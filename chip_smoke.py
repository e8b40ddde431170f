#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the CUDA kernels from ``svt_speechbrain_tpu_torch/csrc`` with nvcc,
   and hold every instantiation of the attention forward (kernels 2, 3, 3b)
   and of the backward kernels 4a and 4b to no spills and at least 8
   resident warps an SM, and every instantiation of the frontend kernels
   (layer 0, layers 1-6), of the int8 kernel (f32, bf16) and of the RNN-T
   lattice (route A at U1 32, 81 and 128, route B) to no spills, printing
   registers, shared memory and resident blocks of each (and for the int8
   kernel the clusters of each size resident on the card);
2. hold each kernel against its plain PyTorch version at main-path shapes,
   in bf16 and in f32 (TF32 off); the frontend at wav (8, 80000), at the
   30 s song window (1, 480000), at phase 26's pretraining batch, at
   phase 27's 10 s segmentation recording (1, 160000) and on a (3, 16123)
   view one sample into its storage; the short attention also at the
   segmentation's (1, 16, 499, 64) with key length 499 and at the video
   recipe's evaluation shapes (1, 16, T, 64), T 250-400, every frame
   attended (``lengths=None``), and the int8 kernel at int8 AV-HuBERT's
   shapes for T 250 (post_extract_proj's (250, 2048, 1024) among them) and
   with ``out_dtype=torch.float32`` on bf16 input at (1992, 1024, 4096);
3. serve wav2vec2-large-lv60 AMT (24 layers, 1024 wide, 16 heads, seeded
   random weights) through ``BatchedAMTTranscriber`` at 5 s chunks, batch 8,
   bf16, on synthetic songs, counting kernel launches; and compare one
   2-chunk batch in f32 against the same port on the CPU;
4. one song at ``chunking="song"`` (a 30 s window, the streaming kernel);
5. time each kernel, its plain version and its library yardstick at the
   main-path shapes, beside its bound (by route: 3b, 4a, 4b and the f32
   frontend run three TF32 tensor-core products per product); the
   frontend also layer by layer (each layer's device time a launch from
   torch.profiler beside its bound), in f32, and beside the eager library
   chain of the same function (cuDNN conv1d, LayerNorm, GELU);
6. train ``AudioAMT`` on lv60 at full width and depth with the recipe's
   hyperparameters (f32, all dropouts 0.1), batch 8 of 30 s rows: one
   linear-probe step, a warm-up and 3 timed full-finetune steps, counting
   kernel launches per step, and one step at ``precision="bf16"``; a
   warm-up and 3 timed steps at ``grad_accumulation_factor`` 2 (two
   micro-batches of 4: 48 launches of 3b, 4a and 4b a step), with their
   peak memory beside the unaccumulated step's; then the recipe's own 5 s
   rows (batch 8, 2 steps), which reach no kernel;
7. one f32 training step of a 2-layer lv60-width model (batch 2, 30 s,
   attention dropout 0.1) on the card against the same step on the CPU,
   then the same at ``grad_accumulation_factor`` 2 (micro-batches of 1);
8. int8 (a8w8) serving of lv60 at full width and depth through
   ``SingingTranscriber(quantize="int8")``, bf16, 5 s chunks, batch 8, on
   the songs of phase 3, in turns with the float interface (float, int8,
   int8, float): launches of the int8 kernel per batch (49; 145 with
   ``quantize_attn``; 0 on the float path), RTFx and ms a batch of both,
   how far the int8 decisions keep to the float ones, and one f32 int8
   batch on the card against the CPU's plain path;
9. streaming, int8 and float: a ``StreamingServer`` (batch 8) with 3
   sessions, one of them int16 PCM, fed in uneven pieces, against the
   offline exact decode at batch 8, and a dedicated
   ``StreamingAMTTranscriber`` per song against the offline exact decode at
   batch 1 (exact equality within one batch width; server against dedicated
   stream is reported); and one song at ``chunking="song"`` with int8;
10. RNN-T training: wav2vec2-large-lv60 at full width and depth as the
   transcription network, ``Embedding(1000, 128)`` → ``GRU(1024)`` as the
   prediction network, a sum joint with ``leaky_relu``, a 1000-way output
   and ``TransducerLoss(fused=True)``, through ``Brain.fit_batch``: batch 8
   of 15 s rows (T = 749 frames), U = 80 labels, ragged lengths with one
   empty target, f32, dropouts 0.1; a warm-up and 3 timed steps, 2 launches
   of the lattice kernel and 1 of the gradient kernel a step, a loss that
   falls, peak memory, the device time by segment (CUDA events at the
   segment boundaries of the forward and, through gradient hooks, of the
   backward) and by kernel (torch.profiler);
11. RNN-T decoding with ``TransducerBeamSearcher``, the GRU cell and the
   joint on the card: greedy on the batch of 8, beam 4 on one 5 s row; and
   greedy of a 2-layer f32 model on the card against the CPU;
12. one f32 RNN-T training step of the 2-layer lv60-width model (batch 2 of
   5 s rows, U = 20) on the card against the CPU: the loss, the gradient
   w.r.t. the logits and every parameter's clipped gradient;
13. the MIR-ST500 recipe (``svt_speechbrain_tpu_torch/recipes/MIR_ST500``)
   on a synthetic set written by its ``prepare_benchmarks`` into a
   temporary folder (6 train songs of 14-23 s, 23 utterances; 2 valid and
   2 test songs), its objects read from its yaml by the port's own reader
   (``recipe_yaml``; the card machine needs no PyYAML): lv60 at full
   width and depth, f32, batch 8, eval batch 1, 3 epochs (linear probe,
   two finetune epochs), then ``evaluate`` from the checkpoint of least
   valid loss;
   rows 1 and 2 held against their plain versions at the evaluation's
   shapes first; asserts the frontend and short attention kernels in every
   evaluated utterance and no kernel in a training step, a finite, falling
   train loss, one checkpoint kept, every test song scored; prints epoch
   walls, step and utterance times, RTFx of ``evaluate``, the device's busy
   share in it, checkpoint bytes and seconds, peak memory;
14. the recipe at 2 lv60-width layers, dropouts 0: ``evaluate`` on the
   seeded weights, one epoch (full finetune) and ``evaluate`` again, on
   the card and on the CPU from the same weights: per-step losses,
   evaluation logits, NewBob rates, and every
   song's notes and scores (a song with a frame probability within 1e-5 of
   a threshold has its notes printed, not held).

15. the N20EMv2 audio-only recipe (``svt_speechbrain_tpu_torch/recipes/
   N20EMv2/audio_only``) on a synthetic set written by its
   ``prepare_n20emv2`` (7 songs of 11-19 s with accompaniment stems, one
   MIR-ST500 song mixed into the train set by ``mix_train``), its accomp
   and white sweeps written by ``synthesis_noise`` on the card; lv60 at full
   width and depth, f32, batch 8, the yaml's values: a linear-probe and a
   finetune epoch, ``evaluate`` from the checkpoint of greatest valid
   COnPOff F1 with the ``save_model`` export, then ``extract_ssl_feats``
   over every split, clean and at accomp -10, 0 and +10 dB; rows 1 and 2
   held against their plain versions at the evaluation's shapes first;
   asserts 7 frontend and 24 short-attention launches in every evaluated
   utterance and none in a training step, the kept checkpoints, the
   export, COff scored, every dump (frames, 1024) and finite; prints epoch
   walls, step medians, ms an utterance, the extraction's RTFx, peak
   memory;
17. the N20EMv2 video recipe (``svt_speechbrain_tpu_torch/recipes/N20EMv2/
   video_only``) on seeded 96x96 uint8 lip ROIs at 50 fps written beside
   phase 15's songs (as long as each song) and prepared by its
   ``prepare_n20emv2``; AV-HuBERT large at full width and depth (the
   Conv3d + ResNet-18 frontend with its BatchNorm statistics, 24 pre-LN
   layers, 1024 wide) and its head, f32, the yaml's values (batch 4, eval
   batch 1): a linear-probe and a finetune epoch, ``evaluate`` from the
   checkpoint of greatest valid COnPOff F1, then ``extract_ssl_feats`` of
   every split into ``noise_data/video_feats.npy``; row 2 held at the
   evaluation's shapes first; asserts 24 short-attention launches in every
   evaluated utterance and none in a training step, running statistics
   moved by the probe epoch, the kept checkpoints, COff scored, every dump
   (video frames, 1024) and finite; prints step medians, epoch walls, ms an
   utterance, the extraction's RTFx, checkpoint bytes, save and recovery
   seconds, peak memory and one profiled finetune step by kernel group;
18. one f32 training step of the full ResEncoder and 2 AV-HuBERT-width
   layers (batch 2 x 1 s, dropouts 0) on the card against the CPU (eval
   logits, the loss, the gradient norm, every gradient, the running
   statistics); then phase 17's model served in int8 by
   ``quantize_avhubert`` (FFN only, then with ``quantize_attn``) on the
   test set at batch 1: kernel 5 held bit for bit at every shape it is
   given first, then 49 and 145 launches an utterance at exactly those
   shapes, and how far the frame decisions and notes keep to the float
   ones;
16. the RCA fusion stage at the published width (``FusionRCA`` alpha 0.5, 8
   heads, d_ffn 3072, d_model 1024; head ``Linear(1024, 20)``) on phase
   15's audio dumps and phase 17's video dumps: ``train_rca_av`` and
   ``train_rca_a`` (2 epochs, batch 8, the head warm-started from phase
   15's export, ``evaluate``), ``run_noise_sweep`` of both over clean and
   accomp at -10, 0, +10 dB; kernel 5 held bit for bit against its plain
   version at every shape that int8 serving of the test set gives it (f32;
   T and 2T of each utterance's padded frame count T,
   ``fusion_int8_shapes``) and timed at those of a whole 5 s utterance;
   the trained AV fusion served in int8 by ``quantize_fusion`` (FFN only,
   then with ``quantize_attn``), asserting that kernel 5 launched at
   exactly the shapes held, 4 and 12 times an utterance, and reporting
   how far its frame decisions and notes keep to the float ones; one f32
   batch of 2 utterances card vs CPU (loss and logits);
19. deployment as a user runs it: the inference yaml of
   ``tests/fixtures/singing_transcriber_hyperparams.yaml`` beside phase
   15's exported ``wav2vec2.pt`` and a seeded head (``model.pt``, the onset
   bias raised so that notes are decoded), read by
   ``SingingTranscriber.from_hparams`` with the port's own YAML reader
   (PyYAML and msgpack blocked) in bf16 and in int8, batch 8, 5 s chunks;
   ``transcribe_file`` on phase 15's valid and test WAVs (7 frontend and 24
   short-attention launches a batch, 49 int8 launches a batch in int8)
   and one at ``chunking="song"`` (the streaming attention), every file's
   frame probabilities (bit for bit) and notes equal to an interface's
   over the same in-memory modules at the same batch width; prints
   ``from_hparams`` seconds, ms a file and RTFx; then
   ``tests/fixtures/jax_export_small.msgpack`` read by the port's own
   msgpack decoder, bit for bit against its ``.npz``.

20. the SSL families at full width and depth, seeded weights:
   wav2vec2-base ("group" extractor, post-LN, 12 x 768),
   data2vec-audio-large (no conv bias, stacked positional convs, post-LN)
   and WavLM-large (gated relative position bias), each built by name
   through the bridge's name check and served in bf16 at batch 8 on phase
   3's song lengths with a ``Linear(hidden, 20)`` head: ms a batch, RTFx,
   launches, asserting row 1 7 times a batch for data2vec and WavLM and
   never for base (its GroupNorm takes the plain frontend), row 2 once a
   layer a batch for base and data2vec and never for WavLM (its biased
   attention runs eagerly); one f32 batch with exact lengths at 2 layers of
   each family and AV-HuBERT base's post-LN encoder card vs CPU; one
   data2vec-audio-large f32 step at batch 8 x 30 s, dropouts 0.1, without
   ``remat`` (twice), with ``remat`` and with ``remat_frontend`` too (the
   losses and clipped gradients held to the first step at phase 7's
   tolerance; 48 launches of 3b under remat; step ms and peak memory of a
   second step), one WavLM-large step at 8 x 5 s with ``remat``; row 5 bit
   for bit at int8 wav2vec2-base's shapes (K or N 768 and 3072) and timed
   beside bf16 ``torch.matmul``, int8 base served (25 launches a batch);
   and the MIR-ST500 recipe's command line with
   ``--ssl_model=wav2vec2-base --feat_dim=768`` (a probe and a finetune
   epoch, ``evaluate``).
21. AV-HuBERT seq2seq ASR at full width: ``AVHubertASR.from_fairseq`` on a
   state dict built on the card from one seed with exactly the keys and
   shapes of ``tests/fixtures/ckpt_manifests.json``'s
   ``avhubert-asr-seq2seq`` (AV-HuBERT large, 24 x 1024, and the fairseq
   decoder, 6 x 1024, V 1000), f32; a batch of 4 utterances of 5 s at 25
   fps (audio features (4, 125, 104), lip ROIs (4, 125, 88, 88, 1)), one
   shorter through ``frame_lengths``, beam 5, ``max_len_b`` 200:
   ``encode`` (24 launches of row 2, nothing else) and ``transcribe`` on
   the generator's fast path, the same search forced onto its host path
   (an LM of zeros) and ``transcribe(device_search=True)``, each with 24
   launches of row 2 for its encode and none in its decoder steps, the
   three giving equal tokens and scores within 1e-5; encode ms, ms a batch,
   a step, best-hypothesis tokens a second, device-to-host reads a step of
   each route, peak memory; then 2 encoder and 2 decoder layers at full
   width, f32, on the card against the CPU (features, tokens, scores).
22. the CRDNN ASR path at the widths of SpeechBrain's TIMIT seq2seq recipe
   (``crdnn-ligru-timit``): ``Fbank(n_mels=40)`` → global
   ``InputNormalization`` → ``CRDNN`` (2 CNN blocks of 128 and 256
   channels, time pooling 2, 4 bidirectional LiGRU layers of 512, 2 DNN
   blocks of 512, dropout 0.15) → a 42-way CTC head, and a location-aware
   GRU ``AttentionalRNNDecoder`` (256 wide, 10 channels, kernel 100, over
   ``Embedding(42, 128)``) → a 42-way sequence head, f32, about 10 M
   parameters drawn by the ``Brain`` from its seed (no ``init_modules``);
   a batch of 8 utterances of 4.5-2.0 s of seeded noise with about 12
   tokens a second: the eval forward (ms a batch, launches, busy share,
   peak memory), a warm-up and 3 timed Adam steps of 0.2 CTC + 0.8 NLL
   (ms a step, launches, peak memory; every running statistic and the
   normalization's state moved, no parameter left at zero), and at 2
   LiGRU layers, dropouts 0, the card against the CPU: log-probabilities,
   loss and the running statistics after one training forward in f32,
   every gradient of the same step in f64, and the f32 gradients against
   f64. Then the eval batch's encoder states are decoded four ways over the
   whole batch (ms, host reads and, for the beam search, launches a step):
   ``S2SRNNGreedySearcher``; ``S2SRNNBeamSearcher`` at beam 8, CTC weight
   0.3; that search fused (weight 0.5) with a seeded ``RNNLM`` at the JAX
   defaults (embedding 128, 2 LSTM layers of 1024, a DNN block of 512) and
   with a 2-layer ``TransformerLM``; each also on the longest and shortest
   rows for 20 steps against the same search on the CPU. No kernel of
   ``csrc/`` lies on this path.
23. the conformer ASR path at the widths of SpeechBrain's LibriSpeech
   conformer recipe (``conformer-small-librispeech``): ``Fbank(n_mels=80,
   n_fft=512)`` → global ``InputNormalization`` → ``ConvolutionFrontEnd``
   (2 blocks of 64 and 32 channels, strides 2: 640 features) → a conformer
   ``TransformerASR`` (d_model 144, 4 heads, 12 encoder and 4 decoder
   layers, d_ffn 1024, kernel 31, dropout 0.1) → 5000-way CTC and sequence
   heads, f32, 13.3 M parameters drawn by the ``Brain``; a batch of 8
   utterances of 14.0-7.0 s, about 4 tokens a second. The augmenters'
   applies card against CPU on the same draws; ``EnvCorrupt`` once on the
   batch over a synthetic noise and RIR corpus the phase writes; the eval
   forward; a warm-up and 3 timed Adam steps of 0.3 CTC + 0.7 label-smoothed
   NLL with ``SpeedPerturb`` and ``SpecAugment`` on (every BatchNorm
   statistic moved); ``S2STransformerBeamSearch`` at beam 10, CTC weight
   0.4, over the eval batch (57 steps: random weights end no hypothesis);
   ms, launches, busy share and peak memory of each, host reads a decode
   step, and no launch of a ``csrc/`` kernel over the path. At 2 encoder
   and 1 decoder layers, dropout 0, the card against the CPU as in phase
   22, and the beam search (beam 3, 6 steps).

24. source separation at the widths of SpeechBrain's WSJ0-2mix SepFormer
   recipe (``sepformer-wsj0-2mix``): ``TasNetEncoder(16, 256)`` →
   ``Dual_Path_Model`` (2 dual blocks, each an intra and an inter
   ``SBTransformerBlock`` of 8 pre-LN layers at width 256, 8 heads, d_ffn
   1024, positions; chunks of 250, gLN, no intra/inter linears) →
   ``TasNetDecoder(16, 256)``, 2 speakers at 8 kHz, f32, 25.7 M parameters
   seeded from one seed: ``SepformerSeparation.separate_batch`` on 4 x 4 s
   (3,999 frames, 34 chunks; ms a batch, launches, busy share, peak
   memory), a warm-up and 3 timed Adam steps of SI-SNR under PIT at the
   recipe's 1 x 4 s (lr 1.5e-4, the gradient norm clipped to 5); no launch
   of a ``csrc/`` kernel; then 1 dual block of 2 + 2 layers card vs CPU
   (the sources and loss of the training step's separation in f32, every
   gradient in f64, and ``separate_batch`` in f32; both run
   ``models.separation.separate``).
25. speaker verification and enhancement: ``ecapa-tdnn-voxceleb`` (Fbank
   80 → ``ECAPA_TDNN`` at 1024 channels → ``Classifier(192, 192, 7205)``
   under ``LogSoftmaxWrapper(AdditiveAngularMargin(0.2, 30))``, 22.2 M
   parameters): a warm-up and 3 timed Adam steps on 32 x 3 s (every
   BatchNorm statistic moved), ``SpeakerRecognition.verify_batch`` on 8
   pairs of 3-6 s with relative lengths and one
   ``EncoderClassifier.classify_batch``, and at 128 channels card vs CPU
   (f32 logits, loss and statistics, f64 gradients);
   ``metricgan-plus-voicebank`` (``SpectralMaskEnhancement.enhance_batch``
   with ``EnhancementGenerator(257, 200, 2)``, STFT at n_fft 512, hop 256,
   resynthesized through the ISTFT) on 4 x 4 s and one row card vs CPU;
   then ConvTasNet, Xvector, the discriminators, SEGAN, ContextNet,
   ESPnetVGG, CNNTransformerSE, TransformerST, the IMU CRNNs and every
   complex and quaternion layer at small widths card vs CPU (f32 outputs
   and statistics; the complex and quaternion layers' gradients in f64,
   of a fixed seeded projection of the output); no launch of a ``csrc/``
   kernel.

26. SSL pretraining and the port's multi-device layer on one card:
   ``HuggingFaceWav2Vec2Pretrain`` on wav2vec2-large-lv60 at full width and
   depth (seeded weights, codevectors 256 of G 2 x V 320, K 100 negatives,
   masks 0.65 x 10, every dropout 0.1, f32, Adam): batch 4 of 25 s crops
   (1249 frames, the streaming attention kernels: 7 frontend and 24 each of
   3b, 4a, 4b launches a step asserted), a warm-up and 3 timed steps with
   their host mask sampling, then one step of fairseq's 20 s crops (999
   frames, the eager band: no attention kernel); the same step under a
   one-rank NCCL process group through ``DistributedDataParallel`` (loss
   and every updated parameter bit for bit) and ``parallel.fsdp.apply_fsdp``
   (within ``TOL_FSDP``); an asynchronous ``torch.distributed.checkpoint``
   save of the model and Adam and a restore, bit for bit;
   ``AVHubertPretrain`` on AV-HuBERT large (audio and video, concat) at
   batch 2 of 6 s, a warm-up and 3 timed Adam steps; and one f64 step of
   2 lv60-width and 2 AV-HuBERT-width layers card vs CPU on the same Gumbel
   noise, every leaf within 1e-9.

27. the serving interfaces and back-ends (``interfaces_phase``), every
   model on seeded weights carried through ``convert_jax``: (a)
   ``EncoderASR`` over wav2vec2-large-lv60 at full width and depth with a
   ``Linear(1024, 1000)`` CTC head and a log-softmax, greedy decoding
   (blank 0) and a 1000-piece unigram tokenizer written by
   ``spm_proto.write_model``, read by ``from_hparams`` from an export
   folder the phase writes (the port's
   ``pretrained/hparams/encoder_asr_lv60.yaml``, ``encoder.pt``,
   ``tokenizer.model``): ``transcribe_batch`` on 8 rows of 3-5 s padded
   to 5 s (a warm-up and 3 timed, 7 launches of row 1 and 24 of row 2 a
   batch asserted; ms, RTFx, every kernel launch, busy share,
   peak memory), ``transcribe_file`` on a 5 s WAV, and ``CTCSegmentation``
   of 4 texts in one 10 s recording (T 499: 7 + 24 launches asserted);
   (b) ``EncoderDecoderASR`` over phase 23's conformer-small-librispeech
   (``TransformerASREncoder``: Fbank, the settled global normalization,
   the frontend, the conformer) with ``S2STransformerBeamSearch`` at beam
   10, CTC weight 0.4 and a 5000-piece unigram tokenizer, batch 4 x 5 s,
   the decode capped at ``E2E_STEPS`` (seeded weights never emit EOS); (c)
   ``VAD`` at vad-crdnn-libriparty's widths (Fbank 40, global
   normalization, CRDNN of 2 CNN blocks of 16, 2 bidirectional GRU layers
   of 32, a DNN block of 16, ``Linear(16, 1)``, 10 ms) on one 60 s
   recording of noise bursts: ``get_speech_segments`` with the double
   check, the normalization's statistics asserted bit for bit as loaded;
   (d) ``DelaySum_Beamformer``, ``Covariance``, ``GccPhat``, ``DelaySum``,
   ``Mvdr``, ``Gev`` (``gevd`` on cuSOLVER; its share of ``Gev``),
   ``SrpPhat`` and ``Music`` over ``sphere()`` on 4 mics x 4 x 10 s over
   one STFT; (e) ECAPA-TDNN (phase 25's widths) embeddings of 1.5 s
   windows of a 60 s three-source recording, ``Spec_Clust_unorm`` and
   ``do_spec_clustering`` on the host, an RTTM written; (b)-(e) reach no
   ``csrc/`` kernel (asserted); (f) the card against the CPU in f64, every
   reading within 1e-9: a 2-layer lv60-width CTC encoder's
   log-posteriors through ``EncoderASR.encode_batch`` (the bridge's
   ``fused_frontend=False``), (b)'s encoder states, (c)'s posteriors, (d)'s
   ``DelaySum``/``Mvdr`` outputs, ``Gev``'s magnitude and ``gevd``'s
   eigenvalues, ``SrpPhat``'s and ``Music``'s directions equal, and
   ``HMMAligner``'s forward and Viterbi scores on phase 22's CRDNN
   posteriors, its Viterbi alignments equal.

A card-vs-CPU reading that is not finite (a NaN or an inf on either side)
fails its check.

28. bucketed training from WAV files: ``AudioAMT`` at lv60 full width and
    depth (f32, TF32 off, the recipe's hyperparameters, seeded weights) on
    32 whole songs of 21-30 s written as WAV files (16-bit PCM, one 32-bit
    float, one 24-bit PCM) and read by the native reader
    (``native.get_lib()`` asserted), batched by ``DynamicBatchSampler``
    (240 s and 8 songs a batch, 4 buckets, seeded shuffle: 4 batches)
    through ``Brain.make_dataloader`` with 2 workers and
    ``prefetch_batches`` 4: one epoch of 4 ``fit_batch`` steps timed by
    ``profiling.StepTimer`` with the card synchronized (ms, ``flops.mfu``
    against the f32 peak, peak memory, 24 launches each of 3b, 4a and 4b a
    step and no other kernel), an intra-epoch checkpoint after step 2 that
    a fresh brain recovers (the same batch ids and losses for steps 3-4,
    bit for bit or within ``TOL_STEP["loss_rel"]``), one step under
    ``profiling.profile`` with ``annotate("fit_batch")`` (the trace names
    the range and kernels 3b, 4a, 4b), and ``evaluate`` of two 8-10 s
    songs at batch 1 (7 + 24 launches an utterance).

Phases run in the order 1-5, 8, 9, 6, 7, 10-15, 19, 17, 18, 16, 20, 21,
22, 23, 24, 25, 26, 27, 28.

Phases 2 and 5 also hold and time the two RNN-T kernels (the lattice on
alpha and on beta panels, the gradient) against their plain versions at the
training shape (8, 749, 81, 1000) and at (4, 64, 17, 32), and time autograd
through the plain ``transducer_loss`` beside them. The lattice is held and
timed by route: route A (what ``lattice_plan`` gives up to U1 128) beside
route B (the first port's design, forced through the launch helper's
``plan``), the two equal bit for bit on the valid region; phase 5 also times
alpha at U1 128 and 129, where the routes meet. Phase 2 also holds the
int8 kernel's integers bit for bit against the plain quantizer at six
shapes (the attention projections of ``quantize_attn`` among them); phase 5
also times it at the four shapes of int8 serving, as the profiler's device
time a launch beside the time through the wrapper, beside ``torch._int_mm``
with an eager quantize pass (its library route) and, alone, beside
``torch._int_mm`` and the bf16 ``torch.matmul`` of the same shape; phase 8
prints its device time in one batch and its share of the batch's kernel
time.

The last lines are the card's ``nvidia-smi`` name and power limit, one
``{"kernels": [...]}`` JSON line and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import copy
import dataclasses
import functools
import gc
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from svt_speechbrain_tpu_torch import ops  # noqa: E402
from svt_speechbrain_tpu_torch.config import load_hyperyaml  # noqa: E402
from svt_speechbrain_tpu_torch.core import Brain, Stage  # noqa: E402
from svt_speechbrain_tpu_torch.dataio.batch import PaddedData  # noqa: E402
from svt_speechbrain_tpu_torch.flagship import (HEAD_OUTPUTS,  # noqa: E402
                                                build_modules)
from svt_speechbrain_tpu_torch.convert_jax import (  # noqa: E402
    _flatten, init_avhubert, init_avhubert_asr, init_embedding, init_linear,
    init_modules, init_params, init_rnn, init_wav2vec2, is_unseeded,
    load_jax_params, load_module_tree, load_msgpack, module_tree)
from svt_speechbrain_tpu_torch.decoders import (  # noqa: E402
    FairseqSequenceGenerator, TransducerBeamSearcher)
from svt_speechbrain_tpu_torch.models.wav2vec2 import (  # noqa: E402
    HuggingFaceWav2Vec2, Wav2Vec2CTCEncoder, Wav2Vec2Config)
from svt_speechbrain_tpu_torch.nnet import losses  # noqa: E402
from svt_speechbrain_tpu_torch.nnet.activations import Softmax  # noqa: E402
from svt_speechbrain_tpu_torch.nnet.embedding import Embedding  # noqa: E402
from svt_speechbrain_tpu_torch.nnet.linear import Linear  # noqa: E402
from svt_speechbrain_tpu_torch.nnet.loss.transducer_loss import (  # noqa: E402
    TransducerLoss, transducer_loss)
from svt_speechbrain_tpu_torch.nnet.rnn import (  # noqa: E402
    GRU, AttentionalRNNDecoder, GRUCell)
from svt_speechbrain_tpu_torch.models.crdnn import CRDNN  # noqa: E402
from svt_speechbrain_tpu_torch.models.features import Fbank  # noqa: E402
from svt_speechbrain_tpu_torch.processing.features import (  # noqa: E402
    InputNormalization)
from svt_speechbrain_tpu_torch.nnet.transducer_joint import (  # noqa: E402
    Transducer_joint)
from svt_speechbrain_tpu_torch.tasks.amt import AudioAMT  # noqa: E402
from svt_speechbrain_tpu_torch.inference import (  # noqa: E402
    BatchedAMTTranscriber)
from svt_speechbrain_tpu_torch.models.avhubert import (  # noqa: E402
    AVHubertConfig, AVHubertPretrain, FairseqAVHubert)
from svt_speechbrain_tpu_torch.models.wav2vec2_pretrain import (  # noqa: E402
    HuggingFaceWav2Vec2Pretrain)
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG  # noqa: E402
from svt_speechbrain_tpu_torch.parallel.fsdp import apply_fsdp  # noqa: E402
from svt_speechbrain_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from svt_speechbrain_tpu_torch.utils.orbax_checkpoints import (  # noqa: E402
    OrbaxCheckpointer)
from svt_speechbrain_tpu_torch.models.avhubert_asr import (  # noqa: E402
    AVHubertASR, default_decoder_config)
from svt_speechbrain_tpu_torch.models.quantize import (  # noqa: E402
    quantize_avhubert, quantize_fusion, quantize_wav2vec2)
from svt_speechbrain_tpu_torch.ops import _build  # noqa: E402
from svt_speechbrain_tpu_torch.ops import conv_frontend as cf  # noqa: E402
from svt_speechbrain_tpu_torch.ops import flash_attention as fa  # noqa: E402
from svt_speechbrain_tpu_torch.ops import quant  # noqa: E402
from svt_speechbrain_tpu_torch.ops import transducer_lattice as tl  # noqa: E402
from svt_speechbrain_tpu_torch.pretrained.interfaces import (  # noqa: E402
    SingingTranscriber)
from svt_speechbrain_tpu_torch.dataio.dataio import (  # noqa: E402
    merge_csvs, read_audio, write_audio)
from svt_speechbrain_tpu_torch.recipes.MIR_ST500 import (  # noqa: E402
    prepare_benchmarks, train_audio_ssl as mir_recipe)
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_only import (  # noqa: E402
    extract_ssl_feats, prepare_n20emv2, train_audio_ssl as n20em_recipe)
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual import (  # noqa: E402
    prepare_n20emv2 as av_prep, run_noise_sweep, synthesis_noise,
    train_rca_a, train_rca_av)
from svt_speechbrain_tpu_torch.recipes.N20EMv2.video_only import (  # noqa: E402
    extract_ssl_feats as video_extract, prepare_n20emv2 as video_prep,
    train_video_ssl as video_recipe)
from svt_speechbrain_tpu_torch.utils.amt import onset_peaks  # noqa: E402
from svt_speechbrain_tpu_torch.decoders.seq2seq import (  # noqa: E402
    S2SRNNBeamSearcher, S2SRNNBeamSearchLM, S2SRNNBeamSearchTransformerLM,
    S2SRNNGreedySearcher, S2STransformerBeamSearch)
from svt_speechbrain_tpu_torch.models.augment import (  # noqa: E402
    EnvCorrupt, SpecAugment)
from svt_speechbrain_tpu_torch.models.convolution import (  # noqa: E402
    ConvolutionFrontEnd)
from svt_speechbrain_tpu_torch.models.rnnlm import RNNLM  # noqa: E402
from svt_speechbrain_tpu_torch.models.transformer_asr import (  # noqa: E402
    TransformerASR, TransformerASREncoder, TransformerLM)
from svt_speechbrain_tpu_torch.processing import (  # noqa: E402
    speech_augmentation as augmentation)
from svt_speechbrain_tpu_torch.models.separation import (  # noqa: E402
    ConvTasNet, Dual_Path_Model, SBTransformerBlock, TasNetDecoder,
    TasNetEncoder, separate)
from svt_speechbrain_tpu_torch.models.ecapa_tdnn import (  # noqa: E402
    ECAPA_TDNN, Classifier)
from svt_speechbrain_tpu_torch.models.xvector import (  # noqa: E402
    Discriminator, Xvector)
from svt_speechbrain_tpu_torch.models.enhancement import (  # noqa: E402
    EnhancementGenerator, MetricDiscriminator, SeganDiscriminator,
    SeganGenerator)
from svt_speechbrain_tpu_torch.models.contextnet import (  # noqa: E402
    ContextNet, ESPnetVGG)
from svt_speechbrain_tpu_torch.models.transformer_se_st import (  # noqa: E402
    IMU_CRNN, IMU_CRNN_GRU, CNNTransformerSE, TransformerST)
from svt_speechbrain_tpu_torch.nnet.complex_networks import (  # noqa: E402
    CBatchNorm, CConv1d, CConv2d, CLayerNorm, CLinear, CLiGRU, CLSTM, CRNN)
from svt_speechbrain_tpu_torch.nnet.quaternion_networks import (  # noqa: E402
    QBatchNorm, QConv1d, QConv2d, QLinear, QLiGRU, QLSTM, QRNN)
from svt_speechbrain_tpu_torch.pretrained.interfaces import (  # noqa: E402
    VAD, EncoderASR, EncoderClassifier, EncoderDecoderASR,
    SepformerSeparation, SpeakerRecognition, SpectralMaskEnhancement)
from svt_speechbrain_tpu_torch.processing.features import (  # noqa: E402
    ISTFT, STFT, spectral_magnitude)
from svt_speechbrain_tpu_torch.processing.signal_processing import (  # noqa: E402
    resynthesize)
from svt_speechbrain_tpu_torch.alignment.aligner import HMMAligner  # noqa: E402
from svt_speechbrain_tpu_torch.alignment.ctc_segmentation import (  # noqa: E402
    CTCSegmentation)
from svt_speechbrain_tpu_torch.models.beamform_multimic import (  # noqa: E402
    DelaySum_Beamformer)
from svt_speechbrain_tpu_torch.nnet.containers import Sequential  # noqa: E402
from svt_speechbrain_tpu_torch.processing import (  # noqa: E402
    decomposition, diarization)
from svt_speechbrain_tpu_torch.processing.multi_mic import (  # noqa: E402
    Covariance, DelaySum, GccPhat, Gev, Music, Mvdr, SrpPhat)
from svt_speechbrain_tpu_torch.tokenizers import (  # noqa: E402
    spm_lite, spm_proto)
from svt_speechbrain_tpu_torch import native  # noqa: E402
from svt_speechbrain_tpu_torch.dataio.dataset import (  # noqa: E402
    DynamicItemDataset)
from svt_speechbrain_tpu_torch.dataio.sampler import (  # noqa: E402
    DynamicBatchSampler)
from svt_speechbrain_tpu_torch.utils import flops, profiling  # noqa: E402

SEED = 0
SR = 16000
# H100 SXM published peaks (dense), from ``utils/flops.py``: bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores, TF32
# tensor-core FLOP/s, int8 tensor-core operations a second, HBM bytes/s
PEAK_BF16 = flops.PEAK_FLOPS["bf16"]
PEAK_F32 = flops.PEAK_FLOPS["f32"]
PEAK_TF32 = flops.PEAK_FLOPS["tf32"]
# the f32 training kernels (3b, 4a, 4b) run each product as three TF32
# products
TF32_PRODUCTS = 3
PEAK_INT8 = flops.PEAK_FLOPS["int8"]
PEAK_BYTES = flops.PEAK_BYTES
# kernel vs plain tolerances (max abs error), with their reasons:
#  f32 frontend: sums over K = 1536 in another order, erff vs exact erf,
#    values after LayerNorm + GELU of unit scale;
#  bf16 frontend: both round every layer's output to bf16 (ulp 2^-7 at 1..2,
#    2^-6 at 2..4); a 1-ulp difference in one layer moves the next layer's
#    LayerNorm input, so up to 4 ulp at the top of the GELU's range (2..4)
#    are allowed at the last layer;
#  f32 attention: summation order and expf;
#  bf16 attention: P rounded to bf16 before P·V (the plain version keeps
#    f32 weights) and a bf16 output (ulp 2^-9..2^-8 at the output's scale).
TOL = {("conv_frontend", "f32"): 1e-3, ("conv_frontend", "bf16"): 6.25e-2,
       ("flash_attention_short", "f32"): 1e-4,
       ("flash_attention_short", "bf16"): 2e-2,
       ("flash_attention", "f32"): 1e-4, ("flash_attention", "bf16"): 2e-2}
# the training kernels, against their plain versions: the forward's output
# by max abs error (f32 as above; bf16 2.5x the 1.953e-3 measured at
# (8, 16, 1499, 64), where |out| peaks near 0.24); L by max abs error (f32
# sums of the same products in another order, values about 7); the
# gradients by max abs error over the plain version's peak magnitude (their
# scale varies with the shape): f32 summation order; bf16 dS rounded to
# bf16 at other f32 values, and bf16 outputs
TRAIN_TOL = {("flash_attention_lse", "f32"): 1e-4,
             ("flash_attention_lse", "bf16"): 5e-3,
             ("lse", "f32"): 1e-3, ("lse", "bf16"): 1e-3,
             ("grad", "f32"): 1e-4, ("grad", "bf16"): 2e-2}
# logits of the f32 serving batch, card vs CPU: 24 layers of f32 products in
# other summation orders (cuBLAS, cuDNN and the kernels vs CPU kernels)
TOL_E2E_F32 = 2e-3
# one f32 training step of 2 lv60-width layers, card vs CPU, by summation
# order only: the loss and the gradient norm relative; each parameter's
# clipped gradient and its update (after minus before), |card - CPU| over
# |CPU| per leaf. Adam's first step moves a parameter by about lr * sign(g),
# so the updates see the gradients' signs and the gradients their sizes. A
# leaf whose CPU gradient is under ZERO_GRAD_SHARE of the norm (the
# attention's key bias: 0 in exact arithmetic, float noise on each side) is
# exempt from both. Measured on an H100 (chip_smoke.py phase 7): gradient
# norm 0, worst gradient 4.870e-06, worst update 1.627e-04, both on a
# frontend conv's weight; each tolerance is about 6x its reading.
TOL_STEP = {"loss_rel": 1e-4, "gnorm_rel": 2e-5, "grad_rel": 3e-5,
            "update_rel": 1e-3}
ZERO_GRAD_SHARE = 1e-6
# the int8 kernel against its plain version: the quantized integers and
# the row scales bit for bit; the output relative to the plain one, element
# by element: the products are exact integers and the f32 epilogue has the
# plain version's order, so f32 may differ in a fused multiply's last bit
# and bf16 by one rounding of the output
INT8_RTOL = {"f32": 1e-6, "bf16": 2.0 ** -8}
# (M, K, N): feat_proj, ffn1 and ffn2 of a chunked batch (8 x 249 frames),
# ffn1 of a 30 s song window, ffn2 of one streamed 5 s window
INT8_SHAPES = ((1992, 512, 1024), (1992, 1024, 4096), (1992, 4096, 1024),
               (1499, 1024, 4096), (249, 4096, 1024), (1992, 1024, 1024))
# timed in phase 5: feat_proj, ffn1, ffn2 of a chunked batch and the
# attention projections of ``quantize_attn``
INT8_TIMED = ((1992, 512, 1024), (1992, 1024, 4096), (1992, 4096, 1024),
              (1992, 1024, 1024))
INT8_ROW = (1992, 1024, 4096)       # the shape of the kernels line
# how far int8 serving may stray from float serving on random weights, per
# frame: the onset and offset decisions, and the pitch class (an argmax
# over an untrained head's near-uniform logits)
INT8_DECISION_AGREE = 0.95
INT8_PITCH_AGREE = 0.7
# logits of one f32 int8 batch, card against the CPU's plain path: the
# float inputs of each quantizer differ by summation order, so an
# activation on a rounding boundary takes the other integer on the other
# device and moves its row by one quantization step; after 24 layers that
# is a noise floor well above f32 rounding, so the median and the worst
# logit are held apart
TOL_INT8_E2E = {"median": 2e-3, "max": 0.5}
HPARAMS = {"frame_rate": 49.8, "onset_threshold": 0.4,
           "offset_threshold": 0.5}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
_CSRC = "svt_speechbrain_tpu_torch/csrc/"
SOURCES = {"conv_frontend": _CSRC + "conv_frontend.cu",
           "flash_attention_short": _CSRC + "flash_attention.cu",
           "flash_attention": _CSRC + "flash_attention.cu",
           "flash_attention_lse": _CSRC + "flash_attention.cu",
           "flash_attention_bwd_dq": _CSRC + "flash_attention_bwd.cu",
           "flash_attention_bwd_dkv": _CSRC + "flash_attention_bwd.cu",
           "int8_matmul": _CSRC + "quant_matmul.cu",
           "rnnt_lattice": _CSRC + "transducer_lattice.cu",
           "rnnt_grad": _CSRC + "transducer_lattice.cu"}
_FA = "svt_speechbrain_tpu/ops/flash_attention.py:"
REPLACES = {"conv_frontend": "svt_speechbrain_tpu/ops/conv_frontend.py:172",
            "flash_attention_short": _FA + "635",
            "flash_attention": _FA + "342",
            "flash_attention_lse": _FA + "437",
            "flash_attention_bwd_dq": _FA + "502",
            "flash_attention_bwd_dkv": _FA + "514",
            "int8_matmul": "svt_speechbrain_tpu/ops/quant.py:121",
            "rnnt_lattice": "svt_speechbrain_tpu/ops/transducer_lattice.py:67",
            "rnnt_grad": "svt_speechbrain_tpu/ops/transducer_lattice.py:276"}
TRAIN_KERNELS = ("flash_attention_lse", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# the RNN-T configuration: the widths of SpeechBrain's LibriSpeech transducer
# recipe (joint and decoder 1024, embedding 128, 1000 units, beam 4) on the
# lv60 transcription network; rows of 15 s, relative input lengths, target
# lengths out of 80 (one empty target)
RNNT = dict(vocab=1000, emb=128, joint=1024, labels=80, seconds=15.0,
            beam=4)
RNNT_BLANK = 0
RNNT_T_REL = [1.0, 0.95, 0.9, 0.8, 0.7, 0.6, 0.5, 0.33]
RNNT_U_LENS = [80, 76, 71, 64, 55, 47, 40, 0]
# (B, T, U, V, relative input lengths, target lengths): the training shape
# and the shape of the JAX package's own chip smoke
RNNT_CASES = ((8, 749, 80, 1000, RNNT_T_REL, RNNT_U_LENS),
              (4, 64, 16, 32, [1.0, 48 / 64, 1.0, 32 / 64], [16, 8, 12, 16]))
# the RNN-T kernels against their plain versions, f32. The lattices: both
# sides run the same recurrence, T + U dependent f32 logaddexp steps, with
# the card's expf/log1pf in the kernel and PyTorch's in the plain version;
# the values reach several thousand (about -7 a step at V = 1000), where an
# f32 ulp is 4.9e-4, so they are held to atol + rtol * |value| on each row's
# valid region, the row losses to rtol alone. The gradient: posteriors are at
# most 1 and each output is a few f32 operations on them, so atol alone;
# exactly 0 outside the valid region. Against autograd through the plain
# ``transducer_loss`` at the small shape: another algorithm (a closed-form
# row solve that subtracts running sums of log-probabilities), 1.7e-5 from
# the plain version on a CPU at row weights up to 1.5.
RNNT_TOL = {"lattice_atol": 1e-5, "lattice_rtol": 4e-6, "loss_rtol": 1e-5,
            "grad_atol": 1e-6, "oracle_grad_atol": 1e-4}
# one f32 RNN-T training step of 2 lv60-width layers, card against CPU
# (phase 12), as TOL_STEP, plus the gradient w.r.t. the logits relative to its
# size. The transition posteriors are exp(alpha + log p + beta - log Z) of
# lattice values of about 1.7e3, where an f32 ulp is 1.2e-4, and the two
# devices' logits differ by summation order, so d_logits and every gradient
# behind it agree to about 1e-4 and no better. Measured on an H100: loss 0,
# gradient norm 2.696e-05, d_logits 8.395e-05, worst parameter 8.219e-05 (the
# GRU's input weights); each tolerance is about 6x its reading.
TOL_RNNT_STEP = {"loss_rel": 1e-4, "gnorm_rel": 2e-4, "grad_rel": 5e-4,
                 "d_logits_rel": 5e-4}
SHORT_LENGTHS = [249, 0, 1, 100, 249, 200, 17, 248]     # B = 8 rows
LONG_LENGTHS = [1499, 700, 0]                          # B = 3 rows
DROPOUT_SEED = 1234567
TRAIN_RATE = 0.1
TRAIN_SECONDS = 30.0
TRAIN_BATCH = 8
FRAME_RATE = 49.8
# phases 13 and 14: the MIR-ST500 recipe on synthetic songs (seconds of each
# song by split); phase 13's train songs make 23 utterances of <= 7.5 s,
# 3 batches of 8, and its eval songs end in utterances of 2.6 to 6.5 s, which
# padding to whole seconds leaves with padded frames
RECIPE_SONGS = {"train": (14, 17, 19, 21, 22, 23), "valid": (12.6, 13.3),
                "test": (11.5, 16.2)}
CARD_VS_CPU_SONGS = {"train": (12, 13), "valid": (11,), "test": (12,)}
# the 2-layer recipe's evaluation logits, card vs CPU, before and after one
# epoch: the f32 frontend kernel (three TF32 products) and the f32 short
# attention kernel against the CPU's plain versions, on weights that one
# epoch of updates (in other summation orders) moved. Measured on an H100
# (chip_smoke.py phase 14): 2.675e-06 and 2.861e-06 in two runs; the
# tolerance is about 7x that
TOL_RECIPE_LOGITS = 2e-5
# a frame decision this close to a tie (a probability against its threshold,
# an onset against its peak window, the top two octave or class logits) may
# go the other way on the other device: if one does, its song's notes are
# printed, not held (the logits differ by about 3e-6, card against CPU)
NEAR_THRESHOLD = 1e-5
# phases 15 and 16: the N20EMv2 audio recipe on synthetic songs (seconds by
# split) with accompaniment stems, and one MIR-ST500 song mixed into its
# train set: 15 train utterances of <= 7 s, 2 batches of 8; 2 valid and 6
# test utterances
N20EM_SONGS = {"train": (12, 14, 17, 19), "valid": (11,), "test": (13, 16)}
N20EM_MIR_SONGS = {"train": (13,)}
# the accomp SNRs whose features phase 15 extracts and phase 16 sweeps
# (``synthesis_noise`` writes all five)
N20EM_SNRS = (-10, 0, 10)
VIDEO_RATE = 50
# phase 17: seeded uint8 lip ROIs of this side, cropped to 88 by the recipe
VIDEO_SIDE = 96
# phase 2 and the card tests: the padded frame counts of the video
# recipe's evaluated utterances (5 s, and last ones up to 7.5 s, padded to
# a multiple of 50)
VIDEO_EVAL_FRAMES = (250, 300, 350, 400)
# phase 18: one f32 training step of the full ResEncoder and 2 AV-HuBERT-
# width layers, card against CPU (batch 2 x 1 s of 88x88 video, dropouts
# 0): the loss and the gradient norm relative, the running statistics and
# the eval logits absolute, f32 products in other summation orders (TF32
# off). Measured on an H100 (PR 12, phase 18): loss 7.3e-08, gradient norm
# 9.5e-07, statistics 1.2e-06, logits 1.9e-06; each tolerance is about 6x
# its reading. The gradients per leaf are held against the same step in
# f64 on the CPU: BatchNorm makes the loss invariant to the scale of each
# conv weight before it, so many leaves' gradients are sums that cancel and
# carry an f32 error of several 1e-3 on either device (card against CPU:
# 5.2e-03 on a BatchNorm scale of layer 1). The card's worst leaf may
# stray from f64 at most GRAD_VS_F64 times as far as the CPU's f32 worst.
TOL_VIDEO_STEP = {"loss_rel": 5e-7, "gnorm_rel": 6e-6, "stats": 1e-5,
                  "logits": 1.2e-5, "grad_vs_f64": 2.0}
# kernel-5 launches in one forward of the RCA fusion: ffn1 and ffn2 of its
# 2 layers, and with ``quantize_attn`` also the 4 projections of each
# layer's shared attention
FUSION_INT8_LAUNCHES = {False: 4, True: 12}


def fusion_int8_shapes(frames, quantize_attn=True):
    """(M, K, N) of kernel 5 in one batch-1 forward of the int8 RCA fusion
    (``quantize_fusion``) over an utterance padded to ``frames`` frames:
    ffn1 and ffn2 at T; with ``quantize_attn`` also the key and value
    projections at T and the stacked queries' and the output's at 2T."""
    shapes = [(frames, 1024, 3072), (frames, 3072, 1024)]
    if quantize_attn:
        shapes += [(frames, 1024, 1024), (2 * frames, 1024, 1024)]
    return shapes
# kernel-5 launches in one forward of int8 AV-HuBERT large
# (``quantize_avhubert``): ffn1 and ffn2 of its 24 layers and
# post_extract_proj, and with ``quantize_attn`` also the 4 attention
# projections of each layer
AVHUBERT_INT8_LAUNCHES = {False: 49, True: 145}


def avhubert_int8_shapes(frames, quantize_attn=True):
    """(M, K, N) of kernel 5 in one batch-1 forward of int8 AV-HuBERT large
    over ``frames`` padded video frames: post_extract_proj (T, 2048, 1024),
    ffn1 and ffn2, and with ``quantize_attn`` the attention projections
    (T, 1024, 1024)."""
    shapes = [(frames, 2048, 1024), (frames, 1024, 4096),
              (frames, 4096, 1024)]
    if quantize_attn:
        shapes.append((frames, 1024, 1024))
    return shapes


# one f32 batch of 2 utterances through the full-width fusion and head,
# card against CPU: 2 layers of f32 products (TF32 off) and softmaxes in
# other summation orders; the loss relative, the logits absolute. Measured
# on an H100 (phase 16): loss 0, logits 2.146e-06; the logits' tolerance is
# about 9x that
TOL_FUSION = {"loss_rel": 1e-5, "logits": 2e-5}


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def lv60_modules():
    bridge, head = build_modules(tiny=False)
    gen = torch.Generator().manual_seed(SEED)
    load_jax_params(init_params(bridge.config, gen, HEAD_OUTPUTS), bridge,
                    head)
    return bridge.eval(), head.eval()


def songs_for(rng, seconds, int16_index=None):
    """Synthetic songs: a sine melody plus noise, one of them int16 PCM."""
    songs = {}
    for i, sec in enumerate(seconds):
        n = int(sec * SR)
        t = np.arange(n) / SR
        f0 = 220.0 * 2 ** (rng.integers(0, 12, size=n // 4000 + 1) / 12)
        wav = 0.3 * np.sin(2 * np.pi * np.repeat(f0, 4000)[:n] * t)
        wav = (wav + 0.05 * rng.standard_normal(n)).astype(np.float32)
        if i == int16_index:
            wav = (wav * 32767).astype(np.int16)
        songs[f"song{i}_{sec}s"] = wav
    return songs


def check_ptxas_spills(report, source):
    """Where ``source`` was built now, ptxas reports no spill in any of its
    instantiations."""
    if source in report:
        spills = [line.strip() for line in report[source][1].splitlines()
                  if "spill" in line]
        bad = [line for line in spills
               if "0 bytes spill stores, 0 bytes spill loads" not in line]
        if not spills or bad:
            raise AssertionError(f"{source} spills: {bad}")


def check_attention_build(report):
    """The attention forward (kernels 2, 3, 3b) and backward (4a, 4b): no
    instantiation spills (ptxas, where the source was built now, and the
    local memory the runtime reports) and each keeps at least 8 warps
    resident per SM; prints registers, shared memory and resident warps."""
    for source in ("flash_attention", "flash_attention_bwd"):
        check_ptxas_spills(report, source)
    for r in fa.forward_kernel_attributes() + fa.backward_kernel_attributes():
        warps = r["blocks_per_sm"] * 4
        log(f"  attention {r['kernel']} {r['dtype']} D={r['d']} dropout="
            f"{r['dropout']}: {r['registers']} registers, "
            f"{r['local_bytes']} bytes local, {r['smem_bytes']} bytes shared "
            f"a block, {r['blocks_per_sm']} blocks ({warps} warps) an SM")
        if r["local_bytes"] != 0 or warps < 8:
            raise AssertionError(f"attention kernel spills or runs under 8 "
                                 f"warps an SM: {r}")


def check_frontend_build(report):
    """The frontend kernels (layer 0, layers 1-6; f32 and bf16; each C the
    kernel takes): no instantiation spills (ptxas, where the source was
    built now, and the local memory the runtime reports); prints
    registers, shared memory and resident blocks."""
    check_ptxas_spills(report, "conv_frontend")
    for r in cf.frontend_kernel_attributes():
        log(f"  conv_frontend {r['kernel']} {r['dtype']} C={r['c']}: "
            f"{r['registers']} registers, {r['local_bytes']} bytes local, "
            f"{r['smem_bytes']} bytes shared a block, {r['blocks_per_sm']} "
            f"blocks (8 warps each) an SM")
        if r["local_bytes"] != 0:
            raise AssertionError(f"conv_frontend kernel spills: {r}")


def check_int8_build(report):
    """The int8 kernel (f32 and bf16): no spills (ptxas, where the source
    was built now, and the local memory the runtime reports); prints
    registers, shared memory, resident blocks and the clusters of each size
    resident on the card."""
    check_ptxas_spills(report, "quant_matmul")
    for r in quant.int8_kernel_attributes():
        log(f"  int8_matmul {r['dtype']}: {r['registers']} registers, "
            f"{r['local_bytes']} bytes local, {r['smem_bytes']} bytes shared "
            f"a block, {r['blocks_per_sm']} blocks (8 warps each) an SM, "
            f"clusters resident by size {r['clusters']}")
        if r["local_bytes"] != 0:
            raise AssertionError(f"int8 kernel spills: {r}")


def check_lattice_build(report):
    """The RNN-T lattice kernel (row 6a), route A (a block of warps a batch
    row) at U1 32, 81 and 128 and route B (the first port's design) there
    and at U1 1500: no spills (ptxas, where the source was built now, and
    the local memory the runtime reports); prints registers, shared memory,
    threads and resident blocks of each."""
    check_ptxas_spills(report, "transducer_lattice")
    for r in tl.lattice_kernel_attributes():
        log(f"  rnnt_lattice route {r['route']} U1={r['u1']}: "
            f"{r['registers']} registers, {r['local_bytes']} bytes local, "
            f"{r['smem_bytes']} bytes shared a block, {r['threads']} "
            f"threads, {r['blocks_per_sm']} blocks an SM")
        if r["local_bytes"] != 0:
            raise AssertionError(f"rnnt_lattice kernel spills: {r}")


# ---------------------------------------------------------------- phase 2
def attention_inputs(shape, lengths, dtype, gen):
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def check_attention(name, wrapper, shape, lengths, gen, errs):
    for tag, dtype in DTYPES.items():
        q, k, v, lens = attention_inputs(shape, lengths, dtype, gen)
        got = wrapper(q, k, v, lens)
        torch.cuda.synchronize()
        want = fa.attention_reference(q, k, v, lens)
        err = (got.float() - want.float()).abs().max().item()
        zero_rows = got[lens == 0]
        ok = (torch.isfinite(got).all().item()
              and (zero_rows == 0).all().item() and err <= TOL[(name, tag)])
        log(f"  {name} {tag} {tuple(shape)} lengths={lengths}: max_abs_err="
            f"{err:.3e} tol={TOL[(name, tag)]:.1e} zero_rows_exact="
            f"{(zero_rows == 0).all().item()} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {tag} disagrees with its plain "
                                 f"version")
        errs[(name, tag)] = max(err, errs.get((name, tag), 0.0))


def check_video_kernels(gen, errs):
    """Row 2 at the video recipe's evaluation shapes, (1, 16, T, 64) with
    every frame attended (``lengths=None``), and row 5 at int8 AV-HuBERT's
    shapes for T 250, post_extract_proj's K 2048 among them."""
    for t in VIDEO_EVAL_FRAMES:
        for tag, dtype in DTYPES.items():
            q, k, v = (torch.randn(1, 16, t, 64, generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(3))
            got = fa.flash_attention_short(q, k, v, None)
            torch.cuda.synchronize()
            err = (got.float() - fa.attention_reference(q, k, v, None)
                   .float()).abs().max().item()
            tol = TOL[("flash_attention_short", tag)]
            ok = torch.isfinite(got).all().item() and err <= tol
            log(f"  flash_attention_short {tag} (1, 16, {t}, 64) lengths="
                f"None: max_abs_err={err:.3e} tol={tol:.1e} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("flash_attention_short disagrees with "
                                     "its plain version at a video shape")
            key = ("flash_attention_short", tag)
            errs[key] = max(err, errs.get(key, 0.0))
    for m, k, n in avhubert_int8_shapes(VIDEO_EVAL_FRAMES[0]):
        for tag, dtype in DTYPES.items():
            hold_int8(m, k, n, tag, dtype, gen, " (AV-HuBERT)")


def frontend_wavs(gen):
    """Phase 2's frontend inputs: chunked serving's batch, the 30 s song
    window, phase 26's pretraining batch, phase 27's segmentation
    recording, and a (3, 16123) view one sample into its storage (an odd
    length at an odd offset: layer 0 takes it as it is)."""
    flat = torch.randn(3 * 16123 + 1, generator=gen, device="cuda")
    pretrain = (PRETRAIN_BATCH, int(PRETRAIN_SECONDS * SR))
    segment = (1, int(SEGMENT_SECONDS * SR))
    return (("(8, 80000)", torch.randn(8, 80000, generator=gen,
                                       device="cuda")),
            ("(1, 480000)", torch.randn(1, 480000, generator=gen,
                                        device="cuda")),
            (f"{pretrain} (pretraining)",
             torch.randn(pretrain, generator=gen, device="cuda")),
            (f"{segment} (segmentation)",
             torch.randn(segment, generator=gen, device="cuda")),
            ("(3, 16123) at offset 1", flat))


def check_frontend(extractor, gen, errs):
    for case, wav in frontend_wavs(gen):
        for tag, dtype in DTYPES.items():
            if case.endswith("offset 1"):
                x = wav.to(dtype)[1:].view(3, 16123)
            else:
                x = wav.to(dtype)
            packed = extractor.packed(dtype)
            got = cf.fused_conv_frontend(x, packed)
            torch.cuda.synchronize()
            want = cf.conv_frontend_reference(x, packed)
            err = (got.float() - want.float()).abs().max().item()
            shape = (x.shape[0], cf.output_frames(x.shape[1]), 512)
            ok = (got.shape == shape and torch.isfinite(got).all().item()
                  and err <= TOL[("conv_frontend", tag)])
            log(f"  conv_frontend {tag} {case}->{tuple(got.shape)}: "
                f"max_abs_err={err:.3e} tol={TOL[('conv_frontend', tag)]:.1e}"
                f" -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"conv_frontend {tag} {case} disagrees "
                                     f"with its plain version")
            errs[("conv_frontend", tag)] = max(
                err, errs.get(("conv_frontend", tag), 0.0))


def _max_abs(got, want):
    return (got.float() - want.float()).abs().max().item()


def check_training_kernels(gen, errs, cases=None, dtypes=tuple(DTYPES)):
    """3b (forward + L + dropout), 4a (dQ) and 4b (dK, dV) against their
    plain versions, rate 0.1, at each (shape, key lengths) of ``cases``:
    by default the 30 s training shape without lengths and with lengths
    [1499, 700, 0], and phase 26's pretraining shape (batch 4 of 25 s, T
    1249: 33 keys past the last full tile of 64) without lengths, as
    ``Wav2Vec2Pretrain`` calls them. The gradients are held to their error
    over the plain version's peak magnitude; rows of length 0 and keys past
    the length must give exact zeros; ``errs`` keeps each kernel's largest
    max abs error per dtype."""
    if cases is None:
        pretrain = cf.output_frames(int(PRETRAIN_SECONDS * SR))
        cases = (((8, 16, 1499, 64), None), ((3, 16, 1499, 64), LONG_LENGTHS),
                 ((PRETRAIN_BATCH, 16, pretrain, 64), None))
    for shape, lengths in cases:
        for tag in dtypes:
            dtype = DTYPES[tag]
            q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                             .to(dtype) for _ in range(4))
            lens = (None if lengths is None else
                    torch.tensor(lengths, dtype=torch.int32, device="cuda"))
            args = (q, k, v, lens, None, DROPOUT_SEED, TRAIN_RATE)
            out, lse = fa.flash_attention_fwd_lse(*args)
            delta = (dout.float() * out.float()).sum(-1).contiguous()
            bargs = (q, k, v, dout, lse, delta, lens, None, DROPOUT_SEED,
                     TRAIN_RATE)
            dq = fa.flash_attention_bwd_dq(*bargs)
            dk, dv = fa.flash_attention_bwd_dkv(*bargs)
            torch.cuda.synchronize()
            want_out, want_lse = fa.attention_lse_reference(*args)
            want_dq = fa.attention_bwd_dq_reference(*bargs)
            want_dk, want_dv = fa.attention_bwd_dkv_reference(*bargs)
            live = want_lse > fa.NEG_INF / 2
            e_lse = _max_abs(lse[live], want_lse[live])
            e_abs = {"flash_attention_lse": _max_abs(out, want_out),
                     "flash_attention_bwd_dq": _max_abs(dq, want_dq),
                     "flash_attention_bwd_dkv": max(_max_abs(dk, want_dk),
                                                    _max_abs(dv, want_dv))}
            e_dq = e_abs["flash_attention_bwd_dq"] / want_dq.abs().max().item()
            e_dkv = max(_max_abs(t, w) / w.abs().max().item()
                        for t, w in ((dk, want_dk), (dv, want_dv)))
            finite = all(torch.isfinite(t).all().item()
                         for t in (out, dq, dk, dv))
            zero_rows = (lens is None or all(
                (t[lens.cpu() == 0] == 0).all().item()
                for t in (out, dq, dk, dv)))
            if lens is not None:    # keys past the length: exact zeros
                past = (torch.arange(shape[2], device="cuda")[None, :]
                        >= lens[:, None])
                zero_rows = zero_rows and all(
                    (t.transpose(1, 2)[past] == 0).all().item()
                    for t in (dk, dv))
            ok = (finite and zero_rows
                  and torch.equal(lse > fa.NEG_INF / 2, live)
                  and e_abs["flash_attention_lse"]
                  <= TRAIN_TOL[("flash_attention_lse", tag)]
                  and e_lse <= TRAIN_TOL[("lse", tag)]
                  and max(e_dq, e_dkv) <= TRAIN_TOL[("grad", tag)])
            log(f"  training kernels {tag} {shape} lengths={lengths} rate="
                f"{TRAIN_RATE}: out max_abs_err="
                f"{e_abs['flash_attention_lse']:.3e} L max_abs_err="
                f"{e_lse:.3e} dQ peak-relative err={e_dq:.3e} dK/dV "
                f"peak-relative err={e_dkv:.3e} zeros_exact={zero_rows} "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"training kernels {tag} disagree with "
                                     f"their plain versions")
            for name, err in e_abs.items():
                errs[(name, tag)] = max(err, errs.get((name, tag), 0.0))
            del q, k, v, dout, out, lse, dq, dk, dv
            del want_out, want_dq, want_dk, want_dv


def int8_inputs(m, k, n, dtype, gen):
    """x (M, K) with the rows that pin the quantizer — all zeros (scale
    from the 1e-8 floor), the amax in the last column, exact .5 ties after
    the division (multiples of amax/254 with amax 127) — and a quantized
    normal weight."""
    x = torch.randn(m, k, generator=gen, device="cuda")
    x[0] = torch.randint(-254, 255, (k,), generator=gen, device="cuda") / 2.0
    x[0, 0] = 127.0
    x[1] = 0.0
    x[2, -1] = 9.0
    w8, ws = quant.quantize_weight(
        torch.randn(k, n, generator=gen, device="cuda"))
    return x.to(dtype), w8, ws


def hold_int8(m, k, n, tag, dtype, gen, where=""):
    """Kernel 5 at (M, K, N) in ``dtype`` against its plain version: the
    integers and scales bit for bit, the output within ``INT8_RTOL``.
    Returns the output's max abs error."""
    x, w8, ws = int8_inputs(m, k, n, dtype, gen)
    out, x8, xs = quant.int8_matmul_quantized(x, w8, ws, quant.pack_weight(w8))
    torch.cuda.synchronize()
    want_x8, want_xs = quant.quantize_activation(x)
    want = quant.int8_matmul_plain(x, w8, ws).float()
    err = (out.float() - want).abs()
    ties = ((x[0].float() * 2).abs() % 2 == 1).sum().item()
    ints_ok = torch.equal(x8, want_x8) and torch.equal(xs, want_xs)
    ok = (ints_ok and out.dtype == dtype and ties > k // 4
          and (err <= INT8_RTOL[tag] * want.abs()).all().item())
    log(f"  int8_matmul{where} {tag} M={m} K={k} N={n}: integers and scales "
        f"bit for bit={ints_ok} ({ties} exact ties in row 0), "
        f"max_abs_err={err.max().item():.3e} (rel tol "
        f"{INT8_RTOL[tag]:.1e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"int8_matmul {tag} disagrees with its plain "
                             f"version at M={m} K={k} N={n}")
    return err.max().item()


def hold_int8_f32_out(m, k, n, gen):
    """Kernel 5 on bf16 input writing f32 (``out_dtype``) from its f32
    epilogue, against the plain version's f32 result, within the f32
    tolerance: a bf16 write cast afterwards would miss it by bf16's ulp."""
    x, w8, ws = int8_inputs(m, k, n, torch.bfloat16, gen)
    out = quant.int8_matmul(x, w8, ws, quant.pack_weight(w8),
                            out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = quant.int8_matmul_plain(x, w8, ws, out_dtype=torch.float32)
    err = (out - want).abs()
    ok = (out.dtype == torch.float32
          and (err <= INT8_RTOL["f32"] * want.abs()).all().item())
    log(f"  int8_matmul bf16 in, f32 out M={m} K={k} N={n}: "
        f"max_abs_err={err.max().item():.3e} (rel tol "
        f"{INT8_RTOL['f32']:.1e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"int8_matmul(out_dtype=float32) on bf16 input "
                             f"disagrees with its plain version: {out.dtype}")


def check_int8(gen, errs):
    for m, k, n in INT8_SHAPES:
        for tag, dtype in DTYPES.items():
            err = hold_int8(m, k, n, tag, dtype, gen)
            if (m, k, n) == INT8_ROW:
                errs[("int8_matmul", tag)] = err
    hold_int8_f32_out(*INT8_ROW, gen)


# ---------------------------------------------------------------- phase 3/4
def run_path(tr, songs, repeats=3):
    """Counts set to 0 just before, read just after each transcribe; the
    median wall time of ``repeats`` runs (each launches the same kernels).
    ``tr`` is a transcriber or a ``SingingTranscriber``."""
    transcribe = getattr(tr, "transcribe", None) or tr.transcribe_batch
    walls, counts = [], []
    for _ in range(repeats):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        notes = transcribe(songs)
        walls.append(time.perf_counter() - t0)
        counts.append(ops.launch_counts())
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"launch counts differ between runs: {counts}")
    return notes, float(np.median(walls)), counts[0]


def _kernel_group(name):
    low = name.lower()
    if "conv_ln_gelu" in low:
        return "conv_frontend kernel"
    if "flash_fwd" in low:
        return "attention forward kernel"
    if "flash_bwd" in low:
        return "attention backward kernels"
    if "int8_matmul" in low:
        return "int8 matmul kernel"
    if "rnnt_lattice" in low:
        return "RNN-T lattice kernel (6a)"
    if "rnnt_grad" in low:
        return "RNN-T gradient kernel (6b)"
    if any(w in low for w in ("conv", "cudnn", "implicit_gemm", "dgrad",
                              "wgrad")):
        return "conv (cuDNN)"
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    return "elementwise/reduce (PyTorch)"


def profile_run(fn, top=10):
    """Device kernels over one call of ``fn``, from torch.profiler: the
    device's busy share of the window (the union of kernel intervals, since
    cuDNN's grouped conv runs kernels that overlap), and kernel time by
    group and by kernel (sums, which count overlapping kernels in full).
    Returns the idle share of the window (None if no kernel was seen)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    # ranges the profiler mirrors onto the device timeline (the optimizer's
    # ``Optimizer.step#...``) span kernels already counted: left out
    kernels = [ev for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)
               and ev.time_range.end > ev.time_range.start]
    if not kernels:
        log("  profiler saw no device kernels: breakdown not measured")
        return None
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    window = (max(ev.time_range.end for ev in events)
              - min(ev.time_range.start for ev in events))
    log(f"  profiled window {window / 1e3:.3f} ms (the profiler slows the "
        f"run); device busy {busy / 1e3:.3f} ms = {100 * busy / window:.1f}%, "
        f"idle {100 * (1 - busy / window):.1f}%")
    by_group, by_name = {}, {}
    for ev in kernels:
        dur = ev.time_range.end - ev.time_range.start
        group = _kernel_group(ev.name)
        by_group[group] = by_group.get(group, 0.0) + dur
        n, t = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (n + 1, t + dur)
    total = sum(by_group.values())
    for group, dur in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"  {group}: {dur / 1e3:.3f} ms ({100 * dur / total:.1f}% of "
            f"kernel time)")
    for name, (n, dur) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][1])[:top]:
        log(f"    {dur / 1e3:8.3f} ms x{n:<5d} {name[:90]}")
    return 1 - busy / window


def kernel_device_ms(fn, match, reps=10, windows=3):
    """Mean device time, ms a launch, of the kernels whose name holds
    ``match`` over ``reps`` calls of ``fn`` (torch.profiler: the kernels' own
    intervals, without the host's launch time); None if none was seen in
    any of ``windows`` profiled windows (a window sometimes comes back
    without device events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [ev.time_range.end - ev.time_range.start
                 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and match in ev.name]
        if spans:
            return sum(spans) / len(spans) / 1e3
    return None


def check_frames(tr, songs):
    frames = tr.predict_frames(songs)
    for name, wav in songs.items():
        _, n_frames, _, _ = tr._chunk_song(np.asarray(wav))
        want = sum(n_frames)
        got = frames[name]
        if got.shape != (want, 4) or not np.isfinite(got).all():
            raise AssertionError(f"{name}: frames {got.shape}, want "
                                 f"({want}, 4), finite")
        if not ((got[:, :2] >= 0).all() and (got[:, :2] <= 1).all()
                and (got[:, 2] <= 4).all() and (got[:, 3] <= 12).all()):
            raise AssertionError(f"{name}: frame values out of range")


def f32_batch_check(bridge, head, rng):
    """One batch of 2 chunks (one ragged) in f32: card vs CPU logits."""
    song = {"f32_check": rng.standard_normal(int(8.3 * SR)).astype(np.float32)}
    logits = {}
    for dev in ("cuda", "cpu"):
        tr = BatchedAMTTranscriber(bridge, head, chunk_seconds=5.0,
                                   batch_size=2, compute_dtype=torch.float32,
                                   device=dev)
        (wavs, lens, order), = tr._jobs(song)
        with torch.inference_mode():
            w = torch.from_numpy(wavs).to(dev)
            out = tr.head(tr.bridge(w, wav_lens=torch.from_numpy(lens).to(dev)))
        logits[dev] = out.float().cpu()
        valid = [f for _, _, f in order]
    err = max((logits["cuda"][j, :f] - logits["cpu"][j, :f]).abs().max().item()
              for j, f in enumerate(valid))
    agree = np.mean([
        (logits["cuda"][j, :f, 2:7].argmax(-1)
         == logits["cpu"][j, :f, 2:7].argmax(-1)).float().mean().item()
        for j, f in enumerate(valid)])
    ok = err <= TOL_E2E_F32 and all(torch.isfinite(l).all() for l in
                                    logits.values())
    log(f"  f32 batch of 2 chunks, card vs CPU logits on valid frames "
        f"{valid}: max_abs_err={err:.3e} tol={TOL_E2E_F32:.1e} "
        f"octave_argmax_agree={agree:.4f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("f32 serving on the card disagrees with the CPU")


# ---------------------------------------------------------------- phase 5
def frontend_cost(b, t, c, itemsize):
    flops, tin, cin = 0, t, 1
    for k, s in zip(cf.KERNELS, cf.STRIDES):
        tout = (tin - k) // s + 1
        flops += 2 * b * tout * k * cin * c
        tin, cin = tout, c
    weight_elems = sum(k * (1 if i == 0 else c) * c
                       for i, k in enumerate(cf.KERNELS))
    nbytes = (b * t + weight_elems + b * tin * c) * itemsize + 7 * 3 * c * 4
    return flops, nbytes


def frontend_layer_costs(b, t, c, itemsize):
    """Per layer: (k, s, T_out, K, flops, bytes): the input read once, the
    weights once, the output written once, bias and LayerNorm affine f32."""
    out, tin, cin = [], t, 1
    for k, s in zip(cf.KERNELS, cf.STRIDES):
        tout = (tin - k) // s + 1
        nbytes = ((b * tin * cin + k * cin * c + b * tout * c) * itemsize
                  + 3 * c * 4)
        out.append((k, s, tout, k * cin, 2 * b * tout * k * cin * c, nbytes))
        tin, cin = tout, c
    return out


def attention_cost(shape, lengths, itemsize):
    """What this run's lengths need: QK^T and PV over the valid keys; q read
    for rows with keys, k and v read up to each length, out written whole."""
    b, h, t, d = shape
    keys = sum(min(n, t) for n in lengths)
    flops = 4 * h * t * keys * d
    q_rows = sum(n > 0 for n in lengths)
    nbytes = h * d * (t * q_rows + 2 * keys + t * b) * itemsize + 4 * b
    return flops, nbytes


def training_cost(name, shape, itemsize):
    """3b, 4a, 4b without lengths: 4, 6 and 8 B·H·Tq·Tk·D flops; bytes of
    each input read once and each output written once (L and Δ are f32
    per query row)."""
    b, h, t, d = shape
    tile, rows = b * h * t * d * itemsize, b * h * t * 4
    flops = {"flash_attention_lse": 4, "flash_attention_bwd_dq": 6,
             "flash_attention_bwd_dkv": 8}[name] * b * h * t * t * d
    nbytes = {"flash_attention_lse": 4 * tile + rows,     # q k v -> out, L
              "flash_attention_bwd_dq": 5 * tile + 2 * rows,  # +dO,L,Δ -> dQ
              "flash_attention_bwd_dkv": 6 * tile + 2 * rows}[name]
    return flops, nbytes


def bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def timings(bridge, gen):
    rows = {}
    extractor = bridge.encoder.feature_extractor.cuda()
    wav = torch.randn(8, 80000, generator=gen, device="cuda").bfloat16()
    packed = extractor.packed(torch.bfloat16)
    b_ms, b_by = bound(*frontend_cost(8, 80000, 512, 2), PEAK_BF16)
    rows["conv_frontend"] = dict(
        ms=time_ms(lambda: cf.fused_conv_frontend(wav, packed)),
        plain_ms=time_ms(lambda: cf.conv_frontend_reference(wav, packed),
                         iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="wav (8, 80000) bf16 -> (8, 249, 512)")
    rows.update(frontend_layer_timings(extractor, gen))
    # f32: bound by route (three TF32 products per product)
    wav32 = wav.float()
    packed32 = extractor.packed(torch.float32)
    flops, nbytes = frontend_cost(8, 80000, 512, 4)
    b_ms, b_by = bound(TF32_PRODUCTS * flops, nbytes, PEAK_TF32)
    log(f"  conv_frontend f32 bound by route (3 x TF32 at 495 TFLOP/s) "
        f"{b_ms:.4f} ms; at f32's 67 TFLOP/s outside the tensor cores "
        f"{bound(flops, nbytes, PEAK_F32)[0]:.4f} ms")
    rows["conv_frontend f32"] = dict(
        ms=time_ms(lambda: cf.fused_conv_frontend(wav32, packed32), iters=20),
        plain_ms=time_ms(lambda: cf.conv_frontend_reference(wav32, packed32),
                         iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="wav (8, 80000) f32 -> (8, 249, 512)")
    # context: the eager library chain of the same function (cuDNN conv1d,
    # LayerNorm, GELU: 21 launches, so not one call and not library_ms)
    eager = copy.deepcopy(extractor).to(torch.bfloat16)
    with torch.inference_mode():
        eager_ms = time_ms(lambda: eager(wav, fused=False), iters=20)
    log(f"  context: eager chain ConvFeatureExtractor.forward(wav, "
        f"fused=False) on (8, 80000) bf16 (cuDNN conv1d + LayerNorm + GELU "
        f"per layer): {eager_ms:.4f} ms")
    del eager
    for name, wrapper, shape, lengths in (
            ("flash_attention_short", fa.flash_attention_short,
             (8, 16, 249, 64), SHORT_LENGTHS),
            ("flash_attention", fa.flash_attention, (3, 16, 1499, 64),
             LONG_LENGTHS)):
        q, k, v, lens = attention_inputs(shape, lengths, torch.bfloat16, gen)
        keep = (torch.arange(shape[2], device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        b_ms, b_by = bound(*attention_cost(shape, lengths, 2), PEAK_BF16)
        rows[name] = dict(
            ms=time_ms(lambda: wrapper(q, k, v, lens)),
            plain_ms=time_ms(lambda: fa.attention_reference(q, k, v, lens),
                             iters=5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.nn.functional
                               .scaled_dot_product_attention(
                                   q, k, v, attn_mask=keep)),
            shape=f"{shape} bf16 lengths={lengths}")
    for tag, dtype in DTYPES.items():
        rows.update(training_timings(tag, dtype, gen))
    rows.update(int8_timings(gen))
    rows.update(rnnt_timings(gen))
    # context: the largest piece of the batch that is not a ported kernel
    pos_conv = copy.deepcopy(bridge.encoder.pos_conv).to("cuda",
                                                         torch.bfloat16)
    x = torch.randn(8, 249, 1024, generator=gen, device="cuda").bfloat16()
    with torch.inference_mode():
        pos_ms = time_ms(lambda: pos_conv(x), iters=5)
    log(f"  context: positional conv (F.conv1d, k=128, groups=16) on "
        f"(8, 249, 1024) bf16: {pos_ms:.4f} ms")
    log_rows(rows)
    for tag in DTYPES:
        dq, dkv = (rows[(name, tag)] for name in TRAIN_KERNELS[1:])
        log(f"  backward {tag}, like for like: 4a + 4b = "
            f"{dq['ms'] + dkv['ms']:.4f} ms against one SDPA backward (dQ, "
            f"dK and dV in one call; the library_ms of both rows) "
            f"{dq['library_ms']:.4f} ms")
    return rows


def log_rows(rows):
    for name, r in rows.items():
        if isinstance(name, tuple):
            name = " ".join(name)
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name} {r['shape']}: ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={lib}")


def frontend_layer_timings(extractor, gen):
    """Each frontend layer alone at wav (8, 80000) in bf16, on the plain
    version's input to it, beside its own bound and plain version: ms
    through the wrapper (the host's launch time for the small layers) and
    the kernel's device time a launch from the profiler."""
    rows = {}
    lib = _build.load("conv_frontend", cf._SIGNATURES)
    packed = extractor.packed(torch.bfloat16)
    x = torch.randn(8, 80000, generator=gen, device="cuda").bfloat16()
    for i, (layer, cost) in enumerate(zip(
            packed, frontend_layer_costs(8, 80000, 512, 2))):
        k, s, tout, kk, flops, nbytes = cost
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
        inp = x[..., None] if i == 0 else x
        launch = lambda: cf._launch_layer(lib, x, layer, 1e-5)  # noqa: E731
        dev = kernel_device_ms(launch, "conv_ln_gelu")
        log(f"  conv_frontend layer {i} device time a launch (profiler): "
            + ("not measured" if dev is None else
               f"{dev:.4f} ms, {dev / b_ms:.2f}x its bound {b_ms:.4f} "
               f"({b_by})"))
        rows[f"conv_frontend layer {i}"] = dict(
            ms=time_ms(launch),
            plain_ms=time_ms(lambda: cf._reference_layer(inp, layer, 1e-5),
                             iters=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"k={k} s={s} K={kk} T_out={tout} bf16, "
                  f"{flops / 1e9:.2f} GFLOP")
        x = cf._reference_layer(inp, layer, 1e-5)
    return rows


def eager_int8_matmul(x, w8, w_scale):
    """The same function from library calls: an eager quantize pass and
    ``torch._int_mm``. A yardstick only; the port never calls it."""
    x8, x_scale = quant.quantize_activation(x)
    acc = torch._int_mm(x8, w8)
    return ((acc.float() * x_scale) * w_scale).to(x.dtype)


def _ms(t):
    return "not measured" if t is None else f"{t:.4f}"


def int8_timings(gen, shapes=INT8_TIMED, dtype=torch.bfloat16):
    """Kernel 5 in bf16 at the four shapes of int8 serving (or in ``dtype``
    at ``shapes``; a row is named by its shape and type): its device time
    a launch (torch.profiler) beside its time through the wrapper, its
    bound (x, w8, w_scale read once, the output written once; 2·M·K·N
    operations against the int8 tensor-core peak), its plain version and
    the library's int8 route; and, as context, bf16 ``torch.matmul`` and
    ``torch._int_mm`` alone (device time a launch / through the call). The
    kernels line takes the ffn1 shape."""
    rows = {}
    size = torch.finfo(dtype).bits // 8
    for m, k, n in shapes:
        x, w8, ws = int8_inputs(m, k, n, dtype, gen)
        w8t = quant.pack_weight(w8)
        w = (w8.float() * ws).bfloat16()
        b_ms, b_by = bound(2 * m * k * n, m * k * size + k * n + n * 4
                           + m * n * size, PEAK_INT8)
        lib = None
        if hasattr(torch, "_int_mm"):
            try:
                same = torch.equal(eager_int8_matmul(x, w8, ws),
                                   quant.int8_matmul_plain(x, w8, ws))
                lib = time_ms(lambda: eager_int8_matmul(x, w8, ws))
            except RuntimeError as exc:
                log(f"  torch._int_mm refuses M={m} K={k} N={n}: {exc}")
        else:
            log("  this PyTorch has no torch._int_mm: library_ms is null")
        kernel = lambda: quant.int8_matmul(x, w8, ws, w8t)  # noqa: E731
        row = dict(
            ms=time_ms(kernel),
            device_ms=kernel_device_ms(kernel, "int8_matmul"),
            plain_ms=time_ms(lambda: quant.int8_matmul_plain(x, w8, ws),
                             iters=5, warmup=2),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib,
            shape=f"x ({m}, {k}) {str(dtype)[6:]}, w8 ({k}, {n})")
        matmul = lambda: torch.matmul(x.bfloat16(), w)  # noqa: E731
        bf16 = (kernel_device_ms(matmul, ""), time_ms(matmul))
        x8 = quant.quantize_activation(x)[0]
        int_mm = lambda: torch._int_mm(x8, w8)  # noqa: E731
        alone = ((kernel_device_ms(int_mm, ""), time_ms(int_mm))
                 if lib is not None else (float("nan"), float("nan")))
        dev = row["device_ms"]
        log(f"  int8_matmul {row['shape']}: device "
            + ("not measured" if dev is None else
               f"{dev:.4f} ms a launch, {dev / b_ms:.2f}x its bound "
               f"{b_ms:.4f} ({b_by}), {2 * m * k * n / dev / 1e9:.1f} TOP/s")
            + f"; through the wrapper {row['ms']:.4f} ms; context (device / "
            f"through the call): bf16 torch.matmul {_ms(bf16[0])} / "
            f"{bf16[1]:.4f} ms, torch._int_mm alone {_ms(alone[0])} / "
            f"{alone[1]:.4f} ms"
            + ("" if dev is None or bf16[0] is None else
               f"; under bf16 torch.matmul: {dev < bf16[0]}")
            + ("" if lib is None else
               f"; the library route (eager quantize + torch._int_mm + "
               f"epilogue) equal to the plain version: {same}"))
        rows["int8_matmul" if (m, k, n) == INT8_ROW
             and dtype == torch.bfloat16 else
             f"int8_matmul M={m} K={k} N={n} {str(dtype)[6:]}"] = row
    return rows


def training_timings(tag, dtype, gen):
    """3b, 4a and 4b at the 30 s training shape, rate 0.1, no lengths; the
    yardstick is SDPA with dropout_p=0.1 (another mask, the same work):
    its forward for 3b; its backward, which computes dQ, dK and dV in one
    call, is the library_ms of both 4a and 4b and compares with their
    sum."""
    shape = (TRAIN_BATCH, 16, 1499, 64)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                     .to(dtype) for _ in range(4))
    fwd = (q, k, v, None, None, DROPOUT_SEED, TRAIN_RATE)
    out, lse = fa.flash_attention_fwd_lse(*fwd)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    bwd = (q, k, v, dout, lse, delta, None, None, DROPOUT_SEED, TRAIN_RATE)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = sdpa(*leaves, dropout_p=TRAIN_RATE)
    lib_fwd = time_ms(lambda: sdpa(q, k, v, dropout_p=TRAIN_RATE), iters=10)
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                  retain_graph=True), iters=10)
    rows = {}
    for name, kernel, plain, args, lib in (
            ("flash_attention_lse", fa.flash_attention_fwd_lse,
             fa.attention_lse_reference, fwd, lib_fwd),
            ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq,
             fa.attention_bwd_dq_reference, bwd, lib_bwd),
            ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv,
             fa.attention_bwd_dkv_reference, bwd, lib_bwd)):
        flops, nbytes = training_cost(name, shape, q.element_size())
        if dtype == torch.bfloat16:
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
        else:                   # by route: three TF32 products per product
            b_ms, b_by = bound(TF32_PRODUCTS * flops, nbytes, PEAK_TF32)
            log(f"  {name} f32 bound by route (3 x TF32 at 495 TFLOP/s) "
                f"{b_ms:.4f} ms; at f32's 67 TFLOP/s outside the tensor "
                f"cores {bound(flops, nbytes, PEAK_F32)[0]:.4f} ms")
        rows[(name, tag)] = dict(
            ms=time_ms(functools.partial(kernel, *args), iters=10, warmup=2),
            plain_ms=time_ms(functools.partial(plain, *args), iters=2,
                             warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib,
            shape=f"{shape} {tag} rate={TRAIN_RATE} no lengths")
    return rows


# ---------------------------------------------------------------- phase 6/7
def amt_hparams():
    """The MIR-ST500 recipe's training hyperparameters
    (``recipes/MIR_ST500/hparams/train_audio_ssl.yaml``)."""
    crit = dict(reduction="mean", allowed_len_diff=60, label_smoothing=0.0)
    return dict(
        seed=1986, pitch_octave_num=4, onset_positive_weight=15.0,
        offset_positive_weight=1.0, lr=3e-4, lr_wav2vec=5e-5,
        linear_prob_epochs=2,
        onset_criterion=functools.partial(losses.bce_loss, **crit),
        offset_criterion=functools.partial(losses.bce_loss, **crit),
        octave_criterion=functools.partial(losses.nll_loss, **crit),
        pitch_criterion=functools.partial(losses.nll_loss, **crit),
        log_softmax=Softmax(apply_log=True))


def amt_brain(tree, arch, device, precision="fp32"):
    """``AudioAMT`` over lv60 (with ``arch`` overrides) holding ``tree``."""
    bridge = HuggingFaceWav2Vec2(source="facebook/wav2vec2-large-lv60",
                                 output_norm=True, arch_overrides=arch)
    head = Linear(HEAD_OUTPUTS, bridge.config.hidden_size)
    load_jax_params(tree, bridge, head)
    brain = AudioAMT({"wav2vec2": bridge, "model": head},
                     hparams=amt_hparams(),
                     run_opts={"device": device, "precision": precision})
    brain.init_optimizers()
    return brain


def train_batch(rng, batch, seconds):
    """Synthetic rows of noise and annotations at 49.8 frames a second:
    onset/offset in {0, 1}, octave in 0..4, pitch class in 0..12."""
    n, frames = int(seconds * SR), int(round(seconds * FRAME_RATE))
    wav = (0.1 * rng.standard_normal((batch, n))).astype(np.float32)
    anno = np.stack([rng.random((batch, frames)) < 0.05,
                     rng.random((batch, frames)) < 0.05,
                     rng.integers(0, 5, (batch, frames)),
                     rng.integers(0, 13, (batch, frames))],
                    axis=-1).astype(np.float32)
    ones = np.ones(batch, np.float32)
    return {"sig": PaddedData(torch.from_numpy(wav).pin_memory(), ones),
            "anno": PaddedData(torch.from_numpy(anno).pin_memory(), ones)}


def train_steps(brain, batch, n):
    """``n`` steps, the counts set to 0 just before and read just after
    each; returns [(loss, gradient norm, wall s, counts)]."""
    out = []
    for _ in range(n):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = brain.fit_batch(batch)
        torch.cuda.synchronize()
        out.append((loss, brain.last_grad_norm, time.perf_counter() - t0,
                    ops.launch_counts()))
        if not np.isfinite(loss):
            raise AssertionError(f"nonfinite training loss {loss}")
    return out


def expect_counts(counts, want, what):
    got = {name: counts[name] for name in counts}
    full = {name: want.get(name, 0) for name in counts}
    if got != full:
        raise AssertionError(f"{what}: launches {got}, want {full}")


def training_phase(rng):
    """Phase 6; returns (counts of a full-finetune step, summary)."""
    arch = {}                                   # lv60, all dropouts 0.1
    tree = init_params(Wav2Vec2Config(**arch),
                       torch.Generator().manual_seed(SEED), HEAD_OUTPUTS)
    brain = amt_brain(tree, arch, "cuda")
    n_layers = brain.modules.wav2vec2.config.num_layers
    batch = train_batch(rng, TRAIN_BATCH, TRAIN_SECONDS)
    log(f"  batch {TRAIN_BATCH} x {TRAIN_SECONDS:.0f} s "
        f"({int(TRAIN_SECONDS * SR)} samples), annotations of "
        f"{batch['anno'].data.shape[1]} frames; {n_layers} layers, "
        f"recipe hyperparameters, f32, dropouts 0.1")
    brain.on_stage_start(Stage.TRAIN, 1)
    (loss, gnorm, wall, counts), = train_steps(brain, batch, 1)
    log(f"  linear-probe step: loss={loss:.6f} gnorm={gnorm:.6f} "
        f"{wall * 1e3:.1f} ms launches={counts}")
    expect_counts(counts, {"flash_attention_lse": n_layers},
                  "linear-probe step")
    brain.on_stage_start(Stage.TRAIN, 3)
    train_steps(brain, batch, 1)                # warm-up
    torch.cuda.reset_peak_memory_stats()
    steps = train_steps(brain, batch, 3)
    per_layer = {name: n_layers for name in TRAIN_KERNELS}
    for i, (loss, gnorm, wall, counts) in enumerate(steps):
        log(f"  full-finetune step {i + 1}: loss={loss:.6f} gnorm="
            f"{gnorm:.6f} {wall * 1e3:.1f} ms launches={counts}")
        expect_counts(counts, per_layer, "full-finetune step")
    step_s = float(np.median([w for _, _, w, _ in steps]))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    audio_rate = TRAIN_BATCH * TRAIN_SECONDS / step_s
    log(f"  median full-finetune step {step_s * 1e3:.1f} ms: "
        f"{audio_rate:.1f} s of audio trained per second; peak memory "
        f"{peak_gb:.2f} GiB (torch.cuda.max_memory_allocated)")
    log("  where the device time goes (torch.profiler, one full-finetune "
        "step):")
    idle = profile_run(lambda: brain.fit_batch(batch))
    brain.precision = "bf16"
    (loss, gnorm, wall, counts), = train_steps(brain, batch, 1)
    log(f"  precision=bf16 step (bf16 parameters, f32 batch): loss="
        f"{loss:.6f} gnorm={gnorm:.6f} {wall * 1e3:.1f} ms "
        f"launches={counts}")
    expect_counts(counts, per_layer, "bf16 step")
    brain.precision = "fp32"

    log(f"  accumulated steps: grad_accumulation_factor 2, the same batch "
        f"as two micro-batches of {TRAIN_BATCH // 2}, f32, full finetune: "
        f"a warm-up and 3 timed")
    brain.grad_accumulation_factor = 2
    train_steps(brain, batch, 1)                # warm-up
    torch.cuda.reset_peak_memory_stats()
    accumulated = train_steps(brain, batch, 3)
    for i, (loss, gnorm, wall, counts) in enumerate(accumulated):
        log(f"  accumulated step {i + 1}: loss={loss:.6f} gnorm={gnorm:.6f} "
            f"{wall * 1e3:.1f} ms launches={counts}")
        expect_counts(counts, {name: 2 * n_layers for name in TRAIN_KERNELS},
                      "accumulated step")
    accum_s = float(np.median([w for _, _, w, _ in accumulated]))
    accum_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  median accumulated step {accum_s * 1e3:.1f} ms, peak memory "
        f"{accum_peak_gb:.2f} GiB (the unaccumulated step: "
        f"{step_s * 1e3:.1f} ms, {peak_gb:.2f} GiB)")
    brain.grad_accumulation_factor = 1

    log(f"  the recipe's own 5 s rows: batch {TRAIN_BATCH}, f32, full "
        f"finetune, 2 steps")
    short = train_batch(rng, TRAIN_BATCH, 5.0)
    for i, (loss, _, wall, counts) in enumerate(train_steps(brain, short, 2)):
        log(f"  5 s step {i + 1}: loss={loss:.6f} {wall * 1e3:.1f} ms "
            f"launches={counts} (eager attention under dropout, unfused "
            f"frontend)")
        expect_counts(counts, {}, "5 s step")
    del brain
    torch.cuda.empty_cache()
    return steps[-1][3], dict(step_ms=step_s * 1e3, audio_rate=audio_rate,
                              peak_gb=peak_gb, idle=idle,
                              accum2_step_ms=accum_s * 1e3,
                              accum2_peak_gb=accum_peak_gb)


def reading(err):
    """One card-vs-CPU error as a float; a non-finite one (a NaN or an inf
    on either side) as inf, so that no worst-of maximum and no ``<=``
    against a tolerance can pass it over."""
    err = float(err)
    return err if math.isfinite(err) else math.inf


def within(errs, tol):
    """Whether every reading of ``errs`` is finite and within its entry of
    ``tol``."""
    return all(math.isfinite(v) and v <= tol[k] for k, v in errs.items())


def leaf_errors(got, want, parts):
    """|card - CPU| / |CPU| per parameter, for each ``parts`` entry (error
    name → key of the per-parameter dicts in ``got``/``want``), each a
    ``reading``; a leaf whose CPU gradient is under ZERO_GRAD_SHARE of the
    gradient norm, and whose card gradient is finite, is exempt.
    Returns ({error name: {parameter: error}}, [exempt parameters])."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in want["grads"].values()]))
    errs = {key: {} for key in parts}
    exempt = []
    for name, g in want["grads"].items():
        if torch.linalg.vector_norm(g) <= ZERO_GRAD_SHARE * norm and \
                torch.isfinite(got["grads"][name]).all():
            exempt.append(name)
            continue
        for key, part in parts.items():
            ref = want[part][name]
            errs[key][name] = reading(
                torch.linalg.vector_norm(got[part][name] - ref)
                / torch.linalg.vector_norm(ref))
    return errs, exempt


def card_vs_cpu_step(rng, accum=1):
    """Phase 7: one f32 full-finetune step of 2 lv60-width layers with the
    full frontend, batch 2 x 30 s, attention dropout 0.1 (the hash mask is
    the same on both sides) and the other dropouts 0; with ``accum`` 2, as
    two micro-batches of 1."""
    arch = dict(num_layers=2, hidden_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, attention_dropout=TRAIN_RATE)
    tree = init_params(Wav2Vec2Config(**arch),
                       torch.Generator().manual_seed(SEED + 1), HEAD_OUTPUTS)
    batch = train_batch(rng, 2, TRAIN_SECONDS)
    result = {}
    for dev in ("cuda", "cpu"):
        brain = amt_brain(tree, arch, dev)
        brain.grad_accumulation_factor = accum
        brain.on_stage_start(Stage.TRAIN, 3)
        params = dict(brain.modules.named_parameters())
        before = {n: p.detach().cpu().clone() for n, p in params.items()}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss = brain.fit_batch(batch)
        wall = time.perf_counter() - t0
        result[dev] = dict(
            loss=loss, gnorm=brain.last_grad_norm, counts=ops.launch_counts(),
            grads={n: p.grad.cpu() for n, p in params.items()},
            updates={n: p.detach().cpu() - before[n]
                     for n, p in params.items()})
        log(f"  {dev}: loss={loss:.6f} gnorm={brain.last_grad_norm:.6f} "
            f"{wall:.1f} s launches={result[dev]['counts']}")
        del brain, params
    expect_counts(result["cuda"]["counts"],
                  {name: 2 * accum for name in TRAIN_KERNELS}, "card step")

    got, want = result["cuda"], result["cpu"]
    errs, exempt = leaf_errors(got, want, {"grad_rel": "grads",
                                           "update_rel": "updates"})
    worst = {key: max(e, key=e.get) for key, e in errs.items()}
    loss_rel = abs(got["loss"] / want["loss"] - 1)
    gnorm_rel = abs(got["gnorm"] / want["gnorm"] - 1)
    ok = (loss_rel <= TOL_STEP["loss_rel"]
          and gnorm_rel <= TOL_STEP["gnorm_rel"]
          and all(errs[key][worst[key]] <= TOL_STEP[key] for key in errs)
          and all(name.endswith("attn.bk") for name in exempt))
    log(f"  card vs CPU: loss rel err={loss_rel:.3e} (tol "
        f"{TOL_STEP['loss_rel']:.0e}), gnorm rel err={gnorm_rel:.3e} (tol "
        f"{TOL_STEP['gnorm_rel']:.0e}); per parameter, worst of "
        f"{len(errs['grad_rel'])}: gradient rel err "
        f"{errs['grad_rel'][worst['grad_rel']]:.3e} ({worst['grad_rel']}, "
        f"tol {TOL_STEP['grad_rel']:.0e}), update rel err "
        f"{errs['update_rel'][worst['update_rel']]:.3e} "
        f"({worst['update_rel']}, tol {TOL_STEP['update_rel']:.0e}); "
        f"exempt (zero gradient) {exempt} -> {'ok' if ok else 'FAIL'}")
    for key, e in errs.items():
        top = sorted(e.items(), key=lambda kv: -kv[1])[:5]
        log(f"    largest {key}: " + ", ".join(f"{n} {v:.3e}" for n, v in top))
    if not ok:
        raise AssertionError("the training step on the card disagrees with "
                             "the CPU")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 8/9
def decisions(frames):
    """Per frame: onset and offset decisions at the serving thresholds, and
    the pitch class."""
    return (frames[:, 0] > HPARAMS["onset_threshold"],
            frames[:, 1] > HPARAMS["offset_threshold"], frames[:, 3])


def int8_against_float(float_tr, int8_tr, songs, notes_f, notes_q):
    ff, fq = float_tr.predict_frames(songs), int8_tr.predict_frames(songs)
    dec_f = [decisions(ff[n]) for n in songs]
    dec_q = [decisions(fq[n]) for n in songs]
    agree = [np.concatenate([f[i] == q[i] for f, q in zip(dec_f, dec_q)])
             .mean() for i in range(3)]
    prob_err = max(np.abs(ff[n][:, :2] - fq[n][:, :2]).max() for n in songs)

    def times(ns):
        return [(round(n[0], 4), round(n[1], 4)) for n in ns]
    same_times = {n: times(notes_f[n]) == times(notes_q[n]) for n in songs}
    pitch = [a[2] == b[2] for n in songs if same_times[n]
             for a, b in zip(notes_f[n], notes_q[n])]
    ok = (agree[0] >= INT8_DECISION_AGREE and agree[1] >= INT8_DECISION_AGREE
          and agree[2] > INT8_PITCH_AGREE)
    log(f"  int8 against float, per frame: onset decisions agree "
        f"{agree[0]:.4f}, offset decisions {agree[1]:.4f} (bar "
        f"{INT8_DECISION_AGREE}), pitch class {agree[2]:.4f} (bar "
        f"{INT8_PITCH_AGREE}); largest probability difference "
        f"{prob_err:.4f} -> {'ok' if ok else 'FAIL'}")
    log(f"  int8 against float, per note (the JAX test's bar at TINY size: "
        f"equal note times, pitch agreeing on more than 0.7): equal times "
        f"per song {same_times}; notes float/int8 "
        f"{ {n: (len(notes_f[n]), len(notes_q[n])) for n in songs} }; pitch "
        f"agreement on songs with equal times "
        f"{np.mean(pitch) if pitch else float('nan'):.4f}")
    if not ok:
        raise AssertionError("int8 serving strays from float serving")


def int8_f32_batch_check(qbridge, head, rng):
    """One int8 batch of 2 chunks (one ragged) in f32: the card (the
    kernel) against the CPU (the plain version), logits on valid frames."""
    song = {"f32_check": rng.standard_normal(int(8.3 * SR)).astype(np.float32)}
    logits = {}
    for dev in ("cuda", "cpu"):
        tr = BatchedAMTTranscriber(qbridge, head, chunk_seconds=5.0,
                                   batch_size=2, compute_dtype=torch.float32,
                                   device=dev)
        (wavs, lens, order), = tr._jobs(song)
        ops.reset_launch_counts()
        with torch.inference_mode():
            w = torch.from_numpy(wavs).to(dev)
            out = tr.head(tr.bridge(w, wav_lens=torch.from_numpy(lens).to(dev)))
        logits[dev] = out.float().cpu()
        launches = ops.launch_counts()["int8_matmul"]
        if launches != (49 if dev == "cuda" else 0):
            raise AssertionError(f"{dev}: {launches} int8 launches")
        valid = [f for _, _, f in order]
    err = torch.cat([(logits["cuda"][j, :f] - logits["cpu"][j, :f]).abs()
                     .flatten() for j, f in enumerate(valid)])
    median, worst = err.median().item(), err.max().item()
    ok = (median <= TOL_INT8_E2E["median"] and worst <= TOL_INT8_E2E["max"]
          and all(torch.isfinite(l).all() for l in logits.values()))
    log(f"  f32 int8 batch of 2 chunks, card (kernel) vs CPU (plain) logits "
        f"on valid frames {valid}: median abs err={median:.3e} (tol "
        f"{TOL_INT8_E2E['median']:.0e}), max={worst:.3e} (tol "
        f"{TOL_INT8_E2E['max']}), logits std "
        f"{logits['cpu'].std().item():.3f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("f32 int8 serving on the card disagrees with "
                             "the CPU's plain path")


def batch_ms(tr, rng):
    """Device-and-launch time of one full batch of 8 five-second chunks
    through ``tr`` (no upload, no copy back), and its int8 launches."""
    wavs = torch.from_numpy(rng.standard_normal((8, tr.chunk_samples))
                            .astype(np.float32)).cuda()
    lens = torch.ones(8, device="cuda")
    ops.reset_launch_counts()
    tr._forward(wavs, lens)
    launches = ops.launch_counts()["int8_matmul"]
    return time_ms(lambda: tr._forward(wavs, lens), iters=10, warmup=2), \
        launches


def int8_batch_device(tr, rng, reps=5):
    """The int8 kernel's device time in one full batch of 8 five-second
    chunks through ``tr`` and its share of the batch's kernel time
    (torch.profiler over ``reps`` batches)."""
    from torch.profiler import ProfilerActivity, profile

    wavs = torch.from_numpy(rng.standard_normal((8, tr.chunk_samples))
                            .astype(np.float32)).cuda()
    lens = torch.ones(8, device="cuda")
    tr._forward(wavs, lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            tr._forward(wavs, lens)
        torch.cuda.synchronize()
    spans = [(ev.name, ev.time_range.end - ev.time_range.start)
             for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(d for _, d in spans)
    int8 = sum(d for name, d in spans if "int8_matmul" in name)
    if not total:
        return None, None
    return int8 / reps / 1e3, int8 / total


def int8_serving_phase(bridge, head, songs, rng):
    """Phase 8; returns (launch counts of the int8 path, the float and int8
    interfaces, summary)."""
    modules = {"wav2vec2": bridge, "model": head}
    faces = {mode: SingingTranscriber(modules=modules, hparams=HPARAMS,
                                      batch_size=8, chunk_seconds=5.0,
                                      quantize=mode)
             for mode in (None, "int8")}
    n_batches = len(faces[None]._get_transcriber()._jobs(songs))
    audio_s = sum(len(w) for w in songs.values()) / SR
    for face in faces.values():
        face.transcribe_batch(songs)            # warm-up, packs the weights
    walls, notes, counts = {None: [], "int8": []}, {}, {}
    for mode in (None, "int8", "int8", None):   # in turns on one card
        notes[mode], wall, counts[mode] = run_path(faces[mode], songs)
        walls[mode].append(wall)
    for mode, name in ((None, "float"), ("int8", "int8")):
        wall = float(np.mean(walls[mode]))
        log(f"  {name}: {audio_s:.1f} s of audio in {wall * 1e3:.1f} ms wall "
            f"(runs {[round(w * 1e3, 1) for w in walls[mode]]}): RTFx="
            f"{audio_s / wall:.1f}, {wall * 1e3 / n_batches:.2f} ms per batch; "
            f"launches {counts[mode]}")
    want = {None: 0, "int8": 49 * n_batches}
    for mode in want:
        if counts[mode]["int8_matmul"] != want[mode]:
            raise AssertionError(
                f"quantize={mode}: {counts[mode]['int8_matmul']} int8 "
                f"launches over {n_batches} batches, want {want[mode]}")
    check_frames(faces["int8"]._get_transcriber(), songs)
    int8_against_float(faces[None]._get_transcriber(),
                       faces["int8"]._get_transcriber(), songs, notes[None],
                       notes["int8"])

    trs = {"float": faces[None]._get_transcriber(),
           "int8": faces["int8"]._get_transcriber(),
           "int8 + quantize_attn": BatchedAMTTranscriber(
               quantize_wav2vec2(bridge, quantize_attn=True), head,
               chunk_seconds=5.0, batch_size=8)}
    per_batch = {}
    for name in ("float", "int8", "int8 + quantize_attn",
                 "int8 + quantize_attn", "int8", "float"):
        ms, launches = batch_ms(trs[name], rng)
        per_batch.setdefault(name, []).append(ms)
        if launches != {"float": 0, "int8": 49}.get(name, 145):
            raise AssertionError(f"{name}: {launches} int8 launches a batch")
    log("  one full batch on the device (forward only, in turns): "
        + "; ".join(f"{name} {np.mean(v):.3f} ms {[round(x, 3) for x in v]}"
                    for name, v in per_batch.items())
        + "; launches a batch 0 / 49 / 145")
    for name in ("int8", "int8 + quantize_attn"):
        dev, share = int8_batch_device(trs[name], rng)
        log(f"  {name}: the int8 kernel's device time in one batch "
            + ("not measured" if dev is None else
               f"{dev:.3f} ms ({100 * share:.1f}% of the batch's kernel "
               f"time; torch.profiler over 5 batches)"))
    log("  where the device time goes, int8 (torch.profiler, one "
        "predict_frames):")
    profile_run(lambda: trs["int8"].predict_frames(songs))
    del trs["int8 + quantize_attn"]
    int8_f32_batch_check(faces["int8"]._serving_bridge(), head, rng)
    summary = {name: audio_s / float(np.mean(walls[mode]))
               for mode, name in ((None, "rtfx_float"), ("int8", "rtfx_int8"))}
    summary.update({f"batch_ms {k}": float(np.mean(v))
                    for k, v in per_batch.items()})
    return counts["int8"], faces, summary


def feed_unevenly(sessions, songs, rng):
    """Round-robin feeds in uneven pieces until every song is exhausted,
    then flush; returns name → notes."""
    got = {name: [] for name in songs}
    pos = {name: 0 for name in songs}
    while any(pos[n] < len(songs[n]) for n in songs):
        for name, wav in songs.items():
            if pos[name] < len(wav):
                step = int(rng.integers(8000, 130000))
                got[name] += sessions[name].feed(wav[pos[name]:pos[name] + step])
                pos[name] += step
    for name in songs:
        got[name] += sessions[name].flush()
    return got


def streamed_against_offline(face, head, songs, rng, int8):
    """A ``StreamingServer`` (batch 8) of ``face`` with one session per song
    fed in uneven pieces, and a dedicated ``StreamingAMTTranscriber`` (batch
    1) per song, each against the offline exact decode.

    Exact equality is held between programs of one batch width: the server
    against the offline decode at batch 8, a dedicated stream against the
    offline decode at batch 1. Rows of a batch do not depend on each other,
    but the library's bf16 products and convolutions choose their kernels
    (and summation orders) by the batch's size, so across widths the logits
    differ in their last bits and an untrained head's decisions near a
    threshold may flip: server against dedicated stream is reported."""
    tag = "int8" if int8 else "float"
    server = face.serve(batch_size=8)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = feed_unevenly({name: server.open(name) for name in songs}, songs,
                        rng)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    windows = sum(-(-len(w) // (5 * SR)) for w in songs.values())
    log(f"  {tag} server: {len(songs)} sessions (one int16), {windows} "
        f"windows, {wall * 1e3:.1f} ms wall, launches {counts}")
    batches = counts["flash_attention_short"] // 24
    if counts["int8_matmul"] != (49 * batches if int8 else 0) \
            or not batches or server.open_sessions or server.pending:
        raise AssertionError(f"the {tag} server left work undone or "
                             f"launched the int8 kernel another number of "
                             f"times than 49 a batch (int8) or 0 (float)")
    # each song is decoded offline on its own: a set of songs of both PCM
    # types would put int16 and float chunks into one batch, where the
    # offline transcriber (like the JAX one) stacks them without the int16
    # rows' 1/32768 scaling
    offline = {8: face._get_transcriber(),
               1: BatchedAMTTranscriber(face._serving_bridge(), head,
                                        chunk_seconds=5.0, batch_size=1)}
    exact = {width: {name: tr.transcribe({name: wav}, fast=False)[name]
                     for name, wav in songs.items()}
             for width, tr in offline.items()}
    for name, wav in songs.items():
        stream = face.stream()
        dedicated = stream.feed(wav) + stream.flush()
        same = (got[name] == exact[8][name], dedicated == exact[1][name])
        across = len({tuple(n) for n in got[name]}
                     & {tuple(n) for n in dedicated})
        log(f"  {tag} {name}: server {len(got[name])} notes, equal to the "
            f"offline exact decode at batch 8: {same[0]}; dedicated stream "
            f"{len(dedicated)} notes, equal to the offline exact decode at "
            f"batch 1: {same[1]}; server against dedicated stream (batch 8 "
            f"against batch 1, reported): equal={got[name] == dedicated}, "
            f"{across} notes in both")
        if not all(same) or not got[name] or not dedicated:
            raise AssertionError(f"{tag} {name}: streamed notes differ from "
                                 f"the offline exact decode at the same "
                                 f"batch width")


def int8_streaming_phase(faces, head, songs, rng):
    """Phase 9: ``faces`` are the interfaces of phase 8 (None → float,
    "int8" → int8)."""
    streamed_against_offline(faces["int8"], head, songs, rng, int8=True)
    streamed_against_offline(faces[None], head, songs, rng, int8=False)
    face = faces["int8"]
    tr = BatchedAMTTranscriber(face._serving_bridge(), head,
                               chunk_seconds=5.0, batch_size=1,
                               chunking="song")
    song = {"whole_song": songs_for(rng, (23,))["song0_23s"]}
    tr.transcribe(song)
    notes, wall, counts = run_path(tr, song)
    check_frames(tr, song)
    log(f"  int8 song mode (30 s window, M = 1499): "
        f"{len(notes['whole_song'])} notes, {wall * 1e3:.1f} ms wall, "
        f"launches {counts}")
    if counts["int8_matmul"] != 49 or counts["flash_attention"] <= 0:
        raise AssertionError("int8 song mode did not launch the int8 and "
                             "streaming attention kernels")


# ------------------------------------------------------------ RNN-T kernels
def rnnt_case(gen, b, t, u, v, t_rel, u_lens):
    """Normal logits on the card, labels in 1..V-1, int32 lengths, and the
    alpha and beta panels made from them as the loss makes them."""
    logits = torch.randn(b, t, u + 1, v, generator=gen, device="cuda")
    targets = torch.randint(1, v, (b, u), generator=gen, device="cuda",
                            dtype=torch.int32)
    t_len = torch.round(torch.tensor(t_rel, device="cuda") * t).int()
    u_len = torch.tensor(u_lens, device="cuda", dtype=torch.int32)
    lse = torch.logsumexp(logits, -1)
    skip, emit_pad = tl._gather_skip_emit(logits, lse, targets, RNNT_BLANK)
    seed = torch.full_like(skip, tl.NEG_INF)
    seed[:, 0, 0] = 0.0
    beta_panels = tl._masked_panels(logits, lse, targets, t_len, u_len,
                                    RNNT_BLANK)
    return dict(logits=logits, targets=targets, t_len=t_len, u_len=u_len,
                lse=lse, alpha_panels=(skip, emit_pad, seed),
                beta_panels=beta_panels,
                t_rel=torch.tensor(t_rel, device="cuda"),
                u_rel=u_len.float() / max(u, 1))


def rnnt_valid(case, extra_row=0):
    """(B, T + extra_row, U1) bool: each row's valid region, t < T(b) and
    u <= U(b)."""
    _, t, u1, _ = case["logits"].shape
    t_grid = torch.arange(t + extra_row, device="cuda")[None, :, None]
    u_grid = torch.arange(u1, device="cuda")[None, None, :]
    return ((t_grid < case["t_len"][:, None, None])
            & (u_grid <= case["u_len"][:, None, None]))


def rnnt_grad_args(case, alpha, beta, g):
    final = tl._masks(case["t_len"], case["u_len"], alpha.shape[1],
                      alpha.shape[2])[2]
    log_z = torch.where(final, alpha + case["alpha_panels"][0],
                        torch.zeros_like(alpha)).sum((1, 2))
    return (case["logits"], case["lse"], case["targets"], alpha, beta, log_z,
            case["t_len"], case["u_len"], g, RNNT_BLANK, False)


def lattice_routes(panels, reverse):
    """The plans a lattice of these panels is held and timed by: the
    route ``lattice_plan`` gives (first), and route B beside route A where
    U1 takes route A."""
    b, rows, u1 = panels[2].shape
    plan = tl.lattice_plan(b, rows, u1, reverse)
    return [plan] + ([tl._block_plan(b, u1)] if plan.route == "warp" else [])


def check_rnnt(gen, errs):
    """6a on alpha panels (whole grid) and on the masked beta panels (each
    row's valid region) against ``lattice_plain``; 6b against
    ``rnnt_grad_plain`` on the kernel's lattices; the fused loss through the
    kernels against the plain path (``lattice="scan"``), and at the small
    shape against autograd through the plain ``transducer_loss``."""
    for b, t, u, v, t_rel, u_lens in RNNT_CASES:
        case = rnnt_case(gen, b, t, u, v, t_rel, u_lens)
        shape = tuple(case["logits"].shape)
        lattices, worst = {}, 0.0
        for name, panels, reverse, live in (
                ("alpha", case["alpha_panels"], False, None),
                ("beta", case["beta_panels"], True, rnnt_valid(case, 1))):
            # beta's grid has one more row, T(b), whose only live cell is
            # the seed: rnnt_valid(case, 1) marks rows below T(b) only
            want = tl.lattice_plain(*panels, reverse=reverse)
            got = {}
            for plan in lattice_routes(panels, reverse):
                out = tl._launch(*panels, reverse, plan=plan)[0]
                torch.cuda.synchronize()
                err, size = (out - want).abs(), want.abs()
                if live is not None:
                    err, size = err[live], size[live]
                ok = (torch.isfinite(out).all().item()
                      and (err <= RNNT_TOL["lattice_atol"]
                           + RNNT_TOL["lattice_rtol"] * size).all().item())
                log(f"  rnnt_lattice {name} {shape[:3]} route {plan.route}: "
                    f"max_abs_err={err.max().item():.3e} at values up to "
                    f"{size.max().item():.1f} (atol "
                    f"{RNNT_TOL['lattice_atol']:.0e} + rtol "
                    f"{RNNT_TOL['lattice_rtol']:.0e}) -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"rnnt_lattice {name} route "
                                         f"{plan.route} disagrees with its "
                                         f"plain version")
                got[plan.route] = out
                worst = max(worst, err.max().item())
            if len(got) == 2:
                mask = torch.ones_like(want, dtype=torch.bool) \
                    if live is None else live
                same = torch.equal(got["warp"][mask], got["block"][mask])
                log(f"  rnnt_lattice {name} {shape[:3]}: route A and route B "
                    f"bit for bit on the valid region: {same}")
                if not same:
                    raise AssertionError("the lattice routes differ")
            lattices[name] = got[lattice_routes(panels, reverse)[0].route]
        g = torch.linspace(0.5, 1.5, b, device="cuda")
        args = rnnt_grad_args(case, lattices["alpha"], lattices["beta"], g)
        got = tl.rnnt_grad(*args)
        torch.cuda.synchronize()
        want = tl.rnnt_grad_plain(*args)
        err = (got - want).abs().max().item()
        dead_zero = (got[~rnnt_valid(case)] == 0).all().item()
        ok = (err <= RNNT_TOL["grad_atol"] and dead_zero
              and got.abs().max().item() > 0)
        log(f"  rnnt_grad {shape}: max_abs_err={err:.3e} tol="
            f"{RNNT_TOL['grad_atol']:.0e} gradient peak "
            f"{want.abs().max().item():.3f} zero outside the valid region="
            f"{dead_zero} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("rnnt_grad disagrees with its plain version")
        if (b, t) == RNNT_CASES[0][:2]:
            errs[("rnnt_lattice", "f32")] = worst
            errs[("rnnt_grad", "f32")] = err
        del got, want, args, lattices

        routes = [("kernel", tl.transducer_loss_fused, "kernel"),
                  ("plain", tl.transducer_loss_fused, "scan")]
        if t < 100:
            routes.append(("autograd", transducer_loss, None))
        out = {}
        for key, fn, lattice in routes:
            leaf = case["logits"].clone().requires_grad_()
            kwargs = {} if lattice is None else {"lattice": lattice}
            nll = fn(leaf, case["targets"], case["t_rel"], case["u_rel"],
                     RNNT_BLANK, reduction="none", **kwargs)
            (nll * g).sum().backward()
            out[key] = (nll.detach(), leaf.grad)
            del leaf
        for key, grad_atol in (("plain", RNNT_TOL["grad_atol"]),
                               ("autograd", RNNT_TOL["oracle_grad_atol"])):
            if key not in out:
                continue
            loss_err = ((out["kernel"][0] - out[key][0]).abs()
                        / out[key][0].abs()).max().item()
            grad_err = (out["kernel"][1] - out[key][1]).abs().max().item()
            ok = loss_err <= RNNT_TOL["loss_rtol"] and grad_err <= grad_atol
            log(f"  fused loss {shape}, kernels against {key}: row losses "
                f"{[round(x, 3) for x in out['kernel'][0].tolist()]}, loss "
                f"rel err={loss_err:.3e} (tol {RNNT_TOL['loss_rtol']:.0e}), "
                f"d_logits max_abs_err={grad_err:.3e} (tol {grad_atol:.0e}) "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the fused loss through the kernels "
                                     f"disagrees with the {key} path")
        del out, case
        torch.cuda.empty_cache()


def lattice_route_timings(case, gen):
    """6a by route: alpha and beta at the training shape through route A
    and through route B (the first port's design, forced by the launch
    helper's ``plan``), in turns (A, B, B, A), and alpha at U1 = 128 and
    129, the widest of route A and the narrowest of route B, on panels of
    V = 16 logits with the training batch's lengths. Each: the device time
    a launch (torch.profiler) and the time through the wrapper (CUDA
    events), the mean of its passes. Returns {(lattice, route): ...} at
    the training shape."""
    def timed(panels, reverse, plan):
        fn = functools.partial(tl._launch, *panels, reverse, plan=plan)
        return kernel_device_ms(fn, "rnnt_lattice"), time_ms(fn, iters=10,
                                                             warmup=2)

    got = {}
    for name, panels, reverse in (("alpha", case["alpha_panels"], False),
                                  ("beta", case["beta_panels"], True)):
        plans = lattice_routes(panels, reverse)
        for plan in plans + plans[::-1]:
            got.setdefault((name, plan.route), []).append(
                timed(panels, reverse, plan))
    b, t, _, _, t_rel, u_lens = RNNT_CASES[0]
    for u in (tl.WARP_MAX_U1 - 1, tl.WARP_MAX_U1):
        wide = rnnt_case(gen, b, t, u, 16, t_rel,
                         [round(n * u / 80) for n in u_lens])
        for plan in lattice_routes(wide["alpha_panels"], False):
            got[(f"alpha U1={u + 1}", plan.route)] = [
                timed(wide["alpha_panels"], False, plan)]
        del wide
    out = {}
    for (name, route), runs in got.items():
        dev = [d for d, _ in runs if d is not None]
        r = dict(device_ms=sum(dev) / len(dev) if dev else None,
                 ms=sum(w for _, w in runs) / len(runs))
        out[(name, route)] = r
        dev_txt = ("not measured" if r["device_ms"] is None
                   else f"{r['device_ms']:.4f}")
        log(f"  rnnt_lattice {name} route {'A' if route == 'warp' else 'B'}"
            f": device {dev_txt} ms a launch, through the wrapper "
            f"{r['ms']:.4f} ms")
    return out


def rnnt_timings(gen):
    """6a (alpha; beta beside it) and 6b at the training shape, beside their
    plain versions, the whole fused loss forward + backward through the
    kernels, and autograd through the plain ``transducer_loss``, which is
    what a user would run without the kernels. Bounds, from this batch's
    lengths: 6a moves its four f32 panels once; 6b reads the logits (and
    4 floats of lattice state) of the cells with a nonzero posterior and
    writes every cell. No PyTorch call computes either function."""
    b, t, u, v, t_rel, u_lens = RNNT_CASES[0]
    case = rnnt_case(gen, b, t, u, v, t_rel, u_lens)
    cells = b * t * (u + 1)
    alpha = tl.rnnt_lattice(*case["alpha_panels"])
    beta = tl.rnnt_lattice(*case["beta_panels"], reverse=True)
    g = torch.ones(b, device="cuda")
    args = rnnt_grad_args(case, alpha, beta, g)
    live = int((tl.rnnt_grad(*args).abs().amax(-1) > 0).sum())
    rows = {}
    b_ms, b_by = bound(0, 4 * 4 * cells, PEAK_F32)
    by_route = lattice_route_timings(case, gen)
    alpha_a, beta_a = by_route[("alpha", "warp")], by_route[("beta", "warp")]
    beta_dev = ("not measured" if beta_a["device_ms"] is None
                else f"{beta_a['device_ms']:.4f} ms")
    rows["rnnt_lattice"] = dict(
        ms=alpha_a["ms"], device_ms=alpha_a["device_ms"],
        plain_ms=time_ms(lambda: tl.lattice_plain(*case["alpha_panels"]),
                         iters=2, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"alpha panels ({b}, {t}, {u + 1}) f32, route A, {t + u} "
              f"dependent steps (beta: {beta_a['ms']:.4f} ms, device "
              f"{beta_dev}, {t + u + 1} steps)")
    # per live cell: V logits, lse, alpha and two betas read; per cell: V
    # gradients written
    b_ms, b_by = bound(6 * live * v, 4 * (live * (v + 4) + cells * v),
                       PEAK_F32)
    rows["rnnt_grad"] = dict(
        ms=time_ms(lambda: tl.rnnt_grad(*args), iters=10, warmup=2),
        plain_ms=time_ms(lambda: tl.rnnt_grad_plain(*args), iters=3,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"logits ({b}, {t}, {u + 1}, {v}) f32, {live} of {cells} "
              f"cells live")
    del alpha, beta, args

    def loss_step(fn, **kwargs):
        leaf = case["logits"].detach().requires_grad_()
        fn(leaf, case["targets"], case["t_rel"], case["u_rel"], RNNT_BLANK,
           **kwargs).backward()

    fused_ms = time_ms(lambda: loss_step(tl.transducer_loss_fused), iters=5,
                       warmup=1)
    plain_ms = time_ms(lambda: loss_step(tl.transducer_loss_fused,
                                         lattice="scan"), iters=2, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss_step(tl.transducer_loss_fused)
    fused_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    auto_ms = time_ms(lambda: loss_step(transducer_loss), iters=2, warmup=1)
    auto_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f"  the loss forward + backward at ({b}, {t}, {u + 1}, {v}) f32: "
        f"through the kernels {fused_ms:.3f} ms (peak {fused_gb:.2f} GiB "
        f"above the logits), through the plain versions {plain_ms:.3f} ms, "
        f"autograd through the plain transducer_loss {auto_ms:.3f} ms "
        f"(peak {auto_gb:.2f} GiB)")
    del case
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phases 10-12
class TransducerBrain(Brain):
    """The RNN-T assembly: wav2vec2 → ``enc_lin``; blank-prefixed labels →
    ``emb`` → ``dec`` (GRU) → ``dec_lin``; sum joint with leaky_relu →
    ``out``; ``TransducerLoss(fused=True)``. Adam on ``wav2vec2``, Adadelta
    on the rest, as ``AudioAMT``. With ``self.marks`` a list, CUDA events
    are recorded at the segment boundaries of the forward and, through
    gradient hooks, of the backward, and ``d_logits_seen`` gets the shape
    of the gradient that reached the logits and whether it was finite; with
    ``keep_logits`` the step's logits stay in ``last_logits`` with their
    gradient."""

    HEADS = ("enc_lin", "emb", "dec", "dec_lin", "out")
    marks = None
    d_logits_seen = None
    keep_logits = False
    last_logits = None

    def mark(self, label):
        if self.marks is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((label, event))

    def _mark_grad(self, tensor, label):
        if self.marks is not None and tensor.requires_grad:
            tensor.register_hook(lambda grad: self.mark(label))

    def _see_d_logits(self, grad):
        self.d_logits_seen = (tuple(grad.shape), torch.isfinite(grad).all())

    def compute_forward(self, batch, stage, rng=None):
        m = self.modules
        wavs, wav_lens = batch["sig"]
        tokens, token_lens = batch["tokens"]
        self.mark("start")
        feats = m.wav2vec2(wavs, rng=rng, train=True,
                           row_mask=batch.get("valid_rows"))
        self._mark_grad(feats, "joint, output and prediction network "
                               "backward")
        self.mark("encoder forward")
        tn = m.enc_lin(feats)
        bos = torch.cat([tokens.new_full((tokens.shape[0], 1), RNNT_BLANK),
                         tokens], dim=1)
        pn, _ = m.dec(m.emb(bos), rng=rng, train=True)
        pn = m.dec_lin(pn)
        self.mark("prediction network and enc_lin forward")
        logits = m.out(self.hparams.joint(tn[:, :, None], pn[:, None]))
        self._mark_grad(logits, "loss backward (gather, 6a beta, 6b)")
        if self.marks is not None and logits.requires_grad:
            logits.register_hook(self._see_d_logits)    # after the mark
        self.mark("joint and output forward")
        if self.keep_logits:
            logits.retain_grad()
            self.last_logits = logits
        return logits, wav_lens, token_lens

    def compute_objectives(self, predictions, batch, stage):
        logits, wav_lens, token_lens = predictions
        loss = self.hparams.loss(logits, batch["tokens"].data, wav_lens,
                                 token_lens)
        self.mark("loss forward (logsumexp, gather, 6a alpha)")
        return loss

    def init_optimizers(self):
        self.add_optimizer("wav2vec", torch.optim.Adam, ["wav2vec2"],
                           lr=self.hparams.lr_wav2vec)
        self.add_optimizer(
            "model", functools.partial(torch.optim.Adadelta, rho=0.95,
                                       eps=1e-8),
            list(self.HEADS), lr=self.hparams.lr)


def rnnt_tree(config, gen):
    h, j, v = config.hidden_size, RNNT["joint"], RNNT["vocab"]
    return {"wav2vec2": init_wav2vec2(config, gen),
            "enc_lin": init_linear(gen, h, j),
            "emb": init_embedding(gen, v, RNNT["emb"]),
            "dec": init_rnn(gen, 3, RNNT["emb"], j),
            "dec_lin": init_linear(gen, j, j), "out": init_linear(gen, j, v)}


def rnnt_modules(tree, arch, cell=False):
    bridge = HuggingFaceWav2Vec2(source="facebook/wav2vec2-large-lv60",
                                 output_norm=True, arch_overrides=arch)
    h, j, v = bridge.config.hidden_size, RNNT["joint"], RNNT["vocab"]
    dec = GRUCell if cell else GRU
    modules = {"wav2vec2": bridge, "enc_lin": Linear(j, h),
               "emb": Embedding(v, RNNT["emb"], blank_id=RNNT_BLANK),
               "dec": dec(j, input_size=RNNT["emb"]),
               "dec_lin": Linear(j, j), "out": Linear(v, j)}
    for name, module in modules.items():
        load_module_tree(module, tree[name])
    return modules


def rnnt_brain(tree, arch, device):
    hp = amt_hparams()
    brain = TransducerBrain(
        rnnt_modules(tree, arch),
        hparams=dict(seed=hp["seed"], lr=hp["lr"], lr_wav2vec=hp["lr_wav2vec"],
                     joint=Transducer_joint(joint="sum",
                                            nonlinearity="leaky_relu"),
                     loss=TransducerLoss(blank_index=RNNT_BLANK, fused=True)),
        run_opts={"device": device})
    brain.init_optimizers()
    return brain


def rnnt_batch(rng, batch, seconds, labels, t_rel, u_lens):
    wav = (0.1 * rng.standard_normal((batch, int(seconds * SR)))
           ).astype(np.float32)
    tokens = rng.integers(1, RNNT["vocab"], (batch, labels))
    return {"sig": PaddedData(torch.from_numpy(wav).pin_memory(),
                              np.asarray(t_rel, np.float32)),
            "tokens": PaddedData(torch.from_numpy(tokens),
                                 np.asarray(u_lens, np.float32) / labels)}


def bias_the_blank(tree, arch):
    """Random weights give 1000 near-equal logits, among which the blank
    almost never reaches the top 4, and then the beam search's expansion
    loop does not end. Raise the output bias of the blank to the 0.998
    quantile of the joint's logits over one 5 s row (two labels in a
    thousand above the blank on average), so that greedy emits on some
    frames and every beam step finds the blank."""
    m = torch.nn.ModuleDict(rnnt_modules(tree, arch)).cuda().eval()
    gen = torch.Generator().manual_seed(SEED + 2)
    wav = 0.1 * torch.randn(1, 5 * SR, generator=gen)
    with torch.inference_mode():
        tn = m["enc_lin"](m["wav2vec2"](wav.cuda()))
        bos = torch.full((1, 1), RNNT_BLANK, device="cuda")
        pn = m["dec_lin"](m["dec"](m["emb"](bos))[0])
        logits = m["out"](torch.nn.functional.leaky_relu(
            tn[:, :, None] + pn[:, None]))
    shift = (torch.quantile(logits.flatten().float(), 0.998)
             - logits[..., RNNT_BLANK].mean()).item()
    tree["out"]["b"][RNNT_BLANK] += shift
    log(f"  output bias of the blank raised by {shift:.4f} (the 0.998 "
        f"quantile of the untrained joint's logits, std "
        f"{logits.std().item():.4f})")
    del m
    torch.cuda.empty_cache()


def segment_times(brain, batch):
    """One more step with CUDA events at the segment boundaries; returns
    [(segment, ms)] in the order the device ran them. The device is busy
    throughout a step, so the time between two events is the segment's."""
    brain.marks = []
    torch.cuda.synchronize()
    brain.fit_batch(batch)
    brain.mark("encoder backward, gradient clip, optimizers")
    torch.cuda.synchronize()
    marks, brain.marks = brain.marks, None
    return [(label, before.elapsed_time(event))
            for (_, before), (label, event) in zip(marks, marks[1:])]


def rnnt_training_phase(rng):
    """Phase 10; returns (launch counts of a step, the seeded tree the
    training started from, summary)."""
    arch = {}                                   # lv60, all dropouts 0.1
    tree = rnnt_tree(Wav2Vec2Config(**arch),
                     torch.Generator().manual_seed(SEED + 3))
    bias_the_blank(tree, arch)
    brain = rnnt_brain(tree, arch, "cuda")
    n_batch = len(RNNT_T_REL)
    batch = rnnt_batch(rng, n_batch, RNNT["seconds"], RNNT["labels"],
                       RNNT_T_REL, RNNT_U_LENS)
    frames = brain.modules.wav2vec2.config.output_length(
        int(RNNT["seconds"] * SR))
    log(f"  batch {n_batch} x {RNNT['seconds']:.0f} s (T = {frames} frames, "
        f"relative lengths {RNNT_T_REL}), U = {RNNT['labels']} labels of "
        f"{RNNT['vocab']} (lengths {RNNT_U_LENS}); logits ({n_batch}, "
        f"{frames}, {RNNT['labels'] + 1}, {RNNT['vocab']}) f32; "
        f"{brain.modules.wav2vec2.config.num_layers} layers, dropouts 0.1")
    torch.cuda.reset_peak_memory_stats()
    steps = train_steps(brain, batch, 4)        # the first is the warm-up
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (loss, gnorm, wall, counts) in enumerate(steps):
        log(f"  step {i} {'(warm-up)' if i == 0 else ''}: loss={loss:.4f} "
            f"gnorm={gnorm:.4f} {wall * 1e3:.1f} ms launches={counts}")
        expect_counts(counts, {"rnnt_lattice": 2, "rnnt_grad": 1},
                      "RNN-T training step")
    losses_seen = [s[0] for s in steps]
    if not losses_seen[-1] < losses_seen[0]:
        raise AssertionError(f"the loss did not fall over the repeated "
                             f"batch: {losses_seen}")
    step_s = float(np.median([w for _, _, w, _ in steps[1:]]))
    audio_s = sum(RNNT_T_REL) * RNNT["seconds"]
    log(f"  median step {step_s * 1e3:.1f} ms: {audio_s / step_s:.1f} s of "
        f"audio trained per second; peak memory {peak_gb:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    segments = segment_times(brain, batch)
    shape, finite = brain.d_logits_seen
    if not finite.item() or shape != (n_batch, frames, RNNT["labels"] + 1,
                                      RNNT["vocab"]):
        raise AssertionError("no finite gradient of the expected shape "
                             "reached the logits")
    total = sum(ms for _, ms in segments)
    log("  where the device time goes, by segment (CUDA events, one step):")
    for label, ms in segments:
        log(f"    {ms:9.3f} ms ({100 * ms / total:5.1f}%) {label}")
    log("  and by kernel (torch.profiler, one step):")
    idle = profile_run(lambda: brain.fit_batch(batch))
    del brain
    torch.cuda.empty_cache()
    return steps[-1][3], tree, dict(
        step_ms=step_s * 1e3, audio_rate=audio_s / step_s, peak_gb=peak_gb,
        idle=idle, loss_first=losses_seen[0], loss_last=losses_seen[-1],
        segments={label: ms for label, ms in segments})


def rnnt_searcher(modules, beam):
    """``TransducerBeamSearcher`` over the prediction network (``emb`` →
    GRU cell → ``dec_lin``) and the joint (sum, leaky_relu → ``out``)."""
    joint = Transducer_joint(joint="sum", nonlinearity="leaky_relu")

    def decode_fn(tokens, state):
        out, state = modules["dec"](modules["emb"](tokens), state)
        return modules["dec_lin"](out), state

    def joint_fn(enc_frame, dec_out):
        return modules["out"](joint(enc_frame, dec_out))

    return TransducerBeamSearcher(decode_fn, joint_fn, RNNT_BLANK,
                                  beam_size=beam, state_beam=2.3,
                                  expand_beam=2.3)


def decoding_modules(tree, arch, device):
    """The assembly for decoding: eval mode, the GRU as a cell."""
    return torch.nn.ModuleDict(rnnt_modules(tree, arch, cell=True)).to(
        device).eval()


def rnnt_decoding_phase(tree, rng):
    """Phase 11, on the seeded weights phase 10 started from: a few steps on
    one repeated batch already teach the model to emit the blank everywhere,
    and then there is nothing to search."""
    modules = decoding_modules(tree, {}, "cuda")
    n_batch = len(RNNT_T_REL)
    wav = torch.from_numpy((0.1 * rng.standard_normal(
        (n_batch, int(RNNT["seconds"] * SR)))).astype(np.float32)).cuda()
    with torch.inference_mode():
        tn = modules["enc_lin"](modules["wav2vec2"](wav))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps, score, _, _ = rnnt_searcher(modules, 1)(tn)
        greedy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        best, beam_score, nbest, nbest_scores = rnnt_searcher(
            modules, RNNT["beam"])(tn[:1, :249])
        beam_s = time.perf_counter() - t0
    log(f"  greedy, batch {n_batch} x {tn.shape[1]} frames: "
        f"{greedy_s * 1e3:.1f} ms wall, hypothesis lengths "
        f"{[len(h) for h in hyps]}, exp-mean score {score:.3e}")
    log(f"  beam {RNNT['beam']}, one row of 249 frames: {beam_s * 1e3:.1f} "
        f"ms wall, best hypothesis of {len(best[0])} labels, "
        f"{len(nbest[0])} hypotheses of lengths "
        f"{[len(h) for h in nbest[0]]}, normalized scores "
        f"{[round(float(x), 4) for x in nbest_scores[0]]}")
    if not all(0 <= tok < RNNT["vocab"] and tok != RNNT_BLANK
               for h in hyps + nbest[0] for tok in h) \
            or not np.isfinite(beam_score) or len(nbest[0]) == 0 \
            or not any(hyps):
        raise AssertionError("decoding gave no hypothesis, or labels outside "
                             "1..V-1")
    del modules
    torch.cuda.empty_cache()

    arch = dict(num_layers=2)
    tree = rnnt_tree(Wav2Vec2Config(**arch),
                     torch.Generator().manual_seed(SEED + 4))
    bias_the_blank(tree, arch)
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, 5 * SR)))
                           .astype(np.float32))
    got = {}
    for dev in ("cuda", "cpu"):
        modules = decoding_modules(tree, arch, dev)
        with torch.inference_mode():
            tn = modules["enc_lin"](modules["wav2vec2"](wav.to(dev)))
            got[dev] = rnnt_searcher(modules, 1)(tn)[:2]
        del modules
    same = got["cuda"][0] == got["cpu"][0]
    log(f"  greedy, 2 layers, f32, 2 x 5 s: card hypotheses of lengths "
        f"{[len(h) for h in got['cuda'][0]]} equal to the CPU's: {same}; "
        f"scores {got['cuda'][1]:.6e} / {got['cpu'][1]:.6e}")
    if not same or not any(got["cuda"][0]):
        raise AssertionError("greedy decoding on the card differs from the "
                             "CPU")
    torch.cuda.empty_cache()
    return dict(greedy_ms=greedy_s * 1e3, beam_ms=beam_s * 1e3)


def rnnt_card_vs_cpu_step(rng):
    """Phase 12: 2 lv60-width layers, all dropouts 0, batch 2 x 5 s, U = 20
    (lengths 20 and 11, input lengths 1 and 0.8), one f32 step."""
    arch = dict(num_layers=2, hidden_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, attention_dropout=0.0)
    tree = rnnt_tree(Wav2Vec2Config(**arch),
                     torch.Generator().manual_seed(SEED + 5))
    batch = rnnt_batch(rng, 2, 5.0, 20, [1.0, 0.8], [20, 11])
    result = {}
    for dev in ("cuda", "cpu"):
        brain = rnnt_brain(tree, arch, dev)
        brain.keep_logits = True
        params = dict(brain.modules.named_parameters())
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss = brain.fit_batch(batch)
        wall = time.perf_counter() - t0
        result[dev] = dict(
            loss=loss, gnorm=brain.last_grad_norm, counts=ops.launch_counts(),
            d_logits=brain.last_logits.grad.cpu(),
            grads={n: p.grad.cpu() for n, p in params.items()})
        log(f"  {dev}: loss={loss:.6f} gnorm={brain.last_grad_norm:.6f} "
            f"{wall:.1f} s launches={result[dev]['counts']}")
        del brain, params
    counts = result["cuda"]["counts"]
    if (counts["rnnt_lattice"], counts["rnnt_grad"]) != (2, 1) \
            or any(result["cpu"]["counts"].values()):
        raise AssertionError("the card step must launch 6a twice and 6b "
                             "once, the CPU step nothing")
    got, want = result["cuda"], result["cpu"]
    errs, exempt = leaf_errors(got, want, {"grad_rel": "grads"})
    worst = max(errs["grad_rel"], key=errs["grad_rel"].get)
    loss_rel = abs(got["loss"] / want["loss"] - 1)
    gnorm_rel = abs(got["gnorm"] / want["gnorm"] - 1)
    d_rel = (torch.linalg.vector_norm(got["d_logits"] - want["d_logits"])
             / torch.linalg.vector_norm(want["d_logits"])).item()
    tol = TOL_RNNT_STEP
    ok = (loss_rel <= tol["loss_rel"] and gnorm_rel <= tol["gnorm_rel"]
          and d_rel <= tol["d_logits_rel"]
          and errs["grad_rel"][worst] <= tol["grad_rel"]
          and all(name.endswith("attn.bk") for name in exempt))
    log(f"  card vs CPU: loss rel err={loss_rel:.3e} (tol "
        f"{tol['loss_rel']:.0e}), gnorm rel err={gnorm_rel:.3e} (tol "
        f"{tol['gnorm_rel']:.0e}), d_logits rel err={d_rel:.3e} (tol "
        f"{tol['d_logits_rel']:.0e}); per parameter, worst of "
        f"{len(errs['grad_rel'])}: gradient rel err "
        f"{errs['grad_rel'][worst]:.3e} ({worst}, tol "
        f"{tol['grad_rel']:.0e}); exempt (zero gradient) {exempt} -> "
        f"{'ok' if ok else 'FAIL'}")
    top = sorted(errs["grad_rel"].items(), key=lambda kv: -kv[1])[:5]
    log("    largest grad_rel: " + ", ".join(f"{n} {v:.3e}" for n, v in top))
    if not ok:
        raise AssertionError("the RNN-T training step on the card disagrees "
                             "with the CPU")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 13-14
RECIPE_YAMLS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "svt_speechbrain_tpu_torch", "recipes")


def recipe_yaml(rel, overrides):
    """A port recipe's objects: its yaml (``rel`` under
    ``svt_speechbrain_tpu_torch/recipes/``) read by ``load_hyperyaml``, the
    port's own YAML reader (the card machine needs no PyYAML), with
    ``overrides`` replacing top-level values before the references
    resolve."""
    with open(os.path.join(RECIPE_YAMLS, rel)) as f:
        return load_hyperyaml(f, overrides)


def recipe_hparams(**overrides):
    """The MIR-ST500 recipe's objects (``MIR_ST500/hparams/
    train_audio_ssl.yaml``)."""
    return recipe_yaml("MIR_ST500/hparams/train_audio_ssl.yaml", overrides)


def synthetic_song(rng, duration):
    """(notes, 16 kHz float32 samples) of a song of ``duration`` seconds:
    random notes of 0.2-0.6 s as sines, plus a little noise."""
    notes, t = [], 0.2
    while t < duration - 0.6:
        dur = float(rng.uniform(0.2, 0.6))
        notes.append([round(t, 3), round(t + dur, 3),
                      int(rng.integers(40, 80))])
        t += dur + float(rng.uniform(0.05, 0.4))
    time_s = np.arange(int(duration * SR)) / SR
    sig = np.zeros(len(time_s), np.float32)
    for on, off, midi in notes:
        mask = (time_s >= on) & (time_s < off)
        sig[mask] += 0.5 * np.sin(2 * np.pi * 440.0 * 2 ** (
            (midi - 69) / 12) * time_s[mask]).astype(np.float32)
    sig += 0.01 * rng.standard_normal(len(sig)).astype(np.float32)
    return notes, sig


def make_recipe_set(root, rng, seconds):
    """A MIR-ST500-shaped set under ``root``: per split, songs of sine notes
    plus noise as 16 kHz WAVs (``<split>/<song>/vocals.wav``), one
    ``Annotations.json``, frame annotations and a CSV per split through the
    recipe's ``prepare_benchmarks``. Returns {split: csv path}."""
    gt, csvs = {}, {}
    for split, durations in seconds.items():
        folder = os.path.join(root, split)
        for i, duration in enumerate(durations):
            name = f"{split}{i}"
            gt[name], sig = synthetic_song(rng, duration)
            os.makedirs(os.path.join(folder, name))
            write_audio(os.path.join(folder, name, "vocals.wav"), sig, SR)
    with open(os.path.join(root, "Annotations.json"), "w") as f:
        json.dump(gt, f)
    os.makedirs(os.path.join(root, "csv"))
    for split in seconds:
        folder = os.path.join(root, split)
        prepare_benchmarks.prepare_frame_anno(
            os.path.join(root, "Annotations.json"), folder)
        csvs[split] = os.path.join(root, "csv", f"{split}.csv")
        prepare_benchmarks.prepare_csv_benchmarks(folder, csvs[split])
    return csvs


class Timed:
    """A mixin for a recipe's brain, recording each training step (frozen
    modules, loss, wall, launches), each evaluated utterance (stage, wall,
    audio seconds, launches, logits of the real frames), each epoch's wall,
    the learning rates after each validation, each song's notes and scores,
    and the checkpoint save and recovery times. Walls end in a synchronise
    on the card; the launch counts are read before and after, never reset.
    ``timed_input`` is the batch key whose length gives the audio seconds,
    at ``timed_rate`` items a second."""

    timed_input, timed_rate = "sig", SR

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.steps, self.evals, self.epochs, self.songs = [], [], [], []
        self.valid_lrs, self.saves, self.recovers = [], [], []
        self._song_logits = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _timed(self, fn, *args):
        before = ops.launch_counts()
        self._sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        wall = time.perf_counter() - t0
        after = ops.launch_counts()
        return out, wall, {k: after[k] - before[k] for k in after}

    def fit_batch(self, batch):
        loss, wall, counts = self._timed(super().fit_batch, batch)
        self.steps.append(dict(probe=bool(self.frozen_modules), loss=loss,
                               wall=wall, counts=counts))
        return loss

    def evaluate_batch(self, batch, stage):
        loss, wall, counts = self._timed(super().evaluate_batch, batch, stage)
        sig = batch[self.timed_input]
        self.evals[-1].update(stage=stage.name, wall=wall, counts=counts,
                              audio_s=float(sig.lengths[0]) * sig.data.shape[1]
                              / self.timed_rate)
        return loss

    def on_evaluate_batch_end(self, batch, predictions, loss, stage):
        frames = self._true_frames(batch, predictions[0].shape[1])
        logits = np.concatenate(
            [predictions[0][0, :frames, None], predictions[1][0, :frames, None],
             predictions[2][0, :frames], predictions[3][0, :frames]], -1)
        self.evals.append(dict(id=batch.id[0], logits=logits))
        self._song_logits.append(logits)
        super().on_evaluate_batch_end(batch, predictions, loss, stage)

    def on_stage_start(self, stage, epoch=None):
        if stage == Stage.TRAIN:
            self._sync()
            self._epoch_t0 = time.perf_counter()
        super().on_stage_start(stage, epoch)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return super().on_stage_end(stage, stage_loss, epoch)
        t0 = time.perf_counter()
        super().on_stage_end(stage, stage_loss, epoch)
        self.saves.append(time.perf_counter() - t0)
        self.valid_lrs.append({o: self.get_learning_rate(o)
                               for o in self.optimizers})
        self.epochs.append(dict(epoch=epoch, valid_loss=stage_loss,
                                f1=self.COnPOff_f1.avg,
                                train_loss=self.train_stats["loss"],
                                wall=time.perf_counter() - self._epoch_t0))

    def on_evaluate_start(self, max_key=None, min_key=None):
        t0 = time.perf_counter()
        super().on_evaluate_start(max_key=max_key, min_key=min_key)
        self.recovers.append(time.perf_counter() - t0)

    def on_song_end(self, batch, est_np):
        super().on_song_end(batch, est_np)
        self.songs.append([batch.id[0].rsplit("_", 1)[0], est_np,
                           np.concatenate(self._song_logits)])
        self._song_logits = []

    def _score_song(self, est_np, ref_intervals, ref_pitchs):
        super()._score_song(est_np, ref_intervals, ref_pitchs)
        self.songs[-1].append({f"{n}_{k}": getattr(self, f"{n}_{k}").val
                               for n in self.metric_names
                               for k in ("precis", "recall", "f1")})


class TimedAMT(Timed, mir_recipe.AMT):
    """The MIR-ST500 recipe's brain, timed."""


def recipe_brain(root, csvs, arch, tree, device, **overrides):
    """The recipe's objects (``recipe_hparams``) over ``csvs`` with
    ``tree``'s weights: (brain, hparams, (train, valid, test sets))."""
    if arch:
        overrides["wav2vec2"] = HuggingFaceWav2Vec2(
            source="facebook/wav2vec2-large-lv60", output_norm=True,
            save_path="ssl_model/wav2vec2-large-lv60", arch_overrides=arch)
    hp = recipe_hparams(
        data_folder=root, output_folder=os.path.join(root, f"out_{device}"),
        train_csv=csvs["train"], valid_csv=csvs["valid"],
        test_csv=[csvs["test"]], **overrides)
    load_jax_params(tree, hp["modules"]["wav2vec2"], hp["modules"]["model"])
    data = mir_recipe.dataio_prepare(hp)
    brain = TimedAMT(modules=hp["modules"], hparams=hp,
                     run_opts={"device": device, "noprogressbar": True},
                     checkpointer=hp["checkpointer"])
    return brain, hp, data


def fit_and_evaluate(brain, hp, data, max_key=None):
    """``fit``, then ``evaluate`` of the test set from the checkpoint of
    least valid loss, or of greatest ``max_key``."""
    train, valid, tests = data
    brain.fit(hp["epoch_counter"], train, valid,
              train_loader_kwargs=hp["train_dataloader_opts"],
              valid_loader_kwargs=hp["valid_dataloader_opts"])
    (test_set,) = tests.values()
    t0 = time.perf_counter()
    test_loss = brain.evaluate(test_set, max_key=max_key,
                               min_key=None if max_key else "loss",
                               test_loader_kwargs=hp["test_dataloader_opts"])
    return test_set, test_loss, time.perf_counter() - t0


def check_eval_shapes(brain, eval_sets):
    """Rows 1 and 2 against their plain versions in f32 at each shape the
    recipe's evaluation gives them: the frontend on an utterance padded to
    whole seconds (1, samples), the short attention on (1, 16, T, 64) with
    the utterance's frame count as the key length."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    config = brain.modules.wav2vec2.config
    packed = brain.modules.wav2vec2.encoder.feature_extractor.packed(
        torch.float32)
    shapes = set()
    for ds in eval_sets:
        for i in range(len(ds)):
            n = len(ds[i]["sig"])
            shapes.add((n, -(-n // SR) * SR))
    for n, padded in sorted(shapes):
        wav = torch.zeros(1, padded, device="cuda")
        wav[0, :n] = torch.randn(n, generator=gen, device="cuda")
        got = cf.fused_conv_frontend(wav, packed)
        want = cf.conv_frontend_reference(wav, packed)
        frames, valid = config.output_length(padded), config.output_length(n)
        q, k, v, lens = attention_inputs((1, 16, frames, 64), [valid],
                                         torch.float32, gen)
        got_a = fa.flash_attention_short(q, k, v, lens)
        want_a = fa.attention_reference(q, k, v, lens)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_a = (got_a - want_a).abs().max().item()
        ok = (got.shape == (1, frames, 512) and err <= TOL[("conv_frontend",
                                                            "f32")]
              and err_a <= TOL[("flash_attention_short", "f32")])
        log(f"  eval shape: wav (1, {padded}) holding {n} samples -> "
            f"conv_frontend max_abs_err={err:.3e}; flash_attention_short "
            f"(1, 16, {frames}, 64) length {valid}: max_abs_err={err_a:.3e} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("a kernel disagrees with its plain version "
                                 "at the recipe's evaluation shapes")


def recipe_phase(rng):
    """Phase 13: the recipe at lv60 full width and depth (seeded random
    weights, f32): 3 epochs of ``fit`` (a linear probe, then two finetune
    epochs: on random weights the recipe's first Adam step overshoots, and
    the train loss falls from the second finetune epoch on) with
    validation, then ``evaluate`` of the test set from the checkpoint of
    least valid loss. Returns (launches, summary)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    try:
        csvs = make_recipe_set(root, rng, RECIPE_SONGS)
        tree = init_params(Wav2Vec2Config(),
                           torch.Generator().manual_seed(SEED + 6),
                           HEAD_OUTPUTS)
        brain, hp, data = recipe_brain(root, csvs, {}, tree, "cuda",
                                       number_of_epochs=3,
                                       linear_prob_epochs=1)
        n_layers = brain.modules.wav2vec2.config.num_layers
        log(f"  {len(data[0])} train utterances (batch "
            f"{hp['batch_size']}), {len(data[1])} valid and "
            f"{len(data[2]['test'])} test utterances (batch 1), "
            f"{n_layers} layers, f32, {hp['num_workers']} loader workers")
        check_eval_shapes(brain, data[1:2] + tuple(data[2].values()))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        test_set, test_loss, eval_s = fit_and_evaluate(brain, hp, data)
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  launches over fit and evaluate: {counts}")
        for e in brain.epochs:
            log(f"  epoch {e['epoch']}: {e['wall']:.2f} s wall, train loss "
                f"{e['train_loss']:.6f}, valid loss {e['valid_loss']:.6f}")
        for i, st in enumerate(brain.steps):
            log(f"  step {i + 1} ({'probe' if st['probe'] else 'finetune'}): "
                f"loss={st['loss']:.6f} {st['wall'] * 1e3:.1f} ms "
                f"launches={ {k: v for k, v in st['counts'].items() if v} }")
            if not np.isfinite(st["loss"]):
                raise AssertionError(f"nonfinite training loss {st['loss']}")
            expect_counts(st["counts"], {}, "recipe training step")
        for ev in brain.evals:
            expect_counts(ev["counts"], {"conv_frontend": 7,
                                         "flash_attention_short": n_layers},
                          f"evaluation of {ev['id']} ({ev['stage']})")
        train_losses = [e["train_loss"] for e in brain.epochs]
        if not train_losses[-1] < train_losses[0]:
            raise AssertionError(f"the train loss did not fall: "
                                 f"{train_losses}")
        ckpts = hp["checkpointer"].list_checkpoints()
        best = min(e["valid_loss"] for e in brain.epochs)
        if len(ckpts) != 1 or ckpts[0].meta["loss"] != best:
            raise AssertionError(f"kept {[c.meta for c in ckpts]}, want one "
                                 f"checkpoint of valid loss {best}")
        n_test_songs = len(RECIPE_SONGS["test"])
        if brain.COn_f1.count != n_test_songs:
            raise AssertionError(f"{brain.COn_f1.count} test songs scored, "
                                 f"want {n_test_songs}")
        ckpt_bytes = sum(os.path.getsize(f)
                         for f in ckpts[0].paramfiles.values())
        tests = [e for e in brain.evals if e["stage"] == "TEST"]
        test_audio = sum(e["audio_s"] for e in tests)
        test_walls = [e["wall"] for e in tests]
        seconds = ", ".join("%.2f" % e["audio_s"] for e in tests)
        log(f"  test: loss {test_loss:.6f}, {len(tests)} utterances "
            f"({seconds} s), "
            f"COnPOff/COnP/COn F1 {brain.COnPOff_f1.avg:.4f} / "
            f"{brain.COnP_f1.avg:.4f} / {brain.COn_f1.avg:.4f}")
        steps = {kind: [s["wall"] for s in brain.steps
                        if s["probe"] == (kind == "probe")]
                 for kind in ("probe", "finetune")}
        summary = dict(
            epoch_s=[round(e["wall"], 3) for e in brain.epochs],
            probe_step_ms=float(np.median(steps["probe"])) * 1e3,
            finetune_step_ms=float(np.median(steps["finetune"])) * 1e3,
            eval_ms_per_utterance=float(np.median(
                [e["wall"] for e in brain.evals])) * 1e3,
            evaluate_s=eval_s, evaluate_rtfx=test_audio / eval_s,
            test_batches_rtfx=test_audio / sum(test_walls),
            ckpt_bytes=ckpt_bytes, ckpt_save_s=brain.saves,
            ckpt_recover_s=list(brain.recovers), peak_gb=peak_gb,
            train_loss=train_losses, test_loss=test_loss)
        log("  where the device time goes in evaluate's batches "
            "(torch.profiler, the test set again without its recovery):")
        saved, brain.checkpointer = brain.checkpointer, None
        idle = profile_run(lambda: brain.evaluate(
            test_set, test_loader_kwargs=hp["test_dataloader_opts"]))
        brain.checkpointer = saved
        summary["evaluate_busy"] = None if idle is None else 1 - idle
        log(f"  median steps: probe {summary['probe_step_ms']:.1f} ms, "
            f"finetune {summary['finetune_step_ms']:.1f} ms; eval "
            f"{summary['eval_ms_per_utterance']:.1f} ms an utterance; "
            f"evaluate {eval_s:.2f} s for {test_audio:.2f} s of audio (RTFx "
            f"{summary['evaluate_rtfx']:.1f}, its batches alone "
            f"{summary['test_batches_rtfx']:.1f}); checkpoint "
            f"{ckpt_bytes / 2 ** 30:.3f} GiB, saved in "
            f"{[round(t, 2) for t in brain.saves]} s (with the epoch's log "
            f"and keep-only), recovered in "
            f"{[round(t, 2) for t in brain.recovers]} s; peak "
            f"{peak_gb:.2f} GiB")
        return counts, summary
    finally:
        shutil.rmtree(root)


def frame_decisions(logits):
    """What ``frame2note`` decides from a song's logits (frames, 20): onset
    peaks, offsets, octave and pitch class; and the frames where a decision
    rests on a near tie (within NEAR_THRESHOLD): a probability against its
    threshold, an onset against another in its peak window, or the top two
    octave or class logits."""
    probs = 1.0 / (1.0 + np.exp(-logits[:, :2].astype(np.float64)))
    onset, offset = probs[:, 0], probs[:, 1]
    octave, pitch = logits[:, 2:7], logits[:, 7:]
    decided = np.stack([
        onset_peaks(onset, HPARAMS["onset_threshold"]),
        offset >= HPARAMS["offset_threshold"],
        octave.argmax(-1), pitch.argmax(-1)], -1)
    n = len(onset)
    near = ((np.abs(onset - HPARAMS["onset_threshold"]) < NEAR_THRESHOLD)
            | (np.abs(offset - HPARAMS["offset_threshold"]) < NEAR_THRESHOLD))
    for i in range(n):
        window = np.r_[onset[max(0, i - 3):i], onset[i + 1:min(i + 4, n - 1)]]
        if window.size and np.abs(window - onset[i]).min() < NEAR_THRESHOLD:
            near[i] = True
    for part in (octave, pitch):
        top2 = np.sort(part, -1)[:, -2:]
        near |= top2[:, 1] - top2[:, 0] < NEAR_THRESHOLD
    return decided, near


def bias_the_onsets(tree, arch, wav):
    """Seeded random weights put every onset probability far under the 0.4
    threshold (0.11-0.23 on a TINY model), so no note would be decoded and
    the notes card against CPU would hold nothing. Raise the head's onset
    bias so that the median onset logit over ``wav`` (one song, on the CPU)
    is 0, a probability of 0.5: onset peaks then cross the threshold."""
    bridge = HuggingFaceWav2Vec2(source="facebook/wav2vec2-large-lv60",
                                 arch_overrides=arch)
    head = Linear(HEAD_OUTPUTS, bridge.config.hidden_size)
    load_jax_params(tree, bridge, head)
    with torch.inference_mode():
        onset = head(bridge(torch.from_numpy(wav)[None],
                            wav_lens=torch.ones(1)))[0, :, 0]
    shift = -onset.median().item()
    tree["model"]["b"][0] += shift
    log(f"  onset bias of the head raised by {shift:.4f} (the median onset "
        f"logit over a {len(wav) / SR:.1f} s song, std "
        f"{onset.std().item():.4f})")


def recipe_card_vs_cpu(rng):
    """Phase 14: ``evaluate`` of a 2-layer lv60-width model on its seeded
    weights (which detect notes), one epoch of ``fit`` (full finetune) and
    ``evaluate`` again, dropouts 0, on the card and on the CPU from the
    same weights: per-step losses, evaluation logits, NewBob rates, every
    song's notes and scores."""
    arch = dict(num_layers=2, hidden_dropout=0.0, attention_dropout=0.0,
                activation_dropout=0.0, feat_proj_dropout=0.0)
    tree = init_params(Wav2Vec2Config(**arch),
                       torch.Generator().manual_seed(SEED + 7), HEAD_OUTPUTS)
    root = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    try:
        csvs = make_recipe_set(root, rng, CARD_VS_CPU_SONGS)
        bias_the_onsets(tree, arch, read_audio(
            os.path.join(root, "test", "test0", "vocals.wav")))
        runs = {}
        for dev in ("cuda", "cpu"):
            brain, hp, data = recipe_brain(
                root, csvs, arch, tree, dev, number_of_epochs=1,
                linear_prob_epochs=0, batch_size=4, num_workers=2)
            t0 = time.perf_counter()
            brain.evaluate(data[2]["test"],
                           test_loader_kwargs=hp["test_dataloader_opts"])
            _, test_loss, _ = fit_and_evaluate(brain, hp, data)
            runs[dev] = brain
            log(f"  {dev}: {time.perf_counter() - t0:.1f} s, step losses "
                f"{[round(s['loss'], 6) for s in brain.steps]}, test loss "
                f"{test_loss:.6f}, learning rates {brain.valid_lrs}")
        card, cpu = runs["cuda"], runs["cpu"]
        loss_rel = max(abs(a["loss"] / b["loss"] - 1)
                       for a, b in zip(card.steps, cpu.steps))
        logit_err = max(np.abs(a["logits"] - b["logits"]).max()
                        for a, b in zip(card.evals, cpu.evals))
        ok = (len(card.steps) == len(cpu.steps) > 1
              and loss_rel <= TOL_STEP["loss_rel"]
              and [e["id"] for e in card.evals] == [e["id"] for e in cpu.evals]
              and logit_err <= TOL_RECIPE_LOGITS
              and card.valid_lrs == cpu.valid_lrs)
        log(f"  card vs CPU: {len(card.steps)} steps, loss rel err "
            f"{loss_rel:.3e} (tol {TOL_STEP['loss_rel']:.0e}); "
            f"{len(card.evals)} evaluated utterances, logits max abs err "
            f"{logit_err:.3e} (tol {TOL_RECIPE_LOGITS:.0e}); learning rates "
            f"equal: {card.valid_lrs == cpu.valid_lrs}")
        for (name, notes, logits, scores), (_, want, want_logits,
                                            want_scores) in zip(card.songs,
                                                                cpu.songs):
            decided, _ = frame_decisions(logits)
            want_decided, near = frame_decisions(want_logits)
            differ = np.flatnonzero((decided != want_decided).any(-1))
            if len(differ):
                log(f"  {name}: frames {differ.tolist()} decide otherwise on "
                    f"the card (near ties: {near[differ].tolist()}; card "
                    f"{decided[differ].tolist()}, CPU "
                    f"{want_decided[differ].tolist()}): notes {len(notes)} "
                    f"on the card, {len(want)} on the CPU, not held")
                ok = ok and bool(near[differ].all())
                continue
            same = (notes.shape == want.shape and (notes == want).all()
                    and scores == want_scores)
            log(f"  {name}: {len(notes)} notes, COnPOff/COnP/COn F1 "
                f"{scores['COnPOff_f1']:.4f}/{scores['COnP_f1']:.4f}/"
                f"{scores['COn_f1']:.4f}, card = CPU: {same}")
            ok = ok and same
        if not ok:
            raise AssertionError("the recipe on the card disagrees with the "
                                 "CPU")
    finally:
        shutil.rmtree(root)


# ------------------------------------------------------------ phases 15-16
def n20em_hparams(extract=False, **overrides):
    """The N20EMv2 audio recipe's objects (``N20EMv2/audio_only/hparams/
    train_audio_ssl.yaml``; ``extract_ssl_feats.yaml`` with ``extract``)."""
    name = "extract_ssl_feats" if extract else "train_audio_ssl"
    return recipe_yaml(f"N20EMv2/audio_only/hparams/{name}.yaml", overrides)


def rca_hparams(system="av", **overrides):
    """The RCA fusion recipes' objects (``N20EMv2/audio_visual/hparams/
    train_rca_av.yaml``; ``train_rca_a.yaml`` for ``system`` "a")."""
    return recipe_yaml(f"N20EMv2/audio_visual/hparams/train_rca_{system}.yaml",
                       overrides)


def video_hparams(extract=False, **overrides):
    """The N20EMv2 video recipe's objects (``N20EMv2/video_only/hparams/
    train_video_ssl.yaml``; ``extract_ssl_feats.yaml`` with ``extract``)."""
    name = "extract_ssl_feats" if extract else "train_video_ssl"
    return recipe_yaml(f"N20EMv2/video_only/hparams/{name}.yaml", overrides)


def make_n20em_set(root, rng):
    """An N20EMv2-shaped set under ``root``: ``annotations.json`` and
    ``data/<song>/{vocals,accomp}.wav`` (sine notes plus noise; Gaussian
    accompaniment), prepared by the recipe's ``prepare_n20emv2`` at 5 s
    utterances, a MIR-ST500 part (``make_recipe_set``) merged into
    ``mix_train.csv``, and the accomp and white sweeps written by
    ``synthesis_noise`` on the card. Returns the CSV folder."""
    annotations = {}
    for split, durations in N20EM_SONGS.items():
        for i, duration in enumerate(durations):
            name = f"n20em_{split}{i}"
            notes, sig = synthetic_song(rng, duration)
            annotations[name] = {"midi": notes, "split": split}
            folder = os.path.join(root, "data", name)
            os.makedirs(folder)
            write_audio(os.path.join(folder, "vocals.wav"), sig, SR)
            write_audio(os.path.join(folder, "accomp.wav"),
                        (0.1 * rng.standard_normal(len(sig))).astype(
                            np.float32), SR)
    with open(os.path.join(root, "annotations.json"), "w") as f:
        json.dump(annotations, f)
    prepare_n20emv2.prepare_frame_anno(root)
    prepare_n20emv2.prepare_csv_n20emv2(root, os.path.join(root, "csv"), 5)
    csv_dir = os.path.join(root, "csv", "dur_5s")
    mir = make_recipe_set(os.path.join(root, "mir"), rng, N20EM_MIR_SONGS)
    shutil.copy(mir["train"], os.path.join(csv_dir, "mir_st500_train.csv"))
    merge_csvs(csv_dir, ["mir_st500_train.csv", "n20em_train.csv"],
               "mix_train.csv")
    synthesis_noise.synthesis_accomp(root)
    synthesis_noise.synthesis_white(root)
    return csv_dir


class TimedN20EM(Timed, n20em_recipe.AMT):
    """The N20EMv2 audio recipe's brain, timed."""


class TimedFusion(Timed, train_rca_av.AMT):
    """The AV fusion recipe's brain, timed (audio frames at 49.8 a
    second)."""

    timed_input, timed_rate = "sig1", FRAME_RATE


class TimedFusionA(Timed, train_rca_a.AMT):
    """The audio-only control's brain, timed."""

    timed_input, timed_rate = "sig1", FRAME_RATE


def check_dumps(root, snrs):
    """Every N20EMv2 song's clean and noisy feature dumps: (frames, 1024),
    f32, finite, and as long as its frame annotations (within a frame)."""
    with open(os.path.join(root, "annotations.json")) as f:
        songs = list(json.load(f))
    shapes = []
    for song in songs:
        folder = os.path.join(root, "data", song, "noise_data")
        anno = np.load(os.path.join(root, "data", song, "frame_anno.npy"))
        for snr in (None,) + tuple(snrs):
            path = os.path.join(folder, "clean_feats.npy" if snr is None else
                                f"accomp/SNR_{snr}dB_feats.npy")
            feats = np.load(path)
            if (feats.dtype != np.float32 or feats.shape[1] != 1024
                    or abs(feats.shape[0] - len(anno)) > 1
                    or not np.isfinite(feats).all()):
                raise AssertionError(f"{path}: {feats.dtype} {feats.shape}, "
                                     f"{len(anno)} annotated frames")
            shapes.append(feats.shape[0])
    return len(songs), shapes


def n20em_phase(root, rng):
    """Phase 15: the N20EMv2 audio recipe at lv60 full width and depth
    (seeded random weights, f32, the yaml's values): a linear-probe and a
    finetune epoch with ``mix_train``, ``evaluate`` of the test set from the
    checkpoint of greatest valid COnPOff F1 with the ``save_model`` export,
    then ``extract_ssl_feats`` over every split, clean and at accomp -10, 0
    and +10 dB. Returns (launches, summary, the exported modules)."""
    t0 = time.perf_counter()
    csv_dir = make_n20em_set(root, rng)
    log(f"  set written, prepared and its accomp and white sweeps "
        f"synthesized on the card in {time.perf_counter() - t0:.1f} s")
    tree = init_params(Wav2Vec2Config(),
                       torch.Generator().manual_seed(SEED + 8), HEAD_OUTPUTS)
    run_opts = {"device": "cuda", "noprogressbar": True}
    common = dict(data_folder=root, output_folder=os.path.join(root, "out"),
                  csv_folder=csv_dir, noise_type="accomp",
                  save_model_folder=os.path.join(root, "save_model"))
    hp = n20em_hparams(number_of_epochs=2, linear_prob_epochs=1,
                       save_model=True, **common)
    load_jax_params(tree, hp["modules"]["wav2vec2"], hp["modules"]["model"])
    data = n20em_recipe.dataio_prepare(hp)
    brain = TimedN20EM(modules=hp["modules"], hparams=hp, run_opts=run_opts,
                       checkpointer=hp["checkpointer"])
    n_layers = brain.modules.wav2vec2.config.num_layers
    log(f"  {len(data[0])} train utterances (mix_train, batch "
        f"{hp['batch_size']}), {len(data[1])} valid and "
        f"{len(data[2]['n20em_test'])} test utterances (batch 1), "
        f"{n_layers} layers, f32")
    check_eval_shapes(brain, (data[0], data[1], data[2]["n20em_test"]))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    test_set, test_loss, eval_s = fit_and_evaluate(brain, hp, data,
                                                   max_key="COnPOff_f1")
    extracted = []
    for snr in (None,) + N20EM_SNRS:
        ehp = n20em_hparams(extract=True, add_noise=snr is not None,
                            snr_db=-10 if snr is None else snr,
                            save_model=False, **common)
        t0 = time.perf_counter()
        ebrain = extract_ssl_feats.extract(ehp, run_opts, TimedN20EM)
        extracted.append((snr, ebrain, time.perf_counter() - t0))
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  launches over fit, evaluate and the extractions: {counts}")

    for e in brain.epochs:
        log(f"  epoch {e['epoch']}: {e['wall']:.2f} s wall, train loss "
            f"{e['train_loss']:.6f}, valid loss {e['valid_loss']:.6f}")
    for i, st in enumerate(brain.steps):
        log(f"  step {i + 1} ({'probe' if st['probe'] else 'finetune'}): "
            f"loss={st['loss']:.6f} {st['wall'] * 1e3:.1f} ms")
        if not np.isfinite(st["loss"]):
            raise AssertionError(f"nonfinite training loss {st['loss']}")
        expect_counts(st["counts"], {}, "N20EMv2 training step")
    evals = brain.evals + [ev for _, b, _ in extracted for ev in b.evals]
    for ev in evals:
        expect_counts(ev["counts"], {"conv_frontend": 7,
                                     "flash_attention_short": n_layers},
                      f"evaluation of {ev['id']} ({ev['stage']})")
    ckpts = hp["checkpointer"].list_checkpoints()
    best = max(e["f1"] for e in brain.epochs)
    if not ckpts or any(c.meta.get("COnPOff_f1") != best for c in ckpts):
        raise AssertionError(f"kept {[c.meta for c in ckpts]}, want the "
                             f"checkpoints of valid COnPOff F1 {best}")
    exported = sorted(os.listdir(hp["save_model_folder"]))
    if exported != ["model.pt", "wav2vec2.pt"]:
        raise AssertionError(f"save_model exported {exported}")
    n_test = len(N20EM_SONGS["test"])
    if brain.COff_f1.count != n_test:
        raise AssertionError(f"COff scored for {brain.COff_f1.count} test "
                             f"songs, want {n_test}")
    n_songs, frames = check_dumps(root, N20EM_SNRS)
    log(f"  test: loss {test_loss:.6f}, COnPOff/COnP/COn/COff F1 "
        f"{brain.COnPOff_f1.avg:.4f} / {brain.COnP_f1.avg:.4f} / "
        f"{brain.COn_f1.avg:.4f} / {brain.COff_f1.avg:.4f}; checkpoints kept "
        f"{[c.meta['COnPOff_f1'] for c in ckpts]} (valid F1 by epoch "
        f"{[e['f1'] for e in brain.epochs]}); exported {exported}")
    x_audio = sum(ev["audio_s"] for _, b, _ in extracted for ev in b.evals)
    x_wall = sum(w for _, _, w in extracted)
    x_batches = sum(ev["wall"] for _, b, _ in extracted for ev in b.evals)
    log(f"  checkpoint saves (with the epoch's log and keep-only) "
        f"{[round(t, 2) for t in brain.saves]} s, recovery "
        f"{[round(t, 2) for t in brain.recovers]} s; the extraction's "
        f"recoveries by condition "
        f"{ {str(snr): [round(t, 2) for t in b.recovers] for snr, b, _ in extracted} } s")
    log(f"  extraction: {len(extracted)} conditions x 3 splits, "
        f"{n_songs} songs each, dumps of {min(frames)}-{max(frames)} frames "
        f"x 1024, all finite; {x_audio:.1f} s of audio in {x_wall:.2f} s "
        f"(RTFx {x_audio / x_wall:.1f}; its batches alone "
        f"{x_audio / x_batches:.1f}); walls by condition "
        f"{ {str(snr): round(w, 2) for snr, _, w in extracted} }")
    steps = {kind: [st["wall"] for st in brain.steps
                    if st["probe"] == (kind == "probe")]
             for kind in ("probe", "finetune")}
    summary = dict(
        epoch_s=[round(e["wall"], 3) for e in brain.epochs],
        probe_step_ms=float(np.median(steps["probe"])) * 1e3,
        finetune_step_ms=float(np.median(steps["finetune"])) * 1e3,
        eval_ms_per_utterance=float(np.median(
            [ev["wall"] for ev in evals])) * 1e3,
        evaluate_s=eval_s, extraction_s=x_wall,
        extraction_rtfx=x_audio / x_wall,
        extraction_batches_rtfx=x_audio / x_batches, peak_gb=peak_gb,
        evaluated_utterances=len(evals), test_loss=test_loss)
    log(f"  median steps: probe {summary['probe_step_ms']:.1f} ms, finetune "
        f"{summary['finetune_step_ms']:.1f} ms; eval "
        f"{summary['eval_ms_per_utterance']:.1f} ms an utterance over "
        f"{len(evals)} utterances; peak {peak_gb:.2f} GiB")
    return counts, summary, {name: hp["modules"][name]
                             for name in ("wav2vec2", "model")}


INFERENCE_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "fixtures",
                              "singing_transcriber_hyperparams.yaml")
JAX_EXPORT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "fixtures", "jax_export_small")


def transcribe_files(face, paths):
    """Each file through ``face.transcribe_file``, the counts set to 0
    just before and read just after each; returns ({name: notes},
    [counts], [batches], wall s)."""
    notes, counts, batches = {}, [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for path in paths:
        ops.reset_launch_counts()
        name = os.path.basename(os.path.dirname(path))
        notes[name] = face.transcribe_file(path)
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
        batches.append(len(face._get_transcriber()._jobs(
            {name: read_audio(path)})))
    return notes, counts, batches, time.perf_counter() - t0


def deploy_export(root, bridge, wav):
    """The folder that phase 19 deploys from: the inference yaml of
    ``tests/fixtures/``, phase 15's exported ``wav2vec2.pt`` (a link) and a
    ``model.pt`` of a seeded head whose onset bias is raised so that the
    median onset logit over ``wav`` is 0. (Phase 15's trained head gives
    the same onset logit on every frame of these random songs, so neither
    it nor a head without the raised bias decodes a note; see
    ``bias_the_onsets``.) Returns (folder, the in-memory modules: phase
    15's bridge and that head)."""
    folder = os.path.join(root, "deploy")
    os.makedirs(folder)
    shutil.copy(INFERENCE_YAML, os.path.join(folder, "hyperparams.yaml"))
    os.symlink(os.path.join(root, "save_model", "wav2vec2.pt"),
               os.path.join(folder, "wav2vec2.pt"))
    width = bridge.config.hidden_size
    head = Linear(HEAD_OUTPUTS, width)
    load_module_tree(head, init_linear(
        torch.Generator().manual_seed(SEED + 19), width, HEAD_OUTPUTS))
    head = head.cuda()
    with torch.no_grad():
        onset = head(bridge.eval()(
            torch.from_numpy(wav)[None].cuda(),
            wav_lens=torch.ones(1, device="cuda")))[0, :, 0]
        head.b[0] -= onset.median()
    torch.save({k: v.cpu() for k, v in head.state_dict().items()},
               os.path.join(folder, "model.pt"))
    log(f"  seeded head, onset bias raised by {-onset.median().item():.4f} "
        f"(the median onset logit over a {len(wav) / SR:.1f} s song, std "
        f"{onset.std().item():.4f})")
    return folder, {"wav2vec2": bridge, "model": head}


class _Blocked:
    """Within the block, an import of any of ``names`` raises ImportError
    (as on a machine without them); the modules are restored after."""

    def __init__(self, *names):
        self.names = names

    def __enter__(self):
        self.saved = {n: sys.modules.get(n) for n in self.names}
        for n in self.names:
            sys.modules[n] = None

    def __exit__(self, *exc):
        for n, mod in self.saved.items():
            if mod is None:
                del sys.modules[n]
            else:
                sys.modules[n] = mod


def deploy_phase(root, modules):
    """Phase 19: deployment as a user runs it. An inference
    ``hyperparams.yaml`` (``tests/fixtures/``) beside phase 15's export
    (``deploy_export``); ``SingingTranscriber.from_hparams`` reads it with
    the port's own YAML reader, PyYAML and msgpack blocked, in bf16 and in
    int8; ``transcribe_file`` on phase 15's valid and test WAVs and one at
    ``chunking="song"``, each file's frame probabilities (bit for bit) and
    notes equal to those of an interface over the in-memory modules at the
    same batch width; then a small JAX export read by the port's own
    msgpack decoder, bit for bit against its ``.npz``. Returns a
    summary."""
    paths = sorted(os.path.join(root, "data", name, "vocals.wav")
                   for name in os.listdir(os.path.join(root, "data"))
                   if name.startswith(("n20em_valid", "n20em_test")))
    wavs = {os.path.basename(os.path.dirname(p)): read_audio(p)
            for p in paths}
    audio_s = sum(len(w) for w in wavs.values()) / SR
    folder, modules = deploy_export(root, modules["wav2vec2"],
                                    wavs["n20em_valid0"])
    n_layers = modules["wav2vec2"].config.num_layers
    summary = {}
    for mode in (None, "int8"):
        tag = mode or "bf16"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Blocked("yaml", "msgpack"):
            face = SingingTranscriber.from_hparams(
                folder, savedir=os.path.join(root, "pretrained"),
                device="cuda", batch_size=8, chunk_seconds=5.0,
                quantize=mode)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ref = SingingTranscriber(modules=dict(modules), hparams=HPARAMS,
                                 device="cuda", batch_size=8,
                                 chunk_seconds=5.0, quantize=mode)
        transcribe_files(face, paths[:1])              # warm-up
        transcribe_files(ref, paths[:1])
        notes, counts, batches, wall = transcribe_files(face, paths)
        want, _, _, _ = transcribe_files(ref, paths)
        per_batch = ({"int8_matmul": 49} if mode else {}) | {
            "conv_frontend": 7, "flash_attention_short": n_layers}
        for path, c, nb in zip(paths, counts, batches):
            expect_counts(c, {k: v * nb for k, v in per_batch.items()},
                          f"phase 19 {tag} {path}")
        frames = face._get_transcriber().predict_frames(wavs)
        ref_frames = ref._get_transcriber().predict_frames(wavs)
        if any(not np.array_equal(frames[k], ref_frames[k]) for k in wavs) \
                or notes != want:
            raise AssertionError(
                f"phase 19 {tag}: from_hparams differs from the in-memory "
                f"interface: frames equal "
                f"{[np.array_equal(frames[k], ref_frames[k]) for k in wavs]}"
                f", notes equal {[notes[k] == want[k] for k in want]}")
        n_notes = {k: len(v) for k, v in notes.items()}
        if not sum(n_notes.values()):
            raise AssertionError(f"phase 19 {tag}: no note decoded")
        summary[tag] = dict(from_hparams_s=load_s,
                            ms_per_file=wall * 1e3 / len(paths),
                            rtfx=audio_s / wall, notes=n_notes,
                            batches=batches)
        log(f"  {tag}: from_hparams {load_s:.2f} s (yaml, modules, "
            f"collect, state dicts; PyYAML and msgpack blocked); "
            f"{len(paths)} files, {audio_s:.1f} s of audio in "
            f"{wall * 1e3:.1f} ms ({wall * 1e3 / len(paths):.1f} ms a file, "
            f"RTFx {audio_s / wall:.1f}); notes {n_notes} and frame "
            f"probabilities equal to the in-memory interface's; launches a "
            f"file {counts}")
        if mode is None:
            song = paths[-1]
            sface = SingingTranscriber(modules=vars(face.mods),
                                       hparams=HPARAMS, device="cuda",
                                       batch_size=1, chunking="song")
            sref = SingingTranscriber(modules=dict(modules),
                                      hparams=HPARAMS, device="cuda",
                                      batch_size=1, chunking="song")
            got, (c,), _, swall = transcribe_files(sface, [song])
            want, _, _, _ = transcribe_files(sref, [song])
            if c["flash_attention"] <= 0 or got != want:
                raise AssertionError(f"phase 19 song mode: launches {c}, "
                                     f"notes equal: {got == want}")
            summary["song"] = dict(ms=swall * 1e3, counts=c,
                                   notes=len(next(iter(got.values()))))
            log(f"  song mode: {os.path.basename(os.path.dirname(song))} in "
                f"{swall * 1e3:.1f} ms, {summary['song']['notes']} notes "
                f"equal to the in-memory interface's, launches {c}")
            del sface, sref
        del face, ref
        torch.cuda.empty_cache()
    with _Blocked("yaml", "msgpack"):
        tree = _flatten(load_msgpack(JAX_EXPORT + ".msgpack"))
    with np.load(JAX_EXPORT + ".npz") as npz:
        want = {k.replace(".", "/"): npz[k] for k in npz.files}
    if sorted(tree) != sorted(want) or any(
            np.asarray(v).dtype != want[k].dtype
            or np.asarray(v).tobytes() != want[k].tobytes()
            for k, v in tree.items()):
        raise AssertionError("the JAX export read by the port's msgpack "
                             "decoder differs from its .npz")
    log(f"  JAX export {os.path.basename(JAX_EXPORT)}.msgpack, PyYAML and "
        f"msgpack blocked: {len(tree)} leaves bit for bit with the .npz")
    summary["jax_export_leaves"] = len(tree)
    return summary


class TimedVideo(Timed, video_recipe.AMT):
    """The N20EMv2 video recipe's brain, timed (video frames at 50 a
    second), keeping the encoder's running statistics at each train
    stage's end."""

    timed_input, timed_rate = "sig", VIDEO_RATE

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.train_end_stats = []

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.TRAIN:
            self.train_end_stats.append(running_stats(self.modules.encoder))
        return super().on_stage_end(stage, stage_loss, epoch)


def running_stats(encoder):
    """The encoder's BatchNorm running statistics, {path: CPU tensor}."""
    return {k: torch.from_numpy(v) for k, v in
            _flatten(module_tree(encoder, running_stats=True)).items()}


def song_seconds(root):
    """{N20EMv2 song: seconds}, from its vocals' sample count."""
    with open(os.path.join(root, "annotations.json")) as f:
        songs = list(json.load(f))
    return {song: len(read_audio(os.path.join(root, "data", song,
                                              "vocals.wav"))) / SR
            for song in songs}


def make_video_set(root, rng):
    """Seeded uint8 lip ROIs (VIDEO_SIDE square, 50 fps) beside each of
    phase 15's N20EMv2 songs, as long as its audio, prepared by the video
    recipe's ``prepare_n20emv2`` at 5 s utterances. Returns (the CSV
    folder, {song: video frames})."""
    frames = {}
    for song, seconds in song_seconds(root).items():
        frames[song] = round(seconds * VIDEO_RATE)
        np.save(os.path.join(root, "data", song, "video_50fps.npy"),
                rng.integers(0, 256, (frames[song], VIDEO_SIDE, VIDEO_SIDE),
                             dtype=np.uint8))
    video_prep.prepare_frame_anno(root, frame_rate=VIDEO_RATE)
    video_prep.prepare_csv_n20emv2(root, os.path.join(root, "csv_video"),
                                   VIDEO_RATE, 5)
    return os.path.join(root, "csv_video", f"frame_rate{VIDEO_RATE}",
                        "dur_5s"), frames


def check_video_eval_shapes(eval_sets, pad):
    """Row 2 against its plain version in f32 at each shape the video
    recipe's evaluation gives it: (1, 16, T, 64), every frame attended, T
    each utterance's frame count padded to ``pad``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = sorted({-(-len(ds[i]["sig"]) // pad) * pad
                     for ds in eval_sets for i in range(len(ds))})
    for t in frames:
        q, k, v = (torch.randn(1, 16, t, 64, generator=gen, device="cuda")
                   for _ in range(3))
        err = (fa.flash_attention_short(q, k, v, None)
               - fa.attention_reference(q, k, v, None)).abs().max().item()
        ok = err <= TOL[("flash_attention_short", "f32")]
        log(f"  eval shape: flash_attention_short (1, 16, {t}, 64) "
            f"lengths=None: max_abs_err={err:.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("row 2 disagrees with its plain version at "
                                 "the video recipe's evaluation shapes")
    return frames


def check_video_dumps(root, frames, width=1024):
    """Every song's ``noise_data/video_feats.npy``: (video frames,
    ``width``), f32, finite."""
    for song, n in frames.items():
        path = os.path.join(root, "data", song, "noise_data",
                            "video_feats.npy")
        feats = np.load(path)
        if (feats.dtype != np.float32 or feats.shape != (n, width)
                or not np.isfinite(feats).all()):
            raise AssertionError(f"{path}: {feats.dtype} {feats.shape}, "
                                 f"{n} video frames")


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, names in os.walk(path) for f in names)


def video_phase(root, rng):
    """Phase 17: the N20EMv2 video recipe at AV-HuBERT large width and depth
    (seeded random weights, f32, the yaml's values: batch 4, eval batch 1)
    on seeded video beside phase 15's songs: a linear-probe and a finetune
    epoch, ``evaluate`` of the test set from the checkpoint of greatest
    valid COnPOff F1, then ``extract_ssl_feats`` of every split into
    ``noise_data/video_feats.npy``, which phase 16 reads. Returns
    (launches, the trained brain, its hparams and test set, summary)."""
    t0 = time.perf_counter()
    csv_dir, frames = make_video_set(root, rng)
    log(f"  video written ({len(frames)} songs, {sum(frames.values())} "
        f"frames of {VIDEO_SIDE}x{VIDEO_SIDE}) and prepared in "
        f"{time.perf_counter() - t0:.1f} s")
    run_opts = {"device": "cuda", "noprogressbar": True}
    common = dict(data_folder=root, csv_folder=csv_dir,
                  output_folder=os.path.join(root, "out_video"))
    hp = video_hparams(number_of_epochs=2, linear_prob_epochs=1, **common)
    t0 = time.perf_counter()
    init_modules(hp["modules"], hp["seed"])
    log(f"  seeded AV-HuBERT large weights drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    data = video_recipe.dataio_prepare(hp)
    brain = TimedVideo(modules=hp["modules"], hparams=hp, run_opts=run_opts,
                       checkpointer=hp["checkpointer"])
    enc = brain.modules.encoder
    n_layers = enc.config.encoder_layers
    n_params = sum(p.numel() for p in enc.parameters())
    log(f"  {len(data[0])} train utterances (batch {hp['batch_size']}), "
        f"{len(data[1])} valid and {len(data[2]['n20em_test'])} test "
        f"utterances (batch 1); AV-HuBERT {n_layers} layers x "
        f"{enc.config.encoder_embed_dim}, {n_params / 1e6:.1f} M parameters "
        f"in the encoder, f32")
    eval_frames = check_video_eval_shapes(
        (data[1], data[2]["n20em_test"], data[0]),
        hp["pad_multiples"]["sig"])
    start_stats = running_stats(enc)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    test_set, test_loss, eval_s = fit_and_evaluate(brain, hp, data,
                                                   max_key="COnPOff_f1")
    ehp = video_hparams(extract=True, **common)
    t0 = time.perf_counter()
    ebrain = video_extract.extract(ehp, run_opts, TimedVideo)
    x_wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  launches over fit, evaluate and the extraction: {counts}")

    for e in brain.epochs:
        log(f"  epoch {e['epoch']}: {e['wall']:.2f} s wall, train loss "
            f"{e['train_loss']:.6f}, valid loss {e['valid_loss']:.6f}")
    for i, st in enumerate(brain.steps):
        log(f"  step {i + 1} ({'probe' if st['probe'] else 'finetune'}): "
            f"loss={st['loss']:.6f} {st['wall'] * 1e3:.1f} ms")
        if not np.isfinite(st["loss"]):
            raise AssertionError(f"nonfinite training loss {st['loss']}")
        expect_counts(st["counts"], {}, "video training step")
    evals = brain.evals + ebrain.evals
    for ev in evals:
        expect_counts(ev["counts"], {"flash_attention_short": n_layers},
                      f"evaluation of {ev['id']} ({ev['stage']})")
    probe_stats = brain.train_end_stats[0]
    unmoved = [k for k in start_stats
               if torch.equal(start_stats[k], probe_stats[k])]
    if unmoved or not all(torch.isfinite(v).all() for v in
                          probe_stats.values()):
        raise AssertionError(f"the probe epoch left running statistics "
                             f"unmoved or nonfinite: {unmoved[:5]}")
    log(f"  the probe epoch moved all {len(start_stats)} running statistics "
        f"(frontend BatchNorm mean: "
        f"{start_stats[next(iter(start_stats))][:3].tolist()} -> "
        f"{[round(x, 5) for x in probe_stats[next(iter(probe_stats))][:3].tolist()]})")
    ckpts = hp["checkpointer"].list_checkpoints()
    best = max(e["f1"] for e in brain.epochs)
    if not ckpts or any(c.meta.get("COnPOff_f1") != best for c in ckpts):
        raise AssertionError(f"kept {[c.meta for c in ckpts]}, want the "
                             f"checkpoints of valid COnPOff F1 {best}")
    n_test = len(N20EM_SONGS["test"])
    if brain.COff_f1.count != n_test:
        raise AssertionError(f"COff scored for {brain.COff_f1.count} test "
                             f"songs, want {n_test}")
    check_video_dumps(root, frames, enc.config.encoder_embed_dim)
    ckpt_bytes = [dir_bytes(c.path) for c in ckpts]
    log(f"  test: loss {test_loss:.6f}, COnPOff/COnP/COn/COff F1 "
        f"{brain.COnPOff_f1.avg:.4f} / {brain.COnP_f1.avg:.4f} / "
        f"{brain.COn_f1.avg:.4f} / {brain.COff_f1.avg:.4f}; checkpoints kept "
        f"{[c.meta['COnPOff_f1'] for c in ckpts]} of "
        f"{[round(b / 2 ** 30, 3) for b in ckpt_bytes]} GiB")
    x_video = sum(ev["audio_s"] for ev in ebrain.evals)
    x_batches = sum(ev["wall"] for ev in ebrain.evals)
    log(f"  checkpoint saves (with the epoch's log and keep-only) "
        f"{[round(t, 2) for t in brain.saves]} s, recovery "
        f"{[round(t, 2) for t in brain.recovers]} s, the extraction's "
        f"{[round(t, 2) for t in ebrain.recovers]} s")
    log(f"  extraction: {len(ebrain.evals)} utterances of "
        f"{len(frames)} songs' splits (valid, then test, valid, train), "
        f"dumps of {min(frames.values())}-{max(frames.values())} frames x "
        f"{enc.config.encoder_embed_dim}, all finite; {x_video:.1f} s of "
        f"video in {x_wall:.2f} s "
        f"(RTFx {x_video / x_wall:.1f}; its batches alone "
        f"{x_video / x_batches:.1f})")
    steps = {kind: [st["wall"] for st in brain.steps
                    if st["probe"] == (kind == "probe")]
             for kind in ("probe", "finetune")}
    log("  where the device time goes in one finetune step at batch "
        f"{hp['batch_size']} (torch.profiler):")
    batch = next(iter(brain.make_dataloader(
        data[0], Stage.TRAIN, ckpt_prefix=None,
        **dict(hp["train_dataloader_opts"], num_workers=0))))
    # the step moves the evaluated model; phase 18 serves that model in
    # int8 against its float evaluation, so it is put back afterwards
    evaluated = copy.deepcopy(brain.modules.state_dict())
    brain.on_stage_start(Stage.TRAIN, 3)
    step_idle = profile_run(lambda: brain.fit_batch(batch))
    brain.modules.load_state_dict(evaluated)
    del evaluated
    summary = dict(
        epoch_s=[round(e["wall"], 3) for e in brain.epochs],
        probe_step_ms=float(np.median(steps["probe"])) * 1e3,
        finetune_step_ms=float(np.median(steps["finetune"])) * 1e3,
        eval_ms_per_utterance=float(np.median(
            [ev["wall"] for ev in evals])) * 1e3,
        evaluate_s=eval_s, extraction_s=x_wall,
        extraction_rtfx=x_video / x_wall,
        extraction_batches_rtfx=x_video / x_batches,
        checkpoint_gib=[b / 2 ** 30 for b in ckpt_bytes],
        save_s=brain.saves, recover_s=brain.recovers + ebrain.recovers,
        peak_gb=peak_gb, evaluated_utterances=len(evals),
        eval_frames=eval_frames, test_loss=test_loss,
        train_step_busy=None if step_idle is None else 1 - step_idle)
    log(f"  median steps: probe {summary['probe_step_ms']:.1f} ms, finetune "
        f"{summary['finetune_step_ms']:.1f} ms; eval "
        f"{summary['eval_ms_per_utterance']:.1f} ms an utterance over "
        f"{len(evals)} utterances; peak {peak_gb:.2f} GiB")
    del ebrain
    torch.cuda.empty_cache()
    return counts, (brain, hp, test_set), summary


def video_batch(rng, batch, seconds):
    """Synthetic rows of normalized 88x88 video and annotations at 50
    frames a second."""
    frames = int(seconds * VIDEO_RATE)
    video = rng.standard_normal((batch, frames, 88, 88, 1)).astype(np.float32)
    anno = np.stack([rng.random((batch, frames)) < 0.05,
                     rng.random((batch, frames)) < 0.05,
                     rng.integers(0, 5, (batch, frames)),
                     rng.integers(0, 13, (batch, frames))],
                    axis=-1).astype(np.float32)
    ones = np.ones(batch, np.float32)
    return {"sig": PaddedData(torch.from_numpy(video), ones),
            "anno": PaddedData(torch.from_numpy(anno), ones)}


def video_card_vs_cpu_step(root, rng):
    """Phase 18, first half: the full ResEncoder and 2 AV-HuBERT-width
    layers (dropouts 0), batch 2 x 1 s: eval logits, then one full-finetune
    step (loss, gradient norm, every clipped gradient, the running
    statistics after it) in f32 on the card and on the CPU, and the same
    forward and backward in f64 on the CPU, which the gradients are held
    to."""
    arch = dict(encoder_layers=2, dropout=0.0, attention_dropout=0.0,
                activation_dropout=0.0, dropout_input=0.0)
    batch = video_batch(rng, 2, 1.0)
    hp = video_hparams(data_folder=root, encoder=None, head=None,
                       modules=None, checkpointer=None,
                       output_folder=os.path.join(root, "out_video_step"))
    result = {}
    for tag, dev, dtype in (("cuda", "cuda", torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu_f64", "cpu", torch.float64)):
        enc = FairseqAVHubert(source=None, output_norm=True,
                              arch_overrides=arch)
        head = Linear(HEAD_OUTPUTS, 1024)
        init_modules({"encoder": enc, "head": head}, SEED + 17)
        brain = video_recipe.AMT({"encoder": enc.to(dtype),
                                  "head": head.to(dtype)},
                                 hparams=hp, run_opts={"device": dev})
        brain.init_optimizers()
        arrays = {k: PaddedData(v.data.to(dtype), v.lengths)
                  for k, v in brain._batch_to_device(batch).items()
                  if isinstance(v, PaddedData)}
        with torch.inference_mode():
            preds = brain.compute_forward(arrays, Stage.VALID)
        logits = torch.cat([p.reshape(2, 50, -1) for p in preds[:4]],
                           -1).float().cpu()
        brain.on_stage_start(Stage.TRAIN, 3)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params = dict(brain.modules.named_parameters())
        if dtype == torch.float32:
            loss = brain.fit_batch(batch)
            gnorm = brain.last_grad_norm
        else:
            loss = brain.compute_objectives(brain.compute_forward(
                arrays, Stage.TRAIN), arrays, Stage.TRAIN)
            loss.backward()
            loss = loss.item()
            gnorm = torch.stack([p.grad.square().sum() for p in
                                 params.values() if p.grad is not None]
                                ).sum().sqrt().item()
            clip = min(1.0, brain.max_grad_norm / (gnorm + 1e-6))
            for p in params.values():
                if p.grad is not None:
                    p.grad.mul_(clip)
        wall = time.perf_counter() - t0
        result[tag] = dict(
            loss=loss, gnorm=gnorm, logits=logits,
            counts=ops.launch_counts(), stats=running_stats(enc),
            grads={n: p.grad.double().cpu() for n, p in params.items()
                   if p.grad is not None})
        log(f"  {tag}: loss={loss:.6f} gnorm={gnorm:.6f} {wall:.1f} s "
            f"launches={result[tag]['counts']}")
        del brain, enc, head, params
    # no attention dropout here, so each layer's forward takes the short
    # kernel (its backward is the plain VJP)
    expect_counts(result["cuda"]["counts"],
                  {"flash_attention_short": arch["encoder_layers"]},
                  "card step")
    got, want, exact = result["cuda"], result["cpu"], result["cpu_f64"]
    card, exempt = leaf_errors(got, exact, {"grad_rel": "grads"})
    cpu, _ = leaf_errors(want, exact, {"grad_rel": "grads"})
    pair, _ = leaf_errors(got, want, {"grad_rel": "grads"})
    worst = {name: max(e["grad_rel"], key=e["grad_rel"].get)
             for name, e in (("card", card), ("cpu", cpu), ("pair", pair))}
    w_card = card["grad_rel"][worst["card"]]
    w_cpu = cpu["grad_rel"][worst["cpu"]]
    loss_rel = abs(got["loss"] / want["loss"] - 1)
    gnorm_rel = abs(got["gnorm"] / want["gnorm"] - 1)
    stats_err = max((got["stats"][k] - want["stats"][k]).abs().max().item()
                    for k in want["stats"])
    logit_err = (got["logits"] - want["logits"]).abs().max().item()
    t = TOL_VIDEO_STEP
    ok = (sorted(got["grads"]) == sorted(want["grads"])
          == sorted(exact["grads"])
          and loss_rel <= t["loss_rel"] and gnorm_rel <= t["gnorm_rel"]
          and stats_err <= t["stats"] and logit_err <= t["logits"]
          and w_card <= t["grad_vs_f64"] * w_cpu
          and all(name.endswith("attn.bk") for name in exempt))
    log(f"  card vs CPU (f32): eval logits max abs err {logit_err:.3e}; loss "
        f"rel err {loss_rel:.3e}, gnorm rel err {gnorm_rel:.3e}; running "
        f"statistics max abs err {stats_err:.3e}; gradients against the f64 "
        f"step, worst of {len(card['grad_rel'])} leaves: card {w_card:.3e} "
        f"({worst['card']}), CPU {w_cpu:.3e} ({worst['cpu']}); card against "
        f"CPU {pair['grad_rel'][worst['pair']]:.3e} ({worst['pair']}); "
        f"exempt (zero gradient) {exempt}; tols {t} -> "
        f"{'ok' if ok else 'FAIL'}")
    for name, e in (("card vs f64", card), ("CPU vs f64", cpu)):
        top = sorted(e["grad_rel"].items(), key=lambda kv: -kv[1])[:4]
        log(f"    largest {name}: " + ", ".join(f"{n} {v:.3e}"
                                              for n, v in top))
    if not ok:
        raise AssertionError("the video training step on the card disagrees "
                             "with the CPU")
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, gnorm_rel=gnorm_rel, stats_abs=stats_err,
                logits_abs=logit_err, grad_rel_card_vs_f64=w_card,
                grad_rel_cpu_vs_f64=w_cpu,
                grad_rel_card_vs_cpu=pair["grad_rel"][worst["pair"]])


def int8_video_serving(brain, hp, test_set):
    """Phase 18, second half: the trained AV-HuBERT large of phase 17
    served in int8 (``quantize_avhubert``, FFN only and with
    ``quantize_attn``) by the recipe's ``evaluate`` on the test set at
    batch 1, against its float evaluation (the brain's TEST records):
    kernel 5 first held against its plain version (f32) at every shape the
    serving gives it and timed at those of a whole 5 s utterance, then 49
    (145) launches an utterance at exactly those shapes, ms an utterance,
    frame decisions and notes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = sorted({-(-len(test_set[i]["sig"]) // hp["pad_multiples"]["sig"])
                     * hp["pad_multiples"]["sig"]
                     for i in range(len(test_set))})
    held = sorted({s for t in frames for s in avhubert_int8_shapes(t)})
    for m, k, n in held:
        hold_int8(m, k, n, "f32", torch.float32, gen, " (AV-HuBERT)")
    log(f"  kernel 5 timed at the products of a whole 5 s utterance (T "
        f"{VIDEO_EVAL_FRAMES[0]}), f32, as served:")
    rows = int8_timings(gen, avhubert_int8_shapes(VIDEO_EVAL_FRAMES[0]),
                        torch.float32)
    float_evals = [ev for ev in brain.evals if ev["stage"] == "TEST"]
    float_songs = {name: notes for name, notes, *_ in brain.songs[
        -len(N20EM_SONGS["test"]):]}
    out = {}
    for qa in (False, True):
        qbrain = TimedVideo(
            modules={"encoder": quantize_avhubert(brain.modules.encoder,
                                                  quantize_attn=qa),
                     "head": brain.modules.head},
            hparams=hp, run_opts={"device": "cuda", "noprogressbar": True})
        with Int8Shapes() as launched:
            qbrain.evaluate(test_set,
                            test_loader_kwargs=hp["test_dataloader_opts"])
        want = {s for t in frames for s in avhubert_int8_shapes(t, qa)}
        if launched.seen != want:
            raise AssertionError(f"int8 AV-HuBERT launched kernel 5 at "
                                 f"{sorted(launched.seen)}, want "
                                 f"{sorted(want)}")
        for ev in qbrain.evals:
            expect_counts(ev["counts"],
                          {"int8_matmul": AVHUBERT_INT8_LAUNCHES[qa],
                           "flash_attention_short": 24},
                          f"int8 AV-HuBERT ({'quantize_attn' if qa else 'FFN'})"
                          f" of {ev['id']}")
        same = np.concatenate([
            np.stack(decisions(_probs(q["logits"])), -1)
            == np.stack(decisions(_probs(f["logits"])), -1)
            for q, f in zip(qbrain.evals, float_evals)])
        agree, each = same.all(-1).mean(), same.mean(0)
        notes = {name: (len(float_songs[name]), len(est))
                 for name, est, *_ in qbrain.songs}
        ms = float(np.median([ev["wall"] for ev in qbrain.evals])) * 1e3
        f_ms = float(np.median([ev["wall"] for ev in float_evals])) * 1e3
        ok = (each[0] >= INT8_DECISION_AGREE and each[1] >= INT8_DECISION_AGREE
              and each[2] > INT8_PITCH_AGREE)
        log(f"  int8 against float, per frame: onset decisions agree "
            f"{each[0]:.4f}, offset {each[1]:.4f} (bar {INT8_DECISION_AGREE}),"
            f" pitch class {each[2]:.4f} (bar {INT8_PITCH_AGREE}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("int8 AV-HuBERT's frame decisions stray "
                                 "from the float model's")
        log(f"  int8 AV-HuBERT {'with quantize_attn' if qa else 'FFN only'}:"
            f" {AVHUBERT_INT8_LAUNCHES[qa]} kernel-5 launches in each of "
            f"{len(qbrain.evals)} utterances at {sorted(launched.seen)}; "
            f"{ms:.1f} ms an utterance (float {f_ms:.1f}); frames whose "
            f"onset, offset and pitch-class decisions all equal the float "
            f"ones {agree:.4f}; notes float/int8 {notes}")
        out["quantize_attn" if qa else "ffn"] = dict(
            ms_per_utterance=ms, float_ms_per_utterance=f_ms,
            decision_agree=float(agree),
            onset_offset_pitch_agree=[float(a) for a in each], notes=notes)
        del qbrain
    out["held_shapes"] = held
    out["int8_kernel"] = {name: {k: r[k] for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}
        for name, r in rows.items()}
    return out


def fusion_batch_card_vs_cpu(modules, hp, train_set):
    """One f32 batch of 2 train utterances through the trained fusion and
    head, on the card and on the CPU: the loss and the logits."""
    out = {}
    for dev in ("cuda", "cpu"):
        brain = train_rca_av.AMT(
            modules={k: copy.deepcopy(m).to(dev) for k, m in modules.items()},
            hparams=hp, run_opts={"device": dev, "noprogressbar": True})
        loader = brain.make_dataloader(
            train_set, Stage.VALID, ckpt_prefix=None,
            **dict(hp["train_dataloader_opts"], batch_size=2, num_workers=0))
        arrays = brain._batch_to_device(next(iter(loader)))
        with torch.inference_mode():
            preds = brain.compute_forward(arrays, Stage.VALID)
            loss = brain.compute_objectives(preds, arrays, Stage.VALID)
        out[dev] = (float(loss), torch.cat([p.reshape(p.shape[0], p.shape[1],
                                                      -1) for p in preds[:4]],
                                           -1).cpu())
    (loss_g, logits_g), (loss_c, logits_c) = out["cuda"], out["cpu"]
    rel = abs(loss_g / loss_c - 1)
    err = (logits_g - logits_c).abs().max().item()
    ok = rel <= TOL_FUSION["loss_rel"] and err <= TOL_FUSION["logits"]
    log(f"  f32 batch {tuple(logits_g.shape)} card vs CPU: loss {loss_g:.6f} "
        f"/ {loss_c:.6f} (rel err {rel:.3e}, tol "
        f"{TOL_FUSION['loss_rel']:.0e}), logits max abs err {err:.3e} (tol "
        f"{TOL_FUSION['logits']:.0e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fusion on the card disagrees with the CPU")
    return rel, err


def served_frames(test_set, pad):
    """The padded frame count T of each utterance of ``test_set`` as the
    evaluation's loader gives it (batch 1, ``sig1`` padded to ``pad``)."""
    return sorted({-(-len(test_set[i]["sig1"]) // pad) * pad
                   for i in range(len(test_set))})


def check_fusion_int8(frames, gen):
    """Kernel 5 in f32 held against its plain version at every product of
    the int8 fusion's forward over utterances of ``frames`` padded frames.
    Returns the shapes held."""
    held = sorted({s for t in frames for s in fusion_int8_shapes(t)})
    for m, k, n in held:
        hold_int8(m, k, n, "f32", torch.float32, gen, " (fusion)")
    return held


class Int8Shapes:
    """Within ``with``: the (M, K, N) of every kernel-5 launch."""

    def __enter__(self):
        self.seen, self._launch = set(), quant._launch

        def launch(x, w8, *args, **kwargs):
            self.seen.add((x.numel() // w8.shape[0], *w8.shape))
            return self._launch(x, w8, *args, **kwargs)

        quant._launch = launch
        return self

    def __exit__(self, *exc):
        quant._launch = self._launch


def fusion_int8_kernel(hp, test_set):
    """Kernel 5 held against its plain version at every shape that int8
    serving of ``test_set`` gives it, and timed at those of a whole
    ``dur_threshold`` utterance. Returns (the test set's padded frame
    counts, the shapes held, timing rows)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pad = hp["pad_multiples"]["sig1"]
    frames = served_frames(test_set, pad)
    log(f"  kernel 5 at the int8 fusion's shapes, f32, for the test set's "
        f"padded frame counts {frames}:")
    held = check_fusion_int8(frames, gen)
    whole = -(-round(hp["dur_threshold"] * hp["audio_sample_rate"]) // pad
              ) * pad
    log(f"  kernel 5 timed at the products of a whole "
        f"{hp['dur_threshold']} s utterance (T {whole}), f32, as served:")
    rows = int8_timings(gen, fusion_int8_shapes(whole), torch.float32)
    log_rows(rows)
    return frames, held, rows


def int8_fusion_serving(brain, hp, test_set, frames):
    """The trained AV fusion served in int8 (``quantize_fusion``, FFN only
    and with ``quantize_attn``) by the recipe's ``evaluate`` on the test
    set, against its float evaluation (the brain's TEST records), asserting
    that kernel 5 launched at exactly the shapes ``fusion_int8_shapes``
    gives for the padded frame counts ``frames`` (those held in
    ``fusion_int8_kernel``): kernel-5 launches an utterance, ms an
    utterance, frame decisions and notes."""
    float_evals = [ev for ev in brain.evals if ev["stage"] == "TEST"]
    float_songs = {name: notes for name, notes, *_ in brain.songs[
        -len(N20EM_SONGS["test"]):]}
    out = {}
    for qa in (False, True):
        qbrain = TimedFusion(
            modules={"head": brain.modules.head,
                     "fusion": quantize_fusion(brain.modules.fusion,
                                               quantize_attn=qa)},
            hparams=hp, run_opts={"device": "cuda", "noprogressbar": True})
        with Int8Shapes() as launched:
            qbrain.evaluate(test_set,
                            test_loader_kwargs=hp["test_dataloader_opts"])
        want = {s for t in frames for s in fusion_int8_shapes(t, qa)}
        if launched.seen != want:
            raise AssertionError(f"int8 fusion launched kernel 5 at "
                                 f"{sorted(launched.seen)}, the shapes held "
                                 f"are {sorted(want)}")
        log(f"  int8 fusion ({'quantize_attn' if qa else 'FFN'}) launched "
            f"kernel 5 at {sorted(launched.seen)}, each held above")
        for ev in qbrain.evals:
            expect_counts(ev["counts"],
                          {"int8_matmul": FUSION_INT8_LAUNCHES[qa]},
                          f"int8 fusion ({'quantize_attn' if qa else 'FFN'})"
                          f" of {ev['id']}")
        agree = np.concatenate([
            (np.stack(decisions(_probs(q["logits"])), -1)
             == np.stack(decisions(_probs(f["logits"])), -1)).all(-1)
            for q, f in zip(qbrain.evals, float_evals)]).mean()
        notes = {name: (len(float_songs[name]), len(est))
                 for name, est, *_ in qbrain.songs}
        ms = float(np.median([ev["wall"] for ev in qbrain.evals])) * 1e3
        log(f"  int8 fusion {'with quantize_attn' if qa else 'FFN only'}: "
            f"{FUSION_INT8_LAUNCHES[qa]} kernel-5 launches in each of "
            f"{len(qbrain.evals)} utterances, {ms:.1f} ms an utterance; "
            f"frames whose onset, offset and pitch-class decisions all equal "
            f"the float ones {agree:.4f}; notes float/int8 {notes}")
        out["quantize_attn" if qa else "ffn"] = dict(
            ms_per_utterance=ms, decision_agree=float(agree), notes=notes)
    return out


def _probs(logits):
    """Frame logits (frames, 20) → the (onset, offset, octave, class)
    columns ``decisions`` reads: probabilities and the class argmax."""
    p = 1.0 / (1.0 + np.exp(-logits[:, :2].astype(np.float64)))
    return np.concatenate([p, logits[:, 2:7].argmax(-1)[:, None],
                           logits[:, 7:].argmax(-1)[:, None]], -1)


def fusion_phase(root, rng):
    """Phase 16: the RCA fusion at the published width (FusionRCA alpha 0.5,
    8 heads, d_ffn 3072, d_model 1024, head Linear(1024 → 20)) on phase
    15's lv60 dumps and phase 17's AV-HuBERT video dumps: ``train_rca_av`` and
    ``train_rca_a`` (2 epochs, batch 8, the head warm-started from phase
    15's export, then ``evaluate``), ``run_noise_sweep`` of both (clean and
    accomp at N20EM_SNRS), int8 serving of the AV fusion, and one f32 batch
    card vs CPU. Returns (launches, summary)."""
    av_prep.prepare_csv_n20emv2_feat(root, os.path.join(root, "csv_av"), 5)
    common = dict(data_folder=root,
                  csv_folder=os.path.join(root, "csv_av", "dur_5s"),
                  pretrain_folder=os.path.join(root, "save_model"),
                  number_of_epochs=2)
    run_opts = {"device": "cuda", "noprogressbar": True}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runs, sweep_rows, sweep_s = {}, [], 0.0
    for system, cls in (("av", TimedFusion), ("a", TimedFusionA)):
        folder = os.path.join(root, f"rca_{system}")
        hp = rca_hparams(system, output_folder=folder, **common)
        init_modules(hp["modules"], hp["seed"])
        data = train_rca_av.dataio_prepare(hp)
        brain = cls(modules=hp["modules"], hparams=hp, run_opts=run_opts,
                    checkpointer=hp["checkpointer"])
        test_set, test_loss, eval_s = fit_and_evaluate(brain, hp, data,
                                                       max_key="COnPOff_f1")
        runs[system] = (brain, hp, data, test_set)
        for i, st in enumerate(brain.steps):
            if not np.isfinite(st["loss"]):
                raise AssertionError(f"nonfinite fusion loss {st['loss']}")
            expect_counts(st["counts"], {}, f"{system} fusion training step")
        for ev in brain.evals:
            expect_counts(ev["counts"], {}, f"{system} fusion evaluation")
        t0 = time.perf_counter()
        sweep_rows += run_noise_sweep.sweep(
            lambda cond, system=system, folder=folder: rca_hparams(
                system, output_folder=folder, **common, **cond),
            systems=[system], noise_types=["accomp"], snrs=N20EM_SNRS,
            run_opts={"device": "cuda"})
        sweep_s += time.perf_counter() - t0
        log(f"  {system}: epochs "
            f"{[(e['epoch'], round(e['wall'], 2), round(e['train_loss'], 4), round(e['valid_loss'], 4)) for e in brain.epochs]} "
            f"(epoch, wall s, train, valid loss); steps "
            f"{[round(st['wall'] * 1e3, 1) for st in brain.steps]} ms; test "
            f"loss {test_loss:.6f}, COnPOff/COn F1 "
            f"{brain.COnPOff_f1.avg:.4f} / {brain.COn_f1.avg:.4f}; eval "
            f"{np.median([e['wall'] for e in brain.evals]) * 1e3:.1f} ms an "
            f"utterance; evaluate {eval_s:.2f} s; checkpoint saves "
            f"{[round(t, 2) for t in brain.saves]} s, recovery "
            f"{[round(t, 2) for t in brain.recovers]} s")
    run_noise_sweep.write_rows(sweep_rows,
                               os.path.join(root, "noise_sweep.jsonl"))
    want_rows = 2 * (1 + len(N20EM_SNRS))
    if len(sweep_rows) != want_rows:
        raise AssertionError(f"{len(sweep_rows)} sweep rows, want "
                             f"{want_rows}")
    log(f"  noise sweep: {len(sweep_rows)} conditions in {sweep_s:.2f} s")
    # profiled on the control's brain, which nothing reads after: one more
    # training step, and its test set again without the recovery
    a_brain, a_hp, a_data, a_test = runs["a"]
    log("  where the device time goes in one training step of the control "
        "at batch 8 (torch.profiler):")
    batch = next(iter(a_brain.make_dataloader(
        a_data[0], Stage.TRAIN, ckpt_prefix=None,
        **dict(a_hp["train_dataloader_opts"], num_workers=0))))
    a_brain.on_stage_start(Stage.TRAIN, 3)
    step_idle = profile_run(lambda: a_brain.fit_batch(batch))
    log("  where the device time goes in the control's evaluation loop "
        "(torch.profiler, the test set without its recovery):")
    a_brain.checkpointer = None
    eval_idle = profile_run(lambda: a_brain.evaluate(
        a_test, test_loader_kwargs=a_hp["test_dataloader_opts"]))
    av_brain, av_hp, av_data, av_test = runs["av"]
    counts_float = ops.launch_counts()
    expect_counts(counts_float, {}, "fusion training, evaluation and sweep")
    frames, held, int8_rows = fusion_int8_kernel(av_hp, av_test)
    ops.reset_launch_counts()    # nothing launched before; now serving only
    int8 = int8_fusion_serving(av_brain, av_hp, av_test, frames)
    counts = ops.launch_counts()
    n_utt = len(av_test)
    want = n_utt * (FUSION_INT8_LAUNCHES[False] + FUSION_INT8_LAUNCHES[True])
    expect_counts(counts, {"int8_matmul": want}, "phase 16")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_rel, logit_err = fusion_batch_card_vs_cpu(
        dict(av_brain.modules.items()), av_hp, av_data[0])
    summary = dict(
        train_step_ms={s: float(np.median([st["wall"] for st in
                                           runs[s][0].steps])) * 1e3
                       for s in runs},
        epoch_s={s: [round(e["wall"], 3) for e in runs[s][0].epochs]
                 for s in runs},
        eval_ms_per_utterance={s: float(np.median(
            [e["wall"] for e in runs[s][0].evals])) * 1e3 for s in runs},
        sweep_s=sweep_s, sweep_rows=len(sweep_rows), int8=int8,
        int8_held_shapes=held,
        int8_kernel={name: {k: r[k] for k in ("ms", "device_ms", "plain_ms",
                                              "bound_ms", "library_ms")}
                     for name, r in int8_rows.items()},
        card_vs_cpu=dict(loss_rel=loss_rel, logits_max_abs=logit_err),
        train_step_busy=None if step_idle is None else 1 - step_idle,
        evaluate_busy=None if eval_idle is None else 1 - eval_idle,
        peak_gb=peak_gb)
    return counts, summary


# ---------------------------------------------------------------- phase 20
# the SSL families served by name at full width and depth, and what rows 1
# (7 launches a batch) and 2 (one a layer a batch) must show for each:
# wav2vec2-base's "group" extractor takes the plain frontend (can_fuse),
# WavLM's biased attention runs eagerly
FAMILY_NAMES = {"wav2vec2-base": "facebook/wav2vec2-base",
                "data2vec-audio-large": "facebook/data2vec-audio-large-960h",
                "wavlm-large": "microsoft/wavlm-large"}
FAMILY_ROWS = {"wav2vec2-base": (False, True),
               "data2vec-audio-large": (True, True),
               "wavlm-large": (True, False)}
# int8 wav2vec2-base: feat_proj, ffn1 and ffn2 of a chunked batch (8 x 249
# frames); 2 launches a layer and feat_proj's
BASE_INT8_SHAPES = ((1992, 512, 768), (1992, 768, 3072), (1992, 3072, 768))
BASE_INT8_LAUNCHES = 25
# phase 20's recipe run: a probe and a finetune epoch of wav2vec2-base
FAMILY_RECIPE_SONGS = {"train": (12, 13, 14), "valid": (11,), "test": (12,)}


def seeded_bridge(source, seed, **arch):
    """A bridge picked by ``source`` (the name check), ``arch`` overrides,
    seeded weights, and a ``Linear(hidden, 20)`` head."""
    bridge = HuggingFaceWav2Vec2(source=source, output_norm=True,
                                 arch_overrides=arch or None)
    head = Linear(HEAD_OUTPUTS, bridge.config.hidden_size)
    gen = torch.Generator().manual_seed(seed)
    load_module_tree(bridge, init_wav2vec2(bridge.config, gen))
    load_module_tree(head, init_linear(gen, bridge.config.hidden_size,
                                       HEAD_OUTPUTS))
    return bridge.eval(), head.eval()


def family_serving(rng):
    """Each family built by name, served in bf16 at batch 8; the rows'
    launches asserted. Returns {family: summary}."""
    songs = songs_for(rng, (7, 16, 23), int16_index=1)
    audio_s = sum(len(w) for w in songs.values()) / SR
    out = {}
    for i, (family, source) in enumerate(FAMILY_NAMES.items()):
        bridge, head = seeded_bridge(source, SEED + 20 + i)
        c = bridge.config
        tr = BatchedAMTTranscriber(bridge, head, chunk_seconds=5.0,
                                   batch_size=8, compute_dtype=torch.bfloat16,
                                   device="cuda")
        del bridge
        tr.transcribe(songs)                       # warm-up
        notes, wall, counts = run_path(tr, songs)
        check_frames(tr, songs)
        n_batches = len(tr._jobs(songs))
        fused, short = FAMILY_ROWS[family]
        expect_counts(counts, {"conv_frontend": 7 * n_batches * fused,
                               "flash_attention_short":
                               c.num_layers * n_batches * short},
                      f"{family} serving")
        log(f"  {family} ({source}: {c.num_layers} layers, "
            f"{c.hidden_size} wide, {c.num_heads} heads, "
            f"{c.feat_extract_norm} extractor, conv_bias={c.conv_bias}, "
            f"{'pre' if c.do_stable_layer_norm else 'post'}-LN, pos_conv "
            f"{c.pos_conv_type}, rel_pos_bias={c.rel_pos_bias}, "
            f"normalize_wav={tr.bridge.normalize_wav}): {audio_s:.1f} s in "
            f"{wall * 1e3:.1f} ms, RTFx={audio_s / wall:.1f}, "
            f"{wall * 1e3 / n_batches:.2f} ms a batch over {n_batches} "
            f"batches; launches {counts} (rows 1/2 expected: "
            f"{'7 a batch' if fused else 'none, plain frontend'} / "
            f"{'one a layer a batch' if short else 'none, eager biased attention'}"
            f"); notes { {k: len(v) for k, v in notes.items()} }")
        out[family] = dict(ms_batch=wall * 1e3 / n_batches,
                           rtfx=audio_s / wall, counts=counts)
        del tr, head
        torch.cuda.empty_cache()
    return out


def family_card_vs_cpu(rng):
    """One f32 batch, exact lengths, 2 layers at each family's full width
    (``f32_batch_check``), and AV-HuBERT base's post-LN encoder (2 layers,
    768 wide, audio features) card vs CPU at the same tolerance."""
    for i, (family, source) in enumerate(FAMILY_NAMES.items()):
        log(f"  {family}, 2 layers:")
        bridge, head = seeded_bridge(source, SEED + 30 + i, num_layers=2)
        f32_batch_check(bridge, head, rng)
    cfg = dict(encoder_layers=2)
    enc = FairseqAVHubert(config=dataclasses.replace(AVHubertConfig.base(),
                                                     **cfg))
    gen = torch.Generator().manual_seed(SEED + 33)
    params, state = init_avhubert(enc.config, gen)
    load_module_tree(enc.model, params, state)
    audio = torch.from_numpy(rng.standard_normal((2, 150, 104))
                             .astype(np.float32))
    outs = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(enc).to(dev).eval()
        with torch.inference_mode():
            outs[dev] = model({"audio": audio.to(dev)}).float().cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    ok = err <= TOL_E2E_F32 and torch.isfinite(outs["cuda"]).all().item()
    log(f"  AV-HuBERT base (post-LN, encoder_ln before the layers), 2 layers "
        f"x 768, audio (2, 150, 104) f32: card vs CPU features max_abs_err="
        f"{err:.3e} tol={TOL_E2E_F32:.1e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("AV-HuBERT base on the card disagrees with the "
                             "CPU")


def remat_steps(rng):
    """One data2vec-audio-large f32 step at batch 8 x 30 s, dropouts 0.1,
    from one seeded tree and the recipe's seed, without remat (twice: how
    far the card's own reductions let two equal steps part), with remat and
    with remat + remat_frontend: the steps' losses and clipped gradients
    held to the first, then a second step timed with its peak memory; and
    one WavLM-large step at batch 8 x 5 s with remat."""
    source = FAMILY_NAMES["data2vec-audio-large"]
    tree = init_wav2vec2(Wav2Vec2Config.data2vec_audio_large(),
                         torch.Generator().manual_seed(SEED + 40))
    head_tree = init_linear(torch.Generator().manual_seed(SEED + 41), 1024,
                            HEAD_OUTPUTS)
    batch = train_batch(rng, TRAIN_BATCH, TRAIN_SECONDS)
    ref, out = None, {}
    for mode, arch in (("no remat", {}), ("no remat, again", {}),
                       ("remat", dict(remat=True)),
                       ("remat + remat_frontend",
                        dict(remat=True, remat_frontend=True))):
        bridge = HuggingFaceWav2Vec2(source=source, output_norm=True,
                                     arch_overrides=arch or None)
        head = Linear(HEAD_OUTPUTS, 1024)
        load_module_tree(bridge, tree)
        load_module_tree(head, head_tree)
        brain = AudioAMT({"wav2vec2": bridge, "model": head},
                         hparams=amt_hparams(), run_opts={"device": "cuda"})
        brain.init_optimizers()
        brain.on_stage_start(Stage.TRAIN, 3)
        n = bridge.config.num_layers
        (loss, gnorm, wall, counts), = train_steps(brain, batch, 1)
        per_layer = 2 * n if arch else n
        expect_counts(counts, {"flash_attention_lse": per_layer,
                               "flash_attention_bwd_dq": n,
                               "flash_attention_bwd_dkv": n},
                      f"data2vec step, {mode}")
        grads = {k: p.grad for k, p in brain.modules.named_parameters()}
        if ref is None:
            ref = dict(loss=loss, gnorm=gnorm,
                       grads={k: g.clone() for k, g in grads.items()})
            rel = {}
        else:
            rel = {k: (torch.linalg.vector_norm(g - ref["grads"][k])
                       / torch.linalg.vector_norm(ref["grads"][k])).item()
                   for k, g in grads.items()
                   if torch.linalg.vector_norm(ref["grads"][k]) > 0}
        bits = ref["loss"] == loss and all(
            torch.equal(g, ref["grads"][k]) for k, g in grads.items())
        worst = max(rel.values(), default=0.0)
        loss_rel = abs(loss / ref["loss"] - 1)
        ok = (np.isfinite(loss) and loss_rel <= TOL_STEP["loss_rel"]
              and worst <= TOL_STEP["grad_rel"])
        held = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        (_, _, wall2, _), = train_steps(brain, batch, 1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  data2vec-audio-large, {mode}: loss={loss:.6f} gnorm="
            f"{gnorm:.6f}, launches {counts}; against no remat: loss rel "
            f"err {loss_rel:.3e} (tol {TOL_STEP['loss_rel']:.0e}), worst "
            f"gradient rel err {worst:.3e} (tol {TOL_STEP['grad_rel']:.0e}), "
            f"bit for bit {bits}; second step {wall2 * 1e3:.1f} ms (first "
            f"{wall * 1e3:.1f} ms), peak {peak:.2f} GiB of which "
            f"{held:.2f} GiB were held before the step (weights, Adam "
            f"moments, the reference gradients, what earlier phases left) "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {mode} step disagrees with the step "
                                 f"without remat")
        out[mode] = dict(step_ms=wall2 * 1e3, peak_gb=peak, held_gb=held,
                         bits=bits, grad_rel=worst)
        # a Brain's references form cycles: collect them before the next
        # mode so that its peak counts no earlier brain
        del brain, bridge, head, grads
        gc.collect()
        torch.cuda.empty_cache()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    log("  WavLM-large at 30 s is not run: each of its 24 layers would keep "
        "(8, 16, 1499, 1499) f32 scores, gated bias and weights (1.15 GB "
        "each) for the backward pass without remat; one step at batch 8 x "
        "5 s with remat instead")
    bridge, head = seeded_bridge(FAMILY_NAMES["wavlm-large"], SEED + 42,
                                 remat=True)
    brain = AudioAMT({"wav2vec2": bridge.train(), "model": head.train()},
                     hparams=amt_hparams(), run_opts={"device": "cuda"})
    brain.init_optimizers()
    brain.on_stage_start(Stage.TRAIN, 3)
    short = train_batch(rng, TRAIN_BATCH, 5.0)
    train_steps(brain, short, 1)                   # warm-up
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    (loss, gnorm, wall, counts), = train_steps(brain, short, 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_counts(counts, {}, "WavLM-large step")
    log(f"  wavlm-large, remat, batch 8 x 5 s: loss={loss:.6f} gnorm="
        f"{gnorm:.6f} {wall * 1e3:.1f} ms, peak {peak:.2f} GiB ({held:.2f} "
        f"GiB held before the step), launches {counts} (eager biased "
        f"attention, unfused frontend in training)")
    out["wavlm-large 5 s remat"] = dict(step_ms=wall * 1e3, peak_gb=peak,
                                        held_gb=held)
    del brain, bridge, head
    gc.collect()
    torch.cuda.empty_cache()
    return out


def base_int8(rng):
    """Row 5 at int8 wav2vec2-base's shapes, bit for bit against its plain
    version and timed beside bf16 ``torch.matmul``; then the base model
    served in int8 (``quantize_wav2vec2``) with its launches asserted."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    for m, k, n in BASE_INT8_SHAPES:
        for tag, dtype in DTYPES.items():
            hold_int8(m, k, n, tag, dtype, gen, " (wav2vec2-base)")
    rows = int8_timings(gen, shapes=BASE_INT8_SHAPES[1:])
    bridge, head = seeded_bridge(FAMILY_NAMES["wav2vec2-base"], SEED + 51)
    trs = {"float": BatchedAMTTranscriber(bridge, head, chunk_seconds=5.0,
                                          batch_size=8),
           "int8": BatchedAMTTranscriber(quantize_wav2vec2(bridge), head,
                                         chunk_seconds=5.0, batch_size=8)}
    per_batch = {}
    for name in ("float", "int8", "int8", "float"):
        ms, launches = batch_ms(trs[name], rng)
        per_batch.setdefault(name, []).append(ms)
        want = BASE_INT8_LAUNCHES if name == "int8" else 0
        if launches != want:
            raise AssertionError(f"wav2vec2-base {name}: {launches} int8 "
                                 f"launches a batch, want {want}")
    log("  wav2vec2-base, one full batch (forward only, in turns): "
        + "; ".join(f"{k} {np.mean(v):.3f} ms {[round(x, 3) for x in v]}"
                    for k, v in per_batch.items())
        + f"; int8 launches a batch {BASE_INT8_LAUNCHES}")
    del trs
    torch.cuda.empty_cache()
    return {"batch_ms " + k: float(np.mean(v)) for k, v in per_batch.items()} \
        | rows


def family_recipe(rng):
    """The MIR-ST500 recipe's command line with ``--ssl_model=wav2vec2-base
    --feat_dim=768``: a probe and a finetune epoch, then ``evaluate``."""
    root = tempfile.mkdtemp(prefix="chip_smoke_family_recipe_")
    try:
        csvs = make_recipe_set(root, rng, FAMILY_RECIPE_SONGS)
        out = os.path.join(root, "results")
        argv = [os.path.join(RECIPE_YAMLS,
                             "MIR_ST500/hparams/train_audio_ssl.yaml"),
                "--device", "cuda", "--noprogressbar",
                f"--data_folder={root}", f"--output_folder={out}",
                f"--train_csv={csvs['train']}",
                f"--valid_csv={csvs['valid']}",
                f"--test_csv=[{csvs['test']}]", "--number_of_epochs=2",
                "--linear_prob_epochs=1", "--num_workers=2",
                "--ssl_model=wav2vec2-base", "--feat_dim=768"]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        brain = mir_recipe.main(argv)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        c = brain.modules.wav2vec2.config
        with open(os.path.join(out, "train_log.txt")) as f:
            lines = f.read().splitlines()
        n_eval = (2 * len(FAMILY_RECIPE_SONGS["valid"])
                  + len(FAMILY_RECIPE_SONGS["test"]))
        ok = (c == Wav2Vec2Config.base()
              and not brain.modules.wav2vec2.normalize_wav
              and len(lines) == 3 and lines[-1].startswith("Epoch loaded")
              and counts["conv_frontend"] == 0
              and counts["flash_attention_short"] >= c.num_layers * n_eval
              and counts["flash_attention_short"] % c.num_layers == 0
              and brain.COn_f1.count == len(FAMILY_RECIPE_SONGS["test"]))
        log(f"  recipe --ssl_model=wav2vec2-base --feat_dim=768: "
            f"{wall:.1f} s for 2 epochs and evaluate; config base="
            f"{c == Wav2Vec2Config.base()}, normalize_wav="
            f"{brain.modules.wav2vec2.normalize_wav}; launches {counts}; "
            f"train log {lines} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the recipe did not run wav2vec2-base as "
                                 "asked")
        return wall
    finally:
        shutil.rmtree(root)


def families_phase(rng):
    """Phase 20; returns its summary."""
    t0 = time.perf_counter()
    summary = dict(serving=family_serving(rng))
    family_card_vs_cpu(rng)
    summary["training"] = remat_steps(rng)
    summary["int8_base"] = base_int8(rng)
    summary["recipe_s"] = family_recipe(rng)
    summary["phase_s"] = time.perf_counter() - t0
    return summary


# ---------------------------------------------------------------- phase 21
# AV-HuBERT seq2seq ASR at full width: the encoder of AV-HuBERT large and
# the 6 x 1024 fairseq decoder (V 1000), from a seeded state dict with the
# key names and shapes of tests/fixtures/ckpt_manifests.json
ASR_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures", "ckpt_manifests.json")
ASR_BATCH, ASR_FRAMES, ASR_SIDE = 4, 125, 88          # 4 x 5 s at 25 fps
ASR_LENGTHS = [125, 125, 90, 125]
ASR_BEAM = 5
# the decode routes on one card: the same steps on the same inputs, so the
# scores of equal tokens differ only where the host adds in numpy what the
# device adds in torch (IEEE, the same bits); held within 1e-5
TOL_ASR_ROUTES = 1e-5
# card vs CPU, 2 encoder and 2 decoder layers at full width, f32: the
# encoder features at the end-to-end f32 tolerance, each hypothesis score
# (a sum of up to ASR_CPU_STEPS + 1 log-probs of a 1000-way softmax whose
# logits agree to ~1e-5) within 1e-3
TOL_ASR_SCORE = 1e-3
ASR_CPU_STEPS = 30


def _zero_lm(tokens):
    """A shallow-fusion LM that adds nothing: it sends ``generate`` down its
    host path (the full log-probs read each step) without changing a
    score."""
    return torch.zeros(tokens.shape[0], 1000, device=tokens.device)


def seeded_asr_state_dict(seed):
    """A flat fairseq ``av_hubert_seq2seq`` state dict with exactly the
    manifest's keys and shapes, built on the card from one seed: weights
    of 2 or more dims normal(0, 1/sqrt(fan in)), biases normal(0, 0.02),
    LayerNorm and BatchNorm scales 1, PReLU slopes 0.25, running means 0
    and variances 1, ``mask_emb`` normal(0, 1); the batch counters and the
    sinusoidal buffer as fairseq keeps them."""
    with open(ASR_MANIFEST) as f:
        manifest = json.load(f)["avhubert-asr-seq2seq"]
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    sd = {}
    for key, shape in sorted(manifest.items()):
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[key] = torch.zeros(shape, dtype=torch.long, device=device)
        elif leaf in ("running_mean", "_float_tensor"):
            sd[key] = torch.zeros(shape, device=device)
        elif leaf == "running_var":
            sd[key] = torch.ones(shape, device=device)
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            sd[key] = torch.randn(shape, generator=gen, device=device) \
                / math.sqrt(fan_in)
        elif leaf == "bias":
            sd[key] = torch.randn(shape, generator=gen, device=device) * 0.02
        elif key.endswith(("relu1.weight", "relu2.weight",
                           "frontend3D.2.weight")):
            sd[key] = torch.full(shape, 0.25, device=device)
        elif leaf == "weight":
            sd[key] = torch.ones(shape, device=device)
        else:
            sd[key] = torch.randn(shape, generator=gen, device=device)
    return sd


def asr_inputs(rng, batch, frames):
    audio = torch.from_numpy(rng.standard_normal((batch, frames, 104))
                             .astype(np.float32))
    video = torch.from_numpy(rng.standard_normal(
        (batch, frames, ASR_SIDE, ASR_SIDE, 1)).astype(np.float32))
    return audio, video


def _same_hyps(a, b):
    """(tokens equal, worst score difference) of two generators' outputs."""
    equal, worst = True, 0.0
    for ha, hb in zip(a, b):
        equal &= len(ha) == len(hb) and all(
            torch.equal(x["tokens"], y["tokens"]) for x, y in zip(ha, hb))
        worst = max([worst] + [abs(x["score"] - y["score"])
                               for x, y in zip(ha, hb)])
    return equal and len(a) == len(b), worst


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def asr_full_width(rng):
    """Phase 21's full-width half: build, encode, the three decode routes.
    Returns the summary."""
    t0 = time.perf_counter()
    sd = seeded_asr_state_dict(SEED + 60)
    n_keys = len(sd)
    asr = AVHubertASR.from_fairseq(sd, beam_size=ASR_BEAM, device="cuda")
    del sd
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in asr.parameters())
    audio, video = asr_inputs(rng, ASR_BATCH, ASR_FRAMES)
    audio, video = audio.cuda(), video.cuda()
    layers = asr.encoder_config.encoder_layers
    enc_cfg, dec_cfg = asr.encoder_config, asr.decoder_config
    log(f"  AVHubertASR.from_fairseq on a seeded state dict of the "
        f"avhubert-asr-seq2seq manifest's {n_keys} keys (the module's "
        f"{len(asr.state_dict())} tensors): encoder "
        f"{layers} x {enc_cfg.encoder_embed_dim} ({enc_cfg.encoder_attention_heads}"
        f" heads), decoder {dec_cfg.num_layers} x {dec_cfg.embed_dim} (ffn "
        f"{dec_cfg.ffn_dim}, {dec_cfg.num_heads} heads, post-LN), V "
        f"{dec_cfg.vocab_size}; {n_params / 1e6:.1f} M parameters, built in "
        f"{build_s:.1f} s")

    # encode: row 2 once a layer, nothing else
    asr.encode(audio=audio, video=video)                      # warm-up
    ops.reset_launch_counts()
    enc = asr.encode(audio=audio, video=video)
    expect_counts(ops.launch_counts(), {"flash_attention_short": layers},
                  "AVHubertASR.encode")
    encode_ms = time_ms(lambda: asr.encode(audio=audio, video=video),
                        iters=5, warmup=1)
    assert enc.shape == (ASR_BATCH, ASR_FRAMES, 1024) and \
        torch.isfinite(enc).all()

    lengths = torch.tensor(ASR_LENGTHS, device="cuda")
    mask = torch.arange(ASR_FRAMES, device="cuda")[None] >= lengths[:, None]
    host_gen = FairseqSequenceGenerator(asr.decoder, beam_size=ASR_BEAM,
                                        lm=_zero_lm)
    routes = {
        "fast": (asr.generator, lambda: asr.transcribe(
            audio=audio, video=video, frame_lengths=ASR_LENGTHS)),
        "host": (host_gen, lambda: host_gen.generate(
            asr.encode(audio=audio, video=video),
            encoder_padding_mask=mask)),
        "device": (asr.generator, lambda: asr.transcribe(
            audio=audio, video=video, frame_lengths=ASR_LENGTHS,
            device_search=True)),
    }
    results, rows = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, (gen, run) in routes.items():
        run()                                                 # warm-up
        ops.reset_launch_counts()
        hyps, wall = _timed(run)
        expect_counts(ops.launch_counts(), {"flash_attention_short": layers},
                      f"transcribe, {name} route (encode + decode)")
        steps = gen.stats["steps"]
        reads = gen.stats["host_reads"]
        decode_s = wall - encode_ms / 1e3
        n_tok = sum(len(h[0]["tokens"]) for h in hyps)
        results[name] = hyps
        rows[name] = dict(
            ms_batch=wall * 1e3, decode_ms=decode_s * 1e3, steps=steps,
            ms_step=decode_s * 1e3 / steps,
            tokens_per_s=n_tok / decode_s,
            host_reads_per_step=reads / steps)
        log(f"  {name} route: {wall * 1e3:.1f} ms a batch (encode "
            f"{encode_ms:.1f} ms + decode {decode_s * 1e3:.1f} ms), {steps} "
            f"steps, {decode_s * 1e3 / steps:.3f} ms a step, "
            f"{n_tok / decode_s:.1f} best-hypothesis tokens/s, "
            f"{reads / steps:.3f} device-to-host reads a step ({reads} in "
            f"all), best lengths {[len(h[0]['tokens']) for h in hyps]}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("host", "device"):
        equal, worst = _same_hyps(results["fast"], results[name])
        ok = equal and worst <= TOL_ASR_ROUTES
        log(f"  {name} route against the fast path: tokens equal {equal}, "
            f"worst score difference {worst:.3e} (tol {TOL_ASR_ROUTES:.0e})"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {name} decode route disagrees with "
                                 f"the fast path")
    for hyps in results["fast"]:
        assert len(hyps) == ASR_BEAM and all(
            int(h["tokens"][-1]) == asr.generator.eos
            and np.isfinite(h["score"]) for h in hyps)
    log(f"  peak memory over the three routes {peak:.2f} GiB "
        f"(weights {n_params * 4 / 2 ** 30:.2f} GiB)")
    summary = dict(encode_ms=encode_ms, routes=rows, peak_gb=peak,
                   build_s=build_s)
    del asr, enc, host_gen, routes, results
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def asr_card_vs_cpu(rng):
    """A 2-encoder-layer, 2-decoder-layer f32 AVHubertASR at full width,
    seeded, on the card and on the CPU: encoder features, tokens and scores
    (fast path and device search)."""
    enc_cfg = dataclasses.replace(AVHubertConfig.large(), encoder_layers=2)
    dec_cfg = dataclasses.replace(default_decoder_config(), num_layers=2)
    model = AVHubertASR(enc_cfg, dec_cfg, beam_size=ASR_BEAM,
                        max_len_b=ASR_CPU_STEPS)
    params, state = init_avhubert_asr(enc_cfg, dec_cfg,
                                      torch.Generator().manual_seed(SEED + 61))
    load_module_tree(model, params, state)
    audio, video = asr_inputs(rng, 2, 50)
    out = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev).eval()
        feats = m.encode(audio=audio, video=video).cpu()
        hyps = m.transcribe(audio=audio, video=video, frame_lengths=[50, 35])
        dev_hyps = m.transcribe(audio=audio, video=video,
                                frame_lengths=[50, 35], device_search=True)
        out[dev] = (feats, hyps, dev_hyps)
        del m
    err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    equal, worst = _same_hyps(out["cuda"][1], out["cpu"][1])
    equal_d, worst_d = _same_hyps(out["cuda"][2], out["cpu"][1])
    ok = (err <= TOL_E2E_F32 and equal and equal_d
          and max(worst, worst_d) <= TOL_ASR_SCORE)
    log(f"  2 + 2 layers at full width, f32, (2, 50) frames: card vs CPU "
        f"features max_abs_err={err:.3e} (tol {TOL_E2E_F32:.0e}); tokens "
        f"equal {equal} (fast path), {equal_d} (card's device search vs "
        f"CPU's fast path); worst score difference "
        f"{max(worst, worst_d):.3e} (tol {TOL_ASR_SCORE:.0e}); best "
        f"lengths {[len(h[0]['tokens']) for h in out['cuda'][1]]} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("AVHubertASR on the card disagrees with the CPU")
    return dict(features_max_abs=err, score_max_abs=max(worst, worst_d))


def asr_phase(rng):
    """Phase 21; returns its summary. TF32 stays off, as in ``main``, so
    that the phase holds alone too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    summary = asr_full_width(rng)
    summary["card_vs_cpu"] = asr_card_vs_cpu(rng)
    summary["phase_s"] = time.perf_counter() - t0
    return summary


# --------------------------------------------------------------- phase 22
# crdnn-ligru-timit: the widths of SpeechBrain's TIMIT seq2seq CRDNN recipe
# (recipes/TIMIT/ASR/seq2seq/hparams/train.yaml), on the JAX CRDNN's own
# arguments; 42 phoneme classes (blank, bos and eos are index 0 there)
CRDNN_ARCH = dict(input_size=40, cnn_blocks=2, cnn_channels=(128, 256),
                  cnn_kernelsize=(3, 3), time_pooling=True,
                  time_pooling_size=2, freq_pooling_size=2,
                  rnn_class="ligru", rnn_layers=4, rnn_neurons=512,
                  rnn_bidirectional=True, dnn_blocks=2, dnn_neurons=512,
                  dropout=0.15)
CRDNN_DEC = dict(hidden_size=256, attn_dim=256, num_layers=1, channels=10,
                 kernel_size=100, dropout=0.5)
CRDNN_VOCAB = 42
CRDNN_EMB = 128
CRDNN_BLANK = CRDNN_BOS = CRDNN_EOS = 0
CRDNN_SECONDS = (4.5, 4.0, 3.6, 3.2, 2.9, 2.6, 2.3, 2.0)
CRDNN_TOKENS_PER_S = 12
CRDNN_CTC_WEIGHT = 0.2
CRDNN_LR = 3e-4
# card vs CPU, 2 LiGRU layers, TF32 off. In f32, cuDNN's convolutions and
# the CPU's sum in other orders. Measured on an H100 (phase 22): eval
# log-probabilities 4.8-7.2e-07 apart, the loss equal, running statistics
# 1.3-2.3e-06 of their norms; each tolerance is 4-10x its reading. The f32
# gradients behind the batch norms and the CNN's LayerNorms over channels
# (the CNN blocks, the LiGRU, the DNN blocks) are not held tightly: against
# the same step in f64 they strayed up to 1.6e-03 and 2.9e-03 on the card
# and 2.3e-04, 3.0e-04 and 3.5e-03 on the CPU, on two batches; with cuDNN
# off the card's LiGRU and DNN gradients came within 1.9e-05 of f64 while
# its CNN's stayed at 2.4-4.2e-03 (`tools/crdnn_grad_probe.py`). Those are
# sums that cancel once a norm projects out the gradient's mean and scale
# parts, behind ReLUs and max pools whose switches follow the forward's
# last bits. So the same step also runs in f64 on both devices, and there
# every leaf is held to 1e-9 of its norm (6.0e-14 measured): the card
# computes the CPU's function. In f32 the leaves no norm stands between and
# the loss (the heads, the embedding, the decoder) are held to 1e-4 of
# their norms against f64 (1.2e-05-3.0e-05 measured; one TF32 product
# would put them near 1e-3), the others to 1e-2 (about 3x the worst seen).
TOL_CRDNN = {"logp_abs": 5e-6, "loss_rel": 1e-5, "stats_rel": 1e-5,
             "grad_f64_rel": 1e-9, "grad_f32_heads": 1e-4,
             "grad_f32_normed": 1e-2}
# the modules whose parameters' gradients reach the loss through no norm
CRDNN_HEADS = ("ctc_lin.", "seq_lin.", "emb.", "dec.")
# decoding: greedy, beam 8 with CTC weight 0.3, and that beam search fused
# (weight 0.5) with an RNNLM at the JAX defaults and a 2-layer
# TransformerLM; the longest transcript is 54 tokens (12 a second of 4.5 s)
CRDNN_DECODE_BOS, CRDNN_DECODE_EOS = CRDNN_VOCAB - 2, CRDNN_VOCAB - 1
CRDNN_DECODE_STEPS = 56
CRDNN_DECODE_CPU_STEPS = 20
CRDNN_BEAM = 8
CRDNN_DECODE_CTC = 0.3
CRDNN_LM_WEIGHT = 0.5
RNNLM_ARCH = dict(embedding_dim=128, rnn_layers=2, rnn_neurons=1024,
                  dnn_blocks=1, dnn_neurons=512)
TRANSFORMER_LM_ARCH = dict(num_encoder_layers=2)
# a search on the card against the same search on the CPU, f32, TF32 off:
# the hypotheses equal and each score (a length-normalized sum of
# log-probabilities of order 1-10) within 1e-4
TOL_DECODE_SCORE = 1e-4


def crdnn_modules(arch=CRDNN_ARCH, dec=CRDNN_DEC, vocab=CRDNN_VOCAB,
                  emb=CRDNN_EMB):
    """The assembly's modules, unseeded: Fbank, the global input
    normalization, the CRDNN, the CTC head, the embedding, the
    location-aware GRU decoder and the sequence head."""
    return {"compute_features": Fbank(n_mels=arch["input_size"]),
            "normalize": InputNormalization(norm_type="global"),
            "enc": CRDNN(**arch),
            "ctc_lin": Linear(vocab, arch["dnn_neurons"]),
            "emb": Embedding(vocab, emb),
            "dec": AttentionalRNNDecoder(
                "gru", "location", enc_dim=arch["dnn_neurons"],
                input_size=emb, **dec),
            "seq_lin": Linear(vocab, dec["hidden_size"])}


def crdnn_batch(rng, seconds=CRDNN_SECONDS, vocab=CRDNN_VOCAB,
                tokens_per_s=CRDNN_TOKENS_PER_S, sr=SR):
    """Seeded noise rows of ``seconds``, zero-padded to the longest, with
    relative lengths; round(tokens_per_s · s) tokens in 1..vocab-1 a row,
    ``tokens_bos`` (bos first) and ``tokens_eos`` (eos after each row's
    tokens), each with its relative lengths."""
    n = [int(s * sr) for s in seconds]
    wav = np.zeros((len(n), max(n)), np.float32)
    for i, k in enumerate(n):
        wav[i, :k] = 0.1 * rng.standard_normal(k)
    u = [int(round(tokens_per_s * s)) for s in seconds]
    umax = max(u)
    tokens = np.zeros((len(u), umax), np.int64)
    eos = np.full((len(u), umax + 1), CRDNN_EOS, np.int64)
    for i, k in enumerate(u):
        tokens[i, :k] = rng.integers(1, vocab, k)
        eos[i, :k] = tokens[i, :k]
    bos = np.concatenate([np.full((len(u), 1), CRDNN_BOS), tokens], axis=1)
    rel = np.asarray(u, np.float32)
    return {"sig": PaddedData(torch.from_numpy(wav),
                              np.asarray(n, np.float32) / max(n)),
            "tokens": PaddedData(torch.from_numpy(tokens), rel / umax),
            "tokens_bos": PaddedData(torch.from_numpy(bos),
                                     (rel + 1) / (umax + 1)),
            "tokens_eos": PaddedData(torch.from_numpy(eos),
                                     (rel + 1) / (umax + 1))}


class CRDNNBrain(Brain):
    """The CRDNN seq2seq assembly of SpeechBrain's TIMIT recipe: features
    → global normalization (updated in training, ``self.epoch`` its epoch)
    → CRDNN → CTC log-probabilities; bos-prefixed tokens → embedding →
    location-aware decoder over the encoder → sequence log-probabilities.
    The loss is ``CRDNN_CTC_WEIGHT`` · CTC + the rest · NLL, Adam over
    every module."""

    epoch = 0

    def compute_forward(self, batch, stage, rng=None):
        m = self.modules
        train = stage == Stage.TRAIN
        wavs, wav_lens = batch["sig"]
        feats = m.normalize(m.compute_features(wavs), wav_lens,
                            epoch=self.epoch, train=train)
        x = m.enc(feats, rng=rng, train=train)
        p_ctc = torch.log_softmax(m.ctc_lin(x), dim=-1)
        h, _ = m.dec(m.emb(batch["tokens_bos"].data), x, wav_lens,
                     train=train, rng=rng)
        p_seq = torch.log_softmax(m.seq_lin(h), dim=-1)
        return p_ctc, p_seq

    def compute_objectives(self, predictions, batch, stage):
        p_ctc, p_seq = predictions
        tokens, token_lens = batch["tokens"]
        tokens_eos, eos_lens = batch["tokens_eos"]
        ctc = losses.ctc_loss(p_ctc, tokens, batch["sig"].lengths,
                              token_lens, CRDNN_BLANK)
        nll = losses.nll_loss(p_seq, tokens_eos, length=eos_lens)
        return CRDNN_CTC_WEIGHT * ctc + (1 - CRDNN_CTC_WEIGHT) * nll

    def init_optimizers(self):
        self.add_optimizer("opt", torch.optim.Adam, list(self.modules.keys()),
                           lr=self.hparams.lr)


def crdnn_brain(modules, device, seed):
    brain = CRDNNBrain(modules, hparams={"seed": seed, "lr": CRDNN_LR},
                       run_opts={"device": device})
    brain.init_optimizers()
    return brain


def crdnn_state(brain):
    """Every running statistic of the assembly (the LiGRU's and DNN
    blocks' batch norms, the input normalization's state), by name."""
    return {name: buf.detach().clone() for name, buf in
            brain.modules.named_buffers()
            if name.rsplit(".", 1)[-1] in ("mean", "var", "glob_mean",
                                           "glob_std", "count")}


def kernel_launches(fn):
    """Device kernels launched by one call of ``fn`` (torch.profiler;
    memory copies and sets are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)
               and not ev.name.lower().startswith(("memcpy", "memset")))


def crdnn_segments(brain, arrays):
    """Kernel launches of the eval forward's segments (features and
    normalization, the CRDNN, the decoder with its head) and of a forward
    and backward of the LiGRU stack and of ``ctc_loss`` alone, on the
    batch's own shapes. The LiGRU's pass runs in training (its batch
    statistics move); the gradients it leaves are cleared."""
    m = brain.modules
    wavs, wav_lens = arrays["sig"]
    with torch.no_grad():
        feats = m.normalize(m.compute_features(wavs), wav_lens, train=False)
        x = m.enc(feats)
        emb = m.emb(arrays["tokens_bos"].data)
        h = m.enc.time_pool(m.enc.cnn1(m.enc.cnn0(feats[..., None])))
        p_ctc = torch.log_softmax(m.ctc_lin(x), -1)
    h = h.reshape(h.shape[0], h.shape[1], -1).requires_grad_()
    p_ctc.requires_grad_()
    tokens, token_lens = arrays["tokens"]

    def infer(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    out = {
        "features": kernel_launches(infer(lambda: m.normalize(
            m.compute_features(wavs), wav_lens, train=False))),
        "crdnn": kernel_launches(infer(lambda: m.enc(feats))),
        "decoder": kernel_launches(infer(lambda: m.seq_lin(m.dec(
            emb, x, wav_lens)[0]))),
        "ligru_fwd_bwd": kernel_launches(lambda: m.enc.rnn(
            h, train=True)[0].sum().backward()),
        "ctc_fwd_bwd": kernel_launches(lambda: losses.ctc_loss(
            p_ctc, tokens, wav_lens, token_lens, CRDNN_BLANK).backward())}
    brain.modules.zero_grad(set_to_none=True)
    return out


def crdnn_full_width(rng):
    """Phase 22's full-width half: the Brain seeds the modules on the card;
    the eval forward (its busy share and launches by segment from the
    profiler), a warm-up and 3 timed training steps and one more whose
    launches are counted. Returns the summary."""
    t0 = time.perf_counter()
    modules = crdnn_modules()
    brain = crdnn_brain(modules, "cuda", SEED + 70)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in brain.modules.parameters())
    left_zero = [n for n, p in brain.modules.named_parameters()
                 if not bool(p.detach().any())]
    if any(is_unseeded(m) for m in brain.modules.values()) or [
            n for n in left_zero if not n.endswith((".b", ".bias"))]:
        raise AssertionError(f"the Brain left modules unseeded: {left_zero}")
    log(f"  crdnn-ligru-timit: {n_params / 1e6:.2f} M parameters seeded by "
        f"the Brain from seed {SEED + 70} in {build_s:.1f} s (zero-valued "
        f"at the start only the biases the JAX init zeroes: "
        f"{len(left_zero)})")
    batch = crdnn_batch(rng)
    arrays = brain._batch_to_device(batch)
    audio_s = sum(CRDNN_SECONDS)

    def forward():
        with torch.inference_mode():
            return brain.compute_forward(arrays, Stage.VALID)

    p_ctc, p_seq = forward()                                # warm-up
    t_frames = int(CRDNN_SECONDS[0] * 100) + 1
    want_ctc = (8, t_frames // 2, CRDNN_VOCAB)
    want_seq = (8, batch["tokens_bos"].data.shape[1], CRDNN_VOCAB)
    if tuple(p_ctc.shape) != want_ctc or tuple(p_seq.shape) != want_seq or \
            not (torch.isfinite(p_ctc).all() and torch.isfinite(p_seq).all()):
        raise AssertionError(f"eval outputs {tuple(p_ctc.shape)}, "
                             f"{tuple(p_seq.shape)}: want {want_ctc}, "
                             f"{want_seq}, finite")
    torch.cuda.reset_peak_memory_stats()
    walls = [_timed(forward)[1] for _ in range(3)]
    eval_ms = float(np.median(walls)) * 1e3
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eval_launches = kernel_launches(forward)
    log(f"  eval forward, batch 8 ({audio_s:.1f} s of audio, "
        f"{want_ctc[1]} encoder frames, {want_seq[1]} decoder steps): "
        f"{eval_ms:.2f} ms a batch (median of 3: "
        f"{[round(w * 1e3, 2) for w in walls]}), RTFx "
        f"{audio_s / (eval_ms / 1e3):.1f}, {eval_launches} kernel launches "
        f"a batch, peak memory {eval_peak:.3f} GiB")
    eval_idle = profile_run(forward)
    segments = crdnn_segments(brain, arrays)
    log(f"  kernel launches by segment: {segments}")

    before = crdnn_state(brain)
    brain.epoch = 1
    brain.on_stage_start(Stage.TRAIN, 1)
    torch.cuda.reset_peak_memory_stats()
    warm = brain.fit_batch(batch)                           # warm-up
    steps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = brain.fit_batch(batch)
        torch.cuda.synchronize()
        steps.append((loss, time.perf_counter() - t1))
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_launches = kernel_launches(lambda: brain.fit_batch(batch))
    after = crdnn_state(brain)
    losses_seen = [warm] + [s[0] for s in steps]
    still = [n for n in before if torch.equal(before[n], after[n])]
    zero = [n for n, p in brain.modules.named_parameters()
            if not bool(p.detach().any())]
    step_ms = float(np.median([s[1] for s in steps])) * 1e3
    log(f"  training: losses {[round(v, 4) for v in losses_seen]} (warm-up "
        f"first), {step_ms:.1f} ms a step (median of 3: "
        f"{[round(s[1] * 1e3, 1) for s in steps]}), {step_launches} kernel "
        f"launches a step, peak memory {train_peak:.3f} GiB; "
        f"{len(before) - len(still)} of {len(before)} running statistics "
        f"moved, normalization count {float(after['normalize.count'])}")
    if not all(np.isfinite(v) for v in losses_seen):
        raise AssertionError(f"nonfinite CRDNN losses {losses_seen}")
    if still or zero:
        raise AssertionError(f"unmoved statistics {still}, parameters at "
                             f"zero {zero}")
    summary = dict(params_m=n_params / 1e6, eval_ms=eval_ms,
                   eval_launches=eval_launches, eval_idle=eval_idle,
                   segment_launches=segments,
                   eval_peak_gb=eval_peak, step_ms=step_ms,
                   step_launches=step_launches, train_peak_gb=train_peak,
                   losses=losses_seen, build_s=build_s)
    summary["decode"] = crdnn_decoding(brain, arrays)
    del brain, modules, arrays
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def count_steps(searcher):
    """Wrap ``searcher.forward_step`` to count its calls; returns the
    one-element counter."""
    n, inner = [0], searcher.forward_step

    def step(*args):
        n[0] += 1
        return inner(*args)

    searcher.forward_step = step
    return n


def crdnn_lms(device, seed):
    """The two seeded LMs of phase 22's fused searches: an ``RNNLM`` at the
    JAX defaults and a 2-layer ``TransformerLM`` (d_model 512, 8 heads,
    d_ffn 2048, the JAX defaults), both over the 42 classes, in eval."""
    lms = {"rnnlm": RNNLM(CRDNN_VOCAB, **RNNLM_ARCH),
           "transformer_lm": TransformerLM(CRDNN_VOCAB, **TRANSFORMER_LM_ARCH)}
    init_modules(lms, seed)
    return {k: m.to(device).eval() for k, m in lms.items()}


def crdnn_searchers(m, lms, steps, frames):
    """Phase 22's four searches over the assembly's modules ``m``: greedy,
    beam 8 with CTC weight 0.3, and that beam search fused with the RNNLM
    and with the TransformerLM; ``steps`` steps at most over ``frames``
    encoder frames. The joint CTC search needs blank, bos and eos apart,
    and the TIMIT recipe gives all three index 0, so the searches take the
    last two classes as bos and eos (the weights are random: no index
    carries a meaning)."""
    common = dict(bos_index=CRDNN_DECODE_BOS, eos_index=CRDNN_DECODE_EOS,
                  min_decode_ratio=0.0,
                  max_decode_ratio=(steps + 0.5) / frames)
    beam = dict(common, blank_index=CRDNN_BLANK, beam_size=CRDNN_BEAM,
                ctc_weight=CRDNN_DECODE_CTC, ctc_linear=m["ctc_lin"])
    heads = (m["emb"], m["dec"], m["seq_lin"])
    return {"greedy": S2SRNNGreedySearcher(*heads, **common),
            "beam": S2SRNNBeamSearcher(*heads, **beam),
            "beam_rnnlm": S2SRNNBeamSearchLM(
                *heads, lms["rnnlm"], lm_weight=CRDNN_LM_WEIGHT, **beam),
            "beam_transformer_lm": S2SRNNBeamSearchTransformerLM(
                *heads, lms["transformer_lm"], lm_weight=CRDNN_LM_WEIGHT,
                **beam)}


def same_searches(got, want, what):
    """Hypotheses equal and scores within TOL_DECODE_SCORE, or raise;
    returns the largest score difference."""
    (g_hyps, g_scores), (w_hyps, w_scores) = got, want
    err = max(abs(a - b) for a, b in zip(g_scores, w_scores))
    if g_hyps != w_hyps or err > TOL_DECODE_SCORE:
        raise AssertionError(f"{what}: card {g_hyps} {g_scores} against "
                             f"CPU {w_hyps} {w_scores}")
    return err


def crdnn_decoding(brain, arrays):
    """Phase 22's decoding: the eval batch's encoder states on the card,
    the four searches over the whole batch (ms and host reads a step,
    launches a step of the beam search), then each on the longest and the
    shortest row for CRDNN_DECODE_CPU_STEPS steps against the same search
    on the CPU from the same encoder states."""
    m = brain.modules
    wavs, wav_lens = arrays["sig"]
    with torch.inference_mode():
        feats = m.normalize(m.compute_features(wavs), wav_lens, train=False)
        x = m.enc(feats)
    frames = x.shape[1]
    lms = crdnn_lms("cuda", SEED + 72)
    out = {}
    for name, searcher in crdnn_searchers(m, lms, CRDNN_DECODE_STEPS,
                                          frames).items():
        searcher(x, wav_lens)                                # warm-up
        steps = count_steps(searcher)
        (hyps, scores), wall = _timed(lambda: searcher(x, wav_lens))
        reads = searcher.host_reads
        entry = dict(steps=steps[0], ms_a_step=wall * 1e3 / steps[0],
                     host_reads_a_step=reads / steps[0],
                     hyp_lengths=[len(h) for h in hyps])
        if name == "beam":
            entry["launches_a_step"] = kernel_launches(
                lambda: searcher(x, wav_lens)) / steps[0]
        if not all(np.isfinite(scores)):
            raise AssertionError(f"{name}: nonfinite scores {scores}")
        out[name] = entry
        log(f"  decode {name}: {entry}")
    rows = [0, x.shape[0] - 1]
    cpu = {k: copy.deepcopy(m[k]).cpu() for k in ("emb", "dec", "seq_lin",
                                                  "ctc_lin")}
    cpu_lms = {k: copy.deepcopy(lm).cpu() for k, lm in lms.items()}
    x_rows, lens_rows = x[rows], wav_lens[rows]
    card = crdnn_searchers(m, lms, CRDNN_DECODE_CPU_STEPS, frames)
    host = crdnn_searchers(cpu, cpu_lms, CRDNN_DECODE_CPU_STEPS, frames)
    for name in card:
        err = same_searches(card[name](x_rows, lens_rows),
                            host[name](x_rows.cpu(), lens_rows.cpu()),
                            f"phase 22 {name}")
        out[name]["card_vs_cpu_score_err"] = err
        log(f"  decode {name}, rows {rows}, {CRDNN_DECODE_CPU_STEPS} steps: "
            f"card and CPU hypotheses equal, scores within {err:.3e} (tol "
            f"{TOL_DECODE_SCORE})")
    del lms, cpu_lms
    return out


def brain_step(make_brain, modules, batch, device, dtype=torch.float32,
               state=None, epoch=None):
    """The eval outputs, then one training forward and backward (no
    optimizer step) of the Brain ``make_brain(modules, device, SEED)`` on
    ``device`` in ``dtype``, its epoch set to ``epoch`` when given: the
    outputs (a list), the loss, the gradients by name and, with ``state``
    (Brain → running statistics by name), the statistics after the step,
    on the CPU in f64."""
    brain = make_brain({k: m.to(dtype) for k, m in modules.items()},
                       device, SEED)
    if epoch is not None:
        brain.epoch = epoch
    arrays = {k: PaddedData(v.data.to(dtype) if v.data.is_floating_point()
                            else v.data, v.lengths)
              if isinstance(v, PaddedData) else v
              for k, v in brain._batch_to_device(batch).items()}
    with torch.inference_mode():
        out = brain.compute_forward(arrays, Stage.VALID)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    outs = [t.double().cpu() for t in outs]
    loss = brain.compute_objectives(
        brain.compute_forward(arrays, Stage.TRAIN), arrays, Stage.TRAIN)
    loss.backward()
    return dict(out=outs, loss=loss.item(),
                grads={n: p.grad.double().cpu() for n, p in
                       brain.modules.named_parameters()},
                stats={n: t.double().cpu() for n, t in
                       (state(brain) if state else {}).items()})


def _card_vs_cpu(modules, batch, step):
    """``step(modules, batch, device, dtype)`` on a copy of ``modules`` in
    f32 and in f64, on the card and on the CPU, by tag ("cuda_32", ...)."""
    out = {}
    for dev in ("cuda", "cpu"):
        for dtype in (torch.float32, torch.float64):
            tag = f"{dev}_{str(dtype)[-2:]}"
            t0 = time.perf_counter()
            out[tag] = step(copy.deepcopy(modules), batch, dev, dtype)
            log(f"  {tag}: loss {out[tag]['loss']:.9f} in "
                f"{time.perf_counter() - t0:.1f} s")
    return out


def _stats_rel(got, want):
    """|card - CPU| / |CPU| of each running statistic, each a ``reading``
    (a statistic that is 0 on the CPU is held to its absolute error)."""
    return {n: reading(torch.linalg.vector_norm(got[n] - w)
                       / torch.linalg.vector_norm(w).clamp(min=1e-30))
            for n, w in want.items()}


def _worst(errs):
    """The name of the worst reading of ``errs`` (None when empty)."""
    return max(errs, key=errs.get, default=None)


def crdnn_card_vs_cpu(rng):
    """The assembly with 2 LiGRU layers and every other width as in phase
    22, dropouts 0, seeded once, on the batch's longest and shortest rows:
    one step in f32 and one in f64 on the card and on the CPU."""
    arch = dict(CRDNN_ARCH, rnn_layers=2, dropout=0.0)
    modules = crdnn_modules(arch, dict(CRDNN_DEC, dropout=0.0))
    init_modules(modules, SEED + 71)
    batch = crdnn_batch(rng, (CRDNN_SECONDS[0], CRDNN_SECONDS[-1]))
    out = _card_vs_cpu(modules, batch, functools.partial(
        brain_step, crdnn_brain, state=crdnn_state))
    t = TOL_CRDNN
    got, want = out["cuda_32"], out["cpu_32"]
    logp_err = max(reading((g - w).abs().max())
                   for g, w in zip(got["out"], want["out"]))
    loss_rel = reading(abs(got["loss"] / want["loss"] - 1))
    stats_rel = _stats_rel(got["stats"], want["stats"])
    worst_stat = _worst(stats_rel)
    f64, exempt = leaf_errors(out["cuda_64"], out["cpu_64"],
                              {"grad_rel": "grads"})
    worst64 = _worst(f64["grad_rel"])
    f32 = {dev: leaf_errors(out[f"{dev}_32"], out[f"{dev}_64"],
                            {"grad_rel": "grads"})[0]["grad_rel"]
           for dev in ("cuda", "cpu")}
    worst32 = {}
    for dev, errs in f32.items():
        for part, heads in (("heads", True), ("normed", False)):
            names = [n for n in errs if n.startswith(CRDNN_HEADS) == heads]
            worst = max(names, key=errs.get)
            worst32[dev, part] = (worst, errs[worst])
    ok = (logp_err <= t["logp_abs"] and loss_rel <= t["loss_rel"]
          and stats_rel[worst_stat] <= t["stats_rel"]
          and f64["grad_rel"][worst64] <= t["grad_f64_rel"]
          and worst32["cuda", "heads"][1] <= t["grad_f32_heads"]
          and worst32["cuda", "normed"][1] <= t["grad_f32_normed"])
    log(f"  2 LiGRU layers at full width: f32 log-probabilities max abs err "
        f"{logp_err:.3e}; loss rel err {loss_rel:.3e}; worst running-"
        f"statistic rel err {stats_rel[worst_stat]:.3e} ({worst_stat}); f64 "
        f"gradients card vs CPU, worst of {len(f64['grad_rel'])} leaves "
        f"{f64['grad_rel'][worst64]:.3e} ({worst64}), exempt (zero "
        f"gradient) {exempt}; f32 gradients against f64, worst leaf "
        + "; ".join(f"{dev} {part} {e:.3e} ({n})"
                    for (dev, part), (n, e) in worst32.items())
        + f"; tols {t} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CRDNN assembly on the card disagrees with "
                             "the CPU")
    return dict(logp_max_abs=logp_err, loss_rel=loss_rel,
                stats_rel=stats_rel[worst_stat],
                grad_rel_f64_card_vs_cpu=f64["grad_rel"][worst64],
                grad_f32_vs_f64={f"{d}_{p}": e for (d, p), (_, e) in
                                 worst32.items()})


def crdnn_phase(rng):
    """Phase 22; returns its summary. TF32 stays off, as in ``main``, so
    that the phase holds alone too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    summary = crdnn_full_width(rng)
    summary["card_vs_cpu"] = crdnn_card_vs_cpu(rng)
    summary["phase_s"] = time.perf_counter() - t0
    return summary


# --------------------------------------------------------------- phase 23
# conformer-small-librispeech: the widths of SpeechBrain's LibriSpeech
# conformer recipe (recipes/LibriSpeech/ASR/transformer/hparams/
# conformer_small.yaml), on the JAX modules' own arguments: Fbank of 80
# mels (n_fft 512), global input normalization, the convolutional frontend
# (2 blocks of 64 and 32 channels, kernel 3, strides 2: 640 features), a
# conformer TransformerASR (d_model 144, 4 heads, 12 encoder and 4 decoder
# layers, d_ffn 1024, kernel 31, dropout 0.1; the decoder pre-LN with
# GELU), CTC and sequence heads over a vocabulary of 5000; blank 0, bos 1,
# eos 2, as the recipe
CONFORMER_N_MELS = 80
CONFORMER_N_FFT = 512
CONFORMER_FRONT = dict(num_blocks=2, num_layers_per_block=1,
                       out_channels=(64, 32), kernel_sizes=(3, 3),
                       strides=(2, 2))
CONFORMER_ARCH = dict(d_model=144, nhead=4, num_encoder_layers=12,
                      num_decoder_layers=4, d_ffn=1024, dropout=0.1,
                      activation="gelu", normalize_before=True,
                      encoder_module="conformer", kernel_size=31)
CONFORMER_VOCAB = 5000
CONFORMER_BLANK, CONFORMER_BOS, CONFORMER_EOS = 0, 1, 2
CONFORMER_SECONDS = (14.0, 13.0, 12.0, 11.0, 10.0, 9.0, 8.0, 7.0)
CONFORMER_TOKENS_PER_S = 4
CONFORMER_CTC_WEIGHT = 0.3
CONFORMER_SMOOTHING = 0.1
CONFORMER_LR = 1e-3
CONFORMER_SPEEDS = [95, 100, 105]
CONFORMER_SPEC = dict(time_warp=True, time_warp_window=5, freq_mask=True,
                      n_freq_mask=2, freq_mask_width=(0, 30), time_mask=True,
                      n_time_mask=2, time_mask_width=(0, 40))
# the search: beam 10, CTC weight 0.4; random weights end no hypothesis,
# so the steps stop one past the longest transcript (56 tokens)
CONFORMER_BEAM = 10
CONFORMER_DECODE_CTC = 0.4
CONFORMER_DECODE_STEPS = 57
CONFORMER_DECODE_CPU_STEPS = 6
# card vs CPU at 2 encoder and 1 decoder layers, full width, dropout 0, no
# augmentation, f32 with TF32 off and f64, on the batch's longest and
# shortest rows. Prediction (PERF.md, before the first run): the f32 eval
# log-probabilities within 1e-5, the loss within 1e-5 of itself, the
# BatchNorm statistics within 1e-5 of their norms; every gradient in f64
# within 1e-9 of its norm; the f32 gradients against f64 within 1e-4 for
# the heads and the decoder and 1e-2 for the leaves behind the conformer's
# BatchNorm and LayerNorms (the frontend, the input projection, the
# encoder), as phase 22 found behind its norms.
TOL_CONFORMER = {"logp_abs": 1e-5, "loss_rel": 1e-5, "stats_rel": 1e-5,
                 "grad_f64_rel": 1e-9, "grad_f32_heads": 1e-4,
                 "grad_f32_normed": 1e-2}
CONFORMER_HEADS = ("ctc_lin.", "seq_lin.", "asr.tgt.", "asr.decoder.")
# the augmenters' applies on the card against the CPU on the same draws,
# f32: values of order 1 through sums of a few dozen terms
TOL_AUGMENT = 1e-5


def conformer_modules(arch=CONFORMER_ARCH, front=CONFORMER_FRONT,
                      n_mels=CONFORMER_N_MELS, vocab=CONFORMER_VOCAB,
                      augment=True, n_fft=CONFORMER_N_FFT):
    """The assembly's modules, unseeded: Fbank, the global input
    normalization, the frontend, the TransformerASR, the CTC and sequence
    heads, and with ``augment`` the speed perturbation and SpecAugment."""
    fe = ConvolutionFrontEnd(input_size=n_mels, **front)
    modules = {"compute_features": Fbank(n_mels=n_mels, n_fft=n_fft),
               "normalize": InputNormalization(norm_type="global"),
               "front": fe,
               "asr": TransformerASR(vocab, fe.output_dim(), **arch),
               "ctc_lin": Linear(vocab, arch["d_model"]),
               "seq_lin": Linear(vocab, arch["d_model"])}
    if augment:
        modules["speed_perturb"] = augmentation.SpeedPerturb(
            SR, speeds=CONFORMER_SPEEDS)
        modules["spec_augment"] = SpecAugment(**CONFORMER_SPEC)
    return modules


def conformer_batch(rng, seconds=CONFORMER_SECONDS, vocab=CONFORMER_VOCAB,
                    tokens_per_s=CONFORMER_TOKENS_PER_S, sr=SR):
    """Seeded noise rows of ``seconds``, zero-padded, with relative lengths;
    round(tokens_per_s · s) tokens in 3..vocab-1 a row, ``tokens_bos`` (bos
    first) and ``tokens_eos`` (eos after each row's tokens)."""
    n = [int(s * sr) for s in seconds]
    wav = np.zeros((len(n), max(n)), np.float32)
    for i, k in enumerate(n):
        wav[i, :k] = 0.1 * rng.standard_normal(k)
    u = [int(round(tokens_per_s * s)) for s in seconds]
    umax = max(u)
    tokens = np.zeros((len(u), umax), np.int64)
    eos = np.zeros((len(u), umax + 1), np.int64)
    for i, k in enumerate(u):
        tokens[i, :k] = rng.integers(3, vocab, k)
        eos[i, :k] = tokens[i, :k]
        eos[i, k] = CONFORMER_EOS
    bos = np.concatenate([np.full((len(u), 1), CONFORMER_BOS), tokens],
                         axis=1)
    rel = np.asarray(u, np.float32)
    return {"sig": PaddedData(torch.from_numpy(wav),
                              np.asarray(n, np.float32) / max(n)),
            "tokens": PaddedData(torch.from_numpy(tokens), rel / umax),
            "tokens_bos": PaddedData(torch.from_numpy(bos),
                                     (rel + 1) / (umax + 1)),
            "tokens_eos": PaddedData(torch.from_numpy(eos),
                                     (rel + 1) / (umax + 1))}


class ConformerBrain(Brain):
    """SpeechBrain's LibriSpeech conformer assembly: in training the
    waveforms are speed-perturbed, then features → global normalization
    (updated in training, ``self.epoch`` its epoch) → SpecAugment (in
    training) → the frontend → the TransformerASR over bos-prefixed
    tokens → CTC and sequence log-probabilities. The loss is
    ``CONFORMER_CTC_WEIGHT`` · CTC + the rest · label-smoothed NLL, Adam
    over every module."""

    epoch = 0

    def features(self, batch, stage, rng=None):
        m = self.modules
        train = stage == Stage.TRAIN
        wavs, wav_lens = batch["sig"]
        if train and "speed_perturb" in m:
            wavs = m.speed_perturb(wavs, rng=rng)
        feats = m.normalize(m.compute_features(wavs), wav_lens,
                            epoch=self.epoch, train=train)
        if train and "spec_augment" in m:
            feats = m.spec_augment(feats, rng=rng)
        return m.front(feats)

    def compute_forward(self, batch, stage, rng=None):
        m = self.modules
        enc, dec = m.asr(self.features(batch, stage, rng),
                         batch["tokens_bos"].data, batch["sig"].lengths,
                         rng=rng, train=stage == Stage.TRAIN)
        return (torch.log_softmax(m.ctc_lin(enc), dim=-1),
                torch.log_softmax(m.seq_lin(dec), dim=-1))

    def compute_objectives(self, predictions, batch, stage):
        p_ctc, p_seq = predictions
        tokens, token_lens = batch["tokens"]
        tokens_eos, eos_lens = batch["tokens_eos"]
        ctc = losses.ctc_loss(p_ctc, tokens, batch["sig"].lengths,
                              token_lens, CONFORMER_BLANK)
        nll = losses.nll_loss(p_seq, tokens_eos, length=eos_lens,
                              label_smoothing=CONFORMER_SMOOTHING)
        return CONFORMER_CTC_WEIGHT * ctc + (1 - CONFORMER_CTC_WEIGHT) * nll

    def init_optimizers(self):
        self.add_optimizer("opt", torch.optim.Adam, list(self.modules.keys()),
                           lr=self.hparams.lr)


def conformer_brain(modules, device, seed):
    brain = ConformerBrain(modules, hparams={"seed": seed,
                                             "lr": CONFORMER_LR},
                           run_opts={"device": device})
    brain.init_optimizers()
    return brain


def conformer_searcher(m, steps, frames, beam=CONFORMER_BEAM):
    """``S2STransformerBeamSearch`` over the assembly's TransformerASR and
    heads: ``beam``, CTC weight 0.4, ``steps`` steps at most over
    ``frames`` encoder frames."""
    return S2STransformerBeamSearch(
        [m["asr"], m["seq_lin"], m["ctc_lin"]], bos_index=CONFORMER_BOS,
        eos_index=CONFORMER_EOS, blank_index=CONFORMER_BLANK,
        min_decode_ratio=0.0, max_decode_ratio=(steps + 0.5) / frames,
        beam_size=beam, ctc_weight=CONFORMER_DECODE_CTC)


def conformer_state(brain):
    """The assembly's running statistics (the conformer's batch norms, the
    input normalization's state), by name."""
    return {name: buf.detach().clone() for name, buf in
            brain.modules.named_buffers()
            if name.rsplit(".", 1)[-1] in ("mean", "var", "glob_mean",
                                           "glob_std", "count")}


def write_noise_corpus(root, rng, sr=SR):
    """A small extended-CSV noise corpus (4 rows of 3-5 s of seeded noise)
    and an RIR corpus (2 decaying impulse responses of 0.25 s) under
    ``root``; returns the two CSV paths."""
    rows = {"noise": [(f"n{i}", 0.1 * rng.standard_normal(int(s * sr)))
                      for i, s in enumerate((3.0, 4.0, 5.0, 3.5))],
            "rir": []}
    t = np.arange(int(0.25 * sr)) / sr
    for i, decay in enumerate((0.05, 0.1)):
        rir = rng.standard_normal(len(t)) * np.exp(-t / decay)
        rir[0] = 1.0
        rows["rir"].append((f"r{i}", 0.5 * rir / np.abs(rir).max()))
    paths = {}
    for kind, items in rows.items():
        lines = ["ID, duration, wav, wav_format, wav_opts"]
        for name, sig in items:
            path = os.path.join(root, f"{name}.wav")
            write_audio(path, torch.from_numpy(sig.astype(np.float32)), sr)
            lines.append(f"{name}, {len(sig) / sr}, {path}, wav, ")
        paths[kind] = os.path.join(root, f"{kind}.csv")
        with open(paths[kind], "w") as f:
            f.write("\n".join(lines) + "\n")
    return paths["noise"], paths["rir"]


def augmenters_card_vs_cpu(gen, wav, lens):
    """Each augmenter's apply on the card against the CPU on the same
    draws (drawn once on the card): Resample 16000 → 15200 and 44100 →
    16000, SpeedPerturb, DropFreq, DropChunk (with noise), DoClip,
    AddBabble, AddNoise (white), AddReverb (a drawn RIR), SpecAugment's
    warp and masks. Returns the worst max abs error by augmenter."""
    A = augmentation
    cpu_wav, cpu_lens = wav.cpu(), lens.cpu()
    rir = torch.randn(1, 800, generator=gen, device="cuda") * torch.exp(
        -torch.arange(800, device="cuda") / 100.0)
    cases = {
        "resample_15200": (A.Resample(SR, 15200), lambda m, w, l, d: m(w)),
        "resample_44100": (A.Resample(44100, SR), lambda m, w, l, d: m(w)),
        "speed_perturb": (A.SpeedPerturb(SR, speeds=CONFORMER_SPEEDS),
                          lambda m, w, l, d: m.apply(w, d)),
        "drop_freq": (A.DropFreq(drop_count_low=1, drop_count_high=3),
                      lambda m, w, l, d: m.apply(w, d)),
        "drop_chunk": (A.DropChunk(drop_length_low=1000,
                                   drop_length_high=2000, drop_count_low=1,
                                   drop_count_high=5, noise_factor=0.5),
                       lambda m, w, l, d: m.apply(w, l, d)),
        "do_clip": (A.DoClip(clip_low=0.05, clip_high=0.2),
                    lambda m, w, l, d: m.apply(w, d)),
        "add_babble": (A.AddBabble(speaker_count=3, snr_low=0, snr_high=10),
                       lambda m, w, l, d: m.apply(w, l, d)),
        "add_noise": (A.AddNoise(snr_low=0, snr_high=15),
                      lambda m, w, l, d: m.apply(w, l, d)),
        "add_reverb": (A.AddReverb(rir_funct=lambda g: rir.to(g.device)),
                       lambda m, w, l, d: m.apply(w, d)),
    }
    errs = {}
    for name, (module, apply) in cases.items():
        draws = (module.draw(wav, gen) if name in ("drop_chunk", "add_babble",
                                                   "add_noise")
                 else module.draw(gen) if hasattr(module, "draw") else None)
        host_draws = None if draws is None else {
            k: (v.cpu() if torch.is_tensor(v) else v)
            for k, v in draws.items()}
        if host_draws and "generator" in host_draws:
            host_draws["generator"] = torch.Generator()
        got = apply(module.cuda(), wav, lens, draws)
        want = apply(module.cpu(), cpu_wav, cpu_lens, host_draws)
        errs[name] = (got.cpu() - want).abs().max().item()
    spec = SpecAugment(**CONFORMER_SPEC)
    feats = torch.randn(wav.shape[0], 300, CONFORMER_N_MELS, generator=gen,
                        device="cuda")
    c, w = spec.draw_warp(300, gen)
    pos, length = spec.draw_mask(wav.shape[0], CONFORMER_N_MELS, 2, (0, 30),
                                 gen)
    got = spec._mask(spec._time_warp_cw(feats, c, w), pos, length, 2)
    want = spec._mask(spec._time_warp_cw(feats.cpu(), c.cpu(), w.cpu()),
                      pos.cpu(), length.cpu(), 2)
    errs["spec_augment"] = (got.cpu() - want).abs().max().item()
    bad = {k: e for k, e in errs.items() if not e <= TOL_AUGMENT}
    log(f"  augmenters' applies, card vs CPU on the same draws, max abs "
        f"err: { {k: float(f'{e:.3e}') for k, e in errs.items()} } (tol "
        f"{TOL_AUGMENT}) -> {'FAIL ' + str(bad) if bad else 'ok'}")
    if bad:
        raise AssertionError(f"augmenters disagree card vs CPU: {bad}")
    return errs


def conformer_full_width(rng):
    """Phase 23's full-width half: the Brain seeds the modules on the card;
    the augmenters' applies against the CPU; EnvCorrupt once on the batch
    over a synthetic noise and RIR corpus; the eval forward (ms, launches,
    busy share, peak), a warm-up and 3 timed Adam steps (launches of one,
    peak, every statistic moved), the beam search over the eval batch (ms,
    launches and host reads a step), with the launches of every kernel of
    ``csrc/`` over the whole path (none expected)."""
    t0 = time.perf_counter()
    modules = conformer_modules()
    brain = conformer_brain(modules, "cuda", SEED + 80)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in brain.modules.parameters())
    left_zero = [n for n, p in brain.modules.named_parameters()
                 if not bool(p.detach().any())]
    if any(is_unseeded(m) for m in brain.modules.values()
           if next(m.parameters(), None) is not None) or [
            n for n in left_zero if not n.endswith((".b", ".bias", ".bo",
                                                    ".bq", ".bk", ".bv"))]:
        raise AssertionError(f"the Brain left modules unseeded: {left_zero}")
    if modules["front"].output_dim() != 640:
        raise AssertionError("the frontend does not give 640 features")
    log(f"  conformer-small-librispeech: {n_params / 1e6:.2f} M parameters "
        f"seeded by the Brain from seed {SEED + 80} in {build_s:.1f} s")
    batch = conformer_batch(rng)
    arrays = brain._batch_to_device(batch)
    wavs, wav_lens = arrays["sig"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    augment_errs = augmenters_card_vs_cpu(gen, wavs[:2, :SR * 2].contiguous(),
                                          wav_lens[:2])

    ops.reset_launch_counts()
    root = tempfile.mkdtemp(prefix="chip_smoke_conformer_")
    try:
        noise_csv, rir_csv = write_noise_corpus(root, rng)
        env = EnvCorrupt(reverb_prob=1.0, babble_prob=1.0, noise_prob=1.0,
                         noise_snr_low=0, noise_snr_high=15,
                         babble_speaker_count=3, babble_snr_low=0,
                         babble_snr_high=15, reverb_csv=rir_csv,
                         noise_csv=noise_csv)
        with torch.no_grad():
            corrupted, env_s = _timed(lambda: env(wavs, wav_lens, rng=gen))
        env_reads = sum(getattr(m, "host_reads", 0) for m in env.modules())
    finally:
        shutil.rmtree(root)
    if (corrupted.shape != wavs.shape or not torch.isfinite(corrupted).all()
            or torch.equal(corrupted, wavs)):
        raise AssertionError("EnvCorrupt gave no finite corrupted batch")
    log(f"  EnvCorrupt once on the batch (reverb, babble of 3, noise from "
        f"the CSV corpus): {env_s * 1e3:.1f} ms, {env_reads} host reads")
    batch["sig"] = PaddedData(corrupted.cpu(), batch["sig"].lengths)
    arrays = brain._batch_to_device(batch)

    def forward():
        with torch.inference_mode():
            return brain.compute_forward(arrays, Stage.VALID)

    p_ctc, p_seq = forward()                                # warm-up
    t_frames = int(CONFORMER_SECONDS[0] * 100) + 1
    frames = math.ceil(math.ceil(t_frames / 2) / 2)    # the frontend's
    want_ctc = (8, frames, CONFORMER_VOCAB)
    want_seq = (8, batch["tokens_bos"].data.shape[1], CONFORMER_VOCAB)
    if tuple(p_ctc.shape) != want_ctc or tuple(p_seq.shape) != want_seq or \
            not (torch.isfinite(p_ctc).all() and torch.isfinite(p_seq).all()):
        raise AssertionError(f"eval outputs {tuple(p_ctc.shape)}, "
                             f"{tuple(p_seq.shape)}: want {want_ctc}, "
                             f"{want_seq}, finite")
    torch.cuda.reset_peak_memory_stats()
    walls = [_timed(forward)[1] for _ in range(3)]
    eval_ms = float(np.median(walls)) * 1e3
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eval_launches = kernel_launches(forward)
    audio_s = sum(CONFORMER_SECONDS)
    log(f"  eval forward, batch 8 ({audio_s:.1f} s of audio, {frames} "
        f"encoder frames, {want_seq[1]} decoder positions): {eval_ms:.2f} ms "
        f"a batch (median of 3: {[round(w * 1e3, 2) for w in walls]}), RTFx "
        f"{audio_s / (eval_ms / 1e3):.1f}, {eval_launches} kernel launches "
        f"a batch, peak memory {eval_peak:.3f} GiB")
    eval_idle = profile_run(forward)

    before = conformer_state(brain)
    brain.epoch = 1
    brain.on_stage_start(Stage.TRAIN, 1)
    torch.cuda.reset_peak_memory_stats()
    warm = brain.fit_batch(batch)                           # warm-up
    steps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = brain.fit_batch(batch)
        torch.cuda.synchronize()
        steps.append((loss, time.perf_counter() - t1))
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_launches = kernel_launches(lambda: brain.fit_batch(batch))
    step_idle = profile_run(lambda: brain.fit_batch(batch))
    after = conformer_state(brain)
    losses_seen = [warm] + [s[0] for s in steps]
    still = [n for n in before if torch.equal(before[n], after[n])]
    step_ms = float(np.median([s[1] for s in steps])) * 1e3
    log(f"  training (speed perturbation and SpecAugment on): losses "
        f"{[round(v, 4) for v in losses_seen]} (warm-up first), {step_ms:.1f} "
        f"ms a step (median of 3: {[round(s[1] * 1e3, 1) for s in steps]}), "
        f"{step_launches} kernel launches a step, peak memory "
        f"{train_peak:.3f} GiB; {len(before) - len(still)} of {len(before)} "
        f"running statistics moved")
    if not all(np.isfinite(v) for v in losses_seen) or still:
        raise AssertionError(f"losses {losses_seen}, unmoved statistics "
                             f"{still}")

    m = brain.modules
    with torch.inference_mode():
        enc, _ = m.asr.encode(brain.features(arrays, Stage.VALID), wav_lens)
    searcher = conformer_searcher(m, CONFORMER_DECODE_STEPS, enc.shape[1])
    n_steps = count_steps(searcher)
    (hyps, scores), decode_s = _timed(lambda: searcher(enc, wav_lens))
    reads = searcher.host_reads
    decode_steps = n_steps[0]
    decode_launches = kernel_launches(lambda: searcher(enc, wav_lens))
    if decode_steps != CONFORMER_DECODE_STEPS or len(hyps) != 8 or \
            not all(np.isfinite(scores)):
        raise AssertionError(f"decode: {decode_steps} steps, scores "
                             f"{scores}")
    log("  where a decode's device time goes (torch.profiler, "
        f"{CONFORMER_DECODE_CPU_STEPS} steps):")
    decode_idle = profile_run(lambda: conformer_searcher(
        m, CONFORMER_DECODE_CPU_STEPS, enc.shape[1])(enc, wav_lens))
    kernel_counts = ops.launch_counts()
    log(f"  S2STransformerBeamSearch, beam {CONFORMER_BEAM}, CTC weight "
        f"{CONFORMER_DECODE_CTC}: {decode_steps} steps in "
        f"{decode_s * 1e3:.1f} ms, {decode_s * 1e3 / decode_steps:.2f} ms a "
        f"step, {decode_launches / decode_steps:.1f} kernel launches and "
        f"{reads / decode_steps:.1f} host reads a step; hypothesis lengths "
        f"{[len(h) for h in hyps]}")
    log(f"  launches of the csrc/ kernels over the phase's path: "
        f"{kernel_counts}")
    if any(kernel_counts.values()):
        raise AssertionError("the conformer path reached a csrc/ kernel")
    summary = dict(params_m=n_params / 1e6, build_s=build_s,
                   augment_max_abs_err=augment_errs, envcorrupt_ms=env_s * 1e3,
                   envcorrupt_host_reads=env_reads, eval_ms=eval_ms,
                   eval_launches=eval_launches, eval_idle=eval_idle,
                   eval_peak_gb=eval_peak, step_ms=step_ms,
                   step_launches=step_launches, step_idle=step_idle,
                   train_peak_gb=train_peak, losses=losses_seen,
                   decode_steps=decode_steps,
                   decode_ms_a_step=decode_s * 1e3 / decode_steps,
                   decode_launches_a_step=decode_launches / decode_steps,
                   decode_host_reads_a_step=reads / decode_steps,
                   decode_idle=decode_idle, csrc_launches=kernel_counts)
    del brain, modules, arrays, enc
    gc.collect()
    torch.cuda.empty_cache()
    return summary


# one training forward and backward of the conformer assembly (no
# augmentation, dropout 0) at epoch 1, no optimizer step
conformer_step = functools.partial(brain_step, conformer_brain,
                                   state=conformer_state, epoch=1)


def conformer_card_vs_cpu(rng):
    """The assembly at 2 encoder and 1 decoder layers, every width as in
    phase 23, dropout 0, no augmentation, seeded once, on the batch's
    longest and shortest rows: one step in f32 and one in f64 on the card
    and on the CPU; then the beam search (beam 3) of the seeded f32 model
    for CONFORMER_DECODE_CPU_STEPS steps, card against CPU."""
    arch = dict(CONFORMER_ARCH, num_encoder_layers=2, num_decoder_layers=1,
                dropout=0.0)
    modules = conformer_modules(arch, augment=False)
    init_modules(modules, SEED + 82)
    batch = conformer_batch(rng, (CONFORMER_SECONDS[0],
                                  CONFORMER_SECONDS[-1]))
    out = _card_vs_cpu(modules, batch, conformer_step)
    t = TOL_CONFORMER
    got, want = out["cuda_32"], out["cpu_32"]
    logp_err = max(reading((g - w).abs().max())
                   for g, w in zip(got["out"], want["out"]))
    loss_rel = reading(abs(got["loss"] / want["loss"] - 1))
    stats_rel = _stats_rel(got["stats"], want["stats"])
    worst_stat = _worst(stats_rel)
    f64, exempt = leaf_errors(out["cuda_64"], out["cpu_64"],
                              {"grad_rel": "grads"})
    worst64 = _worst(f64["grad_rel"])
    worst32 = {}
    for dev in ("cuda", "cpu"):
        errs = leaf_errors(out[f"{dev}_32"], out[f"{dev}_64"],
                           {"grad_rel": "grads"})[0]["grad_rel"]
        for part, heads in (("heads", True), ("normed", False)):
            names = [n for n in errs if n.startswith(CONFORMER_HEADS) == heads]
            worst = max(names, key=errs.get)
            worst32[dev, part] = (worst, errs[worst])
    ok = (logp_err <= t["logp_abs"] and loss_rel <= t["loss_rel"]
          and stats_rel[worst_stat] <= t["stats_rel"]
          and f64["grad_rel"][worst64] <= t["grad_f64_rel"]
          and worst32["cuda", "heads"][1] <= t["grad_f32_heads"]
          and worst32["cuda", "normed"][1] <= t["grad_f32_normed"])
    log(f"  2 + 1 layers at full width: f32 log-probabilities max abs err "
        f"{logp_err:.3e}; loss rel err {loss_rel:.3e}; worst running-"
        f"statistic rel err {stats_rel[worst_stat]:.3e} ({worst_stat}); f64 "
        f"gradients card vs CPU, worst of {len(f64['grad_rel'])} leaves "
        f"{f64['grad_rel'][worst64]:.3e} ({worst64}), exempt (zero "
        f"gradient) {exempt}; f32 gradients against f64, worst leaf "
        + "; ".join(f"{dev} {part} {e:.3e} ({n})"
                    for (dev, part), (n, e) in worst32.items())
        + f"; tols {t} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the conformer assembly on the card disagrees "
                             "with the CPU")

    brains = {dev: conformer_brain(copy.deepcopy(modules), dev, SEED)
              for dev in ("cuda", "cpu")}
    searches = {}
    for dev, brain in brains.items():
        arrays = brain._batch_to_device(batch)
        with torch.inference_mode():
            enc, _ = brain.modules.asr.encode(
                brain.features(arrays, Stage.VALID), arrays["sig"].lengths)
        searches[dev] = conformer_searcher(
            brain.modules, CONFORMER_DECODE_CPU_STEPS, enc.shape[1],
            beam=3)(enc, arrays["sig"].lengths)
    decode_err = same_searches(searches["cuda"], searches["cpu"],
                               "phase 23 S2STransformerBeamSearch")
    log(f"  beam 3, {CONFORMER_DECODE_CPU_STEPS} steps: card and CPU "
        f"hypotheses equal, scores within {decode_err:.3e} (tol "
        f"{TOL_DECODE_SCORE})")
    return dict(logp_max_abs=logp_err, loss_rel=loss_rel,
                stats_rel=stats_rel[worst_stat],
                grad_rel_f64_card_vs_cpu=f64["grad_rel"][worst64],
                grad_f32_vs_f64={f"{d}_{p}": e for (d, p), (_, e) in
                                 worst32.items()},
                decode_score_err=decode_err)


def conformer_phase(rng):
    """Phase 23; returns its summary. TF32 stays off, as in ``main``, so
    that the phase holds alone too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    summary = conformer_full_width(rng)
    summary["card_vs_cpu"] = conformer_card_vs_cpu(rng)
    summary["phase_s"] = time.perf_counter() - t0
    return summary


# --------------------------------------------------------------- phase 24
# sepformer-wsj0-2mix: SpeechBrain's recipes/WSJ0Mix/separation/hparams/
# sepformer.yaml on the JAX modules' own arguments, at 8 kHz: the encoder
# and decoder of kernel 16 and 256 channels, and a Dual_Path_Model(256,
# 256, intra, inter, num_layers=2, norm="ln", K=250, num_spks=2,
# skip_around_intra=True, linear_layer_after_inter_intra=False) with intra
# and inter each an SBTransformerBlock(8, 256, 8, 1024,
# use_positional_encoding=True, norm_before=True) (the JAX SepFormer and
# DualPathModel wrappers keep the linears and a global positional encoding,
# so the masknet is built directly); trained on SI-SNR under PIT with Adam
# at 1.5e-4 and the gradient norm clipped to 5
SEP_SR = 8000
SEP_KERNEL, SEP_CHANNELS = 16, 256
SEP_ARCH = dict(num_layers=2, tlayers=8, nhead=8, d_ffn=1024, K=250,
                num_spks=2)
SEP_LR = 1.5e-4
SEP_SECONDS = 4.0
SEP_SERVE_BATCH = 4
# card vs CPU, 1 dual block of 2 + 2 layers at width 256, 1 s, TF32 off:
# the separated sources in f32 within 1e-4 of their peak (sums of 256-wide
# f32 products in other orders through 4 layers), the loss within 1e-5;
# every gradient leaf of the same step in f64 within 1e-9 of its norm (the
# card computes the CPU's function: f32 gradients behind norms need an f64
# referee, as phase 22 found)
TOL_SEP = {"out_rel": 1e-4, "loss_rel": 1e-5, "grad_f64_rel": 1e-9}


def sepformer_modules(arch=SEP_ARCH, channels=SEP_CHANNELS,
                      kernel=SEP_KERNEL):
    """The separator's modules, unseeded: encoder, dual-path masknet of
    pre-LN transformer blocks with positions (no intra/inter linears),
    decoder."""
    def block():
        return SBTransformerBlock(arch["tlayers"], channels, arch["nhead"],
                                  arch["d_ffn"], use_positional_encoding=True,
                                  norm_before=True)

    return {"encoder": TasNetEncoder(kernel, channels),
            "masknet": Dual_Path_Model(
                channels, channels, block(), block(),
                num_layers=arch["num_layers"], norm="ln", K=arch["K"],
                num_spks=arch["num_spks"], skip_around_intra=True,
                linear_layer_after_inter_intra=False),
            "decoder": TasNetDecoder(kernel, channels)}


class SepformerBrain(Brain):
    """The separation recipe's step: the mixture separated, negative SI-SNR
    under PIT against the sources, Adam over every module."""

    def compute_forward(self, batch, stage, rng=None):
        m = self.modules
        return separate(m.encoder, m.masknet, m.decoder, batch["mix"].data)

    def compute_objectives(self, predictions, batch, stage):
        return losses.get_si_snr_with_pitwrapper(batch["sources"].data,
                                                 predictions)

    def init_optimizers(self):
        self.add_optimizer("opt", torch.optim.Adam, list(self.modules.keys()),
                           lr=self.hparams.lr)


def sepformer_brain(modules, device, seed):
    brain = SepformerBrain(modules, hparams={"seed": seed, "lr": SEP_LR},
                           run_opts={"device": device})
    brain.init_optimizers()
    return brain


def sepformer_batch(rng, batch, samples):
    """Two seeded sources a row (noise under two random spectral tilts) and
    their sum: {"mix": (B, T), "sources": (B, T, 2)}, full lengths."""
    src = rng.standard_normal((batch, samples, 2)).astype(np.float32)
    src[..., 1] = np.cumsum(src[..., 1], axis=1) * 0.05
    src[..., 1] -= src[..., 1].mean(axis=1, keepdims=True)
    src *= 0.1 / np.abs(src).max(axis=1, keepdims=True)
    ones = np.ones(batch, np.float32)
    return {"mix": PaddedData(torch.from_numpy(src.sum(-1)), ones),
            "sources": PaddedData(torch.from_numpy(src), ones)}


def _csrc_untouched(what):
    counts = ops.launch_counts()
    log(f"  launches of the csrc/ kernels over {what}: {counts}")
    if any(counts.values()):
        raise AssertionError(f"{what} reached a csrc/ kernel")
    return counts


def _seeded(modules, seed):
    """Modules seeded on the CPU from one seed; returns them and their
    parameter count."""
    init_modules(modules, seed)
    return modules, sum(p.numel() for m in modules.values()
                        for p in m.parameters())


def sepformer_full_width(rng):
    """Phase 24's full-width half: ``SepformerSeparation.separate_batch``
    on 4 x 4 s (median of 3 after a warm-up; launches, busy share, peak),
    then a warm-up and 3 timed training steps at the recipe's 1 x 4 s."""
    modules, n_params = _seeded(sepformer_modules(), SEED + 90)
    samples = int(SEP_SECONDS * SEP_SR)
    frames = (samples - SEP_KERNEL) // (SEP_KERNEL // 2) + 1
    chunks = 2 * math.ceil((frames + SEP_ARCH["K"] // 2) / SEP_ARCH["K"])
    log(f"  sepformer-wsj0-2mix: {n_params / 1e6:.2f} M parameters seeded "
        f"from seed {SEED + 90}; {samples} samples -> {frames} "
        f"encoder frames, {chunks} chunks of {SEP_ARCH['K']}")
    ops.reset_launch_counts()
    face = SepformerSeparation(modules=modules, hparams={}, device="cuda")
    serve = sepformer_batch(rng, SEP_SERVE_BATCH, samples)
    mix = serve["mix"].data
    est = face.separate_batch(mix)                           # warm-up
    if tuple(est.shape) != (SEP_SERVE_BATCH, samples, 2) or \
            not torch.isfinite(est).all():
        raise AssertionError(f"separated sources {tuple(est.shape)}")
    torch.cuda.reset_peak_memory_stats()
    walls = [_timed(lambda: face.separate_batch(mix))[1] for _ in range(3)]
    serve_ms = float(np.median(walls)) * 1e3
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    serve_launches = kernel_launches(lambda: face.separate_batch(mix))
    audio_s = SEP_SERVE_BATCH * SEP_SECONDS
    log(f"  separate_batch, {SEP_SERVE_BATCH} x {SEP_SECONDS} s: "
        f"{serve_ms:.2f} ms a batch (median of 3: "
        f"{[round(w * 1e3, 2) for w in walls]}), RTFx "
        f"{audio_s / (serve_ms / 1e3):.1f}, {serve_launches} kernel launches "
        f"a batch, peak memory {serve_peak:.3f} GiB")
    serve_idle = profile_run(lambda: face.separate_batch(mix))

    brain = sepformer_brain(vars(face.mods), "cuda", SEED)
    batch = sepformer_batch(rng, 1, samples)
    brain.on_stage_start(Stage.TRAIN, 1)
    torch.cuda.reset_peak_memory_stats()
    warm = brain.fit_batch(batch)                            # warm-up
    steps = []
    for _ in range(3):
        loss, wall = _timed(lambda: brain.fit_batch(batch))
        steps.append((loss, wall))
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_launches = kernel_launches(lambda: brain.fit_batch(batch))
    step_idle = profile_run(lambda: brain.fit_batch(batch))
    losses_seen = [warm] + [s[0] for s in steps]
    step_ms = float(np.median([s[1] for s in steps])) * 1e3
    log(f"  training, 1 x {SEP_SECONDS} s, f32: losses "
        f"{[round(v, 4) for v in losses_seen]} (warm-up first), "
        f"{step_ms:.1f} ms a step (median of 3: "
        f"{[round(s[1] * 1e3, 1) for s in steps]}), {step_launches} kernel "
        f"launches a step, peak memory {train_peak:.3f} GiB, last gradient "
        f"norm {brain.last_grad_norm:.4f}")
    if not all(np.isfinite(v) for v in losses_seen):
        raise AssertionError(f"nonfinite SepFormer losses {losses_seen}")
    counts = _csrc_untouched("phase 24's full-width path")
    del brain, face, modules
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params_m=n_params / 1e6, frames=frames, chunks=chunks,
                serve_ms=serve_ms, serve_launches=serve_launches,
                serve_idle=serve_idle, serve_peak_gb=serve_peak,
                step_ms=step_ms, step_launches=step_launches,
                step_idle=step_idle, train_peak_gb=train_peak,
                losses=losses_seen, csrc_launches=counts)


def _peak_rel(got, want):
    """The largest |card - CPU| over the outputs, over the CPU's peak, a
    ``reading``."""
    return max(reading((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
               for g, w in zip(got, want))


def _f64_grads(out):
    """The worst f64 gradient leaf card vs CPU of a ``_card_vs_cpu``
    result: (its error, its name, the exempt leaves)."""
    f64, exempt = leaf_errors(out["cuda_64"], out["cpu_64"],
                              {"grad_rel": "grads"})
    worst = _worst(f64["grad_rel"])
    return f64["grad_rel"].get(worst, 0.0), worst, exempt


def sepformer_card_vs_cpu(rng):
    """1 dual block of 2 + 2 layers at width 256, 1 x 1 s: the separated
    sources and the loss in f32, every gradient in f64, card vs CPU; then
    ``SepformerSeparation.separate_batch`` on the same mixture in f32."""
    arch = dict(SEP_ARCH, num_layers=1, tlayers=2)
    modules, _ = _seeded(sepformer_modules(arch), SEED + 91)
    batch = sepformer_batch(rng, 1, SEP_SR)
    out = _card_vs_cpu(modules, batch,
                       functools.partial(brain_step, sepformer_brain))
    got, want = out["cuda_32"], out["cpu_32"]
    errs = {"out_rel": _peak_rel(got["out"], want["out"]),
            "loss_rel": reading(abs(got["loss"] / want["loss"] - 1))}
    errs["grad_f64_rel"], worst, exempt = _f64_grads(out)
    served = {dev: SepformerSeparation(
        modules=copy.deepcopy(modules), hparams={},
        device=dev).separate_batch(batch["mix"].data).double().cpu()
        for dev in ("cuda", "cpu")}
    errs["serve_rel"] = _peak_rel([served["cuda"]], [served["cpu"]])
    tol = dict(TOL_SEP, serve_rel=TOL_SEP["out_rel"])
    ok = within(errs, tol)
    log(f"  1 dual block of 2 + 2 layers, card vs CPU: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (f32 sources and separate_batch: max abs err of their peak; "
        f"worst gradient {worst}, exempt {exempt}); tols {tol} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the SepFormer on the card disagrees with the "
                             "CPU")
    return errs


def sepformer_phase(rng):
    """Phase 24; returns its summary. TF32 stays off, as in ``main``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    summary = sepformer_full_width(rng)
    summary["card_vs_cpu"] = sepformer_card_vs_cpu(rng)
    summary["phase_s"] = time.perf_counter() - t0
    return summary


# --------------------------------------------------------------- phase 25
# ecapa-tdnn-voxceleb: recipes/VoxCeleb/SpeakerRec/hparams/
# train_ecapa_tdnn.yaml on the JAX modules' arguments: Fbank of 80 mels at
# 16 kHz, ECAPA_TDNN(80, lin_neurons=192, channels=(1024, 1024, 1024, 1024,
# 3072), kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
# attention_channels=128, res2net_scale=8, se_channels=128), Classifier(192,
# 192, 7205), LogSoftmaxWrapper(AdditiveAngularMargin(0.2, 30)), Adam at
# 1e-3 (the recipe's cyclic schedule is not run); batch 32 of 3 s. The
# recipe's sentence-level mean normalization of the features is left out:
# the JAX EncoderClassifier has no module for it.
ECAPA_ARCH = dict(input_size=80, lin_neurons=192,
                  channels=(1024, 1024, 1024, 1024, 3072),
                  kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
                  attention_channels=128, res2net_scale=8, se_channels=128)
ECAPA_SPEAKERS = 7205
ECAPA_MARGIN, ECAPA_SCALE = 0.2, 30.0
ECAPA_LR = 1e-3
ECAPA_BATCH, ECAPA_SECONDS = 32, 3.0
VERIFY_SECONDS = (3.0, 3.5, 4.0, 4.5, 5.0, 5.5, 6.0, 3.2)
# metricgan-plus-voicebank: recipes/Voicebank/enhance/MetricGAN/hparams/
# train.yaml: EnhancementGenerator(257, 200, 2) over log1p magnitudes of an
# STFT at n_fft 512, 32 ms windows, 16 ms hops at 16 kHz, resynthesized
# with the noisy phase; batch 4 of 4 s
METRICGAN_ARCH = dict(input_size=257, hidden_size=200, num_layers=2)
ENHANCE_BATCH, ENHANCE_SECONDS = 4, 4.0
# the rest of the slice, small widths, card vs CPU: outputs in f32 within
# 1e-4 of their peak (convs and products in other orders; the enhanced
# waveform is peak-normalized to 1); the complex and quaternion layers and
# ECAPA-TDNN at small width also in f64, every gradient within 1e-9 of its
# norm; running statistics after a training forward in f32 within 1e-5 of
# their norm
TOL_REST = {"out_rel": 1e-4, "grad_f64_rel": 1e-9, "stats_rel": 1e-5}


def ecapa_modules(arch=ECAPA_ARCH, speakers=ECAPA_SPEAKERS):
    return {"compute_features": Fbank(n_mels=arch["input_size"]),
            "embedding_model": ECAPA_TDNN(**arch),
            "classifier": Classifier(arch["lin_neurons"],
                                     lin_neurons=arch["lin_neurons"],
                                     out_neurons=speakers)}


class EcapaBrain(Brain):
    """The speaker-identification step: features → ECAPA-TDNN (its batch
    norms in training) → cosine classifier → additive angular margin
    softmax, Adam over every module."""

    criterion = losses.LogSoftmaxWrapper(
        losses.AdditiveAngularMargin(ECAPA_MARGIN, ECAPA_SCALE))

    def compute_forward(self, batch, stage, rng=None):
        m = self.modules
        wavs, wav_lens = batch["sig"]
        emb = m.embedding_model(m.compute_features(wavs), lengths=wav_lens,
                                train=stage == Stage.TRAIN)
        return m.classifier(emb)

    def compute_objectives(self, predictions, batch, stage):
        return self.criterion(predictions, batch["spk_id"])

    def init_optimizers(self):
        self.add_optimizer("opt", torch.optim.Adam, list(self.modules.keys()),
                           lr=self.hparams.lr)


def ecapa_brain(modules, device, seed):
    brain = EcapaBrain(modules, hparams={"seed": seed, "lr": ECAPA_LR},
                       run_opts={"device": device})
    brain.init_optimizers()
    return brain


def speech_rows(rng, seconds, sr=SR):
    """Seeded noise rows of ``seconds``, zero-padded to the longest, and
    their relative lengths."""
    n = [int(s * sr) for s in seconds]
    wav = np.zeros((len(n), max(n)), np.float32)
    for i, k in enumerate(n):
        wav[i, :k] = 0.1 * rng.standard_normal(k)
    return wav, np.asarray(n, np.float32) / max(n)


def ecapa_batch(rng, batch, seconds, speakers=ECAPA_SPEAKERS):
    wav, lens = speech_rows(rng, [seconds] * batch)
    return {"sig": PaddedData(torch.from_numpy(wav), lens),
            "spk_id": torch.from_numpy(rng.integers(0, speakers, batch))}


def _buffers(module):
    return {n: b.detach().double().cpu().clone()
            for n, b in module.named_buffers()
            if n.rsplit(".", 1)[-1] in ("mean", "var", "moving_Vrr",
                                        "moving_Vii", "moving_Vri",
                                        "moving_mean", "running_mean",
                                        "running_var")}


def ecapa_full_width():
    """Phase 25's speaker half: Adam steps at batch 32 x 3 s (every
    statistic moved), ``SpeakerRecognition.verify_batch`` on 8 pairs of
    3-6 s with relative lengths and one ``EncoderClassifier.
    classify_batch``."""
    rng = np.random.default_rng(SEED + 100)
    modules, n_params = _seeded(ecapa_modules(), SEED + 100)
    log(f"  ecapa-tdnn-voxceleb: {n_params / 1e6:.2f} M parameters with the "
        f"{ECAPA_SPEAKERS}-way head, seeded from seed {SEED + 100}")
    brain = ecapa_brain(modules, "cuda", SEED)
    batch = ecapa_batch(rng, ECAPA_BATCH, ECAPA_SECONDS)
    before = _buffers(brain.modules)
    brain.on_stage_start(Stage.TRAIN, 1)
    torch.cuda.reset_peak_memory_stats()
    warm = brain.fit_batch(batch)                           # warm-up
    steps = [_timed(lambda: brain.fit_batch(batch)) for _ in range(3)]
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_launches = kernel_launches(lambda: brain.fit_batch(batch))
    step_idle = profile_run(lambda: brain.fit_batch(batch))
    after = _buffers(brain.modules)
    still = [n for n in before if torch.equal(before[n], after[n])]
    losses_seen = [warm] + [s[0] for s in steps]
    step_ms = float(np.median([s[1] for s in steps])) * 1e3
    log(f"  training, {ECAPA_BATCH} x {ECAPA_SECONDS} s, f32: losses "
        f"{[round(v, 4) for v in losses_seen]} (warm-up first), "
        f"{step_ms:.1f} ms a step (median of 3: "
        f"{[round(s[1] * 1e3, 1) for s in steps]}), {step_launches} kernel "
        f"launches a step, peak memory {train_peak:.3f} GiB; "
        f"{len(before) - len(still)} of {len(before)} running statistics "
        f"moved")
    if not all(np.isfinite(v) for v in losses_seen) or still:
        raise AssertionError(f"losses {losses_seen}, unmoved statistics "
                             f"{still}")

    mods = dict(brain.modules.items())
    verifier = SpeakerRecognition(modules=mods, hparams={}, device="cuda")
    wav1, lens1 = speech_rows(rng, VERIFY_SECONDS)
    wav2, lens2 = speech_rows(rng, VERIFY_SECONDS[::-1])
    verifier.verify_batch(wav1, wav2, lens1, lens2)           # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls, res = [], None
    for _ in range(3):
        res, wall = _timed(lambda: verifier.verify_batch(wav1, wav2, lens1,
                                                         lens2))
        walls.append(wall)
    verify_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    verify_ms = float(np.median(walls)) * 1e3
    verify_launches = kernel_launches(
        lambda: verifier.verify_batch(wav1, wav2, lens1, lens2))
    verify_idle = profile_run(
        lambda: verifier.verify_batch(wav1, wav2, lens1, lens2))
    scores, decisions = res
    if scores.shape != (8,) or not (np.abs(scores) <= 1 + 1e-6).all():
        raise AssertionError(f"verification scores {scores}")
    clf = EncoderClassifier(modules=mods, hparams={}, device="cuda")
    (logits, score, index), classify_s = _timed(
        lambda: clf.classify_batch(wav1, lens1))
    if tuple(logits.shape) != (8, 1, ECAPA_SPEAKERS) or \
            not (np.abs(score) <= 1 + 1e-6).all():
        raise AssertionError(f"classify_batch {tuple(logits.shape)}")
    log(f"  verify_batch, 8 pairs of {min(VERIFY_SECONDS)}-"
        f"{max(VERIFY_SECONDS)} s: {verify_ms:.2f} ms (median of 3: "
        f"{[round(w * 1e3, 2) for w in walls]}), {verify_launches} kernel "
        f"launches, peak memory {verify_peak:.3f} GiB, scores "
        f"{np.round(scores, 4).tolist()}; classify_batch of 8 in "
        f"{classify_s * 1e3:.2f} ms, top index {index[:, 0].tolist()}")
    del brain, verifier, clf, mods, modules
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params_m=n_params / 1e6, step_ms=step_ms,
                step_launches=step_launches, step_idle=step_idle,
                train_peak_gb=train_peak, losses=losses_seen,
                verify_ms=verify_ms, verify_launches=verify_launches,
                verify_idle=verify_idle, verify_peak_gb=verify_peak,
                classify_ms=classify_s * 1e3)


def ecapa_card_vs_cpu(rng):
    """ECAPA-TDNN at 128 channels (every other width as in phase 25) with
    the 7205-way AAM head, 4 rows of 1.0-0.5 s with relative lengths: the
    eval logits, the loss and the running statistics after the training
    forward in f32, every gradient in f64, card vs CPU."""
    arch = dict(ECAPA_ARCH, channels=(128, 128, 128, 128, 384))
    modules, _ = _seeded(ecapa_modules(arch), SEED + 102)
    wav, lens = speech_rows(rng, (1.0, 0.8, 0.65, 0.5))
    batch = {"sig": PaddedData(torch.from_numpy(wav), lens),
             "spk_id": torch.from_numpy(rng.integers(0, ECAPA_SPEAKERS, 4))}
    out = _card_vs_cpu(modules, batch, functools.partial(
        brain_step, ecapa_brain, state=lambda b: _buffers(b.modules)))
    got, want = out["cuda_32"], out["cpu_32"]
    errs = {"out_rel": _peak_rel(got["out"], want["out"]),
            "loss_rel": reading(abs(got["loss"] / want["loss"] - 1)),
            "stats_rel": max(_stats_rel(got["stats"],
                                        want["stats"]).values())}
    errs["grad_f64_rel"], worst, exempt = _f64_grads(out)
    tol = {**TOL_REST, "loss_rel": TOL_SEP["loss_rel"]}
    ok = within(errs, tol)
    log(f"  ECAPA-TDNN (128 channels) + AAM head, card vs CPU: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (worst gradient {worst}, exempt {exempt}); tols {tol} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ECAPA-TDNN + AAM on the card disagrees with "
                             "the CPU")
    return errs


def metricgan_hparams():
    """The enhancement interface's feature hparams: STFT at n_fft 512, 32
    ms windows, 16 ms hops (16 kHz), square-root magnitudes, resynthesis
    with the noisy phase through the ISTFT."""
    stft = STFT(SR, win_length=32, hop_length=16, n_fft=512)
    istft = ISTFT(SR, win_length=32, hop_length=16, n_fft=512)
    return {"compute_stft": stft,
            "spectral_magnitude": functools.partial(spectral_magnitude,
                                                    power=0.5),
            "resynth": functools.partial(resynthesize, stft=stft,
                                         istft=istft),
            "sample_rate": SR}


def metricgan_full_width():
    """Phase 25's enhancement half: ``SpectralMaskEnhancement.
    enhance_batch`` on 4 x 4 s (median of 3 after a warm-up)."""
    rng = np.random.default_rng(SEED + 101)
    modules, n_params = _seeded(
        {"enhance_model": EnhancementGenerator(**METRICGAN_ARCH)}, SEED + 101)
    face = SpectralMaskEnhancement(modules=modules,
                                   hparams=metricgan_hparams(),
                                   device="cuda")
    noisy, _ = speech_rows(rng, [ENHANCE_SECONDS] * ENHANCE_BATCH)
    out = face.enhance_batch(noisy)                          # warm-up
    if tuple(out.shape) != noisy.shape or not torch.isfinite(out).all():
        raise AssertionError(f"enhanced {tuple(out.shape)}")
    torch.cuda.reset_peak_memory_stats()
    walls = [_timed(lambda: face.enhance_batch(noisy))[1] for _ in range(3)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.median(walls)) * 1e3
    launches = kernel_launches(lambda: face.enhance_batch(noisy))
    idle = profile_run(lambda: face.enhance_batch(noisy))
    audio_s = ENHANCE_BATCH * ENHANCE_SECONDS
    log(f"  metricgan-plus-voicebank: {n_params / 1e6:.2f} M parameters; "
        f"enhance_batch, {ENHANCE_BATCH} x {ENHANCE_SECONDS} s: {ms:.2f} ms "
        f"a batch (median of 3: {[round(w * 1e3, 2) for w in walls]}), RTFx "
        f"{audio_s / (ms / 1e3):.1f}, {launches} kernel launches, peak "
        f"memory {peak:.3f} GiB")
    cpu = SpectralMaskEnhancement(
        modules={"enhance_model": copy.deepcopy(
            face.mods.enhance_model).cpu()},
        hparams=metricgan_hparams(), device="cpu")
    err = reading((face.enhance_batch(noisy[:1]).cpu() - cpu.enhance_batch(
        noisy[:1])).abs().max())
    log(f"  one row card vs CPU (f32): max abs err {err:.3e} of outputs "
        f"peak-normalized to 1 (tol {TOL_REST['out_rel']})")
    if not within({"out_rel": err}, TOL_REST):
        raise AssertionError("the enhancement interface on the card "
                             "disagrees with the CPU")
    del face, cpu, modules
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params_m=n_params / 1e6, ms=ms, launches=launches, idle=idle,
                peak_gb=peak, card_vs_cpu=err)


def _rest_cases():
    """(name, modules factory, input factory (numpy rng → args), call,
    gradients in f64) of the small card-vs-CPU set."""
    def wav(n, t):
        return lambda r: (r.standard_normal((n, t)).astype(np.float32),)

    def seq(*shape):
        return lambda r: (r.standard_normal(shape).astype(np.float32),)

    return [
        ("ConvTasNet", lambda: ConvTasNet(2, 16, 32, 16, 32, 3, 2), wav(2, 800),
         None, False),
        ("Xvector", lambda: Xvector(24, tdnn_channels=(32, 32, 32, 32, 64),
                                    lin_neurons=16), seq(2, 50, 24),
         lambda m, x: m(x, train=True), False),
        ("Discriminator", lambda: Discriminator(16, 2, 24), seq(4, 16), None,
         False),
        ("SeganGenerator", lambda: SeganGenerator(8, (4, 8, 16)),
         wav(2, 512), None, False),
        ("SeganDiscriminator", lambda: SeganDiscriminator(8, (4, 8, 16)),
         seq(2, 512, 2), None, False),
        ("MetricDiscriminator", lambda: MetricDiscriminator(2, 6, 5),
         seq(2, 20, 24, 2), None, False),
        ("ContextNet", lambda: ContextNet(24, 32, [16, 16, 32], 3, [1, 2, 1],
                                          3, 2), seq(2, 20, 24),
         lambda m, x: m(x, train=True), False),
        ("ESPnetVGG", lambda: ESPnetVGG(24, (4, 8), 12, 2, True, 0.0),
         seq(2, 12, 24), None, False),
        ("CNNTransformerSE", lambda: CNNTransformerSE(
            16, 20, nhead=4, num_layers=2, d_ffn=32, dropout=0.0,
            input_size=20), seq(2, 9, 20), None, False),
        ("TransformerST", lambda: TransformerST(
            11, 20, 16, 4, 2, 1, 32, dropout=0.0, ctc_vocab=7),
         lambda r: (r.standard_normal((2, 9, 20)).astype(np.float32),
                    r.integers(1, 11, (2, 5))),
         lambda m, x, t: (m(x, t)[1], m.forward_asr_ctc(m.encode(x)[0])),
         False),
        ("IMU_CRNN", lambda: IMU_CRNN(6, (8, 16), 5, 12, 4), seq(2, 32, 6),
         lambda m, x: m(x, train=True), False),
        ("IMU_CRNN_GRU", lambda: IMU_CRNN_GRU(6, (8, 16), 12, 3),
         seq(2, 32, 6), None, False),
        ("CLinear", lambda: CLinear(6, input_size=8), seq(2, 5, 8), None,
         True),
        ("CConv1d", lambda: CConv1d(4, 3, input_size=8), seq(2, 9, 8), None,
         True),
        ("CConv2d", lambda: CConv2d(4, (3, 5), input_size=6),
         seq(2, 7, 9, 6), None, True),
        ("CBatchNorm", lambda: CBatchNorm(input_size=8), seq(4, 5, 8),
         lambda m, x: m(x, train=True), True),
        ("CLayerNorm", lambda: CLayerNorm(8), seq(2, 5, 8), None, True),
        ("CRNN", lambda: CRNN(4, input_size=8, num_layers=2,
                              bidirectional=True), seq(2, 6, 8), None, True),
        ("CLSTM", lambda: CLSTM(4, input_size=8), seq(2, 6, 8), None, True),
        ("CLiGRU", lambda: CLiGRU(4, input_size=8), seq(2, 6, 8),
         lambda m, x: m(x, train=True), True),
        ("QLinear", lambda: QLinear(3, input_size=8), seq(2, 5, 8), None,
         True),
        ("QLinear spinor", lambda: QLinear(3, input_size=8, spinor=True,
                                           vector_scale=True),
         seq(2, 5, 8), None, True),
        ("QConv1d", lambda: QConv1d(3, 3, input_size=8), seq(2, 9, 8), None,
         True),
        ("QConv2d spinor", lambda: QConv2d(3, 3, input_size=8, spinor=True,
                                           vector_scale=True),
         seq(2, 7, 9, 8), None, True),
        ("QBatchNorm", lambda: QBatchNorm(input_size=8), seq(6, 8),
         lambda m, x: m(x, train=True), True),
        ("QRNN", lambda: QRNN(2, input_size=8), seq(2, 6, 8),
         lambda m, x: m(x)[0], True),
        ("QLSTM", lambda: QLSTM(2, input_size=8, bidirectional=True),
         seq(2, 6, 8), lambda m, x: m(x)[0], True),
        ("QLiGRU", lambda: QLiGRU(2, input_size=8), seq(2, 6, 8),
         lambda m, x: m(x, train=True)[0], True),
    ]


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _rest_run(make, args, call, device, dtype, seed, grads):
    module = make()
    init_modules({"m": module}, seed)
    module = module.to(device, dtype)
    xs = [torch.as_tensor(a).to(device) for a in args]
    xs = [x.to(dtype) if x.is_floating_point() else x for x in xs]
    call = call or (lambda m, *a: m(*a))
    if not grads:
        with torch.no_grad():
            out = call(module, *xs)
        outs = out if isinstance(out, tuple) else (out,)
        return dict(outs=[_first(o).double().cpu() for o in outs],
                    stats=_buffers(module))
    out = _first(call(module, *xs))
    # a fixed seeded projection of the output: every leaf, a norm's shift
    # too, gets a gradient that depends on the data
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    (out * w.to(out.device, out.dtype)).sum().backward()
    return dict(outs=[out.detach().double().cpu()], stats=_buffers(module),
                grads={n: p.grad.double().cpu()
                       for n, p in module.named_parameters()
                       if p.grad is not None})


def rest_card_vs_cpu(rng):
    """Every other module of the slice at small width, card vs CPU: f32
    outputs (and running statistics after training forwards), and for the
    layers that train a backward in f64."""
    worst = {"out_rel": 0.0, "grad_f64_rel": 0.0, "stats_rel": 0.0}
    where = {}
    for i, (name, make, inputs, call, grads) in enumerate(_rest_cases()):
        args = inputs(rng)
        res = {(dev, dt): _rest_run(make, args, call, dev, dt, SEED + 110 + i,
                                    grads and dt == torch.float64)
               for dev in ("cuda", "cpu")
               for dt in ((torch.float32, torch.float64) if grads
                          else (torch.float32,))}
        got, want = res["cuda", torch.float32], res["cpu", torch.float32]
        errs = {"out_rel": _peak_rel(got["outs"], want["outs"]),
                "stats_rel": max(_stats_rel(got["stats"],
                                            want["stats"]).values(),
                                 default=0.0)}
        exempt = []
        if grads:      # a leaf with no gradient in exact arithmetic exempt
            errs["grad_f64_rel"], _, exempt = _f64_grads(
                {"cuda_64": res["cuda", torch.float64],
                 "cpu_64": res["cpu", torch.float64]})
        for k, v in errs.items():
            if v >= worst[k]:
                worst[k], where[k] = v, name
        log(f"  {name}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + (f" (exempt {exempt})" if exempt else ""))
    ok = within(worst, TOL_REST)
    log(f"  worst of {len(_rest_cases())} modules: "
        + ", ".join(f"{k} {v:.3e} ({where.get(k)})" for k, v in worst.items())
        + f"; tols {TOL_REST} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a module of the slice disagrees card vs CPU")
    return worst


def speaker_enhancement_phase(rng):
    """Phase 25; returns its summary."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    summary = {"ecapa": ecapa_full_width(),
               "ecapa_card_vs_cpu": ecapa_card_vs_cpu(rng),
               "metricgan": metricgan_full_width(),
               "rest_card_vs_cpu": rest_card_vs_cpu(rng)}
    summary["csrc_launches"] = _csrc_untouched("phase 25's paths")
    summary["phase_s"] = time.perf_counter() - t0
    return summary


# --------------------------------------------------------------- phase 26
# wav2vec2-large-lv60 pretraining: the JAX ``Wav2Vec2Pretrain`` defaults
# (fairseq's examples/wav2vec/config/pretraining/wav2vec2_large_librivox.yaml:
# codevectors 256 of 2 groups x 320 entries, 100 negatives, mask 0.65 x 10,
# logit temperature 0.1, diversity weight 0.1, dropouts 0.1), Adam at a
# fixed 1e-4 (fairseq's schedule warms up to 5e-3; one step on seeded
# weights needs no schedule). Batch 4 of 25 s crops reaches the streaming
# kernels (T 1249 >= 1024); fairseq crops to max_sample_size 320000, 20 s,
# T 999, which the dispatch sends to the eager path.
PRETRAIN_BATCH = 4
PRETRAIN_SECONDS = 25.0
PRETRAIN_CROP_SECONDS = 20.0
PRETRAIN_LR = 1e-4
# phase 27's CTCSegmentation: 4 texts inside one 10 s recording, encoded
# whole (wav (1, 160000), T 499: the short kernel's last tile band of keys,
# 449-512; 20 s would give T 999, the eager band). Phase 2 holds rows 1
# and 2 at these shapes.
SEGMENT_SECONDS = 10.0
# AV-HuBERT large pretraining (audio + video, concat), the JAX
# ``AVHubertPretrain`` defaults: 500 clusters, final_dim 256, logit
# temperature 0.1, mask 0.8 x 10; batch 2 of 6 s at 25 fps, 88 x 88 crops
AVH_PRETRAIN_BATCH, AVH_PRETRAIN_FRAMES, AVH_CROP = 2, 150, 88
# FSDP2 on one rank against the plain step: the same kernels on the copies
# its all-gather makes, and a one-rank reduce-scatter and division by the
# world size, which are exact, so the expected difference is 0; 1e-6 of a
# leaf's largest update (and of the loss) leaves room for an f32 sum taken
# in another order in its flat buffers, far below a wrong shard (which
# moves a leaf by its whole update)
TOL_FSDP = {"loss_rel": 1e-6, "update_rel": 1e-6}
# one f64 step card vs CPU: every gradient leaf, the loss and the aux values
TOL_PRETRAIN_F64 = 1e-9


def pretrain_model(arch=None, seed=SEED + 120):
    model = HuggingFaceWav2Vec2Pretrain("facebook/wav2vec2-large-lv60",
                                        arch_overrides=arch)
    init_modules({"model": model}, seed)
    return model


def pretrain_rng(seed):
    return StepRNG(torch.Generator("cuda").manual_seed(seed),
                   torch.Generator().manual_seed(seed))


def pretrain_step(call, opt, wav, mask, negs, seed):
    """One Adam step of ``call`` (the model, or a wrapper of it) with the
    generators seeded from ``seed``; returns (loss, aux) as floats."""
    opt.zero_grad(set_to_none=True)
    loss, aux = call(wav, mask, negs, rng=pretrain_rng(seed), train=True)
    loss.backward()
    opt.step()
    vals = torch.stack([loss.detach()] + [v.detach() for v in aux.values()])
    vals = vals.tolist()
    return vals[0], dict(zip(aux, vals[1:]))


def pretrain_full_width(rng):
    """Phase 26 (a): returns (model, optimizer, batch, counts, summary)."""
    model = pretrain_model().cuda()
    c = model.config
    opt = torch.optim.Adam(model.parameters(), lr=PRETRAIN_LR)
    n = int(PRETRAIN_SECONDS * SR)
    wav = torch.from_numpy((0.1 * rng.standard_normal(
        (PRETRAIN_BATCH, n))).astype(np.float32)).cuda()
    frames = c.output_length(n)
    log(f"  lv60 pretraining: {c.num_layers} layers x {c.hidden_size}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters; batch {PRETRAIN_BATCH} x {PRETRAIN_SECONDS:.0f} s "
        f"({frames} frames), f32, dropouts 0.1, Adam {PRETRAIN_LR}")
    want = dict({name: c.num_layers for name in TRAIN_KERNELS},
                conv_frontend=len(c.conv_dim))
    steps = []
    for i in range(4):                       # a warm-up, then 3 timed
        t0 = time.perf_counter()
        mask, negs = model.sample_masks(PRETRAIN_BATCH, n, rng)
        mask_ms = (time.perf_counter() - t0) * 1e3
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, aux = pretrain_step(model, opt, wav, mask, negs, SEED + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        log(f"  {'warm-up' if i == 0 else f'step {i}'}: {wall * 1e3:.1f} ms, "
            f"masks on the host {mask_ms:.1f} ms ({int(mask.sum())} masked "
            f"frames), loss {loss:.6f} {aux}, launches {counts} (total "
            f"{sum(counts.values())})")
        if not math.isfinite(loss):
            raise AssertionError(f"nonfinite pretraining loss {loss}")
        expect_counts(counts, want, "lv60 pretraining step")
        if i:
            steps.append((wall, mask_ms, loss, aux))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = float(np.median([w for w, *_ in steps])) * 1e3
    log(f"  median step {step_ms:.1f} ms, peak memory {peak_gb:.2f} GiB")
    log("  where the device time goes (torch.profiler, one step):")
    idle = profile_run(lambda: pretrain_step(model, opt, wav, mask, negs,
                                             SEED + 9))

    crop = int(PRETRAIN_CROP_SECONDS * SR)
    short = wav[:, :crop].contiguous()
    mask_s, negs_s = model.sample_masks(PRETRAIN_BATCH, crop, rng)
    pretrain_step(model, opt, short, mask_s, negs_s, SEED + 10)  # warm-up
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_s, _ = pretrain_step(model, opt, short, mask_s, negs_s, SEED + 11)
    torch.cuda.synchronize()
    crop_ms = (time.perf_counter() - t0) * 1e3
    crop_counts = ops.launch_counts()
    log(f"  fairseq's {PRETRAIN_CROP_SECONDS:.0f} s crop "
        f"({c.output_length(crop)} frames, eager attention): "
        f"{crop_ms:.1f} ms a step, loss {loss_s:.6f}, launches {crop_counts}")
    expect_counts(crop_counts, {"conv_frontend": len(c.conv_dim)},
                  "20 s pretraining step")
    summary = dict(step_ms=step_ms, step_ms_all=[w * 1e3 for w, *_ in steps],
                   mask_ms=[m for _, m, *_ in steps], peak_gb=peak_gb,
                   idle=idle, losses=[(l, a) for *_, l, a in steps],
                   launches=counts, crop20_step_ms=crop_ms)
    return model, opt, (wav, mask, negs), counts, summary


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def pretrain_parallel(model, batch):
    """Phase 26 (b): the plain step (twice), the step through DDP and the
    step under FSDP2, each from (a)'s weights with a fresh Adam, on a
    one-rank NCCL group, deterministic algorithms on. The FSDP check leaves
    out the attention's key biases, whose gradient is 0 in exact arithmetic
    (float noise, which Adam's first step turns into ±lr)."""
    wav, mask, negs = batch
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for how in ("plain", "plain_again", "ddp", "fsdp"):
            clone = call = copy.deepcopy(model)
            if how == "ddp":
                call = torch.nn.parallel.DistributedDataParallel(
                    clone, device_ids=[torch.cuda.current_device()])
            elif how == "fsdp":
                apply_fsdp(clone, make_mesh())
            copt = torch.optim.Adam(clone.parameters(), lr=PRETRAIN_LR)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, aux = pretrain_step(call, copt, wav, mask, negs, SEED + 20)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            runs[how] = dict(loss=loss, aux=aux, ms=wall, params={
                n: _full(p).cpu() for n, p in clone.named_parameters()})
            log(f"  {how}: loss {loss!r}, {wall:.1f} ms")
            del clone, copt, call
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    before = {n: p.detach().cpu() for n, p in model.named_parameters()}
    ref = runs["plain"]
    result = {}
    for how in ("plain_again", "ddp", "fsdp"):
        got = runs[how]
        equal = sum(torch.equal(got["params"][n], ref["params"][n])
                    for n in ref["params"])
        worst = max(reading((got["params"][n] - ref["params"][n]).abs().max()
                            / (ref["params"][n] - before[n]).abs().max()
                            .clamp(min=1e-30)) for n in ref["params"]
                    if not n.endswith("attn.bk"))
        loss_rel = reading(abs(got["loss"] / ref["loss"] - 1))
        result[how] = dict(loss_rel=loss_rel, update_rel=worst,
                           equal_leaves=equal, leaves=len(ref["params"]),
                           ms=got["ms"])
        log(f"  {how} against the plain step: loss {got['loss']!r} vs "
            f"{ref['loss']!r} (rel {loss_rel:.3e}); {equal} of "
            f"{len(ref['params'])} updated leaves bit for bit, worst "
            f"|difference| / |update| {worst:.3e}")
    bitwise = lambda r: (r["equal_leaves"] == r["leaves"]  # noqa: E731
                         and r["loss_rel"] == 0)
    ok = (bitwise(result["ddp"]) and within(
        {k: result["fsdp"][k] for k in TOL_FSDP}, TOL_FSDP))
    log(f"  DDP bit for bit: {bitwise(result['ddp'])} (the plain step again:"
        f" {bitwise(result['plain_again'])}); FSDP within {TOL_FSDP}: "
        f"{within({k: result['fsdp'][k] for k in TOL_FSDP}, TOL_FSDP)} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the DDP or FSDP step departs from the plain "
                             "step")
    return result


def pretrain_checkpoint(model, opt):
    """Phase 26 (e): an asynchronous DCP save of ``model`` and its Adam,
    then a restore into fresh copies, bit for bit."""
    root = tempfile.mkdtemp(prefix="chip_smoke_dcp_")
    try:
        ck = OrbaxCheckpointer(root, {"model": model}, async_save=True)
        ck.add_recoverable("opt", opt, module=model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save_checkpoint(meta={"phase": 26})
        staged = time.perf_counter() - t0
        ck.wait_until_finished()
        saved = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(root) for f in files)
        fresh = pretrain_model(seed=SEED + 121).cuda()
        fopt = torch.optim.Adam(fresh.parameters(), lr=PRETRAIN_LR)
        back = OrbaxCheckpointer(root, {"model": fresh})
        back.add_recoverable("opt", fopt, module=fresh)
        t0 = time.perf_counter()
        step = back.recover_if_possible()
        restored = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), fresh.state_dict().values()))
        mine, theirs = opt.state_dict()["state"], fopt.state_dict()["state"]
        same_opt = len(mine) == len(theirs) and all(
            torch.equal(torch.as_tensor(mine[k][f]), torch.as_tensor(
                theirs[k][f])) for k in mine for f in mine[k])
        log(f"  DCP async save: {staged:.2f} s to hand back, {saved:.2f} s "
            f"written ({size / 2 ** 30:.2f} GiB), restore {restored:.2f} s "
            f"(step {step}); model bit for bit: {same}, Adam state bit for "
            f"bit: {same_opt}")
        if not (same and same_opt and step == 0):
            raise AssertionError("the DCP checkpoint did not restore bit for "
                                 "bit")
        return dict(staged_s=staged, saved_s=saved, restore_s=restored,
                    gib=size / 2 ** 30)
    finally:
        shutil.rmtree(root)


def avhubert_pretrain_batch(rng, batch, frames, crop, feat_dim=104):
    audio = torch.from_numpy(rng.standard_normal(
        (batch, frames, feat_dim)).astype(np.float32))
    video = torch.from_numpy(rng.standard_normal(
        (batch, frames, crop, crop, 1)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, 500, (batch, frames)))
    return {"audio": audio, "video": video}, targets


def avhubert_pretrain_full_width(rng):
    """Phase 26 (c): AV-HuBERT large pretraining steps."""
    model = AVHubertPretrain(AVHubertConfig.large())
    init_modules({"model": model}, SEED + 122)
    model.cuda()
    opt = torch.optim.Adam(model.parameters(), lr=PRETRAIN_LR)
    source, targets = avhubert_pretrain_batch(
        rng, AVH_PRETRAIN_BATCH, AVH_PRETRAIN_FRAMES, AVH_CROP)
    source = {k: v.cuda() for k, v in source.items()}
    targets = targets.cuda()
    log(f"  AV-HuBERT large pretraining (concat): "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters, batch {AVH_PRETRAIN_BATCH} x {AVH_PRETRAIN_FRAMES} "
        f"frames (audio 104, video {AVH_CROP} x {AVH_CROP}), f32")
    walls = []
    for i in range(4):
        mask = model.sample_masks(AVH_PRETRAIN_BATCH, AVH_PRETRAIN_FRAMES,
                                  rng)
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, aux = model(source, targets, mask, rng=pretrain_rng(SEED + i),
                          train=True)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        vals = {k: v.item() for k, v in aux.items()}
        log(f"  {'warm-up' if i == 0 else f'step {i}'}: {wall * 1e3:.1f} ms, "
            f"loss {loss.item():.6f} {vals}, launches {ops.launch_counts()}")
        if not math.isfinite(loss.item()):
            raise AssertionError("nonfinite AV-HuBERT pretraining loss")
        if i:
            walls.append(wall * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  median step {float(np.median(walls)):.1f} ms, peak {peak:.2f} GiB")
    del model, opt
    torch.cuda.empty_cache()
    return dict(step_ms=float(np.median(walls)), step_ms_all=walls,
                peak_gb=peak)


def _f64_step(make, call, device):
    module = make().to(device, torch.float64)
    loss, aux = call(module, device)
    loss.backward()
    return dict(loss=loss.item(), aux={k: v.item() for k, v in aux.items()},
                grads={n: p.grad.cpu() for n, p in module.named_parameters()
                       if p.grad is not None},
                stats={n: b.cpu() for n, b in module.named_buffers()})


def pretrain_card_vs_cpu(rng):
    """Phase 26 (d): one f64 step of 2 lv60-width and of 2 AV-HuBERT-width
    layers, dropouts 0, the Gumbel noise drawn once on the host; every
    gradient leaf, the loss, the aux values and the statistics card vs
    CPU."""
    # dropouts 0, and the eager attention (the kernels take f32 and bf16)
    quiet = dict(num_layers=2, hidden_dropout=0.0, attention_dropout=0.0,
                 activation_dropout=0.0, feat_proj_dropout=0.0,
                 attention_impl="eager")
    n = 2 * SR
    wav = torch.from_numpy(rng.standard_normal((2, n)))
    w2v = pretrain_model(quiet, seed=SEED + 123)
    frames = w2v.config.output_length(n)
    mask, negs = w2v.sample_masks(2, n, rng)
    noise = w2v.model.quantizer.draw_noise(
        torch.Generator().manual_seed(SEED), 2, frames).double()

    def w2v_call(m, dev):
        return m(wav.to(dev), mask, negs, train=True,
                 gumbel_noise=noise.to(dev), fused_frontend=False)

    cfg = dataclasses.replace(AVHubertConfig.large(), encoder_layers=2,
                              dropout=0.0, attention_dropout=0.0)
    avh = AVHubertPretrain(cfg)
    avh.model.enc_cfg.attention_impl = "eager"     # every layer's config
    init_modules({"model": avh}, SEED + 124)
    source, targets = avhubert_pretrain_batch(rng, 2, 25, AVH_CROP)
    avh_mask = avh.sample_masks(2, 25, rng)

    def avh_call(m, dev):
        src = {k: v.to(dev, torch.float64) for k, v in source.items()}
        return m(src, targets.to(dev), avh_mask, train=True)

    out = {}
    for name, module, call in (("wav2vec2", w2v, w2v_call),
                               ("avhubert", avh, avh_call)):
        res = {dev: _f64_step(lambda: copy.deepcopy(module), call, dev)
               for dev in ("cuda", "cpu")}
        got, want = res["cuda"], res["cpu"]
        errs, exempt = leaf_errors(got, want, {"grad_rel": "grads"})
        worst = _worst(errs["grad_rel"])
        vals = dict(loss=(got["loss"], want["loss"]),
                    **{k: (got["aux"][k], want["aux"][k]) for k in got["aux"]})
        readings = {"grad_rel": errs["grad_rel"].get(worst, 0.0),
                    **{k: reading(abs(a - b) / max(abs(b), 1e-30))
                       for k, (a, b) in vals.items()}}
        if got["stats"]:
            readings["stats_rel"] = max(_stats_rel(got["stats"],
                                                   want["stats"]).values())
        tol = {k: TOL_PRETRAIN_F64 for k in readings}
        ok = within(readings, tol) and all(
            n.endswith("attn.bk") for n in exempt)
        log(f"  {name} f64 card vs CPU: "
            + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
            + f" (worst leaf {worst}, exempt {exempt}; tol "
            f"{TOL_PRETRAIN_F64:.0e}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} pretraining on the card disagrees "
                                 f"with the CPU")
        out[name] = readings
    return out


def pretrain_phase(rng):
    """Phase 26; returns (launches of a 25 s lv60 step, summary). TF32 stays
    off, as in ``main``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model, opt, batch, counts, summary = pretrain_full_width(rng)
    log("  (b) the same step under a one-rank NCCL process group: plain, "
        "plain again, DistributedDataParallel, FSDP2 (apply_fsdp)")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        summary["parallel"] = pretrain_parallel(model, batch)
        log("  (e) an asynchronous torch.distributed.checkpoint save of the "
            "model and Adam, and a restore")
        summary["checkpoint"] = pretrain_checkpoint(model, opt)
    finally:
        dist.destroy_process_group()
    del model, opt, batch
    torch.cuda.empty_cache()
    log("  (c) AV-HuBERT large pretraining")
    summary["avhubert"] = avhubert_pretrain_full_width(rng)
    log("  (d) f64 steps card vs CPU")
    summary["card_vs_cpu"] = pretrain_card_vs_cpu(rng)
    summary["phase_s"] = time.perf_counter() - t0
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 27: the serving interfaces and the back-ends of ROADMAP.md item 20.

# (a) wav2vec2-large-lv60 CTC serving through EncoderASR: a Linear(1024 ->
# 1000) head with a log-softmax over a 1000-piece unigram tokenizer, blank
# 0, decoded greedily (the shape of SpeechBrain's wav2vec2 EncoderASR
# models, their DNN between encoder and head left out); batch 8 of 3-5 s
# rows padded to 5 s (T 249: the short attention kernel), f32
ENCODER_ASR_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "svt_speechbrain_tpu_torch", "pretrained",
                                "hparams", "encoder_asr_lv60.yaml")
CTC_VOCAB = 1000
CTC_BLANK = 0
CTC_SECONDS = (5.0, 4.7, 4.4, 4.1, 3.8, 3.5, 3.2, 3.0)
# CTCSegmentation's recording (``SEGMENT_SECONDS``, beside phase 26's
# constants, since phase 2 holds the kernels at its shapes too)
SEGMENT_TEXTS = ["the cat sat on the mat", "a quiet morning by the sea",
                 "seven green birds flew home", "and then the rain came"]
# (b) conformer-small-librispeech through EncoderDecoderASR: phase 23's
# assembly (its Transformer LM left out), S2STransformerBeamSearch at beam
# 10 and CTC weight 0.4 over a 5000-piece unigram tokenizer, batch 4 x 5 s
# (126 encoder frames). Seeded weights never emit EOS, so the decode is
# capped here at E2E_STEPS steps (max_decode_ratio (steps + 0.5) / frames)
E2E_BATCH, E2E_SECONDS, E2E_STEPS = 4, 5.0, 24
# (c) vad-crdnn-libriparty: Fbank 40, global input normalization, a CRDNN
# of 2 CNN blocks of (16, 16) channels, 3 x 3 kernels, no time pooling, 2
# bidirectional GRU layers of 32, 1 DNN block of 16, Linear(16 -> 1); 10
# ms posteriors; one 60 s recording of noise bursts and silences
VAD_ARCH = dict(input_size=40, cnn_blocks=2, cnn_channels=(16, 16),
                cnn_kernelsize=(3, 3), time_pooling=False, rnn_class="gru",
                rnn_layers=2, rnn_neurons=32, rnn_bidirectional=True,
                dnn_blocks=1, dnn_neurons=16, dropout=0.15)
VAD_SECONDS = 60.0
VAD_RESOLUTION = 0.01
# (d) 4 mics on a 10 cm square, batch 4 of 10 s at 16 kHz, one STFT
# (n_fft 400: 201 bins, 1001 frames); a source at MIC_DOA plus
# uncorrelated noise, the first second noise only (the noise covariance's
# frames)
MICS = np.array([[-0.05, -0.05, 0.0], [-0.05, 0.05, 0.0],
                 [0.05, 0.05, 0.0], [0.05, -0.05, 0.0]], np.float32)
MIC_DOA = np.array([0.6, 0.64, 0.48], np.float32)
MIC_BATCH, MIC_SECONDS, MIC_NOISE_SECONDS = 4, 10.0, 1.0
# (e) diarization: ECAPA-TDNN at phase 25's widths, embeddings of 1.5 s
# windows every 0.75 s of a 60 s recording of three synthetic sources
DIAR_SECONDS, DIAR_WINDOW, DIAR_HOP = 60.0, 1.5, 0.75
# (f) card against the CPU in f64: every reading within 1e-9 (of the
# output's peak for the log-posteriors, states, beamformer outputs and
# posteriors; of each value for the eigenvalues and the DP scores); the
# Viterbi alignments and the localizers' directions equal
TOL_F64 = 1e-9


def seeded_unigram(path, n_pieces, seed):
    """A ``n_pieces`` unigram SentencePiece model written by
    ``spm_proto.write_model`` from a seeded piece list (<unk>, the word
    marker, every letter alone and after the marker, then seeded letter
    strings with seeded log-probabilities) to ``path``; returns it loaded
    by ``spm_lite``."""
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    pieces = [("<unk>", 0.0, 2), ("▁", -4.0, 1)]
    pieces += [(c, -8.0, 1) for c in letters]
    pieces += [("▁" + c, -6.0, 1) for c in letters]
    seen = {p[0] for p in pieces}
    while len(pieces) < n_pieces:
        word = "".join(rng.choice(letters, int(rng.integers(2, 7))))
        word = ("▁" if rng.random() < 0.5 else "") + word
        if word not in seen:
            seen.add(word)
            pieces.append((word, float(np.float32(-rng.uniform(5, 15))), 1))
    with open(path, "wb") as f:
        f.write(spm_proto.write_model(pieces, model_type="unigram", unk_id=0,
                                      vocab_size=n_pieces))
    tok = spm_lite.SentencePieceProcessor()
    tok.load(path)
    return tok


def ctc_encoder(arch=None, vocab=CTC_VOCAB):
    """lv60 (with ``arch`` over its config) → Linear(hidden → vocab) →
    log-softmax, unseeded."""
    config = Wav2Vec2Config.large_lv60()
    if arch:
        config = dataclasses.replace(config, **arch)
    return Wav2Vec2CTCEncoder(
        HuggingFaceWav2Vec2(config=config, normalize_wav=True),
        Linear(vocab, config.hidden_size))


def write_encoder_asr_export(folder, encoder, vocab, seed):
    """An export folder that ``EncoderASR.from_hparams`` reads: the
    inference yaml (``pretrained/hparams/encoder_asr_lv60.yaml``),
    ``encoder.pt`` and ``tokenizer.model``; returns the tokenizer."""
    os.makedirs(folder, exist_ok=True)
    shutil.copy(ENCODER_ASR_YAML, os.path.join(folder, "hyperparams.yaml"))
    torch.save(encoder.state_dict(), os.path.join(folder, "encoder.pt"))
    return seeded_unigram(os.path.join(folder, "tokenizer.model"), vocab,
                          seed)


def vad_modules(arch=VAD_ARCH):
    """The VAD's modules, unseeded."""
    return {"compute_features": Fbank(n_mels=arch["input_size"]),
            "mean_var_norm": InputNormalization(norm_type="global"),
            "model": Sequential(CRDNN(**arch),
                                Linear(1, arch["dnn_neurons"]))}


def vad_recording(rng, seconds, sr=SR):
    """One row of noise bursts (0.4-3 s, amplitude 0.05-0.3) between
    silences (0.2-2 s of noise at 1e-3)."""
    n = int(seconds * sr)
    wav = 1e-3 * rng.standard_normal(n)
    t = int(rng.uniform(0.2, 2.0) * sr)
    while t < n:
        k = min(int(rng.uniform(0.4, 3.0) * sr), n - t)
        wav[t:t + k] += rng.uniform(0.05, 0.3) * rng.standard_normal(k)
        t += k + int(rng.uniform(0.2, 2.0) * sr)
    return wav[None].astype(np.float32)


def settle_norm(norm, features, wav):
    """Give a global ``InputNormalization`` the statistics of one training
    batch (its first update), as a trained model holds them."""
    with torch.no_grad():
        norm(features(wav), torch.ones(wav.shape[0]), train=True)


def seeded_vad(seed, arch=VAD_ARCH, device="cuda"):
    """The VAD interface on seeded modules: the statistics of one seeded
    training batch, and the output layer rescaled so that the logits of
    that batch have median 0 and spread 4 (random weights give posteriors
    in a narrow band about one value). Returns it and its parameter
    count."""
    rng = np.random.default_rng(seed)
    modules, n_params = _seeded(vad_modules(arch), seed)
    wav = torch.from_numpy(vad_recording(rng, 4.0))
    settle_norm(modules["mean_var_norm"], modules["compute_features"], wav)
    with torch.no_grad():
        feats = modules["mean_var_norm"](modules["compute_features"](wav),
                                         train=False)
        logits = modules["model"](feats)
        out = modules["model"][1]
        scale = 4.0 / logits.std()
        out.w *= scale
        out.b.copy_((out.b - logits.median()) * scale)
    vad = VAD(modules=modules, hparams={"sample_rate": SR,
                                        "time_resolution": VAD_RESOLUTION},
              device=device)
    return vad, n_params


def multimic_recording(rng, batch=MIC_BATCH, seconds=MIC_SECONDS,
                       noise_seconds=MIC_NOISE_SECONDS, sr=SR):
    """(batch, samples, 4) f32: a broadband source reaching each mic from
    ``MIC_DOA``, mic m ahead by ``doas2taus``'s τ_m in whole samples (a
    mic nearer the source hears it earlier), after ``noise_seconds`` of
    noise only, plus uncorrelated noise."""
    n, lead = int(seconds * sr), int(noise_seconds * sr)
    taus = np.rint((sr / 343.0) * (MICS @ MIC_DOA)).astype(int)
    pad = int(np.abs(taus).max()) + 1
    src = rng.standard_normal((batch, n + 2 * pad))
    src[:, :lead + pad] = 0.0
    x = np.stack([src[:, pad + t: pad + t + n] for t in taus], axis=-1)
    x = 0.1 * x + 0.02 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def multimic_covariances(xs, lead_frames):
    """The mixture's covariance, the noise's (of the first
    ``lead_frames`` frames) and the source's (of the rest), each averaged
    over its frames and held at every frame: (B, T, F, 2, P)."""
    cov = Covariance()
    full = cov(xs)
    nns = cov(xs[:, :lead_frames])[:, :1].expand(full.shape)
    sss = cov(xs[:, lead_frames:])[:, :1].expand(full.shape)
    return full, sss, nns


def diarization_recording(rng, seconds=DIAR_SECONDS, sr=SR):
    """Three synthetic sources in turns of 2-6 s, each a harmonic series
    on its own pitch over noise of its own colour; returns the wav
    (samples,) and the turns [(start s, end s, source)]."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    wav = np.zeros(n)
    turns, start, spk = [], 0.0, 0
    pitches, taps = (110.0, 180.0, 260.0), (1, 3, 7)
    while start < seconds:
        end = min(seconds, start + rng.uniform(2.0, 6.0))
        a, b = int(start * sr), int(end * sr)
        tone = sum(np.sin(2 * np.pi * pitches[spk] * h * t[a:b]) / h
                   for h in range(1, 6))
        noise = np.convolve(rng.standard_normal(b - a),
                            np.ones(taps[spk]) / taps[spk], mode="same")
        wav[a:b] = 0.1 * tone + 0.05 * noise
        turns.append((start, end, spk))
        start, spk = end, (spk + 1 + int(rng.integers(0, 2))) % 3
    return wav.astype(np.float32), turns


def _peak_err(got, want):
    """max |got - want| over the peak of |want|, as a ``reading``."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return reading((got - want).abs().max() / want.abs().max())


def _rows12(counts):
    return {k: counts[k] for k in ("conv_frontend", "flash_attention_short")}


def encoder_asr_serving(rng, root):
    """Phase 27 (a): lv60 CTC serving through ``EncoderASR.from_hparams``
    on an export folder, ``transcribe_file`` and ``CTCSegmentation``.
    Returns (launches of rows 1 and 2 over one batch and one segmentation
    call, summary)."""
    t0 = time.perf_counter()
    encoder = ctc_encoder()
    _, n_params = _seeded({"encoder": encoder}, SEED + 130)
    folder = os.path.join(root, "encoder_asr")
    tok = write_encoder_asr_export(folder, encoder, CTC_VOCAB, SEED + 131)
    want_w = encoder.ctc_lin.w.detach().clone()
    del encoder
    t1 = time.perf_counter()
    asr = EncoderASR.from_hparams(folder, savedir=os.path.join(
        folder, "collected"), device="cuda")
    load_s = time.perf_counter() - t1
    if not torch.equal(asr.mods.encoder.ctc_lin.w.cpu(), want_w) or \
            asr.hparams.tokenizer.pieces != tok.pieces:
        raise AssertionError("from_hparams did not load the export")
    log(f"  lv60 CTC: {n_params / 1e6:.2f} M parameters seeded from seed "
        f"{SEED + 130}; the export written in {t1 - t0:.2f} s and read by "
        f"from_hparams in {load_s:.2f} s")
    wav, lens = speech_rows(rng, CTC_SECONDS)
    asr.transcribe_batch(wav, lens)                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls, per_batch = [], []
    for _ in range(3):
        ops.reset_launch_counts()
        (words, hyps), wall = _timed(lambda: asr.transcribe_batch(wav, lens))
        walls.append(wall)
        per_batch.append(ops.launch_counts())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for counts in per_batch:
        expect_counts(counts, {"conv_frontend": 7,
                               "flash_attention_short": 24},
                      "an EncoderASR batch")
    ms = float(np.median(walls)) * 1e3
    audio_s = float(lens.sum()) * wav.shape[1] / SR
    launches = kernel_launches(lambda: asr.transcribe_batch(wav, lens))
    idle = profile_run(lambda: asr.transcribe_batch(wav, lens))
    lp = asr.encode_batch(wav, lens)
    frames = asr.mods.encoder.wav2vec2.config.output_length(wav.shape[1])
    if tuple(lp.shape) != (len(wav), frames, CTC_VOCAB) or \
            not bool(torch.isfinite(lp).all()) or \
            float((lp.exp().sum(-1) - 1).abs().max()) > 1e-4:
        raise AssertionError(f"log-posteriors {tuple(lp.shape)} are not "
                             "finite normalized distributions")
    if len(hyps) != len(wav) or not all(isinstance(w, str) for w in words):
        raise AssertionError("transcribe_batch gave no hypothesis a row")
    log(f"  transcribe_batch, {len(wav)} x {CTC_SECONDS[-1]}-"
        f"{CTC_SECONDS[0]} s: {ms:.2f} ms a batch (median of 3: "
        f"{[round(w * 1e3, 2) for w in walls]}), RTFx "
        f"{audio_s / (ms / 1e3):.1f}, launches of rows 1 and 2 a batch "
        f"{_rows12(per_batch[0])}, {launches} kernel launches a batch, "
        f"peak {peak:.3f} GiB, tokens a row {[len(h) for h in hyps]}")
    path = os.path.join(folder, "utt.wav")
    write_audio(path, 0.1 * rng.standard_normal(int(5 * SR)), SR)
    asr.transcribe_file(path)                                  # warm-up
    text, file_s = _timed(lambda: asr.transcribe_file(path))
    log(f"  transcribe_file on a 5 s WAV: {file_s * 1e3:.2f} ms, "
        f"{len(text.split())} words")

    seg_wav = speech_rows(rng, [SEGMENT_SECONDS])[0]
    aligner = CTCSegmentation(asr, blank_id=CTC_BLANK)
    aligner(seg_wav, SEGMENT_TEXTS)                            # warm-up
    ops.reset_launch_counts()
    task, seg_s = _timed(lambda: aligner(seg_wav, SEGMENT_TEXTS,
                                         name="rec"))
    seg_counts = ops.launch_counts()
    expect_counts(seg_counts, {"conv_frontend": 7,
                               "flash_attention_short": 24},
                  "a CTCSegmentation call")
    bounds = [(s, e) for s, e, _ in task.segments]
    if len(bounds) != len(SEGMENT_TEXTS) or not all(
            0.0 <= s <= e <= SEGMENT_SECONDS + 0.02 for s, e in bounds):
        raise AssertionError(f"segments {task.segments}")
    log(f"  CTCSegmentation of {len(SEGMENT_TEXTS)} texts in one "
        f"{SEGMENT_SECONDS} s recording: {seg_s * 1e3:.2f} ms, launches of "
        f"rows 1 and 2 {_rows12(seg_counts)}, segments "
        f"{[(round(s, 2), round(e, 2)) for s, e in bounds]}")
    counts = {k: per_batch[0][k] + seg_counts[k]
              for k in ("conv_frontend", "flash_attention_short")}
    del asr, aligner, lp
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(params_m=n_params / 1e6, load_s=load_s,
                        batch_ms=ms, rtfx=audio_s / (ms / 1e3),
                        launches=launches, idle=idle, peak_gb=peak,
                        file_ms=file_s * 1e3, segmentation_ms=seg_s * 1e3)


def conformer_asr_modules(seed, arch=CONFORMER_ARCH, front=CONFORMER_FRONT,
                          n_mels=CONFORMER_N_MELS, vocab=CONFORMER_VOCAB):
    """Phase 23's assembly seeded, its normalization settled on a seeded
    batch: (the ``TransformerASREncoder``, the modules of
    ``S2STransformerBeamSearch``, the parameter count)."""
    rng = np.random.default_rng(seed)
    m, n_params = _seeded(conformer_modules(arch, front, n_mels, vocab,
                                            augment=False), seed)
    wav = torch.from_numpy(speech_rows(rng, [4.0, 3.0])[0])
    settle_norm(m["normalize"], m["compute_features"], wav)
    encoder = TransformerASREncoder(m["compute_features"], m["normalize"],
                                    m["front"], m["asr"])
    return encoder, [m["asr"], m["seq_lin"], m["ctc_lin"]], n_params


def conformer_interface(encoder, parts, tok, steps, frames, device,
                        beam=CONFORMER_BEAM):
    """``EncoderDecoderASR`` over the encoder and a beam search of at most
    ``steps`` steps over ``frames`` encoder frames."""
    searcher = S2STransformerBeamSearch(
        parts, bos_index=CONFORMER_BOS, eos_index=CONFORMER_EOS,
        blank_index=CONFORMER_BLANK, min_decode_ratio=0.0,
        max_decode_ratio=(steps + 0.5) / frames, beam_size=beam,
        ctc_weight=CONFORMER_DECODE_CTC)
    return EncoderDecoderASR(modules={"encoder": encoder,
                                      "decoder": searcher},
                             hparams={"tokenizer": tok}, device=device)


def conformer_frames(samples):
    """Encoder frames of ``samples``: 10 ms Fbank frames through the
    frontend's stride-2 blocks."""
    frames = 1 + samples // int(SR * 0.01)
    for _ in range(CONFORMER_FRONT["num_blocks"]):
        frames = (frames - 1) // 2 + 1
    return frames


def encoder_decoder_serving(rng, root):
    """Phase 27 (b): conformer-small-librispeech through
    ``EncoderDecoderASR`` on 4 x 5 s."""
    encoder, parts, n_params = conformer_asr_modules(SEED + 140)
    tok = seeded_unigram(os.path.join(root, "conformer.model"),
                         CONFORMER_VOCAB, SEED + 141)
    frames = conformer_frames(int(E2E_SECONDS * SR))
    asr = conformer_interface(encoder, parts, tok, E2E_STEPS, frames, "cuda")
    steps = count_steps(asr.mods.decoder)
    wav, lens = speech_rows(rng, [E2E_SECONDS * f for f in
                                  (1.0, 0.9, 0.8, 0.7)][:E2E_BATCH])
    asr.transcribe_batch(wav, lens)                            # warm-up
    ops.reset_launch_counts()
    walls = []
    for _ in range(2):
        steps[0] = 0
        (words, hyps), wall = _timed(lambda: asr.transcribe_batch(wav, lens))
        walls.append(wall)
    enc, enc_s = _timed(lambda: asr.encode_batch(wav, lens))
    if tuple(enc.shape) != (E2E_BATCH, frames, CONFORMER_ARCH["d_model"]) \
            or not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"encoder states {tuple(enc.shape)}")
    if steps[0] != E2E_STEPS or len(hyps) != E2E_BATCH or \
            not all(isinstance(w, str) for w in words):
        raise AssertionError(f"{steps[0]} decode steps, {len(hyps)} hyps")
    _csrc_untouched("EncoderDecoderASR")
    launches = kernel_launches(lambda: asr.transcribe_batch(wav, lens))
    idle = profile_run(lambda: asr.transcribe_batch(wav, lens))
    ms = float(np.median(walls)) * 1e3
    step_ms = (ms - enc_s * 1e3) / E2E_STEPS
    log(f"  conformer-small: {n_params / 1e6:.2f} M parameters; "
        f"transcribe_batch {E2E_BATCH} x {E2E_SECONDS} s, beam "
        f"{CONFORMER_BEAM}, {E2E_STEPS} steps (the cap), {frames} frames: "
        f"{ms:.1f} ms a batch ({[round(w * 1e3, 1) for w in walls]}), "
        f"encode {enc_s * 1e3:.2f} ms, {step_ms:.2f} ms a step, "
        f"{launches} kernel launches a batch, tokens a row "
        f"{[len(h) for h in hyps]}")
    del asr, encoder, parts, enc
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params_m=n_params / 1e6, batch_ms=ms, steps=E2E_STEPS,
                step_ms=step_ms, encode_ms=enc_s * 1e3, launches=launches,
                idle=idle)


def vad_serving(rng):
    """Phase 27 (c): ``VAD.get_speech_segments`` with the double check on
    one 60 s recording; the normalization's statistics as loaded."""
    vad, n_params = seeded_vad(SEED + 150)
    norm = vad.mods.mean_var_norm
    loaded = {n: b.clone() for n, b in norm.named_buffers()}
    wav = vad_recording(rng, VAD_SECONDS)
    vad.get_speech_segments(wav)                               # warm-up
    ops.reset_launch_counts()
    bounds, wall = _timed(lambda: vad.get_speech_segments(wav))
    _csrc_untouched("the VAD")
    for name, buf in norm.named_buffers():
        if not torch.equal(buf, loaded[name]):
            raise AssertionError(f"the VAD moved mean_var_norm.{name}")
    prob, prob_s = _timed(lambda: vad.get_speech_prob_chunk(wav))
    launches = kernel_launches(lambda: vad.get_speech_segments(wav))
    idle = profile_run(lambda: vad.get_speech_segments(wav))
    if bounds.ndim != 2 or bounds.shape[1] != 2 or not len(bounds):
        raise AssertionError(f"no speech segments: {bounds}")
    log(f"  vad-crdnn-libriparty: {n_params} parameters; "
        f"get_speech_segments with the double check on {VAD_SECONDS} s: "
        f"{wall * 1e3:.1f} ms, {len(bounds)} segments, posteriors alone "
        f"{prob_s * 1e3:.2f} ms ({tuple(prob.shape)}), {launches} kernel "
        f"launches; mean_var_norm's statistics as loaded, bit for bit")
    return dict(params=n_params, ms=wall * 1e3, segments=len(bounds),
                prob_ms=prob_s * 1e3, launches=launches, idle=idle)


def multimic_serving(rng):
    """Phase 27 (d): the beamformers and localizers on 4 mics x 4 x 10 s
    over one STFT; ms of each and gevd's share of Gev."""
    wav = torch.from_numpy(multimic_recording(rng)).cuda()
    xs = STFT(sample_rate=SR).cuda()(wav)
    full, sss, nns = multimic_covariances(xs, int(MIC_NOISE_SECONDS * 100))
    tdoas = GccPhat()(full)
    mods = {"DelaySum_Beamformer": (DelaySum_Beamformer(SR).cuda(), (wav,)),
            "Covariance": (Covariance(), (xs,)),
            "GccPhat": (GccPhat(), (full,)),
            "DelaySum": (DelaySum(), (xs, tdoas)),
            "Mvdr": (Mvdr(), (xs, nns, tdoas)),
            "Gev": (Gev(), (xs, sss, nns)),
            "SrpPhat": (SrpPhat(mics=MICS).cuda(), (full,)),
            "Music": (Music(mics=MICS).cuda(), (full,))}
    ms, outs = {}, {}
    ops.reset_launch_counts()
    with torch.no_grad():
        for name, (mod, args) in mods.items():
            mod(*args)                                         # warm-up
            walls = []
            for _ in range(3):
                outs[name], wall = _timed(lambda: mod(*args))
                walls.append(wall)
            ms[name] = float(np.median(walls)) * 1e3
        pair = (sss, decomposition.pos_def(nns))
        decomposition.gevd(*pair)
        gevd_ms = float(np.median([_timed(lambda: decomposition.gevd(
            *pair))[1] for _ in range(3)])) * 1e3
    _csrc_untouched("the multi-mic modules")
    for name, out in outs.items():
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} gave non-finite values")
    doa = torch.from_numpy(MIC_DOA).double().cuda()
    hits = {name: float((outs[name].double() @ doa).mean())
            for name in ("SrpPhat", "Music")}
    log(f"  multi-mic, {MIC_BATCH} x {MIC_SECONDS} s x 4 mics (STFT "
        f"{tuple(xs.shape)}): ms of each "
        f"{ {k: round(v, 2) for k, v in ms.items()} }; gevd {gevd_ms:.2f} "
        f"ms = {100 * gevd_ms / ms['Gev']:.1f}% of Gev; mean cosine of the "
        f"directions found to the source's {hits}")
    del wav, xs, full, sss, nns, outs
    torch.cuda.empty_cache()
    return dict(ms=ms, gevd_ms=gevd_ms, gevd_share=gevd_ms / ms["Gev"],
                doa_cosine=hits)


def diarization_serving(rng, root):
    """Phase 27 (e): ECAPA-TDNN embeddings of 1.5 s windows of a 60 s
    recording on the card, then ``Spec_Clust_unorm`` and
    ``do_spec_clustering`` on the host, writing an RTTM."""
    modules, _ = _seeded(ecapa_modules(), SEED + 160)
    encoder = EncoderClassifier(modules=modules, hparams={}, device="cuda")
    wav, turns = diarization_recording(rng)
    win, hop = int(DIAR_WINDOW * SR), int(DIAR_HOP * SR)
    starts = list(range(0, len(wav) - win + 1, hop))
    windows = np.stack([wav[s:s + win] for s in starts])
    encoder.encode_batch(windows[:8])                          # warm-up
    emb, embed_s = _timed(lambda: encoder.encode_batch(windows))
    emb = emb.reshape(len(windows), -1).cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    clust = diarization.Spec_Clust_unorm(min_num_spkrs=2, max_num_spkrs=10)
    clust.do_spec_clust(emb, k_oracle=None, p_val=0.3)
    clust_s = time.perf_counter() - t0

    class Diary:
        stat1 = emb
        segset = np.array([f"rec_{s / SR:.2f}_{(s + win) / SR:.2f}"
                           for s in starts], dtype="|O")

    rttm = os.path.join(root, "rec.rttm")
    t0 = time.perf_counter()
    labels = diarization.do_spec_clustering(Diary(), rttm, "rec", k=None,
                                            pval=0.3, affinity_type="cos")
    rttm_s = time.perf_counter() - t0
    with open(rttm) as f:
        lines = f.read().splitlines()
    if not lines or len(labels) != len(windows) or \
            not np.isfinite(emb).all():
        raise AssertionError("diarization wrote no RTTM")
    speakers = len(set(clust.labels_.tolist()))
    log(f"  diarization: {len(windows)} windows of {DIAR_WINDOW} s "
        f"embedded in {embed_s * 1e3:.1f} ms (ECAPA-TDNN, {emb.shape[1]} "
        f"wide), Spec_Clust_unorm {clust_s * 1e3:.1f} ms ({speakers} "
        f"speakers; {len(turns)} turns of 3 sources planted), "
        f"do_spec_clustering and the RTTM {rttm_s * 1e3:.1f} ms, "
        f"{len(lines)} RTTM lines")
    del encoder, modules
    torch.cuda.empty_cache()
    return dict(embed_ms=embed_s * 1e3, cluster_ms=clust_s * 1e3,
                rttm_ms=rttm_s * 1e3, speakers=speakers,
                windows=len(windows))


def ctc_logp_f64(encoder, wav, lens, device):
    """``EncoderASR.encode_batch``'s log-posteriors of a copy of the CTC
    encoder in f64 on ``device``, its frontend through the plain
    convolutions (``fused_frontend=False``: the kernel takes f32 and bf16,
    not f64). ``encode_batch`` reads neither the tokenizer nor the
    decoding function."""
    encoder = copy.deepcopy(encoder).to(device, torch.float64)
    encoder.wav2vec2.fused_frontend = False
    asr = EncoderASR(modules={"encoder": encoder}, hparams={
        "tokenizer": None, "decoding_function": None}, device=device)
    return asr.encode_batch(wav.astype(np.float64), lens.astype(np.float64))


def _rel_err(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return reading(((got - want) / want.abs()).abs().max())


# (f)'s CTC encoder: 2 lv60-width layers, dropouts 0, the eager attention
# (the kernels take f32 and bf16)
CTC_F64_ARCH = dict(num_layers=2, hidden_dropout=0.0, attention_dropout=0.0,
                    activation_dropout=0.0, feat_proj_dropout=0.0,
                    attention_impl="eager")


def interfaces_card_vs_cpu(rng, ctc_arch=CTC_F64_ARCH, conformer=None,
                           vad_arch=VAD_ARCH, crdnn=None):
    """Phase 27 (f): the card against the CPU in f64. ``conformer`` and
    ``crdnn`` (keyword arguments of ``conformer_asr_modules`` and
    ``crdnn_modules``) and the archs narrow it for the card tests."""
    errs, same = {}, {}
    enc = ctc_encoder(ctc_arch)
    _seeded({"encoder": enc}, SEED + 170)
    wav, lens = speech_rows(rng, [5.0, 3.5])
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = ctc_logp_f64(enc, wav, lens, dev)
    errs["ctc_logp"] = _peak_err(out["cuda"], out["cpu"])
    del enc, out

    encoder, _, _ = conformer_asr_modules(SEED + 171, **(conformer or {}))
    wav, lens = speech_rows(rng, [E2E_SECONDS, 3.5])
    out = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(encoder).to(dev, torch.float64).eval()
        with torch.no_grad():
            out[dev] = m(torch.from_numpy(wav).to(dev).double(),
                         lengths=torch.from_numpy(lens).to(dev).double())
    errs["conformer_states"] = _peak_err(out["cuda"], out["cpu"])
    del encoder, out

    vad_wav = vad_recording(rng, 8.0).astype(np.float64)
    out = {}
    for dev in ("cuda", "cpu"):
        vad, _ = seeded_vad(SEED + 150, arch=vad_arch, device=dev)
        for m in vars(vad.mods).values():
            m.to(torch.float64)
        out[dev] = vad.get_speech_prob_chunk(vad_wav)
    errs["vad_posteriors"] = _peak_err(out["cuda"], out["cpu"])

    wav = torch.from_numpy(multimic_recording(rng, batch=1, seconds=2.0))
    out = {}
    for dev in ("cuda", "cpu"):
        xs = STFT(sample_rate=SR).to(dev)(wav.to(dev, torch.float64))
        full, sss, nns = multimic_covariances(xs, 50)
        tdoas = GccPhat()(full)
        gev = Gev()(xs, sss, nns)
        _, ds = decomposition.gevd(sss, decomposition.pos_def(nns))
        out[dev] = {
            "DelaySum": DelaySum()(xs, tdoas),
            "Mvdr": Mvdr()(xs, nns, tdoas),
            "Gev_magnitude": torch.hypot(gev[..., 0, 0], gev[..., 1, 0]),
            "gevd_eigenvalues": ds[..., 0].diagonal(dim1=-2, dim2=-1),
            "SrpPhat": SrpPhat(mics=MICS).to(dev)(full),
            "Music": Music(mics=MICS).to(dev)(full)}
    for name, want in out["cpu"].items():
        got = out["cuda"][name]
        if name == "gevd_eigenvalues":
            errs[name] = _rel_err(got, want)
        elif name in ("SrpPhat", "Music"):
            same[name] = bool(torch.equal(got.cpu(), want))
        else:
            errs[name] = _peak_err(got, want)

    crdnn_kw = crdnn or {}
    vocab = crdnn_kw.get("vocab", CRDNN_VOCAB)
    crdnn = crdnn_modules(**crdnn_kw)
    _seeded(crdnn, SEED + 172)
    cwav, clens = speech_rows(rng, CRDNN_SECONDS[:4])
    with torch.no_grad():
        m = {k: v.cuda() for k, v in crdnn.items()}
        feats = m["normalize"](m["compute_features"](
            torch.from_numpy(cwav).cuda()), torch.from_numpy(clens).cuda(),
            train=False)
        emission = torch.log_softmax(m["ctc_lin"](m["enc"](feats)),
                                     dim=-1).double().cpu()
    phns = torch.from_numpy(rng.integers(1, vocab, (4, 12)))
    phn_lens = torch.tensor([1.0, 0.9, 0.75, 0.5], dtype=torch.float64)
    lens_t = torch.from_numpy(clens).double()
    out = {}
    for dev in ("cuda", "cpu"):
        aligner = HMMAligner()
        args = (emission.to(dev), lens_t.to(dev), phns.to(dev),
                phn_lens.to(dev))
        fwd = aligner.forward(*args, dp_algorithm="forward")
        vit, align = aligner.forward(*args, dp_algorithm="viterbi")
        out[dev] = (fwd, vit, align)
    errs["aligner_forward"] = _rel_err(out["cuda"][0], out["cpu"][0])
    errs["aligner_viterbi"] = _rel_err(out["cuda"][1], out["cpu"][1])
    same["viterbi_alignments"] = out["cuda"][2] == out["cpu"][2]
    log(f"  f64 card vs CPU: { {k: f'{v:.2e}' for k, v in errs.items()} }; "
        f"equal: {same}")
    if not within(errs, {k: TOL_F64 for k in errs}) or \
            not all(same.values()):
        raise AssertionError(f"card against CPU in f64: {errs}, {same}")
    return dict(errs=errs, same=same)


def interfaces_phase(rng):
    """Phase 27; returns (launches of rows 1 and 2 in (a), summary). TF32
    stays off, as in ``main``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_interfaces_")
    summary = {}
    try:
        log("  (a) EncoderASR over lv60 with a 1000-way CTC head, read from "
            "an export folder; transcribe_file; CTCSegmentation")
        counts, summary["encoder_asr"] = encoder_asr_serving(rng, root)
        log("  (b) EncoderDecoderASR over conformer-small-librispeech, "
            "S2STransformerBeamSearch at beam 10")
        summary["encoder_decoder_asr"] = encoder_decoder_serving(rng, root)
        log("  (c) VAD at vad-crdnn-libriparty's widths on 60 s")
        summary["vad"] = vad_serving(rng)
        log("  (d) multi-mic beamforming and localization")
        summary["multimic"] = multimic_serving(rng)
        log("  (e) the diarization back-end")
        summary["diarization"] = diarization_serving(rng, root)
        log("  (f) the card against the CPU, f64")
        summary["card_vs_cpu"] = interfaces_card_vs_cpu(rng)
    finally:
        shutil.rmtree(root)
    summary["phase_s"] = time.perf_counter() - t0
    return counts, summary


# ---------------------------------------------------------------- phase 28
BUCKET_TRAIN = 32                     # train songs of 21-30 s, whole
BUCKET_SECONDS = (21.0, 30.0)
BUCKET_VALID = (8.4, 9.6)             # valid songs (5 s utterances)
BUCKET_BATCH_SECONDS = 240.0          # 8 x 30 s, as phase 6
BUCKET_MAX_EX = 8
BUCKET_COUNT = 4
BUCKET_STEPS = 4                      # one epoch: 4 batches of 8
BUCKET_SAVE_AFTER = 2                 # the intra-epoch checkpoint


def write_wav_24(path, sig):
    """``sig`` in [-1, 1] as 24-bit PCM (``wave`` writes WAVE_FORMAT_PCM)."""
    import wave

    pcm = np.clip(np.round(sig.astype(np.float64) * 8388607.0), -8388608,
                  8388607).astype("<i4")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(SR)
        w.writeframes(pcm.view(np.uint8).reshape(-1, 4)[:, :3].tobytes())


def make_bucket_set(root, rng):
    """``BUCKET_TRAIN`` noise songs of 21-30 s as WAVs under
    ``root/bucket``: 16-bit PCM, but one 32-bit float and one 24-bit PCM
    file. Returns ({id: {"wav", "duration"}}, {file format: count})."""
    from scipy.io import wavfile

    folder = os.path.join(root, "bucket")
    os.makedirs(folder)
    data, formats = {}, {}
    durations = np.round(rng.uniform(*BUCKET_SECONDS, BUCKET_TRAIN), 2)
    for i, duration in enumerate(durations):
        path = os.path.join(folder, f"song{i:02d}.wav")
        sig = (0.1 * rng.standard_normal(int(duration * SR))).astype(
            np.float32)
        if i == 0:
            wavfile.write(path, SR, sig)           # IEEE float
            kind = "float32"
        elif i == 1:
            write_wav_24(path, sig)
            kind = "pcm24"
        else:
            write_audio(path, sig, SR)
            kind = "pcm16"
        formats[kind] = formats.get(kind, 0) + 1
        data[f"song{i:02d}"] = {"wav": path, "duration": float(duration)}
    return data, formats


def bucket_dataset(data):
    """Whole songs read by ``read_audio`` (the native reader) with labels
    made as ``train_batch`` makes them, from a generator seeded by the
    song's index, so that every run and worker draws the same ones."""
    ds = DynamicItemDataset(data)

    def labels(id, duration):
        r = np.random.default_rng(SEED + 28 + int(id[4:]))
        frames = int(round(duration * FRAME_RATE))
        return np.stack([r.random(frames) < 0.05, r.random(frames) < 0.05,
                         r.integers(0, 5, frames), r.integers(0, 13, frames)],
                        axis=-1).astype(np.float32)

    ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
    ds.add_dynamic_item(labels, takes=["id", "duration"], provides="anno")
    ds.set_output_keys(["id", "sig", "anno"])
    return ds


def bucket_brain(root, csvs, tree, data):
    """(brain, hparams, recipe sets, train loader): the recipe's brain over
    ``tree``'s weights and the recipe's checkpointer, fed whole songs
    through ``Brain.make_dataloader`` with a ``DynamicBatchSampler``, 2
    workers and ``prefetch_batches`` 4; then ``on_fit_start`` (the
    optimizers, and the newest checkpoint if there is one) and the epoch's
    start, as ``fit`` runs them."""
    brain, hp, sets = recipe_brain(root, csvs, {}, tree, "cuda",
                                   linear_prob_epochs=0)
    sampler = DynamicBatchSampler(
        None, BUCKET_BATCH_SECONDS, num_buckets=BUCKET_COUNT,
        lengths_list=[d["duration"] for d in data.values()],
        max_batch_ex=BUCKET_MAX_EX, shuffle=True, seed=SEED + 28)
    loader = brain.make_dataloader(bucket_dataset(data), Stage.TRAIN,
                                   batch_sampler=sampler, num_workers=2,
                                   prefetch_batches=4)
    brain.on_fit_start()
    brain.on_stage_start(Stage.TRAIN, 1)
    brain.train_sampler.set_epoch(1)
    return brain, hp, sets, loader


def bucket_step(brain, batch, timer, n_layers, config):
    """``fit_batch`` on ``batch`` as ``fit`` steps, timed by ``StepTimer``
    with the card synchronized, the counts set to 0 just before and read
    just after; returns (ids, loss, ms, counts, MFU against the f32
    peak)."""
    ops.reset_launch_counts()
    brain.step += 1
    with timer.measure(device="cuda"):
        loss = brain.fit_batch(batch)
    counts = ops.launch_counts()
    ms = (timer.times or [timer.first_time])[-1] * 1e3
    rows, samples = batch["sig"].data.shape
    used = flops.mfu(rows * flops.amt_train_flops(config, samples),
                     1e3 / ms, dtype="f32")
    audio_s = float(batch["sig"].lengths.sum()) * samples / SR
    log(f"  step {brain.step}: {rows} songs padded to {samples / SR:.2f} s "
        f"({audio_s:.1f} s of audio), loss={loss:.6f} {ms:.1f} ms, MFU "
        f"{100 * used:.2f}% of f32, launches="
        f"{ {k: v for k, v in counts.items() if v} }")
    if not np.isfinite(loss):
        raise AssertionError(f"nonfinite training loss {loss}")
    expect_counts(counts, {name: n_layers for name in TRAIN_KERNELS},
                  "bucketed training step")
    return list(batch.id), loss, ms, counts, used


def count_native_reads():
    """(shared count, restore): ``native.wav_read`` replaced by a wrapper
    that adds one to the count for each file it decodes. Forked loader
    workers inherit the wrapper and the shared count; a read that falls
    back to scipy, or never reaches the native reader, is not counted."""
    reads = multiprocessing.Value("i", 0)
    wav_read = native.wav_read

    def counted(*args, **kwargs):
        out = wav_read(*args, **kwargs)
        if out is not None:
            with reads.get_lock():
                reads.value += 1
        return out

    native.wav_read = counted
    return reads, lambda: setattr(native, "wav_read", wav_read)


def expect_reads(reads, want, what):
    got, reads.value = reads.value, 0
    log(f"  {what}: {got} files decoded by the native reader (want {want})")
    if got != want:
        raise AssertionError(f"{what}: {got} native reads, want {want}")


def record_attention(brain, config):
    """(calls, hook): the first layer's attention records, once a step, the
    (B, H, T, Dh) shape and the key lengths it is given."""
    calls = {}

    def record(module, args, kwargs):
        x, lens = args[0], kwargs.get("key_lengths")
        calls.setdefault(brain.step, (
            (x.shape[0], config.num_heads, x.shape[1],
             x.shape[2] // config.num_heads),
            None if lens is None else lens.detach().clone()))

    attn = brain.modules.wav2vec2.encoder.layers[0].attn
    return calls, attn.register_forward_pre_hook(record, with_kwargs=True)


def check_trace(path):
    """The profiler's trace names the ``annotate`` range and the device
    kernels of 3b, 4a and 4b."""
    with open(path) as f:
        trace = f.read()
    names = {"range fit_batch": '"fit_batch"', "3b": "flash_fwd_kernel",
             "4a": "flash_bwd_dq_kernel", "4b": "flash_bwd_dkv_kernel"}
    found = {k: v in trace for k, v in names.items()}
    log(f"  profiled step: {os.path.basename(path)} of "
        f"{len(trace) / 2 ** 20:.1f} MiB names {found}")
    if not all(found.values()):
        raise AssertionError(f"the profiler trace lacks {found}")


def bucketed_training_phase(gen, errs):
    """Phase 28: ``AudioAMT`` at lv60 full width and depth (f32, TF32 off,
    the recipe's hyperparameters, seeded weights) trained on whole songs
    read from WAV files by the native reader and batched in length buckets
    (``DynamicBatchSampler`` through ``Brain.make_dataloader``); 3b, 4a
    and 4b held against their plain versions at each step's attention
    shape and key lengths; an intra-epoch checkpoint after step 2
    recovered by a fresh brain; one step under ``profiling.profile``;
    ``evaluate`` of a valid set at batch 1. The songs come from the
    phase's own generator, so the batches' shapes do not depend on the
    phases before. Returns (launches of the phase, summary)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    if os.environ.get("SVT_NATIVE", "1") == "0":
        raise AssertionError("SVT_NATIVE=0 turns the native WAV reader off")
    if native.get_lib() is None:
        raise AssertionError("the native WAV reader did not build")
    rng = np.random.default_rng(SEED + 28)
    root = tempfile.mkdtemp(prefix="chip_smoke_bucketed_")
    reads, restore_reads = count_native_reads()
    phase_counts = dict.fromkeys(ops.launch_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            phase_counts[k] += v

    try:
        data, formats = make_bucket_set(root, rng)
        valid = make_recipe_set(root, rng, {"valid": BUCKET_VALID})["valid"]
        csvs = {"train": valid, "valid": valid, "test": valid}
        tree = init_params(Wav2Vec2Config(),
                           torch.Generator().manual_seed(SEED + 28),
                           HEAD_OUTPUTS)
        brain, hp, sets, loader = bucket_brain(root, csvs, tree, data)
        config = brain.modules.wav2vec2.config
        n_layers = config.num_layers
        total_s = sum(d["duration"] for d in data.values())
        log(f"  {len(data)} songs of {BUCKET_SECONDS[0]:.0f}-"
            f"{BUCKET_SECONDS[1]:.0f} s ({total_s:.1f} s) as WAV files "
            f"{formats}, read by the native reader; DynamicBatchSampler at "
            f"{BUCKET_BATCH_SECONDS:.0f} s and {BUCKET_MAX_EX} songs a "
            f"batch, {BUCKET_COUNT} buckets, seeded shuffle: {len(loader)} "
            f"batches; 2 loader workers, prefetch_batches 4; {n_layers} "
            f"layers, f32, dropouts 0.1")
        timer = profiling.StepTimer("bucketed step")
        calls, hook = record_attention(brain, config)
        reads.value = 0
        torch.cuda.reset_peak_memory_stats()
        steps, save_s = [], None
        t_epoch = time.perf_counter()
        frames = []
        for batch in loader:
            steps.append(bucket_step(brain, batch, timer, n_layers, config))
            samples = batch["sig"].data.shape[1]
            frames.append([config.output_length(int(round(float(rel) *
                                                          samples)))
                           for rel in batch["sig"].lengths])
            if brain.step == BUCKET_SAVE_AFTER:
                t0 = time.perf_counter()
                brain._save_intra_epoch_ckpt()
                save_s = time.perf_counter() - t0
                log(f"  intra-epoch checkpoint after step {brain.step} in "
                    f"{save_s:.2f} s; loader state {loader.state_dict()}")
        epoch_s = time.perf_counter() - t_epoch
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        hook.remove()
        for *_, counts, _ in steps:
            add(counts)
        if len(steps) != BUCKET_STEPS or save_s is None:
            raise AssertionError(f"{len(steps)} batches, want "
                                 f"{BUCKET_STEPS}")
        expect_reads(reads, sum(len(s[0]) for s in steps), "the epoch")
        # training attends the padding (``tasks/amt.py``), so the kernels
        # get no key lengths; they are held as called and, at the same
        # shapes, with the rows' true frame counts
        cases = [(shape, None if lens is None else lens.tolist())
                 for shape, lens in (calls[k] for k in sorted(calls))]
        if len(cases) != BUCKET_STEPS:
            raise AssertionError(f"the steps' attention calls: {cases}")
        log(f"  3b, 4a, 4b against their plain versions at the steps' "
            f"attention shapes {[c[0] for c in cases]} as called (key "
            f"lengths {[c[1] for c in cases]}) and with the rows' frame "
            f"counts, on random q, k, v")
        check_training_kernels(
            gen, errs, cases + [(shape, n) for (shape, _), n in
                                zip(cases, frames)], dtypes=("f32",))

        logdir = os.path.join(root, "profile")
        ops.reset_launch_counts()
        with profiling.profile(logdir):
            with profiling.annotate("fit_batch"):
                brain.fit_batch(batch)
            torch.cuda.synchronize()
        add(ops.launch_counts())
        check_trace(os.path.join(logdir, profiling.TRACE_FILE))

        saved, brain.checkpointer = brain.checkpointer, None
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        brain.evaluate(sets[1], test_loader_kwargs=hp["test_dataloader_opts"])
        eval_s = time.perf_counter() - t0
        brain.checkpointer = saved
        expect_reads(reads, len(brain.evals), "evaluate")
        add(ops.launch_counts())
        for ev in brain.evals:
            expect_counts(ev["counts"], {"conv_frontend": 7,
                                         "flash_attention_short": n_layers},
                          f"evaluation of {ev['id']}")
        log(f"  evaluate: {len(brain.evals)} utterances of "
            f"{len(BUCKET_VALID)} songs at batch 1 in {eval_s:.2f} s "
            f"({[round(e['wall'] * 1e3, 1) for e in brain.evals]} ms each)")
        del brain, loader, batch
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        fresh, _, _, loader = bucket_brain(root, csvs, tree, data)
        recover_s = time.perf_counter() - t0
        if fresh.step != BUCKET_SAVE_AFTER:
            raise AssertionError(f"recovered at step {fresh.step}, want "
                                 f"{BUCKET_SAVE_AFTER}")
        resumed = [bucket_step(fresh, batch, profiling.StepTimer(), n_layers,
                               config) for batch in loader]
        expect_reads(reads, sum(len(r[0]) for r in resumed),
                     "the recovered epoch (the consumed batches unread)")
        for *_, counts, _ in resumed:
            add(counts)
        tail = steps[BUCKET_SAVE_AFTER:]
        ids_equal = [r[0] for r in resumed] == [t[0] for t in tail]
        losses = [(r[1], t[1]) for r, t in zip(resumed, tail)]
        bitwise = len(resumed) == len(tail) and all(a == b
                                                    for a, b in losses)
        rel = max(abs(a - b) / abs(b) for a, b in losses)
        log(f"  recovered by a fresh brain in {recover_s:.2f} s: batch ids "
            f"equal {ids_equal}; losses (recovered, uninterrupted) {losses}: "
            f"bit for bit {bitwise}, max rel {rel:.3e} (tol "
            f"{TOL_STEP['loss_rel']:.0e})")
        if not ids_equal or len(resumed) != len(tail) or \
                rel > TOL_STEP["loss_rel"]:
            raise AssertionError(f"the recovered run left the uninterrupted "
                                 f"one: {resumed} against {tail}")
        del fresh, loader
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        restore_reads()
        shutil.rmtree(root)
    summary = timer.summary()
    mfus = [s[4] for s in steps]
    summary.update(
        step_ms=[round(s[2], 1) for s in steps],
        mfu_f32=[round(m, 5) for m in mfus], peak_gb=peak_gb,
        epoch_s=epoch_s, save_s=save_s, recover_s=recover_s, eval_s=eval_s,
        recovery=("bit for bit" if bitwise
                  else f"within loss_rel ({rel:.3e})"),
        formats=formats, attention=[[list(c[0]), c[1], n]
                                    for c, n in zip(cases, frames)],
        phase_s=time.perf_counter() - t_phase)
    log(f"  steps {summary['step_ms']} ms (StepTimer, card synchronized), "
        f"MFU {[f'{100 * m:.2f}%' for m in mfus]} of the f32 peak; peak "
        f"memory {peak_gb:.2f} GiB; phase {summary['phase_s']:.1f} s")
    return phase_counts, summary


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"# device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    log("phase 1: build the CUDA kernels (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    report = _build.build_all()
    log(f"  built { {n: round(sec, 1) for n, (sec, _) in sorted(report.items())} or 'nothing (cached)'} "
        f"(seconds of each nvcc, started together) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (_, text) in sorted(report.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
    check_attention_build(report)
    check_frontend_build(report)
    check_int8_build(report)
    check_lattice_build(report)

    log("phase 2: each kernel against its plain version, bf16 and f32")
    bridge, head = lv60_modules()
    extractor = bridge.encoder.feature_extractor.cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    check_frontend(extractor, gen, errs)
    check_attention("flash_attention_short", fa.flash_attention_short,
                    (8, 16, 249, 64), SHORT_LENGTHS, gen, errs)
    segment = cf.output_frames(int(SEGMENT_SECONDS * SR))
    check_attention("flash_attention_short", fa.flash_attention_short,
                    (1, 16, segment, 64), [segment], gen, errs)
    check_attention("flash_attention", fa.flash_attention,
                    (3, 16, 1499, 64), LONG_LENGTHS, gen, errs)
    check_video_kernels(gen, errs)
    check_training_kernels(gen, errs)
    check_int8(gen, errs)
    check_rnnt(gen, errs)
    extractor.cpu()
    torch.cuda.empty_cache()

    log("phase 3: lv60 AMT serving, 5 s chunks, batch 8, bf16")
    rng = np.random.default_rng(SEED)
    songs = songs_for(rng, (7, 16, 23), int16_index=1)
    tr = BatchedAMTTranscriber(bridge, head, chunk_seconds=5.0, batch_size=8,
                               compute_dtype=torch.bfloat16, device="cuda")
    tr.transcribe(songs)                     # warm-up (cuBLAS/cuDNN set-up)
    notes, wall, counts = run_path(tr, songs)
    check_frames(tr, songs)
    n_batches = len(tr._jobs(songs))
    audio_s = sum(len(w) for w in songs.values()) / SR
    log(f"  notes per song: { {k: len(v) for k, v in notes.items()} }")
    log(f"  {audio_s:.1f} s of audio in {wall * 1e3:.1f} ms wall: RTFx="
        f"{audio_s / wall:.1f}, {n_batches} batches, "
        f"{wall * 1e3 / n_batches:.2f} ms per batch")
    log(f"  launches on this path: {counts}")
    if counts["conv_frontend"] <= 0 or counts["flash_attention_short"] <= 0:
        raise AssertionError("the chunked serving path did not launch the "
                             "frontend and short-attention kernels")
    chunked_counts = counts
    log("  where the device time goes (torch.profiler, one predict_frames):")
    profile_run(lambda: tr.predict_frames(songs))
    del tr
    f32_batch_check(bridge, head, rng)

    log("phase 4: one song at chunking='song' (30 s window), batch 1, bf16")
    tr = BatchedAMTTranscriber(bridge, head, chunk_seconds=5.0, batch_size=1,
                               compute_dtype=torch.bfloat16, device="cuda",
                               chunking="song")
    song = {"whole_song": songs_for(rng, (23,))["song0_23s"]}
    tr.transcribe(song)
    notes, wall, counts = run_path(tr, song)
    check_frames(tr, song)
    log(f"  notes: {len(notes['whole_song'])}, {wall * 1e3:.1f} ms wall, "
        f"launches on this path: {counts}")
    profile_run(lambda: tr.predict_frames(song))
    if counts["flash_attention"] <= 0 or counts["conv_frontend"] <= 0:
        raise AssertionError("song mode did not launch the streaming "
                             "attention and frontend kernels")
    song_counts = counts
    del tr

    log("phase 5: timings at main-path shapes (serving kernels in bf16, "
        "training kernels in f32 and bf16, RNN-T kernels in f32)")
    rows = timings(bridge, gen)

    log("phase 8: int8 (a8w8) lv60 serving, 5 s chunks, batch 8, bf16, in "
        "turns with float serving")
    int8_counts, int8_faces, int8_summary = int8_serving_phase(
        bridge.cpu(), head.cpu(), songs, rng)
    log(f"  int8 serving summary: {json.dumps(int8_summary)}")

    log("phase 9: streaming server and dedicated streams against the offline "
        "exact decode, int8 and float; int8 song mode")
    int8_streaming_phase(int8_faces, head, songs, rng)
    del bridge, head, int8_faces
    torch.cuda.empty_cache()

    log("phase 6: AudioAMT training, lv60 full width and depth, 30 s rows")
    train_counts, summary = training_phase(rng)
    log(f"  training summary: {json.dumps(summary)}")

    log("phase 7: one f32 training step, 2 lv60-width layers, card vs CPU")
    card_vs_cpu_step(rng)
    log("  the same step at grad_accumulation_factor 2 (micro-batches of 1)")
    card_vs_cpu_step(rng, accum=2)

    log("phase 10: RNN-T training, lv60 full width and depth, 15 s rows, "
        "U = 80, V = 1000")
    rnnt_counts, rnnt_start, rnnt_summary = rnnt_training_phase(rng)
    log(f"  RNN-T training summary: {json.dumps(rnnt_summary)}")

    log("phase 11: RNN-T decoding, greedy and beam 4, on the card")
    decode_summary = rnnt_decoding_phase(rnnt_start, rng)
    log(f"  RNN-T decoding summary: {json.dumps(decode_summary)}")
    del rnnt_start

    log("phase 12: one f32 RNN-T training step, 2 lv60-width layers, card vs "
        "CPU")
    rnnt_card_vs_cpu_step(rng)

    log("phase 13: the MIR-ST500 recipe, lv60 full width and depth: fit 3 "
        "epochs (probe, 2 finetune), then evaluate from the best checkpoint")
    _, recipe_summary = recipe_phase(rng)
    log(f"  recipe summary: {json.dumps(recipe_summary)}")

    log("phase 14: the recipe at 2 lv60-width layers, one epoch and "
        "evaluate, card vs CPU")
    recipe_card_vs_cpu(rng)

    root = tempfile.mkdtemp(prefix="chip_smoke_n20em_")
    try:
        log("phase 15: the N20EMv2 audio recipe, lv60 full width and depth: "
            "probe and finetune epochs with mix_train, evaluate, feature "
            "dumps clean and at accomp -10, 0, +10 dB")
        n20em_counts, n20em_summary, exported = n20em_phase(root, rng)
        log(f"  N20EMv2 summary: {json.dumps(n20em_summary)}")
        log("phase 19: deployment: SingingTranscriber.from_hparams on an "
            "inference yaml beside phase 15's export, bf16 and int8, "
            "transcribe_file against the in-memory modules; a JAX export "
            "through the port's msgpack decoder")
        deploy_summary = deploy_phase(root, exported)
        log(f"  deployment summary: {json.dumps(deploy_summary)}")
        del exported
        torch.cuda.empty_cache()
        log("phase 17: the N20EMv2 video recipe, AV-HuBERT large at full "
            "width and depth: probe and finetune epochs, evaluate, video "
            "feature dumps of every split")
        video_counts, (vbrain, vhp, vtest), video_summary = video_phase(
            root, rng)
        log(f"  video summary: {json.dumps(video_summary)}")
        log("phase 18: the ResEncoder and 2 AV-HuBERT-width layers, one f32 "
            "step card vs CPU; int8 AV-HuBERT large serving, FFN only and "
            "with quantize_attn")
        ops.reset_launch_counts()
        step_summary = video_card_vs_cpu_step(root, rng)
        int8_video = int8_video_serving(vbrain, vhp, vtest)
        log(f"  phase 18 summary: {json.dumps(dict(step=step_summary, int8=int8_video))}")
        del vbrain, vhp, vtest
        torch.cuda.empty_cache()
        log("phase 16: RCA fusion at the published width on phase 15's "
            "audio and phase 17's video dumps: AV and A recipes, the noise "
            "sweep, int8 serving, card vs CPU")
        fusion_counts, fusion_summary = fusion_phase(root, rng)
        log(f"  fusion summary: {json.dumps(fusion_summary)}")
        log("phase 20: the SSL families at full width: wav2vec2-base, "
            "data2vec-audio-large and WavLM-large served by name, 2 layers "
            "of each and AV-HuBERT base card vs CPU, data2vec remat steps, "
            "WavLM-large with remat, int8 wav2vec2-base, the recipe with "
            "--ssl_model=wav2vec2-base")
        families_summary = families_phase(rng)
        log(f"  phase 20 summary: {json.dumps(families_summary)}")
    finally:
        shutil.rmtree(root)

    log("phase 21: AV-HuBERT seq2seq ASR at full width (AV-HuBERT large + "
        "the 6 x 1024 decoder, V 1000) from the manifest's key schema: "
        "encode, the fast, host and device decode routes, beam 5; 2 + 2 "
        "layers card vs CPU")
    asr_summary = asr_phase(rng)
    log(f"  phase 21 summary: {json.dumps(asr_summary)}")

    log("phase 22: the CRDNN ASR path (crdnn-ligru-timit): Fbank, global "
        "input normalization, CRDNN with 4 bidirectional LiGRU layers, CTC "
        "head and location-aware GRU decoder, f32, batch 8 of 4.5-2.0 s: "
        "eval forward, Adam steps, 2 LiGRU layers card vs CPU")
    crdnn_summary = crdnn_phase(rng)
    log(f"  phase 22 summary: {json.dumps(crdnn_summary)}")

    log("phase 23: the conformer ASR path (conformer-small-librispeech): "
        "Fbank 80, global input normalization, the convolutional frontend, "
        "a conformer TransformerASR (12 + 4 layers, d_model 144), CTC and "
        "sequence heads over 5000 tokens, f32, batch 8 of 14.0-7.0 s, speed "
        "perturbation and SpecAugment in training, EnvCorrupt once: eval, "
        "Adam steps, beam search; 2 + 1 layers card vs CPU")
    conformer_summary = conformer_phase(rng)
    log(f"  phase 23 summary: {json.dumps(conformer_summary)}")

    log("phase 24: source separation (sepformer-wsj0-2mix): TasNet encoder "
        "and decoder of 256 channels, a dual-path masknet of 2 blocks of "
        "8 + 8 pre-LN transformer layers at width 256, K 250, 2 speakers, "
        "8 kHz, f32: SepformerSeparation on 4 x 4 s, Adam steps on 1 x 4 s; "
        "1 block of 2 + 2 layers card vs CPU")
    sep_summary = sepformer_phase(rng)
    log(f"  phase 24 summary: {json.dumps(sep_summary)}")

    log("phase 25: speaker verification (ecapa-tdnn-voxceleb: Fbank 80, "
        "ECAPA-TDNN at 1024 channels, a 7205-way AAM head; Adam steps on 32 "
        "x 3 s, verify_batch, classify_batch), enhancement "
        "(metricgan-plus-voicebank: enhance_batch on 4 x 4 s) and the rest "
        "of the slice card vs CPU")
    spk_summary = speaker_enhancement_phase(rng)
    log(f"  phase 25 summary: {json.dumps(spk_summary)}")

    log("phase 26: SSL pretraining at full width: wav2vec2-large-lv60 "
        "(batch 4 x 25 s, then a 20 s crop), the same step under DDP and "
        "FSDP2 on a one-rank NCCL group, a DCP checkpoint, AV-HuBERT large "
        "(batch 2 x 6 s); f64 steps card vs CPU")
    pretrain_counts, pretrain_summary = pretrain_phase(rng)
    log(f"  phase 26 summary: {json.dumps(pretrain_summary)}")

    log("phase 27: the serving interfaces and back-ends: EncoderASR over "
        "lv60 with a CTC head (batch 8 x 5 s, from an export folder) and "
        "CTCSegmentation, EncoderDecoderASR over conformer-small "
        "(beam 10), VAD (vad-crdnn-libriparty), multi-mic beamforming and "
        "localization, the diarization back-end; f64 card vs CPU")
    interface_counts, interface_summary = interfaces_phase(rng)
    log(f"  phase 27 summary: {json.dumps(interface_summary)}")

    log("phase 28: bucketed training from WAV files: AudioAMT at lv60 full "
        "width and depth, f32, whole songs of 21-30 s read by the native "
        "reader, DynamicBatchSampler through Brain.make_dataloader (2 "
        "workers, prefetch_batches 4), a mid-epoch recovery, a profiled "
        "step, evaluate at batch 1")
    bucket_counts, bucket_summary = bucketed_training_phase(gen, errs)
    log(f"  phase 28 summary: {json.dumps(bucket_summary)}")

    kernels = []
    for key, r in rows.items():
        if not isinstance(key, tuple) and key not in SOURCES:
            continue                        # the int8 kernel's other shapes
        if isinstance(key, tuple):          # training kernels: f32 rows
            name, tag = key
            if tag != "f32":
                continue
            launches = (train_counts[name] + pretrain_counts[name]
                        + bucket_counts[name])
        else:
            name = key
            tag = "f32" if name.startswith("rnnt_") else "bf16"
            launches = {"flash_attention": song_counts,
                        "int8_matmul": int8_counts,
                        "rnnt_lattice": rnnt_counts,
                        "rnnt_grad": rnnt_counts}.get(
                            name, chunked_counts)[name]
            if name == "conv_frontend":
                launches += pretrain_counts[name]
            launches += interface_counts.get(name, 0)
            launches += bucket_counts.get(name, 0)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": errs[(name, tag)], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("device_ms",) if k in r}})
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
