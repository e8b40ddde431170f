"""Pretrained inference interfaces (port of
``svt_speechbrain_tpu/pretrained/interfaces.py``): the ``Pretrained`` base
and ``SingingTranscriber``, the AMT flagship interface over the batched
chunked pipeline, its streaming session and its multiplexed server.

The modules of the port own their parameters, so an interface holds
modules only: ``init_params(seed)`` fills them with seeded draws, and
``convert_jax.load_jax_params`` or ``models.convert_hf.load_wav2vec2``
installs trained ones. ``from_hparams`` builds an interface from an
inference ``hyperparams.yaml`` (read by ``config``'s own reader) and the
files its ``pretrainer`` names (``torch.save`` state dicts or JAX msgpack
exports, fetched from a local directory).

``EncoderClassifier``, ``SpeakerRecognition``, ``SepformerSeparation`` and
``SpectralMaskEnhancement`` serve the speaker, separation and enhancement
models: each runs its modules (and the hparams' feature modules) on its
``device``, CUDA unless the caller names another, in eval and without
autograd, and keeps the JAX interface's host reads (the numpy score and
argmax of ``classify_batch``, the cosine of ``verify_batch``).

``EncoderASR`` (CTC), ``EncoderDecoderASR`` (an encoder and a searcher)
and ``VAD`` serve the speech recognizers and the voice activity detector
the same way. ``VAD`` normalizes its features with the stored statistics
of its ``mean_var_norm`` and leaves them as they were (the JAX ``VAD``
updates them at every call, ROADMAP.md queue 3); its thresholds and
boundaries are computed on the host from posteriors read once a call.
"""
from __future__ import annotations

import functools
import logging
import os
import pathlib
from types import SimpleNamespace

import numpy as np
import torch

from svt_speechbrain_tpu_torch import resolve_device
from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import init_modules
from svt_speechbrain_tpu_torch.dataio.dataio import read_audio, write_audio
from svt_speechbrain_tpu_torch.decoders.seq2seq import S2SBaseSearcher
from svt_speechbrain_tpu_torch.inference import (BatchedAMTTranscriber,
                                                 StreamingAMTTranscriber,
                                                 StreamingServer)
from svt_speechbrain_tpu_torch.models.quantize import quantize_wav2vec2
from svt_speechbrain_tpu_torch.models.separation import separate
from svt_speechbrain_tpu_torch.pretrained.fetching import fetch
from svt_speechbrain_tpu_torch.processing.features import InputNormalization

logger = logging.getLogger(__name__)


class Pretrained:
    """Base inference interface (``interfaces.py:20``). Subclasses declare
    ``HPARAMS_NEEDED``/``MODULES_NEEDED``; the hparams dict is exposed as a
    namespace, as in the Brain.

    Example
    -------
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> pt = Pretrained(modules={"head": Linear(4, 8)}, hparams={"foo": 1})
    >>> mods = pt.init_params()
    >>> sorted(vars(mods)), tuple(mods.head.w.shape), pt.hparams.foo
    (['head'], (8, 4), 1)
    >>> bool(mods.head.w.abs().sum() > 0)
    True
    """

    HPARAMS_NEEDED = []
    MODULES_NEEDED = []

    def __init__(self, modules=None, hparams=None):
        self.mods = SimpleNamespace(**(modules or {}))
        self.hparams = SimpleNamespace(**(hparams or {}))
        for name in self.HPARAMS_NEEDED:
            if not hasattr(self.hparams, name):
                raise ValueError(f"Need hparams['{name}']")
        for name in self.MODULES_NEEDED:
            if not hasattr(self.mods, name):
                raise ValueError(f"Need modules['{name}']")

    def init_params(self, seed=1234):
        """Fill every module with seeded random parameters (one
        ``torch.Generator``, modules in their given order); returns the
        modules' namespace."""
        init_modules(vars(self.mods), seed)
        return self.mods

    @classmethod
    def from_hparams(cls, source, hparams_file="hyperparams.yaml",
                     savedir=None, overrides=None, **kwargs):
        """An interface from ``source`` (a local directory;
        ``interfaces.py:64``): its ``hparams_file`` (with ``overrides``)
        builds the modules on the CPU, ``init_params`` fills them, the
        yaml's ``pretrainer`` collects its files into ``savedir`` (as
        SpeechBrain's ``from_hparams`` does; a file named without a
        directory is one of ``source``) and loads them, and the modules
        move to the interface's ``device`` where it has one. ``kwargs`` go
        to the interface (``device``, ``batch_size``, ``quantize``, ...). A
        URL or hub id raises: nothing is downloaded."""
        savedir = savedir or \
            f"./pretrained_models/{str(source).replace('/', '--')}"
        path = fetch(hparams_file, source, savedir)
        with open(path) as f:
            hparams = load_hyperyaml(f, overrides)
        instance = cls(modules=hparams.get("modules", {}), hparams=hparams,
                       **kwargs)
        instance.init_params()
        pretrainer = hparams.get("pretrainer")
        if pretrainer is not None:
            pretrainer.collect_in = pathlib.Path(savedir)
            pretrainer.collect_files(default_source=source)
            pretrainer.load_collected()
        device = getattr(instance, "device", None)
        for module in vars(instance.mods).values():
            if device is not None and isinstance(module, torch.nn.Module):
                module.to(device)
        logger.info(f"{cls.__name__} loaded from {source}")
        return instance


class SingingTranscriber(Pretrained):
    """Whole-song AMT inference (the flagship deployment path): waveforms →
    note events, batched and chunked on the device (``interfaces.py:85``).

    Needs modules ``wav2vec2`` and ``model`` and the AMT decode hparams.
    ``chunking`` is "ceil" (throughput), "reference" (equal to the recipes'
    batch-1 eval) or "song" (whole-song attention windows; use a small
    ``batch_size``). ``quantize="int8"`` serves the encoder's FFN and
    feature-projection products in a8w8 (``models/quantize.py``); the float
    path is the default. ``device`` is CUDA unless the caller names another;
    ``compute_dtype`` (bf16 by default) is the serving copies' dtype.

    Example
    -------
    >>> import numpy as np
    >>> from svt_speechbrain_tpu_torch.flagship import build_modules
    >>> bridge, head = build_modules(tiny=True)
    >>> hp = {"frame_rate": 49.8, "onset_threshold": 0.4,
    ...       "offset_threshold": 0.5}
    >>> iface = SingingTranscriber(modules={"wav2vec2": bridge, "model": head},
    ...                            hparams=hp, batch_size=2, chunk_seconds=1.0,
    ...                            quantize="int8", device="cpu")
    >>> _ = iface.init_params()
    >>> notes = iface.transcribe_batch({"s": np.zeros(24000, np.float32)})
    >>> sorted(notes), all(len(ev) == 3 for ev in notes["s"])
    (['s'], True)
    """

    HPARAMS_NEEDED = ["frame_rate", "onset_threshold", "offset_threshold"]
    MODULES_NEEDED = ["wav2vec2", "model"]

    def __init__(self, *args, batch_size=32, chunk_seconds=5.0,
                 chunking="ceil", quantize=None, device=None,
                 compute_dtype=torch.bfloat16, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch_size = batch_size
        self.chunk_seconds = chunk_seconds
        self.chunking = chunking
        if quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode: {quantize!r}")
        self.quantize = quantize
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self._transcriber = None
        self._int8_w2v = None

    def _serving_bridge(self):
        """The bridge a new transcriber, stream or server is made from: the
        float one, or with ``quantize="int8"`` one int8 copy shared by all
        of them. Both are in full precision (the int8 copy is derived from
        the float weights, never from a bf16 cast), so a later
        ``compute_dtype`` acts on untruncated weights and scales; every
        transcriber casts its own copy."""
        if self.quantize != "int8":
            return self.mods.wav2vec2
        if self._int8_w2v is None:
            self._int8_w2v = quantize_wav2vec2(self.mods.wav2vec2)
        return self._int8_w2v

    def _decode_args(self):
        return dict(chunk_seconds=self.chunk_seconds,
                    frame_rate=self.hparams.frame_rate,
                    onset_threshold=self.hparams.onset_threshold,
                    offset_threshold=self.hparams.offset_threshold,
                    compute_dtype=self.compute_dtype, device=self.device)

    def _get_transcriber(self):
        if self._transcriber is None:
            self._transcriber = BatchedAMTTranscriber(
                self._serving_bridge(), self.mods.model,
                batch_size=self.batch_size, chunking=self.chunking,
                **self._decode_args())
        return self._transcriber

    def transcribe_file(self, path):
        """Audio file → [[onset_s, offset_s, midi], ...]
        (``interfaces.py:142``): the file read by ``dataio.read_audio``,
        transcribed as a batch of one song named by its basename."""
        name = os.path.basename(path)
        return self.transcribe_batch({name: read_audio(path)})[name]

    def transcribe_batch(self, songs):
        """dict name → waveform ⇒ dict name → note events."""
        return self._get_transcriber().transcribe(songs)

    def stream(self, **kwargs):
        """Open a low-latency streaming session on this interface's model
        and ``quantize`` mode (``inference.StreamingAMTTranscriber``):
        ``feed()`` PCM as it arrives, ``flush()`` at the end. Each call
        returns an independent session; extra keyword arguments
        (``compact``, ``compute_dtype``, ...) pass through."""
        return StreamingAMTTranscriber(
            self._serving_bridge(), self.mods.model,
            **{**self._decode_args(), **kwargs})

    def serve(self, batch_size=8, **kwargs):
        """Open a multiplexed streaming server on this interface's model
        and ``quantize`` mode (``inference.StreamingServer``): the ready
        windows of N concurrent ``server.open()`` sessions share one batch
        program."""
        return StreamingServer(
            self._serving_bridge(), self.mods.model, batch_size=batch_size,
            **{**self._decode_args(), **kwargs})


def _to_device(objects, device):
    """Move every ``nn.Module`` of ``objects`` (and those bound in a
    ``functools.partial``'s arguments) to ``device``, in eval mode."""
    for obj in objects:
        if isinstance(obj, torch.nn.Module):
            obj.to(device).eval()
        elif isinstance(obj, functools.partial):
            _to_device(list(obj.args) + list(obj.keywords.values()), device)


class _DeviceInterface(Pretrained):
    """An interface whose modules run on its ``device`` (CUDA unless the
    caller names another), in eval mode, as the reference's ``Pretrained``
    puts them."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        _to_device(list(vars(self.mods).values())
                   + list(vars(self.hparams).values()), self.device)

    def _tensor(self, x):
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x)
        return None if x is None else torch.as_tensor(x, device=self.device)

    def _wavs_and_lens(self, wavs, wav_lens):
        """The waveforms on the device, and their relative lengths there
        (ones when None)."""
        wavs = self._tensor(wavs)
        if wav_lens is None:
            return wavs, torch.ones(wavs.shape[0], device=self.device)
        return wavs, self._tensor(wav_lens)


def _words(tokenizer, hyps):
    """Each hypothesis's token ids decoded to text by ``decode_ids``
    (a SentencePiece processor) or ``decode``."""
    decode = getattr(tokenizer, "decode_ids", None) or tokenizer.decode
    return [decode(list(map(int, h))) for h in hyps]


class EncoderDecoderASR(_DeviceInterface):
    """Encoder + autoregressive-decoder ASR (``interfaces.py:208``): the
    ``encoder`` module (features, normalization and the acoustic encoder,
    called with the relative lengths as ``lengths``), then a searcher as
    ``decoder`` (``S2STransformerBeamSearch`` and the other searchers of
    ``decoders.seq2seq``, whose modules the interface moves to its device
    through the searcher's ``to``); the token ids are decoded to words by
    ``hparams['tokenizer']``.

    Example
    -------
    >>> import torch
    >>> class Enc(torch.nn.Module):
    ...     def forward(self, x, lengths=None):
    ...         return x[..., None]
    >>> class Tok:
    ...     def decode_ids(self, ids):
    ...         return " ".join(chr(ord("a") + i) for i in ids)
    >>> def search(enc_states, enc_lens):
    ...     return [[0, 1, 2]], [0.0]
    >>> asr = EncoderDecoderASR(modules={"encoder": Enc(), "decoder": search},
    ...                         hparams={"tokenizer": Tok()}, device="cpu")
    >>> asr.transcribe_batch(torch.zeros(1, 100))
    (['a b c'], [[0, 1, 2]])
    """

    HPARAMS_NEEDED = ["tokenizer"]
    MODULES_NEEDED = ["encoder", "decoder"]

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if isinstance(self.mods.decoder, S2SBaseSearcher):
            self.mods.decoder.to(self.device)

    def encode_batch(self, wavs, wav_lens=None):
        """(B, T) waveforms → the encoder's states, on the device."""
        wavs, wav_lens = self._wavs_and_lens(wavs, wav_lens)
        with torch.no_grad():
            return self.mods.encoder(wavs, lengths=wav_lens)

    def transcribe_batch(self, wavs, wav_lens=None):
        """Waveforms → (the words of each row, its token ids)."""
        wavs, wav_lens = self._wavs_and_lens(wavs, wav_lens)
        enc = self.encode_batch(wavs, wav_lens)
        hyps, _scores = self.mods.decoder(enc, wav_lens)
        return _words(self.hparams.tokenizer, hyps), hyps

    def transcribe_file(self, path):
        """The words of one audio file, read by ``dataio``."""
        words, _ = self.transcribe_batch(np.asarray(read_audio(path))[None])
        return words[0]


class EncoderASR(_DeviceInterface):
    """Encoder-only (CTC) ASR (``interfaces.py:246``): the ``encoder``
    gives per-frame log-posteriors of the waveforms (called with their
    relative lengths as ``lengths``), ``hparams['decoding_function']``
    (``decoders.ctc_greedy_decode`` with its blank, say) maps them and the
    lengths to token sequences, and ``hparams['tokenizer']`` to words.

    Example
    -------
    >>> import functools, torch
    >>> from svt_speechbrain_tpu_torch.decoders.ctc import ctc_greedy_decode
    >>> post = torch.full((1, 4, 4), -10.0)
    >>> post[0, [0, 1, 2, 3], [1, 1, 3, 2]] = 0.0   # 1 1 blank 2
    >>> class Enc(torch.nn.Module):
    ...     def forward(self, x, lengths=None):
    ...         return post
    >>> class Tok:
    ...     def decode_ids(self, ids):
    ...         return " ".join(chr(ord("a") + i) for i in ids)
    >>> asr = EncoderASR(modules={"encoder": Enc()}, hparams={
    ...     "tokenizer": Tok(), "decoding_function": functools.partial(
    ...         ctc_greedy_decode, blank_id=3)}, device="cpu")
    >>> asr.transcribe_batch(torch.zeros(1, 100))
    (['b c'], [[1, 2]])
    """

    HPARAMS_NEEDED = ["tokenizer", "decoding_function"]
    MODULES_NEEDED = ["encoder"]

    def encode_batch(self, wavs, wav_lens=None):
        """(B, T) waveforms → the encoder's (B, frames, V) log-posteriors,
        on the device."""
        wavs, wav_lens = self._wavs_and_lens(wavs, wav_lens)
        with torch.no_grad():
            return self.mods.encoder(wavs, lengths=wav_lens)

    def transcribe_batch(self, wavs, wav_lens=None):
        """Waveforms → (the words of each row, its token ids)."""
        wavs, wav_lens = self._wavs_and_lens(wavs, wav_lens)
        enc = self.encode_batch(wavs, wav_lens)
        hyps = self.hparams.decoding_function(enc, wav_lens)
        return _words(self.hparams.tokenizer, hyps), hyps

    def transcribe_file(self, path):
        """The words of one audio file, read by ``dataio``."""
        words, _ = self.transcribe_batch(np.asarray(read_audio(path))[None])
        return words[0]


class VAD(_DeviceInterface):
    """Voice activity detection (``interfaces.py:303``): features → the
    ``mean_var_norm`` normalization with its stored statistics (an
    ``InputNormalization`` is called with ``train=False`` and keeps them)
    → the frame classifier ``model`` → sigmoid speech posteriors, on the
    device; the hysteresis, boundaries and segment rules run on the host
    in numpy. Long audio is passed whole, as in the JAX interface.

    Example
    -------
    >>> import numpy as np, torch
    >>> from svt_speechbrain_tpu_torch.models.features import Fbank
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> vad = VAD(modules={"compute_features": Fbank(n_mels=8),
    ...                    "mean_var_norm": InputNormalization(),
    ...                    "model": Linear(1, 8)},
    ...           hparams={"sample_rate": 16000, "time_resolution": 0.01},
    ...           device="cpu")
    >>> _ = vad.init_params()
    >>> vad.get_speech_prob_chunk(np.zeros((1, 16000), np.float32)).shape
    torch.Size([1, 101, 1])
    >>> p = np.array([[[0.3], [0.6], [0.3], [0.2], [0.3]]])
    >>> vad.apply_threshold(p)[0, :, 0].tolist()
    [0.0, 1.0, 1.0, 0.0, 0.0]
    >>> vad.get_boundaries(np.array([[0., 1., 1., 0., 1.]]))
    array([[0.01, 0.03],
           [0.04, 0.05]])
    """

    HPARAMS_NEEDED = ["sample_rate", "time_resolution"]
    MODULES_NEEDED = ["compute_features", "mean_var_norm", "model"]

    def get_speech_prob_chunk(self, wavs, wav_lens=None):
        """(B, T) waveforms → (B, frames, 1) speech posteriors, on the
        device."""
        wavs, wav_lens = self._wavs_and_lens(wavs, wav_lens)
        norm = self.mods.mean_var_norm
        with torch.no_grad():
            feats = self.mods.compute_features(wavs)
            if isinstance(norm, InputNormalization):
                feats = norm(feats, wav_lens, train=False)
            else:
                feats = norm(feats, wav_lens)
            out = self.mods.model(feats)
            if isinstance(out, tuple):
                out = out[0]
            return torch.sigmoid(out)

    @staticmethod
    def _host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)

    def apply_threshold(self, vad_prob, activation_th=0.5,
                        deactivation_th=0.25):
        """Double-threshold hysteresis (``interfaces.py:337``): switch on
        above ``activation_th``, off below ``deactivation_th``."""
        p = self._host(vad_prob)
        out = np.zeros_like(p)
        for b in range(p.shape[0]):
            active = False
            for t in range(p.shape[1]):
                v = p[b, t, 0] if p.ndim == 3 else p[b, t]
                if active:
                    active = v > deactivation_th
                else:
                    active = v > activation_th
                if p.ndim == 3:
                    out[b, t, 0] = float(active)
                else:
                    out[b, t] = float(active)
        return out

    def get_boundaries(self, prob_th, output_value="seconds"):
        """Binary frame decisions of the first row → (N, 2) [start, end]
        boundaries in seconds (or frames) at ``time_resolution``
        (``interfaces.py:356``)."""
        p = self._host(prob_th)
        if p.ndim == 3:
            p = p[0, :, 0]
        elif p.ndim == 2:
            p = p[0]
        diff = np.diff(np.concatenate([[0.0], p, [0.0]]))
        starts = np.nonzero(diff == 1)[0]
        ends = np.nonzero(diff == -1)[0]
        bounds = np.stack([starts, ends], axis=-1).astype(np.float64)
        if output_value == "seconds":
            bounds = bounds * float(self.hparams.time_resolution)
        return bounds

    def energy_VAD(self, wavs, activation_th=0.5, deactivation_th=0.0,
                   eps=1e-6):
        """Energy-based decisions (``interfaces.py:374``): per-chunk log
        energies min-max normalized, then double-thresholded."""
        wavs = self._host(wavs)
        chunk = int(self.hparams.sample_rate * self.hparams.time_resolution)
        n = wavs.shape[1] // chunk
        frames = wavs[:, :n * chunk].reshape(wavs.shape[0], n, chunk)
        energy = np.log(np.mean(frames.astype(np.float64) ** 2, axis=-1)
                        + eps)
        emin = energy.min(-1, keepdims=True)
        emax = energy.max(-1, keepdims=True)
        norm = (energy - emin) / np.maximum(emax - emin, eps)
        return self.apply_threshold(norm[..., None], activation_th,
                                    deactivation_th)

    @staticmethod
    def merge_close_segments(boundaries, close_th=0.25):
        """Merge segments separated by less than ``close_th`` seconds."""
        if len(boundaries) == 0:
            return boundaries
        merged = [list(boundaries[0])]
        for seg in boundaries[1:]:
            if seg[0] - merged[-1][1] < close_th:
                merged[-1][1] = seg[1]
            else:
                merged.append(list(seg))
        return np.asarray(merged)

    @staticmethod
    def remove_short_segments(boundaries, len_th=0.25):
        """Drop segments shorter than ``len_th`` seconds."""
        boundaries = np.asarray(boundaries)
        if len(boundaries) == 0:
            return boundaries
        return boundaries[(boundaries[:, 1] - boundaries[:, 0]) >= len_th]

    def double_check_speech_segments(self, boundaries, wavs, speech_th=0.5):
        """Re-score each candidate segment with the model and keep those
        whose mean posterior exceeds ``speech_th`` (``interfaces.py:408``;
        one host read a segment)."""
        sr = self.hparams.sample_rate
        keep = []
        for seg in np.asarray(boundaries):
            lo, hi = int(seg[0] * sr), int(seg[1] * sr)
            if hi - lo < int(sr * self.hparams.time_resolution):
                continue
            prob = self.get_speech_prob_chunk(wavs[:, lo:hi])
            if float(prob.mean()) > speech_th:
                keep.append(seg)
        return np.asarray(keep) if keep else np.zeros((0, 2))

    def get_speech_segments(self, wavs, activation_th=0.5,
                            deactivation_th=0.25, close_th=0.25, len_th=0.25,
                            double_check=True, speech_th=0.5):
        """Posteriors (read to the host once) → hysteresis → boundaries →
        merge and minimum length → the optional double check
        (``interfaces.py:425``)."""
        wavs = self._tensor(wavs)
        prob = self._host(self.get_speech_prob_chunk(wavs))
        prob_th = self.apply_threshold(prob, activation_th, deactivation_th)
        bounds = self.get_boundaries(prob_th)
        bounds = self.merge_close_segments(bounds, close_th)
        bounds = self.remove_short_segments(bounds, len_th)
        if double_check and len(bounds):
            bounds = self.double_check_speech_segments(bounds, wavs,
                                                       speech_th)
        return bounds


class EncoderClassifier(_DeviceInterface):
    """Features → embedding → classifier (``interfaces.py:189``).
    ``encode_batch`` hands the relative ``wav_lens`` to the embedding
    model as they are; ``classify_batch`` returns (logits on the device,
    the numpy max score and argmax index of each row).

    Example
    -------
    >>> import numpy as np
    >>> from svt_speechbrain_tpu_torch.models.ecapa_tdnn import (
    ...     ECAPA_TDNN, Classifier)
    >>> from svt_speechbrain_tpu_torch.models.features import Fbank
    >>> clf = EncoderClassifier(modules={
    ...     "compute_features": Fbank(n_mels=24),
    ...     "embedding_model": ECAPA_TDNN(24, lin_neurons=16,
    ...         channels=(16, 16, 16, 16, 48), attention_channels=8,
    ...         res2net_scale=4, se_channels=8),
    ...     "classifier": Classifier(16, 16, 5)}, device="cpu")
    >>> _ = clf.init_params()
    >>> out, score, index = clf.classify_batch(np.zeros((2, 4000), np.float32))
    >>> tuple(out.shape), index.shape
    ((2, 1, 5), (2, 1))
    """

    MODULES_NEEDED = ["compute_features", "embedding_model", "classifier"]

    def encode_batch(self, wavs, wav_lens=None):
        with torch.no_grad():
            feats = self.mods.compute_features(self._tensor(wavs))
            return self.mods.embedding_model(feats,
                                             lengths=self._tensor(wav_lens))

    def classify_batch(self, wavs, wav_lens=None):
        emb = self.encode_batch(wavs, wav_lens)
        with torch.no_grad():
            out = self.mods.classifier(emb)
        host = out.cpu().numpy()
        return out, host.max(-1), host.argmax(-1)


class SpeakerRecognition(EncoderClassifier):
    """Speaker verification by the cosine of two embeddings
    (``interfaces.py:275``), computed on the host in numpy."""

    MODULES_NEEDED = ["compute_features", "embedding_model"]

    def verify_batch(self, wavs1, wavs2, wav_lens1=None, wav_lens2=None,
                     threshold=0.25):
        """(cosine scores, same-speaker decisions) of each row pair."""
        emb1 = self.encode_batch(wavs1, wav_lens1).cpu().numpy().reshape(
            len(wavs1), -1)
        emb2 = self.encode_batch(wavs2, wav_lens2).cpu().numpy().reshape(
            len(wavs2), -1)
        num = np.sum(emb1 * emb2, axis=-1)
        den = (np.linalg.norm(emb1, axis=-1) * np.linalg.norm(emb2, axis=-1)
               + 1e-12)
        score = num / den
        return score, score > threshold

    def verify_files(self, path_x, path_y, threshold=0.25):
        """(score, decision) of two audio files, read by ``dataio``."""
        x = np.asarray(read_audio(path_x))[None]
        y = np.asarray(read_audio(path_y))[None]
        score, decision = self.verify_batch(x, y, threshold=threshold)
        return float(score[0]), bool(decision[0])


class SepformerSeparation(_DeviceInterface):
    """Source separation (``interfaces.py:440``): encoder → mask network →
    a masked decode a source; the (B, T, sources) estimate is cut or
    zero-padded to the mixture's length. Any separator with the
    encoder/masknet/decoder split serves (SepFormer, Conv-TasNet's
    ``MaskNet``)."""

    MODULES_NEEDED = ["encoder", "masknet", "decoder"]

    def separate_batch(self, mix):
        with torch.no_grad():
            return separate(self.mods.encoder, self.mods.masknet,
                            self.mods.decoder, self._tensor(mix))

    def separate_file(self, path):
        """The separated sources of one audio file, read by ``dataio``."""
        return self.separate_batch(np.asarray(read_audio(path))[None])


class SpectralMaskEnhancement(_DeviceInterface):
    """Spectral-mask enhancement (``interfaces.py:472``): log1p magnitudes
    → the mask model → masked features → resynthesis with the noisy phase
    (the hparams' ``compute_stft``, ``spectral_magnitude`` and ``resynth``,
    moved to the device with the modules)."""

    HPARAMS_NEEDED = ["compute_stft", "spectral_magnitude", "resynth"]
    MODULES_NEEDED = ["enhance_model"]

    def compute_features(self, wavs):
        """log1p of the spectral magnitude of ``wavs``."""
        stft = self.hparams.compute_stft(self._tensor(wavs))
        return torch.log1p(self.hparams.spectral_magnitude(stft))

    def enhance_batch(self, noisy, lengths=None):
        noisy = self._tensor(noisy)
        with torch.no_grad():
            feats = self.compute_features(noisy)
            out = self.mods.enhance_model(feats,
                                          lengths=self._tensor(lengths))
            mask = out[0] if isinstance(out, tuple) else out
            return self.hparams.resynth(torch.expm1(mask * feats), noisy)

    def enhance_file(self, path, output_path=None):
        """Enhance one audio file read by ``dataio``; with ``output_path``
        also write it (at ``hparams.sample_rate``, 16 kHz without one)."""
        enhanced = self.enhance_batch(np.asarray(read_audio(path))[None])
        if output_path is not None:
            write_audio(output_path, enhanced[0].cpu().numpy(),
                        getattr(self.hparams, "sample_rate", 16000))
        return enhanced
