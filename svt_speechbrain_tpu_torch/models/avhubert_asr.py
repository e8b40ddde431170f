"""AV-HuBERT seq2seq ASR: checkpoint → encode → beam decode (port of
``svt_speechbrain_tpu/models/avhubert_asr.py``).

One module holds the fine-tuned AV-HuBERT encoder (``AVHubertModel``, whose
``extract_finetune`` runs the short-attention kernel once a layer on the
card) and the fairseq decoder (``FairseqTransformerDecoder``), and
decodes with ``FairseqSequenceGenerator``. ``from_fairseq`` loads a fairseq
``av_hubert_seq2seq`` state dict (``encoder.w2v_model.*`` and
``decoder.*``) without the fairseq runtime.
"""
from __future__ import annotations

import torch
from torch import nn

from svt_speechbrain_tpu_torch.decoders.fairseq_generator import (
    FairseqSequenceGenerator)
from svt_speechbrain_tpu_torch.models.avhubert import (AVHubertConfig,
                                                      AVHubertModel)
from svt_speechbrain_tpu_torch.models.seq2seq_decoder import (
    FairseqDecoderConfig, FairseqTransformerDecoder)


def default_decoder_config():
    """The decoder of AV-HuBERT large's seq2seq checkpoints: 6 × 1024, FFN
    4096, 8 heads, post-LN, unscaled embeddings, 1000 unigram tokens."""
    return FairseqDecoderConfig(
        vocab_size=1000, embed_dim=1024, ffn_dim=4096, num_layers=6,
        num_heads=8, normalize_before=False, no_scale_embedding=True)


class AVHubertASR(nn.Module):
    """Encoder + decoder + generator for seq2seq ASR checkpoints
    (``avhubert_asr.py:25``). Its parameters are ``encoder.*`` (the
    ``AVHubertModel``'s) and ``decoder.*``; ``convert_jax.load_module_tree``
    fills it from the JAX ``{"encoder", "decoder"}`` params tree with the
    state tree ``{"encoder": state}``. ``generator_kwargs`` go to
    ``FairseqSequenceGenerator``.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.convert_jax import init_modules
    >>> enc_cfg = AVHubertConfig(encoder_layers=1, encoder_embed_dim=16,
    ...     encoder_ffn_embed_dim=32, encoder_attention_heads=2,
    ...     audio_feat_dim=8)
    >>> dec_cfg = FairseqDecoderConfig(vocab_size=13, embed_dim=16,
    ...     ffn_dim=32, num_layers=1, num_heads=2, normalize_before=False,
    ...     no_scale_embedding=True)
    >>> asr = AVHubertASR(enc_cfg, dec_cfg, beam_size=2, max_len_b=6)
    >>> init_modules({"asr": asr}, seed=0)
    >>> hyps = asr.transcribe(audio=torch.ones(2, 10, 8))
    >>> len(hyps), int(hyps[0][0]["tokens"][-1])   # best hyp ends in EOS
    (2, 2)
    """

    def __init__(self, encoder_config=None, decoder_config=None,
                 beam_size=5, **generator_kwargs):
        super().__init__()
        self.encoder_config = encoder_config or AVHubertConfig.large()
        self.decoder_config = decoder_config or default_decoder_config()
        self.encoder = AVHubertModel(self.encoder_config)
        self.decoder = FairseqTransformerDecoder(self.decoder_config)
        self.generator = FairseqSequenceGenerator(
            self.decoder, beam_size=beam_size, **generator_kwargs)

    @classmethod
    def from_fairseq(cls, source, encoder_config=None, decoder_config=None,
                     device="cuda", **kwargs):
        """An ``AVHubertASR`` on ``device`` (the card unless the caller asks
        for the CPU) loaded from a fairseq ``av_hubert_seq2seq`` checkpoint:
        a local file or an already-flat state dict (``hubert_asr.py:413``).
        The JAX package returns ``(asr, params, state)``; here the module
        holds them."""
        from svt_speechbrain_tpu_torch.models.convert_fairseq import (
            convert_fairseq_avhubert_asr, load_fairseq_state_dict)

        with torch.device(device):
            asr = cls(encoder_config, decoder_config, **kwargs)
        sd = source if hasattr(source, "items") else \
            load_fairseq_state_dict(source)
        asr.load_state_dict(convert_fairseq_avhubert_asr(
            sd, asr.encoder_config, asr.decoder_config), strict=True)
        return asr.eval()

    def _device(self):
        return self.decoder.embed_tokens.table.device

    @torch.inference_mode()
    def encode(self, audio=None, video=None):
        """AV features (B, T, D) from audio features (B, T, F) and/or lip
        ROIs (B, T, H, W, 1), tensors or arrays, moved to the model's
        device; a missing modality is zero-filled."""
        source = {}
        for name, x in (("audio", audio), ("video", video)):
            if x is not None:
                source[name] = torch.as_tensor(x, dtype=torch.float32,
                                               device=self._device())
        if not source:
            raise ValueError("need audio and/or video")
        return self.encoder.extract_finetune(source)

    @torch.inference_mode()
    def transcribe(self, audio=None, video=None, frame_lengths=None,
                   tokenizer=None, device_search=False):
        """Beam-decode a batch. Returns per utterance the generator's
        hypotheses (tokens with the EOS, score, positional_scores), best
        first; with ``tokenizer`` (anything with ``decode_ids``) the best
        hypothesis of each utterance as text instead. ``frame_lengths``
        (B,) masks the encoder frames past each length in the
        cross-attention. ``device_search`` runs ``generate_on_device``."""
        enc = self.encode(audio=audio, video=video)
        enc_mask = None
        if frame_lengths is not None:
            lengths = torch.as_tensor(frame_lengths, device=enc.device)
            enc_mask = (torch.arange(enc.shape[1], device=enc.device)[None]
                        >= lengths[:, None])
        decode = (self.generator.generate_on_device if device_search
                  else self.generator.generate)
        hyps = decode(enc, encoder_padding_mask=enc_mask)
        if tokenizer is None:
            return hyps
        eos = self.generator.eos
        return [tokenizer.decode_ids(
            [int(t) for t in h[0]["tokens"] if int(t) != eos])
            if h else "" for h in hyps]
