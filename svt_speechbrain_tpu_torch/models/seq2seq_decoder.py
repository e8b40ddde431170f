"""fairseq-style seq2seq transformer decoder for AV-HuBERT ASR checkpoints
(port of ``svt_speechbrain_tpu/models/seq2seq_decoder.py``).

The decoder math of fairseq's incremental ``TransformerDecoder``: sinusoidal
positions offset by the padding index (or a learned table), sqrt(d)-scaled
embeddings unless ``no_scale_embedding``, pre- or post-norm residual blocks
over self-attention, encoder cross-attention and the FFN, and a shared or
separate output embedding. Two ways to run it:

- the **teacher-forced forward**: every position at once under a causal
  mask (the training and scoring path);
- the **incremental step** over a cache made by ``init_cache``: per layer a
  self-attention ring of static length, written in place at step ``t``,
  and the cross-attention keys/values, computed once per utterance.

The cache keeps the cross-attention keys/values (and the encoder padding
mask) once per sentence, not once per beam: a beam search's rows are
``beam`` consecutive rows per sentence (``init_cache(..., beam=beam)``),
their queries attend to their sentence's keys, and ``reorder_cache`` leaves
them alone, since a beam search only reorders rows within a sentence. The
JAX cache holds them per row and gathers them at every reorder; with
``beam=1`` the two caches hold the same tensors.

The decoder's attention runs eagerly: the layers ask for attention weights
or pass masks, and the step attends by einsum, as in the JAX package, so it
launches no attention kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from svt_speechbrain_tpu_torch.nnet.attention import MultiheadAttention
from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import LayerNorm


@dataclass
class FairseqDecoderConfig:
    """The fairseq decoder's hyperparameters (``seq2seq_decoder.py:37``):
    ``decoder_embed_dim``, ``decoder_ffn_embed_dim``, ``decoder_layers``,
    ``decoder_attention_heads``, ``decoder_normalize_before``,
    ``share_decoder_input_output_embed``, ``no_scale_embedding``,
    ``decoder_learned_pos``, ``max_target_positions``, ``activation_fn``."""

    vocab_size: int
    embed_dim: int = 768
    ffn_dim: int = 3072
    num_layers: int = 6
    num_heads: int = 4
    normalize_before: bool = True
    share_input_output_embed: bool = False
    no_scale_embedding: bool = False
    learned_pos: bool = False
    max_target_positions: int = 2048
    padding_idx: int = 1
    activation: str = "relu"
    dropout: float = 0.0


def sinusoidal_positions(num_embeddings, dim, padding_idx, device=None):
    """fairseq ``SinusoidalPositionalEmbedding.get_embedding``: half sines,
    half cosines concatenated (not interleaved), an odd last dim zero, the
    padding row zero.

    Example
    -------
    >>> t = sinusoidal_positions(6, 4, padding_idx=1)
    >>> tuple(t.shape), float(t[1].abs().max())
    ((6, 4), 0.0)
    """
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                     * -(math.log(10000.0) / (half - 1)))
    ang = (torch.arange(num_embeddings, dtype=torch.float32,
                        device=device)[:, None] * freq[None])
    table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if dim % 2 == 1:
        table = F.pad(table, (0, 1))
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table


class _DecoderLayer(nn.Module):
    """One fairseq decoder layer (``seq2seq_decoder.py:87``): self-attention,
    cross-attention and FFN residual blocks, each with its own LayerNorm,
    pre- or post-norm; ReLU or exact GELU."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.embed_dim, cfg.ffn_dim
        self.self_attn = MultiheadAttention(cfg.num_heads, d)
        self.encoder_attn = MultiheadAttention(cfg.num_heads, d)
        self.ln_self = LayerNorm(d)
        self.ln_cross = LayerNorm(d)
        self.ln_final = LayerNorm(d)
        self.fc1 = Linear(f, d)
        self.fc2 = Linear(d, f)

    def ffn(self, x):
        h = self.fc1(x)
        h = torch.relu(h) if self.cfg.activation == "relu" else F.gelu(h)
        return self.fc2(h)

    def _block(self, ln, x, fn):
        """``x + fn(ln(x))`` (pre-norm) or ``ln(x + fn(x))`` (post-norm)."""
        if self.cfg.normalize_before:
            return x + fn(ln(x))
        return ln(x + fn(x))

    def forward(self, x, encoder_out, self_mask=None,
                encoder_padding_mask=None):
        x = self._block(self.ln_self, x, lambda h: self.self_attn(
            h, h, h, attn_mask=self_mask, return_attn_weights=True)[0])
        attn = []

        def cross(h):
            out, w = self.encoder_attn(
                h, encoder_out, encoder_out,
                key_padding_mask=encoder_padding_mask,
                return_attn_weights=True)
            attn.append(w)
            return out

        x = self._block(self.ln_cross, x, cross)
        x = self._block(self.ln_final, x, self.ffn)
        return x, attn[0]


def _proj(x, attn, name):
    return attn._mm(x, "w" + name) + getattr(attn, "b" + name).to(x.dtype)


class FairseqTransformerDecoder(nn.Module):
    """Embeddings, positions, the layer stack and the output projection
    (``seq2seq_decoder.py:149``). Parameter names follow the JAX tree
    (``embed_tokens.table``, ``layers.{i}.{self_attn,encoder_attn,ln_self,
    ln_cross,ln_final,fc1,fc2}``, ``embed_positions.table`` when learned,
    ``embed_out`` unless shared, ``final_ln`` when pre-norm), so
    ``convert_jax.load_module_tree`` fills it from a JAX tree.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.convert_jax import (
    ...     init_fairseq_decoder, load_module_tree)
    >>> cfg = FairseqDecoderConfig(vocab_size=11, embed_dim=8, ffn_dim=16,
    ...                            num_layers=2, num_heads=2)
    >>> dec = FairseqTransformerDecoder(cfg)
    >>> load_module_tree(dec, init_fairseq_decoder(
    ...     cfg, torch.Generator().manual_seed(0)))
    >>> enc = torch.ones(2, 5, 8)
    >>> logits, attn = dec(torch.tensor([[2, 4, 6], [2, 5, 1]]), enc)
    >>> tuple(logits.shape), tuple(attn.shape)
    ((2, 3, 11), (2, 3, 5))
    >>> cache = dec.init_cache(enc, max_len=4)
    >>> step0 = dec.step(cache, torch.tensor([2, 2]), 0)
    >>> bool(torch.allclose(step0, logits[:, 0], atol=1e-5))
    True
    """

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.embed_tokens = Embedding(cfg.vocab_size, d)
        self.layers = nn.ModuleList(_DecoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        # fairseq's table size: positions start at padding_idx + 1
        self._n_pos = cfg.max_target_positions + cfg.padding_idx + 1
        if cfg.learned_pos:
            self.embed_positions = Embedding(self._n_pos, d)
        else:
            self.register_buffer(
                "_sinusoids", sinusoidal_positions(self._n_pos, d,
                                                   cfg.padding_idx),
                persistent=False)
        if not cfg.share_input_output_embed:
            self.embed_out = nn.Parameter(torch.zeros(cfg.vocab_size, d))
        self.final_ln = LayerNorm(d) if cfg.normalize_before else None
        self.embed_scale = 1.0 if cfg.no_scale_embedding else math.sqrt(d)

    # ------------------------------------------------------------ helpers

    def _pos_table(self, length):
        if self.cfg.learned_pos:
            return self.embed_positions.table
        if length + self.cfg.padding_idx + 1 <= self._n_pos:
            return self._sinusoids
        return sinusoidal_positions(length + self.cfg.padding_idx + 1,
                                    self.cfg.embed_dim, self.cfg.padding_idx,
                                    self._sinusoids.device)

    def _output(self, x):
        table = (self.embed_tokens.table if self.cfg.share_input_output_embed
                 else self.embed_out)
        if self.final_ln is not None:
            x = self.final_ln(x)
        return torch.matmul(x, table.to(x.dtype).t())

    # ------------------------------------------------------- full forward

    def forward(self, prev_tokens, encoder_out, encoder_padding_mask=None):
        """Teacher-forced: ``prev_tokens`` (B, T) int → (logits (B, T, V),
        the last layer's head-averaged cross-attention (B, T, S))."""
        pad = self.cfg.padding_idx
        nonpad = (prev_tokens != pad).long()
        positions = torch.cumsum(nonpad, dim=1) * nonpad + pad
        x = (self.embed_tokens(prev_tokens) * self.embed_scale
             + self._pos_table(prev_tokens.shape[1])[positions])
        t = prev_tokens.shape[1]
        causal = torch.ones(t, t, dtype=torch.bool,
                            device=x.device).triu(diagonal=1)
        attn = None
        for layer in self.layers:
            x, attn = layer(x, encoder_out, self_mask=causal,
                            encoder_padding_mask=encoder_padding_mask)
        return self._output(x), attn

    # -------------------------------------------------- incremental decode

    def init_cache(self, encoder_out, max_len, encoder_padding_mask=None,
                   beam=1):
        """The decode state for ``B·beam`` rows, ``beam`` consecutive rows
        per sentence of ``encoder_out`` (B, S, D): per layer a zeroed
        self-attention ring ``k_self``/``v_self`` (B·beam, max_len, D) and
        the cross-attention ``k_cross``/``v_cross`` (B, S, D), computed here
        once; ``enc_mask`` (B, S), True = padding, or None."""
        rows = encoder_out.shape[0] * beam
        layers = []
        for layer in self.layers:
            ring = encoder_out.new_zeros(rows, max_len,
                                         layer.self_attn.d_model)
            layers.append({
                "k_self": ring, "v_self": torch.zeros_like(ring),
                "k_cross": _proj(encoder_out, layer.encoder_attn, "k"),
                "v_cross": _proj(encoder_out, layer.encoder_attn, "v")})
        return {"enc_mask": encoder_padding_mask, "beam": beam,
                "layers": layers}

    @staticmethod
    def reorder_cache(cache, order):
        """Beam reorder: the self-attention rings gathered along the row
        axis by ``order`` (B·beam,), which keeps each row within its
        sentence's beams; the cross-attention keys/values and the mask are
        per sentence and stay as they are."""
        layers = [dict(lc, k_self=lc["k_self"].index_select(0, order),
                       v_self=lc["v_self"].index_select(0, order))
                  for lc in cache["layers"]]
        return dict(cache, layers=layers)

    def _attend(self, attn, q, k, v, mask=None):
        """q (N, D) over k, v (B, L, D), N = B·g: each group of g rows
        attends to its own row of k and v, with the heads of ``attn`` (its
        own under tensor parallelism); ``mask`` (B, L) True = masked (an
        all-masked row gives NaN, as in the JAX step)."""
        h, dh = attn.nhead, attn.head_dim
        b, n = k.shape[0], q.shape[0]
        qh = q.reshape(b, n // b, h, dh)
        kh = k.reshape(b, -1, h, dh)
        vh = v.reshape(b, -1, h, dh)
        scores = torch.einsum("bghd,bthd->bght", qh, kh) / math.sqrt(dh)
        if mask is not None:
            scores = scores.masked_fill(mask[:, None, None, :], -math.inf)
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bght,bthd->bghd", w, vh).reshape(n, -1)

    def step(self, cache, tokens_t, t):
        """One decode step: ``tokens_t`` (B·beam,) previous tokens at
        position ``t`` (a Python int, 0-based) → logits (B·beam, V). The
        step's keys/values are written into the rings at ``t`` in place;
        the self-attention reads positions 0..t."""
        cfg = self.cfg
        pos = cfg.padding_idx + 1 + t
        x = (self.embed_tokens(tokens_t) * self.embed_scale
             + self._pos_table(cfg.max_target_positions)[pos])
        for layer, lc in zip(self.layers, cache["layers"]):
            def self_attn(h, lc=lc, attn=layer.self_attn):
                lc["k_self"][:, t] = _proj(h, attn, "k")
                lc["v_self"][:, t] = _proj(h, attn, "v")
                o = self._attend(attn, _proj(h, attn, "q"),
                                 lc["k_self"][:, :t + 1],
                                 lc["v_self"][:, :t + 1])
                return _proj(o, attn, "o")

            def cross_attn(h, lc=lc, attn=layer.encoder_attn):
                o = self._attend(attn, _proj(h, attn, "q"), lc["k_cross"],
                                 lc["v_cross"], mask=cache["enc_mask"])
                return _proj(o, attn, "o")

            x = layer._block(layer.ln_self, x, self_attn)
            x = layer._block(layer.ln_cross, x, cross_attn)
            x = layer._block(layer.ln_final, x, layer.ffn)
        return self._output(x)
