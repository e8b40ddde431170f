"""Multi-head attention and the position-wise FFN (port of
``svt_speechbrain_tpu/nnet/attention.py:24-219``)."""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from svt_speechbrain_tpu_torch.nnet.dropout import dropout
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.ops import flash_attention as fa
from svt_speechbrain_tpu_torch.ops.quant import PackedWeight, int8_matmul

NEG_INF = fa.NEG_INF


def scaled_dot_product_attention(q, k, v, bias=None, mask=None,
                                 dropout_rate=0.0, rng=None, train=False,
                                 return_weights=False, impl="auto",
                                 key_lengths=None):
    """q, k, v: (B, H, T, Dh). ``bias`` is added to the scores, ``mask``
    True = masked out, ``key_lengths`` (B,) is each row's valid key count;
    ``rng`` (a ``StepRNG``) and ``train`` turn on attention dropout at
    ``dropout_rate``.

    Dispatch (``attention.py:39-91``): with no bias, boolean mask or
    returned weights, ``impl="auto"`` sends Tk ≥ 1024 to the streaming
    kernel (dropout inside it, seeded per call from the step's host
    generator) and Tk ≤ ``SHORT_T_MAX`` without dropout to the short
    kernel; ``impl="flash"`` forces the streaming kernel. Everything else,
    Tk between 513 and 1023, and short rows under dropout, runs the eager
    path below, with dropout on the materialised weights, as in the JAX
    package. The eager path zeroes rows whose key length is 0, like the
    kernels.
    """
    dropout_active = train and rng is not None and dropout_rate > 0.0
    flashable = bias is None and mask is None and not return_weights
    if flashable and impl != "eager":
        tk = k.shape[2]
        if impl == "flash" or (impl == "auto" and tk >= 1024):
            if dropout_active:
                return fa.flash_attention(q, k, v, key_lengths,
                                          dropout_seed=rng.attention_seed(),
                                          dropout_rate=float(dropout_rate))
            return fa.flash_attention(q, k, v, key_lengths)
        if impl == "auto" and tk <= fa.SHORT_T_MAX and not dropout_active:
            return fa.flash_attention_short(q, k, v, key_lengths)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    if key_lengths is not None:
        kmask = (torch.arange(k.shape[2], device=q.device)[None, None, None, :]
                 >= key_lengths.to(q.device)[:, None, None, None])
        mask = kmask if mask is None else (mask | kmask)
    if mask is not None:
        scores = scores.masked_fill(mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if key_lengths is not None:
        alive = (key_lengths.to(q.device) > 0)[:, None, None, None]
        weights = torch.where(alive, weights, torch.zeros_like(weights))
    if dropout_active:
        weights = dropout(weights, dropout_rate, rng.device, train=True)
    out = torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    if return_weights:
        return out, weights
    return out


class MultiheadAttention(nn.Module):
    """Batch-first multi-head attention with separate ``wq`` (d, d), ``wk``
    (kdim, d), ``wv`` (vdim, d), ``wo`` (d, d) (in, out) projections and
    biases (``attention.py:97``); the attention core goes through
    ``scaled_dot_product_attention``, with attention dropout at rate
    ``dropout`` in training.

    ``forward(query, key, value, attn_mask=None, key_padding_mask=None,
    pos_embs=None, rng=None, train=False, return_attn_weights=False,
    key_lengths=None, impl="auto")``:

    - ``attn_mask``: bool (Tq, Tk), (B·H, Tq, Tk) or (B, Tq, Tk), True =
      disallowed (torch's convention);
    - ``key_padding_mask``: bool (B, Tk), True = padding;
    - ``pos_embs``: a float bias broadcastable to (B, H, Tq, Tk), added to
      the scores;
    - ``key_lengths`` (B,): each row's valid key count, the mask that keeps
      the kernels available; a row of key length 0 comes out as zeros;
    - ``return_attn_weights``: also return the weights averaged over heads,
      (B, Tq, Tk). The JAX module returns them unless told not to; the
      port returns them only when asked (the fusion network asks), so the
      encoder's calls keep their kernel dispatch and single return.

    A boolean mask, a bias or the returned weights take the eager path; a
    row whose keys are all masked by a boolean mask gets a uniform softmax,
    as in the JAX package.

    ``to_int8_`` replaces one projection matrix by its int8 serving form
    (``attention.py:153-158``): buffers ``{name}_q8`` and ``{name}_scale``
    instead of the parameter, the product through ``ops.quant.int8_matmul``.
    The attention core stays float.

    Example
    -------
    >>> import torch
    >>> mha = MultiheadAttention(nhead=4, d_model=16)
    >>> x = torch.ones(2, 6, 16)
    >>> mha(x, x, x, key_lengths=torch.tensor([6, 3])).shape
    torch.Size([2, 6, 16])
    >>> out, weights = mha(x, x, x, return_attn_weights=True)
    >>> weights.shape                        # averaged over heads
    torch.Size([2, 6, 6])
    """

    def __init__(self, nhead, d_model, dropout=0.0, kdim=None, vdim=None):
        super().__init__()
        if d_model % nhead:
            raise ValueError("d_model must be divisible by nhead")
        self.dropout = dropout
        self.nhead = nhead
        self.d_model = d_model
        self.kdim = kdim or d_model
        self.vdim = vdim or d_model
        self.head_dim = d_model // nhead
        for name, n_in in (("q", d_model), ("k", self.kdim), ("v", self.vdim),
                           ("o", d_model)):
            setattr(self, f"w{name}", nn.Parameter(torch.zeros(n_in, d_model)))
            setattr(self, f"b{name}", nn.Parameter(torch.zeros(d_model)))
        self._packed = {}

    def to_int8_(self, name, w_q8, w_scale):
        """In place: replace the float matrix ``name`` ("wq", "wk", "wv" or
        "wo") by the buffers ``{name}_q8`` / ``{name}_scale``."""
        if name not in ("wq", "wk", "wv", "wo"):
            raise KeyError(name)
        if name in self._parameters:
            delattr(self, name)
        for key, value in ((name + "_q8", w_q8), (name + "_scale", w_scale)):
            self._buffers.pop(key, None)
            self.register_buffer(key, value)
        self._packed[name] = PackedWeight()
        return self

    def _mm(self, x, name):
        w8 = self._buffers.get(name + "_q8")
        if w8 is not None:
            return int8_matmul(x, w8, self._buffers[name + "_scale"],
                               self._packed[name](w8))
        return torch.matmul(x, getattr(self, name).to(x.dtype))

    def forward(self, query, key, value, attn_mask=None,
                key_padding_mask=None, pos_embs=None, rng=None, train=False,
                return_attn_weights=False, key_lengths=None, impl="auto"):
        b, tq, _ = query.shape
        tk = key.shape[1]
        h, dh = self.nhead, self.head_dim

        def proj(x, name, bias):
            y = self._mm(x, name) + bias.to(x.dtype)
            return y.reshape(b, -1, h, dh).transpose(1, 2)   # (B, H, T, Dh)

        q = proj(query, "wq", self.bq)
        k = proj(key, "wk", self.bk)
        v = proj(value, "wv", self.bv)

        mask = None
        if attn_mask is not None:
            if attn_mask.dim() == 2:
                mask = attn_mask[None, None]
            elif attn_mask.shape[0] == b * h:
                mask = attn_mask.reshape(-1, h, tq, tk)
            else:
                mask = attn_mask[:, None]
        if key_padding_mask is not None:
            kpm = key_padding_mask[:, None, None, :]            # (B, 1, 1, Tk)
            mask = kpm if mask is None else (mask | kpm)

        res = scaled_dot_product_attention(
            q, k, v, bias=pos_embs, mask=mask, dropout_rate=self.dropout,
            rng=rng, train=train, return_weights=return_attn_weights,
            impl=impl, key_lengths=key_lengths)
        out, weights = res if return_attn_weights else (res, None)
        out = out.transpose(1, 2).reshape(b, tq, self.d_model)
        out = self._mm(out, "wo") + self.bo.to(out.dtype)
        if return_attn_weights:
            return out, weights.mean(dim=1)
        return out


class PositionalwiseFeedForward(nn.Module):
    """The transformer's per-position FFN (``attention.py:194``):
    ``ffn2(dropout(act(ffn1(x))))``, ``act`` ReLU or exact GELU.

    Example
    -------
    >>> import torch
    >>> ffn = PositionalwiseFeedForward(d_ffn=32, input_size=16)
    >>> ffn(torch.ones(2, 5, 16)).shape
    torch.Size([2, 5, 16])
    """

    def __init__(self, d_ffn, input_size, dropout=0.0, activation="relu"):
        super().__init__()
        self.d_ffn = d_ffn
        self.input_size = input_size
        self.dropout = dropout
        self.activation = activation
        self.ffn1 = Linear(d_ffn, input_size)
        self.ffn2 = Linear(input_size, d_ffn)

    def forward(self, x, rng=None, train=False):
        h = self.ffn1(x)
        h = torch.relu(h) if self.activation == "relu" else F.gelu(h)
        if rng is not None:
            h = dropout(h, self.dropout, rng.device, train)
        return self.ffn2(h)
