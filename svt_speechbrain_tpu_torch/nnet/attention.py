"""Attention (port of ``svt_speechbrain_tpu/nnet/attention.py``): multi-head
attention and the position-wise FFN, Transformer-XL relative-position
attention, and the additive, location-aware and key-value attentions of
the RNN decoders."""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from svt_speechbrain_tpu_torch.nnet.dropout import dropout
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import wide
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
    kernels, and computes in f32 (in f64 for f64 inputs).
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
    scores = torch.einsum("bhqd,bhkd->bhqk", wide(q), wide(k))
    scores = scores / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
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
    out = torch.einsum("bhqk,bhkd->bhqd", wide(weights.to(v.dtype)),
                       wide(v)).to(v.dtype)
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


class RelPosEncXL(nn.Module):
    """Transformer-XL relative positional encodings (``attention.py:222``):
    for x (B, T, ...), a (1, 2T-1, emb_dim) table for positions T-1 down to
    -(T-1), sin(|pos|·f) on the even columns and cos(pos·f) on the odd, in
    x's dtype. The table is computed in f32 on the CPU, as the JAX
    package's, and moved to x's device: the card's f32 sine differs from
    the CPU's in the last bit, which a card computing its own table would
    carry into every later product, f64 runs included.

    Example
    -------
    >>> import torch
    >>> RelPosEncXL(8)(torch.ones(2, 5, 3)).shape
    torch.Size([1, 9, 8])
    """

    def __init__(self, emb_dim):
        super().__init__()
        self.emb_dim = emb_dim

    def forward(self, x):
        t = x.shape[1]
        pos = torch.arange(t - 1, -t, -1, dtype=torch.float32)[:, None]
        inv_freq = torch.exp(torch.arange(0, self.emb_dim, 2,
                                          dtype=torch.float32)
                             * -(math.log(10000.0) / self.emb_dim))
        sinusoid = pos * inv_freq[None, :]
        pe = torch.zeros(2 * t - 1, self.emb_dim)
        pe[:, 0::2] = torch.sin(sinusoid.abs())
        pe[:, 1::2] = torch.cos(sinusoid)
        return pe[None].to(x.device, x.dtype)


class RelPosMHAXL(nn.Module):
    """Relative-position multi-head attention (Transformer-XL / Conformer,
    ``attention.py:246``): ``wq``, ``wk``, ``wv``, ``wo``, ``wpos`` (d, d)
    (in, out), ``bo``, and the content and position biases ``u``, ``v``
    (heads, head_dim). The scores are (q+u)·k plus the relative shift of
    (q+v)·p, divided by sqrt(embed_dim), not sqrt(head_dim), as in the JAX
    module (``attention.py:300``). ``forward(query, key, value, pos_embs,
    attn_mask=None, key_padding_mask=None, rng=None, train=False)`` returns
    (out, weights averaged over heads); ``rng`` is a ``StepRNG``.

    Example
    -------
    >>> import torch
    >>> x = torch.ones(2, 5, 8)
    >>> out, w = RelPosMHAXL(8, 2)(x, x, x, RelPosEncXL(8)(x))
    >>> out.shape, w.shape
    (torch.Size([2, 5, 8]), torch.Size([2, 5, 5]))
    """

    def __init__(self, embed_dim, num_heads, dropout=0.0,
                 mask_pos_future=False):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.mask_pos_future = mask_pos_future
        self.head_dim = embed_dim // num_heads
        d = embed_dim
        for name in ("wq", "wk", "wv", "wo", "wpos"):
            setattr(self, name, nn.Parameter(torch.zeros(d, d)))
        self.bo = nn.Parameter(torch.zeros(d))
        self.u = nn.Parameter(torch.zeros(num_heads, self.head_dim))
        self.v = nn.Parameter(torch.zeros(num_heads, self.head_dim))

    @staticmethod
    def _rel_shift(x):
        """(B, H, Tq, 2Tk-1) → (B, H, Tq, Tk), Transformer-XL's relative
        shift (``attention.py:273``)."""
        b, h, tq, w = x.shape
        tk = (w + 1) // 2
        x = F.pad(x, (1, 0)).reshape(b, h, w + 1, tq)
        return x[:, :, 1:].reshape(b, h, tq, w)[:, :, :, :tk]

    def forward(self, query, key, value, pos_embs, attn_mask=None,
                key_padding_mask=None, rng=None, train=False):
        b, tq, d = query.shape
        tk = key.shape[1]
        h, dh = self.num_heads, self.head_dim
        q = (query @ self.wq.to(query.dtype)).reshape(b, tq, h, dh)
        k = (key @ self.wk.to(key.dtype)).reshape(b, tk, h, dh).transpose(1, 2)
        v = (value @ self.wv.to(value.dtype)).reshape(b, tk, h,
                                                      dh).transpose(1, 2)
        p = (pos_embs @ self.wpos.to(pos_embs.dtype)).reshape(
            1, -1, h, dh).transpose(1, 2)
        q_u = (q + self.u.to(q.dtype)).transpose(1, 2)
        q_v = (q + self.v.to(q.dtype)).transpose(1, 2)
        ac = torch.einsum("bhqd,bhkd->bhqk", wide(q_u), wide(k))
        bd = torch.einsum("bhqd,bhkd->bhqk", wide(q_v),
                          wide(p).expand(b, -1, -1, -1))
        scores = (ac + self._rel_shift(bd)) / math.sqrt(d)
        mask = None
        if attn_mask is not None:
            mask = (attn_mask[None, None] if attn_mask.dim() == 2
                    else attn_mask[:, None])
        if key_padding_mask is not None:
            kpm = key_padding_mask[:, None, None, :]
            mask = kpm if mask is None else (mask | kpm)
        if mask is not None:
            scores = scores.masked_fill(mask, NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        if train and rng is not None and self.dropout > 0:
            weights = dropout(weights, self.dropout, rng.device, train=True)
        out = torch.einsum("bhqk,bhkd->bhqd", wide(weights.to(v.dtype)),
                           wide(v)).to(v.dtype)
        out = out.transpose(1, 2).reshape(b, tq, d)
        out = out @ self.wo.to(out.dtype) + self.bo.to(out.dtype)
        return out, weights.mean(dim=1)


def _frame_mask(enc_states, enc_len):
    """(B, T) True on each row's first ``enc_len`` (absolute) frames."""
    t = enc_states.shape[1]
    enc_len = torch.as_tensor(enc_len, device=enc_states.device)
    return torch.arange(t, device=enc_states.device)[None, :] < enc_len[:, None]


class ContentBasedAttention(nn.Module):
    """Bahdanau additive attention (``attention.py:322``): ``mlp_enc``,
    ``mlp_dec``, a bias-free ``mlp_attn`` to one score and ``mlp_out``.
    ``forward(enc_states, enc_len, dec_states, enc_h=None)`` → (context
    (B, output_dim), weights (B, T)), ``enc_len`` in absolute frames; the
    frames past it get -inf before the softmax. ``enc_h`` is
    ``mlp_enc(enc_states)`` when the caller has it already: the projection
    depends on the encoder states only, so a decoder computes it once a
    sequence (the same function as the JAX module's every step).

    Example
    -------
    >>> import torch
    >>> att = ContentBasedAttention(enc_dim=6, dec_dim=4, attn_dim=5,
    ...                             output_dim=3)
    >>> c, w = att(torch.ones(2, 7, 6), torch.tensor([7, 4]), torch.ones(2, 4))
    >>> c.shape, w[1, 4:].tolist()
    (torch.Size([2, 3]), [0.0, 0.0, 0.0])
    """

    def __init__(self, enc_dim, dec_dim, attn_dim, output_dim, scaling=1.0):
        super().__init__()
        self.mlp_enc = Linear(attn_dim, enc_dim)
        self.mlp_dec = Linear(attn_dim, dec_dim)
        self.mlp_attn = Linear(1, attn_dim, bias=False)
        self.mlp_out = Linear(output_dim, enc_dim)
        self.scaling = scaling

    def _attend(self, enc_states, mask, scores_in):
        attn = self.mlp_attn(torch.tanh(scores_in))[..., 0]
        attn = attn.masked_fill(~mask, -math.inf)
        attn = torch.softmax(attn * self.scaling, dim=-1)
        context = torch.einsum("bt,btf->bf", attn, enc_states)
        return self.mlp_out(context), attn

    def forward(self, enc_states, enc_len, dec_states, enc_h=None):
        if enc_h is None:
            enc_h = self.mlp_enc(enc_states)
        dec_h = self.mlp_dec(dec_states)[:, None]
        return self._attend(enc_states, _frame_mask(enc_states, enc_len),
                            enc_h + dec_h)


class LocationAwareAttention(ContentBasedAttention):
    """Chorowski location-aware attention (``attention.py:356``): the
    additive attention plus ``mlp_loc`` of a bias-free "same" ``conv_loc``
    (``channels`` wide, kernel 2·kernel_size+1) over the previous step's
    weights. ``forward(enc_states, enc_len, dec_states, prev_attn=None,
    enc_h=None)``; ``prev_attn=None`` starts uniform over the real frames
    (1/enc_len on them, 0 after).

    Example
    -------
    >>> import torch
    >>> att = LocationAwareAttention(6, 4, 5, 3, conv_channels=2,
    ...                              kernel_size=3)
    >>> c, w = att(torch.ones(2, 7, 6), torch.tensor([7, 4]), torch.ones(2, 4))
    >>> c.shape, w.shape
    (torch.Size([2, 3]), torch.Size([2, 7]))
    """

    def __init__(self, enc_dim, dec_dim, attn_dim, output_dim, conv_channels,
                 kernel_size, scaling=1.0):
        super().__init__(enc_dim, dec_dim, attn_dim, output_dim, scaling)
        from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d

        self.conv_loc = Conv1d(conv_channels, 2 * kernel_size + 1, 1,
                               padding="same", bias=False)
        self.mlp_loc = Linear(attn_dim, conv_channels)

    def forward(self, enc_states, enc_len, dec_states, prev_attn=None,
                enc_h=None):
        mask = _frame_mask(enc_states, enc_len)
        if prev_attn is None:
            enc_len = torch.as_tensor(enc_len, device=enc_states.device)
            prev_attn = mask / enc_len.float()[:, None]
        attn_conv = self.mlp_loc(self.conv_loc(
            prev_attn.to(enc_states.dtype)[..., None]))
        if enc_h is None:
            enc_h = self.mlp_enc(enc_states)
        dec_h = self.mlp_dec(dec_states)[:, None]
        return self._attend(enc_states, mask, enc_h + dec_h + attn_conv)


class KeyValueAttention(nn.Module):
    """Single-head scaled dot-product key/value attention
    (``attention.py:394``): ``key_linear``, ``query_linear``,
    ``value_linear``, scores over sqrt(attn_dim), the frames past
    ``enc_len`` at -inf. Returns (context (B, output_dim), weights (B, 1,
    T)).

    Example
    -------
    >>> import torch
    >>> att = KeyValueAttention(enc_dim=6, dec_dim=4, attn_dim=5,
    ...                         output_dim=3)
    >>> c, w = att(torch.ones(2, 7, 6), torch.tensor([7, 4]), torch.ones(2, 4))
    >>> c.shape, w.shape
    (torch.Size([2, 3]), torch.Size([2, 1, 7]))
    """

    def __init__(self, enc_dim, dec_dim, attn_dim, output_dim):
        super().__init__()
        self.key_linear = Linear(attn_dim, enc_dim)
        self.query_linear = Linear(attn_dim, dec_dim)
        self.value_linear = Linear(output_dim, enc_dim)
        self.scaling = attn_dim ** 0.5

    def forward(self, enc_states, enc_len, dec_states):
        keys = self.key_linear(enc_states)
        values = self.value_linear(enc_states)
        query = self.query_linear(dec_states)
        scores = torch.einsum("btf,bf->bt", keys, query) / self.scaling
        scores = scores.masked_fill(~_frame_mask(enc_states, enc_len),
                                    -math.inf)
        w = torch.softmax(scores, dim=1)
        return torch.einsum("bt,btf->bf", w, values), w[:, None]
