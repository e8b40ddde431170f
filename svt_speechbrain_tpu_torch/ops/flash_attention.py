"""Attention with per-row key lengths on the card (port of
``svt_speechbrain_tpu/ops/flash_attention.py``).

Five wrappers over the CUDA bodies in ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward), each with its own launch
counter so each TPU kernel it replaces stays accounted for:

- ``flash_attention_short`` ← ``flash_attention_short`` (Tk ≤ ``SHORT_T_MAX``);
- ``flash_attention`` ← ``flash_attention``: its counter counts the serving
  form (``_flash_kernel``: no dropout, no logsumexp, no gradient);
- ``flash_attention_fwd_lse`` ← ``_flash_kernel_lse``: the training forward,
  with the logsumexp and the in-kernel hash dropout;
- ``flash_attention_bwd_dq`` ← ``_flash_bwd_dq_kernel``;
- ``flash_attention_bwd_dkv`` ← ``_flash_bwd_dkv_kernel``.

``flash_attention`` runs the serving form when no gradient is wanted and no
dropout applies, else an autograd Function whose forward is
``flash_attention_fwd_lse`` and whose backward computes Δ = rowsum(dO ∘ O)
in f32 and launches the dQ and dK/dV kernels.
``flash_attention_short`` is an autograd Function too, with the VJP of the
plain attention as its backward (the JAX package's ``_short_bwd``).

q, k, v are (B, H, T, D); ``lengths`` (B,) gives each batch row's valid key
count (keys ≥ length are masked with −1e30; a row of length 0 yields
zeros and zero gradients). On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it runs its plain PyTorch version, which
is also the tests' oracle. The kernels copy rows in 16-byte pieces: the
forward wrappers hand the kernel aligned copies of rows that are not
16-byte aligned; the backward wrappers raise on them (the autograd Function
hands them aligned copies).
"""
from __future__ import annotations

import ctypes
import math

import torch

from svt_speechbrain_tpu_torch.ops import _build

NEG_INF = -1e30
SHORT_T_MAX = 512
HEAD_DIMS = (16, 64)   # the D the CUDA kernels are built for (TINY, lv60)

_STRIDES = [ctypes.c_longlong] * 3
_DROPOUT = [ctypes.c_float, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
            ctypes.c_float, ctypes.c_void_p]       # scale .. stream
_FWD = {"svt_flash_attention_fwd":
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + _STRIDES * 4 + _DROPOUT,
        "svt_flash_attention_fwd_attributes":
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]}
_BWD = {"svt_flash_attention_bwd_dq":
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + _STRIDES * 5 + _DROPOUT,
        "svt_flash_attention_bwd_dkv":
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + _STRIDES * 6 + _DROPOUT,
        "svt_flash_attention_bwd_attributes":
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The dropout mask: murmur3 fmix32 over (seed, row, q, k), as uint32
# ---------------------------------------------------------------------------

def _mul32(h, c):
    """(h * c) mod 2^32 for int64 tensors h in [0, 2^32) and a constant c:
    torch has no wrapping uint32 multiply, and an int64 product of two
    32-bit values can pass 2^63, so c is split into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX_C2)
    return h ^ (h >> 16)


def _dropout_bits(seed, row, q_idx, k_idx):
    """uint32 bits (as int64) for score positions (q_idx, k_idx) of
    flattened row ``row`` (``ops/flash_attention.py:80``); all arguments
    are int64 tensors or ints, broadcast together."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & _U32
    row = torch.as_tensor(row, dtype=torch.int64, device=seed.device)
    h0 = _fmix32(seed ^ _mul32(row & _U32, _GOLDEN))
    hq = _fmix32(_mul32(q_idx & _U32, _FMIX_C2) ^ h0)
    return _fmix32(_mul32(k_idx & _U32, _FMIX_C1) ^ hq)


def _dropout_constants(rate):
    """(threshold, keep scale) of ``_keep_scale``: keep where
    bits ≥ min(int(rate·2³²), 2³²−1), scaled by f32(1/(1−rate))."""
    thresh = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    return thresh, float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def attention_dropout_mask(seed, b, h, tq, tk, rate, device=None):
    """The kernels' dropout multiplier for row-major (B, H) flattening:
    (B, H, Tq, Tk) f32 of 0 (dropped) or 1/(1−rate) (kept), bit-identical
    to the JAX package's ``attention_dropout_mask``.

    Example
    -------
    >>> m = attention_dropout_mask(seed=7, b=1, h=2, tq=8, tk=8, rate=0.5)
    >>> m.shape, sorted(set(m.flatten().tolist()))
    (torch.Size([1, 2, 8, 8]), [0.0, 2.0])
    """
    thresh, keep = _dropout_constants(rate)
    rows = torch.arange(b * h, device=device).reshape(b * h, 1, 1)
    q_idx = torch.arange(tq, device=device).reshape(1, tq, 1)
    k_idx = torch.arange(tk, device=device).reshape(1, 1, tk)
    seed = torch.tensor(int(seed), device=device)
    bits = _dropout_bits(seed, rows, q_idx, k_idx)
    return torch.where(bits >= thresh, keep, 0.0).reshape(b, h, tq, tk)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _key_valid(lengths, tk, device):
    """(B or 1, 1, 1, Tk) bool: key < length."""
    col = torch.arange(tk, device=device)[None, None, None, :]
    if lengths is None:
        return torch.ones_like(col, dtype=torch.bool)
    return col < lengths.to(device)[:, None, None, None]


def attention_reference(q, k, v, lengths=None, scale=None):
    """Plain version: f32 scores, −1e30 mask on keys ≥ length, softmax,
    rows of length 0 zeroed, f32 product with V, cast to V's dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * _scale(q, scale)
    if lengths is not None:
        s = torch.where(_key_valid(lengths, k.shape[2], s.device), s,
                        torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    if lengths is not None:
        w = torch.where((lengths.to(s.device) > 0)[:, None, None, None], w,
                        torch.zeros_like(w))
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(v.dtype)


def _mask_or_one(q, k, seed, rate):
    if rate <= 0.0:
        return 1.0
    b, h, tq, _ = q.shape
    return attention_dropout_mask(seed, b, h, tq, k.shape[2], rate, q.device)


def attention_lse_reference(q, k, v, lengths=None, scale=None, seed=0,
                            rate=0.0):
    """Plain version of the training forward: (out, L), L = m + log l in
    f32 (−1e30 where l = 0), out = ((P ∘ M) cast to V's dtype) · V / l."""
    scale = _scale(q, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = _key_valid(lengths, k.shape[2], s.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * _mask_or_one(q, k, seed, rate)).to(v.dtype).float()
    out = torch.einsum("bhqk,bhkd->bhqd", pv, v.float())
    out = (out / torch.clamp(l, min=1e-30)).to(v.dtype)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, NEG_INF))
    return out, lse[..., 0]


def _probs(q, k, lse, lengths, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = _key_valid(lengths, k.shape[2], s.device)
    return torch.where(valid, torch.exp(s - lse[..., None]),
                       torch.zeros_like(s))


def attention_bwd_dq_reference(q, k, v, dout, lse, delta, lengths=None,
                               scale=None, seed=0, rate=0.0):
    """Plain version of the dQ program: dQ = (P ∘ ((dO·Vᵀ) ∘ M − Δ) ·
    scale, cast to K's dtype) · K."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, lengths, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    dp = dp * _mask_or_one(q, k, seed, rate)
    ds = (p * (dp - delta[..., None]) * scale).to(k.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def attention_bwd_dkv_reference(q, k, v, dout, lse, delta, lengths=None,
                                scale=None, seed=0, rate=0.0):
    """Plain version of the dK/dV program: dV = (P ∘ M)ᵀ · dO in f32,
    dK = (P ∘ ((dO·Vᵀ) ∘ M − Δ) · scale, cast to Q's dtype)ᵀ · Q."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, lengths, scale)
    mask = _mask_or_one(q, k, seed, rate)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float()) * mask
    dv = torch.einsum("bhqk,bhqd->bhkd", p * mask, dout.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check(q, k, v, lengths):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, T, D)")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"inconsistent shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share one device")
    if lengths is not None and tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"lengths must be (B,), got {tuple(lengths.shape)}")


def _check_card(*tensors):
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA attention takes f32 or bf16, not {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the CUDA attention takes D in {HEAD_DIMS}, "
                         f"got {q.shape[3]}")
    for t in tensors:
        if t.dtype != q.dtype or t.device != q.device or t.stride(3) != 1:
            raise ValueError("q, k, v, dO must share dtype and device and "
                             "have a unit stride on D")


def _check_backward(q, dout, *rows):
    if dout.shape != q.shape:
        raise ValueError(f"dO must be shaped like q, {tuple(q.shape)}, "
                         f"got {tuple(dout.shape)}")
    want = (q.shape[0], q.shape[1], q.shape[2])
    for t in rows:
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"logsumexp and delta must be contiguous f32 "
                             f"{want} on the device of q")


def _misaligned(t):
    """Why ``t`` cannot feed the attention kernels, or None. They copy rows
    into shared memory in 16-byte pieces (``cp.async``): the base address and
    the (batch, head, time) strides in bytes must be multiples of 16 (the
    stride of an axis of size 1 is never used)."""
    size = t.element_size()
    strides = tuple(st * size for st in t.stride()[:3])
    if t.data_ptr() % 16 or any(n > 1 and st % 16 for n, st in
                                zip(t.shape[:3], strides)):
        return (f"base address {t.data_ptr() % 16} bytes past a multiple of "
                f"16, (batch, head, time) strides {strides} bytes")
    return None


def _check_aligned(*tensors):
    for t in tensors:
        why = _misaligned(t)
        if why is not None:
            raise ValueError("the attention backward kernels need 16-byte "
                             f"aligned rows; got {why}")


def _aligned(t):
    """``t``, or a contiguous copy where the attention kernels cannot take
    it as it is (a non-unit stride on D, e.g. the expanded gradient of a
    sum, or rows that are not 16-byte aligned)."""
    if t.stride(-1) == 1 and _misaligned(t) is None:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _lengths_ptr(lengths, device):
    if lengths is None:
        return None, None
    lens = lengths.to(device=device, dtype=torch.int32).contiguous()
    return lens, lens.data_ptr()


def _like_bthd(x):
    """An uninitialised (B, H, T, D) tensor stored as (B, T, H, D): the
    module's transpose back to (B, T, H*D) is then free."""
    b, h, t, d = x.shape
    return torch.empty(b, t, h, d, device=x.device, dtype=x.dtype).transpose(1, 2)


def _dropout_args(scale, seed, rate):
    if rate > 0.0:
        thresh, keep = _dropout_constants(rate)
        return [float(scale), 1, int(seed) & _U32, thresh, keep,
                _build.stream_handle()]
    return [float(scale), 0, 0, 0, 1.0, _build.stream_handle()]


def _launch_fwd(q, k, v, lengths, scale, lse, seed=0, rate=0.0, lib=None):
    """One launch of the forward body (``lib``: another build of
    ``csrc/flash_attention.cu``, for timing tile variants). q, k and v are
    copied where their rows are not 16-byte aligned (the kernel copies rows
    in 16-byte pieces)."""
    _check_card(q, k, v)
    q, k, v = (_aligned(t) for t in (q, k, v))
    b, h, tq, d = q.shape
    lens, lens_ptr = _lengths_ptr(lengths, q.device)
    out = _like_bthd(q)
    lib = lib or _build.load("flash_attention", _FWD)
    err = lib.svt_flash_attention_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens_ptr, out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, h, tq, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3],
        *_dropout_args(_scale(q, scale), seed, rate))
    _build.check(err, "flash_attention kernel launch")
    return out


def flash_attention_fwd_lse(q, k, v, lengths=None, scale=None, seed=0,
                            rate=0.0):
    """Training forward: (out (B, H, Tq, D), L (B, H, Tq) f32), with the
    hash dropout of (seed, rate) applied after normalisation."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return attention_lse_reference(q, k, v, lengths, scale, seed, rate)
    lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
    out = _launch_fwd(q, k, v, lengths, scale, lse, seed, rate)
    flash_attention_fwd_lse.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, lengths=None,
                           scale=None, seed=0, rate=0.0):
    """dQ (B, H, Tq, D) from the forward's L and Δ = rowsum(dO ∘ O)."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return attention_bwd_dq_reference(q, k, v, dout, lse, delta,
                                          lengths, scale, seed, rate)
    _check_card(q, k, v, dout)
    _check_backward(q, dout, lse, delta)
    _check_aligned(q, k, v, dout)
    b, h, tq, d = q.shape
    lens, lens_ptr = _lengths_ptr(lengths, q.device)
    dq = _like_bthd(q)
    lib = _build.load("flash_attention_bwd", _BWD)
    err = lib.svt_flash_attention_bwd_dq(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), lens_ptr,
        dq.data_ptr(), b, h, tq, k.shape[2], d, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
        *dq.stride()[:3], *_dropout_args(_scale(q, scale), seed, rate))
    _build.check(err, "flash_attention dQ kernel launch")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, lengths=None,
                            scale=None, seed=0, rate=0.0):
    """(dK, dV), each (B, H, Tk, D), from the forward's L and Δ."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                           lengths, scale, seed, rate)
    _check_card(q, k, v, dout)
    _check_backward(q, dout, lse, delta)
    _check_aligned(q, k, v, dout)
    b, h, tq, d = q.shape
    lens, lens_ptr = _lengths_ptr(lengths, q.device)
    dk, dv = _like_bthd(k), _like_bthd(v)
    lib = _build.load("flash_attention_bwd", _BWD)
    err = lib.svt_flash_attention_bwd_dkv(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), lens_ptr,
        dk.data_ptr(), dv.data_ptr(), b, h, tq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        *_dropout_args(_scale(q, scale), seed, rate))
    _build.check(err, "flash_attention dK/dV kernel launch")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _attribute_rows(query, kernels, what):
    """``query(kernel_id, dtype_code, d, dropout, out)`` over every
    instantiation: dicts with ``kernel``, ``dtype``, ``d``, ``dropout``,
    ``registers`` (per thread), ``local_bytes`` (per thread: 0 means no
    spills), ``smem_bytes`` (dynamic, per block) and ``blocks_per_sm``
    (resident, at the kernels' 128 threads a block)."""
    rows = []
    for kernel_id, kernel in enumerate(kernels):
        for dtype, code in _DTYPE_CODES.items():
            for d in HEAD_DIMS:
                for dropout in (0, 1):
                    out = (ctypes.c_int * 4)()
                    _build.check(query(kernel_id, code, d, dropout, out), what)
                    rows.append(dict(
                        kernel=kernel, dtype=str(dtype).split(".")[-1], d=d,
                        dropout=bool(dropout), registers=out[0],
                        local_bytes=out[1], smem_bytes=out[2],
                        blocks_per_sm=out[3]))
    return rows


def forward_kernel_attributes(lib=None):
    """Each instantiation of the forward body (kernels 2, 3 and 3b) on the
    current card (``lib``: another build of ``csrc/flash_attention.cu``), as
    ``backward_kernel_attributes``, ``kernel`` "fwd"."""
    lib = lib or _build.load("flash_attention", _FWD)
    return _attribute_rows(
        lambda _, *args: lib.svt_flash_attention_fwd_attributes(*args),
        ("fwd",), "flash_attention forward attributes")


def backward_kernel_attributes():
    """Each instantiation of the two backward kernels on the current card:
    a list of dicts with ``kernel`` ("dq" or "dkv"), ``dtype``, ``d``,
    ``dropout``, ``registers`` (per thread), ``local_bytes`` (per thread:
    0 means no spills), ``smem_bytes`` (dynamic, per block) and
    ``blocks_per_sm`` (resident, at the kernels' 128 threads a block)."""
    lib = _build.load("flash_attention_bwd", _BWD)
    return _attribute_rows(lib.svt_flash_attention_bwd_attributes,
                           ("dq", "dkv"), "flash_attention backward attributes")


# ---------------------------------------------------------------------------
# Public functions
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Training form (``ops/flash_attention.py:452-521``): the forward saves
    L; the backward computes Δ in f32 and launches the dQ and dK/dV
    kernels, which regenerate the dropout mask."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, seed, rate):
        out, lse = flash_attention_fwd_lse(q, k, v, lengths, scale, seed,
                                           rate)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.args = (scale, seed, rate)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        scale, seed, rate = ctx.args
        q, k, v, grad = (_aligned(t) for t in (q, k, v, grad))
        delta = (grad.float() * out.float()).sum(dim=-1).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, grad, lse, delta, lengths,
                                    scale, seed, rate)
        dk, dv = flash_attention_bwd_dkv(q, k, v, grad, lse, delta, lengths,
                                         scale, seed, rate)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, lengths=None, scale=None, dropout_seed=None,
                    dropout_rate=0.0):
    """Streaming attention over K/V panels: (B, H, Tq, D) out.

    ``dropout_rate`` > 0 applies attention dropout inside the kernels, the
    mask a hash of ``dropout_seed`` (an int, drawn fresh per call) and the
    global score coordinates. With dropout, or when q, k or v needs a
    gradient, the training form runs (forward with logsumexp, backward
    kernels); otherwise the serving form.

    Example
    -------
    >>> import torch
    >>> q = torch.randn(1, 2, 6, 8, requires_grad=True)
    >>> out = flash_attention(q, q, q, torch.tensor([4]), dropout_seed=3,
    ...                       dropout_rate=0.1)
    >>> out.sum().backward()
    >>> out.shape, q.grad.shape
    (torch.Size([1, 2, 6, 8]), torch.Size([1, 2, 6, 8]))
    """
    _check(q, k, v, lengths)
    if dropout_rate > 0.0 and dropout_seed is None:
        # a fixed default seed would drop the same links at every step
        raise ValueError("flash_attention: dropout_rate > 0 requires "
                         "dropout_seed (draw a fresh one per call)")
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if dropout_rate <= 0.0 and not wants_grad:
        if q.device.type == "cpu":
            return attention_reference(q, k, v, lengths, scale)
        out = _launch_fwd(q, k, v, lengths, scale, None)
        flash_attention.launches += 1
        return out
    return _FlashAttention.apply(q, k, v, lengths, scale,
                                 int(dropout_seed or 0), float(dropout_rate))


class _ShortAttention(torch.autograd.Function):
    """The short kernel forward; the backward is the VJP of the plain
    attention (``_short_bwd``, ``ops/flash_attention.py:650-659``)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale):
        out = _launch_fwd(q, k, v, lengths, scale, None)
        flash_attention_short.launches += 1
        ctx.save_for_backward(q, k, v, lengths)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_reference(*inputs, lengths, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad)
        return dq, dk, dv, None, None


def flash_attention_short(q, k, v, lengths=None, scale=None):
    """Short-row attention (Tk ≤ ``SHORT_T_MAX``): (B, H, Tq, D) out.

    Example
    -------
    >>> import torch
    >>> q = k = v = torch.randn(1, 2, 5, 8)
    >>> flash_attention_short(q, k, v, torch.tensor([3])).shape
    torch.Size([1, 2, 5, 8])
    """
    _check(q, k, v, lengths)
    if k.shape[2] > SHORT_T_MAX:
        raise ValueError(f"flash_attention_short takes Tk <= {SHORT_T_MAX}")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, lengths, scale)
    return _ShortAttention.apply(q, k, v, lengths, scale)


flash_attention_short.launches = 0
flash_attention.launches = 0
flash_attention_fwd_lse.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
