"""Int8 (a8w8) matrix product for the serving path (port of
``svt_speechbrain_tpu/ops/quant.py``).

Weights are symmetric per-output-channel int8 (``quantize_weight``, done
once by ``models/quantize.py``); activations are quantized on the fly per
token (last axis) inside the product, so no calibration data is needed:

    scale = max(amax_k |x|, 1e-8) / 127
    x8    = clip(round(x / scale), -127, 127)        (round half to even)
    out   = ((x8 @ w8 in exact int32) * scale) * w_scale  → x.dtype

``int8_matmul`` is the wrapper. On a CUDA tensor it launches
``csrc/quant_matmul.cu`` (or raises), on a CPU tensor it runs
``int8_matmul_plain``, the plain PyTorch version of the same function and
the tests' oracle. Inference only: gradients through the rounding are
undefined, so an input that requires grad raises.

The kernel replaces the TPU kernel ``ops/quant.py:121 int8_matmul_fused``
(body ``_qmm_kernel``), which quantizes a row block once into VMEM scratch
and reuses it across its in-order column grid. Here a block owns 128 rows x
128 columns and multiplies on ``wgmma`` (s8 x s8 → s32); the blocks of a
cluster along N share one row block, each quantizing a share of K into a
scratch in device memory that all of them then stream (``launch_plan``).
Operations bound it at ffn1 and ffn2 (2·M·K·N against the int8 tensor-core
peak), bytes at the narrower products; the design's own limits are written
in the CUDA source. The kernel wants the weights as (N, K) with K
contiguous: ``pack_weight`` transposes the tree's (K, N) once, and
``PackedWeight`` keeps that copy beside a module's buffer.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from svt_speechbrain_tpu_torch.ops import _build

ALIGN = 128                  # K and N must be multiples of this on the card
SHARED_LIMIT = 232448        # bytes of shared memory a block may take
BLOCK_M = BLOCK_N = 128      # rows and columns a block owns
BLOCK_K = 128                # k a staged slab (bytes)
MAX_K = 133120               # 127 * 127 * K stays below 2^31 in s32
CLUSTERS = (8, 4, 2, 1)      # blocks a cluster along N, the widest first
# the kernel's dynamic shared memory: 1024 bytes of alignment, its ring's
# 3 stages (128 rows of int8 x and 128 rows of W^T, 128 bytes each), the
# partial amax of up to 8 ranks, the row scales and the tile's w_scale in
# f32 (`kSmem` in csrc/quant_matmul.cu)
SHARED_BYTES = 1024 + 3 * (BLOCK_M + BLOCK_N) * BLOCK_K \
    + 4 * ((CLUSTERS[0] + 1) * BLOCK_M + BLOCK_N)

_SIGNATURES = {
    "svt_int8_matmul": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "svt_int8_matmul_attributes": [ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int)]}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(amax, eps):
    """``max(amax, eps) / 127`` as a true f32 division on every device: the
    divisor is a tensor, because PyTorch divides a CUDA tensor by a Python
    number as a multiply by its rounded reciprocal, which moves the scale
    by an ulp and some integers with it."""
    return torch.clamp(amax, min=eps) / torch.full_like(amax, 127.0)


def quantize_weight(w, eps=1e-8):
    """Symmetric per-output-channel int8 quantization of an (in, out)
    matrix: ``(w8, scale)`` with ``w ≈ w8 * scale`` and ``scale`` (out,)
    in f32. Any ndim: the scale is over the last axis, reducing all leading
    axes.

    Example
    -------
    >>> import torch
    >>> w8, scale = quantize_weight(torch.tensor([[1.0, -4.0], [0.5, 2.0]]))
    >>> w8.tolist(), w8.dtype, scale.shape
    ([[127, -127], [64, 64]], torch.int8, torch.Size([2]))
    """
    w = w.detach().float()
    scale = _scale(w.abs().amax(dim=tuple(range(w.dim() - 1))), eps)
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w8, scale


def quantize_activation(x, eps=1e-8):
    """Dynamic symmetric per-token int8: ``(x8, scale)`` with
    ``x ≈ x8 * scale``; ``scale`` is f32 of shape ``x.shape[:-1] + (1,)``."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True), eps)
    x8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x8, scale


def int8_matmul_plain(x, w8, w_scale, out_dtype=None):
    """The plain version: quantize, an exact integer product, the
    epilogue in f32 in the order ``(acc * x_scale) * w_scale``, one cast to
    ``out_dtype`` (default ``x.dtype``). The product runs in float64, which
    holds every partial sum exactly on both devices (|sum| ≤ 127·127·K <
    2^53; an f32 product is not exact past K = 1040, and integer matmul does
    not exist on CUDA)."""
    x8, x_scale = quantize_activation(x)
    acc = torch.matmul(x8.double(), w8.double())
    y = (acc.float() * x_scale) * w_scale.float()
    return y.to(out_dtype or x.dtype)


def pack_weight(w8):
    """The kernel's weight operand: (K, N) int8 → (N, K) with K contiguous
    (the B fragment of the tensor-core instruction reads 4 consecutive k of
    one column). Done once per weight, not per call."""
    return w8.t().contiguous()


class PackedWeight:
    """A module's packed copy of one int8 weight: made at the first call on
    the card and again only when the buffer moves or changes."""

    def __init__(self):
        self._key = None
        self._packed = None

    def __call__(self, w8):
        if w8.device.type != "cuda":
            return None
        key = (id(w8), w8.data_ptr(), w8._version)
        if key != self._key:
            self._packed, self._key = pack_weight(w8), key
        return self._packed

    def __deepcopy__(self, memo):
        return PackedWeight()      # a copy of the module packs its own


class Plan(NamedTuple):
    """One launch of the kernel: block (i, j) of ``grid`` owns rows
    [128 j, 128 j + 128) x columns [128 i, 128 i + 128); ``cluster`` blocks
    along N share their rows, block rank r quantizing the share
    [r K / cluster, (r + 1) K / cluster) of K into ``workspace`` (int8: for
    each group of ``cluster`` column tiles, the rows padded to whole blocks,
    in the kernel's swizzled 128 x 128 slabs)."""
    cluster: int
    grid: tuple
    workspace: tuple


def launch_plan(m, k, n, cluster=None):
    """The kernel's ``Plan`` for an (M, K) x (K, N) product: the widest
    cluster that divides the column tiles (``cluster`` overrides it, for
    the tuning script's variants).

    Example
    -------
    >>> p = launch_plan(1992, 1024, 4096)
    >>> p.cluster, p.grid, p.workspace
    (8, (32, 16), (4, 2048, 1024))
    >>> launch_plan(1992, 4096, 1024)[:2]
    (8, (8, 16))
    """
    if k > MAX_K:
        raise ValueError(f"K={k} is too deep for the int8 kernel: its s32 "
                         f"sums hold 127 * 127 * K only up to K={MAX_K}")
    row_blocks = -(-m // BLOCK_M)
    tiles = n // BLOCK_N
    if cluster is None:
        cluster = next(c for c in CLUSTERS if tiles % c == 0)
    return Plan(cluster, (tiles, row_blocks),
                (tiles // cluster, row_blocks * BLOCK_M, k))


def int8_kernel_attributes(lib=None):
    """Each instantiation of the kernel on the current card (``lib``:
    another build of ``csrc/quant_matmul.cu``): dicts with ``dtype``,
    ``registers`` (per thread), ``local_bytes`` (per thread: 0 means no
    spills), ``smem_bytes`` (dynamic, per block), ``blocks_per_sm`` and
    ``clusters`` ({size: clusters of that many blocks resident on the card
    at once})."""
    lib = lib or _build.load("quant_matmul", _SIGNATURES)
    rows = []
    for dtype, code in _DTYPE_CODES.items():
        clusters = {}
        for size in CLUSTERS:
            out = (ctypes.c_int * 5)()
            _build.check(lib.svt_int8_matmul_attributes(code, size, out),
                         "int8_matmul attributes")
            clusters[size] = out[4]
        rows.append(dict(dtype=str(dtype).split(".")[-1], registers=out[0],
                         local_bytes=out[1], smem_bytes=out[2],
                         blocks_per_sm=out[3], clusters=clusters))
    return rows


def _check(x, w8, w_scale):
    if x.requires_grad or w_scale.requires_grad:
        raise ValueError("int8_matmul is inference only: an input requires "
                         "grad")
    if w8.dtype != torch.int8 or w8.dim() != 2:
        raise ValueError(f"w8 must be a (K, N) int8 matrix, got "
                         f"{w8.dtype} {tuple(w8.shape)}")
    if x.shape[-1] != w8.shape[0] or w_scale.shape != (w8.shape[1],):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, w8 "
                         f"{tuple(w8.shape)}, w_scale {tuple(w_scale.shape)}")
    if not (x.device == w8.device == w_scale.device):
        raise ValueError("x, w8 and w_scale must lie on one device")


def _launch(x, w8, w_scale, w8t, debug, lib=None, plan=None,
            out_dtype=None):
    k, n = w8.shape
    if k % ALIGN or n % ALIGN:
        raise ValueError(f"the int8 kernel needs K and N to be multiples of "
                         f"{ALIGN}; got K={k}, N={n}")
    out_dtype = out_dtype or x.dtype
    if (x.dtype not in _DTYPE_CODES or w_scale.dtype not in _DTYPE_CODES
            or out_dtype not in _DTYPE_CODES):
        raise ValueError(f"the int8 kernel takes f32 or bf16 activations, "
                         f"scales and outputs, not {x.dtype} / "
                         f"{w_scale.dtype} / {out_dtype}")
    if not x.is_contiguous() or not w_scale.is_contiguous():
        raise ValueError("the int8 kernel needs contiguous x and w_scale")
    if w8t is None:
        w8t = pack_weight(w8)
    if (w8t.shape != (n, k) or w8t.dtype != torch.int8
            or not w8t.is_contiguous() or w8t.device != x.device):
        raise ValueError("w8t must be pack_weight(w8) on x's device")
    if x.data_ptr() % 16 or w8t.data_ptr() % 16:
        raise ValueError("the int8 kernel needs 16-byte aligned operands")
    m = x.numel() // k
    out = torch.empty(*x.shape[:-1], n, device=x.device, dtype=out_dtype)
    x8 = xs = None
    if debug:
        x8 = torch.empty(x.shape, device=x.device, dtype=torch.int8)
        xs = torch.empty(*x.shape[:-1], 1, device=x.device,
                         dtype=torch.float32)
    if m == 0:
        return out, x8, xs
    if plan is None:
        plan = launch_plan(m, k, n)
    scratch = torch.empty(plan.workspace, device=x.device, dtype=torch.int8)
    lib = lib or _build.load("quant_matmul", _SIGNATURES)
    err = lib.svt_int8_matmul(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w8t.data_ptr(),
        w_scale.data_ptr(), _DTYPE_CODES[w_scale.dtype], out.data_ptr(),
        _DTYPE_CODES[out_dtype],
        x8.data_ptr() if debug else None, xs.data_ptr() if debug else None,
        scratch.data_ptr(), scratch.numel(), m, k, n, plan.cluster,
        _build.stream_handle())
    _build.check(err, "int8_matmul kernel launch")
    int8_matmul.launches += 1
    return out, x8, xs


def _dispatch(x, w8, w_scale, w8t, debug, out_dtype=None):
    _check(x, w8, w_scale)
    if x.device.type == "cpu":
        out = int8_matmul_plain(x, w8, w_scale, out_dtype)
        return (out, *quantize_activation(x)) if debug else (out, None, None)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, w8, w_scale, w8t, debug, out_dtype=out_dtype)


def int8_matmul(x, w8, w_scale, w8t=None, out_dtype=None):
    """``x @ dequant(w8)`` through int8: x float (any leading axes,
    contraction over the last), w8 (K, N) int8, w_scale (N,) →
    ``out_dtype`` (default x.dtype; the kernel writes it from its f32
    epilogue, so bf16 input can give an f32 result never rounded to bf16).

    CUDA tensor: one kernel launch (``int8_matmul.launches`` counts it) when
    K and N are multiples of 128, else ``ValueError``; ``w8t`` is
    ``pack_weight(w8)`` if the caller keeps it (it is made per call
    otherwise). CPU tensor: the plain version.

    Example
    -------
    >>> import torch
    >>> gen = torch.Generator().manual_seed(0)
    >>> w = torch.randn(64, 32, generator=gen)
    >>> x = torch.randn(4, 64, generator=gen)
    >>> w8, scale = quantize_weight(w)
    >>> err = (int8_matmul(x, w8, scale) - x @ w).abs().max()
    >>> bool(err / (x @ w).std() < 0.1)
    True
    """
    return _dispatch(x, w8, w_scale, w8t, debug=False, out_dtype=out_dtype)[0]


int8_matmul.launches = 0


def int8_matmul_quantized(x, w8, w_scale, w8t=None):
    """``int8_matmul`` that also returns what it quantized:
    ``(out, x8, x_scale)``, x8 int8 of x's shape and x_scale f32 of shape
    ``x.shape[:-1] + (1,)``. On the card these are the kernel's own
    integers and scales (a debug output of the same launch), so a check can
    hold them bit for bit against ``quantize_activation``."""
    return _dispatch(x, w8, w_scale, w8t, debug=True)
