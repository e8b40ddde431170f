"""wav2vec2 conv frontend on the card (port of
``svt_speechbrain_tpu/ops/conv_frontend.py``).

The seven-layer strided-conv extractor (k=(10,3,3,3,3,2,2),
s=(5,2,2,2,2,2,2), per-frame LayerNorm + GELU after every layer, "layer"
norm mode) runs as seven launches of ``csrc/conv_frontend.cu``, one per
layer; see that file for the design. ``fused_conv_frontend`` is the
wrapper: on a CUDA tensor it launches the kernel (or raises), on a CPU
tensor it runs ``conv_frontend_reference``, the plain PyTorch version of
the same function, which is also the tests' oracle.

Both compute each layer from the same packed weights (``pack_weights``):
the conv as a product over k * C_in window elements accumulated in f32,
plus bias, LayerNorm and GELU in f32, one cast to the working dtype. In
f32 this equals the JAX package's XLA conv path (exact-erf GELU).

Gradients: each packed layer keeps the tensors it was packed from
(``FrontendLayer.source``). The kernel path is an autograd Function whose
backward recomputes the plain version from those tensors and takes its VJP
w.r.t. the wav and the weights (the JAX package's recompute VJP,
``ops/conv_frontend.py:278-304``); the CPU path repacks from them, so both
send gradients to the module's own conv and LayerNorm parameters.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from svt_speechbrain_tpu_torch.ops import _build

KERNELS = (10, 3, 3, 3, 3, 2, 2)
STRIDES = (5, 2, 2, 2, 2, 2, 2)
TOTAL_STRIDE = 320
RECEPTIVE = 400                       # samples per output frame
KERNEL_CHANNELS = (64, 128, 256, 512)  # C the CUDA kernel is built for

_SIGNATURES = {"svt_conv_ln_gelu": [ctypes.c_int] + [ctypes.c_void_p] * 6
               + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
               "svt_conv_frontend_attributes": [ctypes.c_int] * 3
               + [ctypes.POINTER(ctypes.c_int)]}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class FrontendLayer:
    wt: torch.Tensor      # (C, k * C_in), working dtype; K index = tap*C_in + c
    bias: torch.Tensor    # (C,) f32
    gamma: torch.Tensor   # (C,) f32
    beta: torch.Tensor    # (C,) f32
    kernel: int
    stride: int
    # (conv weight, conv bias or None, LN scale, LN bias) as packed: the
    # tensors the backward sends gradients to
    source: tuple


def _layers(conv_weights, conv_biases, ln_scales, ln_biases, dtype, grad):
    layers = []
    for w, b, g, be, k, s in zip(conv_weights, conv_biases, ln_scales,
                                 ln_biases, KERNELS, STRIDES):
        source = (w, b, g, be)
        if not grad:
            w, b, g, be = (None if t is None else t.detach() for t in source)
        c = w.shape[0]
        wt = w.permute(0, 2, 1).reshape(c, -1)
        bias = (torch.zeros(c, device=w.device) if b is None else b.float())
        layers.append(FrontendLayer(
            wt=wt.to(dtype).contiguous(), bias=bias.contiguous(),
            gamma=g.float().contiguous(), beta=be.float().contiguous(),
            kernel=k, stride=s, source=source))
    return tuple(layers)


def pack_weights(conv_weights, conv_biases, ln_scales, ln_biases, dtype):
    """Per-layer kernel operands from torch-layout conv weights
    (C, C_in, k) (``ops/conv_frontend.py:136`` on the TPU): W^T with the
    K axis ordered (tap, c_in) so an output frame's window is one
    contiguous channel-last span; f32 bias and LayerNorm affine. The
    operands are detached; each layer keeps its source tensors."""
    return _layers(conv_weights, conv_biases, ln_scales, ln_biases, dtype,
                   grad=False)


def _repack(packed, dtype):
    """``packed`` packed again from its source tensors, with autograd."""
    return _layers(*zip(*(layer.source for layer in packed)), dtype,
                   grad=True)


def output_frames(num_samples):
    return (num_samples - RECEPTIVE) // TOTAL_STRIDE + 1


def _gelu(y, dtype):
    if dtype == torch.bfloat16:
        return F.gelu(y, approximate="tanh")
    return F.gelu(y)


def _reference_layer(x, layer, eps):
    """x (B, T_in, C_in) → (B, T_out, C): the plain version of one launch."""
    b = x.shape[0]
    win = x.unfold(1, layer.kernel, layer.stride)      # (B, T_out, C_in, k)
    a = win.transpose(-1, -2).reshape(b, win.shape[1], -1).float()
    h = a @ layer.wt.float().t() + layer.bias
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    y = (h - mean) * torch.rsqrt(var + eps) * layer.gamma + layer.beta
    return _gelu(y, x.dtype).to(x.dtype)


def conv_frontend_reference(wav, packed, eps=1e-5):
    """Plain PyTorch version: wav (B, T) → frames (B, F, C)."""
    x = wav[..., None]
    for layer in packed:
        x = _reference_layer(x, layer, eps)
    return x


def _check(wav, packed):
    if wav.dim() != 2:
        raise ValueError(f"wav must be (B, T), got {tuple(wav.shape)}")
    if wav.shape[1] < RECEPTIVE:
        raise ValueError(f"wav needs at least {RECEPTIVE} samples")
    if len(packed) != len(KERNELS):
        raise ValueError("packed weights must hold seven layers")
    for layer in packed:
        if layer.wt.dtype != wav.dtype or layer.wt.device != wav.device:
            raise ValueError("packed weights must match the wav's dtype and "
                             "device (pack_weights with that dtype)")


def _launch_layer(lib, x, layer, eps):
    """One launch: x (B, T_in, C_in), or the wav (B, T) for layer 0, →
    (B, T_out, C). Layer 0 takes its rows at any alignment (its kernel
    loads samples one by one); layers 1-6 copy 16-byte pieces and take only
    16-byte aligned operands, which the wrapper's own outputs and packed
    weights are."""
    b, tin = x.shape[:2]
    cin = 1 if x.dim() == 2 else x.shape[2]
    c = layer.wt.shape[0]
    if cin > 1 and any(t.data_ptr() % 16 for t in (x, layer.wt)):
        raise ValueError("conv_frontend layers 1-6 need 16-byte aligned "
                         "inputs and weights")
    tout = (tin - layer.kernel) // layer.stride + 1
    out = torch.empty(b, tout, c, device=x.device, dtype=x.dtype)
    err = lib.svt_conv_ln_gelu(
        _DTYPE_CODES[x.dtype], x.data_ptr(), layer.wt.data_ptr(),
        layer.bias.data_ptr(), layer.gamma.data_ptr(),
        layer.beta.data_ptr(), out.data_ptr(), b, tin, cin, layer.kernel,
        layer.stride, tout, c, eps, _build.stream_handle())
    _build.check(err, "conv_frontend kernel launch")
    fused_conv_frontend.launches += 1
    return out


def _launch(wav, packed, eps, lib=None):
    """Seven kernel launches, one per layer (``lib``: another build of
    ``csrc/conv_frontend.cu``, for timing variants). A wav whose rows are
    not contiguous is copied; a contiguous one is taken as it is, at any
    offset or length."""
    if wav.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA frontend takes f32 or bf16, not {wav.dtype}")
    c = packed[0].wt.shape[0]
    if c not in KERNEL_CHANNELS or any(l.wt.shape[0] != c for l in packed):
        raise ValueError(f"the CUDA frontend needs uniform C in "
                         f"{KERNEL_CHANNELS}, got {[l.wt.shape[0] for l in packed]}")
    lib = lib or _build.load("conv_frontend", _SIGNATURES)
    x = wav.contiguous()
    for layer in packed:
        x = _launch_layer(lib, x, layer, eps)
    return x


def frontend_kernel_attributes(lib=None):
    """Each instantiation of the frontend kernels on the current card
    (``lib``: another build of ``csrc/conv_frontend.cu``): dicts with
    ``kernel`` ("layer 0" or "layers 1-6"), ``dtype``, ``c``, ``registers``
    (per thread), ``local_bytes`` (per thread: 0 means no spills),
    ``smem_bytes`` (dynamic, per block) and ``blocks_per_sm`` (resident at
    256 threads a block)."""
    lib = lib or _build.load("conv_frontend", _SIGNATURES)
    rows = []
    for first, kernel in ((1, "layer 0"), (0, "layers 1-6")):
        for dtype, code in _DTYPE_CODES.items():
            for c in KERNEL_CHANNELS:
                out = (ctypes.c_int * 4)()
                _build.check(lib.svt_conv_frontend_attributes(code, c, first,
                                                              out),
                             "conv_frontend attributes")
                rows.append(dict(kernel=kernel,
                                 dtype=str(dtype).split(".")[-1], c=c,
                                 registers=out[0], local_bytes=out[1],
                                 smem_bytes=out[2], blocks_per_sm=out[3]))
    return rows


class _FusedFrontend(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain version from
    the source tensors and takes its VJP (``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, wav, packed, eps, *sources):
        ctx.save_for_backward(wav, *sources)
        ctx.eps = eps
        return _launch(wav, packed, eps)

    @staticmethod
    def backward(ctx, grad):
        wav, *sources = ctx.saved_tensors
        wanted = ctx.needs_input_grad
        with torch.enable_grad():
            wav_ = wav.detach().requires_grad_(wanted[0])
            src = [None if t is None else t.detach().requires_grad_(w)
                   for t, w in zip(sources, wanted[3:])]
            layers = _layers(src[0::4], src[1::4], src[2::4], src[3::4],
                             wav.dtype, grad=True)
            out = conv_frontend_reference(wav_, layers, ctx.eps)
            inputs = [t for t in [wav_, *src]
                      if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, grad))
        return (next(grads) if wanted[0] else None, None, None,
                *(next(grads) if t is not None and w else None
                  for t, w in zip(src, wanted[3:])))


def fused_conv_frontend(wav, packed, eps=1e-5):
    """wav (B, T) → frames (B, F, C), F = (T - 400) // 320 + 1.

    CUDA tensor: seven kernel launches (the launch counter
    ``fused_conv_frontend.launches`` counts each), differentiable through
    the recompute backward. CPU tensor: the plain version, repacked from
    the source tensors so that gradients reach them.

    Example
    -------
    >>> import torch
    >>> gen = torch.Generator().manual_seed(0)
    >>> c = 64
    >>> ws = [0.1 * torch.randn(c, 1 if i == 0 else c, k, generator=gen)
    ...       for i, k in enumerate(KERNELS)]
    >>> ones, zeros = [torch.ones(c)] * 7, [torch.zeros(c)] * 7
    >>> packed = pack_weights(ws, zeros, ones, zeros, torch.float32)
    >>> fused_conv_frontend(torch.randn(2, 1600, generator=gen), packed).shape
    torch.Size([2, 4, 64])
    """
    _check(wav, packed)
    if wav.device.type == "cpu":
        return conv_frontend_reference(wav, _repack(packed, wav.dtype), eps)
    if wav.device.type != "cuda":
        raise ValueError(f"unsupported device {wav.device}")
    sources = [t for layer in packed for t in layer.source]
    return _FusedFrontend.apply(wav, packed, eps, *sources)


fused_conv_frontend.launches = 0


def can_fuse(config, wav):
    """Dispatch predicate (``ops/conv_frontend.py:307`` minus its TPU
    backend and 128-lane tests): "layer" norm mode, the wav2vec2
    kernel/stride schedule, uniform channels the CUDA kernel is built for,
    and at least one full receptive field of samples."""
    return (config.feat_extract_norm == "layer"
            and tuple(config.conv_kernel) == KERNELS
            and tuple(config.conv_stride) == STRIDES
            and len(set(config.conv_dim)) == 1
            and config.conv_dim[0] in KERNEL_CHANNELS
            and wav.dim() == 2 and wav.shape[1] >= RECEPTIVE)
