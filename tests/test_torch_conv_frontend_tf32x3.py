"""The conv frontend kernel's f32 numerics and launch plan, on the CPU.

On the card, ``csrc/conv_frontend.cu`` runs each f32 product of layers 1-6
(K = 1536 or 1024 at lv60's C = 512) as three TF32 tensor-core products:
every operand x is split into big = cvt.rna.tf32(x) and small =
cvt.rna.tf32(x - big), each k step of 8 is summed on its own (small.big +
big.small, then big.big) and added to the running sum in f32; layer 0
(K = 10) runs on f32 FMAs. This file emulates that route in torch with the
attention tests' split (``tests/test_torch_flash_backward_tf32x3.py``; the
tensor cores' truncation inside a k step is not modelled: the card tests
hold the kernel itself) and holds each layer, and the seven-layer chain, to
a float64 reference at lv60 width: within the kernel's f32 tolerance on the
card (``TOL_F32``, max abs error after LayerNorm and GELU), and within
``FACTOR`` of plain f32's own error (these tests read 1.0x to 1.2x, 2.1e-6
to 2.7e-6 a layer, on a CPU). One TF32 product per product instead misses
``TOL_F32`` at a single layer (1.3e-3 to 1.8e-3).

The launch plan is checked with a stand-in for the ctypes library: seven
calls with each layer's (T_in, C_in, k, s, T_out, C), 16-byte aligned
operands for layers 1-6, a contiguous wav taken at any offset and length,
and a wav whose rows are not contiguous copied first.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from svt_speechbrain_tpu_torch.ops import conv_frontend as cf
from tests.test_torch_flash_backward_tf32x3 import (FACTOR, matmul, mm3,
                                                    tf32_once)
from tests.torch_threads import two_torch_threads  # noqa: F401

TOL_F32 = 1e-3   # TOL[("conv_frontend", "f32")] in chip_smoke.py
C = 512          # lv60
EPS = 1e-5


def _layers(seed, c=C):
    """Seven packed layers with the lv60 schedule and weights of unit
    output scale (std 1/sqrt(K)), a small bias and LayerNorm affine."""
    rng = np.random.default_rng(seed)
    ws, bs, gs, betas = [], [], [], []
    for i, k in enumerate(cf.KERNELS):
        cin = 1 if i == 0 else c
        ws.append(torch.from_numpy((rng.normal(size=(c, cin, k))
                                    / math.sqrt(k * cin)).astype(np.float32)))
        bs.append(torch.from_numpy((0.1 * rng.normal(size=c))
                                   .astype(np.float32)))
        gs.append(torch.from_numpy((1 + 0.1 * rng.normal(size=c))
                                   .astype(np.float32)))
        betas.append(torch.from_numpy((0.1 * rng.normal(size=c))
                                      .astype(np.float32)))
    return cf.pack_weights(ws, bs, gs, betas, torch.float32)


def _layer(x, layer, mm):
    """``cf._reference_layer`` with its product taken by ``mm(a, b, 8)``,
    in the dtype of x (f64 for the reference). Layer 0 (C_in = 1) runs on
    f32 FMAs in the kernel: a plain product."""
    b = x.shape[0]
    win = x.unfold(1, layer.kernel, layer.stride)
    a = win.transpose(-1, -2).reshape(b, win.shape[1], -1)
    wt = layer.wt.to(x.dtype).t()
    h = (matmul if x.shape[-1] == 1 else mm)(a, wt, 8)
    h = h + layer.bias.to(x.dtype)
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    y = ((h - mean) * torch.rsqrt(var + EPS) * layer.gamma.to(x.dtype)
         + layer.beta.to(x.dtype))
    return F.gelu(y)


def _errors(want, *gots):
    return [(g.double() - want).abs().max().item() for g in gots]


@pytest.mark.parametrize("index", [1, 5])    # K = 1536 and K = 1024
def test_tf32x3_layer_matches_f64(index):
    """One layer at lv60 width, 2 rows of 40 frames, on GELU-like inputs."""
    layer = _layers(7)[index]
    rng = np.random.default_rng(11 + index)
    tin = 2 * 40 + layer.kernel - 2
    x = F.gelu(torch.from_numpy(rng.normal(size=(2, tin, C))
                                .astype(np.float32)))
    want = _layer(x.double(), layer, matmul)
    got = _layer(x, layer, mm3)
    assert got.shape == (2, 40, C)
    plain = cf._reference_layer(x, layer, EPS)
    single = _layer(x, layer, tf32_once)
    err, plain_err, single_err = _errors(want, got, plain, single)
    assert err <= TOL_F32 and err <= FACTOR * plain_err, (err, plain_err)
    # the split is what buys it: one TF32 product per product misses
    assert single_err > TOL_F32, single_err
    assert (got - plain).abs().max().item() <= TOL_F32


def test_tf32x3_frontend_matches_f64():
    """The seven layers chained at lv60 width on 2 x 4000 samples (T_out
    12): the kernel's route within TOL_F32 of float64 and within FACTOR of
    plain f32's error, as the plain version is."""
    packed = _layers(3)
    rng = np.random.default_rng(5)
    wav = torch.from_numpy(rng.normal(size=(2, 4000)).astype(np.float32))
    x, want = wav[..., None], wav[..., None].double()
    for layer in packed:
        x = _layer(x, layer, mm3)
        want = _layer(want, layer, matmul)
    plain = cf.conv_frontend_reference(wav, packed, EPS)
    assert x.shape == plain.shape == (2, cf.output_frames(4000), C)
    err, plain_err = _errors(want, x, plain)
    assert err <= TOL_F32 and err <= FACTOR * plain_err, (err, plain_err)


# ------------------------------------------------------------ launch plan
class _Lib:
    """Stands in for the ctypes library: records each launch's arguments
    and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def svt_conv_ln_gelu(self, *args):
        self.calls.append(args)
        return self.rc


def _plan(wav, packed, lib):
    before = cf.fused_conv_frontend.launches
    out = cf._launch(wav, packed, EPS, lib=lib)
    assert cf.fused_conv_frontend.launches == before + 7
    return out


@pytest.fixture
def no_stream(monkeypatch):
    monkeypatch.setattr(cf._build, "stream_handle", lambda: None)


@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_is_seven_layers(no_stream, c, dtype):
    packed = cf.pack_weights(*zip(*(layer.source for layer in _layers(0, c))),
                             dtype)
    wav = torch.zeros(3, 16123, dtype=dtype)
    lib = _Lib()
    out = _plan(wav, packed, lib)
    assert len(lib.calls) == 7
    tin, cin = 16123, 1
    prev_out = None
    for i, (args, layer) in enumerate(zip(lib.calls, packed)):
        code, x, wt, out_ptr = args[0], args[1], args[2], args[6]
        k, s = cf.KERNELS[i], cf.STRIDES[i]
        tout = (tin - k) // s + 1
        assert code == cf._DTYPE_CODES[dtype]
        assert args[7:15] == (3, tin, cin, k, s, tout, c, EPS)
        assert wt == layer.wt.data_ptr()
        if i == 0:
            assert x == wav.data_ptr()
        else:
            assert x == prev_out          # the previous layer's output
            assert x % 16 == 0 and wt % 16 == 0 and out_ptr % 16 == 0
        prev_out, tin, cin = out_ptr, tout, c
    assert out.data_ptr() == prev_out
    assert out.shape == (3, cf.output_frames(16123), c)


def test_wav_at_an_odd_offset_is_taken_without_a_copy(no_stream):
    """Layer 0 loads samples one by one: a contiguous wav one sample into
    its storage, of odd length, goes to the kernel as it is."""
    packed = _layers(0, 64)
    wav = torch.zeros(3 * 16123 + 1)[1:].view(3, 16123)
    assert wav.data_ptr() % 16 != 0
    lib = _Lib()
    _plan(wav, packed, lib)
    assert lib.calls[0][1] == wav.data_ptr()


def test_wav_with_strided_rows_is_copied(no_stream):
    packed = _layers(0, 64)
    wav = torch.zeros(3, 16124)[:, 1:]
    assert not wav.is_contiguous()
    lib = _Lib()
    _plan(wav, packed, lib)
    assert lib.calls[0][1] != wav.data_ptr()
    assert lib.calls[0][7:9] == (3, 16123)


def test_misaligned_layer_input_and_kernel_errors_raise(no_stream):
    layer = _layers(0, 64)[1]
    x = torch.zeros(2 * 100 * 64 + 1)[1:].view(2, 100, 64)
    with pytest.raises(ValueError, match="16-byte"):
        cf._launch_layer(_Lib(), x, layer, EPS)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        cf._launch(torch.zeros(1, 800), _layers(0, 64), EPS, lib=_Lib(rc=1))
