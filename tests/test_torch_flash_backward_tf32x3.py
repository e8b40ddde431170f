"""The numerics of the f32 attention backward kernels, on the CPU.

On the card, ``csrc/flash_attention_bwd.cu`` runs each f32 product of the
dQ and dK/dV programs as three TF32 tensor-core products: every operand x
is split into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and
a.b is taken as small_a.big_b + big_a.small_b + big_a.big_b, summed over a
short chunk of k inside the tensor cores and added to the running sum in
f32: 8 (one k step) for the scores S and dP, 32 (one panel) for dQ, dK and
dV. This file emulates that in torch (``cvt.rna.tf32`` rounds the 13 low
mantissa bits to nearest, ties away from zero; the tensor cores' truncation
inside a chunk is not modelled: the card tests hold the kernels themselves),
runs the backward with it at TINY-like shapes (D 16 and 64, a row of length
0, dropout 0.1 with the port's hash mask), and holds dQ, dK and dV to a
float64 reference: within the kernels' f32 tolerance on the card
(``TRAIN_TOL``, peak-relative), and within ``FACTOR`` of plain f32's own
error on the same inputs. The emulation lives here, not in the package.
"""
import numpy as np
import pytest
import torch

from svt_speechbrain_tpu_torch.ops import flash_attention as fa
from tests.torch_threads import two_torch_threads  # noqa: F401

TRAIN_TOL_F32 = 1e-4    # tests/test_torch_kernels_card.py, chip_smoke.py
# 3xTF32 keeps about 21 of f32's 24 mantissa bits per operand and drops
# small.small (2^-22 of a product); the sums over D and over the keys round
# in f32 on both sides, and dominate. Measured here: 0.31x to 1.31x of plain
# f32's error (3.0e-7 to 5.7e-7 peak-relative), where one TF32 product
# alone is 5.3e-4 to 8.4e-4 away and misses TRAIN_TOL_F32
FACTOR = 4.0
SEED = 2 ** 31 - 2
RATE = 0.1


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: keep 10 explicit mantissa bits, rounding the
    magnitude to nearest with ties away from zero (f32 in, f32 out)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm3(a, b, chunk):
    """a @ b (f32, batched) as the kernels' three TF32 products: each chunk
    of k summed on its own, the chunks added in order in f32 (the products
    of TF32 values are exact in f32)."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=a.dtype)
    for j in range(0, a.shape[-1], chunk):
        k = slice(j, j + chunk)
        out = out + ((a_small[..., k] @ b_big[..., k, :]
                      + a_big[..., k] @ b_small[..., k, :])
                     + a_big[..., k] @ b_big[..., k, :])
    return out


def matmul(a, b, chunk):
    """a @ b in the inputs' dtype, in one piece (the references)."""
    return a @ b


def tf32_once(a, b, chunk):
    """a @ b as one TF32 product per product (what the split avoids)."""
    return tf32_rna(a) @ tf32_rna(b)


def _inputs(b, h, tq, tk, d, lens):
    rng = np.random.default_rng(17 + d)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d),
                               (b, h, tq, d)))
    lengths = torch.tensor(lens)
    out, lse = fa.attention_lse_reference(q, k, v, lengths, None, SEED, RATE)
    delta = (dout * out).sum(-1)
    return q, k, v, dout, lse, delta, lengths


def _backward(q, k, v, dout, lse, delta, lengths, mm):
    """dQ, dK, dV with every product taken by ``mm(a, b, chunk)``, in the
    dtype of the inputs (the kernels' elementwise step, written once for
    all); ``chunk`` is the kernels' k chunk: one k step of 8 over D for S
    and dP, one panel of 32 keys or queries for dQ, dK and dV."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    valid = fa._key_valid(lengths, k.shape[2], q.device)
    mask = fa.attention_dropout_mask(SEED, q.shape[0], q.shape[1], q.shape[2],
                                     k.shape[2], RATE).to(q.dtype)
    s = mm(q, k.transpose(-1, -2), 8)
    p = torch.where(valid, torch.exp(s * scale - lse[..., None]),
                    torch.zeros_like(s))
    dp = mm(dout, v.transpose(-1, -2), 8) * mask
    ds = p * (dp - delta[..., None]) * scale
    return (mm(ds, k, 32), mm(ds.transpose(-1, -2), q, 32),
            mm((p * mask).transpose(-1, -2), dout, 32))


def _peak_err(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


CASES = [  # (B, H, Tq, Tk, D, lengths): TINY's D = 16 and lv60's D = 64
    (3, 2, 70, 150, 16, [150, 0, 41]),
    (3, 2, 96, 130, 64, [130, 0, 65]),
]


@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
@pytest.mark.parametrize("b,h,tq,tk,d,lens", CASES)
def test_tf32x3_backward_matches_f64(b, h, tq, tk, d, lens, grad):
    args = _inputs(b, h, tq, tk, d, lens)
    i = ("dq", "dk", "dv").index(grad)
    want = _backward(*(t.double() if t.is_floating_point() else t
                       for t in args), matmul)[i]
    got = _backward(*args, mm3)[i]
    plain = (fa.attention_bwd_dq_reference(*args[:6], args[6], None, SEED,
                                           RATE),
             *fa.attention_bwd_dkv_reference(*args[:6], args[6], None, SEED,
                                             RATE))[i]
    single = _backward(*args, tf32_once)[i]
    err, plain_err = _peak_err(got, want), _peak_err(plain, want)
    assert torch.isfinite(got).all()
    assert err <= TRAIN_TOL_F32, (err, plain_err)
    assert err <= FACTOR * plain_err, (err, plain_err)
    # the split is what buys it: one TF32 product per product misses
    assert _peak_err(single, want) > TRAIN_TOL_F32
    dead = torch.tensor(lens) == 0
    assert (got[dead] == 0).all()      # a row of length 0: exact zeros


def test_tf32_rna_rounds_half_away_from_zero():
    ulp = 2.0 ** -10                   # TF32's ulp at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 0.0, -0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x).view(torch.int32), want.view(torch.int32))
    # the split keeps about 21 bits: 1/3 to within 2^-22 of itself
    big, small = split(torch.tensor([1.0 / 3.0]))
    assert (big.view(torch.int32) & 0x1FFF).item() == 0
    assert abs((big + small).item() - 1.0 / 3.0) <= 2.0 ** -22 / 3.0


@pytest.mark.parametrize("view", ["offset", "time_stride"])
def test_backward_wrappers_name_misaligned_rows(view):
    """The rule the card's wrappers enforce before a launch (the kernels
    copy 16-byte pieces): checked here on CPU tensors, which run the plain
    versions and never reach it."""
    if view == "offset":
        t = torch.zeros(1 * 2 * 8 * 64 + 1)[1:].view(1, 2, 8, 64)
    else:
        t = torch.zeros(1, 2, 8, 17)[..., :16]
    assert fa._misaligned(t) is not None
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_aligned(t)
    copy = fa._aligned(t)
    assert fa._misaligned(copy) is None and torch.equal(copy, t)
    fine = torch.zeros(2, 8, 3, 64).transpose(1, 2)     # (B, T, H, D) view
    assert fa._misaligned(fine) is None and fa._aligned(fine) is fine


@pytest.mark.parametrize("view", ["offset", "time_stride"])
@pytest.mark.parametrize("operand", [0, 1, 2])
def test_forward_launch_hands_the_kernel_aligned_rows(monkeypatch, view,
                                                      operand):
    """The forward (kernels 2, 3, 3b) copies rows in 16-byte pieces too: its
    launch replaces a q, k or v whose rows are not 16-byte aligned by an
    aligned copy and passes aligned ones through. Checked on the CPU with a
    stand-in library that records the pointers and strides it is given."""
    calls = []

    class Lib:
        @staticmethod
        def svt_flash_attention_fwd(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fa, "_check_card", lambda *ts: None)
    monkeypatch.setattr(fa._build, "load", lambda *a, **k: Lib)
    monkeypatch.setattr(fa._build, "stream_handle", lambda: None)
    qkv = [torch.zeros(2, 3, 8, 16) for _ in range(3)]
    if view == "offset":
        qkv[operand] = torch.zeros(2 * 3 * 8 * 16 + 1)[1:].view(2, 3, 8, 16)
    else:
        qkv[operand] = torch.zeros(2, 3, 8, 17)[..., :16]
    assert fa._misaligned(qkv[operand]) is not None
    fa._launch_fwd(*qkv, None, None, None)
    (args,) = calls
    for i, t in enumerate(qkv):
        ptr, strides = args[1 + i], args[12 + 3 * i:15 + 3 * i]
        assert ptr % 16 == 0
        assert all(st * 4 % 16 == 0 for st in strides), strides
        assert (ptr == t.data_ptr()) == (i != operand)
