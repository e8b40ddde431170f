"""The int8 kernel's launch plan and the order it computes in, on the CPU.

The kernel (``csrc/quant_matmul.cu``) runs only on the card. What it rests
on is checked here: the wrapper's plan, through a stand-in for the ctypes
library (every output tile owned once, the K shares of a cluster covering K
once, the shared memory and the scratch it is given), and the kernel's
order emulated in torch (each row's amax over the whole of K from partial
maxima, the division-free quantizer with its fallback to the true division,
share by share, s32 sums slab by slab), bit for bit against
``quantize_activation`` and ``int8_matmul_plain``.
"""
import numpy as np
import pytest
import torch

from svt_speechbrain_tpu_torch.ops import quant as tq

MAGIC = 12582912.0                  # 1.5 * 2^23: rounds |y| < 2^22 to int
FAR = 0.5 - 2.0 ** -14              # the fast path's distance to a tie
CHUNK = {torch.float32: 4, torch.bfloat16: 8}   # elements in 16 bytes
SERVING = [(1992, 512, 1024), (1992, 1024, 4096), (1992, 4096, 1024),
           (1992, 1024, 1024), (249, 4096, 1024)]
EDGES = [(1, 4096, 1024), (33, 1024, 4096), (129, 512, 1024),
         (1993, 4096, 1024), (65, 3072, 128), (64, 2944, 256)]


class _Lib:
    """Stands in for the ctypes library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def svt_int8_matmul(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(tq._build, "stream_handle", lambda: None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", SERVING + EDGES)
def test_launch_plan_owns_every_tile_once(no_card, m, k, n, dtype):
    x = torch.zeros(m, k, dtype=dtype)
    w8 = torch.zeros(k, n, dtype=torch.int8)
    ws = torch.ones(n)
    lib = _Lib()
    before = tq.int8_matmul.launches
    out, _, _ = tq._launch(x, w8, ws, None, False, lib=lib)
    assert tq.int8_matmul.launches == before + 1
    (args,) = lib.calls
    (code, x_ptr, _, ws_ptr, ws_code, out_ptr, out_code, x8, xs, xq,
     xq_bytes, m_, k_, n_, cluster, _) = args
    plan = tq.launch_plan(m, k, n)
    assert (code, ws_code, out_code) == (tq._DTYPE_CODES[dtype], 0,
                                         tq._DTYPE_CODES[dtype])
    assert (x_ptr, ws_ptr, out_ptr) == (x.data_ptr(), ws.data_ptr(),
                                        out.data_ptr())
    assert x8 is None and xs is None and xq % 16 == 0
    assert (m_, k_, n_, cluster) == (m, k, n, plan.cluster)
    # block (i, j) of the grid owns rows [128 j, 128 j + 128) and columns
    # [128 i, 128 i + 128): one block for each 128 x 128 cell of the output
    tiles, row_blocks = plan.grid
    assert tiles * 128 == n and row_blocks * 128 - 128 < m <= row_blocks * 128
    # the blocks of a cluster quantize shares of K that cover it once, in
    # whole 16-byte chunks of either dtype
    assert tiles % cluster == 0 and k % cluster == 0
    share = k // cluster
    assert share % CHUNK[dtype] == 0
    covered = np.zeros(k, dtype=int)
    for rank in range(cluster):
        covered[rank * share:(rank + 1) * share] += 1
    assert (covered == 1).all()
    # the scratch: for each group of column tiles, the rows padded to whole
    # blocks in 128 x 128 slabs; the kernel indexes ((group * row_blocks +
    # j) * (K / 128) + slab) * 16384 + 128 r + byte
    groups = tiles // cluster
    assert plan.workspace == (groups, row_blocks * 128, k)
    assert xq_bytes == groups * row_blocks * 128 * k
    last = ((groups * row_blocks - 1) * (k // 128) + k // 128 - 1) * 16384 \
        + 127 * 128 + 127
    assert last == xq_bytes - 1
    assert tq.SHARED_BYTES <= tq.SHARED_LIMIT


def fast_quantize(xf, scale, chunk):
    """The kernel's quantizer in f32: y = x * fl(1 / s), rounded by adding
    1.5 * 2^23; a 16-byte chunk with any y within 2^-14 of a half-integer
    (or not finite) takes rint(x / s) with the true division instead."""
    r = torch.ones_like(scale) / scale
    y = xf * r
    t = (y + MAGIC) - MAGIC
    hard = ~((y - t).abs() < FAR)
    lead = xf.shape[:-1]
    hard = hard.reshape(*lead, -1, chunk).any(-1, keepdim=True) \
        .expand(*lead, xf.shape[-1] // chunk, chunk).reshape(xf.shape)
    exact = torch.clamp(torch.round(xf / scale), -127, 127)
    return torch.where(hard, exact, t).to(torch.int8), hard


def emulate(x, w8, w_scale, cluster):
    """The kernel's order for one call: per 128-row block, each rank's
    partial amax over its share of K, their max, the scale; each share
    quantized on its own with that scale; s32 sums over 128-k slabs in
    order; the f32 epilogue. Returns (out, x8, scale, largest |partial
    sum|)."""
    m, k = x.shape
    share = k // cluster
    xf = x.float()
    x8 = torch.empty(m, k, dtype=torch.int8)
    scales = torch.empty(m, 1)
    for m0 in range(0, m, 128):
        rows = xf[m0:m0 + 128]
        partial = torch.stack([rows[:, r * share:(r + 1) * share].abs()
                               .amax(-1) for r in range(cluster)])
        amax = partial.amax(0, keepdim=True).t()
        scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
        scales[m0:m0 + 128] = scale
        for r in range(cluster):
            cols = slice(r * share, (r + 1) * share)
            x8[m0:m0 + 128, cols] = fast_quantize(rows[:, cols], scale,
                                                  CHUNK[x.dtype])[0]
    acc = torch.zeros(m, w8.shape[1], dtype=torch.int64)
    peak = 0
    for k0 in range(0, k, 128):
        acc += x8[:, k0:k0 + 128].long() @ w8[k0:k0 + 128].long()
        peak = max(peak, acc.abs().max().item())
    out = ((acc.float() * scales) * w_scale.float()).to(x.dtype)
    return out, x8, scales, peak


def _rows(rng, m, k, dtype):
    """Normal rows with the cases that pin the quantizer: all zeros (the
    1e-8 floor), exact ties (multiples of amax / 254 with amax 127), the
    amax in the last column, and a row whose amax lies in the last share
    only."""
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[1] = 0.0
    x[4] = rng.integers(-254, 255, size=k) / 2.0
    x[4, 0] = 127.0
    x[2, -1] = 9.0
    x[5, -k // 8:] *= 40.0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_order_is_bit_for_bit(dtype):
    """At ffn2's K 4096 and a ragged M: whole-row amax, quantization share
    by share, s32 sums in slab order give the plain version's integers,
    scales and output bit for bit."""
    rng = np.random.default_rng(8)
    m, k, n = 133, 4096, 256
    x = _rows(rng, m, k, dtype)
    w8, ws = tq.quantize_weight(torch.from_numpy(
        rng.normal(size=(k, n)).astype(np.float32)))
    plan = tq.launch_plan(m, k, 1024)
    assert plan.cluster == 8
    out, x8, scales, peak = emulate(x, w8, ws, plan.cluster)
    want_x8, want_scale = tq.quantize_activation(x)
    assert torch.equal(x8, want_x8) and torch.equal(scales, want_scale)
    assert torch.equal(out, tq.int8_matmul_plain(x, w8, ws))
    assert peak < 2 ** 31


def test_partial_amax_would_quantize_otherwise():
    """The hazard the order guards against: a share quantized with its own
    partial amax, not the whole row's, gives other integers."""
    rng = np.random.default_rng(9)
    x = _rows(rng, 8, 1024, torch.float32)
    share = x[:, :128]
    own, _ = tq.quantize_activation(share)
    whole = tq.quantize_activation(x)[0][:, :128]
    assert not torch.equal(own[5], whole[5])     # amax in the last share
    assert torch.equal(own[4], whole[4])         # amax 127 in this share


def test_division_free_quantizer_matches_the_true_division():
    """y = x * fl(1 / s) decides the integer only where it lies more than
    2^-14 from a half-integer. At exact ties, a few ulp from every tie,
    2^-16 to 2^-12 from it, for uniform |x| <= 127 s, subnormal x and zeros,
    over scales from 1e-30 to 1e30, the result equals rint(x / s), and the
    fallback is taken where it must be."""
    rng = np.random.default_rng(10)
    scales = np.concatenate([
        rng.uniform(1e-3, 10.0, 48), 10.0 ** rng.uniform(-30, 30, 48),
        [1e-8 / 127, 1.0, 3.0 / 127]]).astype(np.float32)
    scale = torch.from_numpy(scales)[:, None]
    half = torch.arange(-127, 127, dtype=torch.float64)[None, :] + 0.5
    ties = (half * scale.double()).float()
    near, up, down = [ties], ties, ties
    for _ in range(8):
        up = torch.nextafter(up, torch.full_like(up, np.inf))
        down = torch.nextafter(down, torch.full_like(down, -np.inf))
        near += [up, down]
    for d in (2.0 ** -16, 2.0 ** -15, 2.0 ** -14, 2.0 ** -13, 2.0 ** -12):
        near += [((half + d) * scale.double()).float(),
                 ((half - d) * scale.double()).float()]
    uniform = rng.uniform(-127, 127, size=(len(scales), 4096))
    x = torch.cat(near + [
        (torch.from_numpy(uniform) * scale.double()).float(),
        torch.full((len(scales), 8), 1e-45), torch.zeros(len(scales), 8)],
        dim=1)
    x = x[:, :x.shape[1] // 8 * 8]
    assert (x.abs() <= 127 * scale * (1 + 2.0 ** -20)).all()
    got, hard = fast_quantize(x, scale, 8)
    want = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    assert torch.equal(got, want)
    n_ties = ties.shape[1] // 8 * 8
    assert hard[:, :n_ties].all()               # every exact tie falls back
    assert hard.float().mean() < 0.6


def test_s32_sums_hold_at_the_deepest_k():
    """|acc| <= 127 * 127 * K stays below 2^31 at the largest K the plan
    takes, and the next multiple of 128 is refused."""
    assert 127 * 127 * tq.MAX_K < 2 ** 31 <= 127 * 127 * (tq.MAX_K + 128)
    assert tq.MAX_K % tq.ALIGN == 0
    tq.launch_plan(1, tq.MAX_K, 128)
    with pytest.raises(ValueError, match="too deep"):
        tq.launch_plan(1, tq.MAX_K + 128, 128)
    worst = torch.full((tq.MAX_K,), 127, dtype=torch.int32)
    assert int((worst * worst).sum(dtype=torch.int32)) == 127 * 127 * tq.MAX_K
