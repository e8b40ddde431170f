"""The port's CUDA kernels against their plain versions, on the card.

Card-only: every test here carries the ``cuda`` marker and skips without a
CUDA device (decided in the ``cuda_device`` fixture). The file imports
torch and the port only (no JAX), so it also runs on a machine with a card
and no JAX, without the repository's JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_card.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from svt_speechbrain_tpu_torch import ops
from svt_speechbrain_tpu_torch.flagship import build_modules
from svt_speechbrain_tpu_torch.convert_jax import init_params, load_jax_params
from svt_speechbrain_tpu_torch.inference import BatchedAMTTranscriber
from svt_speechbrain_tpu_torch.models.wav2vec2 import (ConvFeatureExtractor,
                                                       Wav2Vec2Config)
from svt_speechbrain_tpu_torch.ops import conv_frontend as cf
from svt_speechbrain_tpu_torch.ops import flash_attention as fa
from svt_speechbrain_tpu_torch.ops import quant
from svt_speechbrain_tpu_torch.ops import transducer_lattice as tl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _extractor(c, seed):
    cfg = Wav2Vec2Config(conv_dim=(c,) * 7)
    tree = init_params(cfg, torch.Generator().manual_seed(seed))
    holder = torch.nn.Module()
    holder.feature_extractor = ConvFeatureExtractor(cfg)
    load_jax_params({"wav2vec2": {"feature_extractor": tree["wav2vec2"]
                                  ["encoder"]["feature_extractor"]}}, holder)
    return holder.feature_extractor


# tolerances as in chip_smoke.py: f32 differs by summation order and erff;
# bf16 by a few ulp of the last layer's bf16 output. Cases: (C, wav shape,
# view): a ragged length, chunked serving's batch, the 30 s song window, a
# wav one sample into its storage (layer 0 takes it as it is); C 64 and 256
# run the same kernels with narrower warp tiles
FRONTEND_CASES = [(128, (2, 16123), "plain"), (512, (2, 16123), "plain"),
                  (512, (8, 80000), "plain"), (512, (1, 480000), "plain"),
                  (512, (3, 16123), "offset"), (64, (2, 16123), "plain"),
                  (256, (3, 16123), "offset")]


def _frontend_wav(device, shape, view, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    n = shape[0] * shape[1]
    flat = torch.randn(n + 1, generator=gen, device=device).to(dtype)
    return flat[1:].view(shape) if view == "offset" else flat[:n].view(shape)


@pytest.mark.parametrize("c,shape,view", FRONTEND_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 6.25e-2)])
def test_conv_frontend_kernel_matches_plain(cuda_device, c, shape, view,
                                            dtype, tol):
    ext = _extractor(c, 0).to(cuda_device)
    wav = _frontend_wav(cuda_device, shape, view, dtype, 1)
    packed = ext.packed(dtype)
    before = cf.fused_conv_frontend.launches
    got = cf.fused_conv_frontend(wav, packed)
    torch.cuda.synchronize()
    assert cf.fused_conv_frontend.launches == before + 7
    want = cf.conv_frontend_reference(wav, packed)
    assert got.shape == want.shape == (shape[0],
                                       cf.output_frames(shape[1]), c)
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_conv_frontend_kernels_do_not_spill(cuda_device):
    """Every instantiation of the frontend kernels (layer 0 and layers 1-6;
    f32 and bf16; C 64, 128, 256, 512): no local memory (no spills), and
    each fits on an SM."""
    rows = cf.frontend_kernel_attributes()
    assert len(rows) == 16
    for r in rows:
        assert r["local_bytes"] == 0, r
        assert r["blocks_per_sm"] >= 1, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_frontend_kernel_is_deterministic(cuda_device, dtype):
    """Each block owns its output rows: two calls give the same bits."""
    ext = _extractor(512, 4).to(cuda_device)
    wav = _frontend_wav(cuda_device, (3, 16123), "offset", dtype, 5)
    packed = ext.packed(dtype)
    first = cf.fused_conv_frontend(wav, packed)
    second = cf.fused_conv_frontend(wav, packed)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert first.abs().max() > 0


# f32: summation order and expf; bf16: P rounded to bf16 before P·V
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("wrapper,t,lens", [
    ("flash_attention_short", 249, [249, 0, 100]),
    ("flash_attention", 1100, [1100, 0, 700])])
def test_attention_kernel_matches_plain(cuda_device, dtype, tol, d, wrapper,
                                        t, lens):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 4, t, d)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(3))
    lengths = torch.tensor(lens, device=cuda_device)
    fn = getattr(fa, wrapper)
    before = fn.launches
    got = fn(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = fa.attention_reference(q, k, v, lengths)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got[1] == 0).all()


def _peak_err(got, want):
    """max |got - want| over max |want|: the gradients' scale varies with
    the shape, so their tolerances are relative to the peak."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


# f32: summation order and expf; bf16: P (forward) and dS (backward)
# rounded to bf16 at other running maxima, and bf16 outputs
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_CASES = [  # (B, H, Tq, Tk, lengths, dropout rate)
    (3, 4, 300, 300, [300, 0, 170], 0.1),
    (2, 2, 130, 200, [200, 63], 0.3),
    (2, 2, 100, 100, None, 0.0),
    # the backward's 64-row tiles and its ring of 32-row panels: Tk of 1499
    # (46 panels and a tail of 27), Tq != Tk, lengths that end inside a
    # panel (130, 700), one key, zero keys (Tk = 1: test_backward_one_key)
    (3, 2, 150, 1499, [1499, 129, 1], 0.3),
    (2, 3, 1499, 200, [130, 0], 0.0),
    (1, 2, 1499, 1499, [700], 0.1)]


def _train_inputs(device, dtype, d, b, h, tq, tk, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(device, dtype) for shape in
            ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d), (b, h, tq, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_training_kernels_match_plain(cuda_device, dtype, d, case):
    """3b (forward + logsumexp + dropout), 4a (dQ) and 4b (dK, dV) against
    their plain versions on the same inputs; rows of length 0 give zeros."""
    b, h, tq, tk, lens, rate = case
    q, k, v, dout = _train_inputs(cuda_device, dtype, d, b, h, tq, tk, 7)
    lengths = None if lens is None else torch.tensor(lens, device=cuda_device)
    seed = 2 ** 31 - 2
    before = ops.launch_counts()
    out, lse = fa.flash_attention_fwd_lse(q, k, v, lengths, None, seed, rate)
    want_out, want_lse = fa.attention_lse_reference(q, k, v, lengths, None,
                                                    seed, rate)
    assert (out.float() - want_out.float()).abs().max().item() \
        <= {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    valid = want_lse > fa.NEG_INF / 2
    assert torch.equal(lse > fa.NEG_INF / 2, valid)
    assert (lse[valid] - want_lse[valid]).abs().max().item() <= 1e-3
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, dout, lse, delta, lengths, None, seed, rate)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("flash_attention_lse", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    wants = (fa.attention_bwd_dq_reference(*args),
             *fa.attention_bwd_dkv_reference(*args))
    for got, want, name in zip((dq, dk, dv), wants, ("dq", "dk", "dv")):
        assert torch.isfinite(got).all(), name
        assert _peak_err(got, want) <= TRAIN_TOL[dtype], name
    if lens is not None:
        dead = torch.tensor(lens) == 0
        for t in (out, dq, dk, dv):
            assert (t[dead] == 0).all()
        past = torch.arange(tk)[None, :] >= torch.tensor(lens)[:, None]
        assert (dk.transpose(1, 2)[past] == 0).all()
        assert (dv.transpose(1, 2)[past] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
def test_backward_one_key(cuda_device, dtype, d):
    """Tk = 1 (a single, ragged panel) with lengths [1, 0]: over one key the
    softmax is 1 whatever the score, so dS, dQ and dK are 0 in exact
    arithmetic and only rounding is left of them; dV = (P o M)^T dO is not.
    dV is held to its plain version, dQ and dK to zero at the tolerance
    relative to dV's peak, and the row of length 0 to exact zeros."""
    q, k, v, dout = _train_inputs(cuda_device, dtype, d, 2, 2, 77, 1, 3)
    lengths = torch.tensor([1, 0], device=cuda_device)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, lengths, None, 9, 0.3)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, dout, lse, delta, lengths, None, 9, 0.3)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    want_dv = fa.attention_bwd_dkv_reference(*args)[1]
    assert _peak_err(dv, want_dv) <= TRAIN_TOL[dtype]
    peak = want_dv.float().abs().max()
    for t in (dq, dk):
        assert (t.float().abs().max() / peak).item() <= TRAIN_TOL[dtype]
    for t in (dq, dk, dv):
        assert (t[1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
def test_backward_kernels_are_deterministic(cuda_device, dtype, d):
    """Each block owns its output rows (no atomics): two launches on the
    same inputs give the same bits, forward (out and L) and backward."""
    q, k, v, dout = _train_inputs(cuda_device, dtype, d, 2, 3, 333, 555, 8)
    lengths = torch.tensor([555, 300], device=cuda_device)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, lengths, None, 5, 0.1)
    out2, lse2 = fa.flash_attention_fwd_lse(q, k, v, lengths, None, 5, 0.1)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert out.abs().max() > 0
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, dout, lse, delta, lengths, None, 5, 0.1)
    first = (fa.flash_attention_bwd_dq(*args),
             *fa.flash_attention_bwd_dkv(*args))
    second = (fa.flash_attention_bwd_dq(*args),
              *fa.flash_attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name
        assert a.abs().max() > 0, name


def test_forward_kernel_does_not_spill(cuda_device):
    """Every instantiation of the forward body (kernels 2, 3 and 3b; f32 and
    bf16, D 16 and 64, with and without dropout): no local memory (no
    spills) and at least 8 warps resident per SM."""
    rows = fa.forward_kernel_attributes()
    assert len(rows) == 8
    for r in rows:
        assert r["local_bytes"] == 0, r
        assert r["blocks_per_sm"] * 4 >= 8, r


@pytest.mark.parametrize("view", ["offset", "time_stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_wrappers_take_misaligned_rows(cuda_device, view, dtype):
    """The forward copies rows in 16-byte pieces: its wrappers hand it
    aligned copies of views whose rows are not 16-byte aligned, with the
    plain version's result."""
    q, k, v, _ = _train_inputs(cuda_device, dtype, 16, 2, 2, 40, 40, 6)
    if view == "offset":
        flat = torch.zeros(q.numel() + 1, device=cuda_device, dtype=dtype)
        bad = flat[1:].view(q.shape)
    else:
        bad = torch.zeros(*q.shape[:3], 17, device=cuda_device,
                          dtype=dtype)[..., :16]
    bad.copy_(q)
    assert fa._misaligned(bad) is not None
    lengths = torch.tensor([40, 23], device=cuda_device)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    for fn in (fa.flash_attention_short, fa.flash_attention):
        got = fn(bad, k, v, lengths)
        want = fa.attention_reference(q, k, v, lengths)
        assert (got.float() - want.float()).abs().max().item() <= tol
    out, lse = fa.flash_attention_fwd_lse(bad, bad, v, lengths, None, 3, 0.1)
    want, want_lse = fa.attention_lse_reference(q, q, v, lengths, None, 3,
                                                0.1)
    assert (out.float() - want.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-3


def test_backward_kernels_do_not_spill(cuda_device):
    """Every instantiation of 4a and 4b (f32 and bf16, D 16 and 64, with
    and without dropout): no local memory (no spills) and at least 8 warps
    resident per SM."""
    rows = fa.backward_kernel_attributes()
    assert len(rows) == 16
    for r in rows:
        assert r["local_bytes"] == 0, r
        assert r["blocks_per_sm"] * 4 >= 8, r


def test_flash_attention_gradients_on_card_match_cpu(cuda_device):
    """The autograd Function on the card (kernels 3b, 4a, 4b) against the
    same function on the CPU (the plain versions), dropout included."""
    grads = {}
    for dev in ("cuda", "cpu"):
        q, k, v, co = _train_inputs(dev, torch.float32, 64, 2, 3, 260, 260, 9)
        ts = [t.requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*ts, torch.tensor([260, 100], device=dev),
                                 dropout_seed=11, dropout_rate=0.1)
        (out * co).sum().backward()
        grads[dev] = [out.detach().cpu()] + [t.grad.cpu() for t in ts]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _peak_err(got, want) <= 1e-4


@pytest.mark.parametrize("d", [16, 64])
def test_short_attention_gradients_on_card_match_plain(cuda_device, d):
    """Repair: the short kernel's wrapper carries a gradient (the VJP of
    the plain attention), as the plain path does."""
    grads = []
    for fn in (fa.flash_attention_short, fa.attention_reference):
        q, k, v, co = _train_inputs(cuda_device, torch.float32, d, 3, 2, 249,
                                    249, 4)
        ts = [t.requires_grad_() for t in (q, k, v)]
        (fn(*ts, torch.tensor([249, 0, 90], device=cuda_device)) * co) \
            .sum().backward()
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        assert got is not None and _peak_err(got, want) <= 1e-4


def test_conv_frontend_gradients_on_card_match_plain(cuda_device):
    """Repair: gradients through the kernel path reach the extractor's own
    conv and LayerNorm parameters and the wav, equal to the per-layer
    path's."""
    ext = _extractor(128, 2).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    wav0 = torch.randn(2, 16000 + 123, generator=gen, device=cuda_device)
    grads = {}
    for fused in (True, False):
        ext.zero_grad()
        wav = wav0.clone().requires_grad_()
        before = cf.fused_conv_frontend.launches
        out = ext(wav, fused=fused)
        assert cf.fused_conv_frontend.launches == before + (7 if fused else 0)
        (out * torch.linspace(-1, 1, out.shape[-1], device=cuda_device)) \
            .sum().backward()
        grads[fused] = [wav.grad] + [p.grad.clone() for p in ext.parameters()]
    for got, want in zip(grads[True], grads[False]):
        assert _peak_err(got, want) <= 1e-3


def test_unsupported_inputs_raise_on_card(cuda_device):
    q = torch.zeros(1, 2, 8, 24, device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention_short(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    # the backward kernels copy 16-byte pieces: a view that starts 4 bytes
    # into its storage, and one whose rows are 17 floats apart, must raise
    q, k, v, dout = _train_inputs(cuda_device, torch.float32, 16, 1, 2, 8, 8,
                                  1)
    lse = torch.zeros(1, 2, 8, device=cuda_device)
    shifted = torch.zeros(1 * 2 * 8 * 16 + 1, device=cuda_device)[1:]
    wide = torch.zeros(1, 2, 8, 17, device=cuda_device)[..., :16]
    for bad in (shifted.view(1, 2, 8, 16), wide):
        for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            with pytest.raises(ValueError, match="16-byte"):
                fn(bad, k, v, dout, lse, lse)
            with pytest.raises(ValueError, match="16-byte"):
                fn(q, k, v, bad, lse, lse)


def test_tiny_transcriber_card_matches_cpu(cuda_device):
    """TINY_ARCH end to end in f32: the card (attention kernels, head dim
    16) against the CPU (plain versions); same frames, same notes."""
    bridge, head = build_modules(tiny=True)
    load_jax_params(init_params(bridge.config,
                                torch.Generator().manual_seed(3)),
                    bridge, head)
    rng = np.random.default_rng(4)
    songs = {"a": rng.normal(size=40000).astype(np.float32),
             "b": (rng.normal(size=19000) * 3000).astype(np.int16)}
    out = {}
    for dev in ("cuda", "cpu"):
        tr = BatchedAMTTranscriber(bridge, head, chunk_seconds=1.0,
                                   batch_size=2, compute_dtype=torch.float32,
                                   device=dev)
        out[dev] = (tr.predict_frames(songs), tr.transcribe(songs))
    for name in songs:
        got, want = out["cuda"][0][name], out["cpu"][0][name]
        np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-4)
        np.testing.assert_array_equal(got[:, 2:], want[:, 2:])
    assert out["cuda"][1] == out["cpu"][1]


def int8_case(m, k, n, dtype, device, seed=0):
    """x (M, K) with the rows that pin the quantizer: all zeros (scale from
    the 1e-8 floor), the amax in the last column, and exact .5 ties after
    the division (multiples of amax/254, amax 127); w8 and w_scale from a
    quantized normal matrix."""
    rng = np.random.default_rng(seed + m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[0] = (rng.integers(-254, 255, size=k) / 2.0)
    x[0, 0] = 127.0
    if m > 1:
        x[1] = 0.0
    if m > 2:
        x[2, -1] = 9.0
    w8, ws = quant.quantize_weight(
        torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)))
    return (torch.from_numpy(x).to(device, dtype), w8.to(device),
            ws.to(device))


def assert_int8_kernel_matches_plain(x, w8, ws):
    """The kernel's integers and scales bit for bit, and its output within
    one rounding of the output dtype (the products are exact integers and
    the f32 epilogue has the plain version's order, so f32 is held to 1e-6
    relative: a fused multiply's last bit)."""
    out, x8, xs = quant.int8_matmul_quantized(x, w8, ws,
                                              quant.pack_weight(w8))
    torch.cuda.synchronize()
    want_x8, want_xs = quant.quantize_activation(x)
    assert torch.equal(x8, want_x8)
    assert torch.equal(xs, want_xs)
    want = quant.int8_matmul_plain(x, w8, ws)
    assert out.dtype == x.dtype and out.shape == want.shape
    rtol = 1e-6 if x.dtype == torch.float32 else 2.0 ** -8
    err = (out.float() - want.float()).abs()
    assert (err <= rtol * want.float().abs()).all(), err.max().item()
    return err.max().item()


INT8_SHAPES = [  # (M, K, N): the serving shapes, then the edges
    (1992, 512, 1024), (1992, 1024, 4096), (1992, 4096, 1024),
    (1992, 1024, 1024), (1499, 1024, 1024), (249, 1024, 4096),
    (249, 4096, 1024), (1993, 4096, 1024), (1, 128, 128), (33, 128, 128),
    (64, 2944, 256), (65, 3072, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_matmul_kernel_matches_plain(cuda_device, dtype, m, k, n):
    x, w8, ws = int8_case(m, k, n, dtype, cuda_device)
    before = quant.int8_matmul.launches
    assert_int8_kernel_matches_plain(x, w8, ws)
    assert quant.int8_matmul.launches == before + 1
    # leading axes, a bf16 w_scale (a bf16 transcriber's), no packed copy
    if m % 3 == 0:
        ws16 = ws.bfloat16()
        got = quant.int8_matmul(x.reshape(3, m // 3, k), w8, ws16)
        torch.cuda.synchronize()
        want = quant.int8_matmul_plain(x, w8, ws16).reshape(3, m // 3, n)
        assert torch.allclose(got.float(), want.float(), atol=0,
                              rtol=1e-6 if dtype == torch.float32 else 2.0 ** -8)


# (M, K, N) of the RCA fusion's int8 products (``quantize_fusion`` with
# ``quantize_attn``) in batch-1 serving at ``dur_threshold`` 5, as
# ``chip_smoke.fusion_int8_shapes`` lists them for a padded frame count T.
# ``prepare_csv_n20emv2_feat`` cuts a song of D seconds into max(1,
# round(D / 5)) utterances: whole 5 s ones (249 frames at 49.8 a second)
# and a last one of 2.5 to 7.5 s (the whole song when it is shorter), so
# at most 374 frames; the loader pads T to a multiple of 50
FUSION_FRAMES = range(50, 401, 50)
FUSION_INT8_SHAPES = sorted({s for t in FUSION_FRAMES
                             for s in chip_smoke.fusion_int8_shapes(t)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", FUSION_INT8_SHAPES)
def test_int8_matmul_kernel_matches_plain_at_the_fusion_shapes(
        cuda_device, dtype, m, k, n):
    x, w8, ws = int8_case(m, k, n, dtype, cuda_device, seed=7)
    before = quant.int8_matmul.launches
    assert_int8_kernel_matches_plain(x, w8, ws)
    assert quant.int8_matmul.launches == before + 1


@pytest.mark.parametrize("quantize_attn,launches", [(False, 4), (True, 12)])
def test_int8_fusion_card_matches_cpu(cuda_device, quantize_attn, launches):
    """The RCA fusion at its published width (8 heads, d_ffn 3072, d_model
    1024) quantized by ``quantize_fusion``, f32, one 5 s utterance: kernel
    5 launched ``launches`` times a forward, the output against the CPU's
    plain path. An activation on a rounding boundary may take the other
    integer on the other device and move its frame's attention row, so all
    but a few frames are held to f32 summation order and those few to a
    quantization step."""
    from svt_speechbrain_tpu_torch.convert_jax import init_modules
    from svt_speechbrain_tpu_torch.models.fusion import FusionRCA
    from svt_speechbrain_tpu_torch.models.quantize import quantize_fusion

    fusion = FusionRCA(alpha=0.5, nhead=8, d_ffn=3072, d_model=1024)
    init_modules({"fusion": fusion}, 0)
    q = quantize_fusion(fusion, quantize_attn=quantize_attn)
    gen = torch.Generator().manual_seed(1)
    audio = torch.randn(1, 249, 1024, generator=gen)
    video = torch.randn(1, 250, 1024, generator=gen)
    with torch.no_grad():
        want = q(audio, video)
        q.cuda()
        before = quant.int8_matmul.launches
        got = q(audio.cuda(), video.cuda()).cpu()
    assert quant.int8_matmul.launches == before + launches
    err = (got - want).abs().amax(-1)[0]
    assert (err > 1e-4).sum() <= 3, err.max()
    assert err.max() <= 5e-2


def test_int8_matmul_kernel_does_not_spill(cuda_device):
    """Both instantiations of the int8 kernel (f32, bf16): no local memory
    (no spills), two blocks an SM, and clusters of 8 resident (the plan's
    widest)."""
    rows = quant.int8_kernel_attributes()
    assert len(rows) == 2
    for r in rows:
        assert r["local_bytes"] == 0, r
        assert r["blocks_per_sm"] >= 2, r
        assert r["smem_bytes"] == quant.SHARED_BYTES, r
        assert r["clusters"][8] >= 1, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_is_deterministic(cuda_device, dtype):
    """Each block owns its output tile and sums its products in one order:
    two calls on the same input give the same bits, integers and all."""
    x, w8, ws = int8_case(1993, 4096, 1024, dtype, cuda_device, seed=3)
    w8t = quant.pack_weight(w8)
    first = quant.int8_matmul_quantized(x, w8, ws, w8t)
    second = quant.int8_matmul_quantized(x, w8, ws, w8t)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert first[0].abs().max() > 0


def test_int8_matmul_kernel_refuses_what_it_does_not_take(cuda_device):
    x, w8, ws = int8_case(8, 128, 128, torch.float32, cuda_device)
    before = quant.int8_matmul.launches
    for bad_k, bad_n in ((96, 128), (128, 192)):
        bx, bw8, bws = int8_case(8, bad_k, bad_n, torch.float32, cuda_device)
        with pytest.raises(ValueError, match="multiples of 128"):
            quant.int8_matmul(bx, bw8, bws)
    with pytest.raises(ValueError, match="contiguous"):
        quant.int8_matmul(x.t().contiguous().t(), w8, ws)
    with pytest.raises(ValueError, match="f32 or bf16"):
        quant.int8_matmul(x.half(), w8, ws)
    with pytest.raises(ValueError, match="int8"):
        quant.int8_matmul(x, w8.int(), ws)
    with pytest.raises(ValueError, match="inference only"):
        quant.int8_matmul(x.clone().requires_grad_(), w8, ws)
    with pytest.raises(ValueError, match="one device"):
        quant.int8_matmul(x, w8.cpu(), ws)
    wx, ww8, wws = int8_case(8, 128, 256, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="pack_weight"):
        quant.int8_matmul(wx, ww8, wws, ww8)      # (K, N), not packed
    assert quant.int8_matmul.launches == before
    assert quant.int8_matmul(x[:0], w8, ws).shape == (0, 128)
    assert quant.int8_matmul.launches == before   # nothing to launch


def test_tiny_int8_transcriber_card_matches_cpu(cuda_device):
    """A 128-aligned small arch end to end in f32 with int8 FFNs, attention
    projections and feature projection: the card (kernel 5) against the CPU
    (the plain version). An activation that sits on a rounding boundary may
    take the other integer on the other device (the float inputs of the
    quantizer differ by summation order), so the probabilities are held to
    a quantization step, not to f32 rounding."""
    from svt_speechbrain_tpu_torch.models.quantize import quantize_wav2vec2

    arch = dict(hidden_size=128, num_layers=2, num_heads=2, ffn_size=256,
                conv_dim=(128,) * 7, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4)
    from svt_speechbrain_tpu_torch.models.wav2vec2 import HuggingFaceWav2Vec2
    from svt_speechbrain_tpu_torch.nnet.linear import Linear

    bridge = HuggingFaceWav2Vec2(arch_overrides=arch)
    head = Linear(20, 128)
    load_jax_params(init_params(bridge.config,
                                torch.Generator().manual_seed(5)),
                    bridge, head)
    qbridge = quantize_wav2vec2(bridge, quantize_attn=True)
    rng = np.random.default_rng(6)
    songs = {"a": rng.normal(size=40000).astype(np.float32),
             "b": (rng.normal(size=19000) * 3000).astype(np.int16)}
    out = {}
    for dev in ("cuda", "cpu"):
        tr = BatchedAMTTranscriber(qbridge, head, chunk_seconds=1.0,
                                   batch_size=2, compute_dtype=torch.float32,
                                   device=dev)
        before = quant.int8_matmul.launches
        out[dev] = tr.predict_frames(songs)
        # 3 batches of (1 feat_proj + 2 layers x 6) launches on the card
        assert quant.int8_matmul.launches - before == (39 if dev == "cuda"
                                                       else 0)
    for name in songs:
        got, want = out["cuda"][name], out["cpu"][name]
        assert np.median(np.abs(got[:, :2] - want[:, :2])) < 1e-5
        assert np.abs(got[:, :2] - want[:, :2]).max() < 2e-2


# ------------------------------------------------- kernels 6a and 6b (RNN-T)
def _rnnt_problem(device, b, t, u, v, seed, blank_target=False):
    """Logits, targets and ragged relative lengths (the last row with an
    empty target where the batch has more than one row)."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.normal(size=(b, t, u + 1, v))
                              .astype(np.float32)).to(device)
    targets = torch.from_numpy(rng.integers(0 if blank_target else 1, v,
                                            size=(b, u))).to(device)
    t_rel = torch.linspace(1.0, 0.4, b)
    u_rel = torch.linspace(1.0, 0.0, b) if b > 1 else torch.ones(1)
    return logits, targets, t_rel.to(device), u_rel.to(device)


def _rnnt_panels(logits, targets, t_rel, u_rel):
    _, t, u1, _ = logits.shape
    t_len = torch.round(t_rel * t).int()
    u_len = torch.round(u_rel * (u1 - 1)).int()
    lse = torch.logsumexp(logits, -1)
    skip, emit_pad = tl._gather_skip_emit(logits, lse, targets.int(), 0)
    skip_m, emit_m, seed_tu = tl._masked_panels(logits, lse, targets.int(),
                                                t_len, u_len, 0)
    seed = torch.full_like(skip, tl.NEG_INF)
    seed[:, 0, 0] = 0.0
    return lse, t_len, u_len, (skip, emit_pad, seed), (skip_m, emit_m,
                                                      seed_tu)


def _valid(t_len, u_len, rows, u1, extra_row=0):
    """Cells of each row's valid region, (B, rows, u1) bool: t < T(b) (+ the
    beta grid's extra row) and u <= U(b)."""
    t_grid = torch.arange(rows, device=t_len.device)[None, :, None]
    u_grid = torch.arange(u1, device=t_len.device)[None, None, :]
    return ((t_grid < (t_len + extra_row)[:, None, None])
            & (u_grid <= u_len[:, None, None]))


# f32 logaddexp chains of up to T + U steps in two orders of evaluation
# (expf/log1pf of the card's libm against PyTorch's): the lattice values
# reach |x| of several thousand at T 749, where one f32 ulp is 4.9e-4, so
# the lattices are held relative to their size. U1 of 1, 5, 33, 81, 128
# (the widest of route A), 129 (the narrowest of route B only) and 1500.
RNNT_SHAPES = [(3, 12, 5, 7), (2, 1, 4, 6), (2, 9, 0, 5), (2, 40, 32, 12),
               (2, 749, 80, 16), (1, 6, 1499, 8),
               (2, 60, tl.WARP_MAX_U1 - 1, 8), (2, 60, tl.WARP_MAX_U1, 8)]


@pytest.mark.parametrize("b,t,u,v", RNNT_SHAPES)
def test_rnnt_lattice_kernel_matches_plain(cuda_device, b, t, u, v):
    """6a on alpha panels (forward) and on the masked beta panels
    (reverse), U1 of 1, 5, 33, 81, 128, 129 and 1500, T of 1 and 749, ragged
    lengths, by each route that takes U1 (``lattice_plan``'s, and route B
    beside route A up to ``WARP_MAX_U1``): equal to ``lattice_plain`` on
    each row's valid region, and the two routes equal bit for bit there
    (route A's seed shortcut is exact)."""
    logits, targets, t_rel, u_rel = _rnnt_problem(cuda_device, b, t, u, v, 11)
    _, t_len, u_len, fwd, rev = _rnnt_panels(logits, targets, t_rel, u_rel)
    for panels, reverse in ((fwd, False), (rev, True)):
        rows = panels[2].shape[1]
        plan = tl.lattice_plan(b, rows, u + 1, reverse)
        assert plan.route == ("warp" if u + 1 <= tl.WARP_MAX_U1 else "block")
        plans = [plan] + ([tl._block_plan(b, u + 1)]
                          if plan.route == "warp" else [])
        want = tl.lattice_plain(*panels, reverse=reverse)
        live = _valid(t_len, u_len, rows, u + 1, int(reverse))
        got = {}
        for p in plans:
            before = tl.rnnt_lattice.launches
            out, used = tl._launch(*panels, reverse, plan=p)
            torch.cuda.synchronize()
            assert tl.rnnt_lattice.launches == before + 1 and used == p
            assert torch.isfinite(out).all()
            err = (out - want).abs()[live]
            assert (err <= 1e-5 + 2e-6 * want.abs()[live]).all(), (
                p.route, err.max())
            got[p.route] = out
        if len(got) == 2:
            assert torch.equal(got["warp"][live], got["block"][live])
        before = tl.rnnt_lattice.launches
        assert torch.equal(tl.rnnt_lattice(*panels, reverse=reverse),
                           got[plan.route])
        assert tl.rnnt_lattice.launches == before + 1


def test_rnnt_lattice_kernels_do_not_spill(cuda_device):
    """Every instantiation of 6a that the plan launches (route A, route B):
    no local memory, and the shared memory ``lattice_plan`` gives."""
    for r in tl.lattice_kernel_attributes():
        assert r["local_bytes"] == 0, r
        plan = (tl.lattice_plan(1, 2, r["u1"], False) if r["route"] == "warp"
                else tl._block_plan(1, r["u1"]))
        assert (r["smem_bytes"], r["threads"]) == (plan.smem, plan.threads), r
        assert r["blocks_per_sm"] >= 1, r


@pytest.mark.parametrize("from_log_probs", [False, True])
@pytest.mark.parametrize("b,t,u,v", RNNT_SHAPES[:4] + [(2, 60, 20, 1000),
                                                      (2, 30, 9, 37)])
def test_rnnt_grad_kernel_matches_plain(cuda_device, b, t, u, v,
                                        from_log_probs):
    """6b against ``rnnt_grad_plain`` on the same lattices (V a multiple of
    4 and not, a target equal to the blank): atol 1e-6 (posteriors are at
    most 1; expf differs in the last bit), exact zeros outside the valid
    region."""
    logits, targets, t_rel, u_rel = _rnnt_problem(cuda_device, b, t, u, v, 12,
                                                  blank_target=True)
    if from_log_probs:
        logits = torch.log_softmax(logits, -1)
    lse, t_len, u_len, fwd, rev = _rnnt_panels(logits, targets, t_rel, u_rel)
    if from_log_probs:
        lse = torch.zeros_like(lse)
    alpha = tl.lattice_plain(*fwd)
    beta = tl.lattice_plain(*rev, reverse=True)
    final = tl._masks(t_len, u_len, t, u + 1)[2]
    log_z = torch.where(final, alpha + fwd[0], 0.0).sum((1, 2))
    g = torch.linspace(0.5, 1.5, b, device=cuda_device)
    args = (logits, lse, targets.int(), alpha, beta, log_z, t_len, u_len, g,
            0, from_log_probs)
    before = tl.rnnt_grad.launches
    got = tl.rnnt_grad(*args)
    torch.cuda.synchronize()
    assert tl.rnnt_grad.launches == before + 1
    want = tl.rnnt_grad_plain(*args)
    assert (got - want).abs().max().item() <= 1e-6
    dead = ~_valid(t_len, u_len, t, u + 1)
    assert (got[dead] == 0).all()
    assert got.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rnnt_loss_gradients_on_card_match_cpu(cuda_device, dtype):
    """``transducer_loss_fused`` through the autograd Function on the card
    (2 launches of 6a, 1 of 6b) against the same call on the CPU (the plain
    versions) and against autograd through the plain ``transducer_loss``;
    a bf16 input gets a bf16 gradient."""
    from svt_speechbrain_tpu_torch.nnet.loss.transducer_loss import (
        transducer_loss)

    logits, targets, t_rel, u_rel = _rnnt_problem("cpu", 4, 50, 12, 40, 13,
                                                  blank_target=True)
    logits = logits.to(dtype)
    out = {}
    for dev, fn in (("cuda", tl.transducer_loss_pallas),
                    ("cpu", tl.transducer_loss_fused),
                    ("oracle", transducer_loss)):
        where = "cpu" if dev == "oracle" else dev
        leaf = logits.to(where, copy=True).requires_grad_()
        ops.reset_launch_counts()
        nll = fn(leaf, targets.to(where), t_rel.to(where), u_rel.to(where), 0,
                 reduction="none")
        (nll * torch.arange(1, 5, device=where)).sum().backward()
        counts = ops.launch_counts()
        assert (counts["rnnt_lattice"], counts["rnnt_grad"]) == (
            (2, 1) if dev == "cuda" else (0, 0))
        assert leaf.grad.dtype == dtype
        out[dev] = (nll.detach().cpu(), leaf.grad.float().cpu())
    # the posteriors are exp of sums of lattice values of about 200, whose
    # f32 ulp is 1.5e-5, and the card's expf/log1pf differ from the CPU's in
    # the last bit; with row weights up to 4 the gradients agree to a few
    # 1e-5. bf16 adds one rounding (an ulp is at most 2^-7 of the value).
    # Autograd through the closed-form scan is held in f32 only (it takes
    # its log-softmax in the input's type); it is 5.1e-5 from the plain
    # version on the CPU
    for other in ("cpu", "oracle"):
        if other == "oracle" and dtype != torch.float32:
            continue
        torch.testing.assert_close(out["cuda"][0], out[other][0], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(
            out["cuda"][1], out[other][1], atol=2e-4,
            rtol=0 if dtype == torch.float32 else 2.0 ** -7)


def test_rnnt_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros(2, 4, 3, device=cuda_device)
    with pytest.raises(ValueError):
        tl.rnnt_lattice(a.double(), a.double(), a.double())
    with pytest.raises(ValueError):
        tl.rnnt_lattice(a, a, a.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        tl.rnnt_lattice(a, a, a, reverse=True)          # seed needs T + 1
    with pytest.raises(ValueError):
        tl.transducer_loss_fused(torch.zeros(1, 2, 2, 3, device=cuda_device),
                                 torch.ones(1, 1), [1.0], [1.0], 0,
                                 lattice="cudnn")


# --------------------------------------------------------- the video path
# AV-HuBERT's evaluation at batch 1: utterances of at most 7.5 s of 50 fps
# video padded to a multiple of 50 frames, every frame attended
# (``lengths=None``), 16 heads of 64
VIDEO_FRAMES = range(50, 401, 50)


@pytest.mark.parametrize("t", VIDEO_FRAMES)
def test_short_attention_without_lengths_at_the_video_shapes(cuda_device, t):
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    q, k, v = (torch.randn(1, 16, t, 64, generator=gen, device=cuda_device)
               for _ in range(3))
    before = fa.flash_attention_short.launches
    got = fa.flash_attention_short(q, k, v, None)
    torch.cuda.synchronize()
    assert fa.flash_attention_short.launches == before + 1
    want = fa.attention_reference(q, k, v, None)
    assert (got - want).abs().max().item() <= 1e-4
    full = torch.full((1,), t, device=cuda_device)
    assert torch.equal(got, fa.flash_attention_short(q, k, v, full))


# (M, K, N) of int8 AV-HuBERT serving at batch 1 (``quantize_avhubert``):
# post_extract_proj (T, 2048, 1024), ffn1, ffn2 and, with quantize_attn,
# the attention projections, for each padded frame count T
AVHUBERT_INT8_SHAPES = sorted({s for t in VIDEO_FRAMES
                               for s in chip_smoke.avhubert_int8_shapes(t)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", AVHUBERT_INT8_SHAPES)
def test_int8_matmul_kernel_matches_plain_at_the_avhubert_shapes(
        cuda_device, dtype, m, k, n):
    x, w8, ws = int8_case(m, k, n, dtype, cuda_device, seed=11)
    before = quant.int8_matmul.launches
    assert_int8_kernel_matches_plain(x, w8, ws)
    assert quant.int8_matmul.launches == before + 1


@pytest.mark.parametrize("quantize_attn,per_layer", [(False, 2), (True, 6)])
def test_tiny_int8_avhubert_card_matches_cpu(cuda_device, quantize_attn,
                                             per_layer):
    """A 2-layer AV-HuBERT of width 128 (the int8 kernel takes K and N in
    multiples of 128) on the full ResNet frontend,
    quantized by ``quantize_avhubert``, f32, one utterance of 50 frames of
    88×88 video: kernel 5 launched 2 a layer (6 with ``quantize_attn``) and
    once for ``post_extract_proj``, short attention once a layer, the
    features against the CPU's plain path. cuDNN's convolutions and the
    CPU's differ by f32 summation order, so some of the 64,000 activations
    the int8 products round (50 frames x 5 products x K up to 256) fall to
    the other integer, each moving its frame by up to a quantization step
    (6 frames above 1e-3, at most 2.9e-3, on an H100 without
    ``quantize_attn``): a fifth of the frames may stray that far."""
    from svt_speechbrain_tpu_torch.convert_jax import init_modules
    from svt_speechbrain_tpu_torch.models.avhubert import FairseqAVHubert
    from svt_speechbrain_tpu_torch.models.quantize import quantize_avhubert

    enc = FairseqAVHubert(arch_overrides=dict(
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=2, conv_pos=16, conv_pos_groups=4))
    init_modules({"encoder": enc}, 0)
    q = quantize_avhubert(enc, quantize_attn=quantize_attn).eval()
    video = torch.randn(1, 50, 88, 88, 1,
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = q({"video": video})
        q.cuda()
        before = ops.launch_counts()
        got = q({"video": video.cuda()}).cpu()
    after = ops.launch_counts()
    assert after["int8_matmul"] - before["int8_matmul"] == 2 * per_layer + 1
    assert (after["flash_attention_short"]
            - before["flash_attention_short"]) == 2
    err = (got - want).abs().amax(-1)[0]
    assert (err > 1e-3).sum() <= 10, err.max()
    assert err.max() <= 5e-2
