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

from svt_speechbrain_tpu_torch import ops
from svt_speechbrain_tpu_torch.flagship import build_modules
from svt_speechbrain_tpu_torch.convert_jax import init_params, load_jax_params
from svt_speechbrain_tpu_torch.inference import BatchedAMTTranscriber
from svt_speechbrain_tpu_torch.models.wav2vec2 import (ConvFeatureExtractor,
                                                       Wav2Vec2Config)
from svt_speechbrain_tpu_torch.ops import conv_frontend as cf
from svt_speechbrain_tpu_torch.ops import flash_attention as fa

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
# bf16 by a few ulp of the last layer's bf16 output
@pytest.mark.parametrize("c", [128, 512])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 6.25e-2)])
def test_conv_frontend_kernel_matches_plain(cuda_device, c, dtype, tol):
    ext = _extractor(c, 0).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    wav = torch.randn(2, 16000 + 123, generator=gen, device=cuda_device)
    packed = ext.packed(dtype)
    before = cf.fused_conv_frontend.launches
    got = cf.fused_conv_frontend(wav.to(dtype), packed)
    torch.cuda.synchronize()
    assert cf.fused_conv_frontend.launches == before + 7
    want = cf.conv_frontend_reference(wav.to(dtype), packed)
    assert got.shape == want.shape == (2, cf.output_frames(16123), c)
    assert (got.float() - want.float()).abs().max().item() <= tol


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
    (2, 2, 100, 100, None, 0.0)]


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
