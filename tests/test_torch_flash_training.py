"""Port parity, training attention: the in-kernel dropout mask bit for bit,
and the plain versions of the training forward (with logsumexp) and of
both backward programs (the CPU side of ``flash_attention_fwd_lse``,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``) against the JAX
Pallas kernels in interpret mode and ``jax.grad`` through them, f32 on the
CPU; the training dispatch; and the gradients of the CPU paths of the
repaired wrappers."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.ops import flash_attention as jfa

from svt_speechbrain_tpu_torch.models.wav2vec2 import (
    TINY_ARCH, ConvFeatureExtractor, Wav2Vec2Config)
from svt_speechbrain_tpu_torch.convert_jax import init_params, load_jax_params
from svt_speechbrain_tpu_torch.nnet import attention as tattn
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
from svt_speechbrain_tpu_torch.ops import conv_frontend as cf
from svt_speechbrain_tpu_torch.ops import flash_attention as fa

# the JAX package's own tolerance for these gradients
# (tests/test_flash_attention.py::test_flash_dropout_grads_match_masked_einsum);
# the forward and L are held tighter: f32 summation order and exp only
ATOL, RTOL = 5e-4, 1e-3
FWD_ATOL = 1e-5


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("seed", [0, 1234, 2 ** 31 - 2])
def test_dropout_mask_is_bit_equal_to_jax(seed, rate):
    want = np.asarray(jfa.attention_dropout_mask(seed, 2, 3, 37, 150, rate))
    got = fa.attention_dropout_mask(seed, 2, 3, 37, 150, rate).numpy()
    np.testing.assert_array_equal(got, want)


def _inputs(b, h, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d), (b, h, tq, d))]


@pytest.mark.parametrize("b,h,tq,tk,d,lens,seed,rate", [
    (2, 2, 70, 96, 16, [70, 0], 123, 0.1),       # ragged boundary, length 0
    (2, 2, 64, 100, 64, None, 2 ** 31 - 2, 0.3),  # no lengths, D = 64
    (3, 1, 40, 130, 16, [130, 57, 0], 9, 0.0),   # no dropout
])
def test_training_attention_matches_pallas_interpret(b, h, tq, tk, d, lens,
                                                     seed, rate):
    q, k, v, co = _inputs(b, h, tq, tk, d, 0)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jfa._flash_forward(jq, jk, jv, jl, None, 32, 32, True,
                                  return_lse=True,
                                  dropout_seed=jnp.int32(seed),
                                  dropout_rate=rate)
    lse = np.asarray(lse).reshape(b, h, -1)[:, :, :tq]

    def loss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, jl, None, 32, 32, True,
                                jnp.int32(seed), rate)
        return jnp.sum(o * co)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)

    tl = None if lens is None else torch.tensor(lens)
    got_out, got_lse = fa.flash_attention_fwd_lse(
        *map(torch.from_numpy, (q, k, v)), tl, None, seed, rate)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(got_lse.numpy(), lse, atol=FWD_ATOL, rtol=1e-6)
    tq_, tk_, tv_ = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = fa.flash_attention(tq_, tk_, tv_, tl, dropout_seed=seed,
                           dropout_rate=rate)
    (o * torch.from_numpy(co)).sum().backward()
    for got, want, name in zip((tq_.grad, tk_.grad, tv_.grad), grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")
    if lens is not None:
        dead = np.asarray(lens) == 0
        assert (got_lse.numpy()[dead] == fa.NEG_INF).all()
        for t in (tq_, tk_, tv_):
            assert (t.grad.numpy()[dead] == 0).all()


def test_dropout_without_a_seed_raises():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, dropout_rate=0.1)


@pytest.mark.parametrize("tk,train,reached", [
    (1100, True, "lse"),        # long rows, dropout: the training kernel
    (1100, False, "serve"),     # long rows, eval: the serving form
    (249, True, "eager"),       # short rows under dropout: eager path
    (249, False, "short"),
])
def test_training_dispatch(monkeypatch, tk, train, reached):
    calls = []
    monkeypatch.setattr(fa, "flash_attention_short",
                        lambda *a, **k: calls.append("short") or a[0])
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: calls.append(
        "lse" if k.get("dropout_rate", 0.0) > 0 else "serve") or a[0])
    rng = StepRNG(torch.Generator().manual_seed(0),
                  torch.Generator().manual_seed(1))
    q = torch.zeros(1, 2, 8, 16)
    kv = torch.zeros(1, 2, tk, 16)
    out = tattn.scaled_dot_product_attention(q, kv, kv, dropout_rate=0.1,
                                             rng=rng, train=train)
    assert calls == ([] if reached == "eager" else [reached])
    assert out.shape == q.shape


def test_eager_dropout_scales_kept_weights():
    rng = StepRNG(torch.Generator().manual_seed(0),
                  torch.Generator().manual_seed(1))
    q = torch.zeros(1, 1, 600, 16)
    v = torch.ones(1, 1, 600, 16)
    out = tattn.scaled_dot_product_attention(q, q, v, dropout_rate=0.5,
                                             rng=rng, train=True)
    # uniform weights 1/600, half kept at 2x: each output ≈ 1 ± 0.1
    assert not torch.allclose(out, torch.ones_like(out))
    assert (out - 1).abs().max() < 0.25


def test_short_attention_cpu_path_has_gradients():
    q, k, v, co = _inputs(2, 2, 30, 30, 16, 3)
    lens = torch.tensor([30, 11])
    grads = []
    for fn in (fa.flash_attention_short, fa.attention_reference):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        (fn(*ts, lens) * torch.from_numpy(co)).sum().backward()
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_fused_frontend_cpu_path_sends_gradients_to_the_module():
    """The fused frontend's CPU path (repacked from the module's own
    tensors) gives the per-layer path's gradients w.r.t. the conv and
    LayerNorm parameters and the wav."""
    cfg = Wav2Vec2Config(**dict(TINY_ARCH, conv_dim=(64,) * 7))
    tree = init_params(cfg, torch.Generator().manual_seed(5))
    holder = torch.nn.Module()
    holder.feature_extractor = ConvFeatureExtractor(cfg)
    load_jax_params({"wav2vec2": {"feature_extractor": tree["wav2vec2"]
                                  ["encoder"]["feature_extractor"]}}, holder)
    ext = holder.feature_extractor
    wav0 = np.random.default_rng(6).normal(size=(2, 2000)).astype(np.float32)
    grads = {}
    for fused in (True, False):
        ext.zero_grad()
        wav = torch.tensor(wav0, requires_grad=True)
        out = ext(wav, fused=fused)
        (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
        grads[fused] = [wav.grad] + [p.grad.clone() for p in ext.parameters()]
    assert cf.can_fuse(cfg, torch.zeros(2, 2000))
    for got, want in zip(grads[True], grads[False]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)
