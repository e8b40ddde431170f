"""Port parity, ``models/separation.py``: the TasNet and Conv-TasNet
encoders and decoders, gLN/cLN, the TCN blocks and ``MaskNet``, the
dual-path blocks and ``Dual_Path_Model`` (its ``_segment``/``_over_add``,
with and without the intra/inter linears, norms, skips, global positions,
transformer or RNN blocks), ``SepFormer``, the extra blocks; against the
JAX package on the CPU with the same numpy weights (the JAX ``init``'s,
carried across by ``convert_jax``) and inputs, f32; and one Adam step of
``chip_smoke.py``'s phase-24 assembly (SI-SNR under PIT, the gradient
norm clipped to 5) against ``jax.grad`` and optax."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import chip_smoke as cs
from svt_speechbrain_tpu.models import separation as jsep
from svt_speechbrain_tpu.nnet import losses as jlosses

from svt_speechbrain_tpu_torch.convert_jax import (load_module_tree,
                                                   module_tree)
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.models import separation as tsep
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides, outputs of order 1: the summation order only
ATOL = 2e-5
# the step: the loss to 1e-5; each gradient leaf within 1e-4 of its norm
# (sums over thousands of frames through norms in other orders); each
# parameter's Adam update within 1e-3 of its own norm (the first update is
# about lr·sign(g), so elements whose gradient is near 0 carry the error;
# read as (after - before) in f32 it also carries the rounding of the
# parameter)
LOSS_RTOL, GRAD_RTOL, UPDATE_RTOL = 1e-5, 1e-4, 1e-3
# a leaf whose JAX gradient is under this share of the gradient norm is
# held to that bound only
ZERO_SHARE = 1e-6


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _params(jmod, seed=0):
    """The JAX ``init``'s tree as numpy, norm affines moved off one and
    zero so that they count."""
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, v):
        key = jax.tree_util.keystr(path)
        if key.endswith(("['scale']", "['bias']")) and v.ndim == 1:
            return (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(perturb, params)


def _run(jmod, params, *args):
    """The JAX module's forward, jitted (one compile, not one an op)."""
    return jax.jit(lambda p, *a: jmod(p, *a))(params, *args)


def _loaded(tmod, params):
    load_module_tree(tmod, params)
    return tmod


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("t", [30, 25, 23])
def test_segment_and_over_add(t):
    """T % K of 0, of K - P (the gap is a whole chunk) and 3, K 10."""
    jm = jsep.Dual_Path_Model(4, 4, jsep.IdentityBlock(),
                              jsep.IdentityBlock(), K=10)
    tm = tsep.Dual_Path_Model(4, 4, tsep.IdentityBlock(),
                              tsep.IdentityBlock(), K=10)
    x = _x((2, t, 4))
    (js, jgap), (ts, tgap) = jm._segment(jnp.asarray(x)), tm._segment(
        torch.from_numpy(x))
    assert tgap == jgap
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    y = _x(tuple(js.shape), seed=1)
    np.testing.assert_array_equal(
        tm._over_add(torch.from_numpy(y), tgap).numpy(),
        np.asarray(jm._over_add(jnp.asarray(y), jgap)))
    # every frame lies in two chunks: the round trip doubles it
    _close(tm._over_add(ts, tgap), 2 * x)


@pytest.mark.parametrize("shape", [(2, 7, 6), (2, 3, 5, 6)])
@pytest.mark.parametrize("name", ["GlobalLayerNorm", "ChannelwiseLayerNorm"])
def test_layer_norms(name, shape):
    """gLN over every non-batch axis of a 3-D and a 4-D (B, S, K, d)
    tensor; cLN over the channels."""
    jm = getattr(jsep, name)(6)
    params = _params(jm)
    x = _x(shape, scale=3.0)
    _close(_loaded(getattr(tsep, name)(6), params)(torch.from_numpy(x)),
           _run(jm, params, jnp.asarray(x)))
    assert tsep.CumulativeLayerNorm is tsep.ChannelwiseLayerNorm


def test_tasnet_encoder_decoder():
    je, jd = jsep.TasNetEncoder(16, 8), jsep.TasNetDecoder(16, 8)
    pe, pd = _params(je), _params(jd, 1)
    te, td = _loaded(tsep.TasNetEncoder(16, 8), pe), _loaded(
        tsep.TasNetDecoder(16, 8), pd)
    x = _x((2, 205))
    h = _run(je, pe, jnp.asarray(x))
    _close(te(torch.from_numpy(x)), h)
    _close(td(torch.from_numpy(np.array(h))), _run(jd, pd, h))
    assert tsep.Encoder is tsep.TasNetEncoder
    assert tsep.Decoder is tsep.TasNetDecoder


@pytest.mark.parametrize("norm_type,mask,causal", [
    ("gLN", "relu", False), ("cLN", "softmax", False), ("gLN", "relu", True)])
def test_conv_tasnet(norm_type, mask, causal):
    kw = dict(n_sources=2, enc_kernel=16, enc_channels=16, bn_channels=8,
              hidden=16, n_blocks=2, n_repeats=2, norm_type=norm_type,
              causal=causal, mask_nonlinear=mask)
    jm = jsep.ConvTasNet(**kw)
    params = _params(jm)
    x = _x((2, 400))
    _close(_loaded(tsep.ConvTasNet(**kw), params)(torch.from_numpy(x)),
           _run(jm, params, jnp.asarray(x)))
    with pytest.raises(ValueError):
        tsep.MaskNet(mask_nonlinear="tanh")


def test_temporal_blocks_sequential_and_chomp():
    jm = jsep.TemporalBlocksSequential(8, 12, 3, 2, 2, "cLN")
    params = _params(jm)
    x = _x((2, 20, 8))
    _close(_loaded(tsep.TemporalBlocksSequential(8, 12, 3, 2, 2, "cLN"),
                   params)(torch.from_numpy(x)),
           _run(jm, params, jnp.asarray(x)))
    for size in (0, 3):
        np.testing.assert_array_equal(
            tsep.Chomp1d(size)(torch.from_numpy(x)).numpy(),
            np.asarray(jsep.Chomp1d(size)(None, jnp.asarray(x))))


def _blocks(kind, pkg):
    if kind == "transformer":
        return [pkg.SBTransformerBlock(1, 16, 4, 32,
                                       use_positional_encoding=True,
                                       norm_before=True) for _ in range(2)]
    if kind == "post_ln":
        return [pkg.SBTransformerBlock(1, 16, 4, 32) for _ in range(2)]
    return [pkg.SBRNNBlock(16, 8, rnn_type=kind) for _ in range(2)]


@pytest.mark.parametrize("kind,extra", [
    ("transformer", dict(linear_layer_after_inter_intra=False)),
    ("transformer", dict(use_global_pos_enc=True)),
    ("post_ln", dict(norm=None, skip_around_intra=False)),
    ("lstm", dict()),
    ("gru", dict(linear_layer_after_inter_intra=False))])
def test_dual_path_model(kind, extra):
    jm = jsep.Dual_Path_Model(8, 16, *_blocks(kind, jsep), num_layers=2, K=10,
                              **extra)
    params = _params(jm)
    tm = _loaded(tsep.Dual_Path_Model(8, 16, *_blocks(kind, tsep),
                                      num_layers=2, K=10, **extra), params)
    x = _x((2, 33, 8))
    _close(tm(torch.from_numpy(x)), _run(jm, params, jnp.asarray(x)))
    assert tm.blocks[0].intra is not tm.blocks[1].intra


def test_sepformer_wrapper():
    kw = dict(n_sources=2, enc_kernel=16, enc_channels=8, d_model=16,
              chunk_size=10, num_layers=1, nhead=4, d_ffn=32)
    jm = jsep.SepFormer(**kw)
    params = _params(jm)
    x = _x((2, 170))
    _close(_loaded(tsep.SepFormer(**kw), params)(torch.from_numpy(x)),
           _run(jm, params, jnp.asarray(x)))
    assert tsep.SepformerWrapper is tsep.SepFormer


def test_other_blocks():
    x = _x((3, 6, 16))
    jm = jsep.Dual_Computation_Block(*_blocks("transformer", jsep))
    params = _params(jm)
    x4 = _x((2, 3, 5, 16))
    _close(_loaded(tsep.Dual_Computation_Block(*_blocks("transformer", tsep)),
                   params)(torch.from_numpy(x4)), _run(jm, params, jnp.asarray(x4)))
    jm = jsep.DPTNetBlock(16, 4, 12)
    params = _params(jm)
    _close(_loaded(tsep.DPTNetBlock(16, 4, 12), params)(torch.from_numpy(x)),
           _run(jm, params, jnp.asarray(x)))
    np.testing.assert_array_equal(
        tsep.IdentityBlock()(torch.from_numpy(x)).numpy(), x)
    with pytest.raises(ImportError):
        tsep.FastTransformerBlock()
    assert tsep.select_norm is tsep.choose_norm
    assert tsep.PytorchTransformerBlock is tsep.SBTransformerBlock
    assert isinstance(tsep.choose_norm("BN", 4), tsep.BatchNorm1d)


ARCH = dict(cs.SEP_ARCH, num_layers=1, tlayers=1, nhead=4, d_ffn=32, K=10)
CHANNELS, KERNEL = 16, 8


def _jax_assembly():
    def block():
        return jsep.SBTransformerBlock(1, CHANNELS, 4, 32,
                                       use_positional_encoding=True,
                                       norm_before=True)

    return {"encoder": jsep.TasNetEncoder(KERNEL, CHANNELS),
            "masknet": jsep.Dual_Path_Model(
                CHANNELS, CHANNELS, block(), block(), num_layers=1, K=10,
                skip_around_intra=True, linear_layer_after_inter_intra=False),
            "decoder": jsep.TasNetDecoder(KERNEL, CHANNELS)}


def _jax_loss(jm, params, mix, sources):
    h = jm["encoder"](params["encoder"], mix)
    masks = jm["masknet"](params["masknet"], h)
    est = jnp.stack([jm["decoder"](params["decoder"], h * masks[:, :, s])
                     for s in range(2)], axis=-1)
    t = mix.shape[1]
    est = jnp.pad(est[:, :t], ((0, 0), (0, t - min(t, est.shape[1])), (0, 0)))
    return jlosses.get_si_snr_with_pitwrapper(sources, est)


def test_sepformer_step_matches_jax():
    """One training step of the phase-24 assembly at TINY width: the loss,
    every gradient leaf, and the parameters after Adam (lr 1.5e-4, the
    gradient norm clipped to 5) against ``jax.grad`` and optax."""
    jm = _jax_assembly()
    params = {n: _params(m, i) for i, (n, m) in enumerate(jm.items())}
    modules = cs.sepformer_modules(ARCH, CHANNELS, KERNEL)
    for name, m in modules.items():
        load_module_tree(m, params[name])
    batch = cs.sepformer_batch(np.random.default_rng(0), 2, 203)
    mix, src = (jnp.asarray(batch[k].data.numpy())
                for k in ("mix", "sources"))
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(cs.SEP_LR))

    @jax.jit
    def jax_step(params):
        loss, grads = jax.value_and_grad(
            lambda p: _jax_loss(jm, p, mix, src))(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    jloss, jgrads, want_after = jax_step(params)

    brain = cs.sepformer_brain(modules, "cpu", 0)
    arrays = brain._batch_to_device(batch)
    loss = brain.compute_objectives(
        brain.compute_forward(arrays, Stage.TRAIN), arrays, Stage.TRAIN)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    total = np.sqrt(sum(np.sum(np.square(np.asarray(g)))
                        for g in jax.tree_util.tree_leaves(jgrads)))
    for name, m in modules.items():
        got = jax.tree_util.tree_leaves_with_path(module_tree(
            _grads_as_params(m)))
        want = dict(jax.tree_util.tree_leaves_with_path(jgrads[name]))
        for path, g in got:
            w = np.asarray(want[path])
            if np.linalg.norm(w) <= ZERO_SHARE * total:
                # the attention's key bias: no gradient in exact
                # arithmetic (the softmax is shift-invariant)
                assert np.linalg.norm(g) <= ZERO_SHARE * total
                continue
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= GRAD_RTOL, (name, jax.tree_util.keystr(path), err)
    brain.modules.zero_grad(set_to_none=True)
    step_loss = brain.fit_batch(batch)
    np.testing.assert_allclose(step_loss, float(jloss), rtol=LOSS_RTOL)
    for name, m in modules.items():
        before = dict(jax.tree_util.tree_leaves_with_path(params[name]))
        after = dict(jax.tree_util.tree_leaves_with_path(want_after[name]))
        zero = dict(jax.tree_util.tree_leaves_with_path(jgrads[name]))
        for path, got in jax.tree_util.tree_leaves_with_path(module_tree(m)):
            if np.linalg.norm(zero[path]) <= ZERO_SHARE * total:
                continue
            want = np.asarray(after[path]) - before[path]
            err = (np.linalg.norm((got - before[path]) - want)
                   / np.linalg.norm(want))
            assert err <= UPDATE_RTOL, (name, jax.tree_util.keystr(path), err)


def _grads_as_params(module):
    """A copy of ``module`` whose parameters hold their gradients."""
    import copy

    twin = copy.deepcopy(module)
    with torch.no_grad():
        for (_, p), (_, q) in zip(module.named_parameters(),
                                  twin.named_parameters()):
            q.copy_(p.grad)
    return twin
