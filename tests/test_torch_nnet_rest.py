"""Port parity, the rest of ``nnet/``: ``Linear`` with and without bias,
combined dims and the max-norm constraint, every conv with each padding and
padding mode, the norms, the activations, ``Dropout2d``, pooling, the
containers and the attention family, against the JAX package on the CPU,
same numpy weights and inputs, f32."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.nnet import activations as jact
from svt_speechbrain_tpu.nnet import attention as jatt
from svt_speechbrain_tpu.nnet import cnn as jcnn
from svt_speechbrain_tpu.nnet import containers as jcont
from svt_speechbrain_tpu.nnet import dropout as jdrop
from svt_speechbrain_tpu.nnet import linear as jlin
from svt_speechbrain_tpu.nnet import normalization as jnorm
from svt_speechbrain_tpu.nnet import pooling as jpool
from svt_speechbrain_tpu.ops.quant import quantize_weight as jquantize

from svt_speechbrain_tpu_torch.convert_jax import (init_modules,
                                                   load_module_tree,
                                                   module_tree, seeded_tree)
from svt_speechbrain_tpu_torch.nnet import activations as tact
from svt_speechbrain_tpu_torch.nnet import attention as tatt
from svt_speechbrain_tpu_torch.nnet import cnn as tcnn
from svt_speechbrain_tpu_torch.nnet import containers as tcont
from svt_speechbrain_tpu_torch.nnet import dropout as tdrop
from svt_speechbrain_tpu_torch.nnet import linear as tlin
from svt_speechbrain_tpu_torch.nnet import normalization as tnorm
from svt_speechbrain_tpu_torch.nnet import pooling as tpool
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides, outputs of order 1: summation order only
ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(jmod, tmod, seed=0):
    """The port's seeded tree of ``tmod`` (which must have the shapes of the
    JAX ``init``, traced without running it), loaded into ``tmod``; returns
    it as ``jmod``'s params. Drawing on the port's side keeps JAX's
    per-shape PRNG compiles out of the tests."""
    tree = seeded_tree(tmod, torch.Generator().manual_seed(seed))
    want = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    assert [(k, v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(want)] == [
        (k, v.shape) for k, v in jax.tree_util.tree_leaves_with_path(tree)]
    load_module_tree(tmod, tree)
    return _as_params(want, tree)


def _as_params(want, tree):
    """``tree`` in the structure of ``want``, with its empty sub-trees."""
    if isinstance(want, dict):
        return {k: _as_params(v, (tree or {}).get(k)) for k, v in
                want.items()}
    return jnp.asarray(tree)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, _np(want), atol=atol, rtol=0)


# ----------------------------------------------------------------- linear
@pytest.mark.parametrize("bias,combine", [(True, False), (False, False),
                                          (True, True), (False, True)])
def test_linear_bias_and_combine_dims(bias, combine):
    jl = jlin.Linear(6, 12 if combine else 4, bias=bias,
                     combine_dims=combine)
    tl = tlin.Linear(6, 12 if combine else 4, bias=bias,
                     combine_dims=combine)
    params = _pair(jl, tl)
    x = _x((2, 5, 3, 4) if combine else (2, 5, 4))
    assert (tl.b is None) == (not bias)
    _close(tl(torch.from_numpy(x)), jl(params, jnp.asarray(x)))
    assert sorted(module_tree(tl)) == sorted(params)


def test_linear_with_constraint():
    jl, tl = (jlin.LinearWithConstraint(5, 7, max_norm=0.3),
              tlin.LinearWithConstraint(5, 7, max_norm=0.3))
    params = _pair(jl, tl)
    x = _x((3, 7))
    _close(tl(torch.from_numpy(x)), jl(params, jnp.asarray(x)))


def test_bias_free_linear_int8_route():
    """``to_int8_`` on a bias-free ``Linear``: the int8 product alone, as
    the JAX layer with ``w_q8``/``w_scale`` and no ``b``."""
    jl = jlin.Linear(8, 16, bias=False)
    w8, scale = jquantize(jnp.asarray(_x((16, 8), 3)))
    tl = tlin.Linear(8, 16, bias=False)
    tl.to_int8_("w", torch.tensor(np.asarray(w8)),
                torch.tensor(np.asarray(scale)))
    x = _x((2, 3, 16))
    want = jl({"w_q8": w8, "w_scale": scale}, jnp.asarray(x))
    _close(tl(torch.from_numpy(x)), want)


# ------------------------------------------------------------------ convs
_CONV_CASES = [(1, 3, 1, 1), (1, 4, 1, 1), (1, 4, 2, 1), (1, 5, 1, 2),
               (1, 3, 3, 1), (2, (3, 3), 1, 1), (2, (2, 4), 1, 1),
               (2, (3, 2), (2, 1), 1)]


@pytest.mark.parametrize("ndim,k,s,d", _CONV_CASES)
@pytest.mark.parametrize("padding,mode", [
    ("same", "zeros"), ("same", "reflect"), ("same", "replicate"),
    ("same", "circular"), ("causal", "zeros"), ("causal", "reflect"),
    ("valid", "zeros")])
def test_conv_padding_and_modes(ndim, k, s, d, padding, mode):
    jcls, tcls = ((jcnn.Conv1d, tcnn.Conv1d) if ndim == 1
                  else (jcnn.Conv2d, tcnn.Conv2d))
    kwargs = dict(stride=s, dilation=d, padding=padding, padding_mode=mode)
    jc, tc = jcls(6, k, 4, **kwargs), tcls(6, k, 4, **kwargs)
    params = _pair(jc, tc, seed=ndim)
    x = _x((2, 13, 4) if ndim == 1 else (2, 9, 8, 4))
    got, want = tc(torch.from_numpy(x)), jc(params, jnp.asarray(x))
    assert got.shape == want.shape
    _close(got, want)
    if ndim == 1:
        assert got.shape[1] == tcnn.conv_output_length(13, k, s, padding, d)


def test_conv3d_grouped_causal_and_round_trip():
    jc = jcnn.Conv3d(4, (2, 3, 3), 2, padding="causal", groups=2)
    tc = tcnn.Conv3d(4, (2, 3, 3), 2, padding="causal", groups=2)
    params = _pair(jc, tc)
    x = _x((1, 4, 6, 6, 2))
    _close(tc(torch.from_numpy(x)), jc(params, jnp.asarray(x)))
    back = module_tree(tc)
    np.testing.assert_array_equal(back["w"], np.asarray(params["w"]))


def test_conv_transpose_and_separable():
    jt, tt = (jcnn.ConvTranspose1d(5, 4, 3, stride=2, padding=1,
                                   output_padding=1),
              tcnn.ConvTranspose1d(5, 4, 3, stride=2, padding=1,
                                   output_padding=1))
    params = _pair(jt, tt)
    x = _x((2, 7, 3))
    _close(tt(torch.from_numpy(x)), jt(params, jnp.asarray(x)))
    np.testing.assert_array_equal(module_tree(tt)["w"], np.asarray(params["w"]))
    for jcls, tcls, shape in ((jcnn.DepthwiseSeparableConv1d,
                               tcnn.DepthwiseSeparableConv1d, (2, 11, 4)),
                              (jcnn.DepthwiseSeparableConv2d,
                               tcnn.DepthwiseSeparableConv2d, (2, 7, 6, 4))):
        jm, tm = jcls(6, 3, 4), tcls(6, 3, 4)
        params = _pair(jm, tm)
        x = _x(shape)
        _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))


def test_sinc_conv_and_constrained_conv2d():
    js, ts = jcnn.SincConv(6, 30, padding="same"), tcnn.SincConv(6, 30)
    params = js.init(None)
    np.testing.assert_array_equal(ts.low_hz.detach().numpy(),
                                  np.asarray(params["low_hz"]))
    np.testing.assert_array_equal(ts.band_hz.detach().numpy(),
                                  np.asarray(params["band_hz"]))
    x = _x((2, 80, 1))
    # the filters reach ~0.5 in magnitude over 31 taps: outputs of order 3
    _close(ts(torch.from_numpy(x)), js(params, jnp.asarray(x)), atol=3e-5)
    jc = jcnn.Conv2dWithConstraint(5, 3, 2, max_norm=0.4)
    tc = tcnn.Conv2dWithConstraint(5, 3, 2, max_norm=0.4)
    params = _pair(jc, tc)
    x = _x((1, 6, 5, 2))
    _close(tc(torch.from_numpy(x)), jc(params, jnp.asarray(x)))


@pytest.mark.parametrize("args", [(16, 1, 5, 1), (16, 2, 4, 1),
                                  (15, 1, 4, 2), (9, 3, 3, 1)])
def test_padding_helpers(args):
    assert tcnn.get_padding_elem(*args) == jcnn.get_padding_elem(*args)
    l_in, stride, k, d = args
    assert (tcnn.get_padding_elem_transposed(2 * l_in, l_in, stride, k, d, 0)
            == jcnn.get_padding_elem_transposed(2 * l_in, l_in, stride, k,
                                                d, 0))


# ------------------------------------------------------------------ norms
@pytest.mark.parametrize("affine", [True, False])
def test_layer_and_group_norm_affine(affine):
    x = _x((2, 5, 8), scale=3.0)
    for jm, tm in ((jnorm.LayerNorm(8, elementwise_affine=affine),
                    tnorm.LayerNorm(8, elementwise_affine=affine)),
                   (jnorm.GroupNorm(8, 4, affine=affine),
                    tnorm.GroupNorm(8, 4, affine=affine))):
        params = jm.init(None)
        if affine:
            params = {"scale": jnp.asarray(_x((8,), 1)),
                      "bias": jnp.asarray(_x((8,), 2))}
        load_module_tree(tm, _tree(params))
        _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))
    assert tnorm.LayerNorm(elementwise_affine=False)(
        torch.from_numpy(x)).shape == x.shape


def test_instance_norms():
    """Without affine, both against the JAX modules. With affine, per
    channel: ``InstanceNorm2d`` against the JAX module, ``InstanceNorm1d``
    against the JAX ``layer_norm`` over time with the scale applied per
    channel (the JAX module applies it along time; ROADMAP.md queue 3)."""
    x1, x2 = _x((2, 6, 3), scale=2.0), _x((2, 5, 4, 3), scale=2.0)
    _close(tnorm.InstanceNorm1d(3)(torch.from_numpy(x1)),
           jnorm.InstanceNorm1d(3)({}, jnp.asarray(x1)))
    _close(tnorm.InstanceNorm2d(3)(torch.from_numpy(x2)),
           jnorm.InstanceNorm2d(3)({}, jnp.asarray(x2)))
    params = {"scale": _x((3,), 1), "bias": _x((3,), 2)}
    t1, t2 = (tnorm.InstanceNorm1d(3, affine=True),
              tnorm.InstanceNorm2d(3, affine=True))
    load_module_tree(t1, params)
    load_module_tree(t2, params)
    want1 = jnorm.layer_norm(jnp.asarray(x1).swapaxes(1, 2)).swapaxes(1, 2)
    _close(t1(torch.from_numpy(x1)), want1 * params["scale"] + params["bias"])
    _close(t2(torch.from_numpy(x2)),
           jnorm.InstanceNorm2d(3, affine=True)(params, jnp.asarray(x2)))


# ------------------------------------------------------------ activations
def test_gelu_swish():
    x = np.linspace(-6, 6, 301, dtype=np.float32)
    for approx in (False, True):
        _close(tact.GELU(approx)(torch.from_numpy(x)),
               jact.GELU(approx)({}, jnp.asarray(x)))
    _close(tact.Swish(1.7)(torch.from_numpy(x)),
           jact.Swish(1.7)({}, jnp.asarray(x)))


@pytest.mark.parametrize("hard,apply_log", [(False, False), (True, False),
                                            (False, True)])
def test_gumbel_softmax_on_the_same_noise(hard, apply_log):
    """The JAX module's noise (``uniform(rng, minval=1e-20)``) handed to the
    port's ``from_uniform``; the straight-through gradient is the soft
    sample's."""
    x = _x((3, 5), scale=2.0)
    key = jax.random.PRNGKey(7)
    u = jax.random.uniform(key, x.shape, minval=1e-20, maxval=1.0)
    jm = jact.GumbelSoftmax(0.7, hard=hard, apply_log=apply_log)
    tm = tact.GumbelSoftmax(0.7, hard=hard, apply_log=apply_log)
    tx = torch.from_numpy(x).requires_grad_()
    got = tm.from_uniform(tx, torch.from_numpy(np.asarray(u)))
    _close(got, jm({}, jnp.asarray(x), rng=key))
    w = _x((3, 5), 5)
    got.mul(torch.from_numpy(w)).sum().backward()
    jgrad = jax.grad(lambda v: jnp.sum(jm({}, v, rng=key) * w))(jnp.asarray(x))
    _close(tx.grad, jgrad, atol=1e-4)
    drawn = tm(torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert drawn.shape == x.shape and torch.isfinite(drawn).all()


def test_dropout2d_masks_whole_channels():
    x = torch.ones(64, 5, 32)
    y = tdrop.Dropout2d(0.25)(x, torch.Generator().manual_seed(0),
                              train=True)
    assert set(y.unique().tolist()) <= {0.0, np.float32(1 / 0.75)}
    assert bool((y == y[:, :1]).all())            # one draw per channel
    kept = (y[:, 0] > 0).float().mean().item()
    assert abs(kept - 0.75) < 0.04
    assert torch.equal(tdrop.Dropout2d(0.25)(x), x)
    jy = jdrop.Dropout2d(0.25)({}, jnp.ones((4, 5, 8)))
    assert np.all(np.asarray(jy) == 1.0)


# ---------------------------------------------------------------- pooling
@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("k,s,p", [(2, None, 0), (3, 2, 1), (4, 1, 2)])
def test_pooling(pool_type, k, s, p):
    x = _x((2, 11, 3))
    _close(tpool.Pooling1d(pool_type, k, s, p)(torch.from_numpy(x)),
           jpool.Pooling1d(pool_type, k, s, p)({}, jnp.asarray(x)))
    x2 = _x((2, 9, 8, 3))
    k2, s2 = (k, 2), (s, 1) if s else None
    _close(tpool.Pooling2d(pool_type, k2, s2, (p, 0))(torch.from_numpy(x2)),
           jpool.Pooling2d(pool_type, k2, s2, (p, 0))({}, jnp.asarray(x2)))


def test_statistics_and_adaptive_pooling():
    x = _x((3, 10, 4))
    lengths = np.asarray([1.0, 0.55, 0.1], np.float32)
    for sp in ((True, True), (True, False), (False, True)):
        tm, jm = tpool.StatisticsPooling(*sp), jpool.StatisticsPooling(*sp)
        _close(tm(torch.from_numpy(x)), jm({}, jnp.asarray(x)))
        _close(tm(torch.from_numpy(x), torch.from_numpy(lengths)),
               jm({}, jnp.asarray(x), jnp.asarray(lengths)))
    x4 = _x((2, 7, 5, 3))
    _close(tpool.AdaptiveAvgPool2d()(torch.from_numpy(x4)),
           jpool.AdaptiveAvgPool2d()({}, jnp.asarray(x4)))
    with pytest.raises(NotImplementedError):
        tpool.AdaptiveAvgPool2d((2, 2))(torch.from_numpy(x4))
    for size, arr in ((3, x), (4, x), ((3, 2), x4), ((7, 5), x4)):
        _close(tpool.AdaptivePool(size)(torch.from_numpy(arr)),
               jpool.AdaptivePool(size)({}, jnp.asarray(arr)))


# ------------------------------------------------------------- containers
def test_containers():
    x = _x((2, 3, 6))
    js = jcont.Sequential(jlin.Linear(6, 6), jlin.Linear(4, 6))
    ts = tcont.Sequential(tlin.Linear(6, 6), tlin.Linear(4, 6))
    params = _pair(js, ts)
    _close(ts(torch.from_numpy(x)), js(params, jnp.asarray(x)))
    jl = jcont.LengthsCapableSequential(jlin.Linear(6, 6),
                                        jpool.StatisticsPooling())
    tl = tcont.LengthsCapableSequential(tlin.Linear(6, 6),
                                        tpool.StatisticsPooling())
    params = _pair(jl, tl)
    lengths = np.asarray([1.0, 0.67], np.float32)
    _close(tl(torch.from_numpy(x), lengths=torch.from_numpy(lengths)),
           jl(params, jnp.asarray(x), lengths=jnp.asarray(lengths)))
    for kind in ("residual", "dense", "skip"):
        jc = jcont.ConnectBlocks(jlin.Linear(6, 6), jlin.Linear(6, 6),
                                 jlin.Linear(4, 6), shortcut_type=kind)
        tc = tcont.ConnectBlocks(tlin.Linear(6, 6), tlin.Linear(6, 6),
                                 tlin.Linear(4, 6), shortcut_type=kind)
        params = _pair(jc, tc, seed=1)
        _close(tc(torch.from_numpy(x)), jc(params, jnp.asarray(x)))
    jm = jcont.ModuleList(jlin.Linear(3, 6), jlin.Linear(6, 3))
    tm = tcont.ModuleList(tlin.Linear(3, 6), tlin.Linear(6, 3))
    params = _pair(jm, tm)
    _close(tm[1](tm[0](torch.from_numpy(x))),
           jm[1](params["1"], jm[0](params["0"], jnp.asarray(x))))
    assert len(tm) == len(jm) == 2


# -------------------------------------------------------------- attention
def test_rel_pos_mha_xl():
    d, h = 12, 3
    x = _x((2, 6, d))
    _close(tatt.RelPosEncXL(d)(torch.from_numpy(x)),
           jatt.RelPosEncXL(d)({}, jnp.asarray(x)))
    jm, tm = jatt.RelPosMHAXL(d, h), tatt.RelPosMHAXL(d, h)
    params = _pair(jm, tm)
    pos = jatt.RelPosEncXL(d)({}, jnp.asarray(x))
    kpm = np.arange(6)[None, :] >= np.asarray([6, 4])[:, None]
    causal = np.triu(np.ones((6, 6), bool), 1)
    for am, km in ((None, None), (causal, kpm)):
        got = tm(*[torch.from_numpy(x)] * 3, torch.from_numpy(np.asarray(pos)),
                 attn_mask=None if am is None else torch.from_numpy(am),
                 key_padding_mask=None if km is None else torch.from_numpy(km))
        want = jm(params, *[jnp.asarray(x)] * 3, pos_embs=pos,
                  attn_mask=None if am is None else jnp.asarray(am),
                  key_padding_mask=None if km is None else jnp.asarray(km))
        _close(got[0], want[0])
        _close(got[1], want[1])
    shifted = tatt.RelPosMHAXL._rel_shift(torch.from_numpy(_x((1, 2, 4, 7))))
    _close(shifted, jatt.RelPosMHAXL._rel_shift(jnp.asarray(_x((1, 2, 4, 7)))))


@pytest.mark.parametrize("kind", ["content", "location", "keyvalue"])
def test_rnn_attentions(kind):
    enc, dec = _x((3, 9, 10)), _x((3, 7), 1)
    enc_len = np.asarray([9, 5, 1])
    if kind == "content":
        jm, tm = (jatt.ContentBasedAttention(10, 7, 8, 6, scaling=1.5),
                  tatt.ContentBasedAttention(10, 7, 8, 6, scaling=1.5))
    elif kind == "location":
        jm, tm = (jatt.LocationAwareAttention(10, 7, 8, 6, 3, 2),
                  tatt.LocationAwareAttention(10, 7, 8, 6, 3, 2))
    else:
        jm, tm = (jatt.KeyValueAttention(10, 7, 8, 6),
                  tatt.KeyValueAttention(10, 7, 8, 6))
    params = _pair(jm, tm)
    args = (jnp.asarray(enc), jnp.asarray(enc_len), jnp.asarray(dec))
    targs = (torch.from_numpy(enc), torch.from_numpy(enc_len),
             torch.from_numpy(dec))
    want = jm(params, *args)
    got = tm(*targs)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert float(got[1].reshape(3, 9)[2, 1:].abs().max()) == 0.0
    if kind == "location":                       # a given previous step
        prev = np.asarray(want[1])
        want2 = jm(params, *args, prev_attn=jnp.asarray(prev))
        got2 = tm(*targs, prev_attn=torch.from_numpy(prev),
                  enc_h=tm.mlp_enc(targs[0]))
        _close(got2[0], want2[0])
        _close(got2[1], want2[1])


def test_step_rng_dropout_in_rel_pos_attention():
    """Attention dropout in training, from the step's device generator:
    the weights' rows no longer sum to 1, and eval is the identity."""
    tm = tatt.RelPosMHAXL(8, 2, dropout=0.5)
    init_modules({"attn": tm}, 0)
    x = torch.from_numpy(_x((2, 5, 8)))
    pos = tatt.RelPosEncXL(8)(x)
    rng = StepRNG(torch.Generator().manual_seed(0),
                  torch.Generator().manual_seed(1))
    _, w_train = tm(x, x, x, pos, rng=rng, train=True)
    _, w_eval = tm(x, x, x, pos)
    assert not torch.allclose(w_train, w_eval)
    torch.testing.assert_close(w_eval.sum(-1), torch.ones(2, 5))
