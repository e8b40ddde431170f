"""Port parity, ``nnet/complex_networks.py`` and
``nnet/quaternion_networks.py``: the packed-product, conv and rotation ops,
every layer (linear, convs, the rotation form with and without its scale,
the norms, the recurrences one and two ways, with ``hx``), forward and
every parameter's gradient against ``jax.grad``; the batch norms in
training, in eval and with a cumulative average, their buffers against the
threaded JAX state (and through the light GRUs' layers); the reference
quirks the JAX module keeps: contiguous gate slices, ``CBatchNorm``'s eps
before the running update, ``CLayerNorm``'s collapse on 2-D input,
``QBatchNorm``'s uncentred training divide and raw-variance eval; and the
seeded draws' distributions. On the CPU, f32, the JAX ``init``'s weights
carried across by ``convert_jax``."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.nnet import complex_networks as jcx
from svt_speechbrain_tpu.nnet import quaternion_networks as jqt

from svt_speechbrain_tpu_torch.convert_jax import (load_module_tree,
                                                   module_tree, seeded_tree)
from svt_speechbrain_tpu_torch.nnet import complex_networks as tcx
from svt_speechbrain_tpu_torch.nnet import quaternion_networks as tqt
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32, outputs of order 1: the summation order only; gradients within 1e-4
# of each leaf's norm (sums over B·T in other orders, through whitening)
ATOL, GRAD_RTOL = 3e-5, 1e-4
ZERO_SHARE = 1e-6


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _stateless(method):
    """JAX call (m, params, state, x) and port call (m, x) of a module
    without state; ``method`` picks the output of a tuple."""
    return (lambda m, p, s, x: (method(m(p, x)), s),
            lambda m, x: method(m(x)))


def _stateful(method):
    return (lambda m, p, s, x: (lambda o: (method(o[0]), o[1]))(
        m(p, s, x, train=True)),
            lambda m, x: method(m(x, train=True)))


def _out(o):
    return o


def _zeroth(o):
    return o[0]


# (layers, batch, 2H) initial states of a 2-layer CRNN of 4 units
HX = _x((2, 2, 8), seed=21)
CASES = {
    "CLinear": ("c", lambda P: P.CLinear(6, input_size=8), (2, 5, 8),
                _stateless(_out)),
    "CLinear unitary": ("c", lambda P: P.CLinear(
        3, input_size=8, bias=False, weight_init="unitary"), (2, 5, 8),
                        _stateless(_out)),
    "CConv1d": ("c", lambda P: P.CConv1d(4, 3, input_size=8), (2, 9, 8),
                _stateless(_out)),
    "CConv1d causal": ("c", lambda P: P.CConv1d(
        4, 3, input_size=8, padding="causal", dilation=2), (2, 9, 8),
                       _stateless(_out)),
    "CConv2d": ("c", lambda P: P.CConv2d(
        3, (3, 5), input_size=6, stride=(1, 2)), (2, 7, 9, 6),
                _stateless(_out)),
    "CLayerNorm": ("c", lambda P: P.CLayerNorm(8), (2, 5, 8),
                   _stateless(_out)),
    "CRNN": ("c", lambda P: P.CRNN(4, input_size=8, num_layers=2,
                                   bidirectional=True), (2, 6, 8),
             _stateless(_out)),
    "CRNN hx": ("c", lambda P: P.CRNN(4, input_size=8, num_layers=2,
                                      nonlinearity="relu"), (2, 6, 8),
                (lambda m, p, s, x: (m(p, x, hx=jnp.asarray(HX)), s),
                 lambda m, x: m(x, hx=torch.from_numpy(HX)))),
    "CLSTM": ("c", lambda P: P.CLSTM(3, input_size=8, return_hidden=True),
              (2, 6, 8), _stateless(_zeroth)),
    "CLiGRU": ("c", lambda P: P.CLiGRU(4, input_size=8, num_layers=2),
               (3, 6, 8), _stateful(_out)),
    "CLiGRU layernorm": ("c", lambda P: P.CLiGRU(
        4, input_size=8, normalization="layernorm", nonlinearity="tanh"),
                         (2, 6, 8), _stateful(_out)),
    "QLinear": ("q", lambda P: P.QLinear(3, input_size=8), (2, 5, 8),
                _stateless(_out)),
    "QLinear spinor": ("q", lambda P: P.QLinear(
        3, input_size=8, spinor=True), (2, 5, 8), _stateless(_out)),
    "QLinear spinor scale": ("q", lambda P: P.QLinear(
        3, input_size=8, spinor=True, vector_scale=True,
        weight_init="unitary"), (2, 5, 8), _stateless(_out)),
    "QConv1d causal": ("q", lambda P: P.QConv1d(
        3, 3, input_size=8, padding="causal"), (2, 9, 8), _stateless(_out)),
    "QConv1d spinor scale": ("q", lambda P: P.QConv1d(
        3, 3, input_size=8, spinor=True, vector_scale=True), (2, 9, 8),
                             _stateless(_out)),
    "QConv2d": ("q", lambda P: P.QConv2d(
        3, (3, 5), input_size=8, stride=(2, 1)), (2, 7, 9, 8),
                _stateless(_out)),
    "QConv2d spinor": ("q", lambda P: P.QConv2d(
        2, 3, input_size=8, spinor=True), (2, 7, 9, 8), _stateless(_out)),
    "QRNN": ("q", lambda P: P.QRNN(2, input_size=8, num_layers=2), (2, 6, 8),
             _stateless(_zeroth)),
    "QLSTM": ("q", lambda P: P.QLSTM(2, input_size=8, bidirectional=True),
              (2, 6, 8), _stateless(_zeroth)),
    "QLiGRU": ("q", lambda P: P.QLiGRU(2, input_size=8), (3, 6, 8),
               _stateful(_zeroth)),
    "QLiGRU no norm": ("q", lambda P: P.QLiGRU(
        2, input_size=8, normalization="none", nonlinearity="tanh"),
                       (2, 6, 8), _stateful(_zeroth)),
}


def _grad_tree(module):
    twin = copy.deepcopy(module)
    with torch.no_grad():
        for p, q in zip(module.parameters(), twin.parameters()):
            q.copy_(p.grad)
    return module_tree(twin)


@pytest.mark.parametrize("name", list(CASES))
def test_layer_forward_and_gradients(name):
    kind, make, shape, (jcall, tcall) = CASES[name]
    jpkg, tpkg = (jcx, tcx) if kind == "c" else (jqt, tqt)
    jm, tm = make(jpkg), make(tpkg)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)

    def perturb(path, v):   # norm affines off their constants, so that
        # no gradient is a sum that whitening cancels (γ_ri's at γ_ri = 0)
        if jax.tree_util.keystr(path).endswith(
                ("gamma_rr']", "gamma_ii']", "gamma_ri']", "beta']")):
            return (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v
    params = jax.tree_util.tree_map_with_path(perturb, params)
    state = jm.init_state() if hasattr(jm, "init_state") else None
    load_module_tree(tm, params, None if not state else _np(state))
    x = _x(shape)

    def loss(p):
        out, new_state = jcall(jm, p, state, jnp.asarray(x))
        return jnp.sum(jnp.square(out)) / out.size, (out, new_state)

    (_, (jout, jstate)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    out = tcall(tm, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=0)
    (out.square().sum() / out.numel()).backward()
    if jstate:
        got = dict(jax.tree_util.tree_leaves_with_path(
            module_tree(tm, running_stats=True)))
        for path, w in jax.tree_util.tree_leaves_with_path(_np(jstate)):
            np.testing.assert_allclose(got[path], w, atol=ATOL, rtol=0)
    want = dict(jax.tree_util.tree_leaves_with_path(_np(jgrads)))
    total = np.sqrt(sum(np.sum(np.square(w)) for w in want.values()))
    got = jax.tree_util.tree_leaves_with_path(_grad_tree(tm))
    assert len(got) == len(want)
    for path, g in got:
        w = want[path]
        if np.linalg.norm(w) <= ZERO_SHARE * total:
            assert np.linalg.norm(g) <= ZERO_SHARE * total
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("momentum,shape", [(0.1, (4, 5, 8)), (None, (6, 8))])
def test_complex_batch_norm_train_eval(momentum, shape):
    """Two training calls (eps in the running Vrr/Vii; with momentum None a
    cumulative average), then eval on the buffers, with no further eps."""
    jm = jcx.CBatchNorm(input_size=8, momentum=momentum)
    tm = tcx.CBatchNorm(input_size=8, momentum=momentum)
    params = _np(jm.init(None))
    for k in ("gamma_rr", "gamma_ii", "gamma_ri", "beta"):
        params[k] = params[k] + _x(params[k].shape, seed=9, scale=0.1)
    state = jm.init_state()
    load_module_tree(tm, params, _np(state))
    for seed in (1, 2):
        x = _x(shape, seed=seed, scale=2.0)
        jy, state = jm(params, state, jnp.asarray(x), train=True)
        np.testing.assert_allclose(tm(torch.from_numpy(x), train=True)
                                   .detach().numpy(), jy, atol=ATOL)
    got = module_tree(tm, running_stats=True)
    for k, w in _np(state).items():
        np.testing.assert_allclose(got[k], w, atol=ATOL, rtol=0)
    x = _x(shape, seed=3)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               jm(params, state, jnp.asarray(x))[0],
                               atol=ATOL)


@pytest.mark.parametrize("momentum,shape", [(0.1, (6, 8)), (None, (3, 5, 8))])
def test_quaternion_batch_norm_train_eval(momentum, shape):
    jm = jqt.QBatchNorm(input_size=8, momentum=momentum)
    tm = tqt.QBatchNorm(input_size=8, momentum=momentum)
    params = _np(jm.init(None))
    params["gamma"] = params["gamma"] + _x((2,), seed=9, scale=0.1)
    params["beta"] = _x((8,), seed=8, scale=0.1)
    state = jm.init_state()
    load_module_tree(tm, params, _np(state))
    for seed in (1, 2):
        x = _x(shape, seed=seed, scale=2.0)
        jy, state = jm(params, state, jnp.asarray(x), train=True)
        np.testing.assert_allclose(tm(torch.from_numpy(x), train=True)
                                   .detach().numpy(), jy, atol=ATOL)
    got = module_tree(tm, running_stats=True)
    for k, w in _np(state).items():
        np.testing.assert_allclose(got[k], w, atol=ATOL, rtol=0)
    x = _x(shape, seed=3)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               jm(params, state, jnp.asarray(x))[0],
                               atol=ATOL)


def test_quirks():
    """``CLayerNorm`` on 2-D input collapses to ``beta``; ``CLiGRU``'s
    layernorm mode zeroes its input projection; ``QBatchNorm`` trains on
    the uncentred input; gates are contiguous slices of the packing."""
    ln = tcx.CLayerNorm(8)
    with torch.no_grad():
        ln.beta.copy_(torch.arange(8.0))
    np.testing.assert_array_equal(ln(torch.randn(3, 8)).detach().numpy(),
                                  np.tile(np.arange(8.0), (3, 1)))
    qbn = tqt.QBatchNorm(input_size=4)
    x = torch.tensor([[1.0, 0.0, 0.0, 0.0], [3.0, 0.0, 0.0, 0.0]])
    # var of the first component 1 over 4 components summed: x / sqrt(1+eps)
    np.testing.assert_allclose(qbn(x, train=True).detach().numpy(),
                               x.numpy() / np.sqrt(1.0 + 1e-4), rtol=1e-6)
    lstm = tcx.CLSTM(2, input_size=4)
    assert lstm.l0.w.n_neurons == 8 and lstm.width == 4  # (i, f, o, c~) x 4


def test_ops():
    x = _x((2, 5, 8))
    wr, wi = _x((4, 3), seed=1), _x((4, 3), seed=2)
    b = _x((6,), seed=3)
    np.testing.assert_allclose(
        tcx.complex_linear_op(*map(torch.from_numpy, (x, wr, wi, b))),
        jcx.complex_linear_op(*map(jnp.asarray, (x, wr, wi, b))), atol=ATOL)
    np.testing.assert_array_equal(tcx.get_conjugate(torch.from_numpy(x)),
                                  jcx.get_conjugate(jnp.asarray(x)))
    np.testing.assert_allclose(
        tcx.multi_mean(torch.from_numpy(x), (0, 2), keepdim=True),
        jcx.multi_mean(jnp.asarray(x), (0, 2), keepdim=True), atol=ATOL)
    for conv1d, ws, xs in ((True, (3, 4, 3), (2, 9, 8)),
                           (False, (3, 3, 4, 3), (2, 7, 9, 8))):
        cr, ci, xx = _x(ws, seed=4), _x(ws, seed=5), _x(xs, seed=6)
        np.testing.assert_allclose(
            tcx.complex_conv_op(*map(torch.from_numpy, (xx, cr, ci)), None,
                                conv1d=conv1d),
            jcx.complex_conv_op(*map(jnp.asarray, (xx, cr, ci)), None,
                                conv1d=conv1d), atol=ATOL)
        q = [_x((ws[:-2] + (2, 3)), seed=s) for s in range(7, 11)]
        xq = xx[..., :8]
        for fn in ("quaternion_conv_op", "quaternion_conv_rotation_op"):
            np.testing.assert_allclose(
                getattr(tqt, fn)(torch.from_numpy(xq),
                                 *map(torch.from_numpy, q), None,
                                 conv1d=conv1d),
                getattr(jqt, fn)(jnp.asarray(xq), *map(jnp.asarray, q), None,
                                 conv1d=conv1d), atol=ATOL)
    q = [_x((2, 3), seed=s) for s in range(11, 15)] + [_x((12,), seed=15)]
    for fn in ("quaternion_linear_op", "quaternion_linear_rotation_op"):
        np.testing.assert_allclose(
            getattr(tqt, fn)(torch.from_numpy(x), *map(torch.from_numpy, q)),
            getattr(jqt, fn)(jnp.asarray(x), *map(jnp.asarray, q)),
            atol=ATOL)
    assert tqt.QuaternionLinearCustomBackward is tqt.quaternion_linear_op
    for pkg, names in ((tcx, ("CRNN", "CLSTM", "CLiGRU")),
                       (tqt, ("QRNN", "QLSTM", "QLiGRU"))):
        for n in names:
            assert getattr(pkg, n + "_Layer") is getattr(pkg, n)


def test_seeded_draws():
    """The port's draws have the JAX ``init``s' shapes and distributions:
    Rayleigh moduli of mean s·√(π/2), moduli just under 1 for
    ``unitary``, the quaternion moduli's mean and spread as the JAX
    draw's over 40,000 weights; the seeded trees have the JAX trees'
    structure and shapes."""
    gen = torch.Generator().manual_seed(0)
    wr, wi = tcx.complex_init(gen, 100, 400)
    s = 1.0 / 500
    np.testing.assert_allclose(np.hypot(wr, wi).mean(), s * np.sqrt(np.pi / 2),
                               rtol=0.02)
    ur, ui = tcx.unitary_init(gen, 20, 30)       # |v| / (|v| + 1e-4)
    assert (np.hypot(ur, ui) < 1).all() and np.median(np.hypot(ur, ui)) > 0.999
    comps = tqt.quaternion_init(gen, 100, 400)
    mod = np.sqrt(sum(c ** 2 for c in comps))
    jmod = np.sqrt(sum(np.asarray(c) ** 2 for c in jqt.quaternion_init(
        jax.random.PRNGKey(0), 100, 400)))
    np.testing.assert_allclose(mod.mean(), jmod.mean(), rtol=0.02)
    np.testing.assert_allclose(mod.std(), jmod.std(), rtol=0.05)
    uq = np.sqrt(sum(c ** 2 for c in tqt.unitary_init(gen, 20, 30)))
    assert (uq < 1).all() and np.median(uq) > 0.999
    for pkg, (a, b) in ((tcx, (wr, wi)), (tqt, comps[:2])):
        assert [x.shape for x in pkg.affect_init(
            a, b, *(b,) * (2 if pkg is tqt else 0),
            pkg.unitary_init, gen)] == [(100, 400)] * (2 if pkg is tcx else 4)
    for name, tm in (("CConv2d", tcx.CConv2d(3, (3, 5), input_size=6)),
                     ("QConv1d", tqt.QConv1d(3, 3, input_size=8,
                                             spinor=True,
                                             vector_scale=True)),
                     ("CLiGRU", tcx.CLiGRU(4, input_size=8))):
        tree = seeded_tree(tm, torch.Generator().manual_seed(1))
        jm = getattr(jcx if name[0] == "C" else jqt, name)(
            *({"CConv2d": (3, (3, 5)), "QConv1d": (3, 3),
               "CLiGRU": (4,)}[name]),
            input_size=6 if name == "CConv2d" else 8,
            **({"spinor": True, "vector_scale": True}
               if name == "QConv1d" else {}))
        want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(tree), name
        for w, g in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(tree)):
            assert w.shape == g.shape, name
