"""Port parity, ``models/ecapa_tdnn.py`` and ``models/xvector.py``: the TDNN,
Res2Net, SE and attentive-pooling blocks, ``ECAPA_TDNN`` and ``Xvector``
in training and in eval (the port's BatchNorm buffers against the JAX state
tree threaded through the same calls), with and without relative lengths
(one that rounds half to even), the cosine ``Classifier`` and the
``Discriminator``; against the JAX package on the CPU with the JAX
``init``'s weights carried across by ``convert_jax``, f32; and one Adam
step of ``chip_smoke.py``'s phase-25 speaker assembly (ECAPA-TDNN, the
cosine head, the additive angular margin softmax) against ``jax.grad``
and optax."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import chip_smoke as cs
from svt_speechbrain_tpu.models import ecapa_tdnn as jecapa
from svt_speechbrain_tpu.models import xvector as jxv
from svt_speechbrain_tpu.nnet import losses as jlosses

from svt_speechbrain_tpu_torch.convert_jax import (load_module_tree,
                                                   module_tree)
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.models import ecapa_tdnn as tecapa
from svt_speechbrain_tpu_torch.models import xvector as txv
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32, outputs of order 1 (after BatchNorm): the summation order only; the
# running statistics are means over B·T of order-1 values
ATOL = 2e-5
# the step: the loss to 1e-5; each gradient leaf within 5e-4 of its norm,
# wider than 1e-4: the JAX step runs jitted (XLA's fused reductions sum in
# other orders) and a BatchNorm scale's gradient sums B·T terms of both
# signs behind the norm (the worst leaf, a Res2Net norm's scale, sat at
# 1.7e-4, as the CRDNN's norm scales at 0.9-1.5e-4). Adam's first update
# is about lr·sign(g), so where a gradient is near 0 the two packages' last
# bits flip it (the pooling's attention conv: 5% of its update): the
# update is held to optax's on the port's own gradients, within 1e-3 of
# each parameter's update norm: read as (after - before) in f32, it
# carries the rounding of parameters near 1, ulp 1.2e-7 against lr 1e-3
LOSS_RTOL, GRAD_RTOL, UPDATE_RTOL = 1e-5, 5e-4, 1e-3
ZERO_SHARE = 1e-6
# 40 frames: 0.3125 · 40 = 12.5 rounds (half to even) to 12 frames
LENGTHS = np.asarray([1.0, 0.3125, 0.55], np.float32)
ECAPA_KW = dict(input_size=12, lin_neurons=10, channels=(16, 16, 16, 16, 48),
                attention_channels=8, res2net_scale=4, se_channels=8)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _params(jmod, seed=0):
    """The JAX ``init``'s tree, norm affines moved off one and zero."""
    params = jax.tree_util.tree_map(
        np.array, jax.jit(jmod.init)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, v):
        if jax.tree_util.keystr(path).endswith(("['scale']", "['bias']")):
            return (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(perturb, params)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _same_state(module, state):
    got = dict(jax.tree_util.tree_leaves_with_path(
        module_tree(module, running_stats=True)))
    want = jax.tree_util.tree_leaves_with_path(_np(state))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], w, atol=ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_ecapa_train_and_eval_with_state(lengths):
    """A training call (batch statistics, the running update) then an eval
    call on the updated statistics; the JAX state threaded alongside."""
    jm = jecapa.ECAPA_TDNN(**ECAPA_KW)
    params = _params(jm)
    tm = tecapa.ECAPA_TDNN(**ECAPA_KW)
    load_module_tree(tm, params, _np(jm.init_state()))
    x = _x((3, 40, 12), scale=2.0)
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    run = jax.jit(lambda p, s, x, train: jm(p, x, lengths=jl, state=s,
                                            train=train),
                  static_argnums=3)
    jy, state = run(params, jm.init_state(), jnp.asarray(x), True)
    _close(tm(torch.from_numpy(x), lengths=tl, train=True), jy)
    _same_state(tm, state)
    jy, _ = run(params, state, jnp.asarray(x), False)
    _close(tm(torch.from_numpy(x), lengths=tl), jy)


@pytest.mark.parametrize("global_context", [True, False])
def test_attentive_pooling_and_se(global_context):
    jm = jecapa.AttentiveStatisticsPooling(8, 4, global_context)
    params = _params(jm)
    tm = tecapa.AttentiveStatisticsPooling(8, 4, global_context)
    load_module_tree(tm, params)
    x = _x((3, 40, 8))
    jy, _ = jax.jit(lambda p, x: jm(p, x, jm.init_state(),
                                    lengths=jnp.asarray(LENGTHS)))(
        params, jnp.asarray(x))
    _close(tm(torch.from_numpy(x), lengths=torch.from_numpy(LENGTHS)), jy)
    js = jecapa.SEBlock(8, 4, 8)
    ps = _params(js, 1)
    ts = tecapa.SEBlock(8, 4, 8)
    load_module_tree(ts, ps)
    for lens in (None, LENGTHS):
        _close(ts(torch.from_numpy(x),
                  None if lens is None else torch.from_numpy(lens)),
               js(ps, jnp.asarray(x), None if lens is None
                  else jnp.asarray(lens)))


def test_half_to_even_frame_count():
    """12.5 frames round to 12 in both packages (``jnp.round`` and
    ``torch.round`` round half to even), so frame 12 is masked."""
    n, mask = tecapa._frame_mask(torch.tensor([0.3125]), 40,
                                 torch.zeros(1, 40, 1))
    assert float(n[0]) == 12.0 and mask[0, 11, 0] == 1 and mask[0, 12, 0] == 0
    assert float(jnp.round(jnp.float32(0.3125) * 40)) == 12.0


def test_classifier_eps_on_the_norm():
    """The cosine head adds 1e-9 to each norm: held on a row whose norm
    is 1e-7, where an eps on the square would give another cosine."""
    jm = jecapa.Classifier(6, 5, 7)
    params = _params(jm)
    params["weight"][0] = params["weight"][0] / np.linalg.norm(
        params["weight"][0]) * 1e-7
    tm = tecapa.Classifier(6, 5, 7)
    load_module_tree(tm, params)
    x = _x((2, 1, 6))
    _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)), atol=1e-6)


@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_xvector_train_and_eval(lengths):
    kw = dict(in_channels=12, tdnn_channels=(16, 16, 16, 16, 24),
              lin_neurons=10)
    jm = jxv.Xvector(**kw)
    params = _params(jm)
    tm = txv.Xvector(**kw)
    load_module_tree(tm, params, _np(jm.init_state()))
    x = _x((3, 40, 12))
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    run = jax.jit(lambda p, s, x, train: jm(p, x, lengths=jl, state=s,
                                            train=train), static_argnums=3)
    jy, state = run(params, jm.init_state(), jnp.asarray(x), True)
    _close(tm(torch.from_numpy(x), lengths=tl, train=True), jy)
    _same_state(tm, state)
    jy, _ = run(params, state, jnp.asarray(x), False)
    _close(tm(torch.from_numpy(x), lengths=tl), jy)


def test_discriminator():
    jm = jxv.Discriminator(10, 2, 12)
    params = _params(jm)
    tm = txv.Discriminator(10, 2, 12)
    load_module_tree(tm, params)
    x = _x((4, 10))
    _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))


def test_ecapa_aam_step_matches_jax():
    """One training step of the phase-25 assembly at TINY width (Fbank of
    12 mels): the loss, every gradient and the running statistics against
    ``jax.grad``; the parameters after the Brain's Adam step (lr 1e-3, the
    gradient norm clipped to 5) against optax on the same gradients."""
    from svt_speechbrain_tpu.models import features as jfeat

    arch = dict(cs.ECAPA_ARCH, **{k: v for k, v in ECAPA_KW.items()})
    modules = cs.ecapa_modules(arch, speakers=9)
    jm = {"embedding_model": jecapa.ECAPA_TDNN(**ECAPA_KW),
          "classifier": jecapa.Classifier(10, 10, 9)}
    fbank = jfeat.Fbank(n_mels=12)
    params = {n: _params(m, i) for i, (n, m) in enumerate(jm.items())}
    state = jm["embedding_model"].init_state()
    for name, p in params.items():
        load_module_tree(modules[name], p, _np(state) if
                         name == "embedding_model" else None)
    wav, lens = cs.speech_rows(np.random.default_rng(0), (0.3, 0.25, 0.2))
    spk = np.asarray([3, 0, 8])
    batch = {"sig": cs.PaddedData(torch.from_numpy(wav), lens),
             "spk_id": torch.from_numpy(spk)}
    crit = jlosses.LogSoftmaxWrapper(jlosses.AdditiveAngularMargin(
        cs.ECAPA_MARGIN, cs.ECAPA_SCALE))
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(cs.ECAPA_LR))

    def loss_fn(p):
        feats = fbank(None, jnp.asarray(wav))
        emb, new_state = jm["embedding_model"](
            p["embedding_model"], feats, lengths=jnp.asarray(lens),
            state=state, train=True)
        return crit(jm["classifier"](p["classifier"], emb), spk), new_state

    @jax.jit
    def jax_grads(p):
        (loss, new_state), grads = jax.value_and_grad(loss_fn,
                                                      has_aux=True)(p)
        return loss, new_state, grads

    jloss, jstate, jgrads = jax_grads(params)
    brain = cs.ecapa_brain(modules, "cpu", 0)
    probe = copy.deepcopy(brain)
    arrays = probe._batch_to_device(batch)
    loss = probe.compute_objectives(
        probe.compute_forward(arrays, Stage.TRAIN), arrays, Stage.TRAIN)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _same_state(probe.modules["embedding_model"], jstate)
    total = np.sqrt(sum(np.sum(np.square(np.asarray(g)))
                        for g in jax.tree_util.tree_leaves(jgrads)))
    port_grads = {}
    for name in jm:
        grads = copy.deepcopy(probe.modules[name])
        with torch.no_grad():
            for p, q in zip(probe.modules[name].parameters(),
                            grads.parameters()):
                q.copy_(p.grad)
        port_grads[name] = module_tree(grads)
        want = dict(jax.tree_util.tree_leaves_with_path(_np(jgrads[name])))
        for path, g in jax.tree_util.tree_leaves_with_path(port_grads[name]):
            w = want[path]
            if np.linalg.norm(w) <= ZERO_SHARE * total:
                assert np.linalg.norm(g) <= ZERO_SHARE * total
                continue
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= GRAD_RTOL, (name, jax.tree_util.keystr(path), err)
    # the step on those gradients: clipped and applied as optax does
    updates, _ = opt.update(port_grads, opt.init(params), params)
    want_after = _np(optax.apply_updates(params, updates))
    np.testing.assert_allclose(brain.fit_batch(batch), float(jloss),
                               rtol=LOSS_RTOL)
    for name in jm:
        before = dict(jax.tree_util.tree_leaves_with_path(params[name]))
        after = dict(jax.tree_util.tree_leaves_with_path(want_after[name]))
        zero = dict(jax.tree_util.tree_leaves_with_path(_np(jgrads[name])))
        for path, got in jax.tree_util.tree_leaves_with_path(
                module_tree(brain.modules[name])):
            if np.linalg.norm(zero[path]) <= ZERO_SHARE * total:
                continue        # Adam's eps sets the update of noise
            want = after[path] - before[path]
            err = (np.linalg.norm((got - before[path]) - want)
                   / max(np.linalg.norm(want), 1e-30))
            assert err <= UPDATE_RTOL, (name, jax.tree_util.keystr(path), err)
