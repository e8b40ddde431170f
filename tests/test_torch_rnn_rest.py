"""Port parity, the rest of ``nnet/rnn.py``: ``LiGRU`` (batch and layer
norm, one and two directions, with and without ``hx``, train and eval, its
running statistics), ``QuasiRNN`` and ``AttentionalRNNDecoder`` (content,
location-aware and key-value attention, through ``forward_step`` and the
teacher-forced call), with gradients against ``jax.grad``; on the CPU, same
numpy weights and inputs, f32. Dropout draws differ by design (``StepRNG``
against JAX keys), so parity runs at rate 0 and the masks are checked for
their rate and scaling."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.nnet import rnn as jrnn

from svt_speechbrain_tpu_torch.convert_jax import (load_module_tree,
                                                   module_tree, seeded_tree)
from svt_speechbrain_tpu_torch.nnet import rnn as trnn
from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides, outputs of order 1: summation order only
ATOL = 1e-5
# gradients: relative to each leaf's norm (the recurrences sum over time);
# a leaf whose true gradient is zero (a key bias under the softmax's shift
# invariance: both sides hold rounding noise there) must be under
# ZERO_SHARE of the whole gradient's norm on both sides instead
GRAD_RTOL = 1e-4
ZERO_SHARE = 1e-6


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def grad_tree(module):
    """The module's gradients as its JAX-shaped tree."""
    clone = copy.deepcopy(module)
    with torch.no_grad():
        for (_, p), (_, q) in zip(module.named_parameters(),
                                  clone.named_parameters()):
            q.copy_(p.grad)
    return module_tree(clone)


def assert_grads_close(got_tree, want_tree, rtol=GRAD_RTOL):
    flat_got = jax.tree_util.tree_leaves_with_path(got_tree)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(_tree(want_tree)))
    assert len(flat_got) == len(flat_want)
    total = np.sqrt(sum(np.sum(np.square(w)) for w in flat_want.values()))
    for path, g in flat_got:
        w = flat_want[path]
        if np.linalg.norm(w) <= ZERO_SHARE * total:
            assert np.linalg.norm(g) <= ZERO_SHARE * total, \
                jax.tree_util.keystr(path)
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, (jax.tree_util.keystr(path), err)


def _pair(jmod, tmod, seed=0):
    """The port's seeded tree of ``tmod`` (which must have the shapes of the
    JAX ``init``, traced without running it), every leaf moved by noise of
    0.1 so that norms are not the identity, loaded into ``tmod``; returns
    it as ``jmod``'s params. Drawing on the port's side keeps JAX's
    per-shape PRNG compiles out of the tests."""
    tree = seeded_tree(tmod, torch.Generator().manual_seed(seed))
    want = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    assert [(k, v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(want)] == [
        (k, v.shape) for k, v in jax.tree_util.tree_leaves_with_path(tree)]
    noise = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * noise.normal(size=a.shape)).astype(np.float32),
        tree)
    load_module_tree(tmod, tree)
    return _as_params(want, tree)


def _as_params(want, tree):
    """``tree`` in the structure of ``want``, with its empty sub-trees."""
    if isinstance(want, dict):
        return {k: _as_params(v, (tree or {}).get(k)) for k, v in
                want.items()}
    return jnp.asarray(tree)


def _ligru_pair(norm, bidir, layers=2, hidden=8, in_size=5, act="relu"):
    kw = dict(hidden_size=hidden, input_size=in_size, num_layers=layers,
              bidirectional=bidir, normalization=norm, nonlinearity=act)
    jm, tm = jrnn.LiGRU(**kw), trnn.LiGRU(**kw)
    return jm, tm, _pair(jm, tm, 1)


@pytest.mark.parametrize("norm", ["batchnorm", "layernorm"])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("with_hx", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_ligru_matches_jax(norm, bidir, with_hx, train):
    jm, tm, params = _ligru_pair(norm, bidir)
    b, n_dir = 3, 2 if bidir else 1
    x = _x((b, 11, 5))
    hx = _x((2 * n_dir, b, 8), 2, 0.5) if with_hx else None
    state = jm.init_state()
    run = jax.jit(jm.__call__, static_argnames="train")
    if train and norm == "batchnorm":     # run statistics away from (0, 1)
        _, _, state = run(params, jnp.asarray(x) * 2 + 1, state=state,
                          train=True)
        tm(torch.from_numpy(x) * 2 + 1, train=True)
    out, finals, new_state = run(params, jnp.asarray(x),
                                 hx=None if hx is None else jnp.asarray(hx),
                                 state=state, train=train)
    got, got_finals, got_state = tm(
        torch.from_numpy(x), hx=None if hx is None else torch.from_numpy(hx),
        train=train, return_state=True)
    _close(got, out)
    for g, w in zip(got_finals, finals):
        _close(g, w)
    assert jax.tree_util.tree_structure(_tree(new_state)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: t.detach().numpy(), got_state))
    for k, st in new_state.items():
        _close(got_state[k]["mean"], st["mean"])
        _close(got_state[k]["var"], st["var"])
    if norm == "batchnorm":
        stats = module_tree(tm, running_stats=True)
        for k, st in new_state.items():
            np.testing.assert_allclose(stats[k]["mean"], st["mean"],
                                       atol=ATOL)


@pytest.mark.parametrize("act", ["tanh", "sin", "leaky_relu"])
def test_ligru_activations_and_4d_input(act):
    jm, tm, params = _ligru_pair("layernorm", False, layers=1, in_size=6,
                                 act=act)
    x = _x((2, 7, 2, 3))
    run = jax.jit(jm.__call__)
    _close(tm(torch.from_numpy(x))[0], run(params, jnp.asarray(x))[0])
    hx2 = _x((2, 8), 3)                          # one (B, H) for every layer
    _close(tm(torch.from_numpy(x), hx=torch.from_numpy(hx2))[0],
           run(params, jnp.asarray(x), hx=jnp.asarray(hx2))[0])
    with pytest.raises(ValueError):
        tm(torch.from_numpy(x), hx=torch.zeros(3, 2, 8))


@pytest.mark.parametrize("norm", ["batchnorm", "layernorm"])
def test_ligru_gradients_match_jax_grad(norm):
    jm, tm, params = _ligru_pair(norm, True)
    x, w = _x((2, 9, 5)), _x((2, 9, 16), 4)
    state = jm.init_state()

    def loss(p):
        out = jm(p, jnp.asarray(x), state=state, train=True)[0]
        return jnp.sum(out * w)

    jgrads = jax.jit(jax.grad(loss))(params)
    out = tm(torch.from_numpy(x), train=True)[0]
    (out * torch.from_numpy(w)).sum().backward()
    assert_grads_close(grad_tree(tm), jgrads)


def test_ligru_recurrent_dropout_mask(monkeypatch):
    """One (B·n_dir, H) mask a layer a forward, drawn from the step's
    device generator: values 0 or 1/(1 - rate), the kept share near
    1 - rate; none in eval."""
    masks = []
    real = trnn._drop

    def spy(x, rate, generator=None, train=False):
        out = real(x, rate, generator, train)
        masks.append(out)
        return out

    monkeypatch.setattr(trnn, "_drop", spy)
    tm = trnn.LiGRU(64, input_size=4, num_layers=3, dropout=0.25,
                    bidirectional=True)
    rng = StepRNG(torch.Generator().manual_seed(0),
                  torch.Generator().manual_seed(1))
    tm(torch.ones(20, 6, 4), rng=rng, train=True)
    assert len(masks) == 3 and all(m.shape == (40, 64) for m in masks)
    for m in masks:
        assert set(m.unique().tolist()) <= {0.0, np.float32(1 / 0.75)}
        assert abs((m > 0).float().mean().item() - 0.75) < 0.05
    masks.clear()
    tm(torch.ones(2, 6, 4), rng=rng)
    assert masks == []


@pytest.mark.parametrize("bidir", [False, True])
def test_quasi_rnn_matches_jax(bidir):
    kw = dict(hidden_size=6, input_size=4, num_layers=2, bidirectional=bidir)
    jm, tm = jrnn.QuasiRNN(**kw), trnn.QuasiRNN(**kw)
    params = _pair(jm, tm, 2)
    x, w = _x((3, 8, 4)), _x((3, 8, 12 if bidir else 6), 5)
    out = tm(torch.from_numpy(x))[0]
    _close(out, jax.jit(jm.__call__)(params, jnp.asarray(x))[0])
    (out * torch.from_numpy(w)).sum().backward()
    jgrads = jax.jit(jax.grad(
        lambda p: jnp.sum(jm(p, jnp.asarray(x))[0] * w)))(params)
    assert_grads_close(grad_tree(tm), jgrads)
    assert trnn.QuasiRNNLayer is trnn.QuasiRNN and trnn.LiGRU_Layer is \
        trnn.LiGRU


_DECODERS = [("gru", "content", 1), ("gru", "location", 1),
             ("gru", "keyvalue", 1), ("lstm", "location", 2),
             ("rnn", "content", 1)]


def _decoder_pair(rnn_type, attn_type, layers):
    kw = dict(rnn_type=rnn_type, attn_type=attn_type, hidden_size=7,
              attn_dim=6, num_layers=layers, enc_dim=10, input_size=5,
              channels=3, kernel_size=2, scaling=1.3)
    jm, tm = jrnn.AttentionalRNNDecoder(**kw), trnn.AttentionalRNNDecoder(
        **kw)
    return jm, tm, _pair(jm, tm, 3)


@pytest.mark.parametrize("rnn_type,attn_type,layers", _DECODERS)
def test_attentional_decoder_matches_jax(rnn_type, attn_type, layers):
    jm, tm, params = _decoder_pair(rnn_type, attn_type, layers)
    inp, enc = _x((3, 4, 5)), _x((3, 9, 10), 1)
    wav_len = np.asarray([1.0, 0.5, 0.72], np.float32)   # 9, 4.5 -> 4, 6.48
    out, attn = jax.jit(jm.__call__)(params, jnp.asarray(inp),
                                     jnp.asarray(enc), jnp.asarray(wav_len))
    got, got_attn = tm(torch.from_numpy(inp), torch.from_numpy(enc),
                       torch.from_numpy(wav_len))
    _close(got, out)
    _close(got_attn, attn)
    # step by step, threading states and the location state
    enc_len = np.asarray([9, 4, 6])
    hs, ths, ctx, tctx, ast, tast = None, None, None, None, None, None
    ctx = jnp.zeros((3, 6))
    tctx = torch.zeros(3, 6)
    step = jax.jit(jm.forward_step)
    for u in range(4):
        o, hs, ctx, w, ast = step(
            params, jnp.asarray(inp[:, u]), hs, ctx, jnp.asarray(enc),
            jnp.asarray(enc_len), ast)
        to, ths, tctx, tw, tast = tm.forward_step(
            torch.from_numpy(inp[:, u]), ths, tctx, torch.from_numpy(enc),
            torch.from_numpy(enc_len), tast)
        _close(to, o)
        _close(tw, w)
        _close(to, out[:, u])
    assert (tast is None) == (attn_type != "location")


@pytest.mark.parametrize("rnn_type,attn_type,layers", _DECODERS[:3])
def test_attentional_decoder_gradients_match_jax_grad(rnn_type, attn_type,
                                                      layers):
    jm, tm, params = _decoder_pair(rnn_type, attn_type, layers)
    inp, enc = _x((2, 3, 5)), _x((2, 8, 10), 1)
    wav_len, w = np.asarray([1.0, 0.6], np.float32), _x((2, 3, 7), 6)
    tinp, tenc = (torch.from_numpy(inp).requires_grad_(),
                  torch.from_numpy(enc).requires_grad_())
    out = tm(tinp, tenc, torch.from_numpy(wav_len))[0]
    (out * torch.from_numpy(w)).sum().backward()

    def loss(p, i, e):
        return jnp.sum(jm(p, i, e, jnp.asarray(wav_len))[0] * w)

    jg, jgi, jge = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        params, jnp.asarray(inp), jnp.asarray(enc))
    assert_grads_close(grad_tree(tm), jg)
    assert_grads_close({"inp": tinp.grad.numpy(), "enc": tenc.grad.numpy()},
                       {"inp": jgi, "enc": jge})


def test_decoder_cell_input_dropout(monkeypatch):
    """Cell-input dropout in training, one draw a step from the step's
    device generator; none without a generator or in eval."""
    masks = []
    real = trnn._drop

    def spy(x, rate, generator=None, train=False):
        out = real(x, rate, generator, train)
        if train and generator is not None:
            masks.append(out)
        return out

    monkeypatch.setattr(trnn, "_drop", spy)
    _, tm, _ = _decoder_pair("gru", "location", 1)
    tm.dropout = 0.5
    rng = StepRNG(torch.Generator().manual_seed(0),
                  torch.Generator().manual_seed(1))
    inp = torch.ones(64, 3, 5)
    tm(inp, torch.ones(64, 8, 10), torch.ones(64), train=True, rng=rng)
    assert len(masks) == 3 and all(m.shape == (64, 11) for m in masks)
    for m in masks:                   # the embedding part: ones in, 0 or 2
        assert set(m[:, :5].unique().tolist()) == {0.0, 2.0}
        assert abs((m[:, :5] == 0).float().mean().item() - 0.5) < 0.08
    masks.clear()
    tm(inp, torch.ones(64, 8, 10), torch.ones(64), train=False, rng=rng)
    assert masks == []
