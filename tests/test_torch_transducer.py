"""Port parity, the RNN-T path: ``Transducer_joint``, ``Embedding``, the
recurrent networks and their cells and ``TransducerBeamSearcher`` against
the JAX package on the CPU, same numpy weights and inputs, f32 (the slice
as a whole: ``test_torch_transducer_slice.py``)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.decoders.transducer import (
    TransducerBeamSearcher as JSearcher)
from svt_speechbrain_tpu.nnet import rnn as jrnn
from svt_speechbrain_tpu.nnet.embedding import Embedding as JEmbedding
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.nnet.transducer_joint import (
    Transducer_joint as JJoint)

from svt_speechbrain_tpu_torch.convert_jax import (
    init_embedding, init_linear, init_rnn, load_module_tree, module_tree)
from svt_speechbrain_tpu_torch.decoders import TransducerBeamSearcher
from svt_speechbrain_tpu_torch.nnet import rnn as trnn
from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.transducer_joint import Transducer_joint
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides, small widths: summation order only
ATOL = 1e-5


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    flat = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(_flat(val, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = np.asarray(val)
    return flat


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------- joint
@pytest.mark.parametrize("nonlinearity", ["tanh", "relu", "leaky_relu"])
@pytest.mark.parametrize("joint,ndim,network", [
    ("sum", 4, False), ("sum", 4, True), ("concat", 4, True),
    ("concat", 4, False), ("concat", 3, True), ("sum", 3, False)])
def test_transducer_joint_matches_jax(joint, ndim, network, nonlinearity):
    b, t, u, h, n = 2, 5, 3, 8, 6
    rng = np.random.default_rng(0)
    if ndim == 4:
        tn = rng.normal(size=(b, t, 1, h)).astype(np.float32)
        pn = rng.normal(size=(b, 1, u, h)).astype(np.float32)
    else:
        tn = rng.normal(size=(b, t, h)).astype(np.float32)
        pn = rng.normal(size=(b, t, h)).astype(np.float32)
    width = 2 * h if joint == "concat" else h
    tree = {"joint_network": init_linear(_gen(), width, n)} if network else {}
    jmod = JJoint(JLinear(n, width) if network else None, joint=joint,
                  nonlinearity=nonlinearity)
    mod = Transducer_joint(Linear(n, width) if network else None,
                           joint=joint, nonlinearity=nonlinearity)
    load_module_tree(mod, tree)
    want = np.asarray(jmod(_jtree(tree), jnp.asarray(tn), jnp.asarray(pn)))
    got = mod(torch.from_numpy(tn), torch.from_numpy(pn)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    _assert_trees_equal(module_tree(mod), tree)


def test_transducer_joint_refuses_unknown_joint():
    with pytest.raises(NotImplementedError):
        Transducer_joint(joint="product")(torch.ones(1, 2, 1, 3),
                                          torch.ones(1, 1, 2, 3))


# --------------------------------------------------------------- embedding
def test_embedding_matches_jax():
    tree = init_embedding(_gen(1), 10, 16)
    tokens = np.random.default_rng(1).integers(0, 10, size=(3, 7))
    mod = Embedding(10, 16)
    load_module_tree(mod, tree)
    want = np.asarray(JEmbedding(10, 16)(_jtree(tree), jnp.asarray(tokens)))
    np.testing.assert_array_equal(mod(torch.from_numpy(tokens)).detach()
                                  .numpy(), want)
    _assert_trees_equal(module_tree(mod), tree)
    assert abs(tree["table"].std() - 1.0) < 0.15


@pytest.mark.parametrize("blank_id", [0, 2])
def test_one_hot_embedding_matches_jax(blank_id):
    """The fixed one-hot table has the blank's column deleted: N - 1
    columns, and the blank embeds to zeros."""
    jmod = JEmbedding(5, consider_as_one_hot=True, blank_id=blank_id)
    want_table = np.asarray(jmod.init(None)["table"])
    mod = Embedding(5, consider_as_one_hot=True, blank_id=blank_id)
    assert mod.table.shape == (5, 4) and not list(mod.parameters())
    np.testing.assert_array_equal(mod.table.numpy(), want_table)
    tokens = np.arange(5)[None]
    got = mod(torch.from_numpy(tokens)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jmod({"table": jnp.asarray(want_table)},
                             jnp.asarray(tokens))))
    assert (got[0, blank_id] == 0).all()
    load_module_tree(mod, {"table": want_table})         # strict round trip
    _assert_trees_equal(module_tree(mod), {"table": want_table})


# --------------------------------------------------------------------- rnn
KINDS = {"rnn": (jrnn.RNN, trnn.RNN, 1), "lstm": (jrnn.LSTM, trnn.LSTM, 4),
         "gru": (jrnn.GRU, trnn.GRU, 3)}
CELLS = {"rnn": (jrnn.RNNCell, trnn.RNNCell, 1),
         "lstm": (jrnn.LSTMCell, trnn.LSTMCell, 4),
         "gru": (jrnn.GRUCell, trnn.GRUCell, 3)}


def _np_state(state):
    if isinstance(state, (tuple, list)):
        return [_np_state(s) for s in state]
    return np.asarray(state.detach() if isinstance(state, torch.Tensor)
                      else state)


def _assert_states_close(got, want):
    got, want = _np_state(got), _np_state(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_states_close(g, w)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_rnn_matches_jax(kind, bidirectional, bias):
    """2 layers, one or two directions: the outputs, the ``finals`` list
    and the export back leaf by leaf."""
    jcls, tcls, gates = KINDS[kind]
    kwargs = dict(hidden_size=6, input_size=5, num_layers=2, bias=bias,
                  bidirectional=bidirectional)
    tree = init_rnn(_gen(2), gates, 5, 6, num_layers=2,
                    bidirectional=bidirectional, bias=bias)
    assert sorted(tree) == (["l0", "l0_rev", "l1", "l1_rev"] if bidirectional
                            else ["l0", "l1"])
    assert tree["l1"]["w_ih"].shape == (12 if bidirectional else 6, gates * 6)
    x = np.random.default_rng(2).normal(size=(3, 7, 5)).astype(np.float32)
    mod = tcls(**kwargs)
    load_module_tree(mod, tree)
    want, want_finals = jcls(**kwargs)(_jtree(tree), jnp.asarray(x))
    got, finals = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    _assert_states_close(finals, want_finals)
    _assert_trees_equal(module_tree(mod), tree)


def test_rnn_relu_and_4d_input_match_jax():
    tree = init_rnn(_gen(3), 1, 6, 4)
    x = np.random.default_rng(3).normal(size=(2, 5, 2, 3)).astype(np.float32)
    kwargs = dict(hidden_size=4, input_shape=(2, 5, 2, 3),
                  nonlinearity="relu")
    mod = trnn.RNN(**kwargs)
    load_module_tree(mod, tree)
    want, _ = jrnn.RNN(**kwargs)(_jtree(tree), jnp.asarray(x))
    got, _ = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("kind", CELLS)
def test_cells_match_jax_step_by_step(kind):
    """One step through a 2-layer stack from zero states and from the
    states of the step before: outputs and the per-layer state list."""
    jcls, tcls, gates = CELLS[kind]
    tree = init_rnn(_gen(4), gates, 5, 6, num_layers=2)
    jcell = jcls(6, 5, num_layers=2)
    cell = tcls(6, 5, num_layers=2)
    load_module_tree(cell, tree)
    _assert_trees_equal(module_tree(cell), tree)
    xs = np.random.default_rng(4).normal(size=(4, 3, 5)).astype(np.float32)
    jstate = state = None
    for x in xs:
        want, jstate = jcell(_jtree(tree), jnp.asarray(x), jstate)
        got, state = cell(torch.from_numpy(x), state)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)
        assert isinstance(state, list) and len(state) == 2
        _assert_states_close(state, jstate)
    _assert_states_close(cell.init_states(3), jcell.init_states(3))


@pytest.mark.parametrize("kind", KINDS)
def test_rnn_hx_continues_a_sequence(kind):
    """``hx`` in the form of ``finals``: running the second half of a
    sequence from the first half's final states gives the whole sequence's
    outputs, and equals the JAX cells stepped from the same states (the JAX
    sequence modules accept ``hx`` and ignore it)."""
    jcls, tcls, gates = KINDS[kind]
    jcell_cls = CELLS[kind][0]
    tree = init_rnn(_gen(5), gates, 5, 6, num_layers=2)
    mod = tcls(hidden_size=6, input_size=5, num_layers=2)
    load_module_tree(mod, tree)
    x = np.random.default_rng(5).normal(size=(3, 8, 5)).astype(np.float32)
    xt = torch.from_numpy(x)
    whole, whole_finals = mod(xt)
    _, mid = mod(xt[:, :5])
    rest, rest_finals = mod(xt[:, 5:], hx=mid)
    np.testing.assert_allclose(rest.detach().numpy(),
                               whole[:, 5:].detach().numpy(), atol=ATOL)
    _assert_states_close(rest_finals, whole_finals)
    jcell = jcell_cls(6, 5, num_layers=2)
    jstate = jax.tree_util.tree_map(
        lambda s: jnp.asarray(s.detach().numpy()), mid,
        is_leaf=lambda s: isinstance(s, torch.Tensor))
    for step in range(5, 8):
        want, jstate = jcell(_jtree(tree), jnp.asarray(x[:, step]), jstate)
        np.testing.assert_allclose(rest[:, step - 5].detach().numpy(),
                                   np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError):
        mod(xt, hx=mid[:1])


def test_bidirectional_hx_round_trips():
    tree = init_rnn(_gen(6), 4, 3, 4, num_layers=2, bidirectional=True)
    mod = trnn.LSTM(hidden_size=4, input_size=3, num_layers=2,
                    bidirectional=True)
    load_module_tree(mod, tree)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 4, 3))
                         .astype(np.float32))
    _, finals = mod(x)
    zeros = [((torch.zeros(2, 4),) * 2,) * 2] * 2
    again, _ = mod(x, hx=zeros)
    np.testing.assert_array_equal(again.detach().numpy(),
                                  mod(x)[0].detach().numpy())
    moved, _ = mod(x, hx=finals)
    assert not np.allclose(moved.detach().numpy(), again.detach().numpy())


def test_layer_dropout_takes_the_step_generator():
    from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG

    mod = trnn.GRU(hidden_size=4, input_size=3, num_layers=2, dropout=0.5)
    load_module_tree(mod, init_rnn(_gen(7), 3, 3, 4, num_layers=2))
    x = torch.ones(2, 5, 3)
    plain = mod(x)[0]
    assert torch.equal(mod(x, train=True)[0], plain)     # no generator
    outs = [mod(x, rng=StepRNG(_gen(8), _gen(8)), train=True)[0]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])                 # seeded
    assert not torch.equal(outs[0], plain)


def test_rnn_init_matches_jax():
    tree = init_rnn(_gen(9), 1, 4, 6, num_layers=2)
    mod = trnn.RNN(hidden_size=6, input_size=4, num_layers=2)
    load_module_tree(mod, tree)
    want = jrnn.rnn_init(_jtree(tree))
    got = module_tree(trnn.rnn_init(mod))
    for layer in ("l0", "l1"):
        q = got[layer]["w_hh"]
        np.testing.assert_allclose(q, np.asarray(want[layer]["w_hh"]),
                                   atol=1e-6)
        np.testing.assert_allclose(q.T @ q, np.eye(6), atol=1e-5)
        np.testing.assert_array_equal(got[layer]["w_ih"],
                                      tree[layer]["w_ih"])
    gated = trnn.GRU(hidden_size=6, input_size=4)
    with pytest.raises(ValueError):
        trnn.rnn_init(gated)


@pytest.mark.parametrize("name", ["LiGRU", "QuasiRNN", "AttentionalRNNDecoder",
                                  "LiGRU_Layer", "QuasiRNNLayer"])
def test_unported_recurrent_modules_raise(name):
    """The recurrent modules that were stubs (constructing one raised
    ``NotImplementedError`` until they were ported) now build and run;
    their parity with the JAX modules is held in
    ``test_torch_rnn_rest.py``."""
    if name == "AttentionalRNNDecoder":
        module = trnn.AttentionalRNNDecoder(
            "gru", "content", hidden_size=4, attn_dim=3, num_layers=1,
            enc_dim=5, input_size=3)
        out, _ = module(torch.ones(2, 2, 3), torch.ones(2, 6, 5),
                        torch.ones(2))
        assert out.shape == (2, 2, 4)
        return
    module = getattr(trnn, name)(hidden_size=4, input_size=3)
    out, _ = module(torch.ones(2, 5, 3))
    assert out.shape == (2, 5, 4)


def test_pack_and_pad_are_the_identity():
    x = torch.ones(2, 3, 4)
    packed = trnn.pack_padded_sequence(x, [3, 2])
    assert packed[0] is x and packed[1].tolist() == [3, 2]
    assert trnn.pad_packed_sequence(packed) is x
    assert trnn.pad_packed_sequence(x) is x


# ---------------------------------------------------------------- searcher
V, H = 6, 5   # vocab (blank=0), joint hidden
BLANK = 0


def _tables(seed):
    """The fixtures of the JAX package's golden search test, rebuilt from a
    seed: a tanh "prediction network" over an embedding table, a joint with
    a constant blank bias, encoder frames and an LM table."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(V, H)).astype(np.float32)
    w_joint = (0.7 * rng.normal(size=(H, V))).astype(np.float32)
    b_joint = np.zeros(V, np.float32)
    b_joint[BLANK] = 2.5
    enc = rng.normal(size=(2, 7, H)).astype(np.float32)
    lm_table = np.log(rng.dirichlet(np.ones(V), size=V)).astype(np.float32)
    return emb, (w_joint, b_joint), enc, lm_table


def _jax_searcher(emb, joint, lm_table, **kwargs):
    def decode_fn(tokens, state):
        toks = np.asarray(tokens).reshape(-1)
        h = state if state is not None else jnp.zeros((len(toks), H))
        h_new = jnp.tanh(0.5 * h + jnp.asarray(emb)[toks])
        return h_new, h_new

    def joint_fn(enc_frame, dec_out):
        w, b = joint
        return ((jnp.asarray(enc_frame) + dec_out) @ jnp.asarray(w)
                + jnp.asarray(b))

    def lm_fn(tokens, state):
        return jnp.asarray(lm_table)[np.asarray(tokens).reshape(-1)], state

    return JSearcher(decode_fn, joint_fn, blank_id=BLANK, lm_fn=lm_fn,
                     **kwargs)


def _torch_searcher(emb, joint, lm_table, **kwargs):
    emb_t, lm_t = torch.from_numpy(emb), torch.from_numpy(lm_table)
    w, b = (torch.from_numpy(a) for a in joint)

    def decode_fn(tokens, state):
        h = state if state is not None else torch.zeros(len(tokens), H)
        h_new = torch.tanh(0.5 * h + emb_t[tokens])
        return h_new, h_new

    def joint_fn(enc_frame, dec_out):
        return (enc_frame + dec_out) @ w + b

    def lm_fn(tokens, state):
        return lm_t[tokens.reshape(-1)], state

    return TransducerBeamSearcher(decode_fn, joint_fn, blank_id=BLANK,
                                  lm_fn=lm_fn, **kwargs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_search_matches_jax(seed):
    emb, joint, enc, lm_table = _tables(seed)
    want = _jax_searcher(emb, joint, lm_table, beam_size=1)(jnp.asarray(enc))
    got = _torch_searcher(emb, joint, lm_table, beam_size=1)(
        torch.from_numpy(enc))
    assert got[0] == want[0] and got[2:] == (None, None)
    assert any(got[0])
    assert np.isclose(got[1], want[1], rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("beam,lm_weight", [(3, 0.0), (4, 0.0), (3, 0.3),
                                            (4, 0.3)])
def test_beam_search_matches_jax(seed, beam, lm_weight):
    emb, joint, enc, lm_table = _tables(seed)
    kwargs = dict(beam_size=beam, nbest=3, lm_weight=lm_weight)
    w_best, w_score, w_nbest, w_scores = _jax_searcher(
        emb, joint, lm_table, **kwargs)(jnp.asarray(enc))
    g_best, g_score, g_nbest, g_scores = _torch_searcher(
        emb, joint, lm_table, **kwargs)(torch.from_numpy(enc))
    assert g_best == w_best
    assert g_nbest == w_nbest
    for got, want in zip(g_scores, w_scores):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-5)
    assert np.isclose(g_score, w_score, rtol=1e-5)


def test_searcher_needs_an_lm_for_a_positive_weight():
    with pytest.raises(ValueError):
        TransducerBeamSearcher(None, None, blank_id=0, lm_weight=0.5)
