"""Port parity, the RCA fusion network: the port's extended
``MultiheadAttention``, ``PositionalwiseFeedForward``, ``PositionalEncoding``
and its mask helpers, ``RCALayer``, ``RCANet``, ``FusionRCA`` and
``quantize_fusion`` against the JAX package on the CPU, from JAX-initialised
parameters (through ``convert_jax.load_module_tree``) and the same numpy
inputs, in f32.

Tolerances: the attention outputs and weights and each module's output
within 2e-5 absolute (f32 products and softmax summed in other orders, two
layers and two LayerNorms deep at most); the positional table and the masks
exactly. The int8 fusion: the quantized weights bit for bit; the outputs
within ATOL in every frame but at most INT8_ROWS of them, and within
INT8_ATOL there. An activation whose f32 value lies on a rounding boundary
takes the neighbouring integer on one side (one quantization step, 1/127
of its row's largest value); in a projection of the stacked queries that
moves its frame's whole attention row (seen: one frame of 60 with
``quantize_attn``, 3.8e-3)."""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_speechbrain_tpu.models import fusion as jfusion
from svt_speechbrain_tpu.models import quantize as jquantize
from svt_speechbrain_tpu.models import transformer as jtransformer
from svt_speechbrain_tpu.nnet import attention as jattention

from svt_speechbrain_tpu_torch.convert_jax import (
    init_fusion, load_module_tree, module_tree)
from svt_speechbrain_tpu_torch.models import fusion, quantize, transformer
from svt_speechbrain_tpu_torch.nnet import attention

ATOL = 2e-5
INT8_ATOL = 2e-2
INT8_ROWS = 2
B, H, D = 2, 4, 16


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _mha_pair(seed, kdim=None, vdim=None):
    jm = jattention.MultiheadAttention(nhead=H, d_model=D, kdim=kdim,
                                       vdim=vdim)
    params = jm.init(jax.random.PRNGKey(seed))
    # nonzero biases, so that a bias mix-up would show
    params = dict(params, **{
        b: jax.random.normal(jax.random.PRNGKey(seed + i + 1), (D,)) * 0.1
        for i, b in enumerate(("bq", "bk", "bv", "bo"))})
    port = attention.MultiheadAttention(H, D, kdim=kdim, vdim=vdim)
    load_module_tree(port, _tree(params))
    return jm, params, port


def _mask_case(case, rng, tq, tk):
    """(attn_mask, key_padding_mask, pos_embs) as numpy, or None."""
    if case == "attn_mask_2d":
        return np.triu(np.ones((tq, tk), bool), k=1), None, None
    if case == "attn_mask_3d_bh":
        return rng.random((B * H, tq, tk)) < 0.3, None, None
    if case == "attn_mask_3d_b":
        return rng.random((B, tq, tk)) < 0.3, None, None
    if case == "key_padding_all_padded_row":
        kpm = np.zeros((B, tk), bool)
        kpm[0, 5:] = True
        kpm[1, :] = True           # every key padded: a uniform softmax
        return None, kpm, None
    if case == "pos_embs":
        return None, None, _rand(rng, 1, H, tq, tk)
    if case == "all":
        kpm = np.zeros((B, tk), bool)
        kpm[1, 3:] = True
        return (np.triu(np.ones((tq, tk), bool), k=1), kpm,
                _rand(rng, B, H, tq, tk))
    return None, None, None


@pytest.mark.parametrize("case", [
    "none", "attn_mask_2d", "attn_mask_3d_bh", "attn_mask_3d_b",
    "key_padding_all_padded_row", "pos_embs", "all"])
def test_multihead_attention_masks_bias_and_weights(case):
    rng = np.random.default_rng(0)
    jm, params, port = _mha_pair(1)
    tq = tk = 9
    x = _rand(rng, B, tq, D)
    am, kpm, pos = _mask_case(case, rng, tq, tk)
    want, want_w = jm(params, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                      attn_mask=None if am is None else jnp.asarray(am),
                      key_padding_mask=None if kpm is None
                      else jnp.asarray(kpm),
                      pos_embs=None if pos is None else jnp.asarray(pos))
    t = torch.from_numpy
    with torch.no_grad():
        got, got_w = port(t(x), t(x), t(x),
                          attn_mask=None if am is None else t(am),
                          key_padding_mask=None if kpm is None else t(kpm),
                          pos_embs=None if pos is None else t(pos),
                          return_attn_weights=True)
    assert got_w.shape == (B, tq, tk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL)
    if case == "key_padding_all_padded_row":
        np.testing.assert_allclose(got_w[1].numpy(), 1.0 / tk, atol=1e-7)


def test_multihead_attention_kdim_vdim_and_cross_lengths():
    """Keys and values of other widths and another length than the
    queries; the weights are (B, Tq, Tk)."""
    rng = np.random.default_rng(1)
    jm, params, port = _mha_pair(2, kdim=12, vdim=20)
    assert tuple(port.wk.shape) == (12, D) and tuple(port.wv.shape) == (20, D)
    q, k, v = _rand(rng, B, 7, D), _rand(rng, B, 11, 12), _rand(rng, B, 11, 20)
    want, want_w = jm(params, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with torch.no_grad():
        got, got_w = port(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), return_attn_weights=True)
    assert got_w.shape == (B, 7, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL)


def test_multihead_attention_keeps_its_return_and_dispatch_without_weights():
    """The encoder's call (``key_lengths``, no weights asked for) still
    returns the output alone, through the short kernel's plain version on
    the CPU, equal to the eager path on the rows with keys."""
    rng = np.random.default_rng(2)
    _, _, port = _mha_pair(3)
    x = torch.from_numpy(_rand(rng, B, 9, D))
    lens = torch.tensor([9, 4])
    with torch.no_grad():
        out = port(x, x, x, key_lengths=lens)
        eager = port(x, x, x, key_lengths=lens, impl="eager")
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), eager.numpy(), atol=ATOL)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_positionwise_feed_forward(activation):
    rng = np.random.default_rng(3)
    jf = jattention.PositionalwiseFeedForward(32, D, activation=activation)
    params = jf.init(jax.random.PRNGKey(4))
    port = attention.PositionalwiseFeedForward(32, D, activation=activation)
    load_module_tree(port, _tree(params))
    x = _rand(rng, B, 5, D)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jf(params, jnp.asarray(x))),
                               atol=ATOL)


def test_positional_encoding_and_masks():
    x = np.zeros((B, 37, 24), np.float32)
    x[0, 30:] = 7.0
    want = np.asarray(jtransformer.PositionalEncoding(24, 100)(
        None, jnp.asarray(x)))
    pe = transformer.PositionalEncoding(24, 100)
    np.testing.assert_array_equal(pe(torch.from_numpy(x)).numpy(), want)
    assert pe.state_dict() == {}              # a buffer, not a parameter
    np.testing.assert_array_equal(
        transformer.get_lookahead_mask(torch.from_numpy(x)).numpy(),
        np.asarray(jtransformer.get_lookahead_mask(jnp.asarray(x))))
    np.testing.assert_array_equal(
        transformer.get_key_padding_mask(torch.from_numpy(x), 7.0).numpy(),
        np.asarray(jtransformer.get_key_padding_mask(jnp.asarray(x), 7.0)))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_rca_layer_and_net(normalize_before):
    rng = np.random.default_rng(4)
    jl = jfusion.RCALayer(32, H, D, alpha=0.3,
                          normalize_before=normalize_before)
    lp = jl.init(jax.random.PRNGKey(5))
    layer = fusion.RCALayer(32, H, D, alpha=0.3,
                            normalize_before=normalize_before)
    load_module_tree(layer, _tree(lp))
    kv, q = _rand(rng, B, 8, D), _rand(rng, B, 8, D)
    with torch.no_grad():
        got = layer(torch.from_numpy(kv), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jl(lp, jnp.asarray(kv), jnp.asarray(q))), atol=ATOL)

    jn = jfusion.RCANet(H, 32, alpha=0.5, d_model=D,
                        normalize_before=normalize_before)
    np_ = jn.init(jax.random.PRNGKey(6))
    net = fusion.RCANet(H, 32, alpha=0.5, d_model=D,
                        normalize_before=normalize_before)
    load_module_tree(net, _tree(np_))
    s1, s2 = _rand(rng, B, 8, D), _rand(rng, B, 8, D)
    want = jn(np_, jnp.asarray(s1), jnp.asarray(s2))
    with torch.no_grad():
        got = net(torch.from_numpy(s1), torch.from_numpy(s2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.fixture(scope="module")
def fusion_pair():
    jf = jfusion.FusionRCA(alpha=0.5, nhead=H, d_ffn=32, d_model=D)
    params = jf.init(jax.random.PRNGKey(7))
    port = fusion.FusionRCA(alpha=0.5, nhead=H, d_ffn=32, d_model=D)
    load_module_tree(port, _tree(params))
    return jf, params, port


@pytest.mark.parametrize("video_frames,warns", [
    (30, False), (36, False), (24, False), (48, True), (10, True)])
def test_fusion_rca_aligns_the_video(fusion_pair, video_frames, warns,
                                     caplog):
    """Video of the audio's 30 frames, longer and shorter by 6 (cut or
    zero-padded quietly) and off by more than 15 (a warning)."""
    jf, params, port = fusion_pair
    rng = np.random.default_rng(video_frames)
    a, v = _rand(rng, B, 30, D), _rand(rng, B, video_frames, D)
    want = np.asarray(jf(params, jnp.asarray(a), jnp.asarray(v)))
    with caplog.at_level(logging.WARNING, logger=fusion.logger.name):
        with torch.no_grad():
            got = port(torch.from_numpy(a), torch.from_numpy(v)).numpy()
    assert got.shape == (B, 30, D)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert ("Alignment is wrong" in caplog.text) == warns


@pytest.mark.parametrize("quantize_attn", [False, True])
def test_quantize_fusion_matches_the_jax_int8_path(fusion_pair,
                                                   quantize_attn):
    """The JAX ``quantize_fusion`` tree, run through its XLA int8 path,
    against the port's ``quantize_fusion`` copy on the CPU (the int8
    kernel's plain version): the same integers and scales, outputs as the
    module docstring says; the float module is left as it was."""
    jf, params, port = fusion_pair
    jq = jquantize.quantize_fusion(params, quantize_attn=quantize_attn)
    q = quantize.quantize_fusion(port, quantize_attn=quantize_attn)
    got_tree, want_tree = module_tree(q), _tree(jq)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    n_int8 = 0
    for path, leaf in flat_want.items():
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=str(path))
        n_int8 += leaf.dtype == np.int8
    assert n_int8 == (12 if quantize_attn else 4)
    assert hasattr(port.fusion.layer1.pos_ffn.ffn1, "w")
    rng = np.random.default_rng(8)
    a, v = _rand(rng, B, 30, D), _rand(rng, B, 30, D)
    want = np.asarray(jf(jq, jnp.asarray(a), jnp.asarray(v)))
    with torch.no_grad():
        got = q(torch.from_numpy(a), torch.from_numpy(v)).numpy()
        ref = port(torch.from_numpy(a), torch.from_numpy(v)).numpy()
    err = np.abs(got - want)
    assert (err.max(-1) > ATOL).sum() <= INT8_ROWS, err.max(-1)
    assert err.max() <= INT8_ATOL
    assert np.abs(got - ref).max() > 1e-3        # int8 is not the float path


def test_fusion_tree_round_trips_and_seeded_tree_has_the_jax_shapes(
        fusion_pair):
    """``load_module_tree`` then ``module_tree`` gives the JAX tree back,
    leaf for leaf; ``init_fusion``'s seeded tree has the JAX tree's keys,
    shapes and dtypes, its LayerNorms at one and zero and its attention
    biases at zero, as the JAX ``init``s."""
    _, params, port = fusion_pair
    want = _tree(params)
    got = module_tree(port)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got)) == 32
    for path, leaf in leaves:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    seeded = init_fusion(torch.Generator().manual_seed(0), D, 32)
    assert (jax.tree_util.tree_structure(seeded)
            == jax.tree_util.tree_structure(want))
    for (_, s), (_, w) in zip(jax.tree_util.tree_leaves_with_path(seeded),
                              leaves):
        assert s.shape == w.shape and s.dtype == w.dtype
    layer = seeded["fusion"]["layer2"]
    assert (layer["norm1"]["scale"] == 1).all()
    assert (layer["self_att"]["bk"] == 0).all()
    assert np.abs(layer["self_att"]["wq"]).max() <= np.sqrt(6.0 / (2 * D))


@pytest.mark.parametrize("module", [fusion, transformer])
def test_module_examples_pass(module):
    import doctest

    result = doctest.testmod(module, optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
