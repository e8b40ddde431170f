"""Port parity, int8 (a8w8) serving: the port's ``ops/quant.py``, quantized
``Linear``/``MultiheadAttention`` and ``models/quantize.py`` against the JAX
package on the CPU, same numpy inputs. The integers are held bit for bit;
only the f32 epilogue's last bit (XLA may fuse or reorder the two scale
multiplies) and the final bf16 rounding may differ."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.inference import (
    BatchedAMTTranscriber as JTranscriber)
from svt_speechbrain_tpu.models import quantize as jquantize
from svt_speechbrain_tpu.models.wav2vec2 import (
    HuggingFaceWav2Vec2 as JBridge, TINY_ARCH as J_TINY_ARCH)
from svt_speechbrain_tpu.nnet.attention import MultiheadAttention as JMHA
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.ops import quant as jq

from svt_speechbrain_tpu_torch import ops
from svt_speechbrain_tpu_torch.convert_jax import (
    export_jax_params, load_jax_params, load_module_tree, module_tree)
from svt_speechbrain_tpu_torch.flagship import build_modules
from svt_speechbrain_tpu_torch.inference import BatchedAMTTranscriber
from svt_speechbrain_tpu_torch.models import quantize as tquantize
from svt_speechbrain_tpu_torch.nnet.attention import MultiheadAttention
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.ops import quant as tq
from tests.torch_threads import two_torch_threads  # noqa: F401

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# the integers are equal, so the outputs differ only in the last bit of the
# f32 epilogue, and in bf16 by one rounding of the output
RTOL = {"f32": 1e-6, "bf16": 2.0 ** -8}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _edge_matrix(rng, rows, cols):
    """Normal draws with the cases that pin the rounding: an all-zero row
    (scale from the 1e-8 floor), a zero column, a row whose amax sits in the
    last column, and rows of exact .5 ties after the division (multiples of
    amax/254, with amax = 127 and amax = 1)."""
    x = rng.normal(size=(rows, cols)).astype(np.float32)
    x[1] = 0.0
    x[:, 3] = 0.0
    x[2, -1] = 9.0
    ties = (rng.integers(-254, 255, size=cols) / 2.0).astype(np.float32)
    ties[0] = 127.0
    x[4] = ties                      # scale 1: every odd multiple is a tie
    x[5] = ties / 127.0              # amax 1: the same ties after division
    return x


def _as(x, tag):
    tdt, jdt = DTYPES[tag]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def test_quantize_weight_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    for w in (_edge_matrix(rng, 40, 24), _edge_matrix(rng, 24, 40).T.copy(),
              rng.normal(size=(3, 8, 16)).astype(np.float32)):
        w8, scale = tq.quantize_weight(torch.from_numpy(w))
        jw8, jscale = jq.quantize_weight(jnp.asarray(w))
        assert w8.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("tag", DTYPES)
def test_quantize_activation_is_bit_equal_to_jax(tag):
    x = _edge_matrix(np.random.default_rng(1), 9, 64).reshape(3, 3, 64)
    tx, jx = _as(x, tag)
    x8, scale = tq.quantize_activation(tx)
    jx8, jscale = jq.quantize_activation(jx)
    assert x8.dtype == torch.int8 and scale.shape == (3, 3, 1)
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    # the tie rows really hold ties, rounded half to even
    if tag == "f32":
        row = x.reshape(9, 64)[4]
        halves = np.abs(row * 2) % 2 == 1
        assert halves.sum() > 5
        assert (x8.reshape(9, 64)[4].numpy()[halves] % 2 == 0).all()
        assert (x8.reshape(9, 64)[1] == 0).all()


def test_rounding_is_half_to_even_not_half_away():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 127.0, 3.49]])
    x8, scale = tq.quantize_activation(x)
    assert scale.item() == 1.0
    assert x8.tolist() == [[0, 2, 2, 0, -2, -2, 127, 3]]


MATMUL_CASES = [  # (leading shape, K, N): M no block size divides
    ((37,), 256, 128), ((3, 33), 128, 384), ((249,), 512, 256), ((1,), 128, 128)]
# 1/127 rounded to f32: what XLA turns the scale's division by 127 into
# inside a compiled program (see test_compiled_jax_scale_is_a_reciprocal...)
RECIP_127 = np.float32(1.0) / np.float32(127.0)


def _rows_with_one_answer(x):
    """Rows of f32 ``x`` whose integers are the same under the scale as
    written, ``amax / 127``, and under ``amax * fl(1/127)``."""
    amax = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-8))
    return (np.rint(x / (amax / np.float32(127.0)))
            == np.rint(x / (amax * RECIP_127))).all(-1)


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("lead,k,n", MATMUL_CASES)
def test_int8_matmul_plain_matches_jax_xla_and_pallas(tag, lead, k, n):
    """Against the XLA path run op by op (the arithmetic as written) on
    every row, and against the Pallas kernel in interpret mode on the rows
    whose integers do not depend on how the compiler divides by 127."""
    rng = np.random.default_rng(k + n)
    m = int(np.prod(lead))
    x = _edge_matrix(rng, max(m, 6), k)[:m].reshape(*lead, k)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.3
    tx, jx = _as(x, tag)
    w8, ws = tq.quantize_weight(torch.from_numpy(w))
    jw8, jws = jq.quantize_weight(jnp.asarray(w))
    got = tq.int8_matmul_plain(tx, w8, ws)
    wrapped = tq.int8_matmul(tx, w8, ws)          # CPU tensor: the plain one
    assert got.dtype == tx.dtype and torch.equal(got, wrapped)
    xla = jq.int8_matmul(jx, jw8, jws)
    assert xla.dtype == DTYPES[tag][1]
    np.testing.assert_allclose(got.float().numpy(), _np(xla),
                               rtol=RTOL[tag], atol=0.0)
    pallas = jq.int8_matmul_fused(jx, jw8, jws, interpret=True, block_m=32,
                                  block_n=128)
    assert pallas.dtype == DTYPES[tag][1]
    rows = _rows_with_one_answer(tx.float().numpy())
    assert rows.mean() >= 0.9 or m < 10
    np.testing.assert_allclose(got.float().numpy()[rows], _np(pallas)[rows],
                               rtol=RTOL[tag], atol=0.0)
    # the integer product itself is exact: float64 against int32 numpy
    x8, _ = tq.quantize_activation(tx)
    acc = torch.matmul(x8.double(), w8.double()).numpy()
    np.testing.assert_array_equal(
        acc, x8.numpy().astype(np.int32).reshape(-1, k)
        .dot(w8.numpy().astype(np.int32)).reshape(acc.shape))


def test_compiled_jax_scale_is_a_reciprocal_multiply_on_one_input():
    """The one division case that cannot be made equal (ROADMAP.md queue 3):
    run op by op, the JAX functions divide by 127 and the port gives their
    integers; inside a compiled program XLA multiplies by fl(1/127), and for
    amax = 3.25 that scale puts -1.625 on an exact tie (-63.5 → -64) where
    the true division gives -63.499996 → -63."""
    x = np.zeros((1, 128), np.float32)
    x[0, :2] = 3.25, -1.625
    x8, scale = tq.quantize_activation(torch.from_numpy(x))
    jx8, jscale = jq.quantize_activation(jnp.asarray(x))
    assert x8[0, :2].tolist() == np.asarray(jx8)[0, :2].tolist() == [127, -63]
    assert scale.item() == float(jscale[0, 0]) \
        == np.float32(3.25) / np.float32(127.0)
    assert not _rows_with_one_answer(x)[0]
    assert np.rint(x[0, 1] / (np.float32(3.25) * RECIP_127)) == -64


def test_plain_product_is_exact_where_f32_would_not_be():
    """K = 4096 rows of ±127 sum to 127·127·4096 > 2^24: an f32 product
    would round, the plain version must not."""
    k = 4096
    x = torch.full((2, k), 3.0)
    x[1, ::2] = -3.0
    w8 = torch.full((k, 128), 127, dtype=torch.int8)
    w8[1::2, 1] = -127
    out = tq.int8_matmul_plain(x, w8, torch.ones(128))
    scale = np.float32(3.0) / np.float32(127.0)
    assert out[0, 0].item() == np.float32(127 * 127 * k) * scale
    assert out[1, 0].item() == 0.0
    assert out[1, 1].item() == np.float32(-127 * 127 * k) * scale


def test_int8_matmul_is_inference_only_and_checks_shapes():
    w8, ws = tq.quantize_weight(torch.randn(16, 8))
    with pytest.raises(ValueError, match="inference only"):
        tq.int8_matmul(torch.randn(2, 16, requires_grad=True), w8, ws)
    with pytest.raises(ValueError, match="shapes"):
        tq.int8_matmul(torch.randn(2, 12), w8, ws)
    with pytest.raises(ValueError, match="int8"):
        tq.int8_matmul(torch.randn(2, 16), w8.float(), ws)
    before = ops.launch_counts()["int8_matmul"]
    tq.int8_matmul(torch.randn(2, 16), w8, ws)
    assert ops.launch_counts()["int8_matmul"] == before   # CPU counts nothing


def test_launch_plan_fits_shared_memory_and_fills_the_card():
    for m, k, n in ((1992, 512, 1024), (1992, 1024, 4096), (1992, 4096, 1024),
                    (1499, 1024, 1024), (249, 4096, 1024), (1, 128, 128)):
        plan = tq.launch_plan(m, k, n)
        tiles, row_blocks = plan.grid
        assert tiles * tq.BLOCK_N == n           # every column tile is owned
        assert (row_blocks - 1) * tq.BLOCK_M < m <= row_blocks * tq.BLOCK_M
        assert plan.cluster in (1, 2, 4, 8) and tiles % plan.cluster == 0
        assert plan.workspace == (tiles // plan.cluster, row_blocks * 128, k)
        # two blocks an SM (228 KB each, 1 KB of it the system's), and at
        # the serving batch about a block an SM
        assert tq.SHARED_BYTES <= tq.SHARED_LIMIT
        assert 2 * (tq.SHARED_BYTES + 1024) <= 228 * 1024
        if m == 1992:
            assert tiles * row_blocks >= 128
    # the s32 sums bound K: 127 * 127 * K < 2^31
    assert tq.launch_plan(8, tq.MAX_K, 128).grid == (1, 1)
    with pytest.raises(ValueError, match="too deep"):
        tq.launch_plan(8, tq.MAX_K + 128, 128)
    assert tq.PackedWeight()(torch.zeros(4, 4, dtype=torch.int8)) is None
    assert tq.pack_weight(torch.arange(6, dtype=torch.int8).reshape(2, 3)) \
        .tolist() == [[0, 3], [1, 4], [2, 5]]


@pytest.mark.parametrize("tag", DTYPES)
def test_quantized_linear_matches_jax(tag):
    jl = JLinear(n_neurons=24, input_size=40)
    params = jquantize.quantize_linear_params(jl.init(jax.random.PRNGKey(3)))
    x = np.random.default_rng(4).normal(size=(5, 9, 40)).astype(np.float32)
    tx, jx = _as(x, tag)
    tl = Linear(24, 40)
    load_module_tree(tl, _numpy_tree(params))
    assert "w" not in dict(tl.named_parameters())
    assert tl.w_q8.dtype == torch.int8 and tl.w_scale.dtype == torch.float32
    np.testing.assert_array_equal(tl.w_q8.numpy(), np.asarray(params["w_q8"]))
    tl = tl.to(DTYPES[tag][0])
    if tag == "bf16":           # the transcriber's cast of every f32 leaf
        params = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
            params)
    with torch.no_grad():
        got = tl(tx)
    want = jl(params, jx)
    assert got.dtype == tx.dtype
    # the bias is added after the product in the input dtype: one more
    # rounding in bf16
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=2 * RTOL[tag], atol=1e-6)


@pytest.mark.parametrize("key_lengths", [None, [11, 4, 0]])
def test_quantized_attention_matches_jax(key_lengths):
    jm = JMHA(nhead=4, d_model=32)
    params = jm.init(jax.random.PRNGKey(5))
    params = dict(params, **{b: jax.random.normal(jax.random.PRNGKey(i), (32,))
                             * 0.1 for i, b in enumerate(("bq", "bk", "bv",
                                                           "bo"))})
    qparams = jquantize.quantize_mha_params(params)
    x = np.random.default_rng(6).normal(size=(3, 11, 32)).astype(np.float32)
    tm = MultiheadAttention(4, 32)
    load_module_tree(tm, _numpy_tree(qparams))
    assert sorted(n for n, _ in tm.named_parameters()) == ["bk", "bo", "bq",
                                                           "bv"]
    kl_t = None if key_lengths is None else torch.tensor(key_lengths)
    kl_j = None if key_lengths is None else jnp.asarray(key_lengths)
    with pytest.raises(ValueError, match="inference only"):
        tm(*(torch.from_numpy(x),) * 3, key_lengths=kl_t)   # biases want grads
    with torch.no_grad():
        got = tm(*(torch.from_numpy(x),) * 3, key_lengths=kl_t)
    want = jm(qparams, *(jnp.asarray(x),) * 3, key_lengths=kl_j,
              return_attn_weights=False)
    want = want[0] if isinstance(want, tuple) else want
    # f32 softmax and products between the int8 projections: summation
    # order. Rows of key length 0 are batch padding, where the JAX CPU path
    # gives a uniform softmax and the port zeros (ROADMAP.md queue 3).
    rows = slice(None) if key_lengths is None else np.asarray(key_lengths) > 0
    np.testing.assert_allclose(got.numpy()[rows], _np(want)[rows], atol=1e-5,
                               rtol=1e-5)
    # and the quantized module differs from the float one (not vacuous)
    tf = MultiheadAttention(4, 32)
    load_module_tree(tf, _numpy_tree(params))
    with torch.no_grad():
        ref = tf(*(torch.from_numpy(x),) * 3, key_lengths=kl_t)
    assert (ref - got).abs().max() > 1e-4


@pytest.fixture(scope="module")
def tiny():
    """JAX-initialised TINY flagship weights, in both packages."""
    jb = JBridge(source="facebook/wav2vec2-large-lv60", output_norm=True,
                 arch_overrides=dict(J_TINY_ARCH))
    jh = JLinear(input_size=64, n_neurons=20)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = jax.jit(lambda a, b: {"wav2vec2": jb.init(a),
                                   "model": jh.init(b)})(k1, k2)
    bridge, head = build_modules(tiny=True)
    load_jax_params(_numpy_tree(params), bridge, head)
    return jb, jh, params, bridge, head


def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for key, val in want.items():
        if isinstance(val, dict):
            _assert_trees_equal(got[key], val, f"{path}{key}/")
        else:
            val = np.asarray(val)
            assert got[key].dtype == val.dtype, f"{path}{key}"
            np.testing.assert_array_equal(got[key], val,
                                          err_msg=f"{path}{key}")


@pytest.mark.parametrize("kw", [{}, {"quantize_attn": True},
                                {"quantize_feat_proj": False}],
                         ids=["default", "attn", "no_feat_proj"])
def test_quantize_wav2vec2_gives_the_jax_tree(tiny, kw):
    """Same structure, ``w_q8`` bit for bit, ``w_scale`` to 0 ulp, float
    leaves untouched; the float bridge is left as it was."""
    _, _, params, bridge, _ = tiny
    before = copy.deepcopy(bridge.state_dict())
    qbridge = tquantize.quantize_wav2vec2(bridge, **kw)
    assert not any(p.requires_grad for p in qbridge.parameters())
    assert all(p.requires_grad for p in bridge.parameters())
    want = _numpy_tree(jquantize.quantize_wav2vec2(params["wav2vec2"], **kw))
    got = module_tree(qbridge)
    _assert_trees_equal(got, want)
    layer0 = got["encoder"]["layers"]["0"]
    assert layer0["ffn1"]["w_q8"].dtype == np.int8
    assert ("wq_q8" in layer0["attn"]) == bool(kw.get("quantize_attn"))
    assert ("w_q8" in got["encoder"]["feat_proj"]) \
        == kw.get("quantize_feat_proj", True)
    after = bridge.state_dict()
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    # a bare encoder quantizes like a bridge
    qenc = tquantize.quantize_wav2vec2(bridge.encoder, **kw)
    _assert_trees_equal(module_tree(qenc), want["encoder"])


def test_jax_quantized_tree_loads_and_exports_unchanged(tiny):
    _, _, params, _, _ = tiny
    qtree = _numpy_tree({"wav2vec2": jquantize.quantize_wav2vec2(
        params["wav2vec2"], quantize_attn=True), "model": params["model"]})
    bridge, head = build_modules(tiny=True)
    load_jax_params(qtree, bridge, head)
    _assert_trees_equal(export_jax_params(bridge, head), qtree)
    assert bridge.encoder.layers[1].attn.wo_q8.dtype == torch.int8
    with pytest.raises(RuntimeError):       # strict: a float tree no longer fits
        load_jax_params(_numpy_tree(params), bridge, head)


@pytest.mark.parametrize("masked_eval", [False, True])
def test_quantized_bridge_forward_matches_jax(tiny, masked_eval):
    jb, _, params, bridge, _ = tiny
    qparams = jquantize.quantize_wav2vec2(params["wav2vec2"])
    qbridge = tquantize.quantize_wav2vec2(bridge).eval()
    wav = (np.random.default_rng(1).normal(size=(3, 4800)) * 0.1
           ).astype(np.float32)
    lens = np.asarray([1.0, 0.7, 0.5], np.float32)
    with torch.no_grad():
        got = qbridge(torch.from_numpy(wav),
                      wav_lens=torch.from_numpy(lens) if masked_eval else None)
        ref = bridge.eval()(torch.from_numpy(wav),
                            wav_lens=torch.from_numpy(lens)
                            if masked_eval else None)
    want = jb(qparams, jnp.asarray(wav),
              **({"wav_lens": jnp.asarray(lens)} if masked_eval else {}))
    # f32 around equal int8 products; a rare activation that sits on a
    # rounding boundary may land on the other integer in one package (the
    # float inputs of the quantizer differ by summation order), which moves
    # one output by a quantization step of about 1e-2 of the output scale
    diff = np.abs(got.numpy() - _np(want))
    assert np.median(diff) < 1e-5
    assert diff.max() < 5e-2
    cos = float((got * ref).sum() / (got.norm() * ref.norm()))
    assert 0.995 < cos < 1.0                 # quantized, and close to float


def test_bf16_transcriber_holds_bf16_scales_and_int8_weights(tiny):
    """The JAX transcriber's bf16 cast takes every f32 leaf, ``w_scale``
    included, and leaves ``w_q8``; the port's ``module.to`` must end with the
    same leaves."""
    jb, jh, params, bridge, head = tiny
    qparams = {"wav2vec2": jquantize.quantize_wav2vec2(params["wav2vec2"]),
               "model": params["model"]}
    qbridge = tquantize.quantize_wav2vec2(bridge)
    jtr = JTranscriber(jb, jh, qparams, chunk_seconds=1.0, batch_size=2)
    ttr = BatchedAMTTranscriber(qbridge, head, chunk_seconds=1.0,
                                batch_size=2, device="cpu")
    got = module_tree(ttr.bridge)["encoder"]["layers"]["1"]["ffn2"]
    want = jtr.params["wav2vec2"]["encoder"]["layers"]["1"]["ffn2"]
    assert ttr.bridge.encoder.layers[1].ffn2.w_scale.dtype == torch.bfloat16
    assert ttr.bridge.encoder.layers[1].ffn2.w_q8.dtype == torch.int8
    assert want["w_scale"].dtype == jnp.bfloat16
    assert want["w_q8"].dtype == jnp.int8
    np.testing.assert_array_equal(got["w_q8"], np.asarray(want["w_q8"]))
    np.testing.assert_array_equal(got["w_scale"], _np(want["w_scale"]))
    # the caller's quantized bridge keeps its f32 scales
    assert qbridge.encoder.layers[1].ffn2.w_scale.dtype == torch.float32
