"""Port parity, ``models/contextnet.py`` and ``models/transformer_se_st.py``:
``SEmodule``, ``ContextNetBlock`` and ``ContextNet`` in training and eval
(the port's BatchNorm buffers against the threaded JAX state; a strided
block whose residual does not fit), ``ESPnetVGG``, ``CNNTransformerSE``
(causal or not, each output activation), ``TransformerST`` with
``forward_asr_ctc``, ``IMU_CRNN`` with its statistics, ``ConvBlock``,
``IMU_CRNN_GRU`` and ``check_model``; against the JAX package on the CPU
with the JAX ``init``'s weights carried across by ``convert_jax``, f32."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.models import contextnet as jctx
from svt_speechbrain_tpu.models import transformer_se_st as jse

from svt_speechbrain_tpu_torch.convert_jax import (load_module_tree,
                                                   module_tree)
from svt_speechbrain_tpu_torch.models import contextnet as tctx
from svt_speechbrain_tpu_torch.models import transformer_se_st as tse
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides, outputs of order 1: the summation order only; the
# running statistics are means over B·T of order-1 values
ATOL = 2e-5


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _pair(jpkg, tpkg, name, *args, state=False, **kwargs):
    jm = getattr(jpkg, name)(*args, **kwargs)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tm = getattr(tpkg, name)(*args, **kwargs)
    jstate = jm.init_state() if state else None
    load_module_tree(tm, params, None if jstate is None else
                     jax.tree_util.tree_map(np.asarray, jstate))
    return jm, params, tm, jstate


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _same_state(module, state):
    got = dict(jax.tree_util.tree_leaves_with_path(
        module_tree(module, running_stats=True)))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, state))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], w, atol=ATOL, rtol=0)


def test_se_module():
    jm, params, tm, _ = _pair(jctx, tctx, "SEmodule", 6, 10)
    x = _x((2, 7, 10))
    _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))


def test_contextnet_train_and_eval():
    """Strides (1, 2, 1): the strided block's residual conv halves the
    frames and is added; block 0 (12 → 16 channels) adds its 1x1 too."""
    kw = dict(out_channels=16, conv_channels=[16, 16, 16], strides=[1, 2, 1],
              num_blocks=3, num_layers=2)
    jm, params, tm, state = _pair(jctx, tctx, "ContextNet", 12, state=True,
                                  **kw)
    x = _x((2, 20, 12))
    run = jax.jit(lambda p, s, x, train: jm(p, x, state=s, train=train),
                  static_argnums=3)
    jy, state = run(params, state, jnp.asarray(x), True)
    _close(tm(torch.from_numpy(x), train=True), jy)
    _same_state(tm, state)
    jy, _ = run(params, state, jnp.asarray(x), False)
    _close(tm(torch.from_numpy(x)), jy)


def test_contextnet_block_residual_of_another_shape():
    """One conv of even kernel at stride 2 over 10 frames gives 6 frames,
    the residual 1x1 5, so no residual is added, as in JAX."""
    jm, params, tm, state = _pair(jctx, tctx, "ContextNetBlock", 1, 8, 8,
                                  4, 2, state=True)
    x = _x((2, 10, 8))
    jy, _ = jm(params, jnp.asarray(x), state)
    assert jy.shape == (2, 6, 8) and tm.res(torch.from_numpy(x)).shape[1] == 5
    _close(tm(torch.from_numpy(x)), jy)


def test_espnet_vgg():
    jm, params, tm, _ = _pair(jctx, tctx, "ESPnetVGG", 16, (4, 8), 6, 2,
                              True, 0.0)
    x = _x((2, 12, 16))
    _close(tm(torch.from_numpy(x)),
           jax.jit(lambda p, x: jm(p, x))(params, jnp.asarray(x)))


@pytest.mark.parametrize("activation,causal", [
    ("relu", True), ("sigmoid", False), ("linear", True)])
def test_cnn_transformer_se(activation, causal):
    jm, params, tm, _ = _pair(jse, tse, "CNNTransformerSE", 16, 12,
                              output_activation=activation, nhead=4,
                              num_layers=2, d_ffn=32, dropout=0.0,
                              input_size=10, causal=causal)
    x = _x((2, 7, 10))
    _close(tm(torch.from_numpy(x)),
           jax.jit(lambda p, x: jm(p, x))(params, jnp.asarray(x)))


def test_transformer_st():
    jm, params, tm, _ = _pair(jse, tse, "TransformerST", 11, 10, 16, 4, 1, 1,
                              32, dropout=0.0, ctc_vocab=7)
    x = _x((2, 8, 10))
    tgt = np.random.default_rng(1).integers(1, 11, (2, 5))
    lens = np.asarray([1.0, 0.6], np.float32)

    def jax_fwd(p, x, tgt, lens):
        enc, dec = jm(p, x, tgt, wav_len=lens)
        return enc, dec, jm.forward_asr_ctc(p, enc)

    jenc, jdec, jctc = jax.jit(jax_fwd)(params, jnp.asarray(x),
                                        jnp.asarray(tgt), jnp.asarray(lens))
    enc, dec = tm(torch.from_numpy(x), torch.from_numpy(tgt),
                  wav_len=torch.from_numpy(lens))
    _close(enc, jenc)
    _close(dec, jdec)
    _close(tm.forward_asr_ctc(enc), jctc)
    with pytest.raises(ValueError):
        tse.TransformerST(11, 10, 16, 4, 1, 1, 32).forward_asr_ctc(enc)


def test_imu_crnn_train_and_eval():
    jm, params, tm, state = _pair(jse, tse, "IMU_CRNN", 6, (8, 12), 5, 10, 4,
                                  state=True)
    x = _x((2, 24, 6))
    run = jax.jit(lambda p, s, x, train: jm(p, x, state=s, train=train),
                  static_argnums=3)
    jy, state = run(params, state, jnp.asarray(x), True)
    _close(tm(torch.from_numpy(x), train=True), jy)
    _same_state(tm, state)
    jy, _ = run(params, state, jnp.asarray(x), False)
    _close(tm(torch.from_numpy(x)), jy)


def test_conv_block_and_imu_crnn_gru():
    jm, params, tm, state = _pair(jse, tse, "ConvBlock", 8, 6, state=True)
    x = _x((2, 24, 6))
    jy, new_state = jm(params, jnp.asarray(x), state=state, train=True)
    _close(tm(torch.from_numpy(x), train=True), jy)
    _same_state(tm, new_state)
    jm, params, tm, _ = _pair(jse, tse, "IMU_CRNN_GRU", 6, (8, 12), 10, 3)
    _close(tm(torch.from_numpy(x)),
           jax.jit(lambda p, x: jm(p, x))(params, jnp.asarray(x)))
    assert tuple(tse.check_model(tm, (2, 30, 6))) == tuple(
        jse.check_model(jm, params, (2, 30, 6)))
