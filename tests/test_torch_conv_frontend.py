"""Port parity, conv frontend: the port's plain frontend (the CPU side of
``fused_conv_frontend``) against the JAX Pallas kernel in interpret mode and
against the JAX package's XLA conv path, f32 on the CPU."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.models.wav2vec2 import (
    ConvFeatureExtractor as JConvFeatureExtractor, Wav2Vec2Config as JConfig)
from svt_speechbrain_tpu.ops.conv_frontend import (
    _xla_reference, fused_conv_frontend as j_fused_conv_frontend)

from svt_speechbrain_tpu_torch.convert_jax import load_module_tree
from svt_speechbrain_tpu_torch.models.wav2vec2 import (ConvFeatureExtractor,
                                                       TINY_ARCH,
                                                       Wav2Vec2Config)
from svt_speechbrain_tpu_torch.ops import conv_frontend as cf

# f32: sums over up to 3 * C window elements in another order; the JAX
# kernel's rational erf is within 1.5e-7 of the exact erf the port uses
ATOL = 1e-4


def _extractor(c, seed):
    jcfg = JConfig(conv_dim=(c,) * 7)
    params = JConvFeatureExtractor(jcfg).init(jax.random.PRNGKey(seed))
    holder = torch.nn.Module()
    holder.feature_extractor = ConvFeatureExtractor(
        Wav2Vec2Config(conv_dim=(c,) * 7))
    load_module_tree(holder, {"feature_extractor":
                              jax.tree_util.tree_map(np.asarray, params)})
    return params, holder.feature_extractor


@pytest.mark.parametrize("samples", [4000, 3731])
def test_plain_matches_pallas_kernel_interpret(samples):
    """C = 128: the JAX kernel needs lane-aligned channels; the ragged
    length is not a multiple of the kernel's 32-frame tile."""
    params, ext = _extractor(128, 0)
    wav = np.random.default_rng(1).normal(size=(2, samples)).astype(np.float32)
    want = np.asarray(j_fused_conv_frontend(params, jnp.asarray(wav),
                                            conv_dim=(128,) * 7,
                                            interpret=True))
    # the output carries the gradient to the extractor's parameters
    got = cf.fused_conv_frontend(torch.from_numpy(wav),
                                 ext.packed(torch.float32)).detach().numpy()
    assert got.shape == want.shape == (2, cf.output_frames(samples), 128)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_matches_xla_reference_lv60_width():
    params, ext = _extractor(512, 2)
    wav = np.random.default_rng(3).normal(size=(2, 4321)).astype(np.float32)
    want = np.asarray(_xla_reference(params, jnp.asarray(wav), (512,) * 7))
    got = cf.conv_frontend_reference(torch.from_numpy(wav),
                                     ext.packed(torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_module_fused_and_per_layer_paths_agree():
    """The extractor's two paths: packed products vs F.conv1d per layer."""
    _, ext = _extractor(128, 4)
    wav = torch.from_numpy(
        np.random.default_rng(5).normal(size=(3, 2000)).astype(np.float32))
    with torch.no_grad():
        fused = ext(wav, fused=True)
        plain = ext(wav, fused=False)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=ATOL)


def test_can_fuse_predicate():
    wav = torch.zeros(2, 16000)
    assert cf.can_fuse(Wav2Vec2Config(), wav)                 # lv60, C=512
    assert not cf.can_fuse(Wav2Vec2Config(**TINY_ARCH), wav)  # C=32
    assert not cf.can_fuse(Wav2Vec2Config(), torch.zeros(2, 399))
    assert not cf.can_fuse(Wav2Vec2Config(conv_kernel=(10, 3, 3, 3, 3, 3, 2)),
                           wav)


def test_cpu_wrapper_counts_no_launch_and_checks_inputs():
    _, ext = _extractor(64, 6)
    packed = ext.packed(torch.float32)
    before = cf.fused_conv_frontend.launches
    cf.fused_conv_frontend(torch.zeros(1, 800), packed)
    assert cf.fused_conv_frontend.launches == before
    with pytest.raises(ValueError):
        cf.fused_conv_frontend(torch.zeros(1, 800, dtype=torch.bfloat16),
                               packed)
    with pytest.raises(ValueError):
        cf.fused_conv_frontend(torch.zeros(1, 399), packed)


def test_packing_is_cached_until_weights_change():
    _, ext = _extractor(64, 7)
    first = ext.packed(torch.float32)
    assert ext.packed(torch.float32) is first
    with torch.no_grad():
        ext.layers[3].conv.weight.mul_(2.0)
    assert ext.packed(torch.float32) is not first
