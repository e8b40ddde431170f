"""Port parity, wav2vec2: one seeded weight tree at the JAX shapes, read by
the JAX package as its params and carried into the port by
``load_jax_params``; the same numpy waveforms through both packages on the
CPU in f32."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.models.wav2vec2 import (
    HuggingFaceWav2Vec2 as JBridge, TINY_ARCH as J_TINY_ARCH,
    Wav2Vec2Config as JConfig)
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear

from svt_speechbrain_tpu_torch.convert_jax import (init_params,
                                                   load_jax_params)
from svt_speechbrain_tpu_torch.flagship import Flagship, build_modules
from svt_speechbrain_tpu_torch.models.wav2vec2 import (
    HuggingFaceWav2Vec2, TINY_ARCH, Wav2Vec2Config)
from svt_speechbrain_tpu_torch.nnet.linear import Linear

# f32 through the conv stack, the encoder layers and the output norm, whose
# features are of unit scale: summation order only
ATOL = 2e-4

FULL_WIDTH_2_LAYERS = dict(num_layers=2)   # lv60 widths, depth cut to 2


def _pair(arch, seed):
    """The JAX bridge and the port's, holding the same seeded weights (a
    tree of numpy arrays at the JAX shapes, read by both packages)."""
    cfg = Wav2Vec2Config(**arch)
    tree = init_params(cfg, torch.Generator().manual_seed(seed))
    jb = JBridge(config=JConfig(**arch), output_norm=True, normalize_wav=True)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tb = HuggingFaceWav2Vec2(config=cfg, output_norm=True, normalize_wav=True)
    th = Linear(20, cfg.hidden_size)
    load_jax_params(tree, tb, th)
    return jb, params, tb.eval(), th.eval()


def _wavs(batch, samples, seed):
    return np.random.default_rng(seed).normal(
        size=(batch, samples)).astype(np.float32)


@pytest.mark.parametrize("arch", [TINY_ARCH, FULL_WIDTH_2_LAYERS],
                         ids=["tiny", "lv60_width_2_layers"])
def test_bridge_with_wav_lens_matches_jax(arch):
    """Exact-lengths path; the last row is batch padding (length 0) and is
    not compared (the JAX CPU eager attention averages over all keys on it,
    the port's kernels emit zeros)."""
    jb, params, tb, _ = _pair(arch, 0)
    wav = _wavs(3, 8000, 1)
    lens = np.asarray([1.0, 0.55, 0.0], np.float32)
    fwd = jax.jit(lambda p, w, l: jb(p, w, wav_lens=l))
    want = np.asarray(fwd(params["wav2vec2"], jnp.asarray(wav),
                          jnp.asarray(lens)))
    with torch.no_grad():
        got = tb(torch.from_numpy(wav), wav_lens=torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape
    frames = tb.config.output_length_tensor(
        torch.round(torch.from_numpy(lens) * 8000).int()).tolist()
    assert frames[2] == 0 and frames[1] < frames[0]
    for row in range(2):
        np.testing.assert_allclose(got[row, :frames[row]],
                                   want[row, :frames[row]], atol=ATOL)


def test_tiny_bridge_without_lengths_matches_jax():
    """No ``wav_lens``: input and output norms over the whole batch."""
    jb, params, tb, _ = _pair(TINY_ARCH, 2)
    wav = _wavs(2, 6400, 3)
    want = np.asarray(jax.jit(jb)(params["wav2vec2"], jnp.asarray(wav)))
    with torch.no_grad():
        got = tb(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_flagship_forward_matches_jax():
    """``__graft_entry__.entry()``'s forward at TINY_ARCH: four outputs."""
    assert TINY_ARCH == J_TINY_ARCH
    jb = JBridge(source="facebook/wav2vec2-large-lv60", output_norm=True,
                 arch_overrides=dict(J_TINY_ARCH))
    jh = JLinear(input_size=64, n_neurons=20)
    tree = init_params(Wav2Vec2Config(**TINY_ARCH),
                       torch.Generator().manual_seed(5))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    wav = _wavs(2, 16000, 4)

    @jax.jit
    def forward(params, wavs):
        logits = jh(params["model"], jb(params["wav2vec2"], wavs))
        return (logits[:, :, 0], logits[:, :, 1], logits[:, :, 2:7],
                logits[:, :, 7:])

    want = forward(params, jnp.asarray(wav))
    bridge, head = build_modules(tiny=True)
    load_jax_params(tree, bridge, head)
    with torch.no_grad():
        got = Flagship(bridge, head).eval()(torch.from_numpy(wav))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_init_params_has_the_jax_tree_structure():
    cfg = Wav2Vec2Config(**TINY_ARCH)
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    jb = JBridge(config=JConfig(**J_TINY_ARCH))
    key = jax.random.PRNGKey(0)
    theirs = jax.eval_shape(lambda k: {"wav2vec2": jb.init(k),
                                       "model": JLinear(20, 64).init(k)}, key)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), theirs)
    assert jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), ours) == shapes


def test_load_is_strict():
    cfg = Wav2Vec2Config(**TINY_ARCH)
    tree = init_params(cfg, torch.Generator().manual_seed(0))
    del tree["wav2vec2"]["encoder"]["encoder_ln"]["bias"]
    with pytest.raises(RuntimeError):
        load_jax_params(tree, HuggingFaceWav2Vec2(config=cfg))


@pytest.mark.parametrize("override", [
    dict(feat_extract_norm="group"), dict(do_stable_layer_norm=False),
    dict(pos_conv_type="stacked"), dict(rel_pos_bias=True), dict(remat=True)])
def test_unported_variants_raise(override):
    """Each variant the port once refused now builds and serves, and so
    does activation sharding on top of any of them, which raises only when
    it runs outside a device mesh, as the JAX sharding constraint does."""
    bridge = HuggingFaceWav2Vec2(config=Wav2Vec2Config(**TINY_ARCH,
                                                       **override)).eval()
    with torch.no_grad():
        out = bridge(torch.ones(2, 3200))
    assert out.shape == (2, 9, TINY_ARCH["hidden_size"])
    sharded = HuggingFaceWav2Vec2(config=Wav2Vec2Config(
        **TINY_ARCH, **override, act_sharding=("data", "seq", None))).eval()
    with pytest.raises(RuntimeError, match="active device mesh"), \
            torch.no_grad():
        sharded(torch.ones(2, 3200))
