"""Port parity, the fairseq seq2seq decoder (``models/seq2seq_decoder.py``):
the teacher-forced logits and cross-attention map, the incremental step and
the cache reorder against the JAX package on the CPU, from one JAX-drawn
tree (``convert_jax.load_module_tree``) and the same seeded numpy inputs,
in f32; the seeded initialisation and the export back to a JAX tree.

Tolerance: ATOL absolute on logits of unit scale and on attention weights
(f32, the same products summed in other orders; the step attends over the
written positions only, the JAX step over the whole ring with the rest
masked, which adds exact zeros).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_speechbrain_tpu.models import seq2seq_decoder as jdec

from svt_speechbrain_tpu_torch.convert_jax import (
    _flatten, init_fairseq_decoder, load_module_tree, module_tree)
from svt_speechbrain_tpu_torch.models import seq2seq_decoder as tdec

ATOL = 1e-5
D, H, V, S = 16, 2, 13, 7

CONFIGS = {
    "pre_shared_sin_relu": dict(normalize_before=True,
                                share_input_output_embed=True),
    "post_separate_learned_gelu": dict(normalize_before=False,
                                       learned_pos=True, activation="gelu"),
    "pre_separate_learned_gelu_unscaled": dict(
        normalize_before=True, learned_pos=True, activation="gelu",
        no_scale_embedding=True),
    "post_shared_sin_relu_unscaled": dict(normalize_before=False,
                                          share_input_output_embed=True,
                                          no_scale_embedding=True),
}


def _cfg(pkg, name, **kw):
    return pkg.FairseqDecoderConfig(
        vocab_size=V, embed_dim=D, ffn_dim=32, num_layers=2, num_heads=H,
        max_target_positions=12, **CONFIGS[name], **kw)


def _pair(name, seed=0):
    jd = jdec.FairseqTransformerDecoder(_cfg(jdec, name))
    params = jd.init(jax.random.PRNGKey(seed))
    td = tdec.FairseqTransformerDecoder(_cfg(tdec, name))
    load_module_tree(td, jax.tree_util.tree_map(np.asarray, params))
    return jd, params, td.eval()


def _enc(rng, b=2):
    enc = rng.standard_normal((b, S, D)).astype(np.float32)
    mask = np.zeros((b, S), bool)
    mask[-1, S - 3:] = True
    return enc, mask


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_teacher_forced_logits_and_attention(name):
    jd, params, td = _pair(name)
    rng = np.random.default_rng(1)
    enc, mask = _enc(rng)
    prev = np.array([[2, 5, 7, 4, 9, 11], [2, 6, 8, 3, 1, 1]], np.int32)
    for m in (None, mask):
        want_l, want_a = jd(params, jnp.asarray(prev), jnp.asarray(enc),
                            None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got_l, got_a = td(torch.from_numpy(prev).long(),
                              torch.from_numpy(enc),
                              None if m is None else torch.from_numpy(m))
        _close(got_l, want_l)
        _close(got_a, want_a)


def test_positions_grow_past_the_table():
    """A full forward longer than ``max_target_positions`` extends the
    sinusoidal table, as the JAX forward does."""
    jd, params, td = _pair("pre_shared_sin_relu")
    rng = np.random.default_rng(2)
    enc, _ = _enc(rng, 1)
    prev = rng.integers(2, V, size=(1, 15)).astype(np.int32)
    want, _ = jd(params, jnp.asarray(prev), jnp.asarray(enc))
    with torch.no_grad():
        got, _ = td(torch.from_numpy(prev).long(), torch.from_numpy(enc))
    _close(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_matches_full_forward_and_jax_step(name):
    jd, params, td = _pair(name, seed=3)
    rng = np.random.default_rng(4)
    enc, mask = _enc(rng)
    prev = np.array([[2, 5, 7, 4, 9], [2, 6, 8, 3, 10]], np.int32)
    with torch.no_grad():
        full, _ = td(torch.from_numpy(prev).long(), torch.from_numpy(enc),
                     torch.from_numpy(mask))
        cache = td.init_cache(torch.from_numpy(enc), 6,
                              encoder_padding_mask=torch.from_numpy(mask))
        jcache = jd.init_cache(params, jnp.asarray(enc), 6,
                               encoder_padding_mask=jnp.asarray(mask))
        for t in range(prev.shape[1]):
            got = td.step(cache, torch.from_numpy(prev[:, t]).long(), t)
            want, jcache = jd.step(params, jcache, jnp.asarray(prev[:, t]), t)
            _close(got, full[:, t])
            _close(got, want)
            for i, lc in enumerate(cache["layers"]):
                jl = jcache["layers"][str(i)]
                _close(lc["k_self"], jl["k_self"])
                _close(lc["v_self"], jl["v_self"])


def test_reorder_cache_matches_jax():
    """Three sentences of two beams: the port keeps the cross-attention
    keys/values once per sentence, the JAX cache once per row; after a
    reorder within each sentence's beams both step to the same logits and
    the rings are the JAX rings."""
    name = "post_separate_learned_gelu"
    jd, params, td = _pair(name, seed=5)
    rng = np.random.default_rng(6)
    enc, mask = _enc(rng, 3)
    beam = 2
    rows = np.repeat(np.arange(3), beam)
    toks = rng.integers(3, V, size=(6, 3)).astype(np.int32)
    order = np.array([1, 0, 2, 2, 5, 4])
    with torch.no_grad():
        cache = td.init_cache(torch.from_numpy(enc), 5,
                              torch.from_numpy(mask), beam=beam)
        jcache = jd.init_cache(params, jnp.asarray(enc[rows]), 5,
                               jnp.asarray(mask[rows]))
        for t in range(2):
            td.step(cache, torch.from_numpy(toks[:, t]).long(), t)
            _, jcache = jd.step(params, jcache, jnp.asarray(toks[:, t]), t)
        cache = td.reorder_cache(cache, torch.from_numpy(order))
        jcache = jd.reorder_cache(jcache, jnp.asarray(order))
        assert cache["enc_mask"] is not None
        for i, lc in enumerate(cache["layers"]):
            jl = jcache["layers"][str(i)]
            _close(lc["k_self"], jl["k_self"])
            _close(lc["v_self"], jl["v_self"])
            _close(lc["k_cross"][rows], jl["k_cross"])
            _close(lc["v_cross"][rows], jl["v_cross"])
        got = td.step(cache, torch.from_numpy(toks[:, 2]).long(), 2)
        want, _ = jd.step(params, jcache, jnp.asarray(toks[:, 2]), 2)
    _close(got, want)
    unmasked = td.init_cache(torch.from_numpy(enc), 5, beam=beam)
    assert td.reorder_cache(unmasked, torch.from_numpy(order))[
        "enc_mask"] is None


def test_all_masked_encoder_row_gives_nan_like_jax():
    """A row whose encoder frames are all padding attends to nothing: NaN in
    the step of both packages (the generator turns it into -inf)."""
    jd, params, td = _pair("pre_shared_sin_relu")
    rng = np.random.default_rng(7)
    enc, mask = _enc(rng)
    mask[0] = True
    jcache = jd.init_cache(params, jnp.asarray(enc), 3, jnp.asarray(mask))
    want, _ = jd.step(params, jcache, jnp.asarray([2, 2]), 0)
    with torch.no_grad():
        cache = td.init_cache(torch.from_numpy(enc), 3,
                              torch.from_numpy(mask))
        got = td.step(cache, torch.tensor([2, 2]), 0)
    assert np.isnan(np.asarray(want)[0]).all()
    assert torch.isnan(got[0]).all()
    _close(got[1], np.asarray(want)[1])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seeded_init_and_export(name):
    """``init_fairseq_decoder`` draws the JAX ``init``'s tree shapes;
    ``module_tree`` gives a loaded JAX tree back unchanged."""
    jd, params, td = _pair(name)
    want = {k: v.shape for k, v in _flatten(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    drawn = init_fairseq_decoder(_cfg(tdec, name),
                                 torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in _flatten(drawn).items()} == want
    back = _flatten(module_tree(td))
    assert back.keys() == want.keys()
    for k, v in _flatten(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("n,d,pad", [(10, 8, 1), (7, 9, 0), (2050, 1024, 1)])
def test_sinusoidal_positions_match_jax(n, d, pad):
    """Within two ulps of the largest angle (n - 1 radians): the two
    packages' f32 ``exp`` may differ by an ulp in a frequency, and the angle
    multiplies that by the position (0.00024 at 2049 radians)."""
    atol = max(2e-6, 2 * (n - 1) * 2.0 ** -23)
    _close(tdec.sinusoidal_positions(n, d, pad),
           jdec.sinusoidal_positions(n, d, pad), atol=atol)


def test_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(tdec.FairseqDecoderConfig)]
            == [f.name for f in dataclasses.fields(jdec.FairseqDecoderConfig)])
