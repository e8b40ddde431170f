"""wav2vec 2.0 pretraining in the port against the JAX package.

The JAX-initialised parameters of the TINY architecture
(``models/wav2vec2.py:50``) are carried into the port by ``convert_jax``;
both packages get the same numpy inputs and the same host-drawn masks and
negatives. The Gumbel quantizer's training apply takes the JAX package's
own ``jax.random.uniform`` draw. Tolerances: the loss and the aux values
rtol 1e-5 (f32 sums in other orders over at most a few thousand terms);
gradients atol 1e-5 / rtol 1e-4, as ``tests/test_parallel.py:380-384``
holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_speechbrain_tpu.models import wav2vec2 as jw2v
from svt_speechbrain_tpu.models import wav2vec2_pretrain as jpre
from svt_speechbrain_tpu.nnet.core import split_rngs

from svt_speechbrain_tpu_torch.convert_jax import (load_jax_params,
                                                   module_state)
from svt_speechbrain_tpu_torch.models import wav2vec2 as w2v
from svt_speechbrain_tpu_torch.models import wav2vec2_pretrain as pre
from tests.torch_threads import two_torch_threads  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
QUIET = dict(hidden_dropout=0.0, attention_dropout=0.0,
             activation_dropout=0.0, feat_proj_dropout=0.0)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _models(num_negatives=8):
    jm = jpre.Wav2Vec2Pretrain(
        jw2v.Wav2Vec2Config(**dict(w2v.TINY_ARCH, **QUIET)),
        codevector_dim=16, num_negatives=num_negatives)
    tm = pre.Wav2Vec2Pretrain(
        w2v.Wav2Vec2Config(**dict(w2v.TINY_ARCH, **QUIET)),
        codevector_dim=16, num_negatives=num_negatives)
    return jm, tm


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's initialisation of the TINY pretraining model,
    drawn once for the module."""
    return jax.jit(_models()[0].init)(jax.random.PRNGKey(0))


def _pair(params, num_negatives=8):
    jm, tm = _models(num_negatives)
    load_jax_params(_tree(params), tm)
    return jm, params, tm


@pytest.mark.parametrize("train", [False, True])
def test_quantizer_matches_jax(train):
    """Eval: the argmax codes. Training: the straight-through Gumbel codes
    on the JAX draw, and the gradient of the codes' sum."""
    jq = jpre.GumbelVectorQuantizer(24, num_groups=2, num_vars=8,
                                    codevector_dim=12)
    params = jq.init(jax.random.PRNGKey(3))
    x = np.random.default_rng(0).normal(size=(2, 5, 24)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    tq = pre.GumbelVectorQuantizer(24, num_groups=2, num_vars=8,
                                   codevector_dim=12)
    from svt_speechbrain_tpu_torch.convert_jax import load_module_tree
    load_module_tree(tq, _tree(params))

    def f(p):
        q, ppl = jq(p, jnp.asarray(x), rng=key if train else None,
                    train=train)
        return jnp.sum(q * jnp.arange(q.size).reshape(q.shape) / q.size), (
            q, ppl)

    (val, (q_j, ppl_j)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    noise = np.array(jax.random.uniform(key, (2 * 5 * 2, 8), minval=1e-9,
                                        maxval=1.0))
    q_t, ppl_t = tq(torch.from_numpy(x), noise=torch.from_numpy(noise)
                    if train else None, train=train)
    np.testing.assert_allclose(q_t.detach().numpy(), np.asarray(q_j),
                               rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(ppl_t.item(), float(ppl_j), rtol=LOSS_RTOL)
    w = torch.arange(q_t.numel(), dtype=torch.float32).reshape(q_t.shape)
    (q_t * w / q_t.numel()).sum().backward()
    want = module_state(tq, _tree(grads))
    for name, p in tq.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_noise_draw_is_uniform_in_its_range():
    q = pre.GumbelVectorQuantizer(8, num_groups=2, num_vars=4,
                                  codevector_dim=6)
    u = q.draw_noise(torch.Generator().manual_seed(0), 3, 5)
    assert u.shape == (3 * 5 * 2, 4)
    assert float(u.min()) >= 1e-9 and float(u.max()) < 1.0


def test_negatives_and_masks_are_the_jax_draws():
    mask = np.random.default_rng(4).random((3, 40)) < 0.5
    mask[2] = False
    mask[2, 7] = True                      # one masked frame: no negatives
    got = pre.sample_negative_indices(3, 40, 6, mask,
                                      np.random.default_rng(9))
    want = jpre.sample_negative_indices(3, 40, 6, mask,
                                        np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)
    jm, tm = _models()
    for frames in (49, 120):
        m_t, n_t = tm.sample_masks(2, frames, np.random.default_rng(frames))
        m_j, n_j = jm.sample_masks(2, frames, np.random.default_rng(frames))
        np.testing.assert_array_equal(m_t, m_j)
        np.testing.assert_array_equal(n_t, n_j)
        assert m_t.sum(axis=1).min() >= 2 * jm.mask_length or frames < 60


@pytest.mark.parametrize("train", [True, False])
def test_loss_aux_and_gradients_match_jax(train, jax_params):
    """The whole step's loss, its three aux values and every gradient
    against ``jax.value_and_grad``; in training on the JAX Gumbel draw of
    the forward's first key split (the layers' dropouts are 0)."""
    jm, params, tm = _pair(jax_params)
    rng = np.random.default_rng(1)
    wav = rng.normal(size=(2, 16000)).astype(np.float32)
    frames = jm.config.output_length(16000)
    mask, negs = jm.sample_masks(2, frames, rng)
    key = jax.random.PRNGKey(5)

    def f(p):
        return jm(p, jnp.asarray(wav), jnp.asarray(mask), jnp.asarray(negs),
                  rng=key if train else None, train=train)

    (loss_j, aux_j), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    noise = None
    if train:
        sub = split_rngs(key, 2)[0]
        noise = torch.from_numpy(np.array(jax.random.uniform(
            sub, (2 * frames * 2, 320), minval=1e-9, maxval=1.0)))
    loss_t, aux_t = tm(torch.from_numpy(wav), mask, negs, train=train,
                       gumbel_noise=noise)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL)
    for k in aux_j:
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    loss_t.backward()
    want = module_state(tm, _tree(grads))
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_neg_is_pos_fill_matches_jax(jax_params):
    """Negatives that collide with their positive (a frame's own index) are
    filled with -1e9 in both packages: the loss is equal, and it is the
    loss without those negatives."""
    jm, params, tm = _pair(jax_params, num_negatives=4)
    rng = np.random.default_rng(2)
    wav = rng.normal(size=(1, 8000)).astype(np.float32)
    frames = jm.config.output_length(8000)
    mask = np.ones((1, frames), bool)
    negs = np.tile(np.arange(frames)[None, :, None], (1, 1, 4))
    negs[0, :, 1:] = (np.arange(frames)[:, None] + 1) % frames
    want, _ = jax.jit(jm)(params, jnp.asarray(wav), jnp.asarray(mask),
                          jnp.asarray(negs))
    got, _ = tm(torch.from_numpy(wav), mask, negs)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("source,size", [("facebook/wav2vec2-base", 768),
                                         ("facebook/wav2vec2-large-lv60", 1024)])
def test_bridge_picks_the_config_and_normalizes(source, size):
    """base if "base" is in the source, else lv60, as the JAX bridge picks;
    list overrides become tuples; the waveform is normalized over the whole
    batch (the wav here is far from zero mean and unit variance)."""
    bridge = pre.HuggingFaceWav2Vec2Pretrain(source)
    jbridge = jpre.HuggingFaceWav2Vec2Pretrain(source)
    ours, theirs = (dataclasses.asdict(bridge.config),
                    dataclasses.asdict(jbridge.config))
    assert {k: ours[k] for k in theirs if k in ours} == {
        k: v for k, v in theirs.items() if k in ours}
    assert bridge.config.hidden_size == size
    if size != 768:
        return
    over = dict(w2v.TINY_ARCH, conv_dim=list(w2v.TINY_ARCH["conv_dim"]),
                **QUIET)
    small = pre.HuggingFaceWav2Vec2Pretrain(source, arch_overrides=over)
    jsmall = jpre.HuggingFaceWav2Vec2Pretrain(source, arch_overrides=over)
    assert small.config.conv_dim == (32,) * 7
    params = jax.jit(jsmall.init)(jax.random.PRNGKey(0))
    load_jax_params(_tree(params), small)
    rng = np.random.default_rng(3)
    wav = (3.0 + 2.0 * rng.normal(size=(2, 8000))).astype(np.float32)
    mask, negs = jsmall.sample_masks(2, 8000, np.random.default_rng(4))
    m2, n2 = small.sample_masks(2, 8000, np.random.default_rng(4))
    np.testing.assert_array_equal(mask, m2)
    np.testing.assert_array_equal(negs, n2)
    want, _ = jax.jit(jsmall)(params, jnp.asarray(wav), jnp.asarray(mask),
                              jnp.asarray(negs))
    got, _ = small(torch.from_numpy(wav), mask, negs)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_loss_falls_over_adam_steps_on_one_batch(jax_params):
    """As the JAX package's ``test_pretrain_learns_on_one_batch``: the hard
    argmax targets (no Gumbel noise), no diversity term, Adam 3e-3."""
    _, _, tm = _pair(jax_params)
    tm.diversity_loss_weight = 0.0
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(rng.normal(size=(2, 8000)).astype(np.float32))
    mask, negs = tm.sample_masks(2, tm.config.output_length(8000), rng)
    opt = torch.optim.Adam(tm.parameters(), lr=3e-3)
    losses = []
    for _ in range(40):
        opt.zero_grad()
        loss, _ = tm(wav, mask, negs)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 1.0, losses
