"""Port parity, losses: the port's length-masked ``bce_loss`` and
``nll_loss`` against the JAX package's, on the same numpy inputs, f32 on
the CPU, with relative lengths, ``pos_weight`` and time truncation."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.nnet import losses as jlosses

from svt_speechbrain_tpu_torch.nnet import losses

RTOL = 1e-6   # f32 softplus / log-softmax and one masked sum


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("reduction", ["mean", "batch", "batchmean", "sum"])
@pytest.mark.parametrize("pos_weight,extra", [(15.0, 0), (None, 2), (1.0, -3)])
def test_bce_loss_matches_jax(reduction, pos_weight, extra):
    rng = _rng(0)
    logits = (3 * rng.normal(size=(3, 20 + extra))).astype(np.float32)
    targets = (rng.random((3, 20)) > 0.7).astype(np.float32)
    lens = np.asarray([1.0, 0.55, 0.0], np.float32)
    kw = dict(pos_weight=pos_weight, reduction=reduction, allowed_len_diff=3)
    want = np.asarray(jlosses.bce_loss(jnp.asarray(logits),
                                       jnp.asarray(targets),
                                       length=jnp.asarray(lens), **kw))
    got = losses.bce_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                          length=torch.from_numpy(lens), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "batch"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_nll_loss_matches_jax(reduction, smoothing):
    rng = _rng(1)
    logp = np.array(jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(2, 25, 13)).astype(np.float32))))
    targets = rng.integers(0, 13, (2, 24)).astype(np.float32)
    lens = np.asarray([0.5, 1.0], np.float32)
    kw = dict(reduction=reduction, allowed_len_diff=3,
              label_smoothing=smoothing)
    want = np.asarray(jlosses.nll_loss(jnp.asarray(logp), jnp.asarray(targets),
                                       length=jnp.asarray(lens), **kw))
    got = losses.nll_loss(torch.from_numpy(logp), torch.from_numpy(targets),
                          length=torch.from_numpy(lens), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_truncation_beyond_the_allowance_raises():
    with pytest.raises(ValueError):
        losses.bce_loss(torch.zeros(1, 30), torch.zeros(1, 20),
                        allowed_len_diff=3)


def test_length_to_mask_matches_jax():
    lens = np.asarray([0.0, 2.5, 7.0], np.float32)
    np.testing.assert_array_equal(
        losses.length_to_mask(torch.from_numpy(lens), 7).numpy(),
        np.asarray(jlosses.length_to_mask(jnp.asarray(lens), max_len=7)))
