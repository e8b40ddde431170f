"""Port parity, ``models/enhancement.py``: MetricGAN's generator (its scalar
``sigmoid_beta``) and discriminators, SEGAN's generator and discriminator,
``shifted_sigmoid``, ``Learnable_sigmoid``, the SEGAN losses in both
reductions (with the VAE term) and ``xavier_init_layer``; against the JAX
package on the CPU with the JAX ``init``'s weights carried across by
``convert_jax``, f32."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.models import enhancement as jenh

from svt_speechbrain_tpu_torch.convert_jax import (load_module_tree,
                                                   seeded_tree)
from svt_speechbrain_tpu_torch.models import enhancement as tenh
from tests.torch_threads import two_torch_threads  # noqa: F401

# f32 on both sides, outputs of order 1: the summation order only
ATOL = 2e-5


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _pair(name, *args, seed=0, **kwargs):
    jm = getattr(jenh, name)(*args, **kwargs)
    params = jax.tree_util.tree_map(
        np.array, jax.jit(jm.init)(jax.random.PRNGKey(seed)))
    tm = getattr(tenh, name)(*args, **kwargs)
    load_module_tree(tm, params)
    return jm, params, tm


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_enhancement_generator(num_layers):
    jm, params, tm = _pair("EnhancementGenerator", 12, 6, num_layers)
    params["sigmoid_beta"] = np.asarray(1.7, np.float32)   # one scalar
    load_module_tree(tm, params)
    assert tm.sigmoid_beta.shape == ()
    x = _x((2, 9, 12))
    for train in (False, True):      # dropout 0: training changes nothing
        _close(tm(torch.from_numpy(x), train=train),
               jax.jit(lambda p, x: jm(p, x, train=train))(params,
                                                           jnp.asarray(x)))


@pytest.mark.parametrize("name,shape", [
    ("MetricDiscriminator", (2, 20, 24, 2)),
    ("MetricGAN_U_Discriminator", (2, 20, 24))])
def test_metric_discriminators(name, shape):
    jm, params, tm = _pair(name, channels=6)
    x = _x(shape)
    _close(tm(torch.from_numpy(x)),
           jax.jit(lambda p, x: jm(p, x))(params, jnp.asarray(x)))


def test_segan():
    jm, params, tm = _pair("SeganGenerator", 8, (4, 8, 16))
    x = _x((2, 100))
    _close(tm(torch.from_numpy(x)),
           jax.jit(lambda p, x: jm(p, x))(params, jnp.asarray(x)))
    assert tenh.Generator is tenh.SeganGenerator
    jm, params, tm = _pair("SeganDiscriminator", 8, (4, 8))
    x = _x((2, 100, 2))
    _close(tm(torch.from_numpy(x)),
           jax.jit(lambda p, x: jm(p, x))(params, jnp.asarray(x)))


def test_sigmoids():
    x = _x((3, 7), scale=3.0)
    _close(tenh.shifted_sigmoid(torch.from_numpy(x)),
           jenh.shifted_sigmoid(jnp.asarray(x)))
    jm, params, tm = _pair("Learnable_sigmoid", 7)
    params["slope"] = _x((7,), seed=1)
    load_module_tree(tm, params)
    _close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))
    assert seeded_tree(tenh.Learnable_sigmoid(5), torch.Generator())[
        "slope"].tolist() == [1.0] * 5


@pytest.mark.parametrize("reduction", ["mean", "batch"])
def test_segan_losses(reduction):
    d = _x((4, 1), seed=1)
    pred, target = _x((4, 50), seed=2), _x((4, 50), seed=3)
    zm, zl = _x((4, 6), seed=4), _x((4, 6), seed=5, scale=0.3)
    t = [torch.from_numpy(a) for a in (d, pred, target, zm, zl)]
    j = [jnp.asarray(a) for a in (d, pred, target, zm, zl)]
    _close(tenh.d1_loss(t[0], reduction), jenh.d1_loss(j[0], reduction))
    _close(tenh.d2_loss(t[0], reduction), jenh.d2_loss(j[0], reduction))
    for kl in (False, True):
        extra = dict(klLossCoeff=0.5, z_mean=t[3], z_logvar=t[4]) if kl \
            else {}
        jextra = dict(klLossCoeff=0.5, z_mean=j[3], z_logvar=j[4]) if kl \
            else {}
        _close(tenh.g3_loss(t[0], t[1], t[2], reduction=reduction, **extra),
               jenh.g3_loss(j[0], j[1], j[2], reduction=reduction, **jextra),
               atol=1e-4)


def test_xavier_init_layer():
    p = tenh.xavier_init_layer(torch.Generator().manual_seed(0), 30, 20)
    want = jenh.xavier_init_layer(jax.random.PRNGKey(0), 30, 20)
    assert p["w"].shape == want["w"].shape and p["b"].shape == want["b"].shape
    bound = np.sqrt(6.0 / 50)
    assert np.abs(p["w"]).max() <= bound and np.abs(p["w"]).max() > 0.9 * bound
    assert not p["b"].any()
