"""Port parity, nnet building blocks: the PyTorch port against the JAX
package on the CPU, same numpy inputs, f32 unless stated."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.nnet import activations as jact
from svt_speechbrain_tpu.nnet import normalization as jnorm
from svt_speechbrain_tpu.nnet.cnn import Conv1d as JConv1d
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.models.wav2vec2 import _per_item_masked_norm

from svt_speechbrain_tpu_torch.convert_jax import load_module_tree
from svt_speechbrain_tpu_torch.nnet import normalization as tnorm
from svt_speechbrain_tpu_torch.nnet.activations import fast_gelu
from svt_speechbrain_tpu_torch.nnet.cnn import (Conv1d, conv_output_length,
                                                jax_to_torch_conv_weight)
from svt_speechbrain_tpu_torch.nnet.linear import Linear

# f32 on both sides; differences are summation order only
ATOL = 1e-5


def _np(x):
    return np.asarray(x, dtype=np.float32)


def test_linear_matches_jax():
    jl = JLinear(n_neurons=24, input_size=40)
    params = jl.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).normal(size=(3, 7, 40)).astype(np.float32)
    tl = Linear(24, 40)
    load_module_tree(tl, jax.tree_util.tree_map(np.asarray, params))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               _np(jl(params, jnp.asarray(x))), atol=ATOL)


def test_linear_bf16_keeps_input_dtype():
    tl = Linear(8, 16).to(torch.bfloat16)
    out = tl(torch.ones(2, 16, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_gelu_matches_jax(dtype):
    """f32: exact erf GELU. bf16: tanh form in f32, cast back. The two
    libraries' f32 tanh differ in the last bits, which after the bf16
    rounding shows only as up to one bf16 ulp, or below 1e-5 absolute in
    the deep negative tail where the outputs are themselves tiny."""
    x = np.linspace(-8.0, 8.0, 4001, dtype=np.float32)
    got = fast_gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    want = jact.fast_gelu(jnp.asarray(x, getattr(jnp, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(want.astype(jnp.float32)),
                               atol=1e-6 if dtype == "float32" else 1e-5,
                               rtol=0.0 if dtype == "float32" else 2.0 ** -8)


def test_layer_norm_family_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 11, 16)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    row_mask = np.array([1, 0, 1], np.float32)
    valid = np.arange(11)[None, :] < np.array([11, 4, 0])[:, None]
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (tnorm.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias)),
         jnorm.layer_norm(jx, scale, bias)),
        (tnorm.global_layer_norm(tx), jnorm.global_layer_norm(jx)),
        (tnorm.global_layer_norm(tx, row_mask=torch.from_numpy(row_mask)),
         jnorm.global_layer_norm(jx, row_mask=jnp.asarray(row_mask))),
        (tnorm.masked_global_layer_norm(tx, torch.from_numpy(valid)),
         jnorm.masked_global_layer_norm(jx, jnp.asarray(valid))),
        (tnorm.per_item_layer_norm(tx), jnorm.per_item_layer_norm(jx)),
        (tnorm.per_item_masked_layer_norm(tx, torch.from_numpy(valid)),
         _per_item_masked_norm(jx, jnp.asarray(valid))),
    ]
    # rtol beside atol: the row with 0 valid frames has variance 0, so its
    # outputs are x * rsqrt(1e-5), about 1.6e3, where one f32 ulp (1.2e-4)
    # is larger than ATOL; 1e-6 allows a few ulp there and nothing more
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL,
                                   rtol=1e-6, err_msg=f"case {i}")


def test_layer_norm_bf16_stats_in_f32():
    x = torch.tensor([[1000.0, 1001.0, 1002.0, 1003.0]], dtype=torch.bfloat16)
    ln = tnorm.LayerNorm(4).to(torch.bfloat16)
    y = ln(x)
    assert y.dtype == torch.bfloat16
    want = jnorm.layer_norm(jnp.asarray([[1000.0, 1001.0, 1002.0, 1003.0]],
                                        jnp.bfloat16),
                            jnp.ones(4, jnp.bfloat16), jnp.zeros(4, jnp.bfloat16))
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  _np(want.astype(jnp.float32)))


@pytest.mark.parametrize("k,s,groups,cin,cout", [
    (10, 5, 1, 1, 8), (3, 2, 1, 8, 16), (2, 2, 1, 16, 16), (16, 1, 4, 16, 16)])
def test_conv1d_matches_jax(k, s, groups, cin, cout):
    jc = JConv1d(cout, k, cin, stride=s, padding="valid", groups=groups)
    params = jc.init(jax.random.PRNGKey(k + s))
    x = np.random.default_rng(2).normal(size=(2, 57, cin)).astype(np.float32)
    tc = Conv1d(cout, k, cin, stride=s, padding="valid", groups=groups)
    with torch.no_grad():
        tc.weight.copy_(jax_to_torch_conv_weight(
            torch.from_numpy(np.array(params["w"]))))
        tc.bias.copy_(torch.from_numpy(np.array(params["b"])))
    got = tc(torch.from_numpy(x)).detach().numpy()
    want = _np(jc(params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, conv_output_length(57, k, s), cout)
    np.testing.assert_allclose(got, want, atol=ATOL)
