"""Port parity, ``models/convert_sb.py``: each converter on a synthetic
state dict with SpeechBrain's key names (drawn from a seed) gives the JAX
converter's tree, which ``convert_jax.load_module_tree`` loads into the
port's module: the module equals the one loaded from the JAX converter's
tree (every tensor bit for bit), and its forward equals the JAX module's
on that tree (f32, within 1e-5); and
``load_torch_state_dict`` reads a saved checkpoint as the JAX one does."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.models import convert_sb as jsb
from svt_speechbrain_tpu.models import fusion as jfusion
from svt_speechbrain_tpu.models import rnnlm as jrnnlm
from svt_speechbrain_tpu.models import transformer as jtr
from svt_speechbrain_tpu.nnet import attention as jatt

from svt_speechbrain_tpu_torch.convert_jax import load_module_tree


def _loaded(module, tree, state=None):
    load_module_tree(module, tree, state)
    return module
from svt_speechbrain_tpu_torch.models import convert_sb as tsb
from svt_speechbrain_tpu_torch.models import fusion as tfusion
from svt_speechbrain_tpu_torch.models import rnnlm as trnnlm
from svt_speechbrain_tpu_torch.models import transformer as ttr
from svt_speechbrain_tpu_torch.nnet import attention as tatt
from svt_speechbrain_tpu_torch.nnet import rnn as trnn

# f32 on both sides, outputs of order 1: the summation order only
ATOL = 1e-5
D, H, FFN = 8, 2, 16


class _Draw:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, *shape):
        return (0.3 * self.rng.normal(size=shape)).astype(np.float32)


def _mha_sd(draw, prefix, d, bias=True):
    sd = {prefix + "in_proj_weight": draw(3 * d, d),
          prefix + "out_proj.weight": draw(d, d)}
    if bias:
        sd[prefix + "in_proj_bias"] = draw(3 * d)
        sd[prefix + "out_proj.bias"] = draw(d)
    return sd


def _encoder_layer_sd(draw, p, bias=True):
    sd = _mha_sd(draw, p + "self_att.att.", D, bias)
    sd.update({p + "pos_ffn.ffn.0.weight": draw(FFN, D),
               p + "pos_ffn.ffn.0.bias": draw(FFN),
               p + "pos_ffn.ffn.3.weight": draw(D, FFN),
               p + "pos_ffn.ffn.3.bias": draw(D)})
    for n in ("norm1", "norm2"):
        sd[f"{p}{n}.norm.weight"] = 1 + draw(D)
        sd[f"{p}{n}.norm.bias"] = draw(D)
    return sd


def _same_modules(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_convert_relpos_mha():
    draw = _Draw(0)
    p = "enc.layers.0.mha_layer."
    sd = {p + "in_proj_weight": draw(3 * D, D),
          p + "out_proj.weight": draw(D, D), p + "out_proj.bias": draw(D),
          p + "linear_pos.weight": draw(D, D),
          p + "pos_bias_u": draw(D // H, H), p + "pos_bias_v": draw(D // H, H)}
    got = _loaded(tatt.RelPosMHAXL(D, H), tsb.convert_relpos_mha(sd, p, D, H))
    tree = jsb.convert_relpos_mha(sd, p, D, H)
    want = tatt.RelPosMHAXL(D, H)
    load_module_tree(want, tree)
    _same_modules(got, want)
    x = _x((2, 5, D))
    pos = jatt.RelPosEncXL(D)(None, jnp.asarray(x))
    jout, _ = jatt.RelPosMHAXL(D, H)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        jnp.asarray(x), jnp.asarray(x), pos_embs=pos)
    with torch.no_grad():
        tout, _ = got(*(torch.from_numpy(x),) * 3,
                      torch.from_numpy(np.asarray(pos)))
    _close(tout, jout)


@pytest.mark.parametrize("bias", [True, False])
def test_convert_transformer_encoder(bias):
    draw = _Draw(1)
    sd = {}
    for i in range(2):
        sd.update(_encoder_layer_sd(draw, f"encoder.layers.{i}.", bias))
    sd["encoder.norm.norm.weight"] = 1 + draw(D)
    sd["encoder.norm.norm.bias"] = draw(D)
    got = _loaded(ttr.TransformerEncoder(2, H, FFN, d_model=D),
                  tsb.convert_transformer_encoder(sd, 2, D, prefix="encoder."))
    tree = jsb.convert_transformer_encoder(sd, 2, D, prefix="encoder.")
    want = ttr.TransformerEncoder(2, H, FFN, d_model=D)
    load_module_tree(want, tree)
    _same_modules(got, want)
    x = _x((2, 6, D), 1)
    jout, _ = jtr.TransformerEncoder(2, H, FFN, d_model=D)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    with torch.no_grad():
        _close(got(torch.from_numpy(x))[0], jout)
    # the tree itself equals the JAX converter's
    plain = tsb.convert_transformer_encoder(sd, 2, D, prefix="encoder.")
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, plain, tree))


@pytest.mark.parametrize("prefix", ["", "0."])
def test_convert_rca_fusion_and_layer(prefix):
    draw = _Draw(2)
    sd = {}
    for layer in ("layer1", "layer2"):
        sd.update(_encoder_layer_sd(draw, f"{prefix}fusion.{layer}."))
    got = _loaded(tfusion.FusionRCA(0.5, H, FFN, D),
                  tsb.convert_rca_fusion(sd, D, prefix=prefix))
    tree = jsb.convert_rca_fusion(sd, D, prefix=prefix)
    want = tfusion.FusionRCA(0.5, H, FFN, D)
    load_module_tree(want, tree)
    _same_modules(got, want)
    a, v = _x((2, 5, D), 2), _x((2, 5, D), 3)
    jout = jfusion.FusionRCA(0.5, H, FFN, D)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(a),
        jnp.asarray(v))
    with torch.no_grad():
        _close(got(torch.from_numpy(a), torch.from_numpy(v)), jout)
    layer = _loaded(tfusion.RCALayer(FFN, H, D), tsb.convert_rca_layer(
        sd, f"{prefix}fusion.layer2.", D))
    _same_modules(layer, got.fusion.layer2)


def test_convert_ligru_with_its_statistics():
    draw = _Draw(3)
    hid, n_in = 5, 4
    sd = {}
    for i in range(2):
        pre = f"rnn.{i}."
        sd[pre + "w.weight"] = draw(2 * hid, n_in if i == 0 else hid)
        sd[pre + "u.weight"] = draw(2 * hid, hid)
        sd[pre + "norm.weight"] = 1 + draw(2 * hid)
        sd[pre + "norm.bias"] = draw(2 * hid)
        sd[pre + "norm.running_mean"] = draw(2 * hid)
        sd[pre + "norm.running_var"] = 1 + np.abs(draw(2 * hid))
    got = _loaded(trnn.LiGRU(hid, input_size=n_in, num_layers=2),
                  *tsb.convert_ligru(sd, 2))
    params, state = jsb.convert_ligru(sd, 2)
    want = trnn.LiGRU(hid, input_size=n_in, num_layers=2)
    load_module_tree(want, params, state)
    _same_modules(got, want)
    assert torch.equal(got.l1.norm.mean,
                       torch.from_numpy(sd["rnn.1.norm.running_mean"]))


@pytest.mark.parametrize("blocks", [1, 2])
def test_convert_rnnlm(blocks):
    draw = _Draw(4)
    v, emb, hid, dnn = 11, 4, 6, 5
    sd = {"embedding.Embedding.weight": draw(v, emb)}
    for k in range(2):
        sd[f"rnn.rnn.weight_ih_l{k}"] = draw(4 * hid, emb if k == 0 else hid)
        sd[f"rnn.rnn.weight_hh_l{k}"] = draw(4 * hid, hid)
        sd[f"rnn.rnn.bias_ih_l{k}"] = draw(4 * hid)
        sd[f"rnn.rnn.bias_hh_l{k}"] = draw(4 * hid)
    n_in = hid
    for i in range(blocks):
        pre = "dnn." if blocks == 1 else f"dnn.block_{i}."
        sd[pre + "linear.w.weight"] = draw(dnn, n_in)
        sd[pre + "linear.w.bias"] = draw(dnn)
        sd[pre + "norm.norm.weight"] = 1 + draw(dnn)
        sd[pre + "norm.norm.bias"] = draw(dnn)
        n_in = dnn
    sd["out.w.weight"] = draw(v, dnn)
    sd["out.w.bias"] = draw(v)
    kw = dict(output_neurons=v, embedding_dim=emb, rnn_layers=2,
              rnn_neurons=hid, dnn_blocks=blocks, dnn_neurons=dnn,
              dropout=0.0)
    got = _loaded(trnnlm.RNNLM(**kw), tsb.convert_rnnlm(sd, 2, blocks))
    tree = jsb.convert_rnnlm(sd, 2, blocks)
    want = trnnlm.RNNLM(**kw)
    load_module_tree(want, tree)
    _same_modules(got, want)
    x = np.random.default_rng(5).integers(0, v, (2, 4))
    jout = jrnnlm.RNNLM(**kw)(jax.tree_util.tree_map(jnp.asarray, tree),
                              jnp.asarray(x))
    with torch.no_grad():
        _close(got(torch.from_numpy(x)), jout)


def test_load_torch_state_dict(tmp_path):
    module = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.LayerNorm(2))
    path = tmp_path / "model.ckpt"
    torch.save(module.state_dict(), path)
    got, want = tsb.load_torch_state_dict(path), jsb.load_torch_state_dict(
        path)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
