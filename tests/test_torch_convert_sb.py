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


# --- the speaker and separation converters: SpeechBrain-keyed state dicts
# built from JAX-initialised trees (the inverse of the JAX converters), read
# by both packages' converters

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(module, seed=0):
    return _np_tree(jax.jit(module.init)(jax.random.PRNGKey(seed)))


def _sb_conv(sd, prefix, p):
    sd[prefix + "weight"] = np.ascontiguousarray(
        np.transpose(p["w"], (2, 1, 0)))
    if "b" in p:
        sd[prefix + "bias"] = p["b"]


def _sb_bn(sd, prefix, p, s):
    sd[prefix + "weight"], sd[prefix + "bias"] = p["scale"], p["bias"]
    sd[prefix + "running_mean"], sd[prefix + "running_var"] = (s["mean"],
                                                               s["var"])


def _stats(state, seed):
    """A JAX state tree of the same shapes with drawn statistics."""
    draw = _Draw(seed)
    return jax.tree_util.tree_map(
        lambda v: (draw(*v.shape) if v.ndim else v), _np_tree(state))


def _same_trees(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, a, b))


def test_convert_xvector():
    from svt_speechbrain_tpu.models import xvector as jxv
    from svt_speechbrain_tpu_torch.models import xvector as txv

    kw = dict(in_channels=6, tdnn_channels=(8, 8, 8, 8, 12), lin_neurons=5)
    jm = jxv.Xvector(**kw)
    params = _jax_init(jm)
    state = _stats(jm.init_state(), 5)
    state = jax.tree_util.tree_map(lambda v: np.abs(v) + 0.5 if v.ndim
                                   else v, state)
    sd = {}
    for i in range(5):
        _sb_conv(sd, f"blocks.{3 * i}.conv.", params[f"tdnn{i}"]["conv"])
        _sb_bn(sd, f"blocks.{3 * i + 2}.norm.", params[f"tdnn{i}"]["norm"],
               state[f"tdnn{i}"])
    sd["blocks.16.w.weight"] = np.ascontiguousarray(params["fc"]["w"].T)
    sd["blocks.16.w.bias"] = params["fc"]["b"]
    got_p, got_s = tsb.convert_xvector(sd)
    want_p, want_s = jsb.convert_xvector(sd)
    _same_trees(got_p, want_p)
    _same_trees(got_s, want_s)
    tm = _loaded(txv.Xvector(**kw), got_p, got_s)
    assert torch.equal(tm.tdnn3.norm.var,
                       torch.from_numpy(sd["blocks.11.norm.running_var"]))
    x = _x((2, 20, 6), 6)
    jout, _ = jax.jit(lambda p, s, x: jm(p, x, state=s))(want_p, want_s,
                                                          jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jout)


def _ecapa_sd(params, state, n_blocks, scale):
    sd = {}

    def tdnn(prefix, p, s):
        _sb_conv(sd, prefix + "conv.conv.", p["conv"])
        _sb_bn(sd, prefix + "norm.norm.", p["norm"], s)

    tdnn("blocks.0.", params["block0"], state["block0"])
    for i in range(1, n_blocks + 1):
        p, s, pre = params[f"block{i}"], state[f"block{i}"], f"blocks.{i}."
        tdnn(pre + "tdnn1.", p["tdnn1"], s["tdnn1"])
        for j in range(scale - 1):
            tdnn(pre + f"res2net_block.blocks.{j}.", p["res2net"][str(j)],
                 s["res2net"][str(j)])
        tdnn(pre + "tdnn2.", p["tdnn2"], s["tdnn2"])
        _sb_conv(sd, pre + "se_block.conv1.conv.", p["se"]["conv1"])
        _sb_conv(sd, pre + "se_block.conv2.conv.", p["se"]["conv2"])
        if "shortcut" in p:
            _sb_conv(sd, pre + "shortcut.conv.", p["shortcut"])
    tdnn("mfa.", params["mfa"], state["mfa"])
    tdnn("asp.tdnn.", params["asp"]["tdnn"], state["asp"])
    _sb_conv(sd, "asp.conv.conv.", params["asp"]["conv"])
    _sb_bn(sd, "asp_bn.norm.", params["asp_norm"], state["asp_norm"])
    _sb_conv(sd, "fc.conv.", params["fc"])
    return sd


@pytest.mark.parametrize("channels", [(8, 8, 8, 8, 24), (8, 12, 12, 12, 36)])
def test_convert_ecapa(channels):
    """Both widths: equal blocks, and the first SE-Res2Net block with a
    shortcut conv (8 → 12 channels)."""
    from svt_speechbrain_tpu.models import ecapa_tdnn as jecapa
    from svt_speechbrain_tpu_torch.models import ecapa_tdnn as tecapa

    kw = dict(input_size=6, lin_neurons=5, channels=channels,
              attention_channels=4, res2net_scale=4, se_channels=4)
    jm = jecapa.ECAPA_TDNN(**kw)
    params = _jax_init(jm)
    state = jax.tree_util.tree_map(lambda v: np.abs(v) + 0.5,
                                   _stats(jm.init_state(), 7))
    sd = _ecapa_sd(params, state, 3, 4)
    got_p, got_s = tsb.convert_ecapa(sd, n_se_blocks=3, res2net_scale=4)
    want_p, want_s = jsb.convert_ecapa(sd, n_se_blocks=3, res2net_scale=4)
    _same_trees(got_p, want_p)
    _same_trees(got_s, want_s)
    tm = _loaded(tecapa.ECAPA_TDNN(**kw), got_p, got_s)
    assert torch.equal(tm.asp.tdnn.norm.mean, torch.from_numpy(
        sd["asp.tdnn.norm.norm.running_mean"]))
    x = _x((2, 20, 6), 8)
    lens = np.asarray([1.0, 0.6], np.float32)
    jout, _ = jax.jit(lambda p, s, x, lens: jm(p, x, lengths=lens,
                                                state=s))(
        want_p, want_s, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x), lengths=torch.from_numpy(lens)), jout)


def _sb_encoder(sd, prefix, tree):
    for i, layer in tree["layers"].items():
        p = f"{prefix}layers.{i}."
        att = layer["self_att"]
        sd[p + "self_att.att.in_proj_weight"] = np.concatenate(
            [att["wq"].T, att["wk"].T, att["wv"].T])
        sd[p + "self_att.att.in_proj_bias"] = np.concatenate(
            [att["bq"], att["bk"], att["bv"]])
        sd[p + "self_att.att.out_proj.weight"] = np.ascontiguousarray(
            att["wo"].T)
        sd[p + "self_att.att.out_proj.bias"] = att["bo"]
        for k, name in (("0", "ffn1"), ("3", "ffn2")):
            sd[p + f"pos_ffn.ffn.{k}.weight"] = np.ascontiguousarray(
                layer["pos_ffn"][name]["w"].T)
            sd[p + f"pos_ffn.ffn.{k}.bias"] = layer["pos_ffn"][name]["b"]
        for n in ("norm1", "norm2"):
            sd[p + f"{n}.norm.weight"] = layer[n]["scale"]
            sd[p + f"{n}.norm.bias"] = layer[n]["bias"]
    sd[prefix + "norm.norm.weight"] = tree["norm"]["scale"]
    sd[prefix + "norm.norm.bias"] = tree["norm"]["bias"]


def _dual_path_sd(params, linear):
    def conv1x1(name, p, dims=1):
        sd[name + ".weight"] = p["w"].T.reshape(p["w"].T.shape + (1,) * dims)
        if "b" in p:
            sd[name + ".bias"] = p["b"]

    sd = {"norm.weight": params["norm"]["scale"],
          "norm.bias": params["norm"]["bias"],
          "prelu.weight": np.asarray([params["prelu"]["alpha"]])}
    conv1x1("conv1d", params["conv_in"])
    conv1x1("conv2d", params["conv2d"], 2)
    conv1x1("end_conv1x1", params["end_conv"])
    conv1x1("output.0", params["output"])
    conv1x1("output_gate.0", params["output_gate"])
    for i, block in params["blocks"].items():
        pre = f"dual_mdl.{i}."
        for part in ("intra", "inter"):
            _sb_encoder(sd, f"{pre}{part}_mdl.mdl.", block[part]["encoder"])
            sd[f"{pre}{part}_norm.weight"] = block[f"{part}_norm"]["scale"]
            sd[f"{pre}{part}_norm.bias"] = block[f"{part}_norm"]["bias"]
            if linear:
                sd[f"{pre}{part}_linear.w.weight"] = np.ascontiguousarray(
                    block[f"{part}_linear"]["w"].T)
                sd[f"{pre}{part}_linear.w.bias"] = block[f"{part}_linear"]["b"]
    return sd


@pytest.mark.parametrize("linear", [True, False])
def test_convert_dual_path(linear):
    """With the intra/inter linears both converters agree; without them
    (SpeechBrain's published SepFormer) the JAX converter raises
    ``KeyError`` and the port's loads the model."""
    from svt_speechbrain_tpu.models import separation as jsep
    from svt_speechbrain_tpu_torch.models import separation as tsep

    def model(pkg):
        return pkg.Dual_Path_Model(
            6, D, pkg.SBTransformerBlock(2, D, H, FFN, True, True),
            pkg.SBTransformerBlock(2, D, H, FFN, True, True), num_layers=2,
            K=6, linear_layer_after_inter_intra=linear)

    jm = model(jsep)
    params = _jax_init(jm)
    sd = _dual_path_sd(params, linear)
    got = tsb.convert_dual_path(sd, 2, 2, D)
    _same_trees(got, params)
    if linear:
        _same_trees(jsb.convert_dual_path(sd, 2, 2, D), params)
    else:
        with pytest.raises(KeyError):
            jsb.convert_dual_path(sd, 2, 2, D)
    tm = _loaded(model(tsep), got)
    x = _x((2, 17, 6), 9)
    jout = jax.jit(lambda p, x: jm(p, x))(got, jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jout)
