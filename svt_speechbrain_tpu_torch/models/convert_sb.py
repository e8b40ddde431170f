"""SpeechBrain checkpoints → the port's modules (port of
``svt_speechbrain_tpu/models/convert_sb.py``).

SpeechBrain saves each module's ``state_dict()`` in a checkpoint
directory. A converter maps such a flat name → array dict onto the JAX
package's tree of the same module (the layouts of the JAX ``init``s:
(in, out) matrices, channel-last convs, unpacked attention projections),
which ``convert_jax.load_module_tree(module, tree[, state])`` loads into
the port's module (the converters of models with BatchNorm statistics —
LiGRU, x-vector, ECAPA-TDNN — give the state tree too).
"""
from __future__ import annotations

import numpy as np
import torch


def load_torch_state_dict(path):
    """Flat name → numpy dict of a torch checkpoint file (loaded on the CPU,
    tensors only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().numpy() for k, v in sd.items()}


def _t(x):
    return np.ascontiguousarray(np.asarray(x).T)


def _lin(sd, prefix):
    """A torch ``nn.Linear``'s entries → {"w" (in, out), "b"} (no "b" when
    the bias is absent).

    Example
    -------
    >>> import torch
    >>> sd = {k: v.numpy() for k, v in
    ...       torch.nn.Linear(4, 2).state_dict().items()}
    >>> p = _lin(sd, "")
    >>> p["w"].shape, p["b"].shape
    ((4, 2), (2,))
    """
    p = {"w": _t(sd[prefix + "weight"])}
    if prefix + "bias" in sd:
        p["b"] = np.asarray(sd[prefix + "bias"])
    return p


def _sb_lin(sd, prefix):
    # SpeechBrain's Linear wraps the torch linear as ".w"
    return _lin(sd, prefix + "w.")


def _conv1d(sd, prefix):
    """A torch ``Conv1d``'s entries (out, in/groups, k) → {"w" (k,
    in/groups, out), "b"} (no "b" when the bias is absent)."""
    p = {"w": np.ascontiguousarray(
        np.transpose(np.asarray(sd[prefix + "weight"]), (2, 1, 0)))}
    if prefix + "bias" in sd:
        p["b"] = np.asarray(sd[prefix + "bias"])
    return p


def _affine(sd, prefix):
    return {"scale": np.asarray(sd[prefix + "weight"]),
            "bias": np.asarray(sd[prefix + "bias"])}


def _bn(sd, prefix):
    return (_affine(sd, prefix),
            {"mean": np.asarray(sd[prefix + "running_mean"]),
             "var": np.asarray(sd[prefix + "running_var"])})


def _mha(sd, prefix, d):
    """torch ``nn.MultiheadAttention``'s packed in-projection → separate
    q, k, v projections and the output projection; absent biases become
    zeros (torch's ``bias=False``)."""
    w = np.asarray(sd[prefix + "in_proj_weight"])
    p = {"wq": _t(w[:d]), "wk": _t(w[d:2 * d]), "wv": _t(w[2 * d:]),
         "wo": _t(sd[prefix + "out_proj.weight"])}
    if prefix + "in_proj_bias" in sd:
        b = np.asarray(sd[prefix + "in_proj_bias"])
        p.update(bq=b[:d].copy(), bk=b[d:2 * d].copy(), bv=b[2 * d:].copy())
    else:
        z = np.zeros((d,), np.float32)
        p.update(bq=z, bk=z.copy(), bv=z.copy())
    if prefix + "out_proj.bias" in sd:
        p["bo"] = np.asarray(sd[prefix + "out_proj.bias"])
    else:
        p["bo"] = np.zeros((d,), np.float32)
    return p


def convert_relpos_mha(sd, prefix, d, num_heads):
    """SpeechBrain's ``RelPosMHAXL`` → a ``RelPosMHAXL``. Its
    self-attention reads the packed projection per head (q, k, v
    interleaved in each head's 3·dh rows), and its position biases stored
    (dh, H) are read as (H, dh) memory, as in the JAX converter."""
    dh = d // num_heads
    w3 = np.asarray(sd[prefix + "in_proj_weight"]).reshape(
        num_heads, 3, dh, d)
    return {
        "wq": _t(w3[:, 0].reshape(d, d)),
        "wk": _t(w3[:, 1].reshape(d, d)),
        "wv": _t(w3[:, 2].reshape(d, d)),
        "wo": _t(sd[prefix + "out_proj.weight"]),
        "bo": np.asarray(sd[prefix + "out_proj.bias"]),
        "wpos": _t(sd[prefix + "linear_pos.weight"]),
        "u": np.asarray(sd[prefix + "pos_bias_u"]).reshape(num_heads, dh),
        "v": np.asarray(sd[prefix + "pos_bias_v"]).reshape(num_heads, dh),
    }


def _encoder_layer(sd, p, d_model):
    return {"self_att": _mha(sd, p + "self_att.att.", d_model),
            "pos_ffn": {"ffn1": _lin(sd, p + "pos_ffn.ffn.0."),
                        "ffn2": _lin(sd, p + "pos_ffn.ffn.3.")},
            "norm1": _affine(sd, p + "norm1.norm."),
            "norm2": _affine(sd, p + "norm2.norm.")}


def convert_transformer_encoder(sd, num_layers, d_model, prefix=""):
    """SpeechBrain's ``TransformerEncoder`` → a ``models.transformer.
    TransformerEncoder``."""
    layers = {str(i): _encoder_layer(sd, f"{prefix}layers.{i}.", d_model)
              for i in range(num_layers)}
    return {"layers": layers, "norm": _affine(sd, prefix + "norm.norm.")}


def convert_xvector(sd, tdnn_blocks=5):
    """SpeechBrain's ``Xvector`` → (params, state) of a ``models.xvector.
    Xvector``: block i's conv is ``blocks.{3i}``, its norm
    ``blocks.{3i+2}``, the embedding ``blocks.{3·tdnn_blocks+1}``."""
    params, state = {}, {}
    for i in range(tdnn_blocks):
        norm_p, state[f"tdnn{i}"] = _bn(sd, f"blocks.{3 * i + 2}.norm.")
        params[f"tdnn{i}"] = {"conv": _conv1d(sd, f"blocks.{3 * i}.conv."),
                              "norm": norm_p}
    params["fc"] = _sb_lin(sd, f"blocks.{3 * tdnn_blocks + 1}.")
    return params, state


def convert_ecapa(sd, n_se_blocks=3, res2net_scale=8):
    """SpeechBrain's ``ECAPA_TDNN`` → (params, state) of a ``models.
    ecapa_tdnn.ECAPA_TDNN``; each ``TDNNBlock``'s statistics at the block's
    path, as the JAX state tree keeps them."""

    def tdnn(prefix):
        norm_p, norm_s = _bn(sd, prefix + "norm.norm.")
        return {"conv": _conv1d(sd, prefix + "conv.conv."),
                "norm": norm_p}, norm_s

    params, state = {}, {}
    params["block0"], state["block0"] = tdnn("blocks.0.")
    for i in range(1, n_se_blocks + 1):
        pre = f"blocks.{i}."
        p, st = {}, {}
        p["tdnn1"], st["tdnn1"] = tdnn(pre + "tdnn1.")
        res = [tdnn(pre + f"res2net_block.blocks.{j}.")
               for j in range(res2net_scale - 1)]
        p["res2net"] = {str(j): r[0] for j, r in enumerate(res)}
        st["res2net"] = {str(j): r[1] for j, r in enumerate(res)}
        p["tdnn2"], st["tdnn2"] = tdnn(pre + "tdnn2.")
        p["se"] = {"conv1": _conv1d(sd, pre + "se_block.conv1.conv."),
                   "conv2": _conv1d(sd, pre + "se_block.conv2.conv.")}
        if pre + "shortcut.conv.weight" in sd:
            p["shortcut"] = _conv1d(sd, pre + "shortcut.conv.")
        params[f"block{i}"], state[f"block{i}"] = p, st
    params["mfa"], state["mfa"] = tdnn("mfa.")
    asp_p, state["asp"] = tdnn("asp.tdnn.")
    params["asp"] = {"tdnn": asp_p, "conv": _conv1d(sd, "asp.conv.conv.")}
    params["asp_norm"], state["asp_norm"] = _bn(sd, "asp_bn.norm.")
    params["fc"] = _conv1d(sd, "fc.conv.")
    return params, state


def convert_dual_path(sd, num_layers, num_tlayers, d_model):
    """SpeechBrain's ``Dual_Path_Model`` with ``SBTransformerBlock`` intra
    and inter models → a ``models.separation.Dual_Path_Model`` tree (1x1
    convs as ``Linear``s, the PReLU's one slope as a scalar).

    The blocks' ``intra_linear``/``inter_linear`` are read only when the
    state dict has them: a model built with
    ``linear_layer_after_inter_intra`` has them, SpeechBrain's published
    SepFormer has none. The JAX converter always reads them
    (``convert_sb.py:207-208``) and raises ``KeyError`` on it."""
    linears = "dual_mdl.0.intra_linear.w.weight" in sd

    def conv1x1(name, bias=True):
        p = {"w": _t(np.asarray(sd[name + ".weight"])[:, :, 0])}
        if bias:
            p["b"] = np.asarray(sd[name + ".bias"])
        return p

    conv2d_w = np.asarray(sd["conv2d.weight"])[:, :, 0, 0]
    params = {
        "norm": _affine(sd, "norm."),
        "conv_in": conv1x1("conv1d", bias=False),
        "conv2d": {"w": _t(conv2d_w), "b": np.asarray(sd["conv2d.bias"])},
        "end_conv": conv1x1("end_conv1x1", bias=False),
        "output": conv1x1("output.0"),
        "output_gate": conv1x1("output_gate.0"),
        "prelu": {"alpha": np.asarray(sd["prelu.weight"])[0]},
        "blocks": {},
    }
    for i in range(num_layers):
        pre = f"dual_mdl.{i}."
        block = {
            "intra": {"encoder": convert_transformer_encoder(
                sd, num_tlayers, d_model, prefix=pre + "intra_mdl.mdl.")},
            "inter": {"encoder": convert_transformer_encoder(
                sd, num_tlayers, d_model, prefix=pre + "inter_mdl.mdl.")},
            "intra_norm": _affine(sd, pre + "intra_norm."),
            "inter_norm": _affine(sd, pre + "inter_norm."),
        }
        if linears:
            block["intra_linear"] = _sb_lin(sd, pre + "intra_linear.")
            block["inter_linear"] = _sb_lin(sd, pre + "inter_linear.")
        params["blocks"][str(i)] = block
    return params


def convert_rca_layer(sd, prefix, d_model):
    """The reference's ``RCALayer`` (one MHA shared by the self- and
    cross-attention passes) → a ``models.fusion.RCALayer``."""
    return _encoder_layer(sd, prefix, d_model)


def convert_rca_fusion(sd, d_model=1024, prefix=""):
    """The reference's ``FusionRCA`` → a ``models.fusion.FusionRCA``
    (``{"fusion": {"layer1", "layer2"}}``). A checkpoint of the recipe's
    ``model`` list keeps the fusion under ``0.``: pass ``prefix="0."``."""
    return {"fusion": {
        "layer1": convert_rca_layer(sd, prefix + "fusion.layer1.", d_model),
        "layer2": convert_rca_layer(sd, prefix + "fusion.layer2.", d_model),
    }}


def convert_ligru(sd, num_layers):
    """SpeechBrain's ``LiGRU`` → (params, state) of an ``nnet.rnn.LiGRU``."""
    params, state = {}, {}
    for i in range(num_layers):
        pre = f"rnn.{i}."
        norm_p, norm_s = _bn(sd, pre + "norm.")
        params[f"l{i}"] = {"w": _t(sd[pre + "w.weight"]),
                           "u": _t(sd[pre + "u.weight"]),
                           "norm": norm_p}
        state[f"l{i}"] = norm_s
    return params, state


def convert_rnnlm(sd, rnn_layers=2, dnn_blocks=1):
    """SpeechBrain's ``RNNLM`` → a ``models.rnnlm.RNNLM``. torch's LSTM
    packs the gates (i, f, g, o), the order the port's LSTM uses."""
    params = {"embedding": {
        "table": np.asarray(sd["embedding.Embedding.weight"])}}
    params["rnn"] = {f"l{layer}": {
        "w_ih": _t(sd[f"rnn.rnn.weight_ih_l{layer}"]),
        "w_hh": _t(sd[f"rnn.rnn.weight_hh_l{layer}"]),
        "b_ih": np.asarray(sd[f"rnn.rnn.bias_ih_l{layer}"]),
        "b_hh": np.asarray(sd[f"rnn.rnn.bias_hh_l{layer}"]),
    } for layer in range(rnn_layers)}
    for i in range(dnn_blocks):
        pre = "dnn." if dnn_blocks == 1 else f"dnn.block_{i}."
        if pre + "linear.w.weight" not in sd:
            pre = f"dnn.block_{i}."
        params[f"dnn{i}"] = {"linear": _sb_lin(sd, pre + "linear."),
                             "norm": _affine(sd, pre + "norm.norm.")}
    params["out"] = _sb_lin(sd, "out.")
    return params
