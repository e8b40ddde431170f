"""JAX parameter trees → the port's modules, and seeded random trees.

``load_jax_params`` takes the flagship's JAX pytree as nested dicts of
arrays (numpy, or anything ``np.asarray`` reads)::

    {"wav2vec2": {"encoder": {...}}, "model": {"w": ..., "b": ...}}

with the key names of the JAX ``init``s (``feature_extractor/{i}/conv/{w,b}``,
``feature_extractor/{i}/layer_norm/{scale,bias}`` or, in "group" mode,
``feature_extractor/0/group_norm/{scale,bias}``, ``feat_proj_ln`` when the
config has it, ``feat_proj``, ``pos_conv/{v,g,b}`` or data2vec's
``pos_conv/{i}/{w,b}``, ``layers/{i}/attn/{wq..bo}`` and for WavLM
``layers/{i}/attn/{gru_w,gru_b,gru_const}`` and ``layers/0/attn/
rel_attn_embed``, ``layers/{i}/{ffn1,ffn2,ln1,ln2}``, ``encoder_ln``) and
fills the port's modules, converting conv weights from the JAX (k,
in/groups, out) layout to torch's (out, in/groups, k). Loading is strict:
a missing, extra or misshapen entry raises.

A tree quantized by the JAX package's ``models/quantize.py`` loads too:
wherever it holds ``w_q8``/``w_scale`` (or ``wq_q8``/``wq_scale``, ...) in
place of a float matrix, the module that owns the matrix is turned into its
int8 form first; int8 leaves stay int8, so both packages run the same
integers. ``export_jax_params`` gives such a tree back.

The RCA fusion network (``models/fusion.py``) loads through
``load_module_tree`` as it is: its JAX tree (``fusion/layer{1,2}/
{self_att/{wq..bo},pos_ffn/{ffn1,ffn2}/{w,b},norm1,norm2}``) has the
port's parameter names. ``load_msgpack`` reads a tree that the JAX
package's ``save_msgpack`` wrote, with a decoder of its own (no ``msgpack``
package is needed).

AV-HuBERT (``models/avhubert.py``) loads through ``load_module_tree`` with
its JAX params tree and, as ``state``, its state tree: a ``w``/``b`` leaf of
a 2-D or 3-D conv (found by the module that owns it) becomes ``weight``
(out, in, *k) and ``bias``, and the BatchNorm ``mean``/``var`` of the state
tree fill the modules' buffers (without a state tree they keep theirs).
``module_tree(..., running_stats=True)`` gives the state tree back.
``init_avhubert``/``init_resnet`` draw seeded trees of its shapes.

The transducer parts load through ``load_module_tree`` too: an ``RNN``/
``LSTM``/``GRU`` (or cell) tree ``l{k}``/``l{k}_rev`` with ``w_ih`` (in,
g·H), ``w_hh`` (H, g·H), ``b_ih``, ``b_hh`` fills ``layers.{k}``'s torch
parameters (weights transposed); an ``Embedding``'s ``table`` and a
``Transducer_joint``'s ``joint_network`` keep their names.

The fairseq seq2seq decoder (``models/seq2seq_decoder.py``) has the JAX
tree's names (``embed_tokens/table``, ``layers/{i}/{self_attn,encoder_attn,
ln_self,ln_cross,ln_final,fc1,fc2}``, ``embed_out``, ``embed_positions``,
``final_ln``) and loads through ``load_module_tree``; ``AVHubertASR`` takes
the JAX ``{"encoder", "decoder"}`` params tree with the state tree
``{"encoder": state}``. ``module_tree`` gives both back;
``init_fairseq_decoder`` and ``init_avhubert_asr`` draw seeded trees of
their shapes.

The CRDNN path's modules load through ``load_module_tree`` too: a conv's
``w`` (*k, in/groups, out) (a ``ConvTranspose1d``'s (k, out, in)) becomes
its ``weight``, a ``LiGRU`` keeps its ``l{k}/{w,u,norm}`` names, and the
JAX state tree of a ``CRDNN`` (``dnn{i}/{mean,var}``, ``rnn/l{k}/{mean,
var}``) fills the ``norm`` children's buffers of the ``DNNBlock``s and
LiGRU layers (``jax_state_child``); an ``InputNormalization``'s
``glob_mean``, ``glob_std`` and ``count`` are state too.

The transformer and conformer models (``models/{transformer,conformer,
transformer_asr,rnnlm,convolution}.py``) have the JAX trees' names
(``src``, ``tgt``, ``encoder``/``decoder`` with ``layers/{i}`` or, for a
conformer stack, ``{i}``, ``mha``, ``conv``, ``ffn1_a``..., a frontend's
``b{i}l{j}``/``norm{i}``, an RNNLM's ``dnn{i}/{linear,norm}``) and load
through ``load_module_tree``; a conformer's JAX state tree (``{i}/conv/
{mean,var}``) fills its convolution modules' ``BatchNorm1d`` buffers
(``jax_state_child``). They are compositions of the leaves below, which
seed them; ``NormalizedEmbedding`` is an ``Embedding``.

The separation, speaker and enhancement models (``models/{separation,
ecapa_tdnn,xvector,enhancement,contextnet,transformer_se_st}.py``,
``nnet/{complex,quaternion}_networks.py``) have the JAX trees' names and
load through ``load_module_tree``; their JAX state trees keep a block's
BatchNorm statistics at the block's path, or at an ancestor's through a
chain of ``jax_state_child`` (ECAPA's ``asp/{mean,var}`` → the pooling's
TDNN → its norm), and ``CBatchNorm``'s and ``QBatchNorm``'s
``num_batches_tracked``/moving statistics are state leaves too.

``init_params`` draws a tree of the same shapes and distributions as the
JAX ``init``s from a ``torch.Generator`` (JAX's PRNG gives other numbers;
the machine with the card has no JAX); ``seeded_tree`` draws the tree of
any module built from the port's leaves, and ``init_modules`` fills a dict
of modules with such draws from one seed, as the JAX ``Brain`` initialises
its modules when it is built (the port's ``Brain`` does it for the modules
that ``is_unseeded`` finds still as constructed).
"""
from __future__ import annotations

import math
import re
import struct

import numpy as np
import torch

from svt_speechbrain_tpu_torch.models.avhubert import (AVHubertModel,
                                                      AVHubertPretrain,
                                                      FairseqAVHubert)
from svt_speechbrain_tpu_torch.models.avhubert_asr import AVHubertASR
from svt_speechbrain_tpu_torch.models.ecapa_tdnn import Classifier
from svt_speechbrain_tpu_torch.models.enhancement import (
    EnhancementGenerator, Learnable_sigmoid)
from svt_speechbrain_tpu_torch.models.fusion import FusionRCA
from svt_speechbrain_tpu_torch.models.separation import (GlobalLayerNorm,
                                                      SharedPReLU)
from svt_speechbrain_tpu_torch.models.seq2seq_decoder import (
    FairseqTransformerDecoder)
from svt_speechbrain_tpu_torch.models.wav2vec2 import (HuggingFaceWav2Vec2,
                                                       Wav2Vec2Encoder)
from svt_speechbrain_tpu_torch.models.wav2vec2_pretrain import (
    GumbelVectorQuantizer, HuggingFaceWav2Vec2Pretrain, Wav2Vec2Pretrain)
from svt_speechbrain_tpu_torch.nnet.activations import PReLU
from svt_speechbrain_tpu_torch.nnet.attention import (MultiheadAttention,
                                                      RelPosMHAXL)
from svt_speechbrain_tpu_torch.nnet.complex_networks import (
    CBatchNorm, CLinear, _CConvNd, _CNormBase)
from svt_speechbrain_tpu_torch.nnet.cnn import (ConvTranspose1d, SincConv,
                                                _ConvNd,
                                                jax_to_torch_conv_weight,
                                                torch_to_jax_conv_weight)
from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (GroupNorm,
                                                          LayerNorm,
                                                          _BatchNorm,
                                                          _InstanceNorm)
from svt_speechbrain_tpu_torch.nnet.quaternion_networks import (
    QBatchNorm, QLinear, _QConvNd)
from svt_speechbrain_tpu_torch.nnet.rnn import (GRU, LSTM, _LiGRULayer,
                                                _RNNBase)
from svt_speechbrain_tpu_torch.processing.features import InputNormalization


_RNN_LEAF = re.compile(r"(?:^|/)l(\d+)(_rev)?/([wb])_(ih|hh)$")
_RNN_PARAM = re.compile(
    r"(?:^|/)layers/(\d+)/(weight|bias)_(ih|hh)_l0(_reverse)?$")
# data2vec's stacked positional convs: pos_conv/{i}/w, (k, in/groups, out)
_STACKED_POS_CONV = re.compile(r"(?:^|/)pos_conv/\d+/w$")


def _flatten(tree, prefix=""):
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(_flatten(val, path + "/"))
        else:
            flat[path] = val
    return flat


def _convert(path, value):
    """(JAX key path, array) → (port parameter name, tensor)."""
    value = np.asarray(value)
    if value.dtype != np.int8:           # quantized weights stay int8
        value = value.astype(np.float32)
    t = torch.tensor(value)
    name = re.sub(r"feature_extractor/(\d+)/", r"feature_extractor/layers/\1/",
                  path)
    if re.search(r"feature_extractor/layers/\d+/conv/w$", name):
        name, t = name[:-1] + "weight", jax_to_torch_conv_weight(t)
    elif re.search(r"feature_extractor/layers/\d+/conv/b$", name):
        name = name[:-1] + "bias"
    elif name.endswith("pos_conv/v") or _STACKED_POS_CONV.search(name):
        t = jax_to_torch_conv_weight(t)
    elif name.endswith("pos_conv/g"):
        t = t.reshape(1, 1, -1)                # (k, 1, 1) → (1, 1, k)
    rnn = _RNN_LEAF.search(name)
    if rnn:                       # l0_rev/w_ih → layers/0/weight_ih_l0_reverse
        layer, rev, kind, part = rnn.groups()
        name = (f"{name[:rnn.start(1) - 1]}layers/{layer}/"
                f"{'weight' if kind == 'w' else 'bias'}_{part}_l0"
                f"{'_reverse' if rev else ''}")
        if kind == "w":
            t = t.t()                          # (in, g·H) → (g·H, in)
    return name.replace("/", "."), t.contiguous()


def _owner(module, name):
    owner, _, leaf = name.rpartition(".")
    try:
        return module.get_submodule(owner), leaf
    except AttributeError:
        return None, leaf


def _state_child_name(module, name):
    """The name of a running statistic that the JAX state tree keeps at an
    ancestor's path: while the owner names a ``jax_state_child`` and holds
    no such leaf itself, the leaf moves down to that child (a chain, as
    ECAPA's pooling → its ``TDNNBlock`` → the norm)."""
    owner, leaf = _owner(module, name)
    path = name[:-len(leaf)]
    while (owner is not None and getattr(owner, "jax_state_child", None)
           and leaf not in owner._parameters and leaf not in owner._buffers):
        path += owner.jax_state_child + "."
        owner = getattr(owner, owner.jax_state_child, None)
    return path + leaf


def _conv_leaves(module, state):
    """The convs' JAX leaves ``w`` (*k, in, out) (a transposed conv's (k,
    out, in)) and ``b`` → ``weight`` (out, in, *k) (in, out, k) and
    ``bias``, by the module that owns them; the running statistics of a
    ``jax_state_child`` norm, which the JAX state tree keeps at an
    ancestor's path, → the norm's buffers."""
    out = {}
    for name, t in state.items():
        owner, leaf = _owner(module, name)
        if isinstance(owner, (_ConvNd, ConvTranspose1d)) and leaf in ("w",
                                                                      "b"):
            if leaf == "b":
                name = name[:-1] + "bias"
            elif isinstance(owner, ConvTranspose1d):
                name, t = name[:-1] + "weight", t.permute(2, 1, 0)
            else:
                name, t = name[:-1] + "weight", jax_to_torch_conv_weight(t)
        elif getattr(owner, "jax_state_child", None):
            name = _state_child_name(module, name)
        out[name] = t
    return out


_STATE_LEAVES = ((_BatchNorm, ("mean", "var")),
                 (InputNormalization, ("glob_mean", "glob_std", "count")),
                 (CBatchNorm, ("num_batches_tracked", "moving_Vrr",
                               "moving_Vii", "moving_Vri", "moving_mean")),
                 (QBatchNorm, ("num_batches_tracked", "running_mean",
                               "running_var")))


def _running_stat(module, name):
    owner, leaf = _owner(module, name)
    return any(isinstance(owner, cls) and leaf in leaves
               for cls, leaves in _STATE_LEAVES)


def load_module_tree(module, tree, state=None):
    """Fill ``module`` from its JAX sub-tree (strict) and, when ``state``
    (the JAX state tree of the same module) is given, its BatchNorm running
    statistics from it; without ``state`` the module keeps its own."""
    flat = _flatten(tree)
    if state is not None:
        flat.update(_flatten(state))
    keep_stats = state is None
    state = _conv_leaves(module, dict(_convert(p, v) for p, v in flat.items()))
    own = module.state_dict()
    for name, value in own.items():
        if ((keep_stats and _running_stat(module, name))
                or name.endswith("_extra_state")):
            state.setdefault(name, value)
    for name, w_q8 in state.items():
        if name.endswith("_q8"):
            owner, _, leaf = name.rpartition(".")
            module.get_submodule(owner).to_int8_(
                leaf[:-len("_q8")], w_q8, state[name[:-len("q8")] + "scale"])
    module.load_state_dict(state, strict=True)


def module_state(module, tree):
    """``module``'s state-dict names → tensors of a JAX tree shaped like
    its parameters (its params, or an optimizer's moments of them), in
    the port's layouts; nothing is loaded."""
    return _conv_leaves(module, dict(_convert(p, v)
                                     for p, v in _flatten(tree).items()))


def load_running_stats(module, state):
    """Fill ``module``'s BatchNorm running statistics from its JAX state
    tree (the JAX Brain's ``model_states`` entry for the module)."""
    buffers = dict(module.named_buffers())
    for name, value in module_state(module, state).items():
        if not _running_stat(module, name):
            raise ValueError(f"{name} is not a running statistic of "
                             f"{type(module).__name__}")
        with torch.no_grad():
            buffers[name].copy_(value)


# optax state (under inject_hyperparams) → torch.optim state: the optax
# state that holds the moments, and torch's name for each of them
_OPTAX_MOMENTS = {torch.optim.Adam: {"mu": "exp_avg", "nu": "exp_avg_sq"},
                  torch.optim.Adadelta: {"e_g": "square_avg",
                                         "e_x": "acc_delta"}}


def load_optax_state(optimizer, tree, modules):
    """Fill a ``torch.optim.Adam`` or ``Adadelta`` from the flax state dict
    of the JAX Brain's optax state of the same optimizer (``optax.adam`` or
    ``optax.adadelta`` under ``inject_hyperparams``): the moments of each
    parameter (``mu``/``nu`` → ``exp_avg``/``exp_avg_sq``; ``e_g``/``e_x``
    → ``square_avg``/``acc_delta``), the step count and the learning rate.
    ``modules`` maps the tree's module names to the modules that own the
    optimizer's parameters. Any other optimizer raises ``TypeError``."""
    moments = _OPTAX_MOMENTS.get(type(optimizer))
    if moments is None:
        raise TypeError(f"a JAX optimizer state is read into torch.optim."
                        f"Adam or Adadelta, not {type(optimizer).__name__}")
    inner = tree.get("inner_state", tree)
    found = [v for v in (inner.values() if isinstance(inner, dict) else [])
             if isinstance(v, dict) and set(moments) <= set(v)]
    if len(found) != 1:
        raise ValueError(f"no optax {type(optimizer).__name__} moments "
                         f"({', '.join(moments)}) in the state")
    part = found[0]
    count = part.get("count", tree.get("count"))
    converted = {torch_key: {name: module_state(modules[name], sub)
                             for name, sub in part[jax_key].items()}
                 for jax_key, torch_key in moments.items()}
    names = {id(p): (m, n) for m, module in modules.items()
             for n, p in module.named_parameters()}
    for group in optimizer.param_groups:
        if "learning_rate" in tree.get("hyperparams", {}):
            group["lr"] = float(tree["hyperparams"]["learning_rate"])
        for p in group["params"]:
            if id(p) not in names:
                raise ValueError("an optimizer parameter of no module given")
            module_name, name = names[id(p)]
            state = {"step": torch.tensor(float(count), dtype=torch.float32)}
            for torch_key, per_module in converted.items():
                if name not in per_module.get(module_name, {}):
                    raise ValueError(f"the state has no {torch_key} for "
                                     f"{module_name}.{name}")
                state[torch_key] = per_module[module_name][name].to(
                    p.device, p.dtype)
            optimizer.state[p] = state


_PRETRAIN = (HuggingFaceWav2Vec2Pretrain, Wav2Vec2Pretrain, AVHubertPretrain)


def load_jax_params(tree, bridge, head=None, state=None):
    """Fill ``bridge`` (``HuggingFaceWav2Vec2``) from ``tree["wav2vec2"]``
    and ``head`` (``Linear``) from ``tree["model"]``. A pretraining model
    (``HuggingFaceWav2Vec2Pretrain``, ``Wav2Vec2Pretrain`` or
    ``AVHubertPretrain``) takes its whole JAX tree: the encoder, the
    quantizer's ``proj`` and ``codevectors`` (1, G·V, D/G), ``project_hid``,
    ``project_q`` and ``mask_emb``, or ``final_proj`` and ``label_embs``
    beside AV-HuBERT's ``model`` with its BatchNorm ``state``."""
    if isinstance(bridge, _PRETRAIN):
        load_module_tree(bridge, tree, state)
        return
    load_module_tree(bridge, tree["wav2vec2"])
    if head is not None:
        load_module_tree(head, tree["model"])


def _uniform(gen, shape, bound):
    return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1)
            * bound).numpy()


def _kaiming(gen, shape, fan_in):
    # kaiming_uniform with a = sqrt(5): bound = sqrt(6 / (1 + 5) / fan_in)
    return _uniform(gen, shape, math.sqrt(1.0 / fan_in))


def _bias(gen, shape, fan_in):
    return _uniform(gen, shape, 1.0 / math.sqrt(fan_in))


def _ln(n):
    return {"scale": np.ones(n, np.float32), "bias": np.zeros(n, np.float32)}


def init_linear(gen, n_in, n_out):
    """Seeded ``Linear`` tree {"w", "b"}: kaiming-uniform weight, torch-style
    bias."""
    return {"w": _kaiming(gen, (n_in, n_out), n_in),
            "b": _bias(gen, (n_out,), n_in)}


def init_embedding(gen, num_embeddings, embedding_dim):
    """Seeded ``Embedding`` tree {"table"}: unit normal."""
    return {"table": torch.randn(num_embeddings, embedding_dim, generator=gen,
                                 dtype=torch.float32).numpy()}


def init_rnn(gen, gates, input_size, hidden_size, num_layers=1,
             bidirectional=False, bias=True):
    """Seeded tree of an ``RNN`` (``gates`` 1), ``GRU`` (3) or ``LSTM`` (4)
    or of their cells: ``l{k}``/``l{k}_rev`` with ``w_ih`` (in, g·H),
    ``w_hh`` (H, g·H), ``b_ih``, ``b_hh``, all uniform in
    ±1/sqrt(hidden_size)."""
    bound = 1.0 / math.sqrt(hidden_size)
    n_dir = 2 if bidirectional else 1
    tree = {}
    for layer in range(num_layers):
        n_in = input_size if layer == 0 else hidden_size * n_dir
        for suffix in ("", "_rev")[:n_dir]:
            p = {"w_ih": _uniform(gen, (n_in, gates * hidden_size), bound),
                 "w_hh": _uniform(gen, (hidden_size, gates * hidden_size),
                                  bound)}
            if bias:
                p["b_ih"] = _uniform(gen, (gates * hidden_size,), bound)
                p["b_hh"] = _uniform(gen, (gates * hidden_size,), bound)
            tree[f"l{layer}{suffix}"] = p
    return tree


def _init_pos_conv(generator, d, k, groups):
    in_g = d // groups
    v = _kaiming(generator, (k, in_g, d), in_g * k)
    return {"v": v,
            "g": np.sqrt(np.square(v).sum(axis=(1, 2), keepdims=True)),
            "b": _bias(generator, (d,), in_g * k)}


def _init_wavlm_attn(generator, d, heads, rel_attn_embed, num_buckets):
    """WavLM's attention tree (``wav2vec2.py:375``): kaiming-uniform
    projections with torch-style biases, the gate's ``gru_w`` (head_dim, 8)
    and ``gru_b``, a unit ``gru_const`` (1, H, 1, 1), and in layer 0 the
    bucket embedding ``rel_attn_embed``, normal(0, 0.02)."""
    attn = {}
    for name in ("q", "k", "v", "o"):
        attn[f"w{name}"] = _kaiming(generator, (d, d), d)
        attn[f"b{name}"] = _bias(generator, (d,), d)
    hd = d // heads
    attn["gru_w"] = _kaiming(generator, (hd, 8), hd)
    attn["gru_b"] = _bias(generator, (8,), hd)
    attn["gru_const"] = np.ones((1, heads, 1, 1), np.float32)
    if rel_attn_embed:
        attn["rel_attn_embed"] = (torch.randn(
            num_buckets, heads, generator=generator) * 0.02).numpy()
    return attn


def _init_layers(generator, n, d, ffn, heads=None, num_buckets=None):
    """The encoder layers' trees; with ``heads`` and ``num_buckets`` WavLM's
    gated attention, else glorot-uniform projections with zero biases."""
    limit = math.sqrt(6.0 / (2 * d))
    layers = {}
    for i in range(n):
        if num_buckets is not None:
            attn = _init_wavlm_attn(generator, d, heads, i == 0, num_buckets)
        else:
            attn = {}
            for name in ("q", "k", "v", "o"):
                attn[f"w{name}"] = _uniform(generator, (d, d), limit)
                attn[f"b{name}"] = np.zeros(d, np.float32)
        layers[str(i)] = {"attn": attn,
                          "ffn1": init_linear(generator, d, ffn),
                          "ffn2": init_linear(generator, ffn, d),
                          "ln1": _ln(d), "ln2": _ln(d)}
    return layers


def init_wav2vec2(config, generator):
    """Seeded bridge tree {"encoder": ...} at the JAX shapes of every
    family: kaiming-uniform convs and linears with torch-style biases (no
    conv bias without ``conv_bias``), unit LayerNorms after every conv or a
    unit GroupNorm after the first ("group" mode), a feature-projection
    LayerNorm unless ``feat_proj_layer_norm`` is False, a weight-norm ``g``
    equal to the norm of ``v`` or data2vec's stacked convs ``"0"``...,
    glorot-uniform attention projections with zero biases, or WavLM's
    gated attention (``_init_wavlm_attn``)."""
    c = config
    fe, in_ch = {}, 1
    for i, (dim, k) in enumerate(zip(c.conv_dim, c.conv_kernel)):
        conv = {"w": _kaiming(generator, (k, in_ch, dim), in_ch * k)}
        if c.conv_bias:
            conv["b"] = _bias(generator, (dim,), in_ch * k)
        fe[str(i)] = {"conv": conv}
        if c.feat_extract_norm == "layer":
            fe[str(i)]["layer_norm"] = _ln(dim)
        elif i == 0:
            fe[str(i)]["group_norm"] = _ln(dim)
        in_ch = dim
    d = c.hidden_size
    if c.pos_conv_type == "stacked":
        k, in_g = c.pos_conv_kernel, d // c.num_conv_pos_embedding_groups
        pos_conv = {str(i): {"w": _kaiming(generator, (k, in_g, d), in_g * k),
                             "b": _bias(generator, (d,), in_g * k)}
                    for i in range(c.pos_conv_depth)}
    else:
        pos_conv = _init_pos_conv(generator, d, c.num_conv_pos_embeddings,
                                  c.num_conv_pos_embedding_groups)
    layers = _init_layers(generator, c.num_layers, d, c.ffn_size, c.num_heads,
                          c.num_buckets if c.rel_pos_bias else None)
    encoder = {"feature_extractor": fe,
               "feat_proj": init_linear(generator, c.conv_dim[-1], d),
               "pos_conv": pos_conv, "encoder_ln": _ln(d), "layers": layers}
    if c.feat_proj_layer_norm:
        encoder["feat_proj_ln"] = _ln(c.conv_dim[-1])
    return {"encoder": encoder}


def _conv_normal(gen, shape):
    """The ResNet conv init (``resnet.py:33-38``): normal(0, sqrt(2/n)),
    n = prod(kernel) · out, in the JAX layout (*kernel, in, out)."""
    n = int(np.prod(shape[:-2])) * shape[-1]
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * math.sqrt(2.0 / n)).numpy()


def _bn(n):
    return _ln(n), {"mean": np.zeros(n, np.float32),
                    "var": np.ones(n, np.float32)}


def _prelu(n):
    return {"alpha": np.full(n, 0.25, np.float32)}


def init_resnet(gen, relu_type="prelu"):
    """Seeded ``ResEncoder`` (params, state) trees at the JAX shapes:
    normal(0, sqrt(2/n)) convs, unit BatchNorms with zero means and unit
    variances, PReLU slopes of 0.25 per channel."""
    params = {"frontend_conv": {"w": _conv_normal(gen, (5, 7, 7, 1, 64))}}
    params["frontend_bn"], fbn = _bn(64)
    if relu_type == "prelu":
        params["frontend_act"] = _prelu(64)
    trunk_p, trunk_s, inplanes = {}, {}, 64
    for stage, planes in enumerate((64, 128, 256, 512)):
        for b in range(2):
            p, st = {}, {}
            cin = inplanes if b == 0 else planes
            p["conv1"] = {"w": _conv_normal(gen, (3, 3, cin, planes))}
            p["bn1"], st["bn1"] = _bn(planes)
            p["conv2"] = {"w": _conv_normal(gen, (3, 3, planes, planes))}
            p["bn2"], st["bn2"] = _bn(planes)
            if relu_type == "prelu":
                p["relu1"], p["relu2"] = _prelu(planes), _prelu(planes)
            if b == 0 and (stage > 0 or inplanes != planes):
                p["down_conv"] = {"w": _conv_normal(gen, (1, 1, cin, planes))}
                p["down_bn"], st["down_bn"] = _bn(planes)
            trunk_p[f"layer{stage + 1}_{b}"] = p
            trunk_s[f"layer{stage + 1}_{b}"] = st
        inplanes = planes
    params["trunk"] = trunk_p
    return params, {"frontend_bn": fbn, "trunk": trunk_s}


def init_avhubert(config, gen):
    """Seeded ``AVHubertModel`` (params, state) trees at the JAX shapes of
    ``init``/``init_state``: ``init_resnet``, ``init_linear`` projections,
    the wav2vec2 encoder's initialisation (``init_wav2vec2``), unit
    LayerNorms and a uniform ``mask_emb``."""
    c = config
    d = c.encoder_embed_dim
    embed = 2 * d if c.modality_fuse == "concat" else d
    resnet_p, resnet_s = init_resnet(gen, c.relu_type)
    params = {
        "feature_extractor_audio": {
            "proj": init_linear(gen, c.audio_feat_dim, d)},
        "feature_extractor_video": {
            "resnet": resnet_p, "proj": init_linear(gen, c.video_feat_dim, d)},
        "layer_norm": _ln(embed),
        "pos_conv": _init_pos_conv(gen, d, c.conv_pos, c.conv_pos_groups),
        "encoder_ln": _ln(d),
        "layers": _init_layers(gen, c.encoder_layers, d,
                               c.encoder_ffn_embed_dim),
        "mask_emb": torch.rand(c.audio_feat_dim, generator=gen).numpy()}
    if embed != d:
        params["post_extract_proj"] = init_linear(gen, embed, d)
    return params, {"feature_extractor_video": {"resnet": resnet_s}}


def init_mha(gen, d_model, kdim=None, vdim=None):
    """Seeded ``MultiheadAttention`` tree: glorot-uniform (in, out)
    projections, zero biases (``attention.py:130``)."""
    tree = {}
    for name, n_in in (("q", d_model), ("k", kdim or d_model),
                       ("v", vdim or d_model), ("o", d_model)):
        tree[f"w{name}"] = _uniform(gen, (n_in, d_model),
                                    math.sqrt(6.0 / (n_in + d_model)))
        tree[f"b{name}"] = np.zeros(d_model, np.float32)
    return tree


def init_fusion(gen, d_model, d_ffn):
    """Seeded ``FusionRCA`` tree {"fusion": {"layer1", "layer2"}}: each RCA
    layer's attention (``init_mha``), FFN (``init_linear``) and unit
    LayerNorms."""
    def layer():
        return {"self_att": init_mha(gen, d_model),
                "pos_ffn": {"ffn1": init_linear(gen, d_model, d_ffn),
                            "ffn2": init_linear(gen, d_ffn, d_model)},
                "norm1": _ln(d_model), "norm2": _ln(d_model)}

    return {"fusion": {"layer1": layer(), "layer2": layer()}}


def _glorot(gen, n_in, n_out):
    return _uniform(gen, (n_in, n_out), math.sqrt(6.0 / (n_in + n_out)))


def _normal(gen, shape, std):
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * std).numpy()


def init_fairseq_decoder(cfg, gen):
    """Seeded ``FairseqTransformerDecoder`` tree at the JAX shapes
    (``seq2seq_decoder.py:172``): token embeddings (and a learned position
    table, a separate output embedding) normal(0, d^-1/2), glorot-uniform
    attention projections (``init_mha``) and FFN weights with zero biases,
    unit LayerNorms."""
    d, f = cfg.embed_dim, cfg.ffn_dim
    std = d ** -0.5
    tree = {"embed_tokens": {"table": _normal(gen, (cfg.vocab_size, d), std)},
            "layers": {str(i): {
                "self_attn": init_mha(gen, d), "encoder_attn": init_mha(gen, d),
                "ln_self": _ln(d), "ln_cross": _ln(d), "ln_final": _ln(d),
                "fc1": {"w": _glorot(gen, d, f), "b": np.zeros(f, np.float32)},
                "fc2": {"w": _glorot(gen, f, d), "b": np.zeros(d, np.float32)},
            } for i in range(cfg.num_layers)}}
    if cfg.learned_pos:
        n_pos = cfg.max_target_positions + cfg.padding_idx + 1
        tree["embed_positions"] = {"table": _normal(gen, (n_pos, d), std)}
    if not cfg.share_input_output_embed:
        tree["embed_out"] = _normal(gen, (cfg.vocab_size, d), std)
    if cfg.normalize_before:
        tree["final_ln"] = _ln(d)
    return tree


def init_avhubert_asr(encoder_config, decoder_config, gen):
    """Seeded ``AVHubertASR`` (params, state) trees: ``init_avhubert`` under
    "encoder", ``init_fairseq_decoder`` under "decoder"; the state tree is
    ``{"encoder": ...}``."""
    enc_p, enc_s = init_avhubert(encoder_config, gen)
    return ({"encoder": enc_p,
             "decoder": init_fairseq_decoder(decoder_config, gen)},
            {"encoder": enc_s})


def init_params(config, generator, head_outputs=20):
    """Seeded flagship tree {"wav2vec2": {"encoder": ...}, "model": ...}:
    ``init_wav2vec2``, then ``init_linear`` for the frame head."""
    wav2vec2 = init_wav2vec2(config, generator)
    return {"wav2vec2": wav2vec2,
            "model": init_linear(generator, config.hidden_size, head_outputs)}


def _affine(module):
    if getattr(module, "scale", None) is None:
        return {}
    return _ln(module.scale.shape[0])


def _init_conv(gen, module):
    k = module.kernel_size
    in_g = module.in_channels // module.groups
    fan_in = in_g * int(np.prod(k))
    tree = {"w": _kaiming(gen, (*k, in_g, module.out_channels), fan_in)}
    if module.bias is not None:
        tree["b"] = _bias(gen, (module.out_channels,), fan_in)
    return tree


def _init_conv_transpose(gen, module):
    fan_in = module.in_channels * module.kernel_size
    tree = {"w": _kaiming(gen, (module.kernel_size, module.out_channels,
                                module.in_channels), fan_in)}
    if module.bias is not None:
        tree["b"] = _bias(gen, (module.out_channels,), fan_in)
    return tree


def _init_linear_leaf(gen, module):
    n_in, n_out = module.w.shape
    if module.b is None:
        return {"w": _kaiming(gen, (n_in, n_out), n_in)}
    return init_linear(gen, n_in, n_out)


def _init_rnn_leaf(gen, module):
    gates = 4 if isinstance(module, LSTM) else 3 if isinstance(module, GRU) \
        else 1
    return init_rnn(gen, gates, module.input_size, module.hidden_size,
                    module.num_layers, module.bidirectional, module.bias)


def _init_ligru_layer(gen, layer):
    h = layer.u.shape[0]
    bound = 1.0 / math.sqrt(h)
    return {"w": _uniform(gen, tuple(layer.w.shape), bound),
            "u": _uniform(gen, (h, 2 * h), bound), "norm": _ln(2 * h)}


def _init_relpos_mha(gen, module):
    d, h, dh = module.embed_dim, module.num_heads, module.head_dim
    tree = {name: _glorot(gen, d, d) for name in ("wq", "wk", "wv", "wo")}
    tree["bo"] = np.zeros(d, np.float32)
    tree["wpos"] = _glorot(gen, d, d)
    tree["u"], tree["v"] = _glorot(gen, h, dh), _glorot(gen, h, dh)
    return tree


def _init_embedding(gen, module):
    if module.consider_as_one_hot:
        return {}
    return init_embedding(gen, module.num_embeddings, module.embedding_dim)


def _with_own(own):
    """The initialiser of a module with children and parameters of its
    own: its children's trees, in their order, then ``own(gen, module)``."""
    def init(gen, module):
        tree = {}
        for name, child in module.named_children():
            sub = seeded_tree(child, gen)
            if sub is not None:
                tree[name] = sub
        tree.update(own(gen, module))
        return tree
    return init


# the seeded initialiser of each of the port's leaf classes with
# parameters: the distributions and bounds of the JAX ``init``s
_LEAF_INITS = (
    (Linear, _init_linear_leaf),
    (_ConvNd, _init_conv),
    (ConvTranspose1d, _init_conv_transpose),
    (SincConv, lambda gen, m: dict(zip(("low_hz", "band_hz"),
                                       m.mel_init()))),
    ((LayerNorm, GroupNorm, _BatchNorm, _InstanceNorm),
     lambda gen, m: _affine(m)),
    (PReLU, lambda gen, m: {"alpha": np.full(m.num_parameters, m.init_val,
                                             np.float32)}),
    (Embedding, _init_embedding),
    (_RNNBase, _init_rnn_leaf),
    (MultiheadAttention, lambda gen, m: init_mha(gen, m.d_model, m.kdim,
                                                 m.vdim)),
    (RelPosMHAXL, _init_relpos_mha),
    (_LiGRULayer, _init_ligru_layer),
    (GlobalLayerNorm, lambda gen, m: _ln(m.channel_size)),
    (SharedPReLU, lambda gen, m: {"alpha": np.full((), m.init_val,
                                                   np.float32)}),
    (Classifier, _with_own(lambda gen, m: {"weight": _glorot(
        gen, m.out_neurons, m.lin_neurons)})),
    (EnhancementGenerator, _with_own(lambda gen, m: {
        "sigmoid_beta": np.ones((), np.float32)})),
    (Learnable_sigmoid, lambda gen, m: {
        "slope": np.ones(m.in_features, np.float32)}),
    ((CLinear, _CConvNd, _CNormBase, QLinear, _QConvNd, QBatchNorm),
     lambda gen, m: m.init_tree(gen)),
    (GumbelVectorQuantizer, _with_own(lambda gen, m: {
        "codevectors": _uniform(gen, tuple(m.codevectors.shape), math.sqrt(
            6.0 / sum(m.codevectors.shape[1:])))})),
    (Wav2Vec2Pretrain, _with_own(lambda gen, m: {
        "mask_emb": torch.rand(m.mask_emb.shape, generator=gen).numpy()})),
    (AVHubertPretrain, _with_own(lambda gen, m: {
        "label_embs": _normal(gen, tuple(m.label_embs.shape), 0.02),
        "mask_emb": torch.rand(m.mask_emb.shape, generator=gen).numpy()})),
)


def seeded_tree(module, generator):
    """The seeded JAX-shaped tree of one module, or None if it holds no
    parameters: ``init_wav2vec2`` for a ``HuggingFaceWav2Vec2``,
    ``init_avhubert``'s parameters for a ``FairseqAVHubert`` or
    ``AVHubertModel``, ``init_fairseq_decoder`` or ``init_avhubert_asr``'s
    parameters for a ``FairseqTransformerDecoder`` or an ``AVHubertASR``,
    ``init_fusion`` for a ``FusionRCA``, the initialiser of
    ``_LEAF_INITS`` for a leaf class (``Linear``, the convs, the norms,
    ``PReLU``, ``Embedding``, the RNNs and cells, the attentions, a LiGRU
    layer, gLN/cLN, the dual path's scalar PReLU, ``Classifier``,
    ``EnhancementGenerator``, ``Learnable_sigmoid``, the complex and
    quaternion layers and norms, the pretraining models' quantizer and
    their own ``mask_emb``/``label_embs``; ``init_wav2vec2``'s encoder for
    a ``Wav2Vec2Encoder``), and for any other module the trees of
    its children, in their order. A module with parameters of its own and no initialiser raises
    ``NotImplementedError`` naming its class."""
    if isinstance(module, HuggingFaceWav2Vec2):
        return init_wav2vec2(module.config, generator)
    if isinstance(module, Wav2Vec2Encoder):
        return init_wav2vec2(module.config, generator)["encoder"]
    if isinstance(module, FairseqAVHubert):
        return {"model": init_avhubert(module.config, generator)[0]}
    if isinstance(module, AVHubertModel):
        return init_avhubert(module.config, generator)[0]
    if isinstance(module, FairseqTransformerDecoder):
        return init_fairseq_decoder(module.cfg, generator)
    if isinstance(module, AVHubertASR):
        return init_avhubert_asr(module.encoder_config,
                                 module.decoder_config, generator)[0]
    if isinstance(module, FusionRCA):
        ffn = module.fusion.layer1.pos_ffn
        return init_fusion(generator, ffn.input_size, ffn.d_ffn)
    for cls, init in _LEAF_INITS:
        if isinstance(module, cls):
            return init(generator, module) or None
    if next(module.parameters(recurse=False), None) is not None:
        raise NotImplementedError(
            f"no seeded initialisation for {type(module).__name__}")
    tree = {}
    for name, child in module.named_children():
        sub = seeded_tree(child, generator)
        if sub is not None:
            tree[name] = sub
    return tree or None


def is_unseeded(module):
    """Whether ``module`` still holds what the port's constructors put in
    it: every parameter one value throughout (zeros where the JAX ``init``
    draws, ones or a fixed slope elsewhere) and at least one of them all
    zeros. Loaded or seeded weights draw at least one parameter of several
    values, and such a module is left as it is."""
    found_zero = False
    for p in module.parameters():
        flat = p.detach().reshape(-1)
        if flat.numel() == 0:
            continue
        if bool((flat != flat[0]).any()):
            return False
        found_zero = found_zero or bool(flat[0] == 0)
    return found_zero


def init_modules(modules, seed):
    """Fill every module of ``modules`` (a dict, in its order) with seeded
    random parameters from one ``torch.Generator``: what the JAX ``Brain``
    does with its PRNG when it is built (its numbers differ). Buffers keep
    their values."""
    generator = torch.Generator().manual_seed(seed)
    for module in modules.values():
        tree = seeded_tree(module, generator)
        if tree is not None:
            converted = module_state(module, tree)
            params = dict(module.named_parameters())
            for name, value in module.state_dict().items():
                if name not in params:
                    converted.setdefault(name, value)
            module.load_state_dict(converted, strict=True)


def _unconvert(name, tensor):
    """(port parameter name, tensor) → (JAX key path, numpy array): the
    inverse of ``_convert``; the array is a copy."""
    t = tensor.detach().to(
        "cpu", tensor.dtype if tensor.dtype == torch.int8 else torch.float32,
        copy=True)
    path = name.replace(".", "/")
    path = re.sub(r"feature_extractor/layers/(\d+)/", r"feature_extractor/\1/",
                  path)
    if re.search(r"feature_extractor/\d+/conv/weight$", path):
        path, t = path[:-len("weight")] + "w", t.permute(2, 1, 0)
    elif re.search(r"feature_extractor/\d+/conv/bias$", path):
        path = path[:-len("bias")] + "b"
    elif path.endswith("pos_conv/v") or _STACKED_POS_CONV.search(path):
        t = t.permute(2, 1, 0)
    elif path.endswith("pos_conv/g"):
        t = t.reshape(-1, 1, 1)                # (1, 1, k) → (k, 1, 1)
    rnn = _RNN_PARAM.search(path)
    if rnn:
        layer, kind, part, rev = rnn.groups()
        path = (f"{path[:rnn.start(1) - len('layers/')]}l{layer}"
                f"{'_rev' if rev else ''}/{kind[0]}_{part}")
        if kind == "weight":
            t = t.t()
    return path, t.contiguous().numpy()


def module_tree(module, running_stats=False):
    """A module's parameters as its JAX-shaped tree of numpy arrays: the
    inverse of ``load_module_tree``. With ``running_stats`` the tree of its
    BatchNorm running statistics instead (the JAX state tree)."""
    tree = {}
    for name, tensor in module.state_dict().items():
        if (name.endswith("_extra_state")
                or _running_stat(module, name) != running_stats):
            continue
        owner, leaf = _owner(module, name)
        if isinstance(owner, (_ConvNd, ConvTranspose1d)):
            if leaf == "weight":
                tensor = (tensor.permute(2, 1, 0)
                          if isinstance(owner, ConvTranspose1d)
                          else torch_to_jax_conv_weight(tensor))
            name = name[:-len(leaf)] + {"weight": "w", "bias": "b"}[leaf]
        if running_stats:       # a statistic kept at an ancestor's path
            path = name.split(".")[:-1]
            while path and getattr(module.get_submodule(".".join(path[:-1])),
                                   "jax_state_child", None) == path[-1]:
                path.pop()
            name = ".".join(path + [leaf])
        path, value = _unconvert(name, tensor)
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def export_jax_params(bridge, head=None):
    """The inverse of ``load_jax_params``: {"wav2vec2": ..., "model": ...}
    in the JAX layouts, so parameters can be compared with the JAX
    package's after training steps.

    Example
    -------
    >>> import torch
    >>> from svt_speechbrain_tpu_torch.nnet.linear import Linear
    >>> head = Linear(3, 2)
    >>> sorted(export_jax_params(head)["wav2vec2"])
    ['b', 'w']
    """
    tree = {"wav2vec2": module_tree(bridge)}
    if head is not None:
        tree["model"] = module_tree(head)
    return tree


class _MsgpackReader:
    """A decoder of the msgpack that flax's ``to_bytes`` writes: maps,
    arrays, str, bin, ints, floats, nil, bool and ext/fixext, with ext
    type 1 an array and type 3 a numpy scalar (each as msgpack of
    ``(shape, dtype name, C-order bytes)``). Any other byte or ext type
    raises ``ValueError``."""

    _FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
              0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
    _SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
              0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
              0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
              0xde: ("map", ">H"), 0xdf: ("map", ">I"),
              0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
    _FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}

    def __init__(self, data, where):
        self.data, self.i, self.where = memoryview(data), 0, where

    def take(self, n):
        if self.i + n > len(self.data):
            raise ValueError(f"{self.where}: msgpack data ends early")
        out = self.data[self.i:self.i + n]
        self.i += n
        return out

    def number(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read_all(self):
        value = self.read()
        if self.i != len(self.data):
            raise ValueError(f"{self.where}: bytes after the msgpack object")
        return value

    def read(self):
        b = self.number(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.container("map", b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.container("array", b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in self._FIXED:
            return self.number(self._FIXED[b])
        if b in self._FIXEXT:
            return self.ext(self._FIXEXT[b])
        if b in self._SIZED:
            kind, fmt = self._SIZED[b]
            n = self.number(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "ext":
                return self.ext(n)
            return self.container(kind, n)
        raise ValueError(f"{self.where}: msgpack byte 0x{b:02x} is not read")

    def container(self, kind, n):
        if kind == "array":
            return [self.read() for _ in range(n)]
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n):
        code = self.number(">b")
        data = self.take(n)
        if code not in (1, 3):
            raise ValueError(f"{self.where}: msgpack extension type {code} "
                             f"is not a parameter array")
        shape, dtype, buf = _MsgpackReader(data, self.where).read_all()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            # numpy has no bfloat16 without ml_dtypes: the bits as uint16,
            # viewed as torch's bfloat16
            bits = np.frombuffer(buf, np.uint16).reshape(shape).copy()
            return torch.from_numpy(bits).view(torch.bfloat16)
        try:
            np_dtype = np.dtype(dtype)
        except TypeError as e:
            raise ValueError(f"{self.where}: arrays of dtype {dtype} are not "
                             f"read") from e
        array = np.frombuffer(buf, np_dtype).reshape(shape)
        return array[()] if code == 3 else array


def load_msgpack(path):
    """The tree of numpy arrays that the JAX package's ``save_msgpack``
    (flax's msgpack encoding) wrote to ``path``: nested dicts whose leaves
    are arrays (extension type 1) or numpy scalars (type 3); a bfloat16
    leaf comes back as a ``torch.bfloat16`` tensor. Read by
    ``_MsgpackReader``, so no ``msgpack`` package is needed.

    Example
    -------
    >>> import os, tempfile
    >>> path = os.path.join(tempfile.mkdtemp(), "tree.msgpack")
    >>> _ = open(path, "wb").write(bytes.fromhex(
    ...     "81a17781a177c7160193920102a7666c6f61743332c4080000803f00000040"))
    >>> load_msgpack(path)
    {'w': {'w': array([[1., 2.]], dtype=float32)}}
    """
    with open(path, "rb") as f:
        tree = _MsgpackReader(f.read(), path).read_all()

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"{path}: arrays chunked above 1 GiB are "
                                 f"not read")
            for value in node.values():
                check(value)

    check(tree)
    return tree
