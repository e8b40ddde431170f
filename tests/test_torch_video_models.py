"""Port parity, the N20EMv2 video path's modules: ``Conv2d``/``Conv3d``,
``BatchNorm1d/2d/3d`` with their running statistics, ``PReLU``, the
``ResEncoder`` (Conv3d + ResNet-18), ``AVHubertModel`` and
``FairseqAVHubert``, a tiny ``VideoAMT`` loss and its gradients,
``quantize_avhubert`` and the fairseq converter, against the JAX package on
the CPU, from JAX-initialised trees (``convert_jax.load_module_tree``) and
the same seeded numpy inputs, in f32.

Tolerances (absolute, f32, products summed in other orders):
- a single conv: CONV_ATOL; a BatchNorm and PReLU: NORM_ATOL;
- the ``ResEncoder`` at 32×32: RES_ATOL (20 convs with a BatchNorm after
  each; every BatchNorm renormalizes to unit scale, so the error does not
  grow with depth: 1.0e-4 measured at outputs up to 5); the running
  statistics RES_ATOL too;
- ``AVHubertModel``/``FairseqAVHubert`` at the JAX docstring's tiny config:
  MODEL_ATOL (the ResNet's error through a projection, a LayerNorm and one
  encoder layer);
- the ``VideoAMT`` loss relative LOSS_RTOL; each parameter's gradient
  within GRAD_RTOL of the largest gradient of its leaf, plus GRAD_ATOL for
  the leaves whose gradient is 0 in exact arithmetic (the attention's key
  bias: float noise of about 5e-8 on each side);
- int8: the quantized weights and scales bit for bit; the outputs within
  INT8_ATOL of the JAX int8 model (an activation on a rounding boundary may
  take the other integer on one side: one quantization step of its row).
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_speechbrain_tpu.models import avhubert as javhubert
from svt_speechbrain_tpu.models import convert_fairseq as jconvert
from svt_speechbrain_tpu.models import quantize as jquantize
from svt_speechbrain_tpu.models import resnet as jresnet
from svt_speechbrain_tpu.nnet import activations as jact
from svt_speechbrain_tpu.nnet import cnn as jcnn
from svt_speechbrain_tpu.nnet import losses as jlosses
from svt_speechbrain_tpu.nnet import normalization as jnorm
from svt_speechbrain_tpu.tasks import amt as jamt

from svt_speechbrain_tpu_torch.convert_jax import (
    _flatten, init_avhubert, init_resnet, load_module_tree, module_tree)
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.models import avhubert, convert_fairseq
from svt_speechbrain_tpu_torch.models import quantize, resnet
from svt_speechbrain_tpu_torch.nnet import activations, cnn, losses
from svt_speechbrain_tpu_torch.nnet import normalization
from svt_speechbrain_tpu_torch.tasks import amt

CONV_ATOL = 1e-5
NORM_ATOL = 1e-5
RES_ATOL = 5e-4
MODEL_ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 2e-7
INT8_ATOL = 2e-2
REPO = Path(__file__).resolve().parent.parent
MANIFESTS = REPO / "tests" / "fixtures" / "ckpt_manifests.json"
TINY = dict(encoder_layers=1, encoder_embed_dim=16, encoder_ffn_embed_dim=32,
            encoder_attention_heads=4, audio_feat_dim=10, conv_pos=8,
            conv_pos_groups=2, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, dropout_input=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, atol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


def _assert_trees_close(got, want, atol, what=""):
    g, w = _flatten(got), _flatten(_np(want))
    assert sorted(g) == sorted(w), what
    for key in w:
        _close(g[key], w[key], atol, f"{what} {key}")


# ------------------------------------------------------------- convolutions
CONV_CASES = [
    # (ndim, kernel, stride, padding, in, out, bias, dilation)
    (2, 1, 1, "valid", 4, 6, True, 1),
    (2, 1, 2, "valid", 4, 6, False, 1),
    (2, 3, 1, "same", 4, 6, True, 1),
    (2, 3, 2, "same", 4, 6, False, 1),
    (2, 3, 2, "valid", 4, 6, True, 1),
    (2, 3, 1, "same", 4, 6, False, 2),
    (2, (3, 1), (2, 1), "same", 3, 5, True, 1),
    (3, (5, 7, 7), (1, 2, 2), "same", 1, 8, False, 1),
    (3, (5, 7, 7), (1, 2, 2), "valid", 1, 8, False, 1),
    (3, 3, 1, "same", 2, 4, True, 1),
    (3, 3, 2, "same", 2, 4, True, 1),
    (3, 1, 2, "valid", 2, 4, False, 1),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv_matches_jax(case):
    """"same" pads like JAX (a strided axis k // 2 each side, a stride-1
    axis (d·(k-1)) // 2), "valid" pads nothing; outputs within CONV_ATOL."""
    ndim, k, s, pad, cin, cout, bias, d = case
    jcls, cls = ((jcnn.Conv2d, cnn.Conv2d) if ndim == 2
                 else (jcnn.Conv3d, cnn.Conv3d))
    jconv = jcls(cout, k, cin, stride=s, padding=pad, bias=bias, dilation=d)
    params = jconv.init(jax.random.PRNGKey(ndim))
    conv = cls(cout, k, cin, stride=s, padding=pad, bias=bias, dilation=d)
    load_module_tree(conv, _np(params))
    rng = np.random.default_rng(1)
    spatial = (7, 17, 16) if ndim == 3 else (17, 16)
    x = _rand(rng, 2, *spatial, cin)
    want = jconv(params, jnp.asarray(x))
    got = conv(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want, CONV_ATOL)
    assert _flatten(module_tree(conv)).keys() == _flatten(_np(params)).keys()
    _close(torch.from_numpy(module_tree(conv)["w"]), params["w"], 0)


def test_frontend_conv_pads_like_the_reference_torch_conv():
    conv = cnn.Conv3d(64, (5, 7, 7), 1, stride=(1, 2, 2), bias=False)
    assert conv.pads() == (2, 3, 3)
    x = torch.randn(1, 6, 20, 20, 1)
    want = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight,
                                      stride=(1, 2, 2), padding=(2, 3, 3))
    torch.testing.assert_close(conv(x), want.permute(0, 2, 3, 4, 1))


# ------------------------------------------------------- norms, activations
@pytest.mark.parametrize("kind", ["1d", "2d", "3d"])
def test_batchnorm_train_and_eval_match_jax(kind):
    """Three train steps (outputs and running statistics after each), then
    eval on the buffers; the biased batch variance normalizes, the unbiased
    one enters the running estimate."""
    shape = {"1d": (3, 5, 4), "2d": (2, 3, 5, 4), "3d": (2, 3, 4, 5, 4)}[kind]
    jbn = getattr(jnorm, f"BatchNorm{kind}")(4)
    bn = getattr(normalization, f"BatchNorm{kind}")(4)
    rng = np.random.default_rng(2)
    params = {"scale": jnp.asarray(_rand(rng, 4) + 1.0),
              "bias": jnp.asarray(_rand(rng, 4))}
    load_module_tree(bn, _np(params))
    state = jbn.init_state()
    for step in range(3):
        x = _rand(rng, *shape, scale=2.0) + step
        want, state = jbn(params, state, jnp.asarray(x), train=True)
        got = bn(torch.from_numpy(x), train=True)
        _close(got, want, NORM_ATOL, f"step {step}")
        _close(bn.mean, state["mean"], NORM_ATOL)
        _close(bn.var, state["var"], NORM_ATOL)
    x = _rand(rng, *shape)
    want, same = jbn(params, state, jnp.asarray(x), train=False)
    before = bn.mean.clone()
    _close(bn(torch.from_numpy(x)), want, NORM_ATOL)
    assert torch.equal(bn.mean, before)
    assert module_tree(bn, running_stats=True).keys() == {"mean", "var"}


def test_batchnorm_statistics_are_buffers_outside_autograd():
    bn = normalization.BatchNorm2d(3)
    assert {n for n, _ in bn.named_buffers()} == {"mean", "var"}
    assert {n for n, _ in bn.named_parameters()} == {"scale", "bias"}
    x = torch.randn(2, 4, 4, 3, requires_grad=True)
    bn(x, train=True).sum().backward()
    assert not bn.mean.requires_grad and x.grad is not None
    # cross-replica statistics (SyncBN): they need a process group, and
    # over one rank they are the batch's own
    with pytest.raises((RuntimeError, ValueError)):
        bn(x, train=True, axis_name="data")
    import torch.distributed as dist
    plain = normalization.BatchNorm2d(3)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        synced = normalization.BatchNorm2d(3)
        torch.testing.assert_close(synced(x, train=True, axis_name="data"),
                                   plain(x, train=True), rtol=0, atol=0)
        torch.testing.assert_close(synced.var, plain.var, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [1, 6])
def test_prelu_matches_jax(n):
    """One slope, and distinct slopes per channel (broadcast on the last,
    channel axis: equal slopes would hide a wrong axis)."""
    rng = np.random.default_rng(3)
    alpha = (np.linspace(0.05, 0.9, n) if n > 1 else np.array([0.3])
             ).astype(np.float32)
    x = _rand(rng, 2, 5, 6)
    want = jact.PReLU(n)({"alpha": jnp.asarray(alpha)}, jnp.asarray(x))
    act = activations.PReLU(n)
    load_module_tree(act, {"alpha": alpha})
    _close(act(torch.from_numpy(x)), want, NORM_ATOL)
    if n > 1:
        wrong = np.where(x >= 0, x, alpha[None, :, None][:, :5] * x[:, :5, :1])
        assert np.abs(np.asarray(want)[:, :5, :1] - wrong).max() > 1e-3


# --------------------------------------------------------------- ResEncoder
@pytest.fixture(scope="module")
def resnet_run():
    """The JAX ``ResEncoder`` on (2, 3, 32, 32, 1), train (twice, threading
    the state) then eval, once for the module."""
    enc = jresnet.ResEncoder()
    params = enc.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    xs = [_rand(rng, 2, 3, 32, 32, 1) for _ in range(3)]
    state = enc.init_state()
    outs = []
    for x in xs[:2]:
        y, state = enc(params, state, jnp.asarray(x), train=True)
        outs.append(np.asarray(y))
    y, _ = enc(params, state, jnp.asarray(xs[2]), train=False)
    outs.append(np.asarray(y))
    return dict(params=_np(params), state=_np(state), xs=xs, outs=outs)


@pytest.mark.parametrize("relu_type", ["prelu", "relu"])
def test_resencoder_matches_jax(resnet_run, relu_type):
    r = resnet_run
    enc = resnet.ResEncoder(relu_type=relu_type)
    if relu_type == "relu":
        # the ReLU variant on a seeded tree: JAX from the port's draws
        params, state = init_resnet(torch.Generator().manual_seed(0), "relu")
        jenc = jresnet.ResEncoder(relu_type="relu")
        load_module_tree(enc, params)
        x = r["xs"][0][:, :2]
        want, jstate = jenc(jax.tree_util.tree_map(jnp.asarray, params),
                            jenc.init_state(), jnp.asarray(x), train=True)
        _close(enc(torch.from_numpy(x), train=True), want, RES_ATOL)
        _assert_trees_close(module_tree(enc, running_stats=True), jstate,
                            RES_ATOL, "relu state")
        return
    load_module_tree(enc, r["params"])
    for i, x in enumerate(r["xs"][:2]):
        _close(enc(torch.from_numpy(x), train=True), r["outs"][i], RES_ATOL,
               f"train {i}")
    _assert_trees_close(module_tree(enc, running_stats=True), r["state"],
                        RES_ATOL, "running statistics")
    with torch.no_grad():
        got = enc(torch.from_numpy(r["xs"][2]))
    assert got.shape == (2, 3, 512)
    _close(got, r["outs"][2], RES_ATOL, "eval")


def test_resnet_trees_have_the_jax_structure(resnet_run):
    """``init_resnet`` draws trees of the JAX ``init``/``init_state``
    shapes, and a state tree loads into the buffers."""
    params, state = init_resnet(torch.Generator().manual_seed(1))
    shapes = lambda t: {k: np.shape(v) for k, v in _flatten(t).items()}
    assert shapes(params) == shapes(resnet_run["params"])
    assert shapes(state) == shapes(resnet_run["state"])
    enc = resnet.ResEncoder()
    load_module_tree(enc, resnet_run["params"], resnet_run["state"])
    _close(enc.trunk.layer2_0.down_bn.var,
           resnet_run["state"]["trunk"]["layer2_0"]["down_bn"]["var"], 0)
    w = params["trunk"]["layer1_0"]["conv1"]["w"]
    assert abs(w.std() - np.sqrt(2 / (9 * 64))) < 0.05 * np.sqrt(2 / (9 * 64))
    assert resnet.ResNet is resnet.ResNetTrunk
    assert resnet.downsample_basic_block_v2(8, 4, 2)[0] == 2


# ----------------------------------------------------------------- AV-HuBERT
def _jax_avhubert(fuse):
    cfg = javhubert.AVHubertConfig(**TINY, modality_fuse=fuse)
    model = javhubert.AVHubertModel(cfg)
    params = model.init(jax.random.PRNGKey(5))
    # a nonzero audio projection bias and running statistics away from 0/1
    state = jax.tree_util.tree_map(lambda s: s * 1.5 + 0.1, model.init_state())
    return cfg, model, params, state


@pytest.fixture(scope="module")
def avhubert_runs():
    """The JAX tiny ``AVHubertModel`` (concat and add) on video only, audio
    only and both, eval and train; computed once."""
    rng = np.random.default_rng(6)
    video = _rand(rng, 2, 3, 32, 32, 1)
    audio = _rand(rng, 2, 3, 10)
    runs = {}
    for fuse in ("concat", "add"):
        cfg, model, params, state = _jax_avhubert(fuse)
        outs = {}
        for name, src in (("video", {"video": video}),
                          ("audio", {"audio": audio}),
                          ("both", {"video": video, "audio": audio})):
            j = {k: jnp.asarray(v) for k, v in src.items()}
            outs[name] = np.asarray(model.extract_finetune(params, state, j)[0])
            y, st = model.extract_finetune(params, state, j, train=True)
            outs[name + "_train"] = (np.asarray(y), _np(st))
        runs[fuse] = dict(params=_np(params), state=_np(state), outs=outs,
                          cfg=dict(TINY, modality_fuse=fuse))
    return dict(runs=runs, video=video, audio=audio)


@pytest.mark.parametrize("fuse", ["concat", "add"])
@pytest.mark.parametrize("modality", ["video", "audio", "both"])
def test_avhubert_model_matches_jax(avhubert_runs, fuse, modality):
    r = avhubert_runs["runs"][fuse]
    model = avhubert.AVHubertModel(avhubert.AVHubertConfig(**r["cfg"]))
    assert (model.post_extract_proj is not None) == (fuse == "concat")
    load_module_tree(model, r["params"], r["state"])
    src = {"video": {"video": avhubert_runs["video"]},
           "audio": {"audio": avhubert_runs["audio"]},
           "both": {"video": avhubert_runs["video"],
                    "audio": avhubert_runs["audio"]}}[modality]
    src = {k: torch.from_numpy(v) for k, v in src.items()}
    with torch.no_grad():
        got = model.extract_finetune(src)
    _close(got, r["outs"][modality], MODEL_ATOL, "eval")
    want, want_state = r["outs"][modality + "_train"]
    with torch.no_grad():
        got = model.extract_finetune(src, train=True)
    _close(got, want, MODEL_ATOL, "train")
    _assert_trees_close(module_tree(model, running_stats=True),
                        want_state if modality != "audio" else r["state"],
                        MODEL_ATOL, "running statistics")


def test_fairseq_avhubert_output_norm_and_freeze(avhubert_runs):
    """``output_norm`` is the JAX ``global_layer_norm`` over the whole
    output, padding included; ``freeze`` runs without gradients, the
    BatchNorms in eval mode (statistics untouched) even under ``train``."""
    r = avhubert_runs["runs"]["concat"]
    video = torch.from_numpy(avhubert_runs["video"])
    want = np.asarray(jnorm.global_layer_norm(
        jnp.asarray(r["outs"]["video"])))
    enc = avhubert.FairseqAVHubert(arch_overrides=r["cfg"], output_norm=True,
                                   freeze=True)
    load_module_tree(enc, {"model": r["params"]}, {"model": r["state"]})
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    got = enc({"video": video}, train=True)
    _close(got, want, MODEL_ATOL)
    assert not got.requires_grad
    assert all(torch.equal(v, enc.state_dict()[k]) for k, v in before.items())
    jenc = javhubert.FairseqAVHubert(
        javhubert.AVHubertConfig(**r["cfg"]), output_norm=True, freeze=True)
    jout, jst = jenc({"model": jax.tree_util.tree_map(jnp.asarray,
                                                      r["params"])},
                     {"model": r["state"]}, {"video": jnp.asarray(
                         avhubert_runs["video"])}, train=True)
    _close(got, jout, MODEL_ATOL)
    thawed = avhubert.FairseqAVHubert(arch_overrides=r["cfg"])
    load_module_tree(thawed, {"model": r["params"]}, {"model": r["state"]})
    thawed({"video": video}, train=True).sum().backward()
    assert thawed.model.layers[0].ffn1.w.grad is not None
    assert not torch.equal(thawed.model.feature_extractor_video.resnet
                           .frontend_bn.mean,
                           enc.model.feature_extractor_video.resnet
                           .frontend_bn.mean)
    assert enc.load_pretrained() is None


def test_base_config_and_missing_streams_raise():
    """AV-HuBERT base builds (post-LN layers; its parity with the JAX model
    is held in ``test_torch_wav2vec2_families.py``); a source with neither
    stream raises."""
    with torch.device("meta"):
        base = avhubert.AVHubertModel(avhubert.AVHubertConfig.base())
    assert len(base.layers) == 12 and base.post_extract_proj.w.shape == (
        1536, 768)
    assert not base.layers[0].config.do_stable_layer_norm
    with pytest.raises(ValueError):
        avhubert.AVHubertModel(avhubert.AVHubertConfig(**TINY)
                               ).extract_finetune({})


def test_seeded_avhubert_tree_has_the_jax_structure(avhubert_runs):
    shapes = lambda t: {k: np.shape(v) for k, v in _flatten(t).items()}
    r = avhubert_runs["runs"]["concat"]
    params, state = init_avhubert(avhubert.AVHubertConfig(**r["cfg"]),
                                  torch.Generator().manual_seed(0))
    assert shapes(params) == shapes(r["params"])
    assert shapes(state) == shapes(r["state"])


# ----------------------------------------------------------- VideoAMT grads
def _hparams(pkg_losses, log_softmax):
    crit = dict(reduction="mean", allowed_len_diff=60, label_smoothing=0.0)
    return SimpleNamespace(
        pitch_octave_num=4, onset_positive_weight=15.0,
        offset_positive_weight=1.0,
        onset_criterion=functools.partial(pkg_losses.bce_loss, **crit),
        offset_criterion=functools.partial(pkg_losses.bce_loss, **crit),
        octave_criterion=functools.partial(pkg_losses.nll_loss, **crit),
        pitch_criterion=functools.partial(pkg_losses.nll_loss, **crit),
        log_softmax=log_softmax)


def test_video_amt_loss_and_gradients_match_jax_grad(avhubert_runs):
    """A tiny ``VideoAMT`` (encoder with ``output_norm``, head 16 → 20) in
    train mode on one padded batch: the loss, every parameter's gradient
    against ``jax.grad`` of the JAX brain's objectives, and the running
    statistics after the step."""
    from svt_speechbrain_tpu.nnet.linear import Linear as JLinear

    r = avhubert_runs["runs"]["concat"]
    rng = np.random.default_rng(7)
    video = _rand(rng, 2, 4, 32, 32, 1)
    anno = np.stack([rng.integers(0, 2, (2, 4)), rng.integers(0, 2, (2, 4)),
                     rng.integers(0, 5, (2, 4)), rng.integers(0, 13, (2, 4))],
                    -1).astype(np.float32)
    lens = np.array([1.0, 0.75], np.float32)
    jhead = JLinear(20, 16)
    hparams = jhead.init(jax.random.PRNGKey(8))
    jenc = javhubert.FairseqAVHubert(javhubert.AVHubertConfig(**r["cfg"]),
                                     output_norm=True)
    jself = SimpleNamespace(
        modules=SimpleNamespace(encoder=jenc, head=jhead), return_feats=False,
        hparams=_hparams(jlosses, jact.Softmax(apply_log=True)))
    jbatch = {"sig": (jnp.asarray(video), jnp.asarray(lens)),
              "anno": (jnp.asarray(anno), jnp.asarray(lens))}
    params = {"encoder": {"model": jax.tree_util.tree_map(jnp.asarray,
                                                          r["params"])},
              "head": hparams}
    states = {"encoder": {"model": r["state"]}}

    def loss_fn(p):
        preds, new = jamt.VideoAMT.compute_forward(
            jself, p, states, jbatch, jamt.Stage.TRAIN, None)
        return jamt.VideoAMT.compute_objectives(
            jself, preds, jbatch, jamt.Stage.TRAIN), new

    (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    from svt_speechbrain_tpu_torch.nnet.activations import Softmax
    from svt_speechbrain_tpu_torch.nnet.linear import Linear

    enc = avhubert.FairseqAVHubert(arch_overrides=r["cfg"], output_norm=True)
    head = Linear(20, 16)
    load_module_tree(enc, {"model": r["params"]}, {"model": r["state"]})
    load_module_tree(head, _np(hparams))
    pself = SimpleNamespace(
        modules=SimpleNamespace(encoder=enc, head=head), return_feats=False,
        hparams=_hparams(losses, Softmax(apply_log=True)))
    batch = {"sig": (torch.from_numpy(video), torch.from_numpy(lens)),
             "anno": (torch.from_numpy(anno), torch.from_numpy(lens))}
    preds = amt.VideoAMT.compute_forward(pself, batch, Stage.TRAIN, None)
    loss = amt.VideoAMT.compute_objectives(pself, preds, batch, Stage.TRAIN)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_trees_close(module_tree(enc, running_stats=True),
                        jstate["encoder"], MODEL_ATOL, "statistics")
    for module, want in ((enc, jgrads["encoder"]), (head, jgrads["head"])):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        got, want = _flatten(module_tree(module)), _flatten(_np(want))
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            scale = max(np.abs(w).max(), 1e-12)
            assert (np.abs(got[key] - w).max()
                    <= GRAD_RTOL * scale + GRAD_ATOL), key


# --------------------------------------------------------------------- int8
@pytest.mark.parametrize("quantize_attn", [False, True])
def test_quantize_avhubert_matches_jax(avhubert_runs, quantize_attn):
    """The int8 weights and scales bit for bit (the FFNs and
    ``post_extract_proj``; the attention projections with
    ``quantize_attn``; the ResNet and the stream projections float), and
    the int8 model's output against the JAX int8 model's."""
    r = avhubert_runs["runs"]["concat"]
    model = avhubert.AVHubertModel(avhubert.AVHubertConfig(**r["cfg"]))
    load_module_tree(model, r["params"], r["state"])
    qmodel = quantize.quantize_avhubert(model, quantize_attn=quantize_attn)
    assert hasattr(model.layers[0].ffn1, "w")            # argument untouched
    jq = _np(jquantize.quantize_avhubert(
        jax.tree_util.tree_map(jnp.asarray, r["params"]),
        quantize_attn=quantize_attn))
    got = _flatten(module_tree(qmodel))
    want = _flatten(jq)
    assert sorted(got) == sorted(want)
    n_q8 = 0
    for key, w in want.items():
        if w.dtype == np.int8 or key.endswith("_scale"):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
            n_q8 += w.dtype == np.int8
    assert n_q8 == (7 if quantize_attn else 3)
    assert qmodel.feature_extractor_video.proj.w.dtype == torch.float32
    cfg = javhubert.AVHubertConfig(**r["cfg"])
    jmodel = javhubert.AVHubertModel(cfg)
    src = {"video": avhubert_runs["video"]}
    want_out, _ = jmodel.extract_finetune(
        jax.tree_util.tree_map(jnp.asarray, jq), r["state"],
        {k: jnp.asarray(v) for k, v in src.items()})
    with torch.no_grad():
        got_out = qmodel.extract_finetune(
            {k: torch.from_numpy(v) for k, v in src.items()})
    _close(got_out, want_out, INT8_ATOL)
    q_enc = quantize.quantize_avhubert(avhubert.FairseqAVHubert(
        arch_overrides=r["cfg"]))
    assert q_enc.model.post_extract_proj.w_q8.dtype == torch.int8


# --------------------------------------------------------- fairseq converter
IGNORABLE = {"final_proj.weight", "final_proj.bias", "label_embs_concat"}


def test_fairseq_converter_covers_the_avhubert_large_manifest():
    """Every key of the AV-HuBERT large checkpoint manifest is consumed but
    the pretraining head and the BatchNorm batch counters, and the result
    has exactly the names and shapes of the port's ``AVHubertModel`` state
    dict, the running statistics among its buffers. Each key's tensor is
    one tag value, broadcast (no full-size memory)."""
    with open(MANIFESTS) as f:
        manifest = json.load(f)["avhubert-large"]
    sd, tags = {}, {}
    for i, (key, shape) in enumerate(sorted(manifest.items()), start=1):
        sd[key] = torch.tensor(float(i)).expand(shape)
        tags[float(i)] = key
    out = convert_fairseq.convert_avhubert_state_dict(
        sd, avhubert.AVHubertConfig.large())
    seen = set()
    for name, t in out.items():
        lo, hi = float(t.amin()), float(t.amax())
        assert lo == hi, name
        seen.add(tags[lo])
    dropped = {k for k in set(manifest) - seen
               if not k.endswith("num_batches_tracked")}
    assert dropped == IGNORABLE == set(convert_fairseq.IGNORED)
    with torch.device("meta"):
        model = avhubert.AVHubertModel()
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in out.items()} == want
    assert "feature_extractor_video.resnet.trunk.layer4_0.down_bn.var" in out


def _fairseq_sd(params, state):
    """A fairseq-named state dict of a tiny JAX AV-HuBERT tree (the inverse
    of the JAX converter, held to it below)."""
    t = lambda x: np.ascontiguousarray(np.asarray(x).T)
    conv = lambda w: np.ascontiguousarray(np.moveaxis(
        np.asarray(w), (-1, -2), (0, 1)))
    sd = {}

    def bn(prefix, p, s):
        sd.update({prefix + "weight": p["scale"], prefix + "bias": p["bias"],
                   prefix + "running_mean": s["mean"],
                   prefix + "running_var": s["var"],
                   prefix + "num_batches_tracked": np.array(3)})

    rp = params["feature_extractor_video"]["resnet"]
    rs = state["feature_extractor_video"]["resnet"]
    pre = "feature_extractor_video.resnet."
    sd[pre + "frontend3D.0.weight"] = conv(rp["frontend_conv"]["w"])
    bn(pre + "frontend3D.1.", rp["frontend_bn"], rs["frontend_bn"])
    sd[pre + "frontend3D.2.weight"] = rp["frontend_act"]["alpha"]
    for name, bp in rp["trunk"].items():
        stage, b = name[len("layer"):].split("_")
        bpre = f"{pre}trunk.layer{stage}.{b}."
        bs = rs["trunk"][name]
        for i in (1, 2):
            sd[f"{bpre}conv{i}.weight"] = conv(bp[f"conv{i}"]["w"])
            bn(f"{bpre}bn{i}.", bp[f"bn{i}"], bs[f"bn{i}"])
            sd[f"{bpre}relu{i}.weight"] = bp[f"relu{i}"]["alpha"]
        if "down_conv" in bp:
            sd[bpre + "downsample.0.weight"] = conv(bp["down_conv"]["w"])
            bn(bpre + "downsample.1.", bp["down_bn"], bs["down_bn"])
    for src, dst in (("feature_extractor_audio.proj",
                      params["feature_extractor_audio"]["proj"]),
                     ("feature_extractor_video.proj",
                      params["feature_extractor_video"]["proj"]),
                     ("post_extract_proj", params["post_extract_proj"])):
        sd[src + ".weight"], sd[src + ".bias"] = t(dst["w"]), dst["b"]
    sd["layer_norm.weight"] = params["layer_norm"]["scale"]
    sd["layer_norm.bias"] = params["layer_norm"]["bias"]
    sd["mask_emb"] = params["mask_emb"]
    pc = params["pos_conv"]
    sd["encoder.pos_conv.0.weight_g"] = np.transpose(pc["g"], (2, 1, 0))
    sd["encoder.pos_conv.0.weight_v"] = np.transpose(pc["v"], (2, 1, 0))
    sd["encoder.pos_conv.0.bias"] = pc["b"]
    sd["encoder.layer_norm.weight"] = params["encoder_ln"]["scale"]
    sd["encoder.layer_norm.bias"] = params["encoder_ln"]["bias"]
    for i, lp in params["layers"].items():
        pre = f"encoder.layers.{i}."
        for proj, n in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                        ("out_proj", "o")):
            sd[f"{pre}self_attn.{proj}.weight"] = t(lp["attn"][f"w{n}"])
            sd[f"{pre}self_attn.{proj}.bias"] = lp["attn"][f"b{n}"]
        for ln, n in (("self_attn_layer_norm", "ln1"),
                      ("final_layer_norm", "ln2")):
            sd[f"{pre}{ln}.weight"] = lp[n]["scale"]
            sd[f"{pre}{ln}.bias"] = lp[n]["bias"]
        for fc, n in (("fc1", "ffn1"), ("fc2", "ffn2")):
            sd[f"{pre}{fc}.weight"] = t(lp[n]["w"])
            sd[f"{pre}{fc}.bias"] = lp[n]["b"]
    sd["final_proj.weight"] = np.zeros((3, 16), np.float32)
    return {k: np.asarray(v) for k, v in sd.items()}


def test_fairseq_checkpoint_loads_into_the_port_as_into_jax(avhubert_runs,
                                                           tmp_path):
    """A tiny fairseq-named checkpoint file: the JAX converter gives back
    the JAX trees it came from, and the port's ``load_pretrained`` state
    dict, loaded into ``FairseqAVHubert``, computes the JAX model's
    output; a source that is not a local file raises."""
    r = avhubert_runs["runs"]["concat"]
    sd = _fairseq_sd(r["params"], r["state"])
    cfg = javhubert.AVHubertConfig(**r["cfg"])
    jp, js = jconvert.convert_avhubert_state_dict(sd, cfg)
    for got, want in ((jp, r["params"]), (js, r["state"])):
        g, w = _flatten(got), _flatten(want)
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    path = tmp_path / "avhubert_tiny.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    enc = avhubert.FairseqAVHubert(str(path), arch_overrides=r["cfg"])
    enc.load_state_dict(enc.load_pretrained())
    with torch.no_grad():
        got = enc({"video": torch.from_numpy(avhubert_runs["video"])})
    _close(got, r["outs"]["video"], MODEL_ATOL)
    with pytest.raises(FileNotFoundError):
        convert_fairseq.load_fairseq_state_dict(
            "https://dl.fbaipublicfiles.com/avhubert/large_vox_iter5.pt")


# ---------------------------------------------------------------- isolation
_PROBE = """
import sys
import numpy as np
import torch
from svt_speechbrain_tpu_torch.models import (avhubert, convert_fairseq,
                                              quantize, resnet)
from svt_speechbrain_tpu_torch.processing import video
from svt_speechbrain_tpu_torch.recipes.N20EMv2.video_only import (
    extract_ssl_feats, prepare_n20emv2, train_video_ssl)
from svt_speechbrain_tpu_torch.tasks.amt import VideoAMT
enc = avhubert.FairseqAVHubert(arch_overrides=dict(
    encoder_layers=1, encoder_embed_dim=16, encoder_ffn_embed_dim=32,
    encoder_attention_heads=4, conv_pos=8, conv_pos_groups=2))
q = quantize.quantize_avhubert(enc, quantize_attn=True)
frames = video.Compose([video.Normalize(0.0, 255.0),
                        video.CenterCrop((32, 32))])(
    np.zeros((2, 40, 40), np.uint8))
with torch.no_grad():
    out = q({"video": torch.from_numpy(frames[None, ..., None]).float()})
assert out.shape == (1, 2, 16), out.shape
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "svt_speechbrain_tpu" or m.startswith("svt_speechbrain_tpu."))
print("LOADED", bad)
"""


def test_video_modules_run_without_loading_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("name", [
    "svt_speechbrain_tpu_torch.models.avhubert",
    "svt_speechbrain_tpu_torch.models.resnet",
    "svt_speechbrain_tpu_torch.processing.video"])
def test_video_module_examples_pass(name):
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(name),
                             optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0, f"{name} has no examples"
    assert result.failed == 0
