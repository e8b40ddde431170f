"""Port parity, the N20EMv2 video path's modules: ``Conv2d``/``Conv3d``,
``BatchNorm1d/2d/3d`` with their running statistics, ``PReLU``, the
``ResEncoder`` (Conv3d + ResNet-18), ``AVHubertModel`` and
``FairseqAVHubert``, a tiny ``VideoAMT`` loss and its gradients,
``quantize_avhubert`` and the fairseq converter, against the JAX package on
the CPU, from JAX-initialised trees (``convert_jax.load_module_tree``) and
the same seeded numpy inputs, in f32. The AV-HuBERT tests are in
``test_torch_video_avhubert.py``, with this file's tolerances.

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
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_speechbrain_tpu.models import resnet as jresnet
from svt_speechbrain_tpu.nnet import activations as jact
from svt_speechbrain_tpu.nnet import cnn as jcnn
from svt_speechbrain_tpu.nnet import normalization as jnorm

from svt_speechbrain_tpu_torch.convert_jax import (
    _flatten, init_resnet, load_module_tree, module_tree)
from svt_speechbrain_tpu_torch.models import resnet
from svt_speechbrain_tpu_torch.nnet import activations, cnn
from svt_speechbrain_tpu_torch.nnet import normalization
from tests.torch_threads import two_torch_threads  # noqa: F401

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
