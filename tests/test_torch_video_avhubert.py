"""Port parity, the AV-HuBERT side of the video slice: the tiny
``AVHubertModel`` (concat and add; video, audio and both; eval and train
with its running statistics), ``FairseqAVHubert``'s ``output_norm`` and
``freeze``, a tiny ``VideoAMT`` loss's gradients against ``jax.grad``,
``quantize_avhubert`` bit for bit and the fairseq converter against the
``avhubert-large`` manifest and a fairseq state dict, against the JAX
package on the CPU (the convolutions, norms and ``ResEncoder``:
``test_torch_video_models.py``)."""
import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_speechbrain_tpu.models import avhubert as javhubert
from svt_speechbrain_tpu.models import convert_fairseq as jconvert
from svt_speechbrain_tpu.models import quantize as jquantize
from svt_speechbrain_tpu.nnet import activations as jact
from svt_speechbrain_tpu.nnet import losses as jlosses
from svt_speechbrain_tpu.nnet import normalization as jnorm
from svt_speechbrain_tpu.tasks import amt as jamt

from svt_speechbrain_tpu_torch.convert_jax import (
    _flatten, init_avhubert, load_module_tree, module_tree)
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.models import avhubert, convert_fairseq
from svt_speechbrain_tpu_torch.models import quantize
from svt_speechbrain_tpu_torch.nnet import losses
from svt_speechbrain_tpu_torch.tasks import amt
from tests.test_torch_video_models import (  # noqa: F401
    GRAD_ATOL, GRAD_RTOL, INT8_ATOL, LOSS_RTOL, MANIFESTS, MODEL_ATOL, TINY, _assert_trees_close, _close, _np, _rand)
from tests.torch_threads import two_torch_threads  # noqa: F401


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
        # jitted: op by op the JAX forwards took most of the file's time
        forward = jax.jit(model.extract_finetune, static_argnames="train")
        outs = {}
        for name, src in (("video", {"video": video}),
                          ("audio", {"audio": audio}),
                          ("both", {"video": video, "audio": audio})):
            j = {k: jnp.asarray(v) for k, v in src.items()}
            outs[name] = np.asarray(forward(params, state, j)[0])
            y, st = forward(params, state, j, train=True)
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
