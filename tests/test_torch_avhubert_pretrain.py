"""AV-HuBERT pretraining, the fairseq wav2vec bridges and the AV dataset
readers in the port against the JAX package.

``AVHubertPretrain`` takes the JAX-initialised parameters and BatchNorm
state of a tiny configuration through ``convert_jax``; both packages get the
same numpy inputs and masks. Tolerances: the loss and the aux values rtol
1e-5; gradients atol 1e-5 / rtol 1e-4 (``tests/test_parallel.py:380-384``);
the BatchNorm running statistics atol 1e-5 (0.9 of the initial value plus
0.1 of batch statistics of ResNet activations, which carry the convs'
f32 summation-order error; 1.5e-6 measured on a CPU); encoder outputs atol
1e-5.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_speechbrain_tpu.models import avhubert as javh
from svt_speechbrain_tpu.models import convert_fairseq as jconv
from svt_speechbrain_tpu.models import wav2vec2 as jw2v

from svt_speechbrain_tpu_torch.convert_jax import (load_jax_params,
                                                   load_module_tree,
                                                   module_state)
from svt_speechbrain_tpu_torch.models import avhubert as avh
from svt_speechbrain_tpu_torch.models import convert_fairseq as conv
from svt_speechbrain_tpu_torch.models import wav2vec2 as w2v
from tests.torch_threads import two_torch_threads  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
TINY = dict(encoder_layers=1, encoder_embed_dim=16, encoder_ffn_embed_dim=32,
            encoder_attention_heads=4, audio_feat_dim=10, conv_pos=8,
            conv_pos_groups=2, dropout=0.0, attention_dropout=0.0,
            dropout_input=0.0)
FRAMES, SIDE, CLASSES = 6, 32, 7


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def jax_model(fuse):
    """The JAX tiny pretraining model, its parameters and BatchNorm state,
    drawn once a fusion."""
    cfg = javh.AVHubertConfig(**TINY, modality_fuse=fuse)
    model = javh.AVHubertPretrain(cfg, num_classes=CLASSES, final_dim=8)
    return (model, jax.jit(model.init)(jax.random.PRNGKey(0)),
            model.init_state())


def _inputs(rng):
    audio = rng.normal(size=(2, FRAMES, 10)).astype(np.float32)
    video = rng.normal(size=(2, FRAMES, SIDE, SIDE, 1)).astype(np.float32)
    targets = rng.integers(0, CLASSES, (2, FRAMES)).astype(np.int64)
    return audio, video, targets


@pytest.mark.parametrize("fuse,streams", [
    ("concat", "audio"), ("concat", "video"), ("concat", "both"),
    ("add", "both")])
def test_pretrain_step_matches_jax(fuse, streams):
    """Loss, aux, the new BatchNorm statistics and every gradient of one
    training forward against ``jax.value_and_grad`` (dropouts 0); a
    missing stream is zeros shaped like the other one."""
    jm, params, state = jax_model(fuse)
    rng = np.random.default_rng(1)
    audio, video, targets = _inputs(rng)
    mask = jm.sample_masks(2, FRAMES, np.random.default_rng(2))
    source = {"audio": audio, "video": video}
    if streams != "both":
        source = {streams: source[streams]}

    def f(p):
        loss, aux, new_state = jm(
            p, state, {k: jnp.asarray(v) for k, v in source.items()},
            jnp.asarray(targets), jnp.asarray(mask), train=True)
        return loss, (aux, new_state)

    (loss_j, (aux_j, state_j)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)

    tm = avh.AVHubertPretrain(avh.AVHubertConfig(
        **TINY, modality_fuse=jm.config.modality_fuse), num_classes=CLASSES,
        final_dim=8)
    load_jax_params(_tree(params), tm, state=_tree(state))
    tmask = tm.sample_masks(2, FRAMES, np.random.default_rng(2))
    np.testing.assert_array_equal(tmask, mask)
    before = {n: b.clone() for n, b in tm.named_buffers()}
    loss_t, aux_t = tm({k: torch.from_numpy(v) for k, v in source.items()},
                       torch.from_numpy(targets), mask, train=True)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL)
    for k in aux_j:
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    loss_t.backward()
    want = module_state(tm, _tree(grads))
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    ref = avh.AVHubertPretrain(avh.AVHubertConfig(
        **TINY, modality_fuse=jm.config.modality_fuse), num_classes=CLASSES,
        final_dim=8)
    load_jax_params(_tree(params), ref, state=_tree(state_j))
    stats = dict(ref.named_buffers())
    moved = 0
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name].numpy(),
                                   atol=1e-5, err_msg=name)
        moved += int(not torch.equal(buf, before[name]))
    assert (moved > 0) == (streams != "audio")


def _fairseq_sd(p, cfg, norm_key="2"):
    """A fairseq ``Wav2Vec2Model`` state dict of a JAX encoder tree
    (``tests/test_api_parity_extras.py:518-585``)."""
    def t(x):
        return np.ascontiguousarray(np.asarray(x).T)

    sd = {}
    for i in range(len(cfg.conv_dim)):
        fe = p["feature_extractor"][str(i)]
        pre = f"w2v_model.feature_extractor.conv_layers.{i}."
        sd[pre + "0.weight"] = np.transpose(np.asarray(fe["conv"]["w"]),
                                            (2, 1, 0))
        if "b" in fe["conv"]:
            sd[pre + "0.bias"] = np.asarray(fe["conv"]["b"])
        norm = fe.get("layer_norm", fe.get("group_norm"))
        if norm is not None:
            sd[pre + norm_key + ".weight"] = np.asarray(norm["scale"])
            sd[pre + norm_key + ".bias"] = np.asarray(norm["bias"])
    sd["w2v_model.layer_norm.weight"] = np.asarray(p["feat_proj_ln"]["scale"])
    sd["w2v_model.layer_norm.bias"] = np.asarray(p["feat_proj_ln"]["bias"])
    sd["w2v_model.post_extract_proj.weight"] = t(p["feat_proj"]["w"])
    sd["w2v_model.post_extract_proj.bias"] = np.asarray(p["feat_proj"]["b"])
    pc = "w2v_model.encoder.pos_conv.0."
    sd[pc + "weight_g"] = np.transpose(np.asarray(p["pos_conv"]["g"]),
                                       (2, 1, 0))
    sd[pc + "weight_v"] = np.transpose(np.asarray(p["pos_conv"]["v"]),
                                       (2, 1, 0))
    sd[pc + "bias"] = np.asarray(p["pos_conv"]["b"])
    sd["w2v_model.encoder.layer_norm.weight"] = np.asarray(
        p["encoder_ln"]["scale"])
    sd["w2v_model.encoder.layer_norm.bias"] = np.asarray(
        p["encoder_ln"]["bias"])
    for i in range(cfg.num_layers):
        lay, pre = p["layers"][str(i)], f"w2v_model.encoder.layers.{i}."
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "out_proj")):
            sd[pre + f"self_attn.{theirs}.weight"] = t(lay["attn"][ours])
            sd[pre + f"self_attn.{theirs}.bias"] = np.asarray(
                lay["attn"]["b" + ours[1]])
        for ln, name in (("ln1", "self_attn_layer_norm"),
                         ("ln2", "final_layer_norm")):
            sd[pre + name + ".weight"] = np.asarray(lay[ln]["scale"])
            sd[pre + name + ".bias"] = np.asarray(lay[ln]["bias"])
        for ffn, name in (("ffn1", "fc1"), ("ffn2", "fc2")):
            sd[pre + name + ".weight"] = t(lay[ffn]["w"])
            sd[pre + name + ".bias"] = np.asarray(lay[ffn]["b"])
    return sd


@pytest.mark.parametrize("norm", ["layer", "group"])
def test_fairseq_wav2vec2_converter_matches_jax(norm, tmp_path):
    cfg_kw = dict(hidden_size=32, num_layers=1, num_heads=4, ffn_size=64,
                  conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
                  num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                  feat_extract_norm=norm, conv_bias=norm == "layer",
                  do_stable_layer_norm=norm == "layer")
    jcfg = dataclasses.replace(jw2v.Wav2Vec2Config.large_lv60(), **cfg_kw)
    cfg = dataclasses.replace(w2v.Wav2Vec2Config.large_lv60(), **cfg_kw)
    jenc = jw2v.Wav2Vec2Encoder(jcfg)
    p = jax.jit(jenc.init)(jax.random.PRNGKey(0))
    sd = _fairseq_sd(p, cfg)
    want_params = jconv.convert_wav2vec2_fairseq_state_dict(sd, jcfg)
    wav = np.random.default_rng(0).normal(size=(1, 4000)).astype(np.float32)
    want = np.asarray(jenc(want_params, wav))

    enc = w2v.Wav2Vec2Encoder(cfg).eval()
    enc.load_state_dict(conv.convert_wav2vec2_fairseq_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(wav), False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if norm == "layer":          # fairseq's own ``.2.1`` behind TransposeLast
        sd21 = {k.replace(".2.weight", ".2.1.weight").replace(
            ".2.bias", ".2.1.bias") if "conv_layers" in k else k: v
            for k, v in sd.items()}
        enc.load_state_dict(conv.convert_wav2vec2_fairseq_state_dict(
            {k: torch.from_numpy(v) for k, v in sd21.items()}, cfg))
        with torch.no_grad():
            np.testing.assert_allclose(
                enc(torch.from_numpy(wav), False).numpy(), want, atol=1e-5)

    path = os.path.join(tmp_path, "w2v.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    bridge = avh.FairseqWav2Vec2(pretrained_path=path, config=cfg).eval()
    bridge.load_state_dict(bridge.load_pretrained(), strict=True)
    jbridge = javh.FairseqWav2Vec2(config=jcfg)
    want_b = np.asarray(jbridge({"encoder": want_params}, wav))
    with torch.no_grad():
        got_b = bridge(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got_b, want_b, atol=1e-5)
    assert avh.FairseqWav2Vec2(config=cfg).load_pretrained() is None


def test_fairseq_wav2vec1_matches_jax():
    kw = dict(conv_dim=(8,) * 5, context_layers=2, context_kernel=3,
              embedding_dim=8)
    jm = javh.FairseqWav2Vec1(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tm = avh.FairseqWav2Vec1(**kw)
    load_module_tree(tm, _tree(params))
    wav = np.random.default_rng(2).normal(size=(2, 3000)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(params, jnp.asarray(wav))),
                               atol=1e-5)


def test_label_readers_and_dataset_match_jax(tmp_path):
    import scipy.io.wavfile as wavfile

    d = str(tmp_path)
    rng = np.random.default_rng(3)
    wavfile.write(os.path.join(d, "a0.wav"), 16000,
                  (rng.normal(size=16000) * 3000).astype(np.int16))
    np.save(os.path.join(d, "v0.npy"),
            rng.integers(0, 255, (25, 8, 8)).astype(np.uint8))
    manifest = os.path.join(d, "manifest.tsv")
    with open(manifest, "w") as f:
        f.write(d + "\n")
        f.write("u0\tv0.npy\ta0.wav\t25\t16000\n")
        f.write("u1\tv1.npy\ta1.wav\t50\t400\n")
        f.write("u2\tv2.npy\ta2.wav\t50\t32000\n")
    lab = os.path.join(d, "lab.txt")
    with open(lab, "w") as f:
        f.write(" ".join(["1"] * 25) + "\nä 5\n" + " ".join(["2"] * 10) + "\n")
    for fn in ("load_label", "load_label_offset"):
        assert getattr(avh, fn)(lab, [0, 2], 3) == getattr(javh, fn)(
            lab, [0, 2], 3)
    for rate in (25, -1):
        assert avh.verify_label_lengths([16000, 32000], 16000, lab, rate,
                                        [0, 2], 3) == \
            javh.verify_label_lengths([16000, 32000], 16000, lab, rate,
                                      [0, 2], 3)
    for keep in ((None, 1000), (20000, None)):
        assert avh.load_audio_visual(manifest, *keep, 25, [lab], [25]) == \
            javh.load_audio_visual(manifest, *keep, 25, [lab], [25])
    flip = (lambda v: v[:, ::-1])
    ours = avh.AVHubertDataset(manifest, label_paths=[lab], label_rates=[25],
                               min_keep_sample_size=1000,
                               video_transform=flip)
    theirs = javh.AVHubertDataset(manifest, label_paths=[lab],
                                  label_rates=[25],
                                  min_keep_sample_size=1000,
                                  video_transform=flip)
    assert len(ours) == len(theirs) == 2
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b) and a["label0"] == b["label0"]
        for key in ("audio", "video"):
            if key in b:
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(b[key]))


def test_reference_aliases():
    assert avh.SubModel is avh.AudioSubModel
    assert avh.FairseqAVHubertFinetune is avh.FairseqAVHubert
    assert avh.FairseqAVHubertPretrain is avh.AVHubertPretrain
