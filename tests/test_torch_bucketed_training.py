"""Port parity, bucketed training from WAV files: the TINY ``AudioAMT`` in
both packages from one numpy weight tree, fed whole songs read from 16-bit
WAV files by each package's native reader and batched by each package's
``DynamicBatchSampler`` through ``Brain.make_dataloader(batch_sampler=)``.
The two loaders give the same batches, and two full-finetune
``fit_batch`` steps the same losses (rtol 1e-5, as the recipe's parity
test; f32 on the CPU, dropout off in both)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svt_speechbrain_tpu.core import Stage as JStage
from svt_speechbrain_tpu.dataio import dataio as jdataio
from svt_speechbrain_tpu.dataio import sampler as jsampler
from svt_speechbrain_tpu.dataio.dataset import \
    DynamicItemDataset as JDataset
from svt_speechbrain_tpu.models.wav2vec2 import (
    HuggingFaceWav2Vec2 as JBridge, Wav2Vec2Config as JConfig)
from svt_speechbrain_tpu.nnet import losses as jlosses
from svt_speechbrain_tpu.nnet.activations import Softmax as JSoftmax
from svt_speechbrain_tpu.nnet.linear import Linear as JLinear
from svt_speechbrain_tpu.tasks.amt import AudioAMT as JAudioAMT

from svt_speechbrain_tpu_torch.convert_jax import init_params, \
    load_jax_params
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.dataio import dataio, sampler
from svt_speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from svt_speechbrain_tpu_torch.models.wav2vec2 import (
    HuggingFaceWav2Vec2, TINY_ARCH, Wav2Vec2Config)
from svt_speechbrain_tpu_torch.nnet import losses
from svt_speechbrain_tpu_torch.nnet.activations import Softmax
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from tests.torch_threads import two_torch_threads  # noqa: F401

ARCH = dict(TINY_ARCH, hidden_dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, feat_proj_dropout=0.0)
SR = 16000
SECONDS = [0.31, 0.55, 0.42, 0.6, 0.36, 0.5, 0.47, 0.33]
LOSS_RTOL = 1e-5


def _hparams(loss_mod, softmax):
    crit = dict(reduction="mean", allowed_len_diff=60, label_smoothing=0.0)
    return dict(
        seed=1986, pitch_octave_num=4, onset_positive_weight=15.0,
        offset_positive_weight=1.0, lr=3e-4, lr_wav2vec=5e-5,
        linear_prob_epochs=0,
        onset_criterion=functools.partial(loss_mod.bce_loss, **crit),
        offset_criterion=functools.partial(loss_mod.bce_loss, **crit),
        octave_criterion=functools.partial(loss_mod.nll_loss, **crit),
        pitch_criterion=functools.partial(loss_mod.nll_loss, **crit),
        log_softmax=softmax(apply_log=True))


def _songs(root, cfg):
    """{id: {"wav", "duration"}} of 16-bit WAVs and each song's labels."""
    rng = np.random.default_rng(21)
    data, labels = {}, {}
    for i, seconds in enumerate(SECONDS):
        path = str(root / f"s{i}.wav")
        n = int(seconds * SR)
        dataio.write_audio(path, 0.3 * rng.standard_normal(n), SR)
        frames = cfg.output_length(n)
        labels[f"s{i}"] = np.stack(
            [rng.random(frames) > 0.8, rng.random(frames) > 0.8,
             rng.integers(0, 5, frames), rng.integers(0, 13, frames)],
            axis=-1).astype(np.float32)
        data[f"s{i}"] = {"wav": path, "duration": seconds}
    return data, labels


def _dataset(cls, read, data, labels):
    ds = cls(data)
    ds.add_dynamic_item(read, takes="wav", provides="sig")
    ds.add_dynamic_item(lambda id: labels[id], takes="id", provides="anno")
    ds.set_output_keys(["id", "sig", "anno"])
    return ds


# two songs a batch from each of two buckets, every batch padded to 1 s and
# 64 frames: one shape, so the JAX step compiles once
PAD = {"sig": 16000, "anno": 64}


def _bucketed(mod):
    return mod.DynamicBatchSampler(None, 10.0, num_buckets=2,
                                   lengths_list=SECONDS, shuffle=True,
                                   max_batch_ex=2, seed=5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = Wav2Vec2Config(**ARCH)
    data, labels = _songs(tmp_path_factory.mktemp("songs"), cfg)
    tree = init_params(cfg, torch.Generator().manual_seed(0))

    jmodules = {"wav2vec2": JBridge(config=JConfig(**ARCH), output_norm=True,
                                    normalize_wav=True),
                "model": JLinear(20, cfg.hidden_size)}
    for name, module in jmodules.items():
        module.init = functools.partial(
            lambda sub, rng: jax.tree_util.tree_map(jnp.asarray, sub),
            tree[name])
    jbrain = JAudioAMT(modules=jmodules, hparams=_hparams(jlosses, JSoftmax),
                       run_opts={"noprogressbar": True,
                                 "data_parallel_count": 1})
    jbrain.init_optimizers()
    jbrain.configure_freezing(1)
    jloader = jbrain.make_dataloader(
        _dataset(JDataset, jdataio.read_audio, data, labels), JStage.TRAIN,
        batch_sampler=_bucketed(jsampler), prefetch_batches=4,
        pad_multiples=PAD)

    bridge = HuggingFaceWav2Vec2(config=cfg, output_norm=True,
                                 normalize_wav=True)
    head = Linear(20, cfg.hidden_size)
    load_jax_params(tree, bridge, head)
    brain = __import__(
        "svt_speechbrain_tpu_torch.tasks.amt", fromlist=["AudioAMT"]
    ).AudioAMT(modules={"wav2vec2": bridge, "model": head},
               hparams=_hparams(losses, Softmax), run_opts={"device": "cpu"})
    brain.init_optimizers()
    brain.on_stage_start(Stage.TRAIN, 1)
    loader = brain.make_dataloader(
        _dataset(DynamicItemDataset, dataio.read_audio, data, labels),
        Stage.TRAIN, batch_sampler=_bucketed(sampler), num_workers=2,
        prefetch_batches=4, pad_multiples=PAD)
    brain.train_sampler.set_epoch(1)
    jloader.set_epoch(1)

    out = {"jax": [], "port": []}
    for jbatch, batch in zip(jloader, loader):
        out["jax"].append((list(jbatch.id), jbrain.fit_batch(jbatch)))
        out["port"].append((list(batch.id), brain.fit_batch(batch)))
        if len(out["port"]) == 2:
            break
    return out


def test_the_loaders_give_the_same_buckets(runs):
    ids = [i for i, _ in runs["port"]]
    assert ids == [i for i, _ in runs["jax"]]
    want = _bucketed(sampler)
    want.set_epoch(1)
    assert ids == [[f"s{i}" for i in b] for b in list(want)[:2]]


def test_two_steps_give_the_jax_losses(runs):
    got = [loss for _, loss in runs["port"]]
    want = [loss for _, loss in runs["jax"]]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
