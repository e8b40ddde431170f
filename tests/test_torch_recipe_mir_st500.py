"""Port parity, the MIR-ST500 recipe end to end: the TINY recipe in both
packages on the synthetic songs of ``tests/test_recipe_mir_st500.py`` (one
set of files read by both), from one weight tree, dropouts 0, f32 on the
CPU: 2 epochs of ``fit`` (linear probe, then finetune) with validation,
then ``evaluate`` of the test set from the checkpoint of least valid loss.

Held: each epoch's train and valid loss and the test loss (rtol 1e-5:
the two packages sum in other orders); both optimizers' learning rates
after every NewBob step; ``train_log.txt`` line for line (3 significant
digits); every song's notes and COnPOff/COnP/COn precision, recall and F1,
exactly; the kept checkpoint. Then the port alone: a run killed after an
epoch, or in the middle of one, and recovered by a new brain from its
checkpoint ends bit for bit where an uninterrupted run ends (dropout on,
so the generators' states matter); and a JAX ``save_msgpack`` export loads
into the port through ``convert_jax.load_jax_params``."""
import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_speechbrain_tpu.config import load_hyperyaml as jax_load_hyperyaml
from svt_speechbrain_tpu.dataio.dataio import write_audio
from svt_speechbrain_tpu.tasks import amt as jamt

from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import (export_jax_params,
                                                   init_params,
                                                   load_jax_params)
from svt_speechbrain_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from svt_speechbrain_tpu_torch.recipes.MIR_ST500 import \
    train_audio_ssl as recipe
from svt_speechbrain_tpu_torch.tasks import amt
from tests.conftest import REPO_ROOT
from tests.test_recipe_mir_st500 import _make_note_track
from tests.torch_threads import two_torch_threads  # noqa: F401

JAX_RECIPE = os.path.join(REPO_ROOT, "recipes", "MIR_ST500")
JAX_YAML = os.path.join(JAX_RECIPE, "hparams", "train_audio_ssl.yaml")
PORT_YAML = os.path.join(REPO_ROOT, "svt_speechbrain_tpu_torch", "recipes",
                         "MIR_ST500", "hparams", "train_audio_ssl.yaml")
ARCH = dict(hidden_size=32, num_layers=2, num_heads=4, ffn_size=64,
            conv_dim=[16] * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0,
                  activation_dropout=0.0, feat_proj_dropout=0.0)
LOSS_RTOL = 1e-5


def _load_jax_recipe():
    spec = importlib.util.spec_from_file_location(
        "jax_mir_recipe", os.path.join(JAX_RECIPE, "train_audio_ssl.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    """The synthetic set of ``tests/test_recipe_mir_st500.py``: 3 songs of
    8, 10 and 12 s, prepared by the port's ``prepare_benchmarks``."""
    from svt_speechbrain_tpu_torch.recipes.MIR_ST500 import \
        prepare_benchmarks as prep

    root = tmp_path_factory.mktemp("mir_data")
    rng = np.random.default_rng(0)
    gt = {}
    folder = root / "wav16kHz"
    for song_i in range(3):
        name = f"song{song_i}"
        duration = 8.0 + 2.0 * song_i
        notes = _make_note_track(rng, duration)
        gt[name] = notes
        t = np.arange(int(duration * 16000)) / 16000
        sig = np.zeros_like(t, dtype=np.float32)
        for on, off, midi in notes:
            f0 = 440.0 * 2 ** ((midi - 69) / 12)
            mask = (t >= on) & (t < off)
            sig[mask] += 0.5 * np.sin(2 * np.pi * f0 * t[mask]).astype(
                np.float32)
        sig += 0.01 * rng.normal(size=sig.shape).astype(np.float32)
        os.makedirs(folder / name, exist_ok=True)
        write_audio(str(folder / name / "vocals.wav"), sig, 16000)
    with open(root / "Annotations.json", "w") as f:
        json.dump(gt, f)
    prep.prepare_frame_anno(str(root / "Annotations.json"), str(folder))
    os.makedirs(root / "csv", exist_ok=True)
    prep.prepare_csv_benchmarks(str(folder), str(root / "csv" / "train.csv"),
                                dur_thrd=5)
    return root


def _overrides(root, out, package, arch, epochs=2, extra=""):
    csv = f"{root}/csv/train.csv"
    return f"""
data_folder: {root}
output_folder: {out}
csv_folder: {root}/csv
train_csv: {csv}
valid_csv: {csv}
test_csv: [{csv}]
number_of_epochs: {epochs}
linear_prob_epochs: 1
batch_size: 2
num_workers: 0
wav2vec2: !new:{package}.models.wav2vec2.HuggingFaceWav2Vec2
   source: tiny-test
   output_norm: True
   normalize_wav: True
   arch_overrides: {json.dumps(arch)}
feat_dim: 32
{extra}"""


def _recording(cls):
    """``cls`` that records each stage end (loss, learning rates, the
    schedulers' values) and each song's notes and scores."""

    class Recording(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.stage_ends, self.songs = [], []

        def on_stage_end(self, stage, stage_loss, epoch=None):
            super().on_stage_end(stage, stage_loss, epoch)
            self.stage_ends.append(dict(
                stage=stage.name, loss=float(stage_loss), epoch=epoch,
                lrs={o: self.get_learning_rate(o) for o in self.optimizers},
                scheds=[self.hparams.lr_annealing_wav2vec.hyperparam_value,
                        self.hparams.lr_annealing_model.hyperparam_value]))

        def on_song_end(self, batch, est_np):
            self.songs.append([batch.id[0].rsplit("_", 1)[0], est_np])

        def _score_song(self, est_np, ref_intervals, ref_pitchs):
            super()._score_song(est_np, ref_intervals, ref_pitchs)
            self.songs[-1].append({
                f"{n}_{k}": getattr(self, f"{n}_{k}").val
                for n in self.metric_names
                for k in ("precis", "recall", "f1")})

    return Recording


def _run(brain, hparams, evaluate=True):
    brain.fit(hparams["epoch_counter"], *hparams["_data"][:2],
              train_loader_kwargs=hparams["train_dataloader_opts"],
              valid_loader_kwargs=hparams["valid_dataloader_opts"])
    fitted = None
    if isinstance(brain, recipe.AMT):     # the state fit left, in the port
        fitted = {"modules": {k: v.clone() for k, v in
                              brain.modules.state_dict().items()},
                  "opts": {n: cfg["opt"].state_dict()["state"]
                           for n, cfg in brain.optimizers.items()}}
    test_loss = None
    if evaluate:
        test_loss = brain.evaluate(
            list(hparams["_data"][2].values())[0], min_key="loss",
            test_loader_kwargs=hparams["test_dataloader_opts"])
    with open(hparams["train_log"]) as f:
        log = f.read().splitlines()
    return dict(brain=brain, test_loss=test_loss, log=log, fitted=fitted,
                ckpts=hparams["checkpointer"].list_checkpoints())


def _jax_run(root, out, tree):
    jrecipe = _load_jax_recipe()
    with open(JAX_YAML) as f:
        hp = jax_load_hyperyaml(f, _overrides(
            root, out, "svt_speechbrain_tpu", dict(ARCH, **NO_DROPOUT)))
    for name in ("wav2vec2", "model"):
        # the JAX Brain initialises each module itself: hand it the tree
        hp["modules"][name].init = functools.partial(
            lambda sub, rng: jax.tree_util.tree_map(jnp.asarray, sub),
            tree[name])
    hp["_data"] = jrecipe.dataio_prepare(hp)
    brain = _recording(jrecipe.AMT)(
        modules=hp["modules"], hparams=hp,
        run_opts={"noprogressbar": True, "data_parallel_count": 1},
        checkpointer=hp["checkpointer"])
    return _run(brain, hp)


def _port_hparams(root, out, arch, tree=None, epochs=2, extra=""):
    with open(PORT_YAML) as f:
        hp = load_hyperyaml(f, _overrides(root, out,
                                          "svt_speechbrain_tpu_torch", arch,
                                          epochs, extra))
    if tree is None:
        tree = init_params(Wav2Vec2Config(**dict(ARCH, conv_dim=(16,) * 7)),
                           torch.Generator().manual_seed(0))
    load_jax_params(tree, hp["modules"]["wav2vec2"], hp["modules"]["model"])
    hp["_data"] = recipe.dataio_prepare(hp)
    return hp


def _port_run(root, out, tree, arch, cls=recipe.AMT, epochs=2, extra="",
              evaluate=True):
    hp = _port_hparams(root, out, arch, tree, epochs, extra)
    brain = _recording(cls)(modules=hp["modules"], hparams=hp,
                            run_opts={"device": "cpu", "noprogressbar": True},
                            checkpointer=hp["checkpointer"])
    return _run(brain, hp, evaluate)


@pytest.fixture(scope="module")
def runs(songs, tmp_path_factory):
    tree = init_params(Wav2Vec2Config(**dict(ARCH, conv_dim=(16,) * 7)),
                       torch.Generator().manual_seed(0))
    out = tmp_path_factory.mktemp("runs")
    return dict(jax=_jax_run(songs, out / "jax", tree),
                port=_port_run(songs, out / "port", tree,
                               dict(ARCH, **NO_DROPOUT)))


def test_losses_match_the_jax_recipe(runs):
    want, got = runs["jax"], runs["port"]
    assert ([(e["stage"], e["epoch"]) for e in got["brain"].stage_ends]
            == [(e["stage"], e["epoch"]) for e in want["brain"].stage_ends]
            == [("TRAIN", 1), ("VALID", 1), ("TRAIN", 2), ("VALID", 2),
                ("TEST", None)])
    np.testing.assert_allclose(
        [e["loss"] for e in got["brain"].stage_ends],
        [e["loss"] for e in want["brain"].stage_ends], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=LOSS_RTOL)
    assert np.isfinite(got["test_loss"])


def test_newbob_learning_rates_match(runs):
    """The schedulers' values exactly; the optimizers' rates as the JAX
    optimizer keeps them (float32) against the port's (Python floats)."""
    want = runs["jax"]["brain"].stage_ends
    got = runs["port"]["brain"].stage_ends
    for w, g in zip(want, got):
        assert g["scheds"] == w["scheds"]
        assert {k: np.float32(v) for k, v in g["lrs"].items()} == \
            {k: np.float32(v) for k, v in w["lrs"].items()}
    valid = [g for g in got if g["stage"] == "VALID"]
    assert [v["lrs"]["model"] for v in valid] == [v["scheds"][1] for v in valid]


def test_train_log_matches_line_for_line(runs):
    want, got = runs["jax"]["log"], runs["port"]["log"]
    assert len(got) == 3 and got[-1].startswith("Epoch loaded: ")
    assert got == want


def test_song_notes_and_scores_match_exactly(runs):
    want = runs["jax"]["brain"].songs
    got = runs["port"]["brain"].songs
    # 3 songs in each of 2 validations and the test
    assert [s[0] for s in got] == [s[0] for s in want] == \
        ["song0", "song1", "song2"] * 3
    for (name, est, scores), (_, want_est, want_scores) in zip(got, want):
        np.testing.assert_array_equal(est, want_est, err_msg=name)
        assert scores == want_scores, name
    assert runs["port"]["brain"].COn_f1.count == 3


def test_kept_checkpoint_matches(runs):
    want, got = runs["jax"]["ckpts"], runs["port"]["ckpts"]
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0].meta["loss"], want[0].meta["loss"],
                               rtol=LOSS_RTOL)
    assert sorted(got[0].paramfiles) == sorted(want[0].paramfiles)


class _Killed(Exception):
    pass


def _killed_at(step):
    """The recipe's brain, killed before its ``step``-th optimizer step."""

    class Killed(recipe.AMT):
        def fit_batch(self, batch):
            if self.optimizer_step + 1 == step:
                raise _Killed
            return super().fit_batch(batch)

    return Killed


def _recovery_tree():
    return init_params(Wav2Vec2Config(**dict(ARCH, conv_dim=(16,) * 7)),
                       torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def uninterrupted(songs, tmp_path_factory):
    """The 2 straight epochs (dropout on) that both recovery cases end
    against, run once."""
    return _port_run(songs, tmp_path_factory.mktemp("straight"),
                     _recovery_tree(), ARCH)


@pytest.mark.parametrize("where", ["end_of_epoch", "mid_epoch"])
def test_recovered_run_equals_an_uninterrupted_one(songs, uninterrupted,
                                                   tmp_path, where):
    """Dropout on (0.1 everywhere). ``end_of_epoch``: 1 epoch, then a new
    brain recovers and runs the second. ``mid_epoch``: intra-epoch
    checkpoints after every step, the run killed before the second step of
    epoch 2, a new brain recovers (the loader skips the batch consumed) and
    finishes. Parameters, optimizer states and the train log are bit for
    bit those of 2 straight epochs (``uninterrupted``)."""
    tree = _recovery_tree()
    straight = uninterrupted
    if where == "end_of_epoch":
        _port_run(songs, tmp_path / "resumed", tree, ARCH, epochs=1,
                  evaluate=False)
    else:
        with pytest.raises(_Killed):
            _port_run(songs, tmp_path / "resumed", tree, ARCH,
                      cls=_killed_at(5), extra="ckpt_interval_minutes: 1.0e-9")
    # a fresh brain, with other weights, on the same folder
    resumed = _port_run(songs, tmp_path / "resumed", None, ARCH,
                        extra="ckpt_interval_minutes: 1.0e-9"
                        if where == "mid_epoch" else "")
    assert resumed["brain"].optimizer_step == 6
    a, b = straight["fitted"], resumed["fitted"]
    for name, p in a["modules"].items():
        assert torch.equal(p, b["modules"][name]), name
    for opt in ("wav2vec", "model"):
        sa, sb = a["opts"][opt], b["opts"][opt]
        assert sa.keys() == sb.keys() and len(sa) > 0
        for k in sa:
            for key in sa[k]:
                assert torch.equal(sa[k][key], sb[k][key]), (opt, k, key)
    assert resumed["log"] == straight["log"]


def test_jax_msgpack_export_loads_into_the_port(runs, songs, tmp_path):
    """The JAX brain's ``save_model`` export (msgpack) read back with its
    ``load_msgpack`` fills the port's modules through
    ``convert_jax.load_jax_params``: every parameter equal to the JAX
    brain's; the port's own export (``.pt``) round-trips."""
    jbrain = runs["jax"]["brain"]
    jamt.save_msgpack(jbrain.params["wav2vec2"],
                      str(tmp_path / "wav2vec2.msgpack"))
    jamt.save_msgpack(jbrain.params["model"], str(tmp_path / "model.msgpack"))
    tree = {name: jamt.load_msgpack(str(tmp_path / f"{name}.msgpack"))
            for name in ("wav2vec2", "model")}
    hp = _port_hparams(songs, tmp_path / "out", ARCH, tree)
    bridge, head = hp["modules"]["wav2vec2"], hp["modules"]["model"]
    got = export_jax_params(bridge, head)
    want = jax.device_get(jbrain.params)
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    amt.save_state_dict(head, str(tmp_path / "model.pt"))
    assert all(torch.equal(v, head.state_dict()[k]) for k, v in
               amt.load_state_dict(str(tmp_path / "model.pt")).items())


def test_command_line_trains_and_evaluates(songs, tmp_path):
    """``python -m ...train_audio_ssl <yaml> --overrides`` (the JAX recipe's
    command line) on the CPU: the experiment folder holds the
    hyperparameters, a copy of the script, the logs and the kept
    checkpoint; the train log has both epochs and the test."""
    import subprocess
    import sys

    csv = f"{songs}/csv/train.csv"
    out = tmp_path / "results"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    # the recipe's process, like this module, on two torch threads
    # (``tests/torch_threads.py``)
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run(
        [sys.executable, "-m",
         "svt_speechbrain_tpu_torch.recipes.MIR_ST500.train_audio_ssl",
         PORT_YAML, "--device", "cpu", "--noprogressbar",
         f"--data_folder={songs}", f"--output_folder={out}",
         f"--train_csv={csv}", f"--valid_csv={csv}", f"--test_csv=[{csv}]",
         "--number_of_epochs=2", "--linear_prob_epochs=1", "--batch_size=2",
         "--num_workers=2", "--feat_dim=32",
         "--wav2vec2=!new:svt_speechbrain_tpu_torch.models.wav2vec2."
         f"HuggingFaceWav2Vec2 {{source: tiny-test, arch_overrides: "
         f"{json.dumps(ARCH)}}}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(os.listdir(out)) == ["env.log", "hyperparams.yaml",
                                       "log.txt", "save", "train_audio_ssl.py",
                                       "train_log.txt"]
    log = (out / "train_log.txt").read_text().splitlines()
    valid = [float(line.split("valid loss: ")[1].split(",")[0])
             for line in log[:2]]
    assert [line.split(" - ")[0] for line in log] == [
        "epoch: 1, lr_wav2vec: 5.000e-05, lr_model: 3.000e-04",
        "epoch: 2, lr_wav2vec: 5.000e-05, lr_model: 3.000e-04",
        f"Epoch loaded: {1 + int(np.argmin(valid))}"]
    assert len(os.listdir(out / "save")) == 1


def test_fit_start_loads_a_local_hf_checkpoint_then_recovers(tmp_path):
    """``HuggingFaceWav2Vec2.load_pretrained`` converts a HF checkpoint at
    ``save_path`` (None when there is none); ``AudioAMT.on_fit_start``
    installs it, and a checkpoint of the run, when there is one, wins over
    it. lv60 widths, one layer."""
    from svt_speechbrain_tpu_torch.models import convert_hf
    from svt_speechbrain_tpu_torch.models.wav2vec2 import HuggingFaceWav2Vec2
    from svt_speechbrain_tpu_torch.nnet.linear import Linear
    from svt_speechbrain_tpu_torch.utils.checkpoints import Checkpointer
    from tests.test_torch_serving import _hf_state_dict

    sd = {k: torch.from_numpy(v) for k, v in _hf_state_dict(1, False).items()}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    hparams = {"lr": 3e-4, "lr_wav2vec": 5e-5}

    def brain(save_path, ckpt_dir=None):
        bridge = HuggingFaceWav2Vec2(source="facebook/wav2vec2-large-lv60",
                                     save_path=save_path,
                                     arch_overrides={"num_layers": 1})
        return amt.AudioAMT(
            {"wav2vec2": bridge, "model": Linear(20, 1024)}, hparams=hparams,
            run_opts={"device": "cpu"},
            checkpointer=ckpt_dir and Checkpointer(ckpt_dir))

    plain = brain(str(tmp_path / "nothing"), tmp_path / "ckpt")
    assert plain.modules.wav2vec2.load_pretrained() is None
    plain.on_fit_start()
    plain.checkpointer.save_checkpoint()

    loaded = brain(str(tmp_path))
    loaded.on_fit_start()
    want = convert_hf.convert_wav2vec2_state_dict(
        sd, loaded.modules.wav2vec2.config)
    got = loaded.modules.wav2vec2.encoder.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())

    resumed = brain(str(tmp_path), tmp_path / "ckpt")
    resumed.on_fit_start()
    for k, v in plain.modules.state_dict().items():
        assert torch.equal(resumed.modules.state_dict()[k], v), k
