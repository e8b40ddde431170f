"""Port parity, the N20EMv2 path end to end: the audio-only recipe, its
feature dumps, both RCA fusion recipes and the noise sweep, in both
packages on one synthetic set, f32 on the CPU, dropouts 0.

Stage 1 (TINY wav2vec2, one layer, width 32), on the
``tests/test_recipe_n20emv2.py`` ``n20em_audio_dataset`` pattern: three
N20EMv2 songs (train, valid, test) of sine notes with accompaniment stems
and one MIR-ST500 train song; the accompaniment sweep written once by the
port's ``synthesis_noise``; then each package prepares its own copy with
its own scripts (the CSVs, frame and note annotations held equal) and
trains from one weight tree with ``mix_train`` (2 epochs: linear probe,
finetune; batch 2), evaluates the test set from the checkpoint of greatest
valid COnPOff F1, and extracts features of every split clean and with
``add_noise`` (accomp at 0 dB). Held: each epoch's losses (rtol 1e-5: sums
in other orders), both optimizers' rates after each NewBob step, the train
log line for line, every song's notes and COnPOff/COnP/COn/COff scores
exactly, the kept checkpoints, the ``save_model`` exports (the port's
``.pt`` against the JAX msgpack, FEAT_ATOL), and the dumps
``clean_feats.npy`` / ``accomp/SNR_0dB_feats.npy`` (FEAT_ATOL: one encoder
layer and its norms in f32, summed in other orders; 4.7e-6 measured at
values up to 3.0).

Stage 2 (``FusionRCA`` at width 32 and 16, 4 heads): the AV recipe and the
audio-only control in both packages, once on the port's own stage-1 dumps
with seeded 50 fps video dumps (the port's recipe through its ``main``,
its head warm-started from the JAX stage-1 msgpack export in both), and
once on the ``fusion_dataset`` pattern: losses, rates, the train log, the
``*_pred.npy`` dumps and the scores; then ``run_noise_sweep``'s rows (the
port's command line) against the JAX script's ``evaluate_condition``, and
its printed table."""
import functools
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_speechbrain_tpu.config import load_hyperyaml as jax_load_hyperyaml
from svt_speechbrain_tpu.dataio import dataio as jdataio
from svt_speechbrain_tpu.utils.amt import note2frame as jnote2frame

from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import (
    init_modules, init_params, load_jax_params, load_module_tree,
    module_tree)
from svt_speechbrain_tpu_torch.dataio.dataio import merge_csvs, write_audio
from svt_speechbrain_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from svt_speechbrain_tpu_torch.recipes.MIR_ST500 import (
    prepare_benchmarks as mir_prep)
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_only import (
    extract_ssl_feats, prepare_n20emv2, train_audio_ssl)
from svt_speechbrain_tpu_torch.recipes.N20EMv2.audio_visual import (
    prepare_n20emv2 as av_prep, run_noise_sweep, synthesis_noise,
    train_rca_a, train_rca_av)
from svt_speechbrain_tpu_torch.tasks import amt
from tests.conftest import REPO_ROOT
from tests.test_recipe_mir_st500 import _make_note_track
from tests.torch_threads import two_torch_threads  # noqa: F401

JAX_RECIPES = os.path.join(REPO_ROOT, "recipes")
PORT_RECIPES = os.path.join(REPO_ROOT, "svt_speechbrain_tpu_torch", "recipes")
AUDIO_YAML = "N20EMv2/audio_only/hparams/train_audio_ssl.yaml"
EXTRACT_YAML = "N20EMv2/audio_only/hparams/extract_ssl_feats.yaml"
AV_YAML = "N20EMv2/audio_visual/hparams/train_rca_av.yaml"
A_YAML = "N20EMv2/audio_visual/hparams/train_rca_a.yaml"
PKG = {"jax": "svt_speechbrain_tpu", "port": "svt_speechbrain_tpu_torch"}
ARCH = dict(hidden_size=32, num_layers=1, num_heads=4, ffn_size=64,
            conv_dim=[16] * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, hidden_dropout=0.0,
            attention_dropout=0.0, activation_dropout=0.0,
            feat_proj_dropout=0.0)
LOSS_RTOL = 1e-5
FEAT_ATOL = 3e-5
SR = 16000


def _yaml(side, rel):
    return os.path.join(JAX_RECIPES if side == "jax" else PORT_RECIPES, rel)


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(JAX_RECIPES, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    sys.path.insert(0, os.path.dirname(os.path.join(JAX_RECIPES, rel)))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.pop(0)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    """The JAX recipe scripts, loaded from their files."""
    names = {
        "prep": "N20EMv2/audio_only/prepare_n20emv2.py",
        "mir_prep": "MIR_ST500/prepare_benchmarks.py",
        "audio": "N20EMv2/audio_only/train_audio_ssl.py",
        "av_prep": "N20EMv2/audio_visual/prepare_n20emv2.py",
        "av": "N20EMv2/audio_visual/train_rca_av.py",
        "a": "N20EMv2/audio_visual/train_rca_a.py",
        "sweep": "N20EMv2/audio_visual/run_noise_sweep.py"}
    # the AV scripts import their siblings by these names
    mods = {"audio": _load(names["audio"], "train_audio_ssl"),
            "av": _load(names["av"], "train_rca_av")}
    for key in ("prep", "mir_prep", "av_prep", "a", "sweep"):
        mods[key] = _load(names[key], f"jax_n20em_{key}")
    return mods


# ---------------------------------------------------------------- the sets
def _song(rng, seconds):
    notes = _make_note_track(rng, seconds)
    t = np.arange(int(seconds * SR)) / SR
    sig = np.zeros(len(t), np.float32)
    for on, off, midi in notes:
        mask = (t >= on) & (t < off)
        sig[mask] += 0.5 * np.sin(2 * np.pi * 440.0 * 2 ** ((midi - 69) / 12)
                                  * t[mask]).astype(np.float32)
    sig += 0.01 * rng.normal(size=len(sig)).astype(np.float32)
    return notes, sig


def _prepare(side, root, scripts):
    """One package's preparation of its copy: frame annotations and CSVs of
    N20EMv2 and MIR-ST500 at 3 s utterances, merged into mix_train.csv."""
    csv_dir = os.path.join(root, "csv", "dur_3s")
    mir_train = os.path.join(root, "mir", "wav16kHz", "train")
    prep, mir, merge = ((scripts["prep"], scripts["mir_prep"],
                         jdataio.merge_csvs) if side == "jax" else
                        (prepare_n20emv2, mir_prep, merge_csvs))
    prep.prepare_frame_anno(root)
    prep.prepare_csv_n20emv2(root, csv_folder=os.path.join(root, "csv"),
                             dur_thrd=3)
    mir.prepare_frame_anno(os.path.join(root, "mir", "Annotations.json"),
                           mir_train)
    mir.prepare_csv_benchmarks(mir_train,
                               os.path.join(csv_dir, "mir_st500_train.csv"),
                               dur_thrd=3)
    merge(data_folder=csv_dir,
          csv_lst=["mir_st500_train.csv", "n20em_train.csv"],
          merged_csv="mix_train.csv")


@pytest.fixture(scope="module")
def sets(tmp_path_factory, jax_scripts):
    """{"jax": root, "port": root}: one synthetic set, copied for each
    package and prepared by its own scripts."""
    top = tmp_path_factory.mktemp("n20em")
    base = str(top / "base")
    rng = np.random.default_rng(0)
    annotations = {}
    for i, (split, seconds) in enumerate((("train", 6.0), ("valid", 6.0),
                                          ("test", 7.0))):
        entry = f"song{i}"
        notes, sig = _song(rng, seconds)
        annotations[entry] = {"midi": notes, "split": split}
        d = os.path.join(base, "data", entry)
        os.makedirs(d)
        write_audio(os.path.join(d, "vocals.wav"), sig, SR)
        write_audio(os.path.join(d, "accomp.wav"),
                    (rng.normal(size=len(sig)) * 0.05).astype(np.float32),
                    SR)
    with open(os.path.join(base, "annotations.json"), "w") as f:
        json.dump(annotations, f)
    notes, sig = _song(rng, 6.0)
    mir_song = os.path.join(base, "mir", "wav16kHz", "train", "mir0")
    os.makedirs(mir_song)
    write_audio(os.path.join(mir_song, "vocals.wav"), sig, SR)
    with open(os.path.join(base, "mir", "Annotations.json"), "w") as f:
        json.dump({"mir0": notes}, f)
    synthesis_noise.synthesis_accomp(base, device="cpu")
    roots = {}
    for side in ("jax", "port"):
        roots[side] = str(top / side)
        shutil.copytree(base, roots[side])
        _prepare(side, roots[side], jax_scripts)
    return roots


def _tree_files(root, suffixes):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(suffixes):
                path = os.path.join(dirpath, name)
                out[os.path.relpath(path, root)] = path
    return out


def test_preparation_matches_the_jax_scripts(sets):
    """The CSVs (paths relative to each copy), the frame annotations and
    the note files of both packages' preparation are equal."""
    want = _tree_files(sets["jax"], (".csv", ".npy", ".json"))
    got = _tree_files(sets["port"], (".csv", ".npy", ".json"))
    assert sorted(got) == sorted(want)
    assert "csv/dur_3s/mix_train.csv" in got
    for rel, path in want.items():
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(got[rel]), np.load(path))
        else:
            assert open(got[rel]).read() == open(path).read().replace(
                sets["jax"], sets["port"]), rel
    with open(got["csv/dur_3s/mix_train.csv"]) as f:
        rows = f.read().splitlines()
    assert len(rows) == 1 + 2 + 2        # header, mir0's and song0's 3 s


# --------------------------------------------------------------- recording
def _recording(cls, scheds):
    """``cls`` recording each stage end (loss, epoch, learning rates, the
    ``scheds`` schedulers' values) and each song's notes and scores."""

    class Recording(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.stage_ends, self.songs = [], []

        def on_stage_end(self, stage, stage_loss, epoch=None):
            super().on_stage_end(stage, stage_loss, epoch)
            self.stage_ends.append(dict(
                stage=stage.name, loss=float(stage_loss), epoch=epoch,
                lrs={o: np.float32(self.get_learning_rate(o))
                     for o in self.optimizers},
                scheds=[getattr(self.hparams, s).hyperparam_value
                        for s in scheds],
                f1=None if stage.name == "TRAIN" else self.COnPOff_f1.avg))

        def on_song_end(self, batch, est_np):
            super().on_song_end(batch, est_np)
            self.songs.append([batch.id[0].rsplit("_", 1)[0], est_np])

        def _score_song(self, est_np, ref_intervals, ref_pitchs):
            super()._score_song(est_np, ref_intervals, ref_pitchs)
            self.songs[-1].append({
                f"{n}_{k}": getattr(self, f"{n}_{k}").val
                for n in self.metric_names
                for k in ("precis", "recall", "f1")})

    return Recording


def _hand_jax_the_tree(hp, tree):
    """The JAX ``Brain`` initialises each module itself: hand it ``tree``."""
    for name, sub in tree.items():
        hp["modules"][name].init = functools.partial(
            lambda sub, rng: jax.tree_util.tree_map(jnp.asarray, sub), sub)


def _load_hp(side, rel, overrides):
    with open(_yaml(side, rel)) as f:
        return (jax_load_hyperyaml if side == "jax" else load_hyperyaml)(
            f, overrides)


def _run_opts(side):
    if side == "jax":
        return {"noprogressbar": True, "data_parallel_count": 1}
    return {"device": "cpu", "noprogressbar": True}


def _log(hp):
    with open(hp["train_log"]) as f:
        return f.read().splitlines()


def _assert_runs_equal(got, want):
    """Stage ends (losses rtol LOSS_RTOL, rates and schedulers exactly),
    the train log, every song's notes and scores."""
    g, w = got["brain"].stage_ends, want["brain"].stage_ends
    assert [(e["stage"], e["epoch"]) for e in g] == \
        [(e["stage"], e["epoch"]) for e in w]
    np.testing.assert_allclose([e["loss"] for e in g],
                               [e["loss"] for e in w], rtol=LOSS_RTOL)
    assert all(np.isfinite(e["loss"]) for e in g)
    for a, b in zip(g, w):
        assert a["scheds"] == b["scheds"] and a["lrs"] == b["lrs"]
    assert got["log"] == want["log"]
    gs, ws = got["brain"].songs, want["brain"].songs
    assert [s[0] for s in gs] == [s[0] for s in ws] and gs
    for (name, est, scores), (_, want_est, want_scores) in zip(gs, ws):
        np.testing.assert_array_equal(est, want_est, err_msg=name)
        assert scores == want_scores, name
    assert [e["f1"] for e in g] == [e["f1"] for e in w]


# ----------------------------------------------------------------- stage 1
def _audio_overrides(side, root, out, extra=""):
    return f"""
data_folder: {root}
output_folder: {out}
csv_folder: {root}/csv/dur_3s
dur_threshold: 3
number_of_epochs: 2
linear_prob_epochs: 1
batch_size: 2
num_workers: 0
save_model_folder: {out}/save_model
noise_type: accomp
snr_db: 0
wav2vec2: !new:{PKG[side]}.models.wav2vec2.HuggingFaceWav2Vec2
   source: tiny-test
   output_norm: True
   normalize_wav: True
   arch_overrides: {json.dumps(ARCH)}
feat_dim: 32
{extra}"""


def _stage1(side, root, out, tree, scripts):
    """Train (mix_train, save_model) and evaluate the test set; then
    extract features clean and at accomp 0 dB, recovering the trained
    checkpoint. Returns {"train", "clean", "noisy"} runs."""
    recipe = scripts["audio"] if side == "jax" else train_audio_ssl
    hp = _load_hp(side, AUDIO_YAML, _audio_overrides(
        side, root, out, "mix_train: True\nsave_model: True"))
    if side == "jax":
        _hand_jax_the_tree(hp, tree)
    else:
        load_jax_params(tree, hp["modules"]["wav2vec2"], hp["modules"]["model"])
    train, valid, tests = recipe.dataio_prepare(hp)
    brain = _recording(recipe.AMT, ["lr_annealing_wav2vec",
                                    "lr_annealing_model"])(
        modules=hp["modules"], hparams=hp, run_opts=_run_opts(side),
        checkpointer=hp["checkpointer"])
    assert brain.compute_coff and brain.ckpt_policy == "max_COnPOff_f1"
    assert len(train) == 4                    # mir0 and song0, 2 each
    brain.fit(hp["epoch_counter"], train, valid,
              train_loader_kwargs=hp["train_dataloader_opts"],
              valid_loader_kwargs=hp["valid_dataloader_opts"])
    brain.evaluate(list(tests.values())[0], max_key="COnPOff_f1",
                   test_loader_kwargs=hp["test_dataloader_opts"])
    runs = {"train": dict(brain=brain, log=_log(hp),
                          ckpts=hp["checkpointer"].list_checkpoints())}
    for cond, extra in (("clean", "add_noise: False"),
                        ("noisy", "add_noise: True")):
        ehp = _load_hp(side, EXTRACT_YAML, _audio_overrides(
            side, root, out, extra + f"\nsave_model_folder: {out}/x_{cond}"))
        cls = _recording(recipe.AMT, ["lr_annealing_wav2vec",
                                      "lr_annealing_model"])
        if side == "jax":
            data = recipe.dataio_prepare(ehp, extract=True)
            ebrain = cls(modules=ehp["modules"], hparams=ehp,
                         run_opts=_run_opts(side),
                         checkpointer=ehp["checkpointer"])
            ebrain.return_feats = True
            for split in (data[0], data[1], *data[2].values()):
                ebrain.evaluate(split, max_key="COnPOff_f1",
                                test_loader_kwargs=ehp["test_dataloader_opts"])
        else:
            ebrain = extract_ssl_feats.extract(ehp, _run_opts(side), cls)
        runs[cond] = dict(brain=ebrain, log=_log(ehp))
    return runs


@pytest.fixture(scope="module")
def stage1(sets, jax_scripts, tmp_path_factory):
    tree = init_params(Wav2Vec2Config(**dict(ARCH, conv_dim=(16,) * 7)),
                       torch.Generator().manual_seed(0))
    out = tmp_path_factory.mktemp("stage1")
    return {side: _stage1(side, sets[side], str(out / side), tree,
                          jax_scripts)
            for side in ("jax", "port")}


def test_audio_recipe_matches_the_jax_recipe(stage1):
    """Losses, rates, log, notes and scores (COff included) of fit and
    evaluate with ``mix_train``; the checkpoint kept by COnPOff F1."""
    got, want = stage1["port"]["train"], stage1["jax"]["train"]
    assert [(e["stage"], e["epoch"]) for e in got["brain"].stage_ends] == [
        ("TRAIN", 1), ("VALID", 1), ("TRAIN", 2), ("VALID", 2),
        ("TEST", None)]
    _assert_runs_equal(got, want)
    assert "COff_f1" in got["brain"].songs[0][2]
    # the checkpoints of the greatest valid F1 (ties kept), equal in both
    best = max(e["f1"] for e in got["brain"].stage_ends
               if e["stage"] == "VALID")
    metas = [c.meta["COnPOff_f1"] for c in got["ckpts"]]
    assert metas == [c.meta["COnPOff_f1"] for c in want["ckpts"]]
    assert metas and all(m == best for m in metas)


@pytest.mark.parametrize("cond", ["clean", "noisy"])
def test_extraction_matches_and_dumps_every_song(stage1, sets, cond):
    """Every split evaluated in song order from the kept checkpoint (the
    noisy condition reading the accomp 0 dB WAVs); notes and scores equal;
    every song's dump written, (frames, 32), within FEAT_ATOL of the JAX
    package's."""
    got, want = stage1["port"][cond], stage1["jax"][cond]
    _assert_runs_equal(got, want)
    rel = ("noise_data/clean_feats.npy" if cond == "clean"
           else "noise_data/accomp/SNR_0dB_feats.npy")
    names = [s[0] for s in got["brain"].songs]
    assert names == ["song0", "song1", "song2"]     # train, valid, test
    for name in names:
        path = os.path.join("data", name, rel)
        mine = np.load(os.path.join(sets["port"], path))
        theirs = np.load(os.path.join(sets["jax"], path))
        assert mine.dtype == np.float32 and mine.shape[1] == 32
        assert mine.shape == theirs.shape and np.isfinite(mine).all()
        np.testing.assert_allclose(mine, theirs, atol=FEAT_ATOL, err_msg=path)


def test_clean_and_noisy_dumps_differ_and_match_the_annotation_length(
        stage1, sets):
    for entry in ("song0", "song1", "song2"):
        d = os.path.join(sets["port"], "data", entry)
        clean = np.load(os.path.join(d, "noise_data", "clean_feats.npy"))
        noisy = np.load(os.path.join(d, "noise_data", "accomp",
                                     "SNR_0dB_feats.npy"))
        anno = np.load(os.path.join(d, "frame_anno.npy"))
        assert clean.shape == noisy.shape
        assert abs(clean.shape[0] - anno.shape[0]) <= 1
        assert np.abs(clean - noisy).max() > 1e-3


def test_save_model_exports_the_trained_modules(stage1):
    """The port's ``.pt`` export against the JAX msgpack export of the same
    run: every parameter within FEAT_ATOL; the port's msgpack reader gives
    the JAX tree bit for bit."""
    from svt_speechbrain_tpu.tasks import amt as jamt
    from svt_speechbrain_tpu_torch.convert_jax import load_msgpack

    brain = stage1["port"]["train"]["brain"]
    folder = brain.hparams.save_model_folder
    jfolder = stage1["jax"]["train"]["brain"].hparams.save_model_folder
    assert sorted(os.listdir(folder)) == ["model.pt", "wav2vec2.pt"]
    assert sorted(os.listdir(jfolder)) == ["model.msgpack", "wav2vec2.msgpack"]
    for name, module in (("model", brain.modules.model),
                         ("wav2vec2", brain.modules.wav2vec2)):
        mine = amt.load_state_dict(os.path.join(folder, f"{name}.pt"))
        want_tree = jamt.load_msgpack(os.path.join(jfolder,
                                                   f"{name}.msgpack"))
        got_tree = load_msgpack(os.path.join(jfolder, f"{name}.msgpack"))
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(got_tree),
                jax.tree_util.tree_leaves_with_path(want_tree)):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        theirs = module_tree(module)
        jt = jax.tree_util.tree_map(np.asarray, want_tree)
        for path, leaf in jax.tree_util.tree_leaves_with_path(jt):
            node = theirs
            for key in path:
                node = node[key.key]
            np.testing.assert_allclose(node, leaf, atol=FEAT_ATOL)
        assert all(torch.equal(v, module.state_dict()[k].cpu())
                   for k, v in mine.items())


# ----------------------------------------------------------------- stage 2
def _video_dumps(root, width, rng):
    """Seeded 50 fps video dumps beside each N20EMv2 song's clean audio
    dump."""
    with open(os.path.join(root, "annotations.json")) as f:
        entries = list(json.load(f))
    for entry in entries:
        d = os.path.join(root, "data", entry, "noise_data")
        frames = np.load(os.path.join(d, "clean_feats.npy")).shape[0]
        seconds = frames / 49.8
        np.save(os.path.join(d, "video_feats.npy"),
                rng.normal(size=(round(seconds * 50), width)).astype(
                    np.float32))


def _fusion_overrides(side, root, out, width, pretrain_folder=None):
    """The fusion recipe's overrides as {key: yaml value}."""
    return {
        "data_folder": root, "output_folder": out,
        "csv_folder": f"{root}/csv_av/dur_3s", "dur_threshold": "3",
        "number_of_epochs": "1", "batch_size": "2", "num_workers": "0",
        "feat_dim": str(width),
        "pretrain": "True" if pretrain_folder else "False",
        **({"pretrain_folder": pretrain_folder} if pretrain_folder else {}),
        "fusion": (f"!new:{PKG[side]}.models.fusion.FusionRCA {{alpha: 0.5, "
                   f"nhead: 4, d_ffn: {2 * width}, d_model: {width}}}")}


def _yaml_text(overrides):
    return "".join(f"{k}: {v}\n" for k, v in overrides.items())


def _argv(overrides):
    return [f"--{k}={v}" for k, v in overrides.items()]


def _pred_dumps(root):
    return {rel: np.load(path) for rel, path in
            _tree_files(root, ("_pred.npy",)).items()}


def _fusion_run(side, system, root, out, width, tree, scripts,
                pretrain_folder=None):
    """One fusion recipe run (fit 1 epoch, evaluate the test set); the
    port's through ``main`` on its command line, with ``tree``'s weights
    as ``init_modules`` draws them. Returns the run and its note dumps,
    read before the other package writes over them."""
    rel = AV_YAML if system == "av" else A_YAML
    overrides = _fusion_overrides(side, root, out, width, pretrain_folder)
    scheds = ["lr_annealing_model"]
    if side == "jax":
        recipe = scripts[system]
        hp = _load_hp(side, rel, _yaml_text(overrides))
        _hand_jax_the_tree(hp, tree)
        train, valid, tests = scripts["av"].dataio_prepare(hp)
        brain = _recording(recipe.AMT, scheds)(
            modules=hp["modules"], hparams=hp, run_opts=_run_opts(side),
            checkpointer=hp["checkpointer"])
        brain.fit(hp["epoch_counter"], train, valid,
                  train_loader_kwargs=hp["train_dataloader_opts"],
                  valid_loader_kwargs=hp["valid_dataloader_opts"])
        brain.evaluate(list(tests.values())[0], max_key="COnPOff_f1",
                       test_loader_kwargs=hp["test_dataloader_opts"])
    else:
        recipe = train_rca_av if system == "av" else train_rca_a
        brain = recipe.main(
            _recording(recipe.AMT, scheds),
            [_yaml(side, rel), "--device", "cpu", "--noprogressbar",
             *_argv(overrides)])
        hp = vars(brain.hparams)
    return dict(brain=brain, log=_log(hp), preds=_pred_dumps(root),
                ckpts=hp["checkpointer"].list_checkpoints())


def _seeded_fusion_tree(width, seed=1986):
    """The tree the port's ``init_modules`` draws for the recipe's modules
    (head, then fusion) from ``seed``: the port's ``main`` starts from it,
    and the JAX brain is handed it."""
    from svt_speechbrain_tpu_torch.models.fusion import FusionRCA
    from svt_speechbrain_tpu_torch.nnet.linear import Linear

    modules = {"head": Linear(20, width),
               "fusion": FusionRCA(0.5, 4, 2 * width, width)}
    init_modules(modules, seed)
    return {name: module_tree(m) for name, m in modules.items()}


@pytest.fixture(scope="module")
def own_dumps(stage1, sets, jax_scripts, tmp_path_factory):
    """Stage 2 on the port's stage-1 dumps: video dumps written, the AV
    CSVs prepared by both packages' scripts (held equal), then AV and A
    in both packages, the head warm-started from the JAX stage-1
    export."""
    root = sets["port"]
    _video_dumps(root, 32, np.random.default_rng(1))
    av_prep.prepare_csv_n20emv2_feat(root, csv_folder=os.path.join(
        root, "csv_av"), dur_thrd=3)
    jax_scripts["av_prep"].prepare_csv_n20emv2_feat(
        root, csv_folder=os.path.join(root, "csv_av_jax"), dur_thrd=3)
    pretrain = stage1["jax"]["train"]["brain"].hparams.save_model_folder
    tree = _seeded_fusion_tree(32)
    out = tmp_path_factory.mktemp("stage2")
    runs = {}
    for system in ("av", "a"):
        for side in ("jax", "port"):
            runs[system, side] = _fusion_run(
                side, system, root, str(out / f"{system}_{side}"), 32, tree,
                jax_scripts, pretrain)
    return dict(root=root, runs=runs, out=out)


def test_av_csvs_match_the_jax_script(own_dumps):
    root = own_dumps["root"]
    for split in ("train", "valid", "test"):
        name = f"dur_3s/n20em_{split}.csv"
        with open(os.path.join(root, "csv_av", name)) as f:
            got = f.read()
        with open(os.path.join(root, "csv_av_jax", name)) as f:
            assert got == f.read()
        assert len(got.splitlines()) == 3          # 2 utterances a song


@pytest.mark.parametrize("system", ["av", "a"])
def test_fusion_on_the_ports_own_dumps_matches_the_jax_recipe(own_dumps,
                                                              system):
    runs = own_dumps["runs"]
    got, want = runs[system, "port"], runs[system, "jax"]
    _assert_runs_equal(got, want)
    tag = "av" if system == "av" else "audio"
    assert sorted(got["preds"]) == sorted(want["preds"])
    mine = sorted(k for k in got["preds"]
                  if k.endswith(f"clean_{tag}_pred.npy"))
    # the valid song's (its last validation) and the test song's notes
    assert mine == [f"data/song{i}/noise_data/clean_{tag}_pred.npy"
                    for i in (1, 2)]
    for rel in mine:
        np.testing.assert_array_equal(got["preds"][rel], want["preds"][rel])
    assert len(got["ckpts"]) == len(want["ckpts"]) == 1


def test_fusion_head_starts_from_the_stage1_export(own_dumps, stage1,
                                                  tmp_path):
    """``pretrain``: the head read from the JAX msgpack export by the
    port's reader equals the JAX brain's starting head (the run's first
    train loss is equal in both, above); from a ``model.pt`` export the
    port reads the port's own head; a checkpoint of the run wins over the
    export (the JAX brain loads the export over it)."""
    from svt_speechbrain_tpu_torch.models.fusion import FusionRCA
    from svt_speechbrain_tpu_torch.nnet.linear import Linear
    from svt_speechbrain_tpu_torch.utils.checkpoints import Checkpointer

    port_export = stage1["port"]["train"]["brain"].hparams.save_model_folder

    def brain(ckpt=None):
        return amt.FusionAMT(
            {"head": Linear(20, 32), "fusion": FusionRCA(0.5, 4, 64, 32)},
            hparams={"pretrain": True, "pretrain_folder": port_export,
                     "lr": 0.1}, run_opts={"device": "cpu"},
            checkpointer=ckpt and Checkpointer(ckpt))

    fresh = brain()
    fresh.on_fit_start()
    want = amt.load_state_dict(os.path.join(port_export, "model.pt"))
    assert all(torch.equal(fresh.modules.head.state_dict()[k], v)
               for k, v in want.items())
    saved = brain(tmp_path)
    with torch.no_grad():
        saved.modules.head.b.fill_(3.0)
    saved.init_optimizers()
    saved.checkpointer.save_checkpoint()
    resumed = brain(tmp_path)
    resumed.on_fit_start()
    assert bool((resumed.modules.head.b == 3.0).all())


def test_noise_sweep_rows_match_the_jax_script(own_dumps, jax_scripts,
                                               capsys):
    """Each system from its own trained folder, clean and accomp at 0 dB:
    the port's command line writes the JAX script's rows and table."""
    root, out = own_dumps["root"], own_dumps["out"]
    sweep = jax_scripts["sweep"]
    for system in ("av", "a"):
        rel = AV_YAML if system == "av" else A_YAML
        jax_overrides = _fusion_overrides("jax", root,
                                          str(out / f"{system}_jax"), 32)
        cls = sweep.AMT_AV if system == "av" else sweep.AMT_A
        want = []
        for add in (False, True):
            metrics = sweep.evaluate_condition(
                cls, _yaml("jax", rel), _yaml_text(jax_overrides), "accomp",
                0, add)
            want.append({"system": system,
                         "noise_type": "accomp" if add else "clean",
                         "snr_db": 0 if add else None, **metrics})
        port_overrides = _fusion_overrides("port", root,
                                           str(out / f"{system}_port"), 32)
        del port_overrides["data_folder"]
        jsonl = str(out / f"sweep_{system}.jsonl")
        capsys.readouterr()
        run_noise_sweep.main([
            _yaml("port", rel), f"--data_folder={root}", "--noise_types",
            "accomp", "--snrs", "0", "--systems", system, "--out", jsonl,
            "--device", "cpu", *_argv(port_overrides)])
        printed = capsys.readouterr().out.splitlines()
        with open(jsonl) as f:
            got = [json.loads(line) for line in f]
        assert got == json.loads(json.dumps(want))
        assert set(got[0]) == {"system", "noise_type", "snr_db", "COnPOff",
                               "COnP", "COn", "COff"}
        table = [f"{'system':>6} {'noise':>8} {'snr':>5} {'COn_f1':>8} "
                 f"{'COnPOff_f1':>11}"] + [
            f"{r['system']:>6} {r['noise_type']:>8} {str(r['snr_db']):>5} "
            f"{r['COn']:>8.3f} {r['COnPOff']:>11.3f}" for r in want]
        assert printed[-3:] == table


# ---------------------------------------- stage 2 on the fusion_dataset set
@pytest.fixture(scope="module")
def fusion_dataset(tmp_path_factory):
    """``tests/test_recipe_n20emv2.py``'s ``fusion_dataset``: random 16-wide
    audio (49.8 fps) and video (50 fps) dumps of three 6 s songs, prepared
    by the port's AV script."""
    root = tmp_path_factory.mktemp("n20em_av")
    rng = np.random.default_rng(0)
    annotations = {}
    for i, split in enumerate(["train", "valid", "test"]):
        entry = f"song{i}"
        notes = _make_note_track(rng, 6.0)
        annotations[entry] = {"midi": notes, "split": split}
        d = root / "data" / entry / "noise_data"
        os.makedirs(d)
        a_frames, v_frames = round(6.0 * 49.8), round(6.0 * 50)
        np.save(d / "clean_feats.npy",
                rng.normal(size=(a_frames, 16)).astype(np.float32))
        np.save(d / "video_feats.npy",
                rng.normal(size=(v_frames, 16)).astype(np.float32))
        with open(root / "data" / entry / "note_anno.json", "w") as f:
            json.dump(notes, f)
        np.save(root / "data" / entry / "frame_anno.npy",
                jnote2frame(notes, a_frames))
    with open(root / "annotations.json", "w") as f:
        json.dump(annotations, f)
    av_prep.prepare_csv_n20emv2_feat(str(root),
                                     csv_folder=str(root / "csv_av"),
                                     dur_thrd=3)
    return str(root)


@pytest.mark.parametrize("system", ["av", "a"])
def test_fusion_recipe_matches_the_jax_recipe(fusion_dataset, jax_scripts,
                                              tmp_path, system):
    tree = _seeded_fusion_tree(16)
    want = _fusion_run("jax", system, fusion_dataset, str(tmp_path / "jax"),
                       16, tree, jax_scripts)
    got = _fusion_run("port", system, fusion_dataset, str(tmp_path / "port"),
                      16, tree, jax_scripts)
    _assert_runs_equal(got, want)
    tag = "av" if system == "av" else "audio"
    rel = f"data/song2/noise_data/clean_{tag}_pred.npy"
    np.testing.assert_array_equal(got["preds"][rel], want["preds"][rel])


# ------------------------------------- chip_smoke.py's hparams without yaml
@pytest.mark.parametrize("which", ["train", "extract", "av", "a"])
def test_yaml_equals_the_python_hparams_of_chip_smoke(tmp_path, monkeypatch,
                                                      which):
    """``chip_smoke.n20em_hparams`` and ``rca_hparams`` build the recipes'
    objects from the port's yamls through the port's own reader (they were
    Python copies of the yamls' values while the reader needed PyYAML): the
    same keys, values, classes and arguments as ``load_hyperyaml`` on the
    port's yamls, with the same overrides (the wav2vec2 bridge at TINY width
    on both sides, its arguments compared as given)."""
    import chip_smoke
    from svt_speechbrain_tpu_torch.models import wav2vec2
    from tests.test_torch_engine import _describe

    class Bridge(wav2vec2.HuggingFaceWav2Vec2):
        def __init__(self, **kwargs):
            self.given = dict(kwargs)
            super().__init__(**kwargs, arch_overrides=wav2vec2.TINY_ARCH)

    monkeypatch.setattr(wav2vec2, "HuggingFaceWav2Vec2", Bridge)
    monkeypatch.setattr(chip_smoke, "HuggingFaceWav2Vec2", Bridge)
    overrides = dict(data_folder=str(tmp_path), number_of_epochs=2,
                     num_workers=4, snr_db=5, add_noise=True,
                     csv_folder=str(tmp_path / "csv"))
    rel, build = {
        "train": (AUDIO_YAML, lambda o: chip_smoke.n20em_hparams(**o)),
        "extract": (EXTRACT_YAML,
                    lambda o: chip_smoke.n20em_hparams(extract=True, **o)),
        "av": (AV_YAML, lambda o: chip_smoke.rca_hparams("av", **o)),
        "a": (A_YAML, lambda o: chip_smoke.rca_hparams("a", **o))}[which]
    if which in ("train", "extract"):
        overrides.update(linear_prob_epochs=1, save_model=which == "train")
    else:
        overrides.update(pretrain=False, lr=0.001)
    monkeypatch.chdir(tmp_path)        # the default output folders land here
    want = {}
    for i, make in enumerate((lambda o: load_hyperyaml(open(
            _yaml("port", rel)), o), build)):
        hp = make(dict(overrides))
        assert hp["checkpointer"].recoverables["counter"] is \
            hp["epoch_counter"]
        want[i] = _describe(hp)
    assert sorted(want[1]) == sorted(want[0])
    for key in want[0]:
        assert want[1][key] == want[0][key], key
    assert ("noise_True_accomp_5db_lr0.001" in want[1]["output_folder"]) == \
        (which in ("av", "a"))
