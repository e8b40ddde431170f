"""Port parity, the N20EMv2 video recipe end to end: data preparation, the
``train_video_ssl`` recipe (a linear-probe and a finetune epoch, then
``evaluate``) and ``extract_ssl_feats``, in both packages on one synthetic
set (``tests/test_recipe_n20emv2.py``'s ``video_dataset`` pattern: three
4 s songs of 96×96 uint8 frames at 50 fps, train, valid and test), f32 on
the CPU, batch 2, ``dur_threshold`` 2, ``split_noise`` on, no loader
workers, a tiny AV-HuBERT (one layer, width 16) on the full ResNet-18
frontend at the recipe's 88 crop, its dropouts zeroed through
``arch_overrides`` so that both packages compute the same numbers.

Held: the CSVs and annotations of both preparations, equal; the train
pipeline's crops, flips and boundary jitter, bit for bit (one generator,
the same draw order); each epoch's losses (LOSS_RTOL: sums in other
orders) and the learning rates; the BatchNorm running statistics after
each epoch, the probe epoch's included (STAT_ATOL); every song's notes and
COnPOff/COnP/COn/COff scores exactly; the extracted songs' ``video_feats.npy``
(FEAT_ATOL: the ResNet's f32 error through one encoder layer); a recovered
run against the uninterrupted one, bit for bit, buffers included; a
nonfinite step that commits the statistics but no update, as the JAX
engine does; and, with the dropouts on, the mean of many training
forwards against the JAX package's (a statistical check: the two draw
other masks)."""
import copy
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svt_speechbrain_tpu.config import load_hyperyaml as jax_load_hyperyaml
from svt_speechbrain_tpu.core import Stage as JStage

from svt_speechbrain_tpu_torch.config import load_hyperyaml
from svt_speechbrain_tpu_torch.convert_jax import (
    _flatten, init_modules, module_tree)
from svt_speechbrain_tpu_torch.core import Stage
from svt_speechbrain_tpu_torch.recipes.N20EMv2.video_only import (
    extract_ssl_feats, prepare_n20emv2, train_video_ssl)
from tests.test_torch_recipe_n20emv2 import _load, _recording
from tests.test_recipe_n20emv2 import _make_notes
from tests.torch_threads import two_torch_threads  # noqa: F401

JAX_RECIPES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "recipes")
PORT_RECIPES = os.path.join(os.path.dirname(JAX_RECIPES),
                            "svt_speechbrain_tpu_torch", "recipes")
TRAIN_YAML = "N20EMv2/video_only/hparams/train_video_ssl.yaml"
EXTRACT_YAML = "N20EMv2/video_only/hparams/extract_ssl_feats.yaml"
PKG = {"jax": "svt_speechbrain_tpu", "port": "svt_speechbrain_tpu_torch"}
ARCH = dict(encoder_layers=1, encoder_embed_dim=16, encoder_ffn_embed_dim=32,
            encoder_attention_heads=4, audio_feat_dim=8, conv_pos=8,
            conv_pos_groups=2, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, dropout_input=0.0)
LOSS_RTOL = 1e-5
ADAM_RTOL = 2e-4
STAT_ATOL = 5e-4
FEAT_ATOL = 2e-4
SCHEDS = ["lr_annealing_encoder", "lr_annealing_head"]


def _yaml(side, rel):
    return os.path.join(JAX_RECIPES if side == "jax" else PORT_RECIPES, rel)


@pytest.fixture(scope="module")
def jax_scripts():
    return {"prep": _load("N20EMv2/video_only/prepare_n20emv2.py",
                          "jax_video_prep"),
            "train": _load("N20EMv2/video_only/train_video_ssl.py",
                           "train_video_ssl")}


@pytest.fixture(scope="module")
def sets(tmp_path_factory, jax_scripts):
    """{"jax": root, "port": root}: one synthetic set, copied for each
    package and prepared by its own script at 2 s utterances."""
    top = tmp_path_factory.mktemp("n20em_video")
    base = str(top / "base")
    rng = np.random.default_rng(0)
    annotations = {}
    for i, split in enumerate(["train", "valid", "test"]):
        entry = f"song{i}"
        annotations[entry] = {"midi": _make_notes(rng, 4.0), "split": split}
        d = os.path.join(base, "data", entry)
        os.makedirs(d)
        np.save(os.path.join(d, "video_50fps.npy"),
                (rng.random((200, 96, 96)) * 255).astype(np.uint8))
    with open(os.path.join(base, "annotations.json"), "w") as f:
        json.dump(annotations, f)
    roots = {}
    for side in ("jax", "port"):
        roots[side] = str(top / side)
        shutil.copytree(base, roots[side])
        prep = jax_scripts["prep"] if side == "jax" else prepare_n20emv2
        prep.prepare_frame_anno(roots[side], frame_rate=50)
        prep.prepare_csv_n20emv2(roots[side], csv_folder=os.path.join(
            roots[side], "csv"), frame_rate=50, dur_thrd=2)
    return roots


def test_preparation_matches_the_jax_script(sets):
    for rel in ("csv/frame_rate50/dur_2s/n20em_train.csv",
                "csv/frame_rate50/dur_2s/n20em_test.csv",
                "data/song1/note_anno.json"):
        with open(os.path.join(sets["port"], rel)) as f:
            got = f.read()
        with open(os.path.join(sets["jax"], rel)) as f:
            assert got == f.read().replace(sets["jax"], sets["port"]), rel
    rel = "data/song0/video_anno/50fps/video_frame_anno.npy"
    got = np.load(os.path.join(sets["port"], rel))
    np.testing.assert_array_equal(got, np.load(os.path.join(sets["jax"],
                                                            rel)))
    assert got.shape[0] == 200


def _overrides(side, root, out, extra=""):
    csv = f"{root}/csv/frame_rate50/dur_2s"
    return f"""
data_folder: {root}
output_folder: {out}
csv_folder: {csv}
dur_threshold: 2
number_of_epochs: 2
linear_prob_epochs: 1
batch_size: 2
num_workers: 0
split_noise: True
encoder: !new:{PKG[side]}.models.avhubert.FairseqAVHubert
   source: !ref <avhubert_ckpt>
   output_norm: True
   arch_overrides: {json.dumps(ARCH)}
feat_dim: 16
{extra}"""


def _load_hp(side, rel, overrides):
    with open(_yaml(side, rel)) as f:
        return (jax_load_hyperyaml if side == "jax" else load_hyperyaml)(
            f, overrides)


def _run_opts(side):
    if side == "jax":
        return {"noprogressbar": True, "data_parallel_count": 1}
    return {"device": "cpu", "noprogressbar": True}


def _seeded_trees(seed=1986):
    """The trees the port's ``init_modules`` draws for the recipe's modules
    (encoder, then head) from ``seed``."""
    from svt_speechbrain_tpu_torch.models.avhubert import FairseqAVHubert
    from svt_speechbrain_tpu_torch.nnet.linear import Linear

    modules = {"encoder": FairseqAVHubert(arch_overrides=ARCH),
               "head": Linear(20, 16)}
    init_modules(modules, seed)
    return {name: module_tree(m) for name, m in modules.items()}


def _stats(brain, side):
    """The encoder's running statistics as a flat {path: array}."""
    if side == "jax":
        return _flatten(jax.tree_util.tree_map(np.asarray,
                                               brain.states["encoder"]))
    return _flatten(module_tree(brain.modules.encoder, running_stats=True))


def _recording_stats(cls, side):
    """``_recording`` that also keeps the running statistics at each train
    stage's end, and the modules' state at each validation's end."""

    class Recording(_recording(cls, SCHEDS)):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.epoch_stats, self.snapshots = [], []

        def on_stage_end(self, stage, stage_loss, epoch=None):
            if stage == Stage.TRAIN or stage.name == "TRAIN":
                self.epoch_stats.append(_stats(self, side))
            super().on_stage_end(stage, stage_loss, epoch)
            if side == "port" and stage == Stage.VALID:
                self.snapshots.append(copy.deepcopy(
                    {k: m.state_dict() for k, m in self.modules.items()}))

    return Recording


def _hand_jax_the_trees(hp, trees):
    for name, sub in trees.items():
        hp["modules"][name].init = functools.partial(
            lambda sub, rng: jax.tree_util.tree_map(jnp.asarray, sub), sub)


def _run(side, root, out, trees, scripts):
    """Fit and evaluate the test set, then extract every split's features
    from the kept checkpoint. Returns {"train", "extract"} brains and the
    initial statistics."""
    recipe = scripts["train"] if side == "jax" else train_video_ssl
    hp = _load_hp(side, TRAIN_YAML, _overrides(side, root, out))
    if side == "jax":
        _hand_jax_the_trees(hp, trees)
    else:
        init_modules(hp["modules"], hp["seed"])
    train, valid, tests = recipe.dataio_prepare(hp)
    brain = _recording_stats(recipe.AMT, side)(
        modules=hp["modules"], hparams=hp, run_opts=_run_opts(side),
        checkpointer=hp["checkpointer"])
    initial = _stats(brain, side)
    assert len(train) == 2 and brain.compute_coff
    brain.fit(hp["epoch_counter"], train, valid,
              train_loader_kwargs=hp["train_dataloader_opts"],
              valid_loader_kwargs=hp["valid_dataloader_opts"])
    brain.evaluate(list(tests.values())[0], max_key="COnPOff_f1",
                   test_loader_kwargs=hp["test_dataloader_opts"])
    # the extract yaml's test sets are test, valid and train; the valid set
    # is evaluated first anyway, so the train set alone adds the last song
    ehp = _load_hp(side, EXTRACT_YAML, _overrides(
        side, root, out, f"test_csv: [{root}/csv/frame_rate50/dur_2s/"
                         f"n20em_train.csv]"))
    cls = _recording_stats(recipe.AMT, side)
    if side == "jax":
        _, evalid, etests = recipe.dataio_prepare(ehp, extract=True)
        ebrain = cls(modules=ehp["modules"], hparams=ehp,
                     run_opts=_run_opts(side),
                     checkpointer=ehp["checkpointer"])
        ebrain.return_feats = True
        for split in (evalid, *etests.values()):
            ebrain.evaluate(split, max_key="COnPOff_f1",
                            test_loader_kwargs=ehp["test_dataloader_opts"])
    else:
        ebrain = extract_ssl_feats.extract(ehp, _run_opts(side), cls)
    dumps = {name: np.load(os.path.join(root, "data", name, "noise_data",
                                        "video_feats.npy"))
             for name in ("song0", "song1")}
    return dict(brain=brain, extract=ebrain, initial=initial, dumps=dumps,
                nonfinite=_nonfinite_step(side, brain, hp, train))


def _params(brain, side):
    if side == "jax":
        return _flatten(jax.tree_util.tree_map(np.asarray, brain.params))
    return {f"{name}/{k}": v for name, m in brain.modules.items()
            for k, v in _flatten(module_tree(m)).items()}


def _nonfinite_step(side, brain, hp, train):
    """One finetune step of the trained brain (its compiled step reused)
    with an infinite head bias: (loss, statistics before and after,
    parameters before and after)."""
    if side == "jax":
        head = dict(brain.params["head"])
        head["b"] = jnp.full_like(head["b"], jnp.inf)
        brain.params = dict(brain.params, head=head)
        brain.on_stage_start(JStage.TRAIN, 2)
    else:
        with torch.no_grad():
            brain.modules.head.b.fill_(float("inf"))
        brain.on_stage_start(Stage.TRAIN, 2)
    assert not brain.frozen_modules
    batch = next(iter(brain.make_dataloader(
        train, Stage.TRAIN if side == "port" else JStage.TRAIN,
        ckpt_prefix=None, **dict(hp["train_dataloader_opts"],
                                 shuffle=False))))
    before, params = _stats(brain, side), _params(brain, side)
    loss = brain.fit_batch(batch)
    return loss, before, _stats(brain, side), params, _params(brain, side)


@pytest.fixture(scope="module")
def runs(sets, jax_scripts, tmp_path_factory):
    trees = _seeded_trees()
    out = tmp_path_factory.mktemp("video_runs")
    return {side: _run(side, sets[side], str(out / side), trees, jax_scripts)
            for side in ("jax", "port")}


def _assert_stats_close(got, want):
    assert sorted(got) == sorted(want) and got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=STAT_ATOL, err_msg=key)


def _assert_brains_equal(got, want, adam_steps=()):
    """Stage ends (losses within LOSS_RTOL, or ADAM_RTOL at the indices
    ``adam_steps``, which evaluate parameters after an Adam step of the
    encoder; rates and schedulers exactly), every song's notes and scores
    exactly."""
    g, w = got.stage_ends, want.stage_ends
    assert [(e["stage"], e["epoch"]) for e in g] == \
        [(e["stage"], e["epoch"]) for e in w]
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(
            a["loss"], b["loss"],
            rtol=ADAM_RTOL if i in adam_steps else LOSS_RTOL, err_msg=str(i))
    assert all(np.isfinite(e["loss"]) for e in g)
    for a, b in zip(g, w):
        assert a["scheds"] == b["scheds"] and a["lrs"] == b["lrs"]
    assert [s[0] for s in got.songs] == [s[0] for s in want.songs]
    for (name, est, scores), (_, want_est, want_scores) in zip(got.songs,
                                                               want.songs):
        np.testing.assert_array_equal(est, want_est, err_msg=name)
        assert scores == want_scores, name


def test_video_recipe_matches_the_jax_recipe(runs):
    """Losses, rates, notes and scores (COff included) of the probe and
    finetune epochs and the test evaluation; the statistics after each
    epoch. The probe epoch moves the statistics (its steps run the encoder
    in train mode, its parameters frozen)."""
    got, want = runs["port"]["brain"], runs["jax"]["brain"]
    assert [(e["stage"], e["epoch"]) for e in got.stage_ends] == [
        ("TRAIN", 1), ("VALID", 1), ("TRAIN", 2), ("VALID", 2),
        ("TEST", None)]
    _assert_brains_equal(got, want, adam_steps=(3, 4))
    assert "COff_f1" in got.songs[-1][2]
    assert len(got.epoch_stats) == len(want.epoch_stats) == 2
    for g, w in zip(got.epoch_stats, want.epoch_stats):
        _assert_stats_close(g, w)
    initial, probe = runs["port"]["initial"], got.epoch_stats[0]
    moved = [k for k in initial if not np.array_equal(initial[k], probe[k])]
    assert len(moved) == len(initial)            # every BatchNorm, both stats


def test_extraction_matches_and_dumps_every_song(runs):
    """The valid set, then the train set in song order from the kept
    checkpoint: notes and scores equal; the valid and train songs' dumps
    (200 frames × 16, one row per video frame) within FEAT_ATOL of the JAX
    package's."""
    got, want = runs["port"]["extract"], runs["jax"]["extract"]
    _assert_brains_equal(got, want)
    assert [s[0] for s in got.songs] == ["song1", "song0"]
    for name, mine in runs["port"]["dumps"].items():
        theirs = runs["jax"]["dumps"][name]
        assert mine.dtype == np.float32 and mine.shape == (200, 16)
        assert np.isfinite(mine).all()
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=FEAT_ATOL,
                                   err_msg=name)


def test_transforms_draw_the_jax_crops_flips_and_jitter(sets, jax_scripts,
                                                        tmp_path):
    """Each train utterance, read twice in order (two epochs' draws), is
    bit for bit the JAX pipeline's: the jitter, then the crop, then the
    flip from one generator."""
    items = {}
    for side in ("jax", "port"):
        recipe = jax_scripts["train"] if side == "jax" else train_video_ssl
        hp = _load_hp(side, TRAIN_YAML, _overrides(
            side, sets[side], str(tmp_path / side)))
        train, _, _ = recipe.dataio_prepare(hp)
        items[side] = [train[i % len(train)] for i in range(4)]
    shapes = set()
    for got, want in zip(items["port"], items["jax"]):
        np.testing.assert_array_equal(got["sig"], want["sig"])
        np.testing.assert_array_equal(got["anno"], want["anno"])
        assert got["sig"].dtype == np.float32 and got["sig"].shape[1:] == \
            (88, 88, 1)
        shapes.add(got["sig"].shape[0])
    assert not np.array_equal(items["port"][0]["sig"][:50],
                              items["port"][2]["sig"][:50])
    assert len(shapes) > 1                       # the jitter moved a boundary


def test_recovered_run_equals_the_uninterrupted_one(runs, sets, tmp_path):
    """One epoch, then a new process's objects recover its checkpoint (the
    modules with their BatchNorm buffers, the optimizers, the schedulers,
    the transforms' generator) and run the second: every parameter and
    buffer bit for bit as after the uninterrupted run's second epoch."""
    root = sets["port"]
    out = str(tmp_path / "resumed")

    def brain(epochs):
        hp = _load_hp("port", TRAIN_YAML, _overrides("port", root, out)
                      .replace("number_of_epochs: 2",
                               f"number_of_epochs: {epochs}"))
        init_modules(hp["modules"], hp["seed"])
        train, valid, _ = train_video_ssl.dataio_prepare(hp)
        b = _recording_stats(train_video_ssl.AMT, "port")(
            modules=hp["modules"], hparams=hp, run_opts=_run_opts("port"),
            checkpointer=hp["checkpointer"])
        b.fit(hp["epoch_counter"], train, valid,
              train_loader_kwargs=hp["train_dataloader_opts"],
              valid_loader_kwargs=hp["valid_dataloader_opts"])
        return b

    first = brain(1)
    resumed = brain(2)
    assert [e["epoch"] for e in first.stage_ends] == [1, 1]
    assert [e["epoch"] for e in resumed.stage_ends] == [2, 2]
    want = runs["port"]["brain"].snapshots[-1]
    got = resumed.snapshots[-1]
    for name in want:
        assert sorted(got[name]) == sorted(want[name])
        for key, value in want[name].items():
            assert torch.equal(got[name][key], value), (name, key)
    ends = runs["port"]["brain"].stage_ends
    assert [e["loss"] for e in resumed.stage_ends] == \
        [e["loss"] for e in ends[2:4]]


def test_nonfinite_step_commits_the_statistics_as_jax_does(runs):
    """A finetune step whose loss is not finite (an infinite head bias,
    taken after the runs) updates no parameter, and its BatchNorm
    statistics are kept, in both packages (the JAX engine selects the new
    parameters and optimizer states by finiteness, not the model states).
    The two packages' statistics are not compared here: each evaluation
    recovered its kept checkpoint, and the port's restores the transforms'
    generator with it, so the two draw other crops for this batch."""
    for side in ("jax", "port"):
        loss, before, after, params_before, params_after = \
            runs[side]["nonfinite"]
        assert not np.isfinite(loss)
        assert all(not np.array_equal(before[k], after[k]) for k in before)
        assert sorted(params_after) == sorted(params_before)
        for key, value in params_before.items():
            np.testing.assert_array_equal(params_after[key], value,
                                          err_msg=key)


def test_dropout_training_forward_matches_jax_in_the_mean():
    """The dropouts on (the AV-HuBERT large rates: input, hidden,
    attention and activation), N training forwards of the recipe's tiny
    encoder in each package, fed the audio stream (the dropouts sit after
    the streams' fusion; the ResNet has none): the mean outputs agree
    within 5 standard errors in all but 1% of the elements, and differ
    from the dropout-free output (the packages draw other masks, so only
    their statistics can be held)."""
    from svt_speechbrain_tpu.models import avhubert as javhubert
    from svt_speechbrain_tpu_torch.convert_jax import load_module_tree
    from svt_speechbrain_tpu_torch.models.avhubert import FairseqAVHubert
    from svt_speechbrain_tpu_torch.nnet.dropout import StepRNG

    arch = dict(ARCH, dropout=0.1, attention_dropout=0.1, dropout_input=0.1,
                activation_dropout=0.1)
    trees = _seeded_trees()
    audio = np.random.default_rng(9).normal(size=(1, 12, 8)).astype(
        np.float32)
    n = 200
    jenc = javhubert.FairseqAVHubert(javhubert.AVHubertConfig(**arch))
    params = jax.tree_util.tree_map(jnp.asarray, trees["encoder"])
    state = jenc.init_state()

    @jax.jit
    def draws(keys):
        return jax.vmap(lambda k: jenc(params, state,
                                       {"audio": jnp.asarray(audio)},
                                       train=True, rng=k)[0])(keys)

    jout = np.asarray(draws(jax.random.split(jax.random.PRNGKey(0), n)))
    enc = FairseqAVHubert(arch_overrides=arch)
    load_module_tree(enc, trees["encoder"])
    rng = StepRNG(torch.Generator().manual_seed(0),
                  torch.Generator().manual_seed(1))
    src = {"audio": torch.from_numpy(audio)}
    with torch.no_grad():
        pout = np.stack([enc(src, train=True, rng=rng).numpy()
                         for _ in range(n)])
        plain = enc(src, train=True).numpy()
    se = np.sqrt(pout.var(0) / n + jout.var(0) / n) + 1e-6
    far = np.abs(pout.mean(0) - jout.mean(0)) > 5 * se
    assert far.mean() < 0.01, far.mean()
    assert pout.std(0).mean() > 1e-2 and jout.std(0).mean() > 1e-2
    assert np.abs(pout[0] - plain[0]).max() > 1e-3


# ----------------------------------- chip_smoke.py's hparams without yaml
@pytest.mark.parametrize("which", ["train", "extract"])
def test_yaml_equals_the_python_hparams_of_chip_smoke(tmp_path, monkeypatch,
                                                      which):
    """``chip_smoke.video_hparams`` builds the video recipe's objects from
    the port's yamls through the port's own reader (it was a Python copy of
    the yamls' values while the reader needed PyYAML): the same keys,
    values, classes and arguments as ``load_hyperyaml`` on the port's yamls
    with the same overrides (the encoder at a tiny width on both sides, its
    arguments compared as given)."""
    import chip_smoke
    from svt_speechbrain_tpu_torch.models import avhubert
    from tests.test_torch_engine import _describe

    class Encoder(avhubert.FairseqAVHubert):
        def __init__(self, **kwargs):
            self.given = dict(kwargs)
            super().__init__(**kwargs, arch_overrides=ARCH)

    monkeypatch.setattr(avhubert, "FairseqAVHubert", Encoder)
    monkeypatch.setattr(chip_smoke, "FairseqAVHubert", Encoder)
    overrides = dict(data_folder=str(tmp_path), number_of_epochs=2,
                     num_workers=4, linear_prob_epochs=1, split_noise=True,
                     csv_folder=str(tmp_path / "csv"))
    rel = TRAIN_YAML if which == "train" else EXTRACT_YAML
    monkeypatch.chdir(tmp_path)
    want = {}
    for i, make in enumerate((
            lambda o: load_hyperyaml(open(_yaml("port", rel)), o),
            lambda o: chip_smoke.video_hparams(extract=which == "extract",
                                               **o))):
        hp = make(dict(overrides))
        assert hp["checkpointer"].recoverables["counter"] is \
            hp["epoch_counter"]
        want[i] = _describe(hp)
    assert sorted(want[1]) == sorted(want[0])
    for key in want[0]:
        assert want[1][key] == want[0][key], key
    assert want[1]["encoder"][1]["output_norm"] == (which == "train")
