"""Port parity, the engine's parts: each against the JAX package's module on
the same inputs, on the CPU. Padded batches (data, relative lengths, with
``pad_multiples``), CSV datasets and their sorted views, sampler orders,
the loader's checkpointed position, the schedulers, the epoch counter, the
checkpointer's keep-only and recovery, the train log's text, the metric
summaries, WAV reading; then the port's own contracts: the recipe's yaml
against the Python hparams ``chip_smoke.py`` builds (the card machine need
not have PyYAML), the command line's refusals, and one process only."""
import dataclasses
import functools
import os
import time

import numpy as np
import pytest
import torch

from svt_speechbrain_tpu.dataio import batch as jbatch
from svt_speechbrain_tpu.dataio import dataio as jdataio
from svt_speechbrain_tpu.dataio import dataloader as jdataloader
from svt_speechbrain_tpu.dataio import dataset as jdataset
from svt_speechbrain_tpu.dataio import sampler as jsampler
from svt_speechbrain_tpu.nnet import losses as jlosses
from svt_speechbrain_tpu.nnet import schedulers as jschedulers
from svt_speechbrain_tpu.utils import checkpoints as jcheckpoints
from svt_speechbrain_tpu.utils import epoch_loop as jepoch_loop
from svt_speechbrain_tpu.utils import metric_stats as jmetric_stats
from svt_speechbrain_tpu.utils import train_logger as jtrain_logger

from svt_speechbrain_tpu_torch import core
from svt_speechbrain_tpu_torch.dataio import batch, dataio, dataloader, dataset
from svt_speechbrain_tpu_torch.dataio import sampler
from svt_speechbrain_tpu_torch.nnet import losses, schedulers
from svt_speechbrain_tpu_torch.parallel import distributed
from svt_speechbrain_tpu_torch.utils import (checkpoints, epoch_loop,
                                             metric_stats, train_logger)
from tests.conftest import REPO_ROOT

PORT_YAML = os.path.join(REPO_ROOT, "svt_speechbrain_tpu_torch", "recipes",
                         "MIR_ST500", "hparams", "train_audio_ssl.yaml")


def _examples(seed):
    rng = np.random.default_rng(seed)
    return [{"id": f"u{i}", "sig": rng.normal(size=n).astype(np.float32),
             "anno": rng.integers(0, 5, (n // 320 + 1, 4)),
             "ref": rng.normal(size=(i + 1, 2)), "cur": i + 1,
             "dur": float(n) / 16000, "wav": f"/x/u{i}.wav"}
            for i, n in enumerate(rng.integers(8000, 40000, 3))]


@pytest.mark.parametrize("pad_multiples", [None, {"sig": 16000, "anno": 50},
                                           {"sig": 7}])
def test_padded_batch_matches_jax(pad_multiples):
    examples = _examples(0)
    want = jbatch.PaddedBatch(examples, pad_multiples=pad_multiples)
    got = batch.PaddedBatch(examples, pad_multiples=pad_multiples)
    assert got.keys == want.keys and got.padded_keys == want.padded_keys
    for key in ("sig", "anno", "ref"):
        np.testing.assert_array_equal(getattr(got, key).data.numpy(),
                                      getattr(want, key).data)
        assert getattr(got, key).lengths.dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, key).lengths.numpy(),
                                      getattr(want, key).lengths)
    for key in ("cur", "dur"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      getattr(want, key))
    assert got.id == want.id and got.wav == want.wav
    assert sorted(got.tensors()) == sorted(want.numpy_arrays())


def _write_csv(path):
    rows = ["ID,duration,wav,spk", "a,3.0,$root/a.wav,s1", "b,1.5,$root/b.wav,s2",
            "c,3.0,$root/c.wav,s1", "d,0.5,$root/d.wav,s3", "e,1.5,$root/e.wav,s2"]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("view", [
    dict(sort_key="duration"), dict(sort_key="duration", reverse=True),
    dict(key_min_value={"duration": 1.0}, sort_key="duration"),
    dict(key_test={"spk": lambda s: s != "s2"}), dict(select_n=2)])
def test_dataset_from_csv_and_sorted_views_match_jax(tmp_path, view):
    """Stable by key: ties keep the CSV's order in both packages."""
    path = str(tmp_path / "m.csv")
    _write_csv(path)
    want = jdataset.DynamicItemDataset.from_csv(path, {"root": "/d"})
    got = dataset.DynamicItemDataset.from_csv(path, {"root": "/d"})
    assert got.data == want.data
    assert (got.filtered_sorted(**view).data_ids
            == want.filtered_sorted(**view).data_ids)


@pytest.mark.parametrize("seed,epoch", [(563375142, 0), (1986, 1), (1986, 7),
                                        (0, 3)])
def test_sampler_orders_match_jax(seed, epoch):
    want = jsampler.ReproducibleRandomSampler(range(23), seed=seed)
    got = sampler.ReproducibleRandomSampler(range(23), seed=seed)
    want.set_epoch(epoch)
    got.set_epoch(epoch)
    assert list(got) == list(want)
    assert list(sampler.SequentialSampler(range(5))) == list(
        jsampler.SequentialSampler(range(5)))


def _dynamic_dataset(module):
    data = {f"u{i}": {"n": str(i + 2)} for i in range(11)}
    ds = module.DynamicItemDataset(data)
    ds.add_dynamic_item(lambda n: np.arange(int(n), dtype=np.float32),
                        takes="n", provides="x")
    ds.set_output_keys(["id", "x"])
    return ds


@pytest.mark.parametrize("shuffle,consumed", [(False, 2), (True, 3),
                                              (True, 0)])
def test_loader_resume_position_matches_jax(shuffle, consumed):
    """Batches consumed, the saved position, the batches after a mid-epoch
    recovery and after an end-of-epoch one, in both packages."""
    kw = dict(batch_size=3, shuffle=shuffle, seed=7)
    runs = {}
    for name, dl_mod, ds_mod in (("jax", jdataloader, jdataset),
                                 ("port", dataloader, dataset)):
        loader = dl_mod.SaveableDataLoader(_dynamic_dataset(ds_mod), **kw)
        it = iter(loader)
        first = [next(it).id for _ in range(consumed)]
        state = loader.state_dict()
        mid = dl_mod.SaveableDataLoader(_dynamic_dataset(ds_mod), **kw)
        mid.load_state_dict(state, end_of_epoch=False)
        rest = [b.id for b in mid]
        after = mid.state_dict()
        end = dl_mod.SaveableDataLoader(_dynamic_dataset(ds_mod), **kw)
        end.load_state_dict(state, end_of_epoch=True)
        runs[name] = (first, state, rest, after, [b.id for b in end])
    assert runs["port"] == runs["jax"]
    first, state, rest, after, full = runs["port"]
    assert state == {"iterator_position": consumed or None} and after == {
        "iterator_position": None}
    assert first + rest == full and len(full) == 4


_SCHEDULES = {
    "newbob": (lambda m: m.NewBobScheduler(1.0, annealing_factor=0.8),
               [10.0, 9.0, 8.99, 9.5, 7.0, 7.0, 6.999]),
    "newbob_patient": (lambda m: m.NewBobScheduler(
        0.5, annealing_factor=0.9, improvement_threshold=0.01, patient=1),
        [4.0, 3.99, 3.98, 3.97, 2.0, 2.0, 1.999, 1.998]),
    "linear": (lambda m: m.LinearScheduler(1.0, 0.1, 5), [1, 2, 3, 4, 5, 6]),
    "step": (lambda m: m.StepScheduler(0.1, 0.5, 2), [1, 2, 3, 4, 5]),
    "noam": (lambda m: m.NoamScheduler(0.002, 4, model_size=256),
             [None] * 9),
    "cyclic_cosine": (lambda m: m.CyclicCosineScheduler(3, 0.01, 20),
                      [None] * 9),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedulers_match_jax(name):
    make, inputs = _SCHEDULES[name]
    want, got = make(jschedulers), make(schedulers)
    for x in inputs:
        args = () if x is None else (x,)
        assert got(*args) == want(*args)
    assert got.state_dict() == want.state_dict()


def test_plateau_and_cyclic_lr_match_jax():
    want, got = (m.ReduceLROnPlateau(patience=1, dont_halve_until_epoch=2)
                 for m in (jschedulers, schedulers))
    lr_w = lr_g = 1.0
    for epoch, loss in enumerate([5.0, 4.0, 4.5, 4.6, 4.7, 3.0, 3.5], 1):
        _, lr_w = want(lr_w, epoch, loss)
        _, lr_g = got(lr_g, epoch, loss)
        assert lr_g == lr_w
    want, got = (m.CyclicLRScheduler(step_size=3, mode="triangular2")
                 for m in (jschedulers, schedulers))
    assert [got.on_batch_end() for _ in range(13)] == [
        want.on_batch_end() for _ in range(13)]


def test_update_learning_rate_sets_every_optimizer():
    brain = core.Brain({"a": torch.nn.Linear(2, 2), "b": torch.nn.Linear(2, 2)},
                       run_opts={"device": "cpu"})
    for name in ("a", "b"):
        brain.add_optimizer(name, torch.optim.SGD, [name], lr=0.1)
    schedulers.update_learning_rate(brain, 0.25, "a")
    assert brain.get_learning_rate("a") == 0.25
    assert brain.get_learning_rate("b") == 0.1
    schedulers.update_learning_rate(brain, 0.5)
    assert [brain.get_learning_rate(n) for n in "ab"] == [0.5, 0.5]


@pytest.mark.parametrize("end_of_epoch", [True, False])
def test_epoch_counter_matches_jax(end_of_epoch):
    runs = []
    for module in (jepoch_loop, epoch_loop):
        counter = module.EpochCounter(4)
        seen = [next(counter), next(counter)]
        state = counter.state_dict()
        fresh = module.EpochCounter(4)
        fresh.load_state_dict(state, end_of_epoch=end_of_epoch)
        runs.append((seen, state, list(fresh)))
    assert runs[0] == runs[1]


def _checkpointing(module, counter_module, folder, plan):
    """Saves by ``plan`` [(meta, keep-only kwargs)], then the kept metas
    (loss-like keys only) and the counter recovered by min and by max."""
    counter = counter_module.EpochCounter(100)
    ckptr = module.Checkpointer(folder, recoverables={"counter": counter})
    for i, (meta, keep) in enumerate(plan):
        counter.current = i + 1
        ckptr.save_and_keep_only(meta=meta, **keep)
        time.sleep(0.002)   # distinct unixtime, as between epochs
    kept = sorted(tuple(sorted((k, v) for k, v in c.meta.items()
                               if k not in ("unixtime",)))
                  for c in ckptr.list_checkpoints())
    recovered = {}
    for key in ("min_key", "max_key"):
        counter.current = 0
        ckpt = ckptr.recover_if_possible(**{key: "loss"})
        recovered[key] = counter.current if ckpt else None
    counter.current = 0
    ckptr.recover_if_possible()
    recovered["newest"] = counter.current
    return kept, recovered, sorted(os.listdir(folder))


@pytest.mark.parametrize("plan", [
    [({"loss": v}, {"min_keys": ["loss"]}) for v in (3.0, 2.0, 2.5, 1.0, 4.0)],
    [({"loss": v}, {"max_keys": ["loss"], "num_to_keep": 2})
     for v in (3.0, 2.0, 2.5, 1.0, 4.0)],
    [({"loss": 2.0}, {"min_keys": ["loss"]}),
     ({"intra": True}, {"end_of_epoch": False,
                        "ckpt_predicate": lambda c: "intra" in c.meta}),
     ({"intra": True}, {"end_of_epoch": False,
                        "ckpt_predicate": lambda c: "intra" in c.meta}),
     ({"loss": 1.5}, {"min_keys": ["loss"]})],
], ids=["min_loss", "max_loss_keep_2", "intra_epoch"])
def test_checkpointer_keep_only_and_recovery_match_jax(tmp_path, plan):
    want = _checkpointing(jcheckpoints, jepoch_loop, tmp_path / "jax", plan)
    got = _checkpointing(checkpoints, epoch_loop, tmp_path / "port", plan)
    assert got[:2] == want[:2]
    assert [n.split("+")[0] for n in got[2]] == [n.split("+")[0]
                                                 for n in want[2]]
    metas = [os.listdir(tmp_path / "port" / n) for n in got[2]]
    assert all(sorted(m) == ["CKPT.json", "counter.ckpt"] for m in metas)


def test_checkpointer_keeps_modules_optimizers_and_handles(tmp_path):
    """Modules and optimizers through their state dicts, a ``PytreeHandle``,
    hook-registered objects, and ``average_checkpoints``."""
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(lin.parameters(), lr=0.1)
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    store = {"t": torch.arange(3.0)}
    ckptr = checkpoints.Checkpointer(tmp_path, {
        "lin": lin, "opt": opt, "h": checkpoints.PytreeHandle(
            get=lambda: dict(store), set=store.update)})
    first = ckptr.save_checkpoint(meta={"loss": 1.0})
    saved = {k: v.clone() for k, v in lin.state_dict().items()}
    opt.step()
    with torch.no_grad():
        lin.weight.add_(1.0)
    store["t"] = torch.zeros(3)
    second = ckptr.save_checkpoint(meta={"loss": 2.0})
    second_weight = lin.weight.detach().clone()
    ckptr.recover_if_possible(min_key="loss")
    assert all(torch.equal(v, saved[k]) for k, v in lin.state_dict().items())
    assert torch.equal(store["t"], torch.arange(3.0))
    assert int(opt.state_dict()["state"][0]["step"]) == 1
    avg = checkpoints.average_checkpoints([first, second], "lin")
    assert torch.allclose(avg["weight"], (saved["weight"] + second_weight) / 2)


@pytest.mark.parametrize("precision", [2, 3])
def test_file_train_logger_matches_jax_byte_for_byte(tmp_path, precision):
    stats = [({"epoch": 1, "lr_wav2vec": 5e-05, "lr_model": 0.0003},
              {"loss": 7.245634}, {"loss": 7.333, "onset_loss": 1.8831,
                                   "offset_loss": 0.7839, "COn_f1": 0.0,
                                   "COnP_f1": np.float64(0.193)}, None),
              ({"Epoch loaded": 2}, None, None,
               {"loss": 123.5, "COn_f1": 1.0, "note": "x"})]
    texts = []
    for module, name in ((jtrain_logger, "jax"), (train_logger, "port")):
        tl = module.FileTrainLogger(str(tmp_path / name), precision=precision)
        for meta, tr, va, te in stats:
            tl.log_stats(meta, train_stats=tr, valid_stats=va, test_stats=te,
                         verbose=False)
        texts.append((tmp_path / name).read_bytes())
    assert texts[0] == texts[1] and texts[1].count(b"\n") == 2


def test_metric_stats_summaries_match_jax():
    """The recipe's onset statistics: ``bce_loss`` with reduction batch and
    ``pos_weight``, per utterance, over ragged lengths."""
    rng = np.random.default_rng(3)
    j = jmetric_stats.MetricStats(metric=functools.partial(
        jlosses.bce_loss, reduction="batch", allowed_len_diff=60))
    p = metric_stats.MetricStats(metric=functools.partial(
        losses.bce_loss, reduction="batch", allowed_len_diff=60))
    for step in range(4):
        logits = rng.normal(size=(2, 250)).astype(np.float32)
        target = (rng.random((2, 300)) < 0.1).astype(np.float32)
        lens = np.asarray([1.0, 0.6 + 0.1 * step], np.float32)
        ids = [f"s{step}a", f"s{step}b"]
        j.append(ids, logits, target, length=lens, pos_weight=15.0)
        p.append(ids, torch.from_numpy(logits), torch.from_numpy(target),
                 length=torch.from_numpy(lens), pos_weight=15.0)
    want, got = j.summarize(), p.summarize()
    assert {k: got[k] for k in ("min_id", "max_id")} == {
        k: want[k] for k in ("min_id", "max_id")}
    for key in ("average", "min_score", "max_score"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_read_and_write_audio_match_jax(tmp_path, monkeypatch):
    """The scipy reader of both packages gives the same float32 samples
    (int16 / 32768); the port's writer gives the JAX writer's file."""
    monkeypatch.setenv("SVT_NATIVE", "0")
    wav = np.random.default_rng(0).uniform(-1.2, 1.2, 3001).astype(np.float32)
    jdataio.write_audio(str(tmp_path / "j.wav"), wav, 16000)
    dataio.write_audio(str(tmp_path / "p.wav"), wav, 16000)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "p.wav").read_bytes()
    got = dataio.read_audio(str(tmp_path / "p.wav"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jdataio.read_audio(str(tmp_path / "p.wav")))
    np.testing.assert_array_equal(
        dataio.read_audio({"file": str(tmp_path / "p.wav"), "start": 10,
                           "stop": 20}), got[10:20])
    assert dataio.read_audio_info(str(tmp_path / "p.wav")) == (3001, 16000, 1)


def _describe(x):
    """A comparable description of a hparams value: plain values as they
    are, partials by function and arguments, objects by type and fields
    (modules also by parameter shapes)."""
    if isinstance(x, (str, int, float, bool, type(None))):
        return x
    if isinstance(x, dict):
        return {k: _describe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_describe(v) for v in x]
    if isinstance(x, functools.partial):
        return ("partial", _describe(x.func), _describe(x.args),
                _describe(x.keywords))
    if callable(x) and hasattr(x, "__qualname__"):
        return (x.__module__, x.__qualname__)
    if dataclasses.is_dataclass(x):
        return _describe(dataclasses.asdict(x))
    fields = {k: _describe(v) for k, v in vars(x).items()
              if not k.startswith("_") and not isinstance(v, torch.Tensor)}
    if isinstance(x, torch.nn.Module):
        fields["params"] = [(n, tuple(p.shape))
                            for n, p in x.named_parameters()]
    return (type(x).__qualname__, fields)


def test_yaml_equals_the_python_hparams_of_chip_smoke(tmp_path, monkeypatch):
    """``chip_smoke.recipe_hparams`` builds the recipe's objects from the
    recipe's yaml through the port's own reader (it was a Python copy of the
    yaml's values while the reader needed PyYAML): the same keys, values,
    classes and arguments as ``load_hyperyaml`` on the recipe's yaml, with
    the same overrides. The wav2vec2 bridge is built at TINY width on both
    sides (its arguments are compared as given)."""
    import chip_smoke
    from svt_speechbrain_tpu_torch.config import load_hyperyaml
    from svt_speechbrain_tpu_torch.models import wav2vec2

    class Bridge(wav2vec2.HuggingFaceWav2Vec2):
        def __init__(self, **kwargs):
            self.given = dict(kwargs)
            super().__init__(**kwargs, arch_overrides=wav2vec2.TINY_ARCH)

    monkeypatch.setattr(wav2vec2, "HuggingFaceWav2Vec2", Bridge)
    monkeypatch.setattr(chip_smoke, "HuggingFaceWav2Vec2", Bridge)
    overrides = dict(data_folder=str(tmp_path), number_of_epochs=2,
                     linear_prob_epochs=1, num_workers=4,
                     train_csv=str(tmp_path / "train.csv"),
                     test_csv=[str(tmp_path / "test.csv")])
    want = {}
    for i, build in enumerate((
            lambda o: load_hyperyaml(open(PORT_YAML), o),
            lambda o: chip_smoke.recipe_hparams(**o))):
        # each side gets its own output folder (its checkpointer makes it)
        hp = build(dict(overrides, output_folder=str(tmp_path / "out")))
        assert hp["modules"]["wav2vec2"] is hp["wav2vec2"]
        assert hp["checkpointer"].recoverables["counter"] is \
            hp["epoch_counter"]
        assert hp["checkpointer"].recoverables["scheduler_model"] is \
            hp["lr_annealing_model"]
        want[i] = _describe(hp)
    assert list(want[1]) == list(want[0])
    for key in want[0]:
        assert want[1][key] == want[0][key], key


@pytest.mark.parametrize("argv,message", [
    (["--fsdp"], None), (["--jit_module_keys", "wav2vec2"], "jit"),
    (["--distributed_backend", "ici"], "ici"),
    (["--data_parallel_count", "4"], "torchrun --nproc_per_node 4")])
def test_command_line_refuses_the_tpu_flags(argv, message, capsys,
                                            monkeypatch):
    """The XLA and TPU-interconnect flags are refused; ``--fsdp`` parses
    into the run options; a data-parallel count without a launch of that
    many processes names ``torchrun``."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if message is None:
        _, run_opts, _ = core.parse_arguments(["h.yaml"] + argv)
        assert run_opts["fsdp"] is True
        return
    with pytest.raises(SystemExit):
        core.parse_arguments(["h.yaml"] + argv)
    assert message in capsys.readouterr().err


def test_command_line_defaults_to_cuda_and_passes_overrides():
    param_file, run_opts, overrides = core.parse_arguments(
        ["h.yaml", "--noprogressbar", "--auto_mix_prec", "--data_folder=/d",
         "--lr", "0.5"])
    assert param_file == "h.yaml" and run_opts["device"] == "cuda"
    assert run_opts["precision"] == "bf16" and run_opts["noprogressbar"]
    assert overrides == "data_folder: /d\nlr: 0.5"


def test_one_process_only(monkeypatch):
    """One process needs no group; a launch of two whose group cannot be
    set up (no ``MASTER_ADDR``) raises the init error instead of training
    one process on its part of the data."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.ddp_init_group({}) is None
    assert distributed.if_main_process()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="gloo process group failed"):
        distributed.ddp_init_group({"distributed_launch": True,
                                    "device": "cpu"})
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_evaluate_batch_brings_predictions_home_in_one_copy():
    """Floating predictions and the loss come back as numpy from one
    concatenated copy, in their shapes; other values as they are."""
    preds = (torch.randn(1, 5), torch.randn(1, 5, 3).to(torch.bfloat16),
             torch.arange(4), "tag")
    got, loss = core._to_host(preds, torch.tensor(2.5))
    assert loss == 2.5 and got[3] == "tag"
    np.testing.assert_array_equal(got[0], preds[0].numpy())
    np.testing.assert_array_equal(got[1], preds[1].float().numpy())
    np.testing.assert_array_equal(got[2], np.arange(4))
