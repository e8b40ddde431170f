"""Port parity, two engine places no other test drove: ``LoopedLoader``
(nominal epochs over a loader that wraps around, its counters and its
checkpointed position) and the ``Brain``'s debug mode (``debug``,
``debug_batches``, ``debug_epochs`` in ``fit`` and ``evaluate``), each
against the JAX package's: the same batches in the same order, the same
counters and losses."""
import numpy as np
import pytest

from svt_speechbrain_tpu.core import Brain as JBrain
from svt_speechbrain_tpu.dataio import dataloader as jdl
from svt_speechbrain_tpu.utils.epoch_loop import EpochCounter as JEpochs

from svt_speechbrain_tpu_torch.core import Brain as TBrain
from svt_speechbrain_tpu_torch.core import parse_arguments
from svt_speechbrain_tpu_torch.dataio import dataloader as tdl
from svt_speechbrain_tpu_torch.utils.epoch_loop import EpochCounter as TEpochs

DATA = [{"id": f"u{i}", "x": np.arange(i + 1, dtype=np.float32)}
        for i in range(10)]


def _ids(loader, epochs):
    return [[tuple(b.id) for b in loader] for _ in range(epochs)]


@pytest.mark.parametrize("shuffle", [False, True])
def test_looped_loader_wraps_and_counts(shuffle):
    kw = dict(batch_size=3, shuffle=shuffle)
    jl = jdl.make_dataloader(DATA, looped_nominal_epoch=5, **kw)
    tl = tdl.make_dataloader(DATA, looped_nominal_epoch=5, **kw)
    assert isinstance(tl, tdl.LoopedLoader) and len(tl) == len(jl) == 5
    want, got = _ids(jl, 3), _ids(tl, 3)
    assert got == want
    assert [len(e) for e in got] == [5, 5, 5]
    # the wrap: 4 batches an underlying epoch (3, 3, 3, 1 rows)
    assert got[0][4] == got[0][0]
    # 15 batches: three rounds of (3, 3, 3, 1) rows and three of 3
    assert tl.state_dict() == jl.state_dict() == {
        "step": 0, "total_steps": 15, "total_samples": 3 * 10 + 9}


def test_looped_loader_resumes_from_its_state():
    loaders = {}
    for name, mod in (("jax", jdl), ("port", tdl)):
        loader = mod.make_dataloader(DATA, looped_nominal_epoch=4,
                                     batch_size=2)
        it = iter(loader)
        first = [tuple(next(it).id) for _ in range(3)]
        state = loader.state_dict()
        mid = mod.make_dataloader(DATA, looped_nominal_epoch=4, batch_size=2)
        mid.load_state_dict(state, end_of_epoch=False)
        done = mod.make_dataloader(DATA, looped_nominal_epoch=4,
                                   batch_size=2)
        done.load_state_dict(dict(state, step=0), end_of_epoch=True)
        loaders[name] = (first, state, [tuple(b.id) for b in mid],
                         mid.state_dict(), [tuple(b.id) for b in done],
                         done.state_dict())
    assert loaders["port"] == loaders["jax"]
    first, state, rest, after, empty, _ = loaders["port"]
    assert state == {"step": 3, "total_steps": 3, "total_samples": 6}
    # the step resumes, the underlying loader starts afresh, as the JAX one
    assert len(rest) == 1 and after["total_steps"] == 4 and empty == []


def _recording(base):
    class Recording(base):
        def fit_batch(self, batch):
            self.log.append(("train", tuple(batch.id)))
            return float(len(batch.id))

        def evaluate_batch(self, batch, stage):
            self.log.append((stage.name, tuple(batch.id)))
            return float(batch.x.data.shape[1])

    return Recording


def _run(base, epochs, run_opts, hparams=None, looped=None):
    brain = _recording(base)(modules={}, hparams=hparams,
                             run_opts=dict(run_opts, noprogressbar=True,
                                           device="cpu"))
    brain.log = []
    train = DATA
    if looped is not None:
        mod = jdl if base is JBrain else tdl
        train = mod.make_dataloader(DATA, looped_nominal_epoch=looped,
                                    batch_size=2)
    brain.fit(epochs(5), train, DATA[:6],
              train_loader_kwargs={"batch_size": 2},
              valid_loader_kwargs={"batch_size": 2})
    test_loss = brain.evaluate(DATA, test_loader_kwargs={"batch_size": 3})
    return brain.log, brain.train_loss, test_loss, brain.step


@pytest.mark.parametrize("opts", [
    dict(debug=True, debug_batches=2, debug_epochs=2),
    dict(debug=True, debug_batches=1, debug_epochs=3),
    dict(debug=True, debug_batches=50, debug_epochs=1),
    dict(debug=False, debug_batches=1, debug_epochs=1)])
def test_debug_mode_matches_the_jax_brain(opts):
    got = _run(TBrain, TEpochs, opts)
    want = _run(JBrain, JEpochs, opts)
    assert got == want
    log = got[0]
    n_train = sum(1 for kind, _ in log if kind == "train")
    n_test = sum(1 for kind, _ in log if kind == "TEST")
    if opts["debug"]:
        epochs = opts["debug_epochs"]
        assert n_train == epochs * min(opts["debug_batches"], 5)
        assert n_test == min(opts["debug_batches"], 4)
    else:
        assert n_train == 5 * 5 and n_test == 4


def test_debug_mode_from_hparams_and_the_command_line():
    opts = dict(debug=True, debug_batches=1, debug_epochs=2)
    got = _run(TBrain, TEpochs, {}, hparams=opts)
    assert got == _run(JBrain, JEpochs, {}, hparams=opts)
    assert sum(1 for kind, _ in got[0] if kind == "train") == 2
    _, run_opts, _ = parse_arguments(["hp.yaml", "--debug",
                                      "--debug_batches=3",
                                      "--debug_epochs=1"])
    assert (run_opts["debug"], run_opts["debug_batches"],
            run_opts["debug_epochs"]) == (True, 3, 1)


def test_debug_mode_over_a_looped_loader():
    opts = dict(debug=True, debug_batches=3, debug_epochs=2)
    got = _run(TBrain, TEpochs, opts, looped=7)
    assert got == _run(JBrain, JEpochs, opts, looped=7)
    train = [ids for kind, ids in got[0] if kind == "train"]
    # the looped loader carries on where the debug break left it
    assert len(train) == 6 and train[3] == ("u6", "u7")
