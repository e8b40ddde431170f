"""Port parity of ``SaveableDataLoader`` over a ``batch_sampler``: the
batches of both packages' loaders over ``DynamicBatchSampler`` and
``ConcatDatasetBatchSampler`` for two epochs with ``set_epoch``, the saved
position after every batch (the last one included), a mid-epoch recovery
(with worker processes too), ``prefetch_batches``, an unknown key dropped,
and ``Brain.make_dataloader`` with a ``batch_sampler``. Exact equality."""
import numpy as np
import pytest
import torch

from svt_speechbrain_tpu.dataio import dataloader as jdataloader
from svt_speechbrain_tpu.dataio import sampler as jsampler

from svt_speechbrain_tpu_torch.core import Brain, Stage
from svt_speechbrain_tpu_torch.dataio import dataloader, sampler

PACKAGES = (("jax", jdataloader, jsampler), ("port", dataloader, sampler))


def _data(n=6):
    return [{"id": f"u{i}", "x": np.arange(i + 1, dtype=np.float32)}
            for i in range(n)]


def _dynamic(mod, n=6, shuffle=False, **kw):
    return mod.DynamicBatchSampler(_data(n), n, num_buckets=2,
                                   lengths_list=list(range(1, n + 1)),
                                   shuffle=shuffle, **kw)


def _concat(mod):
    samplers = [mod.ReproducibleRandomSampler(range(n), seed=s)
                for n, s in ((4, 1), (3, 2))]
    return mod.ConcatDatasetBatchSampler(samplers, [2, 1])


def _epochs(loader, epochs=(0, 1)):
    """Per epoch: the ids of each batch and the state after each, then the
    state after the iteration ends."""
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        rows = []
        for batch in loader:
            rows.append((batch.id, loader.state_dict()))
        out.append((rows, loader.state_dict(), len(loader)))
    return out


def test_dynamic_batch_sampler_batches_as_the_jax_loader():
    got = {}
    for name, mod, smod in PACKAGES:
        loader = mod.SaveableDataLoader(_data(),
                                        batch_sampler=_dynamic(smod))
        got[name] = [[b.id for b in loader]]
    assert got["port"] == got["jax"] == [[["u5"], ["u3", "u4"],
                                          ["u0", "u1", "u2"]]]


@pytest.mark.parametrize("make,n", [
    (lambda mod: _dynamic(mod, 11, shuffle=True, max_batch_ex=3), 11),
    (_concat, 7)])
def test_two_epochs_and_every_state_match_jax(make, n):
    got = {}
    for name, mod, smod in PACKAGES:
        loader = mod.SaveableDataLoader(_data(n), batch_sampler=make(smod))
        got[name] = _epochs(loader)
    assert got["port"] == got["jax"]
    rows, end, length = got["port"][0]
    assert [s["iterator_position"] for _, s in rows] == list(
        range(1, length + 1))
    assert end == {"iterator_position": None}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("consumed", [1, 2])
def test_mid_epoch_recovery_matches_jax(workers, consumed):
    """The batches after a mid-epoch recovery, the consumed ones never
    loaded again, and the epoch after it, in both packages."""
    got = {}
    for name, mod, smod in PACKAGES:
        kw = dict(shuffle=True, max_batch_ex=3)
        loader = mod.SaveableDataLoader(_data(11),
                                        batch_sampler=_dynamic(smod, 11,
                                                               **kw))
        loader.set_epoch(1)
        it = iter(loader)
        first = [next(it).id for _ in range(consumed)]
        state = loader.state_dict()
        extra = {"num_workers": workers} if name == "port" else {}
        fresh = mod.SaveableDataLoader(
            _data(11), batch_sampler=_dynamic(smod, 11, **kw),
            prefetch_batches=4, **extra)
        fresh.load_state_dict(state, end_of_epoch=False)
        fresh.set_epoch(1)
        rest = [(b.id, fresh.state_dict()) for b in fresh]
        fresh.set_epoch(2)
        after = [b.id for b in fresh]
        got[name] = (first, state, rest, after)
    assert got["port"] == got["jax"]


def test_prefetch_batches_and_unknown_keys():
    """``prefetch_batches`` is accepted and bounds the batches in flight
    across the workers; a key neither loader knows is dropped, as the JAX
    loader drops it; ``batch_sampler`` wins over ``sampler``."""
    got = {}
    for name, mod, smod in PACKAGES:
        loader = mod.SaveableDataLoader(
            _data(), batch_size=2, prefetch_batches=4, bogus=1,
            sampler=smod.SequentialSampler(range(6)),
            batch_sampler=[[4], [1, 0]])
        got[name] = [b.id for b in loader]
    assert got["port"] == got["jax"] == [["u4"], ["u1", "u0"]]
    assert dataloader.SaveableDataLoader(
        _data(), num_workers=2, prefetch_batches=5).prefetch_factor == 3
    assert dataloader.SaveableDataLoader(
        _data(), num_workers=4, prefetch_batches=2).prefetch_factor == 1
    # left out, torch's per-worker default stands
    assert dataloader.SaveableDataLoader(
        _data(), num_workers=4).prefetch_factor == 2
    with_workers = dataloader.SaveableDataLoader(
        _data(), batch_size=2, num_workers=2, prefetch_batches=4, bogus=1)
    assert [b.id for b in with_workers] == [["u0", "u1"], ["u2", "u3"],
                                            ["u4", "u5"]]


class _Plain(Brain):
    def compute_forward(self, batch, stage, rng=None):
        return batch["x"].data.sum()

    def compute_objectives(self, predictions, batch, stage):
        return predictions


def test_brain_make_dataloader_takes_a_batch_sampler(tmp_path):
    """No sampler is installed beside a train ``batch_sampler``; the loader
    gives its batches, registers with the checkpointer, and ``fit``'s
    ``set_epoch`` reaches the sampler (it reaches the JAX loader through
    ``set_epoch``)."""
    from svt_speechbrain_tpu_torch.utils.checkpoints import Checkpointer

    ckpt = Checkpointer(str(tmp_path))
    brain = _Plain({"m": torch.nn.Linear(1, 1)}, run_opts={"device": "cpu"},
                   checkpointer=ckpt)
    batches = _dynamic(sampler, 11, shuffle=True, max_batch_ex=3)
    loader = brain.make_dataloader(_data(11), Stage.TRAIN,
                                   batch_sampler=batches, shuffle=True,
                                   num_workers=0, prefetch_batches=4)
    assert brain.train_sampler is batches
    assert loader.item_sampler is None
    assert "dataloader-TRAIN" in ckpt.recoverables
    want = jdataloader.SaveableDataLoader(
        _data(11), batch_sampler=_dynamic(jsampler, 11, shuffle=True,
                                          max_batch_ex=3))
    for epoch in (1, 2):
        brain.train_sampler.set_epoch(epoch)
        want.set_epoch(epoch)
        assert [b.id for b in loader] == [b.id for b in want]
