"""Data loaders (port of ``svt_speechbrain_tpu/dataio/dataloader.py``).

``SaveableDataLoader`` is a ``torch.utils.data.DataLoader`` that collates
``PaddedBatch``es (with ``pad_multiples``) in worker processes, as
SpeechBrain's loader does, and whose position in the epoch is
checkpointable: after a mid-epoch recovery the next epoch's iteration
fast-forwards the sampler past the batches already consumed, without
loading them (``dataloader.py:149-162``).

Worker processes are forked: the recipes' pipelines are closures, which a
spawned worker could not unpickle. Workers read files and pad arrays on the
CPU and never touch CUDA; the loader pins batches in the parent process.
"""
from __future__ import annotations

import functools
import itertools

from torch.utils.data import BatchSampler, DataLoader, Sampler

from svt_speechbrain_tpu_torch.dataio.batch import PaddedBatch
from svt_speechbrain_tpu_torch.dataio.sampler import (
    ReproducibleRandomSampler, SequentialSampler)


def make_dataloader(dataset, looped_nominal_epoch=None, **loader_kwargs):
    """``SaveableDataLoader(dataset, **loader_kwargs)``, or a ``LoopedLoader``
    over it with ``looped_nominal_epoch`` batches an epoch
    (``dataloader.py:23``)."""
    if looped_nominal_epoch is not None:
        return LoopedLoader(make_dataloader(dataset, **loader_kwargs),
                            looped_nominal_epoch)
    return SaveableDataLoader(dataset, **loader_kwargs)


class _SkippingBatchSampler(Sampler):
    """Batches of a sampler; the first ``skip`` batches of the next
    iteration are drawn and dropped (their items are never loaded)."""

    def __init__(self, sampler, batch_size, drop_last):
        self.batches = BatchSampler(sampler, batch_size, drop_last)
        self.skip = 0

    def __iter__(self):
        skip, self.skip = self.skip, 0
        return itertools.islice(iter(self.batches), skip, None)

    def __len__(self):
        return len(self.batches)


class SaveableDataLoader(DataLoader):
    """A ``DataLoader`` of ``PaddedBatch``es with a checkpointable position
    (``dataloader.py:32``): ``state_dict()`` holds the number of batches
    delivered in the epoch under way (None between epochs), and
    ``load_state_dict(..., end_of_epoch=False)`` makes the next iteration
    resume after them.

    Example
    -------
    >>> import numpy as np
    >>> data = [{"id": f"u{i}", "x": np.arange(i + 1, dtype=np.float32)}
    ...         for i in range(4)]
    >>> dl = SaveableDataLoader(data, batch_size=2)
    >>> batch = next(iter(dl))
    >>> batch.id, tuple(batch.x.data.shape)      # padded to the longest row
    (['u0', 'u1'], (2, 2))
    >>> dl.state_dict()
    {'iterator_position': 1}
    >>> resumed = SaveableDataLoader(data, batch_size=2)
    >>> resumed.load_state_dict(dl.state_dict(), end_of_epoch=False)
    >>> [b.id for b in resumed]                   # skips the consumed batch
    [['u2', 'u3']]
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, sampler=None,
                 collate_fn=None, drop_last=False, num_workers=0,
                 pin_memory=False, pad_multiples=None, padded_keys=None,
                 non_padded_keys=(), seed=563375142, **loader_kwargs):
        if sampler is None:
            sampler = (ReproducibleRandomSampler(dataset, seed=seed)
                       if shuffle else SequentialSampler(dataset))
        if collate_fn is None:
            collate_fn = functools.partial(
                PaddedBatch, pad_multiples=pad_multiples,
                padded_keys=padded_keys, non_padded_keys=non_padded_keys)
        if num_workers > 0:
            loader_kwargs.setdefault("multiprocessing_context", "fork")
        super().__init__(
            dataset, batch_sampler=_SkippingBatchSampler(
                sampler, batch_size, drop_last),
            collate_fn=collate_fn, num_workers=num_workers,
            pin_memory=pin_memory, **loader_kwargs)
        self.item_sampler = sampler
        self._iterator = None
        self._skipped = 0

    def __iter__(self):
        self._skipped = self.batch_sampler.skip
        self._iterator = super().__iter__()
        return self._iterator

    def _position(self):
        if self._iterator is None:
            return None
        pos = self._skipped + self._iterator._num_yielded
        return pos if 0 < pos < len(self) else None

    def state_dict(self):
        return {"iterator_position": self._position()}

    def load_state_dict(self, data, end_of_epoch=True):
        pos = data.get("iterator_position")
        if pos is not None and not end_of_epoch:
            self.batch_sampler.skip = pos

    def set_epoch(self, epoch):
        if hasattr(self.item_sampler, "set_epoch"):
            self.item_sampler.set_epoch(epoch)


class LoopedLoader:
    """Loop an underlying loader to nominal epochs of ``epoch_length``
    batches (``dataloader.py:164``)."""

    def __init__(self, loader, epoch_length, batchsize_fn=None):
        self.loader = loader
        self.iterator = None
        self.epoch_length = epoch_length
        self.step = 0
        self.total_steps = 0
        self.total_samples = 0
        self.batchsize_fn = batchsize_fn or (lambda b: len(b))

    def __iter__(self):
        if self.iterator is None:
            self.iterator = iter(self.loader)
        return self

    def __next__(self):
        if self.step >= self.epoch_length:
            self.step = 0
            raise StopIteration
        self.step += 1
        self.total_steps += 1
        try:
            batch = next(self.iterator)
        except StopIteration:
            self.iterator = iter(self.loader)
            batch = next(self.iterator)
        self.total_samples += self.batchsize_fn(batch)
        return batch

    def __len__(self):
        return self.epoch_length

    def state_dict(self):
        return {"step": self.step, "total_steps": self.total_steps,
                "total_samples": self.total_samples}

    def load_state_dict(self, data, end_of_epoch=True):
        self.step = data["step"]
        self.total_steps = data["total_steps"]
        self.total_samples = data["total_samples"]
        if self.step == 0 and end_of_epoch:
            self.step = self.epoch_length
