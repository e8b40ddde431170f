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
import inspect
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
    """The batches of a batch sampler, the first ``skip`` of them drawn and
    dropped (their items are never loaded). The loader sets ``skip`` back
    to 0 once its iterator holds the batches: a worker iterator asks for
    them twice as it starts."""

    def __init__(self, batches):
        self.batches = batches
        self.skip = 0

    def __iter__(self):
        return itertools.islice(iter(self.batches), self.skip, None)

    def __len__(self):
        return len(self.batches)


_LOADER_KEYS = frozenset(inspect.signature(DataLoader.__init__).parameters)


class SaveableDataLoader(DataLoader):
    """A ``DataLoader`` of ``PaddedBatch``es with a checkpointable position
    (``dataloader.py:32``): ``state_dict()`` holds the number of batches
    delivered in the epoch under way (None before the first and after the
    last), and ``load_state_dict(..., end_of_epoch=False)`` makes the next
    iteration resume after them.

    The signature is the JAX loader's: a ``batch_sampler`` gives the batches
    (and wins over ``sampler``), ``set_epoch`` reaches it, and
    ``prefetch_batches`` bounds the batches in flight across the worker
    processes (it has no effect without workers; left out, torch's own
    per-worker default stands). Keys that neither that
    loader nor ``torch.utils.data.DataLoader`` knows are dropped, as the
    JAX loader drops them.

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
    >>> [b.id for b in SaveableDataLoader(data, batch_sampler=[[3], [0, 2]])]
    [['u3'], ['u0', 'u2']]
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, sampler=None,
                 batch_sampler=None, collate_fn=None, drop_last=False,
                 num_workers=0, prefetch_batches=None, pin_memory=False,
                 pad_multiples=None, padded_keys=None, non_padded_keys=(),
                 seed=563375142, **loader_kwargs):
        if batch_sampler is None:
            if sampler is None:
                sampler = (ReproducibleRandomSampler(dataset, seed=seed)
                           if shuffle else SequentialSampler(dataset))
            batch_sampler = BatchSampler(sampler, batch_size, drop_last)
            self.item_sampler = sampler
        else:
            self.item_sampler = None
        if collate_fn is None:
            collate_fn = functools.partial(
                PaddedBatch, pad_multiples=pad_multiples,
                padded_keys=padded_keys, non_padded_keys=non_padded_keys)
        loader_kwargs = {k: v for k, v in loader_kwargs.items()
                         if k in _LOADER_KEYS}
        if num_workers > 0:
            loader_kwargs.setdefault("multiprocessing_context", "fork")
        if num_workers > 0 and prefetch_batches is not None:
            # torch counts prefetched batches per worker
            loader_kwargs.setdefault(
                "prefetch_factor",
                max(1, -(-max(prefetch_batches, 1) // num_workers)))
        super().__init__(
            dataset, batch_sampler=_SkippingBatchSampler(batch_sampler),
            collate_fn=collate_fn, num_workers=num_workers,
            pin_memory=pin_memory, **loader_kwargs)
        self._iterator_position = None

    def __iter__(self):
        skip = self.batch_sampler.skip
        batches = super().__iter__()
        self.batch_sampler.skip = 0
        return self._counted(batches, skip)

    def _counted(self, batches, skip):
        # counted before the yield: a batch the consumer holds is consumed
        # for recovery (the JAX loader's order)
        self._iterator_position = skip
        for batch in batches:
            self._iterator_position += 1
            yield batch
        self._iterator_position = None

    def state_dict(self):
        return {"iterator_position": self._iterator_position}

    def load_state_dict(self, data, end_of_epoch=True):
        pos = data.get("iterator_position")
        if pos is not None and not end_of_epoch:
            self.batch_sampler.skip = pos

    def set_epoch(self, epoch):
        target = (self.item_sampler if self.item_sampler is not None
                  else self.batch_sampler.batches)
        if hasattr(target, "set_epoch"):
            target.set_epoch(epoch)


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
