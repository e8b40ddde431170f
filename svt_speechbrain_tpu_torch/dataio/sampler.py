"""Samplers (port of ``svt_speechbrain_tpu/dataio/sampler.py:15-233``).

They are ``torch.utils.data.Sampler``s that draw with numpy exactly as the
JAX package's do, so an order is the same in both packages for the same
seed and epoch. ``DistributedSamplerWrapper`` gives each rank of a
``torch.distributed`` process group its part of any sampler's stream.
"""
from __future__ import annotations

import numpy as np
from torch.utils.data import Sampler


class ReproducibleRandomSampler(Sampler):
    """Seeded random permutation, re-drawn per epoch through ``set_epoch``
    (``sampler.py:15``): the order of epoch e is
    ``default_rng(seed + e).permutation(n)``.

    Example
    -------
    >>> sampler = ReproducibleRandomSampler(range(5), seed=42)
    >>> order_a = list(sampler)
    >>> list(sampler) == order_a, sorted(order_a)
    (True, [0, 1, 2, 3, 4])
    >>> sampler.set_epoch(1)
    >>> list(sampler) == order_a
    False
    """

    def __init__(self, data_source, seed=563375142, epoch=0):
        if isinstance(seed, bool):
            raise ValueError("The reproducibility seed cannot be a boolean.")
        self.data_source = data_source
        self.seed = int(seed)
        self.epoch = epoch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        return iter(rng.permutation(len(self.data_source)).tolist())

    def __len__(self):
        return len(self.data_source)


class ReproducibleWeightedRandomSampler(Sampler):
    """Seeded weighted sampling, with replacement by default
    (``sampler.py:49``): epoch e draws ``default_rng(seed + e).choice``.

    Example
    -------
    >>> sampler = ReproducibleWeightedRandomSampler([0.0, 1.0, 3.0], 6,
    ...                                             seed=0)
    >>> order = list(sampler)
    >>> len(order), 0 in order, list(sampler) == order
    (6, False, True)
    """

    def __init__(self, weights, num_samples, replacement=True,
                 seed=129491412, epoch=0):
        if isinstance(seed, bool):
            raise ValueError("The reproducibility seed cannot be a boolean.")
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.seed = int(seed)
        self.epoch = epoch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        p = self.weights / self.weights.sum()
        idx = rng.choice(len(self.weights), size=self.num_samples,
                         replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SequentialSampler(Sampler):
    """Indices in dataset order (``sampler.py:75``); evaluation keeps songs in
    order, which the song stitching depends on."""

    def __init__(self, data_source):
        self.data_source = data_source

    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class ConcatDatasetBatchSampler(Sampler):
    """Batches that take a fixed quota from each of several samplers in
    turn (``sampler.py:87``), over a concatenation of their datasets (each
    sampler's indices offset by the lengths before it); as many batches as
    the shortest sampler fills.

    Example
    -------
    >>> batches = ConcatDatasetBatchSampler(
    ...     [SequentialSampler(range(4)), SequentialSampler(range(3))], [2, 1])
    >>> list(batches)
    [[0, 1, 4], [2, 3, 5]]
    """

    def __init__(self, samplers, batch_sizes, epoch=0):
        if not isinstance(samplers, (list, tuple)) or \
                not isinstance(batch_sizes, (list, tuple)):
            raise ValueError("samplers and batch_sizes should be lists or "
                             "tuples")
        if len(batch_sizes) != len(samplers):
            raise ValueError("batch_sizes and samplers should be have same "
                             "length")
        self.batch_sizes = batch_sizes
        self.samplers = samplers
        self.offsets = [0] + [int(n) for n in
                              np.cumsum([len(x) for x in samplers])[:-1]]
        self.epoch = epoch
        self.set_epoch(self.epoch)

    def set_epoch(self, epoch):
        if not hasattr(self.samplers[0], "epoch"):
            return
        for s in self.samplers:
            s.set_epoch(epoch)

    def __iter__(self):
        iterators = [iter(i) for i in self.samplers]
        for _ in range(len(self)):
            batch = []
            for samp_idx in range(len(self.samplers)):
                for _ in range(self.batch_sizes[samp_idx]):
                    batch.append(self.offsets[samp_idx]
                                 + next(iterators[samp_idx]))
            yield batch

    def __len__(self):
        return int(min(len(sampler) // self.batch_sizes[idx]
                       for idx, sampler in enumerate(self.samplers)))


class DynamicBatchSampler(Sampler):
    """Length-bucketed dynamic batching (``sampler.py:138``): each example
    goes to the bucket of its length, and a bucket is emitted as a batch
    once its summed length reaches ``max_batch_length`` (or it holds
    ``max_batch_ex`` examples); the batch order is random (seeded by
    ``seed + epoch``), ascending or descending by the longest example.

    Example
    -------
    >>> sampler = DynamicBatchSampler(None, max_batch_length=10,
    ...                               bucket_boundaries=[3, 6],
    ...                               lengths_list=[1, 2, 5, 5, 9, 2],
    ...                               shuffle=False,
    ...                               batch_ordering="ascending")
    >>> list(sampler)
    [[0, 1, 5], [2, 3], [4]]
    """

    def __init__(self, dataset, max_batch_length, num_buckets=None,
                 length_func=lambda x: x["duration"], shuffle=True,
                 batch_ordering="random", max_batch_ex=None,
                 bucket_boundaries=(), lengths_list=None, seed=42, epoch=0,
                 drop_last=False, verbose=False):
        self._dataset = dataset
        self._ex_lengths = {}
        if lengths_list is not None:
            for indx in range(len(lengths_list)):
                self._ex_lengths[str(indx)] = lengths_list[indx]
        else:
            ex_ids = self._dataset.data_ids
            for indx in range(len(self._dataset)):
                self._ex_lengths[str(indx)] = length_func(
                    self._dataset.data[ex_ids[indx]])
        if len(bucket_boundaries) > 0:
            if not all(x >= 0 for x in bucket_boundaries):
                raise ValueError("All elements in bucket boundaries should "
                                 "be non-negative.")
            if len(set(bucket_boundaries)) != len(bucket_boundaries):
                raise ValueError("Bucket_boundaries should not contain "
                                 "duplicates.")
            boundaries = np.array(sorted(bucket_boundaries), dtype=np.float64)
        else:
            if num_buckets is None:
                raise ValueError("Need either bucket_boundaries or "
                                 "num_buckets")
            lengths = np.array(list(self._ex_lengths.values()),
                               dtype=np.float64)
            quantiles = np.linspace(0, 1, num_buckets + 1)[1:-1]
            boundaries = np.unique(np.quantile(lengths, quantiles))
        self._bucket_boundaries = boundaries
        self._max_batch_length = max_batch_length
        self._shuffle_ex = shuffle
        self._batch_ordering = batch_ordering
        self._seed = seed
        self._drop_last = drop_last
        self._max_batch_ex = max_batch_ex or np.inf
        self._epoch = epoch
        self._generate_batches()

    def get_durations(self, batch):
        return [self._ex_lengths[str(idx)] for idx in batch]

    def _bucket_of(self, length):
        return int(np.searchsorted(self._bucket_boundaries, length))

    def _longest(self, batch):
        return max(self._ex_lengths[str(i)] for i in batch)

    def _generate_batches(self):
        rng = np.random.default_rng(self._seed + self._epoch)
        order = np.arange(len(self._ex_lengths))
        if self._shuffle_ex:
            order = rng.permutation(order)
        n_buckets = len(self._bucket_boundaries) + 1
        bucket_batches = [[] for _ in range(n_buckets)]
        bucket_lens = [0.0] * n_buckets
        batches = []
        for idx in order:
            length = self._ex_lengths[str(idx)]
            b = self._bucket_of(length)
            bucket_batches[b].append(int(idx))
            bucket_lens[b] += length
            if (bucket_lens[b] >= self._max_batch_length
                    or len(bucket_batches[b]) >= self._max_batch_ex):
                batches.append(bucket_batches[b])
                bucket_batches[b] = []
                bucket_lens[b] = 0.0
        if not self._drop_last:
            batches.extend(b for b in bucket_batches if b)
        if self._batch_ordering == "random":
            perm = rng.permutation(len(batches))
            batches = [batches[i] for i in perm]
        elif self._batch_ordering == "ascending":
            batches.sort(key=self._longest)
        elif self._batch_ordering == "descending":
            batches.sort(key=self._longest, reverse=True)
        self._batches = batches

    def __iter__(self):
        yield from self._batches
        if self._shuffle_ex or self._batch_ordering == "random":
            self._generate_batches()

    def set_epoch(self, epoch):
        self._epoch = epoch
        self._generate_batches()

    def __len__(self):
        return len(self._batches)


class DistributedSamplerWrapper(Sampler):
    """Any sampler shared over the ranks of a process group
    (``sampler.py:235``): rank r of W sees indices ``r::W`` of the inner
    sampler's stream, padded by wrap-around to a multiple of W, or cut to
    one with ``drop_last``. ``rank``/``num_replicas`` default to the process
    group's (0 and 1 without one).

    Example
    -------
    >>> inner = range(5)
    >>> [list(DistributedSamplerWrapper(inner, rank=r, num_replicas=2))
    ...  for r in (0, 1)]
    [[0, 2, 4], [1, 3, 0]]
    >>> len(DistributedSamplerWrapper(inner, 1, 2, drop_last=True))
    2
    """

    def __init__(self, sampler, rank=None, num_replicas=None,
                 drop_last=False):
        import torch.distributed as dist

        group = dist.is_available() and dist.is_initialized()
        self.sampler = sampler
        self.rank = rank if rank is not None else (
            dist.get_rank() if group else 0)
        self.num_replicas = num_replicas if num_replicas is not None else (
            dist.get_world_size() if group else 1)
        self.drop_last = drop_last

    def __iter__(self):
        indices = list(iter(self.sampler))
        if self.drop_last:
            total = (len(indices) // self.num_replicas) * self.num_replicas
            indices = indices[:total]
        else:
            indices = indices + indices[:(-len(indices)) % self.num_replicas]
        return iter(indices[self.rank::self.num_replicas])

    def __len__(self):
        if self.drop_last:
            return len(self.sampler) // self.num_replicas
        return -(-len(self.sampler) // self.num_replicas)

    def set_epoch(self, epoch):
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
