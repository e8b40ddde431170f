"""Samplers (port of ``svt_speechbrain_tpu/dataio/sampler.py:15-87``).

They are ``torch.utils.data.Sampler``s that draw with numpy exactly as the
JAX package's do, so a shuffled order is the same in both packages for the
same seed and epoch. ``DistributedSamplerWrapper`` waits for data parallelism
(ROADMAP.md queue 1 item 16).
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


class SequentialSampler(Sampler):
    """Indices in dataset order (``sampler.py:75``); evaluation keeps songs in
    order, which the song stitching depends on."""

    def __init__(self, data_source):
        self.data_source = data_source

    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)
