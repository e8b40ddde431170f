"""Dropout (port of ``svt_speechbrain_tpu/nnet/dropout.py``), with explicit
generators in place of JAX's PRNG keys: no global RNG is read."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class StepRNG:
    """The random sources of one training step.

    ``device`` draws the elementwise dropout masks, on the device of the
    activations. ``host`` is a CPU generator that draws the per-call seeds
    of the attention kernels' hash dropout: a seed drawn on the host is
    handed to the kernel as an argument, with no device round trip."""

    device: torch.Generator
    host: torch.Generator

    def attention_seed(self):
        """A fresh seed in [0, 2³¹−1), as the JAX package draws it
        (``nnet/attention.py:67``)."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host))


def dropout(x, rate, generator=None, train=False):
    """Inverted dropout: each element kept with probability 1 − ``rate``
    and scaled by 1/(1 − rate). The identity unless ``train``, a
    ``generator`` and ``rate`` > 0 are all given.

    Example
    -------
    >>> import torch
    >>> x = torch.ones(2, 8)
    >>> bool((dropout(x, 0.5) == x).all())            # eval: identity
    True
    >>> y = dropout(x, 0.5, torch.Generator().manual_seed(0), train=True)
    >>> sorted(set(y.flatten().tolist()))             # dropped or scaled
    [0.0, 2.0]
    """
    if not train or generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
