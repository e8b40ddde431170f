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


class Dropout2d(torch.nn.Module):
    """Channel dropout over channel-last input (``dropout.py:32``): each
    (batch row, channel) kept with probability 1 − ``drop_rate`` across all
    other axes, and scaled by 1/(1 − rate); the identity unless ``train``
    and a ``generator`` are given.

    Example
    -------
    >>> import torch
    >>> y = Dropout2d(0.5)(torch.ones(2, 6, 4),
    ...                    torch.Generator().manual_seed(0), train=True)
    >>> bool((y == y[:, :1]).all()), sorted(set(y.flatten().tolist()))
    (True, [0.0, 2.0])
    """

    def __init__(self, drop_rate):
        super().__init__()
        self.drop_rate = drop_rate

    def forward(self, x, generator=None, train=False):
        if not train or generator is None or self.drop_rate <= 0.0:
            return x
        keep = 1.0 - self.drop_rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
