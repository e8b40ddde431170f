"""Chaining helpers (port of ``svt_speechbrain_tpu/utils/callchains.py``):
``LengthsCapableChain`` is an ``nn.Module``, so that modules chained in it
are its submodules (moved, saved and trained with it)."""
from __future__ import annotations

import inspect

from torch import nn


def lengths_arg_exists(func):
    """True if func accepts a ``lengths`` argument (reference ``callchains.py:7``)."""
    try:
        return "lengths" in inspect.signature(func).parameters
    except (TypeError, ValueError):
        return False


class LengthsCapableChain(nn.Module):
    """Chain of callables where each may take (x) or (x, lengths)
    (``callchains.py:16``); callables that are modules are registered as
    submodules.

    Example
    -------
    >>> chain = LengthsCapableChain(
    ...     lambda x: x + 1,
    ...     lambda x, lengths: x * lengths,
    ... )
    >>> chain(2, lengths=10)            # (2+1) * 10
    30
    >>> chain.takes_lengths
    [False, True]
    """

    def __init__(self, *funcs):
        super().__init__()
        self.funcs = []
        self.takes_lengths = []
        self.mods = nn.ModuleList()
        for func in funcs:
            self.append(func)

    def append(self, func):
        self.funcs.append(func)
        self.takes_lengths.append(lengths_arg_exists(
            func.forward if isinstance(func, nn.Module) else func))
        if isinstance(func, nn.Module):
            self.mods.append(func)

    def forward(self, x, lengths=None):
        if not self.funcs:
            return None
        for func, give_lengths in zip(self.funcs, self.takes_lengths):
            if give_lengths and lengths is not None:
                x = func(x, lengths=lengths)
            else:
                x = func(x)
            if isinstance(x, tuple):
                x = x[0]
        return x
