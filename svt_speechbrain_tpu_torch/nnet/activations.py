"""Activations (port of ``svt_speechbrain_tpu/nnet/activations.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def fast_gelu(x):
    """GELU with the JAX package's dtype rule (``activations.py:39-66``):
    the exact erf form in f32/f64; for bf16/f16 the tanh form computed in
    f32 and cast back (the tanh chain in raw bf16 flushes the negative tail
    to zero).

    Example
    -------
    >>> import torch
    >>> round(float(fast_gelu(torch.tensor([1.0]))[0]), 4)
    0.8413
    >>> fast_gelu(torch.tensor([1.0], dtype=torch.bfloat16)).dtype
    torch.bfloat16
    """
    if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
        return F.gelu(x.float(), approximate="tanh").to(x.dtype)
    return F.gelu(x)


class Softmax(nn.Module):
    """(Log-)softmax over ``dim`` (``activations.py:10``); the AMT recipe's
    ``Softmax(apply_log=True)`` turns head logits into log-probabilities.

    Example
    -------
    >>> import torch
    >>> round(float(Softmax(apply_log=True)(torch.zeros(2))[0]), 4)
    -0.6931
    """

    def __init__(self, apply_log=False, dim=-1):
        super().__init__()
        self.apply_log = apply_log
        self.dim = dim

    def forward(self, x):
        if self.apply_log:
            return F.log_softmax(x, dim=self.dim)
        return F.softmax(x, dim=self.dim)
