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


class PReLU(nn.Module):
    """Parametric ReLU (``activations.py:99``): ``alpha`` (num_parameters,),
    one slope for all channels or one per channel, broadcast on the channel
    axis, the last of a channel-last tensor.

    Example
    -------
    >>> import torch
    >>> act = PReLU(2)
    >>> with torch.no_grad():
    ...     _ = act.alpha.copy_(torch.tensor([0.5, 0.25]))
    >>> act(torch.tensor([[-2.0, -2.0], [1.0, 3.0]])).tolist()
    [[-1.0, -0.5], [1.0, 3.0]]
    """

    def __init__(self, num_parameters=1, init=0.25):
        super().__init__()
        self.num_parameters = num_parameters
        self.alpha = nn.Parameter(torch.full((num_parameters,), float(init)))

    def forward(self, x):
        alpha = self.alpha[0] if self.num_parameters == 1 else self.alpha
        return torch.where(x >= 0, x, alpha * x)
