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
        self.init_val = init
        self.alpha = nn.Parameter(torch.full((num_parameters,), float(init)))

    def forward(self, x):
        alpha = self.alpha[0] if self.num_parameters == 1 else self.alpha
        return torch.where(x >= 0, x, alpha * x)


class GELU(nn.Module):
    """Gaussian error linear unit (``activations.py:69``): the erf form, or
    the tanh form with ``approximate``.

    Example
    -------
    >>> import torch
    >>> round(float(GELU()(torch.tensor([1.0]))[0]), 4)
    0.8413
    """

    def __init__(self, approximate=False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate="tanh" if self.approximate else "none")


class Swish(nn.Module):
    """swish(x) = x · sigmoid(beta · x) (``activations.py:81``).

    Example
    -------
    >>> import torch
    >>> round(float(Swish()(torch.tensor([1.0]))[0]), 4)
    0.7311
    """

    def __init__(self, beta=1.0):
        super().__init__()
        self.beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self.beta * x)


class GumbelSoftmax(nn.Module):
    """Gumbel-softmax sampling over the last axis (``activations.py:118``),
    straight-through one-hot with ``hard``, the log of the result with
    ``apply_log``. The uniform noise is drawn from ``generator``, a
    ``torch.Generator`` on the input's device; without one, from a
    generator seeded 0, as the JAX module falls back to ``PRNGKey(0)``.

    Example
    -------
    >>> import torch
    >>> gs = GumbelSoftmax(tau=0.5, hard=True)
    >>> y = gs(torch.zeros(2, 4), torch.Generator().manual_seed(0))
    >>> (y.round() == y.round(decimals=5)).all().item(), y.round().sum(-1)
    (True, tensor([1., 1.]))
    """

    def __init__(self, tau, hard=False, apply_log=False):
        super().__init__()
        self.tau = tau
        self.hard = hard
        self.apply_log = apply_log

    def forward(self, x, generator=None):
        if generator is None:
            generator = torch.Generator(x.device).manual_seed(0)
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return self.from_uniform(x, 1e-20 + u * (1.0 - 1e-20))

    def from_uniform(self, x, u):
        """The sample for uniform noise ``u`` in [1e-20, 1), the shape of
        ``x``: Gumbel noise -log(-log(u + 1e-20)), softmax of (x + g) / tau,
        then the straight-through and log options."""
        g = -torch.log(-torch.log(u + 1e-20))
        y = torch.softmax((x + g) / self.tau, dim=-1)
        if self.hard:
            one_hot = F.one_hot(y.argmax(-1), x.shape[-1]).to(y.dtype)
            y = one_hot + y - y.detach()
        if self.apply_log:
            return torch.log(torch.clamp(y, min=1e-20))
        return y
