"""Complex-valued networks (port of
``svt_speechbrain_tpu/nnet/complex_networks.py``). A complex tensor of
width 2N is stored as ``[real_0..real_{N-1}, imag_0..imag_{N-1}]`` on the
last axis, and (a + ib)(c + id) = (ac - bd) + i(ad + bc) runs as real
products.

The JAX module's quirks are kept (its docstring, ``:13-36``):

- the recurrences slice their fused gate projections contiguously, so a
  gate is a run of 2H real lanes that cuts across the complex packing;
- ``CBatchNorm`` adds ``eps`` to the batch Vrr/Vii before the running
  update, so the running covariances hold eps-inflated values, and eval
  whitens with no further eps;
- ``CLayerNorm`` on a 2-D input reduces over no axis, so its output is
  ``beta``; ``CLiGRU`` normalizes its (B·T, 4H) projection, so its
  ``layernorm`` mode (and any other string but "batchnorm") zeroes it;
- ``CLinear``'s bias starts at zero.

Parameters have the JAX trees' names and layouts (a conv's ``real``/
``imag`` children are ``Conv1d``/``Conv2d``, which ``convert_jax`` fills in
torch's layout); the running statistics are buffers, updated by a training
forward and used in eval. The seeded draws (``complex_init``,
``unitary_init``) take a ``torch.Generator`` and give the JAX
distributions, not its numbers. ``rng`` is a ``StepRNG``: its device
generator draws the recurrences' dropout masks in training."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from svt_speechbrain_tpu_torch.nnet.cnn import (Conv1d, Conv2d, conv_nd,
                                                jax_to_torch_conv_weight)


def check_complex_input(input_shape):
    """Raise unless the last axis is even (``complex_networks.py:48``)."""
    if input_shape[-1] % 2:
        raise ValueError("Complex tensors must have an even last dimension")


def get_real(x):
    """The real half of the last axis."""
    return x[..., : x.shape[-1] // 2]


def get_imag(x):
    """The imaginary half of the last axis."""
    return x[..., x.shape[-1] // 2:]


def _uniform(generator, shape, low, high):
    return torch.rand(shape, generator=generator) * (high - low) + low


def complex_init(generator, in_features, out_features, criterion="glorot"):
    """Polar complex draw (``complex_networks.py:61``): modulus Rayleigh(s)
    by the inverse CDF of U(1e-7, 1), phase U(-π, π), s = 1/(fan_in +
    fan_out) for glorot, 1/fan_in for he; (real, imag) numpy (in, out)."""
    s = (1.0 / (in_features + out_features) if criterion == "glorot"
         else 1.0 / in_features)
    shape = (in_features, out_features)
    modulus = s * torch.sqrt(-2.0 * torch.log(
        _uniform(generator, shape, 1e-7, 1.0)))
    phase = _uniform(generator, shape, -np.pi, np.pi)
    return ((modulus * torch.cos(phase)).numpy(),
            (modulus * torch.sin(phase)).numpy())


def unitary_init(generator, in_features, out_features, criterion="glorot"):
    """Unit-modulus complex draw (``complex_networks.py:797``): uniform
    (real, imag) pairs over the norm plus 1e-4."""
    shape = (in_features, out_features)
    v_r = _uniform(generator, shape, -1.0, 1.0)
    v_i = _uniform(generator, shape, -1.0, 1.0)
    norm = torch.sqrt(v_r ** 2 + v_i ** 2) + 1e-4
    return (v_r / norm).numpy(), (v_i / norm).numpy()


_INITS = {"complex": complex_init, "unitary": unitary_init}


def affect_init(real_weight, imag_weight, init_func, generator,
                criterion="glorot"):
    """A new draw of ``init_func`` at the weights' (in, out) shape
    (``complex_networks.py:810``)."""
    return init_func(generator, real_weight.shape[0], real_weight.shape[1],
                     criterion)


def affect_conv_init(real_weight, imag_weight, kernel_size, init_func,
                     generator, criterion="glorot"):
    """A draw at the (in, out) of the last two axes, broadcast to the
    weights' shape (``complex_networks.py:817``)."""
    r, i = init_func(generator, real_weight.shape[-2],
                     real_weight.shape[-1], criterion)
    shape = tuple(real_weight.shape)
    return np.broadcast_to(r, shape), np.broadcast_to(i, shape)


def get_conjugate(x):
    """The imaginary half negated (``complex_networks.py:827``).

    Example
    -------
    >>> import torch
    >>> get_conjugate(torch.tensor([[1.0, 2.0]])).tolist()
    [[1.0, -2.0]]
    """
    return torch.cat([get_real(x), -get_imag(x)], dim=-1)


def multi_mean(x, axes, keepdim=False):
    """The mean over several axes, the highest first
    (``complex_networks.py:833``)."""
    for ax in sorted(axes, reverse=True):
        x = x.mean(dim=ax, keepdim=keepdim)
    return x


def complex_linear_op(x, real_weight, imag_weight, bias=None):
    """The complex product of packed ``x`` and (real, imag) weights (in,
    out) (``complex_networks.py:78``).

    Example
    -------
    >>> import torch
    >>> x = torch.tensor([[1.0, 2.0]])                       # 1 + 2j
    >>> wr, wi = torch.tensor([[3.0]]), torch.tensor([[4.0]])  # 3 + 4j
    >>> complex_linear_op(x, wr, wi).tolist()                # -5 + 10j
    [[-5.0, 10.0]]
    """
    xr, xi = get_real(x), get_imag(x)
    wr, wi = real_weight.to(x.dtype), imag_weight.to(x.dtype)
    y = torch.cat([xr @ wr - xi @ wi, xr @ wi + xi @ wr], dim=-1)
    return y if bias is None else y + bias


def complex_conv_op(x, real_weight, imag_weight, bias, stride=1,
                    padding="same", dilation=1, conv1d=True):
    """The functional complex conv (``complex_networks.py:841``): weights
    in the JAX layout (*k, in, out), zero "same"/"valid"/"causal"
    padding."""
    cls = Conv1d if conv1d else Conv2d
    k = tuple(real_weight.shape[:-2])
    conv = cls(real_weight.shape[-1], k if len(k) > 1 else k[0],
               real_weight.shape[-2], stride=stride, dilation=dilation,
               padding=padding, bias=False)

    def cv(w, v):
        return _conv_with(conv, jax_to_torch_conv_weight(w), v)

    xr, xi = get_real(x), get_imag(x)
    y = torch.cat([cv(real_weight, xr) - cv(imag_weight, xi),
                   cv(real_weight, xi) + cv(imag_weight, xr)], dim=-1)
    return y if bias is None else y + bias


def _conv_with(conv, weight, x):
    """``conv``'s padding, stride and dilation with another (out, in, *k)
    weight."""
    return conv_nd(x, weight, conv.NDIM, conv._pad_config(),
                   conv.padding_mode, stride=conv.stride,
                   dilation=conv.dilation, groups=conv.groups)


class CLinear(nn.Module):
    """Complex linear layer (``complex_networks.py:99``): ``n_neurons``
    complex units (2·n_neurons reals out), parameters ``real_weight``,
    ``imag_weight`` (in/2, n_neurons) and a zero-started ``bias``.

    Example
    -------
    >>> import torch
    >>> CLinear(n_neurons=4, input_size=2)(torch.ones(2, 5, 2)).shape
    torch.Size([2, 5, 8])
    """

    def __init__(self, n_neurons, input_shape=None, input_size=None,
                 bias=True, init_criterion="glorot", weight_init="complex"):
        super().__init__()
        if input_size is None and input_shape is not None:
            input_size = input_shape[-1]
        check_complex_input((input_size,))
        self.in_complex = input_size // 2
        self.n_neurons = n_neurons
        self.init_criterion = init_criterion
        self.weight_init = weight_init
        self.real_weight = nn.Parameter(torch.zeros(self.in_complex,
                                                    n_neurons))
        self.imag_weight = nn.Parameter(torch.zeros(self.in_complex,
                                                    n_neurons))
        self.bias = nn.Parameter(torch.zeros(2 * n_neurons)) if bias else None

    def init_tree(self, generator):
        """The seeded JAX-shaped tree of the layer."""
        wr, wi = _INITS[self.weight_init](generator, self.in_complex,
                                          self.n_neurons, self.init_criterion)
        tree = {"real_weight": wr, "imag_weight": wi}
        if self.bias is not None:
            tree["bias"] = np.zeros(2 * self.n_neurons, np.float32)
        return tree

    def forward(self, x):
        return complex_linear_op(x, self.real_weight, self.imag_weight,
                                 self.bias)


class _CConvNd(nn.Module):
    """The complex convs: ``real`` and ``imag`` bias-free real convs (odd
    kernels, reflect "same" padding by default, causal always zero-padded)
    and a zero-started ``bias``."""

    CONV = None

    def _kernel(self, kernel_size, stride, dilation):
        """The kernel's sizes, and the real convs' size, stride and
        dilation arguments."""
        raise NotImplementedError

    def __init__(self, out_channels, kernel_size, input_shape=None,
                 input_size=None, stride=1, dilation=1, padding="same",
                 bias=True, padding_mode="reflect", init_criterion="glorot",
                 weight_init="complex"):
        super().__init__()
        if input_size is None and input_shape is not None:
            input_size = input_shape[-1]
        check_complex_input((input_size,))
        self.k, kw = self._kernel(kernel_size, stride, dilation)
        if any(v % 2 == 0 for v in self.k):
            raise ValueError("The field kernel size must be an odd number. "
                             f"Got {kernel_size}.")
        if padding == "causal":
            padding_mode = "zeros"
        self.in_complex = input_size // 2
        self.out_channels = out_channels
        self.init_criterion = init_criterion
        self.weight_init = weight_init
        for name in ("real", "imag"):
            self.add_module(name, self.CONV(
                out_channels, in_channels=self.in_complex, padding=padding,
                padding_mode=padding_mode, bias=False, **kw))
        self.bias = (nn.Parameter(torch.zeros(2 * out_channels)) if bias
                     else None)

    def init_tree(self, generator):
        """The seeded JAX-shaped tree: ``real``/``imag`` ``w`` (*k, in,
        out) from one draw at (in·receptive field, out), zero ``bias``."""
        wr, wi = _INITS[self.weight_init](
            generator, self.in_complex * int(np.prod(self.k)),
            self.out_channels, self.init_criterion)
        shape = tuple(self.real.kernel_size) + (self.in_complex,
                                                self.out_channels)
        tree = {"real": {"w": wr.reshape(shape)},
                "imag": {"w": wi.reshape(shape)}}
        if self.bias is not None:
            tree["bias"] = np.zeros(2 * self.out_channels, np.float32)
        return tree

    def forward(self, x):
        xr, xi = get_real(x), get_imag(x)
        y = torch.cat([self.real(xr) - self.imag(xi),
                       self.real(xi) + self.imag(xr)], dim=-1)
        return y if self.bias is None else y + self.bias


class CConv1d(_CConvNd):
    """Complex 1-D conv over (B, T, 2C) (``complex_networks.py:142``).

    Example
    -------
    >>> import torch
    >>> CConv1d(out_channels=6, kernel_size=3, input_size=8)(
    ...     torch.ones(2, 16, 8)).shape
    torch.Size([2, 16, 12])
    """

    CONV = Conv1d

    def _kernel(self, kernel_size, stride, dilation):
        return (kernel_size,), dict(kernel_size=kernel_size, stride=stride,
                                    dilation=dilation)


class CConv2d(_CConvNd):
    """Complex 2-D conv over (B, T, F, 2C) (``complex_networks.py:209``):
    ``kernel_size[0]`` runs along the feature axis and ``[1]`` along time,
    as the reference's layout does (and stride and dilation likewise).

    Example
    -------
    >>> import torch
    >>> CConv2d(out_channels=4, kernel_size=3, input_size=6)(
    ...     torch.ones(2, 10, 12, 6)).shape
    torch.Size([2, 10, 12, 8])
    """

    CONV = Conv2d

    def _kernel(self, kernel_size, stride, dilation):
        def pair(v):
            return (v, v) if isinstance(v, int) else tuple(v)

        k, s, d = pair(kernel_size), pair(stride), pair(dilation)
        return k, dict(kernel_size=(k[1], k[0]), stride=(s[1], s[0]),
                       dilation=(d[1], d[0]))


def _split_halves(x, dim):
    half = x.shape[dim] // 2
    return x.narrow(dim, 0, half), x.narrow(dim, half, x.shape[dim] - half)


def c_standardization(input_centred, Vrr, Vii, Vri, layernorm=False,
                      dim=-1):
    """Whiten a centred packed tensor by the inverse square root of its
    2x2 covariance [[Vrr, Vri], [Vri, Vii]], in closed form
    (``complex_networks.py:291``); no eps here."""
    tau = Vrr + Vii
    s = torch.sqrt(Vrr * Vii - Vri ** 2)
    t = torch.sqrt(tau + 2 * s)
    inverse_st = 1.0 / (s * t)
    Wrr = (Vii + s) * inverse_st
    Wii = (Vrr + s) * inverse_st
    Wri = -Vri * inverse_st
    xr, xi = _split_halves(input_centred, dim)
    return torch.cat([Wrr * xr + Wri * xi, Wri * xr + Wii * xi], dim=dim)


def c_norm(input_centred, Vrr, Vii, Vri, beta=None, gamma_rr=None,
           gamma_ri=None, gamma_ii=None, scale=True, center=True,
           layernorm=False, dim=-1):
    """Whitening, then the [[γ_rr, γ_ri], [γ_ri, γ_ii]] scale and the β
    shift (``complex_networks.py:310``)."""
    if scale:
        out = c_standardization(input_centred, Vrr, Vii, Vri,
                                layernorm=layernorm, dim=dim)
        xr, xi = _split_halves(out, dim)
        out = torch.cat([gamma_rr * xr + gamma_ri * xi,
                         gamma_ri * xr + gamma_ii * xi], dim=dim)
        return out + beta if center else out
    return input_centred + beta if center else input_centred


class _CNormBase(nn.Module):
    """The complex norms' parameters: ``gamma_rr``, ``gamma_ii`` (1/√2),
    ``gamma_ri`` (0) with ``scale``, ``beta`` (0) with ``center``."""

    def __init__(self, input_size, input_shape, dim, eps, scale, center):
        super().__init__()
        if input_size is None and input_shape is not None:
            input_size = input_shape[dim]
        check_complex_input((input_size,))
        self.num_complex = n = input_size // 2
        self.dim = dim
        self.eps = eps
        self.scale = scale
        self.center = center
        self.gamma_rr = self.gamma_ii = self.gamma_ri = self.beta = None
        if scale:
            self.gamma_rr = nn.Parameter(torch.full((n,), 1 / math.sqrt(2)))
            self.gamma_ii = nn.Parameter(torch.full((n,), 1 / math.sqrt(2)))
            self.gamma_ri = nn.Parameter(torch.zeros(n))
        if center:
            self.beta = nn.Parameter(torch.zeros(2 * n))

    def init_tree(self, generator):
        """The constant JAX tree of the affine parameters."""
        n, tree = self.num_complex, {}
        if self.scale:
            tree["gamma_rr"] = np.full(n, 1 / np.sqrt(2), np.float32)
            tree["gamma_ii"] = np.full(n, 1 / np.sqrt(2), np.float32)
            tree["gamma_ri"] = np.zeros(n, np.float32)
        if self.center:
            tree["beta"] = np.zeros(2 * n, np.float32)
        return tree

    def _affine(self):
        return dict(beta=self.beta, gamma_rr=self.gamma_rr,
                    gamma_ri=self.gamma_ri, gamma_ii=self.gamma_ii,
                    scale=self.scale, center=self.center)


class CBatchNorm(_CNormBase):
    """Complex batch norm with full 2x2 whitening
    (``complex_networks.py:330``). Buffers ``num_batches_tracked`` and,
    with ``track_running_stats``, ``moving_Vrr``, ``moving_Vii`` (√½),
    ``moving_Vri`` (0), ``moving_mean`` (0); a training forward whitens
    with the batch moments (eps already in Vrr/Vii) and moves the buffers
    by ``momentum`` (a cumulative average when None); eval whitens with
    the buffers.

    Example
    -------
    >>> import torch
    >>> bn = CBatchNorm(input_size=6)
    >>> bn(torch.randn(4, 5, 6), train=True).shape, int(bn.num_batches_tracked)
    (torch.Size([4, 5, 6]), 1)
    """

    def __init__(self, input_size=None, input_shape=None, dim=-1, eps=1e-4,
                 momentum=0.1, scale=True, center=True,
                 track_running_stats=True):
        super().__init__(input_size, input_shape, dim, eps, scale, center)
        self.momentum = momentum
        self.track_running_stats = track_running_stats
        n = self.num_complex
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        if track_running_stats:
            if scale:
                self.register_buffer("moving_Vrr",
                                     torch.full((n,), math.sqrt(0.5)))
                self.register_buffer("moving_Vii",
                                     torch.full((n,), math.sqrt(0.5)))
                self.register_buffer("moving_Vri", torch.zeros(n))
            if center:
                self.register_buffer("moving_mean", torch.zeros(2 * n))

    def forward(self, x, train=False):
        dim = self.dim if self.dim >= 0 else x.dim() + self.dim
        axes = tuple(a for a in range(x.dim()) if a != dim)
        mu = x.mean(dim=axes, keepdim=True)
        centred = x - mu
        Vrr = Vii = Vri = None
        if self.scale:
            sq_r, sq_i = _split_halves(centred ** 2, dim)
            c_r, c_i = _split_halves(centred, dim)
            Vrr = sq_r.mean(dim=axes, keepdim=True) + self.eps
            Vii = sq_i.mean(dim=axes, keepdim=True) + self.eps
            Vri = (c_r * c_i).mean(dim=axes, keepdim=True)
        if train and self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked += 1
                f = (1.0 / float(self.num_batches_tracked)
                     if self.momentum is None else self.momentum)
                if self.center:
                    self.moving_mean.copy_((1 - f) * self.moving_mean
                                           + f * mu.reshape(-1))
                if self.scale:
                    for buf, v in ((self.moving_Vrr, Vrr),
                                   (self.moving_Vii, Vii),
                                   (self.moving_Vri, Vri)):
                        buf.copy_((1 - f) * buf + f * v.reshape(-1))
        if train or not self.track_running_stats:
            inferred = centred if self.center else x
            use = (Vrr, Vii, Vri)
        else:
            shape = [1] * x.dim()
            shape[dim] = -1
            inferred = (x - self.moving_mean.reshape(shape) if self.center
                        else x)
            use = tuple(getattr(self, k).reshape(shape) if self.scale
                        else None
                        for k in ("moving_Vrr", "moving_Vii", "moving_Vri"))
        return c_norm(inferred, *use, dim=dim, **self._affine())


class CLayerNorm(_CNormBase):
    """Complex layer norm with full whitening (``complex_networks.py:446``):
    per-item moments over every axis but the batch and the feature axis;
    on a 2-D input over none, so the output is ``beta``.

    Example
    -------
    >>> import torch
    >>> CLayerNorm(6)(torch.randn(2, 5, 6)).shape
    torch.Size([2, 5, 6])
    """

    def __init__(self, input_size=None, input_shape=None, dim=-1, eps=1e-4,
                 scale=True, center=True):
        super().__init__(input_size, input_shape, dim, eps, scale, center)

    def forward(self, x):
        dim = self.dim if self.dim >= 0 else x.dim() + self.dim
        axes = tuple(a for a in range(x.dim()) if a not in (dim, 0))
        mu = x.mean(dim=axes, keepdim=True) if axes else x
        centred = x - mu if self.center else x
        Vrr = Vii = Vri = None
        if self.scale:
            sq_r, sq_i = _split_halves(centred ** 2, dim)
            c_r, c_i = _split_halves(centred, dim)
            if axes:
                Vrr = sq_r.mean(dim=axes, keepdim=True) + self.eps
                Vii = sq_i.mean(dim=axes, keepdim=True) + self.eps
                Vri = (c_r * c_i).mean(dim=axes, keepdim=True)
            else:
                Vrr, Vii, Vri = sq_r + self.eps, sq_i + self.eps, c_r * c_i
        return c_norm(centred, Vrr, Vii, Vri, layernorm=True, dim=dim,
                      **self._affine())


class _RecurrentLayer(nn.Module):
    """One layer of a complex or quaternion recurrence: the fused input
    projection ``w``, the recurrent projection ``u`` and, for the light
    GRUs, the ``norm`` of the projection, whose JAX state sits at the
    layer's path."""

    jax_state_child = "norm"

    def __init__(self, w, u, norm=None):
        super().__init__()
        self.w = w
        self.u = u
        if norm is not None:
            self.norm = norm


class _RecurrenceBase(nn.Module):
    """Shared machinery of the complex and quaternion recurrences: per
    layer (children ``l{k}``) a fused input and recurrent projection,
    shared by both directions (a bidirectional layer runs the time-flipped
    copy in a doubled batch), contiguous gate slices, a zero (or ``hx``)
    initial state and a per-row dropout mask shared across time."""

    GATE_NEURONS = 1
    PROJ_BIAS = False
    COMPONENTS = 2          # 2 real lanes a complex unit, 4 a quaternion
    PROJ = None             # the projection class

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 num_layers=1, bias=True, dropout=0.0, bidirectional=False,
                 init_criterion="glorot", weight_init=None):
        super().__init__()
        if input_size is None and input_shape is not None:
            input_size = int(np.prod(input_shape[2:]))
        if input_size % self.COMPONENTS:
            raise ValueError(f"the input width must divide by "
                             f"{self.COMPONENTS}")
        self.hidden_size = hidden_size
        self.input_size = input_size
        self.num_layers = num_layers
        self.bias = bias
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.init_criterion = init_criterion
        self.width = self.COMPONENTS * hidden_size
        kw = dict(bias=self.PROJ_BIAS, init_criterion=init_criterion)
        if weight_init is not None:
            kw["weight_init"] = weight_init
        for layer in range(num_layers):
            in_size = (input_size if layer == 0 else
                       self.width * (2 if bidirectional else 1))
            self.add_module(f"l{layer}", _RecurrentLayer(
                self.PROJ(self.GATE_NEURONS * hidden_size,
                          input_size=in_size, **kw),
                self.PROJ(self.GATE_NEURONS * hidden_size,
                          input_size=self.width, **kw),
                self._make_norm()))

    def _make_norm(self):
        return None

    def _post_w(self, layer, w, train):
        return w

    def _drop_mask(self, rng, batch, train, x):
        if not train or self.dropout == 0.0 or rng is None:
            return torch.ones(1, self.width, dtype=x.dtype, device=x.device)
        keep = 1.0 - self.dropout
        mask = torch.rand(batch, self.width, generator=rng.device,
                          device=x.device) < keep
        return mask.to(x.dtype) / keep

    def _step(self, w_t, h, c, u, drop_mask):
        raise NotImplementedError

    def _layer_forward(self, layer, x, hx, train, rng):
        if self.bidirectional:
            x = torch.cat([x, x.flip(1)], dim=0)
        w = self._post_w(layer, layer.w(x), train)
        b = x.shape[0]
        h = (torch.zeros(b, self.width, dtype=w.dtype, device=w.device)
             if hx is None else torch.broadcast_to(hx, (b, self.width)))
        c = torch.zeros_like(h)
        drop_mask = self._drop_mask(rng, b, train, x)
        outs = []
        for t in range(w.shape[1]):
            h, c = self._step(w[:, t], h, c, layer.u, drop_mask)
            outs.append(h)
        h = torch.stack(outs, dim=1)
        if self.bidirectional:
            h_f, h_b = h.chunk(2, dim=0)
            h = torch.cat([h_f, h_b.flip(1)], dim=2)
        return h

    def _forward(self, x, hx=None, train=False, rng=None):
        if x.dim() == 4:
            x = x.reshape(x.shape[0], x.shape[1], -1)
        if hx is not None and self.bidirectional:
            hx = hx.reshape(self.num_layers, -1, self.width)
        h_last = []
        for k in range(self.num_layers):
            x = self._layer_forward(getattr(self, f"l{k}"), x,
                                    None if hx is None else hx[k], train, rng)
            h_last.append(x[:, -1, :])
        h = torch.stack(h_last, dim=1)
        if self.bidirectional:
            h = h.reshape(h.shape[1] * 2, h.shape[0], self.width)
        else:
            h = h.transpose(0, 1)
        return x, h


def _act(nonlinearity):
    return torch.tanh if nonlinearity == "tanh" else torch.relu


class _CRNNBase(_RecurrenceBase):
    """The complex recurrences (``complex_networks.py:518``): ``forward``
    returns the output, or (output, h) with ``return_hidden``."""

    PROJ = CLinear

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 num_layers=1, bias=True, dropout=0.0, bidirectional=False,
                 return_hidden=False, init_criterion="glorot",
                 weight_init="complex"):
        self.return_hidden = return_hidden
        super().__init__(hidden_size, input_shape, input_size, num_layers,
                         bias, dropout, bidirectional, init_criterion,
                         weight_init)

    def forward(self, x, hx=None, train=False, rng=None):
        out, h = self._forward(x, hx=hx, train=train, rng=rng)
        return (out, h) if self.return_hidden else out


class CRNN(_CRNNBase):
    """Vanilla complex RNN (``complex_networks.py:630``): h_t = act(w x_t
    + u h_{t-1}) · drop_mask, bias-free projections.

    Example
    -------
    >>> import torch
    >>> CRNN(hidden_size=5, input_size=8)(torch.ones(2, 10, 8)).shape
    torch.Size([2, 10, 10])
    """

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 nonlinearity="tanh", num_layers=1, bias=True, dropout=0.0,
                 bidirectional=False, return_hidden=False,
                 init_criterion="glorot", weight_init="complex"):
        self.act = _act(nonlinearity)
        super().__init__(hidden_size, input_shape, input_size, num_layers,
                         bias, dropout, bidirectional, return_hidden,
                         init_criterion, weight_init)

    def _step(self, w_t, h, c, u, drop_mask):
        h = self.act(w_t + u(h)) * drop_mask
        return h, c


def _lstm_step(w_t, h, c, u, drop_mask, width):
    gates = w_t + u(h)
    it = torch.sigmoid(gates[:, :width])
    ft = torch.sigmoid(gates[:, width:2 * width])
    ot = torch.sigmoid(gates[:, 2 * width:3 * width])
    ctilde = torch.tanh(gates[:, 3 * width:])
    c = it * ctilde * drop_mask + ft * c
    return ot * torch.tanh(c), c


class CLSTM(_CRNNBase):
    """Complex LSTM (``complex_networks.py:666``): one 4H-unit projection
    with bias sliced contiguously into (i, f, o, c~) of 2H reals each;
    c_t = i·tanh(c~)·drop + f·c, h_t = o·tanh(c_t).

    Example
    -------
    >>> import torch
    >>> CLSTM(hidden_size=4, input_size=8)(torch.ones(2, 7, 8)).shape
    torch.Size([2, 7, 8])
    """

    GATE_NEURONS = 4
    PROJ_BIAS = True

    def _step(self, w_t, h, c, u, drop_mask):
        return _lstm_step(w_t, h, c, u, drop_mask, self.width)


class CLiGRU(_CRNNBase):
    """Complex light GRU (``complex_networks.py:704``): 2H-unit projections
    sliced contiguously into (a, z); h_t = z·h + (1-z)·act(a)·drop. The
    input projection is normalized over its (B·T, 4H) view before the
    recurrence: "batchnorm" by a ``CBatchNorm`` (momentum 0.05, its
    statistics buffers), any other string by a ``CLayerNorm``, which
    collapses it to ``beta``.

    Example
    -------
    >>> import torch
    >>> CLiGRU(hidden_size=4, input_size=8)(torch.ones(2, 7, 8)).shape
    torch.Size([2, 7, 8])
    """

    GATE_NEURONS = 2

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 nonlinearity="relu", normalization="batchnorm", num_layers=1,
                 bias=True, dropout=0.0, bidirectional=False,
                 return_hidden=False, init_criterion="glorot",
                 weight_init="complex"):
        self.act = _act(nonlinearity)
        self.normalization = normalization
        super().__init__(hidden_size, input_shape, input_size, num_layers,
                         bias, dropout, bidirectional, return_hidden,
                         init_criterion, weight_init)

    def _make_norm(self):
        width = 4 * self.hidden_size
        if self.normalization == "batchnorm":
            return CBatchNorm(input_size=width, dim=-1, momentum=0.05)
        return CLayerNorm(input_size=width, dim=-1)

    def _post_w(self, layer, w, train):
        flat = w.reshape(-1, w.shape[-1])
        if self.normalization == "batchnorm":
            flat = layer.norm(flat, train=train)
        else:
            flat = layer.norm(flat)
        return flat.reshape(w.shape)

    def _step(self, w_t, h, c, u, drop_mask):
        gates = w_t + u(h)
        at, zt = gates[:, :self.width], torch.sigmoid(gates[:, self.width:])
        return zt * h + (1 - zt) * self.act(at) * drop_mask, c


CRNN_Layer = CRNN
CLSTM_Layer = CLSTM
CLiGRU_Layer = CLiGRU
