"""Quaternion-valued networks (port of
``svt_speechbrain_tpu/nnet/quaternion_networks.py``). A quaternion tensor
of width 4N is stored as ``[r_0..r_{N-1}, i_0.., j_0.., k_0..]`` on the
last axis; the layers compute the Hamilton product W ⊗ x (the weight on
the left) as real products.

The JAX module's quirks are kept (its docstring, ``:11-34``):

- the recurrences slice their fused gate projections contiguously (4H
  real lanes a gate, across the quaternion packing) and always return
  (output, h);
- ``QLiGRU`` normalizes only with "batchnorm" (any other string applies
  nothing) and its default nonlinearity is leaky_relu;
- ``QBatchNorm`` never subtracts the mean in training (x / sqrt(var +
  eps)); eval subtracts the running mean and divides by the raw running
  variance (no sqrt, no eps); the batch statistics reduce over axis 0 and
  the running update averages the leading axes of a >2-D input;
- the rotation (spinor) ops: the linear op adds its 1e-4 outside the sqrt
  of the weight's norm and indexes the rotation by input component; the
  conv op puts it inside and indexes by output channel (``:708-760``).

Parameters have the JAX trees' names; a conv's ``r``/``i``/``j``/``k``
children are ``Conv1d``/``Conv2d`` (``convert_jax`` fills them in torch's
layout) and a conv's ``scale`` keeps the JAX layout (*k, in, out). The
running statistics are buffers. The seeded draws take a
``torch.Generator``; ``rng`` is a ``StepRNG`` for the dropout masks."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from svt_speechbrain_tpu_torch.nnet.cnn import (Conv1d, Conv2d,
                                                jax_to_torch_conv_weight)
from svt_speechbrain_tpu_torch.nnet.complex_networks import (
    _RecurrenceBase, _conv_with, _lstm_step, _uniform)


def check_quaternion_input(input_shape):
    """Raise unless the last axis divides by 4
    (``quaternion_networks.py:45``)."""
    if input_shape[-1] % 4:
        raise ValueError("Quaternion tensors must have a last dim divisible "
                         "by 4")


def split_quaternion(x):
    """The (r, i, j, k) quarters of the last axis."""
    n = x.shape[-1] // 4
    return x[..., :n], x[..., n:2 * n], x[..., 2 * n:3 * n], x[..., 3 * n:]


def quaternion_init(generator, in_features, out_features, criterion="glorot"):
    """Polar quaternion draw (``quaternion_networks.py:55``): modulus the
    norm of 4 normal draws times s (s = 1/√(2(fan_in + fan_out)) for
    glorot, 1/√(2 fan_in) for he), a unit pure-imaginary axis (uniform over
    its norm plus 1e-4), a phase U(-π, π); four numpy (in, out) arrays."""
    s = (1.0 / np.sqrt(2.0 * (in_features + out_features))
         if criterion == "glorot" else 1.0 / np.sqrt(2.0 * in_features))
    shape = (in_features, out_features)
    modulus = s * torch.sqrt((torch.randn(shape + (4,), generator=generator)
                              ** 2).sum(dim=-1))
    v = _uniform(generator, shape + (3,), -1.0, 1.0)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-4)
    phase = _uniform(generator, shape, -np.pi, np.pi)
    sin = modulus * torch.sin(phase)
    return tuple(t.numpy() for t in (modulus * torch.cos(phase),
                                     v[..., 0] * sin, v[..., 1] * sin,
                                     v[..., 2] * sin))


def unitary_init(generator, in_features, out_features, criterion="he"):
    """Unit-quaternion draw (``quaternion_networks.py:658``): uniform
    components over their norm plus 1e-4."""
    k = _uniform(generator, (4, in_features, out_features), -1.0, 1.0)
    k = k / (torch.sqrt(k.square().sum(dim=0, keepdim=True)) + 1e-4)
    return tuple(t.numpy() for t in k)


_INITS = {"quaternion": quaternion_init, "unitary": unitary_init}


def affect_init(r, i, j, k, init_func, generator, criterion="glorot"):
    """A new draw of ``init_func`` at the weights' (in, out) shape
    (``quaternion_networks.py:669``)."""
    return init_func(generator, r.shape[0], r.shape[1], criterion)


def affect_conv_init(r, i, j, k, kernel_size, init_func, generator,
                     criterion="glorot"):
    """A draw at the (in, out) of the last two axes, broadcast to the
    weights' shape (``quaternion_networks.py:675``)."""
    comps = init_func(generator, r.shape[-2], r.shape[-1], criterion)
    return tuple(np.broadcast_to(c, tuple(r.shape)) for c in comps)


def quaternion_linear_op(x, wr, wi, wj, wk, bias=None):
    """y = W ⊗ x over packed tensors, weights (in, out)
    (``quaternion_networks.py:77``).

    Example
    -------
    >>> import torch
    >>> x = torch.tensor([[0.0, 1.0, 0.0, 0.0]])               # i
    >>> w = [torch.tensor([[v]]) for v in (0.0, 0.0, 1.0, 0.0)]  # j
    >>> quaternion_linear_op(x, *w).tolist()                   # j ⊗ i = -k
    [[0.0, 0.0, 0.0, -1.0]]
    """
    xr, xi, xj, xk = split_quaternion(x)
    wr, wi, wj, wk = (w.to(x.dtype) for w in (wr, wi, wj, wk))
    y = torch.cat([xr @ wr - xi @ wi - xj @ wj - xk @ wk,
                   xr @ wi + xi @ wr - xj @ wk + xk @ wj,
                   xr @ wj + xi @ wk + xj @ wr - xk @ wi,
                   xr @ wk - xi @ wj + xj @ wi + xk @ wr], dim=-1)
    return y if bias is None else y + bias


QuaternionLinearCustomBackward = quaternion_linear_op


def _rotation_coeffs(wr, wi, wj, wk, eps_inside):
    """The rotation-matrix rows of the normalized weights; ``eps_inside``
    puts 1e-4 inside the norm's sqrt (the conv op), else outside (the
    linear op) (``quaternion_networks.py:708``)."""
    sq = wr ** 2 + wi ** 2 + wj ** 2 + wk ** 2
    n = torch.sqrt(sq + 1e-4) if eps_inside else torch.sqrt(sq) + 1e-4
    r, i, j, k = wr / n, wi / n, wj / n, wk / n
    sq_i, sq_j, sq_k = 2 * i * i, 2 * j * j, 2 * k * k
    ri, rj, rk = 2 * r * i, 2 * r * j, 2 * r * k
    ij, ik, jk = 2 * i * j, 2 * i * k, 2 * j * k
    return ((1 - (sq_j + sq_k), ij - rk, ik + rj),
            (ij + rk, 1 - (sq_i + sq_k), jk - ri),
            (ik - rj, jk + ri, 1 - (sq_i + sq_j)))


def quaternion_linear_rotation_op(x, wr, wi, wj, wk, bias=None, scale=None):
    """The vector part of ``x`` rotated by each weight's unit quaternion
    (``quaternion_networks.py:728``), rows indexed by input component; the
    real part of the output is zero."""
    _, xi, xj, xk = split_quaternion(x)
    rows = _rotation_coeffs(*(w.to(x.dtype) for w in (wr, wi, wj, wk)),
                            eps_inside=False)
    if scale is not None:
        rows = tuple(tuple(scale.to(x.dtype) * w for w in row)
                     for row in rows)
    (a1, a2, a3), (b1, b2, b3), (c1, c2, c3) = rows
    yi = xi @ a1 + xj @ b1 + xk @ c1
    yj = xi @ a2 + xj @ b2 + xk @ c2
    yk = xi @ a3 + xj @ b3 + xk @ c3
    y = torch.cat([torch.zeros_like(yi), yi, yj, yk], dim=-1)
    return y if bias is None else y + bias


def _functional_conv(weight_jax, stride, padding, dilation, conv1d):
    cls = Conv1d if conv1d else Conv2d
    k = tuple(weight_jax.shape[:-2])
    return cls(weight_jax.shape[-1], k if len(k) > 1 else k[0],
               weight_jax.shape[-2], stride=stride, dilation=dilation,
               padding=padding, bias=False)


def quaternion_conv_op(x, wr, wi, wj, wk, bias, stride=1, padding="same",
                       dilation=1, conv1d=True):
    """The functional quaternion conv, W ⊗ x (``quaternion_networks.py:
    683``): weights in the JAX layout (*k, in, out), zero padding."""
    conv = _functional_conv(wr, stride, padding, dilation, conv1d)
    ws = [jax_to_torch_conv_weight(w) for w in (wr, wi, wj, wk)]
    return _hamilton_conv(lambda c, v: _conv_with(conv, ws["rijk".index(c)],
                                                  v), x, bias)


def quaternion_conv_rotation_op(x, wr, wi, wj, wk, bias=None, scale=None,
                                stride=1, padding="same", dilation=1,
                                conv1d=True):
    """The conv rotation op (``quaternion_networks.py:753``): weights (and
    ``scale``) in the JAX layout, rotation kernels by output channel, the
    norm's eps inside its sqrt."""
    conv = _functional_conv(wr, stride, padding, dilation, conv1d)
    ws = [jax_to_torch_conv_weight(w) for w in (wr, wi, wj, wk)]
    scale = None if scale is None else jax_to_torch_conv_weight(scale)
    return _rotation_conv(lambda w, v: _conv_with(conv, w, v), ws, scale, x,
                          bias)


def _hamilton_conv(cv, x, bias):
    xr, xi, xj, xk = split_quaternion(x)
    y = torch.cat([cv("r", xr) - cv("i", xi) - cv("j", xj) - cv("k", xk),
                   cv("i", xr) + cv("r", xi) - cv("k", xj) + cv("j", xk),
                   cv("j", xr) + cv("k", xi) + cv("r", xj) - cv("i", xk),
                   cv("k", xr) - cv("j", xi) + cv("i", xj) + cv("r", xk)],
                  dim=-1)
    return y if bias is None else y + bias


def _rotation_conv(cv, ws, scale, x, bias):
    rows = _rotation_coeffs(*ws, eps_inside=True)
    if scale is not None:
        rows = tuple(tuple(scale * w for w in row) for row in rows)
    (a1, a2, a3), (b1, b2, b3), (c1, c2, c3) = rows
    _, xi, xj, xk = split_quaternion(x)
    yi = cv(a1, xi) + cv(a2, xj) + cv(a3, xk)
    yj = cv(b1, xi) + cv(b2, xj) + cv(b3, xk)
    yk = cv(c1, xi) + cv(c2, xj) + cv(c3, xk)
    y = torch.cat([torch.zeros_like(yi), yi, yj, yk], dim=-1)
    return y if bias is None else y + bias


class QLinear(nn.Module):
    """Quaternion linear layer (``quaternion_networks.py:100``):
    ``n_neurons`` quaternion units (4·n_neurons reals out), parameters
    ``r_weight``..``k_weight`` (in/4, n_neurons), a zero-started ``bias``;
    with ``spinor`` a rotation of the vector part, and with
    ``vector_scale`` a learnable ``scale`` (in/4, n_neurons) of it.

    Example
    -------
    >>> import torch
    >>> QLinear(n_neurons=4, input_size=8)(torch.ones(2, 8)).shape
    torch.Size([2, 16])
    """

    def __init__(self, n_neurons, input_shape=None, input_size=None,
                 bias=True, init_criterion="glorot", weight_init="quaternion",
                 autograd=True, spinor=False, vector_scale=False):
        super().__init__()
        if input_size is None and input_shape is not None:
            input_size = input_shape[-1]
        check_quaternion_input((input_size,))
        self.in_q = input_size // 4
        self.n_neurons = n_neurons
        self.init_criterion = init_criterion
        self.weight_init = weight_init
        self.spinor = spinor
        self.vector_scale = vector_scale
        for c in "rijk":
            setattr(self, f"{c}_weight", nn.Parameter(torch.zeros(
                self.in_q, n_neurons)))
        self.scale = (nn.Parameter(torch.zeros(self.in_q, n_neurons))
                      if spinor and vector_scale else None)
        self.bias = nn.Parameter(torch.zeros(4 * n_neurons)) if bias else None

    def init_tree(self, generator):
        """The seeded JAX-shaped tree of the layer."""
        comps = _INITS[self.weight_init](generator, self.in_q,
                                         self.n_neurons, self.init_criterion)
        tree = {f"{c}_weight": w for c, w in zip("rijk", comps)}
        if self.scale is not None:
            bound = np.sqrt(6.0 / (self.in_q + self.n_neurons))
            tree["scale"] = _uniform(generator, (self.in_q, self.n_neurons),
                                     -bound, bound).numpy()
        if self.bias is not None:
            tree["bias"] = np.zeros(4 * self.n_neurons, np.float32)
        return tree

    def forward(self, x):
        ws = (self.r_weight, self.i_weight, self.j_weight, self.k_weight)
        if self.spinor:
            return quaternion_linear_rotation_op(x, *ws, self.bias,
                                                 self.scale)
        return quaternion_linear_op(x, *ws, self.bias)


class _QConvNd(nn.Module):
    """The quaternion convs: ``r``, ``i``, ``j``, ``k`` bias-free real convs
    (odd kernels, reflect "same" by default, causal zero-padded), a
    zero-started ``bias``, and with ``spinor`` the rotation form
    (``quaternion_networks.py:155``)."""

    NDIM = 1

    def __init__(self, out_channels, kernel_size, input_shape=None,
                 input_size=None, stride=1, dilation=1, padding="same",
                 groups=1, bias=True, padding_mode="reflect",
                 init_criterion="glorot", weight_init="quaternion",
                 spinor=False, vector_scale=False):
        super().__init__()
        if input_size is None and input_shape is not None:
            input_size = input_shape[-1]
        check_quaternion_input((input_size,))
        self.manual_pads = None
        if self.NDIM == 1:
            if kernel_size % 2 == 0:
                raise ValueError("The field kernel size must be an odd "
                                 f"number. Got {kernel_size}.")
            self.ksize = (kernel_size,)
            conv_k, conv_s, conv_d, conv_padding = (kernel_size, stride,
                                                    dilation, padding)
            cls = Conv1d
            if padding == "causal":
                padding_mode = "zeros"
        else:
            def pair(v):
                return (v, v) if isinstance(v, int) else tuple(v)

            self.ksize = pair(kernel_size)
            if self.ksize[0] % 2 == 0 or self.ksize[1] % 2 == 0:
                raise ValueError("The field kernel size must be an odd "
                                 f"number. Got {self.ksize}.")
            if padding == "causal":
                raise ValueError("Padding must be 'same' or 'valid' for "
                                 "QConv2d")
            s, d = pair(stride), pair(dilation)
            # the reference runs the conv at stride[0]/dilation[0] on both
            # axes; the per-axis values only size the "same" padding
            conv_k, conv_s, conv_d, conv_padding = ((self.ksize[1],
                                                     self.ksize[0]),
                                                    s[0], d[0], "valid")
            if padding == "same":
                def pad_amt(k, st, dl):
                    return k // 2 if st > 1 else dl * (k - 1) // 2

                self.manual_pads = [
                    (pad_amt(self.ksize[1], s[1], d[1]),) * 2,
                    (pad_amt(self.ksize[0], s[0], d[0]),) * 2]
            cls = Conv2d
        self.padding = padding
        self.padding_mode = padding_mode
        self.in_q = input_size // 4
        self.out_channels = out_channels
        self.init_criterion = init_criterion
        self.weight_init = weight_init
        self.spinor = spinor
        self.vector_scale = vector_scale
        for c in "rijk":
            self.add_module(c, cls(out_channels, conv_k, self.in_q,
                                   stride=conv_s, dilation=conv_d,
                                   padding=conv_padding, groups=groups,
                                   padding_mode=padding_mode, bias=False))
        shape = self._jax_shape()
        self.scale = (nn.Parameter(torch.zeros(shape))
                      if spinor and vector_scale else None)
        self.bias = (nn.Parameter(torch.zeros(4 * out_channels)) if bias
                     else None)

    def _jax_shape(self):
        return tuple(reversed(self.ksize)) + (self.in_q, self.out_channels)

    def init_tree(self, generator):
        """The seeded JAX-shaped tree: ``r``..``k`` ``w`` (*k, in, out) from
        one draw at (in·receptive field, out), ``scale`` uniform in
        ±√(6/(in + out)), zero ``bias``."""
        shape = self._jax_shape()
        comps = _INITS[self.weight_init](
            generator, self.in_q * int(np.prod(self.ksize)), self.out_channels,
            self.init_criterion)
        tree = {c: {"w": w.reshape(shape)} for c, w in zip("rijk", comps)}
        if self.scale is not None:
            bound = np.sqrt(6.0 / (self.in_q + self.out_channels))
            tree["scale"] = _uniform(generator, shape, -bound,
                                     bound).numpy()
        if self.bias is not None:
            tree["bias"] = np.zeros(4 * self.out_channels, np.float32)
        return tree

    def _maybe_pad(self, x):
        if self.manual_pads is None:
            return x
        mode = {"zeros": "constant", "reflect": "reflect",
                "replicate": "replicate",
                "circular": "circular"}[self.padding_mode]
        flat = [v for pair in reversed(self.manual_pads) for v in pair]
        return torch.nn.functional.pad(x.movedim(-1, 1), flat,
                                       mode=mode).movedim(1, -1)

    def forward(self, x):
        x = self._maybe_pad(x)
        if self.spinor:
            ws = [getattr(self, c).weight for c in "rijk"]
            scale = (None if self.scale is None
                     else jax_to_torch_conv_weight(self.scale))
            return _rotation_conv(
                lambda w, v: _conv_with(self.r, w, v), ws, scale, x,
                self.bias)
        return _hamilton_conv(lambda c, v: getattr(self, c)(v), x, self.bias)


class QConv1d(_QConvNd):
    """Quaternion 1-D conv over (B, T, 4C) (``quaternion_networks.py:293``).

    Example
    -------
    >>> import torch
    >>> QConv1d(out_channels=3, kernel_size=3, input_size=8)(
    ...     torch.ones(2, 16, 8)).shape
    torch.Size([2, 16, 12])
    """

    NDIM = 1


class QConv2d(_QConvNd):
    """Quaternion 2-D conv over (B, T, F, 4C) (``quaternion_networks.py:
    309``): ``kernel_size[0]`` along the features, ``[1]`` along time; the
    conv runs at stride[0] and dilation[0] on both axes, as the reference.

    Example
    -------
    >>> import torch
    >>> QConv2d(out_channels=3, kernel_size=3, input_size=8)(
    ...     torch.ones(2, 10, 12, 8)).shape
    torch.Size([2, 10, 12, 12])
    """

    NDIM = 2


class QBatchNorm(nn.Module):
    """Quaternion batch norm with the reference's quirks
    (``quaternion_networks.py:325``): one variance shared by a unit's four
    components; training divides the uncentred input by sqrt(var + eps)
    and moves the buffers ``running_mean`` (4n), ``running_var`` (n) and
    ``num_batches_tracked``; eval subtracts the running mean and divides by
    the running variance; then ``gamma`` (n, repeated 4 times) and
    ``beta`` (4n).

    Example
    -------
    >>> import torch
    >>> bn = QBatchNorm(input_size=8)
    >>> bn(torch.randn(4, 8), train=True).shape
    torch.Size([4, 8])
    """

    def __init__(self, input_size, dim=-1, gamma_init=1.0, beta_param=True,
                 momentum=0.1, eps=1e-4, track_running_stats=True):
        super().__init__()
        check_quaternion_input((input_size,))
        if dim != -1:
            raise ValueError("QBatchNorm supports dim=-1 (the reference "
                             "default; its chunk() uses the same axis)")
        self.num_features = n = input_size // 4
        self.gamma_init = gamma_init
        self.beta_param = beta_param
        self.momentum = momentum
        self.eps = eps
        self.track_running_stats = track_running_stats
        self.gamma = nn.Parameter(torch.full((n,), float(gamma_init)))
        self.beta = nn.Parameter(torch.zeros(4 * n))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(4 * n))
            self.register_buffer("running_var", torch.ones(n))

    def init_tree(self, generator):
        """The constant JAX tree {"gamma", "beta"}."""
        n = self.num_features
        return {"gamma": np.full(n, self.gamma_init, np.float32),
                "beta": np.zeros(4 * n, np.float32)}

    def forward(self, x, train=False):
        n = self.num_features
        if train:
            mu = x.mean(dim=0)
            dr, di, dj, dk = split_quaternion(x - mu)
            quat_var = (dr ** 2 + di ** 2 + dj ** 2 + dk ** 2).mean(dim=0)
            out = x / torch.sqrt(quat_var + self.eps).repeat(
                *([1] * (quat_var.dim() - 1)), 4)
            with torch.no_grad():
                self.num_batches_tracked += 1
                if self.track_running_stats:
                    f = (1.0 / float(self.num_batches_tracked)
                         if self.momentum is None else self.momentum)
                    self.running_mean.copy_(
                        (1 - f) * self.running_mean
                        + f * mu.reshape(-1, 4 * n).mean(dim=0))
                    self.running_var.copy_(
                        (1 - f) * self.running_var
                        + f * quat_var.reshape(-1, n).mean(dim=0))
        else:
            out = (x - self.running_mean) / self.running_var.repeat(4)
        return self.gamma.repeat(4) * out + self.beta


class _QRNNBase(_RecurrenceBase):
    """The quaternion recurrences (``quaternion_networks.py:403``):
    ``forward`` always returns (output, h)."""

    COMPONENTS = 4
    PROJ = QLinear

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 num_layers=1, bias=True, dropout=0.0, bidirectional=False,
                 init_criterion="glorot", weight_init="quaternion",
                 autograd=True):
        super().__init__(hidden_size, input_shape, input_size, num_layers,
                         bias, dropout, bidirectional, init_criterion,
                         weight_init)

    def forward(self, x, hx=None, train=False, rng=None):
        return self._forward(x, hx=hx, train=train, rng=rng)


class QRNN(_QRNNBase):
    """Vanilla quaternion RNN (``quaternion_networks.py:503``): h_t =
    act(w x_t + u h_{t-1}) · drop_mask.

    Example
    -------
    >>> import torch
    >>> out, h = QRNN(hidden_size=2, input_size=8)(torch.ones(2, 10, 8))
    >>> out.shape
    torch.Size([2, 10, 8])
    """

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 nonlinearity="tanh", num_layers=1, bias=True, dropout=0.0,
                 bidirectional=False, init_criterion="glorot",
                 weight_init="quaternion", autograd=True):
        self.act = torch.tanh if nonlinearity == "tanh" else torch.relu
        super().__init__(hidden_size, input_shape, input_size, num_layers,
                         bias, dropout, bidirectional, init_criterion,
                         weight_init)

    def _step(self, w_t, h, c, u, drop_mask):
        return self.act(w_t + u(h)) * drop_mask, c


class QLSTM(_QRNNBase):
    """Quaternion LSTM (``quaternion_networks.py:538``): contiguous (i, f,
    o, c~) slices of 4H reals; c_t = i·tanh(c~)·drop + f·c, h_t =
    o·tanh(c_t).

    Example
    -------
    >>> import torch
    >>> out, h = QLSTM(hidden_size=2, input_size=8)(torch.ones(2, 7, 8))
    >>> out.shape
    torch.Size([2, 7, 8])
    """

    GATE_NEURONS = 4
    PROJ_BIAS = True

    def _step(self, w_t, h, c, u, drop_mask):
        return _lstm_step(w_t, h, c, u, drop_mask, self.width)


class QLiGRU(_QRNNBase):
    """Quaternion light GRU (``quaternion_networks.py:576``): contiguous
    (a, z) slices; h_t = z·h + (1-z)·act(a)·drop, leaky_relu by default;
    "batchnorm" normalizes the flattened input projection with a
    ``QBatchNorm`` (buffers), any other string applies nothing.

    Example
    -------
    >>> import torch
    >>> out, h = QLiGRU(hidden_size=2, input_size=8)(torch.ones(2, 7, 8))
    >>> out.shape
    torch.Size([2, 7, 8])
    """

    GATE_NEURONS = 2

    def __init__(self, hidden_size, input_shape=None, input_size=None,
                 nonlinearity="leaky_relu", normalization="batchnorm",
                 num_layers=1, bias=True, dropout=0.0, bidirectional=False,
                 init_criterion="glorot", weight_init="quaternion",
                 autograd=True):
        self.act = {"tanh": torch.tanh,
                    "leaky_relu": torch.nn.functional.leaky_relu}.get(
                        nonlinearity, torch.relu)
        self.normalization = normalization
        self.normalize = normalization == "batchnorm"
        super().__init__(hidden_size, input_shape, input_size, num_layers,
                         bias, dropout, bidirectional, init_criterion,
                         weight_init)

    def _make_norm(self):
        return (QBatchNorm(input_size=8 * self.hidden_size, dim=-1)
                if self.normalize else None)

    def _post_w(self, layer, w, train):
        if not self.normalize:
            return w
        return layer.norm(w.reshape(-1, w.shape[-1]),
                          train=train).reshape(w.shape)

    def _step(self, w_t, h, c, u, drop_mask):
        gates = w_t + u(h)
        at, zt = gates[:, :self.width], torch.sigmoid(gates[:, self.width:])
        return zt * h + (1 - zt) * self.act(at) * drop_mask, c


QRNN_Layer = QRNN
QLSTM_Layer = QLSTM
QLiGRU_Layer = QLiGRU
