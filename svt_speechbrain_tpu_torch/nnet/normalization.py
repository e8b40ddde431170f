"""Layer, group and batch normalization (port of
``svt_speechbrain_tpu/nnet/normalization.py``). Channel-last; statistics are
taken in f32 for low-precision inputs (in f64 for f64 inputs, so that an
f64 run can referee an f32 one) and the result is cast back."""
from __future__ import annotations

import torch
from torch import nn


def wide(x):
    """``x`` in the dtype its statistics are taken in: f32, or f64 for an
    f64 tensor.

    Example
    -------
    >>> import torch
    >>> wide(torch.ones(1, dtype=torch.bfloat16)).dtype, wide(
    ...     torch.ones(1, dtype=torch.float64)).dtype
    (torch.float32, torch.float64)
    """
    return x if x.dtype == torch.float64 else x.float()


class LayerNorm(nn.Module):
    """Layer norm over the trailing axis (``normalization.py:22``), with
    ``scale``/``bias`` of ``input_size`` when ``elementwise_affine`` (then
    ``input_size`` is needed), none otherwise.

    Example
    -------
    >>> import torch
    >>> ln = LayerNorm(input_size=4)
    >>> y = ln(torch.tensor([[1.0, 2.0, 3.0, 4.0]]))
    >>> round(float(y.mean()), 6), round(float(y.std(unbiased=False)), 4)
    (0.0, 1.0)
    """

    def __init__(self, input_size=None, eps=1e-5, elementwise_affine=True):
        super().__init__()
        self.input_size = input_size
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.scale = self.bias = None
        if elementwise_affine:
            if input_size is None:
                raise ValueError("an affine LayerNorm needs input_size")
            self.scale = nn.Parameter(torch.ones(input_size))
            self.bias = nn.Parameter(torch.zeros(input_size))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, eps=self.eps)


def layer_norm(x, scale=None, bias=None, eps=1e-5, axis=-1):
    """Functional layer norm over ``axis`` (``normalization.py:59``)."""
    x32 = wide(x)
    mean = x32.mean(dim=axis, keepdim=True)
    var = (x32 - mean).square().mean(dim=axis, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def global_layer_norm(x, eps=1e-5, row_mask=None):
    """Normalize over all elements of ``x`` (``normalization.py:73``);
    ``row_mask`` (B,) excludes batch-padding rows from the statistics."""
    x32 = wide(x)
    if row_mask is None:
        mean = x32.mean()
        var = (x32 - mean).square().mean()
    else:
        m = row_mask.to(x32.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
        count = m.sum() * (x32.numel() / x32.shape[0])
        mean = (x32 * m).sum() / count
        var = ((x32 - mean).square() * m).sum() / count
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _masked_stats(x32, m, dims):
    count = torch.clamp(m.sum(dim=dims, keepdim=True), min=1.0)
    mean = (x32 * m).sum(dim=dims, keepdim=True) / count
    var = ((x32 - mean).square() * m).sum(dim=dims, keepdim=True) / count
    return mean, var


def masked_global_layer_norm(x, elem_mask, eps=1e-5):
    """Whole-tensor layer norm with statistics over ``elem_mask`` positions
    only (``normalization.py:94``)."""
    x32 = wide(x)
    m = elem_mask.to(x32.dtype)
    while m.dim() < x32.dim():
        m = m[..., None]
    m = m.expand(x32.shape)
    mean, var = _masked_stats(x32, m, tuple(range(x32.dim())))
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def per_item_layer_norm(x, eps=1e-5):
    """Normalize each batch row over all of its elements
    (``normalization.py:110``)."""
    x32 = wide(x)
    dims = tuple(range(1, x.dim()))
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def per_item_masked_layer_norm(x, valid, eps=1e-5):
    """Per-row layer norm over the row's valid positions only
    (``models/wav2vec2.py:604 _per_item_masked_norm``): equal to
    ``per_item_layer_norm`` of the unpadded row."""
    x32 = wide(x)
    m = valid.to(x32.dtype)
    while m.dim() < x32.dim():
        m = m[..., None]
    m = m.expand(x32.shape)
    mean, var = _masked_stats(x32, m, tuple(range(1, x32.dim())))
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class GroupNorm(nn.Module):
    """Group norm over channel-last input (``normalization.py:122``):
    (batch, ..., channels), the channels split into ``num_groups`` groups,
    statistics in f32 over every axis but (batch, group), then ``scale``
    and ``bias`` per channel when ``affine``, the result cast back.

    Example
    -------
    >>> import torch
    >>> gn = GroupNorm(input_size=4, num_groups=2)
    >>> x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    >>> y = gn(x)
    >>> y.shape, round(float(y[0, :, :2].mean()), 6)
    (torch.Size([2, 3, 4]), 0.0)
    """

    def __init__(self, input_size, num_groups, eps=1e-05, affine=True):
        super().__init__()
        if input_size % num_groups:
            raise ValueError("input_size must be divisible by num_groups")
        self.input_size = input_size
        self.num_groups = num_groups
        self.eps = eps
        self.affine = affine
        self.scale = self.bias = None
        if affine:
            self.scale = nn.Parameter(torch.ones(input_size))
            self.bias = nn.Parameter(torch.zeros(input_size))

    def forward(self, x):
        b, g = x.shape[0], self.num_groups
        x32 = wide(x).reshape(b, -1, g, self.input_size // g)
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = (x32 - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        if self.affine:
            y = y * self.scale + self.bias
        return y.to(x.dtype)


class _BatchNorm(nn.Module):
    """Batch norm over channel-last input (``normalization.py:159``):
    (batch, ..., channels), statistics over every axis but the last.

    ``scale``/``bias`` are parameters; the running ``mean``/``var`` are f32
    buffers, so checkpoints carry them and a cast of the parameters (bf16
    compute) leaves them f32. In training the batch is normalized with the
    JAX formula, not cuDNN's: mean and mean of squares over the batch, the
    biased ``var = E[x²] - E[x]²``; the running estimate takes the unbiased
    ``var · n/(n-1)`` by ``(1-m)·old + m·new`` (m = ``momentum``), outside
    autograd. Padded frames count in the statistics, as in the JAX package.
    In eval the buffers normalize.

    With ``axis_name`` in training the statistics are cross-replica (SyncBN,
    ``normalization.py:183-197``): the mean and the mean of squares are
    averaged over the ranks of that dim of the active mesh
    (``parallel.mesh.use_mesh``), or of the whole process group without
    one, by an all-reduce with autograd; ``n`` counts every rank's rows, so
    every rank keeps the same running statistics.

    Example
    -------
    >>> import torch
    >>> bn = BatchNorm1d(input_size=3)
    >>> x = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    >>> y = bn(x, train=True)
    >>> y.shape, [round(float(m), 2) for m in bn.mean]
    (torch.Size([2, 4, 3]), [1.05, 1.15, 1.25])
    """

    def __init__(self, input_size, eps=1e-05, momentum=0.1, affine=True):
        super().__init__()
        self.input_size = input_size
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.scale = nn.Parameter(torch.ones(input_size))
            self.bias = nn.Parameter(torch.zeros(input_size))
        self.register_buffer("mean", torch.zeros(input_size))
        self.register_buffer("var", torch.ones(input_size))

    def forward(self, x, train=False, axis_name=None):
        x32 = wide(x)
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=dims)
            mean_sq = x32.square().mean(dim=dims)
            n = x32.numel() // x32.shape[-1]
            if axis_name is not None:
                mean, mean_sq, replicas = _cross_replica_mean(
                    mean, mean_sq, axis_name)
                n *= replicas
            var = mean_sq - mean.square()
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var
                               + m * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.mean, self.var
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.scale + self.bias
        return y.to(x.dtype)


def _cross_replica_mean(mean, mean_sq, axis_name):
    """(mean, mean of squares) averaged over the replicas of ``axis_name``
    (a dim of the active mesh, or the whole process group), with autograd;
    and the number of replicas."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    from svt_speechbrain_tpu_torch.parallel.mesh import active_mesh

    mesh = active_mesh()
    group = (mesh.get_group(axis_name) if mesh is not None
             and axis_name in (mesh.mesh_dim_names or ()) else
             dist.group.WORLD)
    replicas = dist.get_world_size(group)
    both = all_reduce(torch.stack([mean, mean_sq]), group=group) / replicas
    return both[0], both[1], replicas


class BatchNorm1d(_BatchNorm):
    """Batch norm over (batch, time, channels) (``normalization.py:213``)."""


class BatchNorm2d(_BatchNorm):
    """Batch norm over (batch, H, W, channels) (``normalization.py:231``)."""


class BatchNorm3d(_BatchNorm):
    """Batch norm over (batch, T, H, W, channels): the Conv3d visual
    frontend's (``normalization.py:235``)."""


class _InstanceNorm(nn.Module):
    """Instance norm over channel-last input: each (batch, channel)
    normalized over the spatial axes, statistics in f32, then ``scale`` and
    ``bias`` per channel when ``affine``."""

    def __init__(self, input_size, eps=1e-05, affine=False):
        super().__init__()
        self.input_size = input_size
        self.eps = eps
        self.affine = affine
        self.scale = self.bias = None
        if affine:
            self.scale = nn.Parameter(torch.ones(input_size))
            self.bias = nn.Parameter(torch.zeros(input_size))

    def forward(self, x):
        x32 = wide(x)
        dims = tuple(range(1, x.dim() - 1))
        mean = x32.mean(dim=dims, keepdim=True)
        var = (x32 - mean).square().mean(dim=dims, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.scale + self.bias
        return y.to(x.dtype)


class InstanceNorm1d(_InstanceNorm):
    """Instance norm of (batch, time, channels) over time
    (``normalization.py:240``). The JAX module applies its affine
    ``scale``/``bias`` along the time axis of its swapped view, which
    broadcasts only when T equals the channels (``ROADMAP.md`` queue 3);
    here they act per channel, as the reference's ``InstanceNorm1d``.

    Example
    -------
    >>> import torch
    >>> y = InstanceNorm1d(2)(torch.tensor([[[1.0, 5.0], [3.0, 9.0]]]))
    >>> [[round(v, 3) for v in row] for row in y[0].tolist()]
    [[-1.0, -1.0], [1.0, 1.0]]
    """


class InstanceNorm2d(_InstanceNorm):
    """Instance norm of (batch, T, F, channels) over (T, F)
    (``normalization.py:267``)."""
