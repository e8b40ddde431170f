"""Linear transformation (port of ``svt_speechbrain_tpu/nnet/linear.py``)."""
from __future__ import annotations

import torch
from torch import nn

from svt_speechbrain_tpu_torch.ops.quant import PackedWeight, int8_matmul


class Linear(nn.Module):
    """y = x @ w + b over the trailing feature axis (``linear.py:15``).

    ``w`` is stored (in, out), as in the JAX package, so the converted
    weights load without a transpose. In bf16 the product is emitted in the
    input dtype and the bias is added after, in that dtype (the JAX
    ``preferred_element_type=x.dtype`` rule). Without ``bias`` the module
    has no ``b`` (it is None). With ``combine_dims`` a 4-D input (B, T, C,
    F) has its last two axes joined before the product (``linear.py:
    60-66``).

    ``to_int8_`` turns the layer into its int8 serving form
    (``linear.py:58-61``): the buffers ``w_q8`` (in, out) int8 and
    ``w_scale`` (out,) take the place of ``w``, the product goes through
    ``ops.quant.int8_matmul`` and the bias, if any, is added after it, in
    the input dtype. ``models/quantize.py`` makes such layers.

    Example
    -------
    >>> import torch
    >>> lin = Linear(n_neurons=4, input_size=8)
    >>> lin(torch.ones(2, 3, 8)).shape
    torch.Size([2, 3, 4])
    >>> Linear(4, 6, bias=False, combine_dims=True)(torch.ones(2, 3, 2, 3)).shape
    torch.Size([2, 3, 4])
    """

    def __init__(self, n_neurons, input_size, bias=True, combine_dims=False):
        super().__init__()
        self.n_neurons = n_neurons
        self.input_size = input_size
        self.combine_dims = combine_dims
        self.w = nn.Parameter(torch.zeros(input_size, n_neurons))
        self.b = nn.Parameter(torch.zeros(n_neurons)) if bias else None

    def to_int8_(self, name, w_q8, w_scale):
        """In place: replace the float weight ``name`` (always "w" here) by
        the buffers ``w_q8`` / ``w_scale``."""
        if name != "w":
            raise KeyError(name)
        if "w" in self._parameters:
            del self.w
        for key, value in (("w_q8", w_q8), ("w_scale", w_scale)):
            self._buffers.pop(key, None)
            self.register_buffer(key, value)
        self._packed = PackedWeight()
        return self

    def _weight(self):
        return self.w

    def forward(self, x):
        if x.dim() == 4 and self.combine_dims:
            x = x.reshape(x.shape[0], x.shape[1], x.shape[2] * x.shape[3])
        if "w_q8" in self._buffers:
            y = int8_matmul(x, self.w_q8, self.w_scale,
                            self._packed(self.w_q8))
        else:
            y = torch.matmul(x, self._weight().to(x.dtype))
        return y if self.b is None else y + self.b


class LinearWithConstraint(Linear):
    """``Linear`` with a max-norm constraint on each output's weight column,
    applied at call time (``linear.py:69``): the column is scaled by
    min(1, max_norm / max(‖column‖, 1e-12)).

    Example
    -------
    >>> import torch
    >>> lin = LinearWithConstraint(2, 4, max_norm=0.5)
    >>> with torch.no_grad():
    ...     _ = lin.w.fill_(1.0)
    >>> lin(torch.ones(1, 4)).tolist()             # column norm 2 -> 0.5
    [[1.0, 1.0]]
    """

    def __init__(self, *args, max_norm=1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_norm = max_norm

    def _weight(self):
        w = self.w
        norm = w.square().sum(dim=0, keepdim=True).sqrt()
        return w * torch.clamp(self.max_norm / torch.clamp(norm, min=1e-12),
                               max=1.0)
