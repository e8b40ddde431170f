"""Linear transformation (port of ``svt_speechbrain_tpu/nnet/linear.py:15``)."""
from __future__ import annotations

import torch
from torch import nn

from svt_speechbrain_tpu_torch.ops.quant import PackedWeight, int8_matmul


class Linear(nn.Module):
    """y = x @ w + b over the trailing feature axis (biased, as every
    Linear on the ported path).

    ``w`` is stored (in, out), as in the JAX package, so the converted
    weights load without a transpose. In bf16 the product is emitted in the
    input dtype and the bias is added after, in that dtype (the JAX
    ``preferred_element_type=x.dtype`` rule).

    ``to_int8_`` turns the layer into its int8 serving form
    (``linear.py:58-61``): the buffers ``w_q8`` (in, out) int8 and
    ``w_scale`` (out,) take the place of ``w``, the product goes through
    ``ops.quant.int8_matmul`` and the bias is added after it, in the input
    dtype. ``models/quantize.py`` makes such layers.

    Example
    -------
    >>> import torch
    >>> lin = Linear(n_neurons=4, input_size=8)
    >>> lin(torch.ones(2, 3, 8)).shape
    torch.Size([2, 3, 4])
    """

    def __init__(self, n_neurons, input_size):
        super().__init__()
        self.n_neurons = n_neurons
        self.input_size = input_size
        self.w = nn.Parameter(torch.zeros(input_size, n_neurons))
        self.b = nn.Parameter(torch.zeros(n_neurons))

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

    def forward(self, x):
        if "w_q8" in self._buffers:
            y = int8_matmul(x, self.w_q8, self.w_scale,
                            self._packed(self.w_q8))
        else:
            y = torch.matmul(x, self.w.to(x.dtype))
        return y + self.b
