"""Transducer joint network (port of
``svt_speechbrain_tpu/nnet/transducer_joint.py``)."""
from __future__ import annotations

import torch
from torch import nn

_NONLINEARITIES = {"tanh": torch.tanh, "relu": torch.relu,
                   "leaky_relu": nn.functional.leaky_relu}


class Transducer_joint(nn.Module):
    """Join encoder frames (B, T, 1, H) with prediction-network states
    (B, 1, U, H) by sum or concat, then a nonlinearity (``:12``).
    Broadcasting produces the (B, T, U, H) lattice. With 3-D (or any
    equal-rank) inputs "concat" joins them on the last axis as they are.
    ``joint_network`` (e.g. a ``Linear`` over the concat width) runs before
    the nonlinearity.

    Example
    -------
    >>> import torch
    >>> joint = Transducer_joint(joint="sum", nonlinearity="relu")
    >>> tn = torch.ones(2, 5, 1, 8)          # encoder frames
    >>> pn = torch.ones(2, 1, 3, 8)          # prediction-net states
    >>> joint(tn, pn).shape
    torch.Size([2, 5, 3, 8])
    """

    def __init__(self, joint_network=None, joint="sum", nonlinearity="tanh"):
        super().__init__()
        self.joint_network = joint_network
        self.joint = joint
        self.nonlinearity = _NONLINEARITIES[nonlinearity]

    def forward(self, input_TN, input_PN):
        if self.joint == "sum":
            joint = input_TN + input_PN
        elif self.joint == "concat":
            if input_TN.dim() == 4:  # (B,T,1,H) x (B,1,U,H) → (B,T,U,2H)
                t, u = input_TN.shape[1], input_PN.shape[2]
                tn = input_TN.expand(-1, -1, u, -1)
                pn = input_PN.expand(-1, t, -1, -1)
                joint = torch.cat([tn, pn], dim=-1)
            else:
                joint = torch.cat([input_TN, input_PN], dim=-1)
        else:
            raise NotImplementedError(f"joint={self.joint}")
        if self.joint_network is not None:
            joint = self.joint_network(joint)
        return self.nonlinearity(joint)
