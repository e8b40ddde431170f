"""RNN-Transducer loss, differentiated by autograd (port of
``svt_speechbrain_tpu/nnet/loss/transducer_loss.py``).

Recurrence (log space), with ``skip(t,u) = lp[t,u,blank]`` and
``emit(t,u) = lp[t,u,label[u]]``:

    alpha[t, u] = logaddexp(alpha[t-1, u] + skip(t-1, u),
                            alpha[t, u-1] + emit(t, u-1))

Within a time step the u-recurrence ``a[u] = logaddexp(b[u], a[u-1]+e[u-1])``
has the closed form ``a = E + logcumsumexp(b - E)`` with ``E = cumsum(e)``;
the loop over time is a Python loop, and the backward is autograd's. This is
the independent oracle of ``ops.transducer_lattice``, whose kernels and
closed-form gradient ``TransducerLoss(fused=True)`` runs.
"""
from __future__ import annotations

import torch
from torch import nn

NEG_INF = -1e30


def transducer_forward_score(log_probs, targets, blank_index):
    """Forward lattice scores for every (t, u) (``:34``).

    log_probs: (B, T, U1, V) log-probabilities, U1 = U + 1.
    targets: (B, U) int labels.
    Returns alpha (B, T, U1).
    """
    bsz, t_max, u1, _ = log_probs.shape
    skip = log_probs[..., blank_index]
    index = targets.long()[:, None, :, None].expand(bsz, t_max, -1, 1)
    emit = log_probs[:, :, :-1].gather(-1, index)[..., 0]
    # E[u] = sum_{j<u} emit[t, j]
    e_cum = torch.cumsum(
        torch.cat([emit.new_zeros(bsz, t_max, 1), emit], dim=2), dim=2)

    def row_update(b_row, e_t):
        return e_t + torch.logcumsumexp(b_row - e_t, dim=-1)

    # t = 0 row: only emissions from alpha[0, 0] = 0
    b0 = log_probs.new_full((bsz, u1), NEG_INF)
    b0[:, 0] = 0.0
    rows = [row_update(b0, e_cum[:, 0])]
    for t in range(1, t_max):
        rows.append(row_update(rows[-1] + skip[:, t - 1], e_cum[:, t]))
    return torch.stack(rows, dim=1)


def transducer_loss(logits, targets, input_lens, target_lens, blank_index,
                    reduction="mean", from_log_probs=False):
    """Negative log-likelihood of the RNN-T lattice (``:72``).

    logits: (B, T, U+1, V); targets: (B, U); lengths are *relative*
    (len/max) like every framework loss.

    Example
    -------
    >>> import torch
    >>> # B=1, T=2, U=1, V=3, blank=0: force the only valid path
    >>> # (emit label 1, then blank, blank) to probability ~1 -> loss ~0
    >>> logits = torch.zeros(1, 2, 2, 3)
    >>> logits[0, 0, 0, 1] = 50.0       # emit "1" at (t0, u0)
    >>> logits[0, 0, 1, 0] = 50.0       # blank at (t0, u1)
    >>> logits[0, 1, 1, 0] = 50.0       # final blank at (t1, u1)
    >>> loss = transducer_loss(logits, torch.tensor([[1]]),
    ...                        torch.tensor([1.0]), torch.tensor([1.0]), 0)
    >>> round(abs(float(loss)), 4)
    0.0
    """
    logits = torch.as_tensor(logits)
    dev = logits.device
    bsz, t_max, _, _ = logits.shape
    log_probs = logits if from_log_probs else torch.log_softmax(logits, -1)
    log_probs = log_probs.float()
    targets = torch.as_tensor(targets).to(dev)
    t_len, u_len = (
        torch.round(torch.as_tensor(rel, dtype=torch.float32).to(dev) * n)
        .long() for rel, n in ((input_lens, t_max),
                               (target_lens, targets.shape[1])))
    alpha = transducer_forward_score(log_probs, targets, blank_index)
    rows = torch.arange(bsz, device=dev)
    nll = -(alpha[rows, t_len - 1, u_len]
            + log_probs[rows, t_len - 1, u_len, blank_index])
    if reduction in ("mean", "batchmean"):
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


class TransducerLoss(nn.Module):
    """Object wrapper matching the reference's ``TransducerLoss`` module
    (``:120``). ``fused=True`` uses the hand-written lattice kernels and the
    closed-form backward of ``ops.transducer_lattice`` (the counterpart of
    the reference's CUDA kernels) instead of autograd: on CUDA tensors it
    launches them or raises."""

    def __init__(self, blank_index=0, reduction="mean", fused=False):
        super().__init__()
        self.blank_index = blank_index
        self.reduction = reduction
        self.fused = fused

    def forward(self, logits, targets, input_lens, target_lens):
        if self.fused:
            from svt_speechbrain_tpu_torch.ops.transducer_lattice import (
                transducer_loss_fused)

            return transducer_loss_fused(logits, targets, input_lens,
                                         target_lens, self.blank_index,
                                         reduction=self.reduction)
        return transducer_loss(logits, targets, input_lens, target_lens,
                               self.blank_index, reduction=self.reduction)


# The reference exposes a ``Transducer`` autograd.Function beside its CUDA
# kernels; as in the JAX package the public entry point is the loss class.
Transducer = TransducerLoss
