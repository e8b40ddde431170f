"""Length-masked losses (port of ``svt_speechbrain_tpu/nnet/losses.py:28-168``).

Every sequence loss follows one scheme (``compute_masked_loss``): the
element-wise loss is multiplied by a mask built from *relative* lengths,
then reduced as

- ``mean``      : sum(loss*mask) / max(sum(mask), 1)
- ``batchmean`` : sum(loss*mask) / batch_size
- ``batch``     : per-item sum / max(per-item mask sum, 1)
- ``sum``       : sum(loss*mask)
- anything else : the unreduced masked loss

Time-length mismatches up to ``allowed_len_diff`` frames are truncated
away first. The AMT recipe's four terms are ``bce_loss`` (onset with
``pos_weight``, offset) and ``nll_loss`` (octave, pitch class).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def length_to_mask(length, max_len, dtype=torch.float32):
    """Binary mask from absolute lengths: ``mask[i, t] = t < length[i]``,
    float lengths compared without rounding.

    Example
    -------
    >>> import torch
    >>> length_to_mask(torch.tensor([2, 3]), max_len=4)
    tensor([[1., 1., 0., 0.],
            [1., 1., 1., 0.]])
    """
    length = torch.as_tensor(length)
    ar = torch.arange(max_len, dtype=torch.float32, device=length.device)
    return (ar[None, :] < length[:, None].float()).to(dtype)


def truncate(predictions, targets, allowed_len_diff=3):
    """Trim the time axis (axis 1) so both tensors match."""
    len_diff = predictions.shape[1] - targets.shape[1]
    if len_diff == 0:
        return predictions, targets
    if abs(len_diff) > allowed_len_diff:
        raise ValueError(
            f"Predictions and targets should be same length, but got "
            f"{predictions.shape[1]} and {targets.shape[1]} respectively.")
    if len_diff < 0:
        return predictions, targets[:, :predictions.shape[1]]
    return predictions[:, :targets.shape[1]], targets


def compute_masked_loss(loss_fn, predictions, targets, length=None,
                        label_smoothing=0.0, reduction="mean"):
    """``loss_fn(predictions, targets)`` masked by relative ``length`` and
    reduced (``losses.py:62``); denominators clamp to 1, so a fully
    masked batch gives 0, not NaN."""
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=predictions.device)
    if length is not None:
        length_mask = length_to_mask(
            torch.as_tensor(length, device=predictions.device)
            * targets.shape[1], max_len=targets.shape[1])
        while length_mask.dim() < mask.dim():
            length_mask = length_mask[..., None]
        mask = mask * length_mask

    # a masked position gives 0 even where its prediction is not finite,
    # as in the jitted JAX step (its CPU program drops the masked terms):
    # a micro-batch of padding rows only has loss 0, while the NaN of its
    # statistics still reaches the gradient
    loss = torch.where(mask > 0, loss_fn(predictions, targets) * mask, 0.0)
    n = loss.shape[0]
    if reduction == "mean":
        out = loss.sum() / torch.clamp(mask.sum(), min=1.0)
    elif reduction == "batchmean":
        out = loss.sum() / n
    elif reduction == "batch":
        out = (loss.reshape(n, -1).sum(1)
               / torch.clamp(mask.reshape(n, -1).sum(1), min=1.0))
    elif reduction == "sum":
        out = loss.sum()
    else:
        out = loss

    if label_smoothing == 0:
        return out
    # NLL-style smoothing regularizer over the class (last) axis
    loss_reg = predictions.mean(dim=-1) * mask
    if reduction == "mean":
        loss_reg = loss_reg.sum() / mask.sum()
    elif reduction == "batchmean":
        loss_reg = loss_reg.sum() / targets.shape[0]
    elif reduction == "batch":
        loss_reg = loss_reg.sum(1) / mask.sum(1)
    return -label_smoothing * loss_reg + (1 - label_smoothing) * out


def bce_loss(inputs, targets, length=None, weight=None, pos_weight=None,
             reduction="mean", allowed_len_diff=3, label_smoothing=0.0):
    """Binary cross-entropy with logits in its stable form,
    ``pos_weight * y * softplus(-x) + (1 - y) * softplus(x)``.

    Example
    -------
    >>> import torch
    >>> logits = torch.tensor([[0.0, 10.0]])
    >>> targets = torch.tensor([[0.0, 1.0]])
    >>> round(float(bce_loss(logits, targets)), 4)
    0.3466
    >>> round(float(bce_loss(logits, targets, length=torch.tensor([0.5]))), 4)
    0.6931
    """
    if inputs.dim() == targets.dim() + 1:
        inputs = inputs.squeeze(-1)
    if inputs.dim() >= 2:
        inputs, targets = truncate(inputs, targets, allowed_len_diff)
    elif length is not None:
        raise ValueError("length can be passed only for >= 2D inputs.")

    def loss_fn(x, y):
        x, y = x.float(), y.float()
        pw = (1.0 if pos_weight is None else
              torch.as_tensor(pos_weight, dtype=torch.float32, device=x.device))
        loss = pw * y * F.softplus(-x) + (1.0 - y) * F.softplus(x)
        if weight is not None:
            loss = loss * torch.as_tensor(weight, dtype=torch.float32,
                                          device=x.device)
        return loss

    return compute_masked_loss(loss_fn, inputs, targets, length,
                               label_smoothing=label_smoothing,
                               reduction=reduction)


def nll_loss(log_probabilities, targets, length=None, label_smoothing=0.0,
             allowed_len_diff=3, reduction="mean"):
    """Negative log-likelihood over log-probabilities: (B, C) with targets
    (B,), or (B, T, C) with targets (B, T).

    Example
    -------
    >>> import torch
    >>> logp = torch.log_softmax(torch.tensor([[0.0, 0.0]]), dim=-1)
    >>> round(float(nll_loss(logp, torch.tensor([1]))), 4)
    0.6931
    """
    if log_probabilities.dim() == 3:
        log_probabilities, targets = truncate(log_probabilities, targets,
                                              allowed_len_diff)

    def loss_fn(logp, tgt):
        return -torch.gather(logp.float(), -1,
                             tgt.long()[..., None]).squeeze(-1)

    return compute_masked_loss(loss_fn, log_probabilities, targets, length,
                               label_smoothing=label_smoothing,
                               reduction=reduction)
