"""Masked token accuracy (port of ``svt_speechbrain_tpu/utils/accuracy.py``,
reference ``speechbrain/utils/Accuracy.py``), on tensors."""
from __future__ import annotations

import torch

from svt_speechbrain_tpu_torch.nnet.losses import length_to_mask


class AccuracyStats:
    """Accumulate masked token accuracy (``accuracy.py:11``).

    Example
    -------
    >>> import torch
    >>> stats = AccuracyStats()
    >>> logp = torch.log(torch.tensor([[[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]]]))
    >>> stats.append(logp, torch.tensor([[0, 1, 1]]),
    ...              length=torch.tensor([2 / 3]))   # last frame is padding
    >>> stats.summarize()
    1.0
    """

    def __init__(self):
        self.correct = 0.0
        self.total = 0.0

    def append(self, log_probabilities, targets, length=None):
        numerator, denominator = Accuracy(log_probabilities, targets, length)
        self.correct += numerator
        self.total += denominator

    def summarize(self):
        return self.correct / self.total


def Accuracy(log_probabilities, targets, length=None):
    """(correct, total) as floats (``accuracy.py:38``): with relative
    ``length`` the padded positions are dropped (the (B, T) mask repeated
    along a third target axis); without it the total is batch × time even
    for 3-D targets, as in the reference."""
    log_probabilities = torch.as_tensor(log_probabilities)
    targets = torch.as_tensor(targets, device=log_probabilities.device)
    padded_pred = log_probabilities.argmax(-1)
    if length is not None:
        length = torch.as_tensor(length, device=targets.device)
        mask = length_to_mask(length * targets.shape[1],
                              max_len=targets.shape[1]) > 0
        if targets.dim() == 3:
            mask = mask[:, :, None].expand(-1, -1, targets.shape[2])
        numerator = float((padded_pred[mask] == targets[mask]).sum())
        denominator = float(mask.sum())
    else:
        numerator = float((padded_pred == targets).sum())
        denominator = float(targets.shape[0] * targets.shape[1])
    return numerator, denominator
