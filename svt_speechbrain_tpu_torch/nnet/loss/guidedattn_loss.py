"""Guided attention loss (port of
``svt_speechbrain_tpu/nnet/loss/guidedattn_loss.py``): penalizes attention
mass far from the diagonal (Tachibana et al., 2017) for roughly monotonic
seq2seq tasks.

The soft mask is ``1 - exp(-((u/U_i - t/T_i)^2) / (2 sigma^2))``, zero
outside each utterance's valid rectangle, and the loss is the plain mean of
``attention * mask`` over every element of the padded (batch, targets,
inputs) tensor: padding dilutes the denominator, as in the reference.
"""
from __future__ import annotations

import torch


class GuidedAttentionLoss:
    """Near-diagonal attention prior (``guidedattn_loss.py:17``).

    Example
    -------
    >>> import torch
    >>> loss = GuidedAttentionLoss(sigma=0.2)
    >>> input_lengths = torch.tensor([2, 3])
    >>> target_lengths = torch.tensor([3, 4])
    >>> alignments = torch.tensor([
    ...     [[0.8, 0.2, 0.0], [0.4, 0.6, 0.0],
    ...      [0.2, 0.8, 0.0], [0.0, 0.0, 0.0]],
    ...     [[0.6, 0.2, 0.2], [0.1, 0.7, 0.2],
    ...      [0.3, 0.4, 0.3], [0.2, 0.3, 0.5]]])
    >>> round(float(loss(alignments, input_lengths, target_lengths)), 4)
    0.1142
    """

    def __init__(self, sigma=0.2):
        self.sigma = sigma
        self.weight_factor = 2 * (sigma ** 2)

    def guided_attentions(self, input_lengths, target_lengths,
                          max_input_len=None, max_target_len=None):
        """Soft masks (batch, max_input_len, max_target_len), zero outside
        each valid rectangle."""
        input_lengths = torch.as_tensor(input_lengths)
        target_lengths = torch.as_tensor(target_lengths,
                                         device=input_lengths.device)
        if max_input_len is None:
            max_input_len = int(input_lengths.max())
        if max_target_len is None:
            max_target_len = int(target_lengths.max())
        device = input_lengths.device
        input_mesh = torch.arange(max_input_len, device=device)[None, :, None]
        target_mesh = torch.arange(max_target_len,
                                   device=device)[None, None, :]
        ilens = input_lengths[:, None, None]
        tlens = target_lengths[:, None, None]
        soft_mask = 1.0 - torch.exp(
            -((input_mesh / ilens - target_mesh / tlens) ** 2)
            / self.weight_factor)
        outside = (input_mesh >= ilens) | (target_mesh >= tlens)
        return torch.where(outside, 0.0, soft_mask)

    def __call__(self, attention, input_lengths, target_lengths,
                 max_input_len=None, max_target_len=None):
        """The loss of a padded (batch, targets, inputs) attention tensor:
        the unmasked mean over all of its elements."""
        soft_mask = self.guided_attentions(
            input_lengths, target_lengths, max_input_len, max_target_len)
        return (attention * soft_mask.transpose(-1, -2)).mean()
