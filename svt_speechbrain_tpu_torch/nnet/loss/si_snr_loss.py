"""SI-SNR loss (port of ``svt_speechbrain_tpu/nnet/loss/si_snr_loss.py``).

Unlike ``losses.cal_si_snr`` (which zero-means both signals), this loss
projects without removing the mean, cuts each utterance to its relative
length, and adds ``np.finfo(float).eps`` where the reference does (the
target energy, the noise energy, inside the log).
"""
from __future__ import annotations

import numpy as np
import torch

_SMALL = float(np.finfo("float").eps)


def si_snr_loss(y_pred_batch, y_true_batch, lens=None, reduction="mean"):
    """Negative scale-invariant SNR (``si_snr_loss.py:17``) of (B, T) or
    (B, T, 1) degraded and clean batches with relative ``lens`` (ones when
    omitted); ``reduction`` "mean" or "batch".

    Example
    -------
    >>> import torch
    >>> t = torch.sin(torch.arange(100.0))
    >>> float(si_snr_loss(2.0 * t[None], t[None])) < -50
    True
    """
    y_pred_batch = torch.as_tensor(y_pred_batch).float()
    y_true_batch = torch.as_tensor(y_true_batch).float()
    if y_pred_batch.dim() == 3 and y_pred_batch.shape[-1] == 1:
        y_pred_batch = y_pred_batch[..., 0]
    if y_true_batch.dim() == 3 and y_true_batch.shape[-1] == 1:
        y_true_batch = y_true_batch[..., 0]
    batch_size = y_pred_batch.shape[0]
    lens = (np.ones(batch_size, np.float32) if lens is None
            else np.asarray(lens.cpu() if torch.is_tensor(lens) else lens))
    scores = []
    for i in range(batch_size):
        t = int(lens[i] * y_pred_batch.shape[1])
        s_target = y_true_batch[i, :t]
        s_estimate = y_pred_batch[i, :t]
        dot = (s_estimate * s_target).sum()
        s_target_energy = (s_target ** 2).sum() + _SMALL
        proj = dot * s_target / s_target_energy
        e_noise = s_estimate - proj
        ratio = (proj ** 2).sum() / ((e_noise ** 2).sum() + _SMALL)
        scores.append(10 * torch.log10(ratio + _SMALL))
    si_snr = torch.stack(scores)
    if reduction == "mean":
        return -si_snr.mean()
    return -si_snr
