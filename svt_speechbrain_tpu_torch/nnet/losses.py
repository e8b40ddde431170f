"""Length-masked losses (port of ``svt_speechbrain_tpu/nnet/losses.py``).

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
``pos_weight``, offset) and ``nll_loss`` (octave, pitch class). The rest
of the JAX module follows them: the masked regression and classification
losses, label-smoothed KL, CTC, SI-SNR with permutation-invariant
training, the angular-margin heads and the distillation losses.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from svt_speechbrain_tpu_torch.nnet.normalization import wide


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
        return -torch.gather(wide(logp), -1,
                             tgt.long()[..., None]).squeeze(-1)

    return compute_masked_loss(loss_fn, log_probabilities, targets, length,
                               label_smoothing=label_smoothing,
                               reduction=reduction)


def mse_loss(predictions, targets, length=None, allowed_len_diff=3,
             reduction="mean"):
    """Masked mean-squared error (``losses.py:171``)."""
    predictions, targets = truncate(predictions, targets, allowed_len_diff)
    return compute_masked_loss(lambda p, t: (p - t).square(), predictions,
                               targets, length, reduction=reduction)


def l1_loss(predictions, targets, length=None, allowed_len_diff=3,
            reduction="mean"):
    """Masked L1 error (``losses.py:178``)."""
    predictions, targets = truncate(predictions, targets, allowed_len_diff)
    return compute_masked_loss(lambda p, t: (p - t).abs(), predictions,
                               targets, length, reduction=reduction)


def classification_error(probabilities, targets, length=None,
                         allowed_len_diff=3, reduction="mean"):
    """Frame or batch classification error rate (``losses.py:185``)."""
    if probabilities.dim() == 3 and targets.dim() == 2:
        probabilities, targets = truncate(probabilities, targets,
                                          allowed_len_diff)

    def loss_fn(probs, tgt):
        return (probs.argmax(dim=-1) != tgt).float()

    return compute_masked_loss(loss_fn, probabilities, targets, length,
                               reduction=reduction)


def kldiv_loss(log_probabilities, targets, length=None, label_smoothing=0.0,
               allowed_len_diff=3, pad_idx=0, reduction="mean"):
    """KL-divergence loss with optional label smoothing
    (``losses.py:198``): the target distribution puts ``1 - ls`` on the
    target class and ``ls/(C-1)`` elsewhere; positions whose target is
    ``pad_idx`` give 0. Without smoothing it is ``nll_loss``. "mean" is the
    plain sum, as in the reference."""
    if label_smoothing <= 0:
        return nll_loss(log_probabilities, targets, length,
                        reduction=reduction)
    bz, _, n_class = log_probabilities.shape
    logp = log_probabilities.reshape(-1, n_class).float()
    tgt = targets.reshape(-1).long()
    ignore = tgt == pad_idx
    true_dist = torch.full_like(logp, label_smoothing / (n_class - 1))
    true_dist[torch.arange(logp.shape[0], device=logp.device),
              torch.where(ignore, 0, tgt)] = 1.0 - label_smoothing
    # F.kl_div(logp, q, reduction='none') = q * (log q - logp)
    loss = true_dist * (torch.log(true_dist + 1e-20) - logp)
    loss = torch.where(ignore[:, None], 0.0, loss)
    if reduction in ("mean", "sum"):
        return loss.sum()
    if reduction == "batchmean":
        return loss.sum() / bz
    if reduction == "batch":
        return loss.reshape(bz, -1).sum(1) / torch.as_tensor(
            length, device=loss.device)
    return loss


def _ctc_forward(log_probs, logit_paddings, labels, label_paddings,
                 log_epsilon=-1e5):
    """Per-sequence CTC negative log-likelihood, blank 0: the recursion of
    ``optax.ctc_loss`` (which the JAX package calls), log(0) taken as
    ``log_epsilon``, so an impossible alignment gives a large finite loss
    where ``F.ctc_loss`` gives inf. Inputs are renormalized by a
    log-softmax, as optax does."""
    logprobs = torch.log_softmax(wide(log_probs), dim=-1)
    b, t, k = logprobs.shape
    n = labels.shape[1]
    labellens = n - label_paddings.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    logprobs_phi = logprobs[:, :, :1].transpose(0, 1)            # (T, B, 1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < k)
    emit = torch.gather(logprobs, 2, labels.clamp(0, k - 1)[:, None, :]
                        .expand(b, t, n))
    emit = torch.where(valid[:, None, :], emit, 0.0).transpose(0, 1)
    phi = torch.full((b, n + 1), log_epsilon, device=logprobs.device)
    phi[:, 0] = 0.0
    prev_emit = torch.full((b, n), log_epsilon, device=logprobs.device)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], -1)

    pads = logit_paddings.float().t()
    # one unbind each (one backward op) rather than an index a step, whose
    # backward would fill and add a whole (T, ...) gradient every step
    for e_t, phi_t, pad in zip(emit.unbind(0), logprobs_phi.unbind(0),
                               pads[:, :, None].unbind(0)):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, prev_emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e_t, prev_emit + e_t)
        next_phi = prev_phi + phi_t
        next_phi = update_phi(next_phi, prev_emit + phi_t
                              + log_epsilon * (1.0 - repeat))
        prev_emit = pad * prev_emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, prev_emit)
    return -phi_last.gather(1, labellens[:, None]).squeeze(1)


def ctc_loss(log_probs, targets, input_lens, target_lens, blank_index,
             reduction="mean"):
    """CTC loss (``losses.py:231``) over (B, T, C) log-probs with relative
    ``input_lens``/``target_lens`` (rounded half to even, as JAX rounds).
    ``blank_index`` is rotated to class 0 for the recursion. Reductions:
    "mean" is the batch mean of each loss over its target length, "batch"
    the per-sequence losses, "batchmean" their mean, "sum" their sum."""
    b, t, c = log_probs.shape
    u = targets.shape[1]
    device = log_probs.device
    in_len = torch.round(torch.as_tensor(input_lens, device=device).float()
                         * t)
    tg_len = torch.round(torch.as_tensor(target_lens, device=device).float()
                         * u)
    logit_paddings = (torch.arange(t, device=device)[None, :]
                      >= in_len[:, None]).float()
    label_paddings = (torch.arange(u, device=device)[None, :]
                      >= tg_len[:, None]).float()
    if blank_index != 0:
        others = [i for i in range(c) if i != blank_index]
        log_probs = log_probs[:, :, [blank_index] + others]
        remap = torch.zeros(c, dtype=torch.long, device=device)
        remap[others] = torch.arange(1, c, device=device)
        targets = remap[targets.long()]
    per_seq = _ctc_forward(log_probs, logit_paddings, targets, label_paddings)
    if reduction == "mean":
        return (per_seq / torch.clamp(tg_len, min=1)).mean()
    if reduction == "batchmean":
        return per_seq.mean()
    if reduction == "sum":
        return per_seq.sum()
    return per_seq


def cal_si_snr(source, estimate_source, eps=1e-8):
    """Scale-invariant SNR in dB per (batch, source), both (B, T, C), each
    signal zero-meaned over time (``losses.py:267``); in f32, or in f64 for
    f64 inputs (the JAX function has no f64 path)."""
    source = wide(torch.as_tensor(source))
    estimate_source = wide(torch.as_tensor(estimate_source))
    s = source - source.mean(dim=1, keepdim=True)
    e = estimate_source - estimate_source.mean(dim=1, keepdim=True)
    dot = (e * s).sum(dim=1, keepdim=True)
    s_energy = (s * s).sum(dim=1, keepdim=True) + eps
    proj = dot * s / s_energy
    noise = e - proj
    ratio = (proj ** 2).sum(dim=1) / ((noise ** 2).sum(dim=1) + eps)
    return 10 * torch.log10(ratio + eps)


class PitWrapper:
    """Permutation-invariant training (``losses.py:282``): ``base_loss``
    under every permutation of the estimated sources, the best kept per
    item. ``base_loss(source, estimate)`` returns per-(batch, source)
    losses."""

    def __init__(self, base_loss):
        self.base_loss = base_loss

    def __call__(self, source, estimate_source):
        n_src = source.shape[-1]
        losses = [self.base_loss(source, estimate_source[..., list(perm)])
                  .mean(dim=-1)
                  for perm in itertools.permutations(range(n_src))]
        return torch.stack(losses, dim=-1).min(dim=-1).values


def get_si_snr_with_pitwrapper(source, estimate_source):
    """Negative SI-SNR under PIT, the batch mean (``losses.py:302``)."""
    pit = PitWrapper(lambda s, e: -cal_si_snr(s, e))
    return pit(source, estimate_source).mean()


class AngularMargin:
    """Angular-margin scoring (``losses.py:308``): ``scale · (cos θ -
    margin)`` on the target class."""

    def __init__(self, margin=0.0, scale=1.0):
        self.margin = margin
        self.scale = scale

    def __call__(self, outputs, targets):
        return self.scale * (outputs - self.margin * targets)


class AdditiveAngularMargin(AngularMargin):
    """ArcFace's additive angular margin (``losses.py:321``)."""

    def __init__(self, margin=0.0, scale=1.0, easy_margin=False):
        super().__init__(margin, scale)
        self.easy_margin = easy_margin
        self.cos_m = math.cos(self.margin)
        self.sin_m = math.sin(self.margin)
        self.th = math.cos(math.pi - self.margin)
        self.mm = math.sin(math.pi - self.margin) * self.margin

    def __call__(self, outputs, targets):
        cosine = torch.clamp(outputs, -1 + 1e-7, 1 - 1e-7)
        sine = torch.sqrt(1.0 - cosine ** 2)
        phi = cosine * self.cos_m - sine * self.sin_m
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            phi = torch.where(cosine > self.th, phi, cosine - self.mm)
        return self.scale * (targets * phi + (1.0 - targets) * cosine)


class LogSoftmaxWrapper:
    """A margin module as an NLL criterion (``losses.py:346``): one-hot
    targets → margin logits → cross-entropy, the batch mean."""

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn

    def __call__(self, outputs, targets, length=None):
        outputs = outputs.squeeze(1) if outputs.dim() == 3 else outputs
        targets = torch.as_tensor(targets, device=outputs.device).reshape(-1)
        one_hot = F.one_hot(targets.long(), outputs.shape[-1]).float()
        logp = torch.log_softmax(self.loss_fn(outputs, one_hot), dim=-1)
        return -(logp * one_hot).sum(dim=-1).mean()


def ce_kd(inp, target):
    """Element-wise knowledge-distillation cross-entropy
    (``losses.py:362``): -(teacher probs · student log-probs)."""
    return -(target * inp).sum(dim=-1)


def _masked_mean(elem, length):
    t = elem.shape[1]
    mask = length_to_mask(torch.as_tensor(length, device=elem.device) * t,
                          max_len=t)
    return (elem * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def nll_loss_kd(probabilities, targets, rel_lab_lengths):
    """KD NLL over teacher distributions (``losses.py:368``): ``ce_kd``
    averaged over the valid positions of relative lengths."""
    return _masked_mean(ce_kd(probabilities, targets), rel_lab_lengths)


def ctc_loss_kd(log_probs, targets, input_lens, blank_index, device=None):
    """KD CTC (``losses.py:382``): the cross-entropy between teacher and
    student frame posteriors over the valid frames."""
    return _masked_mean(ce_kd(log_probs, targets), input_lens)


def get_mask(source, source_lengths):
    """(B, T, 1) mask of real frames from (B, T, C) and absolute lengths
    (``losses.py:388``), batch first."""
    t = source.shape[1]
    lengths = torch.as_tensor(source_lengths, device=source.device)
    mask = torch.arange(t, device=source.device)[None, :] < lengths[:, None]
    return mask[..., None].to(source.dtype)
