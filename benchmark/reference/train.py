"""The plain reference of the AMT training step: the recipe's 4-term frame
loss, the global-norm clip and the two optimizers (Adam on the encoder,
Adadelta on the head), with the readings the check compares.

The loss is ``AMTBrainBase.compute_objectives`` of the recipe
(``recipes/MIR_ST500/hparams/train_audio_ssl.yaml``): BCE with logits of
onset (positive weight 15) and offset, and NLL of the log-softmax of the
octave (5) and pitch-class (13) logits, each a mean over the frames within
the annotations' relative lengths, predictions and targets trimmed to the
shorter of the two. The step clips every gradient by min(1, 5 / (norm +
1e-6)) and steps torch's Adam (betas 0.9, 0.999, eps 1e-8) and Adadelta
(rho 0.95, eps 1e-8), written out here.

Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import model

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
ADADELTA_RHO, ADADELTA_EPS = 0.95, 1e-8
MAX_GRAD_NORM = 5.0
ONSET_POS_WEIGHT = 15.0


def masked_mean(loss, rel_lengths):
    t = loss.shape[1]
    mask = (torch.arange(t, device=loss.device, dtype=torch.float32)[None, :]
            < rel_lengths[:, None] * t).float()
    return (loss * mask).sum() / mask.sum().clamp(min=1.0)


def amt_loss(cfg, logits, anno, anno_rel):
    """The frame loss of (B, F, 20) logits against (B, F', 4) annotations
    with relative lengths (B,)."""
    t = min(logits.shape[1], anno.shape[1])
    logits, anno = logits[:, :t], anno[:, :t]
    n_oct = cfg["pitch_octave_num"]

    def bce(x, y, pos_weight):
        return pos_weight * y * F.softplus(-x) + (1.0 - y) * F.softplus(x)

    def nll(x, y):
        return -torch.gather(torch.log_softmax(x, dim=-1), -1,
                             y.long()[..., None])[..., 0]

    return (masked_mean(bce(logits[..., 0], anno[..., 0], ONSET_POS_WEIGHT),
                        anno_rel)
            + masked_mean(bce(logits[..., 1], anno[..., 1], 1.0), anno_rel)
            + masked_mean(nll(logits[..., 2:3 + n_oct], anno[..., 2]), anno_rel)
            + masked_mean(nll(logits[..., 3 + n_oct:], anno[..., 3]), anno_rel))


def leaf_norms(tensors):
    """name → float L2 norm."""
    names = list(tensors)
    norms = torch.stack([tensors[n].float().square().sum() for n in names])
    return dict(zip(names, norms.sqrt().tolist()))


def train_steps(cfg, params, batches, seed, lr_encoder, lr_head):
    """Run ``len(batches)`` steps from ``params`` (name → f32 tensor, taken
    over and changed) on ``batches`` [(wav (B, T), anno (B, F, 4),
    anno_rel (B,))] with dropout replayed from ``seed``. Returns the losses,
    the first step's clipped gradient norms by leaf, and the change of each
    leaf over all the steps."""
    start = {n: t.clone() for n, t in params.items()}
    rng = model.ReplayRNG(seed, next(iter(params.values())).device)
    state = {n: [torch.zeros_like(t), torch.zeros_like(t)] for n, t in
             params.items()}
    losses, first_grads = [], None
    for step, (wav, anno, anno_rel) in enumerate(batches, start=1):
        for t in params.values():
            t.requires_grad_(True)
            t.grad = None
        loss = amt_loss(cfg, model.forward(cfg, params, wav, rng=rng), anno,
                        anno_rel)
        loss.backward()
        with torch.no_grad():
            grads = {n: t.grad for n, t in params.items()}
            norm = torch.stack([g.square().sum() for g in grads.values()])
            clip = torch.clamp(MAX_GRAD_NORM / (norm.sum().sqrt() + 1e-6),
                               max=1.0)
            for g in grads.values():
                g.mul_(clip)
            if first_grads is None:
                first_grads = leaf_norms(grads)
            losses.append(float(loss))
            for name, t in params.items():
                g, (a, b) = grads[name], state[name]
                t.requires_grad_(False)
                if name.startswith("model."):           # Adadelta
                    a.mul_(ADADELTA_RHO).addcmul_(g, g, value=1 - ADADELTA_RHO)
                    delta = ((b + ADADELTA_EPS).sqrt() / (a + ADADELTA_EPS).sqrt()
                             * g)
                    b.mul_(ADADELTA_RHO).addcmul_(delta, delta,
                                                  value=1 - ADADELTA_RHO)
                    t.sub_(lr_head * delta)
                else:                                   # Adam
                    b1, b2 = ADAM_BETAS
                    a.mul_(b1).add_(g, alpha=1 - b1)
                    b.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (b.sqrt() / (1 - b2 ** step) ** 0.5).add_(ADAM_EPS)
                    t.sub_(lr_encoder / (1 - b1 ** step) * a / denom)
                t.grad = None
    change = leaf_norms({n: params[n] - start[n] for n in params})
    return losses, first_grads, change
