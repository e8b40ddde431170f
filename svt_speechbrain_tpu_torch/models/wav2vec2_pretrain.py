"""wav2vec 2.0 self-supervised pretraining (port of
``svt_speechbrain_tpu/models/wav2vec2_pretrain.py``).

- ``GumbelVectorQuantizer``: the product-codebook Gumbel quantizer (G groups
  of V entries) that makes the targets from the unmasked conv features. Its
  noise is a draw (``draw_noise``, uniform in [1e-9, 1) from the step's
  device generator) and its forward a deterministic apply of that noise, so
  a test can hand it the JAX package's own draw;
- span masks (``compute_mask_indices`` with ``min_masks=2``) and
  in-utterance negatives (``sample_negative_indices``), drawn on the host
  with numpy exactly as the JAX package draws them;
- ``Wav2Vec2Pretrain``: the contrastive loss over the K negatives of each
  masked frame plus the codebook diversity penalty. Its forward calls the
  encoder's parts one by one, as the JAX forward does: no feature-projection
  dropout and no dropout after the positional conv, and no key lengths, so
  the attention core takes the streaming kernels at 1024 frames or more in
  training;
- ``HuggingFaceWav2Vec2Pretrain``: the bridge that picks the base or lv60
  architecture by name and normalizes the waveform over the whole batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                       Wav2Vec2Encoder,
                                                       run_layers)
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import global_layer_norm
from svt_speechbrain_tpu_torch.processing.video import compute_mask_indices


class GumbelVectorQuantizer(nn.Module):
    """Product-codebook Gumbel quantizer (``wav2vec2_pretrain.py:27``):
    ``proj`` (input_dim → G·V logits) and ``codevectors`` (1, G·V, D/G).

    In training with ``noise`` (the uniform draw of ``draw_noise``, shaped
    (B·T·G, V)) the codes are the straight-through hard one-hot of the
    Gumbel softmax at ``temperature``; otherwise the argmax of the logits.
    The perplexity is that of the marginal softmax over all B·T frames.

    Example
    -------
    >>> import torch
    >>> q = GumbelVectorQuantizer(8, num_groups=2, num_vars=4,
    ...                           codevector_dim=6)
    >>> out, perplexity = q(torch.ones(2, 3, 8))
    >>> out.shape, perplexity.shape
    (torch.Size([2, 3, 6]), torch.Size([]))
    """

    def __init__(self, input_dim, num_groups=2, num_vars=320,
                 codevector_dim=256):
        super().__init__()
        if codevector_dim % num_groups:
            raise ValueError("codevector_dim must divide num_groups")
        self.num_groups = num_groups
        self.num_vars = num_vars
        self.codevector_dim = codevector_dim
        self.proj = Linear(num_groups * num_vars, input_dim)
        self.codevectors = nn.Parameter(torch.zeros(
            1, num_groups * num_vars, codevector_dim // num_groups))

    def draw_noise(self, generator, batch, frames, device=None):
        """The uniform noise of one training forward, (B·T·G, V) in
        [1e-9, 1), as ``jax.random.uniform(minval=1e-9, maxval=1.0)``."""
        u = torch.rand((batch * frames * self.num_groups, self.num_vars),
                       generator=generator, device=device)
        return 1e-9 + (1.0 - 1e-9) * u

    def forward(self, x, temperature=2.0, noise=None, train=False):
        b, t, _ = x.shape
        g, v = self.num_groups, self.num_vars
        logits = self.proj(x).reshape(b * t * g, v)
        if train and noise is not None:
            gumbel = -torch.log(-torch.log(noise.to(logits.dtype)))
            y_soft = torch.softmax((logits + gumbel) / temperature, dim=-1)
            y_hard = F.one_hot(y_soft.argmax(dim=-1), v).to(y_soft.dtype)
            probs = y_hard + y_soft - y_soft.detach()
        else:
            probs = F.one_hot(logits.argmax(dim=-1), v).to(logits.dtype)
        marginal = torch.softmax(logits.reshape(b * t, g, v), dim=-1).mean(0)
        perplexity = torch.exp(-torch.sum(
            marginal * torch.log(marginal + 1e-7), dim=-1)).sum()
        codevectors = (probs.reshape(b * t, g * v)[:, :, None]
                       * self.codevectors[0][None].to(probs.dtype))
        quantized = codevectors.reshape(b * t, g, v, -1).sum(dim=2)
        return quantized.reshape(b, t, -1), perplexity


def sample_negative_indices(batch_size, seq_len, num_negatives, mask, rng):
    """In-utterance negatives among the masked frames, drawn on the host
    (``wav2vec2_pretrain.py:73``, HF ``_sample_negative_indices``).

    Example
    -------
    >>> import numpy as np
    >>> mask = np.ones((1, 6), bool)
    >>> negs = sample_negative_indices(1, 6, num_negatives=4, mask=mask,
    ...                                rng=np.random.default_rng(0))
    >>> negs.shape
    (1, 6, 4)
    >>> bool((negs[0] != np.arange(6)[:, None]).all())  # never its own pos
    True
    """
    out = np.zeros((batch_size, seq_len, num_negatives), dtype=np.int64)
    for b in range(batch_size):
        masked = np.flatnonzero(mask[b])
        if len(masked) <= 1:
            continue
        for ti, t in enumerate(masked):
            cands = masked[masked != t]
            out[b, t] = rng.choice(cands, size=num_negatives, replace=True)
    return out


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class Wav2Vec2Pretrain(nn.Module):
    """The pretraining model (``wav2vec2_pretrain.py:99``): conv features →
    masked context network → ``project_hid``; quantized unmasked features →
    ``project_q``; contrastive loss over negatives + diversity penalty.

    Example
    -------
    >>> import numpy as np, torch
    >>> from svt_speechbrain_tpu_torch.models.wav2vec2 import TINY_ARCH
    >>> model = Wav2Vec2Pretrain(Wav2Vec2Config(**TINY_ARCH),
    ...                          codevector_dim=16, num_negatives=3)
    >>> mask, negs = model.sample_masks(2, 49, np.random.default_rng(0))
    >>> loss, aux = model(torch.ones(2, 16000), mask, negs)
    >>> loss.shape, sorted(aux)
    (torch.Size([]), ['codebook_perplexity', 'contrastive_loss', 'diversity_loss'])
    """

    def __init__(self, config: Wav2Vec2Config = None, codevector_dim=256,
                 num_negatives=100, contrastive_logits_temperature=0.1,
                 diversity_loss_weight=0.1, mask_prob=0.65, mask_length=10):
        super().__init__()
        self.config = c = config or Wav2Vec2Config.base()
        self.encoder = Wav2Vec2Encoder(c)
        self.quantizer = GumbelVectorQuantizer(c.conv_dim[-1],
                                               codevector_dim=codevector_dim)
        self.project_hid = Linear(codevector_dim, c.hidden_size)
        self.project_q = Linear(codevector_dim, codevector_dim)
        self.mask_emb = nn.Parameter(torch.zeros(c.hidden_size))
        self.num_negatives = num_negatives
        self.temperature = contrastive_logits_temperature
        self.diversity_loss_weight = diversity_loss_weight
        self.mask_prob = mask_prob
        self.mask_length = mask_length

    def sample_masks(self, batch_size, num_frames, rng=None):
        """Host-side span masks (B, T) and negatives (B, T, K), drawn from
        the numpy ``rng`` (``wav2vec2_pretrain.py:128``)."""
        rng = rng or np.random.default_rng()
        mask, *_ = compute_mask_indices(
            (batch_size, num_frames), None, self.mask_prob, self.mask_length,
            rng=rng, min_masks=2)
        negatives = sample_negative_indices(batch_size, num_frames,
                                            self.num_negatives, mask, rng)
        return mask, negatives

    def forward(self, wav, mask, negative_indices, rng=None, train=False,
                gumbel_temperature=2.0, gumbel_noise=None,
                fused_frontend=True):
        """(loss, aux) for ``wav`` (B, samples), ``mask`` (B, T) bool and
        ``negative_indices`` (B, T, K), numpy or tensors. In training the
        Gumbel noise is ``gumbel_noise`` if given, else drawn from the
        ``StepRNG``'s device generator, and the layers' dropouts draw from
        that ``rng``. The conv features take the frontend kernel (its
        backward recomputes the plain version) where it applies, unless
        ``fused_frontend`` is False (an f64 step, which it is not built
        for)."""
        c = self.config
        enc = self.encoder
        feats = enc.feature_extractor(wav, fused=fused_frontend)  # (B, T, C)
        b, t, _ = feats.shape
        dev = feats.device
        mask = torch.as_tensor(mask, device=dev)[:, :t].bool()
        negs = torch.as_tensor(negative_indices, device=dev)[:, :t].long()
        if train and gumbel_noise is None and rng is not None:
            gumbel_noise = self.quantizer.draw_noise(rng.device, b, t, dev)
        quantized, perplexity = self.quantizer(
            feats, temperature=gumbel_temperature, noise=gumbel_noise,
            train=train)
        quantized = self.project_q(quantized)                 # (B, T, D)

        x = enc.feat_proj_ln(feats) if enc.feat_proj_ln is not None else feats
        x = enc.feat_proj(x)
        x = torch.where(mask[..., None], self.mask_emb.to(x.dtype), x)
        x = x + enc.pos_conv(x)
        if not c.do_stable_layer_norm:
            x = enc.encoder_ln(x)
        x = run_layers(enc.layers, c, x, None, dict(rng=rng, train=train))
        if c.do_stable_layer_norm:
            x = enc.encoder_ln(x)
        pred = _unit(self.project_hid(x))                     # (B, T, D)

        # the targets: the positive, then the K negatives of each frame,
        # gathered from the quantized frames of the same row
        rows = torch.arange(b, device=dev)[:, None, None]
        target_unit = _unit(quantized)
        neg_unit = target_unit[rows, negs]                    # (B, T, K, D)
        pos = (pred * target_unit).sum(-1)[..., None] / self.temperature
        neg = (pred[:, :, None] * neg_unit).sum(-1) / self.temperature
        # a negative equal to its positive cannot be told apart from it: HF's
        # ``neg_is_pos`` correction (isclose at rtol 1e-5, atol 1e-8)
        with torch.no_grad():
            q = quantized.detach()
            neg_is_pos = torch.isclose(q[rows, negs], q[:, :, None]).all(-1)
        neg = torch.where(neg_is_pos, torch.full_like(neg, -1e9), neg)
        logits = torch.cat([pos, neg], dim=-1)                # (B, T, K+1)
        per_pos = -torch.log_softmax(logits, dim=-1)[..., 0]  # (B, T)
        mask_f = mask.to(per_pos.dtype)
        contrastive = (per_pos * mask_f).sum() / torch.clamp(mask_f.sum(),
                                                             min=1.0)
        gv = self.quantizer.num_groups * self.quantizer.num_vars
        diversity = (gv - perplexity) / gv
        loss = contrastive + self.diversity_loss_weight * diversity
        return loss, {"contrastive_loss": contrastive,
                      "diversity_loss": diversity,
                      "codebook_perplexity": perplexity}


class HuggingFaceWav2Vec2Pretrain(nn.Module):
    """The bridge (``wav2vec2_pretrain.py:203``): ``Wav2Vec2Pretrain`` on
    the base architecture if "base" is in ``source``, else lv60, with
    ``arch_overrides`` (lists become tuples), and the waveform normalized
    over the whole batch (``global_layer_norm``) when ``normalize_wav``.

    Example
    -------
    >>> bridge = HuggingFaceWav2Vec2Pretrain("facebook/wav2vec2-base",
    ...                                      arch_overrides={"num_layers": 1})
    >>> bridge.config.hidden_size, bridge.config.num_layers
    (768, 1)
    """

    def __init__(self, source=None, save_path=None, mask_prob=0.65,
                 mask_length=10, normalize_wav=True, arch_overrides=None):
        super().__init__()
        config = (Wav2Vec2Config.base() if source and "base" in str(source)
                  else Wav2Vec2Config.large_lv60())
        if arch_overrides:
            config = dataclasses.replace(config, **{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in arch_overrides.items()})
        self.source = source
        self.save_path = save_path
        self.config = config
        self.normalize_wav = normalize_wav
        self.model = Wav2Vec2Pretrain(config, mask_prob=mask_prob,
                                      mask_length=mask_length)

    def sample_masks(self, batch_size, num_samples, rng=None):
        """Masks and negatives for a batch of ``num_samples`` samples."""
        frames = self.config.output_length(num_samples)
        return self.model.sample_masks(batch_size, frames, rng)

    def forward(self, wav, mask, negative_indices, rng=None, train=False,
                **kw):
        if self.normalize_wav:
            wav = global_layer_norm(wav)
        return self.model(wav, mask, negative_indices, rng=rng, train=train,
                          **kw)
