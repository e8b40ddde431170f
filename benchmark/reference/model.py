"""The plain reference of the AMT model: wav2vec2-family encoder (the
"layer" conv extractor, pre- or post-LN layers, the weight-normed or the
stacked positional convs) and the linear frame head, in f32 PyTorch with no
kernel, cache or batching trick.

It follows the published layer equations (HF ``Wav2Vec2`` with
``do_stable_layer_norm``, ``Data2VecAudio``) and the SpeechBrain bridge the
recipe trains: a layer norm over the waveform, and another over the
encoder's output. Two readings of those norms, as the program has them:
with per-row sample counts (serving) each row is normalised over its own
samples and frames and padded frames are masked, keys included; without
(training) the norms run over the whole batch, padding attended.

Training replays the dropout the program drew (``ReplayRNG``): the same
generators, seeded alike, drawn in the same order and shapes, and the
attention dropout of the long rows worked out again from its per-call seed
by ``hash_dropout_mask``. The GELU is the exact erf form the configuration
names. Parameters are a dict of tensors under the brain's leaf names
(``weights.param_specs``).

Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -1e30
EPS = 1e-5
# the program's attention: rows of this many keys or more take the streaming
# kernel, whose dropout hashes (seed, row, q, k); shorter rows under
# dropout take the eager path, whose mask the device generator draws
HASH_DROPOUT_MIN_KEYS = 1024


class ReplayRNG:
    """The random sources of a training run: ``device`` draws elementwise
    masks, ``host`` the attention kernel's per-call seeds."""

    def __init__(self, seed, device):
        self.device = torch.Generator(device).manual_seed(int(seed))
        self.host = torch.Generator().manual_seed(int(seed))

    def drop(self, x, rate):
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.device, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def attention_seed(self):
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host))


# murmur3 fmix32 over (seed, row, q, k), in int64 with 32-bit wrapping
_C1, _C2, _GOLD, _U32 = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0xFFFFFFFF


def _mul32(h, c):
    return ((h * (c & 0xFFFF)) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def hash_dropout_mask(seed, b, h, tq, tk, rate, device):
    """(B, H, Tq, Tk) multiplier, 0 or f32(1/(1 - rate)): a key is kept
    where fmix32(k·C1 ^ fmix32(q·C2 ^ fmix32(seed ^ row·golden))) is at
    least rate·2³², ``row`` the flattened (b, h) index."""
    thresh = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    keep = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    rows = torch.arange(b * h, device=device, dtype=torch.int64).reshape(-1, 1, 1)
    q = torch.arange(tq, device=device, dtype=torch.int64).reshape(1, -1, 1)
    k = torch.arange(tk, device=device, dtype=torch.int64).reshape(1, 1, -1)
    h0 = _fmix32((int(seed) & _U32) ^ _mul32(rows, _GOLD))
    hq = _fmix32(_mul32(q, _C2) ^ h0)
    bits = _fmix32(_mul32(k, _C1) ^ hq)
    return torch.where(bits >= thresh, keep, 0.0).reshape(b, h, tq, tk)


def _probs(q, k, lengths):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if lengths is not None:
        valid = (torch.arange(k.shape[2], device=q.device)[None, :]
                 < lengths[:, None])[:, None, None, :]
        s = s.masked_fill(~valid, NEG)
    p = torch.softmax(s, dim=-1)
    if lengths is not None:
        p = p * (lengths > 0)[:, None, None, None]
    return p


class _Attention(torch.autograd.Function):
    """softmax(QKᵀ/√d) ∘ M · V, keeping q, k, v and M's recipe for the
    backward instead of the (B, H, T, T) probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, mask_fn):
        p = _probs(q, k, None)
        m = mask_fn()
        ctx.save_for_backward(q, k, v)
        ctx.mask_fn = mask_fn
        return torch.einsum("bhqk,bhkd->bhqd", p * m, v)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        p = _probs(q, k, None)
        m = ctx.mask_fn()
        dv = torch.einsum("bhqk,bhqd->bhkd", p * m, dout)
        dp = torch.einsum("bhqd,bhkd->bhqk", dout, v) * m
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        scale = 1.0 / math.sqrt(q.shape[-1])
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
        return dq, dk, dv, None


def attention(q, k, v, lengths, rng, rate, cast=None):
    """(B, H, T, D) attention; key ``lengths`` (B,) mask in serving,
    dropout from ``rng`` in training; ``cast`` rounds each product's
    operands (the control's lower precision)."""
    if rng is None:
        c = cast or (lambda x: x)
        return torch.einsum("bhqk,bhkd->bhqd",
                            c(_probs(c(q), c(k), lengths)), c(v))
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    if tk >= HASH_DROPOUT_MIN_KEYS:
        seed = rng.attention_seed()
        return _Attention.apply(q, k, v, lambda: hash_dropout_mask(
            seed, b, h, tq, tk, rate, q.device))
    kept = torch.rand((b, h, tq, tk), generator=rng.device,
                      device=q.device) < 1.0 - rate
    return _Attention.apply(q, k, v, lambda: torch.where(
        kept, 1.0 / (1.0 - rate), 0.0))


def layer_norm(x, scale=None, bias=None):
    return F.layer_norm(x, x.shape[-1:], scale, bias, EPS)


def masked_norm(x, valid):
    """Per-row norm over the positions where ``valid`` (B, T) holds."""
    m = valid.to(x.dtype).reshape(valid.shape + (1,) * (x.dim() - 2))
    m = m.expand(x.shape)
    dims = tuple(range(1, x.dim()))
    count = m.sum(dim=dims, keepdim=True).clamp(min=1.0)
    mean = (x * m).sum(dim=dims, keepdim=True) / count
    var = ((x - mean).square() * m).sum(dim=dims, keepdim=True) / count
    return (x - mean) * torch.rsqrt(var + EPS)


def global_norm(x):
    return (x - x.mean()) * torch.rsqrt((x - x.mean()).square().mean() + EPS)


def frames_of(cfg, samples):
    """Encoder frames of a (B,) tensor of sample counts."""
    t = samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        t = torch.clamp(torch.div(t - k, s, rounding_mode="floor") + 1, min=0)
    return t


def fp8(x):
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude at 448), and back: the control's products."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _same_conv(x, w, b, groups):
    """Grouped conv over (B, T, C), k//2 padding each side, the last frame
    trimmed for an even kernel."""
    k = w.shape[-1]
    y = F.conv1d(F.pad(x.transpose(1, 2), (k // 2, k // 2)), w, b,
                 groups=groups).transpose(1, 2)
    return y[:, :-1] if k % 2 == 0 else y


def pos_conv(cfg, p, x, c):
    e = "wav2vec2.encoder.pos_conv."
    groups = cfg["num_conv_pos_embedding_groups"]
    if "conv_pos_kernel_size" in cfg:
        for i in range(cfg["num_conv_pos_embeddings"]):
            x = F.gelu(layer_norm(_same_conv(c(x), c(p[f"{e}{i}.w"]),
                                             p[f"{e}{i}.b"], groups)))
        return x
    v, g = p[e + "v"], p[e + "g"]
    w = v * (g / torch.sqrt(v.square().sum(dim=(0, 1), keepdim=True) + 1e-12))
    return F.gelu(_same_conv(c(x), c(w), p[e + "b"], groups))


def forward(cfg, p, wav, samples=None, rng=None, cast=None):
    """(B, T) f32 waveforms → (B, F, head_outputs) logits. ``samples`` (B,)
    true sample counts turn on the per-row reading (serving); ``rng``
    (training) turns on dropout; ``cast`` (``fp8``) rounds the operands of
    every product, the control's lower precision."""
    e = "wav2vec2.encoder."
    drop = (lambda x, r: x) if rng is None else rng.drop
    c = cast or (lambda x: x)
    if samples is not None:
        sample_valid = (torch.arange(wav.shape[1], device=wav.device)[None, :]
                        < samples[:, None])
        x = masked_norm(wav, sample_valid) * sample_valid
    else:
        x = global_norm(wav)
    x = x[:, None, :]
    for i, s in enumerate(cfg["conv_stride"]):
        layer = f"{e}feature_extractor.layers.{i}."
        x = F.conv1d(c(x), c(p[layer + "conv.weight"]),
                     p.get(layer + "conv.bias"), stride=s)
        x = F.gelu(layer_norm(x.transpose(1, 2), p[layer + "layer_norm.scale"],
                              p[layer + "layer_norm.bias"]).transpose(1, 2))
    x = x.transpose(1, 2)
    lengths = valid = None
    if samples is not None:
        lengths = frames_of(cfg, samples)
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lengths[:, None])[..., None].to(x.dtype)
        x = x * valid
    x = layer_norm(x, p[e + "feat_proj_ln.scale"], p[e + "feat_proj_ln.bias"])
    x = c(x) @ c(p[e + "feat_proj.w"]) + p[e + "feat_proj.b"]
    if valid is not None:
        x = x * valid
    x = drop(x, cfg["feat_proj_dropout"])
    x = x + pos_conv(cfg, p, x, c)
    pre_ln = cfg["do_stable_layer_norm"]
    if not pre_ln:
        x = layer_norm(x, p[e + "encoder_ln.scale"], p[e + "encoder_ln.bias"])
    x = drop(x, cfg["hidden_dropout"])
    heads = cfg["num_attention_heads"]
    for i in range(cfg["num_hidden_layers"]):
        layer = f"{e}layers.{i}."

        def attn(h):
            b, t, d = h.shape
            q, k, v = ((c(h) @ c(p[f"{layer}attn.w{n}"])
                        + p[f"{layer}attn.b{n}"])
                       .reshape(b, t, heads, d // heads).transpose(1, 2)
                       for n in "qkv")
            o = attention(q, k, v, lengths, rng, cfg["attention_dropout"],
                          cast)
            o = o.transpose(1, 2).reshape(b, t, d)
            return drop(c(o) @ c(p[f"{layer}attn.wo"]) + p[f"{layer}attn.bo"],
                        cfg["hidden_dropout"])

        def ffn(h):
            h = drop(F.gelu(c(h) @ c(p[layer + "ffn1.w"])
                            + p[layer + "ffn1.b"]), cfg["activation_dropout"])
            return drop(c(h) @ c(p[layer + "ffn2.w"]) + p[layer + "ffn2.b"],
                        cfg["hidden_dropout"])

        ln1 = (p[layer + "ln1.scale"], p[layer + "ln1.bias"])
        ln2 = (p[layer + "ln2.scale"], p[layer + "ln2.bias"])
        if pre_ln:
            x = x + attn(layer_norm(x, *ln1))
            x = x + ffn(layer_norm(x, *ln2))
        else:
            x = layer_norm(x + attn(x), *ln1)
            x = layer_norm(x + ffn(x), *ln2)
    if pre_ln:
        x = layer_norm(x, p[e + "encoder_ln.scale"], p[e + "encoder_ln.bias"])
    if samples is not None:
        frame_valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                       < lengths[:, None])
        x = masked_norm(x, frame_valid)
    else:
        x = global_norm(x)
    return c(x) @ c(p["model.w"]) + p["model.b"]
