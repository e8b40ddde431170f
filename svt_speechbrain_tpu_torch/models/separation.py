"""Source-separation models (port of
``svt_speechbrain_tpu/models/separation.py``): Conv-TasNet (learned encoder,
TCN mask network, overlap-add decoder) and the dual-path models (chunked
intra/inter processing; SepFormer when both are transformer blocks).

Channel-last at every boundary, as the JAX modules: encoders give (B, T,
C), mask networks (B, T, sources, C). The children have the JAX trees'
names, so ``convert_jax.load_module_tree`` fills them from a JAX tree. The
transformer blocks run ``models.transformer``'s encoder, whose attention
keeps the JAX dispatch (the eager path with weights, never a kernel)."""
from __future__ import annotations

import copy

import torch
from torch import nn

from svt_speechbrain_tpu_torch.models.transformer import (
    PositionalEncoding, TransformerEncoder)
from svt_speechbrain_tpu_torch.nnet.activations import PReLU
from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d, ConvTranspose1d
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import (BatchNorm1d,
                                                          LayerNorm, wide)
from svt_speechbrain_tpu_torch.processing.signal_processing import (
    overlap_and_add)


class TasNetEncoder(nn.Module):
    """Waveform (B, T) → latent frames (B, T', C) by a bias-free strided
    conv ("valid", stride ``kernel_size // 2``) and a ReLU
    (``separation.py:24``).

    Example
    -------
    >>> import torch
    >>> TasNetEncoder(16, 32)(torch.ones(2, 160)).shape
    torch.Size([2, 19, 32])
    """

    def __init__(self, kernel_size=16, out_channels=256, stride=None):
        super().__init__()
        self.stride = stride or kernel_size // 2
        self.conv = Conv1d(out_channels, kernel_size, 1, stride=self.stride,
                           padding="valid", bias=False)

    def forward(self, wav):
        return torch.relu(self.conv(wav[..., None]))


class TasNetDecoder(nn.Module):
    """Latent frames (B, T', C) → waveform (B, T) by a bias-free transposed
    conv (``separation.py:40``)."""

    def __init__(self, kernel_size=16, in_channels=256, stride=None):
        super().__init__()
        self.stride = stride or kernel_size // 2
        self.deconv = ConvTranspose1d(1, kernel_size, in_channels,
                                      stride=self.stride, bias=False)

    def forward(self, h):
        return self.deconv(h)[..., 0]


class ConvTasNetEncoder(nn.Module):
    """Conv-TasNet's frontend (``separation.py:55``): a bias-free conv of
    stride L // 2 with reflect "same" padding, then a ReLU; (M, T) → (M,
    K, N)."""

    def __init__(self, L, N):
        super().__init__()
        self.conv = Conv1d(N, L, 1, stride=L // 2, padding="same",
                           padding_mode="reflect", bias=False)

    def forward(self, mixture):
        return torch.relu(self.conv(mixture[..., None]))


class ConvTasNetDecoder(nn.Module):
    """Conv-TasNet's decoder (``separation.py:73``): masked frames (M, K, C,
    N) → bias-free basis signals of length L → 50% overlap-add → (M, T,
    C)."""

    def __init__(self, L, N):
        super().__init__()
        self.L = L
        self.basis_signals = Linear(L, N, bias=False)

    def forward(self, mixture_w, est_mask):
        source_w = (mixture_w[:, :, None, :] * est_mask).permute(0, 2, 1, 3)
        est_source = overlap_and_add(self.basis_signals(source_w),
                                     self.L // 2)
        return est_source.permute(0, 2, 1)


class GlobalLayerNorm(nn.Module):
    """gLN (``separation.py:468``): statistics over every non-batch axis of
    each item (so a (B, S, K, d) tensor is normalized over S, K and d
    together), then ``scale`` and ``bias`` per channel.

    Example
    -------
    >>> import torch
    >>> y = GlobalLayerNorm(3)(torch.arange(12.0).reshape(1, 4, 3))
    >>> round(float(y.mean()), 6), round(float(y.std(unbiased=False)), 4)
    (0.0, 1.0)
    """

    def __init__(self, channel_size, eps=1e-8):
        super().__init__()
        self.channel_size = channel_size
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channel_size))
        self.bias = nn.Parameter(torch.zeros(channel_size))

    def forward(self, x):
        x32 = wide(x)
        dims = tuple(range(1, x.dim()))
        mean = x32.mean(dim=dims, keepdim=True)
        var = (x32 - mean).square().mean(dim=dims, keepdim=True)
        y = (x32 - mean) / torch.sqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


class ChannelwiseLayerNorm(GlobalLayerNorm):
    """cLN (``separation.py:489``): per-frame statistics over the channels,
    then ``scale`` and ``bias``."""

    def forward(self, x):
        x32 = wide(x)
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) / torch.sqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


CumulativeLayerNorm = ChannelwiseLayerNorm


def choose_norm(norm_type, channel_size):
    """"gLN" → ``GlobalLayerNorm``, "cLN" → ``ChannelwiseLayerNorm``, else
    ``BatchNorm1d`` (``separation.py:456``)."""
    if norm_type == "gLN":
        return GlobalLayerNorm(channel_size)
    if norm_type == "cLN":
        return ChannelwiseLayerNorm(channel_size)
    return BatchNorm1d(channel_size)


class DepthwiseSeparableConv(nn.Module):
    """Bias-free depthwise dilated conv (reflect "same", or left-padded
    with ``causal``, as the JAX module) → PReLU → norm → bias-free
    pointwise conv (``separation.py:96``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 dilation=1, norm_type="gLN", causal=False):
        super().__init__()
        self.dconv = Conv1d(in_channels, kernel_size, in_channels,
                            stride=stride, dilation=dilation,
                            padding="causal" if causal else "same",
                            padding_mode="reflect", groups=in_channels,
                            bias=False)
        self.act = PReLU()
        self.norm = choose_norm(norm_type, in_channels)
        self.pconv = Conv1d(out_channels, 1, in_channels, bias=False)

    def forward(self, x):
        return self.pconv(self.norm(self.act(self.dconv(x))))


class TemporalBlock(nn.Module):
    """TCN block with a residual around it (``separation.py:128``):
    bias-free 1x1 conv → PReLU → norm → ``DepthwiseSeparableConv``."""

    def __init__(self, channels, hidden, kernel_size, dilation,
                 norm_type="gLN", causal=False):
        super().__init__()
        self.conv_in = Conv1d(hidden, 1, channels, bias=False)
        self.act = PReLU()
        self.norm = choose_norm(norm_type, hidden)
        self.dsconv = DepthwiseSeparableConv(hidden, channels, kernel_size,
                                             1, dilation, norm_type, causal)

    def forward(self, x):
        h = self.norm(self.act(self.conv_in(x)))
        return x + self.dsconv(h)


class MaskNet(nn.Module):
    """Conv-TasNet's TCN mask network (``separation.py:152``): cLN →
    bias-free bottleneck → ``n_repeats`` x ``n_blocks`` dilated
    ``TemporalBlock``s (children ``block{i}``) → bias-free mask conv →
    relu or softmax over the channels. (M, K, N) → (M, K, C, N)."""

    def __init__(self, in_channels=256, bn_channels=128, hidden=512,
                 kernel_size=3, n_blocks=8, n_repeats=3, n_sources=2,
                 norm_type="gLN", causal=False, mask_nonlinear="relu"):
        super().__init__()
        if mask_nonlinear not in ("softmax", "relu"):
            raise ValueError("Unsupported mask non-linear function")
        self.n_sources = n_sources
        self.in_channels = in_channels
        self.mask_nonlinear = mask_nonlinear
        self.layer_norm = ChannelwiseLayerNorm(in_channels)
        self.bottleneck = Conv1d(bn_channels, 1, in_channels, bias=False)
        self.n_layers = n_blocks * n_repeats
        for i in range(self.n_layers):
            self.add_module(f"block{i}", TemporalBlock(
                bn_channels, hidden, kernel_size, 2 ** (i % n_blocks),
                norm_type, causal))
        self.mask_conv = Conv1d(n_sources * in_channels, 1, bn_channels,
                                bias=False)

    def forward(self, h):
        x = self.bottleneck(self.layer_norm(h))
        for i in range(self.n_layers):
            x = getattr(self, f"block{i}")(x)
        score = self.mask_conv(x)
        b, t, _ = score.shape
        score = score.reshape(b, t, self.n_sources, self.in_channels)
        if self.mask_nonlinear == "softmax":
            return torch.softmax(score, dim=-1)
        return torch.relu(score)


class ConvTasNet(nn.Module):
    """Conv-TasNet (``separation.py:204``): wav (B, T) → sources (B,
    n_sources, T').

    Example
    -------
    >>> import torch
    >>> sep = ConvTasNet(n_sources=2, enc_channels=32, bn_channels=16,
    ...                  hidden=32, n_blocks=2, n_repeats=1)
    >>> sep(torch.ones(1, 800)).shape
    torch.Size([1, 2, 816])
    """

    def __init__(self, n_sources=2, enc_kernel=16, enc_channels=256,
                 bn_channels=128, hidden=512, n_blocks=8, n_repeats=3,
                 norm_type="gLN", causal=False, mask_nonlinear="relu"):
        super().__init__()
        self.encoder = ConvTasNetEncoder(enc_kernel, enc_channels)
        self.masknet = MaskNet(enc_channels, bn_channels, hidden, 3,
                               n_blocks, n_repeats, n_sources, norm_type,
                               causal, mask_nonlinear)
        self.decoder = ConvTasNetDecoder(enc_kernel, enc_channels)
        self.n_sources = n_sources

    def forward(self, wav):
        h = self.encoder(wav)
        return self.decoder(h, self.masknet(h)).permute(0, 2, 1)


class SBTransformerBlock(nn.Module):
    """A transformer stack as a dual-path intra or inter model
    (``separation.py:511``): sinusoidal positions added when
    ``use_positional_encoding``, then ``models.transformer.
    TransformerEncoder`` (child ``encoder``)."""

    def __init__(self, num_layers, d_model, nhead, d_ffn=2048,
                 use_positional_encoding=False, norm_before=False):
        super().__init__()
        self.encoder = TransformerEncoder(num_layers, nhead, d_ffn,
                                          d_model=d_model,
                                          normalize_before=norm_before)
        self.pos = (PositionalEncoding(d_model) if use_positional_encoding
                    else None)
        self.output_size = d_model

    def forward(self, x):
        if self.pos is not None:
            x = x + self.pos(x)
        return self.encoder(x)[0]


class SBRNNBlock(nn.Module):
    """A bidirectional LSTM or GRU and a ``Linear`` back to the model width
    as a dual-path model (``separation.py:534``)."""

    def __init__(self, input_size, hidden_channels, num_layers=1,
                 rnn_type="lstm", bidirectional=True):
        super().__init__()
        from svt_speechbrain_tpu_torch.nnet.rnn import GRU, LSTM

        cls = {"lstm": LSTM, "gru": GRU}[rnn_type.lower()]
        self.rnn = cls(hidden_channels, input_size=input_size,
                       num_layers=num_layers, bidirectional=bidirectional)
        width = hidden_channels * (2 if bidirectional else 1)
        self.proj = Linear(input_size, width)
        self.output_size = input_size

    def forward(self, x):
        return self.proj(self.rnn(x)[0])


class DualComputationBlock(nn.Module):
    """One dual-path block (``separation.py:239``): the intra model over
    each chunk (chunks folded into the batch) → optional ``Linear`` → gLN
    (eps 1e-8, over the whole (S, K, d) item) → optional skip; the inter
    model over each position across chunks → optional ``Linear`` → gLN →
    the residual sum. Children ``intra``, ``inter``, ``intra_norm``,
    ``inter_norm`` and, only with ``linear_layer_after_inter_intra``,
    ``intra_linear`` and ``inter_linear``: SpeechBrain's published
    SepFormer has none."""

    def __init__(self, intra_mdl, inter_mdl, out_channels, norm="ln",
                 skip_around_intra=True, linear_layer_after_inter_intra=True):
        super().__init__()
        self.intra = intra_mdl
        self.inter = inter_mdl
        self.skip_around_intra = skip_around_intra
        self.use_linear = linear_layer_after_inter_intra
        self.norm = norm
        if norm is not None:
            self.intra_norm = GlobalLayerNorm(out_channels, eps=1e-8)
            self.inter_norm = GlobalLayerNorm(out_channels, eps=1e-8)
        if linear_layer_after_inter_intra:
            self.intra_linear = Linear(
                out_channels, getattr(intra_mdl, "output_size", out_channels))
            self.inter_linear = Linear(
                out_channels, getattr(inter_mdl, "output_size", out_channels))

    def forward(self, x):
        b, s, k, d = x.shape
        intra = self.intra(x.reshape(b * s, k, d))
        if self.use_linear:
            intra = self.intra_linear(intra)
        intra = intra.reshape(b, s, k, d)
        if self.norm is not None:
            intra = self.intra_norm(intra)
        if self.skip_around_intra:
            intra = intra + x
        inter = intra.transpose(1, 2).reshape(b * k, s, d)
        inter = self.inter(inter)
        if self.use_linear:
            inter = self.inter_linear(inter)
        inter = inter.reshape(b, k, s, d).transpose(1, 2)
        if self.norm is not None:
            inter = self.inter_norm(inter)
        return inter + intra


class SharedPReLU(nn.Module):
    """PReLU with one scalar slope ``alpha`` (shape ()) shared by every
    channel: the dual-path model's (``separation.py:382-383``)."""

    def __init__(self, init=0.25):
        super().__init__()
        self.init_val = init
        self.alpha = nn.Parameter(torch.tensor(float(init)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class Dual_Path_Model(nn.Module):
    """The dual-path mask network (``separation.py:297``), channel-last:
    gLN → bias-free 1x1 → optional scaled global positions → 50%-overlap
    chunks of K → ``num_layers`` ``DualComputationBlock``s (children
    ``blocks.{i}``, each with its own copy of the intra and inter models)
    → shared-scalar PReLU → 1x1 to ``num_spks`` channel groups →
    overlap-add → tanh x sigmoid gate → bias-free 1x1 → ReLU. (B, T, C) →
    (B, T, num_spks, C).

    Example
    -------
    >>> import torch
    >>> intra = SBTransformerBlock(1, 16, 4, 32)
    >>> inter = SBTransformerBlock(1, 16, 4, 32)
    >>> m = Dual_Path_Model(8, 16, intra, inter, num_layers=1, K=10)
    >>> m(torch.ones(2, 23, 8)).shape
    torch.Size([2, 23, 2, 8])
    """

    def __init__(self, in_channels, out_channels, intra_model, inter_model,
                 num_layers=1, norm="ln", K=200, num_spks=2,
                 skip_around_intra=True, linear_layer_after_inter_intra=True,
                 use_global_pos_enc=False, max_length=20000):
        super().__init__()
        self.num_spks = num_spks
        self.num_layers = num_layers
        self.K = K
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.norm = GlobalLayerNorm(in_channels, eps=1e-8)
        self.conv_in = Linear(out_channels, in_channels, bias=False)
        self.use_global_pos_enc = use_global_pos_enc
        if use_global_pos_enc:
            self.pos_enc = PositionalEncoding(out_channels, max_length)
        self.blocks = nn.ModuleList(DualComputationBlock(
            intra_model if i == 0 else copy.deepcopy(intra_model),
            inter_model if i == 0 else copy.deepcopy(inter_model),
            out_channels, norm, skip_around_intra,
            linear_layer_after_inter_intra) for i in range(num_layers))
        self.conv2d = Linear(out_channels * num_spks, out_channels)
        self.end_conv = Linear(in_channels, out_channels, bias=False)
        self.output = Linear(out_channels, out_channels)
        self.output_gate = Linear(out_channels, out_channels)
        self.prelu = SharedPReLU()

    def _segment(self, x):
        """(B, L, d) → (B, S, K, d) 50%-overlap chunks, and the gap padded
        at the end (``separation.py:349-358``)."""
        b, t, d = x.shape
        k = self.K
        p = k // 2
        gap = k - (p + t % k) % k
        x = torch.nn.functional.pad(x, (0, 0, p, p + gap))
        s1 = x[:, :-p].reshape(b, -1, k, d)
        s2 = x[:, p:].reshape(b, -1, k, d)
        return torch.stack([s1, s2], dim=2).reshape(b, -1, k, d), gap

    def _over_add(self, x, gap):
        """(B, S, K, d) → (B, L, d) overlap-add, the gap trimmed
        (``separation.py:360-370``)."""
        b, s, k, d = x.shape
        p = k // 2
        pairs = x.reshape(b, s // 2, 2, k, d)
        a = pairs[:, :, 0].reshape(b, -1, d)[:, p:]
        c = pairs[:, :, 1].reshape(b, -1, d)[:, :-p]
        y = a + c
        if gap > 0:
            y = y[:, :-gap]
        return y

    def forward(self, h):
        b = h.shape[0]
        x = self.conv_in(self.norm(h))
        if self.use_global_pos_enc:
            x = self.pos_enc(x) + x * (self.out_channels ** 0.5)
        x, gap = self._segment(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.conv2d(self.prelu(x))
        s_chunks, kk = x.shape[1], x.shape[2]
        x = x.reshape(b, s_chunks, kk, self.num_spks, self.out_channels)
        x = x.permute(0, 3, 1, 2, 4).reshape(
            b * self.num_spks, s_chunks, kk, self.out_channels)
        x = self._over_add(x, gap)
        x = torch.tanh(self.output(x)) * torch.sigmoid(self.output_gate(x))
        x = torch.relu(self.end_conv(x))
        x = x.reshape(b, self.num_spks, -1, self.in_channels)
        return x.permute(0, 2, 1, 3)


class DualPathModel(Dual_Path_Model):
    """SepFormer-style mask network (``separation.py:398``): a
    ``Dual_Path_Model`` with pre-LN ``SBTransformerBlock`` intra and inter
    models with positions, the intra/inter linears and a global positional
    encoding. It is a ``Dual_Path_Model``, so its tree is the JAX
    wrapper's (whose ``init`` returns the core's tree)."""

    def __init__(self, in_channels=256, d_model=128, n_sources=2,
                 chunk_size=50, num_layers=2, nhead=4, d_ffn=256,
                 num_dp_blocks=2, use_global_pos_enc=True):
        intra = SBTransformerBlock(num_layers, d_model, nhead, d_ffn,
                                   use_positional_encoding=True,
                                   norm_before=True)
        inter = SBTransformerBlock(num_layers, d_model, nhead, d_ffn,
                                   use_positional_encoding=True,
                                   norm_before=True)
        super().__init__(in_channels, d_model, intra, inter,
                         num_layers=num_dp_blocks, K=chunk_size,
                         num_spks=n_sources,
                         use_global_pos_enc=use_global_pos_enc)
        self.n_sources = n_sources


class SepFormer(nn.Module):
    """``TasNetEncoder`` → ``DualPathModel`` masks → ``TasNetDecoder`` a
    source (``separation.py:426``): wav (B, T) → (B, n_sources, T')."""

    def __init__(self, n_sources=2, enc_kernel=16, enc_channels=256,
                 d_model=128, chunk_size=50, num_layers=2, nhead=4,
                 d_ffn=256):
        super().__init__()
        self.encoder = TasNetEncoder(enc_kernel, enc_channels)
        self.masknet = DualPathModel(enc_channels, d_model, n_sources,
                                     chunk_size, num_layers, nhead, d_ffn)
        self.decoder = TasNetDecoder(enc_kernel, enc_channels)
        self.n_sources = n_sources

    def forward(self, wav):
        h = self.encoder(wav)
        masks = self.masknet(h)
        return torch.stack([self.decoder(h * masks[:, :, s])
                            for s in range(self.n_sources)], dim=1)


SepformerWrapper = SepFormer
Encoder = TasNetEncoder
Decoder = TasNetDecoder


def separate(encoder, masknet, decoder, mix):
    """Encoder → masks → a masked decode a source: the (B, T, sources)
    estimate of the mixture ``mix`` (B, T), cut or zero-padded to its
    length (the JAX ``SepformerSeparation.separate_batch``,
    ``pretrained/interfaces.py:448``). Gradients flow, so the serving
    interface and a training step share it.

    Example
    -------
    >>> import torch
    >>> enc, dec = TasNetEncoder(16, 8), TasNetDecoder(16, 8)
    >>> masknet = lambda h: torch.ones(*h.shape[:2], 2, h.shape[2])
    >>> separate(enc, masknet, dec, torch.ones(1, 1601)).shape
    torch.Size([1, 1601, 2])
    """
    h = encoder(mix)
    masks = masknet(h)
    est = torch.stack([decoder(h * masks[:, :, s])
                       for s in range(masks.shape[2])], dim=-1)
    t_mix, t_est = mix.shape[1], est.shape[1]
    if t_est > t_mix:
        return est[:, :t_mix]
    if t_est < t_mix:
        return torch.nn.functional.pad(est, (0, 0, 0, t_mix - t_est))
    return est


class Chomp1d(nn.Module):
    """Drop the last ``chomp_size`` frames (``separation.py:559``)."""

    def __init__(self, chomp_size):
        super().__init__()
        self.chomp_size = chomp_size

    def forward(self, x):
        return x[:, :-self.chomp_size] if self.chomp_size else x


class TemporalBlocksSequential(nn.Module):
    """``n_repeats`` x ``n_blocks`` dilated ``TemporalBlock``s, children
    ``0``, ``1``, ... (``separation.py:571``)."""

    def __init__(self, channels, hidden, kernel_size=3, n_blocks=8,
                 n_repeats=3, norm_type="gLN", causal=False):
        super().__init__()
        for i in range(n_blocks * n_repeats):
            self.add_module(str(i), TemporalBlock(
                channels, hidden, kernel_size, 2 ** (i % n_blocks),
                norm_type, causal))

    def forward(self, x):
        for blk in self.children():
            x = blk(x)
        return x


class IdentityBlock(nn.Module):
    """A no-op intra or inter model (``separation.py:592``)."""

    def forward(self, x, *args, **kwargs):
        return x


class DPTNetBlock(nn.Module):
    """DPT-Net block (``separation.py:604``): self-attention (no weights
    returned) → residual and LayerNorm → GRU → ReLU → ``Linear`` → residual
    and LayerNorm."""

    def __init__(self, d_model, nhead, dim_feedforward=256, dropout=0.0):
        super().__init__()
        from svt_speechbrain_tpu_torch.nnet.attention import (
            MultiheadAttention)
        from svt_speechbrain_tpu_torch.nnet.rnn import GRU

        self.attn = MultiheadAttention(nhead, d_model, dropout=dropout)
        self.rnn = GRU(dim_feedforward, input_size=d_model)
        self.proj = Linear(d_model, dim_feedforward)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x):
        a = self.attn(x, x, x, return_attn_weights=False)
        x = self.norm1(x + a)
        h = self.proj(torch.relu(self.rnn(x)[0]))
        return self.norm2(x + h)


class FastTransformerBlock(nn.Module):
    """The reference wraps the ``fast_transformers`` library, which is not
    available; use ``SBTransformerBlock`` (``separation.py:633``)."""

    def __init__(self, *args, **kwargs):
        raise ImportError("fast_transformers is not available; use "
                          "SBTransformerBlock")


class Dual_Computation_Block(nn.Module):
    """A dual-path step without norms or linears (``separation.py:645``):
    the intra model over each chunk, an optional skip, the inter model
    across chunks and the residual sum."""

    def __init__(self, intra_mdl, inter_mdl, skip_around_intra=True):
        super().__init__()
        self.intra = intra_mdl
        self.inter = inter_mdl
        self.skip_around_intra = skip_around_intra

    def forward(self, x):
        b, n_chunks, cs, d = x.shape
        intra = self.intra(x.reshape(b * n_chunks, cs, d))
        intra = intra.reshape(b, n_chunks, cs, d)
        if self.skip_around_intra:
            intra = intra + x
        swapped = intra.transpose(1, 2).reshape(b * cs, n_chunks, d)
        inter = self.inter(swapped).reshape(b, cs, n_chunks, d)
        return inter.transpose(1, 2) + intra


select_norm = choose_norm
PytorchTransformerBlock = SBTransformerBlock
PyTorchPositionalEncoding = PositionalEncoding
