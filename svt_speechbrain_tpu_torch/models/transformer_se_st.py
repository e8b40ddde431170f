"""TransformerSE, TransformerST and the IMU CRNNs (port of
``svt_speechbrain_tpu/models/transformer_se_st.py``). Channel-last;
children named as the JAX trees; BatchNorm statistics are buffers."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.models.transformer import (
    PositionalEncoding, TransformerEncoder, get_lookahead_mask)
from svt_speechbrain_tpu_torch.models.transformer_asr import TransformerASR
from svt_speechbrain_tpu_torch.nnet.cnn import Conv1d
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import BatchNorm1d
from svt_speechbrain_tpu_torch.nnet.pooling import Pooling1d
from svt_speechbrain_tpu_torch.nnet.rnn import GRU


class CNNTransformerSE(nn.Module):
    """Speech-enhancement transformer (``transformer_se_st.py:19``): an
    input ``Linear`` (``emb``) plus sinusoidal positions → a post-LN
    ``TransformerEncoder`` (look-ahead masked when ``causal``) → ``out`` →
    relu, sigmoid or no output activation. ``rng`` (a ``StepRNG``) draws
    the encoder's dropout in training.

    Example
    -------
    >>> import torch
    >>> se = CNNTransformerSE(d_model=16, output_size=20, nhead=4,
    ...                       num_layers=1, d_ffn=32, input_size=20)
    >>> mask = se(torch.ones(2, 6, 20))
    >>> mask.shape, bool((mask >= 0).all())
    (torch.Size([2, 6, 20]), True)
    """

    def __init__(self, d_model, output_size, output_activation="relu",
                 nhead=8, num_layers=8, d_ffn=512, dropout=0.1,
                 input_size=None, causal=True):
        super().__init__()
        self.emb = Linear(d_model, input_size or d_model)
        self.pos = PositionalEncoding(d_model)
        self.encoder = TransformerEncoder(num_layers, nhead, d_ffn,
                                          d_model=d_model, dropout=dropout,
                                          normalize_before=False)
        self.out = Linear(output_size, d_model)
        self.output_activation = output_activation
        self.causal = causal

    def forward(self, x, rng=None, train=False):
        h = self.emb(x)
        h = h + self.pos(h)
        mask = get_lookahead_mask(h) if self.causal else None
        h, _ = self.encoder(h, src_mask=mask, rng=rng, train=train)
        out = self.out(h)
        if self.output_activation == "relu":
            return torch.relu(out)
        if self.output_activation == "sigmoid":
            return torch.sigmoid(out)
        return out


class TransformerST(TransformerASR):
    """Speech-translation transformer (``transformer_se_st.py:69``): the
    ``TransformerASR`` with, given ``ctc_vocab``, a CTC ``Linear``
    (``ctc_lin``) over the encoder for auxiliary ASR supervision."""

    def __init__(self, *args, ctc_vocab=None, **kwargs):
        super().__init__(*args, **kwargs)
        d_model = self.src.n_neurons
        self.ctc_lin = Linear(ctc_vocab, d_model) if ctc_vocab else None

    def forward_asr_ctc(self, encoder_out):
        """Log-probabilities of the CTC branch over ``encoder_out``."""
        if self.ctc_lin is None:
            raise ValueError("TransformerST built without a CTC branch")
        return torch.log_softmax(self.ctc_lin(encoder_out), dim=-1)


class IMU_CRNN(nn.Module):
    """Conv + GRU classifier over IMU channels
    (``transformer_se_st.py:92``): per channel width a "same" ``Conv1d``
    (``conv{i}``), leaky ReLU, ``BatchNorm1d`` (``norm{i}``) and a max pool
    of 2; a GRU; ``out`` on its last frame → (B, outputs).

    Example
    -------
    >>> import torch
    >>> imu = IMU_CRNN(input_size=6, channels=(8, 16), rnn_neurons=12,
    ...                outputs=4)
    >>> imu(torch.ones(2, 32, 6)).shape
    torch.Size([2, 4])
    """

    def __init__(self, input_size=6, channels=(32, 64), kernel_size=5,
                 rnn_neurons=64, outputs=8, pool_size=2, dropout=0.1):
        super().__init__()
        self.n_convs = len(channels)
        in_ch = input_size
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", Conv1d(ch, kernel_size, in_ch,
                                               padding="same"))
            self.add_module(f"norm{i}", BatchNorm1d(ch))
            in_ch = ch
        self.pool = Pooling1d("max", pool_size)
        self.rnn = GRU(rnn_neurons, input_size=in_ch, num_layers=1)
        self.out = Linear(outputs, rnn_neurons)

    def forward(self, x, rng=None, train=False):
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x))
            x = self.pool(getattr(self, f"norm{i}")(x, train=train))
        h = self.rnn(x, rng=rng, train=train)[0]
        return self.out(h[:, -1])


class ConvBlock(nn.Module):
    """"Same" ``Conv1d`` → ``BatchNorm1d`` → ReLU
    (``transformer_se_st.py:149``). The JAX state tree keeps the norm's
    statistics at the block's path."""

    jax_state_child = "norm"

    def __init__(self, out_channels, in_channels, kernel_size=3, stride=1):
        super().__init__()
        self.conv = Conv1d(out_channels, kernel_size, in_channels,
                           stride=stride, padding="same")
        self.norm = BatchNorm1d(out_channels)

    def forward(self, x, train=False):
        return torch.relu(self.norm(self.conv(x), train=train))


class IMU_CRNN_GRU(nn.Module):
    """``ConvBlock``s (``block{i}``) → GRU → ``head`` on the last frame
    (``transformer_se_st.py:177``). The JAX module calls its blocks without
    a state, so always in eval on its initial statistics; the port calls
    them in eval on theirs."""

    def __init__(self, in_channels=6, conv_channels=(32, 64), hidden=64,
                 n_classes=2):
        super().__init__()
        self.n_blocks = len(conv_channels)
        ch = in_channels
        for i, c in enumerate(conv_channels):
            self.add_module(f"block{i}", ConvBlock(c, ch))
            ch = c
        self.rnn = GRU(hidden, input_size=ch)
        self.head = Linear(n_classes, hidden)

    def forward(self, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return self.head(self.rnn(x)[0][:, -1])


def check_model(model, input_shape=(2, 100, 6)):
    """The output shape of ``model`` on a zero input of ``input_shape``, on
    the device of its parameters (``transformer_se_st.py:208``; the JAX
    function also takes the params tree).

    Example
    -------
    >>> check_model(IMU_CRNN_GRU())
    torch.Size([2, 2])
    """
    param = next(model.parameters(), None)
    device = param.device if param is not None else None
    with torch.no_grad():
        return model(torch.zeros(input_shape, device=device)).shape
