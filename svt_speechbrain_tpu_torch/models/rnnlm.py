"""RNN language model (port of ``svt_speechbrain_tpu/models/rnnlm.py``)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from svt_speechbrain_tpu_torch.nnet.embedding import Embedding
from svt_speechbrain_tpu_torch.nnet.linear import Linear
from svt_speechbrain_tpu_torch.nnet.normalization import LayerNorm
from svt_speechbrain_tpu_torch.nnet.rnn import GRU, LSTM


class RNNLM(nn.Module):
    """Embedding → LSTM or GRU → DNN blocks (``Linear``, ``LayerNorm``,
    leaky ReLU) → logits (``rnnlm.py:15``). The children are the JAX
    tree's keys: ``embedding``, ``rnn``, ``dnn{i}`` (``linear``, ``norm``)
    and ``out``. The RNN takes dropout between its layers in training.
    ``hx`` (per-layer states, as the RNN returns them) starts the RNN
    from them; the JAX RNN ignores it, so the two agree without it.

    Example
    -------
    >>> import torch
    >>> lm = RNNLM(output_neurons=50, embedding_dim=16, rnn_layers=1,
    ...            rnn_neurons=32, dnn_neurons=24)
    >>> lm(torch.tensor([[1, 2, 3]])).shape
    torch.Size([1, 3, 50])
    """

    def __init__(self, output_neurons, embedding_dim=128,
                 activation="leaky_relu", dropout=0.15, rnn_class="lstm",
                 rnn_layers=2, rnn_neurons=1024, dnn_blocks=1,
                 dnn_neurons=512, return_hidden=False):
        super().__init__()
        self.embedding = Embedding(output_neurons, embedding_dim)
        rnn_cls = {"lstm": LSTM, "gru": GRU}[rnn_class]
        self.rnn = rnn_cls(rnn_neurons, input_size=embedding_dim,
                           num_layers=rnn_layers, dropout=dropout)
        self.dnn_blocks = dnn_blocks
        in_size = rnn_neurons
        for i in range(dnn_blocks):
            self.add_module(f"dnn{i}", nn.ModuleDict(
                {"linear": Linear(dnn_neurons, in_size),
                 "norm": LayerNorm(dnn_neurons)}))
            in_size = dnn_neurons
        self.out = Linear(output_neurons, in_size)
        self.return_hidden = return_hidden

    def forward(self, x, hx=None, rng=None, train=False):
        """x (B, U) token ids → (B, U, vocab) logits (and the RNN's final
        states with ``return_hidden``)."""
        h = self.embedding(x)
        h, hidden = self.rnn(h, hx, rng=rng, train=train)
        for i in range(self.dnn_blocks):
            block = getattr(self, f"dnn{i}")
            h = F.leaky_relu(block["norm"](block["linear"](h)))
        logits = self.out(h)
        if self.return_hidden:
            return logits, hidden
        return logits
