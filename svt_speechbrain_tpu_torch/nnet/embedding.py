"""Embedding (port of ``svt_speechbrain_tpu/nnet/embedding.py``)."""
from __future__ import annotations

import torch
from torch import nn


class Embedding(nn.Module):
    """Token embedding lookup (``:9``). ``table`` is (num_embeddings,
    embedding_dim), zeros until loaded (``convert_jax.init_embedding`` draws
    the JAX package's unit normal). With ``consider_as_one_hot``
    it is a fixed one-hot table with the column of ``blank_id`` deleted
    (width N - 1, so the blank embeds to zeros), kept as a buffer.

    Example
    -------
    >>> import torch
    >>> emb = Embedding(num_embeddings=10, embedding_dim=16)
    >>> emb(torch.tensor([[1, 2, 3]])).shape
    torch.Size([1, 3, 16])
    >>> onehot = Embedding(4, consider_as_one_hot=True, blank_id=0)
    >>> [int(v) for v in onehot(torch.tensor([2]))[0]]
    [0, 1, 0]
    """

    def __init__(self, num_embeddings, embedding_dim=128,
                 consider_as_one_hot=False, blank_id=0):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.consider_as_one_hot = consider_as_one_hot
        self.blank_id = blank_id
        if consider_as_one_hot:
            keep = [i for i in range(num_embeddings) if i != blank_id]
            self.register_buffer("table", torch.eye(num_embeddings)[:, keep])
        else:
            self.table = nn.Parameter(
                torch.zeros(num_embeddings, embedding_dim))

    def forward(self, x):
        return nn.functional.embedding(x.long(), self.table)
