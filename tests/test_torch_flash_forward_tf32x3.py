"""The numerics of the f32 attention forward kernel, on the CPU.

On the card, ``csrc/flash_attention.cu`` runs the two f32 products of the
forward (kernels 2, 3 and 3b) as three TF32 tensor-core products each, as
the backward does (``tests/test_torch_flash_backward_tf32x3.py``): S = Q Kᵀ
summed one k step of 8 at a time, each step added to S in f32; and, per
panel of keys, O = O·alpha + P·V with that panel's P·V summed on its own,
inside an online softmax over the panels (running max m and sum l, panels
past a row's length skipped). This file emulates that recurrence in torch
with the backward test's TF32 split, at TINY-like shapes (D 16 and 64, a row
of length 0, dropout 0.1 with the port's hash mask, panels of 16 (the f32
kernel's), 32 and 64 keys), and holds out and L = m + log l to a float64
reference: within the
kernel's f32 tolerance on the card (``TRAIN_TOL_F32``, max abs error), and
within ``FACTOR`` of plain f32's own error on the same inputs (measured
here: out 2.2e-7 to 3.8e-7, 0.37x to 1.07x of plain f32's; L 4.2e-7 to
4.9e-7, 0.92x to 1.12x; one TF32 product per product instead misses
``TRAIN_TOL_F32``, at 5.0e-4 to 6.4e-4 on out). The tensor cores'
truncation inside a chunk and the kernel's fast exp are not modelled: the
card tests hold the kernel itself.
"""
import math

import numpy as np
import pytest
import torch

from svt_speechbrain_tpu_torch.ops import flash_attention as fa
from tests.test_torch_flash_backward_tf32x3 import (FACTOR, TRAIN_TOL_F32,
                                                    matmul, mm3, tf32_once)
from tests.torch_threads import two_torch_threads  # noqa: F401

SEED = 2 ** 31 - 2


def _forward(q, k, v, lengths, rate, panel, mm):
    """(out, L) through the kernel's recurrence, every product taken by
    ``mm(a, b, chunk)`` in the dtype of the inputs: S in k steps of 8 over D,
    P·V one panel at a time."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    lens = torch.full((b,), tk) if lengths is None else lengths.clamp(0, tk)
    valid = fa._key_valid(lengths, tk, q.device)
    mask = (fa.attention_dropout_mask(SEED, b, h, tq, tk, rate).to(q.dtype)
            if rate > 0 else torch.ones(1, 1, 1, tk, dtype=q.dtype))
    m = torch.full((b, h, tq, 1), fa.NEG_INF, dtype=q.dtype)
    l = torch.zeros((b, h, tq, 1), dtype=q.dtype)
    o = torch.zeros_like(q)
    for k0 in range(0, tk, panel):
        cols = slice(k0, k0 + panel)
        s = mm(q, k[:, :, cols].transpose(-1, -2), 8) * scale
        s = torch.where(valid[..., cols], s, torch.full_like(s, fa.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        pv = mm(p * mask[..., cols], v[:, :, cols], panel)
        runs = (lens > k0)[:, None, None, None]     # the panels a row runs
        m = torch.where(runs, m_new, m)
        l = torch.where(runs, l * alpha + p.sum(-1, keepdim=True), l)
        o = torch.where(runs, o * alpha + pv, o)
    out = o / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, fa.NEG_INF))
    return out, lse[..., 0]


CASES = [  # (B, H, Tq, Tk, D, lengths, rate): TINY's D = 16, lv60's D = 64
    (3, 2, 70, 150, 16, [150, 0, 41], 0.1),
    (3, 2, 96, 130, 64, [130, 0, 65], 0.1),
    (2, 2, 80, 100, 64, None, 0.0),
]


@pytest.mark.parametrize("panel", [16, 32, 64])
@pytest.mark.parametrize("output", ["out", "lse"])
@pytest.mark.parametrize("b,h,tq,tk,d,lens,rate", CASES)
def test_tf32x3_forward_matches_f64(b, h, tq, tk, d, lens, rate, output,
                                    panel):
    rng = np.random.default_rng(29 + d)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
    lengths = None if lens is None else torch.tensor(lens)
    i = ("out", "lse").index(output)
    want = _forward(q.double(), k.double(), v.double(), lengths, rate, panel,
                    matmul)[i]
    got = _forward(q, k, v, lengths, rate, panel, mm3)[i]
    plain = fa.attention_lse_reference(q, k, v, lengths, None, SEED, rate)[i]
    single = _forward(q, k, v, lengths, rate, panel, tf32_once)[i]
    live = want > fa.NEG_INF / 2
    if output == "lse":
        assert torch.equal(got > fa.NEG_INF / 2, live)
        got, want, plain, single = (t[live] for t in (got, want, plain,
                                                      single))
    err = (got.double() - want).abs().max().item()
    plain_err = (plain.double() - want).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= TRAIN_TOL_F32, (err, plain_err)
    assert err <= FACTOR * plain_err, (err, plain_err)
    # the split is what buys it: one TF32 product per product misses
    assert (single.double() - want).abs().max().item() > TRAIN_TOL_F32
    if lens is not None and output == "out":
        dead = torch.tensor(lens) == 0
        assert (got[dead] == 0).all()  # a row of length 0: exact zeros


def test_forward_recurrence_in_f64_is_the_plain_attention():
    """The emulated recurrence itself (f64, plain products) against the
    plain version in f64 terms: the panels and the online rescale change
    nothing but rounding."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 50, 16))).double()
               for _ in range(3))
    lengths = torch.tensor([50, 7])
    out, lse = _forward(q, k, v, lengths, 0.0, 32, matmul)
    s = q @ k.transpose(-1, -2) / 4.0
    s = torch.where(fa._key_valid(lengths, 50, q.device), s,
                    torch.full_like(s, fa.NEG_INF))
    torch.testing.assert_close(out, torch.softmax(s, -1) @ v, rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-12)
