"""Port parity, the rest of ``nnet/losses.py`` and ``nnet/loss/``
(``guidedattn_loss.py``, ``si_snr_loss.py``) against the JAX package on
the CPU, on the same seeded numpy inputs, f32: the masked regression and
classification losses under every reduction, label-smoothed KL, CTC (blank
0 and not, relative lengths that round, an impossible alignment), SI-SNR
with PIT, the angular-margin heads, the distillation losses and the masks.

Tolerance: RTOL relative plus ATOL absolute (f32 sums in other orders; the
CTC recursion's ``logaddexp`` in another formula).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svt_speechbrain_tpu.nnet import losses as jl
from svt_speechbrain_tpu.nnet.loss import guidedattn_loss as jga
from svt_speechbrain_tpu.nnet.loss import si_snr_loss as jsi

from svt_speechbrain_tpu_torch.nnet import losses as tl
from svt_speechbrain_tpu_torch.nnet.loss import guidedattn_loss as tga
from svt_speechbrain_tpu_torch.nnet.loss import si_snr_loss as tsi

RTOL = 1e-5
ATOL = 1e-6
REDUCTIONS = ["mean", "batchmean", "batch", "sum", "none"]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.asarray(a)) for a in arrays])


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", ["mse_loss", "l1_loss"])
def test_regression_losses(rng, name, reduction):
    pred = rng.standard_normal((3, 9, 4)).astype(np.float32)
    tgt = rng.standard_normal((3, 8, 4)).astype(np.float32)   # truncated
    lens = np.array([1.0, 0.5, 0.75], np.float32)
    (jp, jt, jlen), (tp, tt, tlen) = _pair(pred, tgt, lens)
    _close(getattr(tl, name)(tp, tt, tlen, reduction=reduction),
           getattr(jl, name)(jp, jt, jlen, reduction=reduction))


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_classification_error(rng, reduction):
    probs = rng.random((3, 7, 5)).astype(np.float32)
    tgt = rng.integers(0, 5, (3, 7))
    lens = np.array([1.0, 0.43, 0.71], np.float32)
    (jp, jt, jlen), (tp, tt, tlen) = _pair(probs, tgt, lens)
    _close(tl.classification_error(tp, tt, tlen, reduction=reduction),
           jl.classification_error(jp, jt, jlen, reduction=reduction))
    _close(tl.classification_error(tp[:, 0], tt[:, 0], reduction=reduction),
           jl.classification_error(jp[:, 0], jt[:, 0], reduction=reduction))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_kldiv_loss(rng, smoothing, reduction):
    logits = rng.standard_normal((3, 6, 7)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    tgt = rng.integers(0, 7, (3, 6))
    tgt[1, 4:] = 0                                  # padding positions
    lens = np.array([1.0, 0.67, 0.83], np.float32)
    (jp, jt, jlen), (tp, tt, tlen) = _pair(logp, tgt, lens)
    _close(tl.kldiv_loss(tp, tt, tlen, label_smoothing=smoothing,
                         reduction=reduction),
           jl.kldiv_loss(jp, jt, jlen, label_smoothing=smoothing,
                         reduction=reduction))


def _ctc_inputs(rng, blank):
    logits = rng.standard_normal((4, 12, 6)).astype(np.float32) * 2
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = [c for c in range(6) if c != blank]
    tgt = rng.choice(labels, size=(4, 5))
    tgt[0, 1] = tgt[0, 0]                            # a repeat
    tgt[3] = labels[0]                               # all one label
    in_lens = np.array([1.0, 0.75, 0.5, 0.25], np.float32)   # row 3: 3 frames
    tg_lens = np.array([1.0, 0.6, 0.5, 1.0], np.float32)     # 0.5·5 → 2
    return logp, tgt, in_lens, tg_lens


@pytest.mark.parametrize("reduction", ["mean", "batch", "batchmean", "sum"])
@pytest.mark.parametrize("blank", [0, 3])
def test_ctc_loss_matches_optax(rng, blank, reduction):
    """Row 3 needs 9 frames for its 5 repeated labels and has 3: the JAX
    loss (optax's recursion with log 0 = -1e5) is large and finite, and so
    is the port's; ``F.ctc_loss`` says inf there."""
    logp, tgt, in_lens, tg_lens = _ctc_inputs(rng, blank)
    (jp, jt, jin, jtg), (tp, tt, tin, ttg) = _pair(logp, tgt, in_lens,
                                                  tg_lens)
    want = jl.ctc_loss(jp, jt, jin, jtg, blank, reduction=reduction)
    got = tl.ctc_loss(tp, tt, tin, ttg, blank, reduction=reduction)
    _close(got, want)
    assert torch.isfinite(got).all()
    if reduction == "batch":
        assert float(got[3]) > 1e4
        lib = torch.nn.functional.ctc_loss(
            tp.transpose(0, 1), tt, torch.round(tin * 12).long(),
            torch.round(ttg * 5).long(), blank=blank, reduction="none")
        assert torch.isinf(lib[3])
        _close(got[:3], lib[:3], rtol=1e-4)


def test_si_snr_and_pit(rng):
    src = rng.standard_normal((3, 50, 2)).astype(np.float32)
    est = (src[..., ::-1] + 0.3 * rng.standard_normal((3, 50, 2))).astype(
        np.float32)
    (js, je), (ts, te) = _pair(src, est)
    _close(tl.cal_si_snr(ts, te), jl.cal_si_snr(js, je), rtol=1e-4)
    _close(tl.get_si_snr_with_pitwrapper(ts, te),
           jl.get_si_snr_with_pitwrapper(js, je), rtol=1e-4)
    mse = lambda s, e: ((s - e) ** 2).mean(axis=1) if isinstance(s, np.ndarray) \
        else ((s - e) ** 2).mean(1)
    _close(tl.PitWrapper(mse)(ts, te), jl.PitWrapper(mse)(js, je))


@pytest.mark.parametrize("easy", [False, True])
def test_angular_margins(rng, easy):
    cos = np.tanh(rng.standard_normal((5, 4))).astype(np.float32)
    cos[0, 0] = 1.0                                  # clipped
    tgt = rng.integers(0, 4, (5, 1))
    onehot = np.eye(4, dtype=np.float32)[tgt[:, 0]]
    (jc, jo, jt), (tc, to, tt) = _pair(cos, onehot, tgt)
    _close(tl.AngularMargin(0.2, 30.0)(tc, to),
           jl.AngularMargin(0.2, 30.0)(jc, jo))
    arc_t = tl.AdditiveAngularMargin(0.3, 30.0, easy_margin=easy)
    arc_j = jl.AdditiveAngularMargin(0.3, 30.0, easy_margin=easy)
    _close(arc_t(tc, to), arc_j(jc, jo), rtol=1e-5, atol=1e-5)
    _close(tl.LogSoftmaxWrapper(arc_t)(tc[:, None], tt),
           jl.LogSoftmaxWrapper(arc_j)(jc[:, None], jt), atol=1e-5)


def test_distillation_losses_and_mask(rng):
    logits = rng.standard_normal((3, 6, 5)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    teacher = np.exp(rng.standard_normal((3, 6, 5))).astype(np.float32)
    teacher /= teacher.sum(-1, keepdims=True)
    lens = np.array([1.0, 0.5, 0.0], np.float32)
    (jp, jt, jlen), (tp, tt, tlen) = _pair(logp, teacher, lens)
    _close(tl.ce_kd(tp, tt), jl.ce_kd(jp, jt))
    _close(tl.nll_loss_kd(tp, tt, tlen), jl.nll_loss_kd(jp, jt, jlen))
    _close(tl.ctc_loss_kd(tp, tt, tlen, 0), jl.ctc_loss_kd(jp, jt, jlen, 0))
    abs_lens = np.array([6, 2, 0])
    _close(tl.get_mask(tp, torch.from_numpy(abs_lens)),
           jl.get_mask(jp, jnp.asarray(abs_lens)))


@pytest.mark.parametrize("max_lens", [None, (5, 6)])
def test_guided_attention_loss(rng, max_lens):
    attn = rng.random((2, 6, 5)).astype(np.float32)
    in_lens, tg_lens = np.array([3, 5]), np.array([6, 4])
    kw = {} if max_lens is None else dict(max_input_len=max_lens[0],
                                          max_target_len=max_lens[1])
    (ja, ji, jt), (ta, ti, tt) = _pair(attn, in_lens, tg_lens)
    _close(tga.GuidedAttentionLoss(0.3)(ta, ti, tt, **kw),
           jga.GuidedAttentionLoss(0.3)(ja, ji, jt, **kw))
    _close(tga.GuidedAttentionLoss(0.2).guided_attentions(ti, tt),
           jga.GuidedAttentionLoss(0.2).guided_attentions(ji, jt))


@pytest.mark.parametrize("reduction", ["mean", "batch"])
def test_si_snr_loss(rng, reduction):
    clean = rng.standard_normal((3, 40, 1)).astype(np.float32)
    noisy = (clean + 0.2 * rng.standard_normal((3, 40, 1))).astype(np.float32)
    lens = np.array([1.0, 0.5, 0.8], np.float32)
    _close(tsi.si_snr_loss(torch.from_numpy(noisy), torch.from_numpy(clean),
                           torch.from_numpy(lens), reduction=reduction),
           jsi.si_snr_loss(jnp.asarray(noisy), jnp.asarray(clean), lens,
                           reduction=reduction), rtol=1e-4)
    _close(tsi.si_snr_loss(torch.from_numpy(noisy[..., 0]),
                           torch.from_numpy(clean[..., 0])),
           jsi.si_snr_loss(noisy[..., 0], clean[..., 0]), rtol=1e-4)
