"""Port parity, RNN-T lattice and fused loss: the port's
``ops/transducer_lattice.py`` (on the CPU: the kernels' plain versions)
against the JAX package's Pallas kernel in interpret mode, its ``lax.scan``
lattice and its fused losses, on the same numpy inputs, in f32 (the
lattice's alpha and beta panels: ``test_torch_lattice_panels.py``)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from svt_speechbrain_tpu.nnet.loss.transducer_loss import (
    transducer_loss as j_transducer_loss)
from svt_speechbrain_tpu.ops import transducer_lattice as jtl

from svt_speechbrain_tpu_torch import ops
from svt_speechbrain_tpu_torch.nnet.loss.transducer_loss import (
    TransducerLoss, transducer_forward_score, transducer_loss)
from svt_speechbrain_tpu_torch.ops import transducer_lattice as tl
from tests.torch_threads import two_torch_threads  # noqa: F401

BLANK = 0


def _problem(seed, b, t, u, v, t_lens, u_lens, blank_target=False):
    """numpy logits, targets and relative lengths; ``blank_target`` puts the
    blank among the labels."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, t, u + 1, v)).astype(np.float32)
    targets = rng.integers(0 if blank_target else 1, v,
                           size=(b, u)).astype(np.int32)
    if blank_target and u:
        targets[0, 0] = BLANK
    return (logits, targets, np.asarray(t_lens, np.float32) / t,
            np.asarray(u_lens, np.float32) / max(u, 1))


# B 3, T 12, U 5 with ragged lengths and one empty target; U1 = 1; T = 1
PROBLEMS = {
    "ragged": dict(b=3, t=12, u=5, v=7, t_lens=[12, 10, 7], u_lens=[5, 4, 0]),
    "u1_is_1": dict(b=2, t=6, u=0, v=5, t_lens=[6, 4], u_lens=[0, 0]),
    "t_is_1": dict(b=2, t=1, u=4, v=6, t_lens=[1, 1], u_lens=[4, 2]),
}


def _panels(logits, targets, t_rel, u_rel):
    """The JAX package's own alpha and (masked) beta panels for a problem,
    as numpy: (skip, emit_pad, seed), (skip_m, emit_m, seed_tu), lengths."""
    b, t, u1, _ = logits.shape
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    skip, emit_pad = jtl._gather_skip_emit(lp, jnp.asarray(targets), BLANK)
    t_len = np.round(t_rel * t).astype(np.int32)
    u_len = np.round(u_rel * (u1 - 1)).astype(np.int32)
    t_grid = np.arange(t)[None, :, None]
    u_grid = np.arange(u1)[None, None, :]
    t_valid = t_grid < t_len[:, None, None]
    skip_m = np.where(t_valid & (u_grid <= u_len[:, None, None]), skip,
                      jtl.NEG_INF).astype(np.float32)
    emit_m = np.where(t_valid & (u_grid < u_len[:, None, None]), emit_pad,
                      jtl.NEG_INF).astype(np.float32)
    seed = np.full((b, t, u1), jtl.NEG_INF, np.float32)
    seed[:, 0, 0] = 0.0
    seed_tu = np.full((b, t + 1, u1), jtl.NEG_INF, np.float32)
    seed_tu[np.arange(b), t_len, u_len] = 0.0
    return ((np.asarray(skip), np.asarray(emit_pad), seed),
            (skip_m, emit_m, seed_tu), t_len, u_len)


def _valid(t_len, u_len, rows, u1, extra_row=0):
    t_grid = np.arange(rows)[None, :, None]
    u_grid = np.arange(u1)[None, None, :]
    return ((t_grid < (t_len + extra_row)[:, None, None])
            & (u_grid <= u_len[:, None, None]))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


LOSS_PROBLEMS = dict(PROBLEMS, blank_target=dict(
    b=3, t=9, u=4, v=6, t_lens=[9, 7, 5], u_lens=[4, 3, 0],
    blank_target=True))


@pytest.mark.parametrize("from_log_probs", [False, True])
@pytest.mark.parametrize("fn", ["transducer_loss_fused",
                                "transducer_loss_pallas"])
@pytest.mark.parametrize("name", LOSS_PROBLEMS)
def test_fused_loss_and_gradient_match_jax(name, fn, from_log_probs):
    """Rows and the gradient w.r.t. the logits against the JAX function of
    the same name (its Pallas kernel in interpret mode for ``_pallas``) and
    against the port's own autograd ``transducer_loss``: loss rtol 1e-5,
    gradient atol 1e-5 (the JAX tests' own tolerances); the gradient is
    exactly 0 outside each row's valid region and sums to 0 over V."""
    logits, targets, t_rel, u_rel = _problem(2, **LOSS_PROBLEMS[name])
    if from_log_probs:
        logits = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    b, t, u1, _ = logits.shape
    weights = np.linspace(0.5, 1.5, b).astype(np.float32)

    def j_loss(l):
        return getattr(jtl, fn)(l, jnp.asarray(targets), jnp.asarray(t_rel),
                                jnp.asarray(u_rel), BLANK, reduction="none",
                                from_log_probs=from_log_probs)

    # jitted: op by op the JAX side took most of this test's time
    want = np.asarray(jax.jit(j_loss)(jnp.asarray(logits)))
    want_grad = np.asarray(jax.jit(jax.grad(
        lambda l: (j_loss(l) * weights).sum()))(jnp.asarray(logits)))

    got, grads = {}, {}
    for key, loss_fn in (("fused", getattr(tl, fn)), ("oracle",
                                                      transducer_loss)):
        leaf = torch.from_numpy(logits).requires_grad_()
        nll = loss_fn(leaf, *_t(targets, t_rel, u_rel), BLANK,
                      reduction="none", from_log_probs=from_log_probs)
        (nll * torch.from_numpy(weights)).sum().backward()
        got[key], grads[key] = nll.detach().numpy(), leaf.grad.numpy()
    np.testing.assert_allclose(got["fused"], want, rtol=1e-5)
    np.testing.assert_allclose(got["fused"], got["oracle"], rtol=1e-5)
    np.testing.assert_allclose(grads["fused"], want_grad, atol=1e-5)
    np.testing.assert_allclose(grads["fused"], grads["oracle"], atol=1e-5)

    t_len = np.round(t_rel * t).astype(np.int32)
    u_len = np.round(u_rel * (u1 - 1)).astype(np.int32)
    dead = ~_valid(t_len, u_len, t, u1)
    assert (grads["fused"][dead] == 0).all()
    assert np.abs(grads["fused"]).max() > 0
    if not from_log_probs:
        np.testing.assert_allclose(grads["fused"].sum(-1), 0.0, atol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "batchmean", "sum", "none",
                                       "batch"])
def test_reductions_match_jax(reduction):
    """"mean" and "batchmean" are the mean over rows, "sum" the sum,
    anything else the rows: the fused loss, the autograd loss and
    ``TransducerLoss`` (both settings of ``fused``) against the JAX pair."""
    logits, targets, t_rel, u_rel = _problem(3, **LOSS_PROBLEMS["ragged"])
    j_args = (jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(t_rel),
              jnp.asarray(u_rel), BLANK)
    t_args = _t(logits, targets, t_rel, u_rel)
    want_fused = np.asarray(jtl.transducer_loss_fused(*j_args,
                                                      reduction=reduction))
    want_plain = np.asarray(j_transducer_loss(*j_args, reduction=reduction))
    for fused, want in ((True, want_fused), (False, want_plain)):
        got = TransducerLoss(BLANK, reduction=reduction, fused=fused)(*t_args)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(
        tl.transducer_loss_fused(*t_args, BLANK, reduction=reduction).numpy(),
        want_fused, rtol=1e-5)
    np.testing.assert_allclose(
        transducer_loss(*t_args, BLANK, reduction=reduction).numpy(),
        want_plain, rtol=1e-5)


def test_forward_score_matches_jax():
    from svt_speechbrain_tpu.nnet.loss.transducer_loss import (
        transducer_forward_score as j_score)

    logits, targets, _, _ = _problem(4, **PROBLEMS["ragged"])
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    want = np.asarray(j_score(jnp.asarray(lp), jnp.asarray(targets), BLANK))
    got = transducer_forward_score(*_t(lp, targets), BLANK).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("lattice", ["kernel", "pallas", "scan"])
def test_fused_loss_matches_brute_force(lattice):
    """Independent check against an exhaustive path-sum DP in numpy (the
    JAX package's own, ``tests/test_transducer_lattice.py``), for every
    spelling of ``lattice``."""
    rng = np.random.default_rng(1)
    t, u, v = 5, 3, 4
    logits = rng.normal(size=(1, t, u + 1, v)).astype(np.float32)
    targets = np.array([[1, 2, 3]], np.int32)
    lp = torch.log_softmax(torch.from_numpy(logits).double(), -1).numpy()

    alpha = np.full((t, u + 1), -np.inf)
    alpha[0, 0] = 0.0
    for ti in range(t):
        for ui in range(u + 1):
            terms = []
            if ti > 0:
                terms.append(alpha[ti - 1, ui] + lp[0, ti - 1, ui, 0])
            if ui > 0:
                terms.append(alpha[ti, ui - 1]
                             + lp[0, ti, ui - 1, targets[0, ui - 1]])
            if terms:
                alpha[ti, ui] = np.logaddexp.reduce(terms)
    expected = -(alpha[t - 1, u] + lp[0, t - 1, u, 0])
    got = float(tl.transducer_loss_fused(
        *_t(logits, targets), torch.ones(1), torch.ones(1), BLANK,
        lattice=lattice))
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_unknown_lattice_raises():
    logits, targets, t_rel, u_rel = _problem(5, **PROBLEMS["ragged"])
    with pytest.raises(ValueError):
        tl.transducer_loss_fused(*_t(logits, targets, t_rel, u_rel), BLANK,
                                 lattice="cudnn")


def test_bf16_logits_get_a_bf16_gradient():
    """The logits are cast to f32 on entry; the cast's backward hands a bf16
    input a bf16 gradient, equal to the f32 gradient of the same (bf16)
    values rounded once."""
    logits, targets, t_rel, u_rel = _problem(6, **LOSS_PROBLEMS["ragged"])
    leaf = torch.from_numpy(logits).bfloat16().requires_grad_()
    wide = leaf.detach().float().requires_grad_()
    for x in (leaf, wide):
        tl.transducer_loss_fused(x, *_t(targets, t_rel, u_rel), BLANK,
                                 reduction="sum").backward()
    assert leaf.grad.dtype == torch.bfloat16
    assert torch.equal(leaf.grad, wide.grad.bfloat16())
    g_jax = jax.grad(lambda l: jtl.transducer_loss_fused(
        l, jnp.asarray(targets), jnp.asarray(t_rel), jnp.asarray(u_rel),
        BLANK, reduction="sum"))(jnp.asarray(logits).astype(jnp.bfloat16))
    assert g_jax.dtype == jnp.bfloat16
    # one bf16 rounding of gradients below 1 on each side
    np.testing.assert_allclose(leaf.grad.float().numpy(),
                               np.asarray(g_jax.astype(jnp.float32)),
                               atol=2.0 ** -8)


def test_grad_plain_adds_both_terms_on_a_blank_target():
    """A target equal to the blank gets the skip and the emit term on the
    same v (added, not overwritten): the gradient at the blank of such a
    cell equals the autograd gradient, and differs from either term
    alone."""
    logits, targets, t_rel, u_rel = _problem(7, b=1, t=4, u=2, v=3,
                                             t_lens=[4], u_lens=[2])
    targets[:] = BLANK
    grads = []
    for fn in (tl.transducer_loss_fused, transducer_loss):
        leaf = torch.from_numpy(logits).requires_grad_()
        fn(leaf, *_t(targets, t_rel, u_rel), BLANK).backward()
        grads.append(leaf.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], atol=1e-6)
    want = np.asarray(jax.grad(lambda l: jtl.transducer_loss_fused(
        l, jnp.asarray(targets), jnp.asarray(t_rel), jnp.asarray(u_rel),
        BLANK))(jnp.asarray(logits)))
    np.testing.assert_allclose(grads[0], want, atol=1e-6)


def test_cpu_calls_count_no_launch():
    logits, targets, t_rel, u_rel = _problem(8, **PROBLEMS["ragged"])
    ops.reset_launch_counts()
    leaf = torch.from_numpy(logits).requires_grad_()
    tl.transducer_loss_pallas(leaf, *_t(targets, t_rel, u_rel),
                              BLANK).backward()
    counts = ops.launch_counts()
    assert counts["rnnt_lattice"] == 0 and counts["rnnt_grad"] == 0
    assert {"rnnt_lattice", "rnnt_grad"} <= set(ops.kernel_wrappers())
