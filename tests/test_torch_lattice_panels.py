"""Port parity, the RNN-T lattice's recurrence: ``lattice_plain`` against the
JAX package's Pallas kernel in interpret mode and its scan, on alpha and on
the masked beta panels (the fused losses built on it:
``test_torch_transducer_lattice.py``)."""
import numpy as np
import pytest

import jax.numpy as jnp

from svt_speechbrain_tpu.ops import transducer_lattice as jtl

from svt_speechbrain_tpu_torch.ops import transducer_lattice as tl
from tests.test_torch_transducer_lattice import (  # noqa: F401
    PROBLEMS, _panels, _problem, _t, _valid)
from tests.torch_threads import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("name", PROBLEMS)
def test_lattice_plain_matches_pallas_kernel_and_scan_on_alpha(name):
    """``lattice_plain`` against ``_run_lattice(interpret=True)`` through
    ``_skew``/``_unskew`` and against ``_lattice_scan``, alpha panels, the
    whole grid (alpha runs unmasked). atol 1e-5, rtol 1e-6: f32 logaddexp
    chains in three orders of evaluation."""
    (skip, emit_pad, seed), _, _, _ = _panels(*_problem(0, **PROBLEMS[name]))
    b, t, u1 = skip.shape
    got = tl.lattice_plain(*_t(skip, emit_pad, seed)).numpy()
    d_total = t + u1 - 1
    seed_s = jnp.full((b, d_total, u1), jtl.NEG_INF).at[:, 0, 0].set(0.0)
    pallas = jtl._unskew(jtl._run_lattice(
        jtl._skew(jnp.asarray(skip), d_total),
        jtl._skew(jnp.asarray(emit_pad), d_total), seed_s, interpret=True), t)
    scan = jtl._lattice_scan(jnp.asarray(skip), jnp.asarray(emit_pad),
                             jnp.asarray(seed), finite_b=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(scan), atol=1e-5, rtol=1e-6)
    assert got[:, 0, 0].tolist() == [0.0] * b


@pytest.mark.parametrize("name", PROBLEMS)
def test_lattice_plain_matches_pallas_kernel_and_scan_on_beta(name):
    """The reverse lattice (the plain version's flips) against the JAX
    ``_beta`` through the interpret-mode kernel and through the scan, on the
    masked panels, held on each row's valid region (outside it everything is
    about -1e30 on every side, to no fixed bit pattern)."""
    _, (skip_m, emit_m, seed_tu), t_len, u_len = _panels(
        *_problem(1, **PROBLEMS[name]))
    got = tl.lattice_plain(*_t(skip_m, emit_m, seed_tu), reverse=True).numpy()
    live = _valid(t_len, u_len, got.shape[1], got.shape[2], extra_row=1)
    for lattice in ("pallas", "scan"):
        want = np.asarray(jtl._beta(jnp.asarray(skip_m), jnp.asarray(emit_m),
                                    jnp.asarray(seed_tu), True, lattice))
        np.testing.assert_allclose(got[live], want[live], atol=1e-5,
                                   rtol=1e-6)
        assert (got[~live] < -1e29).all() and (want[~live] < -1e29).all()
    assert np.isfinite(got).all()
    # the wrapper on CPU tensors is the plain version and counts nothing
    before = tl.rnnt_lattice.launches
    same = tl.rnnt_lattice(*_t(skip_m, emit_m, seed_tu), reverse=True)
    assert np.array_equal(same.numpy(), got)
    assert tl.rnnt_lattice.launches == before
