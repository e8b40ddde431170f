"""The card-vs-CPU checks of ``chip_smoke.py`` refuse a non-finite
reading: a NaN or an inf in an output, a running statistic or a gradient
on the card fails the check, whatever the other readings are. The
phase-25 loop runs here on the CPU on both sides (the "card" side's
results are the CPU's with a NaN planted in them); no JAX, no card.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf])
def test_a_nonfinite_reading_is_not_within_any_tolerance(bad):
    assert cs.reading(bad) == math.inf
    assert cs.reading(torch.tensor(bad)) == math.inf
    assert cs.within({"a": 0.0, "b": 1e-12}, {"a": 1e-9, "b": 1e-9})
    assert not cs.within({"a": 0.0, "b": bad}, {"a": 1e-9, "b": math.inf})
    assert cs._worst({"a": 1.0, "b": cs.reading(bad), "c": 2.0}) == "b"


@pytest.mark.parametrize("leaf", ["w", "zero"])
def test_leaf_errors_flags_a_nan_gradient(leaf):
    """A NaN card gradient is an inf error, also on a leaf that would be
    exempt for its zero CPU gradient."""
    want = {"grads": {"w": torch.ones(3, dtype=torch.float64),
                      "zero": torch.zeros(3, dtype=torch.float64)}}
    got = {"grads": {k: v.clone() for k, v in want["grads"].items()}}
    errs, exempt = cs.leaf_errors(got, want, {"grad_rel": "grads"})
    assert errs["grad_rel"] == {"w": 0.0} and exempt == ["zero"]
    got["grads"][leaf][1] = math.nan
    errs, exempt = cs.leaf_errors(got, want, {"grad_rel": "grads"})
    assert errs["grad_rel"][leaf] == math.inf and leaf not in exempt


@pytest.fixture
def cbatchnorm_case_on_the_cpu(monkeypatch):
    """Phase 25's card-vs-CPU loop over the ``CBatchNorm`` case alone
    (outputs, running statistics and f64 gradients), both sides on the
    CPU; returns the dict that names the part of the card's results to
    spoil."""
    case = next(c for c in cs._rest_cases() if c[0] == "CBatchNorm")
    monkeypatch.setattr(cs, "_rest_cases", lambda: [case])
    real_run = cs._rest_run
    plant = {}

    def run(make, args, call, device, dtype, seed, grads):
        res = real_run(make, args, call, "cpu", dtype, seed, grads)
        part = plant.get("part")
        if device == "cuda" and part in res and (part == "grads") == grads:
            value = (res[part][0] if part == "outs"
                     else next(iter(res[part].values())))
            value.view(-1)[0] = math.nan
        return res

    monkeypatch.setattr(cs, "_rest_run", run)
    return plant


def test_the_rest_phase_passes_equal_sides(cbatchnorm_case_on_the_cpu):
    worst = cs.rest_card_vs_cpu(np.random.default_rng(0))
    assert worst == {"out_rel": 0.0, "grad_f64_rel": 0.0, "stats_rel": 0.0}


@pytest.mark.parametrize("part", ["outs", "stats", "grads"])
def test_the_rest_phase_fails_on_a_planted_nan(cbatchnorm_case_on_the_cpu,
                                               part):
    cbatchnorm_case_on_the_cpu["part"] = part
    with pytest.raises(AssertionError, match="disagrees card vs CPU"):
        cs.rest_card_vs_cpu(np.random.default_rng(0))


def test_the_projection_gives_a_norm_shift_a_gradient():
    """The f64 gradient check back-propagates a seeded projection of the
    output, so a norm's shift gets a gradient (under the mean of squares
    of its own whitened output it had none)."""
    case = next(c for c in cs._rest_cases() if c[0] == "CLayerNorm")
    _, make, inputs, call, _ = case
    res = cs._rest_run(make, inputs(np.random.default_rng(0)), call, "cpu",
                       torch.float64, 7, True)
    norms = {n: torch.linalg.vector_norm(g).item()
             for n, g in res["grads"].items()}
    total = math.sqrt(sum(v * v for v in norms.values()))
    assert all(v > cs.ZERO_GRAD_SHARE * total for v in norms.values()), norms
