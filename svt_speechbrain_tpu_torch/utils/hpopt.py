"""Hyperparameter-optimization reporters (analogue of reference
``speechbrain/utils/hpopt.py``; a copy of ``svt_speechbrain_tpu/utils/hpopt.py``
that parses the port's command line).

``hyperparameter_optimization`` context + ``report_result`` mirror the
reference's generic/Orion reporter registry (``hpopt.py:39``): results are
emitted as a JSON line (generic mode) or forwarded to Orion when available.
"""
from __future__ import annotations

import json
import logging
import os
import sys

logger = logging.getLogger(__name__)

_context = {"current": None}

KEY_HPOPT = "hpopt"
KEY_HPOPT_MODE = "hpopt_mode"
ORION_MARKER = "orion"
GENERIC_MARKER = "generic"


class HyperparameterOptimizationReporter:
    def report_objective(self, result):
        raise NotImplementedError


class GenericHyperparameterOptimizationReporter(HyperparameterOptimizationReporter):
    """Print a JSON line per trial (reference generic reporter).

    Example
    -------
    >>> import io
    >>> buf = io.StringIO()
    >>> rep = GenericHyperparameterOptimizationReporter(output=buf)
    >>> rep.report_objective({"objective": 0.25, "epoch": 3})
    >>> buf.getvalue().strip()
    '{"objective": 0.25, "epoch": 3}'
    """

    def __init__(self, objective_key="objective", output=None, reference_date=None):
        self.objective_key = objective_key
        self.output = output or sys.stdout

    def report_objective(self, result):
        json.dump(result, self.output)
        self.output.write("\n")


class OrionHyperparameterOptimizationReporter(HyperparameterOptimizationReporter):
    """Forward the objective to Orion (gated import)."""

    def __init__(self, objective_key="objective"):
        self.objective_key = objective_key
        import orion.client  # noqa: F401

        self.orion_client = __import__("orion.client", fromlist=["client"])

    def report_objective(self, result):
        objective = result[self.objective_key]
        self.orion_client.report_objective(objective)


class HyperparameterOptimizationContext:
    """Context manager wiring reporting (reference ``hpopt.py:119``)."""

    def __init__(self, reporter_args=None, reporter_kwargs=None):
        self.reporter_args = reporter_args or []
        self.reporter_kwargs = reporter_kwargs or {}
        self.reporter = None
        self.result = {"objective": 0.0}
        self.enabled = False

    def parse_arguments(self, arg_list):
        """Strip --hpopt/--hpopt_mode from CLI args; enable reporting."""
        from svt_speechbrain_tpu_torch.core import parse_arguments as base_parse

        filtered = []
        mode = None
        enabled = False
        it = iter(arg_list)
        for arg in it:
            if arg == f"--{KEY_HPOPT}":
                enabled = next(it, "false").lower() in ("true", "1", "yes")
            elif arg.startswith(f"--{KEY_HPOPT}="):
                enabled = arg.split("=", 1)[1].lower() in ("true", "1", "yes")
            elif arg == f"--{KEY_HPOPT_MODE}":
                mode = next(it, GENERIC_MARKER)
            elif arg.startswith(f"--{KEY_HPOPT_MODE}="):
                mode = arg.split("=", 1)[1]
            else:
                filtered.append(arg)
        self.enabled = enabled
        if enabled:
            if mode == ORION_MARKER:
                self.reporter = OrionHyperparameterOptimizationReporter(
                    *self.reporter_args, **self.reporter_kwargs)
            else:
                self.reporter = GenericHyperparameterOptimizationReporter(
                    *self.reporter_args, **self.reporter_kwargs)
        return base_parse(filtered)

    def __enter__(self):
        _context["current"] = self
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if self.enabled and exc_type is None and self.reporter is not None:
            self.reporter.report_objective(self.result)
        _context["current"] = None
        return False


def hyperparameter_optimization(*args, **kwargs):
    """Entry point (reference ``hpopt.py:39`` ``hpopt``)."""
    return HyperparameterOptimizationContext(args, kwargs)


def report_result(result):
    """Record the latest result dict for reporting at context exit."""
    ctx = _context["current"]
    if ctx is not None:
        ctx.result = dict(result)


def get_reporter(mode, *args, **kwargs):
    """Reporter factory by mode name (reference ``hpopt.py:39``)."""
    if mode == "orion":
        return OrionHyperparameterOptimizationReporter(*args, **kwargs)
    return GenericHyperparameterOptimizationReporter(*args, **kwargs)


def get_trial_id():
    """Current hyperparameter-search trial id (reference ``hpopt.py:307``):
    from the orion environment when present, else 'hpopt'."""
    import os

    return os.environ.get("ORION_TRIAL_ID", "hpopt")


def hpopt_mode(mode):
    """Reporter-class decorator registry (reference ``hpopt.py:39``)."""
    def decorator(cls):
        _hpopt_modes[mode] = cls
        return cls

    return decorator


_hpopt_modes = {
    "generic": GenericHyperparameterOptimizationReporter,
    "orion": OrionHyperparameterOptimizationReporter,
}
