"""Profiling and step timing on ``torch.profiler`` (port of
``svt_speechbrain_tpu/utils/profiling.py``).

``profile`` records the host and, on a CUDA machine, the card's kernels,
and writes a Chrome trace (``<logdir>/trace.json``, readable in Perfetto or
``chrome://tracing``); ``annotate`` names a region of it, and adds an NVTX
range while CUDA is in use; ``StepTimer`` times steps on the host clock,
synchronizing a CUDA device first so that it times the work and not the
launches. The JAX package's ``log_compile_cache_stats`` has no counterpart
(``docs/PORT_MAP.md``).
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile(logdir="./profile", host_tracer_level=2, timeout_s=60.0):
    """Profile the block and write ``<logdir>/trace.json``; yields
    ``logdir``. The trace is written in a watchdog thread: if it has not
    been written after ``timeout_s`` the block exits with a warning rather
    than hang. ``host_tracer_level`` is accepted and unused, as in the JAX
    package. The wrapped computation always runs, profiled or not."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:
        logger.warning(f"profiler start failed ({e}); running unprofiled")
        prof = None
    try:
        yield logdir
    finally:
        if prof is not None:
            # the profiler stops on the thread that started it; the trace
            # is written on another
            prof.__exit__(None, None, None)
            done = threading.Event()

            def write():
                try:
                    os.makedirs(logdir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
                except Exception as e:  # pragma: no cover
                    logger.warning(f"profiler trace failed: {e}")
                done.set()

            t = threading.Thread(target=write, daemon=True)
            t.start()
            if done.wait(timeout_s):
                logger.info(f"Profiler trace written to {logdir}")
            else:
                logger.warning(f"profiler trace did not finish within "
                               f"{timeout_s}s; continuing without a trace")


@contextlib.contextmanager
def annotate(name):
    """A named range in the profiler's trace (``record_function``), and an
    NVTX range while CUDA is in use (never on a build without CUDA).

    Example
    -------
    >>> with annotate("fit_batch"):
    ...     pass
    """
    import torch

    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock step timing; the first call (builds and warm-up) is kept
    apart from the steady state. ``measure(device=...)`` synchronizes a
    CUDA device before each clock read.

    Example
    -------
    >>> timer = StepTimer("demo")
    >>> for _ in range(3):
    ...     with timer.measure():
    ...         pass
    >>> s = timer.summary()
    >>> sorted(s), s["steps"]       # first call tracked apart from the rest
    (['first_ms', 'mean_ms', 'p50_ms', 'p95_ms', 'steps'], 2)
    """

    def __init__(self, name="step"):
        self.name = name
        self.times = []
        self.first_time = None

    @contextlib.contextmanager
    def measure(self, device=None):
        import torch

        sync = device is not None and torch.device(device).type == "cuda"
        if sync:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if self.first_time is None:
            self.first_time = dt
            logger.info(f"{self.name}: first call {dt * 1e3:.1f} ms")
        else:
            self.times.append(dt)

    def summary(self):
        import numpy as np

        if not self.times:
            return {"first_ms": (self.first_time or 0) * 1e3}
        arr = np.asarray(self.times)
        return {
            "first_ms": (self.first_time or 0) * 1e3,
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "steps": len(self.times),
        }
