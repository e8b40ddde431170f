"""The measured window, the benchmark's spans and the reading of the
profiler's trace into records for the per-layer metrics.

A driver runs its window as ``Window`` items (a request, a step): the
window closes at the first item boundary after ``seconds``. With tracing
on, a run of items in the steady part of the window (``profile_items``:
first item, count) runs under ``torch.profiler`` inside the span
``bench.traced``; the benchmark's spans (``Window.span``) are host-clock
intervals, and ``torch.profiler.record_function`` ranges while traced.

Device records are read from the raw Kineto events: kernels, copies and
sets, each kernel tied to the host time of its launch (the runtime or
driver launch call of the same correlation id), so that a kernel belongs to
the span in which it was launched, whatever its name. The busy time is the
union of device intervals (``chip_smoke.py:1142-1214 profile_run``: cuDNN's
grouped conv runs kernels that overlap); kernel groups are
``chip_smoke.py:1142 _kernel_group``.
"""
from __future__ import annotations

import contextlib
import sys
import time

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
USER_PREFIXES = ("bench.", "Optimizer.", "ProfilerStep")


def note(what, since):
    """A line on standard error: ``what`` and the seconds since ``since``
    (a ``time.perf_counter()`` reading); returns the clock's reading."""
    now = time.perf_counter()
    print(f"[bench] {what}: {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def activity(ev):
    """The Kineto activity of a raw profiler event, worked out from its
    device and name (PyTorch's raw events need not carry their activity
    type): ranges named with ``USER_PREFIXES`` are user annotations."""
    import torch

    name = ev.name()
    user = name.startswith(USER_PREFIXES)
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        if user:
            return "gpu_user_annotation"
        low = name.lower()
        return ("gpu_memcpy" if "memcpy" in low else
                "gpu_memset" if "memset" in low else "kernel")
    if user:
        return "user_annotation"
    if "aunch" in name and name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def kernel_group(name):
    low = name.lower()
    if "conv_ln_gelu" in low:
        return "conv_frontend kernel"
    if "flash_fwd" in low:
        return "attention forward kernel"
    if "flash_bwd" in low:
        return "attention backward kernels"
    if "int8_matmul" in low:
        return "int8 matmul kernel"
    if any(w in low for w in ("conv", "cudnn", "implicit_gemm", "dgrad",
                              "wgrad")):
        return "conv (cuDNN)"
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies and sets"
    return "elementwise/reduce (PyTorch)"


def union(intervals):
    """Total length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged), merged


def start_profiler():
    """One short profile in set-up, so that the traced window does not pay
    the profiler's first start (CUPTI's initialisation)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Window:
    """The measured window of one run."""

    def __init__(self, seconds, trace, profile_items, launch_counts=None,
                 cuda=True):
        self.seconds = seconds
        self.cuda = cuda
        self.trace = trace
        self.first_traced, self.n_traced = profile_items
        self.launch_counts = launch_counts
        self.items = []              # (t0, t1) of every item, host clock
        self.spans = []              # (name, t0, t1), host clock
        self.traced_items = []       # indices of the traced items
        self.records = None
        self.t0 = self.t1 = None
        self._prof = self._range = None

    def more(self):
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
            return True
        return now - self.t0 < self.seconds

    @contextlib.contextmanager
    def span(self, name):
        rf = None
        if self._prof is not None:
            import torch

            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def item(self):
        i = len(self.items)
        if self.trace and i == self.first_traced:
            self._start_profile()
        if self._prof is not None:
            self.traced_items.append(i)
        t0 = time.perf_counter()
        yield i
        self.items.append((t0, time.perf_counter()))
        if self._prof is not None and i == self.first_traced + self.n_traced - 1:
            self._stop_profile()

    def close(self):
        """End the window at the host clock; a profile still open (a
        window too short for its traced items) is read as it stands."""
        self.t1 = time.perf_counter()
        if self._prof is not None:
            self._stop_profile()

    @property
    def wall(self):
        return self.t1 - self.t0

    def _start_profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.launch_counts is not None:
            self._counts0 = self.launch_counts()
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._range = torch.profiler.record_function("bench.traced")
        self._range.__enter__()

    def _stop_profile(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        counts = None
        if self.launch_counts is not None:
            after = self.launch_counts()
            counts = {k: after[k] - self._counts0.get(k, 0) for k in after}
        self.records = read_profile(prof, counts)


def _interval(ev):
    start = ev.start_ns()
    end = ev.end_ns() if hasattr(ev, "end_ns") else start + ev.duration_ns()
    return start, end


def read_profile(prof, launch_counts):
    """Records of a finished profile: ``kernels`` [(name, start_ns, end_ns,
    launch_ns or None)], ``device`` intervals of every kernel, copy and
    set, ``spans`` [(name, start_ns, end_ns)] of the ``bench.*`` ranges,
    the traced window and the launch counts over it."""
    events = prof.profiler.kineto_results.events()
    launches, kernels, device, spans, host_ops = {}, [], [], [], []
    kinds = [activity(ev) for ev in events]
    for ev, kind in zip(events, kinds):
        if kind in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host_ops.append((ev.name(), *_interval(ev)))
        if kind in ("cuda_runtime", "cuda_driver") and "aunch" in ev.name():
            launches[ev.correlation_id()] = ev.start_ns()
        elif kind == "user_annotation" and ev.name().startswith("bench."):
            spans.append((ev.name(), *_interval(ev)))
    for ev, kind in zip(events, kinds):
        start, end = _interval(ev)
        if kind in DEVICE_ACTIVITIES and end > start:
            device.append((start, end))
            kernels.append((ev.name() or kind, start, end,
                            launches.get(ev.correlation_id())))
    window = [s for s in spans if s[0] == "bench.traced"]
    lo, hi = (window[0][1], window[0][2]) if window else (
        min((s for s, _ in device), default=0), max((e for _, e in device),
                                                    default=0))
    clipped = [(max(s, lo), min(e, hi)) for s, e in device
               if e > lo and s < hi]
    busy, merged = union(clipped)
    tied = sum(k[3] is not None for k in kernels)
    print(f"[bench] trace: {len(events)} events, {len(kernels)} on the "
          f"device, {tied} tied to their launch, {len(spans)} spans",
          file=sys.stderr, flush=True)
    return {"kernels": kernels, "device": device, "spans": spans,
            "window_ns": (lo, hi), "busy_s": busy / 1e9,
            "window_s": (hi - lo) / 1e9, "merged": merged,
            "launch_counts": launch_counts, "tied": tied,
            "host_ops": host_ops}


def launched_in(records, span_name):
    """The kernels whose launch lies in a span named ``span_name``."""
    ranges = sorted((s, e) for n, s, e in records["spans"] if n == span_name)
    out = []
    for k in records["kernels"]:
        at = k[3]
        if at is not None and any(s <= at <= e for s, e in ranges):
            out.append(k)
    return out


def breakdown(records, top=10, labelled=300):
    """The device operations that took most time, by group, and the idle
    gaps of the traced window summed by what the host was doing when each
    began: the innermost ``bench.*`` span and the innermost host operation
    (a PyTorch op or a CUDA runtime call) open then. The ``labelled``
    longest gaps are labelled; the rest are summed as shorter gaps."""
    import numpy as np

    by_group = {}
    for name, s, e, _ in records["kernels"]:
        g = kernel_group(name)
        by_group[g] = by_group.get(g, 0.0) + (e - s) / 1e9
    lo, hi = records["window_ns"]
    edges = [lo] + [x for iv in records["merged"] for x in iv] + [hi]
    gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)
    spans = [s for s in records["spans"] if s[0] != "bench.traced"]
    ops = records["host_ops"]
    starts = np.array([o[1] for o in ops], dtype=np.int64)
    ends = np.array([o[2] for o in ops], dtype=np.int64)
    by_label = {}
    for rank, (length, at) in enumerate(gaps):
        if rank >= labelled:
            label = "shorter gaps"
        else:
            open_ = [s for s in spans if s[1] <= at < s[2]]
            span = (min(open_, key=lambda s: s[2] - s[1])[0] if open_
                    else "between items")
            inside = np.flatnonzero((starts <= at) & (ends > at))
            op = (ops[inside[np.argmin(ends[inside] - starts[inside])]][0]
                  if inside.size else "python")
            label = f"{span} / {op}"
        by_label[label] = by_label.get(label, 0.0) + length / 1e9
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(by_group)],
            "idle_gaps": [[k, v] for k, v in order(by_label)]}
