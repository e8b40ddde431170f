"""The reading of a profile into records, on a CPU profile: the one event
classifier finds the benchmark's spans and the host operations, and the
window's union of device intervals is empty where nothing ran on a
device."""
from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import trace


def test_a_cpu_profile_reads_into_spans_and_host_ops():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.traced"):
            with record_function("bench.step"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    kinds = {ev.name(): trace.activity(ev)
             for ev in prof.profiler.kineto_results.events()}
    assert kinds["bench.step"] == kinds["bench.traced"] == "user_annotation"
    assert kinds["aten::matmul"] == "cpu_op"
    rec = trace.read_profile(prof, {"conv_frontend": 0})
    assert sorted(s[0] for s in rec["spans"]) == ["bench.step", "bench.traced"]
    assert rec["kernels"] == [] and rec["busy_s"] == 0.0
    assert any(name == "aten::matmul" for name, _, _ in rec["host_ops"])
    lo, hi = rec["window_ns"]
    step = next(s for s in rec["spans"] if s[0] == "bench.step")
    assert lo <= step[1] <= step[2] <= hi
