"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: ``workloads/<cell>.json`` names the cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, which names its driver, ``drivers/<driver>.py``)
and the limits of its check; ``metrics/<metric>.py`` each read one
per-layer metric from the traced run's records.

A run builds the program and its inputs from the seed, warms its shapes
(set-up), measures ``--seconds`` of traffic, frees the program and checks
what the window produced against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit; the same numbers are
the last lines of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "svt_speechbrain_tpu")


def load_json(*parts):
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def spec():
    """``BENCHMARK.json``, beside the benchmark's folder."""
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(workload, kind, reported=()):
    """name → unit of the ``kind`` metrics ("end_to_end" or "per_layer")
    of ``BENCHMARK.json`` that ``workload`` reports: those that list it,
    and those with no list whose moved metric is among ``reported``."""
    out = {}
    for m in spec()[kind]:
        listed = m.get("workloads")
        if (workload in listed if listed is not None
                else kind == "end_to_end" or m["moves"] in reported):
            out[m["name"]] = m["unit"]
    return out


def load_module(folder, name):
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(workload, overrides=None):
    """(workload, configuration, traffic) of a cell, with ``overrides``
    ({"config": {...}, "traffic": {...}}) laid over the last two."""
    overrides = overrides or {}
    wl = load_json("workloads", f"{workload}.json")
    cfg = dict(load_json("configs", f"{wl['config']}.json"),
               **overrides.get("config", {}))
    traffic = dict(load_json("traffic", f"{wl['traffic']}.json"),
                   **overrides.get("traffic", {}))
    return wl, cfg, traffic


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(rec, workload):
    """name → (value, unit) of every per-layer metric of ``workload``
    whose reader, ``metrics/<name>.py``, finds something to read in
    ``rec``."""
    out = {}
    for name, unit in cell_metrics(workload, "per_layer", rec["e2e"]).items():
        value = load_module("metrics", name).read(rec)
        if value is not None:
            out[name] = (value, unit)
    return out


def fix_malloc_thresholds():
    """Fix glibc's mmap threshold at 32 MiB and its trim threshold at
    2 GiB, as ``MALLOC_MMAP_THRESHOLD_`` and ``MALLOC_TRIM_THRESHOLD_``
    would. Left to move, glibc raises the mmap threshold to the largest
    block freed and trims the heap's top; a serving request's host buffers
    (float copies of its songs, 8-19 MB, and a 10 MB batch a time) then
    come from the heap or from fresh zero-filled pages by the order in
    which earlier requests freed theirs, and a whole run keeps the mode
    its first requests set. Returns whether glibc took both."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (AttributeError, OSError):
        return False
    m_trim_threshold, m_mmap_threshold = -1, -3
    return bool(mallopt(m_mmap_threshold, 32 << 20)
                and mallopt(m_trim_threshold, 2 ** 31 - 1))


def run_cell(workload, seed, seconds, trace, device="cuda", overrides=None,
             cell_class=None):
    """One run of a cell. Returns (result dict, [(name, value, limit)],
    the driver's cell). ``cell_class`` stands in for the traffic's driver
    (the tests plant faults through it)."""
    import torch

    from benchmark import trace as tr

    wl, cfg, traffic = cell_spec(workload, overrides)
    if traffic.get("fixed_malloc_thresholds"):
        fix_malloc_thresholds()
    driver = load_module("drivers", traffic["driver"])
    make = cell_class or driver.Cell
    cell = make(cfg, traffic, seed, device, wl["limits"])
    cuda = torch.device(device).type == "cuda"
    counts = None
    if trace and cuda:
        from svt_speechbrain_tpu_torch import ops

        counts = ops.launch_counts
        tr.start_profiler()
    win = tr.Window(seconds, bool(trace), traffic["profile_items"], counts,
                    cuda)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # what set-up made lives on: out of the collector's reach in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    e2e = cell.run(win)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_items = len(win.items)
    traced = set(win.traced_items)
    rec = {"e2e": sorted(e2e), "cfg": cfg, "traffic": traffic,
           "trace": win.records, "window_s": win.wall, "spans": win.spans,
           "traced": cell.work(sorted(traced)),
           "untraced": cell.work([i for i in range(n_items) if i not in traced]),
           "untraced_s": sum(t1 - t0 for i, (t0, t1) in enumerate(win.items)
                             if i not in traced)}
    attempted, failed = cell.attempted(), cell.failed
    cell.release()
    clock = time.perf_counter()
    checks = cell.check()
    tr.note("check against the reference", clock)
    correct = all(value <= limit for _, value, limit in checks)
    if trace:           # device metrics come only from a device
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in
                   (read_metrics(rec, workload) if cuda else {}).items()}
    else:
        e2e["setup_s"] = setup_s
        units = cell_metrics(workload, "end_to_end")
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and win.records is not None:
        dev["busy_s"] = win.records["busy_s"]
        dev["window_s"] = win.records["window_s"]
        result["breakdown"] = tr.breakdown(win.records)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    return result, checks, cell


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    build = ROOT / "build"
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    import torch

    wl = load_json("workloads", f"{args.workload}.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks, _ = run_cell(args.workload, args.seed, args.seconds,
                                 args.trace)
    found = forbidden_modules()
    if found:
        print(f"the run imported {found}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
