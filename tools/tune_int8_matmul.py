#!/usr/bin/env python3
"""Time variants of the port's int8 quantize+product kernel on one GPU.

    python3 tools/tune_int8_matmul.py [--variants 0,P,C1] \\
        [--out build/tune_int8.json]

Builds ``svt_speechbrain_tpu_torch/csrc/quant_matmul.cu`` once per set of
its ``SVT_Q8_*`` macros (the ring's stages, how many slabs it keeps in
flight, and whether every element takes the true division), and variant 0
from ``tools/quant_matmul_v0.cu``, the design before the Hopper redesign,
so that the old kernel is timed in the same run. One ``nvcc`` per build,
all started together. A variant is a build and a launch plan: the blocks a
cluster shares its rows among (cluster 1 quantizes the rows once per
column tile, reading x for every column tile). For each build it prints
the registers and spill bytes (ptxas) of every instantiation, and the
runtime's registers, local memory, shared memory, blocks an SM and
clusters of each size resident on the card; holds each variant against
the plain version (the quantized integers and the row scales bit for bit,
the output within ``chip_smoke.py``'s relative tolerance) at every shape
in both dtypes; and times it at the shapes of int8 serving: feat_proj,
ffn1 and ffn2 of a chunked batch (M = 8 x 249 frames), the attention
projections (``quantize_attn``) and ffn2 of one streamed 5 s window (M =
249), in bf16 and f32, as the kernel's device time a launch
(torch.profiler) and as the time through the wrapper (CUDA events).
Beside them: bf16 ``torch.matmul`` on the dequantized weight and
``torch._int_mm`` alone. Each variant's L2 bytes of x and of the weights
per call are computed from its plan. ``--trace`` builds a variant with
``SVT_Q8_TRACE`` and prints, at each bf16 shape, how long its blocks spend
quantizing, multiplying and writing, and when they start.

The variants are timed in turns, in order and then in reverse, and each
time is the mean of its two passes. Needs a CUDA device and nvcc; imports
torch and the port only.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from svt_speechbrain_tpu_torch.ops import _build  # noqa: E402
from svt_speechbrain_tpu_torch.ops import quant  # noqa: E402

V0_SOURCE = ROOT / "tools" / "quant_matmul_v0.cu"
MACROS = ("STAGES", "AHEAD", "DIVIDE", "TRACE")
# name: (macros or None for the old design, the widest cluster (None: the
# plan's choice)). "P" is the source's defaults and the wrapper's plan; "D"
# takes the true division for every element; "S4" a deeper ring at one
# block an SM; C4, C2 and C1 share the rows among fewer blocks (C1: each
# block quantizes its rows itself, reading x for every column tile).
# PERF.md keeps the variants of earlier rounds whose switches the source
# no longer has.
VARIANTS = {
    "0": (None, None),
    "P": ((3, 1, 0, 0), None),
    "D": ((3, 1, 1, 0), None),
    "S4": ((4, 2, 0, 0), None),
    "C4": ((3, 1, 0, 0), 4),
    "C2": ((3, 1, 0, 0), 2),
    "C1": ((3, 1, 0, 0), 1),
}
# (name, M, K, N)
SHAPES = (("feat_proj", 1992, 512, 1024), ("ffn1", 1992, 1024, 4096),
          ("ffn2", 1992, 4096, 1024), ("attn", 1992, 1024, 1024),
          ("ffn2 M249", 249, 4096, 1024))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
RTOL = {"f32": 1e-6, "bf16": 2.0 ** -8}   # chip_smoke.py INT8_RTOL
_V0_SIGNATURE = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def build(specs):
    """One nvcc per distinct build, started together: {key: (library,
    ptxas lines) or (None, the compiler's error)}; key None is variant 0,
    else the macro tuple."""
    out_dir = _build.BUILD_DIR.parent / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key in specs:
        src = V0_SOURCE if key is None else _build.CSRC / "quant_matmul.cu"
        flags = [*_build.NVCC_FLAGS, f"-I{_build.CSRC}"]
        if key is not None:
            flags += [f"-DSVT_Q8_{m}={v}" for m, v in zip(MACROS, key)]
        digest = hashlib.sha256(" ".join(flags).encode())
        for part in sorted(_build.CSRC.glob("*.cuh")) + [src]:
            digest.update(part.read_bytes())
        tag = "v0" if key is None else "-".join(map(str, key))
        lib = out_dir / f"q8-{tag}-{digest.hexdigest()[:12]}.so"
        cmd = [_build._nvcc(), *flags, "-o", str(lib), str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    built = {}
    for key, (proc, lib) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            errors = [line for line in text.splitlines() if "error" in line]
            built[key] = (None, "\n".join(errors) or text)
            continue
        built[key] = (lib, [line.strip() for line in text.splitlines()
                            if "registers" in line or "spill" in line
                            or "Compiling entry" in line
                            or "wgmma" in line or "arning" in line])
    return built


def load(path, v0):
    lib = ctypes.CDLL(str(path))
    sigs = ({"svt_int8_matmul": _V0_SIGNATURE} if v0 else quant._SIGNATURES)
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def v0_plan(m, k, n, sms):
    """The old kernel's (rows a block, column tiles a block)."""
    for block_m in (64, 32):
        if block_m * (k + 16) + 2 * 128 * 144 + 4 * block_m <= 232448:
            break
    row_blocks = -(-m // block_m)
    n_tiles = n // 128
    groups = min(n_tiles, -(-2 * sms // row_blocks))
    return block_m, -(-n_tiles // groups)


def v0_launch(lib, x, w8t, ws, m, k, n, sms, debug=False):
    out = torch.empty(m, n, device=x.device, dtype=x.dtype)
    x8 = torch.empty(m, k, device=x.device, dtype=torch.int8) if debug \
        else None
    xs = torch.empty(m, 1, device=x.device) if debug else None
    block_m, tiles = v0_plan(m, k, n, sms)
    _build.check(lib.svt_int8_matmul(
        quant._DTYPE_CODES[x.dtype], x.data_ptr(), w8t.data_ptr(),
        ws.data_ptr(), quant._DTYPE_CODES[ws.dtype], out.data_ptr(),
        x8.data_ptr() if debug else None, xs.data_ptr() if debug else None,
        m, k, n, block_m, tiles, _build.stream_handle()), "v0 launch")
    return out, x8, xs


def plan_of(spec, m, k, n):
    plan = quant.launch_plan(m, k, n)
    widest = spec[1]
    if widest is not None and plan.cluster > widest:
        plan = quant.launch_plan(m, k, n, cluster=widest)
    return plan


def l2_bytes(spec, m, k, n, itemsize, sms):
    """(bytes of x, bytes of the weights) a call reads through L2: for each
    copy of the int8 rows, x in its working dtype once, and again past the
    first 16 chunks of 16 bytes of a row's share (the second pass keeps
    those in registers), the copy written once; the copy read once a
    column tile; the weights once a row block. Variant 0: x twice a column
    group, the weights once a row block."""
    if spec[0] is None:
        block_m, tiles = v0_plan(m, k, n, sms)
        groups = -(-(n // 128) // tiles)
        return 2 * groups * m * k * itemsize, -(-m // block_m) * k * n
    plan = plan_of(spec, m, k, n)
    tiles, row_blocks = plan.grid
    copies = tiles // plan.cluster
    chunks = k // plan.cluster * itemsize // 16
    passes = 1 + max(0, chunks - 16) / chunks
    x_bytes = copies * m * k * (passes * itemsize + 1) + tiles * m * k
    return x_bytes, row_blocks * k * n


def inputs(m, k, n, dtype, gen):
    """x with the rows that pin the quantizer (chip_smoke.py's
    int8_inputs) and a quantized normal weight."""
    x = torch.randn(m, k, generator=gen, device="cuda")
    x[0] = torch.randint(-254, 255, (k,), generator=gen, device="cuda") / 2.0
    x[0, 0] = 127.0
    x[1] = 0.0
    x[2, -1] = 9.0
    w8, ws = quant.quantize_weight(
        torch.randn(k, n, generator=gen, device="cuda"))
    return x.to(dtype), w8, ws


def time_ms(fn, iters=20, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, match=None, reps=10):
    """Device time a call of ``fn``: the sum of its kernels' own intervals
    (those whose name holds ``match``, or all) over ``reps`` calls, divided
    by ``reps`` (torch.profiler; no host time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):   # a process's first window may come back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [ev.time_range.end - ev.time_range.start
                 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and (match is None or match in ev.name)]
        if spans:
            return sum(spans) / reps / 1e3
    raise RuntimeError(f"the profiler saw no kernel matching {match}")


def launcher(name, spec, lib, case, sms, debug=False):
    x, w8, ws, w8t = case
    m, k = x.shape
    n = w8.shape[1]
    if spec[0] is None:
        return lambda: v0_launch(lib, x, w8t, ws, m, k, n, sms, debug)
    plan = plan_of(spec, m, k, n)
    return lambda: quant._launch(x, w8, ws, w8t, debug, lib=lib, plan=plan)


def check(name, spec, lib, cases, sms):
    """Max abs error against the plain version per case; raises unless the
    integers and scales are bit for bit and the output within RTOL."""
    errs = {}
    for label, case in cases.items():
        tag = label.split()[-1]
        out, x8, xs = launcher(name, spec, lib, case, sms, debug=True)()
        torch.cuda.synchronize()
        x, w8, ws, _ = case
        want_x8, want_xs = quant.quantize_activation(x)
        want = quant.int8_matmul_plain(x, w8, ws).float()
        err = (out.float() - want).abs()
        if not (torch.equal(x8, want_x8) and torch.equal(xs, want_xs)):
            raise AssertionError(f"{label}: integers or scales differ")
        if not (err <= RTOL[tag] * want.abs()).all():
            raise AssertionError(f"{label}: max abs error "
                                 f"{err.max().item():.3e}")
        errs[label] = err.max().item()
    return errs


def trace_blocks(names, sms):
    """Each traced variant's blocks at every bf16 shape: the quantization
    (start to the second cluster barrier), the products and the epilogue,
    median and max over the blocks in microseconds, the launch's span, and
    when the blocks start (waves)."""
    specs = {n: VARIANTS[n] for n in names}
    keys = {n: spec[0][:3] + (1,) for n, spec in specs.items()}
    built = build(set(keys.values()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, spec in specs.items():
        path, text = built[keys[name]]
        if path is None:
            print(f"{name}: trace build failed\n{text}", flush=True)
            return 1
        lib = load(path, False)
        lib.svt_int8_matmul_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.svt_int8_matmul_trace.restype = ctypes.c_int
        for label, m, k, n in SHAPES:
            x, w8, ws = inputs(m, k, n, torch.bfloat16, gen)
            case = (x, w8, ws, quant.pack_weight(w8))
            fn = launcher(name, spec, lib, case, sms)
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            plan = plan_of(spec, m, k, n)
            blocks = plan.grid[0] * plan.grid[1]
            buf = torch.zeros(blocks, 5, dtype=torch.int64)
            _build.check(lib.svt_int8_matmul_trace(buf.data_ptr(), blocks),
                         "trace")
            t = buf.double()
            origin = t[:, 0].min()
            quant_us = (t[:, 1] - t[:, 0]) / 1e3
            prod_us = (t[:, 2] - t[:, 1]) / 1e3
            epi_us = (t[:, 3] - t[:, 2]) / 1e3
            start = ((t[:, 0] - origin) / 1e3).sort().values
            span = (t[:, 3].max() - origin) / 1e3
            gaps = int((start[1:] - start[:-1] > 2.0).sum())
            print(f"trace {name} {label} (cluster "
                  f"{plan.cluster}, {blocks} blocks on "
                  f"{len(set(buf[:, 4].tolist()))} SMs): span {span:.1f} us; "
                  f"quantize {quant_us.median():.1f}/{quant_us.max():.1f}, "
                  f"products {prod_us.median():.1f}/{prod_us.max():.1f}, "
                  f"epilogue {epi_us.median():.1f}/{epi_us.max():.1f} us "
                  f"(median/max); starts at "
                  + ", ".join(f"{q:.1f}" for q in start.quantile(
                      torch.tensor([0.0, 0.25, 0.5, 0.75, 0.9, 1.0],
                                   dtype=torch.float64)).tolist())
                  + f" us, {gaps} gaps over 2 us", flush=True)
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="build/tune_int8.json")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated names of VARIANTS")
    parser.add_argument("--trace", default="",
                        help="comma-separated names of VARIANTS to trace "
                             "(each block's phases, SVT_Q8_TRACE) instead "
                             "of timing")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_int8_matmul: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"# {smi}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if args.trace:
        return trace_blocks(args.trace.split(","), sms)
    chosen = {n: VARIANTS[n] for n in args.variants.split(",")}
    t0 = time.perf_counter()
    built = build({spec[0] for spec in chosen.values()})
    print(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    report = {"device": smi, "builds": {}, "variants": {}, "context": {}}
    libs = {}
    for key, (path, text) in built.items():
        tag = "0" if key is None else dict(zip(MACROS, key))
        row = report["builds"][str(tag)] = {}
        if path is None:
            row["error"] = text[-3000:]
            print(f"build {tag} failed\n{text[-3000:]}", flush=True)
            continue
        libs[key] = load(path, key is None)
        row["ptxas"] = text
        for line in text:
            print(f"  [{tag}] {line}", flush=True)
        if key is not None:
            row["attributes"] = quant.int8_kernel_attributes(libs[key])
            for a in row["attributes"]:
                print(f"  [{tag}] {a['dtype']}: "
                      f"{a['registers']} registers, {a['local_bytes']} "
                      f"bytes local, {a['smem_bytes']} bytes shared, "
                      f"{a['blocks_per_sm']} blocks an SM, clusters "
                      f"resident by size {a['clusters']}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for label, m, k, n in SHAPES:
        for tag, dtype in DTYPES.items():
            x, w8, ws = inputs(m, k, n, dtype, gen)
            cases[f"{label} {tag}"] = (x, w8, ws, quant.pack_weight(w8))
    order = []
    for name, spec in chosen.items():
        row = report["variants"][name] = {
            "macros": None if spec[0] is None else dict(zip(MACROS, spec[0])),
            "widest_cluster": spec[1]}
        if spec[0] not in libs:
            row["error"] = "not built"
            continue
        try:
            row["max_abs_err"] = check(name, spec, libs[spec[0]], cases, sms)
        except (AssertionError, RuntimeError) as exc:
            row["error"] = str(exc)
            print(f"{name}: fails: {exc}", flush=True)
            continue
        row["plans"] = {}
        row["l2_mb"] = {}
        for label, m, k, n in SHAPES:
            if spec[0] is not None:
                p = plan_of(spec, m, k, n)
                row["plans"][label] = dict(cluster=p.cluster, grid=p.grid)
            xb, wb = l2_bytes(spec, m, k, n, 2, sms)
            row["l2_mb"][label] = dict(x=xb / 1e6, w=wb / 1e6)
        print(f"{name}: every case bit for bit on integers and scales; "
              f"plans {row['plans']}; L2 MB (x, w) in bf16 "
              + ", ".join(f"{lab} {v['x']:.1f}/{v['w']:.1f}"
                          for lab, v in row["l2_mb"].items()), flush=True)
        order.append(name)
    labels = list(cases)
    times = {name: {lab: {"device": [], "wrapper": []} for lab in labels}
             for name in order}
    for names in (order, order[::-1]):
        for name in names:
            spec = chosen[name]
            for lab in labels:
                fn = launcher(name, spec, libs[spec[0]], cases[lab], sms)
                times[name][lab]["device"].append(device_ms(fn,
                                                            "int8_matmul"))
                times[name][lab]["wrapper"].append(time_ms(fn))
    for lab in labels:
        x, w8, ws, _ = cases[lab]
        w = (w8.float() * ws).to(x.dtype)
        ctx = report["context"][lab] = {}
        if x.dtype == torch.bfloat16:
            ctx["bf16_matmul"] = dict(
                device=device_ms(lambda: torch.matmul(x, w)),
                wrapper=time_ms(lambda: torch.matmul(x, w)))
        x8 = quant.quantize_activation(x)[0]
        try:
            ctx["int_mm"] = dict(
                device=device_ms(lambda: torch._int_mm(x8, w8)),
                wrapper=time_ms(lambda: torch._int_mm(x8, w8)))
        except (RuntimeError, AttributeError) as exc:
            ctx["int_mm"] = f"refused: {exc}"
    print("variant | " + " | ".join(labels) + "   (device ms a launch / "
          "wrapper ms)")
    for name in order:
        row = report["variants"][name]
        row["ms"] = {lab: {kind: sum(v) / len(v) for kind, v in t.items()}
                     for lab, t in times[name].items()}
        row["ms_passes"] = times[name]
        print(f"{name} | " + " | ".join(
            f"{row['ms'][lab]['device']:.4f} / {row['ms'][lab]['wrapper']:.4f}"
            for lab in labels), flush=True)
    for lab, ctx in report["context"].items():
        print(f"context {lab}: " + ", ".join(
            f"{k} " + (f"{v['device']:.4f} / {v['wrapper']:.4f}"
                       if isinstance(v, dict) else v)
            for k, v in ctx.items()), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
