#!/usr/bin/env python3
"""Time variants of the port's RNN-T lattice kernel (row 6a) on one GPU.

    python3 tools/tune_lattice.py [--variants A,H2] \\
        [--out build/tune_lattice.json]

Builds ``svt_speechbrain_tpu_torch/csrc/transducer_lattice.cu`` once per
variant of its ``SVT_LAT_*`` macros (one ``nvcc`` each, all started
together) and prints each build's registers and spills (ptxas) and the
runtime's attributes of route A at U1 81 and 128. Each variant launches with
the plan its own build gives (``lattice_plan(..., lib)``). It holds route A (a block of compute and helper warps a batch row) and route B (the
first port's design, run through the launch helper's ``plan``) against
``lattice_plain``: alpha on the whole grid and the masked beta on each
row's valid region within ``chip_smoke.py``'s tolerance, and route A
against route B bit for bit on the valid region. Then it times alpha and
beta at the RNN-T training shape (8, 749, 81) f32 and alpha at U1 128 and
129 (the widest of route A, the narrowest of route B), by route, as
the kernel's device time a launch (torch.profiler) and through the wrapper
(CUDA events), the variants in turns, in order and then in reverse, each
time the mean of its two passes.

Needs a CUDA device and nvcc; imports torch and the port only.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from svt_speechbrain_tpu_torch.ops import _build  # noqa: E402
from svt_speechbrain_tpu_torch.ops import transducer_lattice as tl  # noqa: E402

# name: (SVT_LAT_EPOCH, SVT_LAT_HELPERS): steps between the helper warps'
# meetings with the compute warps, and helper warps (they stage the panels
# and store the rows). "A" is the source's defaults.
VARIANTS = {"A": (4, 4), "H2": (4, 2), "E2H2": (2, 2), "E6H3": (6, 3)}
MACROS = ("EPOCH", "HELPERS")
TOL = (1e-5, 4e-6)                # chip_smoke.py RNNT_TOL: atol, rtol
# (name, B, T, U1, V)
SHAPES = (("training", 8, 749, 81, 1000), ("U1 128", 8, 749, 128, 16),
          ("U1 129", 8, 749, 129, 16))


def build(names):
    out_dir = _build.BUILD_DIR.parent / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        flags = [*_build.NVCC_FLAGS, f"-I{_build.CSRC}"] + [
            f"-DSVT_LAT_{m}={v}" for m, v in zip(MACROS, VARIANTS[name])]
        src = _build.CSRC / "transducer_lattice.cu"
        digest = hashlib.sha256(" ".join(flags).encode())
        for part in sorted(_build.CSRC.glob("*.cuh")) + [src]:
            digest.update(part.read_bytes())
        lib = out_dir / f"lattice-{name}-{digest.hexdigest()[:12]}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        so = ctypes.CDLL(str(lib))
        for fn, argtypes in tl._SIGNATURES.items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        built[name] = (so, [line.strip() for line in text.splitlines()
                            if "registers" in line or "spill" in line
                            or "Compiling entry" in line])
    return built


def problem(b, t, u1, v, gen):
    """Alpha and masked beta panels of normal logits, as the loss makes
    them, with ragged lengths (the last row's target empty), and each
    row's valid region on beta's grid."""
    logits = torch.randn(b, t, u1, v, generator=gen, device="cuda")
    targets = torch.randint(1, v, (b, u1 - 1), generator=gen, device="cuda",
                            dtype=torch.int32)
    t_len = torch.round(torch.linspace(1.0, 0.33, b, device="cuda") * t).int()
    u_len = torch.round(torch.linspace(1.0, 0.0, b, device="cuda")
                        * (u1 - 1)).int()
    lse = torch.logsumexp(logits, -1)
    skip, emit_pad = tl._gather_skip_emit(logits, lse, targets, 0)
    seed = torch.full_like(skip, tl.NEG_INF)
    seed[:, 0, 0] = 0.0
    beta = tl._masked_panels(logits, lse, targets, t_len, u_len, 0)
    grid_t = torch.arange(t + 1, device="cuda")[None, :, None]
    grid_u = torch.arange(u1, device="cuda")[None, None, :]
    live = (grid_t < t_len[:, None, None]) & (grid_u <= u_len[:, None, None])
    return (skip, emit_pad, seed), beta, live


def plans(lib, panels, reverse):
    """The plan the build ``lib`` gives these panels, and route B beside
    route A."""
    b, rows, u1 = panels[2].shape
    plan = tl.lattice_plan(b, rows, u1, reverse, lib)
    return [plan] + ([tl._block_plan(b, u1, lib)] if plan.route == "warp"
                     else [])


def check(lib, name, panels, reverse, live):
    """Both routes against lattice_plain, and against each other."""
    want = tl.lattice_plain(*panels, reverse=reverse)
    got = {}
    for plan in plans(lib, panels, reverse):
        out, _ = tl._launch(*panels, reverse, plan=plan, lib=lib)
        torch.cuda.synchronize()
        err, size = (out - want).abs(), want.abs()
        if live is not None:
            err, size = err[live], size[live]
        ok = bool(torch.isfinite(out).all()
                  and (err <= TOL[0] + TOL[1] * size).all())
        print(f"    {name} {'beta' if reverse else 'alpha'} route "
              f"{plan.route}: max_abs_err {err.max().item():.3e} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: route {plan.route} disagrees")
        got[plan.route] = out if live is None else out[live]
    if len(got) == 2:
        same = torch.equal(got["warp"], got["block"])
        print(f"    route A and route B bit for bit: {same}")
        if not same:
            raise AssertionError("the routes differ on the valid region")


def device_ms(fn, reps=10):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [ev.time_range.end - ev.time_range.start
                 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and "rnnt_lattice" in ev.name]
        if spans:
            return sum(spans) / len(spans) / 1e3
    return None


def wrapper_ms(fn, iters=20):
    for _ in range(3):
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--out", default="build/tune_lattice.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_lattice: no CUDA device", file=sys.stderr)
        return 2
    names = args.variants.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"# {smi}")
    built = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    problems = {}
    for shape, b, t, u1, v in SHAPES:
        fwd, rev, live = problem(b, t, u1, v, gen)
        problems[shape] = (fwd, rev)
        for name in names:
            lib = built[name][0]
            if shape == SHAPES[0][0]:
                macros = ", ".join(f"SVT_LAT_{m}={v}" for m, v in
                                   zip(MACROS, VARIANTS[name]))
                print(f"  variant {name} ({macros}):")
                for line in built[name][1]:
                    print(f"    {line}")
                for r in tl.lattice_kernel_attributes(lib, (81, 128)):
                    print(f"    attributes {r}")
            check(lib, f"{name} {shape}", fwd, False, None)
            check(lib, f"{name} {shape}", rev, True, live)
    cases = []
    for shape, *_ in SHAPES:
        fwd, rev = problems[shape]
        cases.append((shape, "alpha", fwd, False))
        if shape == SHAPES[0][0]:
            cases.append((shape, "beta", rev, True))
    results = {}
    order = names + names[::-1]
    for name in order:
        lib = built[name][0]
        todo = [(case, plan) for case in cases
                for plan in plans(lib, case[2], case[3])]
        for (shape, lattice, panels, reverse), plan in todo:
            key = f"{name} {shape} {lattice} {plan.route}"

            def fn(panels=panels, reverse=reverse, plan=plan, lib=lib):
                return tl._launch(*panels, reverse, plan=plan, lib=lib)

            results.setdefault(key, []).append((device_ms(fn),
                                                wrapper_ms(fn)))
    report = {"device": smi, "variants": {n: VARIANTS[n] for n in names},
              "ms": {}}
    for key, runs in results.items():
        dev = [d for d, _ in runs if d is not None]
        dev_ms = sum(dev) / len(dev) if dev else None
        wrap_ms = sum(w for _, w in runs) / len(runs)
        report["ms"][key] = {"device_ms": dev_ms, "wrapper_ms": wrap_ms}
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f}"
        print(f"  {key}: device {dev_txt} ms a launch, wrapper "
              f"{wrap_ms:.4f} ms")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
