#!/usr/bin/env python3
"""Time tile variants of the port's attention forward kernel on one GPU.

    python3 tools/tune_flash_forward.py [--out chiprun_out/tune_fwd.json]

Builds ``svt_speechbrain_tpu_torch/csrc/flash_attention.cu`` once per
variant of its tiles (the ``SVT_FWD_*`` macros: panel rows, ring stages and
resident blocks an SM, for f32 and for bf16), one ``nvcc`` per variant, all
started together. For each variant it
prints every instantiation's registers, local memory (spills), shared memory
and resident blocks, holds the kernel against its plain version (3b at a
small shape in f32 and bf16, with dropout and lengths), and times it at the
main-path shapes of ``chip_smoke.py`` phase 5 beside SDPA on the same inputs:

- 3b, the training forward, f32 and bf16 at (8, 16, 1499, 64), rate 0.1;
- row 3, the streaming serving forward, bf16 at (3, 16, 1499, 64), lengths
  [1499, 700, 0];
- row 2, the short serving forward, bf16 at (8, 16, 249, 64), lengths
  [249, 0, 1, 100, 249, 200, 17, 248].

The variants are timed in turns, in order and then in reverse, and each
time is the mean of its two passes. ``--sass`` also prints, for each
variant, the static count of each SASS opcode in each instantiation
(``cuobjdump -sass``): where the issue slots of the unrolled panel loop go.
Needs a CUDA device and nvcc; imports torch and the port only.
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
from svt_speechbrain_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (f32: panel, stages, blocks), (bf16: panel, stages, blocks): "S" is the
# source's own; PERF.md has these and the earlier rounds (A-T), which also
# varied switches the source no longer has (Q re-read from shared memory,
# expf, the length mask on every panel)
VARIANTS = {
    "S": ((16, 2, 2), (32, 3, 4)),
    "P": ((32, 2, 2), (32, 3, 4)),
    "T": ((32, 3, 2), (32, 4, 4)),
    "V": ((16, 3, 2), (64, 3, 3)),
}
SHORT_LENGTHS = [249, 0, 1, 100, 249, 200, 17, 248]
LONG_LENGTHS = [1499, 700, 0]
RATE = 0.1
SEED = 1234567
CHECK_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def defines(f32, bf16):
    names = ("F32_PANEL", "F32_STAGES", "F32_BLOCKS", "BF16_PANEL",
             "BF16_STAGES", "BF16_BLOCKS")
    return [f"-DSVT_FWD_{n}={x}" for n, x in zip(names, (*f32, *bf16))]


def sass_histogram(lib):
    """{kernel instantiation: {opcode: static count}} from cuobjdump."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    hist, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            hist[name] = {}
        elif name and line.startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].split(";")[0].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if not words:
                continue
            op = words[0].split(".")[0]
            if op == "HMMA" and words[-1] == "RZ":
                op = "HMMA(C=RZ)"
            hist[name][op] = hist[name].get(op, 0) + 1
    return hist


def build(variants):
    """One nvcc per variant, started together: {name: (library, ptxas
    lines or the compiler's error)}."""
    out_dir = _build.BUILD_DIR.parent / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "flash_attention.cu"
    procs = {}
    for name, spec in variants.items():
        flags = [*_build.NVCC_FLAGS, *defines(*spec)]
        digest = hashlib.sha256(" ".join(flags).encode())
        for part in sorted(_build.CSRC.glob("*.cuh")) + [src]:
            digest.update(part.read_bytes())
        lib = out_dir / f"fwd-{name}-{digest.hexdigest()[:12]}.so"
        cmd = [_build._nvcc(), *flags, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            built[name] = (None, text)
            continue
        built[name] = (lib, [line.strip() for line in text.splitlines()
                             if "registers" in line or "spill" in line])
    return built


def load(path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in fa._FWD.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def time_ms(fn, iters=20, warmup=3):
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


def inputs(shape, lengths, dtype, gen):
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    return q, k, v, lens


def check(lib, gen):
    """Max abs error of out against the plain version, at a small shape
    with ragged lengths and dropout, per dtype; raises past CHECK_TOL."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, lens = inputs((3, 4, 300, 64), [300, 0, 170], dtype, gen)
        lse = torch.empty(q.shape[:3], device="cuda")
        got = fa._launch_fwd(q, k, v, lens, None, lse, SEED, RATE, lib=lib)
        want, want_lse = fa.attention_lse_reference(q, k, v, lens, None,
                                                    SEED, RATE)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        live = want_lse > fa.NEG_INF / 2
        err_l = (lse[live] - want_lse[live]).abs().max().item()
        if err > CHECK_TOL[dtype] or err_l > 1e-3 or (got[1] != 0).any():
            raise AssertionError(f"{dtype}: out {err:.3e}, L {err_l:.3e}")
        errs[str(dtype).split(".")[-1]] = err
    return errs


def cases(gen):
    """(label, launch(lib), SDPA call) at the main-path shapes."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, _ = inputs((8, 16, 1499, 64), None, dtype, gen)
        lse = torch.empty(q.shape[:3], device="cuda")
        out.append((f"3b {tag}",
                    lambda lib, q=q, k=k, v=v, lse=lse: fa._launch_fwd(
                        q, k, v, None, None, lse, SEED, RATE, lib=lib),
                    lambda q=q, k=k, v=v: sdpa(q, k, v, dropout_p=RATE)))
    for label, shape, lengths in (("row 3 bf16", (3, 16, 1499, 64),
                                   LONG_LENGTHS),
                                  ("row 2 bf16", (8, 16, 249, 64),
                                   SHORT_LENGTHS)):
        q, k, v, lens = inputs(shape, lengths, torch.bfloat16, gen)
        keep = (torch.arange(shape[2], device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        out.append((label,
                    lambda lib, q=q, k=k, v=v, lens=lens: fa._launch_fwd(
                        q, k, v, lens, None, None, lib=lib),
                    lambda q=q, k=k, v=v, keep=keep: sdpa(q, k, v,
                                                          attn_mask=keep)))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out/tune_fwd.json")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated names of VARIANTS")
    parser.add_argument("--sass", action="store_true",
                        help="print each variant's SASS opcode counts")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_flash_forward: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"# {smi}", flush=True)
    chosen = {n: VARIANTS[n] for n in args.variants.split(",")}
    t0 = time.perf_counter()
    built = build(chosen)
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"device": smi, "variants": {}}
    libs = {}
    for name, (path, text) in built.items():
        f32, bf16 = chosen[name]
        row = report["variants"][name] = {"f32": f32, "bf16": bf16}
        if path is None:
            row["error"] = text[-2000:]
            print(f"{name}: build failed\n{text[-2000:]}", flush=True)
            continue
        lib = load(path)
        row["ptxas"] = text
        row["attributes"] = fa.forward_kernel_attributes(lib)
        try:
            row["max_abs_err"] = check(lib, gen)
        except AssertionError as exc:
            row["error"] = str(exc)
            print(f"{name}: disagrees with the plain version: {exc}",
                  flush=True)
            continue
        libs[name] = lib
        if args.sass:
            row["sass"] = sass_histogram(path)
            for fn, ops in row["sass"].items():
                top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
                print(f"  {name} {fn}: {sum(ops.values())} instructions; "
                      + ", ".join(f"{op} {n}" for op, n in top), flush=True)
        attrs = "; ".join(
            f"{a['dtype']} D{a['d']}{' drop' if a['dropout'] else ''} "
            f"{a['registers']}r {a['local_bytes']}L {a['smem_bytes']}B "
            f"{a['blocks_per_sm']}blk" for a in row["attributes"])
        print(f"{name} f32 {f32} bf16 {bf16}: err {row['max_abs_err']}; "
              f"{attrs}", flush=True)
    runs = cases(gen)
    order = list(libs)
    times = {name: {label: [] for label, _, _ in runs} for name in order}
    sdpa_ms = {label: [] for label, _, _ in runs}
    for names in (order, order[::-1]):
        for label, _, lib_call in runs:
            sdpa_ms[label].append(time_ms(lib_call))
        for name in names:
            for label, launch, _ in runs:
                times[name][label].append(
                    time_ms(lambda: launch(libs[name])))
    report["sdpa_ms"] = {k: sum(v) / len(v) for k, v in sdpa_ms.items()}
    print("variant | " + " | ".join(label for label, _, _ in runs))
    print("SDPA | " + " | ".join(f"{report['sdpa_ms'][label]:.4f}"
                                 for label, _, _ in runs))
    for name in order:
        row = report["variants"][name]
        row["ms"] = {k: sum(v) / len(v) for k, v in times[name].items()}
        row["ms_passes"] = times[name]
        print(f"{name} f32 {row['f32']} bf16 {row['bf16']} | "
              + " | ".join(f"{row['ms'][label]:.4f}"
                           for label, _, _ in runs), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v.get("ms") for k, v in report["variants"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
