#!/usr/bin/env python3
"""Time variants of the port's conv frontend kernel on one GPU.

    python3 tools/tune_conv_frontend.py [--variants 0,S,R] \\
        [--out chiprun_out/tune_conv.json]

Builds ``svt_speechbrain_tpu_torch/csrc/conv_frontend.cu`` once per variant
of its ``SVT_CONV_*`` macros (BM and the slab width BK of the f32 mma.sync
body, its ring's stages, layer 0's BM; bf16 at C 512 runs on wgmma in every
variant), and variant 0 from ``tools/conv_frontend_v0.cu``, the
design before the Hopper redesign, so that the old kernel is timed in the
same run. One ``nvcc`` per variant, all started together. For each variant
it prints the registers and spill bytes (ptxas) of every instantiation and,
where the build exports them, the runtime's registers, local memory, shared
memory and resident blocks; holds the frontend against its plain version
(C 128 and 512, a (2, 16123) wav and a (3, 16123) view at an odd sample
offset, f32 and bf16, the tolerances of ``chip_smoke.py``); and times it at
the main-path shapes:

- the whole frontend (seven launches) at wav (8, 80000), chunked serving's
  batch, and (1, 480000), the 30 s song window, in bf16 and f32, lv60's
  C = 512;
- each layer on its own at (8, 80000), in bf16 and f32, as its kernel's
  device time a launch from torch.profiler (through the wrapper the small
  layers would read the host's launch time).

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

from svt_speechbrain_tpu_torch.convert_jax import (  # noqa: E402
    init_params, load_jax_params)
from svt_speechbrain_tpu_torch.models.wav2vec2 import (  # noqa: E402
    ConvFeatureExtractor, Wav2Vec2Config)
from svt_speechbrain_tpu_torch.ops import _build  # noqa: E402
from svt_speechbrain_tpu_torch.ops import conv_frontend as cf  # noqa: E402

V0_SOURCE = ROOT / "tools" / "conv_frontend_v0.cu"
# name: (BM f32, BK f32, stages, layer-0 BM); "0" is the old design; "S" is
# the source's default. PERF.md keeps the earlier rounds, with switches the
# source no longer has (forms 1 and 3: BM frames x all C in one block, the
# two column halves in one block; three slabs ahead on wgmma; bf16 C 512 on
# mma.sync and its BM and BK).
VARIANTS = {
    "0": None,
    "S": (64, 32, 3, 32),
    "R": (64, 16, 3, 32),
    "Z": (32, 16, 4, 64),
}
MACROS = ("F32_BM", "F32_BK", "STAGES", "L0_BM")
TOL = {torch.float32: 1e-3, torch.bfloat16: 6.25e-2}   # chip_smoke.py
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
SHAPES = ((8, 80000), (1, 480000))


def build(variants):
    """One nvcc per variant, started together: {name: (library, ptxas
    lines or the compiler's error)}."""
    out_dir = _build.BUILD_DIR.parent / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, spec in variants.items():
        src = V0_SOURCE if spec is None else _build.CSRC / "conv_frontend.cu"
        flags = [*_build.NVCC_FLAGS, f"-I{_build.CSRC}"]
        if spec is not None:
            flags += [f"-DSVT_CONV_{m}={v}" for m, v in zip(MACROS, spec)]
        digest = hashlib.sha256(" ".join(flags).encode())
        for part in sorted(_build.CSRC.glob("*.cuh")) + [src]:
            digest.update(part.read_bytes())
        lib = out_dir / f"conv-{name}-{digest.hexdigest()[:12]}.so"
        cmd = [_build._nvcc(), *flags, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            errors = [line for line in text.splitlines() if "error" in line]
            built[name] = (None, "\n".join(errors) or text)
            continue
        built[name] = (lib, [line.strip() for line in text.splitlines()
                             if "registers" in line or "spill" in line
                             or "Compiling entry" in line
                             or "wgmma" in line or "arning" in line])
    return built


def load(path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in cf._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def time_ms(fn, iters=10, warmup=3):
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


def device_ms(fn, reps=10):
    """Mean device time of the frontend kernels that ``fn`` launches, ms a
    launch (torch.profiler: the kernels' own intervals, no host time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [ev.time_range.end - ev.time_range.start for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and "conv_ln_gelu" in ev.name]
    if not spans:
        raise RuntimeError("the profiler saw no frontend kernel")
    return sum(spans) / len(spans) / 1e3


def extractor(c, seed=0):
    """An lv60-schedule frontend of width c with seeded random weights."""
    cfg = Wav2Vec2Config(conv_dim=(c,) * 7)
    tree = init_params(cfg, torch.Generator().manual_seed(seed))
    holder = torch.nn.Module()
    holder.feature_extractor = ConvFeatureExtractor(cfg)
    load_jax_params({"wav2vec2": {"feature_extractor": tree["wav2vec2"]
                                  ["encoder"]["feature_extractor"]}}, holder)
    return holder.feature_extractor.cuda()


def odd_view(b, t, dtype, gen):
    """A (b, t) wav that starts one sample into its storage."""
    flat = torch.randn(b * t + 1, generator=gen, device="cuda").to(dtype)
    return flat[1:].view(b, t)


def check(lib, exts, gen):
    """Max abs error against the plain version per (C, case, dtype);
    raises past TOL."""
    errs = {}
    for c, ext in exts.items():
        for tag, dtype in DTYPES.items():
            packed = ext.packed(dtype)
            for case, x in (("(2, 16123)", torch.randn(
                    2, 16123, generator=gen, device="cuda").to(dtype)),
                            ("(3, 16123) odd offset",
                             odd_view(3, 16123, dtype, gen))):
                got = cf._launch(x, packed, 1e-5, lib=lib)
                want = cf.conv_frontend_reference(x, packed)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                key = f"C{c} {case} {tag}"
                errs[key] = err
                if not (err <= TOL[dtype] and torch.isfinite(got).all()):
                    raise AssertionError(f"{key}: max abs error {err:.3e}")
    return errs


def cases(ext, gen):
    """(label, launch(lib), timer) at the main-path shapes: the whole
    frontend (CUDA events around the wrapper), then each layer on its own
    input, the plain version's (the profiler's device time)."""
    out = []
    for tag, dtype in DTYPES.items():
        packed = ext.packed(dtype)
        for shape in SHAPES:
            wav = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            out.append((f"{tag} {shape}",
                        lambda lib, w=wav, p=packed: cf._launch(w, p, 1e-5,
                                                                lib=lib),
                        time_ms))
        x = torch.randn(SHAPES[0], generator=gen, device="cuda").to(dtype)
        for i, layer in enumerate(packed):
            out.append((f"{tag} layer {i}",
                        lambda lib, x=x, layer=layer: cf._launch_layer(
                            lib, x, layer, 1e-5),
                        device_ms))
            x = cf._reference_layer(x if i else x[..., None], layer, 1e-5)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out/tune_conv.json")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated names of VARIANTS")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_conv_frontend: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    exts = {c: extractor(c) for c in (128, 512)}
    report = {"device": smi, "variants": {}}
    libs = {}
    for name, (path, text) in built.items():
        spec = chosen[name]
        row = report["variants"][name] = {
            "spec": None if spec is None else dict(zip(MACROS, spec))}
        if path is None:
            row["error"] = text[-3000:]
            print(f"{name}: build failed\n{text[-3000:]}", flush=True)
            continue
        lib = load(path)
        row["ptxas"] = text
        for line in text:
            print(f"  [{name}] {line}", flush=True)
        if hasattr(lib, "svt_conv_frontend_attributes"):
            row["attributes"] = cf.frontend_kernel_attributes(lib)
            for a in row["attributes"]:
                if a["c"] == 512:
                    print(f"  [{name}] {a['kernel']} {a['dtype']} C512: "
                          f"{a['registers']} registers, {a['local_bytes']} "
                          f"bytes local, {a['smem_bytes']} bytes shared, "
                          f"{a['blocks_per_sm']} blocks an SM", flush=True)
        try:
            row["max_abs_err"] = check(lib, exts, gen)
        except (AssertionError, RuntimeError) as exc:
            row["error"] = str(exc)
            print(f"{name}: fails: {exc}", flush=True)
            continue
        print(f"{name} {row['spec']}: worst err "
              f"{max(row['max_abs_err'].values()):.3e}", flush=True)
        libs[name] = lib
    runs = cases(exts[512], gen)
    order = list(libs)
    times = {name: {label: [] for label, _, _ in runs} for name in order}
    for names in (order, order[::-1]):
        for name in names:
            for label, launch, timer in runs:
                times[name][label].append(timer(lambda: launch(libs[name])))
    labels = [label for label, _, _ in runs]
    print("variant | " + " | ".join(labels))
    for name in order:
        row = report["variants"][name]
        row["ms"] = {k: sum(v) / len(v) for k, v in times[name].items()}
        row["ms_passes"] = times[name]
        print(f"{name} | " + " | ".join(f"{row['ms'][label]:.4f}"
                                        for label in labels), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: {lab: round(ms, 4) for lab, ms in v["ms"].items()
                          if "layer" not in lab}
                      for k, v in report["variants"].items() if "ms" in v}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
