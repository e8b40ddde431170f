#!/usr/bin/env python3
"""Measure the dependent step of the RNN-T lattice kernel (row 6a) on one GPU.

    python3 tools/lattice_step_probe.py [--rows 749] [--u1 81]

``csrc/transducer_lattice.cu`` (``rnnt_lattice_kernel``) walks rows + u1 - 1
anti-diagonals one after another; a step reads the previous diagonal from
shared memory, adds the two edge weights, takes two ``logaddexp`` and
writes the new diagonal, then a barrier. Its loads of the four panels from
device memory can be issued a diagonal ahead, so they are off that chain.
This script builds a probe kernel that runs exactly that chain with the
panels' values in registers (one block, a thread a label position, the same
``logaddexp`` and ``__syncthreads``) and reports its time a step, from the
global timer and from the SM clock, over the step counts of the training
shape: rows + u1 - 1 for alpha (``rows`` = T) and for beta (T + 1 rows).
That time a step times the step count is the lattice's step bound.

Needs a CUDA device and nvcc (built like the port's kernels, without fast
math); imports torch only.
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

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
__device__ __forceinline__ float logaddexp(float x, float y) {
  return fmaxf(x, y) + log1pf(expf(-fabsf(x - y)));
}

// the lattice's step chain: the previous diagonal from shared memory, the
// edge weights from registers, two logaddexp, the new diagonal, a barrier
__global__ void chain(int steps, int u1, float* sink,
                      unsigned long long* out) {
  extern __shared__ float diag[];
  const int u = threadIdx.x;
  const float a = -6.9f - 1e-3f * u, b = -7.1f + 1e-3f * u;
  const float seed = -1e30f;
  if (u < u1) diag[u] = diag[u1 + u] = 0.0f;
  __syncthreads();
  unsigned long long t0 = 0, c0 = 0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  c0 = clock64();
  float last = 0.0f;
  for (int d = 0; d < steps; ++d) {
    const float* prev = diag + ((d + 1) & 1) * u1;
    float* cur = diag + (d & 1) * u1;
    if (u < u1) {
      const float stay = prev[u] + a;
      const float move = u >= 1 ? prev[u - 1] + b : -1e30f;
      last = logaddexp(logaddexp(stay, move), seed);
      cur[u] = last;
    }
    __syncthreads();
  }
  unsigned long long t1 = 0;
  const unsigned long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  sink[u] = last;
  if (u == 0) {
    out[0] = t1 - t0;
    out[1] = c1 - c0;
  }
}
}  // namespace

extern "C" int probe_chain(int steps, int u1, int threads, float* sink,
                           unsigned long long* out) {
  chain<<<1, threads, 2 * u1 * sizeof(float)>>>(steps, u1, sink, out);
  return (int)cudaGetLastError();
}
"""


def build():
    out_dir = _build.BUILD_DIR.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + SOURCE).encode())
    lib = out_dir / f"lattice_step-{digest.hexdigest()[:12]}.so"
    if not lib.exists():
        src = out_dir / "lattice_step.cu"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.probe_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
    so.probe_chain.restype = ctypes.c_int
    return so


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=749)
    parser.add_argument("--u1", type=int, default=81)
    parser.add_argument("--out", default="build/lattice_step.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("lattice_step_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    so = build()
    threads = (args.u1 + 31) // 32 * 32
    sink = torch.empty(threads, device="cuda")
    report = {"device": smi, "u1": args.u1, "threads": threads}
    ns, cycles = [], []
    for steps in (args.rows + args.u1 - 1, 4 * (args.rows + args.u1 - 1)):
        out = torch.zeros(2, dtype=torch.int64, device="cuda")
        for _ in range(3):                        # the last of three
            _build.check(so.probe_chain(steps, args.u1, threads,
                                        sink.data_ptr(), out.data_ptr()),
                         "probe launch")
        torch.cuda.synchronize()
        t, c = out.tolist()
        ns.append(t / steps)
        cycles.append(c / steps)
        report[f"steps {steps}"] = {"ns_a_step": t / steps,
                                    "cycles_a_step": c / steps}
    step_ns = min(ns)
    for name, rows in (("alpha", args.rows), ("beta", args.rows + 1)):
        steps = rows + args.u1 - 1
        report[f"{name} bound ms"] = steps * step_ns / 1e6
    print(f"# {smi}")
    print(f"lattice step chain (u1 {args.u1}, {threads} threads): "
          f"{step_ns:.1f} ns, {min(cycles):.0f} SM cycles a step; step "
          f"bound alpha ({args.rows + args.u1 - 1} steps) "
          f"{report['alpha bound ms']:.4f} ms, beta "
          f"({args.rows + args.u1} steps) {report['beta bound ms']:.4f} ms")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
