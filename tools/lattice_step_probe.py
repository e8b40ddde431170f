#!/usr/bin/env python3
"""Measure the dependent step of the RNN-T lattice kernel (row 6a) on one GPU.

    python3 tools/lattice_step_probe.py [--rows 749] [--u1 81]

``csrc/transducer_lattice.cu`` walks rows + u1 - 1 anti-diagonals one after
another, by one of two routes. This script builds a probe kernel for each
route's dependent chain with the panels' values in registers (route A loads
them a step ahead; route B loads them inside its step, so its probe is the
bound of its design with those loads moved out), and reports its time a
step, from the global timer and from the SM clock, over the step counts of
the training shape: rows + u1 - 1 for alpha (``rows`` = T) and for beta
(T + 1 rows). That time a step times the step count is the route's step
bound.

- Route B (``rnnt_lattice_kernel``, a block a batch row, a thread a label
  position): the previous diagonal from shared memory, two ``logaddexp``,
  the new diagonal written back, a barrier.
- Route A (``rnnt_lattice_warp_kernel``, ceil(u1 / 32) compute warps a
  batch row, a cell a thread): the neighbour by ``__shfl_up_sync`` (across
  warps through shared memory), two adds, one ``logaddexp``, the seed term
  as one ``max.NaN`` behind a warp vote on the seed alone, a barrier of the
  compute warps.

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

__device__ __forceinline__ bool seed_is_low(float s) {
  return s <= -1e30f && s > -__int_as_float(0x7f800000);
}

__device__ __forceinline__ float seed_max(float x, float s) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(x), "f"(s));
  return m;
}

// route B's step chain: the previous diagonal from shared memory, the
// edge weights from registers, two logaddexp, the new diagonal, a barrier
__global__ void chain(int steps, int u1, float seed, float* sink,
                      unsigned long long* out) {
  extern __shared__ float diag[];
  const int u = threadIdx.x;
  const float a = -6.9f - 1e-3f * u, b = -7.1f + 1e-3f * u;
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

// route A's step chain: a block of ceil(u1 / 32) warps, one cell a
// thread in a register, the neighbour by shuffle inside a warp and through
// shared memory across warps, one logaddexp, the guard and its vote, a
// barrier a step
__global__ void chain_band(int steps, float seed, float* sink,
                           unsigned long long* out) {
  __shared__ float edge[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u = threadIdx.x;
  const float a = -6.9f - 1e-3f * u, b = -7.1f + 1e-3f * u;
  float v = 0.0f;
  if (lane == 31) edge[0][warp] = edge[1][warp] = 0.0f;
  __syncthreads();
  unsigned long long t0 = 0, c0 = 0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  c0 = clock64();
  for (int d = 0; d < steps; ++d) {
    float left = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0 && warp > 0) left = edge[(d + 1) & 1][warp - 1];
    const float stay = v + a;
    const float move = u >= 1 ? left + b : -1e30f;
    float x = logaddexp(stay, move);
    if (__any_sync(0xffffffffu, !seed_is_low(seed)))
      x = seed_is_low(seed) ? seed_max(x, seed) : logaddexp(x, seed);
    else
      x = seed_max(x, seed);
    if (lane == 31) edge[d & 1][warp] = x;
    v = x;
    __syncthreads();
  }
  unsigned long long t1 = 0;
  const unsigned long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  sink[u] = v;
  if (u == 0) {
    out[0] = t1 - t0;
    out[1] = c1 - c0;
  }
}
}  // namespace

extern "C" int probe_chain_band(int steps, int u1, float* sink,
                                unsigned long long* out) {
  chain_band<<<1, (u1 + 31) / 32 * 32>>>(steps, -1e30f, sink, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_chain(int steps, int u1, int threads, float* sink,
                           unsigned long long* out) {
  chain<<<1, threads, 2 * u1 * sizeof(float)>>>(steps, u1, -1e30f, sink,
                                                 out);
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
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(lib), str(src)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    so = ctypes.CDLL(str(lib))
    so.probe_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
    so.probe_chain_band.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p]
    for fn in (so.probe_chain, so.probe_chain_band):
        fn.restype = ctypes.c_int
    return so


def step_time(launch, base_steps):
    """(ns, SM cycles) a step: the least over base_steps and 4 x as many
    steps, each the last of three launches."""
    ns, cycles = [], []
    for steps in (base_steps, 4 * base_steps):
        out = torch.zeros(2, dtype=torch.int64, device="cuda")
        for _ in range(3):
            _build.check(launch(steps, out.data_ptr()), "probe launch")
        torch.cuda.synchronize()
        t, c = out.tolist()
        ns.append(t / steps)
        cycles.append(c / steps)
    return min(ns), min(cycles)


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
    sink = torch.empty(max(threads, 32), device="cuda")
    base = args.rows + args.u1 - 1
    routes = {"B": step_time(lambda n, out: so.probe_chain(
        n, args.u1, threads, sink.data_ptr(), out), base)}
    if args.u1 <= 128:
        routes["A"] = step_time(lambda n, out: so.probe_chain_band(
            n, args.u1, sink.data_ptr(), out), base)
    report = {"device": smi, "u1": args.u1, "rows": args.rows}
    print(f"# {smi}")
    for route, (ns, cycles) in routes.items():
        bounds = {name: (rows + args.u1 - 1) * ns / 1e6
                  for name, rows in (("alpha", args.rows),
                                     ("beta", args.rows + 1))}
        report[route] = {"ns_a_step": ns, "cycles_a_step": cycles,
                         **{f"{k} bound ms": v for k, v in bounds.items()}}
        what = {"B": f"{threads} threads, two logaddexp",
                "A": f"{threads // 32} warps, a cell a thread"}[route]
        print(f"route {route} step chain (u1 {args.u1}, {what}): {ns:.1f} "
              f"ns, {cycles:.0f} SM cycles a step; step bound alpha "
              f"({args.rows + args.u1 - 1} steps) {bounds['alpha']:.4f} ms, "
              f"beta ({args.rows + args.u1} steps) {bounds['beta']:.4f} ms")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
