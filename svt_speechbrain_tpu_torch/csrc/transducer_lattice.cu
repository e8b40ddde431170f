// RNN-T (transducer) lattice and its closed-form gradient, f32.
//
// Replaces the TPU kernel svt_speechbrain_tpu/ops/transducer_lattice.py
// `_run_lattice` (body `_lattice_kernel`) and the five XLA passes of its
// backward `_nll_logits_bwd`. They are the counterpart of the original
// PyTorch reference's numba kernels cu_kernel_forward / cu_kernel_backward
// / cu_kernel_compute_grad.
//
// svt_rnnt_lattice fills, for each batch row,
//
//   out[t, u] = logaddexp(out[t-1, u] + a[t-1, u],
//                         out[t, u-1] + b[t, u-1],
//                         seed[t, u])
//
// over a (rows, u1) grid. The TPU kernel's grid step is one anti-diagonal
// over all batch rows in one vector register, on panels skewed, padded to
// 128 lanes and transposed for that. None of that layout is kept here.
//
// reverse = 1 is the beta lattice: the same recurrence in the flipped
// coordinates (rows-1-t, u1-1-u), with a and b holding one row less than
// out (the masked skip and emit panels, T rows for a (T+1, u1) beta), so
//
//   out[t, u] = logaddexp(out[t+1, u] + a[t, u], out[t, u+1] + b[t, u],
//                         seed[t, u])
//
// and both edges of a cell read the same position of a and b. The flips,
// the shift and the padding rows that the JAX `_beta` builds are index
// arithmetic here.
//
// What bounds it: the dependent chain, not bytes. The four panels are a
// few MB (0.0023 ms of device memory at (8, 749, 81)); the time is rows +
// u1 - 1 anti-diagonals walked one after another (829 at T 749, U 80), on
// as many SMs as the batch has rows. A step's latency is the bound.
//
// Two routes, chosen by u1 alone (ops/transducer_lattice.py `lattice_plan`):
//
// Route A, `rnnt_lattice_warp_kernel`, u1 <= 128: a block a batch row
// (the batch's rows sit on separate SMs) of ceil(u1 / 32) compute warps, a
// cell a thread, and 4 helper warps. The current diagonal stays in
// the compute threads' registers. A step's chain is one `__shfl_up_sync`
// (out[t, u-1] from the lane below; lane 0 takes the warp below's last cell
// through shared memory), two adds, one `logaddexp`, one `max.NaN` for the
// seed term, and a barrier of the compute warps alone. The rest is kept off
// that chain:
//   * The panels. The helpers load rows of a, b and seed two epochs (of 4
//     steps) ahead into registers and put them into a ring in shared memory
//     laid out by anti-diagonal: cell (t, u) at ring[(t + u) % D][u], D =
//     u1 + 13. A step's cells are consecutive words, so a compute thread
//     reads its next cell of each panel with one conflict-free load a step
//     ahead; a helper writes a row with a stride of (threads + 1) words,
//     also free of conflicts. The forward's a[t-1, u] and b[t, u-1] are put
//     at the cell they feed, (t, u); reverse reads the flipped rows from
//     the far end.
//   * The output. A cell's value replaces its seed in the ring; the helpers
//     store each finished row from there, coalesced.
//   * The seed term. For a finite seed s <= -1e30 (every cell but one a
//     row), logaddexp(x, s) is max.NaN(x, s) bit for bit (see `seed_max`).
//     A warp votes on its seeds alone, known a step ahead, and only a step
//     with another seed (alpha's (0, 0), beta's seed cell) takes the second
//     `logaddexp`.
//   * The helpers meet the compute warps once an epoch (barrier 2), so no
//     step waits for device memory. Measured on the H100 (PERF.md), each
//     of these was the bottleneck before it moved: staging by the compute
//     threads themselves or by one helper warp that met them every step,
//     loads the compiler sank to their first use, a helper's own issue
//     rate (hence 4 of them), and the vote on the chain. One warp a row
//     with 3 cells a lane and no barrier, tried and dropped, issued 3
//     `logaddexp` a step from one scheduler and lost to a cell a thread.
//
// Route B, `rnnt_lattice_kernel`, any u1 (the first port's design): a
// block a batch row, a thread a label position, the previous diagonal in
// shared memory (two buffers, one barrier a diagonal), panel loads from
// device memory inside the step, two `logaddexp` a cell. Above u1 = 128 a
// block would need more than 4 compute warps and its ring more than the 227
// KB of shared memory a block may take (3 x (u1 + 13) x 32 ceil(u1 / 32) x
// 4 bytes is 216,576 at 128, 272,640 at 129), so the routes meet there.
//
// svt_rnnt_grad is one pass over the (B, T, u1, V) logits: a warp owns one
// lattice cell, computes the two transition posteriors
//
//   occ_skip = exp(clip(alpha[t,u] + skip[t,u] + beta[t+1,u] - log_z, -1e30, 0))
//   occ_emit = exp(clip(alpha[t,u] + emit[t,u] + beta[t,u+1] - log_z, -1e30, 0))
//
// (0 outside the row's valid region t < t_len, u <= u_len, resp. u < u_len)
// and writes, for every v,
//
//   d[v] = -g*occ_skip*[v = blank] - g*occ_emit*[v = target[u]]
//          + g*(occ_skip + occ_emit) * exp(logits[v] - lse)
//
// (the last term only without from_log_probs). The logits are read once,
// the gradient is written once, log-probabilities are never stored. A cell
// whose posteriors are both 0 gets zeros without its logits being read, so
// padding costs a write only. Bytes bound it (4 V bytes read per live cell,
// 4 V written per cell, against 3.35 TB/s); 16-byte loads and stores when V
// is a multiple of 4 and the tensors are 16-byte aligned.
//
// NEG_INF is -1e30, finite: sums of two stay finite and logaddexp of two of
// them gives about -1e30. Built without -use_fast_math; it must stay so.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"   // svt::allow_smem

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxShared = 232448;
constexpr int kGradWarps = 8;     // lattice cells per block of the gradient
constexpr int kWarpMaxU1 = 128;  // route A takes u1 up to this
constexpr int kMaxWarps = 4;     // route A's compute warps a block, at most
// route A: steps an epoch, after which the helper warps meet the compute
// warps; helper warps, which share an epoch's rows to stage and to store.
// tools/tune_lattice.py builds others; the wrapper's plan reads each
// build's geometry from its `svt_rnnt_lattice_plan`.
#ifndef SVT_LAT_EPOCH
#define SVT_LAT_EPOCH 4
#endif
#ifndef SVT_LAT_HELPERS
#define SVT_LAT_HELPERS 4
#endif
constexpr int kEpoch = SVT_LAT_EPOCH;
constexpr int kHelperWarps = SVT_LAT_HELPERS;
constexpr int kHelpers = 32 * kHelperWarps;  // threads that stage and store

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float logaddexp(float x, float y) {
  return fmaxf(x, y) + log1pf(expf(-fabsf(x - y)));
}

// Route A's helper warps move data with these: a global load that stays
// where it is written (the compiler may otherwise sink a load through a
// __restrict__ pointer past the barriers to its first use, which puts its
// whole latency there), and shared-memory accesses by a 32-bit address
// computed once (the compiler would otherwise rebuild the shared window's
// base from a special register at each access), each under a predicate.
__device__ __forceinline__ float ld_global_if(bool p, const float* ptr) {
  float x = 0.0f;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %1, 0;\n"
      " @q ld.global.nc.f32 %0, [%2];\n}\n"
      : "+f"(x) : "r"((int)p), "l"(ptr));
  return x;
}

__device__ __forceinline__ float ld_shared_if(bool p, uint32_t addr) {
  float x = 0.0f;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %1, 0;\n"
      " @q ld.shared.f32 %0, [%2];\n}\n"
      : "+f"(x) : "r"((int)p), "r"(addr) : "memory");
  return x;
}

__device__ __forceinline__ void st_shared_if(bool p, uint32_t addr, float x) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %0, 0;\n"
      " @q st.shared.f32 [%1], %2;\n}\n"
      :: "r"((int)p), "r"(addr), "f"(x) : "memory");
}

// a named barrier of `threads` threads (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Route A's geometry for u1: compute warps (a cell a thread), threads a
// block (the compute warps and the helpers), and a ring of D = u1 +
// 3 kEpoch + 1 anti-diagonals of (compute threads) floats for each of a,
// b and seed. In epoch e (steps e R .. e R + R - 1, R = kEpoch) the
// helpers put rows (e + 1) R + 1 .. (e + 2) R, over the cells of rows D
// earlier, which they stored by the end of epoch e - 1 (rows up to
// (e - 1) R - u1): hence D >= u1 + 3R. Their diagonals stay clear of those
// the compute warps read and write in epoch e (e R .. (e + 1) R), which
// needs only D >= u1 + 2R.
struct WarpGeometry {
  int warps, threads, diags;   // warps: compute warps
  __host__ __device__ size_t smem() const {
    return 3 * sizeof(float) * (size_t)diags * 32 * warps;
  }
};

__host__ __device__ __forceinline__ WarpGeometry warp_geometry(int u1) {
  const int warps = (u1 + 31) / 32;
  return {warps, 32 * warps + kHelpers, u1 + 3 * kEpoch + 1};
}

// logaddexp(x, s) for a finite seed s <= -1e30 (`seed_is_low`), bit for
// bit, in one instruction: the larger of the two, NaN if x is NaN. For
// x >= -1e30 that is x, and |x - s| is 0 (x = s = -1e30, and x +
// log1pf(1) rounds to x) or at least 2^76, whose expf is 0; for x < -1e30
// the same holds with the roles swapped (both lie at or below -1e30, where
// an ulp is 2^76), -inf and +inf included. An infinite seed is left to
// logaddexp (-inf - -inf is NaN there).
__device__ __forceinline__ bool seed_is_low(float s) {
  return s <= kNegInf && s > -__int_as_float(0x7f800000);
}

__device__ __forceinline__ float seed_max(float x, float s) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(x), "f"(s));
  return m;
}

// Route A (see the note at the top): a block a batch row. The compute
// warps own a cell a thread, keep the diagonal in registers,
// take the neighbour by shuffle inside a warp and through `edge` across
// warps, and meet at a barrier of their own (1) every step. Helper warps
// load the panels' rows two epochs ahead into registers and put them into
// a ring laid out by anti-diagonal, and store each finished row of `out`,
// which the compute warps leave in the seed ring in place of the seeds
// they have used. They meet the compute warps once an epoch (barrier 2).
__global__ void __launch_bounds__(32 * kMaxWarps + kHelpers)
    rnnt_lattice_warp_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             const float* __restrict__ seed,
                             float* __restrict__ out, int rows, int u1,
                             int reverse) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float edge[2][kMaxWarps];   // each warp's last cell, by parity
  const WarpGeometry geometry = warp_geometry(u1);
  const int compute = 32 * geometry.warps;   // threads on the lattice

  const int width = compute;             // floats a ring diagonal
  const int diags = u1 + 3 * kEpoch + 1;
  float* const ring_a = ring;
  float* const ring_b = ring + diags * width;
  float* const ring_s = ring + 2 * diags * width;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  const int ab_rows = reverse ? rows - 1 : rows;
  a += row * ab_rows * u1;
  b += row * ab_rows * u1;
  seed += row * rows * u1;
  out += row * rows * u1;
  const int steps = rows + u1 - 1;
  const int epochs = (steps + kEpoch - 1) / kEpoch;

  if (warp * 32 >= compute) {
    const int helper = warp - compute / 32;
    // helper h takes the rows k = h % G of an epoch's G groups (G = the
    // fewer of helpers and epoch rows) and, with the helpers that share
    // them, the 32-column chunks c = h / G of every P (P = H / G)
    constexpr int G = kHelperWarps < kEpoch ? kHelperWarps : kEpoch;
    constexpr int P = kHelperWarps / G;
    static_assert(kHelperWarps % G == 0 && kEpoch % G == 0,
                  "an epoch's rows and chunks split evenly");
    const int group = helper % G, part = helper / G;
    // Lattice row t of the three panels: loaded into registers (`load`),
    // then put into the ring at t % D (`put`). Forward: seed[t, u] and
    // a[t-1, u] go to cell (t, u), b[t, u] to cell (t, u+1), the cell
    // whose move edge it weighs. Reverse: the panels' row rows-1-t, read
    // left to right, goes to u = u1-1-i. Lane l's columns are i = l + 32c;
    // cell (t, u) sits at diagonal t + u, position u.
    constexpr int C = kWarpMaxU1 / 32;
    const uint32_t ring_bytes = diags * width * sizeof(float);
    const uint32_t at_a = (uint32_t)__cvta_generic_to_shared(ring);
    const uint32_t at_b = at_a + ring_bytes, at_s = at_b + ring_bytes;
    const uint32_t diag_bytes = width * sizeof(float);
    // the lane's column i = l + 32c of every row sits at position pos[c]
    // of its diagonal, b's at pos_b[c] (the next cell forward, the same in
    // reverse)
    int col[C], pos[C], pos_b[C];
    bool mine[C], mine_b[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      col[c] = lane + 32 * c;
      mine[c] = col[c] < u1 && c % P == part;
      pos[c] = reverse ? u1 - 1 - col[c] : col[c];
      pos_b[c] = reverse ? pos[c] : pos[c] + 1;
      mine_b[c] = mine[c] && pos_b[c] < u1;
    }
    auto cell = [&](int slot, int u) {   // byte offset of (slot, u)
      const int d = slot + u;
      return (uint32_t)(d >= diags ? d - diags : d) * diag_bytes +
             (uint32_t)u * sizeof(float);
    };
    auto load = [&](float (&r)[3][C], int t) {
      if (t >= rows) return;
      const int src_row = reverse ? rows - 1 - t : t;
      // a's and b's rows for lattice row t (clamped at t = 0, unused there)
      const float* const ps = seed + src_row * u1;
      const float* const pa =
          a + (reverse ? min(src_row, ab_rows - 1) : max(src_row - 1, 0)) * u1;
      const float* const pb =
          b + (reverse ? min(src_row, ab_rows - 1) : src_row) * u1;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        r[0][c] = ld_global_if(mine[c], pa + col[c]);
        r[1][c] = ld_global_if(mine[c], pb + col[c]);
        r[2][c] = ld_global_if(mine[c], ps + col[c]);
      }
    };
    auto put = [&](const float (&r)[3][C], int t, int slot) {
      if (t >= rows) return;
      const bool b_edge = t >= 1 || !reverse;   // reverse row 0 has no b
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint32_t at = cell(slot, pos[c]);
        st_shared_if(mine[c], at_s + at, r[2][c]);
        st_shared_if(mine[c] && t >= 1, at_a + at, r[0][c]);
        st_shared_if(mine_b[c] && b_edge, at_b + cell(slot, pos_b[c]),
                     r[1][c]);
      }
    };
    // Store finished row r (at `slot` = r % D) from the seed ring.
    auto store = [&](int r, int slot) {
      float* const dst = out + (reverse ? rows - 1 - r : r) * u1;
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[c] = ld_shared_if(mine[c], at_s + cell(slot, pos[c]));
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (mine[c]) dst[col[c]] = v[c];
    };
    auto advance = [&](int slot, int by) {
      slot += by;
      return slot >= diags ? slot - diags : slot;
    };
    // Rows 0 .. R go in before the first epoch. In epoch e a helper puts
    // its rows of (e + 1) R + 1 .. (e + 2) R (group k: (e + 1) R + 1 + k,
    // + G, ...), loaded during epoch e - 2 (a load has two epochs to
    // arrive before its put: one is about the latency of device memory),
    // and stores its rows r = k mod G whose last cell epoch e - 1 computed
    // (r <= e R - u1); the rest after the last epoch.
    constexpr int N = kEpoch / G;   // rows a helper puts an epoch
    auto row_of = [&](int e, int j) {
      return (e + 1) * kEpoch + 1 + group + j * G;
    };
    float buf[3][N][3][C];
#pragma unroll
    for (int j = 0; j < N; ++j) load(buf[2][j], group + j * G);
#pragma unroll
    for (int j = 0; j < N; ++j) put(buf[2][j], group + j * G, group + j * G);
    if (group == 0) {
      load(buf[2][0], kEpoch);
      put(buf[2][0], kEpoch, kEpoch);
    }
    int put_slot[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      load(buf[0][j], row_of(0, j));
      load(buf[1][j], row_of(1, j));
      put_slot[j] = row_of(0, j) % diags;
    }
    bar_sync(2, blockDim.x);
    int next_store = group, store_slot = group;
    auto epoch = [&](float (&now)[N][3][C], float (&later)[N][3][C], int e) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        put(now[j], row_of(e, j), put_slot[j]);
        put_slot[j] = advance(put_slot[j], kEpoch);
      }
      for (; next_store <= e * kEpoch - u1; next_store += G) {
        store(next_store, store_slot);
        store_slot = advance(store_slot, G);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) load(later[j], row_of(e + 2, j));
      bar_sync(2, blockDim.x);
    };
    for (int e = 0; e < epochs; e += 3) {
      epoch(buf[0], buf[2], e);
      if (e + 1 < epochs) epoch(buf[1], buf[0], e + 1);
      if (e + 2 < epochs) epoch(buf[2], buf[1], e + 2);
    }
    for (; next_store < rows; next_store += G) {
      store(next_store, store_slot);
      store_slot = advance(store_slot, G);
    }
    return;
  }

  const int u = threadIdx.x;   // the thread's label position
  // the warp below's last cell (warp 0 reads its own slot, unused) and
  // this warp's, by parity; every lane reads, lane 0 takes it
  const float* const edge_in = &edge[0][warp > 0 ? warp - 1 : 0];
  float* const edge_out = &edge[0][warp];
  bar_sync(2, blockDim.x);
  float va = ring_a[u], vb = ring_b[u], vs = ring_s[u], v = kNegInf;
  int slot = 0;                     // d % D
  for (int d = 0; d < steps; ++d) {
    // diagonal d + 1's panel values, for the next step
    const int next = slot + 1 == diags ? 0 : slot + 1;
    const float na = ring_a[next * width + u];
    const float nb = ring_b[next * width + u];
    const float ns = ring_s[next * width + u];
    // diagonal d: cell (d - u, u); out[t, u-1] from the lane below, or
    // from the warp below's last lane
    const float below = edge_in[((d + 1) & 1) * kMaxWarps];
    float left = __shfl_up_sync(kFull, v, 1);
    if (lane == 0 && warp > 0) left = below;
    const int t = d - u;
    const float stay = t >= 1 ? v + va : kNegInf;
    const float move =
        (u >= 1 && (t >= 1 || !reverse)) ? left + vb : kNegInf;
    float x = logaddexp(stay, move);
    const bool live = t >= 0 && t < rows && u < u1;
    // the vote reads the seeds only, known a step ahead: off the chain
    if (__any_sync(kFull, live && !seed_is_low(vs)))
      x = seed_is_low(vs) ? seed_max(x, vs) : logaddexp(x, vs);
    else
      x = seed_max(x, vs);
    if (lane == 31) edge_out[(d & 1) * kMaxWarps] = x;
    if (live) ring_s[slot * width + u] = x;
    v = x;
    va = na;
    vb = nb;
    vs = ns;
    slot = next;
    if ((d + 1) % kEpoch == 0 || d + 1 == steps)
      bar_sync(2, blockDim.x);
    else
      bar_sync(1, compute);
  }
}

// Route B (see the note at the top): the first port's design.
__global__ void rnnt_lattice_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    const float* __restrict__ seed,
                                    float* __restrict__ out, int rows, int u1,
                                    int reverse) {
  extern __shared__ float diag[];   // two anti-diagonals of u1 values
  const size_t row = blockIdx.x;
  const int ab_rows = reverse ? rows - 1 : rows;
  a += row * ab_rows * u1;
  b += row * ab_rows * u1;
  seed += row * rows * u1;
  out += row * rows * u1;
  for (int d = 0; d < rows + u1 - 1; ++d) {
    const float* prev = diag + ((d + 1) & 1) * u1;
    float* cur = diag + (d & 1) * u1;
    const int lo = max(0, d - rows + 1), hi = min(u1 - 1, d);
    for (int u = lo + (int)threadIdx.x; u <= hi; u += blockDim.x) {
      const int t = d - u;
      // where cell (t, u) lies in out and seed, and where the weights of
      // its two incoming edges lie in a and b
      int cell, stay_at, move_at;
      if (reverse) {
        cell = stay_at = move_at = (rows - 1 - t) * u1 + (u1 - 1 - u);
      } else {
        cell = t * u1 + u;
        stay_at = cell - u1;
        move_at = cell - 1;
      }
      const float stay = t >= 1 ? prev[u] + a[stay_at] : kNegInf;
      const float move =
          (u >= 1 && (t >= 1 || !reverse)) ? prev[u - 1] + b[move_at] : kNegInf;
      const float val = logaddexp(logaddexp(stay, move), seed[cell]);
      cur[u] = val;
      out[cell] = val;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float occupancy(float alpha, float log_prob,
                                           float beta, float log_z) {
  const float x = ((alpha + log_prob) + beta) - log_z;
  return expf(fminf(fmaxf(x, kNegInf), 0.0f));
}

struct CellGrad {
  float d_blank, d_label, total, shift;
  int blank, label;
  bool softmax;
  __device__ __forceinline__ float at(int v, float x) const {
    float d = 0.0f;
    if (v == blank) d += d_blank;
    if (v == label) d += d_label;
    return softmax ? d - expf(x - shift) * total : d;
  }
};

template <bool VEC>
__global__ void rnnt_grad_kernel(
    const float* __restrict__ logits, const float* __restrict__ lse,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const float* __restrict__ log_z, const int* __restrict__ targets,
    const int* __restrict__ t_len, const int* __restrict__ u_len,
    const float* __restrict__ g, float* __restrict__ d_logits, int batch,
    int t_max, int u1, int v, int blank, int from_log_probs) {
  const int lane = threadIdx.x & 31;
  const long long cell =
      (long long)blockIdx.x * kGradWarps + (threadIdx.x >> 5);
  if (cell >= (long long)batch * t_max * u1) return;
  const int u = (int)(cell % u1);
  const int t = (int)((cell / u1) % t_max);
  const int bi = (int)(cell / ((long long)u1 * t_max));
  const float* x = logits + cell * v;
  float* dx = d_logits + cell * v;

  CellGrad cg;
  cg.d_blank = cg.d_label = cg.total = cg.shift = 0.0f;
  cg.blank = blank;
  cg.label = -1;
  cg.softmax = !from_log_probs;
  const bool in_time = t < t_len[bi];
  if (in_time && u <= u_len[bi]) {
    cg.shift = from_log_probs ? 0.0f : lse[cell];
    const float al = alpha[cell], lz = log_z[bi], gb = g[bi];
    const float* be = beta + ((long long)bi * (t_max + 1) + t) * u1 + u;
    const float occ_skip = occupancy(al, x[blank] - cg.shift, be[u1], lz);
    float occ_emit = 0.0f;
    if (u < u_len[bi]) {
      cg.label = targets[bi * (u1 - 1) + u];
      occ_emit = occupancy(al, x[cg.label] - cg.shift, be[1], lz);
    }
    cg.d_blank = -gb * occ_skip;
    cg.d_label = -gb * occ_emit;
    cg.total = -gb * (occ_skip + occ_emit);
  }
  const bool dead = cg.total == 0.0f;   // both posteriors 0: the row is 0

  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* dx4 = reinterpret_cast<float4*>(dx);
#pragma unroll 4
    for (int i = lane; i < v / 4; i += 32) {
      float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (!dead) {
        const float4 xi = x4[i];
        o.x = cg.at(4 * i, xi.x);
        o.y = cg.at(4 * i + 1, xi.y);
        o.z = cg.at(4 * i + 2, xi.z);
        o.w = cg.at(4 * i + 3, xi.w);
      }
      dx4[i] = o;
    }
  } else {
    for (int i = lane; i < v; i += 32) dx[i] = dead ? 0.0f : cg.at(i, x[i]);
  }
}

// The launch of `route` (0: A, 1: B) for u1: its kernel, dynamic shared
// memory and threads a block, and route A's ring diagonals (0 for B).
struct Instance {
  const void* kernel;
  size_t smem;
  int threads, ring;
};

Instance instance(int route, int u1) {
  if (route == 1)
    return {(const void*)rnnt_lattice_kernel, 2 * sizeof(float) * (size_t)u1,
            u1 >= 1024 ? 1024 : (u1 + 31) / 32 * 32, 0};
  const WarpGeometry g = warp_geometry(u1);
  return {(const void*)rnnt_lattice_warp_kernel, g.smem(), g.threads,
          g.diags};
}

bool takes(int batch, int rows, int u1, int reverse) {
  return batch > 0 && rows > 0 && u1 > 0 && !(reverse && rows < 2);
}

}  // namespace

// a, b, seed, out: contiguous f32 panels of `batch` rows. Forward
// (reverse = 0): all four are (rows, u1). Reverse: a and b are (rows - 1,
// u1), seed and out (rows, u1). svt_rnnt_lattice runs route A and takes
// u1 up to 128; svt_rnnt_lattice_block runs route B and takes any u1 whose
// two diagonals fit in shared memory. Each returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for what its kernel does not take.
extern "C" int svt_rnnt_lattice(const void* a, const void* b, const void* seed,
                                void* out, int batch, int rows, int u1,
                                int reverse, void* stream) {
  if (!takes(batch, rows, u1, reverse) || u1 > kWarpMaxU1)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err = svt::allow_smem(
      rnnt_lattice_warp_kernel, warp_geometry(kWarpMaxU1).smem(), configured);
  if (err != cudaSuccess) return (int)err;
  const Instance k = instance(0, u1);
  rnnt_lattice_warp_kernel<<<batch, k.threads, k.smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(seed), static_cast<float*>(out), rows, u1,
      reverse);
  return (int)cudaGetLastError();
}

extern "C" int svt_rnnt_lattice_block(const void* a, const void* b,
                                      const void* seed, void* out, int batch,
                                      int rows, int u1, int reverse,
                                      void* stream) {
  const Instance k = instance(1, u1);
  if (!takes(batch, rows, u1, reverse) || k.smem > kMaxShared)
    return (int)cudaErrorInvalidValue;
  if (k.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rnnt_lattice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)k.smem);
    if (err != cudaSuccess) return err;
  }
  rnnt_lattice_kernel<<<batch, k.threads, k.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(seed), static_cast<float*>(out), rows, u1,
      reverse);
  return (int)cudaGetLastError();
}

// out[3] = threads a block, dynamic shared memory bytes a block and ring
// diagonals (0 for route B) of the launch of `route` (0: A, 1: B) for u1:
// the wrapper's plan reads them here, so that it holds the numbers of the
// build it launches. Host arithmetic only.
extern "C" int svt_rnnt_lattice_plan(int route, int u1, int* out) {
  if ((route != 0 && route != 1) || u1 <= 0 || (route == 0 && u1 > kWarpMaxU1))
    return (int)cudaErrorInvalidValue;
  const Instance k = instance(route, u1);
  out[0] = k.threads;
  out[1] = (int)k.smem;
  out[2] = k.ring;
  return 0;
}

// out[5] = registers per thread, local memory bytes per thread (0 = no
// spills), dynamic shared memory bytes a block, threads a block and
// resident blocks per SM of the instantiation that `route` (0: A, 1: B)
// launches for u1.
extern "C" int svt_rnnt_lattice_attributes(int route, int u1, int* out) {
  if ((route != 0 && route != 1) || u1 <= 0 ||
      (route == 0 && u1 > kWarpMaxU1) ||
      (route == 1 && 2 * sizeof(float) * (size_t)u1 > kMaxShared))
    return (int)cudaErrorInvalidValue;
  const Instance k = instance(route, u1);
  // never below what a launch of this instantiation may take (as
  // launch_warp sets it for route A), 48 KB at least
  size_t cap = route == 0 ? warp_geometry(kWarpMaxU1).smem() : k.smem;
  if (cap < 48 * 1024) cap = 48 * 1024;
  cudaError_t err = cudaFuncSetAttribute(
      k.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cap);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k.kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.kernel,
                                                        k.threads, k.smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)k.smem;
  out[3] = k.threads;
  out[4] = blocks;
  return 0;
}

// logits, d_logits (batch, t_max, u1, v) f32; lse, alpha (batch, t_max, u1)
// f32 (lse unread with from_log_probs); beta (batch, t_max + 1, u1) f32;
// log_z, g (batch,) f32; targets (batch, u1 - 1) int32 in [0, v); t_len,
// u_len (batch,) int32; all contiguous. vec = 1 promises v % 4 == 0 and
// 16-byte aligned logits and d_logits.
extern "C" int svt_rnnt_grad(const void* logits, const void* lse,
                             const void* alpha, const void* beta,
                             const void* log_z, const void* targets,
                             const void* t_len, const void* u_len,
                             const void* g, void* d_logits, int batch,
                             int t_max, int u1, int v, int blank,
                             int from_log_probs, int vec, void* stream) {
  if (batch <= 0 || t_max <= 0 || u1 <= 0 || v <= 0 || blank < 0 ||
      blank >= v || (vec && v % 4))
    return (int)cudaErrorInvalidValue;
  const long long cells = (long long)batch * t_max * u1;
  const long long blocks = (cells + kGradWarps - 1) / kGradWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  auto kernel = vec ? rnnt_grad_kernel<true> : rnnt_grad_kernel<false>;
  kernel<<<(unsigned)blocks, kGradWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(lse),
      static_cast<const float*>(alpha), static_cast<const float*>(beta),
      static_cast<const float*>(log_z), static_cast<const int*>(targets),
      static_cast<const int*>(t_len), static_cast<const int*>(u_len),
      static_cast<const float*>(g), static_cast<float*>(d_logits), batch,
      t_max, u1, v, blank, from_log_probs);
  return (int)cudaGetLastError();
}
