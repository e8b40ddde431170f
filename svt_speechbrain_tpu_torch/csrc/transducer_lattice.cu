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
// 128 lanes and transposed for that. None of the layout is kept here: a
// block owns one batch row, a thread one label position u, the previous
// anti-diagonal lives in shared memory (two buffers, one barrier a
// diagonal), and a[t-1, u] is read straight from the unskewed (rows, u1)
// panel. A block with fewer threads than u1 loops over u.
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
// What bounds it: nothing a roofline names. The four panels are a few MB;
// the time is rows + u1 - 1 dependent steps (829 at T 749, U 80), each a
// load from device memory with a stride of u1 - 1 floats between
// neighbouring threads, two logaddexp and a barrier, on as many SMs as the
// batch has rows (8 of 132). Loads of the next diagonal are not issued
// ahead. That is the simple design's known cost.
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

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxShared = 232448;
constexpr int kGradWarps = 8;     // lattice cells per block of the gradient

__device__ __forceinline__ float logaddexp(float x, float y) {
  return fmaxf(x, y) + log1pf(expf(-fabsf(x - y)));
}

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

}  // namespace

// a, b, seed, out: contiguous f32 panels of `batch` rows. Forward
// (reverse = 0): all four are (rows, u1). Reverse: a and b are (rows - 1,
// u1), seed and out (rows, u1). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int svt_rnnt_lattice(const void* a, const void* b, const void* seed,
                                void* out, int batch, int rows, int u1,
                                int reverse, void* stream) {
  const size_t bytes = 2 * sizeof(float) * (size_t)u1;
  if (batch <= 0 || rows <= 0 || u1 <= 0 || bytes > kMaxShared ||
      (reverse && rows < 2))
    return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rnnt_lattice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = u1 >= 1024 ? 1024 : (u1 + 31) / 32 * 32;
  rnnt_lattice_kernel<<<batch, threads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(seed), static_cast<float*>(out), rows, u1,
      reverse);
  return (int)cudaGetLastError();
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
