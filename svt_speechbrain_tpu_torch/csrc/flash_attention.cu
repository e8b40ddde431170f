// Attention forward with per-row key lengths (online softmax over K/V
// panels), one body behind three wrappers.
//
// Replaces three TPU kernels of svt_speechbrain_tpu/ops/flash_attention.py:
//   * `flash_attention_short` (`_flash_short_kernel`): Tk <= 512, the whole
//     score tile of GROUP rows per program in VMEM;
//   * `flash_attention` forward, serving form (`_flash_kernel` /
//     `_fwd_recurrence`): FlashAttention-2 streaming over K/V panels, panels
//     past a row's length skipped;
//   * `flash_attention` forward, training form (`_flash_kernel_lse`): the
//     same recurrence, plus the per-row logsumexp L = m + log l (or -1e30
//     where l = 0) that the backward programs rebuild P from, plus the
//     in-kernel attention dropout (`kDropout`).
// On the TPU the short and streaming kernels differ only to amortise grid
// overhead; on Hopper one body serves both.
//
// Design: one block per (batch*head row, 64-query tile), 4 warps, each
// owning 16 query rows. Q is staged once; K and V^T panels of 64 keys are
// streamed through shared memory (an f32 512 x 64 K plus V pair is 256 KB,
// more than a block's 227 KB, so panels are streamed for every Tk). Per
// panel a warp forms S = Q K^T in f32 accumulators (mma.sync for bf16, f32
// FMAs for f32), scales, masks columns >= length with -1e30, updates the
// running max and sum, writes P (in the input dtype, as the TPU kernel's
// `p.astype(v.dtype)`) to its own shared slab and accumulates O += P V.
// Only ceil(length / 64) panels run, so a row of length 0 runs none and
// writes zeros (l = 0, L = -1e30), never NaN and never a uniform mix.
//
// Dropout (after normalisation, as on the TPU): each thread knows the global
// (q, k) of every element of its accumulator fragment (rows g and g + 8 of
// its warp's 16, columns 2t and 2t + 1 of each 8-wide n-tile), hashes them
// (flash_common.cuh) and multiplies the un-normalised P by the keep scale
// before writing the P slab; the running sum l keeps the un-dropped P, so
// out = (softmax(S) o M / (1 - p)) V exactly, panel by panel.
//
// What bounds it on the H100: at the main-path shapes (T = 249 or 1499,
// D = 64) the products are small (4 T^2 D flops per row) and so are the
// bytes (q, k, v, out once each); this simple kernel is limited by its
// shared-memory fragment reads and by exp throughput (and, with dropout,
// by the three fmix32 of each score), not by HBM. Using P straight from
// registers and wgmma are the later improvements.
//
// Requirements: D = 64 (wav2vec2-large) or 16 (the CI-sized TINY_ARCH);
// q/k/v/out with unit stride on D and arbitrary (batch, head, time)
// strides; lengths int32 per batch (row r = b*H + h), clamped to Tk;
// lse (if given) f32 (B*H, Tq) contiguous; f32 or bf16 (f32 accumulation
// for bf16, full f32 for f32).
#include "flash_common.cuh"

namespace {

using svt::Dropout;
using svt::kNegInf;
using svt::kThreads;
using svt::kTile;
using svt::Strides;

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  // Q (64 x LDD) + K (64 x LDD) + V^T (D x LDT) + P (64 x LDT)
  return sizeof(T) * ((size_t)svt::ld_d<T, D>() * 2 * kTile +
                      (size_t)svt::ld_t<T>() * (D + kTile));
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     T* __restrict__ out, float* __restrict__ lse, int heads,
                     int tq, int tk, Strides qs, Strides ks, Strides vs,
                     Strides os, float scale, Dropout dr) {
  constexpr int LDD = svt::ld_d<T, D>();
  constexpr int LDT = svt::ld_t<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kTile * LDD;
  T* s_vt = sk + kTile * LDD;
  T* sp = s_vt + D * LDT;

  const int row = blockIdx.y;
  const int b = row / heads, h = row % heads;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;

  int len = lengths == nullptr ? tk : lengths[b];
  len = len < 0 ? 0 : (len > tk ? tk : len);

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  svt::stage<T, D>(q + b * qs.b + h * qs.h, qs.t, q0, tq, sq, LDD, nullptr,
                   0);

  // this thread's two query rows: g and g + 8 of the warp's 16
  uint32_t hq[2] = {0u, 0u};
  if constexpr (kDropout) {
    const uint32_t h0 = svt::row_hash(dr, (uint32_t)row);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hq[i] = svt::query_hash(h0, (uint32_t)(q0 + warp * 16 + i * 8 + g));
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;

  T* sp_w = sp + warp * 16 * LDT;
  const T* sq_w = sq + warp * 16 * LDD;
  const int n_panels = (len + kTile - 1) / kTile;

  for (int pb = 0; pb < n_panels; ++pb) {
    const int k0 = pb * kTile;
    __syncthreads();  // Q staged / previous panel fully consumed
    svt::stage<T, D>(kb, ks.t, k0, tk, sk, LDD, nullptr, 0);
    svt::stage<T, D>(vb, vs.t, k0, tk, nullptr, 0, s_vt, LDT);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < D / 16; ++kt)
        svt::Tile<T>::mma(s[nt], sq_w + kt * 16, LDD,
                          sk + nt * 8 * LDD + kt * 16, LDD, lane);
    }

    // scale, mask, running max (row 0 = g, row 1 = g + 8)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * tq4 + (e & 1);
        const float val = col < len ? s[nt][e] * scale : kNegInf;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], m_new[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tq4 + (e & 1);
        const float p = expf(s[nt][e] - m_new[e >> 1]);
        rs[e >> 1] += p;
        float pv = p;
        if constexpr (kDropout)
          pv *= svt::keep(dr, hq[e >> 1], (uint32_t)(k0 + c));
        sp_w[((e >> 1) * 8 + g) * LDT + c] = svt::Num<T>::from_f32(pv);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int kt = 0; kt < kTile / 16; ++kt)
        svt::Tile<T>::mma(o[nt], sp_w + kt * 16, LDT,
                          s_vt + nt * 8 * LDT + kt * 16, LDT, lane);
    __syncwarp();
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + i * 8 + g;
    if (r >= tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ob[r * os.t + nt * 8 + 2 * tq4 + e] =
            svt::Num<T>::from_f32(o[nt][i * 2 + e] * inv);
    if (lse != nullptr && tq4 == 0)
      lse[(long long)row * tq + r] =
          l[i] > 0.0f ? m[i] + logf(fmaxf(l[i], 1e-30f)) : kNegInf;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// (batch, head, time) axes; D (16 or 64) has unit stride. `lengths` may be
// null (every key valid); `lse` may be null (serving form: no logsumexp).
// dropout != 0 applies the hash mask of (seed, thresh, keep_scale).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// an unsupported dtype or D.
extern "C" int svt_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* lengths, void* out, void* lse, int batch, int heads, int tq,
    int tk, int d, long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, float scale, int dropout,
    unsigned int seed, unsigned int thresh, float keep_scale, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst},
      os{osb, osh, ost};
  const Dropout dr{seed, thresh, keep_scale};
  auto st = static_cast<cudaStream_t>(stream);
  return (int)svt::dispatch(dtype, d, dropout, [&](auto t, auto dd,
                                                   auto drop) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    constexpr bool kDrop = decltype(drop)::value;
    static bool configured = false;
    const size_t smem = fwd_smem_bytes<T, D>();
    const cudaError_t err =
        svt::allow_smem(flash_fwd_kernel<T, D, kDrop>, smem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((tq + kTile - 1) / kTile, batch * heads);
    flash_fwd_kernel<T, D, kDrop><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(lengths),
        static_cast<T*>(out), static_cast<float*>(lse), heads, tq, tk, qs, ks,
        vs, os, scale, dr);
    return cudaGetLastError();
  });
}
