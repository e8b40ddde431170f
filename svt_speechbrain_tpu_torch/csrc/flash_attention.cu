// Attention forward with per-row key lengths (online softmax over K/V
// panels), one body behind three wrappers.
//
// Replaces three TPU kernels of svt_speechbrain_tpu/ops/flash_attention.py,
// all computing `_fwd_recurrence` (`:123-174`):
//   * `flash_attention_short` (`_flash_short_kernel`, `:563`): Tk <= 512,
//     the whole score tile of GROUP rows per program in VMEM;
//   * `flash_attention` forward, serving form (`_flash_kernel`, `:176`):
//     FlashAttention-2 streaming over K/V panels, panels past a row's length
//     skipped;
//   * `flash_attention` forward, training form (`_flash_kernel_lse`,
//     `:185`): the same recurrence, plus the per-row logsumexp L = m + log l
//     (or -1e30 where l = 0) that the backward programs rebuild P from, plus
//     the in-kernel attention dropout (`kDropout`).
// On the TPU the short and streaming kernels differ only to amortise grid
// overhead; on Hopper one body serves all three (`lse` null: no logsumexp).
//
// Per panel a warp forms S = Q K^T for its 16 query rows in f32, scales it,
// masks columns >= length with -1e30, updates the running max m and sum l
// (of the un-dropped P), rescales O by alpha = exp(m_old - m_new) and adds
// P V, P cast to the input dtype as the TPU kernel's `p.astype(v.dtype)`.
// Dropout comes after normalisation, as on the TPU: each thread knows the
// global (q, k) of every element of its S fragment (rows g and g + 8 of its
// warp's 16, columns 2t and 2t + 1 of each 8-wide n-tile), hashes them
// (flash_common.cuh) and multiplies P by the keep scale before P V, so out =
// (softmax(S) o M / (1 - p)) V exactly, panel by panel. Only ceil(length /
// panel) panels run: a row of length 0 runs none and writes zeros (l = 0,
// L = -1e30), never NaN and never a uniform mix.
//
// What bounds it on the H100: per row 4 Tq Tk D flops against q, k, v and
// out read or written once, so the products and the elementwise work of
// every score element (scale, mask, max, exp, sum, and with dropout an
// fmix32 hash) are the work, not HBM. At (8, 16, 1499, 64) the bound by
// route is 0.446 ms in f32 (three TF32 products per product at 495 TFLOP/s)
// and 0.074 ms in bf16 (989 TFLOP/s). The design, in the order of what it
// removes from the first version (f32 FMAs, a shared P slab, V transposed by
// scalar stores, synchronous staging with two barriers a panel):
//   1. f32 on the tensor cores: S and P V as three TF32 m16n8k8 products
//      per product (svt::mma_tf32x3). Each k step of S (8 over D) and each
//      panel's P V is summed in a fresh fragment and added in f32 (O
//      rescaled by alpha first): the tensor cores truncate the f32 sums
//      they form, so no chain longer than one panel runs inside them. S is
//      summed in the backward's order (flash_warp.cuh), so the forward's
//      and the dQ/dK/dV programs' S agree bit for bit. bf16 stays on
//      m16n8k16 with ldmatrix.
//   2. P in registers: the C fragment of S is the A fragment of P V (bf16:
//      pairs packed by pack_bf16; f32: the k index permuted, C's c0-c3 as
//      A's a0, a2, a1, a3).
//   3. V row-major, never transposed: bf16 B fragments by ldmatrix .trans;
//      f32 the row-major panel read in the permuted order; rows padded to
//      D + 4 floats or D + 8 bf16, both read patterns bank-conflict free.
//   4. Q fragments loaded once into registers (f32: split into TF32 big and
//      small once, 64 registers at D = 64) and held for the whole panel
//      loop: faster on the card than re-reading them from shared memory at
//      each panel (PERF.md).
//   5. K and V panels through a ring of `kStages` shared-memory stages by
//      16-byte cp.async: panel pb + 1 (and pb + 2) is in flight while panel
//      pb is computed, one barrier a panel.
//   6. Tiles (`Fwd<T>`): 4 warps a block, each owning 16 of the block's 64
//      query rows; panel rows, stages and resident blocks an SM chosen on an
//      H100 for no spills first, then time: f32 16-key panels, 2 stages, 2
//      blocks an SM (207-215 registers at D = 64; Q held: 64 of them);
//      bf16 32-key panels, 3 stages, 4 blocks (119-124 registers).
// Two cheaper elementwise steps, timed the same way: P by the fast exp
// (ex2.approx of x log2 e; f32 out stays 9.2e-7 from the plain version at
// (8, 16, 1499, 64), as with expf), and panels wholly below the length
// skip the mask. Together with the integer TF32 rounding (tile_mma.cuh)
// they took 3b from 2.08 to 1.71 ms in f32 and 0.56 to 0.50 ms in bf16.
// PERF.md keeps every variant timed; tools/tune_flash_forward.py rebuilds
// this file with other tiles (the SVT_FWD_* macros) and times them.
// chip_smoke.py phase 1 prints each instantiation's registers, shared
// memory and resident warps and holds it to no spills. Each block owns its
// output rows: the same bits on every run.
//
// Requirements: D = 64 (wav2vec2-large) or 16 (the CI-sized TINY_ARCH);
// q/k/v/out with unit stride on D and (batch, head, time) strides and base
// pointers of q, k and v that keep every row 16-byte aligned (the wrapper
// copies what does not); lengths int32 per batch (row r = b*H + h), clamped
// to Tk; lse (if given) f32 (B*H, Tq) contiguous; f32 or bf16 (f32
// accumulation for bf16).
#include "flash_common.cuh"
#include "flash_warp.cuh"

// The tiles by dtype: panel rows (a multiple of 16), ring stages, resident
// blocks an SM (__launch_bounds__).
#ifndef SVT_FWD_F32_PANEL
#define SVT_FWD_F32_PANEL 16
#endif
#ifndef SVT_FWD_F32_STAGES
#define SVT_FWD_F32_STAGES 2
#endif
#ifndef SVT_FWD_F32_BLOCKS
#define SVT_FWD_F32_BLOCKS 2
#endif
#ifndef SVT_FWD_BF16_PANEL
#define SVT_FWD_BF16_PANEL 32
#endif
#ifndef SVT_FWD_BF16_STAGES
#define SVT_FWD_BF16_STAGES 3
#endif
#ifndef SVT_FWD_BF16_BLOCKS
#define SVT_FWD_BF16_BLOCKS 4
#endif

namespace {

using svt::clamp_len;
using svt::Dropout;
using svt::kNegInf;
using svt::kRows;
using svt::kThreads;
using svt::row_width;
using svt::store2;
using svt::Strides;
using svt::Warp;

template <typename T>
struct Fwd;

template <>
struct Fwd<float> {
  static constexpr int kPanel = SVT_FWD_F32_PANEL;
  static constexpr int kStages = SVT_FWD_F32_STAGES;
  static constexpr int kBlocks = SVT_FWD_F32_BLOCKS;
};

template <>
struct Fwd<__nv_bfloat16> {
  static constexpr int kPanel = SVT_FWD_BF16_PANEL;
  static constexpr int kStages = SVT_FWD_BF16_STAGES;
  static constexpr int kBlocks = SVT_FWD_BF16_BLOCKS;
};

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  // Q (the block's tile) + kStages x (K, V) panels
  return sizeof(T) * (size_t)row_width<T, D>() *
         (kRows + Fwd<T>::kStages * 2 * Fwd<T>::kPanel);
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, Fwd<T>::kBlocks)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     T* __restrict__ out, float* __restrict__ lse, int heads,
                     int tq, int tk, Strides qs, Strides ks, Strides vs,
                     Strides os, float scale, Dropout dr) {
  constexpr int LD = row_width<T, D>();
  constexpr int kPanel = Fwd<T>::kPanel, kStages = Fwd<T>::kStages;
  constexpr int kPanelElems = kPanel * LD;
  constexpr int NT = kPanel / 8;
  static_assert(kPanel % 16 == 0 && kStages >= 2, "panel rows, stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* ring = sq + kRows * LD;  // stage s: K at ring + 2 s kPanelElems, V next

  const int row = blockIdx.y;
  const int b = row / heads, h = row % heads;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const int len = clamp_len(lengths, b, tk);
  const int n_panels = (len + kPanel - 1) / kPanel;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  auto fetch = [&](int pb) {  // K and V panel pb into its stage
    T* dst = ring + (pb % kStages) * 2 * kPanelElems;
    svt::cp_async_panel<T, D, kPanel, kThreads>(dst, LD, kb, ks.t,
                                                pb * kPanel, tk);
    svt::cp_async_panel<T, D, kPanel, kThreads>(dst + kPanelElems, LD, vb,
                                                vs.t, pb * kPanel, tk);
  };
  svt::cp_async_panel<T, D, kRows, kThreads>(sq, LD, q + b * qs.b + h * qs.h,
                                             qs.t, q0, tq);
  svt::cp_async_commit();
#pragma unroll
  for (int pb = 0; pb < kStages - 1; ++pb) {  // one group per panel
    if (pb < n_panels) fetch(pb);
    svt::cp_async_commit();
  }

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
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;

  typename Warp<T>::template Held<D> qf;  // the warp's 16 Q rows
  svt::cp_async_wait<kStages - 1>();       // Q (the panels may be in flight)
  __syncthreads();
  Warp<T>::template load_rows<D>(qf, sq + warp * 16 * LD, LD, lane);

  for (int pb = 0; pb < n_panels; ++pb) {
    svt::cp_async_wait<kStages - 2>();  // panel pb and Q
    __syncthreads();  // landed for all; panel pb - 1 is consumed, so its
    if (pb + kStages - 1 < n_panels) fetch(pb + kStages - 1);  // stage refills
    svt::cp_async_commit();
    const T* sk = ring + (pb % kStages) * 2 * kPanelElems;
    const T* sv = sk + kPanelElems;
    const int k0 = pb * kPanel;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    Warp<T>::template scores<D, NT>(s, qf, sk, LD, lane);

    // scale, mask (only a panel that reaches the length), running max
    // (row 0 = g, row 1 = g + 8)
    float mx[2] = {kNegInf, kNegInf};
    if (k0 + kPanel > len) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + 2 * tq4 + (e & 1);
          const float val = col < len ? s[nt][e] * scale : kNegInf;
          s[nt][e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
    }
    float alpha[2], m_new[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = __expf(m[i] - m_new[i]);
    }
    // P (un-dropped into l, dropped into the product), in registers
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m_new[e >> 1]);
        rs[e >> 1] += p;
        float pv = p;
        if constexpr (kDropout)
          pv *= svt::keep(dr, hq[e >> 1],
                          (uint32_t)(k0 + nt * 8 + 2 * tq4 + (e & 1)));
        s[nt][e] = pv;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    Warp<T>::template accumulate<D, NT, false>(o, s, sv, LD, lane);
  }
  svt::cp_async_wait<0>();

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + i * 8 + g;
    if (r >= tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(ob + r * os.t + dt * 8 + 2 * tq4, o[dt][2 * i] * inv,
             o[dt][2 * i + 1] * inv);
    if (lse != nullptr && tq4 == 0)
      lse[(long long)row * tq + r] =
          l[i] > 0.0f ? m[i] + logf(fmaxf(l[i], 1e-30f)) : kNegInf;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// (batch, head, time) axes; D (16 or 64) has unit stride. `lengths` may be
// null (every key valid); `lse` may be null (serving form: no logsumexp).
// The base pointers and strides of q, k and v keep rows 16-byte aligned.
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
    const dim3 grid((tq + kRows - 1) / kRows, batch * heads);
    flash_fwd_kernel<T, D, kDrop><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(lengths),
        static_cast<T*>(out), static_cast<float*>(lse), heads, tq, tk, qs, ks,
        vs, os, scale, dr);
    return cudaGetLastError();
  });
}

// out[4] = registers per thread, local memory bytes per thread (0 = no
// spills), dynamic shared memory bytes per block, resident blocks per SM,
// for the instantiation of (dtype, d, dropout).
extern "C" int svt_flash_attention_fwd_attributes(int dtype, int d,
                                                  int dropout, int* out) {
  return (int)svt::dispatch(dtype, d, dropout, [&](auto t, auto dd,
                                                   auto drop) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    constexpr bool kDrop = decltype(drop)::value;
    return svt::attributes(flash_fwd_kernel<T, D, kDrop>,
                           fwd_smem_bytes<T, D>(), out);
  });
}
