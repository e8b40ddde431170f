// Attention backward with per-row key lengths and in-kernel dropout: the
// two programs of the FlashAttention-2 backward.
//
// Replaces two TPU kernels of svt_speechbrain_tpu/ops/flash_attention.py
// (`_flash_bwd`, `:468`):
//   * `_flash_bwd_dq_kernel` (`:205`): dQ per (row, q-block), streaming the
//     K/V panels up to the row's length;
//   * `_flash_bwd_dkv_kernel` (`:253`): dK and dV per (row, k-block),
//     streaming every Q/dO panel (queries are not length-masked); a k-block
//     that starts at or past the length writes zeros.
// Both rebuild the probabilities from the forward's logsumexp,
// P = exp(S * scale - L) where the key is valid and exactly 0 elsewhere
// (an explicit select, never exp(-1e30 - L)), and regenerate the dropout
// mask M bit-identically from global (seed, row, q, k) coordinates
// (flash_common.cuh). With Delta = rowsum(dO o O) (computed outside, in
// f32): dP = (dO V^T) o M, dS = P o (dP - Delta) * scale,
// dQ = dS K, dK = dS^T Q, dV = (P o M)^T dO.
//
// Casts follow the TPU kernels: dS is rounded to the input dtype before
// dS K and dS^T Q (`ds.astype(k.dtype)`, `:244`, `:304`); dO V^T is exact in
// f32 either way; dV's product takes P o M in f32 (`:300`): in bf16 it is
// split into bf16 hi + lo parts and run as two products (16 of P's 24
// mantissa bits), in f32 it is the TF32 split below.
//
// What bounds it on the H100: per row, dQ does 6 and dK/dV 8 T^2 D flops
// against a few T x D tiles of bytes, so the products, and the exp and hash
// of every score element, are the work. The design:
//   * every product on the tensor cores (tile_mma.cuh; the warp-level
//     products, shared with the forward, in flash_warp.cuh): bf16 on
//     m16n8k16 with ldmatrix (.trans where the operand lies keyed by the
//     contraction index), f32 as three TF32 m16n8k8 products per product
//     (big.big + big.small + small.big, the 3xTF32 of CUTLASS's
//     OpMultiplyAddFastF32, the route PyTorch's memory-efficient SDPA
//     backward takes in f32);
//   * P and dS never leave registers: the C fragment of S (dQ) or S^T
//     (dK/dV), after the elementwise step, is the A fragment of the next
//     product (bf16: two n8 C tiles pack into one k16 A tile; tf32: the next
//     product's k index is permuted instead, see tile_mma.cuh);
//   * no transposed copies: the tf32 B operand is read straight from the
//     row-major panel, whose rows are padded to D + 4 floats: with a row
//     stride of 4 (mod 32) banks the A-style reads [g][t] and, with 2 x 68 =
//     8 (mod 32), the permuted reads [2t][g] hit 32 distinct banks (D = 16:
//     20 floats, the same residues); bf16 rows are padded to D + 8 so that
//     ldmatrix's eight 16-byte rows fall in distinct bank groups;
//   * the streamed panels (K, V for dQ; Q, dO with their L and Delta for
//     dK/dV) arrive through a ring of shared-memory stages by 16-byte
//     cp.async (4-byte for L and Delta, whose rows need not be 16-byte
//     aligned), one barrier a panel: panel i + 1 (and i + 2) is in flight
//     while panel i is computed. The block's own tile (Q, dO, or K, V) is
//     copied once;
//   * accuracy: the tensor cores truncate the f32 sums they form; with
//     the products of 1,499 keys chained inside them, dQ, dK and dV ended
//     1.8e-5 of their peak from the plain version (chip_smoke.py phase 2),
//     and a 2-layer training step broke its card-vs-CPU tolerance. Each k
//     step of S and dP and each panel's share of dQ, dK and dV is summed in
//     a fresh fragment and added with f32 adds (round to nearest).
// Tiles (`Bwd<T>`; chosen on an H100 among panels of 32 and 64 rows, 2 to 4
// stages and 2 to 4 blocks an SM, for no spills first, then time): 4 warps
// a block, each owning 16 rows of the block's 64-row tile; panels of 32
// rows; f32 2 stages, 3 dQ and 2 dK/dV blocks an SM; bf16 3 stages, 4 and
// 3 blocks. Shared memory a block (dQ / dK/dV): f32 69,632 / 70,144 B at
// D = 64 and 20,480 / 20,992 at D = 16; bf16 46,080 / 46,848 and 15,360 /
// 16,128. chip_smoke.py phase 1 prints each instantiation's registers and
// holds it to no spills and at least 8 resident warps an SM; PERF.md keeps
// the numbers. Each block owns its output rows: no atomics, no second pass,
// the same bits on every run. Rows of length 0 run no panel (dQ) or take
// the zero path (dK/dV): zero gradients, never NaN.
//
// Requirements: D = 16 or 64, unit stride on D, (batch, head, time) strides
// and base pointers of q, k, v and dO that keep every row 16-byte aligned
// (the wrapper checks), lengths int32 per batch clamped to Tk, lse and delta
// f32 (B*H, Tq) contiguous, f32 or bf16.
#include "flash_common.cuh"
#include "flash_warp.cuh"

namespace {

using svt::clamp_len;
using svt::Dropout;
using svt::kRows;
using svt::kThreads;
using svt::Num;
using svt::row_width;
using svt::store2;
using svt::Strides;
using svt::Warp;

// The tiles, by dtype (the source note has their cost): rows of a streamed
// panel, panels in the ring, resident blocks per SM of dQ and of dK/dV.
template <typename T>
struct Bwd;

template <>
struct Bwd<float> {
  static constexpr int kPanel = 32;
  static constexpr int kStages = 2;
  static constexpr int kDqBlocks = 3;
  static constexpr int kDkvBlocks = 2;
};

template <>
struct Bwd<__nv_bfloat16> {
  static constexpr int kPanel = 32;
  static constexpr int kStages = 3;
  static constexpr int kDqBlocks = 4;
  static constexpr int kDkvBlocks = 3;
};

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  // Q and dO (the block's tile) + kStages x (K, V) panels
  return sizeof(T) * (size_t)row_width<T, D>() *
         (2 * kRows + Bwd<T>::kStages * 2 * Bwd<T>::kPanel);
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, Bwd<T>::kDqBlocks)
    flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ lengths,
    T* __restrict__ dq, int heads, int tq, int tk, Strides qs, Strides ks,
    Strides vs, Strides dos, Strides dqs, float scale, Dropout dr) {
  constexpr int LD = row_width<T, D>();
  constexpr int kPanel = Bwd<T>::kPanel, kStages = Bwd<T>::kStages;
  constexpr int kPanelElems = kPanel * LD;
  constexpr int NT = kPanel / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + kRows * LD;
  T* ring = sdo + kRows * LD;  // stage s: K at ring + 2 s kPanelElems, V next

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
  svt::cp_async_panel<T, D, kRows, kThreads>(
      sdo, LD, dout + b * dos.b + h * dos.h, dos.t, q0, tq);
#pragma unroll
  for (int pb = 0; pb < kStages - 1; ++pb) {  // one group per panel
    if (pb < n_panels) fetch(pb);
    svt::cp_async_commit();
  }

  // this thread's two query rows (g, g + 8): L, Delta and the row hash;
  // rows past Tq have dO = 0 and Delta = 0, so their dS is 0
  float lse_r[2], delta_r[2];
  uint32_t hq[2] = {0u, 0u};
  const uint32_t h0 = kDropout ? svt::row_hash(dr, (uint32_t)row) : 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + i * 8 + g;
    lse_r[i] = r < tq ? lse[(long long)row * tq + r] : 0.0f;
    delta_r[i] = r < tq ? delta[(long long)row * tq + r] : 0.0f;
    if constexpr (kDropout) hq[i] = svt::query_hash(h0, (uint32_t)r);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  const T* sq_w = sq + warp * 16 * LD;
  const T* sdo_w = sdo + warp * 16 * LD;

  for (int pb = 0; pb < n_panels; ++pb) {
    svt::cp_async_wait<kStages - 2>();  // panel pb and the block's tile
    __syncthreads();  // landed for all; panel pb - 1 is consumed, so its
    if (pb + kStages - 1 < n_panels) fetch(pb + kStages - 1);  // stage refills
    svt::cp_async_commit();
    const T* sk = ring + (pb % kStages) * 2 * kPanelElems;
    const T* sv = sk + kPanelElems;
    const int k0 = pb * kPanel;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
    Warp<T>::template scores<D, NT>(s, sq_w, sk, LD, lane);
    Warp<T>::template scores<D, NT>(dp, sdo_w, sv, LD, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = k0 + nt * 8 + 2 * tq4 + (e & 1);
        const float p = col < len ? expf(s[nt][e] * scale - lse_r[i]) : 0.0f;
        float dpv = dp[nt][e];
        if constexpr (kDropout) dpv *= svt::keep(dr, hq[i], (uint32_t)col);
        s[nt][e] = p * (dpv - delta_r[i]) * scale;  // dS, in registers
      }
    Warp<T>::template accumulate<D, NT, false>(acc, s, sk, LD, lane);
  }
  svt::cp_async_wait<0>();

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + i * 8 + g;
    if (r >= tq) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(dqb + r * dqs.t + dt * 8 + 2 * tq4, acc[dt][2 * i],
             acc[dt][2 * i + 1]);
  }
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  // kStages x (L, Delta) of a Q panel + K, V (the block's tile) + kStages x
  // (Q, dO) panels
  constexpr int kPanel = Bwd<T>::kPanel, kStages = Bwd<T>::kStages;
  return sizeof(float) * kStages * 2 * kPanel +
         sizeof(T) * (size_t)row_width<T, D>() *
             (2 * kRows + kStages * 2 * kPanel);
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, Bwd<T>::kDkvBlocks)
    flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ lengths,
    T* __restrict__ dk, T* __restrict__ dv, int heads, int tq, int tk,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
    float scale, Dropout dr) {
  constexpr int LD = row_width<T, D>();
  constexpr int kPanel = Bwd<T>::kPanel, kStages = Bwd<T>::kStages;
  constexpr int kPanelElems = kPanel * LD;
  constexpr int NT = kPanel / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_rows = reinterpret_cast<float*>(smem_raw);  // stage s: L, Delta
  T* sk = reinterpret_cast<T*>(s_rows + kStages * 2 * kPanel);
  T* sv = sk + kRows * LD;
  T* ring = sv + kRows * LD;  // stage s: Q at ring + 2 s kPanelElems, dO next

  const int row = blockIdx.y;
  const int b = row / heads, h = row % heads;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int len = clamp_len(lengths, b, tk);
  T* dkb = dk + b * dks.b + h * dks.h;
  T* dvb = dv + b * dvs.b + h * dvs.h;

  if (k0 >= len) {  // every key of this tile is masked: zero gradients
    const T zero = Num<T>::from_f32(0.0f);
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = k0 + i / D, d = i % D;
      if (r >= tk) continue;
      dkb[r * dks.t + d] = zero;
      dvb[r * dvs.t + d] = zero;
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const float* lse_b = lse + (long long)row * tq;
  const float* delta_b = delta + (long long)row * tq;
  const int n_panels = (tq + kPanel - 1) / kPanel;

  auto fetch = [&](int pb) {  // Q, dO, L and Delta of panel pb
    const int stage = pb % kStages, q0 = pb * kPanel;
    T* dst = ring + stage * 2 * kPanelElems;
    svt::cp_async_panel<T, D, kPanel, kThreads>(dst, LD, qb, qs.t, q0, tq);
    svt::cp_async_panel<T, D, kPanel, kThreads>(dst + kPanelElems, LD, dob,
                                                dos.t, q0, tq);
    float* rows = s_rows + stage * 2 * kPanel;
    for (int i = tid; i < 2 * kPanel; i += kThreads) {
      const int r = i % kPanel;
      const bool valid = q0 + r < tq;
      svt::cp_async4(rows + i,
                     (i < kPanel ? lse_b : delta_b) + (valid ? q0 + r : 0),
                     valid);
    }
  };
  svt::cp_async_panel<T, D, kRows, kThreads>(sk, LD, k + b * ks.b + h * ks.h,
                                             ks.t, k0, tk);
  svt::cp_async_panel<T, D, kRows, kThreads>(sv, LD, v + b * vs.b + h * vs.h,
                                             vs.t, k0, tk);
#pragma unroll
  for (int pb = 0; pb < kStages - 1; ++pb) {  // one group per panel
    if (pb < n_panels) fetch(pb);
    svt::cp_async_commit();
  }

  // this thread's two key rows (g, g + 8 of the warp's 16)
  int key[2];
  bool kvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + i * 8 + g;
    kvalid[i] = key[i] < len;
  }
  const uint32_t h0 = kDropout ? svt::row_hash(dr, (uint32_t)row) : 0u;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.0f;

  const T* sk_w = sk + warp * 16 * LD;
  const T* sv_w = sv + warp * 16 * LD;

  for (int pb = 0; pb < n_panels; ++pb) {
    svt::cp_async_wait<kStages - 2>();  // panel pb and the block's tile
    __syncthreads();  // landed for all; panel pb - 1 is consumed, so its
    if (pb + kStages - 1 < n_panels) fetch(pb + kStages - 1);  // stage refills
    svt::cp_async_commit();
    const int stage = pb % kStages, q0 = pb * kPanel;
    const T* sq = ring + stage * 2 * kPanelElems;
    const T* sdo = sq + kPanelElems;
    const float* s_lse = s_rows + stage * 2 * kPanel;
    const float* s_delta = s_lse + kPanel;

    // S^T and dP^T fragments: rows = this warp's keys, columns = queries
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
    Warp<T>::template scores<D, NT>(st, sk_w, sq, LD, lane);
    Warp<T>::template scores<D, NT>(dpt, sv_w, sdo, LD, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t hq[2] = {0u, 0u};
      if constexpr (kDropout) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          hq[c] = svt::query_hash(h0, (uint32_t)(q0 + nt * 8 + 2 * tq4 + c));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = e & 1;
        const int ql = nt * 8 + 2 * tq4 + c;
        const bool valid = kvalid[i] && q0 + ql < tq;
        const float p = valid ? expf(st[nt][e] * scale - s_lse[ql]) : 0.0f;
        float mk = 1.0f;
        if constexpr (kDropout) mk = svt::keep(dr, hq[c], (uint32_t)key[i]);
        st[nt][e] = p * mk;  // P o M, in registers
        dpt[nt][e] = p * (dpt[nt][e] * mk - s_delta[ql]) * scale;  // dS
      }
    }
    Warp<T>::template accumulate<D, NT, true>(dv_acc, st, sdo, LD, lane);
    Warp<T>::template accumulate<D, NT, false>(dk_acc, dpt, sq, LD, lane);
  }
  svt::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = key[i];
    if (r >= tk) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int d = dt * 8 + 2 * tq4;
      store2(dkb + r * dks.t + d, dk_acc[dt][2 * i], dk_acc[dt][2 * i + 1]);
      store2(dvb + r * dvs.t + d, dv_acc[dt][2 * i], dv_acc[dt][2 * i + 1]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// (batch, head, time) axes; D (16 or 64) has unit stride. `lengths` may be
// null. lse and delta are f32 (B*H, Tq) contiguous. dropout != 0 applies
// the hash mask of (seed, thresh, keep_scale). Each returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unsupported dtype or D.
extern "C" int svt_flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lengths, void* dq,
    int batch, int heads, int tq, int tk, int d, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, long long dosb, long long dosh,
    long long dost, long long dqsb, long long dqsh, long long dqst,
    float scale, int dropout, unsigned int seed, unsigned int thresh,
    float keep_scale, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst},
      dos{dosb, dosh, dost}, dqs{dqsb, dqsh, dqst};
  const Dropout dr{seed, thresh, keep_scale};
  auto st = static_cast<cudaStream_t>(stream);
  return (int)svt::dispatch(dtype, d, dropout, [&](auto t, auto dd,
                                                   auto drop) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    constexpr bool kDrop = decltype(drop)::value;
    static bool configured = false;
    const size_t smem = dq_smem_bytes<T, D>();
    const cudaError_t err =
        svt::allow_smem(flash_bwd_dq_kernel<T, D, kDrop>, smem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((tq + kRows - 1) / kRows, batch * heads);
    flash_bwd_dq_kernel<T, D, kDrop><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(lengths), static_cast<T*>(dq), heads, tq, tk,
        qs, ks, vs, dos, dqs, scale, dr);
    return cudaGetLastError();
  });
}

extern "C" int svt_flash_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lengths, void* dk,
    void* dv, int batch, int heads, int tq, int tk, int d, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, long long dosb,
    long long dosh, long long dost, long long dksb, long long dksh,
    long long dkst, long long dvsb, long long dvsh, long long dvst,
    float scale, int dropout, unsigned int seed, unsigned int thresh,
    float keep_scale, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst},
      dos{dosb, dosh, dost}, dks{dksb, dksh, dkst}, dvs{dvsb, dvsh, dvst};
  const Dropout dr{seed, thresh, keep_scale};
  auto st = static_cast<cudaStream_t>(stream);
  return (int)svt::dispatch(dtype, d, dropout, [&](auto t, auto dd,
                                                   auto drop) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    constexpr bool kDrop = decltype(drop)::value;
    static bool configured = false;
    const size_t smem = dkv_smem_bytes<T, D>();
    const cudaError_t err =
        svt::allow_smem(flash_bwd_dkv_kernel<T, D, kDrop>, smem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((tk + kRows - 1) / kRows, batch * heads);
    flash_bwd_dkv_kernel<T, D, kDrop><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(lengths), static_cast<T*>(dk),
        static_cast<T*>(dv), heads, tq, tk, qs, ks, vs, dos, dks, dvs, scale,
        dr);
    return cudaGetLastError();
  });
}

// kernel: 0 = dQ, 1 = dK/dV; out[4] = registers per thread, local memory
// bytes per thread, dynamic shared memory bytes per block, resident blocks
// per SM, for the instantiation of (dtype, d, dropout).
extern "C" int svt_flash_attention_bwd_attributes(int kernel, int dtype, int d,
                                                  int dropout, int* out) {
  return (int)svt::dispatch(dtype, d, dropout, [&](auto t, auto dd,
                                                   auto drop) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    constexpr bool kDrop = decltype(drop)::value;
    if (kernel == 0)
      return svt::attributes(flash_bwd_dq_kernel<T, D, kDrop>,
                        dq_smem_bytes<T, D>(), out);
    return svt::attributes(flash_bwd_dkv_kernel<T, D, kDrop>,
                      dkv_smem_bytes<T, D>(), out);
  });
}
