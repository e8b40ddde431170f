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
// Design: 4 warps per block, each owning 16 rows of the block's 64-row tile
// (queries for dQ, keys for dK/dV), products on tile_mma.cuh's 16x8x16 tile
// (mma.sync for bf16 with f32 accumulation, full f32 FMAs for f32). A warp
// writes its dS (and P o M) rows to its own shared slab, then multiplies
// the slab by a transposed panel. Each block owns its output rows, so there
// are no atomics and no second pass. Rows of length 0 run no panel (dQ) or
// take the zero path (dK/dV): zero gradients, never NaN.
//
// Casts follow the TPU kernels: dS is rounded to the input dtype before
// dS K and dS^T Q (`ds.astype(k.dtype)`); dO V^T is exact in f32 either way
// (bf16 products are exact in f32); dV's product takes P o M in f32
// (`p_v.astype(do.dtype)` with dO already f32, `:280`, `:299-301`). For
// bf16 that f32 operand is split into bf16 hi + lo parts and run as two
// tensor-core products: 16 of P's 24 mantissa bits, where one bf16 operand
// would keep 8.
//
// What bounds it on the H100: per row, dQ does 6 and dK/dV 8 T^2 D flops
// against a few T x D tiles of bytes, so the work is the products and the
// exps/hashes of each score element; this simple kernel is limited by its
// shared-memory fragment reads (every mma reloads its fragments), as the
// forward. wgmma and register-resident P are the later improvements.
//
// Requirements as the forward: D = 16 or 64, unit stride on D, arbitrary
// (batch, head, time) strides, lengths int32 per batch clamped to Tk, lse
// and delta f32 (B*H, Tq) contiguous, f32 or bf16.
#include "flash_common.cuh"

namespace {

using svt::Dropout;
using svt::kThreads;
using svt::kTile;
using svt::Num;
using svt::Strides;
using svt::Tile;

__device__ __forceinline__ int clamp_len(const int* lengths, int b, int tk) {
  const int len = lengths == nullptr ? tk : lengths[b];
  return len < 0 ? 0 : (len > tk ? tk : len);
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V (64 x LDD each) + K^T (D x LDT) + dS slab (64 x LDT)
  return sizeof(T) * ((size_t)svt::ld_d<T, D>() * 4 * kTile +
                      (size_t)svt::ld_t<T>() * (D + kTile));
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ lengths,
    T* __restrict__ dq, int heads, int tq, int tk, Strides qs, Strides ks,
    Strides vs, Strides dos, Strides dqs, float scale, Dropout dr) {
  constexpr int LDD = svt::ld_d<T, D>();
  constexpr int LDT = svt::ld_t<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + kTile * LDD;
  T* sk = sdo + kTile * LDD;
  T* sv = sk + kTile * LDD;
  T* s_kt = sv + kTile * LDD;
  T* sds = s_kt + D * LDT;

  const int row = blockIdx.y;
  const int b = row / heads, h = row % heads;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const int len = clamp_len(lengths, b, tk);

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  svt::stage<T, D>(q + b * qs.b + h * qs.h, qs.t, q0, tq, sq, LDD, nullptr,
                   0);
  svt::stage<T, D>(dout + b * dos.b + h * dos.h, dos.t, q0, tq, sdo, LDD,
                   nullptr, 0);

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
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  const T* sq_w = sq + warp * 16 * LDD;
  const T* sdo_w = sdo + warp * 16 * LDD;
  T* sds_w = sds + warp * 16 * LDT;
  const int n_panels = (len + kTile - 1) / kTile;

  for (int pb = 0; pb < n_panels; ++pb) {
    const int k0 = pb * kTile;
    __syncthreads();  // previous panel fully consumed
    svt::stage<T, D>(kb, ks.t, k0, tk, sk, LDD, s_kt, LDT);
    svt::stage<T, D>(vb, vs.t, k0, tk, sv, LDD, nullptr, 0);
    __syncthreads();

#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kt = 0; kt < D / 16; ++kt) {
        Tile<T>::mma(s, sq_w + kt * 16, LDD, sk + nt * 8 * LDD + kt * 16, LDD,
                     lane);
        Tile<T>::mma(dp, sdo_w + kt * 16, LDD, sv + nt * 8 * LDD + kt * 16,
                     LDD, lane);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = nt * 8 + 2 * tq4 + (e & 1);
        const int col = k0 + c;
        const float p = col < len ? expf(s[e] * scale - lse_r[i]) : 0.0f;
        float dpv = dp[e];
        if constexpr (kDropout) dpv *= svt::keep(dr, hq[i], (uint32_t)col);
        const float ds = p * (dpv - delta_r[i]) * scale;
        sds_w[(i * 8 + g) * LDT + c] = Num<T>::from_f32(ds);
      }
    }
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int kt = 0; kt < kTile / 16; ++kt)
        Tile<T>::mma(acc[nt], sds_w + kt * 16, LDT,
                     s_kt + nt * 8 * LDT + kt * 16, LDT, lane);
    __syncwarp();
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + i * 8 + g;
    if (r >= tq) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dqb[r * dqs.t + nt * 8 + 2 * tq4 + e] =
            Num<T>::from_f32(acc[nt][i * 2 + e]);
  }
}

// bf16 keeps P o M for dV as two slabs (hi + lo); f32 as one
template <typename T>
__host__ __device__ constexpr int p_slabs() {
  return std::is_same<T, float>::value ? 1 : 2;
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  // L and Delta of the Q panel (64 f32 each) + K, V, Q, dO (64 x LDD each)
  // + Q^T, dO^T (D x LDT each) + P o M slab(s) and dS slab (64 x LDT each)
  return sizeof(float) * 2 * kTile +
         sizeof(T) * ((size_t)svt::ld_d<T, D>() * 4 * kTile +
                      (size_t)svt::ld_t<T>() *
                          (2 * D + (p_slabs<T>() + 1) * kTile));
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ lengths,
    T* __restrict__ dk, T* __restrict__ dv, int heads, int tq, int tk,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
    float scale, Dropout dr) {
  constexpr int LDD = svt::ld_d<T, D>();
  constexpr int LDT = svt::ld_t<T>();
  constexpr bool kSplit = p_slabs<T>() == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_lse = reinterpret_cast<float*>(smem_raw);
  float* s_delta = s_lse + kTile;
  T* sk = reinterpret_cast<T*>(s_delta + kTile);
  T* sv = sk + kTile * LDD;
  T* sq = sv + kTile * LDD;
  T* sdo = sq + kTile * LDD;
  T* s_qt = sdo + kTile * LDD;
  T* s_dot = s_qt + D * LDT;
  T* sp = s_dot + D * LDT;
  T* sds = sp + p_slabs<T>() * kTile * LDT;

  const int row = blockIdx.y;
  const int b = row / heads, h = row % heads;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int len = clamp_len(lengths, b, tk);
  T* dkb = dk + b * dks.b + h * dks.h;
  T* dvb = dv + b * dvs.b + h * dvs.h;

  if (k0 >= len) {  // every key of this tile is masked: zero gradients
    const T zero = Num<T>::from_f32(0.0f);
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = k0 + i / D, d = i % D;
      if (r >= tk) continue;
      dkb[r * dks.t + d] = zero;
      dvb[r * dvs.t + d] = zero;
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  svt::stage<T, D>(k + b * ks.b + h * ks.h, ks.t, k0, tk, sk, LDD, nullptr,
                   0);
  svt::stage<T, D>(v + b * vs.b + h * vs.h, vs.t, k0, tk, sv, LDD, nullptr,
                   0);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;

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
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.0f;

  const T* sk_w = sk + warp * 16 * LDD;
  const T* sv_w = sv + warp * 16 * LDD;
  T* sp_w = sp + warp * 16 * LDT;
  T* sp_lo_w = sp_w + kTile * LDT;  // bf16 only
  T* sds_w = sds + warp * 16 * LDT;
  const int n_q = (tq + kTile - 1) / kTile;

  for (int qb_i = 0; qb_i < n_q; ++qb_i) {
    const int q0 = qb_i * kTile;
    __syncthreads();  // previous Q panel fully consumed
    svt::stage<T, D>(qb, qs.t, q0, tq, sq, LDD, s_qt, LDT);
    svt::stage<T, D>(dob, dos.t, q0, tq, sdo, LDD, s_dot, LDT);
    for (int i = tid; i < kTile; i += kThreads) {
      const int r = q0 + i;
      s_lse[i] = r < tq ? lse[(long long)row * tq + r] : 0.0f;
      s_delta[i] = r < tq ? delta[(long long)row * tq + r] : 0.0f;
    }
    __syncthreads();

    // S^T and dP^T fragments: rows = this warp's keys, columns = queries
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float st[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dpt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kt = 0; kt < D / 16; ++kt) {
        Tile<T>::mma(st, sk_w + kt * 16, LDD, sq + nt * 8 * LDD + kt * 16,
                     LDD, lane);
        Tile<T>::mma(dpt, sv_w + kt * 16, LDD, sdo + nt * 8 * LDD + kt * 16,
                     LDD, lane);
      }
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
        const float p = valid ? expf(st[e] * scale - s_lse[ql]) : 0.0f;
        float mk = 1.0f;
        if constexpr (kDropout) mk = svt::keep(dr, hq[c], (uint32_t)key[i]);
        const float pv = p * mk;
        const float ds = p * (dpt[e] * mk - s_delta[ql]) * scale;
        const int at = (i * 8 + g) * LDT + ql;
        const T hi = Num<T>::from_f32(pv);
        sp_w[at] = hi;
        if constexpr (kSplit)
          sp_lo_w[at] = Num<T>::from_f32(pv - Num<T>::to_f32(hi));
        sds_w[at] = Num<T>::from_f32(ds);
      }
    }
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int kt = 0; kt < kTile / 16; ++kt) {
        const int off = nt * 8 * LDT + kt * 16;
        Tile<T>::mma(dv_acc[nt], sp_w + kt * 16, LDT, s_dot + off, LDT, lane);
        if constexpr (kSplit)
          Tile<T>::mma(dv_acc[nt], sp_lo_w + kt * 16, LDT, s_dot + off, LDT,
                       lane);
        Tile<T>::mma(dk_acc[nt], sds_w + kt * 16, LDT, s_qt + off, LDT, lane);
      }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = key[i];
    if (r >= tk) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nt * 8 + 2 * tq4 + e;
        dkb[r * dks.t + d] = Num<T>::from_f32(dk_acc[nt][i * 2 + e]);
        dvb[r * dvs.t + d] = Num<T>::from_f32(dv_acc[nt][i * 2 + e]);
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
    const dim3 grid((tq + kTile - 1) / kTile, batch * heads);
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
    const dim3 grid((tk + kTile - 1) / kTile, batch * heads);
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
