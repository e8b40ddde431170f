// Fused per-token int8 quantization + s8 x s8 -> s32 matrix product (a8w8).
//
//   amax[m]  = max_k |float(x[m, k])|
//   scale[m] = max(amax[m], 1e-8) / 127                  (true f32 division)
//   x8[m, k] = clip(rint(float(x[m, k]) / scale[m]), -127, 127)
//              (true division, round half to even)
//   out[m, n] = O((float(sum_k x8[m, k] * w8[k, n]) * scale[m]) * w_scale[n])
//
// x is T, out is O (float or bfloat16 each): the epilogue is in f32 and
// writes O directly, so an f32 result of bf16 input is never rounded to bf16.
//
// Replaces the TPU kernel svt_speechbrain_tpu/ops/quant.py `int8_matmul_fused`
// (`_qmm_kernel`, `pallas_call` at `:168`). That kernel's grid runs in order:
// it quantizes a 256-row block of x into VMEM scratch on the first column
// block and reuses it for every later one. On Hopper blocks run in no order
// and share nothing but a cluster, and 128 rows of x8 at K 4096 (512 KB) do
// not fit in one block's shared memory.
//
// Design (tiles chosen on an H100 with tools/tune_int8_matmul.py, PERF.md
// section 6). A block owns 128 rows x 128 columns and multiplies on
// `wgmma.mma_async.m64n128k32.s32.s8.s8`: two warpgroups of 64 rows, both
// operands K-major in shared memory in the 128-byte swizzle (a slab is 128
// k of each row, one swizzled row), s32 sums that cannot overflow below
// kMaxK. The blocks of a cluster (8 where N / 128 allows, else 4, 2, 1) lie
// along N and share their row block: each quantizes its share K / cluster
// of the 128 rows, the shares' partial amax go to every block through
// distributed shared memory (so the whole row's amax is known before any
// element is quantized; max is exact in any order), and each share goes,
// already swizzled, to a scratch in device memory from which every block
// of the cluster then streams whole 16 KB slabs. A 3-stage ring takes the
// int8 slab and the weight slab by 16-byte cp.async, one slab ahead of the
// one multiplied, one barrier a slab; a slab's MMAs run while the next is
// staged. The epilogue applies the f32 order above from the tile's w_scale
// (loaded once) and writes each warp's 16 rows through the drained ring as
// 16-byte stores of whole rows. 104,448 bytes of shared memory and at most
// 128 registers: two blocks an SM, so 30 clusters of 8 are resident.
//
// What bounds it on the H100 (2 M K N against 1,979 TOP/s, bytes once
// against 3.35 TB/s, M = 1992): operations at ffn1 (K 1024, N 4096) and
// ffn2 (K 4096, N 1024), 8.4 us each; bytes at feat_proj (K 512, N 1024,
// 2.0 us) and at the attention projections (K 1024, N 1024, 2.7 us). L2
// traffic a call at these tiles, bf16: the weights once a row block, 67 MB
// at ffn1 and ffn2 (8.4 at feat_proj, 16.8 at the attention projections);
// x in bf16 once a group of 8 column tiles, 16.3 MB at ffn1 (4 groups) and
// 28.6 at ffn2 (one group, read 1.75 times: the first 16 chunks of a row's
// share stay in registers between the amax and the quantize pass), its
// int8 copy written once a group (8.2 MB) and read once a column tile (65
// MB at ffn1 and ffn2). Against the limits of the design before (mma.sync
// on 32- or 64-row blocks holding their int8 rows at full K):
//   * weights re-read for every 32 or 64 rows (134 and 264 MB): 128-row
//     blocks halve or quarter that;
//   * x read twice by every column group (65 and 130 MB): x is quantized
//     once for eight column tiles; the int8 rows it streams instead are
//     half the bytes of bf16;
//   * a serial prologue with one IEEE division per element: the eight
//     blocks of a cluster quantize an eighth of K each, and `quantize`
//     takes the division only where a reciprocal multiply could round
//     otherwise. The quantization is still a prologue to the products
//     (about 40% of the time at ffn2, PERF.md), the main remaining cost;
//   * mma.sync fed from shared memory, two barriers a slab: wgmma reads the
//     swizzled ring, one barrier a slab;
//   * w_scale loaded for every element, 4- or 8-byte stores: once a block,
//     16-byte stores of whole rows.
// Measured and dropped (PERF.md keeps the numbers): rank 0 multicasting
// each int8 slab to the cluster by bulk copy (the blocks wait on the
// slowest one's release every slab), 128 x 256 tiles, a deeper ring at one
// block an SM (15 clusters of 8 fit, ffn2 needs 16), 64-byte slabs with a
// 6-stage ring, L2 prefetch of x and of the weights, the quantization
// staged through shared memory by cp.async, the later slabs of a share
// quantized inside the product loop (it spills at two blocks an SM).
// ffn1's 64 clusters run in three rounds of 30.
//
// Contract: K and N multiples of 128, K at most 133,120 (|sum| <= 127^2 K
// stays below 2^31, so s32 needs no saturation); any M >= 1; x, w8t, out
// and the scratch contiguous and 16-byte aligned; x and out f32 or bf16;
// w_scale f32 or bf16. One launch a call, on the caller's stream; nothing
// allocated here. Built without -use_fast_math: the divisions and the
// rounding are IEEE.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

// the ring's stages and how many slabs are in flight ahead of the one
// multiplied (chosen on an H100 with tools/tune_int8_matmul.py, PERF.md);
// SVT_Q8_DIVIDE 1 quantizes every element by the true division (see
// `quantize`)
#ifndef SVT_Q8_STAGES
#define SVT_Q8_STAGES 3
#endif
#ifndef SVT_Q8_AHEAD
#define SVT_Q8_AHEAD 1
#endif
#ifndef SVT_Q8_DIVIDE
#define SVT_Q8_DIVIDE 0
#endif

// SVT_Q8_TRACE 1 (tools/tune_int8_matmul.py --trace) records each block's
// SM and the global timer at its start, after the quantization, after the
// products and at its end, read back by svt_int8_matmul_trace.
#ifndef SVT_Q8_TRACE
#define SVT_Q8_TRACE 0
#endif
#if SVT_Q8_TRACE
constexpr int kTraceBlocks = 4096;
__device__ unsigned long long svt_q8_trace[kTraceBlocks][5];
#endif

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ void trace(int slot) {
#if SVT_Q8_TRACE
  if (threadIdx.x == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (b < kTraceBlocks) {
      svt_q8_trace[b][slot] = t;
      if (slot == 0) {
        unsigned int sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        svt_q8_trace[b][4] = sm;
      }
    }
  }
#endif
}

constexpr int kThreads = 256;  // two warpgroups of 64 rows each
constexpr int kBM = 128;       // rows a block
constexpr int kBN = 128;       // columns a block
constexpr int kBK = 128;       // k a slab: one 128-byte swizzled row
constexpr int kStages = SVT_Q8_STAGES, kAhead = SVT_Q8_AHEAD;
constexpr int kSlabA = kBM * kBK;            // bytes of a slab's int8 rows
constexpr int kSlab = kSlabA + kBN * kBK;    // and of its W^T rows
constexpr int kMaxK = 133120;  // 127 * 127 * kMaxK < 2^31
constexpr int kMaxCluster = 8;
static_assert(kAhead >= 1 && kAhead <= kStages - 2, "ring");


// 1024 for the ring's alignment | ring | partial amax of every rank and the
// row scales (kBM each), the tile's w_scale (kBN), f32
constexpr size_t kSmem =
    1024 + (size_t)kStages * kSlab + 4 * ((kMaxCluster + 1) * kBM + kBN);

// bytes of one warp's staged output row: 8 elements of padding put the
// fragment stores of a warp on distinct banks
template <typename T>
__host__ __device__ constexpr int staged_row_bytes() {
  return (kBN + 8) * (int)sizeof(T);
}

// 16 bytes of a row as floats, and its int8 once quantized
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kN = 4;
  using Packed = uint32_t;
  static __device__ __forceinline__ void unpack(const uint4& u, float v[kN]) {
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ Packed pack(const uint32_t (&w)[1]) {
    return w[0];
  }
  static __device__ __forceinline__ void store2(void* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Packed = uint2;
  static __device__ __forceinline__ void unpack(const uint4& u, float v[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Packed pack(const uint32_t (&w)[2]) {
    return make_uint2(w[0], w[1]);
  }
  static __device__ __forceinline__ void store2(void* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// The integer of x / s without a division wherever that is exact. y =
// fl(x * r) with r = fl(1 / s); the reference's quotient is q = fl(x / s).
// |x| <= amax gives |x / s| <= 127 (1 + 2^-23), and r, the product and q
// each add a relative error of at most 2^-24, so |y - q| < 3 * 128 * 2^-24
// < 2^-15 (below the normal range both lie within 2^-149 of x / s). Where y
// lies more than 2^-14 from every half-integer, q lies on the same side of
// each and is no tie, so rint(q) = rint(y). Elsewhere (exact ties such as
// x = s / 2 among them) and for non-finite values the chunk takes the true
// division, as the reference does. rint(y) comes from adding 1.5 * 2^23,
// which rounds |y| < 2^22 to an integer, half to even, whose low byte is the
// int8 in two's complement; the fast path's |y| < 127.5 needs no clip. The
// _rn intrinsics keep the compiler from fusing the multiply and the add.
// SVT_Q8_DIVIDE 1 takes the true division for every element.
constexpr float kMagic = 12582912.0f;            // 1.5 * 2^23
constexpr float kFar = 0.5f - 1.0f / 16384.0f;   // 0.5 - 2^-14

template <int N>
__device__ __forceinline__ void quantize(const float (&v)[N], float s,
                                         float r, uint32_t (&words)[N / 4]) {
  uint32_t b[N];
  bool hard = SVT_Q8_DIVIDE != 0;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float y = __fmul_rn(v[e], r);
    const float big = __fadd_rn(y, kMagic);
    hard |= !(fabsf(__fsub_rn(y, __fsub_rn(big, kMagic))) < kFar);
    b[e] = __float_as_uint(big);
  }
  if (hard) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int q = __float2int_rn(__fdiv_rn(v[e], s));
      b[e] = static_cast<uint32_t>(max(-127, min(127, q)));
    }
  }
#pragma unroll
  for (int w = 0; w < N / 4; ++w)
    words[w] = __byte_perm(__byte_perm(b[4 * w], b[4 * w + 1], 0x0040),
                           __byte_perm(b[4 * w + 2], b[4 * w + 3], 0x0040),
                           0x5410);
}

__device__ __forceinline__ float load_scale(const void* ws, int ws_bf16,
                                            int n) {
  return ws_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(ws)[n])
             : static_cast<const float*>(ws)[n];
}

// d += A (64 x 32, descriptor da) . B^T (128 x 32, descriptor db), s8 in,
// s32 accumulators in the m64n128 fragment layout (a warp's 16 rows: lane
// (g, t) holds d[j] = rows g, g + 8 x columns 8j + 2t, 8j + 2t + 1)
__device__ __forceinline__ void mma(int (&d)[16][4], uint64_t da,
                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// slab j's 128 k of the block's W^T rows, in the swizzle
__device__ __forceinline__ void fetch_w(unsigned char* st,
                                        const int8_t* __restrict__ w, int K,
                                        int k0) {
  unsigned char* sw = st + kSlabA;
#pragma unroll
  for (int j = 0; j < kBN * 8 / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int r = i >> 3, c = i & 7;
    svt::cp_async16(sw + r * kBK + ((c ^ (r & 7)) << 4),
                    w + (long long)r * K + k0 + c * 16, true);
  }
}

// slab j of the block's int8 rows from the scratch, where it lies already
// swizzled (16 KB in one piece)
__device__ __forceinline__ void fetch_x(unsigned char* st,
                                        const int8_t* __restrict__ slab) {
#pragma unroll
  for (int j = 0; j < kSlabA / 16 / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    svt::cp_async16(st + i * 16, slab + i * 16, true);
  }
}

// Grid (N / 128, ceil(M / 128)), clusters of `cluster` blocks along N: block
// (tile, row block) owns out[m0 : m0 + 128, 128 tile : 128 (tile + 1)].
// xq is the scratch of the int8 rows: for each group of column tiles that a
// cluster covers, row block and 128-k slab, the slab's 128 rows x 128 bytes
// in the ring's swizzle, so that one straight copy of 16 KB stages it.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads, 2)
    int8_matmul_wgmma_kernel(const T* __restrict__ x,
                             const int8_t* __restrict__ w8t,
                             const void* __restrict__ ws, int ws_bf16,
                             O* __restrict__ out, int8_t* __restrict__ x8_out,
                             float* __restrict__ xs_out,
                             int8_t* __restrict__ xq, int M, int K, int N) {
  trace(0);
  constexpr int VN = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* ring = smem_raw + (1024 - raw % 1024) % 1024;
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);
  float* pam = reinterpret_cast<float*>(ring + kStages * kSlab);  // [8][kBM]
  float* xscale = pam + kMaxCluster * kBM;
  float* wscale = xscale + kBM;

  cg::cluster_group cluster = cg::this_cluster();
  const int cn = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int group = blockIdx.x / cn;
  const int rows = min(kBM, M - m0);
  const int nk = K / kBK;
  const int ks = K / cn, k0 = rank * ks;  // this block's share of K
  // this block's rows in the scratch: nk slabs of kSlabA bytes
  int8_t* xq_rows =
      xq + ((long long)group * gridDim.y + blockIdx.y) * nk * kSlabA;
  const int8_t* w_rows = w8t + (long long)n0 * K;

  // the tile's w_scale, kept in a register until the epilogue
  const float ws_mine = tid < kBN ? load_scale(ws, ws_bf16, n0 + tid) : 0.0f;
  // the first weight slabs are in flight while the rows are quantized
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < nk) fetch_w(ring + j * kSlab, w_rows, K, j * kBK);
    svt::cp_async_commit();
  }

  // ---- quantize this block's share of K of its rows: 8 threads a row,
  // rows tid / 8 + 32 p. A pass loads eight chunks of 16 bytes (two of each
  // of four rows) before it uses any, so that they are in flight together;
  // the first eight stay in registers for the second pass (all of them
  // where the share is at most 16 chunks a row: ffn1, feat_proj and the
  // attention projections in bf16 at cluster 8).
  static_assert(kBM == 4 * (kThreads / 8), "four rows a thread");
  const int chunks = ks / VN;  // 16-byte chunks of a row's share
  const int sub = tid & 7, rt = tid >> 3;
  const T* x_rows = x + (long long)m0 * K + k0;
  auto load = [&](uint4 (&raw)[2][4], int c) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = rt + 32 * p, cc = c + 8 * h;
        raw[h][p] = r < rows && cc < chunks
                        ? *reinterpret_cast<const uint4*>(
                              x_rows + (long long)r * K + cc * VN)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
  };
  float amax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto take_max = [&](const uint4 (&raw)[2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float v[VN];
        Vec<T>::unpack(raw[h][p], v);  // zeros past the rows and the share
#pragma unroll
        for (int e = 0; e < VN; ++e) amax[p] = fmaxf(amax[p], fabsf(v[e]));
      }
  };
  uint4 head[2][4];
  load(head, sub);
  take_max(head);
  for (int c = sub + 16; c < chunks; c += 16) {
    uint4 raw[2][4];
    load(raw, c);
    take_max(raw);
  }
  // each share's partial amax goes to every block of the cluster
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      amax[p] = fmaxf(amax[p], __shfl_xor_sync(0xffffffffu, amax[p], off));
    if (sub == 0)
      for (int q = 0; q < cn; ++q)
        cluster.map_shared_rank(pam, q)[rank * kBM + rt + 32 * p] = amax[p];
  }
  cluster.sync();  // every share's partial amax is in every block
  if (tid < kBM) {
    // max is exact in any order: the row's amax over the whole of K
    float a = pam[tid];
    for (int q = 1; q < cn; ++q) a = fmaxf(a, pam[q * kBM + tid]);
    const float scale = __fdiv_rn(fmaxf(a, 1e-8f), 127.0f);
    xscale[tid] = scale;
    if (xs_out != nullptr && group == 0 && rank == 0 && tid < rows)
      xs_out[m0 + tid] = scale;
  }
  __syncthreads();
  const bool debug = x8_out != nullptr && group == 0;
  float scale[4], rcp[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    scale[p] = xscale[rt + 32 * p];
    rcp[p] = __frcp_rn(scale[p]);
  }
  using Packed = typename Vec<T>::Packed;
  auto quantize_store = [&](const uint4 (&raw)[2][4], int c) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = rt + 32 * p, cc = c + 8 * h;
        if (r < rows && cc < chunks) {
          float v[VN];
          Vec<T>::unpack(raw[h][p], v);
          uint32_t words[VN / 4];
          quantize(v, scale[p], rcp[p], words);
          const Packed q = Vec<T>::pack(words);
          // k = k0 + cc * VN: slab k / 128, 16-byte chunk (k % 128) / 16
          // at its swizzled place in row r
          const int k = k0 + cc * VN;
          *reinterpret_cast<Packed*>(
              xq_rows + (long long)(k / kBK) * kSlabA + r * kBK +
              ((((k % kBK) >> 4) ^ (r & 7)) << 4) + (k & 15)) = q;
          if (debug)
            *reinterpret_cast<Packed*>(x8_out + (long long)(m0 + r) * K +
                                       k) = q;
        }
      }
  };
  quantize_store(head, sub);
  for (int c = sub + 16; c < chunks; c += 16) {
    uint4 raw[2][4];
    load(raw, c);
    quantize_store(raw, c);
  }
  cluster.sync();  // every share of the rows is written
  trace(1);

  // ---- the product: the int8 rows and W^T through the ring, wgmma s8.
  // Slab j lies in stage j % kStages.
  auto stage_slab = [&](int j) {
    unsigned char* st = ring + (j % kStages) * kSlab;
    fetch_x(st, xq_rows + (long long)j * kSlabA);
    if (j >= kAhead) fetch_w(st, w_rows, K, j * kBK);
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < nk) stage_slab(j);
    svt::cp_async_commit();
  }
  int acc[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  const int wgi = tid >> 7;  // the warpgroup's 64 rows
  for (int kb = 0; kb < nk; ++kb) {
    svt::cp_async_wait<kAhead - 1>();  // slab kb (its weights came first)
    svt::wg::fence_shared();
    __syncthreads();  // landed for all; every warpgroup is done with slab
                      // kb - 2, whose stage slab kb + kAhead refills
    const uint32_t st = ring_addr + (kb % kStages) * kSlab;
    const uint64_t da = svt::wg::desc(st + wgi * 64 * kBK);
    const uint64_t db = svt::wg::desc(st + kSlabA);
    svt::wg::fence_operands(acc);
    svt::wg::fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)  // 32 bytes a k step
      mma(acc, da + 2 * kk, db + 2 * kk);
    svt::wg::commit();
    if (kb + kAhead < nk) stage_slab(kb + kAhead);  // while the MMAs run
    svt::cp_async_commit();
    svt::wg::wait<1>();  // slab kb - 1's MMAs are done
  }
  svt::wg::wait<0>();
  svt::wg::fence_operands(acc);
  svt::cp_async_wait<0>();
  if (tid < kBN) wscale[tid] = ws_mine;
  __syncthreads();  // every MMA is done: warps stage their rows in the ring
  trace(2);

  // ---- epilogue in f32, in the reference's order: (acc * x_scale) * w_scale
  constexpr int kLd = staged_row_bytes<O>();
  static_assert(8 * 16 * kLd <= kStages * kSlab, "staging");
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;  // the warp's 16 rows of the block
  unsigned char* stage = ring + warp * 16 * kLd;
  const float xs0 = xscale[r0 + g], xs1 = xscale[r0 + g + 8];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 w = *reinterpret_cast<const float2*>(wscale + c);
    Vec<O>::store2(stage + g * kLd + c * (int)sizeof(O),
                   (__int2float_rn(acc[j][0]) * xs0) * w.x,
                   (__int2float_rn(acc[j][1]) * xs0) * w.y);
    Vec<O>::store2(stage + (g + 8) * kLd + c * (int)sizeof(O),
                   (__int2float_rn(acc[j][2]) * xs1) * w.x,
                   (__int2float_rn(acc[j][3]) * xs1) * w.y);
  }
  __syncwarp();
  // 16-byte stores, whole rows of the tile
  constexpr int kChunks = kBN * (int)sizeof(O) / 16;  // a row's
#pragma unroll 4
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const int m = m0 + r0 + r;
    if (m < M)
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(
                                    out + (long long)m * N + n0) +
                                c * 16) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + c * 16);
  }
  trace(3);
}

cudaLaunchConfig_t launch_config(dim3 grid, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, typename O>
cudaError_t launch(const void* x, const void* w8t, const void* ws,
                   int ws_bf16, void* out, void* x8_out, void* xs_out,
                   void* xq, int m, int k, int n, int cluster,
                   cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t err =
      svt::allow_smem(int8_matmul_wgmma_kernel<T, O>, kSmem, configured);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      dim3(n / kBN, (m + kBM - 1) / kBM, 1), cluster, stream, &attr);
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, int8_matmul_wgmma_kernel<T, O>, static_cast<const T*>(x),
      static_cast<const int8_t*>(w8t), ws, ws_bf16, static_cast<O*>(out),
      static_cast<int8_t*>(x8_out), static_cast<float*>(xs_out),
      static_cast<int8_t*>(xq), m, k, n);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

template <typename T>
cudaError_t attributes(int cluster, int* out) {
  auto kernel = int8_matmul_wgmma_kernel<T, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0, clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, kSmem);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(dim3(cluster, 1, 1), cluster, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)kSmem;
  out[3] = blocks;
  out[4] = clusters;
  return cudaSuccess;
}

}  // namespace

// dtype (x), ws_dtype (w_scale) and out_dtype (out): 0 = float32,
// 1 = bfloat16.
// cluster 1, 2, 4 or 8 dividing N / 128; xq the scratch of xq_bytes, at
// least N / 128 / cluster x ceil(M / 128) x 128 x K int8 (one copy of the
// int8 rows, in slabs, for each group of column tiles). x8_out (M, K) int8
// and xs_out (M,) f32 are both null, or both given to receive the quantized
// rows and their scales (written once for each row, by the first group of
// column tiles). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int svt_int8_matmul(int dtype, const void* x, const void* w8t,
                               const void* ws, int ws_dtype, void* out,
                               int out_dtype, void* x8_out, void* xs_out,
                               void* xq,
                               long long xq_bytes, int m, int k, int n,
                               int cluster, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % kBK || k > kMaxK || n % kBN ||
      (m + kBM - 1) / kBM > 65535 || xq == nullptr ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (n / kBN) % cluster ||
      xq_bytes < (long long)(n / kBN / cluster) * ((m + kBM - 1) / kBM) *
                     kBM * k ||
      (ws_dtype != 0 && ws_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1) ||
      (x8_out == nullptr) != (xs_out == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && out_dtype == 0)
    return (int)launch<float, float>(x, w8t, ws, ws_dtype, out, x8_out,
                                     xs_out, xq, m, k, n, cluster, st);
  if (dtype == 0 && out_dtype == 1)
    return (int)launch<float, bf16>(x, w8t, ws, ws_dtype, out, x8_out,
                                    xs_out, xq, m, k, n, cluster, st);
  if (dtype == 1 && out_dtype == 0)
    return (int)launch<bf16, float>(x, w8t, ws, ws_dtype, out, x8_out,
                                    xs_out, xq, m, k, n, cluster, st);
  if (dtype == 1 && out_dtype == 1)
    return (int)launch<bf16, bf16>(x, w8t, ws, ws_dtype, out, x8_out,
                                   xs_out, xq, m, k, n, cluster, st);
  return (int)cudaErrorInvalidValue;
}

// out[5] = registers per thread, local memory bytes per thread (0 = no
// spills), dynamic shared memory bytes per block, resident blocks per SM,
// and clusters of `cluster` blocks resident on the card at once, of the
// instantiation for dtype.
extern "C" int svt_int8_matmul_attributes(int dtype, int cluster, int* out) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)attributes<float>(cluster, out);
  if (dtype == 1) return (int)attributes<__nv_bfloat16>(cluster, out);
  return (int)cudaErrorInvalidValue;
}

#if SVT_Q8_TRACE
// the trace of the last launch: blocks x 5 values (see SVT_Q8_TRACE)
extern "C" int svt_int8_matmul_trace(unsigned long long* out, int blocks) {
  if (blocks > kTraceBlocks) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, svt_q8_trace,
                                   sizeof(unsigned long long) * 5 * blocks);
}
#endif
