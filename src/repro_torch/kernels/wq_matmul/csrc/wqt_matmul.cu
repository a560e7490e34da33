// Weight-quantized matmul against out-major QTensor storage, or against
// K-major codes (KMAJOR), for Hopper.
//
// Replaces: src/repro/kernels/wq_matmul/wq_matmul.py::wqt_matmul_pallas
// (body _wqt_kernel).  Computes out (M, N) = x (M, K) @ dequant(codes)^T,
// where codes are int8 (N, K) or packed int4 uint8 (N, K/2) with the even k
// in the low nibble, scales are one fp32 per matrix (block_k = -1) or fp32
// (N, K/block_k) blockwise, the contraction accumulates in fp32 and the
// result is written in x's dtype (bf16 or fp32).  With KMAJOR it replaces
// ::wq_matmul_pallas (body _wq_kernel): out = x @ dequant(codes), codes
// int8 (K, N) or packed uint8 (K/2, N) (the even k of a pair in the low
// nibble), scales fp32 (K/block_k, N).
//
// Three instances; the launch plan (instance, tile, K splits, workspace)
// is chosen in Python (ops.py::plan) and passed in.
//
// * GEMV, bf16 x and M <= 16 (decode).  Bound: the code bytes, 0.5 (int4)
//   or 1 (int8) byte per weight read once from HBM at 3.35 TB/s: 9.1 us
//   for one Granite layer at int4.  CUDA cores cannot reach that: at M = 8
//   the layer is 973 MFLOP of fp32 FMA (14.5 us at 67 TFLOP/s) and its
//   60.8 M int->float conversions (16 per clock per SM) take about 14 us
//   more.  So the weights go through the tensor cores as bf16 (integer
//   codes are exact in bf16, and so is every product x * c in fp32):
//   swap-AB, out^T (N, M) = W (N, K) . x^T (K, M) with mma.sync m16n8k16,
//   16 weight rows as operand A and x^T as one n8 tile (M <= 8) or two.
//   Each warp owns 16 rows of N; a code word of 4 consecutive k (2 bytes
//   of int4, 4 of int8) per row and lane becomes its A fragment in
//   registers: an int4 nibble goes into the mantissa of bf16 128 biased by
//   8 (one byte_perm, one lop3) and one packed bf16 subtract of 136 leaves
//   c; int8 takes the same trick in fp32 (2^23 + c + 128) and one cvt to
//   bf16x2.  No weight tile is written to shared memory.  Each mma covers
//   16 consecutive k, so a blockwise scale (block_k % 16 == 0) folds per
//   quant block: the block's mmas accumulate in a fresh fragment, then
//   acc += part * s[n, kb] in block order, the scales staged with the
//   codes.  Codes, x and scales move through a cp.async ring of 128-wide
//   K steps (up to 6 stages, as many as 47 KB of static shared memory
//   holds); the plan splits K (at most 8 ways) toward two blocks per SM
//   and narrows the tile (64, 32, 16 columns) until the grid fills the
//   SMs, so that enough code bytes are in flight to cover HBM latency.
// * GEMM, bf16 x and M > 16 (prefill).  Bound: tensor-core FLOP (a
//   (8192, 2048) weight at M = 1024 is 34 us at the bf16 peak).  Block
//   tile 128 x 128, 8 warps of 64 x 32, K steps of 64 through a 3-4 stage
//   cp.async ring that carries the x tile and the code tile only (HBM and
//   shared memory move code bytes, never a dense weight), one barrier per
//   K step.  Per 16-wide slice a warp takes its x fragments by ldmatrix
//   and builds its code fragments in registers from the code tile (out-
//   major int4: one 8-byte read shared by a row's 4 lanes, one byte_perm,
//   the bit tricks above), then mma.sync.  Scales as in the GEMV.
//   Split-K only where the (M, N) tiles number fewer than the 132 SMs.
//   What holds it below the bound is not the mma.sync rate but moving the
//   x tile (re-read by every column tile) and building code fragments
//   (PERF.md); wgmma fed by TMA, x multicast to a cluster, comes next.
// * FMA, fp32 x or a shape the two above do not take (K not a multiple of
//   their K step, code rows not 16-byte aligned, block_k % 16 != 0): the
//   register-tiled fp32 FMA tiles, 16 x 128 at M <= 16, 64 x 64 above, the
//   code tile dequantized to fp32 in shared memory.  fp32 x would need TF32
//   on the tensor cores, which breaks the 1e-5 tolerance.
//
// Split-K is deterministic everywhere, with no float atomics.  The
// tensor-core instances launch the splits of a tile as one thread block
// cluster and add the partial tiles in split order through distributed
// shared memory.  The FMA instance writes fp32 partial tiles to a global
// workspace, and the last block to finish a tile (found through an
// integer counter, which it resets to 0) adds them in split order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

namespace cg = cooperative_groups;

// ---- blockwise scales, staged with the codes ------------------------------

// Where the quant blocks end, for a block's stages in the order it loads
// them, without a division per stage (block_k % 16 == 0; a split starts a
// quant block).
struct BlockEnds {
  int per;    // 16-wide slices per quant block
  int next;   // slice of the next stage that ends a block (may be >= its end)
  int kb;     // the quant block it ends
  int kbs;    // quant blocks along K
  __device__ BlockEnds(int block_k, int k_begin, int K)
      : per(block_k / 16), next(block_k / 16 - 1), kb(k_begin / block_k),
        kbs(K / block_k) {}
};

// Stage the scales that the next pipeline stage of SLICES 16-wide k slices
// folds in, and advance `ends` past it: ss[j * BN + r] = s(column n0 + r,
// the quant block that slice j ends) for each slice j that ends one (the
// other slots are left unwritten); columns past N read 0.  Out-major
// scales are (N, K / block_k), K-major ones (K / block_k, N).
template <bool KMAJOR, int SLICES, int BN>
__device__ __forceinline__ void load_scales(float* ss,
                                            const float* __restrict__ scales,
                                            BlockEnds& ends, int n0, int N) {
  int j = ends.next;
  for (; j < SLICES; j += ends.per, ++ends.kb) {
    for (int r = threadIdx.x; r < BN; r += blockDim.x) {
      const int gn = n0 + r;
      const bool ok = gn < N;
      cp_async4(ss + j * BN + r,
                ok ? scales + (KMAJOR ? (size_t)ends.kb * N + gn
                                      : (size_t)gn * ends.kbs + ends.kb)
                   : scales, ok);
    }
  }
  ends.next = j - SLICES;
}

// ---- deterministic split-K across a thread block cluster ------------------

constexpr int kMaxClusterSplits = 8;     // the portable cluster size

// The tensor-core instances launch the splits of a tile as one cluster
// (grid z = cluster z = splits <= 8).  Every block leaves its fp32 partial
// tile (tm, tn), row-major, at `red` in its own shared memory; after one
// cluster barrier, block z adds its 1/splits share of the tile's elements
// over all the blocks' tiles in split order through distributed shared
// memory, scales and writes it; a second barrier keeps every tile alive
// until all reads are done.  tn % 4 == 0.
template <typename T>
__device__ void cluster_finish(const float* red, int tm, int tn,
                               T* __restrict__ out, int M, int N, int m0,
                               int n0, float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  const int quads = tm * tn / 4, per = (quads + splits - 1) / splits;
  const int q1 = min(quads, (z + 1) * per);
  for (int q = z * per + threadIdx.x; q < q1; q += blockDim.x) {
    float4 v[kMaxClusterSplits];
#pragma unroll
    for (int r = 0; r < kMaxClusterSplits; ++r)   // all loads in flight
      if (r < splits)
        v[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red + 4 * q, r));
    float4 s = v[0];
#pragma unroll
    for (int r = 1; r < kMaxClusterSplits; ++r)
      if (r < splits) {
        s.x += v[r].x;
        s.y += v[r].y;
        s.z += v[r].z;
        s.w += v[r].w;
      }
    const int m = m0 + 4 * q / tn, n = n0 + 4 * q % tn;
    if (m < M) {
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < N) out[(size_t)m * N + n + i] = from_f32<T>(sv[i] * scale);
    }
  }
  cluster.sync();
}

// ---- deterministic split-K through global memory (the FMA instance) -----

// Call after the block has written its fp32 partial tile to
// partial[blockIdx.z] (all threads).  The last block to arrive at the
// tile's counter adds the partials of rows [m0, m0 + tm) and columns
// [n0, n0 + tn) in split order, scales (1 where the scales are already
// in), writes out and resets the counter.
template <typename T>
__device__ void finish_splits(const float* __restrict__ partial,
                              int* __restrict__ counter, T* __restrict__ out,
                              int M, int N, int m0, int tm, int n0, int tn,
                              float scale) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1) == static_cast<int>(gridDim.z) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t mn = (size_t)M * N;
  for (int e = threadIdx.x; e < tm * tn; e += blockDim.x) {
    const int m = m0 + e / tn, n = n0 + e % tn;
    if (m < M && n < N) {
      const size_t o = (size_t)m * N + n;
      float s = 0.f;
      unsigned z = 0;
      for (; z + 4 <= gridDim.z; z += 4) {     // 4 loads in flight
        const float p0 = __ldcg(partial + z * mn + o);
        const float p1 = __ldcg(partial + (z + 1) * mn + o);
        const float p2 = __ldcg(partial + (z + 2) * mn + o);
        const float p3 = __ldcg(partial + (z + 3) * mn + o);
        s += p0;
        s += p1;
        s += p2;
        s += p3;
      }
      for (; z < gridDim.z; ++z) s += __ldcg(partial + z * mn + o);
      out[o] = from_f32<T>(s * scale);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

// ---- FMA instance ---------------------------------------------------------

constexpr int kThreads = 256;

// Out-major (N, K[/2]) code tile of columns [n0, n0 + TN) and k in
// [k0, k0 + TK) -> ws[k][n], dequantized.
template <bool INT4, int TN, int TK>
__device__ __forceinline__ void load_tile_nk(const uint8_t* __restrict__ codes,
                                             const float* __restrict__ scales,
                                             float (*ws)[TN], int k0, int n0,
                                             int N, int K, int block_k,
                                             int vec_ok) {
  constexpr int kRowBytes = INT4 ? TK / 2 : TK;     // code bytes per tile row
  constexpr int kChunksPerRow = kRowBytes / 16;
  static_assert(kRowBytes % 16 == 0, "16-byte code loads");
  const int t = threadIdx.x;
  const int row_bytes = INT4 ? K / 2 : K;
  const bool per_tensor = block_k < 0;
  const int kb = per_tensor ? 1 : K / block_k;
  const float s_all = per_tensor ? scales[0] : 0.f;
  for (int c = t; c < TN * kChunksPerRow; c += kThreads) {
    const int n = c % TN, part = c / TN;
    const int gn = n0 + n;
    const int byte0 = k0 / (INT4 ? 2 : 1) + part * 16;
    uint8_t b[16];
    if (gn < N && vec_ok && byte0 + 16 <= row_bytes) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          codes + (size_t)gn * row_bytes + byte0);
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 16; ++q) b[q] = (w4[q / 4] >> (8 * (q % 4))) & 0xFF;
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q)
        b[q] = (gn < N && byte0 + q < row_bytes)
                   ? codes[(size_t)gn * row_bytes + byte0 + q] : 0;
    }
    const int kl0 = part * 16 * (INT4 ? 2 : 1);   // first k of the chunk in the tile
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      int c0, c1 = 0;
      if (INT4) {
        c0 = nibble(b[q]);
        c1 = nibble(b[q] >> 4);
      } else {
        c0 = static_cast<int8_t>(b[q]);
      }
      const int kk0 = kl0 + (INT4 ? 2 * q : q);
      const int gk0 = k0 + kk0;
      float s0 = s_all, s1 = s_all;
      if (!per_tensor && gn < N) {
        s0 = gk0 < K ? scales[(size_t)gn * kb + gk0 / block_k] : 0.f;
        if (INT4) s1 = gk0 + 1 < K ? scales[(size_t)gn * kb + (gk0 + 1) / block_k] : 0.f;
      }
      ws[kk0][n] = static_cast<float>(c0) * s0;
      if (INT4) ws[kk0 + 1][n] = static_cast<float>(c1) * s1;
    }
  }
}

// K-major (K[/2], N) code tile -> ws[k][n], dequantized with the scale of
// each (k / block_k, n).
template <bool INT4, int TN, int TK>
__device__ __forceinline__ void load_tile_kn(const uint8_t* __restrict__ codes,
                                             const float* __restrict__ scales,
                                             float (*ws)[TN], int k0, int n0,
                                             int N, int K, int block_k,
                                             int vec_ok) {
  constexpr int kRows = INT4 ? TK / 2 : TK;         // code rows per tile
  constexpr int kChunksPerRow = TN / 16;
  static_assert(TN % 16 == 0, "16-byte code loads");
  const int code_rows = INT4 ? K / 2 : K;
  for (int c = threadIdx.x; c < kRows * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow, chunk = c % kChunksPerRow;
    const int gr = (INT4 ? k0 / 2 : k0) + r;        // code row
    const int n = chunk * 16, gn = n0 + n;
    uint8_t b[16];
    const uint8_t* src = codes + (size_t)gr * N + gn;
    if (gr < code_rows && vec_ok && gn + 16 <= N &&
        (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 16; ++q) b[q] = (w4[q / 4] >> (8 * (q % 4))) & 0xFF;
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q)
        b[q] = (gr < code_rows && gn + q < N) ? src[q] : 0;
    }
    const int kk = INT4 ? 2 * r : r;                // first k of the row in the tile
    const int gk = k0 + kk;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const bool col_ok = gn + q < N;
      const float s0 = (col_ok && gk < K)
          ? scales[(size_t)(gk / block_k) * N + gn + q] : 0.f;
      if (INT4) {
        const float s1 = (col_ok && gk + 1 < K)
            ? scales[(size_t)((gk + 1) / block_k) * N + gn + q] : 0.f;
        ws[kk][n + q] = static_cast<float>(nibble(b[q])) * s0;
        ws[kk + 1][n + q] = static_cast<float>(nibble(b[q] >> 4)) * s1;
      } else {
        ws[kk][n + q] = static_cast<float>(static_cast<int8_t>(b[q])) * s0;
      }
    }
  }
}

// TX threads along N (RN columns each), TY along M (RM rows each), TZ along
// K (each takes TK / TZ of every K step).  TX * TY * TZ == kThreads.
template <typename T, bool INT4, bool KMAJOR, int TM, int TN, int TK, int TX,
          int TY, int TZ, int RM, int RN>
__global__ void __launch_bounds__(kThreads)
fma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scales, T* __restrict__ out,
           float* __restrict__ partial, int* __restrict__ counters, int M,
           int N, int K, int block_k, int vec_ok, int k_per_split) {
  static_assert(TX * TY * TZ == kThreads, "thread layout");
  static_assert(TX * RN == TN && TY * RM == TM, "tile layout");
  static_assert(TK % TZ == 0, "k split");
  constexpr int kKz = TK / TZ;

  // xs[k][m] and ws[k][n]: k-major, so a thread's reads along m or n are
  // contiguous across the warp.  xs is padded one column so that the
  // m-major (coalesced) loads of x write it without bank conflicts.  With
  // TZ > 1 the reduction buffer aliases ws.
  __shared__ float xs[TK][TM + 1];
  __shared__ float ws[TK][TN];

  const int t = threadIdx.x;
  const int tx = t % TX;
  const int ty = (t / TX) % TY;
  const int tz = t / (TX * TY);
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int m_rows = min(TM, M - m0);
  // split-K: block z of gridDim.z walks K in [k_begin, k_end) and, when
  // there is more than one split, writes an fp32 partial tile
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool split = gridDim.z > 1;
  float* part = split ? partial + (size_t)blockIdx.z * M * N : nullptr;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    // ---- x tile -> xs (fp32), zero outside M and K
    for (int e = t; e < TM * TK; e += kThreads) {
      const int m = e / TK, k = e % TK;
      const int gm = m0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? to_f32<T>(x[(size_t)gm * K + gk]) : 0.f;
    }
    // ---- code tile -> ws (dequantized fp32), 16 bytes per load
    if constexpr (KMAJOR)
      load_tile_kn<INT4, TN, TK>(codes, scales, ws, k0, n0, N, K, block_k,
                                 vec_ok);
    else
      load_tile_nk<INT4, TN, TK>(codes, scales, ws, k0, n0, N, K, block_k,
                                 vec_ok);
    __syncthreads();

    // ---- register-tiled FMAs over this thread's K slice
#pragma unroll 4
    for (int kk = tz * kKz; kk < (tz + 1) * kKz; ++kk) {
      float a[RM], w[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) w[j] = ws[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        if (ty + TY * i < m_rows) {
          a[i] = xs[kk][ty + TY * i];
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  if (TZ > 1) {
    // add the TZ partial tiles in a fixed order through shared memory
    float* red = &ws[0][0];                 // TM * TN floats <= TK * TN
    static_assert(TM <= TK, "reduction buffer fits in ws");
    for (int z = 0; z < TZ; ++z) {
      if (tz == z) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int idx = (ty + TY * i) * TN + tx + TX * j;
            red[idx] = (z == 0 ? 0.f : red[idx]) + acc[i][j];
          }
      }
      __syncthreads();
    }
    for (int e = t; e < TM * TN; e += kThreads) {
      const int m = e / TN, n = e % TN;
      if (m0 + m < M && n0 + n < N) {
        const size_t o = (size_t)(m0 + m) * N + n0 + n;
        if (split) part[o] = red[e];
        else out[o] = from_f32<T>(red[e]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gm = m0 + ty + TY * i, gn = n0 + tx + TX * j;
        if (gm < M && gn < N) {
          const size_t o = (size_t)gm * N + gn;
          if (split) part[o] = acc[i][j];
          else out[o] = from_f32<T>(acc[i][j]);
        }
      }
  }
  if (split)   // the scales are in the dequantized tile already
    finish_splits<T>(partial, counters + blockIdx.y * gridDim.x + blockIdx.x,
                     out, M, N, m0, TM, n0, TN, 1.f);
}

// ---- GEMV instance (bf16 x, M <= 16) --------------------------------------

constexpr int kGvK = 128;        // k per pipeline stage

// A stage's code tile.  Out-major: BN rows of the tile's kGvK / 2 (int4) or
// kGvK (int8) code bytes.  K-major: kGvK / 2 or kGvK code rows of BN bytes.
// Rows are padded by 16 bytes so that the warps' reads of a k slice from
// 8 rows fall in distinct banks.
template <bool INT4, bool KMAJOR, int BN>
struct GvCodes {
  static constexpr int kRows = KMAJOR ? (INT4 ? kGvK / 2 : kGvK) : BN;
  static constexpr int kRowBytes = KMAJOR ? BN : (INT4 ? kGvK / 2 : kGvK);
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kBytes = kRows * kStride;
};

// The code word of 4 consecutive k (local kk .. kk + 3, kk % 4 == 0) of
// local output row r in a code tile: int4 2 bytes (low half), int8 4.
template <bool INT4, bool KMAJOR, int STRIDE>
__device__ __forceinline__ uint32_t code_word(const uint8_t* cs, int r,
                                              int kk) {
  if constexpr (KMAJOR) {
    if constexpr (INT4) {
      const uint8_t* p = cs + (kk / 2) * STRIDE + r;
      return p[0] | (uint32_t(p[STRIDE]) << 8);
    } else {
      const uint8_t* p = cs + kk * STRIDE + r;
      return p[0] | (uint32_t(p[STRIDE]) << 8) |
             (uint32_t(p[2 * STRIDE]) << 16) | (uint32_t(p[3 * STRIDE]) << 24);
    }
  } else if constexpr (INT4) {
    return *reinterpret_cast<const uint16_t*>(cs + r * STRIDE + kk / 2);
  } else {
    return *reinterpret_cast<const uint32_t*>(cs + r * STRIDE + kk);
  }
}

// Swap-AB: warp w owns output columns n0 + 16w .. + 16 as the 16 rows of
// operand A; x^T is operand B, MT n8 tiles of M.  For every 16-wide k slice
// lane (g, t) = (lane / 4, lane % 4) holds k = 16j + 4t .. + 4 of rows g
// and g + 8 (A) and of x rows g (+ 8) (B), the same k order on both sides.
// Grid (N / BN, 1, splits), the splits of a tile one cluster; block z
// takes K in [z, z + 1) * k_per_split.
template <bool INT4, bool KMAJOR, int MT, int WN>
__global__ void __launch_bounds__(32 * WN)
gemv_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ codes,
            const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
            int M, int N, int K, int block_k, int k_per_split) {
  constexpr int BN = 16 * WN, XM = 8 * MT, kThreadsGv = 32 * WN;
  using Codes = GvCodes<INT4, KMAJOR, BN>;
  constexpr int XS = kGvK + 8;                  // x row stride (bf16): 272 B
  constexpr int kXBytes = XM * XS * 2;
  // a stage: x tile, code tile, the scales of the blocks it ends
  constexpr int kStage = kXBytes + Codes::kBytes + (kGvK / 16) * BN * 4;
  // as many stages (up to 6) as 47 KB of static shared memory holds
  constexpr int kGvStages = 47 * 1024 / kStage < 6 ? 47 * 1024 / kStage : 6;
  static_assert(kGvStages >= 2, "two stages fit");
  static_assert(XM * BN * 4 <= kGvStages * kStage, "reduction tile fits");
  __shared__ __align__(16) uint8_t smem[kGvStages * kStage];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int steps = (min(K, k_begin + k_per_split) - k_begin) / kGvK;
  const bool per_tensor = block_k < 0;
  BlockEnds ends(per_tensor ? 16 : block_k, k_begin, K);

  auto load_stage = [&](int slot, int k0) {
    uint8_t* st = smem + slot * kStage;
    constexpr int kXChunks = kGvK / 8;          // 16-byte chunks of a row
    for (int c = threadIdx.x; c < XM * kXChunks; c += kThreadsGv) {
      const int m = c / kXChunks, chunk = c % kXChunks;
      const bool ok = m < M;
      cp_async16(st + m * XS * 2 + chunk * 16,
                 ok ? x + (size_t)m * K + k0 + chunk * 8 : x, ok);
    }
    uint8_t* cs = st + kXBytes;
    constexpr int kChunks = Codes::kRowBytes / 16;
    for (int c = threadIdx.x; c < Codes::kRows * kChunks; c += kThreadsGv) {
      const int r = c / kChunks, chunk = c % kChunks;
      const uint8_t* src;
      bool ok;
      if constexpr (KMAJOR) {
        const int gn = n0 + chunk * 16;          // N % 16 == 0
        ok = gn < N;
        src = codes + (size_t)((INT4 ? k0 / 2 : k0) + r) * N + gn;
      } else {
        const int gn = n0 + r;
        ok = gn < N;
        src = codes + (size_t)gn * (INT4 ? K / 2 : K) + (INT4 ? k0 / 2 : k0) +
              chunk * 16;
      }
      cp_async16(cs + r * Codes::kStride + chunk * 16, ok ? src : codes, ok);
    }
    if (!per_tensor)
      load_scales<KMAJOR, kGvK / 16, BN>(
          reinterpret_cast<float*>(cs + Codes::kBytes), scales, ends, n0, N);
  };

  // part: the current quant block's sums (all of K per tensor); acc: the
  // scaled sums of the finished blocks.  Element i of a fragment is output
  // column (row of A) g + 8 * (i / 2) and x row 8 * mt + 2t + i % 2.
  float acc[MT][4], part[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = part[mt][i] = 0.f;
  const int r0 = warp * 16 + g;                 // local rows r0, r0 + 8

#pragma unroll
  for (int s = 0; s < kGvStages - 1; ++s) {
    if (s < steps) load_stage(s, k_begin + s * kGvK);
    cp_async_commit();
  }
  // 16-wide slices left in the current quant block (k_begin starts one)
  int left = per_tensor ? 0 : block_k / 16;
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kGvStages - 2>();
    __syncthreads();                            // stage it landed; it - 1 consumed
    const int nx = it + kGvStages - 1;
    if (nx < steps) load_stage(nx % kGvStages, k_begin + nx * kGvK);
    cp_async_commit();

    const uint8_t* st = smem + (it % kGvStages) * kStage;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const uint8_t* cs = st + kXBytes;
#pragma unroll
    for (int j = 0; j < kGvK / 16; ++j) {
      const int kk = 16 * j + 4 * t;
      uint32_t a[4];
      dequant4<INT4>(code_word<INT4, KMAJOR, Codes::kStride>(cs, r0, kk),
                     a[0], a[2]);
      dequant4<INT4>(code_word<INT4, KMAJOR, Codes::kStride>(cs, r0 + 8, kk),
                     a[1], a[3]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            xs + (8 * mt + g) * XS + kk);
        mma_bf16(part[mt], a, b.x, b.y);
      }
      if (!per_tensor && --left == 0) {
        // end of a quant block: fold it in with its scales, in block order
        left = block_k / 16;
        const float* ss = reinterpret_cast<const float*>(cs + Codes::kBytes);
        const float s0 = ss[j * BN + r0], s1 = ss[j * BN + r0 + 8];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][0] = fmaf(part[mt][0], s0, acc[mt][0]);
          acc[mt][1] = fmaf(part[mt][1], s0, acc[mt][1]);
          acc[mt][2] = fmaf(part[mt][2], s1, acc[mt][2]);
          acc[mt][3] = fmaf(part[mt][3], s1, acc[mt][3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mt][i] = 0.f;
        }
      }
    }
  }

  // (XM, BN) tile through shared memory, then coalesced stores; the scale
  // of a per-tensor matrix is applied once to the full sum.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = per_tensor ? part[mt][i] : acc[mt][i];
    const int m = 8 * mt + 2 * t;
    red[m * BN + r0] = v[0];
    red[(m + 1) * BN + r0] = v[1];
    red[m * BN + r0 + 8] = v[2];
    red[(m + 1) * BN + r0 + 8] = v[3];
  }
  const float s_pt = per_tensor ? scales[0] : 1.f;
  if (gridDim.z > 1) {
    cluster_finish<__nv_bfloat16>(red, XM, BN, out, M, N, 0, n0, s_pt);
    return;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < XM * BN; e += kThreadsGv) {
    const int m = e / BN, n = n0 + e % BN;
    if (m < M && n < N) out[(size_t)m * N + n] = __float2bfloat16(red[e] * s_pt);
  }
}

// ---- GEMM instance (bf16 x, M > 16) ---------------------------------------

constexpr int kGmM = 128, kGmN = 128, kGmK = 64;   // block tile, K step
constexpr int kGmThreads = 256;                    // 2 x 4 warps of 64 x 32
constexpr int kGmXS = kGmK + 8;   // x tile row stride (bf16): 144 B, so
                                  // ldmatrix's 8 rows hit distinct banks

// A stage: the x tile, the code tile, the scales of the quant blocks it
// ends.  Code tile, out-major: kGmN rows of kGmK / 2 (int4) or kGmK (int8)
// bytes; K-major: kGmK / 2 or kGmK code rows of kGmN bytes; rows padded by
// 16 bytes so that the 8 columns of a fragment read distinct banks.
template <bool INT4, bool KMAJOR>
struct GmTile {
  static constexpr int kRows = KMAJOR ? (INT4 ? kGmK / 2 : kGmK) : kGmN;
  static constexpr int kRowBytes = KMAJOR ? kGmN : (INT4 ? kGmK / 2 : kGmK);
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kCodeBytes = kRows * kStride;
  static constexpr int kXBytes = kGmM * kGmXS * 2;
  static constexpr int kScaleBytes = (kGmK / 16) * kGmN * 4;
  static constexpr int kStage = kXBytes + kCodeBytes + kScaleBytes;
  static constexpr int kStages = INT4 ? 4 : 3;      // two blocks per SM
  static constexpr int kSmem = kStages * kStage;
};

// The B fragment of column n for the mma over local k 16s .. 16s + 16 of a
// stage's code tile, dequantized in registers: b0 holds k (2t, 2t + 1) of
// the slice's first 8, b1 of its second 8 (the natural order, as ldmatrix
// gives x).  Out-major int4: one 8-byte read (shared by the 4 lanes of a
// row) and one byte_perm pick the lane's two code bytes.
template <bool INT4, bool KMAJOR, int STRIDE>
__device__ __forceinline__ void b_frag(const uint8_t* cs, int n, int s, int t,
                                       uint32_t& b0, uint32_t& b1) {
  uint32_t h;
  if constexpr (!KMAJOR && INT4) {
    const uint2 w = *reinterpret_cast<const uint2*>(cs + n * STRIDE + 8 * s);
    h = __byte_perm(w.x, w.y, t | ((t + 4) << 4));
  } else if constexpr (!KMAJOR) {
    const uint8_t* r = cs + n * STRIDE + 16 * s + 2 * t;
    h = *reinterpret_cast<const uint16_t*>(r) |
        (uint32_t(*reinterpret_cast<const uint16_t*>(r + 8)) << 16);
  } else if constexpr (INT4) {
    const uint8_t* r = cs + (8 * s + t) * STRIDE + n;
    h = r[0] | (uint32_t(r[4 * STRIDE]) << 8);
  } else {
    const uint8_t* r = cs + (16 * s + 2 * t) * STRIDE + n;
    h = r[0] | (uint32_t(r[STRIDE]) << 8) | (uint32_t(r[8 * STRIDE]) << 16) |
        (uint32_t(r[9 * STRIDE]) << 24);
  }
  dequant4<INT4>(h, b0, b1);
}

// Grid (N / 128, M / 128, splits), the splits of a tile one cluster.  BW:
// blockwise scales (each quant block summed in a fresh fragment, then
// folded with its scales in block order).  Per K step: wait for the
// stage, one barrier, refill the ring, then per 16-wide slice ldmatrix the
// x fragments, dequantize the code fragments in registers, mma.sync.
// Per tensor the registers are held to 128 so that two blocks share an SM
// (left alone, the out-major int4 instance takes 164 and one block); the
// blockwise instance keeps a second accumulator set and one block.
template <bool INT4, bool KMAJOR, bool BW>
__global__ void __launch_bounds__(kGmThreads, BW ? 1 : 2)
gemm_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ codes,
            const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
            int M, int N, int K, int block_k, int k_per_split) {
  using Tile = GmTile<INT4, KMAJOR>;
  constexpr int S = Tile::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kGmM, n0 = blockIdx.x * kGmN;
  const int k_begin = blockIdx.z * k_per_split;
  const int steps = (min(K, k_begin + k_per_split) - k_begin) / kGmK;
  BlockEnds ends(BW ? block_k : 16, k_begin, K);

  auto load_stage = [&](int slot, int k0) {
    uint8_t* st = smem + slot * Tile::kStage;
    constexpr int kXChunks = kGmK / 8;          // 16-byte chunks of a row
    for (int c = tid; c < kGmM * kXChunks; c += kGmThreads) {
      const int m = c / kXChunks, chunk = c % kXChunks, gm = m0 + m;
      const bool ok = gm < M;
      cp_async16(st + m * kGmXS * 2 + chunk * 16,
                 ok ? x + (size_t)gm * K + k0 + chunk * 8 : x, ok);
    }
    uint8_t* cs = st + Tile::kXBytes;
    constexpr int kChunks = Tile::kRowBytes / 16;
    for (int c = tid; c < Tile::kRows * kChunks; c += kGmThreads) {
      const int r = c / kChunks, chunk = c % kChunks;
      const uint8_t* src;
      bool ok;
      if constexpr (KMAJOR) {
        const int gn = n0 + chunk * 16;          // N % 16 == 0
        ok = gn < N;
        src = codes + (size_t)((INT4 ? k0 / 2 : k0) + r) * N + gn;
      } else {
        const int gn = n0 + r;
        ok = gn < N;
        src = codes + (size_t)gn * (INT4 ? K / 2 : K) + (INT4 ? k0 / 2 : k0) +
              chunk * 16;
      }
      cp_async16(cs + r * Tile::kStride + chunk * 16, ok ? src : codes, ok);
    }
    if constexpr (BW)
      load_scales<KMAJOR, kGmK / 16, kGmN>(
          reinterpret_cast<float*>(cs + Tile::kCodeBytes), scales, ends, n0,
          N);
  };

  // fragment (mi, ni) element i: row 64 wm + 16 mi + g + 8 (i / 2), column
  // 32 wn + 8 ni + 2t + i % 2 of the block tile
  float part[4][4][4];
  float acc[BW ? 4 : 1][BW ? 4 : 1][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[mi][ni][i] = 0.f;
        if constexpr (BW) acc[mi][ni][i] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) load_stage(s, k_begin + s * kGmK);
    cp_async_commit();
  }
  // 16-wide slices left in the current quant block (k_begin starts one)
  int left = BW ? block_k / 16 : 0;
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();                  // stage it landed; stage it - 1 consumed
    const int nx = it + S - 1;
    if (nx < steps) load_stage(nx % S, k_begin + nx * kGmK);
    cp_async_commit();
    const uint8_t* st = smem + (it % S) * Tile::kStage;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const uint8_t* cs = st + Tile::kXBytes;
#pragma unroll
    for (int s = 0; s < kGmK / 16; ++s) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], xs + (wm * 64 + mi * 16 + (lane & 15)) * kGmXS +
                                16 * s + (lane >> 4) * 8);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t b0, b1;
        b_frag<INT4, KMAJOR, Tile::kStride>(cs, wn * 32 + ni * 8 + g, s, t,
                                            b0, b1);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(part[mi][ni], af[mi], b0, b1);
      }
      if constexpr (BW) {
        if (--left == 0) {
          left = block_k / 16;
          const float* ss = reinterpret_cast<const float*>(
              cs + Tile::kCodeBytes) + s * kGmN;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int c = wn * 32 + ni * 8 + 2 * t;
            const float sc[2] = {ss[c], ss[c + 1]};
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[mi][ni][i] = fmaf(part[mi][ni][i], sc[i & 1], acc[mi][ni][i]);
                part[mi][ni][i] = 0.f;
              }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const float s_pt = BW ? 1.f : scales[0];
  // split: the partial tile (128, 128) goes to shared memory, over the
  // ring, for the cluster's reduction
  const bool split = gridDim.z > 1;
  float* red = reinterpret_cast<float*>(smem);
  static_assert(kGmM * kGmN * 4 <= Tile::kSmem, "tile fits");
  if (split) __syncthreads();          // every warp is done with the ring
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ml = wm * 64 + mi * 16 + g + 8 * h;
        const int nl = wn * 32 + ni * 8 + 2 * t;
        const int m = m0 + ml, n = n0 + nl;
        float v0, v1;
        if constexpr (BW) {
          v0 = acc[mi][ni][2 * h];
          v1 = acc[mi][ni][2 * h + 1];
        } else {
          v0 = part[mi][ni][2 * h];
          v1 = part[mi][ni][2 * h + 1];
        }
        if (split) {
          *reinterpret_cast<float2*>(red + ml * kGmN + nl) = make_float2(v0, v1);
          continue;
        }
        if (m >= M) continue;
        const size_t o = (size_t)m * N + n;
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __floats2bfloat162_rn(v0 * s_pt, v1 * s_pt);
        } else {
          if (n < N) out[o] = __float2bfloat16(v0 * s_pt);
          if (n + 1 < N) out[o + 1] = __float2bfloat16(v1 * s_pt);
        }
      }
  if (split)
    cluster_finish<__nv_bfloat16>(red, kGmM, kGmN, out, M, N, m0, n0, s_pt);
}

// ---- launchers --------------------------------------------------------------

enum Instance { kGemv = 0, kGemm = 1, kFma = 2 };

struct Args {
  const void* x;
  const uint8_t* codes;
  const float* scales;
  void* out;
  float* partial;
  int* counters;
  int M, N, K, block_k, splits, k_per_split, vec_ok;
  cudaStream_t stream;
};

// Launch a tensor-core instance with the K splits of each tile as one
// cluster (1, 1, splits).
template <typename Kernel>
cudaError_t launch_clustered(Kernel kernel, dim3 grid, int threads, int smem,
                             const Args& a) {
  if (a.splits > kMaxClusterSplits) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel,
                            static_cast<const __nv_bfloat16*>(a.x), a.codes,
                            a.scales, static_cast<__nv_bfloat16*>(a.out),
                            a.M, a.N, a.K, a.block_k, a.k_per_split);
}

template <bool INT4, bool KMAJOR, int MT, int WN>
cudaError_t launch_gemv(const Args& a) {
  dim3 grid((a.N + 16 * WN - 1) / (16 * WN), 1, a.splits);
  cudaError_t e = launch_clustered(gemv_kernel<INT4, KMAJOR, MT, WN>, grid,
                                   32 * WN, 0, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool INT4, bool KMAJOR, int MT>
cudaError_t gemv_by_tile_n(const Args& a, int tile_n) {
  switch (tile_n) {
    case 64: return launch_gemv<INT4, KMAJOR, MT, 4>(a);
    case 32: return launch_gemv<INT4, KMAJOR, MT, 2>(a);
    case 16: return launch_gemv<INT4, KMAJOR, MT, 1>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool INT4, bool KMAJOR, bool BW>
cudaError_t launch_gemm(const Args& a) {
  constexpr int smem = GmTile<INT4, KMAJOR>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<INT4, KMAJOR, BW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + kGmN - 1) / kGmN, (a.M + kGmM - 1) / kGmM, a.splits);
  e = launch_clustered(gemm_kernel<INT4, KMAJOR, BW>, grid, kGmThreads,
                       smem, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, bool INT4, bool KMAJOR>
cudaError_t launch_fma(const Args& a, int tile_m, int tile_n) {
  constexpr int TK = 64;
  const T* xp = static_cast<const T*>(a.x);
  T* op = static_cast<T*>(a.out);
  if (tile_m == 16 && tile_n == 128) {          // decode tiling
    dim3 grid((a.N + 127) / 128, (a.M + 15) / 16, a.splits);
    fma_kernel<T, INT4, KMAJOR, 16, 128, TK, 32, 1, 8, 16, 4>
        <<<grid, kThreads, 0, a.stream>>>(xp, a.codes, a.scales, op,
                                          a.partial, a.counters, a.M, a.N,
                                          a.K, a.block_k, a.vec_ok,
                                          a.k_per_split);
  } else if (tile_m == 64 && tile_n == 64) {    // prefill tiling
    dim3 grid((a.N + 63) / 64, (a.M + 63) / 64, a.splits);
    fma_kernel<T, INT4, KMAJOR, 64, 64, TK, 16, 16, 1, 4, 4>
        <<<grid, kThreads, 0, a.stream>>>(xp, a.codes, a.scales, op,
                                          a.partial, a.counters, a.M, a.N,
                                          a.K, a.block_k, a.vec_ok,
                                          a.k_per_split);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool INT4, bool KMAJOR>
cudaError_t dispatch_bits(const Args& a, int dtype, int instance, int tile_m,
                          int tile_n) {
  if (instance == kFma)
    return dtype == 1 ? launch_fma<__nv_bfloat16, INT4, KMAJOR>(a, tile_m, tile_n)
                      : launch_fma<float, INT4, KMAJOR>(a, tile_m, tile_n);
  if (dtype != 1) return cudaErrorInvalidValue;  // tensor cores: bf16 x only
  if (instance == kGemv) {
    if (tile_m == 8) return gemv_by_tile_n<INT4, KMAJOR, 1>(a, tile_n);
    if (tile_m == 16) return gemv_by_tile_n<INT4, KMAJOR, 2>(a, tile_n);
    return cudaErrorInvalidValue;
  }
  if (instance == kGemm && tile_m == kGmM && tile_n == kGmN)
    return a.block_k > 0 ? launch_gemm<INT4, KMAJOR, true>(a)
                         : launch_gemm<INT4, KMAJOR, false>(a);
  return cudaErrorInvalidValue;
}

template <bool KMAJOR>
int dispatch(const void* x, const void* codes, const void* scales, void* out,
             void* workspace, void* counters, int M, int N, int K,
             int block_k, int bits, int dtype, int instance, int tile_m,
             int tile_n, int splits, int k_per_split, int vec_ok,
             void* stream) {
  if (instance == kFma && splits > 1 &&
      (workspace == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  const Args a{x, static_cast<const uint8_t*>(codes),
               static_cast<const float*>(scales), out,
               static_cast<float*>(workspace), static_cast<int*>(counters),
               M, N, K, block_k, splits, k_per_split, vec_ok,
               static_cast<cudaStream_t>(stream)};
  return bits == 4
      ? dispatch_bits<true, KMAJOR>(a, dtype, instance, tile_m, tile_n)
      : dispatch_bits<false, KMAJOR>(a, dtype, instance, tile_m, tile_n);
}

}  // namespace

// The launch plan comes from ops.py::plan.  dtype: 0 = float32, 1 =
// bfloat16.  bits: 4 or 8.  block_k: -1 per tensor.  instance: 0 GEMV, 1
// GEMM, 2 FMA, with its (tile_m, tile_n).  splits: K splits (grid.z), each
// k_per_split wide (at most 8 for the GEMV and GEMM: one cluster).
// workspace and counters: the FMA instance's split-K, fp32 (splits, M, N)
// partial tiles and one int per (M, N) tile, zero at rest (the kernel
// leaves them zero); null otherwise.  vec_ok: 1 when every code row starts
// 16-byte aligned (the FMA instance's vector loads; the tensor-core
// instances require it).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan no instance takes.
extern "C" int wqt_matmul_launch(const void* x, const void* codes,
                                 const void* scales, void* out,
                                 void* workspace, void* counters, int M,
                                 int N, int K, int block_k, int bits,
                                 int dtype, int instance, int tile_m,
                                 int tile_n, int splits, int k_per_split,
                                 int vec_ok, void* stream) {
  return dispatch<false>(x, codes, scales, out, workspace, counters, M, N, K,
                         block_k, bits, dtype, instance, tile_m, tile_n,
                         splits, k_per_split, vec_ok, stream);
}

// The K-major layout: codes (K, N) or (K/2, N), scales (K/block_k, N),
// block_k > 0 dividing K; vec_ok: 1 when the codes start 16-byte aligned
// and N % 16 == 0.  Other arguments as wqt_matmul_launch.
extern "C" int wq_matmul_launch(const void* x, const void* codes,
                                const void* scales, void* out,
                                void* workspace, void* counters, int M,
                                int N, int K, int block_k, int bits,
                                int dtype, int instance, int tile_m,
                                int tile_n, int splits, int k_per_split,
                                int vec_ok, void* stream) {
  return dispatch<true>(x, codes, scales, out, workspace, counters, M, N, K,
                        block_k, bits, dtype, instance, tile_m, tile_n,
                        splits, k_per_split, vec_ok, stream);
}
