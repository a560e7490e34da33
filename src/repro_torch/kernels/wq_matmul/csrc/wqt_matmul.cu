// Weight-quantized matmul against out-major QTensor storage, or against
// K-major codes (KMAJOR), for Hopper.
//
// Replaces: src/repro/kernels/wq_matmul/wq_matmul.py::wqt_matmul_pallas
// (body _wqt_kernel).  Computes out (M, N) = x (M, K) @ dequant(codes)^T,
// where codes are int8 (N, K) or packed int4 uint8 (N, K/2) with the even k
// in the low nibble, scales are one fp32 per matrix (block_k = -1) or fp32
// (N, K/block_k) blockwise, the contraction accumulates in fp32 and the
// result is written in x's dtype (bf16 or fp32).
//
// With KMAJOR it replaces ::wq_matmul_pallas (body _wq_kernel), the legacy
// layout: out = x @ dequant(codes), codes int8 (K, N) or packed uint8
// (K/2, N) (the even k of a pair in the low nibble), scales fp32
// (K/block_k, N).  Only the loading of a code tile differs: its rows run
// along N, so a 16-byte load takes 16 columns of one k (or k pair) and
// each value its own (k / block_k, n) scale; the Pallas kernel locks its K
// tile to the quant block, this one takes any block.
//
// What bounds it on an H100: at decode (M = batch, 1..12) the work is a
// GEMV and the bound is the weight bytes, 0.5 (int4) or 1 (int8) byte per
// weight read once from HBM at 3.35 TB/s.  At prefill (M = batch x prompt)
// it is a GEMM and the bound is arithmetic.
//
// Design.  Each block owns one (TM, TN) output tile and loops over K in
// TK-wide steps.  Each step stages the x tile (converted to fp32) and the
// unpacked, dequantized weight tile in shared memory; the codes come from
// HBM as 16-byte loads, so HBM reads only the code bytes and never a dense
// weight.  The ragged M and N edges are masked in the kernel (no padding).
// Two tilings share the code:
//   * M > 16 (prefill): 64 x 64 tile, 16 x 16 threads, 4 x 4 outputs per
//     thread, a classic register-tiled fp32 FMA GEMM.
//   * M <= 16 (decode): 16 x 128 tile, 32 threads along N x 8 along K.
//     Each thread keeps all 16 rows x 4 columns in registers over its
//     slice of K, so every warp streams weights even when M = 1, and the
//     8 partial sums are added in a fixed order at the end (deterministic).
// At decode the (M, N) tiles are few (N = 2048 gives 16), too few blocks
// to keep enough code bytes in flight to cover HBM latency, so K is also
// split over blocks (grid.z) until the grid has about two blocks per SM;
// the fp32 partial tiles go to a workspace the wrapper allocates and a
// second small kernel adds them in split order (deterministic).
// fp32 FMAs on CUDA cores, no tensor cores, no copy/compute overlap: this
// first version is the simple one; wgmma, TMA and pipelining come later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype() does
}

// Sign-extended nibble: 0..7 -> 0..7, 8..15 -> -8..-1.
__device__ __forceinline__ int nibble(uint32_t b) {
  int v = static_cast<int>(b & 0xF);
  return v > 7 ? v - 16 : v;
}

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
wqt_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                  const float* __restrict__ scales, T* __restrict__ out,
                  float* __restrict__ partial, int M, int N, int K,
                  int block_k, int vec_ok, int k_per_split) {
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
}

// out[i] = sum over the splits of partial[z][i], in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ partial, T* __restrict__ out,
                 size_t count, int splits) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * count + i];
  out[i] = from_f32<T>(s);
}

constexpr int kSmallM = 16;        // M <= 16: the decode tiling
constexpr int kTK = 64;            // both tilings step K by 64
constexpr int kTargetBlocks = 2 * 132;   // two blocks on each of 132 SMs

// Splits of K (a multiple of kTK each) so that the grid reaches about
// kTargetBlocks blocks: at decode the (M, N) tiles alone are too few to
// keep enough code bytes in flight to cover HBM latency.
int k_splits(int M, int N, int K, int* k_per_split) {
  const int tm = M <= kSmallM ? 16 : 64, tn = M <= kSmallM ? 128 : 64;
  const int tiles = ((N + tn - 1) / tn) * ((M + tm - 1) / tm);
  const int steps = (K + kTK - 1) / kTK;
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > steps ? steps : splits);
  const int steps_per = (steps + splits - 1) / splits;
  *k_per_split = steps_per * kTK;
  return (steps + steps_per - 1) / steps_per;
}

template <typename T, bool INT4, bool KMAJOR>
cudaError_t launch(const void* x, const void* codes, const float* scales,
                   void* out, float* partial, int M, int N, int K,
                   int block_k, int vec_ok, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  T* op = static_cast<T*>(out);
  int k_per_split = 0;
  const int splits = partial ? k_splits(M, N, K, &k_per_split) : 1;
  if (splits == 1) k_per_split = K;
  if (M <= kSmallM) {
    constexpr int TM = 16, TN = 128;
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
    wqt_matmul_kernel<T, INT4, KMAJOR, TM, TN, kTK, 32, 1, 8, 16, 4>
        <<<grid, kThreads, 0, stream>>>(xp, cp, scales, op, partial, M, N, K,
                                        block_k, vec_ok, k_per_split);
  } else {
    constexpr int TM = 64, TN = 64;
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
    wqt_matmul_kernel<T, INT4, KMAJOR, TM, TN, kTK, 16, 16, 1, 4, 4>
        <<<grid, kThreads, 0, stream>>>(xp, cp, scales, op, partial, M, N, K,
                                        block_k, vec_ok, k_per_split);
  }
  if (splits > 1) {
    const size_t count = (size_t)M * N;
    split_sum_kernel<T><<<(unsigned)((count + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(partial, op, count, splits);
  }
  return cudaGetLastError();
}

template <bool KMAJOR>
int dispatch(const void* x, const void* codes, const void* scales, void* out,
             void* workspace, int M, int N, int K, int block_k, int bits,
             int dtype, int vec_ok, void* stream) {
  const float* sp = static_cast<const float*>(scales);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return bits == 4
        ? launch<__nv_bfloat16, true, KMAJOR>(x, codes, sp, out, ws, M, N, K, block_k, vec_ok, st)
        : launch<__nv_bfloat16, false, KMAJOR>(x, codes, sp, out, ws, M, N, K, block_k, vec_ok, st);
  }
  return bits == 4
      ? launch<float, true, KMAJOR>(x, codes, sp, out, ws, M, N, K, block_k, vec_ok, st)
      : launch<float, false, KMAJOR>(x, codes, sp, out, ws, M, N, K, block_k, vec_ok, st);
}

}  // namespace

// Number of K splits the launch will use for (M, N, K), either layout: the
// wrapper allocates an fp32 workspace of splits * M * N when it is above 1.
extern "C" int wqt_matmul_splits(int M, int N, int K) {
  int k_per_split = 0;
  return k_splits(M, N, K, &k_per_split);
}

// dtype: 0 = float32, 1 = bfloat16.  bits: 4 or 8.  block_k: -1 per-tensor.
// workspace: fp32 (splits, M, N) scratch, or null for one split.  vec_ok: 1
// when every code row starts 16-byte aligned (checked by the wrapper),
// enabling the vector loads.  Returns cudaGetLastError().
extern "C" int wqt_matmul_launch(const void* x, const void* codes,
                                 const void* scales, void* out,
                                 void* workspace, int M, int N, int K,
                                 int block_k, int bits, int dtype, int vec_ok,
                                 void* stream) {
  return dispatch<false>(x, codes, scales, out, workspace, M, N, K, block_k,
                         bits, dtype, vec_ok, stream);
}

// The K-major layout: codes (K, N) or (K/2, N), scales (K/block_k, N),
// block_k > 0 dividing K; vec_ok: 1 when the codes start 16-byte aligned
// and N % 16 == 0.  Other arguments as wqt_matmul_launch.
extern "C" int wq_matmul_launch(const void* x, const void* codes,
                                const void* scales, void* out,
                                void* workspace, int M, int N, int K,
                                int block_k, int bits, int dtype, int vec_ok,
                                void* stream) {
  return dispatch<true>(x, codes, scales, out, workspace, M, N, K, block_k,
                        bits, dtype, vec_ok, stream);
}
