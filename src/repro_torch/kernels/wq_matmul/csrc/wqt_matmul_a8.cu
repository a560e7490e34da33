// W4A8 / W8A8 matmul against out-major QTensor storage, for Hopper.
//
// Replaces: src/repro/kernels/wq_matmul/wq_matmul.py::wqt_matmul_a8_pallas
// (body _wqt_a8_kernel).  Computes out (M, N) fp32 from int8 activation
// codes xq (M, K) with fp32 row scales xs (M, 1), against int8 (N, K) or
// packed int4 uint8 (N, K/2) weight codes (even k in the low nibble) with
// one fp32 scale per matrix (block_k = -1) or fp32 (N, K/block_k) scales.
// The contraction is int8 x int8 -> int32 (__dp4a), exact.  The epilogue
// follows the port's plain version (kernels/wq_matmul/ref.py::
// wqt_matmul_a8_ref) operation for operation, so the two agree bit for bit:
//   per tensor: acc = sum over all of K (int32), out = (float(acc) * xs) * s
//   blockwise:  f = sum over quant blocks b, in order, of float(acc_b) * s_b
//               (one rounding for the product, one for the sum), out = f * xs
// The Pallas kernel's own order (acc += float(prod) * (xs * ws) per 512-wide
// K tile) is not its oracle's; the port follows the oracle.
//
// What bounds it on an H100: at decode (M = 8 slots, or 16 for a prefill
// chunk) the weight bytes, 0.5 (int4) or 1 (int8) per weight read once from
// HBM at 3.35 TB/s.  At larger M the int8 operations (1,979 TOP/s on the
// tensor cores; __dp4a on the CUDA cores is far below that).
//
// Design.  The wqt_matmul kernel's two tilings, with the fp32 FMAs replaced
// by __dp4a on 32-bit words of four int8 values: activations and unpacked
// weight codes are staged in shared memory as such words (int4 nibbles are
// sign-extended into bytes on the way), so each inner step is one __dp4a.
// K is cut into segments over grid.z: per tensor, splits of a multiple of
// 64 (enough blocks to cover HBM latency at decode); blockwise, one quant
// block per segment.  Each segment's int32 sums go to a workspace the
// wrapper allocates, and a second small kernel adds them (int32: exact in
// any order) or folds them block by block in order, then applies the
// scales.  Per tensor with one segment the first kernel writes the output.
// No tensor cores (mma.sync s8) and no copy/compute overlap: this first
// version is the simple one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTK = 64;                  // K values per step
constexpr int kTKW = kTK / 4;            // 32-bit words per step

__device__ __forceinline__ uint32_t nib8(uint32_t nibble) {
  // sign-extend a 4-bit code into one byte: 0..7 -> 0..7, 8..15 -> -8..-1
  return (nibble & 0x8u) ? (nibble | 0xF0u) : nibble;
}

// Two packed int4 bytes (4 codes, even k low) -> one word of 4 int8 codes.
__device__ __forceinline__ int pack4(uint32_t b0, uint32_t b1) {
  return static_cast<int>(nib8(b0 & 0xF) | (nib8((b0 >> 4) & 0xF) << 8) |
                          (nib8(b1 & 0xF) << 16) | (nib8((b1 >> 4) & 0xF) << 24));
}

// TX threads along N (RN columns each), TY along M (RM rows each), TZ along
// K (each takes kTKW / TZ words of every step).  TX * TY * TZ == kThreads.
template <bool INT4, int TM, int TN, int TX, int TY, int TZ, int RM, int RN>
__global__ void __launch_bounds__(kThreads)
wqt_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
              const uint8_t* __restrict__ codes, const float* __restrict__ scales,
              float* __restrict__ out, int* __restrict__ partial, int M, int N,
              int K, int k_per_seg, int direct, int vec_ok) {
  static_assert(TX * TY * TZ == kThreads, "thread layout");
  static_assert(TX * RN == TN && TY * RM == TM, "tile layout");
  static_assert(kTKW % TZ == 0, "k split");
  constexpr int kRowBytes = INT4 ? kTK / 2 : kTK;   // code bytes per tile row
  constexpr int kChunks = kRowBytes / 16;
  constexpr int kWz = kTKW / TZ;

  // xw[kw][m], ww[kw][n]: word-major, so reads along m or n are contiguous
  // across the warp; xw padded one column against bank conflicts on store.
  // With TZ > 1 the int32 reduction buffer aliases ww.
  __shared__ int xw[kTKW][TM + 1];
  __shared__ int ww[kTKW][TN];

  const int t = threadIdx.x;
  const int tx = t % TX;
  const int ty = (t / TX) % TY;
  const int tz = t / (TX * TY);
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int row_bytes = INT4 ? K / 2 : K;
  const int m_rows = min(TM, M - m0);
  const int k_begin = blockIdx.z * k_per_seg;
  const int k_end = min(K, k_begin + k_per_seg);
  const int end_bytes = INT4 ? k_end / 2 : k_end;

  int acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    // ---- activation words -> xw, zero outside M and the segment
    for (int e = t; e < TM * kTKW; e += kThreads) {
      const int m = e / kTKW, kw = e % kTKW;
      const int gm = m0 + m, gk = k0 + 4 * kw;
      uint32_t word = 0;
      if (gm < M) {
        const int8_t* src = xq + (size_t)gm * K + gk;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (gk + q < k_end)
            word |= (static_cast<uint32_t>(static_cast<uint8_t>(src[q])) << (8 * q));
      }
      xw[kw][m] = static_cast<int>(word);
    }
    // ---- code tile -> ww (int8 words), 16 bytes per load where aligned
    for (int c = t; c < TN * kChunks; c += kThreads) {
      const int n = c % TN, part = c / TN;
      const int gn = n0 + n;
      const int byte0 = (INT4 ? k0 / 2 : k0) + part * 16;
      uint8_t b[16];
      const uint8_t* src = codes + (size_t)gn * row_bytes + byte0;
      if (gn < N && vec_ok && byte0 + 16 <= end_bytes &&
          (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 16; ++q) b[q] = (w4[q / 4] >> (8 * (q % 4))) & 0xFF;
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q)
          b[q] = (gn < N && byte0 + q < end_bytes) ? src[q] : 0;
      }
      if (INT4) {
        // 16 bytes = 32 codes = 8 words
#pragma unroll
        for (int q = 0; q < 8; ++q) ww[part * 8 + q][n] = pack4(b[2 * q], b[2 * q + 1]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ww[part * 4 + q][n] = static_cast<int>(
              b[4 * q] | (b[4 * q + 1] << 8) | (b[4 * q + 2] << 16) |
              (static_cast<uint32_t>(b[4 * q + 3]) << 24));
      }
    }
    __syncthreads();

    // ---- register-tiled __dp4a over this thread's words
#pragma unroll
    for (int kw = tz * kWz; kw < (tz + 1) * kWz; ++kw) {
      int w[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) w[j] = ww[kw][tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        if (ty + TY * i < m_rows) {
          const int a = xw[kw][ty + TY * i];
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = __dp4a(a, w[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  if (TZ > 1) {
    // add the TZ partial tiles (int32, exact) through shared memory
    int* red = &ww[0][0];                    // TM * TN ints <= kTKW * TN
    static_assert(TZ == 1 || TM <= kTKW, "reduction buffer fits in ww");
    for (int z = 0; z < TZ; ++z) {
      if (tz == z) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int idx = (ty + TY * i) * TN + tx + TX * j;
            red[idx] = (z == 0 ? 0 : red[idx]) + acc[i][j];
          }
      }
      __syncthreads();
    }
    for (int e = t; e < TM * TN; e += kThreads) {
      const int m = e / TN, n = e % TN;
      const int gm = m0 + m, gn = n0 + n;
      if (gm < M && gn < N) {
        const size_t o = (size_t)gm * N + gn;
        if (direct)
          out[o] = __fmul_rn(__fmul_rn(__int2float_rn(red[e]), xs[gm]), scales[0]);
        else
          partial[(size_t)blockIdx.z * M * N + o] = red[e];
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
          if (direct)
            out[o] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), xs[gm]),
                               scales[0]);
          else
            partial[(size_t)blockIdx.z * M * N + o] = acc[i][j];
        }
      }
  }
}

// The segments' int32 sums -> out.  Per tensor (kb == 0): add them (exact),
// then (float(acc) * xs) * s.  Blockwise: fold float(acc_b) * s_b in block
// order, one rounding per product and per sum, then * xs.
__global__ void __launch_bounds__(kThreads)
a8_epilogue_kernel(const int* __restrict__ partial, const float* __restrict__ xs,
                   const float* __restrict__ scales, float* __restrict__ out,
                   int M, int N, int segs, int kb) {
  const size_t count = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
  if (kb == 0) {
    int acc = 0;
    for (int z = 0; z < segs; ++z) acc += partial[(size_t)z * count + i];
    out[i] = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs[m]), scales[0]);
  } else {
    float f = 0.f;
    for (int b = 0; b < kb; ++b)
      f = __fadd_rn(f, __fmul_rn(__int2float_rn(partial[(size_t)b * count + i]),
                                 scales[(size_t)n * kb + b]));
    out[i] = __fmul_rn(f, xs[m]);
  }
}

constexpr int kSmallM = 16;              // M <= 16: the decode tiling
constexpr int kTargetBlocks = 2 * 132;   // two blocks on each of 132 SMs

// Segments of K: blockwise one per quant block; per tensor splits of a
// multiple of kTK until the grid has about kTargetBlocks blocks.
int segments(int M, int N, int K, int block_k, int* k_per_seg) {
  if (block_k > 0) {
    *k_per_seg = block_k;
    return K / block_k;
  }
  const int tm = M <= kSmallM ? 16 : 64, tn = M <= kSmallM ? 128 : 64;
  const int tiles = ((N + tn - 1) / tn) * ((M + tm - 1) / tm);
  const int steps = (K + kTK - 1) / kTK;
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > steps ? steps : splits);
  const int steps_per = (steps + splits - 1) / splits;
  *k_per_seg = steps_per * kTK;
  return (steps + steps_per - 1) / steps_per;
}

template <bool INT4>
cudaError_t launch(const int8_t* xq, const float* xs, const uint8_t* codes,
                   const float* scales, float* out, int* partial, int M, int N,
                   int K, int block_k, int vec_ok, cudaStream_t stream) {
  int k_per_seg = 0;
  const int segs = segments(M, N, K, block_k, &k_per_seg);
  const int direct = (block_k <= 0 && segs == 1) ? 1 : 0;
  if (M <= kSmallM) {
    constexpr int TM = 16, TN = 128;
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, segs);
    wqt_a8_kernel<INT4, TM, TN, 32, 1, 8, 16, 4><<<grid, kThreads, 0, stream>>>(
        xq, xs, codes, scales, out, partial, M, N, K, k_per_seg, direct, vec_ok);
  } else {
    constexpr int TM = 64, TN = 64;
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, segs);
    wqt_a8_kernel<INT4, TM, TN, 16, 16, 1, 4, 4><<<grid, kThreads, 0, stream>>>(
        xq, xs, codes, scales, out, partial, M, N, K, k_per_seg, direct, vec_ok);
  }
  if (!direct) {
    const size_t count = (size_t)M * N;
    a8_epilogue_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(partial, xs, scales, out, M, N, segs,
                                      block_k > 0 ? segs : 0);
  }
  return cudaGetLastError();
}

}  // namespace

// Number of int32 (M, N) partial tiles the launch writes (0: none, the
// first kernel writes the output).  The wrapper allocates that workspace.
extern "C" int wqt_matmul_a8_segments(int M, int N, int K, int block_k) {
  int k_per_seg = 0;
  const int segs = segments(M, N, K, block_k, &k_per_seg);
  return (block_k <= 0 && segs == 1) ? 0 : segs;
}

// bits: 4 or 8.  block_k: -1 per tensor, else a multiple of 4 dividing K
// (even for int4; checked by the wrapper).  workspace: int32 (segments, M,
// N) or null.  vec_ok: 1 when every code row starts 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int wqt_matmul_a8_launch(const void* xq, const void* xs,
                                    const void* codes, const void* scales,
                                    void* out, void* workspace, int M, int N,
                                    int K, int block_k, int bits, int vec_ok,
                                    void* stream) {
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const float* xsp = static_cast<const float*>(xs);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  int* wp = static_cast<int*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bits == 4
      ? launch<true>(xp, xsp, cp, sp, op, wp, M, N, K, block_k, vec_ok, st)
      : launch<false>(xp, xsp, cp, sp, op, wp, M, N, K, block_k, vec_ok, st);
}
