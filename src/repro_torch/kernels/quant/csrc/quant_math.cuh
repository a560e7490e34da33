// Elementwise quantization math shared by the quant, lotion_reg and
// opt_step kernels: the block scale, the representable brackets (lo, hi)
// for INT-n grids and the FP4 e2m1 codebook, deterministic block sums and
// maxima, and the pieces of the persistent per-matrix kernels (the chunk
// walk of kernels/quant/ops.py::plan, the in-kernel absmax phase and the
// 16-byte streaming helpers).
//
// Every operation rounds once, as the plain PyTorch versions (and the JAX
// reference) do: products, sums and quotients use the _rn intrinsics, which
// nvcc never contracts into fused multiply-adds, so the kernels' elementwise
// outputs are bitwise equal to the plain versions'.  The semantics are
// core/quantize.py's: brackets in w-space, z = w / s clipped to the grid
// (NaN propagates, like torch.clamp), and for FP4 `hi` is the first code
// >= z and `lo` equals `hi` when z is a code (jnp.searchsorted).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qm {

constexpr int kThreads = 256;

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clampf(float z, float lo, float hi) {
  return z != z ? z : fminf(fmaxf(z, lo), hi);
}

// torch.amax: NaN wins
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// fmt.scale(absmax): absmax / qmax, 1 for an all-zero block
__device__ __forceinline__ float scale_of(float absmax, float qmax) {
  return absmax > 0.f ? __fdiv_rn(absmax, qmax) : 1.f;
}

__device__ __forceinline__ void int_brackets(float w, float s, float qmax,
                                             float& lo, float& hi) {
  float z = clampf(__fdiv_rn(w, s), -qmax, qmax);
  lo = __fmul_rn(floorf(z), s);
  hi = __fmul_rn(ceilf(z), s);
}

__device__ __forceinline__ void fp4_brackets(float w, float s, float& lo,
                                             float& hi) {
  constexpr float c[15] = {-6.f, -4.f, -3.f, -2.f, -1.5f, -1.f, -0.5f, 0.f,
                           0.5f, 1.f,  1.5f, 2.f,  3.f,  4.f,  6.f};
  float z = clampf(__fdiv_rn(w, s), -6.f, 6.f);
  float h = c[14], l = c[14];          // z NaN: searchsorted gives the end
#pragma unroll
  for (int k = 14; k >= 0; --k) {
    if (c[k] >= z) {                   // the smallest such k wins
      h = c[k];
      l = c[k > 0 ? k - 1 : 0];
    }
  }
  lo = __fmul_rn(h > z ? l : h, s);
  hi = __fmul_rn(h, s);
}

template <bool FP4>
__device__ __forceinline__ void brackets(float w, float s, float qmax,
                                         float& lo, float& hi) {
  if (FP4) fp4_brackets(w, s, lo, hi);
  else int_brackets(w, s, qmax, lo, hi);
}

// Largest |w| over one warp's values (NaN wins), the same on every lane.
__device__ __forceinline__ float warp_absmax(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Sum of one double per thread over the block in a fixed order; the result
// is valid on thread 0.  Needs blockDim.x == kThreads.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? part[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// --------------------------------------------------------------------------
// Persistent per-matrix kernels: the chunk walk, the absmax phase and the
// 16-byte streams
// --------------------------------------------------------------------------

constexpr int kVecStride = kThreads * 4;   // elements between a thread's vectors
constexpr int kScanUnroll = 8;   // absmax phase: vectors per thread in flight

// The work split of one launch (ops.py::plan): n_mats matrices of mat_numel
// elements, each cut into `chunks` chunks of `chunk` elements (a multiple
// of kVecStride; a matrix's last chunk shorter); a block walks chunks
// blockIdx.x, + gridDim.x, ..., so at any time the blocks stream one window
// of consecutive chunks.  The absmax phase walks the first `scan` chunks
// of each matrix (all of them: scan == chunks in every plan the wrapper
// makes).
struct Walk {
  int64_t mat_numel, n_mats, chunk, chunks, scan;
};

// Element range [s, e) of chunk j of matrix m.
__device__ __forceinline__ void chunk_range(const Walk& wk, int64_t m,
                                            int64_t j, int64_t& s,
                                            int64_t& e) {
  const int64_t base = m * wk.mat_numel;
  s = base + j * wk.chunk;
  e = min(s + wk.chunk, base + wk.mat_numel);
}

// A block's chunks of a walk with `per` chunks per matrix, as (m, j):
// chunk blockIdx.x, then every gridDim.x-th, stepping without a division.
struct ChunkIter {
  int64_t m, j, dm, dj, per, left;
  __device__ __forceinline__ ChunkIter(const Walk& wk, int64_t per_mat)
      : per(per_mat) {
    const int64_t total = wk.n_mats * per_mat;
    left = blockIdx.x < total ? (total - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    m = per ? blockIdx.x / per : 0;
    j = blockIdx.x - m * per;
    dm = per ? gridDim.x / per : 0;
    dj = gridDim.x - dm * per;
  }
  __device__ __forceinline__ void next() {
    --left;
    m += dm;
    j += dj;
    if (j >= per) { j -= per; ++m; }
  }
};

// The 16-byte-aligned middle [a, b) of [s, e): `off` is the first
// element's offset from a 16-byte boundary ((address / 4) % 4 of element
// 0), the same for every stream of the call; vec = 0 (streams not alike
// aligned) leaves the whole range to the scalar prologue.
__device__ __forceinline__ void vec_range(int64_t s, int64_t e, int off,
                                          int vec, int64_t& a, int64_t& b) {
  if (!vec) { a = b = e; return; }
  a = min(e, s + ((4 - ((s + off) & 3)) & 3));
  b = a + ((e - a) & ~int64_t(3));
}

// Loads and stores.  ld_keep: a read that a later phase reads again (no L1
// allocation, L2's normal policy); ld_last / st_last: the last use
// (evict-first, __ldcs / __stcs).  A "vector" is 4 elements: 16 bytes of
// fp32 or 8 bytes of bf16 (the bf16 overloads widen to float exactly and
// store rounded to nearest even, as torch's conversion does).
__device__ __forceinline__ float4 ld_keep4(const float* p) {
  float4 v;
  asm volatile("ld.global.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_keep(const float* p) {
  float v;
  asm volatile("ld.global.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 ld_last4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st_last4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ float bf16_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float4 bf16x4(unsigned a, unsigned b) {
  return make_float4(bf16_lo(a), bf16_hi(a), bf16_lo(b), bf16_hi(b));
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float4 ld_keep4(const __nv_bfloat16* p) {
  unsigned a, b;
  asm volatile("ld.global.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(a), "=r"(b) : "l"(p));
  return bf16x4(a, b);
}
__device__ __forceinline__ float ld_keep(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ float4 ld_last4(const __nv_bfloat16* p) {
  const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
  return bf16x4(v.x, v.y);
}
__device__ __forceinline__ void st_last4(__nv_bfloat16* p, float4 v) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                    bf16_bits(v.z) | (bf16_bits(v.w) << 16)));
}
__device__ __forceinline__ float ld_one(const float* p) { return *p; }
__device__ __forceinline__ float ld_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// |w| as bits: for non-negative floats the unsigned order is the float
// order and every NaN sorts above +inf, so an unsigned max is nanmax(|w|),
// exact and independent of order.
__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned abs_bits4(float4 x) {
  return max(max(abs_bits(x.x), abs_bits(x.y)), max(abs_bits(x.z), abs_bits(x.w)));
}

// Largest |w| bits over [s, e), this thread's share (8 vectors in flight);
// T is float or __nv_bfloat16.
template <class T>
__device__ __forceinline__ unsigned range_absmax(const T* __restrict__ w,
                                                 int64_t s, int64_t e,
                                                 int off, int vec) {
  constexpr int U = kScanUnroll;
  int64_t a, b;
  vec_range(s, e, off, vec, a, b);
  unsigned m = 0;
  for (int64_t i = s + threadIdx.x; i < a; i += kThreads) m = max(m, abs_bits(ld_keep(w + i)));
  for (int64_t i0 = a + 4 * threadIdx.x; i0 < b; i0 += int64_t(U) * kVecStride) {
    float4 x[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t i = i0 + int64_t(k) * kVecStride;
      x[k] = i < b ? ld_keep4(w + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) m = max(m, abs_bits4(x[k]));
  }
  for (int64_t i = b + threadIdx.x; i < e; i += kThreads) m = max(m, abs_bits(ld_keep(w + i)));
  return m;
}

// Largest of one unsigned per thread over the block, valid on thread 0.
// Every thread of the block calls it.
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned part[kThreads / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 1; k < kThreads / 32; ++k) m = max(m, part[k]);
  }
  __syncthreads();   // part is written again by the next call
  return m;
}

// Folds the block's largest bits into *dst (one atomicMax).  Every thread
// of the block calls it.
__device__ __forceinline__ void block_absmax_to(unsigned m, unsigned* dst) {
  m = block_max(m);
  if (threadIdx.x == 0 && m) atomicMax(dst, m);
}

// Writes the block's largest bits to *dst (a plain store, zero included).
// Every thread of the block calls it.
__device__ __forceinline__ void block_max_to(unsigned m, unsigned* dst) {
  m = block_max(m);
  if (threadIdx.x == 0) *dst = m;
}

// Phase 1: each matrix's largest |w| bits into amax[m] (zeroed by the
// wrapper), over the first wk.scan chunks of each matrix.  A block keeps a
// running max in registers and folds it once per matrix it touches.
template <class T>
__device__ __forceinline__ void scan_absmax(const T* __restrict__ w,
                                           unsigned* amax, const Walk& wk,
                                           int off, int vec) {
  int64_t cur = -1;
  unsigned m = 0;
  for (ChunkIter it(wk, wk.scan); it.left > 0; it.next()) {
    if (it.m != cur) {                 // block-uniform
      if (cur >= 0) block_absmax_to(m, amax + cur);
      cur = it.m;
      m = 0;
    }
    int64_t s, e;
    chunk_range(wk, it.m, it.j, s, e);
    m = max(m, range_absmax(w, s, e, off, vec));
  }
  if (cur >= 0) block_absmax_to(m, amax + cur);
}

// Phase 2's visit of [s, e): vec_body(i0, b) for this thread's U vectors
// at i0, i0 + kVecStride, ... (those < b), one_body(i) for the scalar
// prologue and epilogue.
template <int U, class VecBody, class OneBody>
__device__ __forceinline__ void stream_range(int64_t s, int64_t e, int off,
                                             int vec, VecBody vec_body,
                                             OneBody one_body) {
  int64_t a, b;
  vec_range(s, e, off, vec, a, b);
  for (int64_t i = s + threadIdx.x; i < a; i += kThreads) one_body(i);
  for (int64_t i0 = a + 4 * threadIdx.x; i0 < b; i0 += int64_t(U) * kVecStride)
    vec_body(i0, b);
  for (int64_t i = b + threadIdx.x; i < e; i += kThreads) one_body(i);
}

// One warp's visit of the quant block [s, e) (blockwise scales): as float4
// where v4 (the block starts 16-byte aligned), its ragged tail element by
// element.
template <class VecBody, class OneBody>
__device__ __forceinline__ void warp_range(int64_t s, int64_t e, bool v4,
                                           VecBody vec_body,
                                           OneBody one_body) {
  const int lane = threadIdx.x & 31;
  int64_t b = s;
  if (v4) {
    b = s + ((e - s) & ~int64_t(3));
    for (int64_t i = s + 4 * lane; i < b; i += 128) vec_body(i);
  }
  for (int64_t i = b + lane; i < e; i += 32) one_body(i);
}

// The last block of a launch to call this adds the blocks' double partial
// sums in block order and writes out[0] = 0.5 * sum (the penalty's 1/2),
// rounded to fp32 once: deterministic for a given grid.  *ticket is zeroed
// by the wrapper.  Every thread of every block calls it.
__device__ __forceinline__ void penalty_epilogue(double acc,
                                                 double* partials,
                                                 unsigned* ticket,
                                                 float* out) {
  __shared__ bool last;
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double v = 0.0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
    v += __ldcg(partials + i);
  v = block_sum(v);
  if (threadIdx.x == 0) out[0] = 0.5f * static_cast<float>(v);
}

}  // namespace qm
