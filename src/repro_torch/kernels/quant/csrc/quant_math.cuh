// Elementwise quantization math shared by the quant, lotion_reg and
// opt_step kernels: the block scale, the representable brackets (lo, hi)
// for INT-n grids and the FP4 e2m1 codebook, and a deterministic block sum.
//
// Every operation rounds once, as the plain PyTorch versions (and the JAX
// reference) do: products, sums and quotients use the _rn intrinsics, which
// nvcc never contracts into fused multiply-adds, so the kernels' elementwise
// outputs are bitwise equal to the plain versions'.  The semantics are
// core/quantize.py's: brackets in w-space, z = w / s clipped to the grid
// (NaN propagates, like torch.clamp), and for FP4 `hi` is the first code
// >= z and `lo` equals `hi` when z is a code (jnp.searchsorted).

#pragma once

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

// One block adds the per-block partial sums in a fixed order and writes
// out[0] = 0.5 * sum (the penalty's 1/2), rounded to fp32 once.  Static:
// every source that includes this header gets its own copy.
static __global__ void __launch_bounds__(kThreads)
half_sum_kernel(const double* __restrict__ partials, int n,
                float* __restrict__ out) {
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) v += partials[i];
  v = block_sum(v);
  if (threadIdx.x == 0) out[0] = 0.5f * static_cast<float>(v);
}

}  // namespace qm
