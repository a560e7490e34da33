// Fused LOTION regularizer (paper Eq. 3), value and gradient in one pass,
// for Hopper.
//
// Replaces: src/repro/kernels/lotion_reg/lotion_reg.py::lotion_reg_pallas
// (bodies _reg_kernel, _reg_kernel_pretensor).  For one parameter leaf w
// and its Fisher diagonal f it writes
//     grad = ct (hi - w) - ct (w - lo),   ct = (lam / 2) f
// and the unscaled penalty 1/2 sum f (hi - w)(w - lo), with (lo, hi) the
// representable brackets of w under per-matrix or blockwise absmax scales.
// The gradient is written in the closed form of core/lotion.py
// (lotion_penalty_and_grad, lam folded into ct, lam / 2 folded on the host
// in double), so it is bitwise equal to the plain version; the Pallas
// kernel writes 1/2 f (lo + hi - 2w) at lam = 1, which rounds differently.
//
// What bounds it on an H100: bytes.  w and f are read once and grad is
// written once, 12 bytes per element: for the 2.43e9 eligible Granite-3-2B
// weights at least 8.7 ms per step at 3.35 TB/s.
//
// Design.  The layouts of quant.cu (per-matrix scales on a 2-D grid whose
// y walks the matrices, so a stacked (L, a, b) leaf is one launch instead
// of the Pallas wrapper's vmap over L; or one warp per quant block with a
// shuffle absmax).  The penalty is summed without atomics, in a fixed
// order: each thread adds its elements in double, each block reduces its
// threads in a fixed tree into one partial, and a second one-block kernel
// adds the partials in order, so the value is the same on every run.

#include "../../quant/csrc/quant_math.cuh"

namespace {

using qm::kThreads;

template <bool FP4>
__device__ __forceinline__ float reg_one(float w, float f, float s,
                                         float qmax, float half_lam,
                                         double& acc) {
  float lo, hi;
  qm::brackets<FP4>(w, s, qmax, lo, hi);
  const float a = __fsub_rn(hi, w), b = __fsub_rn(w, lo);
  acc += static_cast<double>(__fmul_rn(f, __fmul_rn(a, b)));
  const float ct = __fmul_rn(half_lam, f);
  return __fsub_rn(__fmul_rn(ct, a), __fmul_rn(ct, b));
}

template <bool FP4>
__global__ void __launch_bounds__(kThreads)
reg_matrix_kernel(const float* __restrict__ w, const float* __restrict__ f,
                  const float* __restrict__ scales, float* __restrict__ grad,
                  double* __restrict__ partials, int64_t n_mats,
                  int64_t mat_numel, float qmax, float half_lam) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  double acc = 0.0;
  for (int64_t m = blockIdx.y; m < n_mats; m += gridDim.y) {
    const float s = scales[m];
    const int64_t base = m * mat_numel;
    for (int64_t j0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         j0 < mat_numel; j0 += 4 * stride) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t i = base + j0 + k * stride;
        if (j0 + k * stride < mat_numel)
          grad[i] = reg_one<FP4>(w[i], f[i], s, qmax, half_lam, acc);
      }
    }
  }
  acc = qm::block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

template <bool FP4>
__global__ void __launch_bounds__(kThreads)
reg_block_kernel(const float* __restrict__ w, const float* __restrict__ f,
                 float* __restrict__ grad, double* __restrict__ partials,
                 int64_t n, int block_size, float qmax, float half_lam) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t n_blocks = (n + block_size - 1) / block_size;
  double acc = 0.0;
  for (int64_t b = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       b < n_blocks; b += n_warps) {
    const int64_t base = b * block_size;
    const int64_t end = base + block_size < n ? base + block_size : n;
    float m = 0.f;
    for (int64_t i = base + lane; i < end; i += 32) m = qm::nanmax(m, fabsf(w[i]));
    const float s = qm::scale_of(qm::warp_absmax(m), qmax);
    for (int64_t i = base + lane; i < end; i += 32)
      grad[i] = reg_one<FP4>(w[i], f[i], s, qmax, half_lam, acc);
  }
  acc = qm::block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <bool FP4>
void launch(const float* w, const float* f, const float* scales, float* grad,
            double* partials, float* pen, int64_t n, int64_t mat_numel,
            int block_size, float qmax, float half_lam, dim3 grid,
            cudaStream_t stream) {
  if (block_size > 0)
    reg_block_kernel<FP4><<<grid, kThreads, 0, stream>>>(
        w, f, grad, partials, n, block_size, qmax, half_lam);
  else
    reg_matrix_kernel<FP4><<<grid, kThreads, 0, stream>>>(
        w, f, scales, grad, partials, n / mat_numel, mat_numel, qmax,
        half_lam);
  qm::half_sum_kernel<<<1, kThreads, 0, stream>>>(partials, grid.x * grid.y,
                                                  pen);
}

}  // namespace

// w, f, grad: n contiguous fp32; scales: fp32 per matrix (block_size = -1)
// or null; partials: grid_x * grid_y doubles of scratch; pen: one fp32,
// the unscaled penalty; half_lam: lam / 2, the gradient's factor.  Grid
// (grid_x, grid_y) from kernels/_build.py::grid_for: per matrix, grid_y
// blocks walk the matrices and grid_x the elements of each; blockwise,
// grid_y = 1.  Returns cudaGetLastError().
extern "C" int lotion_reg_launch(const void* w, const void* f,
                                 const void* scales, void* grad,
                                 void* partials, void* pen, int64_t n,
                                 int64_t mat_numel, int block_size, int fp4,
                                 float qmax, float half_lam, int grid_x,
                                 int grid_y,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  auto args = [&](auto fn) {
    fn(static_cast<const float*>(w), static_cast<const float*>(f),
       static_cast<const float*>(scales), static_cast<float*>(grad),
       static_cast<double*>(partials), static_cast<float*>(pen), n, mat_numel,
       block_size, qmax, half_lam, grid, s);
  };
  if (fp4) args(launch<true>);
  else args(launch<false>);
  return static_cast<int>(cudaGetLastError());
}
