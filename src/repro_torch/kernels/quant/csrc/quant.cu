// Fused absmax-scale + round + dequantize cast, for Hopper.
//
// Replaces: src/repro/kernels/quant/quant_blockwise.py::quant_pallas
// (bodies _quant_kernel, _quant_kernel_pretensor).  Computes the RTN cast
// (round to nearest, half to even) or the randomized-rounding cast against
// an explicit uniform per element, for INT-n grids and the FP4 e2m1
// codebook, and writes the dequantized fp32 values.  The contract is
// core/quantize.py's (cast_rtn / cast_rr), not the Pallas kernel's: one
// scale per matrix of a stacked leaf for block_size = -1 (the Pallas
// wrapper takes one over the whole tensor), and the RR threshold in
// w-space, u < (w - lo) / (hi - lo) (the Pallas kernel compares in z-space,
// which can decide a rare element differently).
//
// What bounds it on an H100: bytes.  Each element is read once (4 bytes,
// 8 with the uniform) and written once (4 bytes), with a few dozen
// operations: at 3.35 TB/s one RTN cast of the 2.43e9 eligible Granite-3-2B
// weights needs at least 5.8 ms, an RR cast 8.7 ms.
//
// Design.  Two layouts of one grid-stride pass:
//   * per matrix: the wrapper computes the per-matrix scales with one torch
//     reduction (as the JAX code keeps the absmax outside its kernel) and
//     passes them as a (n_matrices,) vector.  A 2-D grid: blockIdx.y walks
//     the matrices, so a stacked leaf is one launch and each block loads
//     its matrix's scale once (no per-element division to find it);
//     blockIdx.x and the threads walk the matrix, four elements a stride
//     apart per iteration (coalesced, four loads in flight).
//   * blockwise: one warp per quant block of block_size contiguous
//     elements: the lanes take the block's absmax with shuffles, then
//     cast the block (read again, from L1/L2).  The ragged tail block is
//     masked; its absent padding is zeros, which never change an absmax.

#include "quant_math.cuh"

namespace {

using qm::kThreads;

template <bool FP4, bool RR>
__device__ __forceinline__ float cast_one(float w, float u, float s,
                                          float qmax) {
  if (!RR && !FP4) {
    float q = qm::clampf(rintf(__fdiv_rn(w, s)), -qmax, qmax);
    return __fmul_rn(q, s);
  }
  float lo, hi;
  qm::brackets<FP4>(w, s, qmax, lo, hi);
  if (!RR) {  // FP4 round to nearest, ties to lo
    return fabsf(__fsub_rn(w, lo)) <= fabsf(__fsub_rn(hi, w)) ? lo : hi;
  }
  float gap = __fsub_rn(hi, lo);
  float p_hi = gap > 0.f ? __fdiv_rn(__fsub_rn(w, lo), gap) : 0.f;
  return u < p_hi ? hi : lo;
}

template <bool FP4, bool RR>
__global__ void __launch_bounds__(kThreads)
quant_matrix_kernel(const float* __restrict__ w, const float* __restrict__ u,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int64_t n_mats, int64_t mat_numel, float qmax) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t m = blockIdx.y; m < n_mats; m += gridDim.y) {
    const float s = scales[m];
    const int64_t base = m * mat_numel;
    for (int64_t j0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         j0 < mat_numel; j0 += 4 * stride) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t i = base + j0 + k * stride;
        if (j0 + k * stride < mat_numel)
          out[i] = cast_one<FP4, RR>(w[i], RR ? u[i] : 0.f, s, qmax);
      }
    }
  }
}

template <bool FP4, bool RR>
__global__ void __launch_bounds__(kThreads)
quant_block_kernel(const float* __restrict__ w, const float* __restrict__ u,
                   float* __restrict__ out, int64_t n, int block_size,
                   float qmax) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t n_blocks = (n + block_size - 1) / block_size;
  for (int64_t b = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       b < n_blocks; b += n_warps) {
    const int64_t base = b * block_size;
    const int64_t end = base + block_size < n ? base + block_size : n;
    float m = 0.f;
    for (int64_t i = base + lane; i < end; i += 32) m = qm::nanmax(m, fabsf(w[i]));
    const float s = qm::scale_of(qm::warp_absmax(m), qmax);
    for (int64_t i = base + lane; i < end; i += 32)
      out[i] = cast_one<FP4, RR>(w[i], RR ? u[i] : 0.f, s, qmax);
  }
}

template <bool FP4, bool RR>
void launch(const float* w, const float* u, const float* scales, float* out,
            int64_t n, int64_t mat_numel, int block_size, float qmax,
            dim3 grid, cudaStream_t stream) {
  if (block_size > 0)
    quant_block_kernel<FP4, RR><<<grid, kThreads, 0, stream>>>(
        w, u, out, n, block_size, qmax);
  else
    quant_matrix_kernel<FP4, RR><<<grid, kThreads, 0, stream>>>(
        w, u, scales, out, n / mat_numel, mat_numel, qmax);
}

}  // namespace

// w, u (RR only, else null), out: n contiguous fp32; scales: fp32 per
// matrix (block_size = -1, matrices of mat_numel elements) or null
// (block_size > 0); fp4: 1 for the e2m1 codebook, else an INT grid of
// +-qmax.  Grid (grid_x, grid_y): per matrix, grid_y blocks walk the
// matrices and grid_x the elements of each; blockwise, grid_y = 1.
// Returns cudaGetLastError().
extern "C" int quant_launch(const void* w, const void* u, const void* scales,
                            void* out, int64_t n, int64_t mat_numel,
                            int block_size, int fp4, float qmax, int grid_x,
                            int grid_y, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  auto wp = static_cast<const float*>(w);
  auto up = static_cast<const float*>(u);
  auto sp = static_cast<const float*>(scales);
  auto op = static_cast<float*>(out);
  const bool rr = u != nullptr;
  if (fp4) {
    if (rr) launch<true, true>(wp, up, sp, op, n, mat_numel, block_size, qmax, grid, s);
    else launch<true, false>(wp, up, sp, op, n, mat_numel, block_size, qmax, grid, s);
  } else {
    if (rr) launch<false, true>(wp, up, sp, op, n, mat_numel, block_size, qmax, grid, s);
    else launch<false, false>(wp, up, sp, op, n, mat_numel, block_size, qmax, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}
