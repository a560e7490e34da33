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
// What bounds it on an H100: bytes.  With per-matrix scales w is read
// twice (the absmax, then the cast) and the output written once: 12 bytes
// per element (16 with the uniform), at 3.35 TB/s at least 8.7 ms for one
// RTN cast of the 2.43e9 eligible Granite-3-2B weights (5.8 ms if w were
// read once).
//
// The bf16 instance (activations: LMConfig.act_fmt fake-quantizes the
// normed bf16 hidden states per batch row) is the per-matrix RTN cast for
// INT grids with bf16 in and out.  It rounds as core/quantize.py's cast_rtn
// does on a bf16 tensor, once per operation: the scale absmax / qmax and
// the quotient w / s are rounded to bf16 (an fp32 quotient of bf16 values
// rounded to bf16 is the correctly rounded bf16 quotient), then rint,
// clamp, and the product rounded to bf16 by the store.  Its floor is 4
// bytes per element (w read twice, the output written once).
//
// Design.
//   * per matrix (block_size = -1): one cooperative launch of a persistent
//     kernel, as many blocks as are co-resident, on the chunk walk of
//     ops.py::plan.  Phase 1 streams w and folds each matrix's nanmax(|w|)
//     into a zeroed (n_matrices,) buffer with atomicMax on the bits;
//     cooperative_groups' grid barrier; phase 2 streams w (and u) again
//     and casts.  Every stream moves as 16-byte vectors, several per
//     thread in flight (qm::range_absmax, qm::stream_range); a scalar
//     prologue and epilogue take the ends of a chunk that are not 16-byte
//     aligned.  A ring of TMA bulk copies instead of the vector loads
//     gained under 2% on an H100 80GB HBM3 at 700 W
//     (scripts/ablate_quant_opt_torch.py).
//   * blockwise: one warp per quant block of block_size contiguous
//     elements, a plain launch: the lanes take the block's absmax with a
//     warp max, then cast the block (read again, from L1), as float4 where
//     the block starts 16-byte aligned.  The ragged tail block is masked;
//     its absent padding is zeros, which never change an absmax.

#include <cooperative_groups.h>

#include "quant_math.cuh"

namespace {

using qm::kThreads;

struct Args {
  const void* w;         // float, or __nv_bfloat16 for the bf16 instance
  const float* u;        // RR only
  void* out;
  unsigned* amax;        // per matrix: (n_mats,) zeroed |w| bits
  qm::Walk wk;           // per matrix
  int64_t n;             // blockwise
  int block_size;        // blockwise
  int off, vec;          // 16-byte alignment of every stream (qm::vec_range)
  float qmax;
};

// Rounds to T's precision (bf16: to nearest even; float: nothing).
template <class T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <bool FP4, bool RR, class T = float>
__device__ __forceinline__ float cast_one(float w, float u, float s,
                                          float qmax) {
  if (!RR && !FP4) {
    float q = qm::clampf(rintf(round_to<T>(__fdiv_rn(w, s))), -qmax, qmax);
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

template <bool FP4, bool RR, class T = float>
__device__ __forceinline__ float4 cast4(float4 w, float4 u, float s,
                                        float qmax) {
  return make_float4(cast_one<FP4, RR, T>(w.x, u.x, s, qmax),
                     cast_one<FP4, RR, T>(w.y, u.y, s, qmax),
                     cast_one<FP4, RR, T>(w.z, u.z, s, qmax),
                     cast_one<FP4, RR, T>(w.w, u.w, s, qmax));
}

constexpr int kUnroll = 4;   // phase 2: vectors per thread per stream in flight

template <bool FP4, bool RR, class T = float>
__global__ void __launch_bounds__(kThreads)
quant_matrix_kernel(const Args a) {
  const T* __restrict__ w = static_cast<const T*>(a.w);
  const float* __restrict__ u = a.u;
  T* __restrict__ out = static_cast<T*>(a.out);
  qm::scan_absmax(w, a.amax, a.wk, a.off, a.vec);
  cooperative_groups::this_grid().sync();
  int64_t cur = -1;
  float s = 1.f;
  for (qm::ChunkIter it(a.wk, a.wk.chunks); it.left > 0; it.next()) {
    if (it.m != cur) {
      cur = it.m;
      s = round_to<T>(
          qm::scale_of(__uint_as_float(__ldcg(a.amax + cur)), a.qmax));
    }
    int64_t c0, c1;
    qm::chunk_range(a.wk, it.m, it.j, c0, c1);
    qm::stream_range<kUnroll>(
        c0, c1, a.off, a.vec,
        [&](int64_t i0, int64_t b) {
          float4 x[kUnroll], r[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            const int64_t i = i0 + int64_t(k) * qm::kVecStride;
            if (i < b) {
              x[k] = qm::ld_last4(w + i);
              r[k] = RR ? qm::ld_last4(u + i) : x[k];
            }
          }
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            const int64_t i = i0 + int64_t(k) * qm::kVecStride;
            if (i < b) qm::st_last4(out + i, cast4<FP4, RR, T>(x[k], r[k], s, a.qmax));
          }
        },
        [&](int64_t i) {
          qm::st_one(out + i, cast_one<FP4, RR, T>(qm::ld_one(w + i),
                                                   RR ? u[i] : 0.f, s, a.qmax));
        });
  }
}

template <bool FP4, bool RR>
__global__ void __launch_bounds__(kThreads)
quant_block_kernel(const Args a) {
  const float* __restrict__ w = static_cast<const float*>(a.w);
  const float* __restrict__ u = a.u;
  float* __restrict__ out = static_cast<float*>(a.out);
  const int64_t n = a.n;
  const int bs = a.block_size;
  const bool v4 = a.vec && a.off == 0 && bs % 4 == 0;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t n_blocks = (n + bs - 1) / bs;
  for (int64_t blk = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       blk < n_blocks; blk += n_warps) {
    const int64_t base = blk * bs;
    const int64_t end = base + bs < n ? base + bs : n;
    unsigned m = 0;
    qm::warp_range(
        base, end, v4,
        [&](int64_t i) {
          m = max(m, qm::abs_bits4(*reinterpret_cast<const float4*>(w + i)));
        },
        [&](int64_t i) { m = max(m, qm::abs_bits(w[i])); });
    const float s = qm::scale_of(
        __uint_as_float(__reduce_max_sync(0xffffffffu, m)), a.qmax);
    qm::warp_range(
        base, end, v4,
        [&](int64_t i) {
          const float4 x = *reinterpret_cast<const float4*>(w + i);
          const float4 r = RR ? qm::ld_last4(u + i) : x;
          qm::st_last4(out + i, cast4<FP4, RR>(x, r, s, a.qmax));
        },
        [&](int64_t i) {
          out[i] = cast_one<FP4, RR>(w[i], RR ? u[i] : 0.f, s, a.qmax);
        });
  }
}

const void* pick(int blockwise, int fp4, int rr, int bf16) {
  if (bf16) return (const void*)quant_matrix_kernel<false, false, __nv_bfloat16>;
  if (blockwise) {
    if (fp4) return rr ? (const void*)quant_block_kernel<true, true>
                       : (const void*)quant_block_kernel<true, false>;
    return rr ? (const void*)quant_block_kernel<false, true>
              : (const void*)quant_block_kernel<false, false>;
  }
  if (fp4) return rr ? (const void*)quant_matrix_kernel<true, true>
                     : (const void*)quant_matrix_kernel<true, false>;
  return rr ? (const void*)quant_matrix_kernel<false, true>
            : (const void*)quant_matrix_kernel<false, false>;
}

}  // namespace

// Blocks of the instance (blockwise or per matrix, fp4, rr, bf16) that fit
// on one SM at once (the cooperative launch's limit is this times the SM
// count), or minus the CUDA error.
extern "C" int quant_blocks_per_sm(int blockwise, int fp4, int rr, int bf16) {
  int nb = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, pick(blockwise, fp4, rr, bf16), kThreads, 0);
  return err == cudaSuccess ? nb : -static_cast<int>(err);
}

// w, u (RR only, else null), out: n contiguous fp32, or with bf16 = 1 w
// and out bf16 (per-matrix RTN on an INT grid only); fp4: 1 for the e2m1
// codebook, else an INT grid of +-qmax.  block_size > 0: blockwise scales,
// a plain launch of `grid` blocks.  block_size = -1: per-matrix scales over
// matrices of mat_numel elements, one cooperative launch of `grid` blocks
// (at most the co-resident count) on the walk (chunk, chunks, scan) of
// ops.py::plan; amax: n / mat_numel zeroed uint32.  Returns the launch's
// CUDA error.
extern "C" int quant_launch(const void* w, const void* u, void* out,
                            void* amax, int64_t n, int64_t mat_numel,
                            int64_t chunk, int64_t chunks, int64_t scan,
                            int block_size, int fp4, float qmax, int grid,
                            int bf16, void* stream) {
  // a vector is 4 elements: 16 bytes of fp32, 8 of bf16
  const uintptr_t vb = bf16 ? 7 : 15;
  const uintptr_t al = reinterpret_cast<uintptr_t>(w) & vb;
  const bool rr = u != nullptr;
  Args a{w, static_cast<const float*>(u), out, static_cast<unsigned*>(amax),
         qm::Walk{mat_numel, n / mat_numel, chunk, chunks, scan}, n,
         block_size, static_cast<int>(al >> (bf16 ? 1 : 2)),
         (reinterpret_cast<uintptr_t>(out) & vb) == al &&
             (!rr || (reinterpret_cast<uintptr_t>(u) & vb) == al),
         qmax};
  void* args[] = {&a};
  const bool blockwise = block_size > 0;
  const void* k = pick(blockwise, fp4, rr, bf16);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      blockwise ? cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args, 0, s)
                : cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads),
                                              args, 0, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
