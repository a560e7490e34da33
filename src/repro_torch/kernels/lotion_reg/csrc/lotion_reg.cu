// Fused LOTION regularizer (paper Eq. 3), value and gradient in one
// launch, for Hopper.
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
// weights at least 8.71 ms per step at 3.35 TB/s.  A kernel that takes the
// per-matrix absmax without a second read of w must hold the leaf on chip,
// which a Granite leaf (up to 2.7 GB) does not fit; reading w twice puts
// the floor at 16 bytes per element, 11.61 ms.
//
// Design.  Every call is exactly one launch, with nothing zeroed before it:
// the wrapper allocates the outputs and any scratch with torch.empty, and
// every scratch slot a launch reads it has written first.  The penalty is
// summed in double without atomics, in a fixed order that depends only on
// the shape and the plan (each thread adds its elements in order, each
// block its threads in a fixed tree, one block the blocks' partials in
// block order), so the value is the same on every run.  ops.py::plan picks
// one of three regimes:
//   * grid (per-matrix scales, large leaves): one cooperative launch of a
//     persistent kernel on kernels/quant/ops.py::plan's chunk walk.
//     Phase 1 streams w as 16-byte vectors (qm::range_absmax); each block
//     keeps a running max over each run of consecutive chunks it walks in
//     one matrix and writes it to the run's slot.  A block's run in matrix
//     m starts at one of the matrix's first min(grid, scan) chunks, and
//     each of those starts exactly one run, so that slot table is written
//     whole.  Grid barrier; block b folds the slots of matrices b, b +
//     grid, ... into amax[m], then another grid barrier (a leaf of one
//     matrix skips both: every block folds the one table itself); phase 2
//     streams w (again) and f and writes grad, 16 bytes at a time; each
//     block writes its partial; grid barrier; block 0 adds the partials in
//     order.
//   * cluster (per-matrix scales, leaves under a size threshold): launch
//     and barrier costs set the time, not bytes.  One thread block cluster
//     of up to 16 blocks walks the matrices in turn; block r takes chunk r
//     of each.  The blocks exchange their maxima through distributed
//     shared memory after a cluster barrier (no grid-wide barrier, no
//     device-memory scratch, no cooperative launch); phase 2 re-reads w
//     from L2; the leader block adds the blocks' partials in rank order.
//     Its 16 SMs stream at about 26 GB/s each, bounded by the loads a
//     block keeps in flight (an L2 prefetch of each block's chunks by the
//     TMA unit gained 3-8%), so above the threshold the grid is faster.
//   * block (blockwise scales): one warp per quant block, the block's
//     absmax by a warp max, then the block read again (from L1), as
//     float4 where it starts 16-byte aligned (INT grids); a cooperative
//     launch so that block 0 adds the partials in order after a grid
//     barrier.

#include <cooperative_groups.h>

#include "../../quant/csrc/quant_math.cuh"

namespace cg = cooperative_groups;

namespace {

using qm::kThreads;

enum Regime { kCluster = 0, kGrid = 1, kBlock = 2 };
constexpr int kMaxCluster = 16;   // the H100's largest (non-portable) cluster
constexpr int kUnroll = 4;        // phase 2: vectors per thread per stream in flight

struct Args {
  const float* w;
  const float* f;
  float* grad;
  double* partials;     // grid, block: one per block
  unsigned* slots;      // grid: n_mats * min(grid, scan) run maxima (|w| bits)
  unsigned* amax;       // grid, several matrices: n_mats folded maxima
  const unsigned* given;  // per-matrix regimes: n_mats |w| bits folded in, or null
  float* pen;
  qm::Walk wk;          // per matrix
  int64_t n;            // blockwise
  int block_size;       // blockwise
  int off, vec;         // 16-byte alignment of every stream (qm::vec_range)
  int n_sum;            // partials the penalty's sum adds
  float qmax, half_lam;
};

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
__device__ __forceinline__ float4 reg4(float4 w, float4 f, float s,
                                       float qmax, float half_lam,
                                       double& acc) {
  float4 g;   // one statement each: the penalty's terms added in order
  g.x = reg_one<FP4>(w.x, f.x, s, qmax, half_lam, acc);
  g.y = reg_one<FP4>(w.y, f.y, s, qmax, half_lam, acc);
  g.z = reg_one<FP4>(w.z, f.z, s, qmax, half_lam, acc);
  g.w = reg_one<FP4>(w.w, f.w, s, qmax, half_lam, acc);
  return g;
}

// Phase 2 over [c0, c1) of one matrix with scale s.
template <bool FP4>
__device__ __forceinline__ void reg_range(const Args& a, int64_t c0,
                                          int64_t c1, float s, double& acc) {
  const float* __restrict__ w = a.w;
  const float* __restrict__ f = a.f;
  float* __restrict__ grad = a.grad;
  qm::stream_range<kUnroll>(
      c0, c1, a.off, a.vec,
      [&](int64_t i0, int64_t b) {
        float4 W[kUnroll], F[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int64_t i = i0 + int64_t(k) * qm::kVecStride;
          if (i < b) {
            W[k] = qm::ld_last4(w + i);
            F[k] = qm::ld_last4(f + i);
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int64_t i = i0 + int64_t(k) * qm::kVecStride;
          if (i < b)
            qm::st_last4(grad + i, reg4<FP4>(W[k], F[k], s, a.qmax,
                                             a.half_lam, acc));
        }
      },
      [&](int64_t i) {
        grad[i] = reg_one<FP4>(w[i], f[i], s, a.qmax, a.half_lam, acc);
      });
}

// The grid and block regimes' end: each block's partial, a grid barrier,
// then block 0 adds the first n_sum partials in order and writes
// pen = 0.5 * sum, rounded to fp32 once.
__device__ __forceinline__ void grid_penalty(double acc, const Args& a) {
  acc = qm::block_sum(acc);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = acc;
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;
  double v = 0.0;
  for (int i = threadIdx.x; i < a.n_sum; i += kThreads)
    v += __ldcg(a.partials + i);
  v = qm::block_sum(v);
  if (threadIdx.x == 0) a.pen[0] = 0.5f * static_cast<float>(v);
}

// Matrix mat's given |w| bits (a sharded leaf's block takes its whole
// matrix's absmax), 0 where none is given: folding it into the block's
// own maxima leaves the given value, which is at least them.
__device__ __forceinline__ unsigned given_bits(const Args& a, int64_t mat) {
  return a.given ? __ldg(a.given + mat) : 0u;
}

// The largest of slots[0, S), on every thread of the block.
__device__ __forceinline__ unsigned fold_slots(const unsigned* slots,
                                               int64_t S) {
  __shared__ unsigned all;
  unsigned v = 0;
  for (int64_t j = threadIdx.x; j < S; j += kThreads)
    v = max(v, __ldcg(slots + j));
  v = qm::block_max(v);
  if (threadIdx.x == 0) all = v;
  __syncthreads();
  return all;
}

template <bool FP4>
__global__ void __launch_bounds__(kThreads)
reg_grid_kernel(const Args a) {
  const qm::Walk& wk = a.wk;
  // run slots per matrix: a run starts at one of the first min(grid, scan)
  const int64_t S = min(static_cast<int64_t>(gridDim.x), wk.scan);
  {  // phase 1: each run's max into its slot
    int64_t cur = -1, slot = 0;
    unsigned m = 0;
    for (qm::ChunkIter it(wk, wk.scan); it.left > 0; it.next()) {
      if (it.m != cur) {               // block-uniform
        if (cur >= 0) qm::block_max_to(m, a.slots + slot);
        cur = it.m;
        slot = it.m * S + it.j;
        m = 0;
      }
      int64_t s, e;
      qm::chunk_range(wk, it.m, it.j, s, e);
      m = max(m, qm::range_absmax(a.w, s, e, a.off, a.vec));
    }
    if (cur >= 0) qm::block_max_to(m, a.slots + slot);
  }
  cg::this_grid().sync();
  // One matrix: every block folds its slots itself.  Several: block b
  // folds matrices b, b + grid, ... into amax, behind one more barrier.
  const bool one = wk.n_mats == 1;
  float s = one ? qm::scale_of(__uint_as_float(max(fold_slots(a.slots, S),
                                                   given_bits(a, 0))),
                               a.qmax)
                : 1.f;
  if (!one) {
    for (int64_t mat = blockIdx.x; mat < wk.n_mats; mat += gridDim.x) {
      const unsigned v = max(fold_slots(a.slots + mat * S, S),
                             given_bits(a, mat));
      if (threadIdx.x == 0) a.amax[mat] = v;
    }
    cg::this_grid().sync();
  }
  double acc = 0.0;
  int64_t cur = -1;
  for (qm::ChunkIter it(wk, wk.chunks); it.left > 0; it.next()) {
    if (!one && it.m != cur) {
      cur = it.m;
      s = qm::scale_of(__uint_as_float(__ldcg(a.amax + cur)), a.qmax);
    }
    int64_t c0, c1;
    qm::chunk_range(wk, it.m, it.j, c0, c1);
    reg_range<FP4>(a, c0, c1, s, acc);
  }
  grid_penalty(acc, a);
}

template <bool FP4>
__global__ void __launch_bounds__(kThreads)
reg_cluster_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ unsigned slot[2];   // this block's max, by matrix parity
  __shared__ double partial;
  const qm::Walk& wk = a.wk;
  const int64_t r = cluster.block_rank();   // the grid is one cluster
  const int lane = threadIdx.x & 31;
  const int S = static_cast<int>(min(static_cast<int64_t>(gridDim.x), wk.scan));
  double acc = 0.0;
  for (int64_t mat = 0; mat < wk.n_mats; ++mat) {
    int64_t c0, c1;
    unsigned m = 0;
    if (r < wk.scan) {
      qm::chunk_range(wk, mat, r, c0, c1);
      m = qm::range_absmax(a.w, c0, c1, a.off, a.vec);
    }
    m = qm::block_max(m);
    if (threadIdx.x == 0) slot[mat & 1] = m;
    // every block's max written; a slot is written again two matrices on,
    // after the next barrier, which every reader of it has passed
    cluster.sync();
    unsigned v = lane < S ? *cluster.map_shared_rank(&slot[mat & 1], lane) : 0u;
    v = max(__reduce_max_sync(0xffffffffu, v), given_bits(a, mat));
    if (r < wk.chunks) {
      qm::chunk_range(wk, mat, r, c0, c1);
      reg_range<FP4>(a, c0, c1, qm::scale_of(__uint_as_float(v), a.qmax), acc);
    }
  }
  acc = qm::block_sum(acc);
  if (threadIdx.x == 0) partial = acc;
  cluster.sync();
  if (r == 0 && threadIdx.x == 0) {
    double v = 0.0;
    for (int k = 0; k < a.n_sum; ++k) v += *cluster.map_shared_rank(&partial, k);
    a.pen[0] = 0.5f * static_cast<float>(v);
  }
  cluster.sync();   // every block's partial stays until the leader has read it
}

template <bool FP4>
__global__ void __launch_bounds__(kThreads)
reg_block_kernel(const Args a) {
  const float* __restrict__ w = a.w;
  const float* __restrict__ f = a.f;
  float* __restrict__ grad = a.grad;
  const int64_t n = a.n;
  const int bs = a.block_size;
  // FP4's codebook search runs faster element by element than as float4
  // (scripts/ablate_lotion_reg_torch.py, variant fp4_vec)
  const bool v4 = !FP4 && a.vec && a.off == 0 && bs % 4 == 0;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t n_blocks = (n + bs - 1) / bs;
  double acc = 0.0;
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
          qm::st_last4(grad + i,
                       reg4<FP4>(*reinterpret_cast<const float4*>(w + i),
                                 qm::ld_last4(f + i), s, a.qmax, a.half_lam,
                                 acc));
        },
        [&](int64_t i) {
          grad[i] = reg_one<FP4>(w[i], f[i], s, a.qmax, a.half_lam, acc);
        });
  }
  grid_penalty(acc, a);
}

const void* pick(int regime, int fp4) {
  switch (regime) {
    case kCluster:
      return fp4 ? (const void*)reg_cluster_kernel<true>
                 : (const void*)reg_cluster_kernel<false>;
    case kGrid:
      return fp4 ? (const void*)reg_grid_kernel<true>
                 : (const void*)reg_grid_kernel<false>;
    default:
      return fp4 ? (const void*)reg_block_kernel<true>
                 : (const void*)reg_block_kernel<false>;
  }
}

cudaError_t launch_cluster(const void* k, int fp4, int grid, void** args,
                           cudaStream_t s) {
  if (grid < 1 || grid > kMaxCluster) return cudaErrorInvalidValue;
  static bool nonportable[2] = {false, false};
  if (grid > 8 && !nonportable[fp4]) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    nonportable[fp4] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, k, args);
}

}  // namespace

// Blocks of the instance (regime 1 grid or 2 block, fp4) that fit on one
// SM at once (the cooperative launch's limit is this times the SM count),
// or minus the CUDA error.
extern "C" int lotion_reg_blocks_per_sm(int regime, int fp4) {
  int nb = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, pick(regime, fp4), kThreads, 0);
  return err == cudaSuccess ? nb : -static_cast<int>(err);
}

// w, f, grad: n contiguous fp32; pen: one fp32, the unscaled penalty;
// half_lam: lam / 2, the gradient's factor; fp4: 1 for the e2m1 codebook,
// else an INT grid of +-qmax.  regime (ops.py::plan): 0 cluster (one
// cluster of `grid` <= 16 blocks), 1 grid (one cooperative launch of
// `grid` blocks, at most the co-resident count) over matrices of mat_numel
// elements on the walk (chunk, chunks, scan); 2 block (blockwise scales of
// block_size, a cooperative launch of `grid` blocks).  scratch (none for
// regime 0, ops.py::scratch_bytes): `grid` doubles (the partials), then
// for regime 1 n_mats * min(grid, scan) + n_mats uint32 (the run slots,
// the folded maxima); nothing in it is read before the launch writes it.
// n_sum: the partials the penalty's sum adds (= grid).  given (regimes 0
// and 1, or null): n_mats uint32, each matrix's |w| bits to fold into its
// absmax.  Returns the launch's CUDA error.
extern "C" int lotion_reg_launch(const void* w, const void* f, void* grad,
                                 void* scratch, void* pen, int64_t n,
                                 int64_t mat_numel, int64_t chunk,
                                 int64_t chunks, int64_t scan,
                                 int block_size, int regime, int fp4,
                                 float qmax, float half_lam, int grid,
                                 int n_sum, const void* given,
                                 void* stream) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(w) & 15;
  const int64_t n_mats = mat_numel > 0 ? n / mat_numel : 0;
  const int64_t S = grid < scan ? grid : scan;
  double* partials = static_cast<double*>(scratch);
  unsigned* slots =
      regime == kGrid ? reinterpret_cast<unsigned*>(partials + grid) : nullptr;
  Args a{static_cast<const float*>(w), static_cast<const float*>(f),
         static_cast<float*>(grad), partials, slots,
         slots ? slots + n_mats * S : nullptr,
         static_cast<const unsigned*>(given), static_cast<float*>(pen),
         qm::Walk{mat_numel, n_mats, chunk, chunks, scan}, n, block_size,
         static_cast<int>(al >> 2),
         (reinterpret_cast<uintptr_t>(f) & 15) == al &&
             (reinterpret_cast<uintptr_t>(grad) & 15) == al,
         n_sum, qmax, half_lam};
  void* args[] = {&a};
  const void* k = pick(regime, fp4);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      regime == kCluster
          ? launch_cluster(k, fp4, grid, args, s)
          : cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), args,
                                        0, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
