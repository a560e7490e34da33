// Fused clip + decoupled-LOTION + AdamW / SGD optimizer step, one launch
// per parameter leaf, for Hopper.
//
// Replaces: src/repro/kernels/opt_step/opt_step.py::opt_step_pallas (body
// _opt_kernel).  Per element, with f the pre-update nu:
//     g   = g * clip
//     ct  = (lam / 2) f;  g += ct (hi - w) - ct (w - lo)     (penalty modes)
//   AdamW:
//     mu' = b1 mu + (1 - b1) g;   nu' = b2 nu + ((1 - b2) g) g
//     w'  = w - lr ((mu' / bc1) / (sqrt(nu' / bc2) + eps) + wd w)
//   SGD:
//     nu' = fd nu + ((1 - fd) g) g  (with a Fisher EMA, else nu)
//     mu' = m mu + g, step mu'      (with momentum, else mu, step g)
//     w'  = w - lr step
// and the penalty 1/2 sum f (hi - w)(w - lo).  The constants b1, 1 - b1,
// b2, 1 - b2, eps, wd, lam / 2, fd, 1 - fd are folded on the host in
// double and arrive as fp32, as JAX folds its Python floats; the step
// scalars [lr, bc1, bc2, clip, ok] stay on the device (no host sync per
// step).  ok = 0 leaves w, mu, nu as they are (nothing is written): the
// non-finite skip gate.  Every operation rounds once (_rn intrinsics, no
// contraction into FMAs), so w', mu', nu' are bitwise equal to the plain
// version's.
//
// w', mu' and nu' are written IN PLACE over w, mu and nu: each element is
// read and then written by the same thread, and with per-matrix scales the
// grid barrier orders every read of the absmax phase before any write.
//
// What bounds it on an H100: bytes.  It reads w, g, mu, nu and writes w',
// mu', nu', 28 bytes per element, and the per-matrix penalty reads w once
// more for the absmax: 32 bytes.  For Granite-3-2B (2.43e9 eligible of
// 2.53e9 parameters) at least 24.1 ms per step at 3.35 TB/s.
//
// Design.  One launch per leaf whatever its rank, in the layouts of
// quant.cu:
//   * per-matrix scales: one cooperative launch of the persistent kernel
//     on ops.py::plan's chunk walk: phase 1 folds each matrix's nanmax(|w|)
//     into a zeroed buffer (qm::scan_absmax), a grid barrier, then phase 2
//     steps every element;
//   * mode none (lam = 0, or a leaf outside the policy): the same kernel
//     without phase 1 or barrier, a plain launch;
//   * blockwise scales: one warp per quant block, a plain launch.
// Every stream moves as 16-byte vectors (two per thread per stream in
// flight in phase 2), with a scalar prologue and epilogue for unaligned
// chunk ends; a stream the core does not change is not written, one it
// does not read is not loaded.  The penalty partials (double, one per
// block) are added in block order by the last block to finish
// (qm::penalty_epilogue): deterministic, no second launch.

#include <cooperative_groups.h>

#include "../../quant/csrc/quant_math.cuh"

namespace {

using qm::kThreads;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, half_lam, momentum, fd, omfd, qmax;
};

enum Mode { kNone = 0, kMatrix = 1, kBlock = 2 };
enum Core { kAdamW = 0, kSgd = 1 };

struct Args {
  float* w;
  const float* g;
  float* mu;
  float* nu;
  const float* sc;       // [lr, bc1, bc2, clip, ok]
  unsigned* amax;        // per matrix: (n_mats,) zeroed |w| bits
  double* partials;      // penalty modes: one per block
  unsigned* ticket;      // penalty modes: zeroed
  float* pen;            // penalty modes
  qm::Walk wk;           // modes none and matrix
  int64_t n;             // blockwise
  int block_size;        // blockwise
  int off, vec;          // 16-byte alignment of every stream
  Hyper h;
};

struct Scalars {
  float lr, bc1, bc2, clip;
  bool ok;
};

// Which moments a core reads and writes.
template <int CORE, bool PEN, bool HAS_FD, bool HAS_MOM>
struct Streams {
  static constexpr bool mu = CORE == kAdamW || HAS_MOM;
  static constexpr bool nu_out = CORE == kAdamW || HAS_FD;
  static constexpr bool nu_in = nu_out || PEN;
};

template <int CORE, bool PEN, bool FP4, bool HAS_FD, bool HAS_MOM>
__device__ __forceinline__ void step_one(float& w, float g, float& mu,
                                         float& nu, float s, const Hyper& h,
                                         const Scalars& sc, double& acc) {
  const float w0 = w, m0 = mu, n0 = nu;
  float gi = __fmul_rn(g, sc.clip);
  if (PEN) {
    float lo, hi;
    qm::brackets<FP4>(w0, s, h.qmax, lo, hi);
    const float a = __fsub_rn(hi, w0), b = __fsub_rn(w0, lo);
    const float ct = __fmul_rn(h.half_lam, n0);
    gi = __fadd_rn(gi, __fsub_rn(__fmul_rn(ct, a), __fmul_rn(ct, b)));
    acc += static_cast<double>(__fmul_rn(n0, __fmul_rn(a, b)));
  }
  if (CORE == kAdamW) {
    mu = __fadd_rn(__fmul_rn(h.b1, m0), __fmul_rn(h.omb1, gi));
    nu = __fadd_rn(__fmul_rn(h.b2, n0), __fmul_rn(__fmul_rn(h.omb2, gi), gi));
    const float upd = __fdiv_rn(__fdiv_rn(mu, sc.bc1),
                                __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, sc.bc2)), h.eps));
    w = __fsub_rn(w0, __fmul_rn(sc.lr, __fadd_rn(upd, __fmul_rn(h.wd, w0))));
  } else {
    if (HAS_FD)
      nu = __fadd_rn(__fmul_rn(h.fd, n0), __fmul_rn(__fmul_rn(h.omfd, gi), gi));
    if (HAS_MOM) mu = __fadd_rn(__fmul_rn(h.momentum, m0), gi);
    w = __fsub_rn(w0, __fmul_rn(sc.lr, HAS_MOM ? mu : gi));
  }
}

template <int CORE, bool PEN, bool FP4, bool HAS_FD, bool HAS_MOM>
__device__ __forceinline__ void step4(float4& w, float4 g, float4& mu,
                                      float4& nu, float s, const Hyper& h,
                                      const Scalars& sc, double& acc) {
  step_one<CORE, PEN, FP4, HAS_FD, HAS_MOM>(w.x, g.x, mu.x, nu.x, s, h, sc, acc);
  step_one<CORE, PEN, FP4, HAS_FD, HAS_MOM>(w.y, g.y, mu.y, nu.y, s, h, sc, acc);
  step_one<CORE, PEN, FP4, HAS_FD, HAS_MOM>(w.z, g.z, mu.z, nu.z, s, h, sc, acc);
  step_one<CORE, PEN, FP4, HAS_FD, HAS_MOM>(w.w, g.w, mu.w, nu.w, s, h, sc, acc);
}

// One element i by scalar loads and stores (chunk ends, ragged blocks).
template <int CORE, bool PEN, bool FP4, bool HAS_FD, bool HAS_MOM>
__device__ __forceinline__ void step_at(const Args& a, int64_t i, float s,
                                        const Scalars& sc, double& acc) {
  using St = Streams<CORE, PEN, HAS_FD, HAS_MOM>;
  float w = a.w[i], mu = St::mu ? a.mu[i] : 0.f, nu = St::nu_in ? a.nu[i] : 0.f;
  step_one<CORE, PEN, FP4, HAS_FD, HAS_MOM>(w, a.g[i], mu, nu, s, a.h, sc, acc);
  if (sc.ok) {
    a.w[i] = w;
    if (St::mu) a.mu[i] = mu;
    if (St::nu_out) a.nu[i] = nu;
  }
}

__device__ __forceinline__ Scalars load_scalars(const float* sc) {
  return Scalars{sc[0], sc[1], sc[2], sc[3], sc[4] != 0.f};
}

constexpr int kUnroll = 2;   // phase 2: vectors per thread per stream in flight

// Modes none and matrix: the persistent kernel (cooperative in mode matrix).
template <int CORE, int MODE, bool FP4, bool HAS_FD, bool HAS_MOM>
__global__ void __launch_bounds__(kThreads)
opt_step_kernel(const Args a) {
  constexpr bool PEN = MODE == kMatrix;
  using St = Streams<CORE, PEN, HAS_FD, HAS_MOM>;
  float* __restrict__ w = a.w;
  const float* __restrict__ g = a.g;
  float* __restrict__ mu = a.mu;
  float* __restrict__ nu = a.nu;
  const Scalars sc = load_scalars(a.sc);
  if (PEN) {
    qm::scan_absmax(w, a.amax, a.wk, a.off, a.vec);
    cooperative_groups::this_grid().sync();
  }
  double acc = 0.0;
  int64_t cur = -1;
  float s = 1.f;
  for (qm::ChunkIter it(a.wk, a.wk.chunks); it.left > 0; it.next()) {
    if (PEN && it.m != cur) {
      cur = it.m;
      s = qm::scale_of(__uint_as_float(__ldcg(a.amax + cur)), a.h.qmax);
    }
    int64_t c0, c1;
    qm::chunk_range(a.wk, it.m, it.j, c0, c1);
    qm::stream_range<kUnroll>(
        c0, c1, a.off, a.vec,
        [&](int64_t i0, int64_t b) {
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 W[kUnroll], G[kUnroll], M[kUnroll], N[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            const int64_t i = i0 + int64_t(k) * qm::kVecStride;
            if (i < b) {
              W[k] = qm::ld_last4(w + i);
              G[k] = qm::ld_last4(g + i);
              M[k] = St::mu ? qm::ld_last4(mu + i) : z;
              N[k] = St::nu_in ? qm::ld_last4(nu + i) : z;
            }
          }
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            const int64_t i = i0 + int64_t(k) * qm::kVecStride;
            if (i < b) {
              step4<CORE, PEN, FP4, HAS_FD, HAS_MOM>(W[k], G[k], M[k], N[k], s,
                                                     a.h, sc, acc);
              if (sc.ok) {
                qm::st_last4(w + i, W[k]);
                if (St::mu) qm::st_last4(mu + i, M[k]);
                if (St::nu_out) qm::st_last4(nu + i, N[k]);
              }
            }
          }
        },
        [&](int64_t i) {
          step_at<CORE, PEN, FP4, HAS_FD, HAS_MOM>(a, i, s, sc, acc);
        });
  }
  if (PEN) qm::penalty_epilogue(acc, a.partials, a.ticket, a.pen);
}

// Blockwise scales: one warp per quant block, a plain launch.
template <int CORE, bool FP4, bool HAS_FD, bool HAS_MOM>
__global__ void __launch_bounds__(kThreads)
opt_step_block_kernel(const Args a) {
  using St = Streams<CORE, true, HAS_FD, HAS_MOM>;
  const Scalars sc = load_scalars(a.sc);
  const int64_t n = a.n;
  const int bs = a.block_size;
  const bool v4 = a.vec && a.off == 0 && bs % 4 == 0;
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
          m = max(m, qm::abs_bits4(*reinterpret_cast<const float4*>(a.w + i)));
        },
        [&](int64_t i) { m = max(m, qm::abs_bits(a.w[i])); });
    // every lane has read its elements of the block before any lane
    // writes w' over them (each writes only the elements it read)
    const float s = qm::scale_of(
        __uint_as_float(__reduce_max_sync(0xffffffffu, m)), a.h.qmax);
    qm::warp_range(
        base, end, v4,
        [&](int64_t i) {
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 W = *reinterpret_cast<const float4*>(a.w + i);
          const float4 G = qm::ld_last4(a.g + i);
          float4 M = St::mu ? qm::ld_last4(a.mu + i) : z;
          float4 N = St::nu_in ? qm::ld_last4(a.nu + i) : z;
          step4<CORE, true, FP4, HAS_FD, HAS_MOM>(W, G, M, N, s, a.h, sc, acc);
          if (sc.ok) {
            qm::st_last4(a.w + i, W);
            if (St::mu) qm::st_last4(a.mu + i, M);
            if (St::nu_out) qm::st_last4(a.nu + i, N);
          }
        },
        [&](int64_t i) {
          step_at<CORE, true, FP4, HAS_FD, HAS_MOM>(a, i, s, sc, acc);
        });
  }
  qm::penalty_epilogue(acc, a.partials, a.ticket, a.pen);
}

template <int CORE, int MODE, bool FP4, bool HAS_FD, bool HAS_MOM>
const void* kernel() {
  if constexpr (MODE == kBlock)
    return reinterpret_cast<const void*>(
        opt_step_block_kernel<CORE, FP4, HAS_FD, HAS_MOM>);
  else
    return reinterpret_cast<const void*>(
        opt_step_kernel<CORE, MODE, FP4, HAS_FD, HAS_MOM>);
}

template <int CORE, int MODE, bool FP4>
const void* pick_sgd(int has_fd, int has_mom) {
  if (has_fd) return has_mom ? kernel<CORE, MODE, FP4, true, true>()
                             : kernel<CORE, MODE, FP4, true, false>();
  return has_mom ? kernel<CORE, MODE, FP4, false, true>()
                 : kernel<CORE, MODE, FP4, false, false>();
}

template <int MODE, bool FP4>
const void* pick_core(int core, int has_fd, int has_mom) {
  if (core == kAdamW) return kernel<kAdamW, MODE, FP4, false, false>();
  return pick_sgd<kSgd, MODE, FP4>(has_fd, has_mom);
}

const void* pick(int core, int mode, int fp4, int has_fd, int has_mom) {
  if (mode == kNone) return pick_core<kNone, false>(core, has_fd, has_mom);
  if (mode == kMatrix)
    return fp4 ? pick_core<kMatrix, true>(core, has_fd, has_mom)
               : pick_core<kMatrix, false>(core, has_fd, has_mom);
  return fp4 ? pick_core<kBlock, true>(core, has_fd, has_mom)
             : pick_core<kBlock, false>(core, has_fd, has_mom);
}

}  // namespace

// Blocks of the instance that fit on one SM at once (the cooperative
// launch's limit is this times the SM count), or minus the CUDA error.
extern "C" int opt_step_blocks_per_sm(int core, int mode, int fp4,
                                      int has_fd, int has_mom) {
  int nb = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, pick(core, mode, fp4, has_fd, has_mom), kThreads, 0);
  return err == cudaSuccess ? nb : -static_cast<int>(err);
}

// w, mu, nu: n contiguous fp32, updated in place; g: n fp32; sc: device
// fp32 [lr, bc1, bc2, clip, ok].  mode: 0 none (mat_numel = n), 1
// per-matrix scales (amax: n / mat_numel zeroed uint32), 2 blockwise;
// modes 0 and 1 walk (chunk, chunks, scan) of ops.py::plan with `grid`
// blocks (mode 1 one cooperative launch, at most the co-resident count),
// mode 2 `grid` blocks of warps per quant block.  Modes 1 and 2: partials
// `grid` doubles of scratch, ticket one zeroed uint32, pen one fp32.
// core: 0 AdamW, 1 SGD.  Returns the launch's CUDA error.
extern "C" int opt_step_launch(void* w, const void* g, void* mu, void* nu,
                               const void* sc, void* amax, void* partials,
                               void* ticket, void* pen, int64_t n,
                               int64_t mat_numel, int64_t chunk,
                               int64_t chunks, int64_t scan, int block_size,
                               int mode, int core, int fp4, int has_fd,
                               int has_mom, float b1, float omb1, float b2,
                               float omb2, float eps, float wd,
                               float half_lam, float momentum, float fd,
                               float omfd, float qmax, int grid,
                               void* stream) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(w) & 15;
  auto same = [al](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == al;
  };
  Args a{static_cast<float*>(w), static_cast<const float*>(g),
         static_cast<float*>(mu), static_cast<float*>(nu),
         static_cast<const float*>(sc), static_cast<unsigned*>(amax),
         static_cast<double*>(partials), static_cast<unsigned*>(ticket),
         static_cast<float*>(pen),
         qm::Walk{mat_numel, n / mat_numel, chunk, chunks, scan}, n,
         block_size, static_cast<int>(al >> 2), same(g) && same(mu) && same(nu),
         Hyper{b1, omb1, b2, omb2, eps, wd, half_lam, momentum, fd, omfd, qmax}};
  void* args[] = {&a};
  const void* k = pick(core, mode, fp4, has_fd, has_mom);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      mode == kMatrix
          ? cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), args, 0, s)
          : cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args, 0, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
