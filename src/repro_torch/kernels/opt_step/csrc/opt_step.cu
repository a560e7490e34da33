// Fused clip + decoupled-LOTION + AdamW / SGD optimizer step, one pass per
// parameter leaf, for Hopper.
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
// step).  ok = 0 writes w, mu, nu back unchanged: the non-finite skip gate.
// Every operation rounds once (_rn intrinsics, no contraction into FMAs),
// so w', mu', nu' are bitwise equal to the plain version's.
//
// w', mu' and nu' are written IN PLACE over w, mu and nu: each element is
// read and then written by the same thread, so no other copy exists.
//
// What bounds it on an H100: bytes.  It reads w, g, mu, nu and writes w',
// mu', nu', 28 bytes per element: for the 2.53e9 parameters of
// Granite-3-2B at least 21.2 ms per step at 3.35 TB/s.
//
// Design.  One launch per leaf, in the layouts of quant.cu: per-matrix
// scales on a 2-D grid whose y walks the matrices (a stacked (L, a, b) leaf
// is one launch, where the Pallas wrapper vmaps over L), or one warp per
// quant block for blockwise scales, or no brackets at all (mode none:
// lam = 0 or a leaf outside the policy).  The global norm and the
// per-matrix absmax stay torch reductions outside, as the JAX code keeps
// them outside its kernel.  The penalty partials are summed in a fixed
// order without atomics (see lotion_reg.cu).

#include "../../quant/csrc/quant_math.cuh"

namespace {

using qm::kThreads;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, half_lam, momentum, fd, omfd, qmax;
};

enum Mode { kNone = 0, kMatrix = 1, kBlock = 2 };
enum Core { kAdamW = 0, kSgd = 1 };

// sc: [lr, bc1, bc2, clip, ok]
template <int CORE, bool PEN, bool FP4, bool HAS_FD, bool HAS_MOM>
__device__ __forceinline__ void step_one(float* __restrict__ w,
                                         const float* __restrict__ g,
                                         float* __restrict__ mu,
                                         float* __restrict__ nu, int64_t i,
                                         float s, const Hyper& h,
                                         const float* sc, double& acc) {
  const float w0 = w[i], m0 = mu[i], n0 = nu[i];
  float gi = __fmul_rn(g[i], sc[3]);
  if (PEN) {
    float lo, hi;
    qm::brackets<FP4>(w0, s, h.qmax, lo, hi);
    const float a = __fsub_rn(hi, w0), b = __fsub_rn(w0, lo);
    const float ct = __fmul_rn(h.half_lam, n0);
    gi = __fadd_rn(gi, __fsub_rn(__fmul_rn(ct, a), __fmul_rn(ct, b)));
    acc += static_cast<double>(__fmul_rn(n0, __fmul_rn(a, b)));
  }
  float w1, m1, n1;
  const float lr = sc[0];
  if (CORE == kAdamW) {
    m1 = __fadd_rn(__fmul_rn(h.b1, m0), __fmul_rn(h.omb1, gi));
    n1 = __fadd_rn(__fmul_rn(h.b2, n0), __fmul_rn(__fmul_rn(h.omb2, gi), gi));
    const float upd = __fdiv_rn(__fdiv_rn(m1, sc[1]),
                                __fadd_rn(__fsqrt_rn(__fdiv_rn(n1, sc[2])), h.eps));
    w1 = __fsub_rn(w0, __fmul_rn(lr, __fadd_rn(upd, __fmul_rn(h.wd, w0))));
  } else {
    n1 = HAS_FD ? __fadd_rn(__fmul_rn(h.fd, n0), __fmul_rn(__fmul_rn(h.omfd, gi), gi))
                : n0;
    m1 = HAS_MOM ? __fadd_rn(__fmul_rn(h.momentum, m0), gi) : m0;
    w1 = __fsub_rn(w0, __fmul_rn(lr, HAS_MOM ? m1 : gi));
  }
  const bool ok = sc[4] != 0.f;
  w[i] = ok ? w1 : w0;
  mu[i] = ok ? m1 : m0;
  nu[i] = ok ? n1 : n0;
}

template <int CORE, int MODE, bool FP4, bool HAS_FD, bool HAS_MOM>
__global__ void __launch_bounds__(kThreads)
opt_step_kernel(float* __restrict__ w, const float* __restrict__ g,
                float* __restrict__ mu, float* __restrict__ nu,
                const float* __restrict__ sc_in,
                const float* __restrict__ scales,
                double* __restrict__ partials, int64_t n, int64_t mat_numel,
                int block_size, Hyper h) {
  constexpr bool PEN = MODE != kNone;
  const float sc[5] = {sc_in[0], sc_in[1], sc_in[2], sc_in[3], sc_in[4]};
  double acc = 0.0;
  if (MODE == kBlock) {
    const int lane = threadIdx.x & 31;
    const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
    const int64_t n_blocks = (n + block_size - 1) / block_size;
    for (int64_t b = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
         b < n_blocks; b += n_warps) {
      const int64_t base = b * block_size;
      const int64_t end = base + block_size < n ? base + block_size : n;
      float m = 0.f;
      for (int64_t i = base + lane; i < end; i += 32) m = qm::nanmax(m, fabsf(w[i]));
      // every lane has read its elements of the block before any lane
      // writes w' over them (the writes below touch only its own elements)
      const float s = qm::scale_of(qm::warp_absmax(m), h.qmax);
      for (int64_t i = base + lane; i < end; i += 32)
        step_one<CORE, PEN, FP4, HAS_FD, HAS_MOM>(w, g, mu, nu, i, s, h, sc, acc);
    }
  } else {
    // per matrix (mode none: the whole leaf is one "matrix" of scale 1)
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    const int64_t n_mats = n / mat_numel;
    for (int64_t m = blockIdx.y; m < n_mats; m += gridDim.y) {
      const float s = PEN ? scales[m] : 1.f;
      const int64_t base = m * mat_numel;
      for (int64_t j0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
           j0 < mat_numel; j0 += 4 * stride) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j0 + k * stride < mat_numel)
            step_one<CORE, PEN, FP4, HAS_FD, HAS_MOM>(
                w, g, mu, nu, base + j0 + k * stride, s, h, sc, acc);
        }
      }
    }
  }
  if (PEN) {
    acc = qm::block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = acc;
  }
}

template <int CORE, int MODE, bool FP4, bool HAS_FD, bool HAS_MOM>
void launch(float* w, const float* g, float* mu, float* nu, const float* sc,
            const float* scales, double* partials, float* pen, int64_t n,
            int64_t mat_numel, int block_size, const Hyper& h, dim3 grid,
            cudaStream_t stream) {
  opt_step_kernel<CORE, MODE, FP4, HAS_FD, HAS_MOM><<<grid, kThreads, 0, stream>>>(
      w, g, mu, nu, sc, scales, partials, n, mat_numel, block_size, h);
  if (MODE != kNone)
    qm::half_sum_kernel<<<1, kThreads, 0, stream>>>(partials, grid.x * grid.y, pen);
}

using LaunchFn = void (*)(float*, const float*, float*, float*, const float*,
                          const float*, double*, float*, int64_t, int64_t, int,
                          const Hyper&, dim3, cudaStream_t);

template <int CORE, int MODE, bool FP4>
LaunchFn pick_sgd(int has_fd, int has_mom) {
  if (has_fd) return has_mom ? launch<CORE, MODE, FP4, true, true>
                             : launch<CORE, MODE, FP4, true, false>;
  return has_mom ? launch<CORE, MODE, FP4, false, true>
                 : launch<CORE, MODE, FP4, false, false>;
}

template <int MODE, bool FP4>
LaunchFn pick_core(int core, int has_fd, int has_mom) {
  if (core == kAdamW) return launch<kAdamW, MODE, FP4, false, false>;
  return pick_sgd<kSgd, MODE, FP4>(has_fd, has_mom);
}

LaunchFn pick(int core, int mode, int fp4, int has_fd, int has_mom) {
  if (mode == kNone) return pick_core<kNone, false>(core, has_fd, has_mom);
  if (mode == kMatrix)
    return fp4 ? pick_core<kMatrix, true>(core, has_fd, has_mom)
               : pick_core<kMatrix, false>(core, has_fd, has_mom);
  return fp4 ? pick_core<kBlock, true>(core, has_fd, has_mom)
             : pick_core<kBlock, false>(core, has_fd, has_mom);
}

}  // namespace

// w, mu, nu: n contiguous fp32, updated in place; g: n fp32; sc: device
// fp32 [lr, bc1, bc2, clip, ok]; scales: fp32 per matrix (mode 1) or null;
// partials: grid_x * grid_y doubles of scratch and pen one fp32 (modes 1
// and 2, else null).  mode: 0 none (mat_numel = n), 1 per-matrix scales, 2
// blockwise; core: 0 AdamW, 1 SGD.  Grid as in quant_launch.  Returns
// cudaGetLastError().
extern "C" int opt_step_launch(void* w, const void* g, void* mu, void* nu,
                               const void* sc, const void* scales,
                               void* partials, void* pen, int64_t n,
                               int64_t mat_numel, int block_size, int mode,
                               int core, int fp4, int has_fd, int has_mom,
                               float b1, float omb1, float b2, float omb2,
                               float eps, float wd, float half_lam,
                               float momentum, float fd, float omfd,
                               float qmax, int grid_x, int grid_y,
                               void* stream) {
  const Hyper h{b1, omb1, b2, omb2, eps, wd, half_lam, momentum, fd, omfd, qmax};
  const dim3 grid(grid_x, grid_y);
  pick(core, mode, fp4, has_fd, has_mom)(
      static_cast<float*>(w), static_cast<const float*>(g),
      static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<const float*>(sc), static_cast<const float*>(scales),
      static_cast<double*>(partials), static_cast<float*>(pen), n, mat_numel,
      block_size, h, grid, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
