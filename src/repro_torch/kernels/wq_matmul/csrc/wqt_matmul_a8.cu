// W4A8 / W8A8 matmul against out-major QTensor storage, for Hopper: the row
// quantizer of the activations, the int8 tensor-core contraction and the
// scale epilogue in one launch.
//
// Replaces: src/repro/kernels/wq_matmul/wq_matmul.py::wqt_matmul_a8_pallas
// (body _wqt_a8_kernel), and in front of it the row quantizer of
// src/repro/kernels/wq_matmul/ref.py::quantize_acts_ref that
// src/repro/core/qtensor.py::matmul runs before it under act_fmt="int8".
// Weight codes are int8 (N, K) or packed int4 uint8 (N, K/2) (even k in the
// low nibble), with one fp32 scale per matrix (block_k = -1) or fp32
// (N, K/block_k) scales.  Two entries share the kernel:
//   x (M, K) bf16 or fp32 -> out (M, N) in x's dtype: each row of x is
//     quantized to int8 codes with scale xs = absmax > 0 ? absmax / 127 : 1,
//     code = clamp(rint(x / xs), -127, 127), as the port's plain version
//     (kernels/wq_matmul/ref.py::quantize_acts_ref) does it;
//   xq (M, K) int8 codes with fp32 row scales xs (M, 1) -> out (M, N) fp32.
// The contraction is exact in int32; the epilogue repeats the plain
// version's operations (ref.py::wqt_matmul_a8_ref) one for one, so kernel
// and plain version agree bit for bit:
//   per tensor: acc = sum over all of K, out = (float(acc) * xs) * s
//   blockwise:  f = sum over quant blocks b, in order, of float(acc_b) * s_b
//               (one rounding per product and per sum), out = f * xs
// and the x-dtype result is the fp32 one rounded to nearest even.
//
// What bounds it on an H100: at decode (M = 8 slots, or a 16-token prefill
// chunk) the code bytes, 0.5 (int4) or 1 (int8) per weight read once from
// HBM at 3.35 TB/s: 9.4 us for one Granite layer at int4.  Each call is a
// few microseconds of that, so what the design fights is latency: one
// launch instead of a dozen, every load in flight at once, few barriers.
//
// Design, following wqt_matmul.cu's GEMV.  Swap-AB: out^T (N, M) = W (N, K)
// . xq^T (K, M) on mma.sync m16n8k32 s8, 16 weight rows as operand A and
// the x codes as one n8 tile (tile_m 8) or two (tile_m 16); larger M runs
// tiles of 16 rows over grid.y.  A block has 4 warps: each owns 16 rows of
// N, and where the tile is narrower than 64 the warps of a row split each
// stage's 32-wide K slices (k-groups), so that every block has 4 warps for
// the quantizer and the contraction.  Lane (g, t) takes k = 8t .. 8t + 7
// of every 32-wide slice: for int4 that is one code
// word of 4 bytes per row, which becomes its two A registers in registers
// (each nibble shifted into the high half of its byte reads as 16 * c as
// int8; the int32 sum is 16x the true one, exact since |16 acc| <= 16 *
// 127 * 8 * K < 2^31 for K <= 131072, and shifted right by 4), the even k
// in one register and the odd k in the other; x codes sit in shared memory
// in that same order, so each B operand is one 8-byte load.  int8 codes
// take their 8 bytes as they are.  Codes stream through a cp.async ring of
// 128-wide K steps (kStages deep, issued before anything else).  K is split
// across a thread block cluster of at most 8 (the plan, ops.py::a8_plan,
// starts splits on quant-block boundaries); every cluster spans all of K.
// The row quantizer runs inside: each block copies its K slice of x into
// shared memory with the first cp.async group, takes each row's |x| max
// (as the bits of |x|, an unsigned max, so NaN wins as it does in
// torch.amax), the cluster combines the maxima through distributed shared
// memory, and each block quantizes its slice into its x codes while the
// code ring is in flight.  The epilogue needs no second kernel: per
// tensor, each block leaves its k-groups' int32 partial tiles in its
// shared memory, and after one cluster barrier block z adds its share of
// the tile over all blocks (exact in any order) and applies the scales;
// blockwise, each k-group keeps its int32 share of every quant block's
// sums, the block adds them and forms float(acc_b) * s_b, and the owner
// of an output element folds the products of all blocks in block order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kK = 128;          // k per pipeline stage
constexpr int kStages = 4;       // cp.async ring depth
constexpr int kWarps = 4;        // per block: BN / 16 row warps x k-groups
constexpr int kMaxSplits = 8;    // the portable cluster size
constexpr int kXPad = 32;        // x-code row pad: stride = 32 (mod 128)

// Code rows of a stage: kK / 2 (int4) or kK (int8) bytes, padded so that
// the 8 rows g of a warp's loads fall in distinct banks (int4: 4-byte
// loads, stride 80; int8: 8-byte loads, stride 160 = 32 mod 128).
__host__ __device__ constexpr int code_stride(bool int4) {
  return int4 ? kK / 2 + 16 : kK + 32;
}

// Dynamic shared memory of one block, in bytes from its start: the code
// ring (aliased by the int32 partial tiles (KG, XM, BN) at the end), the
// block's x codes (rows of kps + kXPad bytes), blockwise the staged scales
// (bps, BN) of its bps quant blocks, and one region that holds first the
// block's raw slice of x (or of the given int8 codes), dead once
// quantized, then blockwise the int32 block sums (KG, bps, XM, BN) and
// their products (bps, XM, BN) over the first of them; KG * BN = 64.
// ops.py::a8_smem mirrors `total`.
struct Layout {
  int xq, ss, xraw, total;
  __host__ __device__ Layout(bool int4, int x_bytes, int xm, int bn, int kps,
                             int bps) {
    xq = kStages * bn * code_stride(int4);
    ss = xq + xm * (kps + kXPad);
    xraw = ss + bps * bn * 4;
    const int raw = xm * kps * x_bytes, prod = bps * xm * 16 * kWarps * 4;
    total = xraw + (raw > prod ? raw : prod);
  }
};

template <typename TX> struct OutOf { using T = TX; };
template <> struct OutOf<int8_t> { using T = float; };

// 8 consecutive elements of x from shared memory, as fp32.
template <typename TX>
__device__ __forceinline__ void load8(const uint8_t* p, float (&f)[8]);
template <> __device__ __forceinline__ void load8<float>(const uint8_t* p,
                                                         float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
template <> __device__ __forceinline__ void load8<__nv_bfloat16>(
    const uint8_t* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The fp32 bits of |v| for the 16 bytes at p: unsigned order is the order
// of |x|, with NaN above inf.
template <typename TX>
__device__ __forceinline__ uint32_t abs_max16(const uint8_t* p, uint32_t v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(TX) == 2) {
      v = max(v, (w[i] & 0x7FFFu) << 16);
      v = max(v, w[i] & 0x7FFF0000u);
    } else {
      v = max(v, w[i] & 0x7FFFFFFFu);
    }
  }
  return v;
}

// One activation code, as quantize_acts_ref: rint (half to even) of the
// IEEE quotient v / s, a clamp to +-127 that passes NaN through
// (torch.clamp), then the same float -> int8 cast as torch's
// .to(torch.int8).  The quotient is taken as v * (1 / s) first (rs = the
// rounded reciprocal): |v / s| <= 127 (about), so that product is within
// 3e-5 of the rounded quotient, and wherever it lies more than 0.001 from
// a half-integer both round to the same integer.  Near a tie, and for NaN
// or inf (the test is false), the code comes from the IEEE division.
__device__ __forceinline__ uint32_t act_code(float v, float s, float rs) {
  const float t = v * rs, q = rintf(t);
  if (fabsf(t - q) < 0.499f)                     // q integral and finite
    return static_cast<uint8_t>(min(max(__float2int_rz(q), -127), 127));
  float e = rintf(__fdiv_rn(v, s));
  if (!(e != e)) e = fminf(fmaxf(e, -127.f), 127.f);
  return static_cast<uint8_t>(static_cast<int8_t>(e));
}

__device__ __forceinline__ uint32_t act_codes4(const float* f, float s,
                                               float rs) {
  return act_code(f[0], s, rs) | (act_code(f[1], s, rs) << 8) |
         (act_code(f[2], s, rs) << 16) | (act_code(f[3], s, rs) << 24);
}

// Grid (cdiv(N, BN), cdiv(M, XM), splits), each (n, m) tile's splits one
// cluster; block z takes K in [z, z + 1) * k_per_split.  Its 4 warps are
// WN row warps (16 columns each) times KG = 4 / WN k-groups; k-group kg
// takes the 32-wide slices j = kg (mod KG) of every stage.  TX: float or
// bf16 activations (quantized here), or int8 codes with row scales xs.
// amax_ranks: the cluster ranks whose row maxima are combined (= splits).
template <bool INT4, typename TX, int MT, int WN>
__global__ void __launch_bounds__(32 * kWarps)
wqt_a8_kernel(const TX* __restrict__ x, const float* __restrict__ xs,
              const uint8_t* __restrict__ codes,
              const float* __restrict__ scales,
              typename OutOf<TX>::T* __restrict__ out, int M, int N, int K,
              int block_k, int k_per_split, int amax_ranks) {
  using T = typename OutOf<TX>::T;
  constexpr bool kCodesIn = sizeof(TX) == 1;
  constexpr int BN = 16 * WN, XM = 8 * MT, KG = kWarps / WN;
  constexpr int kThreads = 32 * kWarps;
  constexpr int CS = code_stride(INT4);
  constexpr int kCodeChunks = (INT4 ? kK / 2 : kK) / 16;   // per row, stage
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t smax[XM];      // this block's row maxima (|x| bits)
  __shared__ float sxs[XM];          // the row scales
  __shared__ float srs[XM];          // their reciprocals (quantizer only)

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(gridDim.z), z = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp / WN;                      // this warp's k-group
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * XM;
  const int rows = min(XM, M - m0);
  const int kps = k_per_split;
  const int k_begin = z * kps, klen = min(K, k_begin + kps) - k_begin;
  const int steps = klen / kK;
  const bool bw = block_k > 0;
  const int bps = bw ? kps / block_k : 0;
  const Layout L(INT4, sizeof(TX), XM, BN, kps, bps);
  uint8_t* ring = smem;
  uint8_t* xraw = smem + L.xraw;
  uint8_t* xq = smem + L.xq;
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  int* pbi = reinterpret_cast<int*>(xraw);      // after the x codes are made
  float* pb = reinterpret_cast<float*>(xraw);
  const int xstride = kps + kXPad;
  const size_t row_bytes = INT4 ? K / 2 : K;

  // ---- group 0: the block's slice of x and its blockwise scales
  {
    const int chunks = klen * static_cast<int>(sizeof(TX)) / 16;   // per row
    for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
      const int m = c / chunks, ch = c % chunks;
      cp_async16(xraw + (size_t)m * kps * sizeof(TX) + ch * 16,
                 reinterpret_cast<const uint8_t*>(x + (size_t)(m0 + m) * K +
                                                  k_begin) + ch * 16, true);
    }
    if (bw) {
      const int kbs = K / block_k, kb0 = k_begin / block_k;
      const int nb = klen / block_k;
      for (int e = threadIdx.x; e < nb * BN; e += kThreads) {
        const int b = e / BN, r = e % BN, gn = n0 + r;
        const bool ok = gn < N;
        cp_async4(ss + b * BN + r,
                  ok ? scales + (size_t)gn * kbs + kb0 + b : scales, ok);
      }
    }
    cp_async_commit();
  }
  auto load_stage = [&](int slot, int k0) {
    uint8_t* cs = ring + slot * BN * CS;
    const size_t b0 = INT4 ? k0 / 2 : k0;
    for (int c = threadIdx.x; c < BN * kCodeChunks; c += kThreads) {
      const int r = c / kCodeChunks, ch = c % kCodeChunks;
      const int gn = n0 + r;
      const bool ok = gn < N;
      cp_async16(cs + r * CS + ch * 16,
                 ok ? codes + gn * row_bytes + b0 + ch * 16 : codes, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, k_begin + s * kK);
    cp_async_commit();
  }

  // ---- the row scales: given, or the cluster's absmax of each row
  cp_async_wait<kStages - 1>();      // group 0 landed
  __syncthreads();
  if constexpr (kCodesIn) {
    if (threadIdx.x < XM)
      sxs[threadIdx.x] = threadIdx.x < rows ? xs[m0 + threadIdx.x] : 1.f;
  } else {
    const int chunks = klen * static_cast<int>(sizeof(TX)) / 16;
    for (int m = warp; m < XM; m += kWarps) {
      uint32_t v = 0;
      if (m < rows)
        for (int ch = lane; ch < chunks; ch += 32)
          v = abs_max16<TX>(xraw + (size_t)m * kps * sizeof(TX) + ch * 16, v);
      v = __reduce_max_sync(0xFFFFFFFFu, v);
      if (lane == 0) smax[m] = v;
    }
    cluster.sync();                  // every block's maxima written
    if (threadIdx.x < XM) {
      uint32_t v = 0;
      for (int r = 0; r < amax_ranks; ++r)
        v = max(v, *cluster.map_shared_rank(&smax[threadIdx.x], r));
      const float a = __uint_as_float(v);
      const float sc = a > 0.f ? __fdiv_rn(a, 127.f) : 1.f;     // NaN: 1
      sxs[threadIdx.x] = sc;
      srs[threadIdx.x] = __frcp_rn(sc);
    }
    __syncthreads();
  }

  // ---- x codes of the slice, each group of 8 k in the weights' k order
  {
    const int groups = klen / 8;
    for (int c = threadIdx.x; c < XM * groups; c += kThreads) {
      const int m = c / groups, gi = c % groups;
      uint32_t lo = 0, hi = 0;
      if (m < rows) {
        if constexpr (kCodesIn) {
          const uint2 u = *reinterpret_cast<const uint2*>(
              xraw + (size_t)m * kps + 8 * gi);
          lo = u.x;
          hi = u.y;
        } else {
          float f[8];
          load8<TX>(xraw + ((size_t)m * kps + 8 * gi) * sizeof(TX), f);
          const float sc = sxs[m], rs = srs[m];
          lo = act_codes4(f, sc, rs);
          hi = act_codes4(f + 4, sc, rs);
        }
        if constexpr (INT4) s8_even_odd(lo, hi);
      }
      *reinterpret_cast<uint2*>(xq + m * xstride + 8 * gi) = make_uint2(lo, hi);
    }
  }

  // ---- the contraction.  Element i of acc[mt] is output column (row of A)
  // r0 + 8 * (i / 2) and x row 8 * mt + 2t + i % 2.
  int acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0;
  const int r0 = (warp % WN) * 16 + g;           // local rows r0, r0 + 8
  int left = bw ? block_k / 32 : 0;              // slices left in the block
  int bl = 0;                                    // the block's local index
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                             // stage it landed; it - 1 done
    const int nx = it + kStages - 1;
    if (nx < steps) load_stage(nx % kStages, k_begin + nx * kK);
    cp_async_commit();

    const uint8_t* cs = ring + (it % kStages) * BN * CS;
    const uint8_t* xk = xq + it * kK;
#pragma unroll
    for (int j = 0; j < kK / 32; ++j) {
      if (j % KG == kg) {
        const uint8_t* c0 = cs + r0 * CS, *c1 = cs + (r0 + 8) * CS;
        uint32_t a[4];
        if constexpr (INT4) {
          int4_s8x16(*reinterpret_cast<const uint32_t*>(c0 + 16 * j + 4 * t),
                     a[0], a[2]);
          int4_s8x16(*reinterpret_cast<const uint32_t*>(c1 + 16 * j + 4 * t),
                     a[1], a[3]);
        } else {
          const uint2 u0 = *reinterpret_cast<const uint2*>(c0 + 32 * j + 8 * t);
          const uint2 u1 = *reinterpret_cast<const uint2*>(c1 + 32 * j + 8 * t);
          a[0] = u0.x; a[2] = u0.y; a[1] = u1.x; a[3] = u1.y;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              xk + (8 * mt + g) * xstride + 32 * j + 8 * t);
          mma_s8(acc[mt], a, b.x, b.y);
        }
      }
      if (bw && --left == 0) {
        // a quant block ends: every k-group keeps its int32 share of the
        // block's sums
        left = block_k / 32;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          int* p = pbi + ((size_t)(kg * bps + bl) * XM + 8 * mt + 2 * t) * BN;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[(i & 1) * BN + r0 + 8 * (i >> 1)] = acc[mt][i];
            acc[mt][i] = 0;
          }
        }
        ++bl;
      }
    }
  }

  // ---- epilogue: per tensor the k-groups' (XM, BN) int32 partial tiles,
  // aliasing the ring, are added over the cluster; blockwise each block's
  // sum over the k-groups becomes its product float(acc_b) * s_b, and the
  // products are folded in block order
  cp_async_wait<0>();
  __syncthreads();
  int* red = reinterpret_cast<int*>(ring);
  if (!bw) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(kg * XM + 8 * mt + 2 * t + (i & 1)) * BN + r0 + 8 * (i >> 1)] =
            acc[mt][i];
  } else {
    const int tile = bps * XM * BN;
    for (int e = threadIdx.x; e < tile; e += kThreads) {
      int a = 0;
#pragma unroll
      for (int h = 0; h < KG; ++h) a += pbi[h * tile + e];
      pb[e] = __fmul_rn(__int2float_rn(INT4 ? a >> 4 : a),
                        ss[e / (XM * BN) * BN + e % BN]);
    }
  }
  cluster.sync();
  const float s_pt = bw ? 1.f : __ldg(scales);
  const int nb = bw ? K / block_k : 0;
  constexpr int kQuads = XM * BN / 4;
  const int per = (kQuads + splits - 1) / splits;
  const int q1 = min(kQuads, (z + 1) * per);
  for (int q = z * per + threadIdx.x; q < q1; q += kThreads) {
    const int m = 4 * q / BN, n = 4 * q % BN;
    if (m >= rows) continue;
    float v[4];
    if (!bw) {
      int4 s = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int h = 0; h < KG; ++h) {
        int4 p[kMaxSplits];
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r)     // all loads in flight
          if (r < splits)
            p[r] = *reinterpret_cast<const int4*>(cluster.map_shared_rank(
                red + h * XM * BN + 4 * q, r));
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r)
          if (r < splits) {
            s.x += p[r].x;
            s.y += p[r].y;
            s.z += p[r].z;
            s.w += p[r].w;
          }
      }
      const int sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = INT4 ? sv[i] >> 4 : sv[i];
        v[i] = __fmul_rn(__fmul_rn(__int2float_rn(a), sxs[m]), s_pt);
      }
    } else {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int b = 0; b < nb; ++b) {
        const int r = b / bps, b_loc = b - r * bps;
        const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(
            pb + ((size_t)b_loc * XM + m) * BN + n, r));
        if (b == 0) {
          f = p;
        } else {
          f.x = __fadd_rn(f.x, p.x);
          f.y = __fadd_rn(f.y, p.y);
          f.z = __fadd_rn(f.z, p.z);
          f.w = __fadd_rn(f.w, p.w);
        }
      }
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __fmul_rn(fv[i], sxs[m]);
    }
    const size_t o = (size_t)(m0 + m) * N + n0 + n;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n0 + n + i < N) out[o + i] = from_f32<T>(v[i]);
  }
  cluster.sync();                    // every tile stays until all reads end
}

// ---- launchers --------------------------------------------------------------

struct Args {
  const void* x;
  const float* xs;
  const uint8_t* codes;
  const float* scales;
  void* out;
  int M, N, K, block_k, tile_m, splits, k_per_split, amax_ranks, smem;
  cudaStream_t stream;
};

template <bool INT4, typename TX, int MT, int WN>
cudaError_t launch(const Args& a) {
  constexpr int BN = 16 * WN, XM = 8 * MT;
  auto kernel = wqt_a8_kernel<INT4, TX, MT, WN>;
  const Layout L(INT4, sizeof(TX), XM, BN, a.k_per_split,
                 a.block_k > 0 ? a.k_per_split / a.block_k : 0);
  if (L.total != a.smem || a.splits < 1 || a.splits > kMaxSplits)
    return cudaErrorInvalidValue;
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + BN - 1) / BN, (a.M + XM - 1) / XM, a.splits);
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TX*>(a.x), a.xs, a.codes, a.scales,
      static_cast<typename OutOf<TX>::T*>(a.out), a.M, a.N, a.K, a.block_k,
      a.k_per_split, a.amax_ranks);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool INT4, typename TX, int MT>
cudaError_t by_tile_n(const Args& a, int tile_n) {
  switch (tile_n) {
    case 64: return launch<INT4, TX, MT, 4>(a);
    case 32: return launch<INT4, TX, MT, 2>(a);
    case 16: return launch<INT4, TX, MT, 1>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool INT4, typename TX>
cudaError_t by_tile(const Args& a, int tile_n) {
  if (a.tile_m == 8) return by_tile_n<INT4, TX, 1>(a, tile_n);
  if (a.tile_m == 16) return by_tile_n<INT4, TX, 2>(a, tile_n);
  return cudaErrorInvalidValue;
}

template <bool INT4>
cudaError_t by_dtype(const Args& a, int xdtype, int tile_n) {
  switch (xdtype) {
    case 0: return by_tile<INT4, float>(a, tile_n);
    case 1: return by_tile<INT4, __nv_bfloat16>(a, tile_n);
    case 2: return by_tile<INT4, int8_t>(a, tile_n);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch plan comes from ops.py::a8_plan.  xdtype: 0 float32 or 1
// bfloat16 activations x (M, K), quantized here, out in x's dtype, xs
// unused; 2 int8 codes x with fp32 row scales xs (M, 1), out fp32.  bits: 4
// or 8.  block_k: -1 per tensor, else a multiple of 32 dividing K.  K a
// multiple of 128; x, codes and every code row 16-byte aligned.  tile_m 8
// or 16 rows of x per block, tile_n 64, 32 or 16 columns; splits (<= 8,
// one cluster) of k_per_split (a multiple of 128 and of block_k) cover K.
// amax_ranks: cluster ranks whose row maxima are combined (= splits).
// smem: the plan's dynamic shared memory, checked against the kernel's
// layout.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan
// no instance takes.
extern "C" int wqt_matmul_a8_launch(const void* x, const void* xs,
                                    const void* codes, const void* scales,
                                    void* out, int M, int N, int K,
                                    int block_k, int bits, int xdtype,
                                    int tile_m, int tile_n, int splits,
                                    int k_per_split, int amax_ranks, int smem,
                                    void* stream) {
  const Args a{x, static_cast<const float*>(xs),
               static_cast<const uint8_t*>(codes),
               static_cast<const float*>(scales), out, M, N, K, block_k,
               tile_m, splits, k_per_split, amax_ranks, smem,
               static_cast<cudaStream_t>(stream)};
  return bits == 4 ? by_dtype<true>(a, xdtype, tile_n)
                   : by_dtype<false>(a, xdtype, tile_n);
}
