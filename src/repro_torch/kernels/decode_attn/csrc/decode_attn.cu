// Fused decode attention over an int8 / packed-int4 ring KV cache or paged
// KV pool, for Hopper.
//
// Replaces: src/repro/kernels/decode_attn/decode_attn.py::decode_attn_pallas
// (body _decode_attn_kernel) and, with PAGED, ::decode_attn_paged_pallas
// (body _decode_attn_paged_kernel).  One GQA decode step: q (b, g, rep, hd)
// against codes (b, L, g, hd) int8 or (b, L, g, hd/2) uint8 (even index in
// the low nibble), scales (b, L, g, 1) fp32 and per-row positions pos (b,)
// int32 (>= 0).  Per slot: raw-code dot with q, then the K scale, / sqrt(hd),
// softcap, the ring-validity (and sliding-window) bias; a softmax over the
// slots with the V scale folded into p, and the PV product.  Out is like q.
// The order is ref.py::decode_attn_ref's.
//
// Paged (decode_attn_paged): codes (n_blocks, bs, g, hd[/2]) and scales
// (n_blocks, bs, g, 1) form a pool shared by all rows; row bi's ring slot j
// lives in pool block bt[bi, j / bs] at offset j % bs (int32 block table bt
// (b, bps), L = bps * bs).  Only the address of a slot changes (slot_row),
// so on the gathered view the two entry points agree bit for bit for any
// bs.
//
// What bounds it on an H100: bytes.  A step reads each valid slot's K and V
// codes and scales once, 2 * (hd or hd/2 + 4) bytes per (slot, kv-head); the
// arithmetic is 4 * rep * hd flops per slot.  At the main path's shape (b =
// 8, g = 8, rep = 4, hd = 64, L = 256, int8, ragged positions: 1,373 valid
// (row, slot) pairs) that is 1.49 MB, 0.47 us at 3.35 TB/s: what holds a
// call back is latency, and the design keeps bytes in flight and the SMs
// busy.
//
// Design.  The launch plan (kernels/decode_attn/ops.py::plan, a function of
// the shapes only, so ring and paged calls share it) picks the instance and
// splits the L slots of every (b, kv-head) into at most 8 splits, one
// thread block each, launched as one thread block cluster: grid (splits, g,
// b), 4 warps a block.  At the main shape, 4 splits of 64 slots give 256
// blocks on the 132 SMs.
// * Only valid slots are read.  The valid slots of a row are one cyclic
//   interval of the ring, at most two intervals of a split (struct Valid,
//   found once per block), so a block tests each 16-slot chunk with a few
//   compares and finds its next valid tile in closed form; a chunk with no
//   valid slot is neither loaded nor scored, and a block with none reads
//   no K/V byte and leaves the neutral partial (m = -1e30, s = 0, acc = 0).
// * mma instance (bf16 q, rep <= 8, hd in {32, 64, 128}, code rows a
//   multiple of 32 bytes, 16-byte aligned).  A tile is 64 slots, one 16-slot
//   chunk per warp.  The block issues its tiles' K codes, V codes and
//   scales with cp.async into a ring of shared-memory stages (one stage
//   holds a whole 64-slot split at L = 256; two at L = 4096) and waits
//   on a stage only when it computes on it.  Codes stay bytes in shared
//   memory and become bf16 fragments in registers, exactly (hopper.cuh's
//   byte_perm/lop3 helpers).  QK^T is swap-AB mma.sync m16n8k16: 16 slots
//   of K codes as A, q^T (rep queries, zero-padded to 8) as B, loaded once
//   per block; its epilogue applies the K scale, 1/sqrt(hd), softcap and
//   bias per (slot, query).  Each warp keeps its own online softmax (warp
//   shuffles for the max and sum).  PV is swap-AB too: V^T (16 d x 16
//   slots) as A, P^T as B, with p * v_scale rounded to bf16 as the plain
//   version rounds p to q's dtype.  V needs the transpose that K did not:
//   each lane reads one 32-bit word (4 d of int8, 8 of int4) from 4 slot
//   rows and transposes the 4 x 4 bytes with byte_perm, so V never goes
//   through shared memory as bf16 and no ldmatrix is needed.  Slot and d
//   orders inside a fragment are permuted consistently on both operands
//   (the contraction does not care) so that every fragment is one word
//   load; row strides are padded so that no load conflicts on a bank.
// * fma instance (fp32 q, the 8-byte int4 code rows of hd = 16 and any
//   shape the mma instance does not take): the earlier CUDA-core kernel,
//   fp32 tiles of TL slots in shared memory, on the same split skeleton.
// * The merge.  Warps merge in warp order inside the block, then the blocks
//   of a cluster in split order through distributed shared memory (block z
//   finishes 1/splits of the outputs).  No second launch, no workspace, no
//   float atomics: two launches are bitwise equal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;        // both instances: 4 warps
constexpr int kMaxSplits = 8;        // the portable cluster size
constexpr int kMaxStages = 4;        // mma: cp.async ring stages

// ---- which slots hold a valid position ------------------------------------

// Ring slot j of a row at position pos holds p_j = pos - ((pos - j) mod L),
// valid iff p_j >= 0 (and pos - p_j < window).  The age (pos - j) mod L
// counts back from slot pos mod L, so the valid slots are the `count`
// youngest, the cyclic interval start .. start + count - 1 (mod L), count =
// min(pos + 1, L, window).  Within a split [lo, hi) that is at most two
// intervals, [a0, b0) and [a1, b1) (empty when a >= b), found once per
// block.  ops.py::ring_window, ::valid_intervals and ::any_valid are this
// arithmetic in Python, tested against ref.py::ring_validity.
struct Valid {
  int a0, b0, a1, b1;
  __device__ Valid(int pos, int L, int window, int lo, int hi) {
    int count = pos < L ? pos + 1 : L;
    if (window > 0 && window < count) count = window;
    const int start = count > 0 ? (pos + 1 - count) % L : 0;
    const int end = start + count;        // past L: the part from slot 0
    a0 = max(lo, start);
    b0 = min(hi, min(end, L));
    a1 = lo;
    b1 = min(hi, end - L);
  }
  __device__ bool slot(int j) const {
    return (j >= a0 && j < b0) || (j >= a1 && j < b1);
  }
  // Does [a, b) hold a valid slot?
  __device__ bool any(int a, int b) const {
    return (a0 < b0 && a < b0 && b > a0) || (a1 < b1 && a < b1 && b > a1);
  }
};

// Split blockIdx.x of gridDim.x covers slots [lo, hi): the splits end at L,
// `per` slots each, the first one short when splits * per > L
// (ops.py::split_range).
__device__ __forceinline__ void split_range(int L, int per, int& lo,
                                            int& hi) {
  hi = L - static_cast<int>(gridDim.x - 1 - blockIdx.x) * per;
  lo = max(0, hi - per);
}

// Where the slot lives: row bi's ring slot gl in a (b, L, ...) cache, or in
// the pool, block bt[bi, gl / bs] at offset gl % bs of a (n_blocks, bs, ...)
// pool; in units of one slot's (g, ...) entries.
template <bool PAGED>
__device__ __forceinline__ size_t slot_row(int bi, int gl, int L,
                                           const int* __restrict__ bt, int bps,
                                           int bs) {
  if (PAGED) return (size_t)bt[(size_t)bi * bps + gl / bs] * bs + gl % bs;
  return (size_t)bi * L + gl;
}

__device__ __forceinline__ float logit(float dot, float k_scale, bool valid,
                                       float sqrt_hd, float softcap) {
  float x = (dot * k_scale) / sqrt_hd;
  if (softcap > 0.f) x = softcap * tanhf(x / softcap);
  return x + (valid ? 0.f : kNegInf);
}

// ---- the merge of the splits ----------------------------------------------

// Each block leaves its partial softmax in its shared memory: per query r
// the running max m[r] and denominator s[r], and the unnormalized
// acc[r * hd + d].  An empty partial (m = -1e30, s = 0, acc = 0) weighs
// exactly 0: exp(-1e30 - M) = 0 for the row's real max M (decode always has
// a valid slot).  With one split the block normalizes its own partial;
// otherwise, after a cluster barrier, block z finishes its 1/splits share
// of the (rep, hd) outputs from all the splits' partials, read through
// distributed shared memory and added in split order; a second barrier
// keeps every partial alive until all reads are done.
template <typename T>
__device__ void merge_splits(const float* m, const float* s, const float* acc,
                             int rep, int hd, T* __restrict__ out) {
  const int n = rep * hd;
  if (gridDim.x == 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      out[e] = from_f32<T>(acc[e] / fmaxf(s[e / hd], 1e-30f));
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  const int per = (n + splits - 1) / splits;
  const int e1 = min(n, (z + 1) * per);
  for (int e = z * per + threadIdx.x; e < e1; e += blockDim.x) {
    const int r = e / hd;
    float mz[kMaxSplits], sz[kMaxSplits], az[kMaxSplits];
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i)   // all loads in flight
      if (i < splits) {
        mz[i] = *cluster.map_shared_rank(m + r, i);
        sz[i] = *cluster.map_shared_rank(s + r, i);
        az[i] = *cluster.map_shared_rank(acc + e, i);
      }
    float mx = mz[0];
#pragma unroll
    for (int i = 1; i < kMaxSplits; ++i)
      if (i < splits) mx = fmaxf(mx, mz[i]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i)
      if (i < splits) {
        const float w = expf(mz[i] - mx);
        den += sz[i] * w;
        num += az[i] * w;
      }
    out[e] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
  cluster.sync();
}

// ---- mma instance -----------------------------------------------------------

constexpr int kTile = 64;            // slots per tile: one 16-slot chunk a warp
constexpr int kMaxRep = 8;           // queries per kv-head: one n8 tile

// Shared memory of the mma instance: a ring of stages (K codes, V codes,
// K scales, V scales of one tile), which after the loop holds the warps'
// partials; the block's partial; each warp's P^T tile.
template <bool INT4, int HD>
struct MmaTile {
  static constexpr int kRowBytes = INT4 ? HD / 2 : HD;   // code bytes a slot
  static constexpr int kWords = kRowBytes / 4;
  static_assert(kWords % 8 == 0, "code rows of a multiple of 32 bytes");
  // Row strides in 32-bit words.  The K fragments read rows gq (8 of them)
  // at word 4j + t, the V fragments rows t + 4i (4 of them) at word gq: no
  // bank conflict when the K stride is 4 mod 8 and the V stride 8 mod 16.
  static constexpr int kKStride = kWords + 4;
  static constexpr int kVStride = kWords % 16 == 8 ? kWords : kWords + 8;
  static constexpr int kKBytes = kTile * kKStride * 4;
  static constexpr int kVBytes = kTile * kVStride * 4;
  static constexpr int kStage = kKBytes + kVBytes + 2 * kTile * 4;
  static constexpr int kWarpPartials = (4 * kMaxRep * HD + 2 * 4 * kMaxRep) * 4;
  static constexpr int kBlockPartial = (2 * kMaxRep + kMaxRep * HD) * 4;
  static constexpr int kP = 4 * kMaxRep * 16 * 2;
  __host__ __device__ static int ring_bytes(int stages) {
    return stages * kStage > kWarpPartials ? stages * kStage : kWarpPartials;
  }
  __host__ __device__ static int smem(int stages) {
    return ring_bytes(stages) + kBlockPartial + kP;
  }
};

__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// The K code word of d = kk .. kk + 3 (kk % 4 == 0) of one slot row: int4 2
// bytes (low half), int8 4.
template <bool INT4>
__device__ __forceinline__ uint32_t k_word(const uint8_t* row, int kk) {
  if constexpr (INT4) return *reinterpret_cast<const uint16_t*>(row + kk / 2);
  else return *reinterpret_cast<const uint32_t*>(row + kk);
}

// Words r[0..3] of 4 slot rows -> w[j] = byte j of each, in row order.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&w)[4]) {
  const uint32_t a = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t b = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t c = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t d = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(a, c, 0x5410);
  w[1] = __byte_perm(a, c, 0x7632);
  w[2] = __byte_perm(b, d, 0x5410);
  w[3] = __byte_perm(b, d, 0x7632);
}

// 4 int4 codes, one in the low nibble of each byte -> the bf16 pairs of
// bytes (0, 1) and (2, 3), exactly (int4_pair's trick).
__device__ __forceinline__ void nibbles4(uint32_t n, uint32_t& p01,
                                         uint32_t& p23) {
  p01 = bf16x2_sub136((__byte_perm(n, 0, 0x0100) & 0x000F000Fu) ^ 0x43084308u);
  p23 = bf16x2_sub136((__byte_perm(n, 0, 0x0302) & 0x000F000Fu) ^ 0x43084308u);
}

// Grid (splits, g, b), one cluster per (b, kv-head).  Lane (gq, t) = (lane /
// 4, lane % 4).  QK^T: A rows are the chunk's slots gq and gq + 8, and the
// lane's k are d = 16j + 4t .. + 3 on both operands; C holds (slot, query
// 2t and 2t + 1).  PV: A rows are d, the lane's k are the chunk's slots t,
// t + 4, t + 8, t + 12, and P^T is stored in that order; C holds (d, query
// 2t and 2t + 1), so the softmax state of a lane's two queries serves both
// products.  For int8 word c = gq + 8 blk of a V row holds d = 4c .. 4c + 3
// (m-tile 2 blk + h: rows gq, gq + 8 are d = 4c + 2h, + 1); for int4 d = 8c
// .. 8c + 7 (m-tile 4 blk + j: d = 8c + 2j, + 1, the nibbles of byte j).
template <bool INT4, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const uint8_t* __restrict__ kc,
                       const float* __restrict__ ksc,
                       const uint8_t* __restrict__ vc,
                       const float* __restrict__ vsc,
                       const int* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out, int g, int rep,
                       int L, int per, int stages, int window,
                       float softcap, const int* __restrict__ bt, int bps,
                       int bs) {
  using Tl = MmaTile<INT4, HD>;
  constexpr int kRowBytes = Tl::kRowBytes;
  extern __shared__ __align__(16) uint8_t smem[];
  const int gi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  int lo, hi;
  split_range(L, per, lo, hi);
  const Valid valid(pos[bi], L, window, lo, hi);
  const int ntiles = (hi - lo + kTile - 1) / kTile;
  const int ring_bytes = Tl::ring_bytes(stages);
  float* bpart = reinterpret_cast<float*>(smem + ring_bytes);
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(
      smem + ring_bytes + Tl::kBlockPartial) + warp * kMaxRep * 16;

  // bit c: chunk c (slots 16c .. 16c + 15) of the tile holds a valid slot
  auto chunks = [&](int tile) {
    const int t0 = lo + tile * kTile;
    unsigned mask = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (valid.any(t0 + 16 * c, t0 + 16 * c + 16)) mask |= 1u << c;
    return mask;
  };
  // the first tile at or after `tile` that holds a valid slot, or ntiles
  auto next_tile = [&](int tile) {
    int next = ntiles;
    if (valid.a0 < valid.b0 && (valid.b0 - 1 - lo) / kTile >= tile)
      next = max(tile, (valid.a0 - lo) / kTile);
    if (valid.a1 < valid.b1 && (valid.b1 - 1 - lo) / kTile >= tile)
      next = min(next, max(tile, (valid.a1 - lo) / kTile));
    return next;
  };
  // cp.async the valid chunks of a tile into stage `slot`: K and V codes 16
  // bytes a copy, and their scales; slots at or past hi read zeros
  auto load_tile = [&](int slot, int tile) {
    const unsigned mask = chunks(tile);
    uint8_t* st = smem + slot * Tl::kStage;
    float* ss = reinterpret_cast<float*>(st + Tl::kKBytes + Tl::kVBytes);
    const int t0 = lo + tile * kTile;
    constexpr int kParts = kRowBytes / 16;
    for (int c = tid; c < kTile * kParts; c += kThreads) {
      const int r = c / kParts, part = c % kParts;
      if (!((mask >> (r / 16)) & 1)) continue;
      const int gl = t0 + r;
      const bool ok = gl < hi;
      const size_t off =
          (ok ? slot_row<PAGED>(bi, gl, L, bt, bps, bs) * g + gi : 0) *
              kRowBytes + part * 16;
      cp_async16(st + r * Tl::kKStride * 4 + part * 16, kc + off, ok);
      cp_async16(st + Tl::kKBytes + r * Tl::kVStride * 4 + part * 16, vc + off,
                 ok);
    }
    for (int r = tid; r < kTile; r += kThreads) {
      if (!((mask >> (r / 16)) & 1)) continue;
      const int gl = t0 + r;
      const bool ok = gl < hi;
      const size_t row =
          ok ? slot_row<PAGED>(bi, gl, L, bt, bps, bs) * g + gi : 0;
      cp_async4(ss + r, ksc + row, ok);
      cp_async4(ss + kTile + r, vsc + row, ok);
    }
  };

  int lt = next_tile(0), ct = lt;       // next tile to load, to compute
  for (int s = 0; s < stages; ++s) {
    if (lt < ntiles) {
      load_tile(s, lt);
      lt = next_tile(lt + 1);
    }
    cp_async_commit();
  }

  // q^T, the B operand of QK^T: lane (gq, t) holds query gq's d = 16j + 4t
  // .. + 3 (zeros past rep), loaded once while the codes are in flight
  uint32_t qf[HD / 16][2];
  {
    const __nv_bfloat16* qr =
        q + (((size_t)bi * g + gi) * rep + gq) * HD + 4 * t;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      uint2 v = make_uint2(0u, 0u);
      if (gq < rep) v = *reinterpret_cast<const uint2*>(qr + 16 * j);
      qf[j][0] = v.x;
      qf[j][1] = v.y;
    }
  }
  const float sqrt_hd = sqrtf(static_cast<float>(HD));
  float m0 = kNegInf, m1 = kNegInf, s0 = 0.f, s1 = 0.f;   // queries 2t, 2t + 1
  float acc[HD / 16][4];
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;

  for (int it = 0; ct < ntiles; ++it) {
    cp_async_wait_n(stages - 1);        // tile ct's stage has landed
    __syncthreads();
    const int slot = it % stages;
    if ((chunks(ct) >> warp) & 1) {     // this warp's chunk holds a valid slot
      const uint8_t* ks = smem + slot * Tl::kStage;
      const uint8_t* vs = ks + Tl::kKBytes;
      const float* ss = reinterpret_cast<const float*>(vs + Tl::kVBytes);
      const int r0 = warp * 16 + gq;    // the lane's slot rows r0, r0 + 8
      // QK^T, swap-AB: (16 slots, 8 queries) = K codes (16 x HD) . q^T
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        uint32_t a[4];
        dequant4<INT4>(k_word<INT4>(ks + r0 * Tl::kKStride * 4, 16 * j + 4 * t),
                       a[0], a[2]);
        dequant4<INT4>(
            k_word<INT4>(ks + (r0 + 8) * Tl::kKStride * 4, 16 * j + 4 * t),
            a[1], a[3]);
        mma_bf16(c, a, qf[j][0], qf[j][1]);
      }
      const int gl = lo + ct * kTile + r0;
      const bool v0 = valid.slot(gl), v1 = valid.slot(gl + 8);
      const float l0 = logit(c[0], ss[r0], v0, sqrt_hd, softcap);
      const float l1 = logit(c[1], ss[r0], v0, sqrt_hd, softcap);
      const float l2 = logit(c[2], ss[r0 + 8], v1, sqrt_hd, softcap);
      const float l3 = logit(c[3], ss[r0 + 8], v1, sqrt_hd, softcap);
      // online softmax over the chunk's 16 slots (lanes of one t)
      float x0 = fmaxf(l0, l2), x1 = fmaxf(l1, l3);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
      }
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      const float al0 = expf(m0 - n0), al1 = expf(m1 - n1);
      const float p0 = expf(l0 - n0), p1 = expf(l1 - n1);
      const float p2 = expf(l2 - n0), p3 = expf(l3 - n1);
      float y0 = p0 + p2, y1 = p1 + p3;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        y0 += __shfl_xor_sync(0xffffffffu, y0, o);
        y1 += __shfl_xor_sync(0xffffffffu, y1, o);
      }
      s0 = s0 * al0 + y0;
      s1 = s1 * al1 + y1;
      m0 = n0;
      m1 = n1;
      // P^T in bf16 with the V scale folded in; position 4 (s % 4) + s / 4
      // of a query's row holds slot s
      const float vs0 = ss[kTile + r0], vs1 = ss[kTile + r0 + 8];
      const int c0 = 4 * (gq & 3) + (gq >> 2), c1 = c0 + 2;
      __syncwarp();                     // the previous chunk's reads are done
      pt[(2 * t) * 16 + c0] = __float2bfloat16(p0 * vs0);
      pt[(2 * t + 1) * 16 + c0] = __float2bfloat16(p1 * vs0);
      pt[(2 * t) * 16 + c1] = __float2bfloat16(p2 * vs1);
      pt[(2 * t + 1) * 16 + c1] = __float2bfloat16(p3 * vs1);
      __syncwarp();
      const uint2 pb = *reinterpret_cast<const uint2*>(pt + gq * 16 + 4 * t);
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
        acc[mt][0] *= al0;
        acc[mt][1] *= al1;
        acc[mt][2] *= al0;
        acc[mt][3] *= al1;
      }
      // PV, swap-AB: (HD, 8 queries) += V^T (HD x 16 slots) . P^T
      const uint8_t* vr = vs + (warp * 16 + t) * Tl::kVStride * 4;
#pragma unroll
      for (int blk = 0; blk < Tl::kWords / 8; ++blk) {
        uint32_t r[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const uint32_t*>(
              vr + 4 * i * Tl::kVStride * 4 + (gq + 8 * blk) * 4);
        transpose4(r, w);
#pragma unroll
        for (int j = 0; j < (INT4 ? 4 : 2); ++j) {
          uint32_t a[4];
          if constexpr (INT4) {
            nibbles4(w[j] & 0x0F0F0F0Fu, a[0], a[2]);
            nibbles4((w[j] >> 4) & 0x0F0F0F0Fu, a[1], a[3]);
          } else {
            dequant4<false>(w[2 * j], a[0], a[2]);
            dequant4<false>(w[2 * j + 1], a[1], a[3]);
          }
          mma_bf16(acc[(INT4 ? 4 : 2) * blk + j], a, pb.x, pb.y);
        }
      }
    }
    __syncthreads();                    // every warp is done with the stage
    if (lt < ntiles) {
      load_tile(slot, lt);
      lt = next_tile(lt + 1);
    }
    cp_async_commit();
    ct = next_tile(ct + 1);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' partials (over the ring), then the block's, in warp order
  float* wacc = reinterpret_cast<float*>(smem);   // [warp][query][HD]
  float* wm = wacc + 4 * kMaxRep * HD;            // [warp][query]
  float* wsum = wm + 4 * kMaxRep;
  constexpr int kDw = INT4 ? 8 : 4, kMpb = kDw / 2;   // d a word, m-tiles a blk
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = kDw * (gq + 8 * (mt / kMpb)) + 2 * (mt % kMpb) + (i >> 1);
      wacc[(warp * kMaxRep + 2 * t + (i & 1)) * HD + d] = acc[mt][i];
    }
  if (gq == 0) {
    wm[warp * kMaxRep + 2 * t] = m0;
    wm[warp * kMaxRep + 2 * t + 1] = m1;
    wsum[warp * kMaxRep + 2 * t] = s0;
    wsum[warp * kMaxRep + 2 * t + 1] = s1;
  }
  __syncthreads();
  float* bm = bpart;
  float* bsum = bm + kMaxRep;
  float* bacc = bsum + kMaxRep;
  for (int e = tid; e < rep * HD; e += kThreads) {
    const int r = e / HD;
    float mx = wm[r];
#pragma unroll
    for (int w = 1; w < 4; ++w) mx = fmaxf(mx, wm[w * kMaxRep + r]);
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      num += wacc[(w * kMaxRep + r) * HD + e % HD] *
             expf(wm[w * kMaxRep + r] - mx);
    bacc[e] = num;
  }
  for (int r = tid; r < rep; r += kThreads) {
    float mx = wm[r];
#pragma unroll
    for (int w = 1; w < 4; ++w) mx = fmaxf(mx, wm[w * kMaxRep + r]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      den += wsum[w * kMaxRep + r] * expf(wm[w * kMaxRep + r] - mx);
    bm[r] = mx;
    bsum[r] = den;
  }
  merge_splits<__nv_bfloat16>(bm, bsum, bacc, rep, HD,
                              out + ((size_t)bi * g + gi) * rep * HD);
}

// ---- fma instance -----------------------------------------------------------

// One (TL, hd) code tile from slot row0 -> fp32 rows of stride `ld` in
// shared memory; slots at or past hi are zero-filled.
template <bool INT4, bool PAGED>
__device__ void load_codes(const uint8_t* __restrict__ codes, float* dst,
                           int ld, int row0, int TL, int hi, int L, int g,
                           int gi, int bi, int hd, int vec_ok,
                           const int* __restrict__ bt, int bps, int bs) {
  const int hd_c = INT4 ? hd / 2 : hd;
  if (vec_ok) {                              // hd_c % 16 == 0, aligned rows
    const int chunks = hd_c / 16;
    for (int c = threadIdx.x; c < TL * chunks; c += kThreads) {
      const int l = c / chunks, part = c % chunks;
      const int gl = row0 + l;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gl < hi)
        v = *reinterpret_cast<const uint4*>(
            codes + (slot_row<PAGED>(bi, gl, L, bt, bps, bs) * g + gi) * hd_c +
            part * 16);
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const uint32_t byte = (w4[q / 4] >> (8 * (q % 4))) & 0xFF;
        if (INT4) {
          dst[l * ld + part * 32 + 2 * q] = static_cast<float>(nibble(byte));
          dst[l * ld + part * 32 + 2 * q + 1] = static_cast<float>(nibble(byte >> 4));
        } else {
          dst[l * ld + part * 16 + q] = static_cast<float>(static_cast<int8_t>(byte));
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < TL * hd_c; e += kThreads) {
      const int l = e / hd_c, j = e % hd_c;
      const int gl = row0 + l;
      const uint32_t byte =
          gl < hi ? codes[(slot_row<PAGED>(bi, gl, L, bt, bps, bs) * g + gi) *
                              hd_c + j]
                  : 0u;
      if (INT4) {
        dst[l * ld + 2 * j] = static_cast<float>(nibble(byte));
        dst[l * ld + 2 * j + 1] = static_cast<float>(nibble(byte >> 4));
      } else {
        dst[l * ld + j] = static_cast<float>(static_cast<int8_t>(byte));
      }
    }
  }
}

// Grid (splits, g, b) as the mma instance.  The block walks its split in
// TL-slot tiles (those with no valid slot skipped): codes unpacked to fp32
// in shared memory (K padded one column so the per-slot dot products read
// it without bank conflicts), one thread per (query, slot) logit, a warp per
// query for the online softmax, one thread per (query, d) for PV; the
// running max, denominator and (rep, hd) accumulator stay in shared memory
// and are the block's partial for the merge.
template <typename T, bool INT4, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attn_fma_kernel(const T* __restrict__ q,
                       const uint8_t* __restrict__ kc,
                       const float* __restrict__ ksc,
                       const uint8_t* __restrict__ vc,
                       const float* __restrict__ vsc,
                       const int* __restrict__ pos, T* __restrict__ out,
                       int g, int rep, int hd, int L, int TL, int per,
                       int window, float softcap, int vec_ok,
                       const int* __restrict__ bt, int bps, int bs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ldk = hd + 1;
  float* qs = reinterpret_cast<float*>(smem);   // rep * hd
  float* acc = qs + rep * hd;                // rep * hd
  float* ks = acc + rep * hd;                // TL * (hd + 1)
  float* vs = ks + TL * ldk;                 // TL * hd
  float* p = vs + TL * hd;                   // rep * TL
  float* kscale = p + rep * TL;              // TL
  float* vscale = kscale + TL;               // TL
  float* m_run = vscale + TL;                // rep
  float* s_run = m_run + rep;                // rep
  float* alpha = s_run + rep;                // rep

  const int gi = blockIdx.y, bi = blockIdx.z;
  const int t = threadIdx.x;
  int lo, hi;
  split_range(L, per, lo, hi);
  const Valid valid(pos[bi], L, window, lo, hi);
  const float sqrt_hd = sqrtf(static_cast<float>(hd));
  const size_t qoff = ((size_t)bi * g + gi) * rep * hd;

  for (int e = t; e < rep * hd; e += kThreads) {
    qs[e] = to_f32<T>(q[qoff + e]);
    acc[e] = 0.f;
  }
  for (int r = t; r < rep; r += kThreads) {
    m_run[r] = kNegInf;
    s_run[r] = 0.f;
  }

  for (int row0 = lo; row0 < hi; row0 += TL) {
    if (!valid.any(row0, row0 + TL)) continue;
    __syncthreads();                         // previous tile fully consumed
    load_codes<INT4, PAGED>(kc, ks, ldk, row0, TL, hi, L, g, gi, bi, hd,
                            vec_ok, bt, bps, bs);
    load_codes<INT4, PAGED>(vc, vs, hd, row0, TL, hi, L, g, gi, bi, hd,
                            vec_ok, bt, bps, bs);
    for (int l = t; l < TL; l += kThreads) {
      const int gl = row0 + l;
      if (gl < hi) {
        const size_t s_idx = slot_row<PAGED>(bi, gl, L, bt, bps, bs) * g + gi;
        kscale[l] = ksc[s_idx];
        vscale[l] = vsc[s_idx];
      } else {
        kscale[l] = 0.f;
        vscale[l] = 0.f;
      }
    }
    __syncthreads();

    // logits (rep, TL): raw-code dot, then the K scale, / sqrt(hd),
    // softcap and the ring-validity bias
    for (int e = t; e < rep * TL; e += kThreads) {
      const int r = e / TL, l = e % TL;
      const int gl = row0 + l;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[r * hd + d], ks[l * ldk + d], s);
      p[e] = logit(s, kscale[l], valid.slot(gl), sqrt_hd, softcap);
    }
    __syncthreads();

    // online-softmax update, one warp per query head of the group
    const int warp = t / 32, lane = t % 32;
    for (int r = warp; r < rep; r += kThreads / 32) {
      float mx = kNegInf;
      for (int l = lane; l < TL; l += 32) mx = fmaxf(mx, p[r * TL + l]);
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[r], mx);
      float sum = 0.f;
      for (int l = lane; l < TL; l += 32) {
        const float e = expf(p[r * TL + l] - m_new);
        sum += e;
        p[r * TL + l] = e * vscale[l];       // the V scale folds into p
      }
      for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_run[r] - m_new);
        alpha[r] = a;
        s_run[r] = s_run[r] * a + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + (p * v_scale) @ v
    for (int e = t; e < rep * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      float pv = 0.f;
      for (int l = 0; l < TL; ++l) pv = fmaf(p[r * TL + l], vs[l * hd + d], pv);
      acc[e] = acc[e] * alpha[r] + pv;
    }
  }
  merge_splits<T>(m_run, s_run, acc, rep, hd, out + qoff);
}

// ---- launchers ----------------------------------------------------------------

enum Instance { kMma = 0, kFma = 1 };

struct Call {
  const void* q;
  const uint8_t* kc;
  const float* ks;
  const uint8_t* vc;
  const float* vs;
  const int* pos;
  void* out;
  int b, g, rep, hd, L, window;
  float softcap;
  int splits, per, tile, stages;
  const int* bt;
  int bps, bs;
  cudaStream_t stream;
};

// Launch with the splits of each (b, kv-head) as one cluster (splits, 1, 1).
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), const Call& c,
                             size_t smem, Args... args) {
  if (c.splits < 1 || c.splits > kMaxSplits) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.splits, c.g, c.b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool INT4, int HD, bool PAGED>
cudaError_t launch_mma(const Call& c) {
  if (c.rep > kMaxRep || c.tile != kTile || c.stages < 1 ||
      c.stages > kMaxStages)
    return cudaErrorInvalidValue;
  return launch_clustered(
      decode_attn_mma_kernel<INT4, HD, PAGED>, c,
      MmaTile<INT4, HD>::smem(c.stages),
      static_cast<const __nv_bfloat16*>(c.q), c.kc, c.ks, c.vc, c.vs, c.pos,
      static_cast<__nv_bfloat16*>(c.out), c.g, c.rep, c.L, c.per, c.stages,
      c.window, c.softcap, c.bt, c.bps, c.bs);
}

template <typename T, bool INT4, bool PAGED>
cudaError_t launch_fma(const Call& c) {
  const int TL = c.tile;
  if (TL < 1) return cudaErrorInvalidValue;
  // 16-byte code loads where every code row is a 16-byte multiple, aligned
  const int vec_ok = (INT4 ? c.hd / 2 : c.hd) % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(c.kc) |
                      reinterpret_cast<uintptr_t>(c.vc)) % 16 == 0;
  const size_t floats = 2 * (size_t)c.rep * c.hd + (size_t)TL * (c.hd + 1) +
                        (size_t)TL * c.hd + (size_t)c.rep * TL + 2 * TL +
                        3 * c.rep;
  return launch_clustered(
      decode_attn_fma_kernel<T, INT4, PAGED>, c, floats * sizeof(float),
      static_cast<const T*>(c.q), c.kc, c.ks, c.vc, c.vs, c.pos,
      static_cast<T*>(c.out), c.g, c.rep, c.hd, c.L, TL, c.per, c.window,
      c.softcap, vec_ok, c.bt, c.bps, c.bs);
}

template <bool PAGED>
int dispatch(const Call& c, int bits, int dtype, int instance) {
  if (instance == kMma) {
    if (dtype != 1) return cudaErrorInvalidValue;   // bf16 q only
    if (bits == 8) {
      switch (c.hd) {
        case 32: return launch_mma<false, 32, PAGED>(c);
        case 64: return launch_mma<false, 64, PAGED>(c);
        case 128: return launch_mma<false, 128, PAGED>(c);
      }
    } else {
      switch (c.hd) {
        case 64: return launch_mma<true, 64, PAGED>(c);
        case 128: return launch_mma<true, 128, PAGED>(c);
      }
    }
    return cudaErrorInvalidValue;
  }
  if (instance != kFma) return cudaErrorInvalidValue;
  if (dtype == 1)
    return bits == 4 ? launch_fma<__nv_bfloat16, true, PAGED>(c)
                     : launch_fma<__nv_bfloat16, false, PAGED>(c);
  return bits == 4 ? launch_fma<float, true, PAGED>(c)
                   : launch_fma<float, false, PAGED>(c);
}

}  // namespace

// The launch plan comes from ops.py::plan.  dtype: 0 = float32, 1 =
// bfloat16.  bits: 4 or 8.  window <= 0: none.  softcap <= 0: none.
// instance: 0 mma, 1 fma; splits (at most 8, one cluster) of
// slots_per_split slots; tile: slots a tile (64 for mma); stages: the mma
// instance's cp.async ring (1-4; mma needs q and the codes 16-byte aligned
// and code rows a multiple of 32 bytes, which the plan checks).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan no instance
// takes.
extern "C" int decode_attn_launch(const void* q, const void* k_codes,
                                  const void* k_scale, const void* v_codes,
                                  const void* v_scale, const void* pos,
                                  void* out, int b, int g, int rep, int hd,
                                  int L, int bits, int window, float softcap,
                                  int dtype, int instance, int splits,
                                  int slots_per_split, int tile, int stages,
                                  void* stream) {
  const Call c{q, static_cast<const uint8_t*>(k_codes),
               static_cast<const float*>(k_scale),
               static_cast<const uint8_t*>(v_codes),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(pos), out, b, g, rep, hd, L, window,
               softcap, splits, slots_per_split, tile, stages, nullptr, 0, 0,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(c, bits, dtype, instance);
}

// The paged pool: codes (n_blocks, bs, g, hd[/2]), scales (n_blocks, bs, g,
// 1), int32 block tables (b, bps) of valid pool block ids; the ring length
// is bps * bs.  Other arguments as decode_attn_launch.
extern "C" int decode_attn_paged_launch(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, const void* block_tables,
    const void* pos, void* out, int b, int g, int rep, int hd, int bps,
    int bs, int bits, int window, float softcap, int dtype, int instance,
    int splits, int slots_per_split, int tile, int stages, void* stream) {
  const Call c{q, static_cast<const uint8_t*>(k_codes),
               static_cast<const float*>(k_scale),
               static_cast<const uint8_t*>(v_codes),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(pos), out, b, g, rep, hd, bps * bs,
               window, softcap, splits, slots_per_split, tile, stages,
               static_cast<const int*>(block_tables), bps, bs,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(c, bits, dtype, instance);
}
