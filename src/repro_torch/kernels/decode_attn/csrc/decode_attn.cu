// Fused decode attention over an int8 / packed-int4 ring KV cache or paged
// KV pool, for Hopper.
//
// Replaces: src/repro/kernels/decode_attn/decode_attn.py::decode_attn_pallas
// (body _decode_attn_kernel) and, with PAGED, ::decode_attn_paged_pallas
// (body _decode_attn_paged_kernel).  One GQA decode step: q (b, g, rep, hd) against
// codes (b, L, g, hd) int8 or (b, L, g, hd/2) uint8 (even index in the low
// nibble), scales (b, L, g, 1) fp32 and per-row positions pos (b,) int32.
// Per slot: unpack, raw-code dot with q, fold the K scale, divide by
// sqrt(hd), softcap, then the ring-validity (and sliding-window) bias; an
// online softmax over the slots and the V-scaled PV product.  Out is like q.
//
// What bounds it on an H100: bytes.  Each step reads the cache once,
// L * g * (hd or hd/2 + 4) bytes per tensor per row, at 3.35 TB/s; the
// arithmetic is 4 * rep * hd flops per slot, far below the card's rate.
//
// Design.  One block per (b, kv-head); the TPU's sequential L grid axis
// becomes a loop over TL-slot tiles inside the block.  A tile's K and V
// codes arrive with 16-byte loads, are unpacked to fp32 in shared memory
// (K padded one column so the per-slot dot products read it without bank
// conflicts), and the running max, denominator and (rep, hd) accumulator
// stay in shared memory across tiles.  The arithmetic order is the Pallas
// kernel's: fp32 dot of raw codes, then scale, softcap and bias; a fully
// masked tile is annihilated by the next valid tile's rescale.
//
// Paged (decode_attn_paged): codes (n_blocks, bs, g, hd[/2]) and scales
// (n_blocks, bs, g, 1) form a pool shared by all rows, and row bi's logical
// ring slot j lives in pool block bt[bi, j / bs] at offset j % bs (int32
// block table bt (b, bps), L = bps * bs).  Only the address of a slot
// changes: each TL-slot tile gathers its slots (TL / bs whole blocks when bs
// divides TL) through the table, and every tile's arithmetic is the ring
// kernel's, so on the gathered view the two kernels agree bit for bit for
// any bs.  The Pallas kernel walks one pool block per grid step instead.
// At b = 8
// and g = 8 this is 64 blocks on 132 SMs: the first thing a later version
// fixes (split the slots over more blocks and merge the partial softmaxes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int nibble(uint32_t b) {
  int v = static_cast<int>(b & 0xF);
  return v > 7 ? v - 16 : v;
}

// Where the slot lives: row bi's ring slot gl in a (b, L, ...) cache, or
// in the pool, block bt[bi, gl / bs] at offset gl % bs of a (n_blocks, bs,
// ...) pool; in units of one slot's (g, ...) entries.
template <bool PAGED>
__device__ __forceinline__ size_t slot_row(int bi, int gl, int L,
                                           const int* __restrict__ bt, int bps,
                                           int bs) {
  if (PAGED) return (size_t)bt[(size_t)bi * bps + gl / bs] * bs + gl % bs;
  return (size_t)bi * L + gl;
}

// One (TL, hd) code tile -> fp32 rows of stride `ld` in shared memory.
// Slots at or past L are zero-filled (they are masked out of the softmax).
template <bool INT4, bool PAGED>
__device__ void load_codes(const uint8_t* __restrict__ codes, float* dst,
                           int ld, int row0, int TL, int L, int g, int gi,
                           int bi, int hd, int vec_ok,
                           const int* __restrict__ bt, int bps, int bs) {
  const int hd_c = INT4 ? hd / 2 : hd;
  if (vec_ok) {                              // hd_c % 16 == 0, aligned rows
    const int chunks = hd_c / 16;
    for (int c = threadIdx.x; c < TL * chunks; c += kThreads) {
      const int l = c / chunks, part = c % chunks;
      const int gl = row0 + l;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gl < L)
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
          gl < L ? codes[(slot_row<PAGED>(bi, gl, L, bt, bps, bs) * g + gi) *
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

template <typename T, bool INT4, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kc,
                   const float* __restrict__ ksc, const uint8_t* __restrict__ vc,
                   const float* __restrict__ vsc, const int* __restrict__ pos,
                   T* __restrict__ out, int g, int rep, int hd, int L, int TL,
                   int window, float softcap, int vec_ok,
                   const int* __restrict__ bt, int bps, int bs) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;
  float* qs = smem;                          // rep * hd
  float* acc = qs + rep * hd;                // rep * hd
  float* ks = acc + rep * hd;                // TL * (hd + 1)
  float* vs = ks + TL * ldk;                 // TL * hd
  float* p = vs + TL * hd;                   // rep * TL
  float* kscale = p + rep * TL;              // TL
  float* vscale = kscale + TL;               // TL
  float* m_run = vscale + TL;                // rep
  float* s_run = m_run + rep;                // rep
  float* alpha = s_run + rep;                // rep

  const int bi = blockIdx.x / g, gi = blockIdx.x % g;
  const int t = threadIdx.x;
  const int row_pos = pos[bi];
  const float inv_sqrt_hd = 1.0f / sqrtf(static_cast<float>(hd));
  const size_t qoff = ((size_t)bi * g + gi) * rep * hd;

  for (int e = t; e < rep * hd; e += kThreads) {
    qs[e] = to_f32<T>(q[qoff + e]);
    acc[e] = 0.f;
  }
  for (int r = t; r < rep; r += kThreads) {
    m_run[r] = kNegInf;
    s_run[r] = 0.f;
  }

  for (int row0 = 0; row0 < L; row0 += TL) {
    __syncthreads();                         // previous tile fully consumed
    load_codes<INT4, PAGED>(kc, ks, ldk, row0, TL, L, g, gi, bi, hd, vec_ok,
                            bt, bps, bs);
    load_codes<INT4, PAGED>(vc, vs, hd, row0, TL, L, g, gi, bi, hd, vec_ok,
                            bt, bps, bs);
    for (int l = t; l < TL; l += kThreads) {
      const int gl = row0 + l;
      if (gl < L) {
        const size_t s_idx = slot_row<PAGED>(bi, gl, L, bt, bps, bs) * g + gi;
        kscale[l] = ksc[s_idx];
        vscale[l] = vsc[s_idx];
      } else {
        kscale[l] = 0.f;
        vscale[l] = 0.f;
      }
    }
    __syncthreads();

    // logits (rep, TL): raw-code dot, fold the K scale, 1/sqrt(hd),
    // softcap, then the ring-validity bias
    for (int e = t; e < rep * TL; e += kThreads) {
      const int r = e / TL, l = e % TL;
      const int gl = row0 + l;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[r * hd + d], ks[l * ldk + d], s);
      float logit = (s * kscale[l]) * inv_sqrt_hd;
      if (softcap > 0.f) logit = softcap * tanhf(logit / softcap);
      // slot j holds p_j = pos - ((pos - j) mod L), mod taken non-negative
      int md = (row_pos - gl) % L;
      if (md < 0) md += L;
      const int p_j = row_pos - md;
      bool valid = gl < L && p_j >= 0;
      if (window > 0) valid = valid && (row_pos - p_j) < window;
      p[e] = logit + (valid ? 0.f : kNegInf);
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
  __syncthreads();
  for (int e = t; e < rep * hd; e += kThreads) {
    const int r = e / hd;
    out[qoff + e] = from_f32<T>(acc[e] / fmaxf(s_run[r], 1e-30f));
  }
}

template <typename T, bool INT4, bool PAGED>
cudaError_t launch(const void* q, const void* kc, const float* ksc,
                   const void* vc, const float* vsc, const int* pos, void* out,
                   int b, int g, int rep, int hd, int L, int window,
                   float softcap, int vec_ok, const int* bt, int bps, int bs,
                   cudaStream_t stream) {
  // slots per tile: about 4096 code values per tensor, at least 8
  int TL = 4096 / hd;
  TL = TL < 8 ? 8 : (TL > 64 ? 64 : TL);
  const size_t floats = 2 * (size_t)rep * hd + (size_t)TL * (hd + 1) +
                        (size_t)TL * hd + (size_t)rep * TL + 2 * TL + 3 * rep;
  const size_t smem = floats * sizeof(float);
  auto kern = decode_attn_kernel<T, INT4, PAGED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<b * g, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(kc), ksc,
      static_cast<const uint8_t*>(vc), vsc, pos, static_cast<T*>(out), g, rep,
      hd, L, TL, window, softcap, vec_ok, bt, bps, bs);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(const void* q, const void* k_codes, const void* k_scale,
             const void* v_codes, const void* v_scale, const void* pos,
             void* out, int b, int g, int rep, int hd, int L, int bits,
             int window, float softcap, int dtype, int vec_ok, const int* bt,
             int bps, int bs, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return bits == 4
        ? launch<__nv_bfloat16, true, PAGED>(q, k_codes, ks, v_codes, vs, ps, out, b, g, rep, hd, L, window, softcap, vec_ok, bt, bps, bs, st)
        : launch<__nv_bfloat16, false, PAGED>(q, k_codes, ks, v_codes, vs, ps, out, b, g, rep, hd, L, window, softcap, vec_ok, bt, bps, bs, st);
  }
  return bits == 4
      ? launch<float, true, PAGED>(q, k_codes, ks, v_codes, vs, ps, out, b, g, rep, hd, L, window, softcap, vec_ok, bt, bps, bs, st)
      : launch<float, false, PAGED>(q, k_codes, ks, v_codes, vs, ps, out, b, g, rep, hd, L, window, softcap, vec_ok, bt, bps, bs, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bits: 4 or 8.  window <= 0: none.
// softcap <= 0: none.  vec_ok: 1 when code rows are 16-byte multiples and
// aligned (checked by the wrapper).  Returns cudaGetLastError().
extern "C" int decode_attn_launch(const void* q, const void* k_codes,
                                  const void* k_scale, const void* v_codes,
                                  const void* v_scale, const void* pos,
                                  void* out, int b, int g, int rep, int hd,
                                  int L, int bits, int window, float softcap,
                                  int dtype, int vec_ok, void* stream) {
  return dispatch<false>(q, k_codes, k_scale, v_codes, v_scale, pos, out, b,
                         g, rep, hd, L, bits, window, softcap, dtype, vec_ok,
                         nullptr, 0, 0, stream);
}

// The paged pool: codes (n_blocks, bs, g, hd[/2]), scales (n_blocks, bs, g,
// 1), int32 block tables (b, bps) of valid pool block ids; the ring length
// is bps * bs.  Other arguments as decode_attn_launch.
extern "C" int decode_attn_paged_launch(const void* q, const void* k_codes,
                                        const void* k_scale,
                                        const void* v_codes,
                                        const void* v_scale,
                                        const void* block_tables,
                                        const void* pos, void* out, int b,
                                        int g, int rep, int hd, int bps,
                                        int bs, int bits, int window,
                                        float softcap, int dtype, int vec_ok,
                                        void* stream) {
  return dispatch<true>(q, k_codes, k_scale, v_codes, v_scale, pos, out, b, g,
                        rep, hd, bps * bs, bits, window, softcap, dtype,
                        vec_ok, static_cast<const int*>(block_tables), bps, bs,
                        stream);
}
