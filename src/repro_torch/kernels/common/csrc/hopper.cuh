// Device helpers shared by the port's tensor-core kernels (wqt_matmul.cu,
// wqt_matmul_a8.cu, decode_attn.cu): dtype conversions, cp.async,
// mma.sync m16n8k16 bf16 and m16n8k32 s8, the exact conversion of int8 /
// packed int4 codes to bf16 pairs in registers, and packed int4 codes as
// int8 operands.  Everything is in an anonymous namespace, one copy per
// translation unit.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype() does
}

// Sign-extended nibble: 0..7 -> 0..7, 8..15 -> -8..-1.
__device__ __forceinline__ int nibble(uint32_t b) {
  int v = static_cast<int>(b & 0xF);
  return v > 7 ? v - 16 : v;
}

// ---- Hopper primitives (inline PTX) --------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared through L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 accumulate: exact.
// Lane (g, t) = (lane / 4, lane % 4) holds a[0] = A[g][4t .. 4t+3],
// a[1] = A[g+8][4t ..], a[2] = A[g][16+4t ..], a[3] = A[g+8][16+4t ..],
// b0 = B[4t .. 4t+3][g], b1 = B[16+4t ..][g]; d as for mma_bf16.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// ---- exact dequantization of integer codes to bf16 pairs ----------------

__device__ __forceinline__ uint32_t bf16x2_sub136(uint32_t v) {
  const uint32_t k136 = 0x43084308u;            // bf16 pair (136, 136)
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&r);
}

// lo = codes & 0x0F0F0F0F and hi = (codes >> 4) & 0x0F0F0F0F of 4 packed
// int4 bytes -> the bf16 pair (low nibble, high nibble) of byte I, i.e.
// (even k, odd k): the nibbles go into the mantissa of bf16 128 biased by
// 8 (one byte_perm, one lop3), then one packed subtract of 136.
template <int I>
__device__ __forceinline__ uint32_t int4_pair(uint32_t lo, uint32_t hi) {
  const uint32_t p = __byte_perm(lo, hi, I | ((I + 4) << 8));
  return bf16x2_sub136((p & 0x000F000Fu) ^ 0x43084308u);
}

// Signed int8 byte I of w -> fp32, exactly: 2^23 + (c + 128) by byte_perm
// into the mantissa of 2^23, minus 2^23 + 128.
template <int I>
__device__ __forceinline__ float int8_at(uint32_t w_biased) {
  return __uint_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7540 | I)) -
         8388736.f;
}

// A code word of 4 consecutive k (int4: 2 bytes in the low half; int8: 4
// bytes) -> two bf16 pairs, (k0, k1) and (k2, k3).
template <bool INT4>
__device__ __forceinline__ void dequant4(uint32_t w, uint32_t& p01,
                                         uint32_t& p23) {
  if constexpr (INT4) {
    const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
    p01 = int4_pair<0>(lo, hi);
    p23 = int4_pair<1>(lo, hi);
  } else {
    const uint32_t u = w ^ 0x80808080u;
    __nv_bfloat162 a = __floats2bfloat162_rn(int8_at<0>(u), int8_at<1>(u));
    __nv_bfloat162 b = __floats2bfloat162_rn(int8_at<2>(u), int8_at<3>(u));
    p01 = *reinterpret_cast<uint32_t*>(&a);
    p23 = *reinterpret_cast<uint32_t*>(&b);
  }
}

// ---- int4 codes as int8 operands ----------------------------------------

// 4 packed int4 bytes (8 codes c0 .. c7, the even one low in each byte) ->
// two words of 4 int8 each holding 16 * c: `even` = (c0, c2, c4, c6) and
// `odd` = (c1, c3, c5, c7).  A nibble in the high half of its byte is, read
// as int8, its signed value times 16 (-128 .. 112), so an s8 mma on these
// words sums 16x the codes' products: exact, and shifted right by 4 after.
__device__ __forceinline__ void int4_s8x16(uint32_t w, uint32_t& even,
                                           uint32_t& odd) {
  even = (w << 4) & 0xF0F0F0F0u;
  odd = w & 0xF0F0F0F0u;
}

// 8 int8 codes (c0 .. c7 as the bytes of lo, hi) -> the order int4_s8x16
// gives the weights: lo' = (c0, c2, c4, c6), hi' = (c1, c3, c5, c7).
__device__ __forceinline__ void s8_even_odd(uint32_t& lo, uint32_t& hi) {
  const uint32_t e = __byte_perm(lo, hi, 0x6420), o = __byte_perm(lo, hi, 0x7531);
  lo = e;
  hi = o;
}

}  // namespace
