// mma.sync, ldmatrix and cp.async helpers shared by the SSD's forward
// (ssd.cu) and backward (ssd_bwd.cu) tensor-core kernels.
//
// Fragment layouts of mma.sync m16n8k16 (bf16 inputs, fp32 accumulator),
// with g = lane / 4 and q = lane % 4:
//   A (16 x 16, row-major)   a[0] (row g, cols 2q, 2q + 1), a[1] row g + 8,
//                            a[2] cols + 8, a[3] row g + 8 and cols + 8;
//   B (16 x 8, k x n)        b0 (k = 2q, 2q + 1; n = g), b1 k + 8;
//   C (16 x 8)               c[0], c[1] (row g, cols 2q, 2q + 1), c[2],
//                            c[3] row g + 8.
// So the accumulators of two neighbouring n-tiles are, element for
// element, the A fragment of one k16 step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most `n` of this thread's newest groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b: m16n8k16, bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Splits the fp32 pair (x, y) into NT bf16 pairs: each term is the
// rounding of what the earlier ones left (the first element in the low
// half, as the fragments want it).
template <int NT>
__device__ __forceinline__ void split(float x, float y, uint32_t (&t)[NT]) {
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x, y);
    t[k] = bits(a);
    x -= __low2float(a);
    y -= __high2float(a);
  }
}

// The two bf16 halves of a fragment register as floats.
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
  return make_float2(__low2float(v), __high2float(v));
}

}  // namespace
