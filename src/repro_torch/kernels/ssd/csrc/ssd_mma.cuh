// mma.sync, ldmatrix and cp.async helpers shared by the SSD's forward
// (ssd.cu) and backward (ssd_bwd.cu) tensor-core kernels: the bf16
// kernels' m16n8k16 products (below), and the fp32 kernels' TF32 ones
// (split_tf32, mma_tf32, mma3; at the end).
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

// ---------------------------------------------------------------------------
// TF32: fp32 operands on the tensor cores (ssd_chunk_tf32,
// ssd_carry_tf32 and the backward's ssd_chunk_bwd_tf32 and
// ssd_carry_bwd_tf32, the bf16 kernels' fp32 siblings).  split_tf32 and
// mma_tf32 are the flash-attention fp32 kernels' (fa_tf32.cuh), copied:
// each fp32 operand is split into two TF32 terms and every product taken
// as three TF32 products, hi·hi + hi·lo + lo·hi, summed in fp32 (the
// dropped lo·lo is below 2^-22 of the product).
//
// Fragments of m16n8k8 (g = lane / 4, c = lane % 4): A a0 (row g, k slot
// c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4); B b0 (slot c,
// column g), b1 (slot c + 4, g); the accumulator d0, d1 (row g, columns
// 2c, 2c + 1), d2, d3 (row g + 8).  A slot is any k the two operands
// agree on: reading an accumulator's columns 2c and 2c + 1 as slots c and
// c + 4 (and the B operand's rows 2c and 2c + 1 into the same slots)
// permutes the sum within the k8 step, so that an accumulator becomes an
// A fragment without shared memory.
// ---------------------------------------------------------------------------

// x's TF32 terms, as mma.sync reads a .tf32 operand (the top 19 bits of
// its 32): hi = x rounded to 10 mantissa bits, to nearest with ties away
// from zero (cvt.rna.tf32.f32's rounding, in two integer operations), and
// lo = x - hi, exact in fp32, which the tensor cores read cut to its top
// 10 mantissa bits.  x - hi keeps a NaN a NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b: m16n8k8, TF32 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (a0 .. a3 as above) split into its TF32 terms.
struct Tf32A {
  uint32_t hi[4], lo[4];
  Tf32A() = default;
  __device__ __forceinline__ Tf32A(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

// A B fragment (b0, b1) split into its TF32 terms.
struct Tf32B {
  uint32_t hi[2], lo[2];
  Tf32B() = default;
  __device__ __forceinline__ Tf32B(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

// d[n0 + i] += a b[i] for NN n-tiles in three TF32 products each, hi·hi +
// hi·lo + lo·hi; one term over every n-tile before the next, so that no
// product waits on the one before.
template <int NN, int M>
__device__ __forceinline__ void mma3(float (&d)[M][4], int n0,
                                     const Tf32A& a, const Tf32B (&b)[NN]) {
#pragma unroll
  for (int i = 0; i < NN; ++i)
    mma_tf32(d[n0 + i], a.hi, b[i].hi[0], b[i].hi[1]);
#pragma unroll
  for (int i = 0; i < NN; ++i)
    mma_tf32(d[n0 + i], a.hi, b[i].lo[0], b[i].lo[1]);
#pragma unroll
  for (int i = 0; i < NN; ++i)
    mma_tf32(d[n0 + i], a.lo, b[i].hi[0], b[i].hi[1]);
}

// Heads per block of the fp32 tensor-core kernels (ssd_chunk_tf32,
// ssd_chunk_bwd_tf32): the divisor g of H up to 16 that minimises
// ceil(blocks / slots) (g + 1), the grid's waves (slots: the blocks the
// card holds at once) times a block's work (its g heads, and about one
// head's more for what it does once: B and C, C . B^T and, backward, the
// summed dC . B^T gradient's products), the larger g on a tie.  The rule
// follows the kernels' times at every g (tools/ssd_ab.py --heads at
// mamba2-780m's heads, PERF.md): a half-empty last wave costs more than
// a block's once-only work.  kernel.py's tf32_heads is the same rule.
__host__ __device__ inline int tf32_heads(int pairs, int H, int slots) {
  int best = 1;
  int64_t cost = -1;
  for (int g = 1; g <= 16; ++g) {
    if (H % g) continue;
    const int64_t blocks = (int64_t)pairs * (H / g);
    const int64_t c = (blocks + slots - 1) / slots * (g + 1);
    if (cost < 0 || c <= cost) {
      cost = c;
      best = g;
    }
  }
  return best;
}

// Word offset of (row r, column c) in a [rows][64] fp32 tile whose 16-byte
// chunk k of row r is stored at chunk k ^ (r % 8) of its group of eight
// (fa_tf32.cuh's tf32_at at 64 columns): ldmatrix's eight rows (K-major
// fragments) and the 32-bit loads of rows 2c and 2c + 1 at column g (a B
// operand read MN-major in the permuted slots) each meet no bank twice.
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((((c >> 2) ^ r) & 7) | ((c >> 2) & ~7)) * 4 + (c & 3);
}

}  // namespace
