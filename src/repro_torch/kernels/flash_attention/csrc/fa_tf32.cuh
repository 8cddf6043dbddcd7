// TF32 tensor-core building blocks shared by the fp32 flash-attention
// kernels (flash_attention.cu's fa_kernel_tf32, flash_attention_bwd.cu's
// fa_bwd_dkdv_tf32 and fa_bwd_dq_tf32): mma.sync m16n8k8 with TF32
// operands, each fp32 operand split into two TF32 terms and every product
// taken as three TF32 products, hi·hi + hi·lo + lo·hi, summed in fp32
// (split_tf32, mma3); fragments read from swizzled fp32 tiles in shared
// memory (tf32_at) that a 2-stage cp.async ring fills (tf32_load_tile).
// Both libraries hash this header with their source (kernel.py's
// CudaLibrary ``headers``), so a change here rebuilds them.
//
// Tiles are [rows][W] fp32, W a column bucket (fa_bucket), with 16-byte
// chunk c of row r stored at chunk c ^ (r % 8), so that ldmatrix's eight
// rows (K-major reads, mma_nt) and the 32-bit loads of rows 2c and 2c + 1
// (MN-major reads, mma_tn) meet no bank twice.
#pragma once

#include "fa_hopper.cuh"

// An anonymous namespace, as in fa_hopper.cuh: each library that includes
// this header gets its own copy.
namespace {

// Rows a block of the fp32 kernels owns, and rows of each tile it streams,
// at bucket W.
template <int W>
__host__ __device__ constexpr int f32_rows() {
  return W <= 128 ? 64 : 32;
}

template <int W>
struct Tf32 {
  static constexpr int R = f32_rows<W>();
  static constexpr int G = R / 16;        // warps per role (dK/dV) or half
                                          // (dQ, the forward)
  static constexpr int NT = 64 * G;       // threads: two warps per 16 rows
  static constexpr int S = 2;             // ring stages
  // Output n-tiles (8 columns each) whose tile sums are taken together
  // (4 at W = 256, where 8 more sums spill).
  static constexpr int NG = W / 8 < 8 ? W / 8 : W < 256 ? 8 : 4;
};

// Word offset of (row r, column c) in a [rows][W] fp32 tile: 16-byte
// chunk c / 4 of row r stored at chunk (c / 4) ^ (r % 8).
template <int W>
__device__ __forceinline__ int tf32_at(int r, int c) {
  return r * W + ((((c >> 2) ^ r) & 7) | ((c >> 2) & ~7)) * 4 + (c & 3);
}

__device__ __forceinline__ void cp_async_zfill16(uint32_t dst,
                                                 const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_zfill4(uint32_t dst,
                                                const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows r0 .. r0 + R - 1 of one (b, h) slice (rows `row` elements apart)
// into the tile at dst, through cp.async (not waited for); rows at or past
// L and columns at or past D zero.  `vec`: D % 4 = 0, so a 16-byte chunk
// is all in or all out (the wrapper aligns the tensors to 16 bytes).
template <int W, int R, int NT>
__device__ __forceinline__ void tf32_load_tile(float* dst, const float* base,
                                               int64_t row, int r0, int L,
                                               int D, bool vec) {
  const uint32_t s = smem_addr(dst);
  if (vec) {
    constexpr int CH = R * W / 4;  // 16-byte chunks
    static_assert(CH % NT == 0, "a tile is not a whole number of rounds");
#pragma unroll
    for (int n = 0; n < CH / NT; ++n) {
      const int e = threadIdx.x + n * NT;
      const int r = e / (W / 4), c = 4 * (e % (W / 4));
      const bool ok = r0 + r < L && c < D;
      cp_async_zfill16(s + 4 * tf32_at<W>(r, c),
                       ok ? base + (r0 + r) * row + c : base, ok);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * W; e += NT) {
      const int r = e / W, c = e % W;
      const bool ok = r0 + r < L && c < D;
      cp_async_zfill4(s + 4 * tf32_at<W>(r, c),
                      ok ? base + (r0 + r) * row + c : base, ok);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// x's TF32 terms, as mma.sync reads a .tf32 operand (the top 19 bits of
// its 32): hi = x rounded to 10 mantissa bits, to nearest with ties away
// from zero (cvt.rna.tf32.f32's rounding, in two integer operations:
// ptxas expands cvt.rna.tf32.f32 into a longer compare-and-select
// sequence), and lo = x - hi, exact in fp32, which the tensor cores read
// cut to its top 10 mantissa bits (clearing lo's 13 low bits by hand
// gives the same outputs bit for bit: tools/fa_ab.py --ceilings).
// x - hi keeps a NaN a NaN, so a NaN operand still makes its products NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Fragments of m16n8k8 (g = lane / 4, c = lane % 4): A a0 (row g, k c),
// a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4); B b0 (k c, column g),
// b1 (k c + 4, g); the accumulator d0, d1 (row g, columns 2c, 2c + 1),
// d2, d3 (row g + 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its TF32 terms.
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

// d[i] += a b[i] for N n-tiles in three TF32 products each, hi·hi +
// hi·lo + lo·hi (b[i] split into bh[i], bl[i]); one term over every
// n-tile before the next, so that no product waits on the one before.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const Tf32A& a,
                                     const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a.hi, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a.hi, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a.lo, bh[i][0], bh[i][1]);
}

// The B fragments of NN n-tiles (8 rows each) of a swizzled tile of W
// columns for one k8 step, read K-major with ldmatrix (`addr`: the lane's
// row of n-tile 0 at the step's chunk; n-tiles in pairs: (n 0-7, k 0-3),
// (0-7, 4-7), (8-15, 0-3), (8-15, 4-7)) and split into their TF32 terms.
template <int W, int NN>
__device__ __forceinline__ void ldsm_split_b(uint32_t (&bh)[NN][2],
                                             uint32_t (&bl)[NN][2],
                                             uint32_t addr) {
  static_assert(NN % 2 == 0, "n-tiles are loaded in pairs");
#pragma unroll
  for (int i = 0; i < NN; i += 2) {
    uint32_t b[4];
    ldsm_x4(b, addr + 8 * i * W * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(__uint_as_float(b[e]), bh[i + e / 2][e % 2],
                 bl[i + e / 2][e % 2]);
  }
}

// acc[p][i] += X_p Y_p^T for NP products at once (more independent sums
// in flight): X_p the warp's 16 rows and Y_p 8 NN rows of swizzled tiles
// of W columns, contracted over their first 8 nks columns (both
// K-major, read with ldmatrix); n-tile i is Y_p's rows 8 i .. 8 i + 7.
template <int W, int NN, int NP>
__device__ __forceinline__ void mma_nt(float (&acc)[NP][NN][4],
                                       const float* const (&x)[NP],
                                       const float* const (&y)[NP], int nks,
                                       int lane) {
  const int sw = lane & 7;  // = the row's r % 8 for every lane below
  // A: matrices (rows 0-7, k 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7).
  const int xrow = (lane & 7) + 8 * ((lane >> 3) & 1), xk = lane >> 4;
  // B: as ldsm_split_b reads them.
  const int yrow = (lane & 7) + 8 * (lane >> 4), yk = (lane >> 3) & 1;
  uint32_t xa[NP], ya[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    xa[p] = smem_addr(x[p]) + xrow * W * 4;
    ya[p] = smem_addr(y[p]) + yrow * W * 4;
  }
#pragma unroll 1
  for (int kk = 0; kk < nks; ++kk) {
    const uint32_t xo = ((2 * kk + xk) ^ sw) << 4;
    const uint32_t yo = ((2 * kk + yk) ^ sw) << 4;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t a[4];
      ldsm_x4(a, xa[p] + xo);
      const Tf32A af(__uint_as_float(a[0]), __uint_as_float(a[1]),
                     __uint_as_float(a[2]), __uint_as_float(a[3]));
      uint32_t bh[NN][2], bl[NN][2];
      ldsm_split_b<W, NN>(bh, bl, ya[p] + yo);
      mma3(acc[p], af, bh, bl);
    }
  }
}

// Row pointers of the MN-major B operand Y (a swizzled tile of W
// columns) for lane `lane`: column 8 n + g of row 2c sits in chunk
// ((2n + g / 4) % 8) ^ 2c of chunk group n / 4, that of row 2c + 1 in the
// chunk beside it; y0[n % 4] and y1[n % 4] hold the word offsets for
// n % 4, the rest is each load's constant offset.
template <int W>
__device__ __forceinline__ void tn_rows(const float* (&y0)[4],
                                        const float* (&y1)[4],
                                        const float* y, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int o = (((2 * u) ^ (2 * c)) | (g >> 2)) * 4 + (g & 3);
    y0[u] = y + 2 * c * W + o;
    y1[u] = y + (2 * c + 1) * W + (o ^ 4);
  }
}

// t = A Y over the output n-tiles n0 .. n0 + N - 1, summed from zero on
// the tensor cores: A the split 16 x 8 NM tile (split_rows), Y's rows
// from tn_rows.
template <int W, int NM, int N>
__device__ __forceinline__ void tn_group(float (&t)[N][4],
                                         const Tf32A (&a)[NM],
                                         const float* (&y0)[4],
                                         const float* (&y1)[4], int n0) {
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) t[u][r] = 0.f;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    uint32_t bh[N][2], bl[N][2];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int n = n0 + u, at = 8 * m * W + 32 * (n / 4);
      split_tf32(y0[n % 4][at], bh[u][0], bl[u][0]);
      split_tf32(y1[n % 4][at], bh[u][1], bl[u][1]);
    }
    mma3(t, a[m], bh, bl);
  }
}

// out[n] += A Y for the output columns 8 n .. 8 n + 7 (in groups of NG
// n-tiles, none wholly at or past D): A the warp's 16 x 8 NM tile, split
// (a[m]: accumulator columns 8 m + 2c, 2c + 1 fed as the k indices c,
// c + 4), Y rows 8 m .. of a swizzled tile of W columns, read in the same
// order (MN-major).  Each group's product is summed from zero on the
// tensor cores and added to out in fp32: their own accumulation cuts
// rather than rounds, and carried across 4,096 keys it drifted to half
// the bar in dK.
template <int W, int NM>
__device__ __forceinline__ void mma_tn(float (&out)[W / 8][4],
                                       const Tf32A (&a)[NM], const float* y,
                                       int D, int lane) {
  constexpr int NG = Tf32<W>::NG;
  const float* y0[4];
  const float* y1[4];
  tn_rows<W>(y0, y1, y, lane);
#pragma unroll
  for (int n0 = 0; n0 < W / 8; n0 += NG) {
    if (8 * n0 >= D) break;
    float t[NG][4];
    tn_group<W, NM, NG>(t, a, y0, y1, n0);
#pragma unroll
    for (int u = 0; u < NG; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) out[n0 + u][r] += t[u][r];
  }
}

// The split A operand of mma_tn from a 16 x 8 NM accumulator tile.
template <int NM>
__device__ __forceinline__ void split_rows(Tf32A (&a)[NM],
                                           const float (&x)[NM][4]) {
#pragma unroll
  for (int m = 0; m < NM; ++m)
    a[m] = Tf32A(x[m][0], x[m][2], x[m][1], x[m][3]);
}

}  // namespace
