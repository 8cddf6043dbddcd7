// Hopper building blocks shared by the flash-attention kernels
// (flash_attention.cu's fa_kernel_tc and flash_attention_bwd.cu's
// fa_bwd_dkdv_tc and fa_bwd_dq_tc): TMA tensor maps and copies, mbarrier
// rings, wgmma descriptors and products, the exact three-term bf16 split,
// and the tile geometry.  Both libraries hash this header with their
// source (kernel.py's CudaLibrary ``headers``), so a change here rebuilds
// them.
//
// Every tile is 64 rows of a [B, L, H, D] bf16 tensor, stored as NB boxes
// of [64 rows][CB columns], each written by one TMA copy in the swizzled
// layout that the wgmma descriptors name.  The kernels are built for a few
// column buckets W (fa_bucket: 32, 64, 128, 192, 256) and take the head
// dim D <= W at run time: the tensor maps span the true D, so TMA fills
// the box columns D .. W - 1 with zeros, the products run over all W
// columns (the zeros add exact zeros) and the epilogues write only the
// first D output columns.  Two ways to read a tile:
//
// * K-major (issue_qk): the tile is an operand whose contraction runs
//   along its W columns (q and k in q k^T; k and q in k q^T; v and dO in
//   v dO^T), 32 bytes further along the row per k16 step.
// * MN-major (issue_pv): the tile is the B operand of a product whose
//   contraction runs along its 64 rows (v in p v; dO and q in P^T dO and
//   dS^T q; k in dS k), the transpose bit set, 16 rows further on per k16
//   step; the A operand is an fp32 accumulator fragment split into three
//   bf16 terms in registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// An anonymous namespace: each library that includes this header gets its
// own copy, as if the functions were written in its source.
namespace {

constexpr int kTile = 64;         // rows of every TMA tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry of a 64-row tile of W columns (a bucket).
template <int W>
struct Geo {
  static constexpr int CB = W < 64 ? W : 64;    // columns per box
  static constexpr int NB = (W + CB - 1) / CB;  // boxes per row
  static constexpr int ROW = CB * 2;            // bytes of a box row
  static constexpr int BOX = kTile * ROW;       // bytes of a box
  static constexpr int TILE = NB * BOX;         // bytes of a 64-row tile
  static constexpr int KSTEPS = CB / 16;        // k16 steps per box
  static constexpr int LAYOUT = ROW == 128 ? 1 : 2;  // 128B / 64B swizzle
  static constexpr int ON = W < 64 ? W / 2 : 32;     // accumulator registers
                                                     // per box (M = 64)
};

// Stages of a ring whose stage holds two W-column tiles (the forward's k
// and v, dK/dV's q and dO): as deep as fits beside the kernel's other
// tiles in the 232,448 bytes a block may use, at most 4.
template <int W>
__host__ __device__ constexpr int ring_stages() {
  return W <= 128 ? 4 : W <= 192 ? 3 : 2;
}

// The column bucket of head dim D: the kernels' tiles are W columns wide
// and D's own columns come first; 0 past 256.  Mirrored by kernel.py's
// ``bucket``.
inline int fa_bucket(int D) {
  if (D < 1) return 0;
  if (D <= 32) return 32;
  if (D <= 64) return 64;
  if (D <= 128) return 128;
  if (D <= 192) return 192;
  if (D <= 256) return 256;
  return 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map (D, H, L, B) into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int row,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
      "r"(h), "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit; results under 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// Splits the fp32 pair (x, y) into three bf16 pairs whose sum is (x, y):
// each term is the rounding of what the earlier ones left.
__device__ __forceinline__ void split3(float x, float y, uint32_t& t1,
                                       uint32_t& t2, uint32_t& t3) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x, y);
  const float rx = x - __low2float(a), ry = y - __high2float(a);
  const __nv_bfloat162 b = __floats2bfloat162_rn(rx, ry);
  const __nv_bfloat162 c =
      __floats2bfloat162_rn(rx - __low2float(b), ry - __high2float(b));
  t1 = *reinterpret_cast<const uint32_t*>(&a);
  t2 = *reinterpret_cast<const uint32_t*>(&b);
  t3 = *reinterpret_cast<const uint32_t*>(&c);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// acc = A B^T over one pair of 64-row tiles, both K-major (A and B each a
// [64 rows][W] tile): k16 step j reads box j / KSTEPS, 32 bytes further
// along the row per step inside it.  All W / 16 steps run: the columns
// past the true D are zeros in both tiles and add exact zeros.
template <int W>
__device__ __forceinline__ void issue_qk(float (&acc)[32], uint32_t sa,
                                         uint32_t sb) {
  using G = Geo<W>;
  constexpr uint32_t kSbo = 8 * G::ROW;  // bytes between 8-row groups
#pragma unroll
  for (int j = 0; j < W / 16; ++j) {
    const uint32_t at = (j / G::KSTEPS) * G::BOX + (j % G::KSTEPS) * 32;
    wgmma_ss_n64(acc, gmma_desc(sa + at, 16, kSbo, G::LAYOUT),
                 gmma_desc(sb + at, 16, kSbo, G::LAYOUT), j > 0);
  }
}

// acc = X B, X a [64][64] fp32 accumulator fragment (the A operand, its
// columns the contraction) split into three bf16 terms, B a [64 rows][W]
// tile read MN-major: summed from zero, or with `carry` added to what acc
// holds.  k16 step j takes X's registers 8 j .. 8 j + 7, packed to bf16
// pairs in the order of the A operand's registers, and B's rows
// 16 j .. 16 j + 15.  The three terms hold every fp32 value exactly, so
// with bf16 B every product is exact.
template <int W>
__device__ __forceinline__ void issue_pv(
    float (&acc)[Geo<W>::NB][Geo<W>::ON], const float (&x)[32],
    uint32_t sb, int carry) {
  using G = Geo<W>;
  constexpr uint32_t kSbo = 8 * G::ROW;
  uint32_t xa[4][3][4];  // [k16 step][term][A register]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 8 * j + 4 * (a >> 1) + 2 * (a & 1);
      split3(x[r], x[r + 1], xa[j][0][a], xa[j][1][a], xa[j][2][a]);
    }
#pragma unroll
  for (int c = 0; c < G::NB; ++c) fence_regs(acc[c]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int c = 0; c < G::NB; ++c) {
        const uint64_t db =
            gmma_desc(sb + c * G::BOX + j * 16 * G::ROW, kSbo, kSbo,
                      G::LAYOUT);
        // Without `carry` the first step starts at 0.
        const int add = carry || j > 0 || term > 0;
        if constexpr (G::ON == 32)
          wgmma_rs_n64(acc[c], xa[j][term], db, add);
        else
          wgmma_rs_n32(acc[c], xa[j][term], db, add);
      }
}

// Keeps the compiler from reading an accumulator that asynchronous
// products wrote before the wait that finished them.
template <int NB, int ON>
__device__ __forceinline__ void settle(float (&acc)[NB][ON]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
}

// One arrival per consumer warp on an `empty` barrier, once the warp is
// done with the stage (lane 0 arrives; predicated, not branched).
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// Tensor map over a contiguous bf16 [B, L, H, D] tensor, viewed as 4-D
// (D, H, L, B) with a box of (cb, 1, 64, 1) (cb = Geo<W>::CB of the
// kernel's bucket) and the swizzle that matches a box row of cb * 2 bytes.
// Rows past L, and box columns past D, read as zeros.  D must be a
// multiple of 8 (the row stride a multiple of 16 bytes).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int L, int H,
                     int D, int cb) {
  if (D % 8 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cb, 1, (cuuint32_t)kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cb == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// TMA needs 16-byte aligned tensors.
inline bool aligned16(const void* a, const void* b, const void* c,
                      const void* d = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

}  // namespace
