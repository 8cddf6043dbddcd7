// Flash attention (forward) for Hopper.
//
// Replaces repro/kernels/flash_attention/kernel.py::_fa_kernel (the Pallas
// TPU kernel launched by flash_attention_bhld): softmax(q k^T * scale) v
// per (batch, head), online over key tiles, with a running row max `m`,
// normalizer `l` and the output accumulator in fp32; keys at or beyond Lk
// are masked, and under `causal` so is every key ki > qi + (Lk - Lq).  A
// masked logit is -1e30, exactly as in the reference.  The output is
// written in q's dtype.  q, k, v, o are contiguous [B, L, H, D], the
// model's layout; the wrapper guarantees Lk >= Lq under `causal`, so every
// real query row sees key 0 in the first key tile and its max is finite
// before any masked tile.
//
// With a non-null `lse` ([B, H, Lq] fp32) both kernels also write each
// row's log-sum-exp of its scaled, masked logits, m + log l in natural-log
// units, which the backward kernels (flash_attention_bwd.cu) recompute P
// from.  Serving passes null and writes nothing more.
//
// Bound: operations.  The function does 4*D flops per unmasked (q, k)
// pair (D multiply-adds for q.k, D for p.v) and moves only q, k, v and o
// once, so at the serving shapes (L = 2048 or 32768, D = 64) it sits far
// above the card's ridge point.  At D = 64 the exponentials come close to
// the products: one ex2 per pair at 16 per clock per SM.
//
// Two kernels, chosen by dtype:
//
// * bf16 (the model's serving dtype): fa_kernel_tc, on the tensor cores.
//   One block of 384 threads per (128 query rows, head, batch): two
//   consumer warpgroups of 64 rows each and a producer warpgroup, of
//   which one thread issues the copies (setmaxnreg moves registers from
//   the producer to the consumers).  The producer loads the q tile once
//   and the k and v tiles of 64 keys through a ring of kStages stages in
//   shared memory with TMA (cp.async.bulk.tensor, 4-D tensor maps over
//   (D, H, L, B), 128-byte swizzle; 64-byte at D = 32, where a row is 64
//   bytes), each stage guarded by a `full` and an `empty` mbarrier, so
//   the next tiles load while the current one is multiplied.  TMA fills
//   rows past L with zeros; the -1e30 masks do the rest.  A head dim above
//   64 that is not a multiple of 64 (D = 80, hubert-xlarge's) is loaded
//   in whole 64-column boxes too: the last box reaches past D and TMA
//   fills its columns D .. 127 with zeros, so the tiles are laid out as
//   at D = 128.  q k^T then takes only D / 16 k16 steps (the zero columns
//   are not multiplied), p v runs at N = 128, and the zero output columns
//   are not written.  That keeps the 128-byte swizzle and the descriptors
//   of D = 64 and 128; p v does 128/80 of the work it needs.  A consumer
//   warpgroup computes S = q k^T with wgmma m64n64k16 (q and k both
//   K-major from shared memory), takes the row max and sum on S's fp32
//   accumulator in registers (a row lies in 4 lanes: two shuffles), and
//   computes each tile's P V with wgmma m64nDk16 (m64n64 per 64 columns
//   at D = 128), P from registers (S's accumulator fragment maps onto the
//   A fragments of the k16 steps once packed to bf16 pairs) and V from
//   shared memory (MN-major, the transpose bit set).  Tile t's q k^T is
//   issued before tile t - 1's P V: the split of P runs while the tensor
//   cores do q k^T, the softmax of tile t while they do P V.
//
//   P is split into three bf16 terms, p1 = bf16(p), p2 = bf16(p - p1),
//   p3 = bf16(p - p1 - p2), and T = p1 V + p2 V + p3 V.  The three terms
//   hold every fp32 p exactly (24 significant bits, 8 per term), and q, k
//   and v are bf16, so every product is exact: the kernel computes what
//   the fp32 kernel below computes, up to the order of the sums.  That
//   keeps each bf16 output within one bf16 step of the fp32 plain
//   version, |d| <= 2^-7 |ref| + 1e-6.  P rounded once to bf16 (the usual
//   tensor-core flash attention) misses that bar by a factor of 200-350
//   on near-zero outputs (a CPU emulation of this arithmetic is in
//   tests/test_torch_flash_attention.py).  The price is the MMA work:
//   8*D flops per pair (2*D for q.k, 3 * 2*D for p.v), against the
//   function's 4*D.
//
//   Each tile's T is summed from zero on the tensor cores and the running
//   output is kept on the CUDA cores, O = O * alpha + T in fp32.  With O
//   carried in the wgmma accumulator across all key tiles instead, rows
//   of 32,768 keys missed the bar on the H100 at every head width: the
//   accumulator's sums over thousands of k16 steps drift further from
//   the exact sum than fp32 rounding does.
//
//   Softmax in log2 units: with c = scale * log2(e), p = 2^(S c - m c)
//   from one fma on the raw logit S, m c rounded once per row and tile,
//   and O's rescale factor alpha = 2^(mL_old - mL_new) from the same
//   rounded values.  Key tiles wholly above the causal diagonal of the
//   block are not loaded; a warpgroup whose 64 rows all lie above a
//   loaded tile skips its products; masks are applied only on tiles that
//   cross the diagonal or Lk.  Query tiles go heaviest first (blockIdx.x
//   counts down the sequence), so the long causal rows do not trail at
//   the end.
//
// * fp32 (the reference sweep's and the tests' dtype, held to 2e-5, which
//   needs fp32 products): fa_kernel_f32, the first port's kernel on the
//   CUDA cores.  One block of 256 threads per (64 query rows, head,
//   batch); q, k and v tiles staged in shared memory in fp32, rows padded
//   by one word; the thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i
//   and logits of columns tx + 16 j, so a row's max and sum are half-warp
//   shuffles; p goes through shared memory for the p v product.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int H, int Lq, int Lk,
                  float scale, int causal) {
  constexpr int RC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);   // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);   // [kBK][D]
  float* ps = vs + kBK * D;         // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int half_base = tid & 16;  // lane 0 or 16 of this half-warp
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;

  const int64_t row = (int64_t)H * D;  // elements between sequence rows
  const float* qb = q + ((int64_t)b * Lq * H + h) * D;
  const float* kb = k + ((int64_t)b * Lk * H + h) * D;
  const float* vb = v + ((int64_t)b * Lk * H + h) * D;
  float* ob = o + ((int64_t)b * Lq * H + h) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int qi = q0 + r;
    qs[r * (D + 1) + c] = qi < Lq ? qb[qi * row + c] : 0.f;
  }

  float acc[4][RC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[i][c] = 0.f;
  }

  int nk = (Lk + kBK - 1) / kBK;
  if (causal) {
    const int last_key = min(q0 + kBQ, Lq) - 1 + off;
    nk = min(nk, last_key / kBK + 1);
  }

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int ki = k0 + r;
      const bool in = ki < Lk;
      ks[r * (D + 1) + c] = in ? kb[ki * row + c] : 0.f;
      vs[r * D + c] = in ? vb[ki * row + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        const bool ok = ki < Lk && (!causal || qi + off >= ki);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[r * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      // Every lane of the half-warp takes lane 0's sum, so the row's l
      // is the same in all of them.
      rs = __shfl_sync(0xffffffffu, rs, half_base);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[RC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < RC; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < RC; ++c)
      ob[qi * row + tx + 16 * c] = acc[i][c] / denom;
    // m is in scaled-logit units here; every lane of the half-warp holds
    // the row's m and l.
    if (lse != nullptr && tx == 0)
      lse[((int64_t)b * H + h) * Lq + qi] = m[i] + logf(denom);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Lq, int Lk, float scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  fa_kernel_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Lq, Lk,
      scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA ring
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;      // query rows per block: two warpgroups
constexpr int kTcKeys = 64;       // keys per tile
constexpr int kStages = 4;        // k/v stages in shared memory
constexpr int kTcThreads = 384;   // two consumer warpgroups + a producer one
constexpr int kProducerWarp = 8;
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry at head dim D.  Every 64-row tile (a k or v
// stage, each half of the q tile) is stored as NB boxes of [64 rows][CB]
// bf16, each box written by one TMA copy in the swizzled layout that the
// wgmma descriptors name.
template <int D>
struct Geo {
  static constexpr int CB = D < 64 ? D : 64;    // columns per box
  static constexpr int NB = (D + CB - 1) / CB;  // boxes per row
  static constexpr int ROW = CB * 2;            // bytes of a box row
  static constexpr int BOX = kTcKeys * ROW;     // bytes of a box
  static constexpr int TILE = NB * BOX;         // bytes of a 64-row tile
  static constexpr int KSTEPS = CB / 16;        // k16 steps per box
  static constexpr int LAYOUT = ROW == 128 ? 1 : 2;  // 128B / 64B swizzle
  static constexpr int ON = D < 64 ? D / 2 : 32;     // O registers per box
  // q (two tiles), k and v rings, then 1 + 2 * kStages mbarriers; 1024
  // bytes of slack to align the base to the swizzle atom.
  static constexpr int SMEM =
      1024 + (2 + 2 * kStages) * TILE + 8 * (1 + 2 * kStages);
};

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

// One online-softmax step on a key tile's raw logits S (its accumulator
// fragment, rows qrow[0] and qrow[1]), with c = scale * log2(e): mask
// with -1e30 where the tile crosses the warpgroup's causal diagonal or
// Lk, move the running max m, mL = m c and this thread's share of the row
// sums l on, and write p = 2^(S c - mL) and O's rescale factor
// alpha = 2^(mL_old - mL_new).
__device__ __forceinline__ void softmax_tile(
    float (&x)[32], float (&p)[32], float (&m)[2], float (&mL)[2],
    float (&l)[2], float (&alpha)[2], float c, int k0, int c0,
    const int (&qrow)[2], int first, int Lk, int off, int causal) {
  const bool edge = k0 + kTcKeys > Lk ||
                    (causal && k0 + kTcKeys - 1 > first + off);
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if (edge) {
      const int ki = k0 + 8 * (r / 4) + c0 + (r & 1);
      const int qi = qrow[(r >> 1) & 1];
      if (!(ki < Lk && (!causal || qi + off >= ki))) x[r] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int r = 0; r < 32; ++r)
    mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], x[r]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m[hh], mx[hh]);
    const float mL_new = m_new * c;
    alpha[hh] = ex2(mL[hh] - mL_new);
    m[hh] = m_new;
    mL[hh] = mL_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int hh = (r >> 1) & 1;
    p[r] = ex2(fmaf(x[r], c, -mL[hh]));
    rs[hh] += p[r];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
}

// O = O alpha + T in fp32, alpha per row half of the fragment; T is a
// finished tile's p v.
template <int NB, int ON>
__device__ __forceinline__ void accumulate(float (&oacc)[NB][ON],
                                           float (&tacc)[NB][ON],
                                           const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    fence_regs(tacc[c]);
#pragma unroll
    for (int r = 0; r < ON; ++r)
      oacc[c][r] = fmaf(oacc[c][r], alpha[(r >> 1) & 1], tacc[c][r]);
  }
}

// S = q k^T over one key tile: k16 step j reads box j / KSTEPS, 32 bytes
// further along the row per step inside it (both operands K-major).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[32], uint32_t sq,
                                         uint32_t sk) {
  using G = Geo<D>;
  constexpr uint32_t kSbo = 8 * G::ROW;  // bytes between 8-row groups
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const uint32_t at = (j / G::KSTEPS) * G::BOX + (j % G::KSTEPS) * 32;
    wgmma_ss_n64(sacc, gmma_desc(sq + at, 16, kSbo, G::LAYOUT),
                 gmma_desc(sk + at, 16, kSbo, G::LAYOUT), j > 0);
  }
}

// O += p v over one key tile, p split into three bf16 terms.  p is S's
// accumulator fragment; k16 step j takes its registers 8 j .. 8 j + 7,
// packed to bf16 pairs in the order of the A operand's registers.  v is
// MN-major: step j starts 16 key rows further on.
template <int D>
__device__ __forceinline__ void issue_pv(float (&tacc)[Geo<D>::NB][Geo<D>::ON],
                                         const float (&p)[32], uint32_t sv) {
  using G = Geo<D>;
  constexpr uint32_t kSbo = 8 * G::ROW;
  uint32_t pa[4][3][4];  // [k16 step][term][A register]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 8 * j + 4 * (a >> 1) + 2 * (a & 1);
      split3(p[r], p[r + 1], pa[j][0][a], pa[j][1][a], pa[j][2][a]);
    }
#pragma unroll
  for (int c = 0; c < G::NB; ++c) fence_regs(tacc[c]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int c = 0; c < G::NB; ++c) {
        const uint64_t dv =
            gmma_desc(sv + c * G::BOX + j * 16 * G::ROW, kSbo, kSbo,
                      G::LAYOUT);
        const int acc = j > 0 || term > 0;  // the first step starts at 0
        if constexpr (G::ON == 32)
          wgmma_rs_n64(tacc[c], pa[j][term], dv, acc);
        else
          wgmma_rs_n32(tacc[c], pa[j][term], dv, acc);
      }
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

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    fa_kernel_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Lq, int Lk, float scale, int causal) {
  using G = Geo<D>;
  constexpr int WG_ROWS = 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + 2 * G::TILE;          // k ring
  const uint32_t sv = sk + kStages * G::TILE;    // v ring
  const uint32_t qbar = sv + kStages * G::TILE;  // q loaded
  const uint32_t full0 = qbar + 8;               // stage s: + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;

  const float scale2 = scale * kLog2e;  // raw logits to log2 units
  const int n_qt = (Lq + kTcRows - 1) / kTcRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kTcRows;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;
  int nk = (Lk + kTcKeys - 1) / kTcKeys;
  if (causal)
    nk = min(nk, (min(q0 + kTcRows, Lq) - 1 + off) / kTcKeys + 1);

  // The warp index through a shuffle, so that the compiler sees it (and
  // every branch and loop bound taken from it) as uniform over the warp;
  // otherwise it serialises the asynchronous products.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(qbar, 2 * G::TILE);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < G::NB; ++c)
          tma_load(sq + half * G::TILE + c * G::BOX, &tq, qbar, c * G::CB, h,
                   q0 + half * WG_ROWS, b);
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * G::TILE);
        for (int c = 0; c < G::NB; ++c) {
          tma_load(sk + s * G::TILE + c * G::BOX, &tk, full, c * G::CB, h,
                   t * kTcKeys, b);
          tma_load(sv + s * G::TILE + c * G::BOX, &tv, full, c * G::CB, h,
                   t * kTcKeys, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // Consumer warpgroup wg owns query rows first .. first + 63.  In S's
  // and O's accumulator fragments this thread holds rows r0 and r0 + 8,
  // columns 8 i + c0 and 8 i + c0 + 1: register 4 i + 2 hh + e is
  // (row r0 + 8 hh, column 8 i + c0 + e).
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int first = q0 + WG_ROWS * wg;
  const int last = min(first + WG_ROWS - 1, Lq - 1);
  const int qrow[2] = {first + r0, first + r0 + 8};
  const uint32_t sqw = sq + wg * G::TILE;

  // O runs in fp32 on the CUDA cores: each tile's p v is summed from
  // zero on the tensor cores (tacc) and added as O = O alpha + T, since
  // the tensor cores' fp32 accumulation, carried over the thousands of
  // k16 steps of a long row, drifts past one bf16 step of the output.
  float oacc[G::NB][G::ON];
  float tacc[G::NB][G::ON];
#pragma unroll
  for (int c = 0; c < G::NB; ++c) zero(oacc[c]);
  float m[2] = {kNegInf, kNegInf};
  float mL[2] = {kNegInf * scale2, kNegInf * scale2};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float p[32];              // the previous tile's p, waiting for its p v
  float alpha[2];           // O's rescale factor before that tile's p v

  // The warpgroup multiplies key tiles 0 .. nw - 1 (up to its last row's
  // diagonal); the block's later tiles only pass through it.  Tile t's
  // q k^T is issued before tile t - 1's p v, so the softmax of t runs
  // while the tensor cores work on p v, and the split of p while they
  // work on q k^T.
  int nw = 0;
  if (first <= last)
    nw = causal ? min(nk, (last + off) / kTcKeys + 1) : nk;
  mbar_wait(qbar, 0);
  if (nw > 0) {
    // Tile 0: q k^T, then its softmax; its p v is issued with tile 1's
    // q k^T.  (No branch on t inside the loop: the compiler would
    // serialise the products.)
    mbar_wait(full0, 0);
    float sacc[32];
    zero(sacc);
    wgmma_fence();
    issue_qk<D>(sacc, sqw, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    softmax_tile(sacc, p, m, mL, l, alpha, scale2, 0, c0, qrow, first, Lk,
                 off, causal);
  }
  for (int t = 1; t < nw; ++t) {
    const int s = t % kStages;
    const int prev = (t - 1) % kStages;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    float sacc[32];
    zero(sacc);
    wgmma_fence();
    issue_qk<D>(sacc, sqw, sk + s * G::TILE);
    wgmma_commit();
    issue_pv<D>(tacc, p, sv + prev * G::TILE);
    wgmma_commit();
    wgmma_wait<1>();  // q k^T of tile t is done, p v of t - 1 runs on
    fence_regs(sacc);
    float alpha_t[2];
    softmax_tile(sacc, p, m, mL, l, alpha_t, scale2, t * kTcKeys, c0, qrow,
                 first, Lk, off, causal);
    wgmma_wait<0>();
    release(empty0 + 8 * prev, lane);
    accumulate<G::NB, G::ON>(oacc, tacc, alpha);
    alpha[0] = alpha_t[0];
    alpha[1] = alpha_t[1];
  }
  if (nw > 0) {
    issue_pv<D>(tacc, p, sv + ((nw - 1) % kStages) * G::TILE);
    wgmma_commit();
    wgmma_wait<0>();
    release(empty0 + 8 * ((nw - 1) % kStages), lane);
    accumulate<G::NB, G::ON>(oacc, tacc, alpha);
  }
  for (int t = nw; t < nk; ++t) {
    mbar_wait(full0 + 8 * (t % kStages), (t / kStages) & 1);
    release(empty0 + 8 * (t % kStages), lane);
  }

  const int64_t row = (int64_t)H * D;  // elements between sequence rows
  __nv_bfloat16* ob = o + ((int64_t)b * Lq * H + h) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = qrow[hh];
    if (qi >= Lq) continue;
    const float denom = fmaxf(lr, 1e-30f);
    // p = 2^(S c - mL) / l, so the row's log-sum-exp of the scaled logits
    // is ln 2 · (mL + log2 l); the row's four lanes hold the same mL.
    if (lse != nullptr && lane % 4 == 0)
      lse[((int64_t)b * H + h) * Lq + qi] = kLn2 * (mL[hh] + log2f(denom));
#pragma unroll
    for (int c = 0; c < G::NB; ++c)
#pragma unroll
      for (int i = 0; i < G::ON / 4; ++i) {
        if (c * G::CB + 8 * i >= D) break;  // a box's zero columns past D
        const int col = c * G::CB + 8 * i + c0;
        *reinterpret_cast<__nv_bfloat162*>(ob + qi * row + col) =
            __floats2bfloat162_rn(oacc[c][4 * i + 2 * hh] / denom,
                                  oacc[c][4 * i + 2 * hh + 1] / denom);
      }
  }
}

// Tensor map over a contiguous bf16 [B, L, H, D] tensor, viewed as 4-D
// (D, H, L, B) with a box of (CB, 1, 64, 1) and the swizzle that matches
// a box row of CB * 2 bytes.  Rows past L, and columns past D in the last
// box (D = 80), read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int L, int H,
                     int D) {
  const int cb = D < 64 ? D : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cb, 1, (cuuint32_t)kTcKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cb == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int Lq, int Lk, float scale,
                      int causal, cudaStream_t stream) {
  // TMA needs 16-byte aligned tensors.
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, B, Lq, H, D);
  if (err == cudaSuccess) err = make_map(&mk, k, B, Lk, H, D);
  if (err == cudaSuccess) err = make_map(&mv, v, B, Lk, H, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = Geo<D>::SMEM;
  err = cudaFuncSetAttribute(
      fa_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kTcRows - 1) / kTcRows, H, B);
  fa_kernel_tc<D><<<grid, kTcThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, Lq, Lk, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// kernel); q, k, v and o share it.  q and o are contiguous [B, Lq, H, D],
// k and v contiguous [B, Lk, H, D]; lse is null or fp32 [B, H, Lq].
extern "C" int fa_launch(const void* q, const void* k, const void* v,
                         void* o, void* lse, int dtype, int B, int H, int Lq,
                         int Lk, int D, float scale, int causal,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
#define FA_ARGS q, k, v, o, ls, B, H, Lq, Lk, scale, causal, s
  if (dtype == 0) {
    switch (D) {
      case 32: return (int)launch_f32<32>(FA_ARGS);
      case 64: return (int)launch_f32<64>(FA_ARGS);
      case 80: return (int)launch_f32<80>(FA_ARGS);
      case 128: return (int)launch_f32<128>(FA_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return (int)launch_tc<32>(FA_ARGS);
      case 64: return (int)launch_tc<64>(FA_ARGS);
      case 80: return (int)launch_tc<80>(FA_ARGS);
      case 128: return (int)launch_tc<128>(FA_ARGS);
    }
  }
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}
