// Flash attention (backward) for Hopper.
//
// The gradient of flash_attention.cu's forward.  The reference has no
// backward Pallas kernel: it trains through its jnp attention
// (repro/models/layers.py::_sdpa_ref and _sdpa_chunked) and XLA takes the
// gradient.  These kernels compute that gradient from what the forward
// kept: q, k, v, the output o, and each row's log-sum-exp lse = m + log l
// of its scaled, masked logits (fp32 [B, H, Lq]), so that P = exp(S - lse)
// is recomputed tile by tile and never stored.  q, k, v, o, dO, dq, dk and
// dv are contiguous [B, L, H, D] in one dtype (fp32 or bf16); every sum
// is fp32; dq, dk and dv are rounded once to the dtype.  A pair is masked
// where the forward masks it (a key at or past Lk, or, under `causal`, a
// key ki > qi + (Lk - Lq)): its P and dS are 0.
//
// Head dims as in the forward: each kernel is built for the column
// buckets W = 32, 64, 128, 192, 256 (fa_bucket) and takes the true D <= W
// at run time; the columns D .. W - 1 of every tile are zeros and only
// the first D output columns are written.  bf16 needs D a multiple of 8
// (the wrapper zero-pads q, k, v and dO to that).
//
// FA2's split, three kernels, none with atomics, so every result is the
// same from run to run:
//
// * fa_bwd_preprocess: D = rowsum(dO o O) per (b, h, query row), either
//   dtype, any head dim.  Bound: bytes (reads o and dO once, writes D).
//   A few lanes a row and several rows in flight a lane, 16-byte loads
//   where the rows are aligned, D written as runs along Lq (the design
//   is set out above the kernel).
// * dK, dV: per block of keys, over the query tiles that can see them
//   (under `causal`, from the keys' own diagonal on): S^T = k q^T,
//   P^T = exp(scale S^T - lse), dP^T = v dO^T, dS^T = P^T o (dP^T - D),
//   dV += P^T dO, dK += dS^T q; dK scaled once at the end.
// * dQ: per block of query rows, over the key tiles they can see: S, P,
//   dP and dS as above, dQ += dS k, scaled once at the end.
//
// Bound: operations.  The function needs 10 D flops per unmasked pair (S,
// dP, dV, dK and dQ, 2 D each); the split recomputes S and dP in the dQ
// kernel.
//
// The dtype picks the dK/dV and dQ kernels, as it picks the forward's:
//
// * fp32 (held to 1e-4·max(max|ref|, 1), which needs fp32 products):
//   fa_bwd_dkdv_tf32 and fa_bwd_dq_tf32 on the tensor cores, mma.sync
//   m16n8k8 with TF32 operands.  Each fp32 operand x is split into
//   hi = x rounded to 10 mantissa bits, to nearest with ties away from
//   zero (cvt.rna.tf32.f32's rounding), and lo = x - hi, exact in fp32,
//   which the tensor cores read cut to 10 mantissa bits (split_tf32); every
//   product is the three TF32 products hi·hi + hi·lo + lo·hi summed in
//   fp32 (mma3).  The lo·lo term and lo's cut leave about 2^-21 of each
//   product, far inside the bar (tests/test_torch_flash_attention.py
//   emulates one, two and three terms).  These building blocks, the
//   fragments and the ring below are in fa_tf32.cuh, shared with the
//   forward's fa_kernel_tf32.  wgmma takes tf32 operands from
//   shared memory only K-major, and dV, dK and dQ contract over the rows
//   of a [L, D] tile, so the kernels use mma.sync, whose fragments are
//   read from shared memory in any layout.
//
//   Blocks: R = f32_rows<W> rows (64 up to W = 128, 32 above) a block
//   owns (keys in dK/dV, queries in dQ), the other side streamed in tiles
//   of R rows through a 2-stage cp.async ring (tf32_load_tile; 16-byte
//   copies where D % 4 = 0, else 4-byte ones; rows past L and columns
//   past D zero-filled), so a tile's copies overlap the products of the
//   tile before it.  2 R / 16 warps a block (8 or 4), one block an SM: in
//   dK/dV warp j (< R / 16) computes S^T = k q^T for keys 16 j .. 16 j +
//   15, P^T, and dV += P^T dO, and warp j + R / 16 computes dP^T = v dO^T
//   for the same keys, takes P^T from warp j through shared memory (a
//   named barrier a pair), dS^T and dK += dS^T q: each output W / 2 fp32
//   registers a thread, no product computed twice.  In dQ warp j + h R /
//   16 (h = 0, 1) takes query rows 16 j .. 16 j + 15 against half h of
//   each key tile's rows; the halves' dQ sums are added through shared
//   memory at the end (half 0's plus half 1's: a fixed order, no atomics).
//
//   Fragments: S^T, dP^T, S and dP read both operands K-major with
//   ldmatrix (an 8 x 8 b16 matrix is an 8 x 4 fp32 one, which is the
//   m16n8k8 tf32 A and B layout); dV, dK and dQ take P^T, dS^T or dS as
//   the A operand from the accumulator fragments, their columns 2c, 2c + 1
//   fed as the k indices c, c + 4, and read the B rows in that order with
//   32-bit loads (mma_tn).  An operand is split as it reaches the
//   registers: an A fragment once for the warp's n-tiles, a B fragment
//   once for its three products (a split kept in shared memory would
//   double the bytes read and the tiles' room).  Tiles are stored
//   [rows][W] with 16-byte chunk c of row r at c ^ (r % 8), so that
//   ldmatrix's eight rows and the B loads' rows 2c and 2c + 1 meet no bank
//   twice.  dV, dK and dQ are summed per tile from zero on the tensor
//   cores, 8 output n-tiles at a time (4 at W = 256), and added to the
//   running sums in fp32: the tensor cores' own accumulation cuts rather
//   than rounds, and carried across 4,096 keys it drifted to half the bar
//   in dK.  Shared memory, 4 bytes a word: dK/dV k, v (R W each), two
//   stages of q, dO (R W each) and their lse and D (R each), P^T (R R):
//   214,016 bytes at W = 128, 201,216 at 256; dQ q, dO and two stages of
//   k, v: 196,608 at W = 128 and 256 (dkdv_tf32_smem, dq_tf32_smem;
//   kernel.py mirrors them).  P = exp(S scale - lse) with the accurate
//   expf; masks on tiles that cross the diagonal, Lq or Lk.  MMA work:
//   24 W flops a pair in dK/dV, 18 W in dQ (the products' 8 W and 6 W,
//   three times); mma.sync's TF32 rate, not the splitting, bounds them
//   (PERF.md, PR 26).
//
// * bf16 (the models' training dtype): fa_bwd_dkdv_tc and fa_bwd_dq_tc on
//   the tensor cores, built from the forward's blocks (fa_hopper.cuh):
//   blocks of two consumer warpgroups (one for dQ at W = 256, below) and
//   a producer warpgroup of which one warp issues the copies (setmaxnreg:
//   232 registers a consumer thread, 40 a producer thread); tiles of 64
//   rows brought by TMA (4-D tensor maps over (D, H, L, B), 64-column
//   boxes with the 128-byte swizzle, one 32-column box with the 64-byte
//   swizzle at W = 32; columns past D zero-filled) through a ring of
//   stages, each guarded by a `full` and an `empty` mbarrier.  Every
//   product is a wgmma m64n64k16 (m64n32 for the W = 32 outputs): S^T,
//   dP^T, S and dP from two K-major tiles in shared memory, as the
//   forward's q k^T; dV, dK and dQ with the fp32 accumulator fragment of
//   P^T, dS^T or dS as the A operand from registers and the dO, q or k
//   tile read MN-major (the transpose bit set), as the forward's p v.
//
//   P and dS are split into three bf16 terms (split3), which hold every
//   fp32 value exactly, and q, k, v and dO are bf16, so every product is
//   exact: the kernels compute what the fp32 kernels compute, up to the
//   order of the sums.  One bf16 rounding of P and dS (the usual
//   tensor-core backward) misses the element bar, as it does in the
//   forward (tests/test_torch_flash_attention.py emulates both).  The
//   price is the MMA work: 18 W flops per pair in dK/dV (S^T twice, dP^T,
//   dV and dK three times) and 10 W in dQ, against the function's 10 D.
//
//   Sums: up to W = 128 each tile's dV, dK or dQ is summed from zero on
//   the tensor cores (12 k16 steps) and added to a running sum in fp32
//   registers, as the forward adds each tile's p v.  The forward found
//   that an accumulator carried across thousands of k16 steps drifts past
//   one bf16 step; the backward's bar leaves more room (1e-5·max|ref|).
//   At W = 192 and 256 a tile sum beside the running sum does not fit a
//   consumer's 232 registers (W / 2 each), so there the three terms'
//   products accumulate into the running sum itself.  A running sum and a
//   tile sum of both dK and dV do not fit one warpgroup's registers at
//   any W >= 128, so in fa_bwd_dkdv_tc the two consumer warpgroups split
//   the outputs, not the keys: one block per 64 keys, warpgroup 0
//   computes S^T and dV, warpgroup 1 computes S^T and dP^T and dK (the A
//   terms in place of S^T and dP^T once dS is split).  S^T is computed
//   twice, 2 W flops per pair more than one warpgroup doing both would
//   need.  The producer loads the keys' k and v tiles once and rings the
//   query tiles' q and dO, and, written by its warp's 32 lanes into the
//   stage (the full barrier counts their 32 arrivals beside the copies'),
//   the tiles' lse (times log2 e) and D, which are per column of S^T here.
//   fa_bwd_dq_tc has the forward's shape: one block per 128 query rows,
//   64 per consumer warpgroup, q and dO loaded once, k and v rung.  At
//   W = 256 two q and two dO tiles and even a 2-stage ring of k and v
//   take 263,208 bytes, over the 232,448 a block may use, so there a
//   block takes 64 query rows with one consumer warpgroup (197,672
//   bytes); the output columns are not split between warpgroups, which
//   would compute S and dP twice.
//
//   Ring depths (stages of the rung tiles): dK/dV 4 up to W = 128, 3 at
//   192, 2 at 256; dQ 4 up to 128, 2 above.  Shared memory: dK/dV
//   166,984 bytes at W = 128, 199,224 at 192, 198,696 at 256; dQ 197,704,
//   197,672, 197,672 (dkdv_tc_smem, dq_tc_smem; kernel.py mirrors them).
//
//   P = 2^(S scale log2(e) - lse log2(e)) from one fma on the raw logit
//   and ex2.approx.ftz.  Query tiles (dK/dV: key tiles) wholly masked by
//   `causal` are not loaded; masks are applied only on tiles that cross
//   the diagonal, Lq or Lk (a query at or past Lq has P = 0 in dK/dV; a
//   key at or past Lk in dQ).  Blocks go heaviest first: dK/dV's key
//   tile 0 sees every query, dQ's last query tile every key.

#include "fa_hopper.cuh"
#include "fa_tf32.cuh"


namespace {

// ---------------------------------------------------------------------------
// The preprocess (either dtype)
// ---------------------------------------------------------------------------

// A block takes `ti` query rows of one batch row (kPreRowsI, or fewer
// where that would leave under two blocks an SM of the current device)
// and up to kPreHeads heads.  Its rows of o and dO, (i, h) pairs, are
// walked in memory order: TPR lanes (a power of two, the fewest that
// cover a row's pieces, at most 32) share a row, each summing its
// pieces, 16 bytes where the rows and both bases are 16-byte aligned
// (kVec) and one element otherwise, with kPreUnroll rows of each lane
// loaded before any is summed.  The rows' sums meet in shared memory,
// and the block writes delta as runs of kPreRowsI along Lq, one per
// head.
constexpr int kPreThreads = 256;
constexpr int kPreRowsI = 16;    // query rows a block, at most
constexpr int kPreHeads = 32;    // heads a block, at most
constexpr int kPreUnroll = 4;    // rows a lane has in flight

// acc += dO . o over one piece: 16 bytes, or one element.
__device__ __forceinline__ float dot_piece(const float* o, const float* d,
                                           float acc) {
  const float4 a = *reinterpret_cast<const float4*>(o);
  const float4 b = *reinterpret_cast<const float4*>(d);
  acc = fmaf(b.x, a.x, acc);
  acc = fmaf(b.y, a.y, acc);
  acc = fmaf(b.z, a.z, acc);
  return fmaf(b.w, a.w, acc);
}
__device__ __forceinline__ float dot_piece(const __nv_bfloat16* o,
                                           const __nv_bfloat16* d,
                                           float acc) {
  const uint4 a = *reinterpret_cast<const uint4*>(o);
  const uint4 b = *reinterpret_cast<const uint4*>(d);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc = fmaf(__low2float(y[k]), __low2float(x[k]), acc);
    acc = fmaf(__high2float(y[k]), __high2float(x[k]), acc);
  }
  return acc;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Elements a lane reads at once: 16 bytes (kVec) or one.
template <typename T, bool kVec>
__host__ __device__ constexpr int pre_piece() {
  return kVec ? 16 / (int)sizeof(T) : 1;
}

template <typename T, bool kVec, int TPR>
__global__ void __launch_bounds__(kPreThreads)
    fa_bwd_preprocess(const T* __restrict__ o, const T* __restrict__ dO,
                      float* __restrict__ delta, int H, int Lq, int D,
                      int ti) {
  constexpr int E = pre_piece<T, kVec>();
  constexpr int NS = kPreThreads / TPR;   // rows a pass
  __shared__ float sums[kPreHeads * kPreRowsI];
  const int b = blockIdx.z, i0 = blockIdx.x * ti;
  const int h0 = blockIdx.y * kPreHeads;
  const int nh = min(kPreHeads, H - h0), ni = min(ti, Lq - i0);
  const int nrows = nh * ni, V = D / E;   // a row's pieces
  const int sub = threadIdx.x % TPR, slot = threadIdx.x / TPR;
  // Row (i, h) of [B, Lq, H] in memory order is (b Lq + i) H + h.
  const int64_t base = ((int64_t)b * Lq + i0) * H + h0;
  for (int r0 = 0; r0 < nrows; r0 += NS * kPreUnroll) {
    float acc[kPreUnroll];
    const T* op[kPreUnroll];
    const T* dp[kPreUnroll];
    bool ok[kPreUnroll];
#pragma unroll
    for (int u = 0; u < kPreUnroll; ++u) {
      const int r = r0 + u * NS + slot, ri = r / nh;
      const int64_t row = base + (int64_t)ri * H + (r - ri * nh);
      ok[u] = r < nrows;
      op[u] = o + row * D;
      dp[u] = dO + row * D;
      acc[u] = 0.f;
    }
    for (int c = sub; c < V; c += TPR) {
      if constexpr (kVec) {
        uint4 a[kPreUnroll], d[kPreUnroll];
#pragma unroll
        for (int u = 0; u < kPreUnroll; ++u)
          if (ok[u]) {
            a[u] = *reinterpret_cast<const uint4*>(op[u] + c * E);
            d[u] = *reinterpret_cast<const uint4*>(dp[u] + c * E);
          }
#pragma unroll
        for (int u = 0; u < kPreUnroll; ++u)
          if (ok[u])
            acc[u] = dot_piece(reinterpret_cast<const T*>(&a[u]),
                               reinterpret_cast<const T*>(&d[u]), acc[u]);
      } else {
        float a[kPreUnroll], d[kPreUnroll];
#pragma unroll
        for (int u = 0; u < kPreUnroll; ++u)
          if (ok[u]) {
            a[u] = ld(op[u] + c);
            d[u] = ld(dp[u] + c);
          }
#pragma unroll
        for (int u = 0; u < kPreUnroll; ++u)
          if (ok[u]) acc[u] = fmaf(d[u], a[u], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPreUnroll; ++u) {
#pragma unroll
      for (int w = TPR / 2; w > 0; w >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], w);
      const int r = r0 + u * NS + slot, ri = r / nh;
      if (sub == 0 && ok[u]) sums[(r - ri * nh) * kPreRowsI + ri] = acc[u];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nh * kPreRowsI; e += kPreThreads) {
    const int rh = e / kPreRowsI, ri = e % kPreRowsI;
    if (ri < ni) delta[((int64_t)b * H + h0 + rh) * Lq + i0 + ri] = sums[e];
  }
}

template <typename T, bool kVec>
cudaError_t launch_preprocess_v(const T* o, const T* dO, float* delta, int B,
                                int H, int Lq, int D, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int V = D / pre_piece<T, kVec>();
  const int hblocks = (H + kPreHeads - 1) / kPreHeads;
  int ti = kPreRowsI;
  while (ti > 4 && (int64_t)B * hblocks * ((Lq + ti - 1) / ti) <
                       2 * (int64_t)sms)
    ti /= 2;
  const dim3 grid((Lq + ti - 1) / ti, hblocks, B);
#define FA_PRE(TPR)                                                        \
  fa_bwd_preprocess<T, kVec, TPR><<<grid, kPreThreads, 0, stream>>>(      \
      o, dO, delta, H, Lq, D, ti)
  if (V <= 1) FA_PRE(1);
  else if (V <= 2) FA_PRE(2);
  else if (V <= 4) FA_PRE(4);
  else if (V <= 8) FA_PRE(8);
  else if (V <= 16) FA_PRE(16);
  else FA_PRE(32);
#undef FA_PRE
  return cudaGetLastError();
}

// 16-byte pieces where a row's bytes and both bases allow them, else
// single elements: two variants of the one kernel.
template <typename T>
cudaError_t launch_preprocess(const void* o, const void* dO, void* delta,
                              int B, int H, int Lq, int D,
                              cudaStream_t stream) {
  const T* op = static_cast<const T*>(o);
  const T* dp = static_cast<const T*>(dO);
  float* out = static_cast<float*>(delta);
  const bool vec = D * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dO) % 16 == 0;
  if (vec)
    return launch_preprocess_v<T, true>(op, dp, out, B, H, Lq, D, stream);
  return launch_preprocess_v<T, false>(op, dp, out, B, H, Lq, D, stream);
}


// ---------------------------------------------------------------------------
// fp32: tensor cores (mma.sync TF32, three terms), cp.async ring
// ---------------------------------------------------------------------------

// dK/dV: k, v, the stages' q, dO, lse and D, the P^T exchange.
template <int W>
__host__ __device__ constexpr int dkdv_tf32_smem() {
  constexpr int R = f32_rows<W>();
  return 4 * (2 * R * W + Tf32<W>::S * (2 * R * W + 2 * R) + R * R);
}

// dQ: q, dO, the stages' k and v.
template <int W>
__host__ __device__ constexpr int dq_tf32_smem() {
  constexpr int R = f32_rows<W>();
  return 4 * (2 * R * W + Tf32<W>::S * 2 * R * W);
}

// Entries r0 .. r0 + R - 1 of a row statistic (lse or D) into dst, through
// cp.async; zero past L.
template <int R, int NT>
__device__ __forceinline__ void tf32_load_stat(float* dst, const float* base,
                                               int r0, int L) {
  for (int e = threadIdx.x; e < R; e += NT) {
    const bool ok = r0 + e < L;
    cp_async_zfill4(smem_addr(dst + e), ok ? base + r0 + e : base, ok);
  }
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int W>
__global__ void __launch_bounds__(Tf32<W>::NT, 1)
    fa_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Lq, int Lk, int D,
                     float scale, int causal) {
  using C = Tf32<W>;
  constexpr int R = C::R;                   // keys a block; queries a tile
  constexpr int NQ = R / 8;                 // n-tiles of S^T (queries)
  constexpr int STAGE = 2 * R * W + 2 * R;  // q, dO, lse, D
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                         // [R][W], swizzled
  float* vs = ks + R * W;
  float* ring = vs + R * W;                 // stage s at + s STAGE
  float* xch = ring + C::S * STAGE;         // P^T, [G][NQ][32 lanes][4]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = warp % C::G;                // the warp's 16 keys
  const bool dk_role = warp >= C::G;        // dP^T, dS^T, dK (else dV)
  const int k0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;
  const bool vec = (D & 3) == 0;

  const int64_t row = (int64_t)H * D;
  const float* qb = q + ((int64_t)b * Lq * H + h) * D;
  const float* ob = dO + ((int64_t)b * Lq * H + h) * D;
  const float* kb = k + ((int64_t)b * Lk * H + h) * D;
  const float* vb = v + ((int64_t)b * Lk * H + h) * D;
  const float* lb = lse + ((int64_t)b * H + h) * Lq;
  const float* db = delta + ((int64_t)b * H + h) * Lq;

  // Query rows qi >= k0 - off can see the block's first key; the wrapper
  // guarantees Lk >= Lq under `causal`, so at least one tile can.
  const int t0 = causal ? max(0, k0 - off) / R : 0;
  const int nt = (Lq + R - 1) / R - t0;
  auto load_stage = [&](int t, float* st) {
    const int q0 = (t0 + t) * R;
    tf32_load_tile<W, R, C::NT>(st, qb, row, q0, Lq, D, vec);
    tf32_load_tile<W, R, C::NT>(st + R * W, ob, row, q0, Lq, D, vec);
    tf32_load_stat<R, C::NT>(st + 2 * R * W, lb, q0, Lq);
    tf32_load_stat<R, C::NT>(st + 2 * R * W + R, db, q0, Lq);
  };
  tf32_load_tile<W, R, C::NT>(ks, kb, row, k0, Lk, D, vec);
  tf32_load_tile<W, R, C::NT>(vs, vb, row, k0, Lk, D, vec);
  load_stage(0, ring);
  cp_async_commit();

  float acc[W / 8][4];  // dV or dK (unscaled) of the warp's 16 keys
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
  const int nks = (D + 7) / 8;  // k8 steps reaching a column below D
  const int g = lane >> 2, c = lane & 3;
  const int krow = k0 + 16 * j + g;  // and krow + 8
  const float* const xs[1] = {(dk_role ? vs : ks) + 16 * j * W};
  float4* xw = reinterpret_cast<float4*>(xch) + j * NQ * 32 + lane;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t - 1's stage and P^T consumed
    if (t + 1 < nt) load_stage(t + 1, ring + ((t + 1) % C::S) * STAGE);
    cp_async_commit();
    const float* qs = ring + (t % C::S) * STAGE;
    const float* os = qs + R * W;
    const float* ls = os + R * W;
    const float* dl = ls + R;
    const int q0 = (t0 + t) * R;

    // S^T = k q^T (dV role) or dP^T = v dO^T (dK role): keys 16 j + g
    // (+ 8) by queries 8 i + 2c (+ 1).
    float s[1][NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[0][i][r] = 0.f;
    const float* const ys[1] = {dk_role ? os : qs};
    mma_nt<W, NQ, 1>(s, xs, ys, nks, lane);

    if (!dk_role) {
      // P^T, 0 where masked (a query at or past Lq, or under `causal` a
      // query qi with qi + off < ki), checked on tiles that cross them.
      const bool edge = q0 + R > Lq || (causal && q0 + off < k0 + R - 1);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * i + 2 * c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p = expf(fmaf(s[0][i][r], scale, -((r & 1) ? l.y : l.x)));
          if (edge) {
            const int qi = q0 + 8 * i + 2 * c + (r & 1);
            const int ki = krow + 8 * (r >> 1);
            if (!(qi < Lq && (!causal || qi + off >= ki))) p = 0.f;
          }
          s[0][i][r] = p;
        }
        xw[32 * i] = make_float4(s[0][i][0], s[0][i][1], s[0][i][2],
                                 s[0][i][3]);
      }
      bar_arrive(1 + j, 64);
    } else {
      bar_sync(1 + j, 64);  // warp j's P^T is in xch
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float4 p = xw[32 * i];
        const float2 d = *reinterpret_cast<const float2*>(dl + 8 * i + 2 * c);
        s[0][i][0] = p.x * (s[0][i][0] - d.x);
        s[0][i][1] = p.y * (s[0][i][1] - d.y);
        s[0][i][2] = p.z * (s[0][i][2] - d.x);
        s[0][i][3] = p.w * (s[0][i][3] - d.y);
      }
    }
    // dV += P^T dO, or dK += dS^T q.
    Tf32A a[NQ];
    split_rows(a, s[0]);
    mma_tn<W, NQ>(acc, a, dk_role ? qs : os, D, lane);
  }

  const float mult = dk_role ? scale : 1.f;
  float* out = (dk_role ? dk : dv) + ((int64_t)b * Lk * H + h) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ki = krow + 8 * hh;
    if (ki >= Lk) continue;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * c + e;
        if (col < D) out[ki * row + col] = acc[n][2 * hh + e] * mult;
      }
  }
}

template <int W>
__global__ void __launch_bounds__(Tf32<W>::NT, 1)
    fa_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int H, int Lq, int Lk, int D, float scale, int causal) {
  using C = Tf32<W>;
  constexpr int R = C::R;         // query rows a block; keys a tile
  constexpr int NK = R / 16;      // n-tiles of a warp's half of the keys
  constexpr int STAGE = 2 * R * W;  // k, v
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [R][W], swizzled
  float* os = qs + R * W;         // dO
  float* ring = os + R * W;       // stage s at + s STAGE

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = warp % C::G;      // the warp's 16 query rows
  const int half = warp / C::G;   // its half of each key tile
  const int n_qt = (Lq + R - 1) / R;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * R;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;
  const bool vec = (D & 3) == 0;
  int nk = (Lk + R - 1) / R;
  if (causal) nk = min(nk, (min(q0 + R, Lq) - 1 + off) / R + 1);

  const int64_t row = (int64_t)H * D;
  const float* kb = k + ((int64_t)b * Lk * H + h) * D;
  const float* vb = v + ((int64_t)b * Lk * H + h) * D;
  auto load_stage = [&](int t, float* st) {
    tf32_load_tile<W, R, C::NT>(st, kb, row, t * R, Lk, D, vec);
    tf32_load_tile<W, R, C::NT>(st + R * W, vb, row, t * R, Lk, D, vec);
  };
  tf32_load_tile<W, R, C::NT>(qs, q + ((int64_t)b * Lq * H + h) * D, row,
                              q0, Lq, D, vec);
  tf32_load_tile<W, R, C::NT>(os, dO + ((int64_t)b * Lq * H + h) * D, row,
                              q0, Lq, D, vec);
  load_stage(0, ring);
  cp_async_commit();

  const int g = lane >> 2, c = lane & 3;
  const int64_t bh = (int64_t)b * H + h;
  int qrow[2];
  float l[2], dl[2];  // the rows' lse and D
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qrow[hh] = q0 + 16 * j + g + 8 * hh;
    const bool in = qrow[hh] < Lq;
    l[hh] = in ? lse[bh * Lq + qrow[hh]] : 0.f;
    dl[hh] = in ? delta[bh * Lq + qrow[hh]] : 0.f;
  }
  float acc[W / 8][4];  // dQ (unscaled) of the warp's rows, its keys
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
  const int nks = (D + 7) / 8;
  const float* const xs[2] = {qs + 16 * j * W, os + 16 * j * W};

  for (int t = 0; t < nk; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t - 1's stage consumed
    if (t + 1 < nk) load_stage(t + 1, ring + ((t + 1) % C::S) * STAGE);
    cp_async_commit();
    const float* kst = ring + (t % C::S) * STAGE + half * (R / 2) * W;
    const float* vst = kst + R * W;
    const int k0 = t * R + half * (R / 2);  // the warp's first key

    // S = q k^T and dP = dO v^T: rows 16 j + g (+ 8) by keys
    // k0 + 8 i + 2c (+ 1).
    float s[2][NK][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[p][i][r] = 0.f;
    const float* const ys[2] = {kst, vst};
    mma_nt<W, NK, 2>(s, xs, ys, nks, lane);

    // P = exp(S scale - lse), 0 where masked (a key at or past Lk, or
    // under `causal` a key ki > qi + off); dS = P o (dP - D) into s[1].
    const bool edge =
        t * R + R > Lk || (causal && t * R + R - 1 > q0 + off);
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hh = r >> 1;
        float p = expf(fmaf(s[0][i][r], scale, -l[hh]));
        if (edge) {
          const int ki = k0 + 8 * i + 2 * c + (r & 1);
          if (!(ki < Lk && (!causal || qrow[hh] + off >= ki))) p = 0.f;
        }
        s[1][i][r] = p * (s[1][i][r] - dl[hh]);
      }
    Tf32A a[NK];
    split_rows(a, s[1]);
    mma_tn<W, NK>(acc, a, kst, D, lane);  // dQ += dS k
  }

  // dQ = half 0's sum + half 1's, through shared memory (q's tile, no
  // longer read).
  cp_async_wait_all();
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(qs) + j * (W / 8) * 32 + lane;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      red[32 * n] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  }
  __syncthreads();
  if (half == 1) return;
  float* out = dq + ((int64_t)b * Lq * H + h) * D;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const float4 o = red[32 * n];
    const float sum[4] = {acc[n][0] + o.x, acc[n][1] + o.y, acc[n][2] + o.z,
                          acc[n][3] + o.w};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (qrow[hh] >= Lq) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * c + e;
        if (col < D) out[qrow[hh] * row + col] = sum[2 * hh + e] * scale;
      }
    }
  }
}

template <int W>
cudaError_t launch_dkdv_tf32(const void* q, const void* k, const void* v,
                             const void* dO, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int H, int Lq, int Lk, int D, float scale,
                             int causal, cudaStream_t stream) {
  constexpr int smem = dkdv_tf32_smem<W>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_tf32<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  constexpr int R = f32_rows<W>();
  dim3 grid((Lk + R - 1) / R, H, B);
  fa_bwd_dkdv_tf32<W><<<grid, Tf32<W>::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Lq, Lk, D, scale,
      causal);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v,
                           const void* dO, const void* lse,
                           const void* delta, void* dq, int B, int H, int Lq,
                           int Lk, int D, float scale, int causal,
                           cudaStream_t stream) {
  constexpr int smem = dq_tf32_smem<W>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_tf32<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int R = f32_rows<W>();
  dim3 grid((Lq + R - 1) / R, H, B);
  fa_bwd_dq_tf32<W><<<grid, Tf32<W>::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Lq, Lk, D, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA ring
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 384;   // dK/dV: two consumer warpgroups + a
                                  // producer one

// Ring stages of dQ (k, v tile pairs); dK/dV's (q, dO) ring takes
// ring_stages.  dQ's two q and dO tiles leave room for fewer.
template <int W>
__host__ __device__ constexpr int dq_tc_stages() {
  return W <= 128 ? 4 : 2;
}
// dQ's consumer warpgroups, each of 64 query rows.
template <int W>
__host__ __device__ constexpr int dq_tc_warpgroups() {
  return W <= 192 ? 2 : 1;
}

// dK/dV: the k and v tiles, the stages' (q, dO) tile pairs, a row of
// (lse log2 e, D) for 64 queries in fp32 per stage, then 1 + 2 stages
// mbarriers; 1024 bytes of slack to align the base to the swizzle atom.
template <int W>
__host__ __device__ constexpr int dkdv_tc_smem() {
  constexpr int S = ring_stages<W>();
  return 1024 + (2 + 2 * S) * Geo<W>::TILE + S * 2 * kTile * 4 +
         8 * (1 + 2 * S);
}

// dQ: q and dO (a tile each per warpgroup), the stages' (k, v) tile
// pairs, mbarriers.
template <int W>
__host__ __device__ constexpr int dq_tc_smem() {
  constexpr int S = dq_tc_stages<W>();
  return 1024 + (2 * dq_tc_warpgroups<W>() + 2 * S) * Geo<W>::TILE +
         8 * (1 + 2 * S);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// acc += tile, once the tile's products are done.
template <int NB, int ON>
__device__ __forceinline__ void fold(float (&acc)[NB][ON],
                                     float (&tile)[NB][ON]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    fence_regs(tile[c]);
#pragma unroll
    for (int r = 0; r < ON; ++r) acc[c][r] += tile[c][r];
  }
}

// run += X B (fa_hopper.cuh's issue_pv), committed: up to W = 128 summed
// from zero into `tile` and folded into `run` once done; above, added to
// `run` by the tensor cores.  Waits for the products and frees the stage.
template <int W>
__device__ __forceinline__ void add_product(
    float (&run)[Geo<W>::NB][Geo<W>::ON],
    float (&tile)[Geo<W>::NB][Geo<W>::ON], const float (&x)[32],
    uint32_t sb, uint32_t empty, int lane) {
  if constexpr (W > 128)
    issue_pv<W>(run, x, sb, 1);
  else
    issue_pv<W>(tile, x, sb, 0);
  wgmma_commit();
  wgmma_wait<0>();
  release(empty, lane);
  if constexpr (W > 128)
    settle(run);
  else
    fold(run, tile);
}

// In an accumulator fragment of M = 64, N = 64 this thread holds rows
// r0 and r0 + 8 and columns 8 i + c0 and 8 i + c0 + 1: register
// 4 i + 2 hh + e is (row r0 + 8 hh, column 8 i + c0 + e).
//
// P^T = 2^(S^T c - lse log2 e) in place on S^T = k q^T's fragment (rows:
// keys krow[hh]; columns: queries q0 + 8 i + c0 + e), lse log2 e of each
// column from the stage's row ls; 0 where the pair is masked (a query at
// or past Lq, or under `causal` a query qi with qi + off < ki), checked
// only on a tile that crosses the diagonal or Lq.
__device__ __forceinline__ void probs_t(float (&x)[32], const float* ls,
                                        float c, int q0, int c0,
                                        const int (&krow)[2], int Lq,
                                        int off, int causal, bool edge) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(ls + 8 * i + c0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 4 * i + 2 * hh + e;
        float p = ex2(fmaf(x[r], c, -(e ? l.y : l.x)));
        if (edge) {
          const int qi = q0 + 8 * i + c0 + e;
          if (!(qi < Lq && (!causal || qi + off >= krow[hh]))) p = 0.f;
        }
        x[r] = p;
      }
  }
}

// P = 2^(S c - lse log2 e) in place on S = q k^T's fragment (rows:
// queries qrow[hh] with l2[hh] = lse log2 e; columns: keys
// k0 + 8 i + c0 + e); 0 where masked (a key at or past Lk, or under
// `causal` a key ki > qi + off), checked only on edge tiles.
__device__ __forceinline__ void probs(float (&x)[32], const float (&l2)[2],
                                      float c, int k0, int c0,
                                      const int (&qrow)[2], int Lk, int off,
                                      int causal, bool edge) {
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int hh = (r >> 1) & 1;
    float p = ex2(fmaf(x[r], c, -l2[hh]));
    if (edge) {
      const int ki = k0 + 8 * (r / 4) + c0 + (r & 1);
      if (!(ki < Lk && (!causal || qrow[hh] + off >= ki))) p = 0.f;
    }
    x[r] = p;
  }
}

// One consumer warpgroup of fa_bwd_dkdv_tc over the block's nt query
// tiles: dV = sum P^T dO (DK false) or dK = sum dS^T q (DK true, not yet
// scaled), into `run` (add_product).
template <int W, bool DK>
__device__ __forceinline__ void dkdv_consumer(
    float (&run)[Geo<W>::NB][Geo<W>::ON], uint32_t sk, uint32_t sv,
    uint32_t sq0, const float* stats, uint32_t full0, uint32_t empty0,
    int nt, int t0, int k0, const int (&krow)[2], int c0, int lane,
    float c, int Lq, int off, int causal) {
  using G = Geo<W>;
  constexpr int S = ring_stages<W>();
  for (int t = 0; t < nt; ++t) {
    const int s = t % S;
    const int q0 = (t0 + t) * kTile;
    const uint32_t sq = sq0 + 2 * s * G::TILE;  // the stage's q tile
    const uint32_t sdo = sq + G::TILE;          // and its dO tile
    const float* ls = stats + s * 2 * kTile;    // lse log2 e, then D
    const bool edge =
        q0 + kTile > Lq || (causal && q0 + off < k0 + kTile - 1);
    mbar_wait(full0 + 8 * s, (t / S) & 1);
    float sacc[32];
    zero(sacc);
    [[maybe_unused]] float tacc[G::NB][G::ON];  // a tile's sum (W <= 128)
    if constexpr (DK) {
      float dp[32];
      zero(dp);
      wgmma_fence();
      issue_qk<W>(sacc, sk, sq);  // S^T = k q^T
      issue_qk<W>(dp, sv, sdo);   // dP^T = v dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dp);
      probs_t(sacc, ls, c, q0, c0, krow, Lq, off, causal, edge);
      const float* dl = ls + kTile;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 d = *reinterpret_cast<const float2*>(dl + 8 * i + c0);
#pragma unroll
        for (int r = 4 * i; r < 4 * i + 4; ++r)
          dp[r] = sacc[r] * (dp[r] - ((r & 1) ? d.y : d.x));
      }
      add_product<W>(run, tacc, dp, sq, empty0 + 8 * s, lane);  // dS^T q
    } else {
      wgmma_fence();
      issue_qk<W>(sacc, sk, sq);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      probs_t(sacc, ls, c, q0, c0, krow, Lq, off, causal, edge);
      add_product<W>(run, tacc, sacc, sdo, empty0 + 8 * s, lane);  // P^T dO
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kTcThreads, 1)
    fa_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
                   int D, float scale, int causal) {
  using G = Geo<W>;
  constexpr int S = ring_stages<W>();
  constexpr int kProducerWarp = 8;
  constexpr int kConsumerWarps = 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  const uint32_t sv = sk + G::TILE;
  const uint32_t sq0 = sv + G::TILE;  // stage s: q at + 2 s TILE, then dO
  const uint32_t sstat = sq0 + 2 * S * G::TILE;
  float* stats = reinterpret_cast<float*>(smem_raw + (sstat - raw));
  const uint32_t kvbar = sstat + S * 2 * kTile * 4;
  const uint32_t full0 = kvbar + 8;  // stage s: + 8 s
  const uint32_t empty0 = full0 + 8 * S;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;
  // Query rows qi >= k0 - off can see the block's first key; the wrapper
  // guarantees Lk >= Lq under `causal`, so at least one tile can.
  const int t0 = causal ? max(0, k0 - off) / kTile : 0;
  const int nt = (Lq + kTile - 1) / kTile - t0;

  // The warp index through a shuffle, so that the compiler sees it as
  // uniform over the warp (see fa_kernel_tc).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      // The copies' arrival and one from each lane of the producer warp.
      mbar_init(full0 + 8 * s, 1 + 32);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kProducerWarp) {
      const int64_t bh = (int64_t)b * H + h;
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * G::TILE);
        for (int c = 0; c < G::NB; ++c) {
          tma_load(sk + c * G::BOX, &tk, kvbar, c * G::CB, h, k0, b);
          tma_load(sv + c * G::BOX, &tv, kvbar, c * G::CB, h, k0, b);
        }
      }
      for (int t = 0; t < nt; ++t) {
        const int s = t % S;
        const int q0 = (t0 + t) * kTile;
        if (t >= S) mbar_wait(empty0 + 8 * s, (t / S - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t sq = sq0 + 2 * s * G::TILE;
        if (lane == 0) {
          mbar_expect_tx(full, 2 * G::TILE);
          for (int c = 0; c < G::NB; ++c) {
            tma_load(sq + c * G::BOX, &tq, full, c * G::CB, h, q0, b);
            tma_load(sq + G::TILE + c * G::BOX, &tdo, full, c * G::CB, h,
                     q0, b);
          }
        }
        float* st = stats + s * 2 * kTile;
        for (int e = lane; e < kTile; e += 32) {
          const int qi = q0 + e;
          st[e] = qi < Lq ? lse[bh * Lq + qi] * kLog2e : 0.f;
          st[kTile + e] = qi < Lq ? delta[bh * Lq + qi] : 0.f;
        }
        mbar_arrive(full);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = warp / 4;  // 0: dV, 1: dK
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int krow[2] = {k0 + r0, k0 + r0 + 8};
  const float c2 = scale * kLog2e;  // raw logits to log2 units
  float run[G::NB][G::ON];
#pragma unroll
  for (int c = 0; c < G::NB; ++c) zero(run[c]);
  mbar_wait(kvbar, 0);
  if (wg == 0)
    dkdv_consumer<W, false>(run, sk, sv, sq0, stats, full0, empty0, nt, t0,
                            k0, krow, c0, lane, c2, Lq, off, causal);
  else
    dkdv_consumer<W, true>(run, sk, sv, sq0, stats, full0, empty0, nt, t0,
                           k0, krow, c0, lane, c2, Lq, off, causal);

  const float mult = wg == 0 ? 1.f : scale;
  const int64_t row = (int64_t)H * D;  // elements between sequence rows
  __nv_bfloat16* out = (wg == 0 ? dv : dk) + ((int64_t)b * Lk * H + h) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ki = krow[hh];
    if (ki >= Lk) continue;
#pragma unroll
    for (int c = 0; c < G::NB; ++c)
#pragma unroll
      for (int i = 0; i < G::ON / 4; ++i) {
        if (c * G::CB + 8 * i >= D) break;  // the zero columns past D
        const int col = c * G::CB + 8 * i + c0;
        *reinterpret_cast<__nv_bfloat162*>(out + ki * row + col) =
            __floats2bfloat162_rn(run[c][4 * i + 2 * hh] * mult,
                                  run[c][4 * i + 2 * hh + 1] * mult);
      }
  }
}

template <int W>
__global__ void __launch_bounds__(128 * (dq_tc_warpgroups<W>() + 1), 1)
    fa_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk, int D,
                 float scale, int causal) {
  using G = Geo<W>;
  constexpr int S = dq_tc_stages<W>();
  constexpr int WGS = dq_tc_warpgroups<W>();
  constexpr int kRows = kTile * WGS;           // query rows per block
  constexpr int kProducerWarp = 4 * WGS;
  constexpr int kConsumerWarps = 4 * WGS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;  // WGS tiles
  const uint32_t sdo = sq + WGS * G::TILE;                      // WGS tiles
  const uint32_t sk = sdo + WGS * G::TILE;                      // k ring
  const uint32_t sv = sk + S * G::TILE;                         // v ring
  const uint32_t qbar = sv + S * G::TILE;  // q and dO loaded
  const uint32_t full0 = qbar + 8;         // stage s: + 8 s
  const uint32_t empty0 = full0 + 8 * S;

  const int n_qt = (Lq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kRows;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;
  int nk = (Lk + kTile - 1) / kTile;
  if (causal) nk = min(nk, (min(q0 + kRows, Lq) - 1 + off) / kTile + 1);

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(qbar, 2 * WGS * G::TILE);
      for (int half = 0; half < WGS; ++half)
        for (int c = 0; c < G::NB; ++c) {
          tma_load(sq + half * G::TILE + c * G::BOX, &tq, qbar, c * G::CB,
                   h, q0 + half * kTile, b);
          tma_load(sdo + half * G::TILE + c * G::BOX, &tdo, qbar, c * G::CB,
                   h, q0 + half * kTile, b);
        }
      for (int t = 0; t < nk; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty0 + 8 * s, (t / S - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * G::TILE);
        for (int c = 0; c < G::NB; ++c) {
          tma_load(sk + s * G::TILE + c * G::BOX, &tk, full, c * G::CB, h,
                   t * kTile, b);
          tma_load(sv + s * G::TILE + c * G::BOX, &tv, full, c * G::CB, h,
                   t * kTile, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // Consumer warpgroup wg owns query rows first .. first + 63.
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int first = q0 + kTile * wg;
  const int last = min(first + kTile - 1, Lq - 1);
  const int qrow[2] = {first + r0, first + r0 + 8};
  const uint32_t sqw = sq + wg * G::TILE;
  const uint32_t sdow = sdo + wg * G::TILE;
  const float c2 = scale * kLog2e;
  const int64_t bh = (int64_t)b * H + h;
  float l2[2], dl[2];  // the rows' lse log2 e and D
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool in = qrow[hh] < Lq;
    l2[hh] = in ? lse[bh * Lq + qrow[hh]] * kLog2e : 0.f;
    dl[hh] = in ? delta[bh * Lq + qrow[hh]] : 0.f;
  }
  float run[G::NB][G::ON];
#pragma unroll
  for (int c = 0; c < G::NB; ++c) zero(run[c]);

  // The warpgroup multiplies key tiles 0 .. nw - 1 (up to its last row's
  // diagonal); the block's later tiles only pass through it.
  int nw = 0;
  if (first <= last)
    nw = causal ? min(nk, (last + off) / kTile + 1) : nk;
  mbar_wait(qbar, 0);
  for (int t = 0; t < nw; ++t) {
    const int s = t % S;
    const int k0 = t * kTile;
    const uint32_t sks = sk + s * G::TILE;
    mbar_wait(full0 + 8 * s, (t / S) & 1);
    float sacc[32], dp[32];
    zero(sacc);
    zero(dp);
    wgmma_fence();
    issue_qk<W>(sacc, sqw, sks);                   // S = q k^T
    issue_qk<W>(dp, sdow, sv + s * G::TILE);       // dP = dO v^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dp);
    const bool edge =
        k0 + kTile > Lk || (causal && k0 + kTile - 1 > first + off);
    probs(sacc, l2, c2, k0, c0, qrow, Lk, off, causal, edge);
#pragma unroll
    for (int r = 0; r < 32; ++r)
      dp[r] = sacc[r] * (dp[r] - dl[(r >> 1) & 1]);
    [[maybe_unused]] float tacc[G::NB][G::ON];  // a tile's sum (W <= 128)
    add_product<W>(run, tacc, dp, sks, empty0 + 8 * s, lane);  // dS k
  }
  for (int t = nw; t < nk; ++t) {
    mbar_wait(full0 + 8 * (t % S), (t / S) & 1);
    release(empty0 + 8 * (t % S), lane);
  }

  const int64_t row = (int64_t)H * D;
  __nv_bfloat16* out = dq + ((int64_t)b * Lq * H + h) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = qrow[hh];
    if (qi >= Lq) continue;
#pragma unroll
    for (int c = 0; c < G::NB; ++c)
#pragma unroll
      for (int i = 0; i < G::ON / 4; ++i) {
        if (c * G::CB + 8 * i >= D) break;
        const int col = c * G::CB + 8 * i + c0;
        *reinterpret_cast<__nv_bfloat162*>(out + qi * row + col) =
            __floats2bfloat162_rn(run[c][4 * i + 2 * hh] * scale,
                                  run[c][4 * i + 2 * hh + 1] * scale);
      }
  }
}

// The four tensor maps over q, k, v and dO, with boxes of bucket W.
struct Maps {
  CUtensorMap q, k, v, dO;
};

template <int W>
cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v,
                      const void* dO, int B, int H, int Lq, int Lk, int D) {
  if (!aligned16(q, k, v, dO)) return cudaErrorMisalignedAddress;
  constexpr int cb = Geo<W>::CB;
  cudaError_t err = make_map(&m->q, q, B, Lq, H, D, cb);
  if (err == cudaSuccess) err = make_map(&m->k, k, B, Lk, H, D, cb);
  if (err == cudaSuccess) err = make_map(&m->v, v, B, Lk, H, D, cb);
  if (err == cudaSuccess) err = make_map(&m->dO, dO, B, Lq, H, D, cb);
  return err;
}

template <int W>
cudaError_t launch_dkdv_tc(const void* q, const void* k, const void* v,
                           const void* dO, const void* lse,
                           const void* delta, void* dk, void* dv, int B,
                           int H, int Lq, int Lk, int D, float scale,
                           int causal, cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps<W>(&m, q, k, v, dO, B, H, Lq, Lk, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = dkdv_tc_smem<W>();
  err = cudaFuncSetAttribute(fa_bwd_dkdv_tc<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + kTile - 1) / kTile, H, B);
  fa_bwd_dkdv_tc<W><<<grid, kTcThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dO, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Lq, Lk, D, scale, causal);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dO, const void* lse, const void* delta,
                         void* dq, int B, int H, int Lq, int Lk, int D,
                         float scale, int causal, cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps<W>(&m, q, k, v, dO, B, H, Lq, Lk, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = dq_tc_smem<W>();
  err = cudaFuncSetAttribute(fa_bwd_dq_tc<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = kTile * dq_tc_warpgroups<W>();
  dim3 grid((Lq + rows - 1) / rows, H, B);
  fa_bwd_dq_tc<W><<<grid, 128 * (dq_tc_warpgroups<W>() + 1), smem,
                    stream>>>(
      m.q, m.k, m.v, m.dO, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H,
      Lq, Lk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// `return CALL<W>(...)` for the bucket of head dim D (then falls through
// past 256: the caller returns cudaErrorInvalidValue).
#define FA_BUCKETS(CALL, ...)                                              \
  switch (fa_bucket(D)) {                                                  \
    case 32: return (int)CALL<32>(__VA_ARGS__);                            \
    case 64: return (int)CALL<64>(__VA_ARGS__);                            \
    case 128: return (int)CALL<128>(__VA_ARGS__);                          \
    case 192: return (int)CALL<192>(__VA_ARGS__);                          \
    case 256: return (int)CALL<256>(__VA_ARGS__);                          \
  }

// Dynamic shared memory (bytes) at bucket W of fa_bwd_dkdv_tc (which = 0),
// fa_bwd_dq_tc (1), fa_bwd_dkdv_tf32 (2) or fa_bwd_dq_tf32 (3); -1 for
// anything else.
extern "C" int fa_bwd_smem_bytes(int which, int W) {
  switch (W) {
#define FA_BWD_SMEM(V)                               \
  case V:                                            \
    return which == 0   ? dkdv_tc_smem<V>()          \
           : which == 1 ? dq_tc_smem<V>()            \
           : which == 2 ? dkdv_tf32_smem<V>()        \
           : which == 3 ? dq_tf32_smem<V>()          \
                        : -1;
    FA_BWD_SMEM(32) FA_BWD_SMEM(64) FA_BWD_SMEM(128) FA_BWD_SMEM(192)
    FA_BWD_SMEM(256)
#undef FA_BWD_SMEM
  }
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16.  o and dO [B, Lq, H, D] in the dtype
// → delta fp32 [B, H, Lq]; any D from 1 to 256.
extern "C" int fa_bwd_preprocess_launch(const void* o, const void* dO,
                                        void* delta, int dtype, int B, int H,
                                        int Lq, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fa_bucket(D) == 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_preprocess<float>(o, dO, delta, B, H, Lq, D, s);
  if (dtype == 1)
    return (int)launch_preprocess<__nv_bfloat16>(o, dO, delta, B, H, Lq, D,
                                                 s);
  return (int)cudaErrorInvalidValue;
}

// q, dO [B, Lq, H, D], k, v [B, Lk, H, D], lse and delta fp32 [B, H, Lq]
// → dk, dv [B, Lk, H, D] in the dtype: fa_bwd_dkdv_tf32 (float32) or
// fa_bwd_dkdv_tc (bfloat16).
extern "C" int fa_bwd_dkdv_launch(const void* q, const void* k,
                                  const void* v, const void* dO,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int dtype, int B, int H,
                                  int Lq, int Lk, int D, float scale,
                                  int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FA_BUCKETS(launch_dkdv_tf32, q, k, v, dO, lse, delta, dk, dv, B, H, Lq,
               Lk, D, scale, causal, s);
  } else if (dtype == 1) {
    FA_BUCKETS(launch_dkdv_tc, q, k, v, dO, lse, delta, dk, dv, B, H, Lq,
               Lk, D, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The same inputs → dq [B, Lq, H, D] in the dtype: fa_bwd_dq_tf32
// (float32) or fa_bwd_dq_tc (bfloat16).
extern "C" int fa_bwd_dq_launch(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq, int dtype, int B,
                                int H, int Lq, int Lk, int D, float scale,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FA_BUCKETS(launch_dq_tf32, q, k, v, dO, lse, delta, dq, B, H, Lq, Lk,
               D, scale, causal, s);
  } else if (dtype == 1) {
    FA_BUCKETS(launch_dq_tc, q, k, v, dO, lse, delta, dq, B, H, Lq, Lk, D,
               scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
