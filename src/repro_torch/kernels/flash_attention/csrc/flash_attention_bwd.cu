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
// FA2's split, three kernels, none with atomics, so every result is the
// same from run to run:
//
// * fa_bwd_preprocess: D = rowsum(dO o O) per (b, h, query row), one warp
//   per row, either dtype.  Bound: bytes (reads o and dO once).
// * dK, dV: per 64 keys, over the query tiles that can see them (under
//   `causal`, from the keys' own diagonal on): S^T = k q^T,
//   P^T = exp(scale S^T - lse), dP^T = v dO^T, dS^T = P^T o (dP^T - D),
//   dV += P^T dO, dK += dS^T q; dK scaled once at the end.
// * dQ: per query rows, over the key tiles they can see: S, P, dP and dS
//   as above, dQ += dS k, scaled once at the end.
//
// Bound: operations.  The function needs 10 D flops per unmasked pair (S,
// dP, dV, dK and dQ, 2 D each); the split recomputes S and dP in the dQ
// kernel.
//
// The dtype picks the dK/dV and dQ kernels, as it picks the forward's:
//
// * fp32 (held to 1e-4·max(max|ref|, 1), which needs fp32 products):
//   fa_bwd_dkdv and fa_bwd_dq on the CUDA cores.  One block of 256
//   threads per 64 rows; the k and v (or q and dO) tiles in shared memory
//   in fp32, rows padded by one word, the thread (ty, tx) of a 16 x 16
//   grid owning rows ty + 16 i and columns tx + 16 c; P and dS go through
//   shared memory.  A tile's shared-memory reads (8 per 16 multiply-adds
//   in the S and dP loop) are their limit.  Shared memory at D = 128:
//   dK/dV 165,888 bytes, dQ 149,248.
//
// * bf16 (the models' training dtype): fa_bwd_dkdv_tc and fa_bwd_dq_tc on
//   the tensor cores, built from the forward's blocks (fa_hopper.cuh):
//   blocks of 384 threads, two consumer warpgroups and a producer
//   warpgroup of which one warp issues the copies (setmaxnreg: 232
//   registers a consumer thread, 40 a producer thread); tiles of 64 rows
//   brought by TMA (4-D tensor maps over (D, H, L, B), 128-byte swizzle,
//   64-byte at D = 32; at D = 80 whole 64-column boxes, zero-filled past
//   column 80, so the tiles are laid out as at D = 128 and only the first
//   80 output columns are written) through a ring of kTcStages stages,
//   each guarded by a `full` and an `empty` mbarrier.  Every product is a
//   wgmma m64n64k16 (m64n32 for the D = 32 outputs): S^T, dP^T, S and dP
//   from two K-major tiles in shared memory, as the forward's q k^T;
//   dV, dK and dQ with the fp32 accumulator fragment of P^T, dS^T or dS
//   as the A operand from registers and the dO, q or k tile read MN-major
//   (the transpose bit set), as the forward's p v.
//
//   P and dS are split into three bf16 terms (split3), which hold every
//   fp32 value exactly, and q, k, v and dO are bf16, so every product is
//   exact: the kernels compute what the fp32 kernels compute, up to the
//   order of the sums.  One bf16 rounding of P and dS (the usual
//   tensor-core backward) misses the element bar, as it does in the
//   forward (tests/test_torch_flash_attention.py emulates both).  The
//   price is the MMA work: 18 D flops per pair in dK/dV (S^T twice, dP^T,
//   dV and dK three times) and 10 D in dQ, against the function's 10 D.
//
//   Sums: each tile's dV, dK or dQ is summed from zero on the tensor cores
//   (12 k16 steps) and added to a running sum in fp32 registers, as the
//   forward adds each tile's p v.  The forward found that an accumulator
//   carried across thousands of k16 steps drifts past one bf16 step; the
//   backward's bar leaves more room (1e-5·max|ref|), but a running sum
//   and a tile sum of dK and of dV do not fit one warpgroup's registers
//   at D = 128 (4 x 64 per thread, with S^T, dP^T and the split A
//   fragments on top).  So in fa_bwd_dkdv_tc the two consumer warpgroups
//   split the outputs, not the keys: one block per 64 keys, warpgroup 0
//   computes S^T and dV (running 64 + tile 64 + S^T 32 + A terms 48
//   registers at D = 128), warpgroup 1 computes S^T and dP^T and dK
//   (64 + 64 + 64, the A terms in place of S^T and dP^T once dS is
//   split).  S^T is computed twice, 2 D flops per pair more than one
//   warpgroup doing both would need.  The producer loads the keys' k and
//   v tiles once and rings the query tiles' q and dO, and, written by its
//   warp's 32 lanes into the stage (the full barrier counts their 32
//   arrivals beside the copies'), the tiles' lse (times log2 e) and D,
//   which are per column of S^T here.  fa_bwd_dq_tc has the forward's
//   shape: one block per 128 query rows, 64 per consumer warpgroup, q
//   and dO loaded once, k and v rung.
//
//   P = 2^(S scale log2(e) - lse log2(e)) from one fma on the raw logit
//   and ex2.approx.ftz.  Query tiles (dK/dV: key tiles) wholly masked by
//   `causal` are not loaded; masks are applied only on tiles that cross
//   the diagonal, Lq or Lk (a query at or past Lq has P = 0 in dK/dV; a
//   key at or past Lk in dQ).  Blocks go heaviest first: dK/dV's key
//   tile 0 sees every query, dQ's last query tile every key.
//
// Shared memory at D = 128: dK/dV 166,984 bytes, dQ 197,704, under the
// 227 KB a block may take.

#include "fa_hopper.cuh"


namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores (and the preprocess, either dtype)
// ---------------------------------------------------------------------------

constexpr int kB = 64;          // rows of a query or key tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kPreRows = 8;     // preprocess: rows (warps) per block

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows r0 .. r0 + 63 of one (b, h) slice (rows `row` elements apart) into
// shared memory as fp32 [64][D + 1]; rows at or past L as zeros.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          int64_t row, int r0, int L) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gi = r0 + r;
    dst[r * (D + 1) + c] = gi < L ? ld(base + gi * row + c) : 0.f;
  }
}

// Entries r0 .. r0 + 63 of one row statistic (lse or D) into shared memory.
__device__ __forceinline__ void load_stat(float* dst, const float* base,
                                          int r0, int L) {
  for (int e = threadIdx.x; e < kB; e += kThreads)
    dst[e] = r0 + e < L ? base[r0 + e] : 0.f;
}

template <int D, typename T>
__global__ void __launch_bounds__(kPreRows * 32)
    fa_bwd_preprocess(const T* __restrict__ o, const T* __restrict__ dO,
                      float* __restrict__ delta, int H, int Lq,
                      int64_t nrows) {
  // Row r of [B, Lq, H] in memory order: r = (b Lq + i) H + h.
  const int64_t r = (int64_t)blockIdx.x * kPreRows + threadIdx.x / 32;
  if (r >= nrows) return;  // uniform over the warp
  const int lane = threadIdx.x % 32;
  const T* op = o + r * D;
  const T* dp = dO + r * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(ld(dp + c), ld(op + c), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const int h = (int)(r % H);
    const int64_t bi = r / H;
    const int i = (int)(bi % Lq);
    const int64_t b = bi / Lq;
    delta[(b * H + h) * Lq + i] = acc;
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) *
         (size_t)(4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int H, int Lq, int Lk, float scale,
                int causal) {
  constexpr int RC = D / 16;  // columns per thread
  constexpr int PS = kB + 1;  // row stride of the P and dS tiles
  extern __shared__ float smem[];
  float* ks = smem;                  // [kB][D + 1]
  float* vs = ks + kB * (D + 1);     // [kB][D + 1]
  float* qs = vs + kB * (D + 1);     // [kB][D + 1]
  float* os = qs + kB * (D + 1);     // dO tile, [kB][D + 1]
  float* ps = os + kB * (D + 1);     // P^T, [kB keys][PS]
  float* ss = ps + kB * PS;          // dS^T, [kB keys][PS]
  float* ls = ss + kB * PS;          // lse of the query tile
  float* dl = ls + kB;               // D of the query tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;

  const int64_t row = (int64_t)H * D;
  const T* qb = q + ((int64_t)b * Lq * H + h) * D;
  const T* ob = dO + ((int64_t)b * Lq * H + h) * D;
  const T* kb = k + ((int64_t)b * Lk * H + h) * D;
  const T* vb = v + ((int64_t)b * Lk * H + h) * D;
  const float* lb = lse + ((int64_t)b * H + h) * Lq;
  const float* db = delta + ((int64_t)b * H + h) * Lq;

  load_tile<D>(ks, kb, row, k0, Lk);
  load_tile<D>(vs, vb, row, k0, Lk);

  float adk[4][RC], adv[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c) adk[i][c] = adv[i][c] = 0.f;

  // Query rows qi >= k0 - off can see this block's first key.
  const int t0 = causal ? max(0, k0 - off) / kB : 0;
  const int n_qt = (Lq + kB - 1) / kB;
  for (int t = t0; t < n_qt; ++t) {
    const int q0 = t * kB;
    __syncthreads();  // the previous tile's q, dO, P and dS are consumed
    load_tile<D>(qs, qb, row, q0, Lq);
    load_tile<D>(os, ob, row, q0, Lq);
    load_stat(ls, lb, q0, Lq);
    load_stat(dl, db, q0, Lq);
    __syncthreads();

    // S^T and dP^T: key rows ty + 16 i, query columns tx + 16 j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty + 16 * i) * (D + 1) + d];
        vv[i] = vs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * (D + 1) + d];
        ov[j] = os[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty + 16 * i;
      const int ki = k0 + kr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int qi = q0 + qc;
        const bool ok = ki < Lk && qi < Lq && (!causal || qi + off >= ki);
        const float p = ok ? expf(s[i][j] * scale - ls[qc]) : 0.f;
        ps[kr * PS + qc] = p;
        ss[kr * PS + qc] = p * (dp[i][j] - dl[qc]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T q over the tile's 64 queries.
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float pv[4], sv[4], ov[RC], qv[RC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[(ty + 16 * i) * PS + c];
        sv[i] = ss[(ty + 16 * i) * PS + c];
      }
#pragma unroll
      for (int cc = 0; cc < RC; ++cc) {
        ov[cc] = os[c * (D + 1) + tx + 16 * cc];
        qv[cc] = qs[c * (D + 1) + tx + 16 * cc];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < RC; ++cc) {
          adv[i][cc] = fmaf(pv[i], ov[cc], adv[i][cc]);
          adk[i][cc] = fmaf(sv[i], qv[cc], adk[i][cc]);
        }
    }
  }

  T* dkb = dk + ((int64_t)b * Lk * H + h) * D;
  T* dvb = dv + ((int64_t)b * Lk * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= Lk) continue;
#pragma unroll
    for (int cc = 0; cc < RC; ++cc) {
      st(dkb + ki * row + tx + 16 * cc, adk[i][cc] * scale);
      st(dvb + ki * row + tx + 16 * cc, adv[i][cc]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kB * (D + 1) + kB * (kB + 1) + 2 * kB);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int Lq, int Lk, float scale,
              int causal) {
  constexpr int RC = D / 16;
  constexpr int PS = kB + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kB][D + 1]
  float* os = qs + kB * (D + 1);     // dO tile
  float* ks = os + kB * (D + 1);
  float* vs = ks + kB * (D + 1);
  float* ss = vs + kB * (D + 1);     // dS, [kB queries][PS]
  float* ls = ss + kB * PS;
  float* dl = ls + kB;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_qt = (Lq + kB - 1) / kB;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kB;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;

  const int64_t row = (int64_t)H * D;
  const T* qb = q + ((int64_t)b * Lq * H + h) * D;
  const T* ob = dO + ((int64_t)b * Lq * H + h) * D;
  const T* kb = k + ((int64_t)b * Lk * H + h) * D;
  const T* vb = v + ((int64_t)b * Lk * H + h) * D;

  load_tile<D>(qs, qb, row, q0, Lq);
  load_tile<D>(os, ob, row, q0, Lq);
  load_stat(ls, lse + ((int64_t)b * H + h) * Lq, q0, Lq);
  load_stat(dl, delta + ((int64_t)b * H + h) * Lq, q0, Lq);

  float adq[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c) adq[i][c] = 0.f;

  int nk = (Lk + kB - 1) / kB;
  if (causal) nk = min(nk, (min(q0 + kB, Lq) - 1 + off) / kB + 1);
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's k, v and dS are consumed
    load_tile<D>(ks, kb, row, k0, Lk);
    load_tile<D>(vs, vb, row, k0, Lk);
    __syncthreads();

    // S and dP: query rows ty + 16 i, key columns tx + 16 j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
        ov[i] = os[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
      const int qi = q0 + qr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const int ki = k0 + kc;
        const bool ok = ki < Lk && qi < Lq && (!causal || qi + off >= ki);
        const float p = ok ? expf(s[i][j] * scale - ls[qr]) : 0.f;
        ss[qr * PS + kc] = p * (dp[i][j] - dl[qr]);
      }
    }
    __syncthreads();

    // dQ += dS k over the tile's 64 keys.
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float sv[4], kv[RC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ss[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < RC; ++cc) kv[cc] = ks[c * (D + 1) + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < RC; ++cc)
          adq[i][cc] = fmaf(sv[i], kv[cc], adq[i][cc]);
    }
  }

  T* dqb = dq + ((int64_t)b * Lq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Lq) continue;
#pragma unroll
    for (int cc = 0; cc < RC; ++cc)
      st(dqb + qi * row + tx + 16 * cc, adq[i][cc] * scale);
  }
}

template <int D, typename T>
cudaError_t launch_preprocess(const void* o, const void* dO, void* delta,
                              int B, int H, int Lq, cudaStream_t stream) {
  const int64_t nrows = (int64_t)B * Lq * H;
  const unsigned blocks = (unsigned)((nrows + kPreRows - 1) / kPreRows);
  fa_bwd_preprocess<D, T><<<blocks, kPreRows * 32, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO),
      static_cast<float*>(delta), H, Lq, nrows);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dO, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int Lq, int Lk,
                        float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + kB - 1) / kB, H, B);
  fa_bwd_dkdv<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk, scale, causal);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dO, const void* lse, const void* delta,
                      void* dq, int B, int H, int Lq, int Lk, float scale,
                      int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kB - 1) / kB, H, B);
  fa_bwd_dq<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Lq, Lk, scale, causal);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA ring
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 384;   // two consumer warpgroups + a producer one
constexpr int kProducerWarp = 8;
constexpr int kConsumerWarps = 8;
constexpr int kTcStages = 4;      // ring stages
constexpr int kQRows = 128;       // dQ: query rows per block

// dK/dV: the k and v tiles, kTcStages (q, dO) tile pairs, kTcStages rows
// of (lse log2 e, D) for 64 queries in fp32, then 1 + 2 kTcStages
// mbarriers; 1024 bytes of slack to align the base to the swizzle atom.
template <int D>
constexpr int dkdv_tc_smem() {
  return 1024 + (2 + 2 * kTcStages) * Geo<D>::TILE +
         kTcStages * 2 * kTile * 4 + 8 * (1 + 2 * kTcStages);
}

// dQ: q and dO (two tiles each), kTcStages (k, v) tile pairs, mbarriers.
template <int D>
constexpr int dq_tc_smem() {
  return 1024 + (4 + 2 * kTcStages) * Geo<D>::TILE + 8 * (1 + 2 * kTcStages);
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
// scaled), each tile's product summed from zero and added to `run`.
template <int D, bool DK>
__device__ __forceinline__ void dkdv_consumer(
    float (&run)[Geo<D>::NB][Geo<D>::ON], uint32_t sk, uint32_t sv,
    uint32_t sq0, const float* stats, uint32_t full0, uint32_t empty0,
    int nt, int t0, int k0, const int (&krow)[2], int c0, int lane,
    float c, int Lq, int off, int causal) {
  using G = Geo<D>;
  for (int t = 0; t < nt; ++t) {
    const int s = t % kTcStages;
    const int q0 = (t0 + t) * kTile;
    const uint32_t sq = sq0 + 2 * s * G::TILE;  // the stage's q tile
    const uint32_t sdo = sq + G::TILE;          // and its dO tile
    const float* ls = stats + s * 2 * kTile;    // lse log2 e, then D
    const bool edge =
        q0 + kTile > Lq || (causal && q0 + off < k0 + kTile - 1);
    mbar_wait(full0 + 8 * s, (t / kTcStages) & 1);
    float sacc[32];
    zero(sacc);
    float tacc[G::NB][G::ON];
    if constexpr (DK) {
      float dp[32];
      zero(dp);
      wgmma_fence();
      issue_qk<D>(sacc, sk, sq);  // S^T = k q^T
      issue_qk<D>(dp, sv, sdo);   // dP^T = v dO^T
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
      issue_pv<D>(tacc, dp, sq);  // dS^T q
    } else {
      wgmma_fence();
      issue_qk<D>(sacc, sk, sq);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      probs_t(sacc, ls, c, q0, c0, krow, Lq, off, causal, edge);
      issue_pv<D>(tacc, sacc, sdo);  // P^T dO
    }
    wgmma_commit();
    wgmma_wait<0>();
    release(empty0 + 8 * s, lane);
    fold(run, tacc);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    fa_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
                   float scale, int causal) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  const uint32_t sv = sk + G::TILE;
  const uint32_t sq0 = sv + G::TILE;  // stage s: q at + 2 s TILE, then dO
  const uint32_t sstat = sq0 + 2 * kTcStages * G::TILE;
  float* stats = reinterpret_cast<float*>(smem_raw + (sstat - raw));
  const uint32_t kvbar = sstat + kTcStages * 2 * kTile * 4;
  const uint32_t full0 = kvbar + 8;  // stage s: + 8 s
  const uint32_t empty0 = full0 + 8 * kTcStages;

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
    for (int s = 0; s < kTcStages; ++s) {
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
        const int s = t % kTcStages;
        const int q0 = (t0 + t) * kTile;
        if (t >= kTcStages)
          mbar_wait(empty0 + 8 * s, (t / kTcStages - 1) & 1);
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
    dkdv_consumer<D, false>(run, sk, sv, sq0, stats, full0, empty0, nt, t0,
                            k0, krow, c0, lane, c2, Lq, off, causal);
  else
    dkdv_consumer<D, true>(run, sk, sv, sq0, stats, full0, empty0, nt, t0,
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
        if (c * G::CB + 8 * i >= D) break;  // a box's zero columns past D
        const int col = c * G::CB + 8 * i + c0;
        *reinterpret_cast<__nv_bfloat162*>(out + ki * row + col) =
            __floats2bfloat162_rn(run[c][4 * i + 2 * hh] * mult,
                                  run[c][4 * i + 2 * hh + 1] * mult);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    fa_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
                 float scale, int causal) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;  // 2 tiles
  const uint32_t sdo = sq + 2 * G::TILE;                        // 2 tiles
  const uint32_t sk = sdo + 2 * G::TILE;                        // k ring
  const uint32_t sv = sk + kTcStages * G::TILE;                 // v ring
  const uint32_t qbar = sv + kTcStages * G::TILE;  // q and dO loaded
  const uint32_t full0 = qbar + 8;                 // stage s: + 8 s
  const uint32_t empty0 = full0 + 8 * kTcStages;

  const int n_qt = (Lq + kQRows - 1) / kQRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kQRows;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;
  int nk = (Lk + kTile - 1) / kTile;
  if (causal) nk = min(nk, (min(q0 + kQRows, Lq) - 1 + off) / kTile + 1);

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(qbar, 4 * G::TILE);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < G::NB; ++c) {
          tma_load(sq + half * G::TILE + c * G::BOX, &tq, qbar, c * G::CB,
                   h, q0 + half * kTile, b);
          tma_load(sdo + half * G::TILE + c * G::BOX, &tdo, qbar, c * G::CB,
                   h, q0 + half * kTile, b);
        }
      for (int t = 0; t < nk; ++t) {
        const int s = t % kTcStages;
        if (t >= kTcStages)
          mbar_wait(empty0 + 8 * s, (t / kTcStages - 1) & 1);
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
    const int s = t % kTcStages;
    const int k0 = t * kTile;
    const uint32_t sks = sk + s * G::TILE;
    mbar_wait(full0 + 8 * s, (t / kTcStages) & 1);
    float sacc[32], dp[32];
    zero(sacc);
    zero(dp);
    wgmma_fence();
    issue_qk<D>(sacc, sqw, sks);                   // S = q k^T
    issue_qk<D>(dp, sdow, sv + s * G::TILE);       // dP = dO v^T
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
    float tacc[G::NB][G::ON];
    issue_pv<D>(tacc, dp, sks);  // dS k
    wgmma_commit();
    wgmma_wait<0>();
    release(empty0 + 8 * s, lane);
    fold(run, tacc);
  }
  for (int t = nw; t < nk; ++t) {
    mbar_wait(full0 + 8 * (t % kTcStages), (t / kTcStages) & 1);
    release(empty0 + 8 * (t % kTcStages), lane);
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

// The four tensor maps over q, k, v and dO.
struct Maps {
  CUtensorMap q, k, v, dO;
};

cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v,
                      const void* dO, int B, int H, int Lq, int Lk, int D) {
  if (!aligned16(q, k, v, dO)) return cudaErrorMisalignedAddress;
  cudaError_t err = make_map(&m->q, q, B, Lq, H, D);
  if (err == cudaSuccess) err = make_map(&m->k, k, B, Lk, H, D);
  if (err == cudaSuccess) err = make_map(&m->v, v, B, Lk, H, D);
  if (err == cudaSuccess) err = make_map(&m->dO, dO, B, Lq, H, D);
  return err;
}

template <int D>
cudaError_t launch_dkdv_tc(const void* q, const void* k, const void* v,
                           const void* dO, const void* lse,
                           const void* delta, void* dk, void* dv, int B,
                           int H, int Lq, int Lk, float scale, int causal,
                           cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dO, B, H, Lq, Lk, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = dkdv_tc_smem<D>();
  err = cudaFuncSetAttribute(fa_bwd_dkdv_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + kTile - 1) / kTile, H, B);
  fa_bwd_dkdv_tc<D><<<grid, kTcThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dO, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Lq, Lk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dO, const void* lse, const void* delta,
                         void* dq, int B, int H, int Lq, int Lk, float scale,
                         int causal, cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dO, B, H, Lq, Lk, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = dq_tc_smem<D>();
  err = cudaFuncSetAttribute(fa_bwd_dq_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kQRows - 1) / kQRows, H, B);
  fa_bwd_dq_tc<D><<<grid, kTcThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dO, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H,
      Lq, Lk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// `return CALL<D, T>(...)` for head dim D in {32, 64, 80, 128} (then
// falls through: the caller returns cudaErrorInvalidValue).
#define FA_BWD_CASES(CALL, T, ...)                                        \
  switch (D) {                                                            \
    case 32: return (int)CALL<32, T>(__VA_ARGS__);                        \
    case 64: return (int)CALL<64, T>(__VA_ARGS__);                        \
    case 80: return (int)CALL<80, T>(__VA_ARGS__);                        \
    case 128: return (int)CALL<128, T>(__VA_ARGS__);                      \
  }
// The same for the bf16 tensor-core launchers, CALL<D>(...).
#define FA_BWD_TC_CASES(CALL, ...)                                        \
  switch (D) {                                                            \
    case 32: return (int)CALL<32>(__VA_ARGS__);                           \
    case 64: return (int)CALL<64>(__VA_ARGS__);                           \
    case 80: return (int)CALL<80>(__VA_ARGS__);                           \
    case 128: return (int)CALL<128>(__VA_ARGS__);                         \
  }

// Dynamic shared memory (bytes) of fa_bwd_dkdv_tc (which = 0) or
// fa_bwd_dq_tc (which = 1) at head dim D; -1 for anything else.
extern "C" int fa_bwd_tc_smem_bytes(int which, int D) {
  switch (D) {
    case 32: return which == 0 ? dkdv_tc_smem<32>() : dq_tc_smem<32>();
    case 64: return which == 0 ? dkdv_tc_smem<64>() : dq_tc_smem<64>();
    case 80: return which == 0 ? dkdv_tc_smem<80>() : dq_tc_smem<80>();
    case 128: return which == 0 ? dkdv_tc_smem<128>() : dq_tc_smem<128>();
  }
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16.  o and dO [B, Lq, H, D] in the dtype
// → delta fp32 [B, H, Lq].
extern "C" int fa_bwd_preprocess_launch(const void* o, const void* dO,
                                        void* delta, int dtype, int B, int H,
                                        int Lq, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FA_BWD_CASES(launch_preprocess, float, o, dO, delta, B, H, Lq, s);
  } else if (dtype == 1) {
    FA_BWD_CASES(launch_preprocess, __nv_bfloat16, o, dO, delta, B, H, Lq,
                 s);
  }
  return (int)cudaErrorInvalidValue;
}

// q, dO [B, Lq, H, D], k, v [B, Lk, H, D], lse and delta fp32 [B, H, Lq]
// → dk, dv [B, Lk, H, D] in the dtype: fa_bwd_dkdv (float32) or
// fa_bwd_dkdv_tc (bfloat16).
extern "C" int fa_bwd_dkdv_launch(const void* q, const void* k,
                                  const void* v, const void* dO,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int dtype, int B, int H,
                                  int Lq, int Lk, int D, float scale,
                                  int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FA_BWD_CASES(launch_dkdv, float, q, k, v, dO, lse, delta, dk, dv, B, H,
                 Lq, Lk, scale, causal, s);
  } else if (dtype == 1) {
    FA_BWD_TC_CASES(launch_dkdv_tc, q, k, v, dO, lse, delta, dk, dv, B, H,
                    Lq, Lk, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The same inputs → dq [B, Lq, H, D] in the dtype: fa_bwd_dq (float32) or
// fa_bwd_dq_tc (bfloat16).
extern "C" int fa_bwd_dq_launch(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq, int dtype, int B,
                                int H, int Lq, int Lk, int D, float scale,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FA_BWD_CASES(launch_dq, float, q, k, v, dO, lse, delta, dq, B, H, Lq,
                 Lk, scale, causal, s);
  } else if (dtype == 1) {
    FA_BWD_TC_CASES(launch_dq_tc, q, k, v, dO, lse, delta, dq, B, H, Lq, Lk,
                    scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
