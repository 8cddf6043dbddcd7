// Flash attention (backward) for Hopper, on the CUDA cores.
//
// The gradient of flash_attention.cu's forward.  The reference has no
// backward Pallas kernel: it trains through its jnp attention
// (repro/models/layers.py::_sdpa_ref and _sdpa_chunked) and XLA takes the
// gradient.  These kernels compute that gradient from what the forward
// kept: q, k, v, the output o, and each row's log-sum-exp lse = m + log l
// of its scaled, masked logits (fp32 [B, H, Lq]), so that P = exp(S - lse)
// is recomputed tile by tile and never stored.  q, k, v, o, dO, dq, dk and
// dv are contiguous [B, L, H, D] in one dtype (fp32 or bf16); every sum
// and product is fp32; dq, dk and dv are rounded once to the dtype.  A
// pair is masked where the forward masks it (a key at or past Lk, or,
// under `causal`, a key ki > qi + (Lk - Lq)): its P and dS are 0.
//
// Three kernels, FA2's split, none with atomics, so every result is the
// same from run to run:
//
// * fa_bwd_preprocess: D = rowsum(dO o O) per (b, h, query row), one warp
//   per row.  Bound: bytes (reads o and dO once).
// * fa_bwd_dkdv: one block of 256 threads per (64 key rows, head, batch).
//   The k and v tiles stay in shared memory in fp32 and dK, dV accumulate
//   in registers (thread (ty, tx) of a 16 x 16 grid owns key rows ty + 16 i
//   and columns tx + 16 c).  The block walks the query tiles that can see
//   its keys (under `causal`, from its own diagonal on); per tile it
//   recomputes S^T = k q^T and P^T = exp(scale S^T - lse), takes
//   dP^T = v dO^T, dS^T = P^T o (dP^T - D), and accumulates dV += P^T dO
//   and dK += dS^T q, both through shared memory.  dK is scaled once at
//   the end.
// * fa_bwd_dq: one block per (64 query rows, head, batch), walking the
//   key tiles its rows can see: S, P and dS as above, dQ += dS k, scaled
//   once at the end.
//
// Bound: operations.  The function needs 10 D flops per unmasked pair (S,
// dP, dV, dK and dQ, 2 D each); this split recomputes S and dP in the dQ
// kernel (14 D per pair) and runs on the CUDA cores at fp32, against the
// bf16 tensor-core peak of the bound, so it sits far above it.  A tile's
// shared-memory reads (8 per 16 multiply-adds in the S and dP loop) are
// its limit.  Moving S, dP, dV, dK and dQ onto wgmma is later work.
//
// Shared memory at D = 128: dK/dV 4 tiles of 64 x 129 fp32 and two 64 x 65
// tiles (165,888 bytes), dQ four tiles and one (149,248 bytes), under the
// 227 KB a block may take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// Instantiates CALL<D, T> for dtype (0 = float32, 1 = bfloat16) and head
// dim D in {32, 64, 80, 128}; anything else is cudaErrorInvalidValue.
#define FA_BWD_DISPATCH(CALL, ...)                                        \
  do {                                                                    \
    if (dtype == 0) {                                                     \
      switch (D) {                                                        \
        case 32: return (int)CALL<32, float>(__VA_ARGS__);                \
        case 64: return (int)CALL<64, float>(__VA_ARGS__);                \
        case 80: return (int)CALL<80, float>(__VA_ARGS__);                \
        case 128: return (int)CALL<128, float>(__VA_ARGS__);              \
      }                                                                   \
    } else if (dtype == 1) {                                              \
      switch (D) {                                                        \
        case 32: return (int)CALL<32, __nv_bfloat16>(__VA_ARGS__);        \
        case 64: return (int)CALL<64, __nv_bfloat16>(__VA_ARGS__);        \
        case 80: return (int)CALL<80, __nv_bfloat16>(__VA_ARGS__);        \
        case 128: return (int)CALL<128, __nv_bfloat16>(__VA_ARGS__);      \
      }                                                                   \
    }                                                                     \
    return (int)cudaErrorInvalidValue;                                    \
  } while (0)

// o and dO [B, Lq, H, D] in the dtype → delta fp32 [B, H, Lq].
extern "C" int fa_bwd_preprocess_launch(const void* o, const void* dO,
                                        void* delta, int dtype, int B, int H,
                                        int Lq, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_BWD_DISPATCH(launch_preprocess, o, dO, delta, B, H, Lq, s);
}

// q, dO [B, Lq, H, D], k, v [B, Lk, H, D], lse and delta fp32 [B, H, Lq]
// → dk, dv [B, Lk, H, D] in the dtype.
extern "C" int fa_bwd_dkdv_launch(const void* q, const void* k,
                                  const void* v, const void* dO,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int dtype, int B, int H,
                                  int Lq, int Lk, int D, float scale,
                                  int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_BWD_DISPATCH(launch_dkdv, q, k, v, dO, lse, delta, dk, dv, B, H, Lq, Lk,
                  scale, causal, s);
}

// The same inputs → dq [B, Lq, H, D] in the dtype.
extern "C" int fa_bwd_dq_launch(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq, int dtype, int B,
                                int H, int Lq, int Lk, int D, float scale,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_BWD_DISPATCH(launch_dq, q, k, v, dO, lse, delta, dq, B, H, Lq, Lk,
                  scale, causal, s);
}
