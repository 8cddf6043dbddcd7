// Flash attention (forward) for Hopper.
//
// Replaces repro/kernels/flash_attention/kernel.py::_fa_kernel (the Pallas
// TPU kernel launched by flash_attention_bhld): softmax(q k^T * scale) v
// per (batch, head), online over key tiles, with a running row max `m`,
// normalizer `l` and the output accumulator in fp32; keys at or beyond Lk
// are masked, and under `causal` so is every key ki > qi + (Lk - Lq).  A
// masked logit is -1e30, exactly as in the reference.  The output is
// written in q's dtype.
//
// Bound: operations.  At the serving shapes (L = 2048 or 32768, D = 64)
// the kernel does 4*D flops per unmasked (q, k) pair (D multiply-adds for
// q.k, D for p.v) and needs to move only q, k, v and o once, so it sits
// far above the card's ridge point.
// This first version runs the two products on the CUDA cores in fp32
// (the reference's arithmetic: it casts q, k, v to fp32), not on the
// tensor cores; it is simple and right, not fast.
//
// Design: one block of 256 threads per (q tile of 64 rows, head, batch).
// The q tile is staged once in shared memory; a loop walks the key tiles
// of 64 rows, staging k and v.  The 256 threads form a 16 x 16 grid: the
// thread (ty, tx) owns rows ty + 16 i (i < 4) of the q tile, logits of
// columns tx + 16 j (j < 4) of the key tile, and output columns
// tx + 16 c (c < D/16).  So a row's logits sit in the 16 lanes of one
// half-warp: its max and sum are shuffle reductions, and the row's
// m, l and the rescale factor live in registers of the same threads that
// hold the row's output accumulator.  p goes through shared memory for
// the p v product.  Rows of q and k in shared memory are padded by one
// word, so the strided reads hit distinct banks.  Key tiles that lie
// wholly above the causal diagonal of the q tile are skipped: there every
// p is exp(-1e30 - m) = 0 with m finite, so skipping changes nothing.
//
// Layout: q, k, v, o are contiguous [B, L, H, D], the model's layout, so
// one row of a head is D elements and consecutive rows lie H * D apart.
// The wrapper guarantees Lk >= Lq under `causal`, so every real query row
// sees key 0 in the first tile and m is finite before any masked tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Lq,
              int Lk, float scale, int causal) {
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
  const T* qb = q + ((int64_t)b * Lq * H + h) * D;
  const T* kb = k + ((int64_t)b * Lk * H + h) * D;
  const T* vb = v + ((int64_t)b * Lk * H + h) * D;
  T* ob = o + ((int64_t)b * Lq * H + h) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int qi = q0 + r;
    qs[r * (D + 1) + c] = qi < Lq ? to_f(qb[qi * row + c]) : 0.f;
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
      ks[r * (D + 1) + c] = in ? to_f(kb[ki * row + c]) : 0.f;
      vs[r * D + c] = in ? to_f(vb[ki * row + c]) : 0.f;
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
      ob[qi * row + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Lq, int Lk, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  fa_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Lq, Lk, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int Lq, int Lk, float scale,
                     int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Lq, Lk, scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Lq, Lk, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Lq, Lk, scale, causal,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  q and o are
// contiguous [B, Lq, H, D], k and v contiguous [B, Lk, H, D].
extern "C" int fa_launch(const void* q, const void* k, const void* v,
                         void* o, int dtype, int B, int H, int Lq, int Lk,
                         int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, o, B, H, Lq, Lk, scale, causal,
                                s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Lq, Lk, scale,
                                        causal, s);
  return (int)cudaErrorInvalidValue;
}
