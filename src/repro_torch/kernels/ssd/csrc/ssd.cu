// Mamba2 SSD intra-chunk pass for Hopper.
//
// Replaces repro/kernels/ssd/kernel.py::_ssd_chunk_kernel (the Pallas TPU
// kernel launched by ssd_chunks).  For one (batch b, head h, chunk c) of Q
// time steps, with x [Q, P], dt and cum [Q] (cum = the within-chunk
// cumulative sum of dt * A, A < 0) and B, C [Q, N]:
//
//   W[i][j]  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
//   y[i][p]  = sum_j W[i][j] * x[j][p]                    (y_intra, [Q, P])
//   S[n][p]  = sum_j B[j][n] * (x[j][p] * exp(cum_last - cum_j) * dt_j)
//                                                         (chunk state, [N, P])
//
// in fp32 whatever the input type, as the reference does.  The inter-chunk
// carry and the C . h_prev term stay torch ops in ops.py, as they are jnp
// outside the Pallas kernel in the reference.
//
// Bound: at the serving shapes (Q = 64, N = P = 64) a block does about
// 2 Q^2 N + 2 Q^2 P + 2 Q N P = 1.6 MFLOP on 40 KB of input and output,
// so the arithmetic bounds it on paper.  This first version is simple: it
// runs on the CUDA cores in fp32 with one shared-memory operand per
// multiply-add, so shared-memory bandwidth, not the fp32 rate, is what it
// meets first.
//
// Design: one block of 256 threads per (chunk, head, batch).  The block
// stages x, B, C, dt and cum of its chunk in dynamic shared memory (B and
// C rows padded by one word so that column walks hit distinct banks),
// builds the [Q, Q] tile W there, then writes y_intra straight into the
// [B, L, H, P] layout of x and the chunk state into [B, nc, H, N, P].
// exp(cum_i - cum_j) is taken only where i >= j: for i < j it can
// overflow to inf, and the masked entry is a plain 0, never inf * 0.
// Shared memory grows with Q, N and P (98 KB at Q = 64, N = 128, P = 64;
// 163 KB at Q = 128, N = P = 64), past the 48 KB default, so the launch
// raises the kernel's dynamic shared-memory limit first and reports any
// error the launch returns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t smem_floats(int Q, int N, int P) {
  return (size_t)Q * P + 2 * (size_t)Q * (N + 1) + (size_t)Q * (Q + 1) +
         3 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ cum, const T* __restrict__ bm,
                     const T* __restrict__ cm, float* __restrict__ y,
                     float* __restrict__ state, int L, int H, int P, int N,
                     int Q) {
  extern __shared__ float smem[];
  float* xs = smem;                  // [Q][P]
  float* bs = xs + Q * P;            // [Q][N + 1]
  float* cs = bs + Q * (N + 1);      // [Q][N + 1]
  float* ws = cs + Q * (N + 1);      // [Q][Q + 1]
  float* dts = ws + Q * (Q + 1);     // [Q]
  float* cums = dts + Q;             // [Q]
  float* des = cums + Q;             // [Q]: exp(cum_last - cum_j) * dt_j

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;  // first time step

  for (int e = tid; e < Q * P; e += kThreads) {
    const int i = e / P, p = e % P;
    xs[e] = to_f(x[((row0 + i) * H + h) * P + p]);
  }
  for (int e = tid; e < Q * N; e += kThreads) {
    const int i = e / N, n = e % N;
    bs[i * (N + 1) + n] = to_f(bm[(row0 + i) * N + n]);
    cs[i * (N + 1) + n] = to_f(cm[(row0 + i) * N + n]);
  }
  for (int i = tid; i < Q; i += kThreads) {
    dts[i] = dt[(row0 + i) * H + h];
    cums[i] = cum[(row0 + i) * H + h];
  }
  __syncthreads();

  for (int i = tid; i < Q; i += kThreads)
    des[i] = expf(cums[Q - 1] - cums[i]) * dts[i];
  for (int e = tid; e < Q * Q; e += kThreads) {
    const int i = e / Q, j = e % Q;
    float w = 0.f;
    if (i >= j) {
      float cb = 0.f;
      for (int n = 0; n < N; ++n)
        cb = fmaf(cs[i * (N + 1) + n], bs[j * (N + 1) + n], cb);
      w = cb * expf(cums[i] - cums[j]) * dts[j];
    }
    ws[i * (Q + 1) + j] = w;
  }
  __syncthreads();

  for (int e = tid; e < Q * P; e += kThreads) {
    const int i = e / P, p = e % P;
    float acc = 0.f;
    for (int j = 0; j <= i; ++j)
      acc = fmaf(ws[i * (Q + 1) + j], xs[j * P + p], acc);
    y[((row0 + i) * H + h) * P + p] = acc;
  }
  float* st = state + (((int64_t)b * nc + c) * H + h) * (int64_t)N * P;
  for (int e = tid; e < N * P; e += kThreads) {
    const int n = e / P, p = e % P;
    float acc = 0.f;
    for (int j = 0; j < Q; ++j)
      acc = fmaf(bs[j * (N + 1) + n], xs[j * P + p] * des[j], acc);
    st[e] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* cum,
                   const void* bm, const void* cm, float* y, float* state,
                   int B, int L, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(Q, N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(L / Q, H, B);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, cum, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, state, L, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x, B and C; dt, cum, y and state
// are float32.  x [B, L, H, P], dt and cum [B, L, H], B and C [B, L, N],
// y [B, L, H, P], state [B, L / Q, H, N, P], all contiguous.
extern "C" int ssd_chunk_launch(const void* x, const void* dt,
                                const void* cum, const void* bm,
                                const void* cm, void* y, void* state,
                                int dtype, int B, int L, int H, int P, int N,
                                int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* cumf = static_cast<const float*>(cum);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return (int)launch<float>(x, dtf, cumf, bm, cm, yf, sf, B, L, H, P, N, Q,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dtf, cumf, bm, cm, yf, sf, B, L, H,
                                      P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
