// Gradient of the Mamba2 SSD chunked scan (ssd.cu) for Hopper: the
// inter-chunk carry's walks and each chunk's gradients.
//
// The reference has no backward Pallas kernel: it trains through its jnp
// SSD (repro/kernels/ssd/ref.py::ssd_ref), which XLA differentiates.  The
// port's forward is two kernels whose outputs autograd cannot see
// through, so its gradient is written out here as two kernels, launched
// in order by the op repro_torch::ssd_fwd's backward after one more
// launch of the chunk kernel for the chunk states S_c (kept out of the
// forward's saved tensors: at 48 layers they would take ~9.6 GB).  All
// arithmetic is fp32; bf16 inputs are converted exactly as they are read.
// The formulas, and their plain versions, are in ../ref.py
// (ssd_carry_bwd_ref, ssd_chunk_bwd_ref).
//
// * ssd_carry_bwd: one block per (slice of PS columns of P, head, batch),
//   as the forward carry.  Each thread owns two rows of N and four
//   columns of the slice, so both walks keep their state in registers:
//     forward  h_prev_c = h,  h = exp(cum_last,c) h + S_c      (writes the
//              [B, nc, H, N, P] stack of h_prev)
//     reverse  g_c = g,  g = exp(cum_last,c) g + sum_i exp(cum_i) C_i (x) dy_i
//              from g = dfinal (zeros without one); what is left is
//              d init_state.
//   The reverse walk stages the chunk's C and exp(cum_i) dy_i (this slice)
//   in shared memory, fp32, and forms C^T . dy on the CUDA cores.
//   Bound: bytes (S_c read, h_prev and g written, fp32).
//
// * ssd_chunk_bwd: one block of 256 threads per (chunk, group of G heads,
//   batch).  C . B^T depends on (batch, chunk) only, so the block forms it
//   once, keeps it in shared memory with B and C (transposed, fp32), and
//   walks its G heads.  For each head, with E_ij = exp(cum_i - cum_j) for
//   i >= j (a plain 0 above the diagonal, never inf * 0), K = (C . B^T) o E,
//   W_ij = K_ij dt_j, dW_ij = dy_i . x_j, d_j = exp(cum_last - cum_j) dt_j,
//   g the gradient of S_c and h_prev the state entering the chunk:
//     dx_j   = dt_j sum_i K_ij dy_i + d_j B_j^T g
//     dcum_i = sum_j T_ij - sum_j T_ji - d_i <B_i (x) x_i, g>
//              + exp(cum_i) <C_i . h_prev, dy_i>            (T = dW o W)
//     ddt_j  = sum_i dW_ij K_ij + exp(cum_last - cum_j) <B_j (x) x_j, g>
//     dcum_last += sum_j d_j <B_j (x) x_j, g> + exp(cum_last) <g, h_prev>
//   (ddt without the cumsum's part: the op adds A . da), and accumulates
//   over its heads sum_h dW o E o dt (for dC = . B and dB = ^T . C at the
//   end), sum_h d_j g x_j (dB) and sum_h exp(cum_i) h_prev dy_i (dC) in
//   registers.  dB and dC are written as one partial sum per group,
//   [H / G, B, L, N]; the op sums the groups in a fixed order.  No
//   atomics: two passes are equal bit for bit.  Every product runs as 4 x 4
//   register tiles over two k-major operands in shared memory (two 16-byte
//   loads per 16 multiply-adds).
//   Bound: operations, fp32 on the CUDA cores (~6 Q N P + 2 Q^2 P flops per
//   (b, c, h)).  The tensor-core version (C . B^T, dW and the dx products
//   on mma.sync, as ssd_chunk_tc) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;          // ssd_chunk_bwd's block
constexpr int kCarryMaxThreads = 512;  // ssd_carry_bwd's largest block
constexpr size_t kMaxSmem = 232448;    // a block's dynamic shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// d * h + s, elementwise.
__device__ __forceinline__ float4 decay4(float d, float4 h, float4 s) {
  return make_float4(fmaf(d, h.x, s.x), fmaf(d, h.y, s.y), fmaf(d, h.z, s.z),
                     fmaf(d, h.w, s.w));
}

// ---------------------------------------------------------------------------
// ssd_carry_bwd
// ---------------------------------------------------------------------------

size_t carry_bwd_smem_bytes(int Q, int N, int PS) {
  return ((size_t)Q * N + (size_t)Q * PS) * sizeof(float);
}

template <typename T, int PS>
__global__ void __launch_bounds__(kCarryMaxThreads)
    ssd_carry_bwd(const float* __restrict__ states,
                  const float* __restrict__ cum, const T* __restrict__ cm,
                  const T* __restrict__ dy, const float* __restrict__ init,
                  const float* __restrict__ dfinal,
                  float* __restrict__ h_prev, float* __restrict__ g_out,
                  float* __restrict__ dinit, int L, int H, int P, int N,
                  int Q) {
  constexpr int G4 = PS / 4;
  extern __shared__ __align__(16) float carry_smem[];
  float* cs = carry_smem;    // [Q][N]: the chunk's C
  float* ds = cs + Q * N;    // [Q][PS]: exp(cum_i) dy_i, this slice
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ps0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int nc = L / Q;
  const int n0 = (tid / G4) * 2, q4 = (tid % G4) * 4;
  // This thread's two float4s of an [N, P] state.
  const int64_t o0 = (int64_t)n0 * P + ps0 + q4, o1 = o0 + P;
  const int64_t whole = (((int64_t)b * H) + h) * (int64_t)N * P;
  auto at = [&](int c) {
    return (((int64_t)b * nc + c) * H + h) * (int64_t)N * P;
  };
  auto last_decay = [&](int c) {
    return expf(cum[((int64_t)b * L + (int64_t)c * Q + Q - 1) * H + h]);
  };

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 h0 = init ? ld4(init + whole + o0) : zero;
  float4 h1 = init ? ld4(init + whole + o1) : zero;
  for (int c = 0; c < nc; ++c) {
    const int64_t s = at(c);
    st4(h_prev + s + o0, h0);
    st4(h_prev + s + o1, h1);
    const float d = last_decay(c);
    h0 = decay4(d, h0, ld4(states + s + o0));
    h1 = decay4(d, h1, ld4(states + s + o1));
  }

  float4 g0 = dfinal ? ld4(dfinal + whole + o0) : zero;
  float4 g1 = dfinal ? ld4(dfinal + whole + o1) : zero;
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t s = at(c);
    st4(g_out + s + o0, g0);
    st4(g_out + s + o1, g1);
    const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
    __syncthreads();  // every thread is done with chunk c + 1's tiles
    for (int e = tid; e < Q * N; e += nthr) cs[e] = to_f(cm[row0 * N + e]);
    for (int e = tid; e < Q * PS; e += nthr) {
      const int i = e / PS, p = e % PS;
      const int64_t row = row0 + i;
      ds[e] = expf(cum[row * H + h]) * to_f(dy[(row * H + h) * P + ps0 + p]);
    }
    __syncthreads();
    float a[2][4] = {};
#pragma unroll 8
    for (int i = 0; i < Q; ++i) {
      const float2 cc = *reinterpret_cast<const float2*>(cs + i * N + n0);
      const float4 dv = ld4(ds + i * PS + q4);
      a[0][0] = fmaf(cc.x, dv.x, a[0][0]);
      a[0][1] = fmaf(cc.x, dv.y, a[0][1]);
      a[0][2] = fmaf(cc.x, dv.z, a[0][2]);
      a[0][3] = fmaf(cc.x, dv.w, a[0][3]);
      a[1][0] = fmaf(cc.y, dv.x, a[1][0]);
      a[1][1] = fmaf(cc.y, dv.y, a[1][1]);
      a[1][2] = fmaf(cc.y, dv.z, a[1][2]);
      a[1][3] = fmaf(cc.y, dv.w, a[1][3]);
    }
    const float d = last_decay(c);
    g0 = decay4(d, g0, make_float4(a[0][0], a[0][1], a[0][2], a[0][3]));
    g1 = decay4(d, g1, make_float4(a[1][0], a[1][1], a[1][2], a[1][3]));
  }
  st4(dinit + whole + o0, g0);
  st4(dinit + whole + o1, g1);
}

template <typename T, int PS>
cudaError_t launch_carry_bwd_ps(const void* states, const void* cum,
                                const void* cm, const void* dy,
                                const void* init, const void* dfinal,
                                void* h_prev, void* g, void* dinit, int B,
                                int L, int H, int P, int N, int Q,
                                cudaStream_t stream) {
  const int threads = (N / 2) * (PS / 4);
  const size_t smem = carry_bwd_smem_bytes(Q, N, PS);
  if (threads > kCarryMaxThreads || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_carry_bwd<T, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P / PS, H, B);
  ssd_carry_bwd<T, PS><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(states), static_cast<const float*>(cum),
      static_cast<const T*>(cm), static_cast<const T*>(dy),
      static_cast<const float*>(init), static_cast<const float*>(dfinal),
      static_cast<float*>(h_prev), static_cast<float*>(g),
      static_cast<float*>(dinit), L, H, P, N, Q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ssd_chunk_bwd
// ---------------------------------------------------------------------------

// acc[r][c] += sum_{k0 <= k < k1} a(k)[r] * b(k)[c]: one 4 x 4 register
// tile, its two operands' k-th rows as float4s.
template <class FA, class FB>
__device__ __forceinline__ void mac4x4(float (&acc)[4][4], int k0, int k1,
                                       FA a, FB b) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 av = a(k), bv = b(k);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

// The sum of v over the `width` consecutive lanes of its segment (width a
// power of two up to 32), in a fixed order; every lane of the warp calls
// it.
__device__ __forceinline__ float segment_sum(float v, int width) {
  for (int off = 1; off < width; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared-memory layout of ssd_chunk_bwd, in floats; rows padded by 4 so
// that they stay 16-byte aligned.
struct ChunkBwdSmem {
  int ldq, ldn, ldp;
  size_t bt, ct, cb, dcbt, xt, dyt, dyr, un, vec, total;
  // kernel.py's chunk_bwd_smem_bytes is the same sum.
  __host__ __device__ ChunkBwdSmem(int Q, int N, int P) {
    ldq = Q + 4;
    ldn = N + 4;
    ldp = P + 4;
    bt = 0;                                // [N][ldq]  B, transposed
    ct = bt + (size_t)N * ldq;             // [N][ldq]  C, transposed
    cb = ct + (size_t)N * ldq;             // [Q][ldq]  C . B^T
    dcbt = cb + (size_t)Q * ldq;           // [Q][ldq]  sum_h dW o E o dt, ^T
    xt = dcbt + (size_t)Q * ldq;           // [P][ldq]  x, transposed
    dyt = xt + (size_t)P * ldq;            // [P][ldq]  dy, transposed
    dyr = dyt + (size_t)P * ldq;           // [Q][ldp]  dy
    un = dyr + (size_t)Q * ldp;            // the union below
    // g [N][ldp] and g^T [P][ldn] (h_prev^T replaces g^T); then K and V,
    // [Q][ldq] each; at the end B and C, [Q][ldn] each.
    size_t u = (size_t)N * ldp + (size_t)P * ldn;
    if (2 * (size_t)Q * ldq > u) u = 2 * (size_t)Q * ldq;
    if (2 * (size_t)Q * ldn > u) u = 2 * (size_t)Q * ldn;
    vec = un + u;                          // 9 vectors of Q
    total = vec + 9 * (size_t)Q;
  }
};

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_bwd(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ cum, const T* __restrict__ bm,
                  const T* __restrict__ cm, const T* __restrict__ dy,
                  const float* __restrict__ g, const float* __restrict__ hp,
                  float* __restrict__ dx, float* __restrict__ dcum,
                  float* __restrict__ ddt, float* __restrict__ db_part,
                  float* __restrict__ dc_part, int L, int H, int P, int N,
                  int Q, int G) {
  extern __shared__ __align__(16) float sm[];
  const ChunkBwdSmem lay(Q, N, P);
  const int ldq = lay.ldq, ldn = lay.ldn, ldp = lay.ldp;
  float* bt = sm + lay.bt;
  float* ct = sm + lay.ct;
  float* cb = sm + lay.cb;
  float* dcbt = sm + lay.dcbt;
  float* xt = sm + lay.xt;
  float* dyt = sm + lay.dyt;
  float* dyr = sm + lay.dyr;
  float* gr = sm + lay.un;                 // g [N][ldp]
  float* gt = gr + (size_t)N * ldp;        // g^T, then h_prev^T [P][ldn]
  float* kk = sm + lay.un;                 // K [Q][ldq]
  float* vv = kk + (size_t)Q * ldq;        // V = dW o K [Q][ldq]
  float* brm = sm + lay.un;                // B [Q][ldn] (at the end)
  float* crm = brm + (size_t)Q * ldn;      // C [Q][ldn]
  float* dts = sm + lay.vec;               // dt_i
  float* cums = dts + Q;                   // cum_i
  float* ecum = cums + Q;                  // exp(cum_i)
  float* dex = ecum + Q;                   // exp(cum_last - cum_j)
  float* dd = dex + Q;                     // d_j = dex_j dt_j
  float* ured = dd + Q;                    // <B_j (x) x_j, g>
  float* inter = ured + Q;                 // exp(cum_i) <C_i . h_prev, dy_i>
  float* rowt = inter + Q;                 // sum_j T_ij
  float* colv = rowt + Q;                  // sum_i V_ij
  __shared__ float red[kThreads / 32];
  __shared__ float gh_sum;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * G;
  const int nc = L / Q;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int qt = Q / 4, ntn = N / 4, ptn = P / 4;
  const int sq_tiles = qt * qt, qn_tiles = qt * ntn, qp_tiles = qt * ptn;

  // B, C transposed; the running sum of dW o E o dt zeroed.
  for (int e = tid; e < Q * N; e += kThreads) {
    const int i = e / N, n = e % N;
    bt[n * ldq + i] = to_f(bm[row0 * N + e]);
    ct[n * ldq + i] = to_f(cm[row0 * N + e]);
  }
  for (int e = tid; e < Q * ldq; e += kThreads) dcbt[e] = 0.f;
  __syncthreads();
  // C . B^T on and below the diagonal's tiles.
  if (tid < sq_tiles && tid % qt <= tid / qt) {
    const int i0 = (tid / qt) * 4, j0 = (tid % qt) * 4;
    float acc[4][4] = {};
    mac4x4(acc, 0, N, [&](int k) { return ld4(ct + k * ldq + i0); },
           [&](int k) { return ld4(bt + k * ldq + j0); });
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st4(cb + (i0 + r) * ldq + j0,
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  }

  float db[MT][4][4] = {}, dc[MT][4][4] = {};
  for (int gi = 0; gi < G; ++gi) {
    const int h = h0 + gi;
    const int64_t st = (((int64_t)b * nc + c) * H + h) * (int64_t)N * P;
    __syncthreads();  // C . B^T is complete; the last head is done
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P, p = e % P;
      const int64_t o = ((row0 + i) * H + h) * P + p;
      const float dv = to_f(dy[o]);
      xt[p * ldq + i] = to_f(x[o]);
      dyt[p * ldq + i] = dv;
      dyr[i * ldp + p] = dv;
    }
    const float cl = cum[(row0 + Q - 1) * H + h];
    for (int i = tid; i < Q; i += kThreads) {
      const float ci = cum[(row0 + i) * H + h], ti = dt[(row0 + i) * H + h];
      dts[i] = ti;
      cums[i] = ci;
      ecum[i] = expf(ci);
      dex[i] = expf(cl - ci);
      dd[i] = dex[i] * ti;
    }
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e % P;
      const float v = g[st + e];
      gr[n * ldp + p] = v;
      gt[p * ldn + n] = v;
    }
    __syncthreads();

    // State term: dx_j = d_j B_j^T g; g x_j into dB; <B_j (x) x_j, g>.
    float dxa[4][4] = {};
    const int xj0 = (tid / ptn) * 4, xp0 = (tid % ptn) * 4;
    if (tid < qp_tiles) {
      mac4x4(dxa, 0, N, [&](int k) { return ld4(bt + k * ldq + xj0); },
             [&](int k) { return ld4(gr + k * ldp + xp0); });
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) dxa[r][q] *= dd[xj0 + r];
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int t = tid + m * kThreads;
      const bool ok = t < qn_tiles;
      const int i0 = (t / ntn) * 4, n0 = (t % ntn) * 4;
      float tmp[4][4] = {}, part[4] = {};
      if (ok) {
        mac4x4(tmp, 0, P, [&](int k) { return ld4(xt + k * ldq + i0); },
               [&](int k) { return ld4(gt + k * ldn + n0); });
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            part[r] = fmaf(bt[(n0 + q) * ldq + i0 + r], tmp[r][q], part[r]);
            db[m][r][q] = fmaf(dd[i0 + r], tmp[r][q], db[m][r][q]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) part[r] = segment_sum(part[r], ntn);
      if (ok && n0 == 0)
#pragma unroll
        for (int r = 0; r < 4; ++r) ured[i0 + r] = part[r];
    }
    __syncthreads();  // done with g^T

    // Inter term: h_prev^T staged over g^T; <g, h_prev> on the way.
    float gh = 0.f;
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e % P;
      const float v = hp[st + e];
      gt[p * ldn + n] = v;
      gh = fmaf(gr[n * ldp + p], v, gh);
    }
    gh = segment_sum(gh, 32);
    if (lane == 0) red[warp] = gh;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w];
      gh_sum = s;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int t = tid + m * kThreads;
      const bool ok = t < qn_tiles;
      const int i0 = (t / ntn) * 4, n0 = (t % ntn) * 4;
      float tmp[4][4] = {}, part[4] = {};
      if (ok) {
        mac4x4(tmp, 0, P, [&](int k) { return ld4(dyt + k * ldq + i0); },
               [&](int k) { return ld4(gt + k * ldn + n0); });
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            part[r] = fmaf(ct[(n0 + q) * ldq + i0 + r], tmp[r][q], part[r]);
            dc[m][r][q] = fmaf(ecum[i0 + r], tmp[r][q], dc[m][r][q]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) part[r] = segment_sum(part[r], ntn);
      if (ok && n0 == 0)
#pragma unroll
        for (int r = 0; r < 4; ++r) inter[i0 + r] = ecum[i0 + r] * part[r];
    }
    __syncthreads();  // done with g and h_prev^T: K and V take their place

    // Intra term: dW on and below the diagonal's tiles; K, V and the
    // running sum of dW o E o dt.
    if (tid < sq_tiles) {
      const int mt = tid / qt, nt = tid % qt;
      const int i0 = mt * 4, j0 = nt * 4;
      float dw[4][4] = {};
      if (nt <= mt)
        mac4x4(dw, 0, P, [&](int k) { return ld4(dyt + k * ldq + i0); },
               [&](int k) { return ld4(xt + k * ldq + j0); });
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float kr[4], vr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + r, j = j0 + q;
          kr[q] = 0.f;
          vr[q] = 0.f;
          if (i >= j) {
            const float e = expf(cums[i] - cums[j]);
            kr[q] = cb[i * ldq + j] * e;
            vr[q] = dw[r][q] * kr[q];
            dcbt[j * ldq + i] = fmaf(dw[r][q] * e, dts[j], dcbt[j * ldq + i]);
          }
        }
        st4(kk + (i0 + r) * ldq + j0, make_float4(kr[0], kr[1], kr[2], kr[3]));
        st4(vv + (i0 + r) * ldq + j0, make_float4(vr[0], vr[1], vr[2], vr[3]));
      }
    }
    __syncthreads();
    if (tid < Q) {
      float s = 0.f;
      for (int j = 0; j <= tid; ++j) s = fmaf(vv[tid * ldq + j], dts[j], s);
      rowt[tid] = s;
    } else if (tid < 2 * Q) {
      const int j = tid - Q;
      float s = 0.f;
      for (int i = j; i < Q; ++i) s += vv[i * ldq + j];
      colv[j] = s;
    }
    if (tid < qp_tiles) {
      float acc[4][4] = {};
      mac4x4(acc, xj0, Q, [&](int k) { return ld4(kk + k * ldq + xj0); },
             [&](int k) { return ld4(dyr + k * ldp + xp0); });
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float tj = dts[xj0 + r];
        st4(dx + ((row0 + xj0 + r) * H + h) * P + xp0,
            make_float4(fmaf(tj, acc[r][0], dxa[r][0]),
                        fmaf(tj, acc[r][1], dxa[r][1]),
                        fmaf(tj, acc[r][2], dxa[r][2]),
                        fmaf(tj, acc[r][3], dxa[r][3])));
      }
    }
    __syncthreads();
    if (tid < Q) {
      const int j = tid;
      float v = rowt[j] - dts[j] * colv[j] - dd[j] * ured[j] + inter[j];
      if (j == Q - 1) {
        float s = expf(cums[Q - 1]) * gh_sum;
        for (int k = 0; k < Q; ++k) s = fmaf(dd[k], ured[k], s);
        v += s;
      }
      dcum[(row0 + j) * H + h] = v;
      ddt[(row0 + j) * H + h] = fmaf(dex[j], ured[j], colv[j]);
    }
  }

  // dC += (sum_h dW o E o dt) . B and dB += its transpose . C, with B and
  // C row-major in the union; then this group's partial sums.
  __syncthreads();
  for (int e = tid; e < Q * N; e += kThreads) {
    const int i = e / N, n = e % N;
    brm[i * ldn + n] = to_f(bm[row0 * N + e]);
    crm[i * ldn + n] = to_f(cm[row0 * N + e]);
  }
  __syncthreads();
  const int64_t part0 = ((int64_t)grp * gridDim.z * L) * N;  // this group
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int t = tid + m * kThreads;
    if (t >= qn_tiles) continue;
    const int i0 = (t / ntn) * 4, n0 = (t % ntn) * 4;
    float acc[4][4] = {};
    mac4x4(acc, 0, min(Q, i0 + 4),
           [&](int k) { return ld4(dcbt + k * ldq + i0); },
           [&](int k) { return ld4(brm + k * ldn + n0); });
    float acc2[4][4] = {};
    mac4x4(acc2, i0, Q,
           [&](int k) {
             return make_float4(dcbt[i0 * ldq + k], dcbt[(i0 + 1) * ldq + k],
                                dcbt[(i0 + 2) * ldq + k],
                                dcbt[(i0 + 3) * ldq + k]);
           },
           [&](int k) { return ld4(crm + k * ldn + n0); });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t o = part0 + (row0 + i0 + r) * N + n0;
      st4(dc_part + o,
          make_float4(dc[m][r][0] + acc[r][0], dc[m][r][1] + acc[r][1],
                      dc[m][r][2] + acc[r][2], dc[m][r][3] + acc[r][3]));
      st4(db_part + o,
          make_float4(db[m][r][0] + acc2[r][0], db[m][r][1] + acc2[r][1],
                      db[m][r][2] + acc2[r][2], db[m][r][3] + acc2[r][3]));
    }
  }
}

template <typename T, int MT>
cudaError_t launch_chunk_bwd_mt(const void* x, const void* dt,
                                const void* cum, const void* bm,
                                const void* cm, const void* dy,
                                const void* g, const void* hp, void* dx,
                                void* dcum, void* ddt, void* db_part,
                                void* dc_part, int B, int L, int H, int P,
                                int N, int Q, int G, cudaStream_t stream) {
  const size_t smem = ChunkBwdSmem(Q, N, P).total * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(L / Q, H / G, B);
  ssd_chunk_bwd<T, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(dy),
      static_cast<const float*>(g), static_cast<const float*>(hp),
      static_cast<float*>(dx), static_cast<float*>(dcum),
      static_cast<float*>(ddt), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), L, H, P, N, Q, G);
  return cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for C and dy.  states, h_prev and g
// [B, L / Q, H, N, P], cum [B, L, H], init, dfinal and dinit [B, H, N, P]
// fp32 (init and dfinal may be null: zeros), C [B, L, N], dy [B, L, H, P];
// all contiguous and 16-byte aligned; P and N multiples of 8, N at most
// 256.
extern "C" int ssd_carry_bwd_launch(const void* states, const void* cum,
                                    const void* cm, const void* dy,
                                    const void* init, const void* dfinal,
                                    void* h_prev, void* g, void* dinit,
                                    int dtype, int B, int L, int H, int P,
                                    int N, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P % 8 || N % 8 || N > 256 || Q < 1 || L % Q)
    return (int)cudaErrorInvalidValue;
  const bool wide = P % 16 == 0;
#define SSD_CARRY_BWD(T, PS)                                                \
  return (int)launch_carry_bwd_ps<T, PS>(states, cum, cm, dy, init, dfinal, \
                                         h_prev, g, dinit, B, L, H, P, N, Q, \
                                         s)
  if (dtype == 0 && wide) SSD_CARRY_BWD(float, 16);
  if (dtype == 0) SSD_CARRY_BWD(float, 8);
  if (dtype == 1 && wide) SSD_CARRY_BWD(bf16, 16);
  if (dtype == 1) SSD_CARRY_BWD(bf16, 8);
#undef SSD_CARRY_BWD
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 for x, B, C and dy.  x, dy and dx
// [B, L, H, P]; dt, cum, dcum and ddt [B, L, H] fp32; B, C [B, L, N];
// g and h_prev [B, L / Q, H, N, P] fp32; db_part and dc_part
// [H / G, B, L, N] fp32; all contiguous and 16-byte aligned.  Q a multiple
// of 4 up to 64, P a multiple of 4 up to 64, N a power of two from 8 to
// 128, G a divisor of H.
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* dt,
                                    const void* cum, const void* bm,
                                    const void* cm, const void* dy,
                                    const void* g, const void* hp, void* dx,
                                    void* dcum, void* ddt, void* db_part,
                                    void* dc_part, int dtype, int B, int L,
                                    int H, int P, int N, int Q, int G,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q % 4 || Q < 4 || Q > 64 || L % Q || P % 4 || P < 4 || P > 64 ||
      !pow2(N) || N < 8 || N > 128 || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  const int mt = ((Q / 4) * (N / 4) + kThreads - 1) / kThreads;  // 1 or 2
#define SSD_CHUNK_BWD(T, MT)                                                 \
  return (int)launch_chunk_bwd_mt<T, MT>(x, dt, cum, bm, cm, dy, g, hp, dx,  \
                                         dcum, ddt, db_part, dc_part, B, L, \
                                         H, P, N, Q, G, s)
  if (dtype == 0 && mt == 1) SSD_CHUNK_BWD(float, 1);
  if (dtype == 0 && mt == 2) SSD_CHUNK_BWD(float, 2);
  if (dtype == 1 && mt == 1) SSD_CHUNK_BWD(bf16, 1);
  if (dtype == 1 && mt == 2) SSD_CHUNK_BWD(bf16, 2);
#undef SSD_CHUNK_BWD
  return (int)cudaErrorInvalidValue;
}
