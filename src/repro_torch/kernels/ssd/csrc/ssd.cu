// Mamba2 SSD chunked scan for Hopper: the intra-chunk pass and the
// inter-chunk carry.
//
// The intra-chunk pass replaces repro/kernels/ssd/kernel.py::
// _ssd_chunk_kernel (the Pallas TPU kernel launched by ssd_chunks).  For
// one (batch b, head h, chunk c) of Q time steps, with x [Q, P], dt and
// cum [Q] (cum = the within-chunk cumulative sum of dt * A, A < 0) and B,
// C [Q, N]:
//
//   W[i][j]  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
//   y[i][p]  = sum_j W[i][j] * x[j][p]                    (y_intra, [Q, P])
//   S[n][p]  = sum_j B[j][n] * (x[j][p] * exp(cum_last - cum_j) * dt_j)
//                                                         (chunk state, [N, P])
//
// in fp32 whatever the input type, as the reference does.  Two kernels,
// chosen by the wrapper:
//
// * ssd_chunk_tc (bf16 x, B and C at Q = P = 64, N = 64 or 128: the
//   serving path), on the tensor cores with mma.sync m16n8k16.  C . B^T
//   depends on (batch, chunk) only, so one block of 4 warps takes a
//   (batch, chunk, group of G heads): it stages B and C once with
//   cp.async and computes C . B^T once (bf16 inputs, fp32 sums: every
//   product exact), each warp keeping its 16 rows of it in registers for
//   all G heads.  For each head it stages x with cp.async one head ahead
//   (double buffer), builds W in registers straight from C . B^T's
//   accumulator fragments (the m16n8 accumulator of two n-tiles is the
//   A fragment of one k16 step) and multiplies it with x; and it builds
//   B ⊙ dec_end (dec_end_j = exp(cum_last - cum_j) * dt_j) in shared
//   memory and multiplies its transpose with x for the state, x's
//   fragments (ldmatrix.trans) serving both products.  W and B ⊙ dec_end
//   are fp32: each is split into `terms` bf16 terms, t1 = bf16(v),
//   t2 = bf16(v - t1), ..., and every term multiplied exactly, so the
//   products carry 8 significant bits per term (three terms hold an fp32
//   value exactly).  The wrapper picks two terms by default; the worst
//   ratio to the bar per term count is in PERF.md.  The group size G is
//   the largest divisor of H up to 16 that still gives four blocks per
//   SM.  mma.sync rather than wgmma: the tiles are 64 x 64 with one
//   operand built in registers per warp, the MMA work is small beside
//   the bytes, and the fragment layout of mma.sync lets W go from the
//   C . B^T accumulator to the next product without shared memory.
//
//   Bound: bytes.  Per (b, c, h) it reads x (8 KB) and writes y_intra and
//   the state in fp32 (32 KB) for 2 * terms * (Q^2 P / 2 + Q N P) MMA
//   flops; C . B^T is once per G heads.
//
// * ssd_chunk_kernel (fp32 inputs, the reference sweep, held to 1e-4, and
//   every other shape, chunks of 1 to 256 rows), on the CUDA cores: one
//   block of 256 threads per (chunk, head, batch) stages dt and cum, then
//   walks the chunk in blocks of up to kRows = 64 rows: for each row
//   block i, the column blocks j at or below it, staging x and B of j and
//   C of i in dynamic shared memory (B and C rows padded by one word) and
//   building that [64, 64] tile of W there, so that no [Q, Q] or [Q, N]
//   tile is ever held whole.  Each y element sums its j in order; the
//   chunk state sums the blocks j in order while the last row block is
//   walked.  At Q <= 64 it is one block, as the first port's kernel was.
//
// exp(cum_i - cum_j) is taken only where i >= j: for i < j it can
// overflow to inf, and the masked entry is a plain 0, never inf * 0.
//
// The inter-chunk carry has no Pallas counterpart: the
// reference runs it as a jax.lax.scan plus an einsum (repro/kernels/ssd/
// ops.py:40-55).  One block per (batch, head, slice of PS columns of P)
// walks the chunks in order, keeping h_prev [N, PS] in fp32 in shared
// memory:
//
//   y[i][p] = y_intra[i][p] + exp(cum_i) * (C_i . h_prev)[p]   (x's dtype)
//   h       = exp(cum_last) * h + S_c
//
// and writes the final state in fp32 at the end; no [B, nc, H, N, P]
// stack of h_prev and no fp32 y_inter is ever written.  The walk takes
// each chunk in tiles of up to kCarryTile = 64 rows (the whole chunk when
// shorter), h updated after a chunk's last tile, so that the C it stages
// is two tiles at any chunk length up to 256.  Nothing the walk reads
// depends on h except the product itself, so the block reads one tile
// ahead of the one it works on.  16-column slices where P is a multiple
// of 16, else 8.  Two kernels, by C's dtype:
//
// * ssd_carry_tc (bf16 C, the serving path): C . h_prev on mma.sync, one
//   warp per 16 rows of a tile, C the A operand straight from shared memory and
//   h_prev kept beside its fp32 copy as three bf16 terms (exact), so the
//   products are exact and the sums fp32.  The same walk on the CUDA
//   cores runs two shared-memory loads per eight multiply-adds and, with
//   few warps per SM, was limited by instruction throughput (2.13 ms at
//   the 32k prompt on the H100 against its 0.40 ms byte bound).
// * ssd_carry_kernel (fp32 C, and shapes the first does not take): the
//   CUDA cores.  C is transposed into fp32 ([N][tile rows], so that a
//   thread's two rows are one 8-byte read); each thread owns two rows of
//   a tile and four columns of y.
//
// Both copy the next tile's C with cp.async (double buffer) and read
// the next tile's y_intra and cum (and, at a chunk's first tile, its
// state slice) into registers while they work on the current one.
//
// Bound: bytes — y_intra and the chunk states read once (fp32), C and
// cum, y written in its dtype and the final state: about 1.3 GB, 0.40 ms
// at 3.35 TB/s, for the 1 x 32,768-token prompt of zamba2-1.2b.
//
// The mma.sync, ldmatrix and cp.async helpers are in ssd_mma.cuh, which
// the backward (ssd_bwd.cu) includes too.

#include "ssd_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNumSMs = 132;
constexpr size_t kMaxSmem = 232448;   // a block's dynamic shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// CUDA-core chunk kernel
// ---------------------------------------------------------------------------

// Rows of the row blocks i and column blocks j of W: kRows, or Q when
// shorter.
constexpr int kRows = 64;

int chunk_rows(int Q) { return Q < kRows ? Q : kRows; }

// Shared memory (floats) of one block: dt, cum and dec_end of the chunk;
// x and B of block j, C of block i, the [R, R] tile of W; and where the
// chunk has more than one block, y of block i summed over the blocks j.
// kernel.py's smem_bytes is the same sum.
size_t smem_floats(int Q, int N, int P) {
  const int R = chunk_rows(Q);
  return 3 * (size_t)Q + (size_t)R * P * (Q > R ? 2 : 1) +
         2 * (size_t)R * (N + 1) + (size_t)R * (R + 1);
}

// One (chunk, head, batch) per block, in blocks of R rows: for each row
// block I it walks the column blocks J <= I in order, builds that [R, R]
// tile of W and adds W . x_J into y_I (each y element sums j = 0..i in
// order, as one pass over the whole row would); while I is the last row
// block, the walk over every J also adds B_J^T . (x_J o dec_end) into the
// chunk state, kept in the output between blocks.  kWhole: the chunk is
// one block (Q <= kRows), the walk's counts and branches known to the
// compiler.
template <typename T, bool kWhole>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ cum, const T* __restrict__ bm,
                     const T* __restrict__ cm, float* __restrict__ y,
                     float* __restrict__ state, int L, int H, int P, int N,
                     int Q, int R) {
  extern __shared__ float smem[];
  float* dts = smem;                 // [Q]
  float* cums = dts + Q;             // [Q]
  float* des = cums + Q;             // [Q]: exp(cum_last - cum_j) * dt_j
  float* xs = des + Q;               // [R][P]: x of block J
  float* bs = xs + R * P;            // [R][N + 1]: B of block J
  float* cs = bs + R * (N + 1);      // [R][N + 1]: C of block I
  float* ws = cs + R * (N + 1);      // [R][R + 1]: W of (I, J)
  float* ys = ws + R * (R + 1);      // [R][P]: y of block I, blocks J < I

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x;
  const int nb = kWhole ? 1 : (Q + R - 1) / R;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;  // first time step

  for (int i = tid; i < Q; i += kThreads) {
    dts[i] = dt[(row0 + i) * H + h];
    cums[i] = cum[(row0 + i) * H + h];
  }
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads)
    des[i] = expf(cums[Q - 1] - cums[i]) * dts[i];

  float* st = state + (((int64_t)b * nc + c) * H + h) * (int64_t)N * P;
  for (int I = 0; I < nb; ++I) {
    const int i0 = I * R, ni = min(R, Q - i0);
    __syncthreads();  // every thread is done with block I - 1's C and y
    for (int e = tid; e < ni * N; e += kThreads) {
      const int i = e / N, n = e % N;
      cs[i * (N + 1) + n] = to_f(cm[(row0 + i0 + i) * N + n]);
    }
    for (int J = 0; J <= I; ++J) {
      const int j0 = J * R, nj = min(R, Q - j0);
      __syncthreads();  // every thread is done with the last x, B and W
      for (int e = tid; e < nj * P; e += kThreads) {
        const int j = e / P, p = e % P;
        xs[e] = to_f(x[((row0 + j0 + j) * H + h) * P + p]);
      }
      for (int e = tid; e < nj * N; e += kThreads) {
        const int j = e / N, n = e % N;
        bs[j * (N + 1) + n] = to_f(bm[(row0 + j0 + j) * N + n]);
      }
      __syncthreads();

      for (int e = tid; e < ni * nj; e += kThreads) {
        const int ii = e / nj, jj = e % nj;
        const int i = i0 + ii, j = j0 + jj;
        float w = 0.f;
        if (i >= j) {
          float cb = 0.f;
          for (int n = 0; n < N; ++n)
            cb = fmaf(cs[ii * (N + 1) + n], bs[jj * (N + 1) + n], cb);
          w = cb * expf(cums[i] - cums[j]) * dts[j];
        }
        ws[ii * (R + 1) + jj] = w;
      }
      __syncthreads();

      for (int e = tid; e < ni * P; e += kThreads) {
        const int ii = e / P, p = e % P;
        const int jn = min(nj, i0 + ii - j0 + 1);  // j <= i
        float acc = J == 0 ? 0.f : ys[e];
        for (int jj = 0; jj < jn; ++jj)
          acc = fmaf(ws[ii * (R + 1) + jj], xs[jj * P + p], acc);
        if (J == I)
          y[((row0 + i0 + ii) * H + h) * P + p] = acc;
        else
          ys[e] = acc;
      }
      if (I == nb - 1) {
        for (int e = tid; e < N * P; e += kThreads) {
          const int n = e / P, p = e % P;
          float acc = J == 0 ? 0.f : st[e];
          for (int jj = 0; jj < nj; ++jj)
            acc = fmaf(bs[jj * (N + 1) + n], xs[jj * P + p] * des[j0 + jj],
                       acc);
          st[e] = acc;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_f32(const void* x, const float* dt, const float* cum,
                       const void* bm, const void* cm, float* y,
                       float* state, int B, int L, int H, int P, int N,
                       int Q, cudaStream_t stream) {
  const int R = chunk_rows(Q);
  const size_t smem = smem_floats(Q, N, P) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const auto kernel = R >= Q ? ssd_chunk_kernel<T, true>
                             : ssd_chunk_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(L / Q, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, cum, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, state, L, H, P, N, Q, R);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core chunk kernel (bf16)
// ---------------------------------------------------------------------------

constexpr int kQ = 64;          // chunk rows: 4 warps of 16
constexpr int kP = 64;          // head width
constexpr int kTcThreads = 128;
constexpr int kLdP = kP + 8;    // padded x row (bf16): ldmatrix rows on
                                // distinct banks

size_t tc_smem_bytes(int N, int NT, int G) {
  return 2 * ((size_t)(2 + NT) * kQ * (N + 8) + 2 * (size_t)kQ * kLdP) +
         8 * (size_t)G * kQ;
}

// x of one head, [kQ][kP] bf16, into a padded shared buffer.
__device__ __forceinline__ void load_x(bf16* dst, const bf16* x,
                                       int64_t row0, int H, int h) {
  for (int e = threadIdx.x; e < kQ * (kP / 8); e += kTcThreads) {
    const int j = e / (kP / 8), k8 = (e % (kP / 8)) * 8;
    cp_async16(dst + j * kLdP + k8, x + ((row0 + j) * H + h) * kP + k8);
  }
}

template <int N, int NT>
__global__ void __launch_bounds__(kTcThreads)
    ssd_chunk_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const bf16* __restrict__ bm,
                 const bf16* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ state, int L, int H, int G) {
  constexpr int kLdN = N + 8;
  constexpr int kPass = N / 64;     // state row tiles of 64 per warp set
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // [kQ][kLdN]
  bf16* bs = cs + kQ * kLdN;                     // [kQ][kLdN]
  bf16* bd = bs + kQ * kLdN;                     // NT x [kQ][kLdN]
  bf16* xs = bd + NT * kQ * kLdN;                // 2 x [kQ][kLdP]
  float* dts = reinterpret_cast<float*>(xs + 2 * kQ * kLdP);  // [G][kQ]
  float* cums = dts + G * kQ;                                 // [G][kQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int c = blockIdx.x, h0 = blockIdx.y * G, b = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * kQ;
  const int i0 = 16 * warp;  // this warp's rows of y (and of each state
                             // row tile)

  for (int e = tid; e < kQ * (N / 8); e += kTcThreads) {
    const int j = e / (N / 8), k8 = (e % (N / 8)) * 8;
    cp_async16(cs + j * kLdN + k8, cm + (row0 + j) * N + k8);
    cp_async16(bs + j * kLdN + k8, bm + (row0 + j) * N + k8);
  }
  load_x(xs, x, row0, H, h0);
  cp_async_commit();
  for (int e = tid; e < kQ * G; e += kTcThreads) {
    const int j = e / G, gi = e % G;
    dts[gi * kQ + j] = dt[(row0 + j) * H + h0 + gi];
    cums[gi * kQ + j] = cum[(row0 + j) * H + h0 + gi];
  }
  cp_async_wait_all();
  __syncthreads();

  // C . B^T, rows i0..i0+15, all kQ columns: cb[nt] is the m16n8 tile of
  // columns 8 nt .. 8 nt + 7.
  float cb[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[nt][e] = 0.f;
#pragma unroll
  for (int kn = 0; kn < N / 16; ++kn) {
    uint32_t a[4];
    ldsm_x4(a, cs + (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdN +
                   kn * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t r[4];
      ldsm_x4(r, bs + (16 * jp + (lane & 7) + (lane >> 4) * 8) * kLdN +
                     kn * 16 + ((lane >> 3) & 1) * 8);
      mma(cb[2 * jp], a, r[0], r[1]);
      mma(cb[2 * jp + 1], a, r[2], r[3]);
    }
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = h0 + gi;
    const bf16* xb = xs + (gi & 1) * kQ * kLdP;
    const float* cg = cums + gi * kQ;
    const float* dg = dts + gi * kQ;
    // x(gi) has landed; every warp is done with head gi - 1 (its x buffer
    // and bd).
    cp_async_wait_all();
    __syncthreads();
    if (gi + 1 < G) load_x(xs + ((gi + 1) & 1) * kQ * kLdP, x, row0, H, h + 1);
    cp_async_commit();

    // B ⊙ dec_end, split into NT bf16 planes: two threads per row j.
    {
      const int j = tid >> 1;
      const float de = expf(cg[kQ - 1] - cg[j]) * dg[j];
      const int n_lo = (tid & 1) * (N / 2);
#pragma unroll
      for (int n8 = 0; n8 < N / 2; n8 += 8) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(bs + j * kLdN + n_lo + n8);
        const __nv_bfloat162* v =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        uint32_t out[NT][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t t[NT];
          split<NT>(__low2float(v[q]) * de, __high2float(v[q]) * de, t);
#pragma unroll
          for (int k = 0; k < NT; ++k) out[k][q] = t[k];
        }
#pragma unroll
        for (int k = 0; k < NT; ++k)
          *reinterpret_cast<uint4*>(bd + k * kQ * kLdN + j * kLdN + n_lo +
                                    n8) =
              make_uint4(out[k][0], out[k][1], out[k][2], out[k][3]);
      }
    }
    __syncthreads();

    const float ci[2] = {cg[i0 + g], cg[i0 + g + 8]};
    float yacc[8][4], sacc[kPass][8][4];
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yacc[pt][e] = 0.f;
#pragma unroll
        for (int s = 0; s < kPass; ++s) sacc[s][pt][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      // x's B fragments for the k16 step kk: xf[pt] for columns 8 pt..
      uint32_t xf[8][2];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, xb + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              kLdP +
                          16 * np + (lane >> 4) * 8);
        xf[2 * np][0] = r[0];
        xf[2 * np][1] = r[1];
        xf[2 * np + 1][0] = r[2];
        xf[2 * np + 1][1] = r[3];
      }
      if (kk <= warp) {  // k16 steps at or below the diagonal
        uint32_t wa[NT][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * kk + 8 * half + 2 * cq;
          const float cj[2] = {cg[j], cg[j + 1]};
          const float dj[2] = {dg[j], dg[j + 1]};
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = i0 + g + 8 * rr;
            float w[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              w[e] = i >= j + e ? cb[2 * kk + half][2 * rr + e] *
                                      expf(ci[rr] - cj[e]) * dj[e]
                                : 0.f;
            uint32_t t[NT];
            split<NT>(w[0], w[1], t);
#pragma unroll
            for (int k = 0; k < NT; ++k) wa[k][2 * half + rr] = t[k];
          }
        }
#pragma unroll
        for (int k = 0; k < NT; ++k)
#pragma unroll
          for (int pt = 0; pt < 8; ++pt)
            mma(yacc[pt], wa[k], xf[pt][0], xf[pt][1]);
      }
#pragma unroll
      for (int s = 0; s < kPass; ++s)
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          uint32_t a[4];
          ldsm_x4_t(a, bd + k * kQ * kLdN +
                           (16 * kk + (lane & 7) + (lane >> 4) * 8) * kLdN +
                           64 * s + i0 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int pt = 0; pt < 8; ++pt)
            mma(sacc[s][pt], a, xf[pt][0], xf[pt][1]);
        }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* yr = y + ((row0 + i0 + g + 8 * rr) * H + h) * kP + 2 * cq;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
        *reinterpret_cast<float2*>(yr + 8 * pt) =
            make_float2(yacc[pt][2 * rr], yacc[pt][2 * rr + 1]);
    }
    float* st = state + (((int64_t)b * nc + c) * H + h) * (int64_t)N * kP;
#pragma unroll
    for (int s = 0; s < kPass; ++s)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float* sr = st + (64 * s + i0 + g + 8 * rr) * kP + 2 * cq;
#pragma unroll
        for (int pt = 0; pt < 8; ++pt)
          *reinterpret_cast<float2*>(sr + 8 * pt) =
              make_float2(sacc[s][pt][2 * rr], sacc[s][pt][2 * rr + 1]);
      }
  }
}

// Heads per block: the largest divisor of H up to 16 that still gives
// four blocks per SM.
int heads_per_block(int pairs, int H) {
  for (int g = 16; g > 1; g /= 2)
    if (H % g == 0 && (int64_t)pairs * (H / g) >= 4 * kNumSMs) return g;
  return 1;
}

template <int N, int NT>
cudaError_t launch_tc_n(const void* x, const float* dt, const float* cum,
                        const void* bm, const void* cm, float* y,
                        float* state, int B, int L, int H,
                        cudaStream_t stream) {
  const int nc = L / kQ;
  const int G = heads_per_block(B * nc, H);
  const size_t smem = tc_smem_bytes(N, NT, G);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tc<N, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nc, H / G, B);
  ssd_chunk_tc<N, NT><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), dt, cum, static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), y, state, L, H, G);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_tc(const void* x, const float* dt, const float* cum,
                      const void* bm, const void* cm, float* y, float* state,
                      int B, int L, int H, int N, cudaStream_t stream) {
  if (N == 64)
    return launch_tc_n<64, NT>(x, dt, cum, bm, cm, y, state, B, L, H,
                               stream);
  if (N == 128)
    return launch_tc_n<128, NT>(x, dt, cum, bm, cm, y, state, B, L, H,
                                stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Inter-chunk carry
// ---------------------------------------------------------------------------

constexpr int kCarryMaxThreads = 512;
constexpr int kMaxS = 4;   // float4s of a chunk state per thread

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(bits(lo), bits(hi));
}

// 16 bytes of C as floats.
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  const float* v = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = v[k];
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __low2float(v[k]);
    f[2 * k + 1] = __high2float(v[k]);
  }
}

// The carry walks each chunk in tiles of up to kCarryTile rows (Q when
// shorter): the C it stages is two tiles, whatever the chunk length.
constexpr int kCarryTile = 64;

__host__ __device__ __forceinline__ int carry_tile(int Q) {
  return Q < kCarryTile ? Q : kCarryTile;
}

// Rows [row0, row0 + rows) of C into a padded shared buffer (rows of
// N + VW).
template <typename TC>
__device__ __forceinline__ void load_c(TC* dst, const TC* cm, int64_t row0,
                                       int N, int rows) {
  constexpr int VW = 16 / sizeof(TC);
  const int ldc = N + VW;
  for (int e = threadIdx.x; e < rows * (N / VW); e += blockDim.x) {
    const int i = e / (N / VW), nv = (e % (N / VW)) * VW;
    cp_async16(dst + i * ldc + nv, cm + (row0 + i) * N + nv);
  }
  cp_async_commit();
}

// A position of the walk: tile k of chunk c (rows k R .. of it, R =
// carry_tile(Q), nt tiles a chunk), advanced one tile at a time without
// a division (the walk issues few instructions per tile besides them).
struct CarryPos {
  int c, k;
  __device__ bool first() const { return k == 0; }
  __device__ bool last(int nt) const { return k == nt - 1; }
  __device__ CarryPos next(int nt) const {
    return k + 1 == nt ? CarryPos{c + 1, 0} : CarryPos{c, k + 1};
  }
};

size_t carry_smem_bytes(int N, int Q, int PS, int c_size) {
  const int R = carry_tile(Q);
  return ((size_t)N * PS + (size_t)N * (R + (R & 1))) * sizeof(float) +
         2 * (size_t)R * (N + 16 / c_size) * c_size;
}

// One float4 of h_prev's slice: h = d * h + s.
__device__ __forceinline__ float4 carry(float d, float4 h, float4 s) {
  return make_float4(d * h.x + s.x, d * h.y + s.y, d * h.z + s.z,
                     d * h.w + s.w);
}

// kWhole: a chunk is one tile (Q <= kCarryTile), the walk's counts and
// branches known to the compiler.
template <typename TC, typename TY, int PS, bool kWhole>
__global__ void __launch_bounds__(kCarryMaxThreads)
    ssd_carry_kernel(const float* __restrict__ y_intra,
                     const float* __restrict__ states,
                     const float* __restrict__ cum, const TC* __restrict__ cm,
                     const float* __restrict__ init, TY* __restrict__ y,
                     float* __restrict__ final_state, int L, int H, int P,
                     int N, int Q) {
  constexpr int G4 = PS / 4;                // 4-column groups of a slice
  constexpr int VW = 16 / sizeof(TC);       // C values per 16-byte load
  extern __shared__ __align__(16) float carry_smem[];
  const int R = kWhole ? Q : kCarryTile;
  const int nt = kWhole ? 1 : (Q + R - 1) / R;
  const int ldc = N + VW;
  const int ldq = R + (R & 1);   // even, for the 8-byte reads of ct
  float* hs = carry_smem;    // [N][PS]: h_prev's slice
  float* ct = hs + N * PS;   // [N][ldq]: the tile's C, transposed, fp32
  TC* raw = reinterpret_cast<TC*>(ct + N * ldq);  // 2 x [R][ldc]: C as read
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ps0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int nc = L / Q;
  const int i0 = (tid / G4) * 2;   // this thread's rows i0, i0 + 1 of a tile
  const int q4 = (tid % G4) * 4;   // and columns ps0 + q4 .. + 3
  auto row0_of = [&](CarryPos p) {
    return (int64_t)b * L + (int64_t)p.c * Q + (kWhole ? 0 : p.k * R);
  };
  auto rows_of = [&](CarryPos p) {
    return kWhole ? Q : min(R, Q - p.k * R);
  };

  // What a tile needs besides C, read into registers one tile ahead:
  // this thread's y_intra and cum; at a chunk's first tile also the
  // chunk's last cum and the first kMaxS of the thread's float4s of the
  // chunk state (used after its last tile).
  float4 yi[2], sreg[kMaxS];
  float ci[2], dl;
  auto state_at = [&](int c) {
    return states + (((int64_t)b * nc + c) * H + h) * (int64_t)N * P + ps0;
  };
  auto prefetch = [&](CarryPos p) {
    const int64_t row0 = row0_of(p);
    const int rows = min(2, rows_of(p) - i0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r >= rows) break;
      const int64_t row = row0 + i0 + r;
      yi[r] = *reinterpret_cast<const float4*>(y_intra + (row * H + h) * P +
                                               ps0 + q4);
      ci[r] = cum[row * H + h];
    }
    if (!kWhole && !p.first()) return;
    dl = cum[((int64_t)b * L + (int64_t)p.c * Q + Q - 1) * H + h];
    const float* sc = state_at(p.c);
#pragma unroll
    for (int k = 0; k < kMaxS; ++k) {
      const int e = tid + k * nthr;
      if (e < N * G4)
        sreg[k] = *reinterpret_cast<const float4*>(sc + (e / G4) * P +
                                                   (e % G4) * 4);
    }
  };

  for (int e = tid; e < N * PS; e += nthr) {
    const int n = e / PS, p = e % PS;
    hs[e] = init ? init[(((int64_t)b * H + h) * N + n) * P + ps0 + p] : 0.f;
  }
  load_c(raw, cm, row0_of({0, 0}), N, rows_of({0, 0}));
  prefetch({0, 0});
  int buf = 0;
  for (CarryPos p{0, 0}; p.c < nc; p = p.next(nt), buf ^= 1) {
    const CarryPos q = p.next(nt);   // the tile after this one
    const int64_t row0 = row0_of(p);
    const int rows_t = rows_of(p);
    const TC* cur = raw + buf * R * ldc;
    // C(p) has landed; every thread is done with the tile before (its C
    // buffer, ct and the h update).
    cp_async_wait_all();
    __syncthreads();
    if (q.c < nc)
      load_c(raw + (buf ^ 1) * R * ldc, cm, row0_of(q), N, rows_of(q));
#pragma unroll 4
    for (int e = tid; e < rows_t * (N / VW); e += nthr) {
      const int i = e % rows_t, nv = (e / rows_t) * VW;
      float f[VW];
      unpack(*reinterpret_cast<const uint4*>(cur + i * ldc + nv), f);
#pragma unroll
      for (int k = 0; k < VW; ++k) ct[(nv + k) * ldq + i] = f[k];
    }
    __syncthreads();  // C transposed; h_prev complete

    float acc[2][4] = {};
#pragma unroll 8  // N is a multiple of 8: eight loads in flight at once
    for (int n = 0; n < N; ++n) {
      const float2 cc = *reinterpret_cast<const float2*>(ct + n * ldq + i0);
      const float4 hv = *reinterpret_cast<const float4*>(hs + n * PS + q4);
      acc[0][0] += cc.x * hv.x;
      acc[0][1] += cc.x * hv.y;
      acc[0][2] += cc.x * hv.z;
      acc[0][3] += cc.x * hv.w;
      acc[1][0] += cc.y * hv.x;
      acc[1][1] += cc.y * hv.y;
      acc[1][2] += cc.y * hv.z;
      acc[1][3] += cc.y * hv.w;
    }
    const int rows = min(2, rows_t - i0);  // 1 for the last row of an odd
                                           // tile, none past a short one
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r >= rows) break;
      const float e = expf(ci[r]);
      store4(y + ((row0 + i0 + r) * H + h) * P + ps0 + q4,
             yi[r].x + e * acc[r][0], yi[r].y + e * acc[r][1],
             yi[r].z + e * acc[r][2], yi[r].w + e * acc[r][3]);
    }

    if (kWhole || p.last(nt)) {
      __syncthreads();  // every read of h_prev is done
      const float d = expf(dl);
#pragma unroll
      for (int k = 0; k < kMaxS; ++k) {
        const int e = tid + k * nthr;
        if (e < N * G4) {
          float4* hp = reinterpret_cast<float4*>(hs + 4 * e);
          *hp = carry(d, *hp, sreg[k]);
        }
      }
      const float* sc = state_at(p.c);
      for (int e = tid + kMaxS * nthr; e < N * G4; e += nthr) {
        float4* hp = reinterpret_cast<float4*>(hs + 4 * e);
        *hp = carry(d, *hp, *reinterpret_cast<const float4*>(
                                sc + (e / G4) * P + (e % G4) * 4));
      }
    }
    if (q.c < nc) prefetch(q);
  }
  __syncthreads();
  for (int e = tid; e < N * PS; e += nthr) {
    const int n = e / PS, p = e % PS;
    final_state[(((int64_t)b * H + h) * N + n) * P + ps0 + p] = hs[e];
  }
}

template <typename TC, typename TY, int PS>
cudaError_t launch_carry_ps(const void* y_intra, const void* states,
                            const void* cum, const void* cm, const void* init,
                            void* y, void* final_state, int B, int L, int H,
                            int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = carry_smem_bytes(N, Q, PS, sizeof(TC));
  const int threads = ((carry_tile(Q) + 1) / 2) * (PS / 4);
  if (threads > kCarryMaxThreads || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const auto kernel = Q <= kCarryTile ? ssd_carry_kernel<TC, TY, PS, true>
                                      : ssd_carry_kernel<TC, TY, PS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P / PS, H, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const float*>(y_intra), static_cast<const float*>(states),
      static_cast<const float*>(cum), static_cast<const TC*>(cm),
      static_cast<const float*>(init), static_cast<TY*>(y),
      static_cast<float*>(final_state), L, H, P, N, Q);
  return cudaGetLastError();
}

// The carry with bf16 C (the serving path) on the tensor cores: C . h_prev
// with mma.sync m16n8k16, C read as the A operand straight from its
// copy in shared memory (no transpose), h_prev kept in fp32 and, after
// every update, as three bf16 terms that hold it exactly (the B
// operands), so every product is exact and the sums are fp32.  One warp
// per 16 rows of a tile.
constexpr int kCarryTerms = 3;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

size_t carry_tc_smem_bytes(int N, int Q, int PS) {
  return (size_t)N * PS * 4 + kCarryTerms * (size_t)N * PS * 2 +
         2 * (size_t)carry_tile(Q) * (N + 8) * 2;
}

template <typename TY, int PS, bool kWhole>
__global__ void __launch_bounds__(kCarryMaxThreads)
    ssd_carry_tc(const float* __restrict__ y_intra,
                 const float* __restrict__ states,
                 const float* __restrict__ cum, const bf16* __restrict__ cm,
                 const float* __restrict__ init, TY* __restrict__ y,
                 float* __restrict__ final_state, int L, int H, int P, int N,
                 int Q) {
  constexpr int NTP = PS / 8;   // n8 tiles of the slice
  constexpr int G4 = PS / 4;    // float4s of a row of the slice
  extern __shared__ __align__(16) float carry_smem[];
  const int R = kWhole ? Q : kCarryTile;
  const int nt = kWhole ? 1 : (Q + R - 1) / R;
  const int ldc = N + 8;
  float* hs = carry_smem;                              // [N][PS] fp32
  bf16* ht = reinterpret_cast<bf16*>(hs + N * PS);     // 3 x [N][PS]
  bf16* raw = ht + kCarryTerms * N * PS;               // 2 x [R][ldc]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int ps0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int nc = L / Q;
  const int r0 = 16 * warp;     // this warp's rows of a tile
  auto row0_of = [&](CarryPos p) {
    return (int64_t)b * L + (int64_t)p.c * Q + (kWhole ? 0 : p.k * R);
  };
  auto rows_of = [&](CarryPos p) {
    return kWhole ? Q : min(R, Q - p.k * R);
  };

  // h_prev's float4 e (row e / G4 of the slice) into fp32 and its terms.
  auto put_h = [&](int e, float4 v) {
    *reinterpret_cast<float4*>(hs + 4 * e) = v;
    uint32_t lo[kCarryTerms], hi[kCarryTerms];
    split<kCarryTerms>(v.x, v.y, lo);
    split<kCarryTerms>(v.z, v.w, hi);
#pragma unroll
    for (int k = 0; k < kCarryTerms; ++k)
      *reinterpret_cast<uint2*>(ht + k * N * PS + 4 * e) =
          make_uint2(lo[k], hi[k]);
  };
  // What a tile needs besides C, read into registers one tile ahead:
  // this warp's y_intra and cum (when the tile has its rows); at a
  // chunk's first tile also the chunk's last cum and the first kMaxS of
  // the thread's float4s of the chunk state (used after its last tile).
  float2 yi[2][NTP];
  float4 sreg[kMaxS];
  float ci[2], dl;
  auto state_at = [&](int c) {
    return states + (((int64_t)b * nc + c) * H + h) * (int64_t)N * P + ps0;
  };
  auto prefetch = [&](CarryPos p) {
    const int64_t row0 = row0_of(p);
    if (kWhole || r0 < rows_of(p)) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int64_t row = row0 + r0 + g + 8 * rr;
#pragma unroll
        for (int nt8 = 0; nt8 < NTP; ++nt8)
          yi[rr][nt8] = *reinterpret_cast<const float2*>(
              y_intra + (row * H + h) * P + ps0 + 8 * nt8 + 2 * cq);
        ci[rr] = cum[row * H + h];
      }
    }
    if (!kWhole && !p.first()) return;
    dl = cum[((int64_t)b * L + (int64_t)p.c * Q + Q - 1) * H + h];
    const float* sc = state_at(p.c);
#pragma unroll
    for (int k = 0; k < kMaxS; ++k) {
      const int e = tid + k * nthr;
      if (e < N * G4)
        sreg[k] = *reinterpret_cast<const float4*>(sc + (e / G4) * P +
                                                   (e % G4) * 4);
    }
  };

  for (int e = tid; e < N * G4; e += nthr) {
    const int n = e / G4, q = (e % G4) * 4;
    put_h(e, init ? *reinterpret_cast<const float4*>(
                        init + (((int64_t)b * H + h) * N + n) * P + ps0 + q)
                  : make_float4(0.f, 0.f, 0.f, 0.f));
  }
  load_c(raw, cm, row0_of({0, 0}), N, rows_of({0, 0}));
  prefetch({0, 0});
  int buf = 0;
  for (CarryPos p{0, 0}; p.c < nc; p = p.next(nt), buf ^= 1) {
    const CarryPos q = p.next(nt);   // the tile after this one
    const int64_t row0 = row0_of(p);
    const bf16* cur = raw + buf * R * ldc;
    // C(p) has landed and h_prev's terms are complete; every warp is done
    // with the tile before's C buffer.
    cp_async_wait_all();
    __syncthreads();
    if (q.c < nc)
      load_c(raw + (buf ^ 1) * R * ldc, cm, row0_of(q), N, rows_of(q));

    // Warp-uniform: whether the tile has this warp's rows.
    if (kWhole || r0 < rows_of(p)) {
      float acc[NTP][4] = {};
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, cur + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldc +
                       16 * kk + (lane >> 4) * 8);
#pragma unroll
        for (int k = 0; k < kCarryTerms; ++k)
#pragma unroll
          for (int nt8 = 0; nt8 < NTP; ++nt8) {
            uint32_t bb[2];
            ldsm_x2_t(bb, ht + k * N * PS +
                              (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  PS +
                              8 * nt8);
            mma(acc[nt8], a, bb[0], bb[1]);
          }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int64_t row = row0 + r0 + g + 8 * rr;
        const float e = expf(ci[rr]);
#pragma unroll
        for (int nt8 = 0; nt8 < NTP; ++nt8)
          store2(y + (row * H + h) * P + ps0 + 8 * nt8 + 2 * cq,
                 yi[rr][nt8].x + e * acc[nt8][2 * rr],
                 yi[rr][nt8].y + e * acc[nt8][2 * rr + 1]);
      }
    }

    if (kWhole || p.last(nt)) {
      __syncthreads();  // every read of h_prev's terms is done
      const float d = expf(dl);
#pragma unroll
      for (int k = 0; k < kMaxS; ++k) {
        const int e = tid + k * nthr;
        if (e < N * G4)
          put_h(e, carry(d, *reinterpret_cast<const float4*>(hs + 4 * e),
                         sreg[k]));
      }
      const float* sc = state_at(p.c);
      for (int e = tid + kMaxS * nthr; e < N * G4; e += nthr)
        put_h(e, carry(d, *reinterpret_cast<const float4*>(hs + 4 * e),
                       *reinterpret_cast<const float4*>(sc + (e / G4) * P +
                                                        (e % G4) * 4)));
    }
    if (q.c < nc) prefetch(q);
  }
  __syncthreads();
  for (int e = tid; e < N * PS; e += nthr) {
    const int n = e / PS, p = e % PS;
    final_state[(((int64_t)b * H + h) * N + n) * P + ps0 + p] = hs[e];
  }
}

template <typename TY, int PS>
cudaError_t launch_carry_tc(const void* y_intra, const void* states,
                            const void* cum, const void* cm, const void* init,
                            void* y, void* final_state, int B, int L, int H,
                            int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = carry_tc_smem_bytes(N, Q, PS);
  const auto kernel = Q <= kCarryTile ? ssd_carry_tc<TY, PS, true>
                                      : ssd_carry_tc<TY, PS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P / PS, H, B);
  kernel<<<grid, (carry_tile(Q) / 16) * 32, smem, stream>>>(
      static_cast<const float*>(y_intra), static_cast<const float*>(states),
      static_cast<const float*>(cum), static_cast<const bf16*>(cm),
      static_cast<const float*>(init), static_cast<TY*>(y),
      static_cast<float*>(final_state), L, H, P, N, Q);
  return cudaGetLastError();
}

template <typename TC, typename TY>
cudaError_t launch_carry(const void* y_intra, const void* states,
                         const void* cum, const void* cm, const void* init,
                         void* y, void* final_state, int B, int L, int H,
                         int P, int N, int Q, cudaStream_t stream) {
  // 16-column slices where P allows: every block reads all of C, so
  // wider slices read C from L2 fewer times over.
  const bool wide = P % 16 == 0;
  if (sizeof(TC) == 2 && Q % 16 == 0 && N % 16 == 0 &&
      carry_tc_smem_bytes(N, Q, wide ? 16 : 8) <= kMaxSmem) {
    if (wide)
      return launch_carry_tc<TY, 16>(y_intra, states, cum, cm, init, y,
                                     final_state, B, L, H, P, N, Q, stream);
    return launch_carry_tc<TY, 8>(y_intra, states, cum, cm, init, y,
                                  final_state, B, L, H, P, N, Q, stream);
  }
  if (wide)
    return launch_carry_ps<TC, TY, 16>(y_intra, states, cum, cm, init, y,
                                       final_state, B, L, H, P, N, Q, stream);
  return launch_carry_ps<TC, TY, 8>(y_intra, states, cum, cm, init, y,
                                    final_state, B, L, H, P, N, Q, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x, B and C; dt, cum, y and state
// are float32.  x [B, L, H, P], dt and cum [B, L, H], B and C [B, L, N],
// y [B, L, H, P], state [B, L / Q, H, N, P], all contiguous and 16-byte
// aligned.  terms = 0 runs the CUDA-core kernel; 1, 2 or 3 the
// tensor-core kernel with W and B ⊙ dec_end in that many bf16 terms
// (bf16 only, at Q = P = 64 and N = 64 or 128).
extern "C" int ssd_chunk_launch(const void* x, const void* dt,
                                const void* cum, const void* bm,
                                const void* cm, void* y, void* state,
                                int dtype, int B, int L, int H, int P, int N,
                                int Q, int terms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* cumf = static_cast<const float*>(cum);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  if (terms == 0) {
    if (dtype == 0)
      return (int)launch_f32<float>(x, dtf, cumf, bm, cm, yf, sf, B, L, H,
                                    P, N, Q, s);
    if (dtype == 1)
      return (int)launch_f32<bf16>(x, dtf, cumf, bm, cm, yf, sf, B, L, H, P,
                                   N, Q, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1 || Q != kQ || P != kP) return (int)cudaErrorInvalidValue;
  if (terms == 1)
    return (int)launch_tc<1>(x, dtf, cumf, bm, cm, yf, sf, B, L, H, N, s);
  if (terms == 2)
    return (int)launch_tc<2>(x, dtf, cumf, bm, cm, yf, sf, B, L, H, N, s);
  if (terms == 3)
    return (int)launch_tc<3>(x, dtf, cumf, bm, cm, yf, sf, B, L, H, N, s);
  return (int)cudaErrorInvalidValue;
}

// c_dtype: 0 = float32, 1 = bfloat16 for C; y_dtype likewise for y.
// y_intra [B, L, H, P] and states [B, L / Q, H, N, P] fp32, cum [B, L, H]
// fp32, C [B, L, N], init [B, H, N, P] fp32 or null, y [B, L, H, P],
// final_state [B, H, N, P] fp32; all contiguous and 16-byte aligned,
// Q at most 256, P and N multiples of 8.
extern "C" int ssd_carry_launch(const void* y_intra, const void* states,
                                const void* cum, const void* cm,
                                const void* init, void* y, void* final_state,
                                int c_dtype, int y_dtype, int B, int L, int H,
                                int P, int N, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q > 256 || P % 8 || N % 8) return (int)cudaErrorInvalidValue;
#define SSD_CARRY(TC, TY)                                                   \
  return (int)launch_carry<TC, TY>(y_intra, states, cum, cm, init, y,        \
                                   final_state, B, L, H, P, N, Q, s)
  if (c_dtype == 0 && y_dtype == 0) SSD_CARRY(float, float);
  if (c_dtype == 0 && y_dtype == 1) SSD_CARRY(float, bf16);
  if (c_dtype == 1 && y_dtype == 0) SSD_CARRY(bf16, float);
  if (c_dtype == 1 && y_dtype == 1) SSD_CARRY(bf16, bf16);
#undef SSD_CARRY
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of a block at chunk Q, state size N and
// head width P: the CUDA-core chunk kernel (which = 0), the carry on the
// CUDA cores with fp32 C (1) or bf16 C (2), the carry on the tensor cores
// (3), the carries at their 16-column slice; -1 for anything else.
extern "C" int ssd_smem_bytes(int which, int Q, int N, int P) {
  if (Q < 1 || N < 1 || P < 1) return -1;
  if (which == 0)
    return (int)(smem_floats(Q, N, P) * sizeof(float));
  if (which == 1) return (int)carry_smem_bytes(N, Q, 16, 4);
  if (which == 2) return (int)carry_smem_bytes(N, Q, 16, 2);
  if (which == 3) return (int)carry_tc_smem_bytes(N, Q, 16);
  return -1;
}
