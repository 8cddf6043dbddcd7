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
// in fp32 whatever the input type, as the reference does.  Five
// kernels, chosen by the wrapper (kernel.py's fwd_kernels):
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
// * ssd_chunk_tc_tiled (bf16 x, B and C at Q = 128, 192 or 256, P = 64, N
//   = 64 or 128: Mamba2's own chunk of 256 rows and the Pallas kernel's
//   chunk lengths), ssd_chunk_tc's arithmetic over 64 x 64 tiles.  At Q =
//   256 a warp's row of C . B^T would take 128 registers and C and B
//   alone 139 KB of shared memory, so the chunk is cut into row blocks of
//   kQ = 64 and the grid into tasks: per (chunk, group of G heads, batch)
//   one block of 4 warps for each row block I of y_intra, and one for each
//   64-row slice s of the chunk state (Q / 64 + N / 64 blocks a chunk, so
//   that at 2 x 4096 tokens the 32 chunks of 256 rows still give the card
//   hundreds of blocks).  A row task forms C_I . B_J^T for J <= I once for
//   its heads and keeps it in shared memory in fragment order (at most
//   64 KB), then streams each head's x tiles J <= I through a two-stage
//   cp.async ring, building each W tile in registers as ssd_chunk_tc does;
//   a state task keeps its slice of B for the whole chunk (36 KB) and reads
//   the A operand (B o dec_end)^T from it with ldmatrix.trans, scaling and
//   splitting it in registers.  Each output element is summed in one block
//   over J in order: deterministic.  At Q = 64 the grid would be the same
//   as ssd_chunk_tc's, which stays the kernel there.
//
//   Bound: bytes, as ssd_chunk_tc's; x is read by every row task at or
//   below its tiles and by the state tasks, from L2 after the first.
//
// * ssd_chunk_tf32 (fp32 x, B and C at Q = P = 64, N = 64 or 128: the
//   models' fp32 training and the reference sweep's N = 128 shape), on
//   the tensor cores with mma.sync m16n8k8 in TF32, ssd_chunk_tc's domain
//   and design with fp32 tiles: every product is three TF32 products
//   (each fp32 operand split into hi = its TF32 rounding and lo = the
//   rest; hi·hi + hi·lo + lo·hi, as the fp32 flash-attention kernels take
//   theirs), so that it meets the fp32 bar (1e-4·max|ref|) with ~0.005 of
//   it used (the CPU emulation, tests/_ssd_tf32.py; one TF32 product
//   misses it five-fold).  C . B^T is computed once per group of G heads
//   and kept in accumulator fragments; W goes from them to the next
//   product as the bf16 kernel's does, by reading an accumulator's
//   columns 2c, 2c + 1 as the k slots c, c + 4 and x's rows 2c, 2c + 1
//   into the same slots; the state's A operand is read from B itself,
//   each row scaled by its dec_end_j as it is read, so that one split of
//   each x fragment serves both products and no B ⊙ dec_end tile is
//   kept.  B, C and x rows are padded to 4 (mod 32) words, where both
//   the K-major reads (row g, column c) and the MN-major ones (rows 2c
//   and 2c + 1, column g) meet no bank twice.  G is the largest divisor
//   of H up to 16 that gives the fewest waves of two blocks an SM, each
//   weighed by its G + 1 heads' work (tf32_heads in ssd_mma.cuh; its
//   shared memory at N = 128, 114,688 bytes at G = 16, leaves room for
//   two blocks).
//
//   Bound: bytes, as ssd_chunk_tc's, with x read in fp32 (16 KB a head);
//   three TF32 products a product at the TF32 peak take about 0.4 of the
//   byte bound at mamba2-780m's heads.
//
// * ssd_chunk_tf32_tiled (fp32 x, B and C at Q = 128, 192 or 256, P = 64,
//   N = 64 or 128), ssd_chunk_tc_tiled's grid of row and state tasks with
//   ssd_chunk_tf32's arithmetic.  A row task forms C_I . B_J^T for J <= I
//   once for its heads, 64 columns of N at a time (fp32 pieces of C_I and
//   B_J, [64][68] each, in the region the x ring later takes), and keeps
//   it in fragment order (at most 64 KB); a state task keeps its fp32
//   slice of B for the whole chunk ([Q][68], 68 KB at Q = 256).  So a
//   block takes at most 108,544 bytes: two blocks an SM.  Heads a block
//   by tf32_heads over the tasks, two blocks an SM.
//
//   Bound: bytes, as ssd_chunk_tf32's.
//
// * ssd_chunk_kernel (every other shape, chunks of 1 to 256 rows, and
//   terms = 0 at any shape), on the CUDA cores: one
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
// ops.py:40-55).  For each (batch, head, slice of PS columns of P) it
// walks the chunks in order, keeping h_prev [N, PS] in fp32:
//
//   y[i][p] = y_intra[i][p] + exp(cum_i) * (C_i . h_prev)[p]   (x's dtype)
//   h       = exp(cum_last) * h + S_c
//
// and writes the final state in fp32 at the end; no [B, nc, H, N, P]
// stack of h_prev and no fp32 y_inter is ever written.  The walk takes
// each chunk in tiles of up to kCarryTile = 64 rows (the whole chunk when
// shorter), h updated after a chunk's last tile, so that a staged C tile
// is at most 64 rows at any chunk length up to 256.  16-column slices
// where P is a multiple of 16, else 8.  Three kernels, by C's dtype and
// the shape:
//
// * ssd_carry_tc (bf16 C, the serving path) and ssd_carry_tf32 (fp32 C,
//   the models' fp32 training), at Q and N multiples of 16 where the
//   layout fits a block; one walk, set out above carry_tc_walk:
//   warp-specialised, a producer warp keeping a ring of chunk states in
//   flight, chain warps advancing h in registers, MMA warps copying their
//   own tiles and computing C . h_prev on mma.sync (bf16: h_prev in three
//   exact bf16 terms, so the products are exact and the sums fp32; fp32:
//   TF32 m16n8k8, three TF32 products a product, h_prev in two TF32
//   planes and C split as read) and storing y off the chain; a
//   persistent grid whose slice width and ring depth follow the shape and
//   the card.
//   Its first design (one block per slice, all warps through each
//   tile's product and h's update in turn, one tile's loads in flight)
//   reached 38-41% of the byte bound.  On the CUDA cores the same walk
//   ran two shared-memory loads per eight multiply-adds and was limited
//   by instruction throughput (2.13 ms at the 32k prompt on the H100
//   against its 0.40 ms byte bound).
// * ssd_carry_kernel (every other shape: Q or N not a multiple of 16, as
//   the models' chunk of 50 rows): the CUDA cores, one block per slice.
//   C is transposed into fp32 ([N][tile rows], so that a thread's two rows
//   are one 8-byte read); each thread owns two rows of a tile and four
//   columns of y.  It copies the next tile's C with cp.async (double
//   buffer) and reads the next tile's y_intra and cum (and, at a chunk's
//   first tile, its state slice) into registers while it works on the
//   current one.  ssd_carry_core_launch runs it at any shape.
//
// Bound: bytes — y_intra and the chunk states read once (fp32), C and
// cum, y written in its dtype and the final state: about 1.3 GB, 0.40 ms
// at 3.35 TB/s, for the 1 x 32,768-token prompt of zamba2-1.2b.
//
// The mma.sync, ldmatrix and cp.async helpers are in ssd_mma.cuh, which
// the backward (ssd_bwd.cu) includes too.

#include <array>
#include <map>
#include <mutex>

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
// Tensor-core chunk kernel over 64 x 64 tiles (bf16, Q = 128, 192, 256)
// ---------------------------------------------------------------------------

constexpr int kTiledMaxQ = 256;   // four row blocks of kQ
constexpr int kTiledTerms = 2;    // bf16 terms of W and B o dec_end
                                  // (kernel.py's TERMS)
constexpr int kLdSlice = kQ + 8;  // padded bf16 row of a 64-column slice
                                  // of B

// Shared memory of ssd_chunk_tc_tiled (bytes), whichever task a block
// takes: region 0, the C . B^T fragments of a row task ([Q / kQ] tiles of
// [4 warps][8 n-tiles][32 lanes] float4) or a state task's slice of B
// ([Q][kLdSlice] bf16, smaller); region 1, a row task's C_I and B_J
// ([kQ][N + 8] bf16 each) while it forms C . B^T, then the ring of two x tiles
// ([kQ][kLdP] bf16) both tasks stream; and dt and cum of the chunk for two
// heads ([2][2][Q] fp32).  kernel.py's chunk_tiled_smem_bytes is the same
// sum.
struct TiledSmem {
  size_t cb, r1, dtc, total;
  __host__ __device__ TiledSmem(int N, int Q) {
    const size_t setup = 2 * (size_t)kQ * (N + 8) * 2;
    const size_t ring = 2 * (size_t)kQ * kLdP * 2;
    cb = 0;
    r1 = (size_t)(Q / kQ) * 4 * 8 * 32 * 16;
    dtc = r1 + (setup > ring ? setup : ring);
    total = dtc + 4 * (size_t)Q * 4;
  }
};

// dt and cum of head h over the chunk's Q rows into dst ([Q] dt, then [Q]
// cum), 4-byte cp.async copies (the rows are H floats apart).
__device__ __forceinline__ void load_dtcum(float* dst, const float* dt,
                                           const float* cum, int64_t row0,
                                           int H, int h, int Q) {
  for (int e = threadIdx.x; e < 2 * Q; e += kTcThreads) {
    const int j = e < Q ? e : e - Q;
    cp_async4(dst + e, (e < Q ? dt : cum) + (row0 + j) * H + h);
  }
}

// x's B fragments for k16 step kk of a [kQ][kLdP] bf16 tile (ldmatrix
// .trans): xf[pt] for columns 8 pt .. 8 pt + 7.
__device__ __forceinline__ void x_frags(uint32_t (&xf)[8][2], const bf16* xb,
                                        int kk, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t r[4];
    ldsm_x4_t(r, xb + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdP +
                     16 * np + (lane >> 4) * 8);
    xf[2 * np][0] = r[0];
    xf[2 * np][1] = r[1];
    xf[2 * np + 1][0] = r[2];
    xf[2 * np + 1][1] = r[3];
  }
}

// A row task: rows I kQ .. of y_intra for the block's G heads.  C_I . B_J^T
// for J <= I is formed once (bf16 inputs, exact products, fp32 sums: warp w
// its rows 16 w .. against all 64 columns, as ssd_chunk_tc) and kept in
// shared memory in fragment order (one float4 a lane and n-tile); then for
// each head the x tiles J = 0 .. I stream through the ring and each W tile
// is built in registers from those fragments, exp(cum_i - cum_j) and dt_j
// (a plain 0 above the diagonal of J = I, whose k16 steps above it are
// skipped), split into NT bf16 terms and multiplied with x_J, y summed over
// J in order in one accumulator.
template <int N, int NT>
__device__ __forceinline__ void chunk_tiled_rows(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cum, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, float* __restrict__ y,
    unsigned char* smem_raw, int L, int H, int G, int Q, int I) {
  constexpr int kLdN = N + 8;
  const TiledSmem lay(N, Q);
  float4* cbs = reinterpret_cast<float4*>(smem_raw + lay.cb);
  bf16* cs = reinterpret_cast<bf16*>(smem_raw + lay.r1);   // C_I
  bf16* bs = cs + kQ * kLdN;                               // B_J
  bf16* xr = reinterpret_cast<bf16*>(smem_raw + lay.r1);   // 2 x [kQ][kLdP]
  float* dtc = reinterpret_cast<float*>(smem_raw + lay.dtc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int nb = Q / kQ;
  const int c = blockIdx.x / (nb + N / 64), h0 = blockIdx.y * G;
  const int b = blockIdx.z;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int i0 = 16 * warp;

  for (int e = tid; e < kQ * (N / 8); e += kTcThreads) {
    const int j = e / (N / 8), k8 = (e % (N / 8)) * 8;
    cp_async16(cs + j * kLdN + k8, cm + (row0 + kQ * I + j) * N + k8);
  }
  load_dtcum(dtc, dt, cum, row0, H, h0, Q);
  for (int J = 0; J <= I; ++J) {
    for (int e = tid; e < kQ * (N / 8); e += kTcThreads) {
      const int j = e / (N / 8), k8 = (e % (N / 8)) * 8;
      cp_async16(bs + j * kLdN + k8, bm + (row0 + kQ * J + j) * N + k8);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
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
        if (J == I && jp > warp) continue;   // above the diagonal
        uint32_t r[4];
        ldsm_x4(r, bs + (16 * jp + (lane & 7) + (lane >> 4) * 8) * kLdN +
                       kn * 16 + ((lane >> 3) & 1) * 8);
        mma(cb[2 * jp], a, r[0], r[1]);
        mma(cb[2 * jp + 1], a, r[2], r[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      cbs[((J * 4 + warp) * 8 + nt) * 32 + lane] =
          make_float4(cb[nt][0], cb[nt][1], cb[nt][2], cb[nt][3]);
    __syncthreads();   // every warp is done with B_J (and, at the end, C_I)
  }

  load_x(xr, x, row0, H, h0);
  cp_async_commit();
  int seq = 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = h0 + gi;
    const float* dg = dtc + (gi & 1) * 2 * Q;
    const float* cg = dg + Q;
    float yacc[8][4];
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.f;
    for (int J = 0; J <= I; ++J, ++seq) {
      // x_J of head gi (and its dt and cum) has landed; every warp is done
      // with the ring stage and the dt, cum buffer refilled below.
      cp_async_wait_all();
      __syncthreads();
      if (J == 0 && gi + 1 < G)
        load_dtcum(dtc + ((gi + 1) & 1) * 2 * Q, dt, cum, row0, H, h + 1, Q);
      if (J < I || gi + 1 < G)
        load_x(xr + ((seq + 1) & 1) * kQ * kLdP, x,
               row0 + kQ * (J < I ? J + 1 : 0), H, J < I ? h : h + 1);
      cp_async_commit();
      const bf16* xb = xr + (seq & 1) * kQ * kLdP;
      const float ci[2] = {cg[kQ * I + i0 + g], cg[kQ * I + i0 + g + 8]};
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        if (J == I && kk > warp) continue;   // k16 steps above the diagonal
        uint32_t xf[8][2];
        x_frags(xf, xb, kk, lane);
        uint32_t wa[NT][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 cb4 = cbs[((J * 4 + warp) * 8 + 2 * kk + half) * 32 +
                                 lane];
          const float cbv[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
          const int j = 16 * kk + 8 * half + 2 * cq;   // within the tile
          const float cj[2] = {cg[kQ * J + j], cg[kQ * J + j + 1]};
          const float dj[2] = {dg[kQ * J + j], dg[kQ * J + j + 1]};
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = i0 + g + 8 * rr;
            float w[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              w[e] = (J < I || i >= j + e)
                         ? cbv[2 * rr + e] * expf(ci[rr] - cj[e]) * dj[e]
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
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* yr = y + ((row0 + kQ * I + i0 + g + 8 * rr) * H + h) * kP +
                  2 * cq;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
        *reinterpret_cast<float2*>(yr + 8 * pt) =
            make_float2(yacc[pt][2 * rr], yacc[pt][2 * rr + 1]);
    }
  }
}

// A state task: rows 64 s .. of the chunk state for the block's G heads.
// The slice of B (every row of the chunk, columns 64 s ..) is staged once;
// for each head the x tiles J = 0 .. nb - 1 stream through the ring, and
// per k16 step the A operand (B o dec_end)^T is read with ldmatrix.trans
// from B as stored, each column j scaled by dec_end_j = exp(cum_last -
// cum_j) dt_j in registers and split into NT bf16 terms, then multiplied
// with x_J; the state sums J in order in one accumulator.
template <int N, int NT>
__device__ __forceinline__ void chunk_tiled_state(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cum, const bf16* __restrict__ bm,
    float* __restrict__ state, unsigned char* smem_raw, int L, int H, int G,
    int Q, int s) {
  const TiledSmem lay(N, Q);
  bf16* bsl = reinterpret_cast<bf16*>(smem_raw + lay.cb);   // [Q][kLdSlice]
  bf16* xr = reinterpret_cast<bf16*>(smem_raw + lay.r1);
  float* dtc = reinterpret_cast<float*>(smem_raw + lay.dtc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int nb = Q / kQ;
  const int c = blockIdx.x / (nb + N / 64), h0 = blockIdx.y * G;
  const int b = blockIdx.z;
  const int nc = L / Q;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int i0 = 16 * warp;

  for (int e = tid; e < Q * (kQ / 8); e += kTcThreads) {
    const int j = e / (kQ / 8), k8 = (e % (kQ / 8)) * 8;
    cp_async16(bsl + j * kLdSlice + k8, bm + (row0 + j) * N + kQ * s + k8);
  }
  load_dtcum(dtc, dt, cum, row0, H, h0, Q);
  load_x(xr, x, row0, H, h0);
  cp_async_commit();
  int seq = 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = h0 + gi;
    const float* dg = dtc + (gi & 1) * 2 * Q;
    const float* cg = dg + Q;
    float sacc[8][4];
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[pt][e] = 0.f;
    for (int J = 0; J < nb; ++J, ++seq) {
      cp_async_wait_all();
      __syncthreads();
      if (J == 0 && gi + 1 < G)
        load_dtcum(dtc + ((gi + 1) & 1) * 2 * Q, dt, cum, row0, H, h + 1, Q);
      if (J + 1 < nb || gi + 1 < G)
        load_x(xr + ((seq + 1) & 1) * kQ * kLdP, x,
               row0 + kQ * (J + 1 < nb ? J + 1 : 0), H,
               J + 1 < nb ? h : h + 1);
      cp_async_commit();
      const bf16* xb = xr + (seq & 1) * kQ * kLdP;
      const float cl = cg[Q - 1];
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        uint32_t xf[8][2];
        x_frags(xf, xb, kk, lane);
        // dec_end of the step's columns j, j + 1 (a[0], a[1]) and j + 8,
        // j + 9 (a[2], a[3]).
        const int j = kQ * J + 16 * kk + 2 * cq;
        float de[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jj = j + (u & 1) + 8 * (u >> 1);
          de[u] = expf(cl - cg[jj]) * dg[jj];
        }
        uint32_t a[4];
        ldsm_x4_t(a, bsl + (kQ * J + 16 * kk + (lane & 7) + (lane >> 4) * 8) *
                               kLdSlice +
                         i0 + ((lane >> 3) & 1) * 8);
        uint32_t sa[NT][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = unpack2(a[q]);
          uint32_t t[NT];
          split<NT>(v.x * de[2 * (q >> 1)], v.y * de[2 * (q >> 1) + 1], t);
#pragma unroll
          for (int k = 0; k < NT; ++k) sa[k][q] = t[k];
        }
#pragma unroll
        for (int k = 0; k < NT; ++k)
#pragma unroll
          for (int pt = 0; pt < 8; ++pt)
            mma(sacc[pt], sa[k], xf[pt][0], xf[pt][1]);
      }
    }
    float* st = state + (((int64_t)b * nc + c) * H + h) * (int64_t)N * kP;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* sr = st + (kQ * s + i0 + g + 8 * rr) * kP + 2 * cq;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
        *reinterpret_cast<float2*>(sr + 8 * pt) =
            make_float2(sacc[pt][2 * rr], sacc[pt][2 * rr + 1]);
    }
  }
}

// One block of 4 warps per (chunk, task, group of G heads, batch): tasks 0
// .. nb - 1 the row blocks of y_intra, tasks nb .. nb + N / 64 - 1 the
// 64-row slices of the chunk state.  Every output element is summed by one
// block in a fixed order: no atomics, two passes equal bit for bit.
template <int N, int NT>
__global__ void __launch_bounds__(kTcThreads)
    ssd_chunk_tc_tiled(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ cum,
                       const bf16* __restrict__ bm,
                       const bf16* __restrict__ cm, float* __restrict__ y,
                       float* __restrict__ state, int L, int H, int G, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = Q / kQ;
  const int task = blockIdx.x % (nb + N / 64);
  if (task < nb)
    chunk_tiled_rows<N, NT>(x, dt, cum, bm, cm, y, smem_raw, L, H, G, Q,
                            task);
  else
    chunk_tiled_state<N, NT>(x, dt, cum, bm, state, smem_raw, L, H, G, Q,
                             task - nb);
}

template <int N, int NT>
cudaError_t launch_tiled_n(const void* x, const float* dt, const float* cum,
                           const void* bm, const void* cm, float* y,
                           float* state, int B, int L, int H, int Q,
                           cudaStream_t stream) {
  const int nc = L / Q, tasks = Q / kQ + N / 64;
  const int G = heads_per_block(B * nc * tasks, H);
  const size_t smem = TiledSmem(N, Q).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tc_tiled<N, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nc * tasks, H / G, B);
  ssd_chunk_tc_tiled<N, NT><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), dt, cum, static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), y, state, L, H, G, Q);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_tiled(const void* x, const float* dt, const float* cum,
                         const void* bm, const void* cm, float* y,
                         float* state, int B, int L, int H, int N, int Q,
                         cudaStream_t stream) {
  if (Q % kQ || Q <= kQ || Q > kTiledMaxQ) return cudaErrorInvalidValue;
  if (N == 64)
    return launch_tiled_n<64, NT>(x, dt, cum, bm, cm, y, state, B, L, H, Q,
                                  stream);
  if (N == 128)
    return launch_tiled_n<128, NT>(x, dt, cum, bm, cm, y, state, B, L, H, Q,
                                   stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core chunk kernel (fp32: TF32, three products a product)
// ---------------------------------------------------------------------------

// TF32 products a product (hi·hi + hi·lo + lo·hi): the terms argument
// that asks the entry point for ssd_chunk_tf32 (kernel.py's TF32_TERMS).
constexpr int kTf32Terms = 3;
constexpr int kLdX32 = kP + 4;   // padded fp32 row of x: 68 words, 4 (mod
                                 // 32), so that rows 2c and 2c + 1 at
                                 // column g meet no bank twice

// Shared memory of ssd_chunk_tf32 (bytes): C and B [kQ][N + 4] (also 4
// (mod 32) words a row), two x buffers [kQ][kLdX32], all fp32; dt, cum and
// dec_end [G][kQ].  kernel.py's chunk_tf32_smem_bytes is the same sum.
size_t tf32_smem_bytes(int N, int G) {
  return 4 * (2 * (size_t)kQ * (N + 4) + 2 * (size_t)kQ * kLdX32 +
              3 * (size_t)G * kQ);
}

// x of one head, [kQ][kP] fp32, into a padded shared buffer.
__device__ __forceinline__ void load_x32(float* dst, const float* x,
                                         int64_t row0, int H, int h) {
  for (int e = threadIdx.x; e < kQ * (kP / 4); e += kTcThreads) {
    const int j = e / (kP / 4), k4 = (e % (kP / 4)) * 4;
    cp_async16(dst + j * kLdX32 + k4, x + ((row0 + j) * H + h) * kP + k4);
  }
}

// C . B^T for the warp's rows i0.. against the first NT n-tiles of B (8
// columns j each: the tiles at or below the diagonal), in three TF32
// products: cb[nt] is the m16n8 tile of columns 8 nt .. 8 nt + 7.
template <int N, int NT>
__device__ __forceinline__ void cb_tf32(float (&cb)[8][4], const float* cs,
                                        const float* bs, int i0, int g,
                                        int cq) {
  constexpr int kLdN = N + 4;
#pragma unroll 2
  for (int kn = 0; kn < N / 8; ++kn) {
    const float* cr = cs + (i0 + g) * kLdN + 8 * kn + cq;
    const Tf32A a(cr[0], cr[8 * kLdN], cr[4], cr[8 * kLdN + 4]);
    Tf32B bt[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* br = bs + (8 * nt + g) * kLdN + 8 * kn + cq;
      bt[nt] = Tf32B(br[0], br[4]);
    }
    mma3<NT>(cb, 0, a, bt);
  }
}

// One block of 4 warps per (chunk, group of G heads, batch), as
// ssd_chunk_tc: B and C staged once with cp.async and C . B^T computed
// once, each warp keeping its 16 rows i of it in accumulator fragments for
// all G heads.  For each head, x is staged one head ahead (double buffer);
// per k8 step of j, W = (C . B^T) o exp(cum_i - cum_j) o dt_j is built in
// registers from the accumulator (its columns 2c and 2c + 1 as the slots c
// and c + 4; exp only at i >= j, a plain 0 above the diagonal) and
// multiplied with x (rows 2c and 2c + 1 of the step at column g: the same
// slots), and the state's A operand, B^T o dec_end, is read straight from
// B (rows 2c and 2c + 1 of the step, each scaled by its dec_end_j as it is
// read: no B o dec_end tile), so that one split of x's fragment serves
// both products.  Warp w takes rows 16 w.. of y (k8 steps up to its
// diagonal) and rows 64 s + 16 w.. of the state (all 8 steps).
template <int N>
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_chunk_tf32(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ cum, const float* __restrict__ bm,
                   const float* __restrict__ cm, float* __restrict__ y,
                   float* __restrict__ state, int L, int H, int G) {
  constexpr int kLdN = N + 4;
  constexpr int kPass = N / 64;     // state row tiles of 16 per warp
  extern __shared__ __align__(16) float smf[];
  float* cs = smf;                       // [kQ][kLdN]
  float* bs = cs + kQ * kLdN;            // [kQ][kLdN]
  float* xs = bs + kQ * kLdN;            // 2 x [kQ][kLdX32]
  float* dts = xs + 2 * kQ * kLdX32;     // [G][kQ]
  float* cums = dts + G * kQ;            // [G][kQ]
  float* des = cums + G * kQ;            // [G][kQ]: dec_end_j = exp(cum_last
                                         //   - cum_j) dt_j

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int c = blockIdx.x, h0 = blockIdx.y * G, b = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * kQ;
  const int i0 = 16 * warp;

  for (int e = tid; e < kQ * (N / 4); e += kTcThreads) {
    const int j = e / (N / 4), k4 = (e % (N / 4)) * 4;
    cp_async16(cs + j * kLdN + k4, cm + (row0 + j) * N + k4);
    cp_async16(bs + j * kLdN + k4, bm + (row0 + j) * N + k4);
  }
  load_x32(xs, x, row0, H, h0);
  cp_async_commit();
  for (int e = tid; e < kQ * G; e += kTcThreads) {
    const int j = e / G, gi = e % G;
    dts[gi * kQ + j] = dt[(row0 + j) * H + h0 + gi];
    cums[gi * kQ + j] = cum[(row0 + j) * H + h0 + gi];
  }
  __syncthreads();
  for (int e = tid; e < kQ * G; e += kTcThreads)
    des[e] = expf(cums[(e / kQ) * kQ + kQ - 1] - cums[e]) * dts[e];
  cp_async_wait_all();
  __syncthreads();

  float cb[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[nt][e] = 0.f;
  // Only the n-tiles at or below the warp's diagonal: 2 (w + 1) of them.
  if (warp == 0) cb_tf32<N, 2>(cb, cs, bs, i0, g, cq);
  else if (warp == 1) cb_tf32<N, 4>(cb, cs, bs, i0, g, cq);
  else if (warp == 2) cb_tf32<N, 6>(cb, cs, bs, i0, g, cq);
  else cb_tf32<N, 8>(cb, cs, bs, i0, g, cq);

  for (int gi = 0; gi < G; ++gi) {
    const int h = h0 + gi;
    const float* xb = xs + (gi & 1) * kQ * kLdX32;
    const float* cg = cums + gi * kQ;
    const float* dg = dts + gi * kQ;
    const float* eg = des + gi * kQ;
    // x(gi) has landed; every warp is done with head gi - 1's x buffer.
    cp_async_wait_all();
    __syncthreads();
    if (gi + 1 < G)
      load_x32(xs + ((gi + 1) & 1) * kQ * kLdX32, x, row0, H, h + 1);
    cp_async_commit();

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
    for (int kt = 0; kt < kQ / 8; ++kt) {
      const int j = 8 * kt + 2 * cq;   // slots c and c + 4: j and j + 1
      const bool diag = kt < 2 * warp + 2;   // a W tile at or below it
      Tf32A wa;
      if (diag) {
        const float cj[2] = {cg[j], cg[j + 1]};
        const float dj[2] = {dg[j], dg[j + 1]};
        float w[2][2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i0 + g + 8 * rr;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            w[rr][e] = i >= j + e ? cb[kt][2 * rr + e] *
                                        expf(ci[rr] - cj[e]) * dj[e]
                                  : 0.f;
        }
        wa = Tf32A(w[0][0], w[1][0], w[0][1], w[1][1]);
      }
      Tf32A sa[kPass];
      {
        const float d0 = eg[j], d1 = eg[j + 1];
#pragma unroll
        for (int s = 0; s < kPass; ++s) {
          const float* br = bs + j * kLdN + 64 * s + i0 + g;
          sa[s] = Tf32A(br[0] * d0, br[8] * d0, br[kLdN] * d1,
                        br[kLdN + 8] * d1);
        }
      }
#pragma unroll
      for (int p0 = 0; p0 < 8; p0 += 4) {
        Tf32B xf[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* xr = xb + j * kLdX32 + 8 * (p0 + u) + g;
          xf[u] = Tf32B(xr[0], xr[kLdX32]);
        }
        if (diag) mma3<4>(yacc, p0, wa, xf);
#pragma unroll
        for (int s = 0; s < kPass; ++s) mma3<4>(sacc[s], p0, sa[s], xf);
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

// Heads per ssd_chunk_tf32 block: tf32_heads with two blocks an SM (its
// shared memory at N = 128 and 16 heads leaves room for two), on a card
// of `sms` SMs.
int tf32_heads_per_block(int pairs, int H, int sms) {
  return tf32_heads(pairs, H, 2 * sms);
}

template <int N>
cudaError_t launch_tf32_n(const void* x, const float* dt, const float* cum,
                          const void* bm, const void* cm, float* y,
                          float* state, int B, int L, int H,
                          cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nc = L / kQ;
  const int G = tf32_heads_per_block(B * nc, H, sms);
  const size_t smem = tf32_smem_bytes(N, G);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_chunk_tf32<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nc, H / G, B);
  ssd_chunk_tf32<N><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, cum, static_cast<const float*>(bm),
      static_cast<const float*>(cm), y, state, L, H, G);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core chunk kernel over 64 x 64 tiles (fp32: TF32, Q = 128, 192, 256)
// ---------------------------------------------------------------------------

constexpr int kLdPiece = kQ + 4;   // padded fp32 row of a 64-column piece
                                   // of B or C, or of x (= kLdX32): 4 (mod
                                   // 32) words

// Shared memory of ssd_chunk_tf32_tiled (bytes), whichever task a block
// takes: region 0, the C . B^T fragments of a row task ([Q / kQ] tiles of
// [4 warps][8 n-tiles][32 lanes] float4) or a state task's fp32 slice of
// B ([Q][kLdPiece], larger); region 1, a row task's 64-column pieces of
// C_I and B_J ([kQ][kLdPiece] fp32 each) while it forms C . B^T, then the
// ring of two x tiles ([kQ][kLdX32] fp32, the same size) both tasks
// stream; and dt and cum of the chunk for two heads ([2][2][Q] fp32).
// kernel.py's chunk_tf32_tiled_smem_bytes is the same sum.
struct Tf32TiledSmem {
  size_t cb, r1, dtc, total;
  __host__ __device__ Tf32TiledSmem(int Q) {
    const size_t frags = (size_t)(Q / kQ) * 4 * 8 * 32 * 16;
    const size_t slice = (size_t)Q * kLdPiece * 4;
    cb = 0;
    r1 = frags > slice ? frags : slice;
    dtc = r1 + 2 * (size_t)kQ * kLdPiece * 4;
    total = dtc + 4 * (size_t)Q * 4;
  }
};

// A row task: rows I kQ .. of y_intra for the block's G heads, as
// chunk_tiled_rows with ssd_chunk_tf32's arithmetic.  C_I . B_J^T for J <=
// I is formed once, in three TF32 products, one 64-column piece of N at a
// time (the accumulators kept in shared memory in fragment order between
// pieces, so that the sum over n is the one an unbroken walk gives); then
// for each head the x tiles J = 0 .. I stream through the ring and per k8
// step W is built in registers from the fragments (columns 2c, 2c + 1 as
// the slots c, c + 4; exp only at i >= j, a plain 0 above the diagonal of
// J = I, whose k8 steps above it are skipped) and multiplied with x_J's
// rows 2c, 2c + 1, y summed over J in order in one accumulator.
template <int N>
__device__ __forceinline__ void chunk_tf32_tiled_rows(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cum, const float* __restrict__ bm,
    const float* __restrict__ cm, float* __restrict__ y,
    unsigned char* smem_raw, int L, int H, int G, int Q, int I) {
  const Tf32TiledSmem lay(Q);
  float4* cbs = reinterpret_cast<float4*>(smem_raw + lay.cb);
  float* cs = reinterpret_cast<float*>(smem_raw + lay.r1);   // C_I piece
  float* bs = cs + kQ * kLdPiece;                            // B_J piece
  float* xr = reinterpret_cast<float*>(smem_raw + lay.r1);   // 2 x [kQ][kLdX32]
  float* dtc = reinterpret_cast<float*>(smem_raw + lay.dtc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int nb = Q / kQ;
  const int c = blockIdx.x / (nb + N / 64), h0 = blockIdx.y * G;
  const int b = blockIdx.z;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int i0 = 16 * warp;
  // The n-tiles of C . B^T at or below the warp's diagonal in tile I.
  const int diag_tiles = 2 * warp + 2;

  load_dtcum(dtc, dt, cum, row0, H, h0, Q);
  for (int kn = 0; kn < N / 64; ++kn) {
    for (int e = tid; e < kQ * (kQ / 4); e += kTcThreads) {
      const int j = e / (kQ / 4), k4 = (e % (kQ / 4)) * 4;
      cp_async16(cs + j * kLdPiece + k4,
                 cm + (row0 + kQ * I + j) * N + 64 * kn + k4);
    }
    for (int J = 0; J <= I; ++J) {
      for (int e = tid; e < kQ * (kQ / 4); e += kTcThreads) {
        const int j = e / (kQ / 4), k4 = (e % (kQ / 4)) * 4;
        cp_async16(bs + j * kLdPiece + k4,
                   bm + (row0 + kQ * J + j) * N + 64 * kn + k4);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      float cb[8][4];
      float4* frag = cbs + (J * 4 + warp) * 8 * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 v = kn ? frag[nt * 32] : make_float4(0.f, 0.f, 0.f, 0.f);
        cb[nt][0] = v.x;
        cb[nt][1] = v.y;
        cb[nt][2] = v.z;
        cb[nt][3] = v.w;
      }
      if (J < I) cb_tf32<64, 8>(cb, cs, bs, i0, g, cq);
      else if (warp == 0) cb_tf32<64, 2>(cb, cs, bs, i0, g, cq);
      else if (warp == 1) cb_tf32<64, 4>(cb, cs, bs, i0, g, cq);
      else if (warp == 2) cb_tf32<64, 6>(cb, cs, bs, i0, g, cq);
      else cb_tf32<64, 8>(cb, cs, bs, i0, g, cq);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        frag[nt * 32] = make_float4(cb[nt][0], cb[nt][1], cb[nt][2], cb[nt][3]);
      __syncthreads();   // every warp is done with B_J (and, at the end, C_I)
    }
  }

  load_x32(xr, x, row0, H, h0);
  cp_async_commit();
  int seq = 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = h0 + gi;
    const float* dg = dtc + (gi & 1) * 2 * Q;
    const float* cg = dg + Q;
    float yacc[8][4];
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.f;
    for (int J = 0; J <= I; ++J, ++seq) {
      // x_J of head gi (and its dt and cum) has landed; every warp is done
      // with the ring stage and the dt, cum buffer refilled below.
      cp_async_wait_all();
      __syncthreads();
      if (J == 0 && gi + 1 < G)
        load_dtcum(dtc + ((gi + 1) & 1) * 2 * Q, dt, cum, row0, H, h + 1, Q);
      if (J < I || gi + 1 < G)
        load_x32(xr + ((seq + 1) & 1) * kQ * kLdX32, x,
                 row0 + kQ * (J < I ? J + 1 : 0), H, J < I ? h : h + 1);
      cp_async_commit();
      const float* xb = xr + (seq & 1) * kQ * kLdX32;
      const float4* frag = cbs + (J * 4 + warp) * 8 * 32 + lane;
      const float ci[2] = {cg[kQ * I + i0 + g], cg[kQ * I + i0 + g + 8]};
#pragma unroll
      for (int kt = 0; kt < kQ / 8; ++kt) {
        if (J == I && kt >= diag_tiles) continue;   // above the diagonal
        const int j = 8 * kt + 2 * cq;   // slots c and c + 4: j and j + 1
        const float4 cb4 = frag[kt * 32];
        const float cbv[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
        const float cj[2] = {cg[kQ * J + j], cg[kQ * J + j + 1]};
        const float dj[2] = {dg[kQ * J + j], dg[kQ * J + j + 1]};
        float w[2][2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i0 + g + 8 * rr;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            w[rr][e] = (J < I || i >= j + e)
                           ? cbv[2 * rr + e] * expf(ci[rr] - cj[e]) * dj[e]
                           : 0.f;
        }
        const Tf32A wa(w[0][0], w[1][0], w[0][1], w[1][1]);
#pragma unroll
        for (int p0 = 0; p0 < 8; p0 += 4) {
          Tf32B xf[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* xp = xb + j * kLdX32 + 8 * (p0 + u) + g;
            xf[u] = Tf32B(xp[0], xp[kLdX32]);
          }
          mma3<4>(yacc, p0, wa, xf);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* yr = y + ((row0 + kQ * I + i0 + g + 8 * rr) * H + h) * kP +
                  2 * cq;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
        *reinterpret_cast<float2*>(yr + 8 * pt) =
            make_float2(yacc[pt][2 * rr], yacc[pt][2 * rr + 1]);
    }
  }
}

// A state task: rows 64 s .. of the chunk state for the block's G heads.
// The fp32 slice of B (every row of the chunk, columns 64 s ..) is staged
// once; for each head the x tiles J = 0 .. nb - 1 stream through the ring,
// and per k8 step the A operand (B o dec_end)^T is read from B as stored
// (rows j and j + 1 of the step as the slots c and c + 4, column i), each
// row scaled by its dec_end_j = exp(cum_last - cum_j) dt_j as it is read,
// and multiplied with x_J's rows j, j + 1 in the same slots; the state
// sums J in order in one accumulator.
template <int N>
__device__ __forceinline__ void chunk_tf32_tiled_state(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cum, const float* __restrict__ bm,
    float* __restrict__ state, unsigned char* smem_raw, int L, int H, int G,
    int Q, int s) {
  const Tf32TiledSmem lay(Q);
  float* bsl = reinterpret_cast<float*>(smem_raw + lay.cb);  // [Q][kLdPiece]
  float* xr = reinterpret_cast<float*>(smem_raw + lay.r1);
  float* dtc = reinterpret_cast<float*>(smem_raw + lay.dtc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int nb = Q / kQ;
  const int c = blockIdx.x / (nb + N / 64), h0 = blockIdx.y * G;
  const int b = blockIdx.z;
  const int nc = L / Q;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int i0 = 16 * warp;

  for (int e = tid; e < Q * (kQ / 4); e += kTcThreads) {
    const int j = e / (kQ / 4), k4 = (e % (kQ / 4)) * 4;
    cp_async16(bsl + j * kLdPiece + k4, bm + (row0 + j) * N + kQ * s + k4);
  }
  load_dtcum(dtc, dt, cum, row0, H, h0, Q);
  load_x32(xr, x, row0, H, h0);
  cp_async_commit();
  int seq = 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = h0 + gi;
    const float* dg = dtc + (gi & 1) * 2 * Q;
    const float* cg = dg + Q;
    float sacc[8][4];
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[pt][e] = 0.f;
    for (int J = 0; J < nb; ++J, ++seq) {
      cp_async_wait_all();
      __syncthreads();
      if (J == 0 && gi + 1 < G)
        load_dtcum(dtc + ((gi + 1) & 1) * 2 * Q, dt, cum, row0, H, h + 1, Q);
      if (J + 1 < nb || gi + 1 < G)
        load_x32(xr + ((seq + 1) & 1) * kQ * kLdX32, x,
                 row0 + kQ * (J + 1 < nb ? J + 1 : 0), H,
                 J + 1 < nb ? h : h + 1);
      cp_async_commit();
      const float* xb = xr + (seq & 1) * kQ * kLdX32;
      const float cl = cg[Q - 1];
#pragma unroll
      for (int kt = 0; kt < kQ / 8; ++kt) {
        const int j = 8 * kt + 2 * cq;   // within the tile
        const int jq = kQ * J + j;       // within the chunk
        const float d0 = expf(cl - cg[jq]) * dg[jq];
        const float d1 = expf(cl - cg[jq + 1]) * dg[jq + 1];
        const float* br = bsl + jq * kLdPiece + i0 + g;
        const Tf32A sa(br[0] * d0, br[8] * d0, br[kLdPiece] * d1,
                       br[kLdPiece + 8] * d1);
#pragma unroll
        for (int p0 = 0; p0 < 8; p0 += 4) {
          Tf32B xf[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* xp = xb + j * kLdX32 + 8 * (p0 + u) + g;
            xf[u] = Tf32B(xp[0], xp[kLdX32]);
          }
          mma3<4>(sacc, p0, sa, xf);
        }
      }
    }
    float* st = state + (((int64_t)b * nc + c) * H + h) * (int64_t)N * kP;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* sr = st + (kQ * s + i0 + g + 8 * rr) * kP + 2 * cq;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
        *reinterpret_cast<float2*>(sr + 8 * pt) =
            make_float2(sacc[pt][2 * rr], sacc[pt][2 * rr + 1]);
    }
  }
}

// One block of 4 warps per (chunk, task, group of G heads, batch), as
// ssd_chunk_tc_tiled: tasks 0 .. nb - 1 the row blocks of y_intra, tasks
// nb .. nb + N / 64 - 1 the 64-row slices of the chunk state.  Every
// output element is summed by one block in a fixed order: no atomics, two
// passes equal bit for bit.
template <int N>
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_chunk_tf32_tiled(const float* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ cum,
                         const float* __restrict__ bm,
                         const float* __restrict__ cm, float* __restrict__ y,
                         float* __restrict__ state, int L, int H, int G,
                         int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = Q / kQ;
  const int task = blockIdx.x % (nb + N / 64);
  if (task < nb)
    chunk_tf32_tiled_rows<N>(x, dt, cum, bm, cm, y, smem_raw, L, H, G, Q,
                             task);
  else
    chunk_tf32_tiled_state<N>(x, dt, cum, bm, state, smem_raw, L, H, G, Q,
                              task - nb);
}

// Heads per ssd_chunk_tf32_tiled block: tf32_heads over its tasks with two
// blocks an SM (its shared memory at Q = 256 leaves room for two), on a
// card of `sms` SMs.
int tf32_tiled_heads_per_block(int pairs, int Q, int N, int H, int sms) {
  return tf32_heads(pairs * (Q / kQ + N / 64), H, 2 * sms);
}

template <int N>
cudaError_t launch_tf32_tiled_n(const void* x, const float* dt,
                                const float* cum, const void* bm,
                                const void* cm, float* y, float* state,
                                int B, int L, int H, int Q,
                                cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nc = L / Q, tasks = Q / kQ + N / 64;
  const int G = tf32_tiled_heads_per_block(B * nc, Q, N, H, sms);
  const size_t smem = Tf32TiledSmem(Q).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_chunk_tf32_tiled<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nc * tasks, H / G, B);
  ssd_chunk_tf32_tiled<N><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, cum, static_cast<const float*>(bm),
      static_cast<const float*>(cm), y, state, L, H, G, Q);
  return cudaGetLastError();
}

cudaError_t launch_tf32_tiled(const void* x, const float* dt,
                              const float* cum, const void* bm,
                              const void* cm, float* y, float* state, int B,
                              int L, int H, int N, int Q,
                              cudaStream_t stream) {
  if (Q % kQ || Q <= kQ || Q > kTiledMaxQ) return cudaErrorInvalidValue;
  if (N == 64)
    return launch_tf32_tiled_n<64>(x, dt, cum, bm, cm, y, state, B, L, H, Q,
                                   stream);
  if (N == 128)
    return launch_tf32_tiled_n<128>(x, dt, cum, bm, cm, y, state, B, L, H, Q,
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

// The carry on the tensor cores: ssd_carry_tc for bf16 C (the serving
// path), ssd_carry_tf32 for fp32 C (the models' fp32 training and the
// reference sweep's fp32 shapes).  The recurrence h <- exp(cum_last) h + S
// runs along the chunks, one fma per element of h; C . h_prev and the y it
// adds to hang off it.  So a block, one (batch, head, slice of PS columns)
// at a time, splits into roles:
//
// * a producer warp copies each chunk's state slice and last cum, with
//   cp.async, into a ring of `stages` chunks; a stage's full mbarrier
//   completes when its copies land (cp.async.mbarrier.arrive);
// * chain warps, each holding 16 KW rows of N of h's slice in fp32
//   registers (32 values a lane; KW = 64 / PS k16 steps), advance h with
//   carry()'s fma and, before each chunk, publish h_prev into a ring of
//   kTermSlots slots, already in mma.sync's B-fragment order: for bf16 C
//   as three exact bf16 terms (m16n8k16), for fp32 C as two TF32 planes,
//   hi and lo (split_tf32; m16n8k8, the k slots c and c + 4 holding rows
//   2c and 2c + 1 of each k8 step);
// * MMA warps, one per 16 rows of a tile, each copying its own rows of C
//   (rows of N + 8 elements), y_intra and cum with cp.async into its own
//   ring of `stages` tiles (stages - 1 tiles ahead), compute C . h_prev on
//   mma.sync and store y, off the chain.  bf16: ldmatrix fragments of C
//   against each term.  fp32: C's columns 2c, 2c + 1 of each k8 step read
//   as one 8-byte load (rows of N + 8 words, 8 (mod 32), so that the
//   warp's loads meet no bank twice), split as read, and every product
//   taken as three TF32 products (hi·hi + hi·lo + lo·hi, as
//   ssd_chunk_tf32's), which meets the fp32 bar where one TF32 product
//   misses it (tests/_ssd_tf32.py).
//
// Why this split: a first version staged every tile through one producer
// warp, whose cp.async issue (~190 cache lines a tile: C rows, y_intra
// pieces, cum strided by H) kept the MMA warps waiting on their tiles most
// of the time, and one staged C tile shared by two heads of a block
// measured slower than a head a block at every shape (PERF.md).  Copied
// by the MMA warps themselves, the tiles' issue spreads over four warps.
// The fp32 kernel is the same walk with C's tiles twice as wide and
// h_prev in two planes of 4 bytes where the bf16 one has three of 2: its
// plans fit fewer stages or blocks in an SM's shared memory.
//
// The grid is persistent: block i walks the groups i, i + gridDim.x, ...,
// its rings running on from one group to the next.  carry_tc_plan picks
// the slice width and the ring depth from the shape, C's type and the
// card's SM count.
//
// The sums of ssd_carry_tc are the first design's, term for term: per 16
// rows, k16 steps outer and terms inner, each accumulator from zero, then
// y = y_intra + exp(cum) acc, and h = d h + s; so y and the final state
// are bitwise those of the kernel it replaces (tools/ssd_ab.py).
// ssd_carry_tf32: per 16 rows, k8 steps outer, hi·hi, hi·lo, lo·hi over
// the slice's n8 tiles inner (mma3), the accumulator from zero.  Neither
// uses atomics: two passes are equal bit for bit.
//
// Bound: bytes, as the CUDA-core carry's.  At mamba2-780m's heads the
// fp32 kernel's products, three TF32 products a product at mma.sync's
// ~310 TFLOP/s, take about half the byte bound.
constexpr int kCarryTerms = 3;
constexpr int kCarryPlanStages = 3;      // deepest ring a plan takes
constexpr int kTermSlots = 2;            // slots of h_prev's terms
constexpr long long kWatchdogCycles = 1LL << 34;   // ~10 s of SM clock

// What the two tensor-core carries take from C's type: h_prev's planes a
// slot (bf16 terms, or the TF32 hi and lo) and the k rows of one mma.sync
// (m16n8k16 or m16n8k8).  A slot holds planes x (N / kStep) k steps x
// (PS / 8) n8 tiles x 32 lanes of uint2: planes N PS sizeof(TC) bytes.
template <typename TC>
struct CarryTc;
template <>
struct CarryTc<bf16> {
  static constexpr int kPlanes = kCarryTerms;
  static constexpr int kStep = 16;
};
template <>
struct CarryTc<float> {
  static constexpr int kPlanes = 2;
  static constexpr int kStep = 8;
};

// The most threads a tensor-core carry block takes (1 + chain + MMA
// warps): 640, which caps a thread at 96 registers; the fp32 kernel at
// 64-column slices needs 128 (it spills at 96), so it takes 512.
template <typename TC>
__host__ __device__ constexpr int carry_tc_max_threads(int PS) {
  return sizeof(TC) == 4 && PS == 64 ? 512 : 640;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// One arrival for the warp once all its lanes are done with (or have
// written) what the barrier guards: lane 0 arrives after __syncwarp,
// which orders the other lanes' accesses before it.  One arrival a warp
// rather than a lane: arrivals on one barrier are serialised.
__device__ __forceinline__ void mbar_arrive_warp(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}
// One arrival on `bar` once every cp.async this thread has issued lands.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_done(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits for the phase of this parity to complete.  A wait of seconds is a
// deadlock: it traps, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_done(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_done(bar, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

// Waits until at most n (0 to kCarryPlanStages - 1) of this thread's
// newest cp.async groups are in flight.
static_assert(kCarryPlanStages == 3, "cp_async_wait_n covers n <= 2");
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}

// A slot of a ring and the parity of its current use.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ void next(int n) {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Shared memory of a tensor-core carry: the barriers; `stages` chunk
// stages (the state slice [N][PS + 4] fp32 and its last cum, padded to 16
// bytes); the terms ring (kTermSlots slots of planes N PS values of C's
// type); and per MMA warp `stages` tile stages (its 16 rows of C
// [16][N + 8] in C's type, y_intra [16][ldy] and cum [16] fp32).  The
// padding keeps ldmatrix, the fp32 fragment loads, the chain's state
// reads and the y_intra reads free of bank conflicts.
__host__ __device__ constexpr int carry_ldy(int PS) {
  return PS == 8 ? 8 : PS + 8;
}
__host__ __device__ inline size_t carry_tc_chunk_bytes(int N, int PS) {
  return (size_t)N * (PS + 4) * 4 + 16;
}
template <typename TC>
__host__ __device__ inline size_t carry_tc_mma_stage_bytes(int N, int PS) {
  return 16 * (size_t)(N + 8) * sizeof(TC) +
         16 * (size_t)(carry_ldy(PS) + 1) * 4;
}
__host__ __device__ inline size_t carry_tc_bar_bytes(int stages) {
  return ((2 * stages + 2 * kTermSlots) * 8 + 15) / 16 * 16;
}
template <typename TC>
size_t carry_tc_smem_bytes(int N, int Q, int PS, int stages) {
  return carry_tc_bar_bytes(stages) +
         stages * carry_tc_chunk_bytes(N, PS) +
         (size_t)kTermSlots * CarryTc<TC>::kPlanes * N * PS * sizeof(TC) +
         (size_t)(carry_tile(Q) / 16) * stages *
             carry_tc_mma_stage_bytes<TC>(N, PS);
}
// k16 steps (16 rows of N) of h's slice a chain warp holds: 32 values a
// lane (16 at 8-column slices).
__host__ __device__ constexpr int carry_kw(int PS) {
  return PS == 8 ? 4 : 64 / PS;
}
__host__ __device__ inline int carry_chain_warps(int N, int PS) {
  return (N / 16 + carry_kw(PS) - 1) / carry_kw(PS);
}
// Threads of a block: the producer warp, the chain warps and one MMA warp
// per 16 rows of a tile.
__host__ __device__ inline int carry_tc_threads(int N, int Q, int PS) {
  return 32 * (1 + carry_chain_warps(N, PS) + carry_tile(Q) / 16);
}

// The walk of either tensor-core carry (the design above), C of type TC.
template <typename TC, typename TY, int PS>
__device__ __forceinline__ void carry_tc_walk(
    unsigned char* carry_tc_smem, const float* __restrict__ y_intra,
    const float* __restrict__ states, const float* __restrict__ cum,
    const TC* __restrict__ cm, const float* __restrict__ init,
    TY* __restrict__ y, float* __restrict__ final_state, int B, int L, int H,
    int P, int N, int Q, int stages) {
  constexpr bool kTf32 = sizeof(TC) == 4;
  constexpr int kPlanes = CarryTc<TC>::kPlanes;
  constexpr int NTP = PS / 8;           // n8 tiles of the slice
  constexpr int G4 = PS / 4;            // 16-byte pieces of a slice row
  constexpr int LDY = carry_ldy(PS);    // y_intra rows in shared memory
  constexpr int LDS = PS + 4;           // state rows in shared memory
  constexpr int KW = carry_kw(PS);
  constexpr int VW = 16 / sizeof(TC);   // C values a 16-byte piece
  const int R = carry_tile(Q), nt = (Q + R - 1) / R, nc = L / Q;
  const int KK = N / CarryTc<TC>::kStep, ldc = N + 8;
  const int cw = carry_chain_warps(N, PS);
  const int nslice = P / PS, ngroups = B * H * nslice;
  const size_t chunk_bytes = carry_tc_chunk_bytes(N, PS);
  uint64_t* chunk_full = reinterpret_cast<uint64_t*>(carry_tc_smem);
  uint64_t* chunk_empty = chunk_full + stages;
  uint64_t* terms_full = chunk_empty + stages;
  uint64_t* terms_empty = terms_full + kTermSlots;
  unsigned char* chunks = carry_tc_smem + carry_tc_bar_bytes(stages);
  uint2* terms = reinterpret_cast<uint2*>(chunks + stages * chunk_bytes);
  const int slot_terms = kPlanes * KK * NTP * 32;   // uint2s a slot
  unsigned char* mma_rings =
      reinterpret_cast<unsigned char*>(terms + kTermSlots * slot_terms);
  auto chunk_state = [&](int s) {   // its last cum at [N * LDS]
    return reinterpret_cast<float*>(chunks + s * chunk_bytes);
  };
  auto group = [&](int gi, int& b, int& h, int& ps0) {
    ps0 = (gi % nslice) * PS;
    gi /= nslice;
    h = gi % H;
    b = gi / H;
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, cq = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(chunk_full + s, 32);
      mbar_init(chunk_empty + s, cw);
    }
    for (int j = 0; j < kTermSlots; ++j) {
      mbar_init(terms_full + j, cw);
      mbar_init(terms_empty + j, R / 16);
    }
  }
  __syncthreads();

  if (warp == 0) {
    // The producer: each chunk's state slice and its last cum.
    Ring cs;
    for (int gi = blockIdx.x; gi < ngroups; gi += gridDim.x) {
      int b, h, ps0;
      group(gi, b, h, ps0);
      for (int c = 0; c < nc; ++c) {
        mbar_wait(chunk_empty + cs.slot, cs.phase ^ 1);
        float* dst = chunk_state(cs.slot);
        const float* src =
            states + (((int64_t)b * nc + c) * H + h) * (int64_t)N * P + ps0;
        for (int e = lane; e < N * G4; e += 32)
          cp_async16(dst + (e / G4) * LDS + (e % G4) * 4,
                     src + (int64_t)(e / G4) * P + (e % G4) * 4);
        if (lane == 0)
          cp_async4(dst + N * LDS,
                    cum + ((int64_t)b * L + (int64_t)c * Q + Q - 1) * H + h);
        mbar_arrive_cp_async(chunk_full + cs.slot);
        cs.next(stages);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  if (warp <= cw) {
    // A chain warp: rows 16 kk0 .. of N.  Lane (g, cq) holds, for each k16
    // step j and n8 tile of the slice, the four values of h that make its
    // B fragment: rows 2cq, 2cq + 1, 2cq + 8, 2cq + 9 of the step, column
    // g of the tile (for fp32 C, rows 2cq and 2cq + 1 of each of the
    // step's two k8 steps, in their slots cq and cq + 4).
    const int kk0 = KW * (warp - 1), nk = min(KW, N / 16 - kk0);
    float hv[KW][NTP][4];
    Ring cs, js;
    auto row_of = [&](int j, int e) {
      return 16 * (kk0 + j) + 2 * cq + (e & 1) + 8 * (e >> 1);
    };
    for (int gi = blockIdx.x; gi < ngroups; gi += gridDim.x) {
      int b, h, ps0;
      group(gi, b, h, ps0);
      const int64_t bh = (int64_t)b * H + h;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        if (j >= nk) continue;
#pragma unroll
        for (int t8 = 0; t8 < NTP; ++t8)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hv[j][t8][e] = init ? init[(bh * N + row_of(j, e)) * P + ps0 +
                                       8 * t8 + g]
                                : 0.f;
      }
      for (int c = 0; c < nc; ++c) {
        mbar_wait(terms_empty + js.slot, js.phase ^ 1);
        uint2* tb = terms + js.slot * slot_terms;
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          if (j >= nk) continue;
#pragma unroll
          for (int t8 = 0; t8 < NTP; ++t8) {
            if constexpr (kTf32) {
#pragma unroll
              for (int s = 0; s < 2; ++s) {
                uint2 hi, lo;
                split_tf32(hv[j][t8][2 * s], hi.x, lo.x);
                split_tf32(hv[j][t8][2 * s + 1], hi.y, lo.y);
                const int ks = 2 * (kk0 + j) + s;
                tb[(ks * NTP + t8) * 32 + lane] = hi;
                tb[((KK + ks) * NTP + t8) * 32 + lane] = lo;
              }
            } else {
              uint32_t lo[kCarryTerms], up[kCarryTerms];
              split<kCarryTerms>(hv[j][t8][0], hv[j][t8][1], lo);
              split<kCarryTerms>(hv[j][t8][2], hv[j][t8][3], up);
#pragma unroll
              for (int t = 0; t < kCarryTerms; ++t)
                tb[((t * KK + kk0 + j) * NTP + t8) * 32 + lane] =
                    make_uint2(lo[t], up[t]);
            }
          }
        }
        mbar_arrive_warp(terms_full + js.slot);
        js.next(kTermSlots);
        mbar_wait(chunk_full + cs.slot, cs.phase);
        const float* st = chunk_state(cs.slot);
        const float d = expf(st[N * LDS]);
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          if (j >= nk) continue;
#pragma unroll
          for (int t8 = 0; t8 < NTP; ++t8)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              hv[j][t8][e] =
                  d * hv[j][t8][e] + st[row_of(j, e) * LDS + 8 * t8 + g];
        }
        mbar_arrive_warp(chunk_empty + cs.slot);
        cs.next(stages);
      }
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        if (j >= nk) continue;
#pragma unroll
        for (int t8 = 0; t8 < NTP; ++t8)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            final_state[(bh * N + row_of(j, e)) * P + ps0 + 8 * t8 + g] =
                hv[j][t8][e];
      }
    }
    return;
  }

  // An MMA warp: rows r0 .. r0 + 15 of each tile, which it copies itself
  // into its own ring, stages - 1 tiles ahead of the one it computes.
  const int r0 = 16 * (warp - 1 - cw);
  const size_t mstage = carry_tc_mma_stage_bytes<TC>(N, PS);
  unsigned char* ring = mma_rings + (size_t)(warp - 1 - cw) * stages * mstage;
  auto stage_c = [&](int s) {
    return reinterpret_cast<TC*>(ring + s * mstage);
  };
  auto stage_y = [&](int s) {
    return reinterpret_cast<float*>(ring + s * mstage +
                                    16 * ldc * (int)sizeof(TC));
  };
  auto stage_cum = [&](int s) { return stage_y(s) + 16 * LDY; };
  // The next tile to copy (group, its batch row, head and columns, chunk,
  // tile) and the stage it goes to; a row of C is NV 16-byte pieces, which
  // the lanes step through 32 at a time without a division.
  const int NV = N / VW, di = 32 / NV, dv = 32 % NV;
  int ngi = blockIdx.x, nb = 0, nh = 0, nps0 = 0, ncc = 0, nk = 0, ws = 0;
  if (ngi < ngroups) group(ngi, nb, nh, nps0);
  auto copy_next = [&]() {
    if (ngi < ngroups) {
      const int64_t row0 = (int64_t)nb * L + (int64_t)ncc * Q + nk * R + r0;
      if (r0 < min(R, Q - nk * R)) {
        TC* dc = stage_c(ws);
        const TC* sc = cm + row0 * N;
        for (int i = lane / NV, v = lane % NV; i < 16;) {
          cp_async16(dc + i * ldc + v * VW, sc + (int64_t)i * N + v * VW);
          i += di;
          v += dv;
          if (v >= NV) {
            v -= NV;
            ++i;
          }
        }
        float* dy = stage_y(ws);
        const float* sy = y_intra + (row0 * H + nh) * P + nps0;
        for (int e = lane; e < 16 * G4; e += 32)
          cp_async16(dy + (e / G4) * LDY + (e % G4) * 4,
                     sy + (int64_t)(e / G4) * H * P + (e % G4) * 4);
        if (lane < 16)
          cp_async4(stage_cum(ws) + lane, cum + (row0 + lane) * H + nh);
      }
      if (++nk == nt) {
        nk = 0;
        if (++ncc == nc) {
          ncc = 0;
          ngi += gridDim.x;
          if (ngi < ngroups) group(ngi, nb, nh, nps0);
        }
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count
    if (++ws == stages) ws = 0;
  };
  for (int s = 1; s < stages; ++s) copy_next();
  Ring js;
  int rs = 0;   // the stage of the tile computed next
  for (int gi = blockIdx.x; gi < ngroups; gi += gridDim.x) {
    int b, h, ps0;
    group(gi, b, h, ps0);
    for (int c = 0; c < nc; ++c) {
      mbar_wait(terms_full + js.slot, js.phase);
      const uint2* tb = terms + js.slot * slot_terms;
      for (int k = 0; k < nt; ++k) {
        const int64_t row0 = (int64_t)b * L + (int64_t)c * Q + k * R + r0;
        copy_next();   // into the stage computed last
        cp_async_wait_n(stages - 1);
        __syncwarp();   // every lane's copies of this tile have landed
        if (r0 < min(R, Q - k * R)) {   // warp-uniform
          const TC* cur = stage_c(rs);
          float acc[NTP][4] = {};
          if constexpr (kTf32) {
            for (int kk = 0; kk < KK; ++kk) {
              // Columns 2cq, 2cq + 1 of the k8 step as the slots cq,
              // cq + 4 (rows g and g + 8), split as read; h_prev's planes
              // as the chain published them.
              const float2 u = *reinterpret_cast<const float2*>(
                  cur + g * ldc + 8 * kk + 2 * cq);
              const float2 w = *reinterpret_cast<const float2*>(
                  cur + (g + 8) * ldc + 8 * kk + 2 * cq);
              Tf32B bt[NTP];
#pragma unroll
              for (int t8 = 0; t8 < NTP; ++t8) {
                const uint2 hi = tb[(kk * NTP + t8) * 32 + lane];
                const uint2 lo = tb[((KK + kk) * NTP + t8) * 32 + lane];
                bt[t8].hi[0] = hi.x;
                bt[t8].hi[1] = hi.y;
                bt[t8].lo[0] = lo.x;
                bt[t8].lo[1] = lo.y;
              }
              mma3<NTP>(acc, 0, Tf32A(u.x, w.x, u.y, w.y), bt);
            }
          } else {
            for (int kk = 0; kk < KK; ++kk) {
              // The step's fragments first, then its products: the loads
              // of a step overlap the products of the one before instead
              // of each product waiting on its own load.
              uint32_t a[4];
              uint2 bb[kCarryTerms][NTP];
              ldsm_x4(a, cur + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldc +
                             16 * kk + (lane >> 4) * 8);
#pragma unroll
              for (int t = 0; t < kCarryTerms; ++t)
#pragma unroll
                for (int t8 = 0; t8 < NTP; ++t8)
                  bb[t][t8] = tb[((t * KK + kk) * NTP + t8) * 32 + lane];
#pragma unroll
              for (int t = 0; t < kCarryTerms; ++t)
#pragma unroll
                for (int t8 = 0; t8 < NTP; ++t8)
                  mma(acc[t8], a, bb[t][t8].x, bb[t][t8].y);
            }
          }
          const float* ys = stage_y(rs);
          const float* cs = stage_cum(rs);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = g + 8 * rr;
            const float e = expf(cs[i]);
#pragma unroll
            for (int t8 = 0; t8 < NTP; ++t8) {
              const float2 v = *reinterpret_cast<const float2*>(
                  ys + i * LDY + 8 * t8 + 2 * cq);
              store2(y + ((row0 + i) * H + h) * P + ps0 + 8 * t8 + 2 * cq,
                     v.x + e * acc[t8][2 * rr], v.y + e * acc[t8][2 * rr + 1]);
            }
          }
        }
        __syncwarp();   // every lane is done with the stage it refills next
        if (++rs == stages) rs = 0;
      }
      mbar_arrive_warp(terms_empty + js.slot);
      js.next(kTermSlots);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename TY, int PS>
__global__ void __launch_bounds__(carry_tc_max_threads<bf16>(PS))
    ssd_carry_tc(const float* __restrict__ y_intra,
                 const float* __restrict__ states,
                 const float* __restrict__ cum, const bf16* __restrict__ cm,
                 const float* __restrict__ init, TY* __restrict__ y,
                 float* __restrict__ final_state, int B, int L, int H, int P,
                 int N, int Q, int stages) {
  extern __shared__ __align__(128) unsigned char carry_tc_smem[];
  carry_tc_walk<bf16, TY, PS>(carry_tc_smem, y_intra, states, cum, cm, init,
                              y, final_state, B, L, H, P, N, Q, stages);
}

template <typename TY, int PS>
__global__ void __launch_bounds__(carry_tc_max_threads<float>(PS))
    ssd_carry_tf32(const float* __restrict__ y_intra,
                   const float* __restrict__ states,
                   const float* __restrict__ cum,
                   const float* __restrict__ cm,
                   const float* __restrict__ init, TY* __restrict__ y,
                   float* __restrict__ final_state, int B, int L, int H,
                   int P, int N, int Q, int stages) {
  extern __shared__ __align__(128) unsigned char carry_tc_smem[];
  carry_tc_walk<float, TY, PS>(carry_tc_smem, y_intra, states, cum, cm,
                               init, y, final_state, B, L, H, P, N, Q,
                               stages);
}

// The kernel of the tensor-core carry for C of type TC.
template <typename TC, typename TY, int PS>
constexpr auto carry_tc_kernel() {
  if constexpr (sizeof(TC) == 2)
    return ssd_carry_tc<TY, PS>;
  else
    return ssd_carry_tf32<TY, PS>;
}

// What launch_carry_tc launches: slice width, ring depth, blocks, threads
// and shared memory.
struct CarryTcPlan {
  int ps, stages, blocks, threads;
  size_t smem;
};

// One candidate: `PS` columns a slice and a ring of `stages`, with the
// blocks that `sms` SMs hold at once (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor on the current device); plan->stages = 0 where it does
// not fit.
template <typename TC, typename TY, int PS>
cudaError_t carry_tc_candidate(int B, int H, int P, int N, int Q, int stages,
                               int sms, CarryTcPlan* plan) {
  const auto kernel = carry_tc_kernel<TC, TY, PS>();
  *plan = CarryTcPlan{PS, 0, 0, 0, 0};
  const int threads = carry_tc_threads(N, Q, PS);
  const size_t smem = carry_tc_smem_bytes<TC>(N, Q, PS, stages);
  if (P % PS || threads > carry_tc_max_threads<TC>(PS) || smem > kMaxSmem)
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess || per_sm < 1) return err;
  const int64_t groups = (int64_t)B * H * (P / PS);
  const int64_t slots = (int64_t)sms * per_sm;
  *plan = CarryTcPlan{PS, stages, (int)(groups < slots ? groups : slots),
                      threads, smem};
  return cudaSuccess;
}

template <typename TC, typename TY>
cudaError_t carry_tc_candidate(int ps, int B, int H, int P, int N, int Q,
                               int stages, int sms, CarryTcPlan* plan) {
  switch (ps) {
    case 8:
      return carry_tc_candidate<TC, TY, 8>(B, H, P, N, Q, stages, sms, plan);
    case 16:
      return carry_tc_candidate<TC, TY, 16>(B, H, P, N, Q, stages, sms,
                                            plan);
    case 32:
      return carry_tc_candidate<TC, TY, 32>(B, H, P, N, Q, stages, sms,
                                            plan);
    case 64:
      return carry_tc_candidate<TC, TY, 64>(B, H, P, N, Q, stages, sms,
                                            plan);
  }
  return cudaErrorInvalidValue;
}

// The plan (tools/ssd_ab.py --plans at the models' shapes): each block
// walks its groups' chunks one after another, so what a plan must do is
// keep every SM busy with every group resident at once, and read rows in
// long runs.  So: the widest slice (64, 32 or 16 columns; 8 where P is
// not a multiple of 16) whose groups keep at least three quarters of the
// SMs busy, at the deepest ring up to kCarryPlanStages with which every
// group is resident at once (else the deepest that fits); where no slice
// has that many groups, the narrowest.  plan->stages = 0 where nothing
// fits (the shape then takes the CUDA-core kernel).  The rule is the same
// for both kernels; their shared memory differs (carry_tc_smem_bytes).
template <typename TC, typename TY>
cudaError_t choose_carry_tc_plan(int B, int H, int P, int N, int Q, int sms,
                                 CarryTcPlan* plan) {
  *plan = CarryTcPlan{0, 0, 0, 0, 0};
  const int slices[] = {64, 32, 16, 8};
  for (int ps : slices) {
    if ((ps == 8) != (P % 16 != 0)) continue;
    const int64_t groups = (int64_t)B * H * (P / ps);
    CarryTcPlan best{0, 0, 0, 0, 0};
    for (int stages = kCarryPlanStages; stages >= 1; --stages) {
      CarryTcPlan c;
      const cudaError_t err =
          carry_tc_candidate<TC, TY>(ps, B, H, P, N, Q, stages, sms, &c);
      if (err != cudaSuccess) return err;
      if (c.stages == 0) continue;
      if (best.stages == 0 || c.blocks == groups) best = c;
      if (c.blocks == groups) break;   // every group resident at once
    }
    if (best.stages == 0) continue;
    *plan = best;   // the narrowest so far
    if (4 * groups >= 3 * (int64_t)sms) return cudaSuccess;
  }
  return cudaSuccess;
}

// The plan for this shape and C's type on the current device, chosen once
// per (device, shape) and kept: a serving process launches the same few
// shapes.
template <typename TC, typename TY>
cudaError_t carry_tc_plan(int B, int H, int P, int N, int Q,
                          CarryTcPlan* plan) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex lock;
  static std::map<std::array<int, 6>, CarryTcPlan> plans;
  const std::array<int, 6> key = {dev, B, H, P, N, Q};
  std::lock_guard<std::mutex> hold(lock);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    *plan = it->second;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = choose_carry_tc_plan<TC, TY>(B, H, P, N, Q, sms, plan);
  if (err == cudaSuccess) plans[key] = *plan;
  return err;
}

template <typename TC, typename TY, int PS>
cudaError_t run_carry_tc(const CarryTcPlan& plan, const void* y_intra,
                         const void* states, const void* cum, const void* cm,
                         const void* init, void* y, void* final_state, int B,
                         int L, int H, int P, int N, int Q,
                         cudaStream_t stream) {
  const auto kernel = carry_tc_kernel<TC, TY, PS>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<plan.blocks, plan.threads, plan.smem, stream>>>(
      static_cast<const float*>(y_intra), static_cast<const float*>(states),
      static_cast<const float*>(cum), static_cast<const TC*>(cm),
      static_cast<const float*>(init), static_cast<TY*>(y),
      static_cast<float*>(final_state), B, L, H, P, N, Q, plan.stages);
  return cudaGetLastError();
}

template <typename TC, typename TY>
cudaError_t launch_carry_tc(const void* y_intra, const void* states,
                            const void* cum, const void* cm, const void* init,
                            void* y, void* final_state, int B, int L, int H,
                            int P, int N, int Q, cudaStream_t stream) {
  CarryTcPlan plan;
  const cudaError_t err = carry_tc_plan<TC, TY>(B, H, P, N, Q, &plan);
  if (err != cudaSuccess) return err;
#define SSD_RUN_CARRY_TC(PS)                                                \
  return run_carry_tc<TC, TY, PS>(plan, y_intra, states, cum, cm, init, y,   \
                                  final_state, B, L, H, P, N, Q, stream)
  if (plan.stages == 0) return cudaErrorInvalidValue;
  if (plan.ps == 8) SSD_RUN_CARRY_TC(8);
  if (plan.ps == 16) SSD_RUN_CARRY_TC(16);
  if (plan.ps == 32) SSD_RUN_CARRY_TC(32);
  SSD_RUN_CARRY_TC(64);
#undef SSD_RUN_CARRY_TC
}

// Whether the tensor-core carry for C of type TC takes this shape: Q and N
// multiples of 16, and its smallest plan (a one-stage ring at the
// narrowest slice) fits a block.
template <typename TC>
bool carry_tc_fits(int N, int Q, int P) {
  const int ps = P % 16 == 0 ? 16 : 8;
  return Q % 16 == 0 && N % 16 == 0 &&
         carry_tc_smem_bytes<TC>(N, Q, ps, 1) <= kMaxSmem &&
         carry_tc_threads(N, Q, ps) <= carry_tc_max_threads<TC>(ps);
}

template <typename TC, typename TY>
cudaError_t launch_carry(const void* y_intra, const void* states,
                         const void* cum, const void* cm, const void* init,
                         void* y, void* final_state, int B, int L, int H,
                         int P, int N, int Q, bool cuda_cores,
                         cudaStream_t stream) {
  if (!cuda_cores && carry_tc_fits<TC>(N, Q, P))
    return launch_carry_tc<TC, TY>(y_intra, states, cum, cm, init, y,
                                   final_state, B, L, H, P, N, Q, stream);
  // 16-column slices where P allows: every block reads all of C, so wider
  // slices read C from L2 fewer times over.
  if (P % 16 == 0)
    return launch_carry_ps<TC, TY, 16>(y_intra, states, cum, cm, init, y,
                                       final_state, B, L, H, P, N, Q, stream);
  return launch_carry_ps<TC, TY, 8>(y_intra, states, cum, cm, init, y,
                                    final_state, B, L, H, P, N, Q, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x, B and C; dt, cum, y and state
// are float32.  x [B, L, H, P], dt and cum [B, L, H], B and C [B, L, N],
// y [B, L, H, P], state [B, L / Q, H, N, P], all contiguous and 16-byte
// aligned.  terms = 0 runs the CUDA-core kernel; at P = 64 and N = 64 or
// 128, for bf16 1, 2 or 3 run ssd_chunk_tc (Q = 64) with W and B ⊙
// dec_end in that many bf16 terms and kTiledTerms (2) runs
// ssd_chunk_tc_tiled (Q = 128, 192 or 256), and for fp32 kTf32Terms (3)
// runs ssd_chunk_tf32 (Q = 64) or ssd_chunk_tf32_tiled (Q = 128, 192 or
// 256).
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
  if (P != kP) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && Q != kQ) {
    if (terms != kTiledTerms) return (int)cudaErrorInvalidValue;
    return (int)launch_tiled<kTiledTerms>(x, dtf, cumf, bm, cm, yf, sf, B, L,
                                          H, N, Q, s);
  }
  if (dtype == 0 && Q != kQ) {
    if (terms != kTf32Terms) return (int)cudaErrorInvalidValue;
    return (int)launch_tf32_tiled(x, dtf, cumf, bm, cm, yf, sf, B, L, H, N, Q,
                                  s);
  }
  if (Q != kQ) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (terms != kTf32Terms) return (int)cudaErrorInvalidValue;
    if (N == 64)
      return (int)launch_tf32_n<64>(x, dtf, cumf, bm, cm, yf, sf, B, L, H,
                                    s);
    if (N == 128)
      return (int)launch_tf32_n<128>(x, dtf, cumf, bm, cm, yf, sf, B, L, H,
                                     s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
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
// Q at most 256, P and N multiples of 8.  ssd_carry_launch runs the
// tensor-core carry where it takes the shape (ssd_carry_tc for bf16 C,
// ssd_carry_tf32 for fp32 C: Q and N multiples of 16, its layout within a
// block), else ssd_carry_kernel; ssd_carry_core_launch runs
// ssd_carry_kernel at any shape (the CUDA cores, for comparison).
static int carry_entry(const void* y_intra, const void* states,
                       const void* cum, const void* cm, const void* init,
                       void* y, void* final_state, int c_dtype, int y_dtype,
                       int B, int L, int H, int P, int N, int Q,
                       bool cuda_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q > 256 || P % 8 || N % 8) return (int)cudaErrorInvalidValue;
#define SSD_CARRY(TC, TY)                                                   \
  return (int)launch_carry<TC, TY>(y_intra, states, cum, cm, init, y,        \
                                   final_state, B, L, H, P, N, Q,            \
                                   cuda_cores, s)
  if (c_dtype == 0 && y_dtype == 0) SSD_CARRY(float, float);
  if (c_dtype == 0 && y_dtype == 1) SSD_CARRY(float, bf16);
  if (c_dtype == 1 && y_dtype == 0) SSD_CARRY(bf16, float);
  if (c_dtype == 1 && y_dtype == 1) SSD_CARRY(bf16, bf16);
#undef SSD_CARRY
  return (int)cudaErrorInvalidValue;
}
extern "C" int ssd_carry_launch(const void* y_intra, const void* states,
                                const void* cum, const void* cm,
                                const void* init, void* y, void* final_state,
                                int c_dtype, int y_dtype, int B, int L, int H,
                                int P, int N, int Q, void* stream) {
  return carry_entry(y_intra, states, cum, cm, init, y, final_state, c_dtype,
                     y_dtype, B, L, H, P, N, Q, false, stream);
}
extern "C" int ssd_carry_core_launch(const void* y_intra, const void* states,
                                     const void* cum, const void* cm,
                                     const void* init, void* y,
                                     void* final_state, int c_dtype,
                                     int y_dtype, int B, int L, int H, int P,
                                     int N, int Q, void* stream) {
  return carry_entry(y_intra, states, cum, cm, init, y, final_state, c_dtype,
                     y_dtype, B, L, H, P, N, Q, true, stream);
}

// Dynamic shared memory (bytes) of an ssd_chunk_tf32 block at state size
// N (64 or 128) with G heads a block, and the heads a block it takes for B
// batches of L steps and H heads on this card (ssd_chunk_tf32_heads); -1
// for anything else.
extern "C" int ssd_chunk_tf32_smem_bytes(int N, int G) {
  if ((N != 64 && N != 128) || G < 1) return -1;
  return (int)tf32_smem_bytes(N, G);
}
extern "C" int ssd_chunk_tf32_heads(int B, int L, int H) {
  int dev = 0, sms = 0;
  if (B < 1 || L < kQ || H < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return tf32_heads_per_block(B * (L / kQ), H, sms);
}

// Dynamic shared memory (bytes) of an ssd_chunk_tc_tiled block at state
// size N (64 or 128) and chunk Q (128, 192 or 256); -1 for anything else.
extern "C" int ssd_chunk_tiled_smem_bytes(int N, int Q) {
  if ((N != 64 && N != 128) || Q % kQ || Q <= kQ || Q > kTiledMaxQ)
    return -1;
  return (int)TiledSmem(N, Q).total;
}

// Dynamic shared memory (bytes) of an ssd_chunk_tf32_tiled block at state
// size N (64 or 128) and chunk Q (128, 192 or 256), and the heads a block
// it takes for B batches of L steps and H heads on this card
// (ssd_chunk_tf32_tiled_heads); -1 for anything else.
extern "C" int ssd_chunk_tf32_tiled_smem_bytes(int N, int Q) {
  if ((N != 64 && N != 128) || Q % kQ || Q <= kQ || Q > kTiledMaxQ)
    return -1;
  return (int)Tf32TiledSmem(Q).total;
}
extern "C" int ssd_chunk_tf32_tiled_heads(int B, int L, int H, int N,
                                          int Q) {
  int dev = 0, sms = 0;
  if (B < 1 || H < 1 || (N != 64 && N != 128) || Q % kQ || Q <= kQ ||
      Q > kTiledMaxQ || L < Q || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return tf32_tiled_heads_per_block(B * (L / Q), Q, N, H, sms);
}

// Dynamic shared memory (bytes) of a block at chunk Q, state size N and
// head width P: the CUDA-core chunk kernel (which = 0), the carry on the
// CUDA cores with fp32 C (1) or bf16 C (2), ssd_carry_tc at its smallest
// plan (3: a one-stage ring, the size that decides whether it takes the
// shape), the carries at their 16-column slice; -1 for anything else.
extern "C" int ssd_smem_bytes(int which, int Q, int N, int P) {
  if (Q < 1 || N < 1 || P < 1) return -1;
  if (which == 0)
    return (int)(smem_floats(Q, N, P) * sizeof(float));
  if (which == 1) return (int)carry_smem_bytes(N, Q, 16, 4);
  if (which == 2) return (int)carry_smem_bytes(N, Q, 16, 2);
  if (which == 3) return (int)carry_tc_smem_bytes<bf16>(N, Q, 16, 1);
  return -1;
}

// Dynamic shared memory (bytes) of a tensor-core carry block for C of
// c_dtype (0 = float32: ssd_carry_tf32, 1 = bfloat16: ssd_carry_tc) at
// chunk Q, state size N, slices of ps columns and rings of `stages`; -1
// for anything else.
extern "C" int ssd_carry_tc_smem_bytes(int c_dtype, int N, int Q, int ps,
                                       int stages) {
  if (Q < 1 || N < 1 || (ps != 8 && ps != 16 && ps != 32 && ps != 64) ||
      stages < 1 || stages > kCarryPlanStages)
    return -1;
  if (c_dtype == 0) return (int)carry_tc_smem_bytes<float>(N, Q, ps, stages);
  if (c_dtype == 1) return (int)carry_tc_smem_bytes<bf16>(N, Q, ps, stages);
  return -1;
}

template <typename TC>
int carry_plan_entry(int y_dtype, int B, int H, int P, int N, int Q,
                     int* out) {
  if (B < 1 || H < 1 || Q < 1 || Q > 256 || P % 8 ||
      !carry_tc_fits<TC>(N, Q, P))
    return 1;
  CarryTcPlan plan;
  const cudaError_t err =
      y_dtype == 0 ? carry_tc_plan<TC, float>(B, H, P, N, Q, &plan)
                   : carry_tc_plan<TC, bf16>(B, H, P, N, Q, &plan);
  if (err != cudaSuccess) return (int)err;
  if (plan.stages == 0) return 1;
  out[0] = plan.ps;
  out[1] = plan.stages;
  out[2] = plan.blocks;
  out[3] = plan.threads;
  out[4] = (int)plan.smem;
  return 0;
}

// The plan of the tensor-core carry at this shape, y in y_dtype (0 =
// float32, 1 = bfloat16): ssd_carry_plan for bf16 C (ssd_carry_tc),
// ssd_carry_tf32_plan for fp32 C.  out = {columns a slice, ring stages,
// blocks, threads, shared-memory bytes}.  Returns 0, 1 where the shape
// takes the CUDA-core kernel instead, or a CUDA error.
extern "C" int ssd_carry_plan(int y_dtype, int B, int H, int P, int N, int Q,
                              int* out) {
  return carry_plan_entry<bf16>(y_dtype, B, H, P, N, Q, out);
}
extern "C" int ssd_carry_tf32_plan(int y_dtype, int B, int H, int P, int N,
                                   int Q, int* out) {
  return carry_plan_entry<float>(y_dtype, B, H, P, N, Q, out);
}
