// Gradient of the Mamba2 SSD chunked scan (ssd.cu) for Hopper: the
// inter-chunk carry's walks and each chunk's gradients.
//
// The reference has no backward Pallas kernel: it trains through its jnp
// SSD (repro/kernels/ssd/ref.py::ssd_ref), which XLA differentiates.  The
// port's forward is two kernels whose outputs autograd cannot see
// through, so its gradient is written out here, launched in order by the
// op repro_torch::ssd_fwd's backward after one more launch of the chunk
// kernel for the chunk states S_c (kept out of the forward's saved
// tensors: at 48 layers they would take ~9.6 GB).  The formulas, and
// their plain versions, are in ../ref.py (ssd_carry_bwd_ref,
// ssd_chunk_bwd_ref).  The kernels are chosen by the wrapper
// (kernel.py::bwd_kernels) as the forward's chunk kernels are: at Q = P =
// 64, N = 64 or 128 (the models' training shapes) bf16 x, B, C and dy on
// the tensor cores (ssd_carry_bwd_tc, ssd_chunk_bwd_tc), fp32 on the
// tensor cores in TF32 (ssd_carry_bwd_tf32, ssd_chunk_bwd_tf32); at Q =
// 128, 192 and 256 the chunk backward on the tensor cores over 64 x 64
// tiles (bf16 ssd_chunk_bwd_tc_tiled, fp32 ssd_chunk_bwd_tf32_tiled) and
// the same carry backward kernels, which walk a chunk in 64-row slabs;
// every other shape on the CUDA cores (ssd_carry_bwd, ssd_chunk_bwd).
//
// The carry's walks, per (batch, head) and element (n, p) of the state:
//     forward  h_prev_c = h,  h = exp(cum_last,c) h + S_c      (writes the
//              [B, nc, H, N, P] stack of h_prev)
//     reverse  g_c = g,  g = exp(cum_last,c) g + sum_i exp(cum_i) C_i (x) dy_i
//              from g = dfinal (zeros without one); what is left is
//              d init_state.
// Bound: bytes (S_c read, h_prev and g written, fp32: ~604 MB at
// [B, L, H, P, N] = [2, 4096, 48, 64, 128]).
//
// Each chunk's gradients, with E_ij = exp(cum_i - cum_j) for i >= j (a
// plain 0 above the diagonal, never computed there, so never inf * 0),
// K = (C . B^T) o E, W_ij = K_ij dt_j, dW_ij = dy_i . x_j,
// d_j = exp(cum_last - cum_j) dt_j, g the gradient of S_c and h_prev the
// state entering the chunk:
//     dx_j   = dt_j sum_i K_ij dy_i + d_j B_j^T g
//     dcum_i = sum_j T_ij - sum_j T_ji - d_i <B_i (x) x_i, g>
//              + exp(cum_i) <C_i . h_prev, dy_i>            (T = dW o W)
//     ddt_j  = sum_i dW_ij K_ij + exp(cum_last - cum_j) <B_j (x) x_j, g>
//     dcum_last += sum_j d_j <B_j (x) x_j, g> + exp(cum_last) <g, h_prev>
// (ddt without the cumsum's part: the op adds A . da), with dC += (sum_h
// dW o E o dt) . B + exp(cum_i) h_prev dy_i and dB += its transpose . C +
// d_j g x_j, summed over a group of G heads and written as one partial
// sum per group, [H / G, B, L, N]; the op sums the groups in a fixed
// order.  No atomics anywhere: two passes are equal bit for bit.
// Bound: bytes (x, dy, B, C, g and h_prev read, dx and the partials
// written: 0.191 ms at the mamba2-780m shape above, bf16).
//
// * ssd_chunk_bwd_tc (bf16): one block of 8 warps per (chunk, group of G
//   heads, batch), G from kernel.py::bwd_heads_per_block (16 at the
//   training shapes).  B and C are staged once per group with cp.async,
//   and (C . B^T)^T is formed once on mma.sync m16n8k16 (bf16 inputs:
//   exact products, fp32 sums) and kept in fragment order in shared
//   memory.  Each head's x and dy (bf16) and g and h_prev (fp32, straight
//   from the [B, nc, H, N, P] stacks) are copied with cp.async one head
//   ahead into a second buffer while the block works on this head
//   (~80 KB in flight an SM).  Warp (r, S) takes rows 16 r.. of the chunk
//   and half S of each product's columns; every product runs on mma.sync
//   with fp32 accumulators, the bf16 operand as read and the fp32 one
//   split into kBwdTerms bf16 terms (t1 = bf16(v), t2 = bf16(v - t1)):
//   dW^T = x . dy^T on the tiles at or right of the diagonal (one pass);
//   dx = d_j (B . g) + (K o dt)^T . dy, K o dt built in registers from the
//   (C . B^T)^T fragments (an accumulator pair of n-tiles is one A
//   fragment); x . g^T (into dB) and dy . h_prev^T (into dC), the running
//   dB and dC in registers over the group's heads; and at the group's end
//   (sum_h dW o E o dt)^T . C and its transpose against B, that sum kept
//   in registers over the heads and split once.  Each head's g and
//   h_prev are split once, in place, into two bf16 planes whose 16-byte
//   column groups are swizzled by the row (plane_off), so that every
//   fragment of them, read as [n][p] or transposed, is one conflict-free
//   ldmatrix; splitting at each use would split every g value 8 times
//   over the block.  Row and column sums (of T, V = dW o K,
//   <B_j (x) x_j, g> = x_j . (B . g)_j, <C_i . h_prev, dy_i>) are warp
//   shuffles over the fragments and a fixed-order sum of per-warp
//   partials; <g, h_prev> and the dcum tail likewise.  The MMA work at
//   two terms is ~47 GFLOP at the shape above (0.047 ms at the bf16
//   peak), a quarter of the byte bound: the copies decide.
// * ssd_chunk_bwd_tc_tiled (bf16 at Q = 128, 192 or 256, P = 64, N = 64
//   or 128): ssd_chunk_bwd_tc's arithmetic over 64 x 64 tiles, one block
//   of 8 warps per (chunk, 64-row block K, group of G heads, batch), G
//   from bwd_heads_per_block over the chunk's Q / 64 blocks.  A block
//   owns every output of its rows, in two phases over its heads: first
//   each head's state and inter terms (as ssd_chunk_bwd_tc's, g and
//   h_prev double-buffered), then each head's tiles: the diagonal (K, K),
//   the tiles below it, (I, K) for I > K (dx_K and the column sums of V),
//   and beside it, (K, J) for J < K (the row sums of T), the other row
//   blocks' dy or x and C or B streamed through a two-stage cp.async
//   ring, each tile's dW o E o dt added to the group's sum for that tile
//   in shared memory, where g and h_prev were.  At the group's end dB_K
//   += sum^T . C_I and dC_K += sum . B_J, once a tile as
//   ssd_chunk_bwd_tc's once a chunk.  A tile off the diagonal is formed
//   by two blocks (C . B^T and dW twice), and every output element is
//   summed by one block in a fixed order; only the chunk's dcum_last
//   gathers terms from every row block (sum_j d_j U_j, and exp(cum_last)
//   <g, h_prev>), which each block writes to `tails` and the wrapper adds
//   in a fixed order.
// * ssd_chunk_bwd_tf32_tiled (fp32 at Q = 128, 192 or 256, P = 64, N = 64
//   or 128): ssd_chunk_bwd_tc_tiled's block, one per (chunk, 64-row block
//   K, group of G heads, batch), with ssd_chunk_bwd_tf32's TF32 products
//   (three a product, operands split as read).  In fp32 that kernel's
//   layout would take 327,712 bytes of shared memory at N = 128, Q = 256,
//   so the work is ordered to need 229,408: first each head's state and
//   inter terms and its diagonal tile, g and h_prev single-buffered where
//   the second phase's ring is, (C_K . B_K^T)^T formed once for the group
//   and the group's dW o E o dt on the diagonal summed in registers;
//   then each off-diagonal tile for every head of the group, its C . B^T
//   formed once and its summed dW o E o dt multiplied with C_I or B_J
//   once (no per-tile group sums are kept), the heads' x and dy tiles
//   streamed through a two-stage ring.  The second phase adds its dx,
//   dcum, ddt, dB and dC terms to what the first wrote, in a fixed order.
// * ssd_carry_bwd_tc (bf16 at Q = 64, 128, 192 or 256, P = 64, N = 64 or
//   128): one block per (slice of kCarryRows = 32
//   rows of N, head, batch); its first two warps walk forward, the other
//   two back, each pair at its own pace.  The forward walk streams
//   the state slices through a kCarryStages-deep cp.async ring, each
//   thread copying and reading only its own float4s (no barrier); the
//   reverse walk rings the chunk's C slice, dy tile and cum column
//   (kCarryStages - 1 chunks in flight, a named barrier per step) and
//   forms (exp(cum) o C)^T . dy on mma.sync: C's slice is the A operand
//   (ldmatrix.trans), scaled by exp(cum_i) and split into kBwdTerms bf16
//   terms (scaling C's side splits a quarter as many values a thread as
//   scaling dy's, for the same exactness), dy the B operand as read.
//   h and g stay in fp32 registers.  Cutting N into slices gives more
//   walks in flight (384 blocks of 128 threads at the shape above with
//   32 rows, against the 96 (batch, head) pairs) and each block reads
//   only its slice of C; dy is read once per slice, from L2 for all but
//   the first.  The slice was set by measurement (H100 80GB HBM3,
//   700 W, the two slices timed in turns): at [2, 4096, 48, 64, 128, 64]
//   32 rows took 0.36342 ms against 0.37925 for 64; at N = 64 the two
//   were within the runs' spread (0.25530 / 0.26078 in one run, 0.24267
//   / 0.22627 in another).
//   A chunk of Q = 64 S rows (S = 1 to 4, a template parameter) is S
//   slabs of 64 rows: the ring stages hold one slab each, the reverse walk
//   takes a step a slab (the chunk's slabs in order, each slab's product
//   added into the same accumulators), and g is stored and decayed once
//   the chunk's last slab is in.  Shared memory is that of Q = 64 but for
//   a decay table of L / Q entries; the walk issues the products of
//   Q = 64 for the same L, with 1 / S as many serial g updates.
// * ssd_carry_bwd_tf32 (fp32 at the shapes above and at Q = 128, 192,
//   256): ssd_carry_bwd_tc's block, warps, rings, slabs and slices
//   (carry_bwd_walk serves both), with
//   fp32 C slices and dy tiles in the rings.  The forward walk is the same
//   code.  The reverse walk forms (exp(cum) o C)^T . dy on mma.sync
//   m16n8k8 in TF32, three TF32 products a product: C's slice is the A
//   operand, read MN-major (rows c and c + 4 of each k8 step, column g),
//   scaled by exp(cum_i) as it is read and then split; dy is the B
//   operand, split as it is read.  Rows of NS + 8 and P + 8 words (8 (mod
//   32)) keep both reads free of bank conflicts.  At 32 rows of N, 64
//   chunks take ~109 KB a block: two blocks an SM.  g stays in fp32
//   registers; no atomics, a fixed order: two passes are equal bit for
//   bit.  Bound: bytes; its products at three TF32 products a product
//   take about a quarter of the byte bound at mamba2-780m's heads.
// * ssd_chunk_bwd_tf32 (fp32 at the shapes above): ssd_chunk_bwd_tc's
//   block, warps, product list, partial sums and barriers on mma.sync
//   m16n8k8 in TF32, every product three TF32 products (hi·hi + hi·lo +
//   lo·hi) on operands split as they reach the registers (two integer
//   operations a split: no split planes are stored).  x, dy, g and h_prev
//   are fp32 tiles swizzled as the fp32 flash-attention kernels' are
//   (swz64), read K-major with ldmatrix and MN-major as rows 2c, 2c + 1
//   in the permuted slots; B and C are rows of N + 8 words, read K-major
//   as one 8-byte load of columns 2c, 2c + 1 and MN-major as rows c,
//   c + 4.  At N = 128 one head's x, dy, g and h_prev take 96 KB, so only
//   x and dy are double-buffered: the next head's g and h_prev are copied
//   into the single buffers once the head's last product that reads them
//   (B . g, x . g^T, dy . h_prev^T, done first) is through, while the
//   block computes dW^T and dx's intra term (227,872 bytes at G = 16).
//   The summed dW o E o dt is staged twice at the group's end (rows j
//   over the x buffers, rows i over the dy buffers) so that both of its
//   products read it K-major.  No atomics and a fixed order: two passes
//   are equal bit for bit.  Its products at three TF32 products a product
//   take about 0.6 of its byte bound at mamba2-780m's heads.
// * ssd_carry_bwd and ssd_chunk_bwd (every other shape): the CUDA cores,
//   fp32 arithmetic (bf16 inputs converted exactly as read); tc = 0 at
//   the entry points runs them at any shape.
//   ssd_carry_bwd: one block per (slice of PS columns of P, head, batch),
//   each thread two rows of N and four columns, both walks in registers;
//   the reverse walk stages the chunk's C and exp(cum_i) dy_i in shared
//   memory and forms C^T . dy on the CUDA cores (any chunk up to 256
//   rows: C and the slice of dy take 4 Q (N + PS) bytes).
//   ssd_chunk_bwd: one block of 256 threads per (chunk, group of G heads,
//   batch), chunks of 1 to 256 rows walked in blocks of up to 64 rows
//   (kBwdRows): first each block of rows for every term it alone gives
//   (state, inter, and the intra term of the block with itself), then
//   each pair of blocks (i > j) for the rest of the intra term, C_i .
//   B_j^T once a pair in shared memory with B and C (transposed, fp32),
//   every product as 4 x 4 register tiles over two k-major operands in
//   shared memory.  At Q <= 64 it is the first port's kernel.
//   dx, dcum, ddt and the dB and dC partials are summed in the outputs,
//   which only this block writes, each element by one thread in a fixed
//   order: dx_j and dB_j over the blocks i at or above j, dC_i over the
//   blocks j at or below i, dcum over both sides.

#include "ssd_mma.cuh"

namespace {

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

// ssd_chunk_bwd walks a chunk in blocks of kBwdRows rows, or of the
// chunk rounded up to a multiple of 4 when it is shorter; rows past the
// chunk are zeros in shared memory and are never written out.
constexpr int kBwdRows = 64;
constexpr int kMaxGroup = 16;   // heads a block at most
constexpr int kBwdVecs = 10;    // vectors of a block's rows

__host__ __device__ inline int bwd_rows(int Q) {
  const int r = (Q + 3) / 4 * 4;
  return r < kBwdRows ? r : kBwdRows;
}

// Shared-memory layout of ssd_chunk_bwd, in floats; rows padded by 4 so
// that they stay 16-byte aligned.
struct ChunkBwdSmem {
  int T, ldq, ldn, ldp;
  size_t bt, ct, cb, dcbt, xt, dyt, dyr, un, vec, total;
  // kernel.py's chunk_bwd_smem_bytes is the same sum.
  __host__ __device__ ChunkBwdSmem(int Q, int N, int P) {
    T = bwd_rows(Q);
    ldq = T + 4;
    ldn = N + 4;
    ldp = P + 4;
    bt = 0;                                // [N][ldq]  B of a block, ^T
    ct = bt + (size_t)N * ldq;             // [N][ldq]  C of a block, ^T
    cb = ct + (size_t)N * ldq;             // [T][ldq]  C_i . B_j^T
    dcbt = cb + (size_t)T * ldq;           // [T][ldq]  sum_h dW o E o dt, ^T
    xt = dcbt + (size_t)T * ldq;           // [P][ldq]  x of a block, ^T
    dyt = xt + (size_t)P * ldq;            // [P][ldq]  dy of a block, ^T
    dyr = dyt + (size_t)P * ldq;           // [T][ldp]  dy of block i
    un = dyr + (size_t)T * ldp;            // the union below
    // g [N][ldp] and g^T [P][ldn] (h_prev^T replaces g^T); then K and V,
    // [T][ldq] each; at a pair's end B_j and C_i, [T][ldn] each.
    size_t u = (size_t)N * ldp + (size_t)P * ldn;
    if (2 * (size_t)T * ldq > u) u = 2 * (size_t)T * ldq;
    if (2 * (size_t)T * ldn > u) u = 2 * (size_t)T * ldn;
    vec = un + u;                          // kBwdVecs vectors of T
    total = vec + kBwdVecs * (size_t)T + kMaxGroup;
  }
};

// One (chunk, group of G heads, batch) per block, the chunk in blocks of
// T rows (bwd_rows).  Phase 1, for each block k of rows in order: for
// each head, every term of those rows that block k alone gives — the
// state and inter terms (dx's d_j B_j^T g, <B_j (x) x_j, g>, the inter
// term of dcum; dB's g x_j and dC's h_prev dy_i summed over the heads in
// registers) and the intra term of the pair (k, k) (dW = dy . x^T at or
// below the diagonal, K, V = dW o K and the running sum over the heads of
// dW o E o dt; the row and column sums of V; dx's K^T dy) — then dC_k
// and dB_k from the registers and that running sum; each written once.
// At Q <= 64 that is the whole chunk, in the order the first port's
// kernel summed it.  Phase 2, for each pair of blocks (i, j) with i > j,
// j the outer walk, i the inner: C_i . B_j^T; for each head, dW, K and V
// of the pair's tile and the running sum of dW o E o dt; dcum_i += row
// sums of V o dt, dcum_j -= dt_j . column sums of V, ddt_j += the
// column sums, dx_j += dt_j (K^T dy_i); at the pair's end dC_i += (sum_h
// dW o E o dt) . B_j and dB_j += its transpose . C_i — each added to
// what the block wrote, by the thread that wrote it or after a barrier,
// so every element sums in a fixed order and two runs are equal.
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
  const int TR = lay.T, ldq = lay.ldq, ldn = lay.ldn, ldp = lay.ldp;
  float* bt = sm + lay.bt;
  float* ct = sm + lay.ct;
  float* cb = sm + lay.cb;
  float* dcbt = sm + lay.dcbt;
  float* xt = sm + lay.xt;
  float* dyt = sm + lay.dyt;
  float* dyr = sm + lay.dyr;
  float* gr = sm + lay.un;                 // g [N][ldp]
  float* gt = gr + (size_t)N * ldp;        // g^T, then h_prev^T [P][ldn]
  float* kk = sm + lay.un;                 // K [T][ldq]
  float* vv = kk + (size_t)TR * ldq;       // V = dW o K [T][ldq]
  float* brm = sm + lay.un;                // B_j [T][ldn] (a pair's end)
  float* crm = brm + (size_t)TR * ldn;     // C_i [T][ldn]
  float* ecum = sm + lay.vec;              // exp(cum_i)
  float* dex = ecum + TR;                  // exp(cum_last - cum_j)
  float* dd = dex + TR;                    // d_j = dex_j dt_j
  float* ured = dd + TR;                   // <B_j (x) x_j, g>
  float* inter = ured + TR;                // exp(cum_i) <C_i . h_prev, dy_i>
  float* dtsj = inter + TR;                // dt_j
  float* cumsj = dtsj + TR;                // cum_j
  float* cumsi = cumsj + TR;               // cum_i (phase 2)
  float* rowt = cumsi + TR;                // sum_j T_ij over block j
  float* colv = rowt + TR;                 // sum_i V_ij over block i
  float* tails = colv + TR;                // [G]: dcum_last's chunk terms
  __shared__ float red[kThreads / 32];
  __shared__ float gh_sum;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * G;
  const int nc = L / Q;
  const int nb = (Q + TR - 1) / TR;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int qt = TR / 4, ntn = N / 4, ptn = P / 4;
  const int sq_tiles = qt * qt, qn_tiles = qt * ntn, qp_tiles = qt * ptn;
  const int64_t part0 = ((int64_t)grp * gridDim.z * L) * N;  // this group
  // This thread's 4 x 4 tile of a [T, P] product (dx) and its rows.
  const int xj0 = (tid / ptn) * 4, xp0 = (tid % ptn) * 4;
  // Rows r0.. of B or C, transposed into dst, zeros past the chunk.
  auto load_t = [&](float* dst, const T* src, int r0) {
    for (int e = tid; e < TR * N; e += kThreads) {
      const int i = e / N, n = e % N;
      dst[n * ldq + i] = r0 + i < Q ? to_f(src[(row0 + r0 + i) * N + n])
                                    : 0.f;
    }
  };
  // Rows r0.. of B and C, row-major into the union, zeros past the chunk.
  auto load_rows = [&](int jb, int ib) {
    for (int e = tid; e < TR * N; e += kThreads) {
      const int i = e / N, n = e % N;
      brm[i * ldn + n] = jb + i < Q ? to_f(bm[(row0 + jb + i) * N + n])
                                    : 0.f;
      crm[i * ldn + n] = ib + i < Q ? to_f(cm[(row0 + ib + i) * N + n])
                                    : 0.f;
    }
  };
  // C_i . B_j^T from ct and bt on the 4 x 4 tiles (at or below the
  // diagonal's when i = j).
  auto c_bt = [&](bool diag) {
    if (tid < sq_tiles && (!diag || tid % qt <= tid / qt)) {
      const int a0 = (tid / qt) * 4, c0 = (tid % qt) * 4;
      float acc[4][4] = {};
      mac4x4(acc, 0, N, [&](int k) { return ld4(ct + k * ldq + a0); },
             [&](int k) { return ld4(bt + k * ldq + c0); });
#pragma unroll
      for (int r = 0; r < 4; ++r)
        st4(cb + (a0 + r) * ldq + c0,
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
  };
  // dW = dy_i . x_j^T on the tiles (at or below the diagonal's when
  // i = j); K, V and the running sum of dW o E o dt.  E is taken only at
  // i >= j within the chunk (ni, nj rows of the two blocks).
  auto intra_tiles = [&](bool diag, const float* ci_, int ni, int nj,
                         int di) {
    if (tid >= sq_tiles) return;
    const int mt = tid / qt, nt = tid % qt;
    const int a0 = mt * 4, c0 = nt * 4;
    float dw[4][4] = {};
    if (!diag || nt <= mt)
      mac4x4(dw, 0, P, [&](int k) { return ld4(dyt + k * ldq + a0); },
             [&](int k) { return ld4(xt + k * ldq + c0); });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float kr[4], vr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = a0 + r, j = c0 + q;
        kr[q] = 0.f;
        vr[q] = 0.f;
        if (i < ni && j < nj && di + i >= j) {
          const float e = expf(ci_[i] - cumsj[j]);
          kr[q] = cb[i * ldq + j] * e;
          vr[q] = dw[r][q] * kr[q];
          dcbt[j * ldq + i] = fmaf(dw[r][q] * e, dtsj[j], dcbt[j * ldq + i]);
        }
      }
      st4(kk + (a0 + r) * ldq + c0, make_float4(kr[0], kr[1], kr[2], kr[3]));
      st4(vv + (a0 + r) * ldq + c0, make_float4(vr[0], vr[1], vr[2], vr[3]));
    }
  };
  // Row sums of V o dt into rowt, column sums of V into colv.
  auto row_col_sums = [&](bool diag) {
    if (tid < TR) {
      const int jn = diag ? tid + 1 : TR;
      float s = 0.f;
      for (int j = 0; j < jn; ++j) s = fmaf(vv[tid * ldq + j], dtsj[j], s);
      rowt[tid] = s;
    } else if (tid < 2 * TR) {
      const int j = tid - TR;
      float s = 0.f;
      for (int i = diag ? j : 0; i < TR; ++i) s += vv[i * ldq + j];
      colv[j] = s;
    }
  };
  // K^T dy_i for this thread's dx tile.
  auto kt_dy = [&](bool diag, float (&acc)[4][4]) {
    mac4x4(acc, diag ? xj0 : 0, TR,
           [&](int k) { return ld4(kk + k * ldq + xj0); },
           [&](int k) { return ld4(dyr + k * ldp + xp0); });
  };
  // (sum_h dW o E o dt) . B_j (rows a0.. of block i) and its transpose
  // . C_i (rows a0.. of block j) for output tile t of a [T, N] product.
  auto dcb_products = [&](bool diag, int a0, int n0, float (&acc)[4][4],
                          float (&acc2)[4][4]) {
    mac4x4(acc, 0, diag ? min(TR, a0 + 4) : TR,
           [&](int k) { return ld4(dcbt + k * ldq + a0); },
           [&](int k) { return ld4(brm + k * ldn + n0); });
    mac4x4(acc2, diag ? a0 : 0, TR,
           [&](int k) {
             return make_float4(dcbt[a0 * ldq + k], dcbt[(a0 + 1) * ldq + k],
                                dcbt[(a0 + 2) * ldq + k],
                                dcbt[(a0 + 3) * ldq + k]);
           },
           [&](int k) { return ld4(crm + k * ldn + n0); });
  };

  // Phase 1: block k of rows by block k, every term it alone gives.
  for (int K = 0; K < nb; ++K) {
    const int k0 = K * TR, nk = min(TR, Q - k0);
    __syncthreads();  // every thread is done with the last block's tiles
    load_t(bt, bm, k0);
    load_t(ct, cm, k0);
    for (int e = tid; e < TR * ldq; e += kThreads) dcbt[e] = 0.f;
    __syncthreads();
    c_bt(true);
    float db[MT][4][4] = {}, dc[MT][4][4] = {};
    for (int gi = 0; gi < G; ++gi) {
      const int h = h0 + gi;
      const int64_t st = (((int64_t)b * nc + c) * H + h) * (int64_t)N * P;
      __syncthreads();  // C . B^T is complete; the last head is done
      for (int e = tid; e < TR * P; e += kThreads) {
        const int i = e / P, p = e % P;
        const bool ok = i < nk;
        const int64_t o = ((row0 + k0 + i) * H + h) * P + p;
        const float dv = ok ? to_f(dy[o]) : 0.f;
        xt[p * ldq + i] = ok ? to_f(x[o]) : 0.f;
        dyt[p * ldq + i] = dv;
        dyr[i * ldp + p] = dv;
      }
      const float cl = cum[(row0 + Q - 1) * H + h];
      for (int i = tid; i < TR; i += kThreads) {
        float ci = 0.f, ti = 0.f, e = 0.f, de = 0.f;
        if (i < nk) {
          ci = cum[(row0 + k0 + i) * H + h];
          ti = dt[(row0 + k0 + i) * H + h];
          e = expf(ci);
          de = expf(cl - ci);
        }
        dtsj[i] = ti;
        cumsj[i] = ci;
        ecum[i] = e;
        dex[i] = de;
        dd[i] = de * ti;
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
              part[r] = fmaf(bt[(n0 + q) * ldq + i0 + r], tmp[r][q],
                             part[r]);
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
              part[r] = fmaf(ct[(n0 + q) * ldq + i0 + r], tmp[r][q],
                             part[r]);
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

      // Intra term of the pair (k, k).
      intra_tiles(true, cumsj, nk, nk, 0);
      __syncthreads();
      row_col_sums(true);
      if (tid < qp_tiles) {
        float acc[4][4] = {};
        kt_dy(true, acc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (xj0 + r >= nk) break;
          const float tj = dtsj[xj0 + r];
          st4(dx + ((row0 + k0 + xj0 + r) * H + h) * P + xp0,
              make_float4(fmaf(tj, acc[r][0], dxa[r][0]),
                          fmaf(tj, acc[r][1], dxa[r][1]),
                          fmaf(tj, acc[r][2], dxa[r][2]),
                          fmaf(tj, acc[r][3], dxa[r][3])));
        }
      }
      __syncthreads();
      if (tid < nk) {
        const int j = tid;
        const int64_t o = (row0 + k0 + j) * H + h;
        dcum[o] = rowt[j] - dtsj[j] * colv[j] - dd[j] * ured[j] + inter[j];
        ddt[o] = fmaf(dex[j], ured[j], colv[j]);
      }
      if (tid == 0) {   // dcum_last: exp(cum_last) <g, h_prev> + sum d U
        float s = K == 0 ? expf(cl) * gh_sum : tails[gi];
        for (int k = 0; k < nk; ++k) s = fmaf(dd[k], ured[k], s);
        tails[gi] = s;
      }
    }

    // This block's rows of the group's dB and dC: the registers' terms
    // and the pair (k, k)'s, with B and C row-major in the union.
    __syncthreads();
    load_rows(k0, k0);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int t = tid + m * kThreads;
      if (t >= qn_tiles) continue;
      const int a0 = (t / ntn) * 4, n0 = (t % ntn) * 4;
      float acc[4][4] = {}, acc2[4][4] = {};
      dcb_products(true, a0, n0, acc, acc2);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (a0 + r >= nk) break;
        const int64_t o = part0 + (row0 + k0 + a0 + r) * N + n0;
        st4(dc_part + o,
            make_float4(dc[m][r][0] + acc[r][0], dc[m][r][1] + acc[r][1],
                        dc[m][r][2] + acc[r][2], dc[m][r][3] + acc[r][3]));
        st4(db_part + o,
            make_float4(db[m][r][0] + acc2[r][0], db[m][r][1] + acc2[r][1],
                        db[m][r][2] + acc2[r][2], db[m][r][3] + acc2[r][3]));
      }
    }
  }
  __syncthreads();
  if (tid < G) dcum[(row0 + Q - 1) * H + h0 + tid] += tails[tid];

  // Phase 2: the intra term of each pair of blocks (i, j), i > j.
  for (int J = 0; J + 1 < nb; ++J) {
    const int j0 = J * TR, nj = min(TR, Q - j0);
    for (int I = J + 1; I < nb; ++I) {
      const int i0b = I * TR, ni = min(TR, Q - i0b);
      __syncthreads();  // every thread is done with the last pair's tiles
      load_t(bt, bm, j0);
      load_t(ct, cm, i0b);
      for (int e = tid; e < TR * ldq; e += kThreads) dcbt[e] = 0.f;
      __syncthreads();
      c_bt(false);

      for (int gi = 0; gi < G; ++gi) {
        const int h = h0 + gi;
        __syncthreads();  // C_i . B_j^T is complete; the last head is done
        for (int e = tid; e < TR * P; e += kThreads) {
          const int i = e / P, p = e % P;
          xt[p * ldq + i] =
              i < nj ? to_f(x[((row0 + j0 + i) * H + h) * P + p]) : 0.f;
          const float dv =
              i < ni ? to_f(dy[((row0 + i0b + i) * H + h) * P + p]) : 0.f;
          dyt[p * ldq + i] = dv;
          dyr[i * ldp + p] = dv;
        }
        for (int i = tid; i < TR; i += kThreads) {
          dtsj[i] = i < nj ? dt[(row0 + j0 + i) * H + h] : 0.f;
          cumsj[i] = i < nj ? cum[(row0 + j0 + i) * H + h] : 0.f;
          cumsi[i] = i < ni ? cum[(row0 + i0b + i) * H + h] : 0.f;
        }
        __syncthreads();
        intra_tiles(false, cumsi, ni, nj, i0b - j0);
        __syncthreads();
        row_col_sums(false);
        if (tid < qp_tiles) {   // dx_j += dt_j (K^T dy_i)_j
          float acc[4][4] = {};
          kt_dy(false, acc);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (xj0 + r >= nj) break;
            const float tj = dtsj[xj0 + r];
            float* o = dx + ((row0 + j0 + xj0 + r) * H + h) * P + xp0;
            const float4 v = ld4(o);
            st4(o, make_float4(fmaf(tj, acc[r][0], v.x),
                               fmaf(tj, acc[r][1], v.y),
                               fmaf(tj, acc[r][2], v.z),
                               fmaf(tj, acc[r][3], v.w)));
          }
        }
        __syncthreads();
        if (tid < TR) {   // rows tid of blocks i and j: distinct elements
          if (tid < ni) dcum[(row0 + i0b + tid) * H + h] += rowt[tid];
          if (tid < nj) {
            const int64_t o = (row0 + j0 + tid) * H + h;
            dcum[o] -= dtsj[tid] * colv[tid];
            ddt[o] += colv[tid];
          }
        }
      }

      // dC_i += (sum_h dW o E o dt) . B_j and dB_j += its transpose . C_i.
      __syncthreads();
      load_rows(j0, i0b);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int t = tid + m * kThreads;
        if (t >= qn_tiles) continue;
        const int a0 = (t / ntn) * 4, n0 = (t % ntn) * 4;
        float acc[4][4] = {}, acc2[4][4] = {};
        dcb_products(false, a0, n0, acc, acc2);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (a0 + r < ni) {
            float* o = dc_part + part0 + (row0 + i0b + a0 + r) * N + n0;
            const float4 v = ld4(o);
            st4(o, make_float4(v.x + acc[r][0], v.y + acc[r][1],
                               v.z + acc[r][2], v.w + acc[r][3]));
          }
          if (a0 + r < nj) {
            float* o = db_part + part0 + (row0 + j0 + a0 + r) * N + n0;
            const float4 v = ld4(o);
            st4(o, make_float4(v.x + acc2[r][0], v.y + acc2[r][1],
                               v.z + acc2[r][2], v.w + acc2[r][3]));
          }
        }
      }
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

// ---------------------------------------------------------------------------
// Tensor-core kernels: bf16 x, B, C and dy at Q = P = 64, N = 64 or 128
// ---------------------------------------------------------------------------

constexpr int kBwdTerms = 2;        // bf16 terms of an fp32 operand
constexpr int kTQ = 64;             // chunk rows
constexpr int kTP = 64;             // head width
constexpr int kLdX = kTP + 8;       // padded bf16 row of x and dy: the
                                    // rows of an ldmatrix on distinct banks
constexpr int kTcThreads = 256;     // ssd_chunk_bwd_tc: 4 row tiles x 2
constexpr int kRedFloats = 10 * kTQ + 8;  // its per-head partial sums
constexpr int kCarryStages = 3;     // ssd_carry_bwd_tc's copy ring
constexpr int kCarryRows = 32;      // ssd_carry_bwd_tc's slice of N

// Byte offset of (n, p) in a bf16 plane of a g or h_prev tile ([N][64],
// rows of 128 bytes): the 16-byte column group moves by the row's low
// three bits, so that the eight rows an ldmatrix reads at one column
// group sit on distinct banks, with no padding.
__device__ __forceinline__ int plane_off(int n, int p) {
  return n * 128 + ((((p >> 3) ^ n) & 7) << 4) + (p & 7) * 2;
}

// bar.sync with an explicit thread count, which PTX counts per warp: the
// barrier for threads that reach it from different code in warp-uniform
// branches (ssd_chunk_bwd_tc's two column halves, ssd_carry_bwd_tc's
// reverse walk), where __syncthreads() would sit under a divergent
// condition.
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The sum over the eight lanes of a fragment column (lane / 4 = 0..7);
// segment_sum(v, 4) is the sum over the four lanes of a fragment row.
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Shared-memory layout of ssd_chunk_bwd_tc, in bytes
// (ssd_bwd_tc_smem_bytes reports it).
struct ChunkTcSmem {
  size_t c, b, cb, x, dy, g, hp, dts, cums, red, total;
  __host__ __device__ ChunkTcSmem(int N, int G) {
    const size_t bc = (size_t)kTQ * (N + 8) * 2;  // C or B, bf16
    const size_t xd = (size_t)kTQ * kLdX * 2;     // one x or dy buffer
    const size_t st = (size_t)N * kTP * 4;        // one g or h_prev buffer
    c = 0;
    b = c + bc;
    cb = b + bc;         // (C . B^T)^T fragments: [4 row tiles][8][32] x 4
    x = cb + 4 * 8 * 32 * 16;   // 2 buffers
    dy = x + 2 * xd;     // 2 buffers
    g = dy + 2 * xd;     // 2 buffers
    hp = g + 2 * st;     // 2 buffers
    dts = hp + 2 * st;   // [G][kTQ]
    cums = dts + (size_t)G * kTQ * 4;
    red = cums + (size_t)G * kTQ * 4;
    total = red + (size_t)kRedFloats * 4;
  }
};

// The work of one warp of ssd_chunk_bwd_tc: rows 16 r .. 16 r + 15 of the
// chunk (j for dx, dB and the K tile, i for dC) and half S of the columns
// of each product (i for dW and the running dC . B^T gradient, p for dx,
// n for dB and dC).  S is a template parameter so that every register
// array is indexed by constants.
template <int N, int NT, int S>
__device__ __forceinline__ void chunk_bwd_tc_warp(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const float* __restrict__ g, const float* __restrict__ hp,
    float* __restrict__ dx, float* __restrict__ dcum,
    float* __restrict__ ddt, float* __restrict__ db_part,
    float* __restrict__ dc_part, unsigned char* smem_raw, int L, int H,
    int G) {
  constexpr int kLdN = N + 8;   // padded bf16 row of B and C
  constexpr int NH = N / 2;     // this warp's half of N
  constexpr int NTN = NH / 8;   // its n8 tiles
  const ChunkTcSmem lay(N, G);
  const bf16* cs = reinterpret_cast<const bf16*>(smem_raw + lay.c);
  const bf16* bs = reinterpret_cast<const bf16*>(smem_raw + lay.b);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + lay.x);
  bf16* dys = reinterpret_cast<bf16*>(smem_raw + lay.dy);
  float* gs = reinterpret_cast<float*>(smem_raw + lay.g);
  float* hs = reinterpret_cast<float*>(smem_raw + lay.hp);
  float4* cbs = reinterpret_cast<float4*>(smem_raw + lay.cb);
  const float* dts = reinterpret_cast<const float*>(smem_raw + lay.dts);
  const float* cums = reinterpret_cast<const float*>(smem_raw + lay.cums);
  float* red_rowt = reinterpret_cast<float*>(smem_raw + lay.red);  // [4][Q]
  float* red_colv = red_rowt + 4 * kTQ;    // [2][Q]: sum_i V_ij by half
  float* red_ured = red_colv + 2 * kTQ;    // [2][Q]: <B_j (x) x_j, g>
  float* red_inter = red_ured + 2 * kTQ;   // [2][Q]: <C_i . h_prev, dy_i>
  float* red_gh = red_inter + 2 * kTQ;     // [8]: <g, h_prev> by warp

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane >> 2, cq = lane & 3;
  const int r = warp & 3, j0 = 16 * r;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * kTQ;
  // The A fragment of rows j0.. of a padded bf16 tile, k16 step k.
  auto frag_rows = [&](uint32_t(&a)[4], const bf16* t, int ld, int k) {
    ldsm_x4(a, t + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + 16 * k +
                   (lane >> 4) * 8);
  };
  // The B fragments of n-tiles 2 m and 2 m + 1 of a padded bf16 tile
  // stored [n][k] (rows 16 m ..), k16 step k.
  auto frag_cols = [&](uint32_t(&q)[4], const bf16* t, int ld, int m,
                       int k) {
    ldsm_x4(q, t + (16 * m + (lane & 7) + (lane >> 4) * 8) * ld + 16 * k +
                   ((lane >> 3) & 1) * 8);
  };
  // The B fragments of n-tiles 2 m and 2 m + 1 of a padded bf16 tile
  // stored [k][n] (columns 16 m ..), k16 step k.
  auto frag_cols_t = [&](uint32_t(&q)[4], const bf16* t, int ld, int m,
                         int k) {
    ldsm_x4_t(q, t + (16 * k + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                     16 * m + (lane >> 4) * 8);
  };
  // x, dy, g and h_prev of head h into buffer `buf` with cp.async: this
  // warp's share of the block's copies.
  auto load_head = [&](int h, int buf) {
    bf16* xd = xs + buf * kTQ * kLdX;
    bf16* dd = dys + buf * kTQ * kLdX;
    for (int e = tid; e < kTQ * (kTP / 8); e += kTcThreads) {
      const int i = e >> 3, k8 = (e & 7) * 8;
      const int64_t o = ((row0 + i) * H + h) * kTP + k8;
      cp_async16(xd + i * kLdX + k8, x + o);
      cp_async16(dd + i * kLdX + k8, dy + o);
    }
    const int64_t st = (((int64_t)b * nc + c) * H + h) * (int64_t)N * kTP;
    float* gd = gs + buf * N * kTP;
    float* hd = hs + buf * N * kTP;
    for (int e = tid; e < N * (kTP / 4); e += kTcThreads) {
      cp_async16(gd + 4 * e, g + st + 4 * e);
      cp_async16(hd + 4 * e, hp + st + 4 * e);
    }
  };

  // (C . B^T)^T: rows j0.. of B against every row of C, the m16n8 tile t
  // covering columns (i) 8 t ..; only the tiles at or right of the
  // diagonal's (i >= j) are formed.  bf16 inputs: exact products.  It is
  // kept for the group's heads in shared memory in fragment order (one
  // float4 a lane and tile: conflict-free reads), once for both halves:
  // in registers it would leave too few for the rest.
  {
    float cbt[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) cbt[t][e] = 0.f;
#pragma unroll
    for (int kn = 0; kn < N / 16; ++kn) {
      uint32_t a[4];
      frag_rows(a, bs, kLdN, kn);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m < r) continue;
        uint32_t q[4];
        frag_cols(q, cs, kLdN, m, kn);
        mma(cbt[2 * m], a, q[0], q[1]);
        mma(cbt[2 * m + 1], a, q[2], q[3]);
      }
    }
    if (S == 0) {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        cbs[(r * 8 + t) * 32 + lane] =
            make_float4(cbt[t][0], cbt[t][1], cbt[t][2], cbt[t][3]);
    }
  }

  // Over the group's heads: dcb the running sum of dW o E o dt
  // (transposed: rows j, this warp's half of i), dba and dca the running
  // dB (rows j) and dC (rows i) over this warp's half of n.
  float dcb[4][4], dba[NTN][4], dca[NTN][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int t = 0; t < 4; ++t) dcb[t][e] = 0.f;
#pragma unroll
    for (int t = 0; t < NTN; ++t) dba[t][e] = dca[t][e] = 0.f;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = grp * G + gi, buf = gi & 1;
    // Head gi's tiles have landed; every warp is done with head gi - 1
    // (its buffers and the partial sums).
    cp_async_wait_all();
    group_sync(0, kTcThreads);
    if (gi + 1 < G) load_head(h + 1, buf ^ 1);
    cp_async_commit();
    const bf16* xb = xs + buf * kTQ * kLdX;
    const bf16* dyb = dys + buf * kTQ * kLdX;
    unsigned char* gp = reinterpret_cast<unsigned char*>(gs + buf * N * kTP);
    unsigned char* hq = reinterpret_cast<unsigned char*>(hs + buf * N * kTP);
    // g and h_prev split once into their NT = 2 bf16 terms, each a plane
    // (plane_off) in place of the fp32 tile (plane k at byte k N 128): the
    // warps then read every fragment with one ldmatrix, where splitting
    // at each use would split a g value 8 times and an h_prev value 4.
    // <g, h_prev> on the way.
    {
      static_assert(NT == 2, "two bf16 planes fill the fp32 tile exactly");
      constexpr int kPer = N * kTP / 4 / kTcThreads;   // float4s a thread
      float4 gv[kPer], hv[kPer];
      float gh = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + kTcThreads * k;
        gv[k] = reinterpret_cast<const float4*>(gp)[e];
        hv[k] = reinterpret_cast<const float4*>(hq)[e];
        gh = fmaf(gv[k].x, hv[k].x, fmaf(gv[k].y, hv[k].y,
             fmaf(gv[k].z, hv[k].z, fmaf(gv[k].w, hv[k].w, gh))));
      }
      gh = segment_sum(gh, 32);
      if (lane == 0) red_gh[warp] = gh;
      group_sync(0, kTcThreads);   // every read of the fp32 tiles is done
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + kTcThreads * k;
        const int o = plane_off(e >> 4, (e & 15) * 4);
        uint32_t a[2], b[2];
        split<2>(gv[k].x, gv[k].y, a);
        split<2>(gv[k].z, gv[k].w, b);
        *reinterpret_cast<uint2*>(gp + o) = make_uint2(a[0], b[0]);
        *reinterpret_cast<uint2*>(gp + N * 128 + o) = make_uint2(a[1], b[1]);
        split<2>(hv[k].x, hv[k].y, a);
        split<2>(hv[k].z, hv[k].w, b);
        *reinterpret_cast<uint2*>(hq + o) = make_uint2(a[0], b[0]);
        *reinterpret_cast<uint2*>(hq + N * 128 + o) = make_uint2(a[1], b[1]);
      }
      group_sync(0, kTcThreads);   // the planes are complete
    }
    // The B fragments of n-tiles 2 m and 2 m + 1 of term k of a plane
    // pair, k16 step kk: `t` (transposed) for a tile read as [k][n] (k =
    // the row n of g, n = its column p), else as [n][k].
    auto frag_plane = [&](uint32_t(&q)[4], const unsigned char* pl, int k,
                          int m, int kk, bool t) {
      const unsigned char* base = pl + k * N * 128;
      if (t)
        ldsm_x4_t(q, base + plane_off(16 * kk + (lane & 7) +
                                          ((lane >> 3) & 1) * 8,
                                      16 * m + (lane >> 4) * 8));
      else
        ldsm_x4(q, base + plane_off(16 * m + (lane & 7) + (lane >> 4) * 8,
                                    16 * kk + ((lane >> 3) & 1) * 8));
    };
    const float* dg = dts + gi * kTQ;
    const float* cg = cums + gi * kTQ;
    const float cl = cg[kTQ - 1];
    // This thread's two rows, j0 + lg and j0 + lg + 8.
    float dtr[2], cur[2], dr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = j0 + lg + 8 * rr;
      dtr[rr] = dg[j];
      cur[rr] = cg[j];
      dr[rr] = expf(cl - cur[rr]) * dtr[rr];   // d_j
    }

    // dW^T = x . dy^T on this warp's half of i (exact products).
    float dwt[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dwt[t][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      uint32_t a[4];
      frag_rows(a, xb, kLdX, kp);
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        if (2 * S + l < r) continue;
        uint32_t q[4];
        frag_cols(q, dyb, kLdX, 2 * S + l, kp);
        mma(dwt[2 * l], a, q[0], q[1]);
        mma(dwt[2 * l + 1], a, q[2], q[3]);
      }
    }

    // dx's state term on this warp's half of p: B . g (g in NT terms),
    // and <B_j (x) x_j, g> = sum_p x_j[p] (B . g)[j][p] on the way.
    float dxa[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[t][e] = 0.f;
    // The k loops that index no register array stay rolled: unrolled,
    // their hoisted loads and splits leave too few registers at N = 128.
#pragma unroll 2
    for (int kn = 0; kn < N / 16; ++kn) {
      uint32_t a[4];
      frag_rows(a, bs, kLdN, kn);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          uint32_t q[4];
          frag_plane(q, gp, k, 2 * S + m, kn, true);
          mma(dxa[2 * m], a, q[0], q[1]);
          mma(dxa[2 * m + 1], a, q[2], q[3]);
        }
    }
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int pt = 0; pt < 4; ++pt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float2 xv = unpack2(*reinterpret_cast<const uint32_t*>(
            xb + (j0 + lg + 8 * rr) * kLdX + 32 * S + 8 * pt + 2 * cq));
        part[rr] = fmaf(xv.x, dxa[pt][2 * rr],
                        fmaf(xv.y, dxa[pt][2 * rr + 1], part[rr]));
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      part[rr] = segment_sum(part[rr], 4);
      if (cq == 0) red_ured[S * kTQ + j0 + lg + 8 * rr] = part[rr];
#pragma unroll
      for (int pt = 0; pt < 4; ++pt) {
        dxa[pt][2 * rr] *= dr[rr];
        dxa[pt][2 * rr + 1] *= dr[rr];
      }
    }

    // dx's intra term, (K o dt)^T . dy, with K^T o dt built in registers
    // from (C . B^T)^T's fragments k16 step by k16 step (each accumulator
    // pair of n-tiles is one A fragment) and split into NT terms; on this
    // warp's half of i also V = dW o K (row sums: sum_i V_ij; column sums
    // of V o dt_j: sum_j T_ij) and the running sum of dW o E o dt.
    float colp[2] = {0.f, 0.f}, tcol[4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t) tcol[t][0] = tcol[t][1] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < r) continue;    // every i of the step is below j
      uint32_t wa[NT][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 2 * kk + half;
        const int i = 8 * t + 2 * cq;
        const float ci[2] = {cg[i], cg[i + 1]};
        const float4 cb4 = cbs[(r * 8 + t) * 32 + lane];
        const float cbt[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int j = j0 + lg + 8 * rr;
          float w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // E_ij = exp(cum_i - cum_j) for i >= j, else a plain 0.
            const float ex = i + e >= j ? expf(ci[e] - cur[rr]) : 0.f;
            const float kv = cbt[2 * rr + e] * ex;
            w[e] = kv * dtr[rr];
            if ((t >> 2) == S) {
              const int lt = t & 3;   // the tile within this half
              const float dw = dwt[lt][2 * rr + e];
              const float v = dw * kv;
              colp[rr] += v;
              tcol[lt][e] = fmaf(v, dtr[rr], tcol[lt][e]);
              dcb[lt][2 * rr + e] =
                  fmaf(dw * ex, dtr[rr], dcb[lt][2 * rr + e]);
            }
          }
          uint32_t tt[NT];
          split<NT>(w[0], w[1], tt);
#pragma unroll
          for (int k = 0; k < NT; ++k) wa[k][2 * half + rr] = tt[k];
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t q[4];
        frag_cols_t(q, dyb, kLdX, 2 * S + m, kk);
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          mma(dxa[2 * m], wa[k], q[0], q[1]);
          mma(dxa[2 * m + 1], wa[k], q[2], q[3]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* o = dx + ((row0 + j0 + lg + 8 * rr) * H + h) * kTP + 32 * S +
                 2 * cq;
#pragma unroll
      for (int pt = 0; pt < 4; ++pt)
        *reinterpret_cast<float2*>(o + 8 * pt) =
            make_float2(dxa[pt][2 * rr], dxa[pt][2 * rr + 1]);
      colp[rr] = segment_sum(colp[rr], 4);
      if (cq == 0) red_colv[S * kTQ + j0 + lg + 8 * rr] = colp[rr];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = column_sum(tcol[t][e]);
        if (lg == 0) red_rowt[r * kTQ + 32 * S + 8 * t + 2 * cq + e] = v;
      }

    // x . g^T on this warp's half of n, into dB as d_j (x . g^T)_j.
    {
      float acc[NTN][4];
#pragma unroll
      for (int t = 0; t < NTN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t a[4];
        frag_rows(a, xb, kLdX, kp);
#pragma unroll
        for (int m = 0; m < NTN / 2; ++m)
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            uint32_t q[4];
            frag_plane(q, gp, k, S * NTN / 2 + m, kp, false);
            mma(acc[2 * m], a, q[0], q[1]);
            mma(acc[2 * m + 1], a, q[2], q[3]);
          }
      }
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dba[nt][e] = fmaf(dr[e >> 1], acc[nt][e], dba[nt][e]);
    }

    // dy . h_prev^T on this warp's half of n (rows i), into dC as
    // exp(cum_i) (dy . h_prev^T)_i, and <C_i . h_prev, dy_i> on the way.
    {
      float acc[NTN][4];
#pragma unroll
      for (int t = 0; t < NTN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t a[4];
        frag_rows(a, dyb, kLdX, kp);
#pragma unroll
        for (int m = 0; m < NTN / 2; ++m)
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            uint32_t q[4];
            frag_plane(q, hq, k, S * NTN / 2 + m, kp, false);
            mma(acc[2 * m], a, q[0], q[1]);
            mma(acc[2 * m + 1], a, q[2], q[3]);
          }
      }
      float ip[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = j0 + lg + 8 * rr;
        const float ec = expf(cur[rr]);
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt) {
          const float2 cv = unpack2(*reinterpret_cast<const uint32_t*>(
              cs + i * kLdN + S * NH + 8 * nt + 2 * cq));
          ip[rr] = fmaf(cv.x, acc[nt][2 * rr],
                        fmaf(cv.y, acc[nt][2 * rr + 1], ip[rr]));
          dca[nt][2 * rr] = fmaf(ec, acc[nt][2 * rr], dca[nt][2 * rr]);
          dca[nt][2 * rr + 1] =
              fmaf(ec, acc[nt][2 * rr + 1], dca[nt][2 * rr + 1]);
        }
        ip[rr] = segment_sum(ip[rr], 4);
        if (cq == 0) red_inter[S * kTQ + i] = ip[rr];
      }
    }

    group_sync(0, kTcThreads);

    // dcum and ddt of the head's rows, from the partial sums in a fixed
    // order: warp 0, two rows a lane.
    if (warp == 0) {
      float v[2], w[2], tail = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const float rowt = ((red_rowt[j] + red_rowt[kTQ + j]) +
                            red_rowt[2 * kTQ + j]) + red_rowt[3 * kTQ + j];
        const float colv = red_colv[j] + red_colv[kTQ + j];
        const float ured = red_ured[j] + red_ured[kTQ + j];
        const float inter =
            expf(cg[j]) * (red_inter[j] + red_inter[kTQ + j]);
        const float dex = expf(cl - cg[j]), dj = dex * dg[j];
        v[u] = rowt - dg[j] * colv - dj * ured + inter;
        w[u] = fmaf(dex, ured, colv);
        tail = fmaf(dj, ured, tail);
      }
      tail = segment_sum(tail, 32);
      if (lane == 31) {
        float gh = 0.f;
        for (int k = 0; k < kTcThreads / 32; ++k) gh += red_gh[k];
        v[1] += expf(cl) * gh + tail;   // row Q - 1: the chunk's decay
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int64_t o = (row0 + lane + 32 * u) * H + h;
        dcum[o] = v[u];
        ddt[o] = w[u];
      }
    }
  }

  // dB += (sum_h dW o E o dt)^T . C and dC += (sum_h dW o E o dt) . B,
  // the sum staged in fp32 over the g buffers (no copy is in flight) and
  // split into NT terms; then this group's partial sums.
  constexpr int kLdS = kTQ + 4;
  float* scr = gs;   // [j][kLdS]
  group_sync(0, kTcThreads);   // every warp is done with the last head
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<float2*>(scr + (j0 + lg + 8 * rr) * kLdS + 32 * S +
                                 8 * t + 2 * cq) =
          make_float2(dcb[t][2 * rr], dcb[t][2 * rr + 1]);
  group_sync(0, kTcThreads);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < r) continue;   // rows j against i >= j
    uint32_t ta[NT][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(
          scr + (j0 + lg + 8 * (q & 1)) * kLdS + 16 * kk + 2 * cq +
          8 * (q >> 1));
      uint32_t tt[NT];
      split<NT>(v.x, v.y, tt);
#pragma unroll
      for (int k = 0; k < NT; ++k) ta[k][q] = tt[k];
    }
#pragma unroll
    for (int m = 0; m < NTN / 2; ++m) {
      uint32_t q[4];
      frag_cols_t(q, cs, kLdN, S * NTN / 2 + m, kk);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        mma(dba[2 * m], ta[k], q[0], q[1]);
        mma(dba[2 * m + 1], ta[k], q[2], q[3]);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk > r) continue;   // rows i against j <= i
    uint32_t ta[NT][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = j0 + lg + 8 * (q & 1), j = 16 * kk + 2 * cq + 8 * (q >> 1);
      uint32_t tt[NT];
      split<NT>(scr[j * kLdS + i], scr[(j + 1) * kLdS + i], tt);
#pragma unroll
      for (int k = 0; k < NT; ++k) ta[k][q] = tt[k];
    }
#pragma unroll
    for (int m = 0; m < NTN / 2; ++m) {
      uint32_t q[4];
      frag_cols_t(q, bs, kLdN, S * NTN / 2 + m, kk);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        mma(dca[2 * m], ta[k], q[0], q[1]);
        mma(dca[2 * m + 1], ta[k], q[2], q[3]);
      }
    }
  }
  const int64_t part0 = (int64_t)grp * gridDim.z * L * N;   // this group
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t o = part0 + (row0 + j0 + lg + 8 * rr) * N + S * NH +
                      2 * cq;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      *reinterpret_cast<float2*>(db_part + o + 8 * nt) =
          make_float2(dba[nt][2 * rr], dba[nt][2 * rr + 1]);
      *reinterpret_cast<float2*>(dc_part + o + 8 * nt) =
          make_float2(dca[nt][2 * rr], dca[nt][2 * rr + 1]);
    }
  }
}

template <int N, int NT>
__global__ void __launch_bounds__(kTcThreads, 1)
    ssd_chunk_bwd_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ cum,
                     const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                     const bf16* __restrict__ dy, const float* __restrict__ g,
                     const float* __restrict__ hp, float* __restrict__ dx,
                     float* __restrict__ dcum, float* __restrict__ ddt,
                     float* __restrict__ db_part, float* __restrict__ dc_part,
                     int L, int H, int G) {
  constexpr int kLdN = N + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ChunkTcSmem lay(N, G);
  bf16* cs = reinterpret_cast<bf16*>(smem_raw + lay.c);
  bf16* bs = reinterpret_cast<bf16*>(smem_raw + lay.b);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + lay.x);
  bf16* dys = reinterpret_cast<bf16*>(smem_raw + lay.dy);
  float* gs = reinterpret_cast<float*>(smem_raw + lay.g);
  float* hs = reinterpret_cast<float*>(smem_raw + lay.hp);
  float* dts = reinterpret_cast<float*>(smem_raw + lay.dts);
  float* cums = reinterpret_cast<float*>(smem_raw + lay.cums);
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h0 = blockIdx.y * G, b = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * kTQ;

  // B and C once per group, and the first head's x, dy, g and h_prev.
  for (int e = tid; e < kTQ * (N / 8); e += kTcThreads) {
    const int i = e / (N / 8), k8 = (e % (N / 8)) * 8;
    cp_async16(cs + i * kLdN + k8, cm + (row0 + i) * N + k8);
    cp_async16(bs + i * kLdN + k8, bm + (row0 + i) * N + k8);
  }
  for (int e = tid; e < kTQ * (kTP / 8); e += kTcThreads) {
    const int i = e >> 3, k8 = (e & 7) * 8;
    const int64_t o = ((row0 + i) * H + h0) * kTP + k8;
    cp_async16(xs + i * kLdX + k8, x + o);
    cp_async16(dys + i * kLdX + k8, dy + o);
  }
  const int64_t st = (((int64_t)b * nc + c) * H + h0) * (int64_t)N * kTP;
  for (int e = tid; e < N * (kTP / 4); e += kTcThreads) {
    cp_async16(gs + 4 * e, g + st + 4 * e);
    cp_async16(hs + 4 * e, hp + st + 4 * e);
  }
  cp_async_commit();
  for (int e = tid; e < kTQ * G; e += kTcThreads) {
    const int i = e / G, gi = e % G;
    dts[gi * kTQ + i] = dt[(row0 + i) * H + h0 + gi];
    cums[gi * kTQ + i] = cum[(row0 + i) * H + h0 + gi];
  }
  cp_async_wait_all();
  __syncthreads();
  // Warps 0-3 take the first half of each product's columns, 4-7 the
  // second; both run the same barriers in the same order, each a
  // group_sync(0, kTcThreads) reached from its own template body.
  if (tid < kTcThreads / 2)
    chunk_bwd_tc_warp<N, NT, 0>(x, dy, g, hp, dx, dcum, ddt,
                                db_part, dc_part, smem_raw, L, H, G);
  else
    chunk_bwd_tc_warp<N, NT, 1>(x, dy, g, hp, dx, dcum, ddt,
                                db_part, dc_part, smem_raw, L, H, G);
}

template <int N>
cudaError_t launch_chunk_bwd_tc(const void* x, const void* dt,
                                const void* cum, const void* bm,
                                const void* cm, const void* dy,
                                const void* g, const void* hp, void* dx,
                                void* dcum, void* ddt, void* db_part,
                                void* dc_part, int B, int L, int H, int G,
                                cudaStream_t stream) {
  const size_t smem = ChunkTcSmem(N, G).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_tc<N, kBwdTerms>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(L / kTQ, H / G, B);
  ssd_chunk_bwd_tc<N, kBwdTerms><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<const bf16*>(dy),
      static_cast<const float*>(g), static_cast<const float*>(hp),
      static_cast<float*>(dx), static_cast<float*>(dcum),
      static_cast<float*>(ddt), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), L, H, G);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ssd_chunk_bwd_tc_tiled: bf16 at Q = 128, 192, 256, P = 64, N = 64 or 128
// ---------------------------------------------------------------------------

constexpr int kTiledMaxQ = 256;   // four row blocks of kTQ
constexpr int kLdScr = kTQ + 4;   // padded fp32 row of the staging tile

// Shared-memory layout of ssd_chunk_bwd_tc_tiled, in bytes
// (ssd_chunk_bwd_tiled_smem_bytes reports it, kernel.py's
// chunk_bwd_tiled_smem_bytes mirrors it): C_K and B_K of the block's rows
// ([kTQ][N + 8] bf16); two x_K and two dy_K buffers ([kTQ][kLdX] bf16);
// the g and h_prev region ([N][kTP] fp32 each, split in place into two
// bf16 planes; in the second phase the group's sums of dW o E o dt, Q /
// kTQ tiles of kAccTile bytes in fragment order); a two-stage ring of the
// other row blocks' tiles (x_J or dy_I [kTQ][kLdX], B_J or C_I [kTQ][N +
// 8], bf16; in the first phase, with the staging tile after it, a second
// g and h_prev); the staging tile ([kTQ][kLdScr] fp32: a tile's C . B^T
// fragments, or a sum of dW o E o dt); dt and cum of the chunk for two
// heads ([2][2][Q] fp32); and the per-head partial sums (12 . kTQ + 8
// floats).
constexpr size_t kAccTile = 8 * 4 * 32 * 16;   // one tile's sum, bytes

struct TiledBwdSmem {
  size_t c, b, x, dy, ghp, ring, stage, scr, dtc, red, total;
  __host__ __device__ TiledBwdSmem(int N, int Q) {
    const size_t bc = (size_t)kTQ * (N + 8) * 2;
    const size_t xd = (size_t)kTQ * kLdX * 2;
    const size_t st = 2 * (size_t)N * kTP * 4;   // g and h_prev
    const size_t acc = (size_t)(Q / kTQ) * kAccTile;
    c = 0;
    b = c + bc;
    x = b + bc;          // 2 buffers
    dy = x + 2 * xd;     // 2 buffers
    ghp = dy + 2 * xd;
    ring = ghp + (st > acc ? st : acc);   // 2 stages of `stage` bytes:
    stage = xd + bc;                      // x_J or dy_I, then B_J or C_I
    scr = ring + 2 * stage;
    dtc = scr + (size_t)kTQ * kLdScr * 4;
    red = dtc + 4 * (size_t)Q * 4;
    total = red + (12 * (size_t)kTQ + 8) * 4;
  }
};

// The work of one warp of ssd_chunk_bwd_tc_tiled: rows 16 r .. of the
// block's row block K (j for dx, dB and the column side, i for dC and the
// row side) and half S of each product's columns, as chunk_bwd_tc_warp's
// warps.  Two phases over the group's heads.  The first takes each head's
// state and inter terms of rows K (B_K . g, x_K . g^T, dy_K . h_prev^T,
// as ssd_chunk_bwd_tc), with the next head's g and h_prev copied into a
// second buffer meanwhile, and writes dx's, dcum's and ddt's parts of
// them.  The second takes each head's tiles: the diagonal (K, K) as
// ssd_chunk_bwd_tc's chunk; the column side, (I, K) for I > K: dW^T =
// x_K . dy_I^T, dx_K += (K o dt)^T . dy_I and the column sums of V; the
// row side, (K, J) for J < K: dW = dy_K . x_J^T and the row sums of T;
// each tile's dW o E o dt added to the group's sum for that tile in
// shared memory (where g and h_prev were), and dx, dcum and ddt of rows K
// completed.  At the group's end dB_K += sum^T . C_I and dC_K += sum .
// B_J, each tile's sum split once into kBwdTerms bf16 terms, as
// ssd_chunk_bwd_tc does for its one tile.  C . B^T is formed per head and
// tile on mma.sync (exact products), its fragments staged where both
// column halves need them.  dB_K and dC_K are summed over the heads in
// registers and written once; the chunk's dcum_last terms of these rows
// (sum_j d_j U_j, and exp(cum_last) <g, h_prev> in the last row block)
// go into tails, which the wrapper adds to the chunk's last row in a
// fixed order.  Every sum runs in one block in a fixed order, each output
// element read back and written by the thread that wrote it: two passes
// are equal bit for bit.
template <int N, int S>
__device__ __forceinline__ void chunk_bwd_tiled_warp(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cum, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, const bf16* __restrict__ dy,
    const float* __restrict__ g, const float* __restrict__ hp,
    float* __restrict__ dx, float* __restrict__ dcum,
    float* __restrict__ ddt, float* __restrict__ db_part,
    float* __restrict__ dc_part, float* __restrict__ tails,
    unsigned char* smem_raw, int L, int H, int G, int Q) {
  constexpr int NT = kBwdTerms;
  constexpr int kLdN = N + 8;   // padded bf16 row of B and C
  constexpr int NH = N / 2;     // this warp's half of N
  constexpr int NTN = NH / 8;   // its n8 tiles
  const TiledBwdSmem lay(N, Q);
  const bf16* cs = reinterpret_cast<const bf16*>(smem_raw + lay.c);
  const bf16* bs = reinterpret_cast<const bf16*>(smem_raw + lay.b);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + lay.x);
  bf16* dys = reinterpret_cast<bf16*>(smem_raw + lay.dy);
  float4* acc4 = reinterpret_cast<float4*>(smem_raw + lay.ghp);
  float* scr = reinterpret_cast<float*>(smem_raw + lay.scr);
  float4* scr4 = reinterpret_cast<float4*>(scr);
  float* dtc = reinterpret_cast<float*>(smem_raw + lay.dtc);
  float* red_ured = reinterpret_cast<float*>(smem_raw + lay.red);  // [2][64]
  float* red_inter = red_ured + 2 * kTQ;   // [2][64]
  float* red_gh = red_inter + 2 * kTQ;     // [8]
  float* red_rowd = red_gh + 8;            // [4][64]: the diagonal's
  float* red_rows = red_rowd + 4 * kTQ;    // [2][64]: the row side's
  float* red_colv = red_rows + 2 * kTQ;    // [2][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane >> 2, cq = lane & 3;
  const int r = warp & 3, j0 = 16 * r;
  const int nb = Q / kTQ, nc = L / Q;
  const int c = blockIdx.x / nb, K = blockIdx.x % nb;
  const int grp = blockIdx.y, b = blockIdx.z;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;   // the chunk's
  const int64_t rk = row0 + kTQ * K;                      // block K's
  const int ntiles = nb - 1;         // off-diagonal tiles a head
  const int ncol = nb - 1 - K;       // of which on the column side
  auto frag_rows = [&](uint32_t(&a)[4], const bf16* t, int ld, int k) {
    ldsm_x4(a, t + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + 16 * k +
                   (lane >> 4) * 8);
  };
  auto frag_cols = [&](uint32_t(&q)[4], const bf16* t, int ld, int m,
                       int k) {
    ldsm_x4(q, t + (16 * m + (lane & 7) + (lane >> 4) * 8) * ld + 16 * k +
                   ((lane >> 3) & 1) * 8);
  };
  auto frag_cols_t = [&](uint32_t(&q)[4], const bf16* t, int ld, int m,
                         int k) {
    ldsm_x4_t(q, t + (16 * k + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                     16 * m + (lane >> 4) * 8);
  };
  auto ring_t64 = [&](int stage) {
    return reinterpret_cast<bf16*>(smem_raw + lay.ring + stage * lay.stage);
  };
  auto ring_tn = [&](int stage) {
    return reinterpret_cast<bf16*>(smem_raw + lay.ring + stage * lay.stage +
                                   (size_t)kTQ * kLdX * 2);
  };
  // Off-diagonal tile t into ring stage `stage`: the column side (t <
  // ncol) C of row block I = K + 1 + t, the row side B of row block J =
  // t - ncol; and where h >= 0 head h's dy of I or x of J.
  auto load_tile = [&](int h, int t, int stage) {
    const bool col = t < ncol;
    const int64_t r0 = row0 + kTQ * (col ? K + 1 + t : t - ncol);
    const bf16* srn = col ? cm : bm;
    bf16* dn = ring_tn(stage);
    for (int e = tid; e < kTQ * (N / 8); e += kTcThreads) {
      const int i = e / (N / 8), k8 = (e % (N / 8)) * 8;
      cp_async16(dn + i * kLdN + k8, srn + (r0 + i) * N + k8);
    }
    if (h < 0) return;
    const bf16* src = col ? dy : x;
    bf16* d64 = ring_t64(stage);
    for (int e = tid; e < kTQ * (kTP / 8); e += kTcThreads) {
      const int i = e >> 3, k8 = (e & 7) * 8;
      cp_async16(d64 + i * kLdX + k8, src + ((r0 + i) * H + h) * kTP + k8);
    }
  };
  auto load_xdy = [&](int h, int buf) {
    for (int e = tid; e < kTQ * (kTP / 8); e += kTcThreads) {
      const int i = e >> 3, k8 = (e & 7) * 8;
      const int64_t o = ((rk + i) * H + h) * kTP + k8;
      cp_async16(xs + buf * kTQ * kLdX + i * kLdX + k8, x + o);
      cp_async16(dys + buf * kTQ * kLdX + i * kLdX + k8, dy + o);
    }
    float* d = dtc + buf * 2 * Q;   // dt [Q], then cum [Q]
    for (int e = tid; e < 2 * Q; e += kTcThreads) {
      const int j = e < Q ? e : e - Q;
      cp_async4(d + e, (e < Q ? dt : cum) + (row0 + j) * H + h);
    }
  };
  // g and h_prev of head h into buffer p: 0 the g and h_prev region, 1
  // the ring's.
  auto ghp_at = [&](int p) {
    return smem_raw + (p ? lay.ring : lay.ghp);
  };
  auto load_ghp = [&](int h, int p) {
    float* gd = reinterpret_cast<float*>(ghp_at(p));
    float* hd = gd + N * kTP;
    const int64_t st = (((int64_t)b * nc + c) * H + h) * (int64_t)N * kTP;
    for (int e = tid; e < N * (kTP / 4); e += kTcThreads) {
      cp_async16(gd + 4 * e, g + st + 4 * e);
      cp_async16(hd + 4 * e, hp + st + 4 * e);
    }
  };
  // (C_I . B_K^T)^T for this warp's rows j and its half of the columns i,
  // into the staging tile in fragment order ([r][8 n-tiles][32] float4);
  // at the diagonal only the tiles at or right of it.
  auto stage_cbt = [&](const bf16* ct, bool diag) {
    float cbt[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) cbt[t][e] = 0.f;
#pragma unroll 2
    for (int kn = 0; kn < N / 16; ++kn) {
      uint32_t a[4];
      frag_rows(a, bs, kLdN, kn);
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        if (diag && 2 * S + l < r) continue;
        uint32_t q[4];
        frag_cols(q, ct, kLdN, 2 * S + l, kn);
        mma(cbt[2 * l], a, q[0], q[1]);
        mma(cbt[2 * l + 1], a, q[2], q[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      scr4[(r * 8 + 4 * S + t) * 32 + lane] =
          make_float4(cbt[t][0], cbt[t][1], cbt[t][2], cbt[t][3]);
  };
  // This warp's float4 of n-tile lt in the group's sum of tile u (0 the
  // diagonal, 1 + t off-diagonal tile t): its rows, its half of the
  // columns, fragment order.
  auto acc_at = [&](int u, int lt) -> float4& {
    return acc4[((u * 8 + warp) * 4 + lt) * 32 + lane];
  };
  auto accumulate = [&](int u, const float (&v)[4][4]) {
#pragma unroll
    for (int lt = 0; lt < 4; ++lt) {
      float4& a = acc_at(u, lt);
      a = make_float4(a.x + v[lt][0], a.y + v[lt][1], a.z + v[lt][2],
                      a.w + v[lt][3]);
    }
  };
  // The group's sum of tile u into the staging tile, row-major (this
  // warp's rows, its half of the columns).
  auto stage_acc = [&](int u) {
#pragma unroll
    for (int lt = 0; lt < 4; ++lt) {
      const float4 a = acc_at(u, lt);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(scr + (j0 + lg + 8 * rr) * kLdScr +
                                   32 * S + 8 * lt + 2 * cq) =
            rr ? make_float2(a.z, a.w) : make_float2(a.x, a.y);
    }
  };
  // acc[n-tiles of this warp's half of N] += (the staged tile, rows j0..,
  // k16 steps kk_lo .. kk_hi) . tn (stored [k][n]).
  auto staged_times = [&](float (&acc)[NTN][4], const bf16* tn, int kk_lo,
                          int kk_hi) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < kk_lo || kk > kk_hi) continue;
      uint32_t ta[NT][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(
            scr + (j0 + lg + 8 * (q & 1)) * kLdScr + 16 * kk + 2 * cq +
            8 * (q >> 1));
        uint32_t tt[NT];
        split<NT>(v.x, v.y, tt);
#pragma unroll
        for (int k = 0; k < NT; ++k) ta[k][q] = tt[k];
      }
#pragma unroll
      for (int m = 0; m < NTN / 2; ++m) {
        uint32_t q[4];
        frag_cols_t(q, tn, kLdN, S * NTN / 2 + m, kk);
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          mma(acc[2 * m], ta[k], q[0], q[1]);
          mma(acc[2 * m + 1], ta[k], q[2], q[3]);
        }
      }
    }
  };
  // The B fragments of n-tiles 2 m and 2 m + 1 of term k of a plane pair,
  // as chunk_bwd_tc_warp's frag_plane.
  auto frag_plane = [&](uint32_t(&q)[4], const unsigned char* pl, int k,
                        int m, int kk, bool t) {
    const unsigned char* base = pl + k * N * 128;
    if (t)
      ldsm_x4_t(q, base + plane_off(16 * kk + (lane & 7) +
                                        ((lane >> 3) & 1) * 8,
                                    16 * m + (lane >> 4) * 8));
    else
      ldsm_x4(q, base + plane_off(16 * m + (lane & 7) + (lane >> 4) * 8,
                                  16 * kk + ((lane >> 3) & 1) * 8));
  };

  // Over the group's heads: dba and dca the running dB (rows j) and dC
  // (rows i) of this warp's half of n.
  float dba[NTN][4], dca[NTN][4];
#pragma unroll
  for (int t = 0; t < NTN; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dba[t][e] = dca[t][e] = 0.f;

  // Phase 1: each head's state and inter terms of rows K.
  for (int gi = 0; gi < G; ++gi) {
    const int h = grp * G + gi, buf = gi & 1;
    // Head gi's x_K, dy_K, dt, cum, g and h_prev have landed; every warp
    // is done with head gi - 1 (its buffers, the partial sums).
    cp_async_wait_all();
    group_sync(0, kTcThreads);
    // The next head's, or after the last the second phase's first head's
    // x_K, dy_K, dt and cum.
    load_xdy(gi + 1 < G ? h + 1 : grp * G, buf ^ 1);
    if (gi + 1 < G) load_ghp(h + 1, buf ^ 1);
    cp_async_commit();
    const bf16* xb = xs + buf * kTQ * kLdX;
    const bf16* dyb = dys + buf * kTQ * kLdX;
    const float* dg = dtc + buf * 2 * Q;
    const float* cg = dg + Q;
    const float cl = cg[Q - 1];
    unsigned char* gp = ghp_at(buf);
    unsigned char* hq = gp + N * kTP * 4;
    // g and h_prev split once into two bf16 planes, as ssd_chunk_bwd_tc;
    // <g, h_prev> on the way.
    {
      constexpr int kPer = N * kTP / 4 / kTcThreads;
      float4 gv[kPer], hv[kPer];
      float gh = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + kTcThreads * k;
        gv[k] = reinterpret_cast<const float4*>(gp)[e];
        hv[k] = reinterpret_cast<const float4*>(hq)[e];
        gh = fmaf(gv[k].x, hv[k].x, fmaf(gv[k].y, hv[k].y,
             fmaf(gv[k].z, hv[k].z, fmaf(gv[k].w, hv[k].w, gh))));
      }
      gh = segment_sum(gh, 32);
      if (lane == 0) red_gh[warp] = gh;
      group_sync(0, kTcThreads);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + kTcThreads * k;
        const int o = plane_off(e >> 4, (e & 15) * 4);
        uint32_t a[2], bb[2];
        split<2>(gv[k].x, gv[k].y, a);
        split<2>(gv[k].z, gv[k].w, bb);
        *reinterpret_cast<uint2*>(gp + o) = make_uint2(a[0], bb[0]);
        *reinterpret_cast<uint2*>(gp + N * 128 + o) = make_uint2(a[1], bb[1]);
        split<2>(hv[k].x, hv[k].y, a);
        split<2>(hv[k].z, hv[k].w, bb);
        *reinterpret_cast<uint2*>(hq + o) = make_uint2(a[0], bb[0]);
        *reinterpret_cast<uint2*>(hq + N * 128 + o) = make_uint2(a[1], bb[1]);
      }
      group_sync(0, kTcThreads);
    }
    // This thread's two rows of block K, j0 + lg and j0 + lg + 8.
    float cur[2], dr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = kTQ * K + j0 + lg + 8 * rr;
      cur[rr] = cg[j];
      dr[rr] = expf(cl - cur[rr]) * dg[j];   // d_j
    }

    // dx_K's state term, d_j (B_K . g), and <B_j (x) x_j, g> on the way.
    {
      float dxa[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[t][e] = 0.f;
#pragma unroll 2
      for (int kn = 0; kn < N / 16; ++kn) {
        uint32_t a[4];
        frag_rows(a, bs, kLdN, kn);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            uint32_t q[4];
            frag_plane(q, gp, k, 2 * S + m, kn, true);
            mma(dxa[2 * m], a, q[0], q[1]);
            mma(dxa[2 * m + 1], a, q[2], q[3]);
          }
      }
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int pt = 0; pt < 4; ++pt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float2 xv = unpack2(*reinterpret_cast<const uint32_t*>(
              xb + (j0 + lg + 8 * rr) * kLdX + 32 * S + 8 * pt + 2 * cq));
          part[rr] = fmaf(xv.x, dxa[pt][2 * rr],
                          fmaf(xv.y, dxa[pt][2 * rr + 1], part[rr]));
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        part[rr] = segment_sum(part[rr], 4);
        if (cq == 0) red_ured[S * kTQ + j0 + lg + 8 * rr] = part[rr];
        float* o = dx + ((rk + j0 + lg + 8 * rr) * H + h) * kTP + 32 * S +
                   2 * cq;
#pragma unroll
        for (int pt = 0; pt < 4; ++pt)
          *reinterpret_cast<float2*>(o + 8 * pt) =
              make_float2(dxa[pt][2 * rr] * dr[rr],
                          dxa[pt][2 * rr + 1] * dr[rr]);
      }
    }
    // x_K . g^T into dB as d_j (x . g^T)_j.
    {
      float acc[NTN][4];
#pragma unroll
      for (int t = 0; t < NTN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t a[4];
        frag_rows(a, xb, kLdX, kp);
#pragma unroll
        for (int m = 0; m < NTN / 2; ++m)
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            uint32_t q[4];
            frag_plane(q, gp, k, S * NTN / 2 + m, kp, false);
            mma(acc[2 * m], a, q[0], q[1]);
            mma(acc[2 * m + 1], a, q[2], q[3]);
          }
      }
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dba[nt][e] = fmaf(dr[e >> 1], acc[nt][e], dba[nt][e]);
    }
    // dy_K . h_prev^T into dC as exp(cum_i) (dy . h_prev^T)_i, and
    // <C_i . h_prev, dy_i> on the way.
    {
      float acc[NTN][4];
#pragma unroll
      for (int t = 0; t < NTN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t a[4];
        frag_rows(a, dyb, kLdX, kp);
#pragma unroll
        for (int m = 0; m < NTN / 2; ++m)
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            uint32_t q[4];
            frag_plane(q, hq, k, S * NTN / 2 + m, kp, false);
            mma(acc[2 * m], a, q[0], q[1]);
            mma(acc[2 * m + 1], a, q[2], q[3]);
          }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = j0 + lg + 8 * rr;
        const float ec = expf(cur[rr]);
        float ip = 0.f;
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt) {
          const float2 cv = unpack2(*reinterpret_cast<const uint32_t*>(
              cs + i * kLdN + S * NH + 8 * nt + 2 * cq));
          ip = fmaf(cv.x, acc[nt][2 * rr], fmaf(cv.y, acc[nt][2 * rr + 1],
                                                ip));
          dca[nt][2 * rr] = fmaf(ec, acc[nt][2 * rr], dca[nt][2 * rr]);
          dca[nt][2 * rr + 1] =
              fmaf(ec, acc[nt][2 * rr + 1], dca[nt][2 * rr + 1]);
        }
        ip = segment_sum(ip, 4);
        if (cq == 0) red_inter[S * kTQ + i] = ip;
      }
    }
    // Every warp is done with the planes and the partial sums are
    // complete.  After the last head: the group's sums zeroed where g and
    // h_prev were, and the second phase's first tile copied.
    group_sync(0, kTcThreads);
    if (gi + 1 == G) {
      for (int e = tid; e < nb * (int)(kAccTile / 16); e += kTcThreads)
        acc4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      load_tile(grp * G, 0, 0);
      cp_async_commit();
    }
    // dcum's and ddt's state and inter terms of rows K, and this block's
    // dcum_last terms: warp 0, two rows a lane.
    if (warp == 0) {
      float tail = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = lane + 32 * u, j = kTQ * K + k;
        const float ured = red_ured[k] + red_ured[kTQ + k];
        const float inter =
            expf(cg[j]) * (red_inter[k] + red_inter[kTQ + k]);
        const float dex = expf(cl - cg[j]), dj = dex * dg[j];
        const int64_t o = (rk + k) * H + h;
        dcum[o] = inter - dj * ured;
        ddt[o] = dex * ured;
        tail = fmaf(dj, ured, tail);
      }
      tail = segment_sum(tail, 32);
      if (lane == 0) {
        if (K == nb - 1) {
          float gh = 0.f;
          for (int k = 0; k < kTcThreads / 32; ++k) gh += red_gh[k];
          tail += expf(cl) * gh;
        }
        tails[(((int64_t)b * nc + c) * nb + K) * H + h] = tail;
      }
    }
  }

  // Phase 2: each head's tiles.
  int seq = 0;   // ring tiles consumed
  for (int gi = 0; gi < G; ++gi) {
    const int h = grp * G + gi, buf = (G + gi) & 1;
    // Head gi's x_K, dy_K, dt, cum and first ring tile have landed; every
    // warp is done with head gi - 1.
    cp_async_wait_all();
    group_sync(0, kTcThreads);
    if (gi + 1 < G) load_xdy(h + 1, buf ^ 1);
    cp_async_commit();
    const bf16* xb = xs + buf * kTQ * kLdX;
    const bf16* dyb = dys + buf * kTQ * kLdX;
    const float* dg = dtc + buf * 2 * Q;
    const float* cg = dg + Q;
    float dtr[2], cur[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = kTQ * K + j0 + lg + 8 * rr;
      dtr[rr] = dg[j];
      cur[rr] = cg[j];
    }
    // dx_K's intra term over the diagonal and the column side; the column
    // sums of V (over i, this warp's half) and the row sums of T on the
    // row side (over j, this warp's half).
    float dxa[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[t][e] = 0.f;
    float colp[2] = {0.f, 0.f}, rowp[2] = {0.f, 0.f};

    // The diagonal tile (K, K), as ssd_chunk_bwd_tc's chunk.
    stage_cbt(cs, true);
    group_sync(0, kTcThreads);
    {
      float dwt[4][4], dcb[4][4], tcol[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) dwt[t][e] = dcb[t][e] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) tcol[t][0] = tcol[t][1] = 0.f;
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t a[4];
        frag_rows(a, xb, kLdX, kp);
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          if (2 * S + l < r) continue;
          uint32_t q[4];
          frag_cols(q, dyb, kLdX, 2 * S + l, kp);
          mma(dwt[2 * l], a, q[0], q[1]);
          mma(dwt[2 * l + 1], a, q[2], q[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < r) continue;    // every i of the step is below j
        uint32_t wa[NT][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 2 * kk + half;
          const int i = 8 * t + 2 * cq;
          const float ci[2] = {cg[kTQ * K + i], cg[kTQ * K + i + 1]};
          const float4 cb4 = scr4[(r * 8 + t) * 32 + lane];
          const float cbt[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int j = j0 + lg + 8 * rr;
            float w[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ex = i + e >= j ? expf(ci[e] - cur[rr]) : 0.f;
              const float kv = cbt[2 * rr + e] * ex;
              w[e] = kv * dtr[rr];
              if ((t >> 2) == S) {
                const int lt = t & 3;
                const float dw = dwt[lt][2 * rr + e];
                const float v = dw * kv;
                colp[rr] += v;
                tcol[lt][e] = fmaf(v, dtr[rr], tcol[lt][e]);
                dcb[lt][2 * rr + e] = dw * ex * dtr[rr];
              }
            }
            uint32_t tt[NT];
            split<NT>(w[0], w[1], tt);
#pragma unroll
            for (int k = 0; k < NT; ++k) wa[k][2 * half + rr] = tt[k];
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t q[4];
          frag_cols_t(q, dyb, kLdX, 2 * S + m, kk);
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            mma(dxa[2 * m], wa[k], q[0], q[1]);
            mma(dxa[2 * m + 1], wa[k], q[2], q[3]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = column_sum(tcol[t][e]);
          if (lg == 0) red_rowd[r * kTQ + 32 * S + 8 * t + 2 * cq + e] = v;
        }
      accumulate(0, dcb);
    }
    group_sync(0, kTcThreads);   // every warp is done with the fragments

    // The off-diagonal tiles, through the ring.
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t, ++seq) {
      if (t > 0) {
        cp_async_wait_all();
        group_sync(0, kTcThreads);
      }
      if (t + 1 < ntiles)
        load_tile(h, t + 1, (seq + 1) & 1);
      else if (gi + 1 < G)
        load_tile(h + 1, 0, (seq + 1) & 1);
      cp_async_commit();
      const bf16* t64 = ring_t64(seq & 1);
      const bf16* tn = ring_tn(seq & 1);
      if (t < ncol) {
        // Column side, tile (I, K): rows j of K, columns i of I.
        const int I = K + 1 + t;
        stage_cbt(tn, false);
        group_sync(0, kTcThreads);
        float dwt[4][4], dcb[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) dwt[u][e] = dcb[u][e] = 0.f;
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
          uint32_t a[4];
          frag_rows(a, xb, kLdX, kp);
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            uint32_t q[4];
            frag_cols(q, t64, kLdX, 2 * S + l, kp);
            mma(dwt[2 * l], a, q[0], q[1]);
            mma(dwt[2 * l + 1], a, q[2], q[3]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t wa[NT][4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int u = 2 * kk + half;
            const int i = 8 * u + 2 * cq;
            const float ci[2] = {cg[kTQ * I + i], cg[kTQ * I + i + 1]};
            const float4 cb4 = scr4[(r * 8 + u) * 32 + lane];
            const float cbt[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float w[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float ex = expf(ci[e] - cur[rr]);   // i > j
                const float kv = cbt[2 * rr + e] * ex;
                w[e] = kv * dtr[rr];
                if ((u >> 2) == S) {
                  const int lt = u & 3;
                  const float dw = dwt[lt][2 * rr + e];
                  colp[rr] += dw * kv;
                  dcb[lt][2 * rr + e] = dw * ex * dtr[rr];
                }
              }
              uint32_t tt[NT];
              split<NT>(w[0], w[1], tt);
#pragma unroll
              for (int k = 0; k < NT; ++k) wa[k][2 * half + rr] = tt[k];
            }
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            uint32_t q[4];
            frag_cols_t(q, t64, kLdX, 2 * S + m, kk);
#pragma unroll
            for (int k = 0; k < NT; ++k) {
              mma(dxa[2 * m], wa[k], q[0], q[1]);
              mma(dxa[2 * m + 1], wa[k], q[2], q[3]);
            }
          }
        }
        accumulate(1 + t, dcb);
      } else {
        // Row side, tile (K, J): rows i of K, columns j of J.
        const int J = t - ncol;
        float cbr[4][4], dw[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) cbr[u][e] = dw[u][e] = 0.f;
#pragma unroll 2
        for (int kn = 0; kn < N / 16; ++kn) {
          uint32_t a[4];
          frag_rows(a, cs, kLdN, kn);
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            uint32_t q[4];
            frag_cols(q, tn, kLdN, 2 * S + l, kn);
            mma(cbr[2 * l], a, q[0], q[1]);
            mma(cbr[2 * l + 1], a, q[2], q[3]);
          }
        }
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
          uint32_t a[4];
          frag_rows(a, dyb, kLdX, kp);
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            uint32_t q[4];
            frag_cols(q, t64, kLdX, 2 * S + l, kp);
            mma(dw[2 * l], a, q[0], q[1]);
            mma(dw[2 * l + 1], a, q[2], q[3]);
          }
        }
        // cur holds cum of this warp's rows i; dW o E o dt over dw.
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 32 * S + 8 * u + 2 * cq;
          const float cj[2] = {cg[kTQ * J + j], cg[kTQ * J + j + 1]};
          const float dj[2] = {dg[kTQ * J + j], dg[kTQ * J + j + 1]};
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ex = expf(cur[rr] - cj[e]);   // i > j
              const float d = dw[u][2 * rr + e];
              rowp[rr] = fmaf(d * (cbr[u][2 * rr + e] * ex), dj[e],
                              rowp[rr]);
              dw[u][2 * rr + e] = d * ex * dj[e];
            }
        }
        accumulate(1 + t, dw);
      }
    }

    // dx of rows K: the first phase's state term plus this head's; the
    // row and column sums' partials.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* o = dx + ((rk + j0 + lg + 8 * rr) * H + h) * kTP + 32 * S +
                 2 * cq;
#pragma unroll
      for (int pt = 0; pt < 4; ++pt) {
        const float2 v = *reinterpret_cast<const float2*>(o + 8 * pt);
        *reinterpret_cast<float2*>(o + 8 * pt) =
            make_float2(v.x + dxa[pt][2 * rr], v.y + dxa[pt][2 * rr + 1]);
      }
      colp[rr] = segment_sum(colp[rr], 4);
      rowp[rr] = segment_sum(rowp[rr], 4);
      if (cq == 0) {
        red_colv[S * kTQ + j0 + lg + 8 * rr] = colp[rr];
        red_rows[S * kTQ + j0 + lg + 8 * rr] = rowp[rr];
      }
    }
    group_sync(0, kTcThreads);

    // dcum and ddt of rows K completed from the partial sums in a fixed
    // order: warp 0, two rows a lane (the lanes that wrote them in the
    // first phase).
    if (warp == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = lane + 32 * u, j = kTQ * K + k;
        const float rowt = (((red_rowd[k] + red_rowd[kTQ + k]) +
                             red_rowd[2 * kTQ + k]) + red_rowd[3 * kTQ + k]) +
                           (red_rows[k] + red_rows[kTQ + k]);
        const float colv = red_colv[k] + red_colv[kTQ + k];
        const int64_t o = (rk + k) * H + h;
        dcum[o] += rowt - dg[j] * colv;
        ddt[o] += colv;
      }
    }
  }

  // The group's dB_K += sum^T . C_I and dC_K += sum . B_J, each tile's sum
  // split once: the diagonal from C_K and B_K, the others' C_I and B_J
  // through the ring.
  stage_acc(0);
  if (ntiles > 0) load_tile(-1, 0, 0);
  cp_async_commit();
  group_sync(0, kTcThreads);
  staged_times(dba, cs, r, 3);   // i >= j
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk > r) continue;        // j <= i, the staged tile read transposed
    uint32_t ta[NT][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = j0 + lg + 8 * (q & 1);
      const int j = 16 * kk + 2 * cq + 8 * (q >> 1);
      uint32_t tt[NT];
      split<NT>(scr[j * kLdScr + i], scr[(j + 1) * kLdScr + i], tt);
#pragma unroll
      for (int k = 0; k < NT; ++k) ta[k][q] = tt[k];
    }
#pragma unroll
    for (int m = 0; m < NTN / 2; ++m) {
      uint32_t q[4];
      frag_cols_t(q, bs, kLdN, S * NTN / 2 + m, kk);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        mma(dca[2 * m], ta[k], q[0], q[1]);
        mma(dca[2 * m + 1], ta[k], q[2], q[3]);
      }
    }
  }
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    group_sync(0, kTcThreads);   // tile t has landed; the staging tile and
                                 // the other stage are free
    if (t + 1 < ntiles) load_tile(-1, t + 1, (t + 1) & 1);
    cp_async_commit();
    stage_acc(1 + t);
    group_sync(0, kTcThreads);
    if (t < ncol)
      staged_times(dba, ring_tn(t & 1), 0, 3);
    else
      staged_times(dca, ring_tn(t & 1), 0, 3);
  }

  // This group's partial dB and dC of rows K.
  const int64_t part0 = (int64_t)grp * gridDim.z * L * N;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t o = part0 + (rk + j0 + lg + 8 * rr) * N + S * NH + 2 * cq;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      *reinterpret_cast<float2*>(db_part + o + 8 * nt) =
          make_float2(dba[nt][2 * rr], dba[nt][2 * rr + 1]);
      *reinterpret_cast<float2*>(dc_part + o + 8 * nt) =
          make_float2(dca[nt][2 * rr], dca[nt][2 * rr + 1]);
    }
  }
}

// One block of 8 warps per (chunk, row block K, group of G heads, batch).
template <int N>
__global__ void __launch_bounds__(kTcThreads, 1)
    ssd_chunk_bwd_tc_tiled(
        const bf16* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ cum, const bf16* __restrict__ bm,
        const bf16* __restrict__ cm, const bf16* __restrict__ dy,
        const float* __restrict__ g, const float* __restrict__ hp,
        float* __restrict__ dx, float* __restrict__ dcum,
        float* __restrict__ ddt, float* __restrict__ db_part,
        float* __restrict__ dc_part, float* __restrict__ tails, int L, int H,
        int G, int Q) {
  constexpr int kLdN = N + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TiledBwdSmem lay(N, Q);
  bf16* cs = reinterpret_cast<bf16*>(smem_raw + lay.c);
  bf16* bs = reinterpret_cast<bf16*>(smem_raw + lay.b);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + lay.x);
  bf16* dys = reinterpret_cast<bf16*>(smem_raw + lay.dy);
  float* gs = reinterpret_cast<float*>(smem_raw + lay.ghp);
  float* hs = gs + N * kTP;
  float* dtc = reinterpret_cast<float*>(smem_raw + lay.dtc);
  const int tid = threadIdx.x;
  const int nb = Q / kTQ, nc = L / Q;
  const int c = blockIdx.x / nb, K = blockIdx.x % nb;
  const int h0 = blockIdx.y * G, b = blockIdx.z;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int64_t rk = row0 + kTQ * K;

  // C_K and B_K once per group, and the first head's x_K, dy_K, dt, cum, g
  // and h_prev; here rather than in the warps' code, whose registers are
  // at their limit at N = 128.
  for (int e = tid; e < kTQ * (N / 8); e += kTcThreads) {
    const int i = e / (N / 8), k8 = (e % (N / 8)) * 8;
    cp_async16(cs + i * kLdN + k8, cm + (rk + i) * N + k8);
    cp_async16(bs + i * kLdN + k8, bm + (rk + i) * N + k8);
  }
  for (int e = tid; e < kTQ * (kTP / 8); e += kTcThreads) {
    const int i = e >> 3, k8 = (e & 7) * 8;
    const int64_t o = ((rk + i) * H + h0) * kTP + k8;
    cp_async16(xs + i * kLdX + k8, x + o);
    cp_async16(dys + i * kLdX + k8, dy + o);
  }
  const int64_t st = (((int64_t)b * nc + c) * H + h0) * (int64_t)N * kTP;
  for (int e = tid; e < N * (kTP / 4); e += kTcThreads) {
    cp_async16(gs + 4 * e, g + st + 4 * e);
    cp_async16(hs + 4 * e, hp + st + 4 * e);
  }
  for (int e = tid; e < 2 * Q; e += kTcThreads) {
    const int j = e < Q ? e : e - Q;
    cp_async4(dtc + e, (e < Q ? dt : cum) + (row0 + j) * H + h0);
  }
  cp_async_commit();
  // Warps 0-3 take the first half of each product's columns, 4-7 the
  // second; both run the same barriers in the same order.
  if (tid < kTcThreads / 2)
    chunk_bwd_tiled_warp<N, 0>(x, dt, cum, bm, cm, dy, g, hp, dx, dcum, ddt,
                               db_part, dc_part, tails, smem_raw, L, H, G,
                               Q);
  else
    chunk_bwd_tiled_warp<N, 1>(x, dt, cum, bm, cm, dy, g, hp, dx, dcum, ddt,
                               db_part, dc_part, tails, smem_raw, L, H, G,
                               Q);
}

template <int N>
cudaError_t launch_chunk_bwd_tiled(const void* x, const void* dt,
                                   const void* cum, const void* bm,
                                   const void* cm, const void* dy,
                                   const void* g, const void* hp, void* dx,
                                   void* dcum, void* ddt, void* db_part,
                                   void* dc_part, void* tails, int B, int L,
                                   int H, int Q, int G, cudaStream_t stream) {
  const size_t smem = TiledBwdSmem(N, Q).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_tc_tiled<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L / Q) * (Q / kTQ), H / G, B);
  ssd_chunk_bwd_tc_tiled<N><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<const bf16*>(dy),
      static_cast<const float*>(g), static_cast<const float*>(hp),
      static_cast<float*>(dx), static_cast<float*>(dcum),
      static_cast<float*>(ddt), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), static_cast<float*>(tails), L, H, G, Q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ssd_chunk_bwd_tf32: fp32 x, B, C and dy at Q = P = 64, N = 64 or 128
// ---------------------------------------------------------------------------

// Shared-memory layout of ssd_chunk_bwd_tf32, in bytes
// (ssd_chunk_bwd_tf32_smem_bytes reports it, kernel.py's
// chunk_bwd_tf32_smem_bytes mirrors it).  B and C are fp32 rows of N + 8
// words (8 (mod 32): their K-major reads take two slots a lane as one
// 8-byte load, their MN-major reads rows c and c + 4); x, dy, g and
// h_prev are [rows][64] fp32 tiles swizzled by swz64.  x and dy are
// double-buffered, g and h_prev not: at N = 128 a second pair would not
// fit beside B and C, so the next head's g and h_prev are copied once
// this head's last product that reads them is done.
struct ChunkTf32Smem {
  size_t c, b, cb, x, dy, g, hp, dts, cums, red, total;
  __host__ __device__ ChunkTf32Smem(int N, int G) {
    const size_t bc = (size_t)kTQ * (N + 8) * 4;  // C or B
    const size_t xd = (size_t)kTQ * kTP * 4;      // one x or dy buffer
    const size_t st = (size_t)N * kTP * 4;        // g or h_prev
    c = 0;
    b = c + bc;
    cb = b + bc;         // (C . B^T)^T fragments: [4 row tiles][8][32] x 4
    x = cb + 4 * 8 * 32 * 16;   // 2 buffers
    dy = x + 2 * xd;     // 2 buffers
    g = dy + 2 * xd;
    hp = g + st;
    dts = hp + st;       // [G][kTQ]
    cums = dts + (size_t)G * kTQ * 4;
    red = cums + (size_t)G * kTQ * 4;
    total = red + (size_t)kRedFloats * 4;
  }
};

// x and dy of head h, [kTQ][kTP] fp32 each, into swizzled tiles with
// cp.async: this thread's share of the block's copies.
__device__ __forceinline__ void tf32_load_xdy(float* xd, float* dd,
                                              const float* x,
                                              const float* dy, int64_t row0,
                                              int H, int h) {
  for (int e = threadIdx.x; e < kTQ * (kTP / 4); e += kTcThreads) {
    const int i = e >> 4, c4 = (e & 15) * 4;
    const int64_t o = ((row0 + i) * H + h) * kTP + c4;
    cp_async16(xd + swz64(i, c4), x + o);
    cp_async16(dd + swz64(i, c4), dy + o);
  }
}

// g and h_prev of one (chunk, head), [N][kTP] fp32 each from `st` on,
// into swizzled tiles with cp.async.
template <int N>
__device__ __forceinline__ void tf32_load_gh(float* gd, float* hd,
                                             const float* g, const float* hp,
                                             int64_t st) {
  for (int e = threadIdx.x; e < N * (kTP / 4); e += kTcThreads) {
    const int n = e >> 4, c4 = (e & 15) * 4;
    cp_async16(gd + swz64(n, c4), g + st + 4 * e);
    cp_async16(hd + swz64(n, c4), hp + st + 4 * e);
  }
}

// The A fragment of rows r0 .. r0 + 15 (r0 a multiple of 8) of a
// swizzled tile, k8 step k (ldmatrix: rows 0-7 and 8-15 at slots 0-3,
// then at 4-7), split.  The lane's row r has r % 8 = lane % 8, and its
// 16-byte chunk 2k + h of the row's 16 sits at (2k + h) ^ (r % 8) (swz64).
__device__ __forceinline__ Tf32A tf32_rows(const float* t, int r0, int k,
                                           int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t a[4];
  ldsm_x4(a, t + row * kTP + (((2 * k + (lane >> 4)) ^ (lane & 7)) << 2));
  return Tf32A(__uint_as_float(a[0]), __uint_as_float(a[1]),
               __uint_as_float(a[2]), __uint_as_float(a[3]));
}

// The B fragments of the n-tiles of rows n0 .. n0 + 7 and n0 + 8 .. n0 +
// 15 of a swizzled tile read K-major (its columns the k of the product),
// k8 step k, split.
__device__ __forceinline__ void tf32_cols(Tf32B (&b)[2], const float* t,
                                          int n0, int k, int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  uint32_t q[4];
  ldsm_x4(q, t + row * kTP +
                 (((2 * k + ((lane >> 3) & 1)) ^ (lane & 7)) << 2));
  b[0] = Tf32B(__uint_as_float(q[0]), __uint_as_float(q[1]));
  b[1] = Tf32B(__uint_as_float(q[2]), __uint_as_float(q[3]));
}

// (C . B^T)^T on the warp's rows j0.. of B against the i-tiles T0, T0 + 2,
// .. of C (the two column halves take alternate tiles, at or right of the
// diagonal's), three TF32 products over N, each slot pair of a lane one
// 8-byte load of a row; stored in fragment order for the group's heads.
template <int N, int T0>
__device__ __forceinline__ void cbt_tf32(float4* cbs, const float* bs,
                                         const float* cs, int r, int j0,
                                         int lg, int cq, int lane) {
  constexpr int kLdN = N + 8;
  constexpr int NT = (9 - T0) / 2;
  float cbt[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) cbt[t][e] = 0.f;
#pragma unroll 2
  for (int kn = 0; kn < N / 8; ++kn) {
    const float* br = bs + (j0 + lg) * kLdN + 8 * kn + 2 * cq;
    const float2 v0 = *reinterpret_cast<const float2*>(br);
    const float2 v1 = *reinterpret_cast<const float2*>(br + 8 * kLdN);
    const Tf32A a(v0.x, v1.x, v0.y, v1.y);
    Tf32B bt[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float2 v = *reinterpret_cast<const float2*>(
          cs + (8 * (T0 + 2 * t) + lg) * kLdN + 8 * kn + 2 * cq);
      bt[t] = Tf32B(v.x, v.y);
    }
    mma3<NT>(cbt, 0, a, bt);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
    cbs[(r * 8 + T0 + 2 * t) * 32 + lane] =
        make_float4(cbt[t][0], cbt[t][1], cbt[t][2], cbt[t][3]);
}

// The state and inter terms of one head on a warp's rows 16 r .. (j for
// dx and dB, i for dC) and half S of each product's columns, shared by
// ssd_chunk_bwd_tf32 and ssd_chunk_bwd_tf32_tiled: <g, h_prev> over this
// thread's float4s into red_gh[warp]; dx's state term B . g on the half of
// p (permuted slots: B's columns 2c, 2c + 1 as one load, g's rows 2c,
// 2c + 1), <B_j (x) x_j, g> = sum_p x_j[p] (B . g)[j][p] into red_ured on
// the way, then scaled by d_j (dr); x . g^T into dB as d_j (x . g^T)_j and
// dy . h_prev^T into dC as exp(cum_i) (dy . h_prev^T)_i on the half of n,
// <C_i . h_prev, dy_i> into red_inter on the way.  NQ n-tiles of the half
// at a time: all of them in ssd_chunk_bwd_tf32, half in the tiled kernel,
// whose registers are at their limit.
template <int N, int S, int NQ>
__device__ __forceinline__ void tf32_state_terms(
    float (&dxa)[4][4], float (&dba)[N / 16][4], float (&dca)[N / 16][4],
    const float* bs, const float* cs, const float* gs, const float* hs,
    const float* xb, const float* dyb, const int (&mn)[4][2],
    const float (&dr)[2], const float (&cur)[2], float* red_gh,
    float* red_ured, float* red_inter, int j0, int lg, int cq, int lane) {
  constexpr int kLdN = N + 8;   // fp32 row of B and C
  constexpr int NH = N / 2;     // this warp's half of N
  constexpr int NTN = NH / 8;   // its n8 tiles
  {
    constexpr int kPer = N * kTP / 4 / kTcThreads;
    const int tid = threadIdx.x;
    float gh = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + kTcThreads * k;
      const float4 gv = reinterpret_cast<const float4*>(gs)[e];
      const float4 hv = reinterpret_cast<const float4*>(hs)[e];
      gh = fmaf(gv.x, hv.x, fmaf(gv.y, hv.y,
           fmaf(gv.z, hv.z, fmaf(gv.w, hv.w, gh))));
    }
    gh = segment_sum(gh, 32);
    if (lane == 0) red_gh[tid >> 5] = gh;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[t][e] = 0.f;
#pragma unroll 2
  for (int kn = 0; kn < N / 8; ++kn) {
    const float* br = bs + (j0 + lg) * kLdN + 8 * kn + 2 * cq;
    const float2 v0 = *reinterpret_cast<const float2*>(br);
    const float2 v1 = *reinterpret_cast<const float2*>(br + 8 * kLdN);
    const Tf32A a(v0.x, v1.x, v0.y, v1.y);
    const float* gk = gs + 8 * kn * kTP;
    Tf32B bt[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) bt[u] = Tf32B(gk[mn[u][0]], gk[mn[u][1]]);
    mma3<4>(dxa, 0, a, bt);
  }
  {
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int pt = 0; pt < 4; ++pt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float2 xv = *reinterpret_cast<const float2*>(
            xb + swz64(j0 + lg + 8 * rr, 32 * S + 8 * pt + 2 * cq));
        part[rr] = fmaf(xv.x, dxa[pt][2 * rr],
                        fmaf(xv.y, dxa[pt][2 * rr + 1], part[rr]));
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      part[rr] = segment_sum(part[rr], 4);
      if (cq == 0) red_ured[S * kTQ + j0 + lg + 8 * rr] = part[rr];
#pragma unroll
      for (int pt = 0; pt < 4; ++pt) {
        dxa[pt][2 * rr] *= dr[rr];
        dxa[pt][2 * rr + 1] *= dr[rr];
      }
    }
  }
  // x . g^T, into dB.
#pragma unroll
  for (int h2 = 0; h2 < NTN / NQ; ++h2) {
    float acc[NQ][4];
#pragma unroll
    for (int t = 0; t < NQ; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
    for (int kp = 0; kp < kTP / 8; ++kp) {
      const Tf32A a = tf32_rows(xb, j0, kp, lane);
#pragma unroll
      for (int m = 0; m < NQ / 2; ++m) {
        Tf32B bt[2];
        tf32_cols(bt, gs, S * NH + 8 * NQ * h2 + 16 * m, kp, lane);
        mma3<2>(acc, 2 * m, a, bt);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dba[NQ * h2 + nt][e] =
            fmaf(dr[e >> 1], acc[nt][e], dba[NQ * h2 + nt][e]);
  }
  // dy . h_prev^T, into dC (exp(cum_i) and the sums of ip in the order
  // that each kernel's registers take best).
  float ec[2], ip[2] = {0.f, 0.f};
  if (NQ < NTN) ec[0] = expf(cur[0]), ec[1] = expf(cur[1]);
#pragma unroll
  for (int h2 = 0; h2 < NTN / NQ; ++h2) {
    float acc[NQ][4];
#pragma unroll
    for (int t = 0; t < NQ; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
    for (int kp = 0; kp < kTP / 8; ++kp) {
      const Tf32A a = tf32_rows(dyb, j0, kp, lane);
#pragma unroll
      for (int m = 0; m < NQ / 2; ++m) {
        Tf32B bt[2];
        tf32_cols(bt, hs, S * NH + 8 * NQ * h2 + 16 * m, kp, lane);
        mma3<2>(acc, 2 * m, a, bt);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = j0 + lg + 8 * rr;
      if (NQ == NTN) ec[rr] = expf(cur[rr]);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const int n = NQ * h2 + nt;
        const float2 cv = *reinterpret_cast<const float2*>(
            cs + i * kLdN + S * NH + 8 * n + 2 * cq);
        ip[rr] = fmaf(cv.x, acc[nt][2 * rr],
                      fmaf(cv.y, acc[nt][2 * rr + 1], ip[rr]));
        dca[n][2 * rr] = fmaf(ec[rr], acc[nt][2 * rr], dca[n][2 * rr]);
        dca[n][2 * rr + 1] =
            fmaf(ec[rr], acc[nt][2 * rr + 1], dca[n][2 * rr + 1]);
      }
      if (h2 == NTN / NQ - 1) {
        ip[rr] = segment_sum(ip[rr], 4);
        if (cq == 0) red_inter[S * kTQ + i] = ip[rr];
      }
    }
  }
}

// acc = (rows j0.. of a) . b^T over p (rows j, half S of the columns; a
// and b swizzled [64][64] tiles): dW^T = x . dy^T, or dW = dy_K . x_J^T;
// on a diagonal tile only the column tiles at or right of it.  Shared by
// ssd_chunk_bwd_tf32 and ssd_chunk_bwd_tf32_tiled.
template <int S>
__device__ __forceinline__ void tf32_dw(float (&acc)[4][4], const float* a,
                                        const float* bt_src, bool diag,
                                        int r, int j0, int lane) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
  for (int kp = 0; kp < kTP / 8; ++kp) {
    const Tf32A af = tf32_rows(a, j0, kp, lane);
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (diag && 2 * S + l < r) continue;   // every i of the pair < j
      Tf32B bt[2];
      tf32_cols(bt, bt_src, 16 * (2 * S + l), kp, lane);
      mma3<2>(acc, 2 * l, af, bt);
    }
  }
}

// dx's intra term over a tile of rows i (their cum from cgi on) against
// the warp's rows j (cur, dtr), added to dxa: K^T o dt built in registers
// from the staged (C . B^T)^T fragments (cbs) k8 step by k8 step, an
// accumulator tile's columns 2c, 2c + 1 as the slots c, c + 4, and
// multiplied with dy's rows 2c, 2c + 1 (dyt) in the same slots; on half S
// of i also V = dW o K (colp: sum_i V_ij; on the diagonal tcol: sum_j
// V_ij dt_j, the row sums of T) and the running sum of dW o E o dt
// (dsum).  DIAG: the diagonal tile, where E_ij is a plain 0 for i < j.
// ssd_chunk_bwd_tf32_tiled's tiles; ssd_chunk_bwd_tf32 writes it out.
template <int S, bool DIAG>
__device__ __forceinline__ void tf32_tile_dx(
    float (&dxa)[4][4], float (&dsum)[4][4], const float (&dwt)[4][4],
    const float* dyt, const float4* cbs, const float* cgi,
    const float (&cur)[2], const float (&dtr)[2], const int (&mn)[4][2],
    float (&colp)[2], float (&tcol)[4][2], int r, int j0, int lg, int cq,
    int lane) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (DIAG && t < 2 * r) continue;   // every i of the step is below j
    const int i = 8 * t + 2 * cq;
    const float ci[2] = {cgi[i], cgi[i + 1]};
    const float4 cb4 = cbs[(r * 8 + t) * 32 + lane];
    const float cbt[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
    float w[2][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = j0 + lg + 8 * rr;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // E_ij = exp(cum_i - cum_j) for i >= j, else a plain 0.
        const float ex = !DIAG || i + e >= j ? expf(ci[e] - cur[rr]) : 0.f;
        const float kv = cbt[2 * rr + e] * ex;
        w[rr][e] = kv * dtr[rr];
        if ((t >> 2) == S) {
          const int lt = t & 3;   // the tile within this half
          const float dw = dwt[lt][2 * rr + e];
          const float v = dw * kv;
          colp[rr] += v;
          if (DIAG) tcol[lt][e] = fmaf(v, dtr[rr], tcol[lt][e]);
          dsum[lt][2 * rr + e] = fmaf(dw * ex, dtr[rr], dsum[lt][2 * rr + e]);
        }
      }
    }
    const Tf32A wa(w[0][0], w[1][0], w[0][1], w[1][1]);
    const float* dk = dyt + 8 * t * kTP;
    Tf32B bt[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) bt[u] = Tf32B(dk[mn[u][0]], dk[mn[u][1]]);
    mma3<4>(dxa, 0, wa, bt);
  }
}

// The work of one warp of ssd_chunk_bwd_tf32, as chunk_bwd_tc_warp's:
// rows 16 r .. 16 r + 15 of the chunk (j for dx, dB and the K tile, i for
// dC) and half S of the columns of each product.  Every product is three
// TF32 products on operands split as they reach the registers, on the
// same slots for both operands: natural (k = c, c + 4) where the A
// operand is read K-major from x, dy or the staged dC . B^T gradient,
// permuted (k = 2c, 2c + 1) where it is an accumulator or a pair of B's
// columns.  Each product is summed from zero on the tensor cores (a k8
// step at a time, at most N / 8 steps) and added in fp32 where it joins a
// running sum (dB, dC over the group's heads).
template <int N, int S>
__device__ __forceinline__ void chunk_bwd_tf32_warp(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ g, const float* __restrict__ hp,
    float* __restrict__ dx, float* __restrict__ dcum,
    float* __restrict__ ddt, float* __restrict__ db_part,
    float* __restrict__ dc_part, unsigned char* smem_raw, int L, int H,
    int G) {
  constexpr int kLdN = N + 8;   // fp32 row of B and C
  constexpr int NH = N / 2;     // this warp's half of N
  constexpr int NTN = NH / 8;   // its n8 tiles
  constexpr int kLdS = kTQ + 4; // the staged dC . B^T gradient's rows
  const ChunkTf32Smem lay(N, G);
  const float* cs = reinterpret_cast<const float*>(smem_raw + lay.c);
  const float* bs = reinterpret_cast<const float*>(smem_raw + lay.b);
  float* xs = reinterpret_cast<float*>(smem_raw + lay.x);
  float* dys = reinterpret_cast<float*>(smem_raw + lay.dy);
  float* gs = reinterpret_cast<float*>(smem_raw + lay.g);
  float* hs = reinterpret_cast<float*>(smem_raw + lay.hp);
  float4* cbs = reinterpret_cast<float4*>(smem_raw + lay.cb);
  const float* dts = reinterpret_cast<const float*>(smem_raw + lay.dts);
  const float* cums = reinterpret_cast<const float*>(smem_raw + lay.cums);
  float* red_rowt = reinterpret_cast<float*>(smem_raw + lay.red);  // [4][Q]
  float* red_colv = red_rowt + 4 * kTQ;    // [2][Q]: sum_i V_ij by half
  float* red_ured = red_colv + 2 * kTQ;    // [2][Q]: <B_j (x) x_j, g>
  float* red_inter = red_ured + 2 * kTQ;   // [2][Q]: <C_i . h_prev, dy_i>
  float* red_gh = red_inter + 2 * kTQ;     // [8]: <g, h_prev> by warp

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane >> 2, cq = lane & 3;
  const int r = warp & 3, j0 = 16 * r;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * kTQ;

  // This lane's word offsets, in a swizzled tile, of rows 2c and 2c + 1
  // at its column of each of its half's p n-tiles: the B fragments of g
  // (B . g) and dy (dx's intra term) read MN-major in the permuted slots;
  // a k8 step adds 8 rows (the swizzle repeats every 8).
  int mn[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      mn[u][e] = swz64(2 * cq + e, 32 * S + 8 * u + lg);

  // (C . B^T)^T: this warp's alternate i-tiles at or right of the
  // diagonal's (i >= j); read for the group's heads by both halves.
  if (r == 0) cbt_tf32<N, S>(cbs, bs, cs, r, j0, lg, cq, lane);
  else if (r == 1) cbt_tf32<N, 2 + S>(cbs, bs, cs, r, j0, lg, cq, lane);
  else if (r == 2) cbt_tf32<N, 4 + S>(cbs, bs, cs, r, j0, lg, cq, lane);
  else cbt_tf32<N, 6 + S>(cbs, bs, cs, r, j0, lg, cq, lane);

  // Over the group's heads: dcb the running sum of dW o E o dt
  // (transposed: rows j, this warp's half of i), dba and dca the running
  // dB (rows j) and dC (rows i) over this warp's half of n.
  float dcb[4][4], dba[NTN][4], dca[NTN][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int t = 0; t < 4; ++t) dcb[t][e] = 0.f;
#pragma unroll
    for (int t = 0; t < NTN; ++t) dba[t][e] = dca[t][e] = 0.f;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = grp * G + gi, buf = gi & 1;
    // Head gi's tiles have landed; every warp is done with head gi - 1
    // (its x and dy buffer, the (C . B^T)^T tiles the first time, the
    // partial sums).
    cp_async_wait_all();
    group_sync(0, kTcThreads);
    if (gi + 1 < G)
      tf32_load_xdy(xs + (buf ^ 1) * kTQ * kTP, dys + (buf ^ 1) * kTQ * kTP,
                    x, dy, row0, H, h + 1);
    cp_async_commit();
    const float* xb = xs + buf * kTQ * kTP;
    const float* dyb = dys + buf * kTQ * kTP;
    const float* dg = dts + gi * kTQ;
    const float* cg = cums + gi * kTQ;
    const float cl = cg[kTQ - 1];
    // This thread's two rows, j0 + lg and j0 + lg + 8.
    float dtr[2], cur[2], dr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = j0 + lg + 8 * rr;
      dtr[rr] = dg[j];
      cur[rr] = cg[j];
      dr[rr] = expf(cl - cur[rr]) * dtr[rr];   // d_j
    }
    // The head's state and inter terms.
    float dxa[4][4];
    tf32_state_terms<N, S, NTN>(dxa, dba, dca, bs, cs, gs, hs, xb, dyb, mn,
                                dr, cur, red_gh, red_ured, red_inter, j0, lg,
                                cq, lane);

    // Every read of g and h_prev is done: the next head's copies go out
    // while the block works on x and dy.
    group_sync(0, kTcThreads);
    if (gi + 1 < G)
      tf32_load_gh<N>(gs, hs, g, hp,
                      (((int64_t)b * nc + c) * H + h + 1) * (int64_t)N * kTP);
    cp_async_commit();

    // dW^T = x . dy^T on this warp's half of i.
    float dwt[4][4];
    tf32_dw<S>(dwt, xb, dyb, true, r, j0, lane);

    // dx's intra term, as tf32_tile_dx<S, true> computes it, written out:
    // through that function this kernel compiles to more instructions and
    // runs slower.  K^T o dt built in registers from (C . B^T)^T's
    // fragments k8 step by k8 step (an accumulator tile's columns 2c,
    // 2c + 1 as the slots c, c + 4, dy's rows 2c, 2c + 1 in the same
    // slots); on this warp's half of i also V = dW o K (row sums: sum_i
    // V_ij; column sums of V o dt_j: sum_j T_ij) and the running sum of
    // dW o E o dt.
    float colp[2] = {0.f, 0.f}, tcol[4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t) tcol[t][0] = tcol[t][1] = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t < 2 * r) continue;    // every i of the step is below j
      const int i = 8 * t + 2 * cq;
      const float ci[2] = {cg[i], cg[i + 1]};
      const float4 cb4 = cbs[(r * 8 + t) * 32 + lane];
      const float cbt[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
      float w[2][2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = j0 + lg + 8 * rr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // E_ij = exp(cum_i - cum_j) for i >= j, else a plain 0.
          const float ex = i + e >= j ? expf(ci[e] - cur[rr]) : 0.f;
          const float kv = cbt[2 * rr + e] * ex;
          w[rr][e] = kv * dtr[rr];
          if ((t >> 2) == S) {
            const int lt = t & 3;   // the tile within this half
            const float dw = dwt[lt][2 * rr + e];
            const float v = dw * kv;
            colp[rr] += v;
            tcol[lt][e] = fmaf(v, dtr[rr], tcol[lt][e]);
            dcb[lt][2 * rr + e] = fmaf(dw * ex, dtr[rr], dcb[lt][2 * rr + e]);
          }
        }
      }
      const Tf32A wa(w[0][0], w[1][0], w[0][1], w[1][1]);
      const float* dk = dyb + 8 * t * kTP;
      Tf32B bt[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) bt[u] = Tf32B(dk[mn[u][0]], dk[mn[u][1]]);
      mma3<4>(dxa, 0, wa, bt);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* o = dx + ((row0 + j0 + lg + 8 * rr) * H + h) * kTP + 32 * S +
                 2 * cq;
#pragma unroll
      for (int pt = 0; pt < 4; ++pt)
        *reinterpret_cast<float2*>(o + 8 * pt) =
            make_float2(dxa[pt][2 * rr], dxa[pt][2 * rr + 1]);
      colp[rr] = segment_sum(colp[rr], 4);
      if (cq == 0) red_colv[S * kTQ + j0 + lg + 8 * rr] = colp[rr];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = column_sum(tcol[t][e]);
        if (lg == 0) red_rowt[r * kTQ + 32 * S + 8 * t + 2 * cq + e] = v;
      }

    group_sync(0, kTcThreads);

    // dcum and ddt of the head's rows, from the partial sums in a fixed
    // order: warp 0, two rows a lane.
    if (warp == 0) {
      float v[2], w[2], tail = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const float rowt = ((red_rowt[j] + red_rowt[kTQ + j]) +
                            red_rowt[2 * kTQ + j]) + red_rowt[3 * kTQ + j];
        const float colv = red_colv[j] + red_colv[kTQ + j];
        const float ured = red_ured[j] + red_ured[kTQ + j];
        const float inter =
            expf(cg[j]) * (red_inter[j] + red_inter[kTQ + j]);
        const float dex = expf(cl - cg[j]), dj = dex * dg[j];
        v[u] = rowt - dg[j] * colv - dj * ured + inter;
        w[u] = fmaf(dex, ured, colv);
        tail = fmaf(dj, ured, tail);
      }
      tail = segment_sum(tail, 32);
      if (lane == 31) {
        float gh = 0.f;
        for (int k = 0; k < kTcThreads / 32; ++k) gh += red_gh[k];
        v[1] += expf(cl) * gh + tail;   // row Q - 1: the chunk's decay
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int64_t o = (row0 + lane + 32 * u) * H + h;
        dcum[o] = v[u];
        ddt[o] = w[u];
      }
    }
  }

  // dB += (sum_h dW o E o dt)^T . C and dC += (sum_h dW o E o dt) . B,
  // the sum staged over the x buffers as rows j and over the dy buffers as
  // rows i (no copy is in flight), so that both products read their A
  // operand K-major; each summed from zero and added to the running sums;
  // then this group's partial sums.
  float* scr = xs;    // [j][kLdS]
  float* scrt = dys;  // [i][kLdS]
  group_sync(0, kTcThreads);   // every warp is done with the last head
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = j0 + lg + 8 * rr, i = 32 * S + 8 * t + 2 * cq;
      *reinterpret_cast<float2*>(scr + j * kLdS + i) =
          make_float2(dcb[t][2 * rr], dcb[t][2 * rr + 1]);
      scrt[i * kLdS + j] = dcb[t][2 * rr];
      scrt[(i + 1) * kLdS + j] = dcb[t][2 * rr + 1];
    }
  group_sync(0, kTcThreads);
  {
    float acc[NTN][4];
#pragma unroll
    for (int t = 0; t < NTN; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
    for (int kt = 0; kt < kTQ / 8; ++kt) {
      if (kt < 2 * r) continue;   // rows j against i >= j
      const float* sr = scr + (j0 + lg) * kLdS + 8 * kt + cq;
      const Tf32A a(sr[0], sr[8 * kLdS], sr[4], sr[8 * kLdS + 4]);
      Tf32B bt[NTN];
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        const float* cr = cs + (8 * kt + cq) * kLdN + S * NH + 8 * nt + lg;
        bt[nt] = Tf32B(cr[0], cr[4 * kLdN]);
      }
      mma3<NTN>(acc, 0, a, bt);
    }
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dba[nt][e] += acc[nt][e];
  }
  {
    float acc[NTN][4];
#pragma unroll
    for (int t = 0; t < NTN; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
    for (int kt = 0; kt < kTQ / 8; ++kt) {
      if (kt > 2 * r + 1) continue;   // rows i against j <= i
      const float* sr = scrt + (j0 + lg) * kLdS + 8 * kt + cq;
      const Tf32A a(sr[0], sr[8 * kLdS], sr[4], sr[8 * kLdS + 4]);
      Tf32B bt[NTN];
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        const float* br = bs + (8 * kt + cq) * kLdN + S * NH + 8 * nt + lg;
        bt[nt] = Tf32B(br[0], br[4 * kLdN]);
      }
      mma3<NTN>(acc, 0, a, bt);
    }
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dca[nt][e] += acc[nt][e];
  }
  const int64_t part0 = (int64_t)grp * gridDim.z * L * N;   // this group
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t o = part0 + (row0 + j0 + lg + 8 * rr) * N + S * NH +
                      2 * cq;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      *reinterpret_cast<float2*>(db_part + o + 8 * nt) =
          make_float2(dba[nt][2 * rr], dba[nt][2 * rr + 1]);
      *reinterpret_cast<float2*>(dc_part + o + 8 * nt) =
          make_float2(dca[nt][2 * rr], dca[nt][2 * rr + 1]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kTcThreads, 1)
    ssd_chunk_bwd_tf32(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ cum,
                       const float* __restrict__ bm,
                       const float* __restrict__ cm,
                       const float* __restrict__ dy,
                       const float* __restrict__ g,
                       const float* __restrict__ hp, float* __restrict__ dx,
                       float* __restrict__ dcum, float* __restrict__ ddt,
                       float* __restrict__ db_part,
                       float* __restrict__ dc_part, int L, int H, int G) {
  constexpr int kLdN = N + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ChunkTf32Smem lay(N, G);
  float* cs = reinterpret_cast<float*>(smem_raw + lay.c);
  float* bs = reinterpret_cast<float*>(smem_raw + lay.b);
  float* dts = reinterpret_cast<float*>(smem_raw + lay.dts);
  float* cums = reinterpret_cast<float*>(smem_raw + lay.cums);
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h0 = blockIdx.y * G, b = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * kTQ;

  // B and C once per group, and the first head's x, dy, g and h_prev.
  for (int e = tid; e < kTQ * (N / 4); e += kTcThreads) {
    const int i = e / (N / 4), k4 = (e % (N / 4)) * 4;
    cp_async16(cs + i * kLdN + k4, cm + (row0 + i) * N + k4);
    cp_async16(bs + i * kLdN + k4, bm + (row0 + i) * N + k4);
  }
  tf32_load_xdy(reinterpret_cast<float*>(smem_raw + lay.x),
                reinterpret_cast<float*>(smem_raw + lay.dy), x, dy, row0, H,
                h0);
  tf32_load_gh<N>(reinterpret_cast<float*>(smem_raw + lay.g),
                  reinterpret_cast<float*>(smem_raw + lay.hp), g, hp,
                  (((int64_t)b * nc + c) * H + h0) * (int64_t)N * kTP);
  cp_async_commit();
  for (int e = tid; e < kTQ * G; e += kTcThreads) {
    const int i = e / G, gi = e % G;
    dts[gi * kTQ + i] = dt[(row0 + i) * H + h0 + gi];
    cums[gi * kTQ + i] = cum[(row0 + i) * H + h0 + gi];
  }
  cp_async_wait_all();
  __syncthreads();
  // Warps 0-3 take the first half of each product's columns, 4-7 the
  // second; both run the same barriers in the same order.
  if (tid < kTcThreads / 2)
    chunk_bwd_tf32_warp<N, 0>(x, dy, g, hp, dx, dcum, ddt, db_part, dc_part,
                              smem_raw, L, H, G);
  else
    chunk_bwd_tf32_warp<N, 1>(x, dy, g, hp, dx, dcum, ddt, db_part, dc_part,
                              smem_raw, L, H, G);
}

template <int N>
cudaError_t launch_chunk_bwd_tf32(const void* x, const void* dt,
                                  const void* cum, const void* bm,
                                  const void* cm, const void* dy,
                                  const void* g, const void* hp, void* dx,
                                  void* dcum, void* ddt, void* db_part,
                                  void* dc_part, int B, int L, int H, int G,
                                  cudaStream_t stream) {
  const size_t smem = ChunkTf32Smem(N, G).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_tf32<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(L / kTQ, H / G, B);
  ssd_chunk_bwd_tf32<N><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(dy),
      static_cast<const float*>(g), static_cast<const float*>(hp),
      static_cast<float*>(dx), static_cast<float*>(dcum),
      static_cast<float*>(ddt), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), L, H, G);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ssd_chunk_bwd_tf32_tiled: fp32 at Q = 128, 192, 256, P = 64, N = 64 or 128
// ---------------------------------------------------------------------------

// Shared-memory layout of ssd_chunk_bwd_tf32_tiled, in bytes
// (ssd_chunk_bwd_tf32_tiled_smem_bytes reports it, kernel.py's
// chunk_bwd_tf32_tiled_smem_bytes mirrors it): C_K and B_K of the block's
// rows ([kTQ][N + 8] fp32, as ssd_chunk_bwd_tf32's B and C); a two-stage
// ring of per-head tile pairs ([kTQ][kTP] fp32 each, swizzled by swz64:
// x_K and dy_K in the first phase, then x_K and dy_I or dy_K and x_J); a
// two-stage ring of the other row blocks' C_I or B_J ([kTQ][N + 8] fp32;
// in the first phase the head's g and h_prev, [N][kTP] fp32 each,
// swizzled); the staging tile ([kTQ][kLdScr] fp32: a tile's (C . B^T)^T
// fragments, or the group's dW o E o dt on it); dt and cum of the chunk
// for two heads ([2][2][Q] fp32); and the partial sums (12 . kTQ + 8
// floats).  ssd_chunk_bwd_tc_tiled's layout in fp32 would take 327,712
// bytes at N = 128, Q = 256; this one takes 229,408.
struct Tf32TiledBwdSmem {
  size_t c, b, pair, bcr, bc, scr, dtc, red, total;
  __host__ __device__ Tf32TiledBwdSmem(int N, int Q) {
    bc = (size_t)kTQ * (N + 8) * 4;
    const size_t xd = (size_t)kTQ * kTP * 4;
    c = 0;
    b = c + bc;
    pair = b + bc;       // 2 stages of two [kTQ][kTP] tiles
    bcr = pair + 4 * xd;  // 2 stages of `bc` bytes
    scr = bcr + 2 * bc;
    dtc = scr + (size_t)kTQ * kLdScr * 4;
    red = dtc + 4 * (size_t)Q * 4;
    total = red + (12 * (size_t)kTQ + 8) * 4;
  }
};

// The work of one warp of ssd_chunk_bwd_tf32_tiled: rows 16 r .. of the
// block's row block K (j for dx, dB and the column side, i for dC and the
// row side) and half S of each product's columns, as
// chunk_bwd_tiled_warp's warps, with ssd_chunk_bwd_tf32's products:
// every product three TF32 products on operands split as they reach the
// registers.  Two phases.  The first walks the group's heads as
// ssd_chunk_bwd_tf32 walks a chunk's: each head's state and inter terms of
// rows K (B_K . g, x_K . g^T, dy_K . h_prev^T; its g and h_prev copied
// once those are done, while the block works on the rest) and its
// diagonal tile (K, K), from (C_K . B_K^T)^T formed once for the group;
// the group's dW o E o dt on the diagonal summed in registers and
// multiplied with C_K and B_K at the end.  The second walks the
// off-diagonal tiles, each for every head of the group: the column side,
// (I, K) for I > K (dW^T = x_K . dy_I^T, dx_K += (K o dt)^T . dy_I, the
// column sums of V), from (C_I . B_K^T)^T formed once a tile and staged;
// the row side, (K, J) for J < K (dW = dy_K . x_J^T, the row sums of T),
// from C_K . B_J^T formed once a tile (each warp its own part, staged in
// its fragments' places).  Each (tile, head)'s x and dy tiles stream
// through a two-stage ring, each tile's C_I or B_J through another; the
// group's dW o E o dt on the tile is summed in registers and multiplied
// with C_I (into dB_K) or B_J (into dC_K) once the tile's heads are done.
// dx, dcum and ddt of rows K are written in the first phase and the
// group's partial dB and dC at its end, and each tile's terms added to
// them in the second in a fixed order (the second phase holds no dB or dC in
// registers: with them it spilled at N = 128); the dcum_last terms of
// these rows go into tails, as ssd_chunk_bwd_tc_tiled's.  No atomics: two
// passes are equal bit for bit.
template <int N, int S>
__device__ __forceinline__ void chunk_bwd_tf32_tiled_warp(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cum, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dy,
    const float* __restrict__ g, const float* __restrict__ hp,
    float* __restrict__ dx, float* __restrict__ dcum,
    float* __restrict__ ddt, float* __restrict__ db_part,
    float* __restrict__ dc_part, float* __restrict__ tails,
    unsigned char* smem_raw, int L, int H, int G, int Q) {
  constexpr int kLdN = N + 8;   // fp32 row of B and C
  constexpr int NH = N / 2;     // this warp's half of N
  constexpr int NTN = NH / 8;   // its n8 tiles
  const Tf32TiledBwdSmem lay(N, Q);
  const float* cs = reinterpret_cast<const float*>(smem_raw + lay.c);
  const float* bs = reinterpret_cast<const float*>(smem_raw + lay.b);
  float* gs = reinterpret_cast<float*>(smem_raw + lay.bcr);   // phase 1
  float* hs = gs + N * kTP;
  float* scr = reinterpret_cast<float*>(smem_raw + lay.scr);
  float4* scr4 = reinterpret_cast<float4*>(scr);
  float* dtc = reinterpret_cast<float*>(smem_raw + lay.dtc);
  float* red_ured = reinterpret_cast<float*>(smem_raw + lay.red);  // [2][64]
  float* red_inter = red_ured + 2 * kTQ;   // [2][64]
  float* red_gh = red_inter + 2 * kTQ;     // [8]
  float* red_rowd = red_gh + 8;            // [4][64]: the diagonal's
  float* red_colv = red_rowd + 4 * kTQ;    // [2][64]
  float* red_half = red_colv + 2 * kTQ;    // [64]: the second half's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane >> 2, cq = lane & 3;
  const int r = warp & 3, j0 = 16 * r;
  const int nb = Q / kTQ, nc = L / Q;
  const int c = blockIdx.x / nb, K = blockIdx.x % nb;
  const int grp = blockIdx.y, b = blockIdx.z;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;   // the chunk's
  const int64_t rk = row0 + kTQ * K;                      // block K's
  const int ntiles = nb - 1;         // off-diagonal tiles
  const int ncol = nb - 1 - K;       // of which on the column side

  // This lane's word offsets, in a swizzled tile, of rows 2c and 2c + 1
  // at its column of each of its half's p n-tiles (the B fragments of g
  // and of dy read MN-major in the permuted slots; a k8 step adds 8 rows).
  int mn[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      mn[u][e] = swz64(2 * cq + e, 32 * S + 8 * u + lg);

  auto pair_at = [&](int stage, int k) {
    return reinterpret_cast<float*>(smem_raw + lay.pair +
                                    (2 * stage + k) * kTQ * kTP * 4);
  };
  auto bc_at = [&](int stage) {
    return reinterpret_cast<float*>(smem_raw + lay.bcr + stage * lay.bc);
  };
  // dt and cum of head h over the chunk into buffer `stage`.
  auto load_dtc = [&](int h, int stage) {
    float* d = dtc + stage * 2 * Q;   // dt [Q], then cum [Q]
    for (int e = tid; e < 2 * Q; e += kTcThreads) {
      const int j = e < Q ? e : e - Q;
      cp_async4(d + e, (e < Q ? dt : cum) + (row0 + j) * H + h);
    }
  };
  // Head h's pair for off-diagonal tile t into ring stage `stage` (t < 0:
  // the first phase's x_K and dy_K): the column side (t < ncol) x_K and dy
  // of row block I = K + 1 + t, the row side dy_K and x of row block J =
  // t - ncol; and its dt and cum.
  auto load_pair = [&](int t, int h, int stage) {
    const bool col = t < ncol;
    const int64_t r1 =
        t < 0 ? rk : row0 + kTQ * (col ? K + 1 + t : t - ncol);
    const float* sa = col ? x : dy;
    const float* sb = col ? dy : x;
    float* da = pair_at(stage, 0);
    float* db = pair_at(stage, 1);
    for (int e = tid; e < kTQ * (kTP / 4); e += kTcThreads) {
      const int i = e >> 4, c4 = (e & 15) * 4;
      cp_async16(da + swz64(i, c4), sa + ((rk + i) * H + h) * kTP + c4);
      cp_async16(db + swz64(i, c4), sb + ((r1 + i) * H + h) * kTP + c4);
    }
    load_dtc(h, stage);
  };
  // C of row block I (column side) or B of row block J (row side) of
  // off-diagonal tile t into its ring stage.
  auto load_bc = [&](int t) {
    const bool col = t < ncol;
    const int64_t r1 = row0 + kTQ * (col ? K + 1 + t : t - ncol);
    const float* src = col ? cm : bm;
    float* d = bc_at(t & 1);
    for (int e = tid; e < kTQ * (N / 4); e += kTcThreads) {
      const int i = e / (N / 4), k4 = (e % (N / 4)) * 4;
      cp_async16(d + i * kLdN + k4, src + (r1 + i) * N + k4);
    }
  };
  // v (this warp's rows, its half of the columns) into the staging tile,
  // row-major, or transposed.
  auto stage_tile = [&](const float (&v)[4][4], bool transpose) {
#pragma unroll
    for (int lt = 0; lt < 4; ++lt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = j0 + lg + 8 * rr, col = 32 * S + 8 * lt + 2 * cq;
        if (transpose) {
          scr[col * kLdScr + row] = v[lt][2 * rr];
          scr[(col + 1) * kLdScr + row] = v[lt][2 * rr + 1];
        } else {
          *reinterpret_cast<float2*>(scr + row * kLdScr + col) =
              make_float2(v[lt][2 * rr], v[lt][2 * rr + 1]);
        }
      }
  };
  // (the staged tile, rows j0.., k8 steps kt_lo .. kt_hi, natural slots)
  // . tn (rows the k, [k][n] with rows of N + 8) on this warp's half of n,
  // half of its n-tiles at a time, each summed from zero and handed to
  // add(h2, acc) to be added where it goes.
  constexpr int NQ = NTN / 2;
  auto staged = [&](const float* tn, int kt_lo, int kt_hi, auto&& add) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float acc[NQ][4];
#pragma unroll
      for (int t = 0; t < NQ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
      for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const float* sr = scr + (j0 + lg) * kLdScr + 8 * kt + cq;
        const Tf32A a(sr[0], sr[8 * kLdScr], sr[4], sr[8 * kLdScr + 4]);
        Tf32B bt[NQ];
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          const float* tr = tn + (8 * kt + cq) * kLdN + S * NH +
                            8 * (NQ * h2 + nt) + lg;
          bt[nt] = Tf32B(tr[0], tr[4 * kLdN]);
        }
        mma3<NQ>(acc, 0, a, bt);
      }
      add(h2, acc);
    }
  };
  // ... into the running run[n-tiles of the half].
  auto staged_times = [&](float (&run)[NTN][4], const float* tn, int kt_lo,
                          int kt_hi) {
    staged(tn, kt_lo, kt_hi, [&](int h2, const float (&acc)[NQ][4]) {
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[NQ * h2 + nt][e] += acc[nt][e];
    });
  };
  // ... over all 8 k8 steps into the group's partial dB or dC of rows K in
  // the output.
  const int64_t part0 = (int64_t)grp * gridDim.z * L * N;
  auto staged_into = [&](float* out, const float* tn) {
    staged(tn, 0, kTQ / 8 - 1, [&](int h2, const float (&acc)[NQ][4]) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float* o = out + part0 + (rk + j0 + lg + 8 * rr) * N + S * NH +
                   8 * NQ * h2 + 2 * cq;
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          const float2 v = *reinterpret_cast<const float2*>(o + 8 * nt);
          *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(
              v.x + acc[nt][2 * rr], v.y + acc[nt][2 * rr + 1]);
        }
      }
    });
  };
  // The two halves' partial sums of this warp's rows, in a fixed order (the
  // first half's, then the second's), for the lanes of column 0: the
  // second half's warp hands its sums to the first's over a barrier of the
  // pair.
  auto pair_sum = [&](float (&v)[2]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      v[rr] = segment_sum(v[rr], 4);
      if (S == 1 && cq == 0) red_half[j0 + lg + 8 * rr] = v[rr];
    }
    group_sync(1 + r, 64);
    if (S == 0)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) v[rr] += red_half[j0 + lg + 8 * rr];
  };

  // Over the group's heads: dba and dca the running dB (rows j) and dC
  // (rows i) of this warp's half of n; dsum the group's dW o E o dt on a
  // tile (this warp's rows, its half of the columns).
  float dba[NTN][4], dca[NTN][4], dsum[4][4];
#pragma unroll
  for (int t = 0; t < NTN; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dba[t][e] = dca[t][e] = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dsum[t][e] = 0.f;

  // (C_K . B_K^T)^T once for the group: this warp's alternate i-tiles at or
  // right of the diagonal's, staged for both halves.
  cp_async_wait_all();
  group_sync(0, kTcThreads);
  if (r == 0) cbt_tf32<N, S>(scr4, bs, cs, r, j0, lg, cq, lane);
  else if (r == 1) cbt_tf32<N, 2 + S>(scr4, bs, cs, r, j0, lg, cq, lane);
  else if (r == 2) cbt_tf32<N, 4 + S>(scr4, bs, cs, r, j0, lg, cq, lane);
  else cbt_tf32<N, 6 + S>(scr4, bs, cs, r, j0, lg, cq, lane);

  // Phase 1: each head's state and inter terms of rows K, and its
  // diagonal tile.
  for (int gi = 0; gi < G; ++gi) {
    const int h = grp * G + gi, buf = gi & 1;
    // Head gi's x_K, dy_K, dt, cum, g and h_prev have landed; every warp
    // is done with head gi - 1.
    cp_async_wait_all();
    group_sync(0, kTcThreads);
    // The next head's x_K, dy_K, dt and cum; after the last head the
    // second phase's first pair.
    if (gi + 1 < G) load_pair(-1, h + 1, buf ^ 1);
    else load_pair(0, grp * G, buf ^ 1);
    cp_async_commit();
    const float* xb = pair_at(buf, 0);
    const float* dyb = pair_at(buf, 1);
    const float* dg = dtc + buf * 2 * Q;
    const float* cg = dg + Q;
    const float cl = cg[Q - 1];
    // This thread's two rows of block K, j0 + lg and j0 + lg + 8.
    float cur[2], dtr[2], dr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = kTQ * K + j0 + lg + 8 * rr;
      cur[rr] = cg[j];
      dtr[rr] = dg[j];
      dr[rr] = expf(cl - cur[rr]) * dtr[rr];   // d_j
    }
    // The head's state and inter terms of rows K (n-tiles half at a time).
    float dxa[4][4];
    tf32_state_terms<N, S, NQ>(dxa, dba, dca, bs, cs, gs, hs, xb, dyb, mn,
                               dr, cur, red_gh, red_ured, red_inter, j0, lg,
                               cq, lane);
    // Every read of g and h_prev is done: the next head's copies (after
    // the last head the second phase's first C_I or B_J, where they were)
    // go out while the block works on the diagonal tile.
    group_sync(0, kTcThreads);
    if (gi + 1 < G)
      tf32_load_gh<N>(gs, hs, g, hp,
                      (((int64_t)b * nc + c) * H + h + 1) * (int64_t)N * kTP);
    else
      load_bc(0);
    cp_async_commit();

    // The diagonal tile (K, K), as ssd_chunk_bwd_tf32's chunk.
    {
      float dwt[4][4], tcol[4][2], colp[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 4; ++t) tcol[t][0] = tcol[t][1] = 0.f;
      tf32_dw<S>(dwt, xb, dyb, true, r, j0, lane);
      tf32_tile_dx<S, true>(dxa, dsum, dwt, dyb, scr4, cg + kTQ * K, cur, dtr,
                            mn, colp, tcol, r, j0, lg, cq, lane);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float* o = dx + ((rk + j0 + lg + 8 * rr) * H + h) * kTP + 32 * S +
                   2 * cq;
#pragma unroll
        for (int pt = 0; pt < 4; ++pt)
          *reinterpret_cast<float2*>(o + 8 * pt) =
              make_float2(dxa[pt][2 * rr], dxa[pt][2 * rr + 1]);
        colp[rr] = segment_sum(colp[rr], 4);
        if (cq == 0) red_colv[S * kTQ + j0 + lg + 8 * rr] = colp[rr];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = column_sum(tcol[t][e]);
          if (lg == 0) red_rowd[r * kTQ + 32 * S + 8 * t + 2 * cq + e] = v;
        }
    }
    group_sync(0, kTcThreads);   // the partial sums are complete

    // dcum and ddt of rows K (the state, inter and diagonal terms) and
    // this block's dcum_last terms: warp 0, two rows a lane.
    if (warp == 0) {
      float tail = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = lane + 32 * u, j = kTQ * K + k;
        const float rowt = ((red_rowd[k] + red_rowd[kTQ + k]) +
                            red_rowd[2 * kTQ + k]) + red_rowd[3 * kTQ + k];
        const float colv = red_colv[k] + red_colv[kTQ + k];
        const float ured = red_ured[k] + red_ured[kTQ + k];
        const float inter =
            expf(cg[j]) * (red_inter[k] + red_inter[kTQ + k]);
        const float dex = expf(cl - cg[j]), dj = dex * dg[j];
        const int64_t o = (rk + k) * H + h;
        dcum[o] = rowt - dg[j] * colv - dj * ured + inter;
        ddt[o] = fmaf(dex, ured, colv);
        tail = fmaf(dj, ured, tail);
      }
      tail = segment_sum(tail, 32);
      if (lane == 0) {
        if (K == nb - 1) {
          float gh = 0.f;
          for (int k = 0; k < kTcThreads / 32; ++k) gh += red_gh[k];
          tail += expf(cl) * gh;
        }
        tails[(((int64_t)b * nc + c) * nb + K) * H + h] = tail;
      }
    }
  }

  // The group's dW o E o dt on the diagonal: dB_K += it . C_K over i >= j,
  // dC_K += its transpose . B_K over j <= i.  Every warp is done with the
  // fragments (the barrier above).
  stage_tile(dsum, false);
  group_sync(0, kTcThreads);
  staged_times(dba, cs, 2 * r, kTQ / 8 - 1);
  group_sync(0, kTcThreads);
  stage_tile(dsum, true);
  group_sync(0, kTcThreads);
  staged_times(dca, bs, 0, 2 * r + 1);

  // This group's partial dB and dC of rows K so far; the second phase adds
  // each tile's products to them in place.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t o = part0 + (rk + j0 + lg + 8 * rr) * N + S * NH + 2 * cq;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      *reinterpret_cast<float2*>(db_part + o + 8 * nt) =
          make_float2(dba[nt][2 * rr], dba[nt][2 * rr + 1]);
      *reinterpret_cast<float2*>(dc_part + o + 8 * nt) =
          make_float2(dca[nt][2 * rr], dca[nt][2 * rr + 1]);
    }
  }

  // Phase 2: each off-diagonal tile for every head of the group.
  int seq = G;   // pairs consumed
  for (int t = 0; t < ntiles; ++t) {
    const bool col = t < ncol;
    const int I = K + 1 + t, J = t - ncol;   // col: I; else J
    const float* tbc = bc_at(t & 1);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[u][e] = 0.f;
    for (int gi = 0; gi < G; ++gi, ++seq) {
      const int h = grp * G + gi, buf = seq & 1;
      // The pair (and at the tile's first head its C_I or B_J) has
      // landed; every warp is done with the last pair, the staging tile
      // and the partial sums.
      cp_async_wait_all();
      group_sync(0, kTcThreads);
      if (gi + 1 < G) load_pair(t, h + 1, buf ^ 1);
      else if (t + 1 < ntiles) load_pair(t + 1, grp * G, buf ^ 1);
      if (gi == 0 && t + 1 < ntiles) load_bc(t + 1);
      cp_async_commit();
      const float* pa = pair_at(buf, 0);
      const float* pb = pair_at(buf, 1);
      const float* dg = dtc + buf * 2 * Q;
      const float* cg = dg + Q;
      float cur[2], dtr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = kTQ * K + j0 + lg + 8 * rr;
        cur[rr] = cg[j];
        dtr[rr] = dg[j];
      }
      // What this head's terms are added to, read now so that the loads
      // are in flight while the block computes: dx of this warp's rows and
      // half of p (the column side), dcum and ddt of its rows (the lanes
      // that add them).
      float2 dxo[2][4];
      float dco[2], ddo[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int64_t o = (rk + j0 + lg + 8 * rr) * H + h;
#pragma unroll
        for (int pt = 0; pt < 4; ++pt)
          dxo[rr][pt] = col ? *reinterpret_cast<const float2*>(
                                  dx + o * kTP + 32 * S + 8 * pt + 2 * cq)
                            : make_float2(0.f, 0.f);
        dco[rr] = S == 0 && cq == 0 ? dcum[o] : 0.f;
        ddo[rr] = S == 0 && cq == 0 && col ? ddt[o] : 0.f;
      }
      float dwt[4][4], part[2] = {0.f, 0.f};
      if (col) {
        // Column side, tile (I, K): rows j of K, columns i of I.
        if (gi == 0) {
          cbt_tf32<N, S>(scr4, bs, tbc, r, j0, lg, cq, lane);
          group_sync(0, kTcThreads);   // the fragments are staged
        }
        float dxa[4][4], tcol[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) dxa[u][e] = 0.f;
        tf32_dw<S>(dwt, pa, pb, false, r, j0, lane);
        tf32_tile_dx<S, false>(dxa, dsum, dwt, pb, scr4, cg + kTQ * I, cur,
                               dtr, mn, part, tcol, r, j0, lg, cq, lane);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float* o = dx + ((rk + j0 + lg + 8 * rr) * H + h) * kTP + 32 * S +
                     2 * cq;
#pragma unroll
          for (int pt = 0; pt < 4; ++pt)
            *reinterpret_cast<float2*>(o + 8 * pt) =
                make_float2(dxo[rr][pt].x + dxa[pt][2 * rr],
                            dxo[rr][pt].y + dxa[pt][2 * rr + 1]);
        }
      } else {
        // Row side, tile (K, J): rows i of K, columns j of J.  C_K . B_J^T
        // on this warp's half of j, staged in its own fragments' places.
        if (gi == 0) {
          float cbr[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) cbr[u][e] = 0.f;
#pragma unroll 2
          for (int kn = 0; kn < N / 8; ++kn) {
            const float* ar = cs + (j0 + lg) * kLdN + 8 * kn + 2 * cq;
            const float2 v0 = *reinterpret_cast<const float2*>(ar);
            const float2 v1 =
                *reinterpret_cast<const float2*>(ar + 8 * kLdN);
            const Tf32A a(v0.x, v1.x, v0.y, v1.y);
            Tf32B bt[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float2 v = *reinterpret_cast<const float2*>(
                  tbc + (32 * S + 8 * u + lg) * kLdN + 8 * kn + 2 * cq);
              bt[u] = Tf32B(v.x, v.y);
            }
            mma3<4>(cbr, 0, a, bt);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            scr4[(r * 8 + 4 * S + u) * 32 + lane] =
                make_float4(cbr[u][0], cbr[u][1], cbr[u][2], cbr[u][3]);
        }
        tf32_dw<S>(dwt, pa, pb, false, r, j0, lane);
        // cur holds cum of this warp's rows i; the row sums of T and
        // dW o E o dt over dW.
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 32 * S + 8 * u + 2 * cq;
          const float cj[2] = {cg[kTQ * J + j], cg[kTQ * J + j + 1]};
          const float dj[2] = {dg[kTQ * J + j], dg[kTQ * J + j + 1]};
          const float4 cb4 = scr4[(r * 8 + 4 * S + u) * 32 + lane];
          const float cbr[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ex = expf(cur[rr] - cj[e]);   // i > j
              const float d = dwt[u][2 * rr + e];
              part[rr] = fmaf(d * (cbr[2 * rr + e] * ex), dj[e], part[rr]);
              dsum[u][2 * rr + e] =
                  fmaf(d * ex, dj[e], dsum[u][2 * rr + e]);
            }
        }
      }
      // This head's terms of dcum and ddt of rows K: the first half's warp
      // adds both halves' sums.
      pair_sum(part);
      if (S == 0 && cq == 0)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int j = kTQ * K + j0 + lg + 8 * rr;
          const int64_t o = (rk + j0 + lg + 8 * rr) * H + h;
          if (col) {
            dcum[o] = dco[rr] - dg[j] * part[rr];
            ddt[o] = ddo[rr] + part[rr];
          } else {
            dcum[o] = dco[rr] + part[rr];
          }
        }
    }
    // The group's dW o E o dt on the tile against C_I (into dB_K) or B_J
    // (into dC_K).
    group_sync(0, kTcThreads);   // every warp is done with the fragments
    stage_tile(dsum, false);
    group_sync(0, kTcThreads);
    staged_into(col ? db_part : dc_part, tbc);
  }
}

// One block of 8 warps per (chunk, row block K, group of G heads, batch).
template <int N>
__global__ void __launch_bounds__(kTcThreads, 1)
    ssd_chunk_bwd_tf32_tiled(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ cum, const float* __restrict__ bm,
        const float* __restrict__ cm, const float* __restrict__ dy,
        const float* __restrict__ g, const float* __restrict__ hp,
        float* __restrict__ dx, float* __restrict__ dcum,
        float* __restrict__ ddt, float* __restrict__ db_part,
        float* __restrict__ dc_part, float* __restrict__ tails, int L, int H,
        int G, int Q) {
  constexpr int kLdN = N + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tf32TiledBwdSmem lay(N, Q);
  float* cs = reinterpret_cast<float*>(smem_raw + lay.c);
  float* bs = reinterpret_cast<float*>(smem_raw + lay.b);
  float* gs = reinterpret_cast<float*>(smem_raw + lay.bcr);
  float* dtc = reinterpret_cast<float*>(smem_raw + lay.dtc);
  const int tid = threadIdx.x;
  const int nb = Q / kTQ, nc = L / Q;
  const int c = blockIdx.x / nb, K = blockIdx.x % nb;
  const int h0 = blockIdx.y * G, b = blockIdx.z;
  const int64_t row0 = (int64_t)b * L + (int64_t)c * Q;
  const int64_t rk = row0 + kTQ * K;

  // C_K and B_K once per group, and the first head's x_K, dy_K, dt, cum, g
  // and h_prev; here rather than in the warps' code, whose registers are
  // at their limit at N = 128.
  for (int e = tid; e < kTQ * (N / 4); e += kTcThreads) {
    const int i = e / (N / 4), k4 = (e % (N / 4)) * 4;
    cp_async16(cs + i * kLdN + k4, cm + (rk + i) * N + k4);
    cp_async16(bs + i * kLdN + k4, bm + (rk + i) * N + k4);
  }
  tf32_load_xdy(reinterpret_cast<float*>(smem_raw + lay.pair),
                reinterpret_cast<float*>(smem_raw + lay.pair) + kTQ * kTP, x,
                dy, rk, H, h0);
  tf32_load_gh<N>(gs, gs + N * kTP, g, hp,
                  (((int64_t)b * nc + c) * H + h0) * (int64_t)N * kTP);
  for (int e = tid; e < 2 * Q; e += kTcThreads) {
    const int j = e < Q ? e : e - Q;
    cp_async4(dtc + e, (e < Q ? dt : cum) + (row0 + j) * H + h0);
  }
  cp_async_commit();
  // Warps 0-3 take the first half of each product's columns, 4-7 the
  // second; both run the same barriers in the same order.
  if (tid < kTcThreads / 2)
    chunk_bwd_tf32_tiled_warp<N, 0>(x, dt, cum, bm, cm, dy, g, hp, dx, dcum,
                                    ddt, db_part, dc_part, tails, smem_raw,
                                    L, H, G, Q);
  else
    chunk_bwd_tf32_tiled_warp<N, 1>(x, dt, cum, bm, cm, dy, g, hp, dx, dcum,
                                    ddt, db_part, dc_part, tails, smem_raw,
                                    L, H, G, Q);
}

template <int N>
cudaError_t launch_chunk_bwd_tf32_tiled(
    const void* x, const void* dt, const void* cum, const void* bm,
    const void* cm, const void* dy, const void* g, const void* hp, void* dx,
    void* dcum, void* ddt, void* db_part, void* dc_part, void* tails, int B,
    int L, int H, int Q, int G, cudaStream_t stream) {
  const size_t smem = Tf32TiledBwdSmem(N, Q).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_tf32_tiled<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L / Q) * (Q / kTQ), H / G, B);
  ssd_chunk_bwd_tf32_tiled<N><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(dy),
      static_cast<const float*>(g), static_cast<const float*>(hp),
      static_cast<float*>(dx), static_cast<float*>(dcum),
      static_cast<float*>(ddt), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), static_cast<float*>(tails), L, H, G, Q);
  return cudaGetLastError();
}

// Shared-memory layout of ssd_carry_bwd_tc (C and dy in bf16: esize 2)
// and ssd_carry_bwd_tf32 (fp32: esize 4) at nc chunks of any length, in
// bytes (ssd_bwd_tc_smem_bytes and ssd_carry_bwd_tf32_smem_bytes report
// them): the forward walk's ring of state slices, the reverse walk's rings
// of 64-row slabs (C slices [kTQ][NS + 8] and dy tiles [kTQ][kLdX], in C's
// type, and cum columns), and every chunk's exp(cum_last).  Rows of NS + 8 and kTP + 8 elements: in bf16 the eight
// rows of an ldmatrix on distinct banks; in fp32 8 (mod 32) words, so that
// the MN-major fragment reads (rows c and c + 4, column g) meet no bank
// twice.
struct CarryTcSmem {
  size_t s, c, dy, cum, dec, total;
  __host__ __device__ CarryTcSmem(int NS, int nc, int esize = 2) {
    s = 0;
    c = s + kCarryStages * (size_t)NS * kTP * 4;
    dy = c + kCarryStages * (size_t)kTQ * (NS + 8) * esize;
    cum = dy + kCarryStages * (size_t)kTQ * kLdX * esize;
    dec = cum + kCarryStages * (size_t)kTQ * 4;
    total = dec + ((size_t)nc * 4 + 15) / 16 * 16;
  }
};

// The two walks of ssd_carry_bwd_tc (T = bf16, h_prev's and (exp(cum) o
// C)'s operands in NT bf16 terms) and ssd_carry_bwd_tf32 (T = float, TF32
// m16n8k8, three TF32 products a product) at chunks of S slabs of kTQ
// rows: one block per (slice of NS rows of N, head, batch); warps
// 0 .. NS/16 - 1 walk forward (h_prev), the others walk back (g), each
// group at its own pace.
template <typename T, int S, int NS, int NT>
__device__ __forceinline__ void carry_bwd_walk(
    unsigned char* smem_raw, const float* __restrict__ states,
    const float* __restrict__ cum, const T* __restrict__ cm,
    const T* __restrict__ dy, const float* __restrict__ init,
    const float* __restrict__ dfinal, float* __restrict__ h_prev,
    float* __restrict__ g_out, float* __restrict__ dinit, int L, int H,
    int N) {
  constexpr bool kTf32 = sizeof(T) == 4;
  constexpr int W = NS / 16;        // warps of each walk
  constexpr int kGroup = 32 * W;    // threads of each walk
  constexpr int kLdC = NS + 8;      // padded row of a C slice
  constexpr int VW = 16 / sizeof(T);   // values a 16-byte copy
  constexpr int kPer = NS * kTP / 4 / kGroup;   // float4s a forward thread
  constexpr int Q = S * kTQ;        // chunk rows
  const int nc = L / Q;
  const CarryTcSmem lay(NS, nc, sizeof(T));
  float* ring_s = reinterpret_cast<float*>(smem_raw + lay.s);
  T* ring_c = reinterpret_cast<T*>(smem_raw + lay.c);
  T* ring_dy = reinterpret_cast<T*>(smem_raw + lay.dy);
  float* ring_cum = reinterpret_cast<float*>(smem_raw + lay.cum);
  float* dec = reinterpret_cast<float*>(smem_raw + lay.dec);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * NS, h = blockIdx.y, b = blockIdx.z;
  const int64_t whole = ((int64_t)b * H + h) * (int64_t)N * kTP;
  auto at = [&](int c) {
    return (((int64_t)b * nc + c) * H + h) * (int64_t)N * kTP;
  };

  for (int c = tid; c < nc; c += blockDim.x)
    dec[c] = expf(cum[((int64_t)b * L + (int64_t)c * Q + Q - 1) * H + h]);
  __syncthreads();

  if (warp < W) {
    // Forward: h_prev_c = h, h = exp(cum_last,c) h + S_c.  Thread tid owns
    // the float4s tid + kGroup k of the [NS][P] slice and copies exactly
    // those, so it waits for its own copies and needs no barrier.
    auto off = [&](int k) {
      const int e = tid + kGroup * k;
      return (int64_t)(n0 + (e >> 4)) * kTP + (e & 15) * 4;
    };
    auto issue = [&](int c) {
      float* dst = ring_s + (c % kCarryStages) * NS * kTP;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        cp_async16(dst + 4 * (tid + kGroup * k), states + at(c) + off(k));
    };
    float4 hv[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      hv[k] = init ? ld4(init + whole + off(k))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kCarryStages - 1; ++c) {
      if (c < nc) issue(c);
      cp_async_commit();
    }
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kCarryStages - 2>();   // chunk c's slice has landed
      if (c + kCarryStages - 1 < nc) issue(c + kCarryStages - 1);
      cp_async_commit();
      const float* src = ring_s + (c % kCarryStages) * NS * kTP;
      const float d = dec[c];
      const int64_t s = at(c);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        st4(h_prev + s + off(k), hv[k]);
        hv[k] = decay4(d, hv[k], ld4(src + 4 * (tid + kGroup * k)));
      }
    }
    return;
  }

  // Reverse: g_c = g, g = exp(cum_last,c) g + sum_i exp(cum_i) C_i (x) dy_i,
  // the sum as (exp(cum) o C)^T . dy on mma.sync, slab by slab into one
  // accumulator: C's slice is the A operand, read MN-major and scaled by
  // exp(cum_i), dy the B operand.
  // bf16: C's fragment by ldmatrix.trans, scaled and split into NT bf16
  // terms; dy as read.  fp32: both read as 32-bit values in the natural
  // slots (rows i = c and c + 4 of each k8 step), split as read, three
  // TF32 products a product (mma3).  g stays in fp32 registers in the
  // accumulator layout: rows n0 + 16 rw + lg (+ 8), columns 8 pt + 2 q.
  const int rt = tid - kGroup, rw = warp - W;
  const int lg = lane >> 2, cq = lane & 3;
  // Step t walks slab t % S of chunk nc - 1 - t / S (the chunk's rows
  // from 64 (t % S)); cum is the within-chunk cumsum, read as it is.
  auto issue = [&](int t) {
    const int st = t % kCarryStages;
    const int64_t r0 = (int64_t)b * L + (int64_t)(nc - 1 - t / S) * Q +
                       (t % S) * kTQ;
    T* cd = ring_c + st * kTQ * kLdC;
    T* dd = ring_dy + st * kTQ * kLdX;
    float* cu = ring_cum + st * kTQ;
    for (int e = rt; e < kTQ * (NS / VW); e += kGroup) {
      const int i = e / (NS / VW), k8 = (e % (NS / VW)) * VW;
      cp_async16(cd + i * kLdC + k8, cm + (r0 + i) * N + n0 + k8);
    }
    constexpr int kRowShift = VW == 8 ? 3 : 4;   // log2(kTP / VW)
    for (int e = rt; e < kTQ * (kTP / VW); e += kGroup) {
      const int i = e >> kRowShift, k8 = (e & (kTP / VW - 1)) * VW;
      cp_async16(dd + i * kLdX + k8, dy + ((r0 + i) * H + h) * kTP + k8);
    }
    for (int e = rt; e < kTQ; e += kGroup)
      cp_async4(cu + e, cum + (r0 + e) * H + h);
  };
  float gv[8][4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t o = whole + (int64_t)(n0 + 16 * rw + lg + 8 * rr) * kTP +
                      2 * cq;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      const float2 v = dfinal
                           ? *reinterpret_cast<const float2*>(dfinal + o +
                                                              8 * pt)
                           : make_float2(0.f, 0.f);
      gv[pt][2 * rr] = v.x;
      gv[pt][2 * rr + 1] = v.y;
    }
  }
  const int steps = nc * S;
#pragma unroll
  for (int t = 0; t < kCarryStages - 1; ++t) {
    if (t < steps) issue(t);
    cp_async_commit();
  }
  float acc[8][4];
  for (int t = 0; t < steps; ++t) {
    const int c = nc - 1 - t / S, st = t % kCarryStages;
    // Step t's slab has landed; every warp of the walk is done with step
    // t - 1's stage, which the copy below refills.
    cp_async_wait<kCarryStages - 2>();
    group_sync(1, kGroup);
    if (t + kCarryStages - 1 < steps) issue(t + kCarryStages - 1);
    cp_async_commit();
    const T* cst = ring_c + st * kTQ * kLdC;
    const T* dst = ring_dy + st * kTQ * kLdX;
    const float* cu = ring_cum + st * kTQ;
    if (t % S == 0) {   // the chunk's first slab
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;
    }
    if constexpr (kTf32) {
#pragma unroll 2
      for (int ks = 0; ks < kTQ / 8; ++ks) {
        const int i = 8 * ks + cq;   // slots cq and cq + 4: rows i, i + 4
        const float e0 = expf(cu[i]), e4 = expf(cu[i + 4]);
        const float* cr = cst + i * kLdC + 16 * rw + lg;
        const Tf32A a(cr[0] * e0, cr[8] * e0, cr[4 * kLdC] * e4,
                      cr[4 * kLdC + 8] * e4);
#pragma unroll
        for (int p0 = 0; p0 < 8; p0 += 4) {
          Tf32B bt[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* dr = dst + i * kLdX + 8 * (p0 + u) + lg;
            bt[u] = Tf32B(dr[0], dr[4 * kLdX]);
          }
          mma3<4>(acc, p0, a, bt);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        ldsm_x4_t(a, cst + (16 * kk + (lane & 7) + (lane >> 4) * 8) * kLdC +
                         16 * rw + ((lane >> 3) & 1) * 8);
        const int i = 16 * kk + 2 * cq;
        const float e0 = expf(cu[i]), e1 = expf(cu[i + 1]);
        const float e8 = expf(cu[i + 8]), e9 = expf(cu[i + 9]);
        uint32_t ta[NT][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = unpack2(a[q]);
          uint32_t tt[NT];
          split<NT>(v.x * (q < 2 ? e0 : e8), v.y * (q < 2 ? e1 : e9), tt);
#pragma unroll
          for (int k = 0; k < NT; ++k) ta[k][q] = tt[k];
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t q[4];
          ldsm_x4_t(q, dst + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kLdX +
                           16 * m + (lane >> 4) * 8);
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            mma(acc[2 * m], ta[k], q[0], q[1]);
            mma(acc[2 * m + 1], ta[k], q[2], q[3]);
          }
        }
      }
    }
    if (t % S != S - 1) continue;   // the chunk has slabs to come
    const float d = dec[c];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* o = g_out + at(c) + (int64_t)(n0 + 16 * rw + lg + 8 * rr) * kTP +
                 2 * cq;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        *reinterpret_cast<float2*>(o + 8 * pt) =
            make_float2(gv[pt][2 * rr], gv[pt][2 * rr + 1]);
        gv[pt][2 * rr] = fmaf(d, gv[pt][2 * rr], acc[pt][2 * rr]);
        gv[pt][2 * rr + 1] = fmaf(d, gv[pt][2 * rr + 1], acc[pt][2 * rr + 1]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float* o = dinit + whole + (int64_t)(n0 + 16 * rw + lg + 8 * rr) * kTP +
               2 * cq;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
      *reinterpret_cast<float2*>(o + 8 * pt) =
          make_float2(gv[pt][2 * rr], gv[pt][2 * rr + 1]);
  }
}

template <int S, int NS, int NT>
__global__ void __launch_bounds__(4 * NS)
    ssd_carry_bwd_tc(const float* __restrict__ states,
                     const float* __restrict__ cum,
                     const bf16* __restrict__ cm, const bf16* __restrict__ dy,
                     const float* __restrict__ init,
                     const float* __restrict__ dfinal,
                     float* __restrict__ h_prev, float* __restrict__ g_out,
                     float* __restrict__ dinit, int L, int H, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  carry_bwd_walk<bf16, S, NS, NT>(smem_raw, states, cum, cm, dy, init,
                                  dfinal, h_prev, g_out, dinit, L, H, N);
}

template <int S, int NS>
__global__ void __launch_bounds__(4 * NS)
    ssd_carry_bwd_tf32(const float* __restrict__ states,
                       const float* __restrict__ cum,
                       const float* __restrict__ cm,
                       const float* __restrict__ dy,
                       const float* __restrict__ init,
                       const float* __restrict__ dfinal,
                       float* __restrict__ h_prev, float* __restrict__ g_out,
                       float* __restrict__ dinit, int L, int H, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  carry_bwd_walk<float, S, NS, 0>(smem_raw, states, cum, cm, dy, init,
                                  dfinal, h_prev, g_out, dinit, L, H, N);
}

// ssd_carry_bwd_tc (bf16) or ssd_carry_bwd_tf32 (fp32) at kCarryRows rows
// of N a block, chunks of S slabs of kTQ rows.
template <typename T, int S>
cudaError_t launch_carry_bwd_tc(const void* states, const void* cum,
                                const void* cm, const void* dy,
                                const void* init, const void* dfinal,
                                void* h_prev, void* g, void* dinit, int B,
                                int L, int H, int N, cudaStream_t stream) {
  constexpr int NS = kCarryRows;
  const auto kernel = [] {
    if constexpr (sizeof(T) == 2)
      return ssd_carry_bwd_tc<S, NS, kBwdTerms>;
    else
      return ssd_carry_bwd_tf32<S, NS>;
  }();
  const size_t smem = CarryTcSmem(NS, L / (S * kTQ), sizeof(T)).total;
  if (N % NS || smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / NS, H, B);
  kernel<<<grid, 4 * NS, smem, stream>>>(
      static_cast<const float*>(states), static_cast<const float*>(cum),
      static_cast<const T*>(cm), static_cast<const T*>(dy),
      static_cast<const float*>(init), static_cast<const float*>(dfinal),
      static_cast<float*>(h_prev), static_cast<float*>(g),
      static_cast<float*>(dinit), L, H, N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for C and dy.  states, h_prev and g
// [B, L / Q, H, N, P], cum [B, L, H], init, dfinal and dinit [B, H, N, P]
// fp32 (init and dfinal may be null: zeros), C [B, L, N], dy [B, L, H, P];
// all contiguous and 16-byte aligned; P and N multiples of 8, N at most
// 256.  tc = 0 runs ssd_carry_bwd on the CUDA cores; tc = 1, at Q = 64,
// 128, 192 or 256, P = 64 and N = 64 or 128, runs ssd_carry_bwd_tc for
// bf16 and ssd_carry_bwd_tf32 for fp32.
extern "C" int ssd_carry_bwd_launch(const void* states, const void* cum,
                                    const void* cm, const void* dy,
                                    const void* init, const void* dfinal,
                                    void* h_prev, void* g, void* dinit,
                                    int dtype, int B, int L, int H, int P,
                                    int N, int Q, int tc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P % 8 || N % 8 || N > 256 || Q < 1 || L % Q)
    return (int)cudaErrorInvalidValue;
  if (tc) {
    if (Q % kTQ || Q > kTiledMaxQ || P != kTP || (N != 64 && N != 128) ||
        (dtype != 0 && dtype != 1))
      return (int)cudaErrorInvalidValue;
#define SSD_CARRY_BWD_TC(T, S)                                              \
  return (int)launch_carry_bwd_tc<T, S>(states, cum, cm, dy, init, dfinal, \
                                        h_prev, g, dinit, B, L, H, N, s)
    if (dtype == 1 && Q == kTQ) SSD_CARRY_BWD_TC(bf16, 1);
    if (dtype == 1 && Q == 2 * kTQ) SSD_CARRY_BWD_TC(bf16, 2);
    if (dtype == 1 && Q == 3 * kTQ) SSD_CARRY_BWD_TC(bf16, 3);
    if (dtype == 1) SSD_CARRY_BWD_TC(bf16, 4);
    if (Q == kTQ) SSD_CARRY_BWD_TC(float, 1);
    if (Q == 2 * kTQ) SSD_CARRY_BWD_TC(float, 2);
    if (Q == 3 * kTQ) SSD_CARRY_BWD_TC(float, 3);
    SSD_CARRY_BWD_TC(float, 4);
#undef SSD_CARRY_BWD_TC
  }
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
// [H / G, B, L, N] fp32; all contiguous and 16-byte aligned.  Q from 1 to
// 256, P a multiple of 4 up to 64, N a power of two from 8 to 128, G a
// divisor of H up to 16.  tc = 0 runs ssd_chunk_bwd on the CUDA cores;
// tc = 1, at Q = P = 64 and N = 64 or 128, runs ssd_chunk_bwd_tc for bf16
// and ssd_chunk_bwd_tf32 for fp32.
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* dt,
                                    const void* cum, const void* bm,
                                    const void* cm, const void* dy,
                                    const void* g, const void* hp, void* dx,
                                    void* dcum, void* ddt, void* db_part,
                                    void* dc_part, int dtype, int B, int L,
                                    int H, int P, int N, int Q, int G,
                                    int tc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > 256 || L % Q || P % 4 || P < 4 || P > 64 || !pow2(N) ||
      N < 8 || N > 128 || G < 1 || G > kMaxGroup || H % G)
    return (int)cudaErrorInvalidValue;
  if (tc) {
    if (Q != kTQ || P != kTP) return (int)cudaErrorInvalidValue;
#define SSD_CHUNK_BWD_TC(KERNEL, NN)                                        \
  return (int)KERNEL<NN>(x, dt, cum, bm, cm, dy, g, hp, dx, dcum, ddt,      \
                         db_part, dc_part, B, L, H, G, s)
    if (dtype == 1 && N == 64) SSD_CHUNK_BWD_TC(launch_chunk_bwd_tc, 64);
    if (dtype == 1 && N == 128) SSD_CHUNK_BWD_TC(launch_chunk_bwd_tc, 128);
    if (dtype == 0 && N == 64) SSD_CHUNK_BWD_TC(launch_chunk_bwd_tf32, 64);
    if (dtype == 0 && N == 128) SSD_CHUNK_BWD_TC(launch_chunk_bwd_tf32, 128);
#undef SSD_CHUNK_BWD_TC
    return (int)cudaErrorInvalidValue;
  }
  const int mt = ((bwd_rows(Q) / 4) * (N / 4) + kThreads - 1) /
                 kThreads;  // 1 or 2
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

// dtype: 0 = float32, 1 = bfloat16 for x, B, C and dy; shapes as
// ssd_chunk_bwd_launch with P = 64, N = 64 or 128 and Q = 128, 192 or 256;
// tails [B, L / Q, Q / 64, H] fp32 (each row block's terms of its chunk's
// dcum_last, for the caller to add to the chunk's last row).  Runs
// ssd_chunk_bwd_tc_tiled (bf16) or ssd_chunk_bwd_tf32_tiled (fp32), which
// write dcum without those terms.
extern "C" int ssd_chunk_bwd_tiled_launch(
    const void* x, const void* dt, const void* cum, const void* bm,
    const void* cm, const void* dy, const void* g, const void* hp, void* dx,
    void* dcum, void* ddt, void* db_part, void* dc_part, void* tails,
    int dtype, int B, int L, int H, int P, int N, int Q, int G,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || P != kTP || Q % kTQ || Q <= kTQ ||
      Q > kTiledMaxQ || L % Q || G < 1 || G > kMaxGroup || H % G)
    return (int)cudaErrorInvalidValue;
#define SSD_CHUNK_BWD_TILED(KERNEL, NN)                                     \
  return (int)KERNEL<NN>(x, dt, cum, bm, cm, dy, g, hp, dx, dcum, ddt,      \
                         db_part, dc_part, tails, B, L, H, Q, G, s)
  if (dtype == 1 && N == 64) SSD_CHUNK_BWD_TILED(launch_chunk_bwd_tiled, 64);
  if (dtype == 1 && N == 128)
    SSD_CHUNK_BWD_TILED(launch_chunk_bwd_tiled, 128);
  if (dtype == 0 && N == 64)
    SSD_CHUNK_BWD_TILED(launch_chunk_bwd_tf32_tiled, 64);
  if (dtype == 0 && N == 128)
    SSD_CHUNK_BWD_TILED(launch_chunk_bwd_tf32_tiled, 128);
#undef SSD_CHUNK_BWD_TILED
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of ssd_chunk_bwd_tc_tiled at state size N
// (64 or 128) and chunk Q (128, 192 or 256); -1 for anything else.
extern "C" int ssd_chunk_bwd_tiled_smem_bytes(int N, int Q) {
  if ((N != 64 && N != 128) || Q % kTQ || Q <= kTQ || Q > kTiledMaxQ)
    return -1;
  return (int)TiledBwdSmem(N, Q).total;
}

// Dynamic shared memory (bytes) of ssd_chunk_bwd_tf32_tiled at state size
// N (64 or 128) and chunk Q (128, 192 or 256); -1 for anything else.
extern "C" int ssd_chunk_bwd_tf32_tiled_smem_bytes(int N, int Q) {
  if ((N != 64 && N != 128) || Q % kTQ || Q <= kTQ || Q > kTiledMaxQ)
    return -1;
  return (int)Tf32TiledBwdSmem(N, Q).total;
}

// Dynamic shared memory (bytes) of ssd_chunk_bwd_tc (which = 0) at state
// size N with n heads a block, or of ssd_carry_bwd_tc (which = 1) at n
// chunks of any length it takes; -1 for anything else.
extern "C" int ssd_bwd_tc_smem_bytes(int which, int N, int n) {
  if ((N != 64 && N != 128) || n < 1) return -1;
  if (which == 0) return (int)ChunkTcSmem(N, n).total;
  if (which == 1) return (int)CarryTcSmem(kCarryRows, n).total;
  return -1;
}

// Dynamic shared memory (bytes) of ssd_chunk_bwd_tf32 at state size N
// with G heads a block; -1 for anything else.
extern "C" int ssd_chunk_bwd_tf32_smem_bytes(int N, int G) {
  if ((N != 64 && N != 128) || G < 1) return -1;
  return (int)ChunkTf32Smem(N, G).total;
}

// Dynamic shared memory (bytes) of an ssd_chunk_bwd block (which = 0) or
// of an ssd_carry_bwd block at its 16-column slice (1), at chunk Q, state
// size N and head width P; -1 for anything else.
extern "C" int ssd_bwd_smem_bytes(int which, int Q, int N, int P) {
  if (Q < 1 || N < 1 || P < 1) return -1;
  if (which == 0) return (int)(ChunkBwdSmem(Q, N, P).total * sizeof(float));
  if (which == 1) return (int)carry_bwd_smem_bytes(Q, N, 16);
  return -1;
}

// Dynamic shared memory (bytes) of ssd_carry_bwd_tf32 at n chunks of any
// length it takes; -1 for anything else.
extern "C" int ssd_carry_bwd_tf32_smem_bytes(int n) {
  if (n < 1) return -1;
  return (int)CarryTcSmem(kCarryRows, n, 4).total;
}
