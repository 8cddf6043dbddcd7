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
// Head dims: the reference's D "rides along whole", up to 256.  Each
// kernel is built for the column buckets W = 32, 64, 128, 192, 256
// (fa_bucket in fa_hopper.cuh) and takes the true D <= W at run time:
// columns D .. W - 1 of every tile are zeros (TMA's fill for bf16, the
// cp.async copies' zero fill for fp32), which add exact zeros to q k^T and give zero output
// columns, and only the first D output columns are written.  The scale is
// the caller's (1/sqrt(D) of the true D).  bf16 needs D a multiple of 8
// (a tensor map's rows are whole 16-byte units); the wrapper zero-pads q,
// k and v to that.
//
// With a non-null `lse` ([B, H, Lq] fp32) both kernels also write each
// row's log-sum-exp of its scaled, masked logits, m + log l in natural-log
// units, which the backward kernels (flash_attention_bwd.cu) recompute P
// from.  Serving passes null and writes nothing more.
//
// Bound: operations.  The function does 4*D flops per unmasked (q, k)
// pair (D multiply-adds for q.k, D for p.v) and moves only q, k, v and o
// once, so at the serving shapes (L = 2048 or 32768, D >= 64) it sits far
// above the card's ridge point.  At D = 64 the exponentials come close to
// the products: one ex2 per pair at 16 per clock per SM.  fp32 products
// are priced at three TF32 tensor-core products a product (494.7 / 3
// TFLOP/s), which is how the fp32 kernel takes them.
//
// Two kernels, chosen by dtype:
//
// * bf16 (the model's serving dtype): fa_kernel_tc, on the tensor cores.
//   One block of 384 threads per (128 query rows, head, batch): two
//   consumer warpgroups of 64 rows each and a producer warpgroup, of
//   which one thread issues the copies (setmaxnreg moves registers from
//   the producer to the consumers).  The producer loads the q tile once
//   and the k and v tiles of 64 keys through a ring of ring_stages<W>
//   stages in shared memory with TMA (cp.async.bulk.tensor, 4-D tensor
//   maps over (D, H, L, B), 64-column boxes with the 128-byte swizzle; at
//   W = 32 one 32-column box with the 64-byte swizzle), each stage guarded
//   by a `full` and an `empty` mbarrier, so the next tiles load while the
//   current one is multiplied.  TMA fills rows past L and columns past D
//   with zeros; the -1e30 masks do the rest.  The ring is 4 stages deep up
//   to W = 128, 3 at 192 and 2 at 256 (each stage holds a k and a v tile
//   of W columns): tc_smem_bytes, under the 232,448 bytes a block may
//   take.  q k^T runs all W / 16 k16 steps and p v all W columns, so a D
//   below its bucket (80 or 96 at W = 128) pays for the zero columns.  A
//   consumer warpgroup computes S = q k^T with wgmma m64n64k16 (q and k
//   both K-major from shared memory), takes the row max and sum on S's
//   fp32 accumulator in registers (a row lies in 4 lanes: two shuffles),
//   and computes each tile's P V with wgmma m64n64k16 per 64 columns
//   (m64n32 at W = 32), P from registers (S's accumulator fragment maps
//   onto the A fragments of the k16 steps once packed to bf16 pairs) and V
//   from shared memory (MN-major, the transpose bit set).  Tile t's q k^T
//   is issued before tile t - 1's P V: the split of P runs while the
//   tensor cores do q k^T, the softmax of tile t while they do P V.
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
//   8*W flops per pair (2*W for q.k, 3 * 2*W for p.v), against the
//   function's 4*D.
//
//   The order of the output's sums follows the registers.  Up to W = 128
//   each tile's T is summed from zero on the tensor cores (tacc) and the
//   running output is kept on the CUDA cores, O = O * alpha + T in fp32:
//   with O carried in the wgmma accumulator across all key tiles instead,
//   rows of 32,768 keys missed the bar on the H100 at every head width
//   (the accumulator's sums over thousands of k16 steps drift further from
//   the exact sum than fp32 rounding does).  At W = 192 and 256 a second
//   accumulator of 64 x W fp32 does not fit beside O (W / 2 registers a
//   thread each, 256 at W = 256, over the 240 a consumer thread has), so
//   there O is rescaled by alpha on the CUDA cores before the tile's P V
//   and the three terms' products accumulate into O itself (the CPU
//   emulation holds this order to the bar at 2,048 keys; chip_smoke.py
//   phase 6 holds it on the card up to 4,096).
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
//   needs fp32 products): fa_kernel_tf32, on the tensor cores with TF32
//   mma.sync m16n8k8 (fa_tf32.cuh, shared with the fp32 backward).  Each
//   fp32 operand x is split into hi = x rounded to 10 mantissa bits and
//   lo = x - hi, and every product is taken as three TF32 products,
//   hi·hi + hi·lo + lo·hi, summed in fp32 (mma3): about 2^-21 of each
//   product is lost, where one TF32 product (plain TF32) misses the 2e-5
//   bar by 4-49x and two by 3-47x (the CPU emulation,
//   tests/test_torch_flash_attention.py::emulate_tf32_fwd).  wgmma takes
//   .tf32 operands only K-major from shared memory, and v in p v is read
//   MN-major, so the kernel uses mma.sync.
//
//   Blocks: R = f32_rows<W> query rows (64 up to W = 128, 32 above) per
//   (row block, head, batch), 2 R / 16 warps (8 or 4), one block an SM;
//   the q tile is loaded once and split once into its hi and lo tiles,
//   and the k and v tiles of R keys stream through a 2-stage cp.async
//   ring (tf32_load_tile; rows past L and columns past D zero-filled), so
//   the next tile loads while the current one is multiplied.  Warp j + h R / 16 (h = 0, 1) takes query rows
//   16 j .. 16 j + 15 against half h of each key tile, with its own row
//   max m, sum l and output O; at the end the halves merge through shared
//   memory (m = max(m0, m1), a_h = exp(m_h - m), l = l0 a0 + l1 a1,
//   O = O0 a0 + O1 a1).  A half that none of a warp's rows sees is
//   skipped; key tiles above the block's causal diagonal are not loaded;
//   query blocks go heaviest first.  Shared memory: q's hi and lo tiles
//   and two stages of k and v, R W words each (tf32_smem_bytes: 196,608
//   bytes at W = 128 and 256; kernel.py mirrors it).
//
//   Per key tile: S = q k^T over the true D in k8 steps (qk_tf32, both
//   operands K-major through ldmatrix, q's terms from their tiles, k split
//   in registers), summed from zero with hi·hi apart from hi·lo + lo·hi
//   (more independent sums in flight; it also cut the worst error at
//   4,096 keys by a quarter on the card); logits S scale,
//   -1e30 where masked (only on tiles that cross the diagonal or Lk); the
//   online softmax with the accurate expf (a row spans the four lanes of
//   its fragment row: two shuffles), p = 0 where masked; then T = p v,
//   p's accumulator fragment as the split A operand (split_rows) and v's
//   rows read MN-major from the swizzled tile, summed from zero on the
//   tensor cores and added as O = O alpha + T in fp32 on the CUDA cores:
//   O is never carried in the tensor cores' accumulator, whose sums cut
//   rather than round (carried across 4,096 keys such a sum drifted to
//   half the backward's bar).  p v runs over groups of Tf32<W>::NG output
//   n-tiles (4 at W = 256, where more tile sums spill), the last group cut
//   at the n-tile holding D - 1 (to 2, 4 or NG n-tiles, pv_tf32), so D =
//   80 computes 80 columns, not its bucket's 128.  lse = m + log l in
//   natural-log units.  MMA work: 6 (8 ceil(D/8) + the p v columns) flops
//   a pair (kernel.py's fwd_tf32_pv_tiles).

#include "fa_hopper.cuh"
#include "fa_tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: tensor cores (mma.sync TF32, three terms), cp.async ring
// ---------------------------------------------------------------------------

// Shared memory of fa_kernel_tf32: q's hi and lo tiles and the ring's
// stages of k and v tiles, fp32, unpadded (the tiles are swizzled).
template <int W>
__host__ __device__ constexpr int tf32_smem_bytes() {
  constexpr int R = f32_rows<W>();
  return 4 * (2 * R * W + Tf32<W>::S * 2 * R * W);
}

// s = X Y^T for the warp's 16 rows of q against NN n-tiles (8 rows each)
// of a swizzled k tile, contracted over their first 8 nks columns, both
// K-major through ldmatrix (mma_nt's fragments).  X comes as its two TF32
// terms from their own tiles (q split once a block), Y is split as it
// reaches the registers.  hi·hi is summed apart from hi·lo + lo·hi, both
// from zero, and the two added at the end: twice the independent sums in
// flight, and the tensor cores' cut of the small terms' sum stays small.
template <int W, int NN>
__device__ __forceinline__ void qk_tf32(float (&s)[NN][4], const float* xh,
                                        const float* xl, const float* y,
                                        int nks, int lane) {
  const int sw = lane & 7;  // = the row's r % 8 for every lane below
  // A: matrices (rows 0-7, k 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7).
  const int xrow = (lane & 7) + 8 * ((lane >> 3) & 1), xk = lane >> 4;
  // B: as ldsm_split_b reads them.
  const int yrow = (lane & 7) + 8 * (lane >> 4), yk = (lane >> 3) & 1;
  const uint32_t xah = smem_addr(xh) + xrow * W * 4;
  const uint32_t xal = smem_addr(xl) + xrow * W * 4;
  const uint32_t ya = smem_addr(y) + yrow * W * 4;
  float corr[NN][4];
#pragma unroll
  for (int i = 0; i < NN; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[i][r] = corr[i][r] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < nks; ++kk) {
    const uint32_t xo = ((2 * kk + xk) ^ sw) << 4;
    const uint32_t yo = ((2 * kk + yk) ^ sw) << 4;
    Tf32A a;
    ldsm_x4(a.hi, xah + xo);
    ldsm_x4(a.lo, xal + xo);
    uint32_t bh[NN][2], bl[NN][2];
    ldsm_split_b<W, NN>(bh, bl, ya + yo);
#pragma unroll
    for (int i = 0; i < NN; ++i) mma_tf32(s[i], a.hi, bh[i][0], bh[i][1]);
#pragma unroll
    for (int i = 0; i < NN; ++i) mma_tf32(corr[i], a.hi, bl[i][0], bl[i][1]);
#pragma unroll
    for (int i = 0; i < NN; ++i) mma_tf32(corr[i], a.lo, bh[i][0], bh[i][1]);
  }
#pragma unroll
  for (int i = 0; i < NN; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[i][r] += corr[i][r];
}

// O = O alpha + A Y over the output n-tiles n0 .. n0 + N - 1 (tn_group's
// product, summed from zero, added in fp32).
template <int W, int NM, int N>
__device__ __forceinline__ void pv_group(float (&out)[W / 8][4],
                                         const Tf32A (&a)[NM],
                                         const float* (&y0)[4],
                                         const float* (&y1)[4],
                                         int n0, const float (&alpha)[2]) {
  float t[N][4];
  tn_group<W, NM, N>(t, a, y0, y1, n0);
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[n0 + u][r] = fmaf(out[n0 + u][r], alpha[r >> 1], t[u][r]);
}

// O = O alpha + P V over the output n-tiles below nt = ceil(D / 8), P the
// split A operand (split_rows), V a swizzled tile of W columns read
// MN-major: in groups of NG = Tf32<W>::NG n-tiles, the last group cut to
// the fewest of NG, NG / 2 or NG / 4 n-tiles (at least 2) that reach nt,
// so that a D below its bucket (80 at W = 128) pays for few zero columns.
// Rows with no valid key yet have O = 0 and p = 0, so their O stays 0.
template <int W, int NM>
__device__ __forceinline__ void pv_tf32(float (&out)[W / 8][4],
                                        const Tf32A (&a)[NM], const float* y,
                                        int nt, const float (&alpha)[2],
                                        int lane) {
  constexpr int NG = Tf32<W>::NG;
  constexpr int NG2 = NG / 2 < 2 ? 2 : NG / 2;
  constexpr int NG4 = NG / 4 < 2 ? 2 : NG / 4;
  const float* y0[4];
  const float* y1[4];
  tn_rows<W>(y0, y1, y, lane);
#pragma unroll
  for (int n0 = 0; n0 < W / 8; n0 += NG) {
    const int left = nt - n0;
    if (left <= 0) break;
    if (left > NG2)
      pv_group<W, NM, NG>(out, a, y0, y1, n0, alpha);
    else if (left > NG4)
      pv_group<W, NM, NG2>(out, a, y0, y1, n0, alpha);
    else
      pv_group<W, NM, NG4>(out, a, y0, y1, n0, alpha);
  }
}

template <int W>
__global__ void __launch_bounds__(Tf32<W>::NT, 1)
    fa_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int H, int Lq, int Lk, int D,
                   float scale, int causal, int vec) {
  using C = Tf32<W>;
  constexpr int R = C::R;            // query rows a block; keys a tile
  constexpr int NK = R / 16;         // n-tiles of a warp's half of a tile
  constexpr int STAGE = 2 * R * W;   // k, v
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [R][W], swizzled: q, then its hi
  float* ql = qs + R * W;            // q's lo
  float* ring = ql + R * W;          // stage s at + s STAGE

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = warp % C::G;         // the warp's 16 query rows
  const int half = warp / C::G;      // its half of each key tile
  const int n_qt = (Lq + R - 1) / R;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * R;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Lk - Lq;
  int nk = (Lk + R - 1) / R;
  if (causal) nk = min(nk, (min(q0 + R, Lq) - 1 + off) / R + 1);

  const int64_t row = (int64_t)H * D;  // elements between sequence rows
  const float* kb = k + ((int64_t)b * Lk * H + h) * D;
  const float* vb = v + ((int64_t)b * Lk * H + h) * D;
  auto load_stage = [&](int t, float* st) {
    tf32_load_tile<W, R, C::NT>(st, kb, row, t * R, Lk, D, vec);
    tf32_load_tile<W, R, C::NT>(st + R * W, vb, row, t * R, Lk, D, vec);
  };
  tf32_load_tile<W, R, C::NT>(qs, q + ((int64_t)b * Lq * H + h) * D, row,
                              q0, Lq, D, vec);
  load_stage(0, ring);
  cp_async_commit();
  // q's TF32 terms, once: hi in place, lo beside it (the loop's first
  // barrier orders these writes before the products read them).
  cp_async_wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < R * W; e += C::NT) {
    uint32_t hi, lo;
    split_tf32(qs[e], hi, lo);
    qs[e] = __uint_as_float(hi);
    ql[e] = __uint_as_float(lo);
  }

  // In S's and O's accumulator fragments this thread holds rows g and
  // g + 8 of the warp's 16, columns 8 i + 2c and 8 i + 2c + 1: register
  // 2 hh + e of n-tile i is (row qrow[hh], column 8 i + 2c + e).
  const int g = lane >> 2, c = lane & 3;
  const int first = q0 + 16 * j;              // the warp's first row
  const int last = min(first + 15, Lq - 1);    // its last (< first: none)
  const int qrow[2] = {first + g, first + g + 8};
  float acc[W / 8][4];  // O of the warp's rows over its halves' keys
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the rows' sums
  // k8 steps of q k^T and output n-tiles of p v reaching a column below D.
  const int nks = (D + 7) / 8;

  for (int t = 0; t < nk; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t - 1's stage consumed
    if (t + 1 < nk) load_stage(t + 1, ring + ((t + 1) % C::S) * STAGE);
    cp_async_commit();
    const float* kst = ring + (t % C::S) * STAGE + half * (R / 2) * W;
    const float* vst = kst + R * W;
    const int k0 = t * R + half * (R / 2);  // the warp's first key
    // A half that none of the warp's rows sees (rows past Lq, keys past Lk
    // or past every row's diagonal) would leave m, l and O as they are.
    if (first > last || k0 >= Lk || (causal && k0 > last + off)) continue;

    // S = q k^T: rows qrow[hh] by keys k0 + 8 i + 2c (+ 1), summed from
    // zero; then the logits S scale, -1e30 where masked (a key at or past
    // Lk, or under `causal` a key ki > qi + off), checked on tiles that
    // cross them.
    float s[NK][4];
    qk_tf32<W, NK>(s, qs + 16 * j * W, ql + 16 * j * W, kst, nks, lane);
    const bool edge =
        k0 + R / 2 > Lk || (causal && k0 + R / 2 - 1 > first + off);
    auto masked = [&](int i, int r) {
      const int ki = k0 + 8 * i + 2 * c + (r & 1);
      return !(ki < Lk && (!causal || qrow[r >> 1] + off >= ki));
    };
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[i][r] * scale;
        if (edge && masked(i, r)) x = kNegInf;
        s[i][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    // A row's logits lie in the four lanes of its fragment row.
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      alpha[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
    // p = exp(x - m), 0 where masked (a row whose keys so far are all
    // masked has m = -1e30, and exp(0) would count them).
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = expf(s[i][r] - m[r >> 1]);
        if (edge && masked(i, r)) p = 0.f;
        s[i][r] = p;
        rs[r >> 1] += p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
    Tf32A a[NK];
    split_rows(a, s);
    pv_tf32<W, NK>(acc, a, vst, nks, alpha, lane);  // O = O alpha + p v
  }

  // The two halves' (m, l, O) of each row merge: m = max(m0, m1),
  // a_h = exp(m_h - m), l = l0 a0 + l1 a1, O = O0 a0 + O1 a1; half 1's go
  // through shared memory (its O where q's tile was, m and l in the ring).
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  float4* red = reinterpret_cast<float4*>(qs) + j * (W / 8) * 32 + lane;
  float4* st = reinterpret_cast<float4*>(ring) + j * 32 + lane;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      if (8 * n >= D) break;
      red[32 * n] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
    *st = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (half == 1) return;
  const float4 other = *st;
  const float m1[2] = {other.x, other.y}, l1[2] = {other.z, other.w};
  float a0[2], a1[2], denom[2];
  const int64_t bh = (int64_t)b * H + h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float mm = fmaxf(m[hh], m1[hh]);
    a0[hh] = expf(m[hh] - mm);
    a1[hh] = expf(m1[hh] - mm);
    denom[hh] = fmaxf(l[hh] * a0[hh] + l1[hh] * a1[hh], 1e-30f);
    // The row's log-sum-exp of its scaled logits; its four lanes hold
    // the same m and l.
    if (lse != nullptr && c == 0 && qrow[hh] < Lq)
      lse[bh * Lq + qrow[hh]] = mm + logf(denom[hh]);
  }
  float* ob = o + ((int64_t)b * Lq * H + h) * D;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    if (8 * n >= D) break;  // the zero columns past D
    const float4 x = red[32 * n];
    const float sum[4] = {fmaf(acc[n][0], a0[0], x.x * a1[0]),
                          fmaf(acc[n][1], a0[0], x.y * a1[0]),
                          fmaf(acc[n][2], a0[1], x.z * a1[1]),
                          fmaf(acc[n][3], a0[1], x.w * a1[1])};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (qrow[hh] >= Lq) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * c + e;
        if (col < D) ob[qrow[hh] * row + col] = sum[2 * hh + e] / denom[hh];
      }
    }
  }
}

template <int W>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int Lq, int Lk, int D,
                        float scale, int causal, cudaStream_t stream) {
  constexpr int smem = tf32_smem_bytes<W>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel_tf32<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int R = f32_rows<W>();
  dim3 grid((Lq + R - 1) / R, H, B);
  // 16-byte copies where every row starts on a 16-byte boundary, else
  // 4-byte ones (a contiguous view at an odd offset).
  const int vec = (D & 3) == 0 && aligned16(q, k, v);
  fa_kernel_tf32<W><<<grid, Tf32<W>::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Lq, Lk,
      D, scale, causal, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA ring
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;      // query rows per block: two warpgroups
constexpr int kTcKeys = kTile;    // keys per tile
constexpr int kTcThreads = 384;   // two consumer warpgroups + a producer one
constexpr int kProducerWarp = 8;
constexpr int kConsumerWarps = 8;

// Shared memory of fa_kernel_tc: q (two tiles), the k and v rings, then
// 1 + 2 * stages mbarriers; 1024 bytes of slack to align the base to the
// swizzle atom.
template <int W>
__host__ __device__ constexpr int tc_smem_bytes() {
  return 1024 + (2 + 2 * ring_stages<W>()) * Geo<W>::TILE +
         8 * (1 + 2 * ring_stages<W>());
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
// finished tile's p v (W <= 128).
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

// O = O alpha in fp32 before a tile's p v accumulates into O (W > 128).
template <int NB, int ON>
__device__ __forceinline__ void rescale(float (&oacc)[NB][ON],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    fence_regs(oacc[c]);
#pragma unroll
    for (int r = 0; r < ON; ++r) oacc[c][r] *= alpha[(r >> 1) & 1];
  }
}

template <int W>
__global__ void __launch_bounds__(kTcThreads, 1)
    fa_kernel_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Lq, int Lk, int D, float scale, int causal) {
  using G = Geo<W>;
  constexpr int WG_ROWS = 64;
  constexpr int S = ring_stages<W>();
  // O carried in the tensor cores' accumulator (see the header).
  constexpr bool kCarry = W > 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + 2 * G::TILE;        // k ring
  const uint32_t sv = sk + S * G::TILE;        // v ring
  const uint32_t qbar = sv + S * G::TILE;      // q loaded
  const uint32_t full0 = qbar + 8;             // stage s: + 8 s
  const uint32_t empty0 = full0 + 8 * S;

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
    for (int s = 0; s < S; ++s) {
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
        const int s = t % S;
        if (t >= S) mbar_wait(empty0 + 8 * s, (t / S - 1) & 1);
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

  // O runs in fp32.  Up to W = 128 each tile's p v is summed from zero on
  // the tensor cores (tacc) and added on the CUDA cores as
  // O = O alpha + T, since the tensor cores' fp32 accumulation, carried
  // over the thousands of k16 steps of a long row, drifts past one bf16
  // step of the output; above 128, O is rescaled and the products add
  // into it (tacc is then never used and takes no registers).
  float oacc[G::NB][G::ON];
  [[maybe_unused]] float tacc[G::NB][G::ON];
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
    issue_qk<W>(sacc, sqw, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    softmax_tile(sacc, p, m, mL, l, alpha, scale2, 0, c0, qrow, first, Lk,
                 off, causal);
  }
  for (int t = 1; t < nw; ++t) {
    const int s = t % S;
    const int prev = (t - 1) % S;
    mbar_wait(full0 + 8 * s, (t / S) & 1);
    if constexpr (kCarry) rescale<G::NB, G::ON>(oacc, alpha);
    float sacc[32];
    zero(sacc);
    wgmma_fence();
    issue_qk<W>(sacc, sqw, sk + s * G::TILE);
    wgmma_commit();
    if constexpr (kCarry)
      issue_pv<W>(oacc, p, sv + prev * G::TILE, 1);
    else
      issue_pv<W>(tacc, p, sv + prev * G::TILE, 0);
    wgmma_commit();
    wgmma_wait<1>();  // q k^T of tile t is done, p v of t - 1 runs on
    fence_regs(sacc);
    float alpha_t[2];
    softmax_tile(sacc, p, m, mL, l, alpha_t, scale2, t * kTcKeys, c0, qrow,
                 first, Lk, off, causal);
    wgmma_wait<0>();
    release(empty0 + 8 * prev, lane);
    if constexpr (kCarry)
      settle<G::NB, G::ON>(oacc);
    else
      accumulate<G::NB, G::ON>(oacc, tacc, alpha);
    alpha[0] = alpha_t[0];
    alpha[1] = alpha_t[1];
  }
  if (nw > 0) {
    const uint32_t sv_last = sv + ((nw - 1) % S) * G::TILE;
    if constexpr (kCarry) {
      rescale<G::NB, G::ON>(oacc, alpha);
      issue_pv<W>(oacc, p, sv_last, 1);
    } else {
      issue_pv<W>(tacc, p, sv_last, 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    release(empty0 + 8 * ((nw - 1) % S), lane);
    if constexpr (kCarry)
      settle<G::NB, G::ON>(oacc);
    else
      accumulate<G::NB, G::ON>(oacc, tacc, alpha);
  }
  for (int t = nw; t < nk; ++t) {
    mbar_wait(full0 + 8 * (t % S), (t / S) & 1);
    release(empty0 + 8 * (t % S), lane);
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
        if (c * G::CB + 8 * i >= D) break;  // the zero columns past D
        const int col = c * G::CB + 8 * i + c0;
        *reinterpret_cast<__nv_bfloat162*>(ob + qi * row + col) =
            __floats2bfloat162_rn(oacc[c][4 * i + 2 * hh] / denom,
                                  oacc[c][4 * i + 2 * hh + 1] / denom);
      }
  }
}

template <int W>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int Lq, int Lk, int D,
                      float scale, int causal, cudaStream_t stream) {
  if (!aligned16(q, k, v)) return cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, B, Lq, H, D, Geo<W>::CB);
  if (err == cudaSuccess) err = make_map(&mk, k, B, Lk, H, D, Geo<W>::CB);
  if (err == cudaSuccess) err = make_map(&mv, v, B, Lk, H, D, Geo<W>::CB);
  if (err != cudaSuccess) return err;
  constexpr int smem = tc_smem_bytes<W>();
  err = cudaFuncSetAttribute(
      fa_kernel_tc<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kTcRows - 1) / kTcRows, H, B);
  fa_kernel_tc<W><<<grid, kTcThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, Lq, Lk, D, scale,
      causal);
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

// The bucket of head dim D (0 past the domain), as the launches pick it.
extern "C" int fa_head_bucket(int D) { return fa_bucket(D); }

// Dynamic shared memory (bytes) of fa_kernel_tc (which = 0) or
// fa_kernel_tf32 (which = 1) at bucket W; -1 for anything else.
extern "C" int fa_smem_bytes(int which, int W) {
  switch (W) {
#define FA_SMEM(V)                                   \
  case V:                                            \
    return which == 0   ? tc_smem_bytes<V>()         \
           : which == 1 ? tf32_smem_bytes<V>()       \
                        : -1;
    FA_SMEM(32) FA_SMEM(64) FA_SMEM(128) FA_SMEM(192) FA_SMEM(256)
#undef FA_SMEM
  }
  return -1;
}

// dtype: 0 = float32 (fa_kernel_tf32, TF32 mma.sync), 1 = bfloat16
// (fa_kernel_tc, wgmma); q, k, v and o share it.  q and o are contiguous [B, Lq, H, D],
// k and v contiguous [B, Lk, H, D]; lse is null or fp32 [B, H, Lq].
extern "C" int fa_launch(const void* q, const void* k, const void* v,
                         void* o, void* lse, int dtype, int B, int H, int Lq,
                         int Lk, int D, float scale, int causal,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
#define FA_ARGS q, k, v, o, ls, B, H, Lq, Lk, D, scale, causal, s
  if (dtype == 0) {
    FA_BUCKETS(launch_tf32, FA_ARGS);
  } else if (dtype == 1) {
    FA_BUCKETS(launch_tc, FA_ARGS);
  }
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}
