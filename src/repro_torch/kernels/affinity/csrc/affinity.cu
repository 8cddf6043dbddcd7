// EBPSM task x VM affinity scoring (Algorithm 2 inner loop) for Hopper.
//
// Replaces repro/kernels/affinity/kernel.py::_affinity_kernel (the Pallas
// TPU kernel, vmapped over the batch by ops.py::_affinity_batch_impl).
//
// Per (b, t) row: for every VM v, the tolerance-ceiled transfer-in,
// runtime and transfer-out ms of Eqs 1-5 plus the container delay give
// `pipe`; `cost = ceil(pipe / bp) * price`; a pair is feasible when
// `tier > 0 && cost <= budget + 1e-6`; the row's answer is the
// lexicographic argmin over (tier_eff, pipe, vmid), where tier_eff is 9
// for infeasible pairs.  Outputs: best_vm (-1 = none), best_tier (9 =
// none), est_finish and est_cost (3.4e38 = none).
//
// Bound: bytes.  Each pair reads 12 bytes (missing, cont, tier), each VM
// 12 bytes (mips, bw, price) per batch row, each task 12 bytes (size,
// out_mb, budget), and each task writes 16 bytes; the arithmetic is a
// handful of flops per pair.  On the simulator's main path the rounds are
// small ([B, T, V] buckets of 1e4-1e6 pairs, at most a few MB), so the
// kernel has to put enough loads in flight at once to cover the memory
// latency: its time at those shapes is set by how many warps it keeps
// busy, not by the memory rate.
//
// Design: 256 threads (8 warps) per block, all rows of a block in one
// batch row b (blockIdx.y).  Each (b, t) row gets W warps (1, 2, 4 or 8,
// chosen by the launcher): where B*T is small, W grows until the grid
// fills the card, and each warp scans its own contiguous slice of V.
// The block stages its batch row's VM arrays in shared memory, a tile of
// kTile VMs at a time, with 1/bw taken once per VM (the same IEEE
// division the plain version takes per pair, so the same value).  Where
// V % 4 == 0 and the pair arrays are 16-byte aligned, every lane reads
// missing, cont and tier four columns at a time with 16-byte loads.
// Each lane keeps a running best (tier_eff, pipe, vmid, cost) under the
// lexicographic order, the warp reduces with __shfl_xor_sync, and the W
// warps of a row combine through shared memory under the same order.
// vmids are distinct, so the order is total and the result does not
// depend on how V was split among warps and lanes.
//
// Arithmetic is bitwise equal to the plain torch version (ref.py) and to
// the reference's compiled jnp oracle: the folded constants K, 1/gs_read,
// 1/gs_write and 1/bp come from the wrapper as fp32 values, every division
// is IEEE round-to-nearest, and the build passes -fmad=false (no FMA
// contraction) and no fast-math flag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;       // VMs staged in shared memory per pass
constexpr float kBig = 3.4e38f;
constexpr int kNoTier = 9;
constexpr int kNumSMs = 132;

struct Best {
  int tier;
  float pipe;
  int vm;
  float cost;
};

__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  if (a.tier != b.tier) return a.tier < b.tier;
  if (a.pipe != b.pipe) return a.pipe < b.pipe;
  return a.vm < b.vm;
}

struct Row {
  float size, omb, bud, k, rbp;
};

// Staged per-VM values: r + 1/gs_read, r + 1/gs_write (r = 1/bw), mips
// and price.
struct VmTile {
  float rr[kTile], rw[kTile], mips[kTile], price[kTile];
};

__device__ __forceinline__ void score(const Row& row, const VmTile& s,
                                      int v, int vt, float miss, float cont,
                                      int tr, Best& best) {
  const float in_ms = (miss * s.rr[vt]) * row.k;
  const float rt_ms = (row.size / s.mips[vt]) * row.k;
  const float o_ms = (row.omb * s.rw[vt]) * row.k;
  const float pipe = ((ceilf(in_ms) + ceilf(rt_ms)) + ceilf(o_ms)) + cont;
  const float cost = ceilf(pipe * row.rbp) * s.price[vt];
  const bool feasible = (tr > 0) && (cost <= row.bud);
  const Best cand = {feasible ? tr : kNoTier, pipe, v, cost};
  if (better(cand, best)) best = cand;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) affinity_kernel(
    const float* __restrict__ size_mi, const float* __restrict__ out_mb,
    const float* __restrict__ budget, const float* __restrict__ missing,
    const float* __restrict__ cont, const int32_t* __restrict__ tier,
    const float* __restrict__ mips, const float* __restrict__ bw,
    const float* __restrict__ price, int T, int V, int W, float k,
    float rgs_r, float rgs_w, float rbp, int32_t* __restrict__ best_vm,
    int32_t* __restrict__ best_tier, float* __restrict__ est_finish,
    float* __restrict__ est_cost) {
  __shared__ VmTile s;
  __shared__ Best s_best[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * (kWarps / W) + warp / W;
  const int part = warp % W;
  const int b = blockIdx.y;
  const bool live = t < T;  // dead warps still stage and synchronise

  const int64_t row = (int64_t)b * T + (live ? t : 0);
  Row r;
  r.size = size_mi[row];
  r.omb = out_mb[row];
  r.bud = budget[row] + 1e-6f;
  r.k = k;
  r.rbp = rbp;
  const float* miss_r = missing + row * V;
  const float* cont_r = cont + row * V;
  const int32_t* tier_r = tier + row * V;
  const float* mips_b = mips + (int64_t)b * V;
  const float* bw_b = bw + (int64_t)b * V;
  const float* price_b = price + (int64_t)b * V;

  // This warp's slice of V: a multiple of 4 columns wide, so that every
  // 16-byte load stays inside it.
  const int per = (((V + W - 1) / W) + 3) & ~3;
  const int v_lo = part * per;
  const int v_hi = min(V, v_lo + per);

  Best best = {0x7fffffff, kBig, 0x7fffffff, kBig};  // loses to any VM
  for (int t0 = 0; t0 < V; t0 += kTile) {
    const int t1 = min(V, t0 + kTile);
    __syncthreads();  // the previous tile is consumed
    for (int v = t0 + threadIdx.x; v < t1; v += kThreads) {
      const float rv = 1.0f / bw_b[v];
      s.rr[v - t0] = rv + rgs_r;
      s.rw[v - t0] = rv + rgs_w;
      s.mips[v - t0] = mips_b[v];
      s.price[v - t0] = price_b[v];
    }
    __syncthreads();
    if (!live) continue;
    const int lo = max(v_lo, t0);
    const int hi = min(v_hi, t1);
    if (kVec) {
      for (int v = lo + 4 * lane; v < hi; v += 128) {
        const float4 m = *reinterpret_cast<const float4*>(miss_r + v);
        const float4 c = *reinterpret_cast<const float4*>(cont_r + v);
        const int4 tr = *reinterpret_cast<const int4*>(tier_r + v);
        const int vt = v - t0;
        score(r, s, v, vt, m.x, c.x, tr.x, best);
        score(r, s, v + 1, vt + 1, m.y, c.y, tr.y, best);
        score(r, s, v + 2, vt + 2, m.z, c.z, tr.z, best);
        score(r, s, v + 3, vt + 3, m.w, c.w, tr.w, best);
      }
    } else {
      for (int v = lo + lane; v < hi; v += 32)
        score(r, s, v, v - t0, miss_r[v], cont_r[v], tier_r[v], best);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.tier = __shfl_xor_sync(0xffffffffu, best.tier, off);
    o.pipe = __shfl_xor_sync(0xffffffffu, best.pipe, off);
    o.vm = __shfl_xor_sync(0xffffffffu, best.vm, off);
    o.cost = __shfl_xor_sync(0xffffffffu, best.cost, off);
    if (better(o, best)) best = o;
  }
  if (W > 1) {
    if (lane == 0) s_best[warp] = best;
    __syncthreads();
    if (part != 0) return;
    for (int w = 1; w < W; ++w)
      if (better(s_best[warp + w], best)) best = s_best[warp + w];
  }
  if (live && lane == 0) {
    const bool none = best.tier >= kNoTier;
    best_vm[row] = none ? -1 : best.vm;
    best_tier[row] = best.tier;
    est_finish[row] = none ? kBig : best.pipe;
    est_cost[row] = none ? kBig : best.cost;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Warps per row: enough that each warp reads at least 128 columns (one
// 16-byte load of each pair array per lane) where V allows it, then more
// while the grid is below two blocks per SM and each warp keeps at least
// 32 columns.
int warps_per_row(int B, int T, int V) {
  int W = 1;
  while (W < kWarps && V >= 2 * W * 128) W *= 2;
  auto blocks = [&](int w) {
    return (int64_t)B * ((T + kWarps / w - 1) / (kWarps / w));
  };
  while (W < kWarps && blocks(W) < 2 * kNumSMs && V >= 2 * W * 32) W *= 2;
  return W;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All arrays are contiguous:
// task arrays [B, T], pair arrays [B, T, V], VM arrays [B, V].  The
// packed round (ops.py) passes pointers into one device buffer, and its
// four outputs as consecutive [B, T] slices of one 32-bit buffer.
// Launches on `stream` and returns cudaGetLastError() without
// synchronising.
extern "C" int affinity_launch(
    const void* size_mi, const void* out_mb, const void* budget,
    const void* missing, const void* cont, const void* tier,
    const void* mips, const void* bw, const void* price, int B, int T, int V,
    float k, float rgs_r, float rgs_w, float rbp, void* best_vm,
    void* best_tier, void* est_finish, void* est_cost, void* stream) {
  if (B > 0 && T > 0 && V > 0) {
    const int W = warps_per_row(B, T, V);
    const int rows = kWarps / W;
    const dim3 grid((T + rows - 1) / rows, B);
    const bool vec = V % 4 == 0 && aligned16(missing) && aligned16(cont) &&
                     aligned16(tier);
    auto kernel = vec ? affinity_kernel<true> : affinity_kernel<false>;
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)size_mi, (const float*)out_mb, (const float*)budget,
        (const float*)missing, (const float*)cont, (const int32_t*)tier,
        (const float*)mips, (const float*)bw, (const float*)price, T, V, W,
        k, rgs_r, rgs_w, rbp, (int32_t*)best_vm, (int32_t*)best_tier,
        (float*)est_finish, (float*)est_cost);
  }
  return (int)cudaGetLastError();
}
