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
// small ([B, T, V] buckets of 1e4-1e6 pairs), so the call's time is set by
// the launch and by the host-to-device copy of the round, not by the
// scoring itself.
//
// Design: B is a grid axis (blockIdx.y); one warp per (b, t) row.  The 32
// lanes stride over V, so missing/cont/tier are read coalesced and V is
// not bounded by on-chip memory.  Each lane keeps a running best
// (tier_eff, pipe, vmid, cost) under the lexicographic order, then the
// warp reduces with __shfl_xor_sync under the same order.  vmids are
// distinct, so the order is total and the result does not depend on which
// lane saw which VM.
//
// Arithmetic is bitwise equal to the plain torch version (ref.py) and to
// the reference's compiled jnp oracle: the folded constants K, 1/gs_read,
// 1/gs_write and 1/bp come from the wrapper as fp32 values, every division
// is IEEE round-to-nearest, and the build passes -fmad=false (no FMA
// contraction) and no fast-math flag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kBig = 3.4e38f;
constexpr int kNoTier = 9;

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

__global__ void affinity_kernel(
    const float* __restrict__ size_mi, const float* __restrict__ out_mb,
    const float* __restrict__ budget, const float* __restrict__ missing,
    const float* __restrict__ cont, const int32_t* __restrict__ tier,
    const float* __restrict__ mips, const float* __restrict__ bw,
    const float* __restrict__ price, int T, int V, float k, float rgs_r,
    float rgs_w, float rbp, int32_t* __restrict__ best_vm,
    int32_t* __restrict__ best_tier, float* __restrict__ est_finish,
    float* __restrict__ est_cost) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (t >= T) return;  // whole warp leaves together

  const int64_t row = (int64_t)b * T + t;
  const float size = size_mi[row];
  const float omb = out_mb[row];
  const float bud = budget[row] + 1e-6f;
  const float* miss_r = missing + row * V;
  const float* cont_r = cont + row * V;
  const int32_t* tier_r = tier + row * V;
  const float* mips_b = mips + (int64_t)b * V;
  const float* bw_b = bw + (int64_t)b * V;
  const float* price_b = price + (int64_t)b * V;

  Best best = {0x7fffffff, kBig, 0x7fffffff, kBig};  // loses to any VM
  for (int v = lane; v < V; v += 32) {
    const float r = 1.0f / bw_b[v];
    const float in_ms = (miss_r[v] * (r + rgs_r)) * k;
    const float rt_ms = (size / mips_b[v]) * k;
    const float o_ms = (omb * (r + rgs_w)) * k;
    const float pipe =
        ((ceilf(in_ms) + ceilf(rt_ms)) + ceilf(o_ms)) + cont_r[v];
    const float cost = ceilf(pipe * rbp) * price_b[v];
    const int tr = tier_r[v];
    const bool feasible = (tr > 0) && (cost <= bud);
    const Best cand = {feasible ? tr : kNoTier, pipe, v, cost};
    if (better(cand, best)) best = cand;
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
  if (lane == 0) {
    const bool none = best.tier >= kNoTier;
    best_vm[row] = none ? -1 : best.vm;
    best_tier[row] = best.tier;
    est_finish[row] = none ? kBig : best.pipe;
    est_cost[row] = none ? kBig : best.cost;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All arrays are contiguous:
// task arrays [B, T], pair arrays [B, T, V], VM arrays [B, V].  Launches on
// `stream` and returns cudaGetLastError() without synchronising.
extern "C" int affinity_launch(
    const void* size_mi, const void* out_mb, const void* budget,
    const void* missing, const void* cont, const void* tier,
    const void* mips, const void* bw, const void* price, int B, int T, int V,
    float k, float rgs_r, float rgs_w, float rbp, void* best_vm,
    void* best_tier, void* est_finish, void* est_cost, void* stream) {
  if (B > 0 && T > 0 && V > 0) {
    const dim3 grid((T + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
    const dim3 block(32 * kWarpsPerBlock);
    affinity_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)size_mi, (const float*)out_mb, (const float*)budget,
        (const float*)missing, (const float*)cont, (const int32_t*)tier,
        (const float*)mips, (const float*)bw, (const float*)price, T, V, k,
        rgs_r, rgs_w, rbp, (int32_t*)best_vm, (int32_t*)best_tier,
        (float*)est_finish, (float*)est_cost);
  }
  return (int)cudaGetLastError();
}
