"""Plain-torch version of the EBPSM affinity scoring (Alg. 2 inner loop).

Given T queued tasks × V pooled VMs, score every pair with the paper's
locality-aware finish-time estimate and pick, per task, the feasible VM
minimizing the lexicographic key (tier, est_finish, vmid).

Tiers follow Alg. 2: 1 = idle VM holding all the task's input data,
2 = idle VM with the task's container deployed, 3 = any idle VM.
``tier = 0`` marks pairs out of scope (busy VM, wrong owner tag).

The arithmetic is written in the *folded* form the reference's compiled
jnp oracle actually evaluates, so the two agree bit for bit:

* ``(x * MS) * CEIL_TOL`` is one multiply by ``K = f32(f32(MS) * f32(TOL))``;
* ``pipe / bp_ms`` is ``pipe * f32(1 / bp_ms)``;
* the scalar reciprocals ``1 / gs_read`` and ``1 / gs_write`` are taken in
  double and rounded once to fp32.

Every multiply by a scalar is spelled out as a multiply: PyTorch's CUDA
``div`` by a Python scalar multiplies by its reciprocal while its CPU
``div`` divides, so ``tensor / scalar`` would not even agree with itself
across devices.  The CUDA kernel (``csrc/affinity.cu``) computes the same
expressions in the same order from the same :func:`folded_scalars`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

BIG = 3.4e38          # "no feasible VM" finish/cost sentinel (fp32-rounded)
MS = 1000.0
CEIL_TOL = 1.0 - 1e-6  # matches core.costs.ceil_ms (see comment there)
NO_TIER = 9            # best_tier when no VM is feasible


class AffinityOut(NamedTuple):
    best_vm: torch.Tensor    # [.., T] int32, -1 when no feasible VM
    best_tier: torch.Tensor  # [.., T] int32, 9 when none
    est_finish: torch.Tensor  # [.., T] f32 ms
    est_cost: torch.Tensor   # [.., T] f32 cents


@lru_cache(maxsize=64)
def folded_scalars(gs_read: float, gs_write: float,
                   bp_ms: float) -> Tuple[float, float, float, float]:
    """``(K, 1/gs_read, 1/gs_write, 1/bp_ms)``, each an exact fp32 value
    held in a Python float; computed once per platform configuration."""
    f32 = np.float32
    k = f32(f32(MS) * f32(CEIL_TOL))
    return (float(k), float(f32(1.0 / gs_read)), float(f32(1.0 / gs_write)),
            float(f32(1.0 / bp_ms)))


def pair_estimates(size_mi, out_mb, missing_mb, cont_ms, vm_mips, vm_bw,
                   gs_read, gs_write, bp_ms, vm_price):
    """Vectorized Eqs. (1)-(5) without provisioning: ``[.., T, V]`` pipe_ms
    and cost.  Task arrays ``[.., T]``, pair arrays ``[.., T, V]``, VM
    arrays ``[.., V]``."""
    k, rgs_r, rgs_w, rbp = folded_scalars(gs_read, gs_write, bp_ms)
    r = 1.0 / vm_bw.unsqueeze(-2)                      # [.., 1, V]
    in_ms = (missing_mb * (r + rgs_r)) * k
    rt_ms = (size_mi.unsqueeze(-1) / vm_mips.unsqueeze(-2)) * k
    out_ms = (out_mb.unsqueeze(-1) * (r + rgs_w)) * k
    pipe = ((torch.ceil(in_ms) + torch.ceil(rt_ms)) + torch.ceil(out_ms)) \
        + cont_ms
    cost = torch.ceil(pipe * rbp) * vm_price.unsqueeze(-2)
    return pipe, cost


def affinity_ref(size_mi, out_mb, budget, missing_mb, cont_ms, tier,
                 vm_mips, vm_bw, vm_price, gs_read, gs_write,
                 bp_ms) -> AffinityOut:
    """Task arrays ``[.., T]``; pair arrays ``[.., T, V]``; VM arrays
    ``[.., V]`` — any number of leading batch dims (the batched form is
    the reference's ``vmap`` written out)."""
    pipe, cost = pair_estimates(size_mi, out_mb, missing_mb, cont_ms,
                                vm_mips, vm_bw, gs_read, gs_write, bp_ms,
                                vm_price)
    big = torch.tensor(BIG, dtype=torch.float32, device=pipe.device)
    feasible = (tier > 0) & (cost <= budget.unsqueeze(-1) + 1e-6)
    t_eff = torch.where(feasible, tier, NO_TIER).to(torch.int32)
    best_tier = t_eff.amin(dim=-1)
    f_eff = torch.where(t_eff == best_tier.unsqueeze(-1), pipe, big)
    best_fin = f_eff.amin(dim=-1)
    V = tier.shape[-1]
    vmids = torch.arange(V, dtype=torch.int32, device=tier.device)
    v_eff = torch.where(f_eff == best_fin.unsqueeze(-1), vmids, 1 << 30)
    best_vm = v_eff.amin(dim=-1).to(torch.int32)
    none = best_tier >= NO_TIER
    best_vm = torch.where(none, -1, best_vm).to(torch.int32)
    idx = best_vm.clamp(0, V - 1).long().unsqueeze(-1)
    est_f = torch.take_along_dim(pipe, idx, dim=-1).squeeze(-1)
    est_c = torch.take_along_dim(cost, idx, dim=-1).squeeze(-1)
    return AffinityOut(best_vm, best_tier,
                       torch.where(none, big, est_f),
                       torch.where(none, big, est_c))
