"""Task→VM selection — Algorithm 2 (EBPSM) and the MSLBL_MW baseline rule.

A ``Policy`` captures exactly how the five algorithms of the paper differ:

==============  ==========  ===========  =========  ==========  ===========
policy          containers  share scope  loc. tiers idle thresh budget mode
==============  ==========  ===========  =========  ==========  ===========
EBPSM           yes         global       yes        5 s         Alg. 1+3
EBPSM_NS        yes         workflow     yes        5 s         Alg. 1+3
EBPSM_WS        no (VM img) app          yes        5 s         Alg. 1+3
EBPSM_NC        no          global       yes        5 s         Alg. 1+3
MSLBL_MW        no          global       no         0 s         MSLBL
==============  ==========  ===========  =========  ==========  ===========

The infrastructure physics (caches, delays, billing) is identical across
policies — only selection, budget handling and deprovisioning differ.

Two implementations of Algorithm 2 share one semantics:

* the **vectorized** path (default when the caller hands over the
  :class:`~repro_torch.sim.cloud.VMPool` registry and the pool is big enough):
  tier partition, missing-input volumes, container delays and both
  argmin reductions are numpy operations over the pool's vmid-indexed
  attribute arrays and incremental ``data_index`` / ``app_image`` /
  ``app_active`` indexes — no per-VM Python loop;
* the **scalar** path — the original per-VM loop, kept as the parity
  oracle (``REPRO_SCALAR_SELECT=1`` forces it everywhere) and as the
  faster branch for tiny pools, where numpy call overhead exceeds the
  loop cost.

Every vectorized quantity is computed with the same float64 IEEE
operations, in the same order, as the scalar reference, so the two paths
are bit-exact (property-tested in tests/test_dispatcher_matrix.py).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import costs
from .cost_tables import CostTable, _ceil_ms
from .types import MS, PlatformConfig, Task, VMType
from ..sim.cloud import VM, VM_IDLE, DataKey, VMPool

# Sentinel: "derive the owner tag from (wid, app)" — callers that already
# hold the tag (the auction path) pass it explicitly, since None is a
# legitimate tag (global sharing scope).
_AUTO_TAG = object()

# Pools smaller than this stay on the scalar loop: ~30 numpy dispatches
# cost more than dozens of per-VM Python iterations (measured crossover
# on CPython 3.10 ≈ 40–60 VMs).  Tests pin it to 0/1 to force the
# vectorized path; REPRO_VECTOR_SELECT_MIN overrides.
VECTOR_SELECT_MIN_VMS = int(os.environ.get("REPRO_VECTOR_SELECT_MIN", "48"))

# The scalar-oracle switch is read once at import: it is a test/debug
# knob (parity oracle), not a per-call runtime toggle, and an environ
# lookup per select call is measurable on the hot path.
_SCALAR_FORCED = os.environ.get("REPRO_SCALAR_SELECT") == "1"

_HUGE_MS = np.int64(1) << 60


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    use_containers: bool
    share_scope: str          # 'global' | 'workflow' | 'app'
    locality_tiers: bool
    idle_threshold_ms: int
    budget_mode: str          # 'ebpsm' | 'mslbl'

    def owner_tag(self, wid: int, app: str):
        if self.share_scope == "workflow":
            return ("wf", wid)
        if self.share_scope == "app":
            return ("app", app)
        return None


EBPSM = Policy("EBPSM", True, "global", True, 5_000, "ebpsm")
EBPSM_NS = Policy("EBPSM_NS", True, "workflow", True, 5_000, "ebpsm")
EBPSM_WS = Policy("EBPSM_WS", False, "app", True, 5_000, "ebpsm")
EBPSM_NC = Policy("EBPSM_NC", False, "global", True, 5_000, "ebpsm")
MSLBL_MW = Policy("MSLBL_MW", False, "global", False, 0, "mslbl")

ALL_POLICIES = (EBPSM, EBPSM_NS, EBPSM_WS, EBPSM_NC, MSLBL_MW)


@dataclasses.dataclass(slots=True)
class Placement:
    """Outcome of one selection decision."""

    vm: Optional[VM]              # reuse this idle VM …
    new_vmt_idx: Optional[int]    # … or provision a fresh VM of this type
    tier: int                     # 1=input-data, 2=container, 3=any idle, 4=new
    est_finish_ms: int
    est_cost: float


def _est_pipeline_ms(
    cfg: PlatformConfig,
    vmt: VMType,
    task: Task,
    missing_mb: float,
    container_ms: int,
    rt_out_ms: Optional[int] = None,
) -> int:
    """Scheduler's estimate: advertised capacity, known cache state.

    ``rt_out_ms`` short-circuits the static RT + write-back legs with the
    precomputed cost-table entry (bit-identical to the scalar sum)."""
    if rt_out_ms is None:
        rt_out_ms = costs.runtime_ms(vmt, task.size_mi) \
            + costs.transfer_out_ms(cfg, vmt, task.out_mb)
    pt = costs.transfer_in_ms(cfg, vmt, missing_mb) + rt_out_ms
    return container_ms + pt


def _est_cost(
    cfg: PlatformConfig, vmt: VMType, pipeline_ms: int, include_prov: bool
) -> float:
    dur = pipeline_ms + (cfg.vm_provision_delay_ms if include_prov else 0)
    return costs.billed_cost(cfg, vmt, dur)


@functools.lru_cache(maxsize=None)
def _speed_desc(cfg: PlatformConfig) -> Tuple[int, ...]:
    """VM-type indices by descending MIPS, ties in catalogue order — the
    exact order ``sorted(..., reverse=True)`` produced in the scalar
    tier-4 sweep."""
    return tuple(sorted(range(len(cfg.vm_types)),
                        key=lambda i: cfg.vm_types[i].mips, reverse=True))


@functools.lru_cache(maxsize=None)
def _cheapest_idx(cfg: PlatformConfig) -> int:
    return min(range(len(cfg.vm_types)),
               key=lambda i: cfg.vm_types[i].cost_per_bp)


def select(
    cfg: PlatformConfig,
    policy: Policy,
    task: Task,
    wid: int,
    app: str,
    inputs: List[Tuple[DataKey, float]],
    budget: float,
    idle_vms: Sequence[VM],
    table: Optional[CostTable] = None,
    owner_tag: object = _AUTO_TAG,
    pool: Optional[VMPool] = None,
) -> Placement:
    """Algorithm 2 for one task.  Always returns a placement (the paper
    assumes budgets are sufficient; when even the cheapest new VM exceeds the
    sub-budget we still fall back to the cheapest type — the budget is a soft
    constraint and Algorithm 3 will recover the debt downstream).

    ``table`` (the workflow's cost table) short-circuits the static
    estimate legs; every table entry is bit-identical to the scalar
    computation, so callers may mix table-carrying and bare calls freely.

    ``pool`` (the live :class:`VMPool` registry) enables the vectorized
    path; without it — or with ``REPRO_SCALAR_SELECT=1``, or below
    ``VECTOR_SELECT_MIN_VMS`` idle VMs in scope — the scalar per-VM loop
    runs instead.  Both paths are bit-exact.  ``idle_vms`` must be in
    ascending-vmid order (every caller's pool queries already are).
    """
    tag = policy.owner_tag(wid, app) if owner_tag is _AUTO_TAG else owner_tag
    scoped = [vm for vm in idle_vms
              if vm.status == VM_IDLE and vm.owner_tag == tag]
    if (pool is not None and len(scoped) >= VECTOR_SELECT_MIN_VMS
            and not _SCALAR_FORCED):
        return _select_vector(cfg, policy, task, app, inputs, budget,
                              scoped, table, pool)
    return _select_scalar(cfg, policy, task, app, inputs, budget, scoped,
                          table)


def _select_scalar(
    cfg: PlatformConfig,
    policy: Policy,
    task: Task,
    app: str,
    inputs: List[Tuple[DataKey, float]],
    budget: float,
    scoped: List[VM],
    table: Optional[CostTable],
) -> Placement:
    """Reference per-VM loop (the REPRO_SCALAR_SELECT=1 oracle).

    The tier-1/2/3 stage is one fused pass: each VM's tier, missing
    volume, pipeline estimate and billed cost are computed inline and
    the per-tier (finish, vmid) minima tracked as scalars — equivalent
    to partitioning into tier lists and scanning each (the tier of a VM
    does not depend on the other VMs), without building any of them.
    ``scoped`` is ascending by vmid, so "first strict improvement wins"
    reproduces the (finish, vmid) tie-break.
    """
    if scoped:
        use_cont = policy.use_containers
        loc = policy.locality_tiers
        rt_l = table.rt_list[task.tid] if table is not None else None
        gsr = cfg.gs_read_mbps
        bp = cfg.billing_period_ms
        c_init = cfg.container_init_ms
        c_prov = cfg.container_provision_ms
        tol = 1.0 - costs.CEIL_TOL
        ceil = math.ceil
        total_in = sum(mb for _, mb in inputs) if not loc else 0.0
        # Per-tier best (pipe, cost, vm); index 0 unused.
        best: List[Optional[Tuple[int, float, VM]]] = [None, None, None, None]
        for vm in scoped:
            if not use_cont:
                c_ms = 0
            elif vm.active_container == app:
                c_ms = 0
            elif app in vm.image_cache:
                c_ms = c_init
            else:
                c_ms = c_prov
            if loc:
                dc = vm.data_cache
                missing = 0.0
                have_all = True
                for key, mb in inputs:
                    if key not in dc:
                        missing += mb
                        if mb > 0:
                            have_all = False
                tier = 1 if have_all else (
                    2 if use_cont and vm.active_container == app else 3)
            else:
                missing = total_in
                tier = 3
            if rt_l is not None:
                ro = rt_l[vm.vmt_idx]
            else:
                ro = costs.runtime_ms(vm.vmt, task.size_mi) \
                    + costs.transfer_out_ms(cfg, vm.vmt, task.out_mb)
            if missing > 0.0:
                pipe = c_ms + int(ceil(
                    1000.0 * (missing / vm.vmt.bandwidth_mbps
                              + missing / gsr) * tol)) + ro
            else:
                pipe = c_ms + ro
            cost = ((pipe + bp - 1) // bp) * vm.vmt.cost_per_bp
            if cost > budget + 1e-9:
                continue
            b = best[tier]
            if b is None or pipe < b[0]:
                best[tier] = (pipe, cost, vm)
        for tier in (1, 2, 3):
            b = best[tier]
            if b is not None:
                return Placement(b[2], None, tier, b[0], b[1])

    # Tier 4: provision the fastest affordable new VM.  The full-input
    # pipeline estimate is exactly the cost table's proc_ms row.
    total_in = sum(mb for _, mb in inputs)
    c_ms = cfg.container_provision_ms if policy.use_containers else 0
    proc = table.proc_ms[task.tid] if table is not None else None

    def full_pipe(idx: int) -> int:
        if proc is not None:
            return int(proc[idx]) + c_ms
        return _est_pipeline_ms(cfg, cfg.vm_types[idx], task, total_in, c_ms)

    for idx in _speed_desc(cfg):
        pipe = full_pipe(idx)
        cost = _est_cost(cfg, cfg.vm_types[idx], pipe, include_prov=True)
        if cost <= budget + 1e-9:
            return Placement(
                None, idx, 4, cfg.vm_provision_delay_ms + pipe, cost
            )

    # Insufficient sub-budget (paper assumes budgets sufficient; the budget
    # is a soft constraint and Algorithm 3 recovers the debt downstream).
    # Take the *cheapest* feasible action: min-cost over reusing any idle VM
    # in scope vs. provisioning a fresh cheapest-type VM.
    cands: List[Placement] = []
    rt_out = table.rt_out_ms[task.tid] if table is not None else None
    for vm in scoped:
        cm = vm.container_ms(cfg, app, policy.use_containers)
        missing = vm.missing_mb(inputs) if policy.locality_tiers else total_in
        pipe = _est_pipeline_ms(
            cfg, vm.vmt, task, missing, cm,
            int(rt_out[vm.vmt_idx]) if rt_out is not None else None)
        cands.append(
            Placement(vm, None, 5, pipe, _est_cost(cfg, vm.vmt, pipe, False))
        )
    idx = _cheapest_idx(cfg)
    pipe = full_pipe(idx)
    cands.append(
        Placement(
            None, idx, 5, cfg.vm_provision_delay_ms + pipe,
            _est_cost(cfg, cfg.vm_types[idx], pipe, include_prov=True),
        )
    )
    return min(
        cands,
        key=lambda p: (p.est_cost, p.est_finish_ms, p.vm.vmid if p.vm else 1 << 30),
    )


def _select_vector(
    cfg: PlatformConfig,
    policy: Policy,
    task: Task,
    app: str,
    inputs: List[Tuple[DataKey, float]],
    budget: float,
    scoped: List[VM],
    table: Optional[CostTable],
    pool: VMPool,
) -> Placement:
    """Algorithm 2 as numpy reductions over the pool registry.

    Per-VM quantities (container delay, missing-input volume, pipeline
    estimate, billed cost) are built from the pool's incremental indexes
    and vmid-indexed float64 attribute arrays; the tier partition and the
    (tier, finish, vmid) argmin are array reductions.  Every float op
    matches the scalar reference's float64 sequence, so the outcome is
    bit-exact (``scoped`` ascending by vmid makes ``argmin``'s
    first-occurrence rule the scalar vmid tie-break).
    """
    V = len(scoped)
    ids = np.fromiter((vm.vmid for vm in scoped), np.int64, V)
    col = {vmid: j for j, vmid in enumerate(ids.tolist())}
    bw = pool.bandwidth[ids]
    price = pool.price[ids]
    bp = cfg.billing_period_ms

    # Container-activation delay vector from the incremental app indexes.
    active = np.zeros(V, bool)
    if policy.use_containers:
        cont = np.full(V, cfg.container_provision_ms, np.int64)
        for vid in pool.app_image.get(app, ()):
            j = col.get(vid)
            if j is not None:
                cont[j] = cfg.container_init_ms
        for vid in pool.app_active.get(app, ()):
            j = col.get(vid)
            if j is not None:
                cont[j] = 0
                active[j] = True
    else:
        cont = np.zeros(V, np.int64)

    # Missing-input MB + all-inputs-cached mask from the data index.
    # Accumulation order matches VM.missing_mb's per-input Python sum.
    total_in = sum(mb for _, mb in inputs)
    if policy.locality_tiers:
        miss = np.zeros(V, np.float64)
        have_all = np.ones(V, bool)
        for key, mb in inputs:
            holders = pool.data_index.get(key)
            if holders:
                hold = np.zeros(V, bool)
                for vid in holders:
                    j = col.get(vid)
                    if j is not None:
                        hold[j] = True
                miss += np.where(hold, 0.0, mb)
                if mb > 0:
                    have_all &= hold
            else:
                miss += mb
                if mb > 0:
                    have_all[:] = False
    else:
        miss = np.full(V, total_in, np.float64)
        have_all = np.zeros(V, bool)

    # Pipeline estimate (Eqs. 1–5 legs) and billed cost, all int64/float64
    # with the scalar op sequence.
    in_ms = np.where(
        miss > 0.0,
        _ceil_ms(MS * (miss / bw + miss / cfg.gs_read_mbps)),
        np.int64(0),
    )
    if table is not None:
        rt_out = table.rt_out_ms[task.tid][pool.type_idx[ids]]
    else:
        mips = pool.mips[ids]
        rt_out = _ceil_ms(MS * task.size_mi / mips)
        if task.out_mb > 0.0:
            rt_out = rt_out + _ceil_ms(
                MS * (task.out_mb / bw + task.out_mb / cfg.gs_write_mbps))
    pipe = cont + in_ms + rt_out
    cost = ((np.maximum(pipe, 0) + bp - 1) // bp) * price

    feas = cost <= budget + 1e-9
    if policy.locality_tiers:
        tier = np.where(have_all, 1, np.where(active, 2, 3))
    else:
        tier = np.full(V, 3, np.int64)
    t_eff = np.where(feas, tier, 9)
    best_t = int(t_eff.min()) if V else 9
    if best_t < 9:
        pipe_eff = np.where(t_eff == best_t, pipe, _HUGE_MS)
        j = int(pipe_eff.argmin())
        return Placement(scoped[j], None, best_t, int(pipe[j]),
                         float(cost[j]))

    # Tier 4: fastest affordable new VM (few types — scalar sweep over the
    # cached speed-descending order, table-backed estimates).
    c_ms = cfg.container_provision_ms if policy.use_containers else 0
    proc = table.proc_ms[task.tid] if table is not None else None

    def full_pipe(idx: int) -> int:
        if proc is not None:
            return int(proc[idx]) + c_ms
        return _est_pipeline_ms(cfg, cfg.vm_types[idx], task, total_in, c_ms)

    for idx in _speed_desc(cfg):
        pipe4 = full_pipe(idx)
        cost4 = _est_cost(cfg, cfg.vm_types[idx], pipe4, include_prov=True)
        if cost4 <= budget + 1e-9:
            return Placement(None, idx, 4,
                             cfg.vm_provision_delay_ms + pipe4, cost4)

    # Tier 5 (insufficient sub-budget): cheapest action over reusing any
    # scoped idle VM vs provisioning the cheapest type.  The reuse pipe
    # and cost vectors above are exactly the scalar candidates.
    idx = _cheapest_idx(cfg)
    pipe5 = full_pipe(idx)
    prov = Placement(
        None, idx, 5, cfg.vm_provision_delay_ms + pipe5,
        _est_cost(cfg, cfg.vm_types[idx], pipe5, include_prov=True),
    )
    if not V:
        return prov
    cmin = cost.min()
    pipe_eff = np.where(cost == cmin, pipe, _HUGE_MS)
    j = int(pipe_eff.argmin())
    if (float(cost[j]), int(pipe[j]), scoped[j].vmid) < (
            prov.est_cost, prov.est_finish_ms, 1 << 30):
        return Placement(scoped[j], None, 5, int(pipe[j]), float(cost[j]))
    return prov
