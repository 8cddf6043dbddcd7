"""Budget distribution — Algorithm 1 (DistributeBudget/SFTD) and
Algorithm 3 (UpdateBudget) of the paper.

The distribution assigns every task a sub-budget.  Pass 1 levels the DAG
(Deadline Top Level, Eq. 7), orders tasks by ascending EFT within each level
(Eq. 8) to form the estimated execution order ``S``; pass 2 allocates the
cheapest-VM cost to every task and then spends any leftover budget upgrading
the *earliest* tasks in ``S`` to the fastest affordable VM type
(Slowest-First Task-based Distribution).

All per-(task, VM type) estimates are read from the precomputed
:mod:`core.cost_tables` table (one ``[T, V]`` grid per workflow family,
shared across clones and both engines) instead of per-call scalar cost
evaluation — Algorithm 3's per-finish redistribution, the shared hot path
of both engines, reduces to indexed table reads.

Algorithm 3 has two implementations that must stay bit-exact with each
other (gated by ``tests/test_redistribute.py``):

* :func:`update_budget` — the scalar reference (sort, pool, sweep);
* :func:`update_budget_fast` — the array path: a per-workflow
  :class:`RedistState` keeps the estimated execution order ``S`` as an
  index array plus an unscheduled *mask*, so each per-finish call is a
  mask compress + table gathers + the bulk SFTD sweep
  (:func:`_bulk_sweep`) instead of a Python sort and per-tier rescan.

Tuning knobs (see the README "Tuning knobs" table):

* ``REPRO_SCALAR_REDIST=1`` — force the scalar :func:`update_budget`
  oracle on the engine hot path (read at import into
  ``_ARRAY_REDIST``); the array path is the default.
* ``_PY_DISTRIBUTE_MAX`` (=64) — subsets at or below this size take the
  pure-Python distribution path on *both* implementations; the cutover
  is bit-invisible.

The round-batched redistribution mode (``redistribute="round"`` on the
engines) banks per-finish surpluses and flushes them through
:func:`update_budget_pooled` once per workflow per scheduling cycle —
semantics-changing (surplus flows coalesce), so it is opt-in and
A/B-gated rather than bit-parity-gated (see docs/PROFILING.md).
"""
from __future__ import annotations

import os as _os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import cost_tables, costs
from .types import PlatformConfig, Task, VMType, Workflow


def assign_levels(wf: Workflow) -> None:
    """Eq. (7): level(t) = 0 for entries else max(level(parents)) + 1."""
    order = topological_order(wf)
    for tid in order:
        t = wf.tasks[tid]
        t.level = 0 if not t.parents else 1 + max(wf.tasks[p].level for p in t.parents)


def topological_order(wf: Workflow) -> List[int]:
    """Kahn topological order with deterministic (lowest-tid) tie-breaks."""
    indeg = [len(t.parents) for t in wf.tasks]
    import heapq

    heap = [i for i, d in enumerate(indeg) if d == 0]
    heapq.heapify(heap)
    out: List[int] = []
    while heap:
        u = heapq.heappop(heap)
        out.append(u)
        for c in wf.tasks[u].children:
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(heap, c)
    assert len(out) == len(wf.tasks), "cycle in workflow"
    return out


def input_mb(wf: Workflow, task: Task) -> float:
    """Total input volume d_t^in (external + every parent's output)."""
    out_of = [t.out_mb for t in wf.tasks]
    return costs.total_input_mb(task, out_of)


def estimated_eft(
    cfg: PlatformConfig, wf: Workflow, ref_vmt: VMType
) -> List[int]:
    """Eq. (8): EFT on a reference VM type (cheapest), in ms."""
    try:
        ref_idx = cfg.vm_types.index(ref_vmt)
        pt_of = cost_tables.table_for(cfg, wf).proc_ms[:, ref_idx]
    except ValueError:  # off-catalogue reference type: scalar fallback
        pt_of = [
            costs.processing_ms(cfg, ref_vmt, t, input_mb(wf, t))
            for t in wf.tasks
        ]
    eft = [0] * wf.n_tasks
    for tid in topological_order(wf):
        t = wf.tasks[tid]
        start = max((eft[p] for p in t.parents), default=0)
        eft[tid] = start + int(pt_of[tid])
    return eft


def execution_order(cfg: PlatformConfig, wf: Workflow) -> List[int]:
    """Estimated execution order S: level-major, EFT-ascending within level."""
    assign_levels(wf)
    ref = cfg.vm_types[0]  # cheapest type as the reference estimator
    eft = estimated_eft(cfg, wf, ref)
    order = sorted(
        range(wf.n_tasks),
        key=lambda tid: (wf.tasks[tid].level, eft[tid], tid),
    )
    for rank, tid in enumerate(order):
        wf.tasks[tid].rank = rank
    wf.rank_cache = None   # ranks changed; drop the memoized list
    return order


# Subsets up to this size take the pure-Python distribution path: ~20
# numpy dispatches cost more than the loop at Algorithm 3's per-finish
# call sizes.  Both paths execute the identical float64 operation
# sequence, so the cutover is invisible in results (bit-exact).
_PY_DISTRIBUTE_MAX = 64


def _sum_like_numpy(values: List[float]) -> float:
    """``float(np.sum(np.asarray(values)))`` without the array round-trip
    for the small-n regime, preserving numpy's exact summation order:
    n < 8 is a plain sequential reduction; 8 ≤ n ≤ 128 is the 8-lane
    pairwise block numpy uses below its recursion blocksize.  Falls back
    to numpy above that, and the replication is verified at import
    (``_SUM_VERIFIED``) so a change in numpy's reduction would be
    caught, not silently diverge."""
    n = len(values)
    if not _SUM_VERIFIED or n > 128:
        return float(np.sum(np.asarray(values)))
    if n < 8:
        s = 0.0
        for x in values:
            s += x
        return s
    r0, r1, r2, r3, r4, r5, r6, r7 = values[:8]
    i = 8
    stop = n - (n % 8)
    while i < stop:
        r0 += values[i]
        r1 += values[i + 1]
        r2 += values[i + 2]
        r3 += values[i + 3]
        r4 += values[i + 4]
        r5 += values[i + 5]
        r6 += values[i + 6]
        r7 += values[i + 7]
        i += 8
    s = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))
    while i < n:
        s += values[i]
        i += 1
    return s


def _verify_sum_compat() -> bool:
    global _SUM_VERIFIED
    _SUM_VERIFIED = True   # let _sum_like_numpy take the scalar paths
    rng = np.random.default_rng(0)
    for n in (*range(1, 18), 31, 64, 65, 127, 128):
        a = (rng.random(n) * rng.integers(1, 1000, n)).tolist()
        if _sum_like_numpy(a) != float(np.sum(np.asarray(a))):
            return False
    return True


_SUM_VERIFIED = _verify_sum_compat()


def _distribute_small(wf: Workflow, table, budget: float,
                      order: List[int]) -> float:
    """Pure-Python Algorithm 1 passes for small ``order`` subsets.

    Mirrors the vectorized body below operation-for-operation: pass 1 is
    the same sequential cumulative sum (``np.cumsum`` adds in index
    order) with ``remaining`` from the numpy-order total, and the SFTD
    sweep reads the table's plain-list mirror.

    The sweep keeps a *live* row list instead of re-scanning everything:
    ``remaining`` only ever decreases, and a row's upgrade delta is
    unchanged until the row itself upgrades — so a row that once fails
    the paid-upgrade check can never succeed later and is dropped, and a
    row at the top tier is done.  The rows it visits make exactly the
    decisions the full re-scan would (skipped rows change nothing), so
    allocations are bit-identical.
    """
    cheap = table.cheap_list
    running = 0.0
    alloc: List[float] = []
    for tid in order:
        w = cheap[tid]
        running = running + w
        avail = budget - (running - w)
        if avail < 0.0:
            avail = 0.0
        alloc.append(w if w < avail else avail)
    remaining = max(budget - _sum_like_numpy(alloc), 0.0)

    if remaining > 1e-9:
        tier_list = table.tier_list
        K = len(tier_list[0])
        top = K - 1
        # "Everyone tops out" shortcut: with nondecreasing tier costs,
        # the sweep's total consumption to bring every row to the top
        # tier is exactly Σ(top − alloc); when the remainder covers that
        # with margin (the 1e-6 safety dwarfs any accumulated rounding in
        # the ≤ U·K subtractions the sweep would make, so every paid
        # check the sweep would run is guaranteed to pass), the fixed
        # point is known without sweeping.
        if table.tiers_monotone:
            top_l = table.top_list
            need = 0.0
            for u, tid in enumerate(order):
                need += top_l[tid] - alloc[u]
            if remaining > need + 1e-6:
                remaining -= need
                tasks = wf.tasks
                for pos, tid in enumerate(order):
                    tasks[tid].budget = top_l[tid]
                return max(remaining, 0.0)
        # First sweep fused with tier-discovery: current tier = highest
        # covered (same `alloc >= tier_cost - 1e-9` predicate as the
        # array path), then the usual one-tier upgrade attempt.  Upgrade
        # attempts continue through the whole sweep even once
        # ``remaining`` dips under the sweep-entry threshold — exactly
        # the reference loop's within-sweep behavior.
        live: List[list] = []   # [u, k, row] for rows that may still move
        monotone = table.tiers_monotone
        for u, a in enumerate(alloc):
            row = tier_list[order[u]]
            if monotone:
                # Nondecreasing row ⇒ the covered set is a prefix: walk
                # up and stop at the first uncovered tier (same result
                # as the descending scan, fewer comparisons — most rows
                # sit at low tiers).
                k = 0
                for j in range(1, K):
                    if a >= row[j] - 1e-9:
                        k = j
                    else:
                        break
            else:
                k = 0
                for j in range(top, -1, -1):
                    if a >= row[j] - 1e-9:
                        k = j
                        break
            if k >= top:
                continue
            delta = row[k + 1] - a
            if 0 < delta <= remaining + 1e-9:
                alloc[u] = row[k + 1]
                remaining -= delta
                k += 1
            elif delta <= 0:
                k += 1
            else:
                continue  # paid check failed: can never succeed later
            if k < top:
                live.append([u, k, row])
        while live and remaining > 1e-9:
            nxt: List[list] = []
            for item in live:
                u, k, row = item
                delta = row[k + 1] - alloc[u]
                if 0 < delta <= remaining + 1e-9:
                    alloc[u] = row[k + 1]
                    remaining -= delta
                elif delta > 0:
                    continue  # dropped forever
                item[1] = k = k + 1
                if k < top:
                    nxt.append(item)
            live = nxt

    tasks = wf.tasks
    for pos, tid in enumerate(order):
        tasks[tid].budget = alloc[pos]
    return max(remaining, 0.0)


def distribute_budget(
    cfg: PlatformConfig,
    wf: Workflow,
    budget: float,
    task_ids: Optional[Sequence[int]] = None,
    presorted: bool = False,
) -> float:
    """Algorithm 1.  Mutates ``task.budget``; returns the undistributed
    remainder (spare budget — Alg. 3 folds it into the next update so no
    money is ever lost).

    Pass 1 allocates the cheapest-VM conservative cost to tasks in order
    *while the pool lasts* (the paper's ``while β > 0``); once exhausted,
    later tasks receive whatever fraction remains (possibly zero).  Budget
    is strictly conserved: Σ sub-budgets ≤ β always.

    Pass 2 (SFTD) upgrades the earliest tasks in ``S`` to the fastest type
    still affordable with the leftover.

    ``task_ids`` restricts distribution to a subset (used by Algorithm 3 to
    redistribute over unscheduled tasks); order within the subset follows the
    original estimated execution order (``task.rank``).

    Both passes read the workflow's :class:`~core.cost_tables.CostTable`:
    pass 1 is a masked cumulative reduction over the cheapest-type column,
    pass 2 sweeps the precomputed ``[U, V]`` tier-cost slice.
    """
    if task_ids is None:
        order = execution_order(cfg, wf)
    elif presorted:
        order = task_ids
    else:
        ranks = wf.rank_cache
        if ranks is None:
            # Ranks are frozen once the arrival-time distribution ran;
            # the per-finish Algorithm 3 path sorts against this list
            # instead of a per-call attribute-chasing lambda.
            wf.rank_cache = ranks = [t.rank for t in wf.tasks]
        order = sorted(task_ids, key=ranks.__getitem__)
    if not order:
        return budget

    table = cost_tables.table_for(cfg, wf)
    if len(order) <= _PY_DISTRIBUTE_MAX:
        return _distribute_small(wf, table, budget, order)
    order_arr = np.asarray(order, np.int64)
    # Pass 1: cheapest-VM conservative cost, allocated while the pool
    # lasts — give_i = min(want_i, max(β − Σ_{<i} give, 0)), as a masked
    # cumulative table reduction (cfg.vm_types[0] is the cheapest type,
    # mirroring the reference estimator in execution_order).
    want = table.est_full_cost[order_arr, 0]
    cum = np.cumsum(want)
    alloc = np.minimum(want, np.maximum(budget - (cum - want), 0.0))
    remaining = max(budget - float(alloc.sum()), 0.0)

    # Pass 2 (SFTD): sweep the order earliest-first, upgrading each task's
    # allocation by ONE VM-type tier per visit ("upgrade ... for a faster VM
    # type starting from the earliest tasks"), until a sweep changes nothing.
    # One-tier sweeps keep the allocation distribution unimodal — the whole
    # workflow climbs the VM ladder together instead of splitting into a
    # fastest/cheapest bimodal mix (which would pollute the shared pool with
    # slow cache-carrier VMs).
    give = alloc.tolist()
    if remaining > 1e-9 and table.tiers_monotone:
        # Same "everyone tops out" shortcut as the small-subset path,
        # with the identical scalar accumulation so both paths stay
        # bit-exact around the size cutover.
        top_l = table.top_list
        need = 0.0
        for u, tid in enumerate(order):
            need += top_l[tid] - give[u]
        if remaining > need + 1e-6:
            remaining -= need
            tasks = wf.tasks
            for tid in order:
                tasks[tid].budget = top_l[tid]
            return max(remaining, 0.0)
    if remaining > 0:
        tier_cost = table.tier_cost[order_arr]
        K = tier_cost.shape[1]
        # Current tier: highest tier fully covered by the allocation.
        covered = alloc[:, None] >= tier_cost - 1e-9
        any_cov = covered.any(axis=1)
        highest = K - 1 - np.argmax(covered[:, ::-1], axis=1)
        tier_of = np.where(any_cov, highest, 0).tolist()
        # The sweep itself runs on plain Python floats (the same IEEE
        # doubles the array holds — ``tolist`` is value-preserving), which
        # is several times faster than per-element numpy indexing on the
        # per-finish Algorithm 3 hot path.
        tc = tier_cost.tolist()
        changed = True
        while remaining > 1e-9 and changed:
            changed = False
            for u in range(len(give)):
                k = tier_of[u]
                if k + 1 >= K:
                    continue
                delta = tc[u][k + 1] - give[u]
                if 0 < delta <= remaining + 1e-9:
                    give[u] = tc[u][k + 1]
                    tier_of[u] = k + 1
                    remaining -= delta
                    changed = True
                elif delta <= 0:
                    tier_of[u] = k + 1
                    changed = True

    tasks = wf.tasks
    for pos, tid in enumerate(order):
        tasks[tid].budget = give[pos]
    return max(remaining, 0.0)


def update_budget(
    cfg: PlatformConfig,
    wf: Workflow,
    finished_tid: int,
    actual_cost: float,
    spare_budget: float,
    unscheduled: Sequence[int],
) -> float:
    """Algorithm 3.  Returns the new spare budget.

    The finished task's allocation plus the spare budget absorb the actual
    cost; any surplus (or debt) flows into the pool redistributed over the
    unscheduled tasks, so uncertainty never propagates into a violation.
    The undistributed remainder of the redistribution persists as the spare
    (conservation: money is never created or silently dropped).

    ``unscheduled`` may come in any order (the engine hands over its raw
    set): the rank order of the estimated execution sequence S — which
    the redistribution consumes anyway — is the one deterministic order
    used for both the pool summation and the distribution, computed once.
    """
    tasks = wf.tasks
    t_f = tasks[finished_tid]
    if unscheduled:
        ranks = wf.rank_cache
        if ranks is None:
            wf.rank_cache = ranks = [t.rank for t in tasks]
        order = sorted(unscheduled, key=ranks.__getitem__)
        pool = sum([tasks[tid].budget for tid in order])
    else:
        order = None
        pool = 0.0
    headroom = t_f.budget + spare_budget
    if actual_cost <= headroom:
        pool += headroom - actual_cost
    else:
        pool -= actual_cost - headroom
    pool = max(pool, 0.0)
    if order:
        return distribute_budget(cfg, wf, pool, task_ids=order,
                                 presorted=True)
    return pool


# ---------------------------------------------------------------------------
# Array-path Algorithm 3 (the engine hot path)
# ---------------------------------------------------------------------------

# REPRO_SCALAR_REDIST=1 forces the scalar update_budget reference on the
# engine hot path — the oracle knob for parity tests and bisection, the
# exact analogue of scheduler.py's REPRO_SCALAR_SELECT.
_ARRAY_REDIST = _os.environ.get("REPRO_SCALAR_REDIST") != "1"


class RedistState:
    """Live per-workflow state for the array-path Algorithm 3.

    The scalar :func:`update_budget` pays three per-call costs that scale
    with the unscheduled count ``U``: sorting the engine's raw set into
    rank order, gathering the pool from task attributes, and the per-tier
    SFTD rescan.  This state removes the first two: the estimated
    execution order ``S`` is stored once as an index array, scheduling
    only ever *clears* mask bits (:meth:`mark_scheduled`), so the
    rank-ordered unscheduled rows are a boolean compress; and
    ``budget_vec`` mirrors every task's current sub-budget as float64 so
    the pool gather is one fancy index (summed in the scalar reference's
    exact order — see :func:`update_budget_fast`).

    Because the row set only changes at :meth:`mark_scheduled`, every
    pure function of the rows is memoized between scheduling events —
    the compress itself, the cheapest-column gather and its cumulative
    sum (pass 1 of Algorithm 1 depends on the pool only through two
    scalars), the ``[U, K]`` tier slice, and a running ``top_sum`` that
    turns the "everyone tops out" screen into two flops (the cached sum
    drifts from the exact reduction by at most ~n·eps, which the
    screen's margin dominates — it only ever errs toward running the
    exact check).  A typical engine trace schedules a burst of tasks,
    then redistributes across many finishes with the same row set, so
    the caches hit on most calls.

    Lives on the engine's per-workflow ``_WfState`` (never on the
    :class:`Workflow` itself: structural-sharing clones share task lists
    across grid members, while the mask/budget mirror is per-member
    mutable state).
    """

    __slots__ = ("order_all", "pos_of", "mask", "budget_vec", "top_sum",
                 "_top_list", "_rows", "_rows_list", "_want", "_cum",
                 "_want_sum", "_tcr")

    def __init__(self, cfg: PlatformConfig, wf: Workflow,
                 unscheduled: Optional[Sequence[int]] = None,
                 backing: Optional[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]] = None):
        """``backing``: optional ``(order, pos, mask, budget)`` array
        segments — slices of a ``core.types.StreamState`` pool — to fill
        and use in place of fresh per-workflow allocations.  Values and
        semantics are identical either way (the arrays are just owned by
        a shared backing instead of this object)."""
        ranks = wf.rank_cache
        if ranks is None:
            wf.rank_cache = ranks = [t.rank for t in wf.tasks]
        n = wf.n_tasks
        # Ranks are a permutation (execution_order assigns positions), so
        # the stable argsort equals the scalar path's sorted(..., key=rank).
        order = np.argsort(np.asarray(ranks, np.int64), kind="stable")
        if backing is None:
            self.order_all = order                 # S: tids, rank-ascending
            pos = np.empty(n, np.int64)
        else:
            out_order, pos, out_mask, out_budget = backing
            out_order[:] = order
            self.order_all = order = out_order
        pos[order] = np.arange(n, dtype=np.int64)
        self.pos_of = pos                          # tid -> position in S
        if backing is None:
            mask = np.ones(n, bool) if unscheduled is None \
                else np.zeros(n, bool)
        else:
            mask = out_mask
            mask[:] = unscheduled is None
        if unscheduled is not None:
            pos_l = pos.tolist()
            for tid in unscheduled:
                mask[pos_l[tid]] = True
        self.mask = mask
        if backing is None:
            self.budget_vec = np.array([t.budget for t in wf.tasks],
                                       np.float64)
        else:
            out_budget[:] = [t.budget for t in wf.tasks]
            self.budget_vec = out_budget
        self._rows = None
        self._rows_list = None
        self._want = None
        self._cum = None
        self._want_sum = 0.0
        self._tcr = None
        table = cost_tables.table_for(cfg, wf)
        if table.tiers_monotone:
            self._top_list = table.top_list
            r = self.rows()
            self.top_sum = float(table.top_arr[r].sum()) if r.size else 0.0
        else:
            self._top_list = None
            self.top_sum = 0.0

    def mark_scheduled(self, tid: int) -> None:
        self.mask[self.pos_of[tid]] = False
        self._rows = None
        self._rows_list = None
        self._want = None
        self._cum = None
        self._tcr = None
        if self._top_list is not None:
            self.top_sum -= self._top_list[tid]

    def mark_unscheduled(self, tid: int) -> None:
        """Exact inverse of :meth:`mark_scheduled` — readmit a requeued
        task (chaos re-execution) into the redistribution pool."""
        self.mask[self.pos_of[tid]] = True
        self._rows = None
        self._rows_list = None
        self._want = None
        self._cum = None
        self._tcr = None
        if self._top_list is not None:
            self.top_sum += self._top_list[tid]

    def rows(self) -> np.ndarray:
        """Unscheduled tids in rank order (the compress of S)."""
        r = self._rows
        if r is None:
            r = self._rows = self.order_all[self.mask]
        return r


def update_budget_fast(
    cfg: PlatformConfig,
    wf: Workflow,
    rs: RedistState,
    finished_tid: int,
    actual_cost: float,
    spare_budget: float,
) -> float:
    """Array-path Algorithm 3 — bit-exact with :func:`update_budget`.

    The pool is summed with the builtin over the gathered row budgets
    (``tolist`` is value-preserving, and the rows are in rank order —
    the identical float sequence the scalar reference reduces), the
    headroom fold is the same scalar expression, and the redistribution
    runs through :func:`_distribute_rows`, which replicates
    :func:`distribute_budget` operation-for-operation.

    One shortcut the scalar path lacks: a zero pool redistributed over
    already-all-zero budgets is the identity (pass 1 allocates zero to
    every row and the sweep never runs), so the call returns without
    touching the tasks — the common steady state of debt-heavy regimes.
    """
    rows = rs.rows()
    if rows.size:
        vals = rs.budget_vec[rows]
        pool = sum(vals.tolist())
    else:
        pool = 0.0
    headroom = wf.tasks[finished_tid].budget + spare_budget
    if actual_cost <= headroom:
        pool += headroom - actual_cost
    else:
        pool -= actual_cost - headroom
    pool = max(pool, 0.0)
    if not rows.size:
        return pool
    if pool == 0.0 and not vals.any():
        return 0.0
    return _distribute_rows(cfg, wf, rs, rows, pool, vals)


def update_budget_pooled(
    cfg: PlatformConfig,
    wf: Workflow,
    rs: RedistState,
    surplus: float,
    spare_budget: float,
) -> float:
    """Round-batched Algorithm 3 (array path): one redistribution for a
    whole rendezvous round's worth of task-finish events.

    ``surplus`` is the banked ``Σ (budget_f − actual_f)`` over the
    coalesced finishes.  In exact arithmetic the chained per-finish
    updates and this pooled form conserve the same money; in float they
    differ (surplus flows reorder), which is why the mode is opt-in and
    A/B-gated rather than parity-gated.  Bit-exact with
    :func:`update_budget_pooled_scalar` (the oracle form).
    """
    rows = rs.rows()
    if rows.size:
        vals = rs.budget_vec[rows]
        pool = sum(vals.tolist())
    else:
        pool = 0.0
    pool += spare_budget + surplus
    pool = max(pool, 0.0)
    if not rows.size:
        return pool
    if pool == 0.0 and not vals.any():
        return 0.0
    return _distribute_rows(cfg, wf, rs, rows, pool, vals)


def update_budget_pooled_scalar(
    cfg: PlatformConfig,
    wf: Workflow,
    surplus: float,
    spare_budget: float,
    unscheduled: Sequence[int],
) -> float:
    """Scalar oracle for :func:`update_budget_pooled` (same pooled
    semantics on the reference sort/sum/distribute path); the engine uses
    it when ``REPRO_SCALAR_REDIST=1`` forces the scalar hot path."""
    tasks = wf.tasks
    if unscheduled:
        ranks = wf.rank_cache
        if ranks is None:
            wf.rank_cache = ranks = [t.rank for t in tasks]
        order = sorted(unscheduled, key=ranks.__getitem__)
        pool = sum([tasks[tid].budget for tid in order])
    else:
        order = None
        pool = 0.0
    pool += spare_budget + surplus
    pool = max(pool, 0.0)
    if order:
        return distribute_budget(cfg, wf, pool, task_ids=order,
                                 presorted=True)
    return pool


def _distribute_rows(
    cfg: PlatformConfig,
    wf: Workflow,
    rs: RedistState,
    rows: np.ndarray,
    budget: float,
    old: Optional[np.ndarray] = None,
) -> float:
    """Algorithm 1 over the rank-ordered row array — the redistribution
    core of the array path, bit-exact with
    ``distribute_budget(..., task_ids=rows, presorted=True)``.

    Small subsets delegate to the shared pure-Python path (identical
    object); larger ones replicate the numpy branch: the same pass-1
    cumulative reduction over the contiguous cheapest column (gathered
    once per row set and memoized on ``rs``), the same
    scalar-accumulated "everyone tops out" shortcut behind the cached
    ``top_sum`` screen, and the SFTD sweep via :func:`_bulk_sweep`.
    Also syncs ``rs.budget_vec`` with the written ``task.budget``
    values.  ``old`` is the caller's already-gathered current row
    budgets (skips re-gathering for the diff-only writeback).
    """
    table = cost_tables.table_for(cfg, wf)
    tasks = wf.tasks
    if rows.size <= _PY_DISTRIBUTE_MAX:
        order = rs._rows_list
        if order is None or len(order) != rows.size:
            order = rs._rows_list = rows.tolist()
        rem = _distribute_small(wf, table, budget, order)
        rs.budget_vec[rows] = [tasks[tid].budget for tid in order]
        return rem

    if old is None:
        old = rs.budget_vec[rows]

    def writeback(new: np.ndarray) -> None:
        # task.budget mirrors budget_vec by invariant, so only rows whose
        # value moved need the (Python-priced) attribute write; the
        # written floats are identical either way.
        changed = np.flatnonzero(old != new)
        if changed.size:
            for tid, b in zip(rows[changed].tolist(),
                              new[changed].tolist()):
                tasks[tid].budget = b
            rs.budget_vec[rows] = new
    # Pass 1 — identical ops to distribute_budget's numpy branch
    # (cheap_arr is a contiguous copy of est_full_cost[:, 0]).  The
    # gather and its cumsum depend only on the row set, so they are
    # memoized on the state; the pool enters through two scalars.
    want = rs._want
    if want is None:
        want = rs._want = table.cheap_arr[rows]
        rs._cum = np.cumsum(want)
        rs._want_sum = float(want.sum())
    cum = rs._cum
    total_want = float(cum[-1])
    if budget >= total_want + 1e-6 + 1e-12 * (abs(budget) + total_want):
        # Fully funded with margin: every per-row ``budget − (cum−want)``
        # provably rounds at or above ``want`` (the margin dwarfs the one
        # subtraction's rounding), so pass 1 allocates exactly ``want``
        # and the pairwise sum is the cached one.  Boundary cases fall
        # through to the literal expression.
        alloc = want.copy()
        alloc_sum = rs._want_sum
    else:
        alloc = np.minimum(want, np.maximum(budget - (cum - want), 0.0))
        alloc_sum = float(alloc.sum())
    remaining = max(budget - alloc_sum, 0.0)

    if remaining > 1e-9 and rs._top_list is not None:
        # "Everyone tops out" shortcut.  The reference accumulates
        # ``need`` with an exact scalar loop; the cached running
        # ``top_sum`` gives a two-flop screen — when the remainder
        # provably can't clear the exact need (the usual exhaustion
        # regime), the loop and the shortcut are skipped without any
        # observable difference, since the reference discards ``need``
        # on a non-firing shortcut too.  The screen's error term covers
        # the cached sum's drift (≤ ~n·eps relative) with orders of
        # magnitude to spare, so it only errs toward running the loop.
        need_est = rs.top_sum - alloc_sum
        err = 1e-9 * (abs(rs.top_sum) + abs(alloc_sum) + 1.0)
        if remaining > need_est - err + 1e-6:
            # May fire: replicate the reference's exact accumulation
            # order (top − give, row-ascending).
            top_v = table.top_arr[rows]
            need = 0.0
            for t, g in zip(top_v.tolist(), alloc.tolist()):
                need += t - g
            if remaining > need + 1e-6:
                remaining -= need
                writeback(top_v)
                return max(remaining, 0.0)
    if remaining > 1e-9:
        tcr = rs._tcr
        if tcr is None:
            tcr = rs._tcr = table.tier_cost[rows]
        remaining = _bulk_sweep(table, tcr, alloc, remaining)
    writeback(alloc)
    return max(remaining, 0.0)


def _discover_tiers(tcr: np.ndarray, alloc: np.ndarray, K: int):
    """Current tier of each row: highest tier covered by the allocation
    — the numpy reference branch's exact predicate.  Returns
    ``(tier, alive)``."""
    covered = alloc[:, None] >= tcr - 1e-9
    any_cov = covered.any(axis=1)
    highest = K - 1 - np.argmax(covered[:, ::-1], axis=1)
    tier = np.where(any_cov, highest, 0)
    return tier, np.flatnonzero(tier < K - 1)


def _commit_candidates(ci: np.ndarray, cd: np.ndarray, remaining: float):
    """Sequential paid checks over a sweep's boundary candidates,
    vectorized where provable.  Returns ``(committed_positions,
    remaining)`` with ``remaining`` advanced by the exact per-row chain.

    The longest cumulative-sum prefix that provably fits commits in
    bulk: before prefix candidate ``i`` the reference's remainder is at
    least ``remaining − Σ_{j≤i} d_j`` up to the chain's accumulated
    rounding, and the margin (the same shape as the sweep predicates)
    dominates both that and the cumsum-vs-chain reassociation, so every
    prefix check passes.  ``remaining`` still advances by the exact
    subtraction chain.  The tail is then pre-filtered against the
    post-prefix remainder — the remainder only decreases, so a tail
    candidate already above it can never commit at its later visit —
    and the few survivors run the reference's decision loop verbatim.
    """
    cum = np.cumsum(cd)
    margin = 1e-6 + 1e-12 * (abs(remaining) + float(cum[-1])) * ci.size
    m = int(np.searchsorted(cum, remaining - margin, side="right"))
    if m:
        for d in cd[:m].tolist():
            remaining -= d
        if m == ci.size:
            return ci, remaining
    tail_d = cd[m:]
    keep = tail_d <= remaining + 1e-9
    if not keep.any():
        return ci[:m], remaining
    commit: List[int] = []
    for pos, d in zip(ci[m:][keep].tolist(), tail_d[keep].tolist()):
        if 0 < d <= remaining + 1e-9:
            remaining -= d
            commit.append(pos)
        # else: dead — the remainder shrank past it mid-sweep
    if not commit:
        return ci[:m], remaining
    cp = np.asarray(commit, np.int64)
    if m:
        cp = np.concatenate([ci[:m], cp])
    return cp, remaining


def _bulk_sweep(table, tcr: np.ndarray, alloc: np.ndarray,
                remaining: float) -> float:
    """SFTD sweep, one whole sweep per step, mutating ``alloc`` in place.

    The reference sweep visits rows in order, upgrading each by one tier
    when the paid check ``0 < delta ≤ remaining + 1e-9`` passes, and
    rescans until a sweep changes nothing.  Two vectorized regimes cover
    it bit-exactly:

    * **Guaranteed success** — the entry remainder exceeds the summed
      paid deltas by a conservative margin (covering both the
      pairwise-sum error of the total and the accumulated rounding of
      the sequential chain), so *every* sequential paid check provably
      passes: before row ``i`` the reference's remainder is at least
      ``remaining − Σ_{j<i} d_j`` up to that rounding, which the margin
      dominates.  Give/tier updates commit as array writes; ``remaining``
      still advances by the exact per-row subtraction chain (the same
      float sequence the reference executes), keeping the returned spare
      bit-identical.

    * **Exhaustion** — otherwise, a paid row whose delta exceeds even
      the sweep-entry remainder can never succeed (the remainder only
      decreases and a row's delta is fixed until its tier moves — the
      same live-list argument as :func:`_distribute_small`): those rows
      die permanently.  Free advances (``delta ≤ 0``) don't touch the
      remainder and commit vectorized; the boundary candidates go
      through :func:`_commit_candidates` (guaranteed prefix + exact
      tail).

    Monotone tier tables (the usual case) take a specialized iteration:
    after discovery every delta is positive (the highest-covered tier
    bounds the allocation strictly below the next tier's cost, and a
    committed row lands exactly on a tier value), so the paid/free
    bookkeeping collapses — zero deltas (duplicate adjacent tier costs)
    are detected with one ``all()`` and routed to the generic step.
    Discovery itself short-circuits when no row covers tier 1 (always
    true right after pass 1 unless tier costs nearly coincide): every
    row's highest covered tier is then 0, matching the reference's
    ``where(any_cov, highest, 0)`` without the ``[n, K]`` scan.

    A row that neither advanced nor died keeps its state and is
    revisited next sweep, exactly like the reference rescan.
    """
    K = tcr.shape[1]
    if K < 2:
        return remaining
    mono = table.tiers_monotone
    if mono and not (alloc >= tcr[:, 1] - 1e-9).any():
        # No row covers tier 1 ⇒ (monotone) none covers any higher tier
        # ⇒ every row sits at tier 0 (covered there or not — the
        # reference assigns 0 either way).
        tier = np.zeros(alloc.size, np.int64)
        alive = np.arange(alloc.size)
    else:
        tier, alive = _discover_tiers(tcr, alloc, K)
    while remaining > 1e-9 and alive.size:
        nxt = tcr[alive, tier[alive] + 1]
        delta = nxt - alloc[alive]
        if mono and delta.all():
            # Monotone fast step: every row is a paid upgrade.
            total = float(delta.sum())
            margin = 1e-6 + 1e-12 * (abs(remaining) + total) * alive.size
            if remaining > total + margin:
                alloc[alive] = nxt
                tier[alive] += 1
                for d in delta.tolist():     # exact reference chain
                    remaining -= d
                alive = alive[tier[alive] < K - 1]
                continue
            ci = np.flatnonzero(delta <= remaining + 1e-9)
            if not ci.size:
                break                        # everyone died: fixed point
            cp, remaining = _commit_candidates(ci, delta[ci], remaining)
            if not cp.size:
                break
            rc = alive[cp]
            alloc[rc] = nxt[cp]
            tier[rc] += 1
            alive = rc[tier[rc] < K - 1]
            continue
        # Generic step (non-monotone tables, or zero/negative deltas).
        paid = delta > 0.0
        pd = delta[paid]
        total = float(pd.sum())
        margin = 1e-6 + 1e-12 * (abs(remaining) + total) * alive.size
        if remaining > total + margin:
            # Guaranteed success: commit the whole sweep in bulk.
            alloc[alive[paid]] = nxt[paid]
            tier[alive] += 1                 # free rows advance too
            for d in pd.tolist():            # exact reference chain
                remaining -= d
            alive = alive[tier[alive] < K - 1]
            continue
        advanced = ~paid                     # free rows always advance
        if advanced.any():
            tier[alive[advanced]] += 1
        cand = paid & (delta <= remaining + 1e-9)
        ci = np.flatnonzero(cand)
        if ci.size:
            cp, remaining = _commit_candidates(ci, delta[ci], remaining)
            if cp.size:
                rc = alive[cp]
                alloc[rc] = nxt[cp]
                tier[rc] += 1
                advanced[cp] = True
        if not advanced.any():
            break                            # nothing changed: fixed point
        alive = alive[advanced]
        alive = alive[tier[alive] < K - 1]
    return remaining


def min_max_workflow_cost(cfg: PlatformConfig, wf: Workflow) -> tuple:
    """Budget-range estimate used by workload generation (Section 5).

    Minimum: sequential execution of every task on the cheapest type.
    Maximum: every task on its own fastest-type VM (max parallel spend).
    """
    table = cost_tables.table_for(cfg, wf)
    cheapest = cfg.vm_types[0]
    fastest_idx = max(range(len(cfg.vm_types)),
                      key=lambda i: cfg.vm_types[i].mips)
    lo = float(table.cost_bare[:, 0].sum())
    # Sequential on one VM: charge provisioning + one container once.
    lo += costs.billed_cost(
        cfg, cheapest, cfg.vm_provision_delay_ms + cfg.container_provision_ms
    )
    hi = float(table.est_full_cost[:, fastest_idx].sum())
    return lo, hi
