"""Precomputed per-workflow ``[tasks × vm_types]`` cost tables.

Every budget decision in the paper — Algorithm 1 distribution, Algorithm 3
redistribution, the MSLBL_MW budget level, and the scheduler's tier-4/5
provisioning estimates — keeps re-evaluating the *same* static quantity:
Eq. (5) on advertised (undegraded) capacity for a (task, VM type) pair.
Profiling puts that at ~80% of both engines' wall (215k
``estimate_full_cost`` calls for a 40-workflow run).

A :class:`CostTable` evaluates the whole ``[T, V]`` grid once per
(config, workflow) with vectorized numpy float64 — the *same* IEEE
operations as the scalar reference in :mod:`core.costs`, so every entry is
bit-identical to the corresponding scalar call.  Budget distribution and
the scheduler then read table entries instead of recomputing; Algorithm 3
redistribution becomes indexed reductions over the unscheduled rows.

The table depends only on the immutable task attributes (sizes, outputs,
DAG edges) — never on budgets, policies or degradation seeds — so one
table is shared by every structural-sharing clone of a workflow
(``Workflow.clone`` propagates the ``cost_cache`` slot) and by both
engines, keeping batched↔sequential parity bit-exact by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from . import costs
from .types import MS, PlatformConfig, Workflow


def _ceil_ms(x: np.ndarray) -> np.ndarray:
    """Vectorized :func:`core.costs.ceil_ms` (tolerance-ceil to int ms)."""
    return np.ceil(x * (1.0 - costs.CEIL_TOL)).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class CostTable:
    """Static per-(cfg, workflow) estimate tables.

    All 2-D arrays are ``[T, V]`` with V indexed by ``cfg.vm_types``
    position (``VM.vmt_idx`` order, *not* speed order); ``by_speed``
    holds the type indices sorted by ascending MIPS for consumers that
    sweep the VM-type ladder.
    """

    cfg: PlatformConfig
    in_mb: np.ndarray          # [T] f64 — d_t^in (ext + shared + parents)
    proc_ms: np.ndarray        # [T, V] i64 — Eq. (4) PT, undegraded
    rt_out_ms: np.ndarray      # [T, V] i64 — RT + T^{d_out} (no input leg)
    est_full_cost: np.ndarray  # [T, V] f64 — Eq. (5) max: prov + cont + PT
    cost_bare: np.ndarray      # [T, V] f64 — PT only (no prov, no cont)
    by_speed: np.ndarray       # [V] i64 — type indices, ascending mips
    tier_cost: np.ndarray      # [T, V] f64 — est_full_cost in by_speed order
    # Contiguous 1-D gather columns for the array-path Algorithm 3
    # (``core.budget.update_budget_fast``): row gathers from a contiguous
    # copy beat strided views on the per-finish hot path.  Values are the
    # corresponding est_full_cost / tier_cost columns, bit-identical.
    cheap_arr: np.ndarray      # [T] f64 — est_full_cost[:, 0] contiguous
    top_arr: np.ndarray        # [T] f64 — tier_cost[:, -1] contiguous
    # Plain-Python mirrors (``tolist`` is value-preserving) for the
    # small-subset Algorithm 1/3 and scalar-select fast paths, where
    # per-call numpy dispatch overhead dwarfs the arithmetic.
    cheap_list: list           # [T] — est_full_cost[:, 0] as floats
    tier_list: list            # [T][V] — tier_cost rows as float lists
    rt_list: list              # [T][V] — rt_out_ms rows as int lists
    top_list: list             # [T] — tier_cost[:, -1] (fastest tier)
    # True ⇔ every tier_cost row is nondecreasing in speed order — the
    # precondition for the budget sweep's "everyone tops out" shortcut.
    tiers_monotone: bool

    @property
    def n_tasks(self) -> int:
        return self.proc_ms.shape[0]

    @property
    def n_types(self) -> int:
        return self.proc_ms.shape[1]


def build_table(cfg: PlatformConfig, wf: Workflow) -> CostTable:
    """Evaluate Eqs. (1)–(5) for every (task, VM type) pair at once."""
    mips = np.array([v.mips for v in cfg.vm_types], np.float64)
    bw = np.array([v.bandwidth_mbps for v in cfg.vm_types], np.float64)
    price = np.array([v.cost_per_bp for v in cfg.vm_types], np.float64)

    size = np.array([t.size_mi for t in wf.tasks], np.float64)
    out = np.array([t.out_mb for t in wf.tasks], np.float64)
    out_of = [t.out_mb for t in wf.tasks]
    # Same accumulation as the scalar path (costs.total_input_mb) so the
    # per-task totals are bit-identical to ``budget.input_mb``.
    in_mb = np.array(
        [costs.total_input_mb(t, out_of) for t in wf.tasks], np.float64
    )

    # Eqs. (1)–(3), elementwise over the [T, V] grid.  Undegraded
    # bandwidth is b_vmt · (1 − 0) — identical to the scalar estimate.
    in_ms = np.where(
        in_mb[:, None] > 0.0,
        _ceil_ms(MS * (in_mb[:, None] / bw[None, :]
                       + in_mb[:, None] / cfg.gs_read_mbps)),
        np.int64(0),
    )
    out_ms = np.where(
        out[:, None] > 0.0,
        _ceil_ms(MS * (out[:, None] / bw[None, :]
                       + out[:, None] / cfg.gs_write_mbps)),
        np.int64(0),
    )
    rt_ms = _ceil_ms(MS * size[:, None] / mips[None, :])

    proc_ms = in_ms + rt_ms + out_ms
    rt_out_ms = rt_ms + out_ms

    bp = cfg.billing_period_ms

    def billed(dur_ms: np.ndarray) -> np.ndarray:
        periods = (np.maximum(dur_ms, 0) + bp - 1) // bp
        return periods * price[None, :]

    prov = cfg.vm_provision_delay_ms
    cont = cfg.container_provision_ms
    est_full = billed(proc_ms + prov + cont)
    by_speed = np.argsort(mips, kind="stable").astype(np.int64)
    # Pre-gathered [T, K] slice the SFTD sweep reads row-wise: one
    # fancy-index per redistribution call instead of a 2-D gather.
    tier_cost = np.ascontiguousarray(est_full[:, by_speed])
    return CostTable(
        cfg=cfg,
        in_mb=in_mb,
        proc_ms=proc_ms,
        rt_out_ms=rt_out_ms,
        est_full_cost=est_full,
        cost_bare=billed(proc_ms),
        by_speed=by_speed,
        tier_cost=tier_cost,
        cheap_arr=np.ascontiguousarray(est_full[:, 0]),
        top_arr=np.ascontiguousarray(tier_cost[:, -1]),
        cheap_list=est_full[:, 0].tolist(),
        tier_list=tier_cost.tolist(),
        rt_list=rt_out_ms.tolist(),
        top_list=tier_cost[:, -1].tolist(),
        tiers_monotone=bool((np.diff(tier_cost, axis=1) >= 0).all()),
    )


def table_for(cfg: PlatformConfig, wf: Workflow) -> CostTable:
    """Memoized :func:`build_table` — one table per (cfg, workflow family).

    The cache lives on the workflow's ``cost_cache`` slot, which
    ``Workflow.clone`` shares by reference: a whole grid of
    structural-sharing clones hits one table.  A config change (the
    degradation sweeps rebuild ``PlatformConfig``) invalidates by value.
    """
    cached = wf.cost_cache
    if cached is not None and (cached.cfg is cfg or cached.cfg == cfg):
        return cached
    table = build_table(cfg, wf)
    wf.cost_cache = table
    return table
