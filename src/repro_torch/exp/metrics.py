"""Per-cell metrics collection for the evaluation grid.

One :class:`CellMetrics` summarizes one (scenario cell × policy)
simulation: the paper's headline quantities (makespan, cost/budget ratio,
budget-met %, VM usage) plus the resource-sharing actuals that make the
policy comparison explainable (container/data-cache hit rates, placement
tier histogram).  The ``repro_torch.exp.run`` harness consumes this
collector, so every report speaks the reference's schema — see the
metrics glossary in README.md.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.types import SimResult


@dataclasses.dataclass
class CellMetrics:
    """Summary of one simulation run (one grid cell × policy)."""

    policy: str
    n_workflows: int
    mean_makespan_s: float
    p95_makespan_s: float
    mean_cost_budget_ratio: float
    budget_met: float             # fraction of workflows with cost ≤ budget
    utilization: float            # busy-seconds / lease-seconds, all VMs
    total_vms: int
    vm_lease_s: float             # Σ leased VM-seconds (spend proxy)
    data_cache_hit_rate: float    # input MB served locally / total input MB
    container_hit_rate: float     # activations that skipped the download
    # Placement-tier histogram (1=input-data locality, 2=warm container,
    # 3=any idle, 4=new VM, 5=insufficient-budget fallback); empty when
    # the run was not traced.
    tier_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    # ---- online / multi-tenant extensions (zero-valued for closed grids).
    # Slowdown = makespan ÷ critical-path ideal (tenants.ideal_makespan_ms);
    # requires ``ideal_ms`` at collection time.
    p50_slowdown: float = 0.0
    p95_slowdown: float = 0.0
    # Jain fairness index over per-tenant mean slowdowns: 1 = every tenant
    # slowed equally, 1/n = one tenant absorbs all the queueing.
    jain_fairness: float = 0.0
    # Fleet size over time (from SimResult lease intervals).
    peak_vms: int = 0
    mean_fleet_vms: float = 0.0
    # Workflows that arrived during warm-up and were excluded from every
    # statistic above (online scenarios truncate the cold-start ramp).
    n_warmup_excluded: int = 0
    # Per-tenant and per-QoS-class breakdowns:
    # {name: {n, budget_met, mean_makespan_s, p50_slowdown, p95_slowdown}}.
    by_tenant: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    by_qos: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    # ---- fault-injection tallies (repro_torch.chaos; zeros on benign runs).
    # wasted_spend_frac = cost sunk into attempts that produced no output
    # ÷ total spend of all workflows (both unfiltered by warm-up — waste
    # is a whole-run platform quantity, not a per-workflow statistic).
    revocations: int = 0
    task_failures: int = 0
    task_retries: int = 0
    stragglers_detected: int = 0
    wasted_cost: float = 0.0
    wasted_spend_frac: float = 0.0
    spot_vms: int = 0
    # ---- live-monitor tallies (repro_torch.obs.monitor; zeros unless the run
    # carried a monitor).  alerts_open counts alerts still firing at the
    # horizon; alerts_by_kind keys are repro_torch.obs.slo.ALERT_KIND_NAMES.
    alerts_total: int = 0
    alerts_open: int = 0
    alerts_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)

    @staticmethod
    def _group_stats(rows: List[tuple]) -> Dict:
        """rows: (makespan_ms, met, slowdown-or-nan)."""
        mks = np.array([r[0] for r in rows], np.float64)
        slow = np.array([r[2] for r in rows], np.float64)
        have_slow = len(slow) and not np.isnan(slow).any()
        return {
            "n": len(rows),
            "budget_met": float(np.mean([r[1] for r in rows])),
            "mean_makespan_s": float(mks.mean()) / 1000.0,
            "p50_slowdown": float(np.percentile(slow, 50))
            if have_slow else 0.0,
            "p95_slowdown": float(np.percentile(slow, 95))
            if have_slow else 0.0,
        }

    @classmethod
    def from_result(
        cls,
        policy: str,
        res: SimResult,
        trace_rows: Optional[Sequence[tuple]] = None,
        tenant_of: Optional[Dict[int, str]] = None,
        qos_of: Optional[Dict[str, str]] = None,
        ideal_ms: Optional[Dict[int, int]] = None,
        warmup_ms: int = 0,
        monitor=None,
    ) -> "CellMetrics":
        """``tenant_of`` (wid → tenant), ``qos_of`` (tenant → QoS class)
        and ``ideal_ms`` (wid → critical-path lower bound) switch on the
        per-tenant online metrics; ``warmup_ms`` drops workflows that
        arrived before it from every statistic (cold-start truncation);
        ``monitor`` (a :class:`repro_torch.obs.monitor.Monitor`) fills the
        alert tallies."""
        wfs = [w for w in res.workflows if w.arrival_ms >= warmup_ms]
        n_excluded = len(res.workflows) - len(wfs)
        mks = np.array([w.makespan_ms for w in wfs], np.float64)
        ratios = np.array([w.cost_budget_ratio for w in wfs], np.float64)
        # Truncation covers the tier histogram too: placements made by
        # warm-up-excluded workflows (trace row = (t, wid, tid, tier, ...))
        # must not bias the locality rates of the reported set.
        kept = {w.wid for w in wfs}
        tiers = (
            dict(sorted(collections.Counter(
                r[3] for r in trace_rows if r[1] in kept).items()))
            if trace_rows else {}
        )
        slowdowns = {
            w.wid: w.makespan_ms / max(ideal_ms.get(w.wid, 0), 1)
            for w in wfs
        } if ideal_ms else {}
        p50 = p95 = 0.0
        if slowdowns:
            vals = np.array(list(slowdowns.values()), np.float64)
            p50 = float(np.percentile(vals, 50))
            p95 = float(np.percentile(vals, 95))
        by_tenant: Dict[str, Dict] = {}
        by_qos: Dict[str, Dict] = {}
        jain = 0.0
        if tenant_of:
            grouped: Dict[str, List[tuple]] = {}
            for w in wfs:
                row = (w.makespan_ms, w.budget_met,
                       slowdowns.get(w.wid, float("nan")))
                grouped.setdefault(tenant_of.get(w.wid, "?"), []).append(row)
            by_tenant = {name: cls._group_stats(rows)
                         for name, rows in sorted(grouped.items())}
            if qos_of:
                q_rows: Dict[str, List[tuple]] = {}
                for name, rows in grouped.items():
                    q_rows.setdefault(qos_of.get(name, "?"), []).extend(rows)
                by_qos = {q: cls._group_stats(rows)
                          for q, rows in sorted(q_rows.items())}
            if slowdowns:
                per_tenant_mean = np.array([
                    np.mean([r[2] for r in rows])
                    for rows in grouped.values()], np.float64)
                jain = float(per_tenant_mean.sum() ** 2
                             / (len(per_tenant_mean)
                                * (per_tenant_mean ** 2).sum()))
        # Budget-met over the post-warmup set (res.budget_met_fraction
        # would include warm-up workflows).
        met = float(np.mean([w.budget_met for w in wfs])) if wfs else 1.0
        total_spend = float(sum(w.cost for w in res.workflows))
        return cls(
            policy=policy,
            n_workflows=len(wfs),
            mean_makespan_s=float(mks.mean()) / 1000.0 if len(mks) else 0.0,
            p95_makespan_s=float(np.percentile(mks, 95)) / 1000.0
            if len(mks) else 0.0,
            mean_cost_budget_ratio=float(ratios.mean()) if len(ratios) else 0.0,
            budget_met=met,
            utilization=res.avg_vm_utilization,
            total_vms=res.total_vms,
            vm_lease_s=float(sum(res.vm_seconds_by_type.values())),
            data_cache_hit_rate=res.data_cache_hit_rate,
            container_hit_rate=res.container_hit_rate,
            tier_hist=tiers,
            p50_slowdown=p50,
            p95_slowdown=p95,
            jain_fairness=jain,
            peak_vms=res.peak_vms,
            mean_fleet_vms=res.mean_fleet_vms,
            n_warmup_excluded=n_excluded,
            by_tenant=by_tenant,
            by_qos=by_qos,
            revocations=res.revocations,
            task_failures=res.task_failures,
            task_retries=res.task_retries,
            stragglers_detected=res.stragglers_detected,
            wasted_cost=res.wasted_cost,
            wasted_spend_frac=(res.wasted_cost / total_spend
                               if total_spend > 0 else 0.0),
            spot_vms=res.spot_vms,
            alerts_total=len(monitor.alerts) if monitor is not None else 0,
            alerts_open=(sum(1 for a in monitor.alerts if a.open)
                         if monitor is not None else 0),
            alerts_by_kind=(monitor.alerts_by_kind()
                            if monitor is not None else {}),
        )

    @property
    def locality_hit_rate(self) -> float:
        """Fraction of placements on a VM already holding all inputs."""
        total = sum(self.tier_hist.values())
        return self.tier_hist.get(1, 0) / total if total else 0.0

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["locality_hit_rate"] = self.locality_hit_rate
        d["tier_hist"] = {str(k): v for k, v in self.tier_hist.items()}
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "CellMetrics":
        """Inverse of :meth:`to_dict` (ignores extra keys — artifact rows
        carry cell coordinates alongside the metrics)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["tier_hist"] = {int(k): v
                           for k, v in d.get("tier_hist", {}).items()}
        return cls(**kw)


def format_row(m: CellMetrics) -> str:
    """One-line human-readable summary (examples / REPL use)."""
    return (f"{m.policy:10s} mk={m.mean_makespan_s:9.1f}s "
            f"p95={m.p95_makespan_s:9.1f}s met={m.budget_met:6.2%} "
            f"util={m.utilization:6.2%} warm={m.locality_hit_rate:6.2%} "
            f"data-hit={m.data_cache_hit_rate:6.2%} "
            f"cont-hit={m.container_hit_rate:6.2%}")


def aggregate_by_policy(cells: Sequence[CellMetrics]) -> Dict[str, Dict]:
    """Across-cell aggregates per policy: mean of the cell means (every
    cell weighs equally, matching the paper's per-configuration figures)
    plus the worst cell for the floor-gated quantities."""
    by_pol: Dict[str, List[CellMetrics]] = {}
    for m in cells:
        by_pol.setdefault(m.policy, []).append(m)
    out: Dict[str, Dict] = {}
    for pol, ms in sorted(by_pol.items()):
        out[pol] = {
            "cells": len(ms),
            "mean_makespan_s": float(np.mean([m.mean_makespan_s for m in ms])),
            "mean_cost_budget_ratio": float(
                np.mean([m.mean_cost_budget_ratio for m in ms])),
            "budget_met_mean": float(np.mean([m.budget_met for m in ms])),
            "budget_met_min": float(np.min([m.budget_met for m in ms])),
            "utilization_mean": float(np.mean([m.utilization for m in ms])),
            "data_cache_hit_rate_mean": float(
                np.mean([m.data_cache_hit_rate for m in ms])),
            "container_hit_rate_mean": float(
                np.mean([m.container_hit_rate for m in ms])),
            # Online extensions (zero for closed grids).
            "p50_slowdown_mean": float(np.mean([m.p50_slowdown for m in ms])),
            "p95_slowdown_mean": float(np.mean([m.p95_slowdown for m in ms])),
            "jain_fairness_min": float(np.min([m.jain_fairness for m in ms])),
            "peak_vms_max": int(np.max([m.peak_vms for m in ms])),
            # Chaos tallies (zeros on benign runs).
            "revocations_total": int(np.sum([m.revocations for m in ms])),
            "task_failures_total": int(np.sum([m.task_failures
                                               for m in ms])),
            "task_retries_total": int(np.sum([m.task_retries for m in ms])),
            "stragglers_total": int(np.sum([m.stragglers_detected
                                            for m in ms])),
            "wasted_spend_frac_mean": float(
                np.mean([m.wasted_spend_frac for m in ms])),
            "wasted_spend_frac_max": float(
                np.max([m.wasted_spend_frac for m in ms])),
            # Live-monitor alert tallies (zeros unless monitored).
            "alerts_total": int(np.sum([m.alerts_total for m in ms])),
            "alerts_open_total": int(np.sum([m.alerts_open for m in ms])),
        }
    return out
