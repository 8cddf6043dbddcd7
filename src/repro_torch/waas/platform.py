"""Multi-tenant TPU-slice WaaS platform: EBPSM scheduling ML jobs.

Drives the *unchanged* core engine (policies, budget algebra, caches) on
the slice catalogue + ML-job DAGs.  Reporting rides the shared
:mod:`repro_torch.exp.metrics` collector (one schema for the paper grid and
the ML bridge): per-tenant makespan/cost/budget-met, slice utilization,
locality and sharing hit rates (tier 1 = "weights already resident", the
paper's data-sharing claim restated for ML), and a straggler-recovery
comparison.

Every entry point takes ``device``, where the engines score their
batched auction rounds: ``None`` means ``"cuda"`` (the CUDA affinity
kernel) and raises when no CUDA device is available; ``"cpu"`` runs the
plain torch version.  Results are the same on both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..chaos import ChaosConfig
from ..core.batch_engine import (BatchSimEngine, GridMember,
                                 predistribute_workload)
from ..core.engine import SimEngine
from ..device import resolve_device
from ..obs import monitor as obs_monitor
from ..obs import report as obs_report
from ..obs import timeseries as obs_ts
from ..obs.events import EventLog
from ..core.scheduler import ALL_POLICIES, EBPSM, MSLBL_MW, Policy
from ..core.types import PlatformConfig, SimResult, Workflow, clone_workload
from ..exp.metrics import CellMetrics, format_row
from ..tenants import QoSClass, Tenant, TenantMix, assign_budgets_uniform
from . import mljobs, slices

# The ML bridge's service class: budgets drawn from the upper 85% of each
# job's [min_cost, max_cost] range (the historical assign_budgets default).
ML_QOS = QoSClass("ml", (0.15, 1.0), 1)


@dataclasses.dataclass
class PlatformReport:
    """One policy's platform run: the raw SimResult plus its collected
    metrics (repro_torch.exp.metrics.CellMetrics — the shared schema)."""

    sim: SimResult
    metrics: CellMetrics
    slice_mix: Dict[str, int]
    #: Sampled-over-simulated-time summary from :mod:`repro_torch.obs.timeseries`
    #: (fleet/busy/utilization/cost-vs-budget curves); ``None`` unless the
    #: run collected events (``run_platform(..., events=True)``).
    series: Optional[Dict[str, object]] = None
    #: Live-monitor payload (:func:`repro_torch.obs.report.monitor_payload` —
    #: windowed series, per-QoS SLO table, alerts); ``None`` unless the
    #: run enabled the monitor (``run_platform(..., monitor=True)`` or
    #: ``REPRO_MONITOR=1``).
    monitor: Optional[Dict[str, object]] = None

    @property
    def policy(self) -> str:
        return self.metrics.policy

    @property
    def tier_hist(self) -> Dict[int, int]:
        return self.metrics.tier_hist

    @property
    def mean_makespan_s(self) -> float:
        return self.metrics.mean_makespan_s

    @property
    def p95_makespan_s(self) -> float:
        return self.metrics.p95_makespan_s

    @property
    def budget_met(self) -> float:
        return self.metrics.budget_met

    @property
    def utilization(self) -> float:
        return self.metrics.utilization

    @property
    def locality_hit_rate(self) -> float:
        return self.metrics.locality_hit_rate

    def row(self) -> str:
        return f"{format_row(self.metrics)} mix={self.slice_mix}"


def assign_budgets(cfg: PlatformConfig, wfs: Sequence[Workflow],
                   seed: int = 0, lo: float = 0.15, hi: float = 1.0) -> None:
    """Uniform budget draw — delegates to the shared
    :func:`repro_torch.tenants.assign_budgets_uniform` code path."""
    assign_budgets_uniform(cfg, wfs, np.random.default_rng(seed), lo, hi)


def ml_tenant(n_jobs: int, rate: float, art_dir: str = "artifacts/dryrun",
              name: str = "ml-tenant", qos: QoSClass = ML_QOS) -> Tenant:
    """The ML-job stream as a :class:`repro_torch.tenants.Tenant` — the one
    workload-construction path shared with the exp harness.  A
    single-tenant mix reproduces the legacy ``ml_workload`` +
    ``assign_budgets`` construction draw-for-draw (tenant 0 keeps the
    caller's seed)."""
    return Tenant(
        name=name, qos=qos, n_workflows=n_jobs,
        stream=lambda n, s: mljobs.ml_workload(n, rate, seed=s,
                                               art_dir=art_dir))


def ml_stream(cfg: PlatformConfig, n_jobs: int, rate: float, seed: int,
              art_dir: str = "artifacts/dryrun") -> List[Workflow]:
    """Build the budgeted ML workload through :class:`TenantMix`."""
    mix = TenantMix((ml_tenant(n_jobs, rate, art_dir),))
    return mix.build(cfg, seed).workflows


def run_platform(wfs: Sequence[Workflow], policy: Policy,
                 cfg: Optional[PlatformConfig] = None,
                 seed: int = 0,
                 events: Union[None, bool, EventLog] = None,
                 chaos: Optional[ChaosConfig] = None,
                 monitor: Union[None, bool, "obs_monitor.Monitor"] = None,
                 device: Union[None, str, "torch.device"] = None
                 ) -> PlatformReport:
    cfg = cfg or slices.platform_config()
    eng = SimEngine(cfg, policy, list(wfs), seed=seed, trace=True,
                    events=events, chaos=chaos, monitor=monitor,
                    device=device)
    sim = eng.run()
    return PlatformReport(
        sim=sim,
        metrics=CellMetrics.from_result(policy.name, sim, eng.trace_rows,
                                        monitor=eng.monitor),
        slice_mix=dict(eng.pool.vm_count_by_type),
        series=(obs_ts.cell_summary(eng.elog)
                if eng.elog is not None else None),
        monitor=(obs_report.monitor_payload(eng.monitor, label=policy.name)
                 if eng.monitor is not None else None),
    )


def compare_policies(n_jobs: int = 40, rate: float = 2.0, seed: int = 0,
                     policies: Sequence[Policy] = ALL_POLICIES,
                     art_dir: str = "artifacts/dryrun",
                     device: Union[None, str, "torch.device"] = None
                     ) -> List[PlatformReport]:
    device = resolve_device(device)
    cfg = slices.platform_config()
    reports = []
    for pol in policies:
        wfs = ml_stream(cfg, n_jobs, rate, seed, art_dir)
        reports.append(run_platform(wfs, pol, cfg, seed=seed, device=device))
    return reports


def sweep(n_jobs: int = 24, rates: Sequence[float] = (1.0, 4.0),
          seeds: Sequence[int] = (0,),
          policies: Sequence[Policy] = ALL_POLICIES,
          cfg: Optional[PlatformConfig] = None,
          art_dir: str = "artifacts/dryrun",
          device: Union[None, str, "torch.device"] = None) -> List[Dict]:
    """The full experiment grid — policy × arrival rate × seed — in ONE
    batched engine run (core.batch_engine).

    Each (rate, seed) pair generates one workload; every policy simulates
    a structural-sharing clone of it (fresh budget fields, shared DAG
    lists), so the comparison is paired exactly as in the paper.
    Returns one summary row per grid cell.
    """
    device = resolve_device(device)
    cfg = cfg or slices.platform_config()
    members: List[GridMember] = []
    labels: List[Tuple[str, float, int]] = []
    pre: List[Dict[int, float]] = []
    for rate in rates:
        for s in seeds:
            wfs = ml_stream(cfg, n_jobs, rate, s, art_dir)
            # One arrival-time budget distribution per budget mode; every
            # policy member clones the distributed prototype.
            protos = {}
            for pol in policies:
                if pol.budget_mode not in protos:
                    protos[pol.budget_mode] = predistribute_workload(
                        cfg, wfs, pol.budget_mode)
                proto, spares = protos[pol.budget_mode]
                members.append((pol, clone_workload(proto), s))
                labels.append((pol.name, rate, s))
                pre.append(spares)
    engine = BatchSimEngine(cfg, members, trace=True, predistributed=pre,
                            device=device)
    results = engine.run()
    rows: List[Dict] = []
    for (name, rate, s), res, st in zip(labels, results, engine.states):
        m = CellMetrics.from_result(name, res, st.trace_rows)
        rows.append({"rate_wf_per_min": rate, "seed": s, **m.to_dict()})
    return rows


def straggler_experiment(n_jobs: int = 30, rate: float = 2.0, seed: int = 0,
                         degradations: Sequence[float] = (0.1, 0.3, 0.5),
                         art_dir: str = "artifacts/dryrun",
                         slowdowns: Optional[Sequence[float]] = None,
                         straggler_prob: float = 0.1,
                         device: Union[None, str, "torch.device"] = None
                         ) -> Dict[str, List[Tuple[float, ...]]]:
    """Straggler mitigation = the paper's §5.2 experiment on slices:
    EBPSM's budget-update loop reallocates successors of slow stages onto
    faster slices; MSLBL's static safety net cannot.

    Two injection routes share the harness:

    * **degradation sweep** (default) — per-VM CPU degradation drawn by
      the cloud model, the paper's own perturbation.  Rows are
      ``(max_degradation, mean_makespan_s, budget_met)``.
    * **chaos sweep** (``slowdowns=(2.0, 4.0, ...)``) — seeded per-task
      runtime inflation via :class:`repro_torch.chaos.ChaosConfig`
      (``straggler_prob`` of tasks run ``slowdown ×`` their modelled
      time), with detections (actual > ``straggler_factor ×`` estimate)
      counted by the engine.  Rows are
      ``(slowdown, mean_makespan_s, budget_met, stragglers_detected)``.
    """
    device = resolve_device(device)
    out: Dict[str, List[Tuple[float, ...]]] = {}
    for pol in (EBPSM, MSLBL_MW):
        rows: List[Tuple[float, ...]] = []
        if slowdowns is None:
            for dmax in degradations:
                cfg = slices.platform_config(
                    cpu_degradation_mean=dmax / 2, cpu_degradation_std=0.01,
                    cpu_degradation_max=dmax)
                wfs = ml_stream(cfg, n_jobs, rate, seed, art_dir)
                rep = run_platform(wfs, pol, cfg, seed=seed, device=device)
                rows.append((dmax, rep.mean_makespan_s, rep.budget_met))
        else:
            cfg = slices.platform_config()
            for slow in slowdowns:
                chaos = ChaosConfig(straggler_prob=straggler_prob,
                                    straggler_slowdown=slow,
                                    straggler_factor=max(2.0, slow / 2),
                                    seed=seed)
                wfs = ml_stream(cfg, n_jobs, rate, seed, art_dir)
                rep = run_platform(wfs, pol, cfg, seed=seed, chaos=chaos,
                                   device=device)
                rows.append((slow, rep.mean_makespan_s, rep.budget_met,
                             float(rep.metrics.stragglers_detected)))
        out[pol.name] = rows
    return out
