"""Paper-grid reproduction harness.

    PYTHONPATH=src python -m repro_torch.exp.run --grid paper-smoke

Runs a registered :mod:`repro_torch.exp.scenarios` grid through the batched
engine (``core.batch_engine.BatchSimEngine``, whose auction rounds the
CUDA affinity kernel scores) — every policy simulates a
structural-sharing clone of the same per-cell workload, with the
arrival-time budget distribution computed once per (workload, budget
mode) — collects one :class:`repro_torch.exp.metrics.CellMetrics` per
(cell × policy), and emits:

* ``<out>/BENCH_paper_grid.json`` — the machine-readable artifact CI
  uploads and diff-tracks across PRs;
* ``<out>/paper_grid.md`` — a human-readable report (summary table +
  per-cell makespans).

Workload cells are independent simulations, so the grid scales across
processes: ``--workers N`` fans cell batches out to a spawn-based
process pool.  Row order and every per-cell metric are identical to a
serial run; the merged dispatch stats (rounds, batched calls) reflect
the worker chunking, which re-batches cells for load balance, so they
can differ from a serial run's batching.  The full ``paper`` grid
(180 workload cells × 5 policies × 3 seeds) is the intended consumer.

``--check-floors`` turns the run into a gate: non-zero exit when any
EBPSM cell's budget-met % drops below the scenario's recorded floor, or
when EBPSM stops beating MSLBL_MW on mean makespan (the paper's headline
claim).

``--device`` (default ``cuda``) says where auction rounds are scored;
``cpu`` runs the plain torch version.  The artifact keeps the reference
schema: its ``use_pallas`` key holds the device the run used.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import ckpt
from ..core.batch_engine import (BatchSimEngine, GridMember,
                                 StreamInterrupted, predistribute_workload)
from ..core.types import PlatformConfig, clone_workload
from ..device import resolve_device
from ..obs import export as obs_export
from ..obs import monitor as obs_monitor
from ..obs import report as obs_report
from ..workflows.workload import cell_workload
from .metrics import CellMetrics, aggregate_by_policy
from .scenarios import (POLICY_BY_NAME, OnlineScenario, Scenario,
                        WorkloadCell, get_scenario)

ARTIFACT_NAME = "BENCH_paper_grid.json"
REPORT_NAME = "paper_grid.md"


def grid_executor(workers: int):
    """Spawn-context process pool for grid batches.

    Spawn (not fork): the parent usually holds an initialized CUDA
    context, which a forked child cannot use.  Callers that time
    repeated grids should create this once and pass it to ``run_grid``
    so worker start-up (interpreter + imports) amortizes.
    """
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        max_workers=workers,
        mp_context=multiprocessing.get_context("spawn"),
    )


def _chunked(seq: Sequence, n: int):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def _merge_stats(parts: List[Dict]) -> Dict:
    """Combine per-engine ``dispatch_stats`` payloads."""
    out: Dict = {"rounds": 0, "batched_calls": 0, "batched_cycles": 0,
                 "serial_cycles": 0, "aggregate_pairs_hist": {},
                 "max_member_pairs_batched": 0,
                 "min_member_pairs_batched": 0}
    mins = []
    profiles: List[Dict] = []
    for s in parts:
        for k in ("rounds", "batched_calls", "batched_cycles",
                  "serial_cycles"):
            out[k] += s[k]
        for b, n in s["aggregate_pairs_hist"].items():
            out["aggregate_pairs_hist"][b] = \
                out["aggregate_pairs_hist"].get(b, 0) + n
        out["max_member_pairs_batched"] = max(
            out["max_member_pairs_batched"], s["max_member_pairs_batched"])
        if s["batched_cycles"]:
            mins.append(s["min_member_pairs_batched"])
        if "profile" in s:
            profiles.append(s["profile"])
    out["min_member_pairs_batched"] = min(mins) if mins else 0
    # Structured-event counts (repro_torch.obs): totals and per-kind counts sum
    # across engines exactly like the phase counters, so a --workers run
    # merges to the same block as a serial run of the same chunking
    # (asserted in tests/test_torch_exp.py::test_workers_match_serial).
    ev_parts = [s["events"] for s in parts if "events" in s]
    if ev_parts:
        by_kind: Dict[str, int] = {}
        for e in ev_parts:
            for k, n in e["by_kind"].items():
                by_kind[k] = by_kind.get(k, 0) + n
        out["events"] = {
            "enabled": any(e["enabled"] for e in ev_parts),
            "total": sum(e["total"] for e in ev_parts),
            "by_kind": dict(sorted(by_kind.items())),
            "dropped": sum(e["dropped"] for e in ev_parts),
        }
    # Live-monitor blocks are integer-only by construction, so summing
    # them across worker chunks is exact and chunking-order-independent:
    # serial and --workers runs merge to byte-identical blocks (gated in
    # tests/test_torch_exp.py).
    mon_parts = [s["monitor"] for s in parts if "monitor" in s]
    if mon_parts:
        out["monitor"] = obs_monitor.merge_monitor_blocks(mon_parts)
    if parts:
        # Uniform across parts — every engine in a run shares the mode.
        out["redistribute_mode"] = parts[0].get("redistribute_mode",
                                                "finish")
    if profiles:
        # REPRO_PROFILE=1 phase counters: sum the absolute seconds
        # (including the per-engine walls); the artifact assembler
        # recomputes the share from the summed engine walls — the
        # parent's elapsed time is not a valid denominator when parts
        # ran concurrently in worker processes.
        agg = {k: float(sum(p[k] for p in profiles)) for k in profiles[0]
               if k != "redistribute_share_of_wall"}
        out["profile"] = agg
    return out


def _cell_label(scenario_name: str, cell: WorkloadCell,
                policy: str) -> str:
    """Deterministic filesystem-safe trace filename stem for one
    (cell, policy)."""
    blo, bhi = cell.budget_interval
    return (f"{scenario_name}__{cell.app}_r{cell.rate:g}"
            f"_b{blo:g}-{bhi:g}_s{cell.seed}__{policy}")


def _grid_batch(
    scenario: Scenario,
    cfg: PlatformConfig,
    batch: List[WorkloadCell],
    trace: bool,
    device: str,
    batched: object,
    redistribute: str = "finish",
    events: bool = False,
    trace_dir: Optional[str] = None,
    report_dir: Optional[str] = None,
    monitor: bool = False,
) -> Tuple[List[Dict], Dict]:
    """Simulate one batch of workload cells × all scenario policies.

    Self-contained and picklable-argument-only: this is both the serial
    loop body and the unit of work a ``--workers`` process executes
    (cells are regenerated in-worker from their deterministic seeds —
    nothing heavy crosses the process boundary; ``device`` crosses it as
    a string).  ``trace_dir`` implies
    ``events`` and writes one Perfetto trace + JSONL dump per
    (cell, policy) — workers write their own cells' files directly.
    ``report_dir`` implies the live monitor (which implies events) and
    writes one ``monitor.json`` + HTML dashboard per (cell, policy);
    ``monitor`` alone collects the monitor block without report files.
    """
    policies = [POLICY_BY_NAME[name] for name in scenario.policies]
    members: List[GridMember] = []
    labels: List[Tuple[WorkloadCell, str]] = []
    pre: List[Dict[int, float]] = []
    for cell in batch:
        wl = cell_workload(cfg, cell.app, cell.rate, cell.budget_interval,
                           cell.workload_seed, scenario.n_workflows,
                           scenario.sizes)
        protos = {}
        for pol in policies:
            if pol.budget_mode not in protos:
                protos[pol.budget_mode] = predistribute_workload(
                    cfg, wl, pol.budget_mode)
            proto, spares = protos[pol.budget_mode]
            members.append((pol, clone_workload(proto), cell.seed))
            labels.append((cell, pol.name))
            pre.append(spares)
    mon_on = bool(monitor or report_dir)
    engine = BatchSimEngine(cfg, members, trace=trace, predistributed=pre,
                            device=device, batched=batched,
                            redistribute=redistribute,
                            events=bool(events or trace_dir or mon_on),
                            monitor=mon_on or None)
    results = engine.run()
    rows: List[Dict] = []
    vm_type_names = [t.name for t in cfg.vm_types]
    for (cell, pol_name), res, st in zip(labels, results, engine.states):
        label = _cell_label(scenario.name, cell, pol_name)
        if trace_dir and st.elog is not None:
            obs_export.write_cell_trace(trace_dir, label, st.elog,
                                        vm_type_names=vm_type_names)
        if report_dir and st.monitor is not None:
            obs_report.write_cell_report(report_dir, label, st.monitor)
        m = CellMetrics.from_result(pol_name, res, st.trace_rows,
                                    monitor=st.monitor)
        rows.append({
            "app": cell.app,
            "rate_wf_per_min": cell.rate,
            "budget_lo": cell.budget_interval[0],
            "budget_hi": cell.budget_interval[1],
            "seed": cell.seed,
            **m.to_dict(),
        })
    return rows, engine.dispatch_stats()


def run_grid(
    scenario: Scenario,
    cfg: Optional[PlatformConfig] = None,
    cells_per_batch: int = 8,
    trace: bool = True,
    verbose: bool = False,
    workers: int = 1,
    device: Optional[str] = None,
    batched: object = "auto",
    redistribute: str = "finish",
    executor=None,
    events: bool = False,
    trace_dir: Optional[str] = None,
    report_dir: Optional[str] = None,
    monitor: bool = False,
) -> Dict:
    """Run the whole grid; returns the artifact payload.

    ``device``: where auction rounds are scored — ``None`` means
    ``"cuda"`` and raises when no CUDA device is available; ``"cpu"``
    runs the plain torch version.

    ``workers > 1`` fans the cell batches out to a process pool
    (spawn context — safe with an initialized CUDA context in the
    parent; each worker opens its own).  ``executor`` lets callers reuse
    a warm pool across runs (the grid-wall benchmark does); it must come
    from ``grid_executor(workers)``.

    ``events`` enables structured-event collection (the artifact's
    ``dispatch.events`` block); ``trace_dir`` additionally writes one
    Perfetto trace + JSONL event dump per (cell, policy) — see
    ``repro_torch.obs`` and docs/PROFILING.md.

    ``monitor`` enables the live SLO monitor (the artifact's
    ``dispatch.monitor`` block and per-cell alert tallies);
    ``report_dir`` additionally writes one ``monitor.json`` + HTML
    dashboard per (cell, policy) — see ``repro_torch.obs.monitor``.
    """
    cfg = cfg or PlatformConfig()
    device = str(resolve_device(device))
    wcells = list(scenario.workload_cells())
    t0 = time.perf_counter()

    if workers > 1 and len(wcells) > 1:
        # Small chunks load-balance heterogeneous cells across the pool.
        per = max(1, min(cells_per_batch,
                         math.ceil(len(wcells) / (workers * 2))))
    else:
        per = cells_per_batch
    batches = list(_chunked(wcells, per))

    parts: List[Tuple[List[Dict], Dict]] = []
    if workers > 1 and len(batches) > 1:
        own = executor is None
        ex = executor or grid_executor(workers)
        try:
            futs = [ex.submit(_grid_batch, scenario, cfg, b, trace,
                              device, batched, redistribute,
                              events, trace_dir, report_dir, monitor)
                    for b in batches]
            for i, f in enumerate(futs):
                parts.append(f.result())
                if verbose:
                    done = sum(len(p[0]) for p in parts)
                    print(f"  {done}/{scenario.n_cells} cells "
                          f"({time.perf_counter() - t0:.1f}s)")
        finally:
            if own:
                ex.shutdown()
    else:
        for batch in batches:
            parts.append(_grid_batch(scenario, cfg, batch, trace,
                                     device, batched, redistribute,
                                     events, trace_dir, report_dir,
                                     monitor))
            if verbose:
                done = sum(len(p[0]) for p in parts)
                print(f"  {done}/{scenario.n_cells} cells "
                      f"({time.perf_counter() - t0:.1f}s)")

    rows = [r for part_rows, _ in parts for r in part_rows]
    stats = _merge_stats([s for _, s in parts])
    return _artifact(scenario, rows, stats,
                     wall_s=time.perf_counter() - t0, workers=workers,
                     device=device, redistribute=redistribute)


def _artifact(scenario, rows: List[Dict], stats: Dict, wall_s: float,
              workers: int, device: str, **extra) -> Dict:
    """Assemble the ``BENCH_paper_grid.json``-schema payload (shared by
    the closed-grid and online harnesses).  The schema's ``use_pallas``
    key holds the device the run scored rounds on: a backend field, like
    ``wall_s``."""
    collected = [CellMetrics.from_dict(r) for r in rows]
    summary = aggregate_by_policy(collected)
    prof = stats.get("profile")
    if prof and prof.get("engine_wall_s"):
        prof["redistribute_share_of_wall"] = \
            prof["redistribute_s"] / prof["engine_wall_s"]
    ebpsm = summary.get("EBPSM", {})
    mslbl = summary.get("MSLBL_MW", {})
    # Data-integrity warnings ride the artifact so consumers see them
    # even when the run's stdout is long gone.  A ring-truncated event
    # log means every post-hoc time series derived from it is silently
    # wrong — say so loudly (main() prints these too).
    warnings: List[str] = []
    dropped = stats.get("events", {}).get("dropped", 0)
    if dropped > 0:
        warnings.append(
            f"event ring dropped {dropped} events — post-hoc time series "
            f"(fleet/queue/cost curves, Perfetto traces) are truncated; "
            f"raise the EventLog capacity or use the live monitor "
            f"(--report-dir), which folds events before overwrite")
    return {
        "bench": "paper_grid",
        "scenario": scenario.name,
        "description": scenario.description,
        "n_cells": scenario.n_cells,
        "n_workflows_per_cell": scenario.n_workflows,
        "ebpsm_budget_met_floor": scenario.ebpsm_budget_met_floor,
        "wall_s": wall_s,
        "workers": workers,
        "use_pallas": device,
        "dispatch": stats,
        "summary_by_policy": summary,
        "ebpsm_vs_mslbl_makespan_ratio": (
            ebpsm["mean_makespan_s"] / mslbl["mean_makespan_s"]
            if ebpsm.get("mean_makespan_s") and mslbl.get("mean_makespan_s")
            else None
        ),
        "cells": rows,
        "warnings": warnings,
        **extra,
    }


class _StreamCkpt:
    """``BatchSimEngine.run`` checkpoint hook: writes a
    ``ckpt.save_stream`` snapshot every ``every_s`` of wall clock
    (``every_s=0`` ⇒ every rendezvous round — the deterministic cadence
    the CI resume smoke interrupts on), carrying the harness's
    cross-seed progress (completed rows + dispatch stats) in the
    manifest meta so a resumed run reassembles the identical artifact.
    ``stop_after`` > 0 stops the stream after that many saves
    (:class:`StreamInterrupted`) — a deterministic, in-band "kill"."""

    def __init__(self, ckpt_dir: str, every_s: float, meta: Dict,
                 stop_after: Optional[int] = None):
        self.ckpt_dir = ckpt_dir
        self.every_s = every_s
        self.meta = meta
        self.stop_after = stop_after
        last = ckpt.latest_step(ckpt_dir)
        # Continue numbering past earlier segments' steps: a resumed
        # run must never rewrite a step the interrupt already wrote
        # (latest_step would go stale mid-stream otherwise).
        self.step = 0 if last is None else last + 1
        self.saved = 0
        self._last_t = time.monotonic()

    def __call__(self, engine: BatchSimEngine) -> bool:
        if time.monotonic() - self._last_t < self.every_s:
            return False
        ckpt.save_stream(self.ckpt_dir, self.step, engine.snapshot(),
                         meta=self.meta)
        self.step += 1
        self.saved += 1
        self._last_t = time.monotonic()
        return self.stop_after is not None and self.saved >= self.stop_after


def run_online(
    scenario: OnlineScenario,
    cfg: Optional[PlatformConfig] = None,
    trace: bool = True,
    verbose: bool = False,
    device: Optional[str] = None,
    batched: object = "auto",
    redistribute: str = "finish",
    ckpt_dir: Optional[str] = None,
    ckpt_every_s: Optional[float] = None,
    resume: bool = False,
    stop_after_ckpts: Optional[int] = None,
    events: bool = False,
    trace_dir: Optional[str] = None,
    report_dir: Optional[str] = None,
    monitor: bool = False,
) -> Dict:
    """Stream an :class:`OnlineScenario`'s tenant mix through the batched
    engine, one merged multi-tenant stream per seed × every policy.

    Every policy simulates a structural-sharing clone of the *same* merged
    stream (budget distribution predistributed once per budget mode), so
    policy comparisons stay paired; metrics truncate the warm-up window
    and carry the per-tenant extensions (slowdown percentiles, per-QoS
    budget-met, fleet size, Jain fairness).  Returns the same artifact
    schema as :func:`run_grid`; ``device`` as there.

    ``ckpt_dir`` + ``ckpt_every_s`` enable long-horizon checkpointing
    (see :class:`_StreamCkpt`); ``resume=True`` restores the latest
    snapshot in ``ckpt_dir`` — the stream continues bit-identically, so
    the final artifact's rows and dispatch stats match an uninterrupted
    run.  ``stop_after_ckpts`` raises :class:`StreamInterrupted` after
    that many saves (deterministic interruption for tests/CI).

    ``events`` enables structured-event collection; ``trace_dir``
    additionally writes one Perfetto trace + JSONL dump per
    (seed, policy), with task slices categorized by tenant and QoS.
    Event logs ride the stream snapshots, so a resumed run's traces are
    byte-identical with an uninterrupted one
    (tests/test_torch_ckpt_stream.py).

    ``monitor`` enables the live SLO monitor (one independent
    :class:`repro_torch.obs.monitor.Monitor` per (seed, policy) member, fed by
    tenant/QoS maps so per-QoS burn rates and slowdown SLIs resolve);
    ``report_dir`` additionally writes one ``monitor.json`` + HTML
    dashboard per (seed, policy) and implies ``monitor``.  Monitors ride
    the member event logs through stream snapshots, so a resumed run's
    alerts and windows are byte-identical with an uninterrupted one.
    """
    cfg = cfg or PlatformConfig()
    device = str(resolve_device(device))
    mon_on = bool(monitor or report_dir)
    t0 = time.perf_counter()
    warmup_ms = int(scenario.warmup_s * 1000)
    blo, bhi = scenario.mix.budget_span()
    policies = [POLICY_BY_NAME[name] for name in scenario.policies]
    rows: List[Dict] = []
    stats_parts: List[Dict] = []
    resume_snap = None
    start_seed_idx = 0
    if resume:
        if not ckpt_dir:
            raise SystemExit("--resume requires --ckpt-dir")
        resume_snap, step, meta = ckpt.restore_stream(ckpt_dir)
        if meta.get("scenario") != scenario.name:
            raise SystemExit(
                f"checkpoint in {ckpt_dir} is for scenario "
                f"{meta.get('scenario')!r}, not {scenario.name!r}")
        if meta.get("redistribute") != redistribute:
            raise SystemExit(
                f"checkpoint was written with "
                f"--redistribute {meta.get('redistribute')}, "
                f"this run uses {redistribute}")
        rows = list(meta.get("rows", []))
        stats_parts = list(meta.get("stats", []))
        start_seed_idx = int(meta.get("seed_index", 0))
        if verbose:
            print(f"  resuming {scenario.name} from step {step} "
                  f"(seed index {start_seed_idx}, "
                  f"{len(rows)} completed rows)")
    for seed_idx, seed in enumerate(scenario.seeds):
        if seed_idx < start_seed_idx:
            continue  # fully covered by the restored rows
        tw = scenario.mix.build(cfg, seed)
        ideal = tw.ideal_ms(cfg)
        protos = {}
        members: List[GridMember] = []
        labels: List[str] = []
        pre: List[Dict[int, float]] = []
        for pol in policies:
            if pol.budget_mode not in protos:
                protos[pol.budget_mode] = predistribute_workload(
                    cfg, tw.workflows, pol.budget_mode)
            proto, spares = protos[pol.budget_mode]
            members.append((pol, clone_workload(proto), seed))
            labels.append(pol.name)
            pre.append(spares)
        engine = BatchSimEngine(cfg, members, trace=trace,
                                predistributed=pre, device=device,
                                batched=batched, redistribute=redistribute,
                                events=bool(events or trace_dir or mon_on),
                                chaos=scenario.chaos,
                                monitor=mon_on or None,
                                monitor_maps=(tw.tenant_of, tw.qos_of,
                                              ideal))
        if resume_snap is not None:
            engine.load_snapshot(resume_snap)
            resume_snap = None
        hook = None
        if ckpt_dir and ckpt_every_s is not None:
            hook = _StreamCkpt(ckpt_dir, ckpt_every_s, meta={
                "scenario": scenario.name,
                "redistribute": redistribute,
                "seed": seed,
                "seed_index": seed_idx,
                "rows": rows,
                "stats": stats_parts,
            }, stop_after=stop_after_ckpts)
        results = engine.run(ckpt_hook=hook)
        for name, res, st in zip(labels, results, engine.states):
            if trace_dir and st.elog is not None:
                obs_export.write_cell_trace(
                    trace_dir, f"{scenario.name}__seed{seed}__{name}",
                    st.elog,
                    vm_type_names=[t.name for t in cfg.vm_types],
                    tenant_of=tw.tenant_of, qos_of=tw.qos_of)
            if report_dir and st.monitor is not None:
                obs_report.write_cell_report(
                    report_dir, f"{scenario.name}__seed{seed}__{name}",
                    st.monitor)
            m = CellMetrics.from_result(
                name, res, st.trace_rows, tenant_of=tw.tenant_of,
                qos_of=tw.qos_of, ideal_ms=ideal, warmup_ms=warmup_ms,
                monitor=st.monitor)
            rows.append({
                "app": "mixed",
                "rate_wf_per_min": round(
                    scenario.mix.mean_rate_per_min(), 3),
                "budget_lo": blo,
                "budget_hi": bhi,
                "seed": seed,
                **m.to_dict(),
            })
        stats_parts.append(engine.dispatch_stats())
        if verbose:
            print(f"  seed {seed}: {len(labels)} policies x "
                  f"{len(tw.workflows)} workflows "
                  f"({time.perf_counter() - t0:.1f}s)")
    return _artifact(
        scenario, rows, _merge_stats(stats_parts),
        wall_s=time.perf_counter() - t0, workers=1, device=device,
        redistribute=redistribute,
        scenario_kind="online",
        warmup_s=scenario.warmup_s,
        p95_slowdown_ceiling=scenario.p95_slowdown_ceiling,
        wasted_spend_ceiling=scenario.wasted_spend_ceiling,
        alert_floors=scenario.alert_floors,
        chaos=scenario.chaos.knobs() if scenario.chaos else None,
        tenants=[{
            "name": t.name,
            "qos": t.qos.name,
            "priority": t.qos.priority,
            "budget_interval": list(t.qos.budget_interval),
            "n_workflows": t.n_workflows,
            "apps": list(t.apps),
            "arrival": type(t.arrival).__name__ if t.arrival else "stream",
            "mean_rate_per_min": (t.arrival.mean_rate_per_min()
                                  if t.arrival else None),
        } for t in scenario.mix.tenants],
    )


def check_floors(art: Dict) -> List[str]:
    """CI gate: EBPSM budget-met floor per cell, the p95-slowdown and
    wasted-spend ceilings (online scenarios that record them), and the
    headline makespan win over MSLBL_MW (when both policies are in the
    grid)."""
    failures: List[str] = []
    floor = float(art.get("ebpsm_budget_met_floor", 0.0))
    ceiling = float(art.get("p95_slowdown_ceiling", 0.0))
    waste_ceiling = float(art.get("wasted_spend_ceiling", 0.0))
    for row in art["cells"]:
        if row["policy"] != "EBPSM":
            continue
        if ceiling > 0 and row.get("p95_slowdown", 0.0) > ceiling + 1e-9:
            failures.append(
                f"EBPSM p95 slowdown {row['p95_slowdown']:.2f} > ceiling "
                f"{ceiling:.2f} in cell app={row['app']} "
                f"rate={row['rate_wf_per_min']} seed={row['seed']}"
            )
        if waste_ceiling > 0 and row.get("wasted_spend_frac", 0.0) \
                > waste_ceiling + 1e-9:
            failures.append(
                f"EBPSM wasted-spend fraction "
                f"{row['wasted_spend_frac']:.2%} > ceiling "
                f"{waste_ceiling:.2%} in cell app={row['app']} "
                f"rate={row['rate_wf_per_min']} seed={row['seed']}"
            )
        if row.get("n_workflows", 1) == 0:
            # A cell whose workflows were all warm-up-excluded would pass
            # the floor vacuously (budget_met defaults to 1.0) — fail
            # loudly instead.
            failures.append(
                f"EBPSM cell has no post-warmup workflows (all "
                f"{row.get('n_warmup_excluded', 0)} excluded) in cell "
                f"app={row['app']} rate={row['rate_wf_per_min']} "
                f"seed={row['seed']}"
            )
            continue
        if row["budget_met"] < floor - 1e-9:
            failures.append(
                f"EBPSM budget-met {row['budget_met']:.2%} < floor "
                f"{floor:.2%} in cell app={row['app']} "
                f"rate={row['rate_wf_per_min']} "
                f"budget=[{row['budget_lo']},{row['budget_hi']}] "
                f"seed={row['seed']}"
            )
    ratio = art.get("ebpsm_vs_mslbl_makespan_ratio")
    if ratio is not None and ratio >= 1.0:
        failures.append(
            f"EBPSM mean makespan no longer beats MSLBL_MW "
            f"(ratio {ratio:.3f} >= 1)"
        )
    alert_floors = art.get("alert_floors") or {}
    if alert_floors:
        # Declared floors REQUIRE the live monitor: a run without it
        # would pass vacuously (zero alerts observed because none were
        # looked for), which is exactly the silent-regression mode this
        # gate exists to catch.
        mon = art.get("dispatch", {}).get("monitor", {})
        if not mon.get("enabled"):
            failures.append(
                "alert floors declared but monitoring disabled — run "
                "with --report-dir or REPRO_MONITOR=1 so the floors "
                "are actually evaluated")
        else:
            by_kind = mon.get("alerts_by_kind", {})
            for kind, floor_n in sorted(alert_floors.items()):
                got = int(by_kind.get(kind, 0))
                if got < int(floor_n):
                    failures.append(
                        f"alert floor: {got} {kind!r} alerts fired "
                        f"< floor {floor_n} — the chaos scenario no "
                        f"longer trips its detector")
    return failures


def write_report(art: Dict, path: str) -> None:
    lines = [
        f"# Paper grid — `{art['scenario']}`",
        "",
        art["description"],
        "",
        f"{art['n_cells']} cells, {art['n_workflows_per_cell']} workflows "
        f"per cell, wall {art['wall_s']:.1f}s.",
        "",
        "## Summary by policy",
        "",
        "| policy | mean makespan (s) | cost/budget | budget met "
        "(mean / min) | util | data hit | container hit |",
        "|---|---|---|---|---|---|---|",
    ]
    for pol, s in art["summary_by_policy"].items():
        lines.append(
            f"| {pol} | {s['mean_makespan_s']:.1f} "
            f"| {s['mean_cost_budget_ratio']:.3f} "
            f"| {s['budget_met_mean']:.1%} / {s['budget_met_min']:.1%} "
            f"| {s['utilization_mean']:.1%} "
            f"| {s['data_cache_hit_rate_mean']:.1%} "
            f"| {s['container_hit_rate_mean']:.1%} |"
        )
    ratio = art.get("ebpsm_vs_mslbl_makespan_ratio")
    if ratio is not None:
        lines += ["", f"EBPSM / MSLBL_MW mean-makespan ratio: "
                      f"**{ratio:.3f}** (< 1 means EBPSM wins)."]
    lines += [
        "",
        "## Per-cell mean makespan (s)",
        "",
        "| app | rate | budget | seed | " + " | ".join(
            p for p in sorted({r['policy'] for r in art['cells']})) + " |",
        "|---|---|---|---|" + "---|" * len(
            {r['policy'] for r in art['cells']}),
    ]
    by_cell: Dict[tuple, Dict[str, float]] = {}
    for r in art["cells"]:
        key = (r["app"], r["rate_wf_per_min"], r["budget_lo"],
               r["budget_hi"], r["seed"])
        by_cell.setdefault(key, {})[r["policy"]] = r["mean_makespan_s"]
    pols = sorted({r["policy"] for r in art["cells"]})
    for key, vals in sorted(by_cell.items()):
        app, rate, blo, bhi, seed = key
        cells = " | ".join(f"{vals.get(p, float('nan')):.1f}" for p in pols)
        lines.append(f"| {app} | {rate} | [{blo},{bhi}] | {seed} | {cells} |")
    lines += ["", "Metrics glossary: see README.md § Reproducing the paper.",
              ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", default="paper-smoke",
                    help="scenario name (see repro_torch.exp.scenarios)")
    ap.add_argument("--out", default="artifacts/exp")
    ap.add_argument("--cells-per-batch", type=int, default=8,
                    help="workload cells per batched engine run")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool width for cell batches (cells are "
                         "independent; the full paper grid parallelizes "
                         "across cores)")
    ap.add_argument("--redistribute", choices=("finish", "round"),
                    default="finish",
                    help="Algorithm-3 mode: per-task-finish (paper "
                         "semantics, default) or round-batched (one "
                         "pooled redistribution per workflow per "
                         "scheduling cycle; coalesces surplus flows, "
                         "A/B-gated — see docs/PROFILING.md)")
    ap.add_argument("--check-floors", action="store_true",
                    help="exit non-zero on budget-met floor / makespan-win "
                         "regressions")
    ap.add_argument("--ckpt-dir", default=None,
                    help="stream-checkpoint directory (online grids only): "
                         "with --ckpt-every-s, snapshots land here; with "
                         "--resume, the latest snapshot restores from here")
    ap.add_argument("--ckpt-every-s", type=float, default=None,
                    help="seconds of wall clock between stream snapshots "
                         "(0 = every rendezvous round — deterministic, "
                         "what the CI resume smoke uses)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the online stream from the latest "
                         "checkpoint in --ckpt-dir (bit-identical "
                         "continuation)")
    ap.add_argument("--stop-after-ckpts", type=int, default=None,
                    help="interrupt the stream after N checkpoint saves "
                         "(exit code 3) — deterministic interruption for "
                         "the CI resume smoke")
    ap.add_argument("--trace-dir", default=None,
                    help="write one Perfetto/Chrome-trace JSON + JSONL "
                         "event dump per (cell, policy) into this "
                         "directory (implies event collection; load in "
                         "ui.perfetto.dev — see docs/PROFILING.md)")
    ap.add_argument("--trace-events", action="store_true",
                    help="collect structured events without writing trace "
                         "files (the artifact's dispatch.events block; "
                         "REPRO_TRACE=1 is the env equivalent)")
    ap.add_argument("--report-dir", default=None,
                    help="write one monitor.json + self-contained HTML "
                         "dashboard per (cell, policy) into this directory "
                         "(implies the live SLO monitor and event "
                         "collection; REPRO_MONITOR=1 enables the monitor "
                         "without reports; validate with "
                         "tools/check_report.py)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where auction rounds are scored: the CUDA "
                         "affinity kernel (default; fails without a card) "
                         "or the plain torch version on the CPU")
    args = ap.parse_args(argv)

    scenario = get_scenario(args.grid)
    if isinstance(scenario, OnlineScenario):
        if args.workers > 1:
            print(f"note: --workers {args.workers} ignored — online grids "
                  f"run single-process (policies within a stream share "
                  f"one batched engine run)")
        print(f"online grid {scenario.name}: {scenario.n_cells} cells "
              f"({len(scenario.seeds)} seeds x "
              f"{len(scenario.policies)} policies, "
              f"{scenario.n_workflows} workflows/stream, "
              f"warm-up {scenario.warmup_s:.0f}s)")
        try:
            art = run_online(scenario, verbose=True,
                             redistribute=args.redistribute,
                             ckpt_dir=args.ckpt_dir,
                             ckpt_every_s=args.ckpt_every_s,
                             resume=args.resume,
                             stop_after_ckpts=args.stop_after_ckpts,
                             events=args.trace_events,
                             trace_dir=args.trace_dir,
                             report_dir=args.report_dir,
                             device=args.device)
        except StreamInterrupted as e:
            print(f"interrupted: {e} — resume with --resume "
                  f"--ckpt-dir {args.ckpt_dir}")
            raise SystemExit(3)
    else:
        if args.ckpt_dir or args.resume:
            raise SystemExit("--ckpt-dir/--resume are online-grid flags "
                             f"({scenario.name} is a closed grid)")
        print(f"grid {scenario.name}: {scenario.n_cells} cells "
              f"({scenario.n_workload_cells} workloads x "
              f"{len(scenario.policies)} policies)"
              + (f", {args.workers} workers" if args.workers > 1 else ""))
        art = run_grid(scenario, cells_per_batch=args.cells_per_batch,
                       verbose=True, workers=args.workers,
                       redistribute=args.redistribute,
                       events=args.trace_events, trace_dir=args.trace_dir,
                       report_dir=args.report_dir, device=args.device)
    if args.trace_dir:
        n_traces = len([f for f in os.listdir(args.trace_dir)
                        if f.endswith(".trace.json")])
        print(f"traces:   {args.trace_dir} ({n_traces} Perfetto traces; "
              f"validate with tools/check_trace.py)")
    if args.report_dir:
        n_dash = len([f for f in os.listdir(args.report_dir)
                      if f.endswith(".dashboard.html")])
        print(f"reports:  {args.report_dir} ({n_dash} dashboards; "
              f"validate with tools/check_report.py)")
    for w in art.get("warnings", []):
        print(f"WARNING: {w}")

    os.makedirs(args.out, exist_ok=True)
    jpath = os.path.join(args.out, ARTIFACT_NAME)
    with open(jpath, "w") as f:
        json.dump(art, f, indent=2, sort_keys=True)
        f.write("\n")
    mpath = os.path.join(args.out, REPORT_NAME)
    write_report(art, mpath)
    print(f"artifact: {jpath}\nreport:   {mpath}")
    for pol, s in art["summary_by_policy"].items():
        print(f"  {pol:10s} mk={s['mean_makespan_s']:8.1f}s "
              f"met={s['budget_met_mean']:6.1%} (min {s['budget_met_min']:6.1%}) "
              f"util={s['utilization_mean']:6.1%}")
    ratio = art.get("ebpsm_vs_mslbl_makespan_ratio")
    if ratio is not None:
        print(f"  EBPSM/MSLBL_MW makespan ratio: {ratio:.3f}")

    if args.check_floors:
        failures = check_floors(art)
        if failures:
            raise SystemExit("FLOOR FAILURES:\n  " + "\n  ".join(failures))
        print("floor gate OK")


if __name__ == "__main__":
    main()
