"""Time-series derivation over the structured event log (``repro_torch.obs``).

Everything here is a pure function of an :class:`~repro_torch.obs.events.EventLog`
(plus optional wid → tenant/QoS maps): fleet size, busy-VM count,
utilization, per-tenant ready-queue depth, cumulative cost vs cumulative
budget, and per-QoS running mean slowdown — each as a :class:`TimeSeries`
step function over the *simulated* clock, sampleable onto any grid with
:func:`sample`.

:func:`peak_and_mean` is the one shared lease-interval reconstruction:
``SimState.finalize`` reports ``peak_vms`` / ``mean_fleet_vms`` through
it (from the pool's lease intervals), and :func:`fleet_series` derives
the same step function from ``VM_PROVISION`` / ``VM_REAP`` events — so
the event log and the end-of-run aggregates can never disagree
(invariant-gated in ``tests/test_obs.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import events as ev_mod
from .events import EventLog


@dataclasses.dataclass
class TimeSeries:
    """Right-continuous step function: value is ``v[i]`` from ``t_ms[i]``
    until ``t_ms[i+1]`` (0 before the first step)."""

    name: str
    t_ms: np.ndarray    # int64, strictly increasing step times
    v: np.ndarray       # float64, value after each step

    def at(self, t: int) -> float:
        i = int(np.searchsorted(self.t_ms, t, side="right")) - 1
        return float(self.v[i]) if i >= 0 else 0.0

    def final(self) -> float:
        return float(self.v[-1]) if len(self.v) else 0.0

    def to_dict(self) -> Dict[str, list]:
        return {"name": self.name, "t_ms": self.t_ms.tolist(),
                "v": self.v.tolist()}


def step_series(name: str, times: Iterable[int],
                deltas: Iterable[float]) -> TimeSeries:
    """Build a step series from (time, delta) impulses: stable-sort by
    time, cumulative-sum, and coalesce impulses sharing a timestamp."""
    t = np.asarray(list(times), np.int64)
    d = np.asarray(list(deltas), np.float64)
    if len(t) == 0:
        return TimeSeries(name, np.zeros(0, np.int64), np.zeros(0))
    order = np.argsort(t, kind="stable")
    t = t[order]
    cum = np.cumsum(d[order])
    # Keep the last cumulative value at each distinct timestamp.
    last = np.append(t[1:] != t[:-1], True)
    return TimeSeries(name, t[last], cum[last])


def peak_and_mean(starts: Iterable[int],
                  ends: Iterable[int]) -> Tuple[int, float]:
    """(peak concurrency, time-weighted mean) of a set of half-open
    lease intervals — the single reconstruction behind
    ``SimResult.peak_vms`` / ``mean_fleet_vms`` *and* the event-derived
    :func:`fleet_series`.  An end tied with a start at the same
    millisecond releases before the start claims (the sort puts -1
    before +1), matching the pre-obs ``SimState._fleet_stats``."""
    deltas: List[Tuple[int, int]] = []
    horizon = 0
    for s, e in zip(starts, ends):
        deltas.append((int(s), 1))
        deltas.append((int(e), -1))
        horizon = max(horizon, int(e))
    if not deltas or horizon <= 0:
        return 0, 0.0
    deltas.sort()
    peak = cur = 0
    area = 0.0   # concurrency-ms integral
    prev = 0
    for t, d in deltas:
        area += cur * (t - prev)
        prev = t
        cur += d
        peak = max(peak, cur)
    return peak, area / horizon


def _kind_times(log: EventLog, kind: int) -> np.ndarray:
    idx = log._order()
    kinds = log.kind[idx]
    return log.t[idx][kinds == kind]


def fleet_series(log: EventLog) -> TimeSeries:
    """Live-VM count over time (``VM_PROVISION`` opens; ``VM_REAP`` or
    ``VM_REVOKE`` closes — a spot revocation terminates the lease just
    as a reap does, so chaos runs stay consistent with the pool's
    interval accounting)."""
    opens = _kind_times(log, ev_mod.VM_PROVISION)
    closes = np.concatenate([_kind_times(log, ev_mod.VM_REAP),
                             _kind_times(log, ev_mod.VM_REVOKE)])
    return step_series(
        "fleet",
        np.concatenate([opens, closes]),
        np.concatenate([np.ones(len(opens)), -np.ones(len(closes))]))


def busy_series(log: EventLog) -> TimeSeries:
    """Busy-VM count over time (one task pipeline occupies one VM:
    ``TASK_START`` claims; ``TASK_FINISH`` or ``TASK_FAIL`` releases,
    and a ``VM_REVOKE`` with the busy flag set releases the attempt it
    killed)."""
    starts = _kind_times(log, ev_mod.TASK_START)
    idx = log._order()
    kinds = log.kind[idx]
    revoked_busy = log.t[idx][(kinds == ev_mod.VM_REVOKE)
                              & (log.d[idx] == 1)]
    ends = np.concatenate([_kind_times(log, ev_mod.TASK_FINISH),
                           _kind_times(log, ev_mod.TASK_FAIL),
                           revoked_busy])
    return step_series(
        "busy",
        np.concatenate([starts, ends]),
        np.concatenate([np.ones(len(starts)), -np.ones(len(ends))]))


def utilization_series(log: EventLog) -> TimeSeries:
    """busy / fleet at every step of either series (0 when no fleet)."""
    fleet = fleet_series(log)
    busy = busy_series(log)
    t = np.union1d(fleet.t_ms, busy.t_ms).astype(np.int64)
    if len(t) == 0:
        return TimeSeries("utilization", t, np.zeros(0))
    f = sample(fleet, t)
    b = sample(busy, t)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.where(f > 0, b / np.maximum(f, 1e-12), 0.0)
    return TimeSeries("utilization", t, u)


def queue_depth_series(
    log: EventLog,
    tenant_of: Optional[Dict[int, str]] = None,
) -> Dict[str, TimeSeries]:
    """Ready-queue depth over time (``TASK_READY`` enqueues,
    ``TASK_PLACE`` drains), keyed by tenant when a wid → tenant map is
    given, else a single ``"all"`` series."""
    idx = log._order()
    kinds = log.kind[idx]
    t = log.t[idx]
    wid = log.a[idx]
    ready = kinds == ev_mod.TASK_READY
    placed = kinds == ev_mod.TASK_PLACE
    times = np.concatenate([t[ready], t[placed]])
    deltas = np.concatenate([np.ones(int(ready.sum())),
                             -np.ones(int(placed.sum()))])
    if tenant_of is None:
        return {"all": step_series("queue_depth", times, deltas)}
    wids = np.concatenate([wid[ready], wid[placed]])
    out: Dict[str, TimeSeries] = {}
    for name in sorted(set(tenant_of.values())):
        member = np.array([tenant_of.get(int(w)) == name for w in wids],
                          bool)
        out[name] = step_series(f"queue_depth/{name}",
                                times[member], deltas[member])
    return out


def cumulative_cost_series(log: EventLog) -> TimeSeries:
    """Cumulative actual cost billed: task finishes plus the sunk spend
    of failed attempts and revoked leases (chaos runs)."""
    idx = log._order()
    kinds = log.kind[idx]
    spend = ((kinds == ev_mod.TASK_FINISH) | (kinds == ev_mod.TASK_FAIL)
             | (kinds == ev_mod.VM_REVOKE))
    return step_series("cumulative_cost", log.t[idx][spend],
                       log.x[idx][spend])


def cumulative_budget_series(log: EventLog) -> TimeSeries:
    """Cumulative budget entering the system at workflow arrivals."""
    idx = log._order()
    arr = log.kind[idx] == ev_mod.WF_ARRIVE
    return step_series("cumulative_budget", log.t[idx][arr],
                       log.x[idx][arr])


def slowdown_series(
    log: EventLog,
    ideal_ms: Dict[int, int],
    qos_of_wid: Optional[Dict[int, str]] = None,
) -> Dict[str, TimeSeries]:
    """Running mean workflow slowdown ((finish − arrival) / ideal) at
    each ``WF_DONE``, keyed by QoS class when a wid → QoS map is given
    (else one ``"all"`` series).  Workflows without an ideal runtime are
    skipped."""
    idx = log._order()
    kinds = log.kind[idx]
    t = log.t[idx]
    wid = log.a[idx]
    arrival: Dict[int, int] = {}
    arr = kinds == ev_mod.WF_ARRIVE
    for w, ts in zip(wid[arr], t[arr]):
        arrival[int(w)] = int(ts)
    done = kinds == ev_mod.WF_DONE
    groups: Dict[str, List[Tuple[int, float]]] = {}
    for w, ts in zip(wid[done], t[done]):
        w = int(w)
        ideal = ideal_ms.get(w)
        if not ideal or w not in arrival:
            continue
        sd = (int(ts) - arrival[w]) / ideal
        key = qos_of_wid.get(w, "all") if qos_of_wid else "all"
        groups.setdefault(key, []).append((int(ts), sd))
    out: Dict[str, TimeSeries] = {}
    for key in sorted(groups):
        pts = groups[key]
        times = np.array([p[0] for p in pts], np.int64)
        means = np.cumsum([p[1] for p in pts]) / np.arange(1, len(pts) + 1)
        out[key] = TimeSeries(f"slowdown/{key}", times,
                              np.asarray(means, np.float64))
    return out


def sample(series: TimeSeries, t_grid: np.ndarray) -> np.ndarray:
    """Step-hold sample of a series at each grid time (0 before the
    first step)."""
    t_grid = np.asarray(t_grid, np.int64)
    if len(series.t_ms) == 0:
        return np.zeros(len(t_grid))
    pos = np.searchsorted(series.t_ms, t_grid, side="right") - 1
    vals = np.where(pos >= 0, series.v[np.maximum(pos, 0)], 0.0)
    return vals


def cell_summary(log: EventLog, n_samples: int = 64) -> Dict[str, object]:
    """Compact per-cell time-series digest (the shape
    ``waas.platform.PlatformReport.series`` carries): peak/mean fleet
    via the shared :func:`peak_and_mean` path plus each headline series
    sampled onto a uniform grid over the simulated horizon."""
    fleet = fleet_series(log)
    busy = busy_series(log)
    util = utilization_series(log)
    cost = cumulative_cost_series(log)
    budget = cumulative_budget_series(log)
    horizon = max([int(s.t_ms[-1]) for s in (fleet, busy, cost, budget)
                   if len(s.t_ms)], default=0)
    grid = np.linspace(0, horizon, n_samples).astype(np.int64) \
        if horizon > 0 else np.zeros(0, np.int64)
    opens = _kind_times(log, ev_mod.VM_PROVISION)
    closes = np.concatenate([_kind_times(log, ev_mod.VM_REAP),
                             _kind_times(log, ev_mod.VM_REVOKE)])
    peak, mean = peak_and_mean(opens.tolist(), closes.tolist())
    return {
        "peak_vms": peak,
        "mean_fleet_vms": mean,
        "horizon_ms": horizon,
        "t_ms": grid.tolist(),
        "series": {s.name: sample(s, grid).tolist()
                   for s in (fleet, busy, util, cost, budget)},
    }
