"""Live streaming monitor over the :class:`repro_torch.obs.events.EventLog`.

The :class:`Monitor` subscribes to the emit path (``elog.sub``) and
folds every event into rolling aggregates *as it happens* — no post-hoc
scan, O(1) amortized per event, zero-cost when disabled (the hot path
in ``events.append`` is a single ``sub is not None`` check, the same
discipline as ``elog=None`` itself).  State lives in flat numpy ring
buffers sampled on a fixed simulated-time grid:

* gauges per sample tick — fleet size, busy VMs, ready-queue depth
  (total and per QoS class);
* cumulative counters per tick — spend, wasted spend, distributed
  budget, arrivals (total and per QoS), completions, failures,
  revocations, straggler detections, retries, provisioning churn,
  placements;
* recent-completion and recent-placement rings feeding the per-QoS
  windowed SLIs (budget-met fraction, p95 slowdown, p95 queue wait).

On each tick the :mod:`repro_torch.obs.slo` engine evaluates multi-window
burn rates and threshold+MAD anomaly detectors, appending typed
:class:`~repro_torch.obs.slo.Alert` records with fire/clear timestamps.

Determinism: sample ticks advance *before* the incoming event is
applied, so a tick at boundary ``B`` always records the state produced
by events with ``t < B`` — the sampled series depend only on the
(engine-invariant) per-member event stream, never on wall clock.  The
monitor rides stream snapshots for free: it is reachable from the
pickled ``elog`` residue (``elog.sub``), so interrupt/resume replays
windows and alerts bit-identically.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import slo as obs_slo
from .events import (STRAGGLER_DETECT, TASK_FAIL, TASK_FINISH, TASK_PLACE,
                     TASK_READY, TASK_RETRY, TASK_START, VM_PROVISION,
                     VM_REAP, VM_REVOKE, WF_ARRIVE, WF_DONE)

#: Names of the per-tick sampled series, in export order.  Gauges are
#: instantaneous; ``cum_*`` series are cumulative counters (windowed
#: rates are deltas of these).
SERIES_NAMES: Tuple[str, ...] = (
    "fleet", "busy", "queue",
    "cum_cost", "cum_wasted", "cum_budget",
    "cum_arrivals", "cum_completions", "cum_failures", "cum_revocations",
    "cum_stragglers", "cum_retries", "cum_churn", "cum_placements",
)


def _monitor_enabled() -> bool:
    """``REPRO_MONITOR=1`` turns the live monitor on globally (same
    contract as ``REPRO_TRACE`` for the event log)."""
    return os.environ.get("REPRO_MONITOR", "") == "1"


def resolve_monitor(monitor) -> Optional["Monitor"]:
    """Normalize an engine ``monitor=`` argument: a :class:`Monitor`
    passes through, ``True`` builds a default one, ``None`` defers to
    the ``REPRO_MONITOR=1`` environment opt-in, falsy disables."""
    if isinstance(monitor, Monitor):
        return monitor
    if monitor is None:
        return Monitor() if _monitor_enabled() else None
    return Monitor() if monitor else None


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Knobs for the streaming monitor.  Everything is in simulated
    milliseconds; all thresholds are evaluated on the sample grid, so
    the whole configuration is deterministic in (seed, config)."""

    sample_ms: int = 5_000            # tick grid for the sampled series
    short_window_ms: int = 60_000     # fast burn window
    long_window_ms: int = 300_000     # sustained burn window
    sample_capacity: int = 4096       # ring capacity, sample ticks
    completion_capacity: int = 8192   # ring capacity, WF_DONE records
    placement_capacity: int = 16384   # ring capacity, TASK_PLACE records
    # SLO burn-rate gating (multi-window: short>=fire AND long>=fire*
    # long_factor opens; short<clear closes).
    burn_fire: float = 2.0
    burn_clear: float = 1.0
    long_factor: float = 0.5
    min_window_completions: int = 5
    min_window_placements: int = 5
    # Anomaly detectors.
    mad_k: float = 6.0
    mad_window: int = 64              # ticks of history for MAD rules
    mad_min_samples: int = 12
    waste_frac_fire: float = 0.04     # budget_burn: windowed wasted/spend
    waste_frac_clear: float = 0.01
    min_window_spend: float = 1e-9
    straggler_fire: int = 3           # straggler_spike: short-window count
    straggler_clear: int = 1
    fleet_thrash_min: float = 6.0     # churn/tick floor under the MAD rule
    queue_buildup_min: float = 12.0   # depth-over-median floor (MAD rule)
    # Per-QoS SLO targets; ``None`` = :data:`repro_torch.obs.slo.DEFAULT_TARGETS`.
    targets: Optional[Dict[str, obs_slo.SLOTarget]] = None


class Monitor:
    """Streaming monitor instance — attach as ``elog.sub`` (the engines
    do this when constructed with ``monitor=``).

    ``tenant_of`` (wid → tenant), ``qos_of`` (tenant → QoS class) and
    ``ideal_ms`` (wid → critical-path lower bound) switch on the per-QoS
    breakdown and the slowdown SLI; without maps every workflow lands in
    a single ``"all"`` class and slowdown alerts stay dormant.
    """

    def __init__(self, cfg: Optional[MonitorConfig] = None,
                 tenant_of: Optional[Dict[int, str]] = None,
                 qos_of: Optional[Dict[str, str]] = None,
                 ideal_ms: Optional[Dict[int, int]] = None):
        self.cfg = cfg or MonitorConfig()
        if qos_of:
            self.qos_names: Tuple[str, ...] = tuple(sorted(set(
                qos_of.values())))
        else:
            self.qos_names = ("all",)
        qidx = {name: i for i, name in enumerate(self.qos_names)}
        # wid → QoS index, precomputed once (hot path does one dict get).
        self._wid_q: Dict[int, int] = {}
        if tenant_of:
            for wid, ten in tenant_of.items():
                self._wid_q[wid] = qidx.get(
                    (qos_of or {}).get(ten, self.qos_names[0]), 0)
        self._ideal = dict(ideal_ms) if ideal_ms else None
        nq = len(self.qos_names)
        c = self.cfg
        cap = c.sample_capacity
        self.samp_t = np.zeros(cap, np.int64)
        self.s_gauges = np.zeros((cap, 3), np.int64)      # fleet busy queue
        self.s_qqueue = np.zeros((cap, nq), np.int64)     # queue per QoS
        self.s_qarr = np.zeros((cap, nq), np.int64)       # cum arrivals/QoS
        self.s_cum = np.zeros((cap, len(SERIES_NAMES) - 3), np.float64)
        self.comp_t = np.zeros(c.completion_capacity, np.int64)
        self.comp_q = np.zeros(c.completion_capacity, np.int8)
        self.comp_met = np.zeros(c.completion_capacity, np.int8)
        self.comp_slow = np.zeros(c.completion_capacity, np.float64)
        self.comp_total = 0
        self.pl_t = np.zeros(c.placement_capacity, np.int64)
        self.pl_q = np.zeros(c.placement_capacity, np.int8)
        self.pl_wait = np.zeros(c.placement_capacity, np.int64)
        self.pl_total = 0
        # Live gauges / counters (plain scalars on the hot path).
        self.fleet = 0
        self.busy = 0
        self.queue = 0
        self.qqueue = [0] * nq
        self.qarr = [0] * nq
        self.cost = 0.0
        self.wasted = 0.0
        self.budget = 0.0
        self.arrivals = 0
        self.completions = 0
        self.failures = 0
        self.revocations = 0
        self.stragglers = 0
        self.retries = 0
        self.churn = 0
        self.placements = 0
        self.events_seen = 0
        self._ready_at: Dict[Tuple[int, int], int] = {}
        self._arrive_at: Dict[int, int] = {}
        self.ticks = 0
        self.next_tick_ms = c.sample_ms
        self.finalized_ms = -1
        self.alerts: List[obs_slo.Alert] = []
        # Gates in a fixed order (platform detectors, then per-QoS SLO
        # gates in sorted class order) so same-tick alerts serialize
        # identically everywhere.
        self._g_burn = obs_slo.AlertGate(obs_slo.ALERT_BUDGET_BURN,
                                         "platform")
        self._g_thrash = obs_slo.AlertGate(obs_slo.ALERT_FLEET_THRASH,
                                           "platform")
        self._g_strag = obs_slo.AlertGate(obs_slo.ALERT_STRAGGLER_SPIKE,
                                          "platform")
        self._g_queue = obs_slo.AlertGate(obs_slo.ALERT_QUEUE_BUILDUP,
                                          "platform")
        self._g_slo: Dict[Tuple[int, str], obs_slo.AlertGate] = {}
        for q in self.qos_names:
            for kind in (obs_slo.ALERT_SLO_BUDGET, obs_slo.ALERT_SLO_SLOWDOWN,
                         obs_slo.ALERT_SLO_QUEUE_WAIT):
                self._g_slo[(kind, q)] = obs_slo.AlertGate(kind, q)

    # ---- hot path ----------------------------------------------------------
    def on_event(self, kind: int, t: int, a: int, b: int, c: int, d: int,
                 x: float, y: float) -> None:
        """Fold one event (called from ``EventLog.append``).  Ticks are
        flushed *before* the event is applied — see the module note."""
        while t >= self.next_tick_ms:
            self._tick(self.next_tick_ms)
            self.next_tick_ms += self.cfg.sample_ms
        self.events_seen += 1
        if kind == TASK_READY:
            self.queue += 1
            qi = self._wid_q.get(a, 0)
            self.qqueue[qi] += 1
            self._ready_at[(a, b)] = t
        elif kind == TASK_PLACE:
            self.queue -= 1
            qi = self._wid_q.get(a, 0)
            self.qqueue[qi] -= 1
            ready = self._ready_at.pop((a, b), t)
            self.placements += 1
            j = self.pl_total % self.cfg.placement_capacity
            self.pl_t[j] = t
            self.pl_q[j] = qi
            self.pl_wait[j] = t - ready
            self.pl_total += 1
        elif kind == TASK_START:
            self.busy += 1
        elif kind == TASK_FINISH:
            self.busy -= 1
            self.cost += x
        elif kind == TASK_FAIL:
            self.busy -= 1
            self.cost += x
            self.wasted += x
            self.failures += 1
        elif kind == TASK_RETRY:
            self.retries += 1
            self.queue += 1
            qi = self._wid_q.get(a, 0)
            self.qqueue[qi] += 1
            self._ready_at[(a, b)] = t
        elif kind == WF_ARRIVE:
            self.arrivals += 1
            self.budget += x
            self.qarr[self._wid_q.get(a, 0)] += 1
            self._arrive_at[a] = t
        elif kind == WF_DONE:
            self.completions += 1
            qi = self._wid_q.get(a, 0)
            ideal = self._ideal.get(a, 0) if self._ideal else 0
            arrive = self._arrive_at.pop(a, t)
            j = self.comp_total % self.cfg.completion_capacity
            self.comp_t[j] = t
            self.comp_q[j] = qi
            self.comp_met[j] = 1 if x <= y + 1e-9 else 0
            self.comp_slow[j] = ((t - arrive) / ideal if ideal > 0
                                 else float("nan"))
            self.comp_total += 1
        elif kind == VM_PROVISION:
            self.fleet += 1
            self.churn += 1
        elif kind == VM_REAP:
            self.fleet -= 1
            self.churn += 1
        elif kind == VM_REVOKE:
            self.fleet -= 1
            self.churn += 1
            self.busy -= d
            self.cost += x
            self.wasted += x
            self.revocations += 1
        elif kind == STRAGGLER_DETECT:
            self.stragglers += 1
        # Other kinds (BUDGET_*, VM_BUSY/IDLE/CONTAINER, GRID_*) carry no
        # monitored state but still count toward events_seen.

    # ---- sampling ----------------------------------------------------------
    def _tick(self, t: int) -> None:
        """Record one sample at boundary ``t`` and evaluate alerts."""
        cap = self.cfg.sample_capacity
        j = self.ticks % cap
        self.samp_t[j] = t
        self.s_gauges[j, 0] = self.fleet
        self.s_gauges[j, 1] = self.busy
        self.s_gauges[j, 2] = self.queue
        self.s_qqueue[j] = self.qqueue
        self.s_qarr[j] = self.qarr
        self.s_cum[j] = (self.cost, self.wasted, self.budget,
                         self.arrivals, self.completions, self.failures,
                         self.revocations, self.stragglers, self.retries,
                         self.churn, self.placements)
        self.ticks += 1
        self._evaluate(t)

    def _cum_delta(self, col: int, w_ticks: int) -> float:
        """Windowed delta of cumulative column ``col`` at the latest
        tick: value now minus value ``w_ticks`` ticks ago (0 before the
        stream started)."""
        cap = self.cfg.sample_capacity
        i = self.ticks - 1
        cur = float(self.s_cum[i % cap, col])
        k = i - w_ticks
        if k < 0:
            return cur
        if i - k >= cap:        # ring forgot it; clamp to oldest retained
            k = i - cap + 1
        return cur - float(self.s_cum[k % cap, col])

    def _tick_deltas(self, col: int) -> np.ndarray:
        """Per-tick deltas of cumulative column ``col`` over the MAD
        history window, oldest→newest, excluding the current tick."""
        cap = self.cfg.sample_capacity
        i = self.ticks - 1
        lo = max(i - self.cfg.mad_window, i - cap + 1, 0)
        idx = np.arange(lo, i + 1) % cap
        return np.diff(self.s_cum[idx, col])[:-1] if i - lo >= 2 \
            else np.zeros(0, np.float64)

    def _gauge_history(self, col: int) -> np.ndarray:
        """Sampled gauge history over the MAD window, excluding now."""
        cap = self.cfg.sample_capacity
        i = self.ticks - 1
        lo = max(i - self.cfg.mad_window, i - cap + 1, 0)
        idx = np.arange(lo, i) % cap
        return self.s_gauges[idx, col].astype(np.float64)

    # ---- alert evaluation --------------------------------------------------
    def _evaluate(self, t: int) -> None:
        cfg = self.cfg
        ws = max(1, cfg.short_window_ms // cfg.sample_ms)
        wl = max(1, cfg.long_window_ms // cfg.sample_ms)
        al = self.alerts
        # budget_burn: windowed wasted-spend fraction over both windows.
        spend_s = self._cum_delta(0, ws)
        spend_l = self._cum_delta(0, wl)
        frac_s = (self._cum_delta(1, ws) / spend_s
                  if spend_s > cfg.min_window_spend else 0.0)
        frac_l = (self._cum_delta(1, wl) / spend_l
                  if spend_l > cfg.min_window_spend else 0.0)
        self._g_burn.step(
            al, t,
            fire=(frac_s >= cfg.waste_frac_fire
                  and frac_l >= cfg.waste_frac_fire * cfg.long_factor),
            clear=frac_s < cfg.waste_frac_clear,
            value=frac_s, threshold=cfg.waste_frac_fire)
        # straggler_spike: short-window detection count over threshold.
        n_strag = self._cum_delta(7, ws)
        self._g_strag.step(
            al, t,
            fire=n_strag >= cfg.straggler_fire,
            clear=n_strag <= cfg.straggler_clear,
            value=n_strag, threshold=float(cfg.straggler_fire))
        # fleet_thrash: this tick's provisioning churn vs MAD history.
        churn_hist = self._tick_deltas(9)
        churn_now = (self._cum_delta(9, 1) if self.ticks > 1
                     else float(self.s_cum[(self.ticks - 1)
                                           % cfg.sample_capacity, 9]))
        thrash = obs_slo.mad_fire(churn_hist, churn_now, cfg.mad_k,
                                  cfg.fleet_thrash_min, cfg.mad_min_samples)
        self._g_thrash.step(al, t, fire=thrash, clear=not thrash,
                            value=churn_now, threshold=cfg.fleet_thrash_min)
        # queue_buildup: queue depth now vs MAD over its sampled history.
        q_hist = self._gauge_history(2)
        q_now = float(self.queue)
        build = obs_slo.mad_fire(q_hist, q_now, cfg.mad_k,
                                 cfg.queue_buildup_min, cfg.mad_min_samples)
        self._g_queue.step(al, t, fire=build, clear=not build,
                           value=q_now, threshold=cfg.queue_buildup_min)
        # Per-QoS SLO burn rates from the completion/placement rings.
        n = min(self.comp_total, cfg.completion_capacity)
        if n:
            ct = self.comp_t[:n]
            in_s = (ct >= t - cfg.short_window_ms) & (ct < t)
            in_l = (ct >= t - cfg.long_window_ms) & (ct < t)
        m = min(self.pl_total, cfg.placement_capacity)
        if m:
            pt = self.pl_t[:m]
            pin_s = (pt >= t - cfg.short_window_ms) & (pt < t)
            pin_l = (pt >= t - cfg.long_window_ms) & (pt < t)
        for qi, qname in enumerate(self.qos_names):
            tgt = obs_slo.target_for(qname, cfg.targets)
            if n:
                qs = in_s & (self.comp_q[:n] == qi)
                ql = in_l & (self.comp_q[:n] == qi)
                ns, nl = int(qs.sum()), int(ql.sum())
                if min(ns, nl) >= cfg.min_window_completions:
                    burn_s = obs_slo.burn_rate(
                        float(self.comp_met[:n][qs].mean()), tgt.budget_met)
                    burn_l = obs_slo.burn_rate(
                        float(self.comp_met[:n][ql].mean()), tgt.budget_met)
                    self._g_slo[(obs_slo.ALERT_SLO_BUDGET, qname)].step(
                        al, t,
                        fire=(burn_s >= cfg.burn_fire
                              and burn_l >= cfg.burn_fire * cfg.long_factor),
                        clear=burn_s < cfg.burn_clear,
                        value=burn_s, threshold=cfg.burn_fire)
                    slow_s = self.comp_slow[:n][qs]
                    slow_l = self.comp_slow[:n][ql]
                    if (not np.isnan(slow_s).any()
                            and not np.isnan(slow_l).any()):
                        v_s = float(np.percentile(slow_s, 95))
                        v_l = float(np.percentile(slow_l, 95))
                        r_s = v_s / tgt.p95_slowdown
                        self._g_slo[(obs_slo.ALERT_SLO_SLOWDOWN,
                                     qname)].step(
                            al, t,
                            fire=(r_s >= 1.0
                                  and v_l / tgt.p95_slowdown
                                  >= cfg.long_factor),
                            clear=r_s < 1.0,
                            value=v_s, threshold=tgt.p95_slowdown)
            if m:
                qs = pin_s & (self.pl_q[:m] == qi)
                ql = pin_l & (self.pl_q[:m] == qi)
                if (min(int(qs.sum()), int(ql.sum()))
                        >= cfg.min_window_placements):
                    w_s = float(np.percentile(self.pl_wait[:m][qs], 95))
                    w_l = float(np.percentile(self.pl_wait[:m][ql], 95))
                    r_s = w_s / tgt.queue_wait_ms
                    self._g_slo[(obs_slo.ALERT_SLO_QUEUE_WAIT, qname)].step(
                        al, t,
                        fire=(r_s >= 1.0
                              and w_l / tgt.queue_wait_ms >= cfg.long_factor),
                        clear=r_s < 1.0,
                        value=w_s, threshold=float(tgt.queue_wait_ms))

    # ---- lifecycle ---------------------------------------------------------
    def finalize(self, now_ms: int) -> None:
        """Flush remaining sample boundaries up to ``now_ms`` and record
        one final sample at the horizon (post-reap state).  Alerts still
        open keep ``cleared_ms = -1``.  Idempotent per horizon."""
        if self.finalized_ms == now_ms:
            return
        while self.next_tick_ms <= now_ms:
            self._tick(self.next_tick_ms)
            self.next_tick_ms += self.cfg.sample_ms
        cap = self.cfg.sample_capacity
        last = int(self.samp_t[(self.ticks - 1) % cap]) if self.ticks else -1
        if last != now_ms:
            self._tick(now_ms)
        self.finalized_ms = now_ms

    # ---- export helpers ----------------------------------------------------
    def sample_order(self) -> np.ndarray:
        """Chronological ring indices of the retained samples."""
        cap = self.cfg.sample_capacity
        if self.ticks <= cap:
            return np.arange(self.ticks)
        start = self.ticks % cap
        return np.concatenate([np.arange(start, cap), np.arange(start)])

    def series(self) -> Dict[str, np.ndarray]:
        """Retained sampled series by name (chronological)."""
        o = self.sample_order()
        out: Dict[str, np.ndarray] = {"t_ms": self.samp_t[o]}
        for k, name in enumerate(("fleet", "busy", "queue")):
            out[name] = self.s_gauges[o, k]
        for k, name in enumerate(SERIES_NAMES[3:]):
            out[name] = self.s_cum[o, k]
        for qi, qname in enumerate(self.qos_names):
            out[f"queue[{qname}]"] = self.s_qqueue[o, qi]
            out[f"cum_arrivals[{qname}]"] = self.s_qarr[o, qi]
        return out

    def alerts_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for a in self.alerts:
            name = obs_slo.ALERT_KIND_NAMES.get(a.kind, str(a.kind))
            out[name] = out.get(name, 0) + 1
        return dict(sorted(out.items()))

    def slo_table(self) -> Dict[str, Dict[str, object]]:
        """Whole-run per-QoS SLI summary (over the retained completion /
        placement rings) for the dashboard SLO table."""
        cfg = self.cfg
        out: Dict[str, Dict[str, object]] = {}
        n = min(self.comp_total, cfg.completion_capacity)
        m = min(self.pl_total, cfg.placement_capacity)
        for qi, qname in enumerate(self.qos_names):
            tgt = obs_slo.target_for(qname, cfg.targets)
            row: Dict[str, object] = {
                "target_budget_met": tgt.budget_met,
                "target_p95_slowdown": tgt.p95_slowdown,
                "target_queue_wait_ms": int(tgt.queue_wait_ms),
                "n_completions": 0, "budget_met": 1.0,
                "p95_slowdown": 0.0, "p95_queue_wait_ms": 0.0,
            }
            if n:
                sel = self.comp_q[:n] == qi
                k = int(sel.sum())
                row["n_completions"] = k
                if k:
                    row["budget_met"] = float(self.comp_met[:n][sel].mean())
                    slow = self.comp_slow[:n][sel]
                    if not np.isnan(slow).any():
                        row["p95_slowdown"] = float(np.percentile(slow, 95))
            if m:
                sel = self.pl_q[:m] == qi
                if sel.any():
                    row["p95_queue_wait_ms"] = float(
                        np.percentile(self.pl_wait[:m][sel], 95))
            row["alerts_open"] = sum(
                1 for a in self.alerts if a.scope == qname and a.open)
            out[qname] = row
        return out


def monitor_block(monitors: Sequence[Optional[Monitor]]) -> Dict[str, object]:
    """The ``dispatch_stats()["monitor"]`` block, merged over grid
    members.  Integer-only by design: ``repro.exp.run._merge_stats``
    sums these across worker chunks, and integer sums are exact and
    chunking-order-independent — serial and ``--workers`` artifacts gate
    on byte-identical merged blocks."""
    live = [m for m in monitors if m is not None]
    by_kind: Dict[str, int] = {}
    for m in live:
        for name, k in m.alerts_by_kind().items():
            by_kind[name] = by_kind.get(name, 0) + k
    return {
        "enabled": bool(live),
        "members": len(live),
        "samples": int(sum(m.ticks for m in live)),
        "events": int(sum(m.events_seen for m in live)),
        "completions": int(sum(m.completions for m in live)),
        "alerts_total": int(sum(len(m.alerts) for m in live)),
        "alerts_open": int(sum(1 for m in live
                               for a in m.alerts if a.open)),
        "alerts_by_kind": dict(sorted(by_kind.items())),
    }


def merge_monitor_blocks(blocks: Sequence[Dict]) -> Dict[str, object]:
    """Sum monitor blocks across worker chunks (exp harness)."""
    out: Dict[str, object] = {
        "enabled": any(b.get("enabled") for b in blocks),
        "members": 0, "samples": 0, "events": 0, "completions": 0,
        "alerts_total": 0, "alerts_open": 0,
    }
    by_kind: Dict[str, int] = {}
    for b in blocks:
        for key in ("members", "samples", "events", "completions",
                    "alerts_total", "alerts_open"):
            out[key] += int(b.get(key, 0))
        for name, k in b.get("alerts_by_kind", {}).items():
            by_kind[name] = by_kind.get(name, 0) + int(k)
    out["alerts_by_kind"] = dict(sorted(by_kind.items()))
    return out
