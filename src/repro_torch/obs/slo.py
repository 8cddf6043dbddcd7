"""SLO targets, burn-rate algebra and typed alert records (``repro_torch.obs``).

The live monitor (:mod:`repro_torch.obs.monitor`) evaluates two alert families
over its rolling windows:

* **SLO burn rates** — per-QoS service objectives (budget-met fraction,
  p95 workflow slowdown, p95 queue wait) expressed as *error-budget burn
  rates*: ``burn = (1 - SLI) / (1 - target)``.  Burn 1.0 means the class
  is consuming its error budget exactly as fast as the target allows;
  an alert fires when the short **and** long windows both burn too fast
  (the SRE multi-window rule — short catches the spike, long confirms
  it is sustained) and clears when the short window recovers.
* **Anomaly detectors** — platform-scope threshold + MAD (median
  absolute deviation) rules over the windowed deltas: wasted-spend burn
  (``budget_burn``), straggler-rate spike, fleet provisioning thrash and
  ready-queue buildup.

Everything here is pure and deterministic: alerts are typed records with
fire/clear timestamps on the *simulated* clock, so the same (seed,
config) produces byte-identical alert streams on every engine and across
checkpoint/resume (gated in ``tests/test_monitor.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# ---- alert kinds -----------------------------------------------------------
# SLO burn-rate alerts (scoped per QoS class):
ALERT_SLO_BUDGET = 1        # windowed budget-met fraction burning too fast
ALERT_SLO_SLOWDOWN = 2      # windowed p95 workflow slowdown over ceiling
ALERT_SLO_QUEUE_WAIT = 3    # windowed p95 queue wait over target
# Anomaly detectors (scope "platform"):
ALERT_BUDGET_BURN = 4       # windowed wasted-spend fraction (chaos burn)
ALERT_FLEET_THRASH = 5      # provisioning churn spike (MAD over ticks)
ALERT_STRAGGLER_SPIKE = 6   # straggler-detection rate spike
ALERT_QUEUE_BUILDUP = 7     # ready-queue depth anomaly (MAD over samples)

ALERT_KIND_NAMES: Dict[int, str] = {
    ALERT_SLO_BUDGET: "slo_budget_met",
    ALERT_SLO_SLOWDOWN: "slo_p95_slowdown",
    ALERT_SLO_QUEUE_WAIT: "slo_queue_wait",
    ALERT_BUDGET_BURN: "budget_burn",
    ALERT_FLEET_THRASH: "fleet_thrash",
    ALERT_STRAGGLER_SPIKE: "straggler_spike",
    ALERT_QUEUE_BUILDUP: "queue_buildup",
}


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Per-QoS service objectives the monitor burns against."""

    budget_met: float = 0.80        # target fraction of workflows in budget
    p95_slowdown: float = 16.0      # ceiling on windowed p95 slowdown
    queue_wait_ms: int = 240_000    # ceiling on windowed p95 queue wait


# Defaults keyed by the repo's QoS class names (repro.tenants GOLD /
# SILVER / BRONZE); "all" covers runs without tenant maps.  Tighter
# classes pay for tighter budget draws with tighter objectives.
DEFAULT_TARGETS: Dict[str, SLOTarget] = {
    "gold": SLOTarget(budget_met=0.90, p95_slowdown=8.0,
                      queue_wait_ms=60_000),
    "silver": SLOTarget(budget_met=0.85, p95_slowdown=12.0,
                        queue_wait_ms=120_000),
    "bronze": SLOTarget(budget_met=0.80, p95_slowdown=16.0,
                        queue_wait_ms=240_000),
    "all": SLOTarget(),
}


def target_for(qos: str,
               targets: Optional[Dict[str, SLOTarget]] = None) -> SLOTarget:
    """The SLO target for a QoS class (falls back to ``"all"``)."""
    table = targets if targets is not None else DEFAULT_TARGETS
    return table.get(qos) or table.get("all") or SLOTarget()


def burn_rate(sli: float, target: float) -> float:
    """Error-budget burn rate of an SLI against its target fraction:
    ``(1 - sli) / (1 - target)`` — 0 when the SLI is perfect, 1 when it
    sits exactly at target, >1 when the error budget is burning faster
    than the objective allows.  A degenerate target of 1.0 burns at the
    raw error fraction scaled by 1e3 (never divides by zero)."""
    err_budget = 1.0 - target
    if err_budget <= 0.0:
        return (1.0 - sli) * 1e3
    return max(0.0, 1.0 - sli) / err_budget


def mad_fire(history: np.ndarray, current: float, k: float,
             min_abs: float, min_samples: int) -> bool:
    """Threshold + MAD anomaly rule: ``current`` is anomalous when it
    exceeds ``median(history) + max(k * MAD(history), min_abs)``.  The
    absolute floor ``min_abs`` keeps all-quiet histories (MAD = 0) from
    flagging every nonzero tick; fewer than ``min_samples`` history
    points never fire."""
    if len(history) < min_samples:
        return False
    med = float(np.median(history))
    mad = float(np.median(np.abs(history - med)))
    return current > med + max(k * mad, min_abs)


@dataclasses.dataclass
class Alert:
    """One fired alert: typed kind, QoS scope (or ``"platform"``),
    fire/clear timestamps on the simulated clock (``cleared_ms = -1``
    while open), the value that tripped the rule and its threshold."""

    kind: int
    scope: str
    fired_ms: int
    value: float
    threshold: float
    cleared_ms: int = -1

    @property
    def open(self) -> bool:
        return self.cleared_ms < 0

    def to_dict(self) -> Dict[str, object]:
        return {
            "kind": ALERT_KIND_NAMES.get(self.kind, str(self.kind)),
            "scope": self.scope,
            "fired_ms": int(self.fired_ms),
            "cleared_ms": int(self.cleared_ms),
            "value": float(self.value),
            "threshold": float(self.threshold),
        }


class AlertGate:
    """Hysteresis per (kind, scope): holds the open alert's index into
    the shared alert list; :meth:`step` opens on the fire condition and
    closes on the clear condition.  Pickles with the monitor (plain
    attributes), so resumed streams replay fire/clear bit-identically."""

    __slots__ = ("kind", "scope", "open_idx")

    def __init__(self, kind: int, scope: str):
        self.kind = kind
        self.scope = scope
        self.open_idx = -1

    def step(self, alerts: List[Alert], now_ms: int, fire: bool,
             clear: bool, value: float, threshold: float) -> None:
        if self.open_idx < 0:
            if fire:
                self.open_idx = len(alerts)
                alerts.append(Alert(self.kind, self.scope, now_ms,
                                    float(value), float(threshold)))
        elif clear:
            alerts[self.open_idx].cleared_ms = now_ms
            self.open_idx = -1
