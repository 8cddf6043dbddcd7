"""Deterministic monitor artifacts: ``monitor.json`` + HTML dashboard.

Renders one :class:`repro_torch.obs.monitor.Monitor` into

* ``<label>.monitor.json`` — the machine-readable schema
  (``repro-obs-monitor`` v1) validated by ``tools/check_report.py``;
* ``<label>.dashboard.html`` — a single-file ops dashboard: stat tiles,
  one inline SVG sparkline per sampled series, an alert timeline, and
  the per-QoS SLO table.  No external assets, no scripts, no wall-clock
  or host fields — the bytes are a pure function of (seed, config), so
  dashboards diff clean across engines and checkpoint/resume (gated in
  ``tests/test_torch_obs_export.py``).

Float formatting is fixed-precision everywhere (``%.6g`` for values,
``%.2f`` for SVG coordinates) to keep byte-determinism independent of
repr subtleties.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import slo as obs_slo
from .export import _dumps
from .monitor import Monitor

MONITOR_SCHEMA = "repro-obs-monitor"
MONITOR_SCHEMA_VERSION = 1
DASHBOARD_MARKER = "<!-- repro-obs-dashboard v1 -->"

# Fixed sparkline palette, assigned to series in export order.
_COLORS = ("#2563eb", "#16a34a", "#d97706", "#dc2626", "#7c3aed",
           "#0891b2", "#be185d", "#4d7c0f", "#b45309", "#1d4ed8",
           "#9333ea", "#0f766e", "#a16207", "#991b1b")


def _num(v: float) -> float:
    """JSON-safe float: NaN/inf → 0 (``_dumps`` forbids non-finite)."""
    f = float(v)
    return f if np.isfinite(f) else 0.0


def _fmt(v: float) -> str:
    """Fixed-precision human value for the dashboard."""
    return f"{_num(v):.6g}"


def monitor_payload(mon: Monitor, label: str = "cell") -> Dict[str, object]:
    """The ``monitor.json`` document (pre-serialization)."""
    cfg = mon.cfg
    series = mon.series()
    t_ms = [int(v) for v in series.pop("t_ms")]
    horizon = (mon.finalized_ms if mon.finalized_ms >= 0
               else (t_ms[-1] if t_ms else 0))
    return {
        "schema": MONITOR_SCHEMA,
        "version": MONITOR_SCHEMA_VERSION,
        "label": label,
        "config": {
            "sample_ms": int(cfg.sample_ms),
            "short_window_ms": int(cfg.short_window_ms),
            "long_window_ms": int(cfg.long_window_ms),
            "burn_fire": _num(cfg.burn_fire),
            "burn_clear": _num(cfg.burn_clear),
            "mad_k": _num(cfg.mad_k),
        },
        "horizon_ms": int(horizon),
        "qos": list(mon.qos_names),
        "samples": {
            "t_ms": t_ms,
            "series": {name: [_num(v) for v in vals]
                       for name, vals in sorted(series.items())},
        },
        "totals": {
            "events": int(mon.events_seen),
            "samples": int(mon.ticks),
            "arrivals": int(mon.arrivals),
            "completions": int(mon.completions),
            "placements": int(mon.placements),
            "failures": int(mon.failures),
            "retries": int(mon.retries),
            "revocations": int(mon.revocations),
            "stragglers": int(mon.stragglers),
            "cost": _num(mon.cost),
            "wasted_cost": _num(mon.wasted),
            "budget": _num(mon.budget),
        },
        "slo": mon.slo_table(),
        "alerts": [a.to_dict() for a in mon.alerts],
        "alerts_by_kind": mon.alerts_by_kind(),
    }


def monitor_json(mon: Monitor, label: str = "cell") -> str:
    return _dumps(monitor_payload(mon, label))


# ---- HTML dashboard --------------------------------------------------------
_CSS = """
body{font-family:ui-monospace,Menlo,Consolas,monospace;background:#0b1020;
color:#dbe2f0;margin:0;padding:24px}
h1{font-size:18px;margin:0 0 4px}h2{font-size:14px;margin:24px 0 8px;
color:#8fa3c8}
.meta{color:#8fa3c8;font-size:12px;margin-bottom:16px}
.tiles{display:flex;flex-wrap:wrap;gap:8px}
.tile{background:#141b33;border:1px solid #24304f;border-radius:6px;
padding:8px 14px;min-width:96px}
.tile .v{font-size:18px;color:#fff}.tile .k{font-size:11px;color:#8fa3c8}
.spark{display:flex;align-items:center;gap:12px;margin:2px 0}
.spark .name{width:200px;font-size:12px;color:#b8c4dd;text-align:right}
.spark .last{width:90px;font-size:12px;color:#8fa3c8}
table{border-collapse:collapse;font-size:12px}
td,th{border:1px solid #24304f;padding:4px 10px;text-align:right}
th{background:#141b33;color:#8fa3c8}td.l,th.l{text-align:left}
.ok{color:#4ade80}.bad{color:#f87171}.open{color:#fbbf24}
svg{display:block}
""".strip()


def _sparkline(t: Sequence[int], v: Sequence[float], color: str,
               width: int = 560, height: int = 36) -> str:
    """Inline SVG sparkline with fixed-precision coordinates."""
    n = len(v)
    if n == 0:
        return f'<svg width="{width}" height="{height}"></svg>'
    t0, t1 = t[0], t[-1]
    span_t = max(t1 - t0, 1)
    lo = min(_num(x) for x in v)
    hi = max(_num(x) for x in v)
    span_v = hi - lo if hi > lo else 1.0
    pts = []
    for i in range(n):
        x = (t[i] - t0) / span_t * (width - 4) + 2
        y = height - 3 - (_num(v[i]) - lo) / span_v * (height - 6)
        pts.append(f"{x:.2f},{y:.2f}")
    return (f'<svg width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}">'
            f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{" ".join(pts)}"/></svg>')


def _alert_timeline(alerts: Sequence[obs_slo.Alert], horizon_ms: int,
                    width: int = 760, row_h: int = 18) -> str:
    """SVG timeline: one bar per alert from fire to clear (open alerts
    extend to the horizon in the open color)."""
    if not alerts:
        return "<p class='meta'>no alerts fired</p>"
    span = max(horizon_ms, 1)
    h = row_h * len(alerts) + 4
    label_w = 240
    rows: List[str] = []
    for i, a in enumerate(alerts):
        name = obs_slo.ALERT_KIND_NAMES.get(a.kind, str(a.kind))
        end = a.cleared_ms if a.cleared_ms >= 0 else horizon_ms
        x0 = label_w + a.fired_ms / span * (width - label_w - 4)
        x1 = label_w + end / span * (width - label_w - 4)
        color = "#f87171" if a.cleared_ms >= 0 else "#fbbf24"
        y = i * row_h + 2
        rows.append(
            f'<text x="2" y="{y + 12}" fill="#b8c4dd" font-size="11">'
            f'{name} [{a.scope}]</text>'
            f'<rect x="{x0:.2f}" y="{y + 3}" '
            f'width="{max(x1 - x0, 2.0):.2f}" height="{row_h - 8}" '
            f'fill="{color}" rx="2"/>')
    return (f'<svg width="{width}" height="{h}" '
            f'viewBox="0 0 {width} {h}">{"".join(rows)}</svg>')


def _tile(key: str, value: str) -> str:
    return (f'<div class="tile"><div class="v">{value}</div>'
            f'<div class="k">{key}</div></div>')


def dashboard_html(mon: Monitor, label: str = "cell") -> str:
    """Render the single-file dashboard (byte-deterministic)."""
    pay = monitor_payload(mon, label)
    tot = pay["totals"]
    horizon = int(pay["horizon_ms"])
    t_ms = pay["samples"]["t_ms"]
    parts: List[str] = [
        "<!DOCTYPE html>", DASHBOARD_MARKER,
        "<html><head><meta charset='utf-8'>",
        f"<title>repro monitor — {label}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>repro live monitor — {label}</h1>",
        f"<div class='meta'>horizon {horizon / 1000.0:.1f}s · "
        f"sample {mon.cfg.sample_ms}ms · windows "
        f"{mon.cfg.short_window_ms // 1000}s/"
        f"{mon.cfg.long_window_ms // 1000}s · schema "
        f"{MONITOR_SCHEMA} v{MONITOR_SCHEMA_VERSION}</div>",
        "<div class='tiles'>",
        _tile("events", str(tot["events"])),
        _tile("arrivals", str(tot["arrivals"])),
        _tile("completions", str(tot["completions"])),
        _tile("failures", str(tot["failures"])),
        _tile("revocations", str(tot["revocations"])),
        _tile("stragglers", str(tot["stragglers"])),
        _tile("spend", _fmt(tot["cost"])),
        _tile("wasted", _fmt(tot["wasted_cost"])),
        _tile("budget", _fmt(tot["budget"])),
        _tile("alerts", str(len(pay["alerts"]))),
        "</div>",
        "<h2>window series</h2>",
    ]
    for i, (name, vals) in enumerate(sorted(
            pay["samples"]["series"].items())):
        color = _COLORS[i % len(_COLORS)]
        last = _fmt(vals[-1]) if vals else "-"
        parts.append(
            f"<div class='spark'><div class='name'>{name}</div>"
            f"{_sparkline(t_ms, vals, color)}"
            f"<div class='last'>{last}</div></div>")
    parts.append("<h2>alert timeline</h2>")
    parts.append(_alert_timeline(mon.alerts, horizon))
    parts.append("<h2>per-QoS SLO table</h2>")
    parts.append(
        "<table><tr><th class='l'>qos</th><th>n</th>"
        "<th>budget-met</th><th>target</th><th>p95 slowdown</th>"
        "<th>ceiling</th><th>p95 wait (s)</th><th>target (s)</th>"
        "<th>status</th></tr>")
    for qname, row in pay["slo"].items():
        met_ok = row["budget_met"] >= row["target_budget_met"]
        status = ("<span class='open'>ALERT</span>"
                  if row["alerts_open"]
                  else ("<span class='ok'>OK</span>" if met_ok
                        else "<span class='bad'>MISS</span>"))
        parts.append(
            f"<tr><td class='l'>{qname}</td>"
            f"<td>{row['n_completions']}</td>"
            f"<td>{_fmt(row['budget_met'])}</td>"
            f"<td>{_fmt(row['target_budget_met'])}</td>"
            f"<td>{_fmt(row['p95_slowdown'])}</td>"
            f"<td>{_fmt(row['target_p95_slowdown'])}</td>"
            f"<td>{_fmt(row['p95_queue_wait_ms'] / 1000.0)}</td>"
            f"<td>{_fmt(row['target_queue_wait_ms'] / 1000.0)}</td>"
            f"<td>{status}</td></tr>")
    parts.append("</table>")
    if pay["alerts"]:
        parts.append("<h2>alerts</h2>")
        parts.append(
            "<table><tr><th class='l'>kind</th><th class='l'>scope</th>"
            "<th>fired (s)</th><th>cleared (s)</th><th>value</th>"
            "<th>threshold</th></tr>")
        for a in pay["alerts"]:
            cleared = (_fmt(a["cleared_ms"] / 1000.0)
                       if a["cleared_ms"] >= 0 else "open")
            parts.append(
                f"<tr><td class='l'>{a['kind']}</td>"
                f"<td class='l'>{a['scope']}</td>"
                f"<td>{_fmt(a['fired_ms'] / 1000.0)}</td>"
                f"<td>{cleared}</td><td>{_fmt(a['value'])}</td>"
                f"<td>{_fmt(a['threshold'])}</td></tr>")
        parts.append("</table>")
    parts.append("</body></html>")
    return "\n".join(parts) + "\n"


def write_cell_report(report_dir: str, label: str, mon: Monitor) -> Tuple[str, str]:
    """Write ``<label>.monitor.json`` + ``<label>.dashboard.html`` into
    ``report_dir`` (created if missing).  Returns the two paths."""
    os.makedirs(report_dir, exist_ok=True)
    jpath = os.path.join(report_dir, f"{label}.monitor.json")
    hpath = os.path.join(report_dir, f"{label}.dashboard.html")
    with open(jpath, "w") as fh:
        fh.write(monitor_json(mon, label) + "\n")
    with open(hpath, "w") as fh:
        fh.write(dashboard_html(mon, label))
    return jpath, hpath
