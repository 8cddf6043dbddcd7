"""Deterministic trace export (``repro_torch.obs``).

Turns an :class:`~repro_torch.obs.events.EventLog` into:

* **Chrome-trace / Perfetto JSON** (:func:`chrome_trace`) — loadable in
  ``ui.perfetto.dev`` or ``chrome://tracing``.  One thread track per VM
  (named ``vm<id> (<type>)``), one complete-slice (``ph: "X"``) per task
  pipeline colored by tenant (or QoS) category, and counter tracks
  (``ph: "C"``) for the headline ``obs.timeseries`` series: fleet size,
  busy VMs, ready-queue depth, cumulative cost and cumulative budget.
* a **JSONL event dump** (:func:`events_jsonl`) — one header line
  carrying the versioned schema (``EVENT_SCHEMA_VERSION``), then one
  line per event with the named fields from ``events.SCHEMA``.

Both are **byte-deterministic** in the event log: keys sorted, compact
separators, no wall-clock or host fields — the same cell + seed produces
identical bytes across runs, state layouts (SoA vs object) and
checkpoint/resume cuts (gated in ``tests/test_torch_obs_export.py``,
validated by ``tools/check_trace.py``).  Simulated milliseconds map to trace
microseconds (Chrome's ``ts`` unit) as ``ts = t_ms * 1000``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from . import events as ev_mod
from . import timeseries as ts_mod
from .events import EventLog

TRACE_SCHEMA = "repro-obs-trace"
EVENTS_SCHEMA = "repro-obs-events"

# Chrome-trace reserved color names, assigned to tenants/QoS classes by
# sorted order — stable across runs for a fixed tenant set.
_PALETTE = (
    "thread_state_running", "rail_response", "rail_animation",
    "rail_idle", "rail_load", "cq_build_passed", "cq_build_attempt_runnig",
    "startup", "good", "bad", "terrible", "generic_work",
)


def _dumps(obj: object) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def chrome_trace(
    log: EventLog,
    label: str = "sim",
    vm_type_names: Sequence[str] = (),
    tenant_of: Optional[Dict[int, str]] = None,
    qos_of: Optional[Dict[str, str]] = None,
) -> Dict[str, object]:
    """Build the Chrome-trace JSON object (pure; see module docstring).

    ``tenant_of``: wid → tenant name (slice category + color);
    ``qos_of``: tenant name → QoS class (slice args).  Without maps,
    slices are categorized by workflow id.
    """
    rows = list(log.rows())
    trace_events: List[Dict[str, object]] = []
    # -- track metadata: one named thread per VM -----------------------------
    trace_events.append({
        "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
        "args": {"name": label},
    })
    vm_types: Dict[int, int] = {}
    for r in rows:
        if r["kind"] == "vm_provision":
            vm_types[r["vmid"]] = r["vmt"]
    for vmid in sorted(vm_types):
        vmt = vm_types[vmid]
        tname = (vm_type_names[vmt]
                 if 0 <= vmt < len(vm_type_names) else f"type{vmt}")
        trace_events.append({
            "ph": "M", "pid": 0, "tid": vmid + 1, "name": "thread_name",
            "args": {"name": f"vm{vmid} ({tname})"},
        })
        trace_events.append({
            "ph": "M", "pid": 0, "tid": vmid + 1,
            "name": "thread_sort_index", "args": {"sort_index": vmid},
        })
    # -- task slices: pair TASK_START with TASK_FINISH -----------------------
    tenants = sorted(set(tenant_of.values())) if tenant_of else []
    color_of = {t: _PALETTE[i % len(_PALETTE)]
                for i, t in enumerate(tenants)}
    tier_of: Dict[tuple, Dict[str, object]] = {}
    open_slices: Dict[tuple, Dict[str, object]] = {}
    for r in rows:
        kind = r["kind"]
        if kind == "task_place":
            tier_of[(r["wid"], r["tid"])] = r
        elif kind == "task_start":
            open_slices[(r["wid"], r["tid"])] = r
        elif kind == "task_finish":
            start = open_slices.pop((r["wid"], r["tid"]), None)
            if start is None:
                continue
            wid, tid = r["wid"], r["tid"]
            tenant = tenant_of.get(wid) if tenant_of else None
            place = tier_of.get((wid, tid), {})
            args: Dict[str, object] = {
                "wid": wid, "tid": tid, "warmth": start["warmth"],
                "cost": r["cost"], "input_mb": start["total_mb"],
                "staged_mb": start["missing_mb"],
            }
            if "tier" in place:
                args["tier"] = place["tier"]
                args["est_cost"] = place["est_cost"]
            if tenant is not None:
                args["tenant"] = tenant
                if qos_of and tenant in qos_of:
                    args["qos"] = qos_of[tenant]
            slice_ev: Dict[str, object] = {
                "ph": "X", "pid": 0, "tid": r["vmid"] + 1,
                "ts": start["t_ms"] * 1000,
                "dur": (r["t_ms"] - start["t_ms"]) * 1000,
                "name": f"w{wid}/t{tid}",
                "cat": tenant if tenant is not None else f"w{wid}",
                "args": args,
            }
            if tenant is not None:
                slice_ev["cname"] = color_of[tenant]
            trace_events.append(slice_ev)
    # -- counter tracks from the time-series API -----------------------------
    counters = [ts_mod.fleet_series(log), ts_mod.busy_series(log),
                ts_mod.cumulative_cost_series(log),
                ts_mod.cumulative_budget_series(log)]
    counters += ts_mod.queue_depth_series(log, tenant_of).values()
    for series in counters:
        for t, v in zip(series.t_ms.tolist(), series.v.tolist()):
            trace_events.append({
                "ph": "C", "pid": 0, "tid": 0, "ts": int(t) * 1000,
                "name": series.name, "args": {"value": float(v)},
            })
    return {
        "displayTimeUnit": "ms",
        "metadata": {"schema": TRACE_SCHEMA,
                     "version": ev_mod.EVENT_SCHEMA_VERSION,
                     "label": label},
        "traceEvents": trace_events,
    }


def events_jsonl(log: EventLog, label: str = "sim") -> str:
    """The versioned JSONL dump: header line + one line per event."""
    lines = [_dumps({
        "schema": EVENTS_SCHEMA,
        "version": ev_mod.EVENT_SCHEMA_VERSION,
        "label": label,
        "n_events": len(log),
        "dropped": log.dropped,
    })]
    lines.extend(_dumps(row) for row in log.rows())
    return "\n".join(lines) + "\n"


def write_cell_trace(
    trace_dir: str,
    label: str,
    log: EventLog,
    vm_type_names: Sequence[str] = (),
    tenant_of: Optional[Dict[int, str]] = None,
    qos_of: Optional[Dict[str, str]] = None,
    jsonl: bool = True,
) -> List[str]:
    """Write ``<label>.trace.json`` (+ ``<label>.events.jsonl``) under
    ``trace_dir``; returns the written paths.  The label doubles as the
    filename stem, so callers keep it filesystem-safe and unique per
    (cell, policy)."""
    os.makedirs(trace_dir, exist_ok=True)
    trace = chrome_trace(log, label=label, vm_type_names=vm_type_names,
                         tenant_of=tenant_of, qos_of=qos_of)
    paths = []
    tpath = os.path.join(trace_dir, f"{label}.trace.json")
    with open(tpath, "w") as f:
        f.write(_dumps(trace) + "\n")
    paths.append(tpath)
    if jsonl:
        jpath = os.path.join(trace_dir, f"{label}.events.jsonl")
        with open(jpath, "w") as f:
            f.write(events_jsonl(log, label=label))
        paths.append(jpath)
    return paths
