"""repro_torch.obs — structured simulation tracing, time-series metrics and
the live SLO monitor.

Five layers, all pure over the event log:

* :mod:`repro_torch.obs.events` — the typed, numpy-columned event bus the
  engines emit into (off by default; ``REPRO_TRACE=1`` or ``events=``
  opts in), with an optional streaming subscriber hook (``elog.sub``);
* :mod:`repro_torch.obs.timeseries` — post-hoc sampled-over-simulated-time
  series (fleet, utilization, queue depth, cost vs budget, slowdown)
  and the shared lease-interval ``peak_and_mean`` reconstruction;
* :mod:`repro_torch.obs.monitor` — the *online* counterpart: rolling-window
  aggregates in flat numpy ring buffers folded incrementally on the
  emit path (``REPRO_MONITOR=1`` or ``monitor=`` opts in);
* :mod:`repro_torch.obs.slo` — per-QoS SLO targets, multi-window burn rates,
  threshold+MAD anomaly detectors and typed alert records;
* :mod:`repro_torch.obs.export` / :mod:`repro_torch.obs.report` —
  deterministic Chrome-trace/JSONL dumps (``--trace-dir``) and the per-cell
  ``monitor.json`` + single-file HTML dashboard (``--report-dir``).

The schemas are the reference package's (docs/PROFILING.md § Event
schema and § Live SLO monitor), so ``tools/check_trace.py`` and
``tools/check_report.py`` validate this package's files unchanged.
"""
from .events import (EVENT_SCHEMA_VERSION, EventLog, events_block,
                     resolve_events)
from .export import chrome_trace, events_jsonl, write_cell_trace
from .monitor import (Monitor, MonitorConfig, monitor_block,
                      resolve_monitor)
from .report import (MONITOR_SCHEMA, MONITOR_SCHEMA_VERSION, dashboard_html,
                     monitor_json, monitor_payload, write_cell_report)
from .slo import (ALERT_KIND_NAMES, Alert, AlertGate, SLOTarget, burn_rate,
                  mad_fire)
from .timeseries import (TimeSeries, cell_summary, peak_and_mean,
                         sample, step_series)

__all__ = [
    "EVENT_SCHEMA_VERSION", "EventLog", "events_block", "resolve_events",
    "chrome_trace", "events_jsonl", "write_cell_trace",
    "Monitor", "MonitorConfig", "monitor_block", "resolve_monitor",
    "MONITOR_SCHEMA", "MONITOR_SCHEMA_VERSION", "dashboard_html",
    "monitor_json", "monitor_payload", "write_cell_report",
    "ALERT_KIND_NAMES", "Alert", "AlertGate", "SLOTarget", "burn_rate",
    "mad_fire",
    "TimeSeries", "cell_summary", "peak_and_mean", "sample", "step_series",
]
