"""repro_torch.obs — structured simulation tracing and the live SLO monitor.

The layers the engines import:

* :mod:`repro_torch.obs.events` — the typed, numpy-columned event bus the
  engines emit into (off by default; ``REPRO_TRACE=1`` or ``events=``
  opts in), with an optional streaming subscriber hook (``elog.sub``);
* :mod:`repro_torch.obs.monitor` — rolling-window aggregates in flat numpy
  ring buffers folded incrementally on the emit path (``REPRO_MONITOR=1``
  or ``monitor=`` opts in);
* :mod:`repro_torch.obs.slo` — per-QoS SLO targets, multi-window burn
  rates, threshold+MAD anomaly detectors and typed alert records;
* :mod:`repro_torch.obs.timeseries` — the lease-interval ``peak_and_mean``
  reconstruction ``SimState.finalize`` reports fleet size with, and the
  sampled-over-simulated-time series built on the same log.

Chrome-trace/JSONL export and the HTML report are not ported yet.
"""
from .events import (EVENT_SCHEMA_VERSION, EventLog, events_block,
                     resolve_events)
from .monitor import (Monitor, MonitorConfig, monitor_block,
                      resolve_monitor)
from .slo import (ALERT_KIND_NAMES, Alert, AlertGate, SLOTarget, burn_rate,
                  mad_fire)

__all__ = [
    "EVENT_SCHEMA_VERSION", "EventLog", "events_block", "resolve_events",
    "Monitor", "MonitorConfig", "monitor_block", "resolve_monitor",
    "ALERT_KIND_NAMES", "Alert", "AlertGate", "SLOTarget", "burn_rate",
    "mad_fire",
]
