"""Structured simulation event bus (``repro_torch.obs``).

A :class:`EventLog` is a numpy-columned append buffer for *typed*
simulation events: every event is one row of fixed numeric columns —
``t_ms`` (simulated clock), ``kind`` (one of the ``WF_*`` / ``TASK_*`` /
``VM_*`` / ``BUDGET_*`` / ``GRID_*`` constants) and six payload columns
(``a b c d`` int64, ``x y`` float64) whose per-kind meaning is declared
once in :data:`SCHEMA`.  The engines (``core.engine.SimState``,
``core.batch_engine.BatchSimEngine``) emit into it from every state
transition; ``obs.timeseries`` derives sampled-over-simulated-time
series from it and ``obs.export`` turns it into Chrome-trace/Perfetto
JSON and a versioned JSONL dump.

Cost model: **off by default and zero-cost when disabled** — the hot
paths hold a local ``ev = self.elog`` and guard every emission with a
single ``is not None`` test, exactly like the ``REPRO_PROFILE``
counters.  When enabled, an append is a handful of scalar array stores
(no tuples, no dicts, no Python objects per event).  ``REPRO_TRACE=1``
is the ambient opt-in (the env analogue of the ``events=`` kwarg), and
``capacity=`` turns the buffer into a ring that keeps the last N events
(``dropped`` counts the overwritten prefix) for long-horizon streams.

Events are simulation state: :meth:`EventLog.__getstate__` makes the log
pickle cleanly, so checkpointed streams (``SimState.snapshot``) carry
their event history and a resumed run exports **byte-identical** traces
(gated in ``tests/test_obs.py``).
"""
from __future__ import annotations

import os as _os
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

# Versioned wire schema for the JSONL dump (obs.export) and the trace
# validator (tools/check_trace.py).  Bump on any change to the kind set
# or a kind's field mapping.
# v2: chaos kinds 18-21 (VM_REVOKE / TASK_FAIL / TASK_RETRY /
#     STRAGGLER_DETECT) — see repro_torch.chaos.
EVENT_SCHEMA_VERSION = 2

# ---- event kinds -----------------------------------------------------------
WF_ARRIVE = 1            # workflow arrival enters the system
WF_DONE = 2              # last task of a workflow finished
TASK_READY = 3           # task entered the ready queue
TASK_PLACE = 4           # scheduler committed a placement decision
TASK_START = 5           # execution pipeline started on a VM
TASK_FINISH = 6          # task finished (actual cost billed)
VM_PROVISION = 7         # VM lease opened (provisioning begins)
VM_READY = 8             # provisioning delay elapsed
VM_BUSY = 9              # VM taken by a task pipeline
VM_IDLE = 10             # VM returned to the idle pool
VM_CONTAINER = 11        # container activation that cost time (init/cold)
VM_REAP = 12             # VM lease closed (terminate)
BUDGET_DISTRIBUTE = 13   # Algorithm 1 / MSLBL arrival-time distribution
BUDGET_REDISTRIBUTE = 14  # Algorithm 3 redistribution (either mode)
BUDGET_SPARE = 15        # spare-pool movement (MSLBL spend, round banking)
GRID_ROUND = 16          # grid-engine rendezvous round
GRID_AUCTION = 17        # batched auction call within a round
VM_REVOKE = 18           # spot lease revoked (repro_torch.chaos)
TASK_FAIL = 19           # execution attempt failed (spend sunk)
TASK_RETRY = 20          # failed/preempted task re-entered the queue
STRAGGLER_DETECT = 21    # finish whose compute time tripped the detector

KIND_NAMES: Dict[int, str] = {
    WF_ARRIVE: "wf_arrive",
    WF_DONE: "wf_done",
    TASK_READY: "task_ready",
    TASK_PLACE: "task_place",
    TASK_START: "task_start",
    TASK_FINISH: "task_finish",
    VM_PROVISION: "vm_provision",
    VM_READY: "vm_ready",
    VM_BUSY: "vm_busy",
    VM_IDLE: "vm_idle",
    VM_CONTAINER: "vm_container",
    VM_REAP: "vm_reap",
    BUDGET_DISTRIBUTE: "budget_distribute",
    BUDGET_REDISTRIBUTE: "budget_redistribute",
    BUDGET_SPARE: "budget_spare",
    GRID_ROUND: "grid_round",
    GRID_AUCTION: "grid_auction",
    VM_REVOKE: "vm_revoke",
    TASK_FAIL: "task_fail",
    TASK_RETRY: "task_retry",
    STRAGGLER_DETECT: "straggler_detect",
}

# Per-kind payload declaration: (json_field_name, column) in column order.
# Columns: a b c d are int64, x y are float64.  Documented prose-side in
# docs/PROFILING.md § Event schema.
SCHEMA: Dict[int, tuple] = {
    WF_ARRIVE: (("wid", "a"), ("n_tasks", "b"), ("budget", "x")),
    WF_DONE: (("wid", "a"), ("cost", "x"), ("budget", "y")),
    TASK_READY: (("wid", "a"), ("tid", "b")),
    TASK_PLACE: (("wid", "a"), ("tid", "b"), ("vmid", "c"), ("tier", "d"),
                 ("est_cost", "x")),
    TASK_START: (("wid", "a"), ("tid", "b"), ("vmid", "c"), ("warmth", "d"),
                 ("missing_mb", "x"), ("total_mb", "y")),
    TASK_FINISH: (("wid", "a"), ("tid", "b"), ("vmid", "c"), ("cost", "x")),
    VM_PROVISION: (("vmid", "a"), ("vmt", "b")),
    VM_READY: (("vmid", "a"),),
    VM_BUSY: (("vmid", "a"),),
    VM_IDLE: (("vmid", "a"),),
    VM_CONTAINER: (("vmid", "a"), ("warmth", "b")),
    VM_REAP: (("vmid", "a"), ("finalized", "b")),
    BUDGET_DISTRIBUTE: (("wid", "a"), ("mode", "b"), ("spare", "x")),
    BUDGET_REDISTRIBUTE: (("wid", "a"), ("tid", "b"), ("events", "c"),
                          ("surplus", "x"), ("spare", "y")),
    BUDGET_SPARE: (("wid", "a"), ("tid", "b"), ("delta", "x"),
                   ("spare", "y")),
    GRID_ROUND: (("round", "a"), ("parked", "b"), ("ridden", "c"),
                 ("pairs", "d")),
    GRID_AUCTION: (("round", "a"), ("requests", "b"), ("pairs", "d")),
    # Chaos kinds (repro_torch.chaos): wid/tid are -1 on VM_REVOKE when the VM
    # carried no task; ``busy`` is 1 when a pipeline was killed mid-run.
    VM_REVOKE: (("vmid", "a"), ("wid", "b"), ("tid", "c"), ("busy", "d"),
                ("wasted", "x")),
    TASK_FAIL: (("wid", "a"), ("tid", "b"), ("vmid", "c"), ("attempt", "d"),
                ("wasted", "x")),
    TASK_RETRY: (("wid", "a"), ("tid", "b"), ("attempt", "c"),
                 ("preemptions", "d")),
    STRAGGLER_DETECT: (("wid", "a"), ("tid", "b"), ("vmid", "c"),
                       ("rt_ms", "d"), ("ratio", "x")),
}

# Container-warmth codes shared by TASK_START / VM_CONTAINER (matches the
# SimState counter classification; -1 = containers disabled).
WARMTH_NONE, WARMTH_WARM, WARMTH_INIT, WARMTH_COLD = -1, 0, 1, 2


def _trace_enabled() -> bool:
    """Ambient opt-in (``REPRO_TRACE=1``) — the env default the
    ``events=`` kwargs resolve against, read per engine construction so
    tests can monkeypatch it."""
    return _os.environ.get("REPRO_TRACE") == "1"


_COLS = ("t", "kind", "a", "b", "c", "d", "x", "y")
_INT_COLS = ("t", "kind", "a", "b", "c", "d")


class EventLog:
    """Append-only (optionally ring) numpy-columned event buffer."""

    __slots__ = ("t", "kind", "a", "b", "c", "d", "x", "y",
                 "total", "capacity", "_cap", "sub")

    def __init__(self, capacity: Optional[int] = None):
        """``capacity=None`` (default) grows geometrically and keeps
        everything; ``capacity=N`` keeps only the most recent N events
        (ring), counting the overwritten prefix in :attr:`dropped`."""
        if capacity is not None and capacity <= 0:
            raise ValueError(f"capacity={capacity} (expected > 0 or None)")
        cap = capacity if capacity is not None else 1024
        for name in _INT_COLS:
            setattr(self, name, np.zeros(cap, np.int64))
        self.x = np.zeros(cap, np.float64)
        self.y = np.zeros(cap, np.float64)
        self.total = 0
        self.capacity = capacity
        self._cap = cap
        # Optional streaming subscriber (repro_torch.obs.monitor.Monitor): an
        # object with on_event(kind, t, a, b, c, d, x, y), invoked on
        # every append *before* ring overwrite can lose the record.  A
        # single is-None check on the hot path keeps the zero-cost
        # discipline when no monitor is attached.
        self.sub = None

    # -- hot path ------------------------------------------------------------
    def append(self, kind: int, t_ms: int, a: int = 0, b: int = 0,
               c: int = 0, d: int = 0, x: float = 0.0,
               y: float = 0.0) -> None:
        i = self.total
        if self.capacity is None:
            if i == self._cap:
                self._grow()
            j = i
        else:
            j = i % self.capacity
        self.t[j] = t_ms
        self.kind[j] = kind
        self.a[j] = a
        self.b[j] = b
        self.c[j] = c
        self.d[j] = d
        self.x[j] = x
        self.y[j] = y
        self.total = i + 1
        sub = self.sub
        if sub is not None:
            sub.on_event(kind, t_ms, a, b, c, d, x, y)

    def _grow(self) -> None:
        new_cap = self._cap * 2
        for name in _COLS:
            arr = getattr(self, name)
            grown = np.zeros(new_cap, arr.dtype)
            grown[:self._cap] = arr
            setattr(self, name, grown)
        self._cap = new_cap

    # -- views ---------------------------------------------------------------
    def __len__(self) -> int:
        """Events currently stored (≤ :attr:`total` for rings)."""
        if self.capacity is None:
            return self.total
        return min(self.total, self.capacity)

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap-around (0 for unbounded logs)."""
        if self.capacity is None:
            return 0
        return max(0, self.total - self.capacity)

    def _order(self) -> Union[slice, np.ndarray]:
        n = len(self)
        if self.capacity is None or self.total <= self.capacity:
            return slice(0, n)
        head = self.total % self.capacity
        return np.concatenate([np.arange(head, self.capacity),
                               np.arange(0, head)])

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Chronological copies of the stored columns."""
        idx = self._order()
        return {name: getattr(self, name)[idx].copy() for name in _COLS}

    def counts(self) -> Dict[str, int]:
        """Stored events per kind name (unknown kinds keyed by number)."""
        kinds = self.kind[self._order()]
        out: Dict[str, int] = {}
        if len(kinds) == 0:
            return out
        for k, n in zip(*np.unique(kinds, return_counts=True)):
            out[KIND_NAMES.get(int(k), str(int(k)))] = int(n)
        return out

    def rows(self) -> Iterator[Dict[str, object]]:
        """Stored events as named-field dicts, chronological order
        (the JSONL dump shape; ints/floats narrowed to Python scalars)."""
        arrays = self.to_arrays()
        kind_col = arrays["kind"]
        for i in range(len(kind_col)):
            k = int(kind_col[i])
            row: Dict[str, object] = {
                "kind": KIND_NAMES.get(k, str(k)),
                "t_ms": int(arrays["t"][i]),
            }
            for field, col in SCHEMA.get(k, ()):
                v = arrays[col][i]
                row[field] = float(v) if col in ("x", "y") else int(v)
            yield row

    # -- pickling (numpy slots) ---------------------------------------------
    def __getstate__(self) -> Dict[str, object]:
        state = {name: getattr(self, name) for name in _COLS}
        state["total"] = self.total
        state["capacity"] = self.capacity
        state["_cap"] = self._cap
        state["sub"] = self.sub
        return state

    def __setstate__(self, state: Dict[str, object]) -> None:
        # Pre-subscriber pickles (version-2 stream snapshots) carry
        # no "sub" key; default it so restored logs stay well-formed.
        self.sub = None
        for name, v in state.items():
            setattr(self, name, v)


def resolve_events(
    events: Union[None, bool, EventLog],
) -> Optional[EventLog]:
    """Normalize an ``events=`` kwarg: ``None`` defers to ``REPRO_TRACE``,
    booleans toggle a fresh log, an :class:`EventLog` passes through."""
    if isinstance(events, EventLog):
        return events
    if events is None:
        events = _trace_enabled()
    return EventLog() if events else None


def events_block(logs: Sequence[Optional[EventLog]]) -> Dict[str, object]:
    """The ``dispatch_stats()["events"]`` payload: per-kind counts summed
    over a collection of logs (grid members + the grid log).  ``total``
    counts *emitted* events; ``by_kind``/``dropped`` reflect what rings
    still hold."""
    live: List[EventLog] = [log for log in logs if log is not None]
    by_kind: Dict[str, int] = {}
    total = dropped = 0
    for log in live:
        for name, n in log.counts().items():
            by_kind[name] = by_kind.get(name, 0) + n
        total += log.total
        dropped += log.dropped
    return {"enabled": bool(live), "total": total,
            "by_kind": dict(sorted(by_kind.items())), "dropped": dropped}
