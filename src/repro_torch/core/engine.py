"""Discrete-event WaaS simulation engine (reference implementation).

Event-driven, heap-ordered, integer-millisecond clock.  Scheduling cycles run
after all events at a timestamp are applied — exactly the paper's trigger
rule ("the arrival of a new workflow's job and the completion of a task").

The state-transition semantics live in :class:`SimState` — arrival / finish /
VM_READY / REAP handling, the execution pipeline, budget redistribution via
Algorithm 3, and the cycle commit protocol.  Two engines drive that one
source of truth:

* :class:`SimEngine` (here) — the sequential semantic oracle, one
  (policy, workload) per run;
* ``core.batch_engine.BatchSimEngine`` — lockstep rounds over a whole
  experiment grid with the per-cycle scoring batched onto the device
  (property-tested bit-exact against this engine and against the
  reference package in ``tests/test_torch_engine.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math as _math
import os as _os
import pickle as _pickle
import time as _time
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from . import budget as budget_mod
from . import cost_tables, costs
from .mslbl import distribute_budget_mslbl
from .scheduler import Placement, Policy, select
from .types import (
    MS,
    PlatformConfig,
    SimResult,
    StreamState,
    Task,
    Workflow,
    WorkflowResult,
    degradation_tables,
)
from ..chaos import ChaosConfig, chaos_draws
from ..device import resolve_device
from ..obs import events as obs_events
from ..obs import monitor as obs_monitor
from ..obs import timeseries as obs_ts
from ..obs.events import EventLog
from ..sim.cloud import (VM, VM_BUSY, VM_IDLE, VM_PROVISIONING,
                         VM_TERMINATED, DataKey, VMPool)

ARRIVAL, FINISH, VM_READY, REAP, REVOKE = 0, 1, 2, 3, 4

# Auction engagement threshold for a solo SimEngine cycle (queue × pool
# pair count).  The grid engine amortizes device calls across members and
# uses the lower core.batch_engine.AUCTION_MIN_PAIRS_GRID.
AUCTION_MIN_PAIRS = 8192

# Queue-order metadata for one cycle's drained tasks: (wid, tid, inputs).
CycleMeta = Tuple[int, int, List[Tuple[DataKey, float]]]


def _profile_enabled() -> bool:
    """Opt-in per-phase timing (``REPRO_PROFILE=1``).

    Off by default: the counters wrap the per-dispatch hot path with two
    ``perf_counter`` calls each, which is measurable at paper scale.  Read
    per ``SimState`` so tests can toggle via monkeypatch.
    """
    return _os.environ.get("REPRO_PROFILE") == "1"


def _object_state_forced() -> bool:
    """``REPRO_OBJECT_STATE=1`` forces the legacy per-workflow object
    state (`_WfState` dicts/sets) instead of the structure-of-arrays
    ``StreamState`` default — the debugging/bisection escape hatch, the
    state-layer analogue of ``REPRO_SCALAR_SELECT`` /
    ``REPRO_SCALAR_REDIST``.  Read per ``SimState`` so tests can toggle
    it without re-importing."""
    return _os.environ.get("REPRO_OBJECT_STATE") == "1"

# Version tag for SimState.snapshot() payloads (bumped on layout
# changes; repro.ckpt.checkpoint.restore_stream refuses newer ones).
# v2: chaos residue (attempt/preemption counters, injection tallies) and
#     the extended _Running fields (start_ms, rt_ms, est_rt_ms).
#     The live monitor (repro_torch.obs.monitor) needs no version of its own:
#     it rides the opaque elog pickle as ``elog.sub`` — v2 snapshots
#     written before the monitor existed restore with ``sub = None``.
STREAM_SNAPSHOT_VERSION = 2


def new_profile() -> Dict[str, float]:
    """Fresh per-phase counter block (seconds + call counts)."""
    return {
        "distribute_s": 0.0,      # Algorithm 1 / MSLBL arrival distribution
        "redistribute_s": 0.0,    # Algorithm 3 redistribution (either mode)
        "select_s": 0.0,          # per-task scheduler.select calls
        "pipeline_s": 0.0,        # execution-pipeline math + cache updates
        "distributions": 0.0,
        "redistributions": 0.0,       # Algorithm-3 distribute invocations
        "redistribute_events": 0.0,   # task finishes feeding them (≥ above
        #                               in round mode: events coalesce)
        "selects": 0.0,
        "pipelines": 0.0,             # _start_pipeline timer pairs
    }


# Calibrated-once cost of one perf_counter bracket (two calls), the unit
# the self-measured profile_overhead_s is denominated in.
_PAIR_COST_S: Optional[float] = None


def _perf_pair_cost_s() -> float:
    global _PAIR_COST_S
    if _PAIR_COST_S is None:
        n = 10000
        t0 = _time.perf_counter()
        for _ in range(n):
            _time.perf_counter()
            _time.perf_counter()
        _PAIR_COST_S = (_time.perf_counter() - t0) / n
    return _PAIR_COST_S


def profile_overhead_s(prof: Dict[str, float]) -> float:
    """Self-measured cost of the profiling counters themselves: every
    instrumented phase wraps its body in one ``perf_counter`` bracket,
    so the overhead is (brackets taken) × (calibrated bracket cost).
    Surfaced as ``dispatch_stats()["profile"]["profile_overhead_s"]`` so
    consumers can judge whether the counters perturb what they time."""
    pairs = (prof.get("distributions", 0.0)
             + prof.get("redistributions", 0.0)
             + prof.get("selects", 0.0)
             + prof.get("pipelines", 0.0))
    return pairs * _perf_pair_cost_s()


@dataclasses.dataclass(slots=True)
class _WfState:
    """Legacy per-workflow object state (``REPRO_OBJECT_STATE=1``).

    Shares the accessor-method interface of :class:`_WfView` so every
    ``SimState`` transition is state-layout-agnostic; the two layouts
    are parity-gated in ``tests/test_dispatcher_matrix.py``."""

    wf: Workflow
    spare: float = 0.0
    cost: float = 0.0
    remaining: int = 0
    finish_ms: int = 0
    unscheduled: Set[int] = dataclasses.field(default_factory=set)
    pending_parents: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Array-path Algorithm 3 (core.budget.RedistState), built lazily at
    # the first redistribution; None when the scalar oracle is forced.
    redist: Optional[budget_mod.RedistState] = None
    # Round-batched mode: surplus banked since the last flush, and the
    # number of finish events it coalesces.
    pending_surplus: float = 0.0
    pending_events: int = 0

    def begin_arrival(self) -> None:
        wf = self.wf
        self.remaining = wf.n_tasks
        self.unscheduled = set(range(wf.n_tasks))
        self.pending_parents = {t.tid: len(t.parents) for t in wf.tasks}

    def unscheduled_seq(self) -> Sequence[int]:
        """Unscheduled tids, any order (the scalar Algorithm-3 oracle
        sorts by rank internally, so ordering is semantics-free)."""
        return self.unscheduled

    def discard_unscheduled(self, tid: int) -> None:
        self.unscheduled.discard(tid)

    def add_unscheduled(self, tid: int) -> None:
        """Chaos re-execution: a revoked/failed task rejoins the pool."""
        self.unscheduled.add(tid)

    def dec_pending(self, child: int) -> bool:
        """Decrement the child's pending-parent count; True ⇒ released."""
        v = self.pending_parents[child] - 1
        self.pending_parents[child] = v
        return v == 0

    def make_redist(self, cfg: PlatformConfig) -> budget_mod.RedistState:
        self.redist = budget_mod.RedistState(cfg, self.wf, self.unscheduled)
        return self.redist


class _WfView:
    """Per-workflow accessor over the shared :class:`StreamState` arrays
    (the default state layout).

    Same interface as :class:`_WfState`; the scalar fields are numpy
    array cells (``float()``/``int()`` narrowing on read keeps every
    value a Python scalar, so downstream float algebra and JSON output
    are bit-identical with the object path), and the unscheduled set /
    pending-parent dict become segment slices of the pooled per-task
    arrays.  ``redist`` wraps the StreamState Algorithm-3 pool segments
    instead of allocating per-workflow mirrors."""

    __slots__ = ("wf", "redist", "_ss", "_w", "_t0", "_n")

    def __init__(self, wf: Workflow, ss: StreamState, wid: int, t0: int):
        self.wf = wf
        self.redist = None
        self._ss = ss
        self._w = wid
        self._t0 = t0
        self._n = wf.n_tasks

    # -- per-workflow scalars ------------------------------------------------
    @property
    def spare(self) -> float:
        return float(self._ss.spare[self._w])

    @spare.setter
    def spare(self, v: float) -> None:
        self._ss.spare[self._w] = v

    @property
    def cost(self) -> float:
        return float(self._ss.cost[self._w])

    @cost.setter
    def cost(self, v: float) -> None:
        self._ss.cost[self._w] = v

    @property
    def remaining(self) -> int:
        return int(self._ss.remaining[self._w])

    @remaining.setter
    def remaining(self, v: int) -> None:
        self._ss.remaining[self._w] = v

    @property
    def finish_ms(self) -> int:
        return int(self._ss.finish_ms[self._w])

    @finish_ms.setter
    def finish_ms(self, v: int) -> None:
        self._ss.finish_ms[self._w] = v

    @property
    def pending_surplus(self) -> float:
        return float(self._ss.pending_surplus[self._w])

    @pending_surplus.setter
    def pending_surplus(self, v: float) -> None:
        self._ss.pending_surplus[self._w] = v

    @property
    def pending_events(self) -> int:
        return int(self._ss.pending_events[self._w])

    @pending_events.setter
    def pending_events(self, v: int) -> None:
        self._ss.pending_events[self._w] = v

    # -- per-task segments ---------------------------------------------------
    def begin_arrival(self) -> None:
        ss, w, t0, n = self._ss, self._w, self._t0, self._n
        ss.arrived[w] = True
        ss.remaining[w] = n
        ss.unscheduled[t0:t0 + n] = True
        ss.pending_parents[t0:t0 + n] = \
            [len(t.parents) for t in self.wf.tasks]

    def unscheduled_seq(self) -> Sequence[int]:
        t0 = self._t0
        return np.flatnonzero(
            self._ss.unscheduled[t0:t0 + self._n]).tolist()

    def discard_unscheduled(self, tid: int) -> None:
        self._ss.unscheduled[self._t0 + tid] = False

    def add_unscheduled(self, tid: int) -> None:
        self._ss.unscheduled[self._t0 + tid] = True

    def dec_pending(self, child: int) -> bool:
        pp = self._ss.pending_parents
        i = self._t0 + child
        v = pp[i] - 1
        pp[i] = v
        return v == 0

    def make_redist(self, cfg: PlatformConfig) -> budget_mod.RedistState:
        ss, t0 = self._ss, self._t0
        seg = slice(t0, t0 + self._n)
        self.redist = budget_mod.RedistState(
            cfg, self.wf, self.unscheduled_seq(),
            backing=(ss.redist_order[seg], ss.redist_pos[seg],
                     ss.redist_mask[seg], ss.redist_budget[seg]))
        return self.redist


@dataclasses.dataclass(slots=True)
class _Running:
    wid: int
    tid: int
    vm: VM
    triggered_provision: bool
    actual_cost: float = 0.0
    # Chaos bookkeeping (set only when injection is enabled): pipeline
    # start for pro-rated revocation billing, the (possibly inflated)
    # compute leg and its undegraded estimate for straggler detection.
    start_ms: int = 0
    end_ms: int = 0
    rt_ms: int = 0
    est_rt_ms: int = 0


class SimState:
    """One simulation's mutable state + the transition semantics.

    Engine-agnostic: every method advances state deterministically; *when*
    events are drained and *how* the scheduling cycle is scored is the
    driving engine's business.
    """

    def __init__(
        self,
        cfg: PlatformConfig,
        policy: Policy,
        workflows: Sequence[Workflow],
        seed: int = 0,
        trace: bool = False,
        predistributed: Optional[Dict[int, float]] = None,
        redistribute: str = "finish",
        soa: Optional[bool] = None,
        stream: Optional[StreamState] = None,
        profile: Optional[bool] = None,
        events: Union[None, bool, EventLog] = None,
        chaos: Optional[ChaosConfig] = None,
        monitor: Union[None, bool, "obs_monitor.Monitor"] = None,
    ):
        """``predistributed``: wid → spare budget for workflows whose
        arrival-time budget distribution (Algorithm 1 / MSLBL) already ran
        on these task objects.  The distribution is deterministic in
        (cfg, workflow, budget) — policy- and seed-independent — so a grid
        engine computes it once per (workload, budget_mode) and shares the
        result across members instead of recomputing per member.

        ``redistribute``: ``"finish"`` (default) runs Algorithm 3 once per
        task finish — the paper's trigger, bit-exact with the scalar
        reference; ``"round"`` banks each finish's surplus and runs one
        pooled redistribution per workflow per scheduling cycle
        (``flush_redistributions``) — surplus flows coalesce, so results
        may differ in float; the A/B quality comparison lives in
        ``benchmarks/bench_grid_wall.py``.

        ``soa``: True/False/None — per-workflow mutable state layout.
        None (default) resolves to the structure-of-arrays
        ``StreamState`` unless ``REPRO_OBJECT_STATE=1`` forces the
        legacy object layout; both are bit-exact (parity-gated in
        ``tests/test_dispatcher_matrix.py``).

        ``stream``: optional pre-allocated :class:`StreamState` (or a
        :meth:`StreamState.view` segment of an engine-pooled backing)
        sized for this simulation; implies ``soa``.

        ``profile``: True/False/None — per-phase wall-clock counters.
        None (default) defers to ``REPRO_PROFILE=1``; the kwarg lets
        tests and benchmarks toggle per engine without mutating
        ``os.environ``.

        ``events``: None/bool/:class:`~repro_torch.obs.events.EventLog` —
        structured event tracing (repro_torch.obs).  None defers to
        ``REPRO_TRACE=1``; True allocates a fresh log; a log instance
        is used as-is.  Off ⇒ ``self.elog is None`` and every emission
        site is a single attribute-load + None check (same zero-cost
        discipline as ``profile``).

        ``chaos``: optional :class:`repro_torch.chaos.ChaosConfig` — spot
        revocation, task-failure and straggler injection (deterministic
        in (seed, config); see repro_torch.chaos).  ``None`` or an all-zero
        config disables injection entirely: ``self.chaos is None`` and
        every chaos branch is one attribute-load + None test.

        ``monitor``: None/bool/:class:`~repro_torch.obs.monitor.Monitor` —
        the live SLO monitor (repro_torch.obs.monitor).  None defers to
        ``REPRO_MONITOR=1``; when on it subscribes to the event log's
        emit path (``elog.sub``), allocating a log if tracing was off.
        The monitor is reachable from the pickled ``elog`` residue, so
        stream snapshots carry it and resume replays its windows and
        alerts bit-identically."""
        if redistribute not in ("finish", "round"):
            raise ValueError(f"redistribute={redistribute!r} "
                             "(expected 'finish' or 'round')")
        self.cfg = cfg
        self.policy = policy
        self.redistribute = redistribute
        self.workflows = list(workflows)
        self.predistributed = predistributed
        self.pool = VMPool(cfg)
        self.queue: List[Tuple[int, int, int]] = []  # (est_ms, wid, tid)
        self.events: List[Tuple[int, int, int, tuple]] = []
        self._seq = 0
        self.now = 0
        self.n_events = 0
        self.wf_state: Dict[int, Union[_WfState, "_WfView"]] = {}
        self.running: Dict[Tuple[int, int], _Running] = {}
        self.vm_bound: Dict[int, Tuple[int, int]] = {}  # vmid -> (wid, tid)
        self.trace_rows: List[tuple] = [] if trace else None
        # Resource-sharing counters (actuals, accumulated at pipeline
        # start): data-cache bytes served locally vs staged, and container
        # activations by warmth (0 ms / init-only / full download).
        self.data_mb_total = 0.0
        self.data_mb_hit = 0.0
        self.container_warm = 0
        self.container_init = 0
        self.container_cold = 0
        # Opt-in per-phase wall-clock counters (REPRO_PROFILE=1): how much
        # of a run the Algorithm 1/3 budget algebra, selection, and the
        # pipeline math each cost — see BatchSimEngine.dispatch_stats().
        self.profile: Optional[Dict[str, float]] = (
            new_profile()
            if (profile if profile is not None else _profile_enabled())
            else None)
        # Structured event log (repro_torch.obs) — None unless opted in; every
        # emission below is guarded by one `is not None` test.
        self.elog: Optional[EventLog] = obs_events.resolve_events(events)
        # Live SLO monitor (repro_torch.obs.monitor): subscribes to the emit
        # path.  Monitoring implies an event log (the monitor has no
        # other input); with both off the hot path is untouched.
        self.monitor = obs_monitor.resolve_monitor(monitor)
        if self.monitor is not None:
            if self.elog is None:
                self.elog = EventLog()
            self.elog.sub = self.monitor
        total_tasks = sum(w.n_tasks for w in self.workflows)
        # Global per-task degradation tables, indexed by task global id.
        # Kept as plain-float lists: the pipeline math runs per dispatch
        # and numpy scalar arithmetic is several times slower than float
        # (values identical — tolist is value-preserving).
        cpu_deg, bw_in_deg, bw_out_deg = degradation_tables(
            cfg, total_tasks, seed
        )
        self.cpu_deg = cpu_deg.tolist()
        self.bw_in_deg = bw_in_deg.tolist()
        self.bw_out_deg = bw_out_deg.tolist()
        # Fault injection (repro_torch.chaos): None unless a config with at
        # least one live knob is passed; the draw tables are derived
        # state (pure function of config × seed × total_tasks), while
        # the attempt/preemption counters and injection tallies below
        # are mutable state that rides the snapshot residue.
        self.chaos: Optional[ChaosConfig] = (
            chaos if chaos is not None and chaos.enabled else None)
        self.chaos_draws = chaos_draws(self.chaos, total_tasks, seed)
        self.task_attempts: Dict[Tuple[int, int], int] = {}
        self.task_preempts: Dict[Tuple[int, int], int] = {}
        self.revocations = 0
        self.task_failures = 0
        self.task_retries = 0
        self.stragglers_detected = 0
        self.wasted_cost = 0.0
        self.spot_provisioned = 0
        self._task_base: Dict[int, int] = {}
        base = 0
        for w in self.workflows:
            self._task_base[w.wid] = base
            base += w.n_tasks
        # State layout: SoA StreamState (default) vs legacy objects.
        self.soa = (not _object_state_forced()) if soa is None else bool(soa)
        if stream is not None:
            if not self.soa:
                raise ValueError("stream= requires the SoA state layout")
            self.stream: Optional[StreamState] = stream
        else:
            self.stream = (StreamState(len(self.workflows), total_tasks)
                           if self.soa else None)

    # ---- event plumbing ----------------------------------------------------
    def _push(self, t_ms: int, kind: int, payload: tuple) -> None:
        heapq.heappush(self.events, (t_ms, self._seq, kind, payload))
        self._seq += 1

    def _gid(self, wid: int, tid: int) -> int:
        return self._task_base[wid] + tid

    def seed_arrivals(self) -> None:
        for wf in self.workflows:
            self._push(wf.arrival_ms, ARRIVAL, (wf.wid,))

    @property
    def done(self) -> bool:
        return not self.events

    def advance(self) -> bool:
        """Drain every event at the next timestamp; True ⇒ a scheduling
        cycle must follow (the paper's trigger rule)."""
        t_ms = self.events[0][0]
        self.now = t_ms
        need_cycle = False
        while self.events and self.events[0][0] == t_ms:
            _, _, kind, payload = heapq.heappop(self.events)
            self.n_events += 1
            if kind == ARRIVAL:
                self._handle_arrival(payload[0])
                need_cycle = True
            elif kind == FINISH:
                self._handle_finish(*payload)
                need_cycle = True
            elif kind == VM_READY:
                self._handle_vm_ready(payload[0])
            elif kind == REAP:
                self._handle_reap(*payload)
            elif kind == REVOKE:
                # True (⇒ cycle) only when a task was requeued.
                need_cycle |= self._handle_revoke(payload[0])
        return need_cycle

    def post_cycle(self) -> None:
        """Deprovisioning step that follows every scheduling cycle."""
        if self.policy.idle_threshold_ms == 0:
            self.reap_now()

    # ---- handlers --------------------------------------------------------------
    def _handle_arrival(self, wid: int) -> None:
        wf = self.workflows[wid]
        if self.soa:
            st = _WfView(wf, self.stream, wid, self._task_base[wid])
        else:
            st = _WfState(wf=wf)
        st.begin_arrival()
        self.wf_state[wid] = st
        ev = self.elog
        if ev is not None:
            ev.append(obs_events.WF_ARRIVE, self.now, wid, wf.n_tasks,
                      x=wf.budget)
        if self.predistributed is not None and wid in self.predistributed:
            st.spare = self.predistributed[wid]  # tasks already carry budgets
            dist_mode = 2
        elif self.policy.budget_mode == "mslbl":
            t0 = _time.perf_counter() if self.profile is not None else 0.0
            distribute_budget_mslbl(self.cfg, wf, wf.budget)
            if self.profile is not None:
                self.profile["distribute_s"] += _time.perf_counter() - t0
                self.profile["distributions"] += 1
            dist_mode = 1
        else:
            t0 = _time.perf_counter() if self.profile is not None else 0.0
            st.spare = budget_mod.distribute_budget(self.cfg, wf, wf.budget)
            if self.profile is not None:
                self.profile["distribute_s"] += _time.perf_counter() - t0
                self.profile["distributions"] += 1
            dist_mode = 0
        if ev is not None:
            ev.append(obs_events.BUDGET_DISTRIBUTE, self.now, wid,
                      dist_mode, x=st.spare)
        for tid in wf.entry_tasks():
            heapq.heappush(self.queue, (self.now, wid, tid))
            if ev is not None:
                ev.append(obs_events.TASK_READY, self.now, wid, tid)

    def _inputs_of(self, wf: Workflow, task: Task) -> List[Tuple[DataKey, float]]:
        # Static per task (DAG and sizes are immutable once built) and
        # read at least twice per task (selection + pipeline start):
        # memoized on the Task (clones share the list — same wid, same
        # DAG by construction).
        ins = task.inputs_cache
        if ins is not None:
            return ins
        ins = []
        if task.ext_in_mb > 0:
            ins.append((("ext", wf.wid, task.tid), task.ext_in_mb))
        for name, mb in task.shared_in:   # cross-tenant shared data
            ins.append((("shared", name, 0), mb))
        for p in task.parents:
            ins.append((("out", wf.wid, p), wf.tasks[p].out_mb))
        task.inputs_cache = ins
        return ins

    def _handle_finish(self, wid: int, tid: int, attempt: int = 0) -> None:
        ch = self.chaos
        if ch is not None \
                and attempt != self.task_attempts.get((wid, tid), 0):
            return  # stale FINISH of an attempt a revocation already killed
        run = self.running.pop((wid, tid))
        st = self.wf_state[wid]
        wf = st.wf
        task = wf.tasks[tid]
        vm = run.vm
        if ch is not None and ch.fail_prob > 0.0 \
                and self.chaos_draws.fails(self._gid(wid, tid), attempt):
            self._fail_attempt(run, st, wid, tid, attempt)
            return
        # Cache this task's output locally (the resource-sharing policy).
        vm.cache_put(self.cfg, ("out", wid, tid), task.out_mb,
                     self.pool.data_index)
        self.pool.mark_idle(vm, self.now)
        self.vm_bound.pop(vm.vmid, None)
        self._arm_reap(vm)
        # Actual cost (Eq. 5) and budget bookkeeping.
        actual = self._actual_cost_of(run)
        st.cost += actual
        st.remaining -= 1
        st.finish_ms = max(st.finish_ms, self.now)
        ev = self.elog
        if ev is not None:
            ev.append(obs_events.TASK_FINISH, self.now, wid, tid, vm.vmid,
                      x=actual)
            ev.append(obs_events.VM_IDLE, self.now, vm.vmid)
        if ch is not None and run.rt_ms > ch.straggler_factor * run.est_rt_ms:
            # Straggler detection: the *platform-observable* rule — the
            # compute leg exceeded straggler_factor × the undegraded
            # estimate — so natural degradation outliers can trip it too
            # when the factor is set below the degradation ceiling.
            self.stragglers_detected += 1
            if ev is not None:
                ev.append(obs_events.STRAGGLER_DETECT, self.now, wid, tid,
                          vm.vmid, run.rt_ms,
                          x=run.rt_ms / max(run.est_rt_ms, 1))
        if self.policy.budget_mode == "mslbl":
            st.spare += task.budget - actual
            if ev is not None:
                ev.append(obs_events.BUDGET_SPARE, self.now, wid, tid,
                          x=task.budget - actual, y=st.spare)
        elif self.redistribute == "round":
            # Round-batched Algorithm 3: bank the surplus; the pooled
            # redistribution runs once per workflow per scheduling cycle
            # (flush_redistributions), coalescing every finish in between.
            st.pending_surplus += task.budget - actual
            st.pending_events += 1
            if self.profile is not None:
                self.profile["redistribute_events"] += 1
            if ev is not None:
                ev.append(obs_events.BUDGET_SPARE, self.now, wid, tid,
                          x=task.budget - actual, y=st.pending_surplus)
        else:
            # Algorithm 3: one redistribution per task finish.  The array
            # path (core.budget.RedistState) is bit-exact with the scalar
            # reference, which REPRO_SCALAR_REDIST=1 forces back on.
            prof = self.profile
            t0 = _time.perf_counter() if prof is not None else 0.0
            if budget_mod._ARRAY_REDIST:
                rd = st.redist
                if rd is None:
                    rd = st.make_redist(self.cfg)
                st.spare = budget_mod.update_budget_fast(
                    self.cfg, wf, rd, tid, actual, st.spare
                )
            else:
                st.spare = budget_mod.update_budget(
                    self.cfg, wf, tid, actual, st.spare,
                    st.unscheduled_seq()
                )
            if prof is not None:
                prof["redistribute_s"] += _time.perf_counter() - t0
                prof["redistributions"] += 1
                prof["redistribute_events"] += 1
            if ev is not None:
                ev.append(obs_events.BUDGET_REDISTRIBUTE, self.now, wid,
                          tid, 1, x=task.budget - actual, y=st.spare)
        if ev is not None and st.remaining == 0:
            ev.append(obs_events.WF_DONE, self.now, wid, x=st.cost,
                      y=wf.budget)
        # Release ready children.
        for c in task.children:
            if st.dec_pending(c):
                heapq.heappush(self.queue, (self.now, wid, c))
                if ev is not None:
                    ev.append(obs_events.TASK_READY, self.now, wid, c)

    def _actual_cost_of(self, run: _Running) -> float:
        return run.actual_cost  # computed at dispatch time

    # ---- chaos transitions (repro_torch.chaos) ---------------------------------------
    def _fail_attempt(self, run: _Running, st: Union["_WfState", "_WfView"],
                      wid: int, tid: int, attempt: int) -> None:
        """An execution attempt failed: the VM worked (and bills) in full
        but produced no output — no cache_put, no child release; the task
        requeues through the debt-absorbing path."""
        vm = run.vm
        self.pool.mark_idle(vm, self.now)
        self.vm_bound.pop(vm.vmid, None)
        self._arm_reap(vm)
        actual = self._actual_cost_of(run)
        self.task_failures += 1
        self.task_attempts[(wid, tid)] = attempt + 1
        ev = self.elog
        if ev is not None:
            ev.append(obs_events.TASK_FAIL, self.now, wid, tid, vm.vmid,
                      attempt, x=actual)
            ev.append(obs_events.VM_IDLE, self.now, vm.vmid)
        self._requeue_task(st, wid, tid, actual)

    def _requeue_task(self, st: Union["_WfState", "_WfView"], wid: int,
                      tid: int, wasted: float) -> None:
        """Put a killed/failed task back on the ready queue (its parents
        all finished, so it is ready by construction).  The wasted spend
        is real cost (Eq. 5 has no refunds) and is absorbed out of the
        workflow's remaining budget pool via Algorithm 3."""
        st.cost += wasted
        self.wasted_cost += wasted
        self.task_retries += 1
        st.add_unscheduled(tid)
        if st.redist is not None:
            st.redist.mark_unscheduled(tid)
        self._absorb_chaos_debt(st, wasted)
        heapq.heappush(self.queue, (self.now, wid, tid))
        if self.elog is not None:
            key = (wid, tid)
            self.elog.append(obs_events.TASK_RETRY, self.now, wid, tid,
                             self.task_attempts.get(key, 0),
                             self.task_preempts.get(key, 0))

    def _absorb_chaos_debt(self, st: Union["_WfState", "_WfView"],
                           amount: float) -> None:
        """Charge wasted spend to the budget layer: MSLBL pays from its
        spare pot; round-batched banking nets it against pending surplus;
        per-finish Algorithm 3 runs a pooled redistribution with the
        debt as negative surplus (spare + unscheduled sub-budgets absorb
        it, clamped at zero — overruns show up as budget violations,
        exactly like benign cost overruns)."""
        if amount <= 0.0:
            return
        ev = self.elog
        if self.policy.budget_mode == "mslbl":
            st.spare -= amount
            if ev is not None:
                ev.append(obs_events.BUDGET_SPARE, self.now, st.wf.wid, -1,
                          x=-amount, y=st.spare)
        elif self.redistribute == "round":
            st.pending_surplus -= amount
            st.pending_events += 1
            if self.profile is not None:
                self.profile["redistribute_events"] += 1
        else:
            prof = self.profile
            t0 = _time.perf_counter() if prof is not None else 0.0
            if budget_mod._ARRAY_REDIST:
                rd = st.redist
                if rd is None:
                    rd = st.make_redist(self.cfg)
                st.spare = budget_mod.update_budget_pooled(
                    self.cfg, st.wf, rd, -amount, st.spare
                )
            else:
                st.spare = budget_mod.update_budget_pooled_scalar(
                    self.cfg, st.wf, -amount, st.spare,
                    st.unscheduled_seq()
                )
            if prof is not None:
                prof["redistribute_s"] += _time.perf_counter() - t0
                prof["redistributions"] += 1
                prof["redistribute_events"] += 1
            if ev is not None:
                ev.append(obs_events.BUDGET_REDISTRIBUTE, self.now,
                          st.wf.wid, -2, 1, x=-amount, y=st.spare)

    def _handle_revoke(self, vmid: int) -> bool:
        """A spot lease's drawn lifetime elapsed.  Kill the VM whatever
        it was doing — the in-flight task's spend so far is sunk (billed
        per started period at the spot price), its attempt is abandoned
        (the stale FINISH event is invalidated by the attempt counter)
        and it requeues through the normal auction path.  Returns True
        iff a task was requeued (⇒ a scheduling cycle must follow)."""
        vm = self.pool.vms[vmid]
        if vm.status == VM_TERMINATED:
            return False    # reaped/idle-closed before the lifetime elapsed
        bound = self.vm_bound.pop(vmid, None)
        self.revocations += 1
        busy = 1 if vm.status == VM_BUSY else 0
        wid = tid = -1
        wasted = 0.0
        st = None
        if bound is not None:
            wid, tid = bound
            st = self.wf_state[wid]
            run = self.running.pop((wid, tid), None)
            if run is not None:
                # Billing stops at the revocation: started periods of the
                # elapsed pipeline (plus the provision delay the lease
                # triggered, per the benign billing rule).
                elapsed = self.now - run.start_ms
                if run.triggered_provision:
                    elapsed += self.cfg.vm_provision_delay_ms
                if elapsed > 0:
                    bp = self.cfg.billing_period_ms
                    wasted = ((elapsed + bp - 1) // bp) * vm.price_per_bp
                # The dispatch pre-charged the full pipeline to busy_ms;
                # give back the part the revocation cut off.
                vm.busy_ms -= max(0, run.end_ms - self.now)
            key = (wid, tid)
            self.task_attempts[key] = self.task_attempts.get(key, 0) + 1
            self.task_preempts[key] = self.task_preempts.get(key, 0) + 1
        self.pool.revoke(vm, self.now)
        if self.elog is not None:
            self.elog.append(obs_events.VM_REVOKE, self.now, vmid, wid, tid,
                             busy, x=wasted)
        if bound is not None:
            self._requeue_task(st, wid, tid, wasted)
        return bound is not None

    def _provision_for(self, wid: int, tid: int, app: str,
                       vmt_idx: int) -> VM:
        """Provision a VM for a task that found no suitable idle one,
        bind it, and arm its ready event.  Under spot pricing the lease
        is discounted and carries a pre-drawn revocation deadline —
        unless the task has been preempted ``escalate_after`` times
        already, in which case it escalates to on-demand (full price,
        non-revocable)."""
        tag = self.policy.owner_tag(wid, app)
        ch = self.chaos
        if ch is None or not ch.spot_enabled or (
                ch.escalate_after is not None
                and self.task_preempts.get((wid, tid), 0)
                >= ch.escalate_after):
            vm = self.pool.provision(vmt_idx, self.now, tag)
        else:
            vmt = self.cfg.vm_types[vmt_idx]
            vm = self.pool.provision(
                vmt_idx, self.now, tag, spot=True,
                price_per_bp=vmt.cost_per_bp * (1.0 - ch.spot_discount))
            self.spot_provisioned += 1
            if ch.revocation_rate > 0.0:
                self._push(
                    self.now + self.chaos_draws.vm_lifetime_ms(vm.vmid),
                    REVOKE, (vm.vmid,))
        self.vm_bound[vm.vmid] = (wid, tid)
        self._push(vm.ready_ms, VM_READY, (vm.vmid,))
        if self.elog is not None:
            self.elog.append(obs_events.VM_PROVISION, self.now, vm.vmid,
                             vm.vmt_idx)
        return vm

    def _handle_vm_ready(self, vmid: int) -> None:
        vm = self.pool.vms[vmid]
        if vm.status == VM_PROVISIONING:
            ev = self.elog
            if ev is not None:
                ev.append(obs_events.VM_READY, self.now, vmid)
            bound = self.vm_bound.get(vmid)
            if bound is not None:
                self.pool.mark_busy(vm)
                self._start_pipeline(*bound, vm, triggered_provision=True)
            else:
                self.pool.mark_idle(vm, self.now)
                if ev is not None:
                    ev.append(obs_events.VM_IDLE, self.now, vmid)
                self._arm_reap(vm)

    def _arm_reap(self, vm: VM) -> None:
        """Schedule the deferred reap for the idle period that just opened;
        the payload pins the current idle epoch so any reuse invalidates
        the event."""
        if self.policy.idle_threshold_ms > 0:
            self._push(self.now + self.policy.idle_threshold_ms, REAP,
                       (vm.vmid, vm.idle_epoch))

    def _handle_reap(self, vmid: int, idle_epoch: int) -> None:
        """A deferred reap kills its VM only if the idle epoch it was armed
        for is still the current one — any reuse in between (even a
        zero-length pipeline that returns to idle within the same
        millisecond) bumps the epoch and invalidates the reap."""
        vm = self.pool.vms[vmid]
        if vm.status == VM_IDLE and vm.idle_epoch == idle_epoch:
            self.pool.terminate(vm, self.now)
            if self.elog is not None:
                self.elog.append(obs_events.VM_REAP, self.now, vmid)

    def reap_now(self) -> None:
        ev = self.elog
        for vm in self.pool.idle_vms():
            self.pool.terminate(vm, self.now)
            if ev is not None:
                ev.append(obs_events.VM_REAP, self.now, vm.vmid)

    # ---- round-batched Algorithm 3 (redistribute="round") --------------------
    def flush_redistributions(self) -> None:
        """Run the banked pooled redistribution of every workflow with a
        task in the current ready queue — their sub-budgets are about to
        be read by selection.  Workflows with banked surplus but nothing
        queued keep coalescing until they queue again (or finalize)."""
        if self.redistribute != "round" or not self.queue:
            return
        for wid in sorted({e[1] for e in self.queue}):
            st = self.wf_state[wid]
            if st.pending_events:
                self._flush_wf(st)

    def _flush_wf(self, st: Union[_WfState, _WfView]) -> None:
        prof = self.profile
        t0 = _time.perf_counter() if prof is not None else 0.0
        if budget_mod._ARRAY_REDIST:
            rd = st.redist
            if rd is None:
                rd = st.make_redist(self.cfg)
            st.spare = budget_mod.update_budget_pooled(
                self.cfg, st.wf, rd, st.pending_surplus, st.spare
            )
        else:
            st.spare = budget_mod.update_budget_pooled_scalar(
                self.cfg, st.wf, st.pending_surplus, st.spare,
                st.unscheduled_seq()
            )
        if prof is not None:
            prof["redistribute_s"] += _time.perf_counter() - t0
            prof["redistributions"] += 1
        if self.elog is not None:
            self.elog.append(obs_events.BUDGET_REDISTRIBUTE, self.now,
                             st.wf.wid, -1, st.pending_events,
                             x=st.pending_surplus, y=st.spare)
        st.pending_surplus = 0.0
        st.pending_events = 0

    # ---- scheduling cycles (Alg. 2) ------------------------------------------
    def sequential_cycle(self, idle: Optional[List[VM]] = None) -> None:
        """Per-task reference cycle: drain the ready queue in order, calling
        ``scheduler.select`` against the live idle pool for each task."""
        self.flush_redistributions()
        idle = self.pool.idle_vms() if idle is None else idle
        while self.queue:
            est, wid, tid = heapq.heappop(self.queue)
            st = self.wf_state[wid]
            wf = st.wf
            task = wf.tasks[tid]
            budget_eff = task.budget
            if self.policy.budget_mode == "mslbl" and st.spare > 0:
                budget_eff += st.spare
            inputs = self._inputs_of(wf, task)
            t0 = _time.perf_counter() if self.profile is not None else 0.0
            placement = select(
                self.cfg,
                self.policy,
                task,
                wid,
                wf.app,
                inputs,
                budget_eff,
                idle,
                table=cost_tables.table_for(self.cfg, wf),
                pool=self.pool,
            )
            if self.profile is not None:
                self.profile["select_s"] += _time.perf_counter() - t0
                self.profile["selects"] += 1
            ev = self.elog
            if self.policy.budget_mode == "mslbl":
                # Spare consumed by how much the estimate exceeds the base.
                used = max(0.0, placement.est_cost - task.budget)
                spend = min(used, max(st.spare, 0.0))
                st.spare -= spend
                if ev is not None and spend > 0.0:
                    ev.append(obs_events.BUDGET_SPARE, self.now, wid, tid,
                              x=-spend, y=st.spare)
            st.discard_unscheduled(tid)
            if st.redist is not None:
                st.redist.mark_scheduled(tid)
            if ev is not None:
                ev.append(obs_events.TASK_PLACE, self.now, wid, tid,
                          placement.vm.vmid if placement.vm else -1,
                          placement.tier, x=placement.est_cost)
            if placement.vm is not None:
                vm = placement.vm
                self.pool.mark_busy(vm)
                idle = [v for v in idle if v.vmid != vm.vmid]
                self.vm_bound[vm.vmid] = (wid, tid)
                self._start_pipeline(wid, tid, vm, triggered_provision=False)
            else:
                self._provision_for(wid, tid, wf.app, placement.new_vmt_idx)
            if self.trace_rows is not None:
                self.trace_rows.append(
                    (self.now, wid, tid, placement.tier, placement.est_cost,
                     placement.vm.vmid if placement.vm else -1)
                )

    def drain_queue_for_cycle(self) -> Tuple[list, List[CycleMeta], list]:
        """Pop the whole ready queue in heap order; returns the
        (task, app, owner_tag, inputs) rows the auction scores, the
        (wid, tid, inputs) metadata the commit step needs, and the
        per-task cost tables the auction's serial resolution reads."""
        self.flush_redistributions()
        ordered = []
        while self.queue:
            ordered.append(heapq.heappop(self.queue))
        tasks = []
        metas: List[CycleMeta] = []
        tables = []
        for est, wid, tid in ordered:
            st = self.wf_state[wid]
            task = st.wf.tasks[tid]
            tag = self.policy.owner_tag(wid, st.wf.app)
            inputs = self._inputs_of(st.wf, task)
            tasks.append((task, st.wf.app, tag, inputs))
            metas.append((wid, tid, inputs))
            tables.append(cost_tables.table_for(self.cfg, st.wf))
        return tasks, metas, tables

    def apply_cycle_placements(
        self,
        metas: Sequence[CycleMeta],
        placements: Sequence[Optional[Placement]],
        idle: List[VM],
    ) -> None:
        """Commit an auction's outcome in queue order.  ``None`` placements
        fall back to the per-task reference selection against the VMs the
        auction left untaken (provisioning can't conflict, so the fallback
        is final)."""
        remaining = {vm.vmid for vm in idle}
        for (wid, tid, inputs), p in zip(metas, placements):
            st = self.wf_state[wid]
            task = st.wf.tasks[tid]
            if p is None:
                pool = [vm for vm in idle if vm.vmid in remaining
                        and vm.status == VM_IDLE]
                p = select(self.cfg, self.policy, task, wid, st.wf.app,
                           inputs, task.budget, pool,
                           table=cost_tables.table_for(self.cfg, st.wf),
                           pool=self.pool)
            st.discard_unscheduled(tid)
            if st.redist is not None:
                st.redist.mark_scheduled(tid)
            ev = self.elog
            if ev is not None:
                ev.append(obs_events.TASK_PLACE, self.now, wid, tid,
                          p.vm.vmid if p.vm else -1, p.tier, x=p.est_cost)
            if p.vm is not None:
                vm = p.vm
                self.pool.mark_busy(vm)
                remaining.discard(vm.vmid)
                self.vm_bound[vm.vmid] = (wid, tid)
                self._start_pipeline(wid, tid, vm, triggered_provision=False)
            else:
                self._provision_for(wid, tid, st.wf.app, p.new_vmt_idx)
            if self.trace_rows is not None:
                self.trace_rows.append((self.now, wid, tid, p.tier,
                                        p.est_cost,
                                        p.vm.vmid if p.vm else -1))

    # ---- execution pipeline ---------------------------------------------------
    def _start_pipeline(
        self, wid: int, tid: int, vm: VM, triggered_provision: bool
    ) -> None:
        tp0 = _time.perf_counter() if self.profile is not None else 0.0
        st = self.wf_state[wid]
        wf = st.wf
        task = wf.tasks[tid]
        gid = self._gid(wid, tid)
        # 1. container (actual, mutates image cache + the pool's app indexes).
        # Classify warmth from the VM's pre-activation state (the ground
        # truth), not from the returned delay — degenerate configs can make
        # the init and full-provision delays coincide.
        warmth = obs_events.WARMTH_NONE
        if self.policy.use_containers:
            if vm.active_container == wf.app:
                self.container_warm += 1
                warmth = obs_events.WARMTH_WARM
            elif wf.app in vm.image_cache:
                self.container_init += 1
                warmth = obs_events.WARMTH_INIT
            else:
                self.container_cold += 1
                warmth = obs_events.WARMTH_COLD
        c_ms = self.pool.activate_container(vm, wf.app, self.policy.use_containers)
        # 2. input staging: only cache-missing bytes travel.  One pass
        # computes the missing volume and collects the keys to cache
        # (cache_put is a no-op for already-cached keys, so putting only
        # the misses is equivalent).
        inputs = self._inputs_of(wf, task)
        dc = vm.data_cache
        missing = 0.0
        total_mb = 0.0
        to_cache = []
        for item in inputs:
            mb = item[1]
            total_mb += mb
            if item[0] not in dc:
                missing += mb
                to_cache.append(item)
        self.data_mb_total += total_mb
        self.data_mb_hit += total_mb - missing
        for key, mb in to_cache:
            vm.cache_put(self.cfg, key, mb, self.pool.data_index)
        # 3. compute (degraded CPU), 4. write-back to global storage.
        # Eqs. (1)-(3) inlined from core.costs (same float64 op sequence,
        # same tolerance-ceil) — three function hops per task dispatch
        # add up over six-figure task counts.
        cfg = self.cfg
        vmt = vm.vmt
        ceil = _math.ceil
        tol = 1.0 - costs.CEIL_TOL
        if missing > 0.0:
            bw = vmt.bandwidth_mbps * (1.0 - self.bw_in_deg[gid])
            in_ms = int(ceil(
                1000.0 * (missing / bw + missing / cfg.gs_read_mbps) * tol))
        else:
            in_ms = 0
        rt_ms = int(ceil(
            1000.0 * task.size_mi / (vmt.mips * (1.0 - self.cpu_deg[gid]))
            * tol))
        ch = self.chaos
        if ch is not None and ch.straggler_prob > 0.0 \
                and self.chaos_draws.straggler[gid]:
            # Injected straggler: the compute leg runs slowdown× on top
            # of the benign degradation (every attempt — slowness models
            # the task's pathology, not the VM's).
            rt_ms = int(ceil(rt_ms * ch.straggler_slowdown))
        if task.out_mb > 0.0:
            bw = vmt.bandwidth_mbps * (1.0 - self.bw_out_deg[gid])
            out_ms = int(ceil(
                1000.0 * (task.out_mb / bw + task.out_mb / cfg.gs_write_mbps)
                * tol))
        else:
            out_ms = 0
        pipe_ms = c_ms + in_ms + rt_ms + out_ms
        finish = self.now + pipe_ms
        vm.busy_ms += pipe_ms
        billed = pipe_ms + (
            cfg.vm_provision_delay_ms if triggered_provision else 0
        )
        bp = cfg.billing_period_ms
        # Bills at the lease's own rate: identical to vmt.cost_per_bp on
        # on-demand VMs, discounted on spot leases (repro_torch.chaos).
        actual_cost = ((billed + bp - 1) // bp) * vm.price_per_bp
        run = _Running(wid, tid, vm, triggered_provision, actual_cost)
        self.running[(wid, tid)] = run
        if ch is None:
            self._push(finish, FINISH, (wid, tid))
        else:
            # Chaos bookkeeping: pro-rated revocation billing needs the
            # pipeline bounds, straggler detection the compute legs, and
            # the FINISH payload pins the attempt so a revocation's
            # stale event can be told apart from the live re-execution.
            run.start_ms = self.now
            run.end_ms = finish
            run.rt_ms = rt_ms
            run.est_rt_ms = costs.runtime_ms(vmt, task.size_mi)
            self._push(finish, FINISH,
                       (wid, tid, self.task_attempts.get((wid, tid), 0)))
        ev = self.elog
        if ev is not None:
            ev.append(obs_events.VM_BUSY, self.now, vm.vmid)
            if warmth > obs_events.WARMTH_WARM:
                # Activation that cost time (image init or full download).
                ev.append(obs_events.VM_CONTAINER, self.now, vm.vmid,
                          warmth)
            ev.append(obs_events.TASK_START, self.now, wid, tid, vm.vmid,
                      warmth, x=missing, y=total_mb)
        if self.profile is not None:
            self.profile["pipeline_s"] += _time.perf_counter() - tp0
            self.profile["pipelines"] += 1

    # ---- results ---------------------------------------------------------------
    def _fleet_stats(self) -> Tuple[int, float]:
        """(peak concurrent VMs, time-weighted mean fleet size) from the
        pool's lease intervals, via the shared ``obs.timeseries``
        reconstruction — the same path the event-derived fleet series
        uses, so traces and end-of-run aggregates cannot disagree.
        Every VM is terminated by finalize, so both endpoints are
        defined."""
        return obs_ts.peak_and_mean(
            (vm.lease_start_ms for vm in self.pool.vms),
            (vm.terminated_ms if vm.terminated_ms >= 0 else self.now
             for vm in self.pool.vms))

    def finalize(self, wall_s: float = 0.0) -> SimResult:
        if self.redistribute == "round":
            # Flush any still-banked surplus so spare/budget invariants
            # hold post-run (results don't read budgets, but tests and
            # conservation checks do).
            for st in self.wf_state.values():
                if st.pending_events:
                    self._flush_wf(st)
        if self.elog is not None:
            # Close the remaining leases in the event stream before the
            # pool stamps their termination — the event-derived fleet
            # series ends exactly where the lease intervals do.
            for vm in self.pool.vms:
                if vm.terminated_ms < 0:
                    self.elog.append(obs_events.VM_REAP, self.now,
                                     vm.vmid, 1)
        self.pool.finalize(self.now)
        if self.monitor is not None:
            # Flush the remaining sample boundaries (the closing reaps
            # above already streamed through the subscriber) and stamp
            # the horizon; open alerts keep cleared_ms = -1.
            self.monitor.finalize(self.now)
        peak_vms, mean_fleet = self._fleet_stats()
        results = [
            WorkflowResult(
                wid=s.wf.wid,
                app=s.wf.app,
                n_tasks=s.wf.n_tasks,
                budget=s.wf.budget,
                cost=s.cost,
                arrival_ms=s.wf.arrival_ms,
                finish_ms=s.finish_ms,
            )
            for s in self.wf_state.values()
        ]
        return SimResult(
            workflows=results,
            vm_seconds_by_type=self.pool.vm_seconds_by_type,
            vm_busy_seconds_by_type=self.pool.vm_busy_seconds_by_type,
            vm_count_by_type=self.pool.vm_count_by_type,
            total_events=self.n_events,
            wall_s=wall_s,
            data_mb_total=self.data_mb_total,
            data_mb_hit=self.data_mb_hit,
            container_warm=self.container_warm,
            container_init=self.container_init,
            container_cold=self.container_cold,
            peak_vms=peak_vms,
            mean_fleet_vms=mean_fleet,
            revocations=self.revocations,
            task_failures=self.task_failures,
            task_retries=self.task_retries,
            stragglers_detected=self.stragglers_detected,
            wasted_cost=self.wasted_cost,
            spot_vms=self.spot_provisioned,
        )


    # ---- checkpoint / resume ---------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Serializable snapshot: ``{"arrays", "residue", "version"}``.

        ``arrays`` is the StreamState persisted block (gathered from the
        object layout when ``soa=False`` — the interchange format is
        layout-independent, so a snapshot written by either layout
        restores into either) plus the per-task mutable ``Task`` fields
        Algorithm 1/3 writes (budget/level/rank), in global-id order;
        an ``order`` array preserves ``wf_state`` insertion order
        (finalize and metric grouping iterate it).  ``residue`` is one
        pickle of the heap-ordered event/queue lists, clocks, the VM
        pool with in-flight pipelines (pickled together so VM object
        identity between ``running`` and the pool survives), trace rows
        and the resource-sharing counters.  Derived state — Algorithm-3
        pools, cost tables, rank/input caches — is rebuilt lazily and
        bit-identically after :meth:`load_snapshot`."""
        n_wf = len(self.workflows)
        total_tasks = sum(w.n_tasks for w in self.workflows)
        if self.soa:
            arrays = self.stream.snapshot_arrays()
        else:
            arrays = {name: np.zeros(n_wf if per_wf else total_tasks,
                                     dtype=dt)
                      for per_wf, fields in
                      ((True, StreamState.WF_FIELDS),
                       (False, StreamState.TASK_FIELDS))
                      for name, dt in fields}
            for wid, st in self.wf_state.items():
                arrays["arrived"][wid] = True
                for name in ("spare", "cost", "pending_surplus",
                             "remaining", "finish_ms", "pending_events"):
                    arrays[name][wid] = getattr(st, name)
                t0 = self._task_base[wid]
                pp = arrays["pending_parents"]
                for tid, v in st.pending_parents.items():
                    pp[t0 + tid] = v
                un = arrays["unscheduled"]
                for tid in st.unscheduled:
                    un[t0 + tid] = True
        arrays["order"] = np.fromiter(self.wf_state, np.int64,
                                      count=len(self.wf_state))
        arrays["task_budget"] = np.array(
            [t.budget for w in self.workflows for t in w.tasks], np.float64)
        arrays["task_level"] = np.array(
            [t.level for w in self.workflows for t in w.tasks], np.int64)
        arrays["task_rank"] = np.array(
            [t.rank for w in self.workflows for t in w.tasks], np.int64)
        residue = _pickle.dumps({
            "events": self.events,
            "queue": self.queue,
            "seq": self._seq,
            "now": self.now,
            "n_events": self.n_events,
            "pool": self.pool,
            "running": self.running,
            "vm_bound": self.vm_bound,
            "trace_rows": self.trace_rows,
            "data_mb_total": self.data_mb_total,
            "data_mb_hit": self.data_mb_hit,
            "container_warm": self.container_warm,
            "container_init": self.container_init,
            "container_cold": self.container_cold,
            "profile": self.profile,
            "elog": self.elog,
            # Chaos mutable state (v2): attempt/preemption counters and
            # run tallies.  The draw tables are derived state — rebuilt
            # bit-identically from (config, seed) at construction.
            "task_attempts": self.task_attempts,
            "task_preempts": self.task_preempts,
            "chaos_counters": (
                self.revocations, self.task_failures, self.task_retries,
                self.stragglers_detected, self.wasted_cost,
                self.spot_provisioned),
        }, protocol=_pickle.HIGHEST_PROTOCOL)
        return {"arrays": arrays, "residue": residue,
                "version": STREAM_SNAPSHOT_VERSION}

    def load_snapshot(self, snap: Dict[str, object]) -> None:
        """Restore a :meth:`snapshot` into this freshly-constructed state
        (same cfg/policy/workloads/seed/redistribute — the caller
        rebuilds those deterministically; only mutable state loads)."""
        if snap.get("version", 1) > STREAM_SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {snap.get('version')} is newer than "
                f"supported {STREAM_SNAPSHOT_VERSION}")
        arrays: Dict[str, np.ndarray] = snap["arrays"]
        residue = _pickle.loads(snap["residue"])
        # Mutable per-task fields written by Algorithm 1/3 / MSLBL.
        tb = arrays["task_budget"].tolist()
        tl = arrays["task_level"].tolist()
        tr = arrays["task_rank"].tolist()
        i = 0
        for wf in self.workflows:
            wf.rank_cache = None    # rebuilt from the restored ranks
            for t in wf.tasks:
                t.budget = tb[i]
                t.level = tl[i]
                t.rank = tr[i]
                i += 1
        # Per-workflow state, in the checkpointed insertion order.
        order = arrays["order"].tolist()
        self.wf_state = {}
        if self.soa:
            self.stream.load_arrays(arrays)
            for wid in order:
                self.wf_state[wid] = _WfView(
                    self.workflows[wid], self.stream, wid,
                    self._task_base[wid])
        else:
            for wid in order:
                wf = self.workflows[wid]
                t0 = self._task_base[wid]
                n = wf.n_tasks
                st = _WfState(wf=wf)
                st.spare = float(arrays["spare"][wid])
                st.cost = float(arrays["cost"][wid])
                st.pending_surplus = float(arrays["pending_surplus"][wid])
                st.remaining = int(arrays["remaining"][wid])
                st.finish_ms = int(arrays["finish_ms"][wid])
                st.pending_events = int(arrays["pending_events"][wid])
                st.unscheduled = set(np.flatnonzero(
                    arrays["unscheduled"][t0:t0 + n]).tolist())
                st.pending_parents = dict(enumerate(
                    arrays["pending_parents"][t0:t0 + n].tolist()))
                self.wf_state[wid] = st
        # Event plumbing + pool (one pickle: VM identity is preserved
        # between running pipelines, vm_bound and the pool's own maps).
        self.events = residue["events"]
        self.queue = residue["queue"]
        self._seq = residue["seq"]
        self.now = residue["now"]
        self.n_events = residue["n_events"]
        self.pool = residue["pool"]
        self.running = residue["running"]
        self.vm_bound = residue["vm_bound"]
        self.trace_rows = residue["trace_rows"]
        self.data_mb_total = residue["data_mb_total"]
        self.data_mb_hit = residue["data_mb_hit"]
        self.container_warm = residue["container_warm"]
        self.container_init = residue["container_init"]
        self.container_cold = residue["container_cold"]
        self.profile = residue["profile"]
        # Snapshots from before the obs subsystem lack the key; a log
        # restored from the cut replaces whatever the constructor made,
        # so resumed traces are byte-identical with uninterrupted runs.
        self.elog = residue.get("elog")
        # The live monitor rides the elog residue (elog.sub): restoring
        # the log restores its windows, gates and alert history, so a
        # resumed stream replays alerts bit-identically.  Monitoring
        # strictly follows the restored stream — a monitor created by
        # this constructor is dropped if the snapshot ran without one.
        self.monitor = getattr(self.elog, "sub", None)
        # v1 snapshots (pre-chaos) default to the benign zeros.
        self.task_attempts = residue.get("task_attempts", {})
        self.task_preempts = residue.get("task_preempts", {})
        (self.revocations, self.task_failures, self.task_retries,
         self.stragglers_detected, self.wasted_cost,
         self.spot_provisioned) = residue.get(
            "chaos_counters", (0, 0, 0, 0, 0.0, 0))


class SimEngine(SimState):
    """One policy × one workload → SimResult (sequential engine)."""

    def __init__(
        self,
        cfg: PlatformConfig,
        policy: Policy,
        workflows: Sequence[Workflow],
        seed: int = 0,
        trace: bool = False,
        batched: object = "auto",
        predistributed: Optional[Dict[int, float]] = None,
        redistribute: str = "finish",
        soa: Optional[bool] = None,
        profile: Optional[bool] = None,
        events: Union[None, bool, EventLog] = None,
        chaos: Optional[ChaosConfig] = None,
        monitor: Union[None, bool, "obs_monitor.Monitor"] = None,
        device: Union[None, str, "torch.device"] = None,
    ):
        """``batched``: True / False / "auto" — use the batched
        scheduling cycle (core.cycles) when the queue×pool product is
        large.  EBPSM-family policies only; MSLBL mutates spare budget
        mid-cycle and stays sequential.

        ``device``: where batched cycles are scored — ``None`` means
        ``"cuda"`` (the CUDA affinity kernel) and raises when no CUDA
        device is available; ``"cpu"`` runs the plain torch version.

        ``profile`` / ``events``: per-engine toggles for the phase
        counters and the structured event log (None defers to
        ``REPRO_PROFILE`` / ``REPRO_TRACE``; see :class:`SimState`).

        ``chaos``: fault-injection knobs (:class:`repro_torch.chaos.ChaosConfig`);
        None or all-zero ⇒ the benign engine, bit-for-bit."""
        super().__init__(cfg, policy, workflows, seed=seed, trace=trace,
                         predistributed=predistributed,
                         redistribute=redistribute, soa=soa,
                         profile=profile, events=events, chaos=chaos,
                         monitor=monitor)
        self.batched = batched
        self.device = resolve_device(device)

    # ---- main loop -----------------------------------------------------------
    def run(self) -> SimResult:
        t0 = _time.time()
        self.seed_arrivals()
        while self.events:
            if self.advance():
                self._schedule_cycle()
                self.post_cycle()
        return self.finalize(wall_s=_time.time() - t0)

    # ---- scheduling cycle (Alg. 2 loop) ------------------------------------
    def _use_batched(self, n_queue: int, n_idle: int) -> bool:
        if self.policy.budget_mode != "ebpsm":
            return False
        if self.batched is True:
            return True
        if self.batched == "auto":
            return n_queue * n_idle >= AUCTION_MIN_PAIRS
        return False

    def _schedule_cycle(self) -> None:
        idle = self.pool.idle_vms()
        if self.queue and self._use_batched(len(self.queue), len(idle)):
            self._schedule_cycle_batched(idle)
            return
        self.sequential_cycle(idle)

    def _schedule_cycle_batched(self, idle: List[VM]) -> None:
        """Whole-queue scheduling via the affinity kernel + auction
        (core.cycles).  Matches the sequential outcome exactly while
        budgets are sufficient (see the core.cycles docstring)."""
        from .cycles import batched_cycle

        tasks, metas, tables = self.drain_queue_for_cycle()
        placements = batched_cycle(self.cfg, self.policy, tasks, idle,
                                   self.pool, device=self.device,
                                   tables=tables)
        self.apply_cycle_placements(metas, placements, idle)


def simulate(
    cfg: PlatformConfig,
    policy: Policy,
    workflows: Sequence[Workflow],
    seed: int = 0,
    device: Union[None, str, "torch.device"] = None,
) -> SimResult:
    """Convenience wrapper: run one simulation."""
    return SimEngine(cfg, policy, workflows, seed=seed, device=device).run()
