"""Batched simulation engine: a whole experiment grid per device pass.

The paper's headline comparison (EBPSM variants vs MSLBL_MW across
arrival rates, budgets and seeds) needs hundreds of independent
simulations.  Running them one ``SimEngine`` at a time leaves the device
idle between tiny kernel calls; running them here batches the hot path.

Architecture
------------
Every grid member (policy × workload × seed) owns a :class:`SimState`
(``core.engine``) — the single source of truth for arrival / finish /
VM_READY / REAP handling, the execution pipeline, and Algorithm 3 budget
redistribution.  :class:`BatchSimEngine` drives members as coroutines
that **rendezvous at auction points**:

1. each member runs uninterrupted — full cache locality, zero
   per-timestamp lockstep overhead — until its next scheduling cycle
   with queued tasks (EBPSM family) or until it completes;
2. the grid engine decides **per rendezvous round, on aggregate size**: when
   the summed queue × pool pair count of every parked member clears
   ``AUCTION_MIN_PAIRS_ROUND``, all parked cycles are auctioned together
   — pair arrays stack into one resident ``[B, T, V]`` buffer scored by
   a single batched affinity kernel call
   (``kernels.affinity.ops.affinity_batch``, ``core.cycles``);
   below the threshold each parked cycle runs the per-task reference
   path instead (bit-exact either way);
3. placements commit through the shared ``apply_cycle_placements`` and
   each member resumes toward its next cycle.

Members are independent simulations, so the interleaving is free to
choose; rendezvous maximizes sharing (every batched kernel call carries
*all* members with a pending cycle, not just the ones whose event
timestamps happened to coincide — dozens of individually small cycles
batch into one device call) while members that never park — MSLBL, or
``batched=False`` — run start-to-finish in one slice, exactly like the
sequential reference.

Because the transition semantics are shared code and the auction is the
property-tested ``cycles`` fixed point, results are bit-exact with
the sequential reference (tests/test_torch_engine.py) in the paper's
sufficient-budget regime.  MSLBL mutates spare budget mid-cycle, so
MSLBL members run the per-task reference cycle inside their own slice
(exactly as ``SimEngine`` itself does).

Grid members simulate a structural-sharing clone of their workload
(``Workflow.clone``): per-member ``Task`` objects for the mutable budget
fields, shared immutable DAG lists — not a ``copy.deepcopy`` of the
whole object graph.
"""
from __future__ import annotations

import dataclasses
import pickle as _pickle
import time as _time
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from . import budget as budget_mod
from ..chaos import ChaosConfig
from .engine import (STREAM_SNAPSHOT_VERSION, SimState,
                     _object_state_forced, load_residue,
                     profile_overhead_s)
from .cycles import CycleRequest, multi_cycle
from ..device import resolve_device
from ..obs import events as obs_events
from ..obs import monitor as obs_monitor
from ..obs.events import EventLog
from .mslbl import distribute_budget_mslbl
from .scheduler import Policy
from .types import PlatformConfig, SimResult, StreamState, Workflow, \
    clone_workload

# One grid member: (policy, workflows, degradation seed).
GridMember = Tuple[Policy, Sequence[Workflow], int]

# Legacy per-member auction threshold (queue × pool pairs), kept for the
# ``batched="member"`` compatibility mode the grid-wall benchmark uses as
# its measured baseline.  The default dispatcher decides on *aggregate*
# round size instead (below).
AUCTION_MIN_PAIRS_GRID = 2048

# Aggregate-round auction threshold: at each rendezvous the grid engine sums
# every parked member's queue × pool pair product and rides one batched
# ``multi_cycle`` whenever the round total clears this.  Much lower than
# the per-member threshold — one resident [B, T, V] kernel call amortizes
# across all parked members, so dozens of small cycles that individually
# never justified a device call now batch into one.
AUCTION_MIN_PAIRS_ROUND = 1536

# What a member yields when it parks at a pending scheduling cycle:
# (state, idle snapshot).  The grid engine decides serial vs batched.
_CyclePoint = Tuple[SimState, list]


class StreamInterrupted(Exception):
    """Raised by :meth:`BatchSimEngine.run` when the checkpoint hook asks
    the stream to stop after a snapshot — the caller resumes later from
    the written checkpoint (``repro.exp.run --resume``)."""


class BatchSimEngine:
    """N independent simulations, rendezvous rounds, batched cycle scoring."""

    def __init__(
        self,
        cfg: PlatformConfig,
        members: Sequence[GridMember],
        trace: bool = False,
        device: Union[None, str, "torch.device"] = None,
        batched: object = "auto",
        predistributed: Optional[Sequence[Optional[Dict[int, float]]]] = None,
        redistribute: str = "finish",
        soa: Optional[bool] = None,
        profile: Optional[bool] = None,
        events: Optional[bool] = None,
        chaos: Optional[ChaosConfig] = None,
        monitor: Optional[bool] = None,
        monitor_maps: Optional[Tuple[Dict[int, str], Dict[str, str],
                                     Dict[int, int]]] = None,
    ):
        """``batched``: False / True / "auto" / "member".

        * ``"auto"`` (default) — the aggregate-round dispatcher: members
          park at every EBPSM scheduling cycle; a rendezvous round rides
          the batched auction when the summed queue×pool pairs of all
          parked members reach ``AUCTION_MIN_PAIRS_ROUND``, else each
          parked cycle runs the per-task reference path.
        * ``True`` — every parked round is auctioned; ``False`` — members
          never park (pure sequential reference, one slice per member).
        * ``"member"`` — the pre-aggregate per-member rule (pairs ≥
          ``AUCTION_MIN_PAIRS_GRID``), kept as the benchmark baseline.

        Outcomes are bit-exact with ``SimEngine`` on every path,
        including insufficient-budget tier-5 cycles.

        ``device``: where batched rounds are scored — ``None`` means
        ``"cuda"`` (the CUDA affinity kernel) and raises when no CUDA
        device is available; ``"cpu"`` runs the plain torch version
        (both parity-gated).

        ``predistributed``: optional per-member wid → spare maps for
        workloads whose arrival-time budget distribution already ran (see
        ``predistribute_workload`` / ``SimState``).

        ``redistribute``: ``"finish"`` (default, per-task-finish Algorithm
        3, bit-exact with ``SimEngine``) or ``"round"`` — each member
        banks finish surpluses and redistributes once per workflow per
        scheduling cycle, so all finish events inside one rendezvous
        round coalesce into a single array call (shared ``SimState``
        semantics: engine↔engine parity holds in both modes).

        ``soa``: state layout (see ``SimState``).  In SoA mode (the
        default) the engine allocates ONE pooled :class:`StreamState`
        spanning every member and hands each ``SimState`` a zero-copy
        :meth:`StreamState.view` segment — thousands of open-stream
        members share a handful of flat numpy arrays instead of carrying
        per-member object graphs, and grid-level aggregates
        (:meth:`stream_stats`) reduce over the pooled arrays directly.

        ``profile`` / ``events``: per-engine toggles (None defers to
        ``REPRO_PROFILE`` / ``REPRO_TRACE``).  With events on, every
        member ``SimState`` gets its own log (exported per cell by
        ``repro.exp.run --trace-dir``) and the grid engine keeps a separate
        :class:`EventLog` of grid-level events — rendezvous rounds and
        batched auction calls, timestamped by round index (grid events
        span members, so no single simulated clock applies).

        ``chaos``: fault-injection knobs (:class:`repro_torch.chaos.ChaosConfig`)
        applied to every member — each member's draws are keyed by its own
        seed, and injections stay bit-exact with a ``SimEngine`` run of
        the same (policy, workflows, seed, chaos)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batched = batched
        self.redistribute = redistribute
        pre = predistributed or [None] * len(members)
        soa_resolved = (not _object_state_forced()) if soa is None \
            else bool(soa)
        self.stream: Optional[StreamState] = None
        views: List[Optional[StreamState]] = [None] * len(members)
        if soa_resolved and members:
            wf_counts = [len(wfs) for _, wfs, _ in members]
            task_counts = [sum(w.n_tasks for w in wfs)
                           for _, wfs, _ in members]
            self.stream = StreamState(sum(wf_counts), sum(task_counts))
            wf_lo = task_lo = 0
            for i, (nw, nt) in enumerate(zip(wf_counts, task_counts)):
                views[i] = self.stream.view(wf_lo, wf_lo + nw,
                                            task_lo, task_lo + nt)
                wf_lo += nw
                task_lo += nt
        ev_enabled = (obs_events._trace_enabled() if events is None
                      else bool(events))
        self.elog: Optional[EventLog] = EventLog() if ev_enabled else None
        # Live SLO monitor: one independent Monitor per member (windows
        # and alerts are per-simulation state), sharing one optional
        # (tenant_of, qos_of, ideal_ms) map tuple — online streams run
        # every policy member over the same tenant workload.  The grid engine
        # log gets no monitor (GRID_* rounds are not platform signals).
        mon_enabled = (obs_monitor._monitor_enabled() if monitor is None
                       else bool(monitor))
        t_of, q_of, i_ms = monitor_maps or (None, None, None)
        self.states = [
            SimState(cfg, policy, workflows, seed=seed, trace=trace,
                     predistributed=p, redistribute=redistribute,
                     soa=soa_resolved, stream=v, profile=profile,
                     events=ev_enabled, chaos=chaos,
                     monitor=(obs_monitor.Monitor(tenant_of=t_of,
                                                  qos_of=q_of,
                                                  ideal_ms=i_ms)
                              if mon_enabled else False))
            for ((policy, workflows, seed), p, v) in zip(members, pre, views)
        ]
        self._resumed = False
        self.rounds = 0
        self.batched_calls = 0
        self.batched_cycles = 0     # member-cycles scored by the kernel
        self.serial_cycles = 0      # parked member-cycles run per-task
        self.round_pairs: List[int] = []          # aggregate pairs / round
        self.batched_member_pairs: List[int] = []  # per-member pairs when batched
        self.wall_s = 0.0  # whole-grid wall clock of the last run()

    def _member_steps(self, st: SimState) -> Iterator[_CyclePoint]:
        """Run one member until its next pending scheduling cycle (yield)
        or until it completes.  EBPSM-family members park at *every*
        cycle with queued tasks — the grid engine owns the serial-vs-batched
        decision per rendezvous round; MSLBL mutates spare budget
        mid-cycle and runs the per-task reference path in its own slice,
        exactly like ``SimEngine``."""
        park = self.batched is not False \
            and st.policy.budget_mode == "ebpsm"
        while not st.done:
            if not st.advance():
                continue
            idle = st.pool.idle_vms()
            if park and st.queue:
                yield st, idle
            else:
                st.sequential_cycle(idle)
                st.post_cycle()

    def _round_rides_kernel(self, points: List[_CyclePoint],
                            pairs: List[int]) -> List[bool]:
        """The dispatcher: which parked cycles of this round are auctioned.
        Zero-pair cycles (no idle VMs — pure provisioning fallback) never
        ride: the kernel has nothing to score for them."""
        self.round_pairs.append(sum(pairs))
        if self.batched is True:
            return [p > 0 for p in pairs]
        if self.batched == "member":
            return [p >= AUCTION_MIN_PAIRS_GRID for p in pairs]
        # "auto": one aggregate decision for the whole rendezvous round.
        ride = sum(pairs) >= AUCTION_MIN_PAIRS_ROUND
        return [ride and p > 0 for p in pairs]

    def run(
        self,
        ckpt_hook: Optional[Callable[["BatchSimEngine"], bool]] = None,
    ) -> List[SimResult]:
        """``ckpt_hook``: called at the top of every rendezvous round —
        the one point where every live member sits at a generator yield
        with its pending cycle fully committed, so :meth:`snapshot` is
        a consistent cut (fresh ``_member_steps`` generators over the
        restored states resume bit-identically).  The hook owns the
        save-rate decision; returning True stops the stream by raising
        :class:`StreamInterrupted` (resume later via
        :meth:`load_snapshot` + ``run()``)."""
        t0 = _time.time()
        if not self._resumed:
            for st in self.states:
                st.seed_arrivals()
        live = [self._member_steps(st) for st in self.states]
        while live:
            if ckpt_hook is not None and ckpt_hook(self):
                self.wall_s += _time.time() - t0
                raise StreamInterrupted(
                    f"stream stopped by checkpoint hook at round "
                    f"{self.rounds}")
            self.rounds += 1
            points: List[_CyclePoint] = []
            parked: List[Iterator[_CyclePoint]] = []
            for stepper in live:
                point = next(stepper, None)
                if point is None:
                    continue  # member ran to completion
                points.append(point)
                parked.append(stepper)
            if not points:
                break
            owners: List[Tuple[SimState, list, list]] = []
            requests: List[CycleRequest] = []
            pairs = [len(st.queue) * len(idle) for st, idle in points]
            ride_pairs = 0
            for (st, idle), p, ride in zip(points, pairs,
                                           self._round_rides_kernel(points,
                                                                    pairs)):
                if ride:
                    self.batched_cycles += 1
                    self.batched_member_pairs.append(p)
                    ride_pairs += p
                    tasks, metas, tables = st.drain_queue_for_cycle()
                    owners.append((st, metas, idle))
                    requests.append(CycleRequest(
                        self.cfg, st.policy, tasks, idle, st.pool,
                        tables=tables))
                else:
                    self.serial_cycles += 1
                    st.sequential_cycle(idle)
                    st.post_cycle()
            if self.elog is not None:
                self.elog.append(obs_events.GRID_ROUND, self.rounds,
                                 self.rounds, len(points), len(requests),
                                 sum(pairs))
            if requests:
                self.batched_calls += 1
                if self.elog is not None:
                    self.elog.append(obs_events.GRID_AUCTION, self.rounds,
                                     self.rounds, len(requests),
                                     d=ride_pairs)
                all_placements = multi_cycle(self.cfg, requests,
                                             device=self.device)
                for (st, metas, idle), placements in zip(owners,
                                                         all_placements):
                    st.apply_cycle_placements(metas, placements, idle)
                    st.post_cycle()
            live = parked
        # Accumulate (not assign): a resumed stream's wall includes the
        # pre-interrupt segments restored by load_snapshot.
        self.wall_s += _time.time() - t0
        # Per-member wall is the amortized share of the grid run (they sum
        # to the total); the whole-grid wall lives on the engine/BatchResult.
        share = self.wall_s / len(self.states) if self.states else 0.0
        return [st.finalize(wall_s=share) for st in self.states]

    # ---- checkpoint / resume -------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """One consistent cut of the whole stream: every member's
        :meth:`SimState.snapshot` arrays keyed ``m<i>.<name>`` plus the
        engine's dispatch counters, shaped for
        ``repro.ckpt.checkpoint.save_stream``.  Only valid at a
        rendezvous-round boundary (see :meth:`run`)."""
        arrays: Dict[str, np.ndarray] = {}
        residues: List[bytes] = []
        for i, st in enumerate(self.states):
            snap = st.snapshot()
            for name, arr in snap["arrays"].items():
                arrays[f"m{i:04d}.{name}"] = arr
            residues.append(snap["residue"])
        residue = _pickle.dumps({
            "members": residues,
            "counters": {
                "rounds": self.rounds,
                "batched_calls": self.batched_calls,
                "batched_cycles": self.batched_cycles,
                "serial_cycles": self.serial_cycles,
                "round_pairs": self.round_pairs,
                "batched_member_pairs": self.batched_member_pairs,
                "wall_s": self.wall_s,
                "elog": self.elog,
            },
        }, protocol=_pickle.HIGHEST_PROTOCOL)
        return {"arrays": arrays, "residue": residue,
                "version": STREAM_SNAPSHOT_VERSION,
                "n_members": len(self.states)}

    def load_snapshot(self, snap: Dict[str, object]) -> None:
        """Restore a :meth:`snapshot` into this freshly-constructed
        engine (same cfg/members/modes).  The next :meth:`run` skips
        ``seed_arrivals`` and continues the stream bit-identically."""
        if snap.get("n_members", len(self.states)) != len(self.states):
            raise ValueError(
                f"snapshot has {snap.get('n_members')} members, "
                f"engine has {len(self.states)}")
        residue = load_residue(snap["residue"])
        arrays: Dict[str, np.ndarray] = snap["arrays"]
        version = snap.get("version", 1)
        per_member: List[Dict[str, np.ndarray]] = \
            [{} for _ in self.states]
        for key, arr in arrays.items():
            prefix, name = key.split(".", 1)
            per_member[int(prefix[1:])][name] = arr
        for st, member_arrays, member_residue in zip(
                self.states, per_member, residue["members"]):
            st.load_snapshot({"arrays": member_arrays,
                              "residue": member_residue,
                              "version": version})
        c = residue["counters"]
        self.rounds = c["rounds"]
        self.batched_calls = c["batched_calls"]
        self.batched_cycles = c["batched_cycles"]
        self.serial_cycles = c["serial_cycles"]
        self.round_pairs = list(c["round_pairs"])
        self.batched_member_pairs = list(c["batched_member_pairs"])
        self.wall_s = c["wall_s"]
        self.elog = c.get("elog")
        self._resumed = True

    def stream_stats(self) -> Dict[str, float]:
        """Whole-stream aggregates reduced straight off the pooled
        StreamState arrays (no per-member iteration); falls back to the
        per-state objects under ``REPRO_OBJECT_STATE=1``."""
        if self.stream is not None:
            arrived = int(self.stream.arrived.sum())
            open_wfs = int((self.stream.arrived
                            & (self.stream.remaining > 0)).sum())
            tasks_left = int(self.stream.remaining.sum())
            spare = float(self.stream.spare.sum())
        else:
            arrived = open_wfs = tasks_left = 0
            spare = 0.0
            for st in self.states:
                for wst in st.wf_state.values():
                    arrived += 1
                    open_wfs += wst.remaining > 0
                    tasks_left += wst.remaining
                    spare += wst.spare
        return {"workflows_arrived": arrived, "workflows_open": open_wfs,
                "tasks_remaining": tasks_left, "spare_budget": spare}

    def dispatch_stats(self) -> Dict[str, object]:
        """Aggregate-auction observability for benchmarks and reports."""
        hist: Dict[str, int] = {}
        for p in self.round_pairs:
            b = 1 << max(int(p) - 1, 0).bit_length() if p else 0
            key = str(b)
            hist[key] = hist.get(key, 0) + 1
        out: Dict[str, object] = {
            "rounds": self.rounds,
            "redistribute_mode": self.redistribute,
            "batched_calls": self.batched_calls,
            "batched_cycles": self.batched_cycles,
            "serial_cycles": self.serial_cycles,
            "aggregate_pairs_hist": hist,
            "max_member_pairs_batched": max(self.batched_member_pairs,
                                            default=0),
            "min_member_pairs_batched": min(self.batched_member_pairs,
                                            default=0),
        }
        # Structured-event counts (repro_torch.obs): member logs + the grid engine
        # log, summed per kind; {"enabled": False, ...} when tracing is
        # off so consumers can key on the block unconditionally.
        out["events"] = obs_events.events_block(
            [st.elog for st in self.states] + [self.elog])
        # Live-monitor block (repro_torch.obs.monitor), summed over member
        # monitors; integer-only so worker-chunk merges are exact.
        out["monitor"] = obs_monitor.monitor_block(
            [st.monitor for st in self.states])
        # REPRO_PROFILE=1 per-phase counters, summed across members.  The
        # headline derived number is the Algorithm-3 redistribution share
        # of the grid wall — the quantity behind the ROADMAP's "~45% of a
        # heavy cell" claim and the batched-redistribution decision.
        profs = [st.profile for st in self.states if st.profile is not None]
        if profs:
            agg = {k: float(sum(p[k] for p in profs)) for k in profs[0]}
            # The share's denominator is this engine's own wall; when
            # stats from several (possibly concurrent) engines are merged
            # the consumer must recompute the share from the summed
            # engine walls, not from its elapsed time (see exp.run).
            agg["engine_wall_s"] = self.wall_s
            agg["redistribute_share_of_wall"] = (
                agg["redistribute_s"] / self.wall_s if self.wall_s else 0.0)
            # Self-measured cost of the counters themselves (bracket
            # count × calibrated perf_counter-pair cost) — merge-safe
            # (sums across engines like the other absolute seconds).
            agg["profile_overhead_s"] = profile_overhead_s(agg)
            out["profile"] = agg
        return out


# ---------------------------------------------------------------------------
# Grid API
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GridEntry:
    """One cell of the experiment grid."""

    policy: str
    workload: int          # index into the workloads argument
    seed: int
    result: SimResult


@dataclasses.dataclass
class BatchResult:
    entries: List[GridEntry]
    wall_s: float

    @property
    def results(self) -> List[SimResult]:
        return [e.result for e in self.entries]

    def by_policy(self) -> Dict[str, List[GridEntry]]:
        out: Dict[str, List[GridEntry]] = {}
        for e in self.entries:
            out.setdefault(e.policy, []).append(e)
        return out


def predistribute_workload(
    cfg: PlatformConfig, wl: Sequence[Workflow], budget_mode: str
) -> Tuple[List[Workflow], Dict[int, float]]:
    """Run the arrival-time budget distribution once on a prototype clone.

    Algorithm 1 (and the MSLBL distribution) is deterministic in
    (cfg, workflow, budget) — independent of policy and degradation seed
    — so every grid member with the same workload and budget mode gets
    identical sub-budgets.  Returns the distributed prototype (clone it
    per member) and the wid → spare map to seed each member's
    ``SimState`` with.
    """
    proto = clone_workload(wl)
    spares: Dict[int, float] = {}
    for wf in proto:
        if budget_mode == "mslbl":
            distribute_budget_mslbl(cfg, wf, wf.budget)
            spares[wf.wid] = 0.0
        else:
            spares[wf.wid] = budget_mod.distribute_budget(cfg, wf, wf.budget)
    return proto, spares


def _as_workload_list(
    workloads: Union[Sequence[Workflow], Sequence[Sequence[Workflow]]],
) -> List[List[Workflow]]:
    wls = list(workloads)
    if not wls:
        return []
    if isinstance(wls[0], Workflow):
        return [wls]  # a single workload
    return [list(w) for w in wls]


def simulate_batch(
    cfg: PlatformConfig,
    policy: Union[Policy, Sequence[Policy]],
    workloads: Union[Sequence[Workflow], Sequence[Sequence[Workflow]]],
    seed: Union[int, Sequence[int]] = 0,
    trace: bool = False,
    device: Union[None, str, "torch.device"] = None,
    batched: object = "auto",
    redistribute: str = "finish",
    soa: Optional[bool] = None,
    profile: Optional[bool] = None,
    events: Optional[bool] = None,
    chaos: Optional[ChaosConfig] = None,
) -> BatchResult:
    """Evaluate the full grid policies × workloads × seeds in one batched
    engine run.

    ``policy`` / ``seed`` accept a single value or a sequence;
    ``workloads`` accepts one workload (a sequence of ``Workflow``) or a
    sequence of workloads.  Budget distribution mutates tasks, so every
    member simulates a structural-sharing clone (``Workflow.clone``) —
    callers can reuse the same workload objects across the grid.

    ``device``: ``None`` means ``"cuda"`` and raises when no CUDA device
    is available; pass ``"cpu"`` to score rounds with the plain torch
    version.
    """
    policies = [policy] if isinstance(policy, Policy) else list(policy)
    seeds = [seed] if isinstance(seed, int) else list(seed)
    wls = _as_workload_list(workloads)
    members: List[GridMember] = []
    labels: List[Tuple[str, int, int]] = []
    pre: List[Dict[int, float]] = []
    # Arrival-time budget distribution is shared: computed once per
    # (workload, budget_mode), inherited by every member's clone.
    protos: Dict[Tuple[int, str], Tuple[List[Workflow], Dict[int, float]]] = {}
    for pol in policies:
        for wi, wl in enumerate(wls):
            key = (wi, pol.budget_mode)
            if key not in protos:
                protos[key] = predistribute_workload(cfg, wl, pol.budget_mode)
            proto, spares = protos[key]
            for s in seeds:
                members.append((pol, clone_workload(proto), s))
                labels.append((pol.name, wi, s))
                pre.append(spares)
    engine = BatchSimEngine(cfg, members, trace=trace, device=device,
                            batched=batched, predistributed=pre,
                            redistribute=redistribute, soa=soa,
                            profile=profile, events=events, chaos=chaos)
    results = engine.run()
    entries = [
        GridEntry(policy=name, workload=wi, seed=s, result=res)
        for (name, wi, s), res in zip(labels, results)
    ]
    return BatchResult(entries=entries, wall_s=engine.wall_s)
