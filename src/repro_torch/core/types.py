"""Core entity types for the WaaS platform simulation.

Times are integer **milliseconds** throughout (exact arithmetic, identical
between the Python reference engine and the batched engine).  Money is in
float cents; task sizes in MI (million instructions); data sizes in MB.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MS = 1000  # ms per second


# ---------------------------------------------------------------------------
# Infrastructure catalogue
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VMType:
    """An IaaS VM offering (Table 2 of the paper)."""

    name: str
    mips: float           # processing capacity p_vmt (MIPS)
    storage_mb: float     # local storage LS capacity
    cost_per_bp: float    # c_vmt, cents per billing period
    bandwidth_mbps: float  # b_vmt, MB/s (≈ same across types per the paper)


# The paper's Table 2 (c4-like, price linear in CPU), per-second billing.
PAPER_VM_TYPES: Tuple[VMType, ...] = (
    VMType("small", 2.0, 20 * 1024, 1.0, 20.0),
    VMType("medium", 4.0, 40 * 1024, 2.0, 20.0),
    VMType("large", 8.0, 80 * 1024, 4.0, 20.0),
    VMType("xlarge", 16.0, 160 * 1024, 8.0, 20.0),
)


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    """Environment constants (paper Section 5 defaults)."""

    vm_types: Tuple[VMType, ...] = PAPER_VM_TYPES
    billing_period_ms: int = 1 * MS          # per-second billing
    vm_provision_delay_ms: int = 45 * MS     # Ulrich et al. benchmark
    container_download_ms: int = 9_600       # 600 MB at 500 Mbps
    container_init_ms: int = 400             # Piraghaj et al. model
    gs_read_mbps: float = 50.0               # global storage read rate GS_r
    gs_write_mbps: float = 30.0              # global storage write rate GS_w
    provision_interval_ms: int = 1 * MS      # Alg. 4 monitor period prov_int
    idle_threshold_ms: int = 5 * MS          # Alg. 4 threshold_idle (EBPSM)
    # Leitner & Cito performance-variation model.
    cpu_degradation_mean: float = 0.12
    cpu_degradation_std: float = 0.10
    cpu_degradation_max: float = 0.24
    bw_degradation_mean: float = 0.095
    bw_degradation_std: float = 0.05
    bw_degradation_max: float = 0.19
    # Fixed-capacity limits for the vectorized engine.
    max_vms: int = 1024
    cache_slots: int = 64                    # FIFO data-cache entries per VM
    image_slots: int = 8                     # FIFO container-image entries

    @property
    def container_provision_ms(self) -> int:
        """prov_c — full container provisioning (download + init)."""
        return self.container_download_ms + self.container_init_ms

    def with_(self, **kw) -> "PlatformConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Application model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(slots=True)
class Task:
    """A workflow task.

    ``parents``/``children`` index into the owning workflow's task list.
    ``out_mb`` is the size of this task's output dataset d_t^out; a child
    reads every parent's output as its input d_t^in.  ``ext_in_mb`` models
    initial input staged from global storage (entry tasks).

    ``slots=True``: tasks are the most attribute-chased objects in both
    engines; slot access is measurably faster and halves the footprint.
    """

    tid: int
    size_mi: float
    out_mb: float
    ext_in_mb: float = 0.0
    parents: List[int] = dataclasses.field(default_factory=list)
    children: List[int] = dataclasses.field(default_factory=list)
    # Cross-workflow shared inputs [(name, mb)] — e.g. a base-model
    # checkpoint shared by every tenant fine-tuning the same arch (WaaS→ML
    # bridge).  Cache keys are global: ("shared", name, 0).
    shared_in: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)

    # Filled in by budget distribution / scheduling.
    level: int = 0
    rank: int = 0                 # position in estimated execution order S
    budget: float = 0.0           # current sub-budget allocation
    # Engine-memoized [(DataKey, mb)] input list (static per task; clones
    # share it — the DAG and the owning wid are identical by definition).
    inputs_cache: Optional[list] = dataclasses.field(
        default=None, repr=False, compare=False)


@dataclasses.dataclass(slots=True)
class Workflow:
    """A tenant job: a DAG of tasks plus a soft budget constraint."""

    wid: int
    app: str                      # application type == container image id
    tasks: List[Task]
    budget: float = 0.0
    arrival_ms: int = 0
    # Memoized core.cost_tables.CostTable — depends only on the immutable
    # task attributes, so clones share it by reference (see table_for).
    cost_cache: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)
    # Memoized [t.rank for t in tasks] (frozen once distribution ran).
    rank_cache: Optional[list] = dataclasses.field(
        default=None, repr=False, compare=False)

    def entry_tasks(self) -> List[int]:
        return [t.tid for t in self.tasks if not t.parents]

    def exit_tasks(self) -> List[int]:
        return [t.tid for t in self.tasks if not t.children]

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def clone(self) -> "Workflow":
        """Per-simulation copy with structural sharing.

        Budget distribution mutates ``Task.budget`` / ``level`` /
        ``rank``, so every grid member needs its own ``Task`` objects —
        but the DAG structure (``parents`` / ``children`` /
        ``shared_in`` lists) is immutable once built and is shared by
        reference.  This replaces per-member ``copy.deepcopy`` in the
        batched engine: O(tasks) instead of O(whole object graph).
        """
        # Positional Task construction: ~4× faster than
        # dataclasses.replace on the clone-per-grid-member hot path
        # (replace re-enters __init__ through kwargs plumbing).
        return Workflow(
            wid=self.wid,
            app=self.app,
            tasks=[
                Task(t.tid, t.size_mi, t.out_mb, t.ext_in_mb, t.parents,
                     t.children, t.shared_in, t.level, t.rank, t.budget,
                     t.inputs_cache)
                for t in self.tasks
            ],
            budget=self.budget,
            arrival_ms=self.arrival_ms,
            cost_cache=self.cost_cache,
            rank_cache=self.rank_cache,
        )

    def validate(self) -> None:
        """Check DAG structure; raises :class:`ValueError` with a concrete
        message on malformed input.

        Generators *and importers* (``tenants.traces``) run this before a
        workflow ever reaches an engine: a cycle or dangling edge must be
        rejected at load time with a clear error, not crash mid-sim.
        """
        n = len(self.tasks)
        if n == 0:
            raise ValueError(f"workflow {self.wid} ({self.app!r}) is empty")
        for i, t in enumerate(self.tasks):
            if t.tid != i:
                raise ValueError(
                    f"workflow {self.wid}: task at position {i} has "
                    f"tid {t.tid} (tids must equal list position)")
            for p in t.parents:
                if not 0 <= p < n:
                    raise ValueError(
                        f"workflow {self.wid}: task {t.tid} names parent "
                        f"{p}, outside 0..{n - 1}")
                if t.tid not in self.tasks[p].children:
                    raise ValueError(
                        f"workflow {self.wid}: dangling edge — task "
                        f"{t.tid} lists parent {p}, but {p} does not list "
                        f"{t.tid} as a child")
            for c in t.children:
                if not 0 <= c < n:
                    raise ValueError(
                        f"workflow {self.wid}: task {t.tid} names child "
                        f"{c}, outside 0..{n - 1}")
                if t.tid not in self.tasks[c].parents:
                    raise ValueError(
                        f"workflow {self.wid}: dangling edge — task "
                        f"{t.tid} lists child {c}, but {c} does not list "
                        f"{t.tid} as a parent")
        # Acyclicity via Kahn's algorithm.
        indeg = [len(t.parents) for t in self.tasks]
        stack = [i for i, d in enumerate(indeg) if d == 0]
        seen = 0
        while stack:
            u = stack.pop()
            seen += 1
            for c in self.tasks[u].children:
                indeg[c] -= 1
                if indeg[c] == 0:
                    stack.append(c)
        if seen != n:
            cyc = sorted(i for i, d in enumerate(indeg) if d > 0)
            raise ValueError(
                f"workflow {self.wid}: DAG has a cycle through tasks {cyc}")


def clone_workload(workflows: Sequence[Workflow]) -> List[Workflow]:
    """Structural-sharing copy of a whole workload (see Workflow.clone)."""
    return [wf.clone() for wf in workflows]


# ---------------------------------------------------------------------------
# Structure-of-arrays stream state
# ---------------------------------------------------------------------------


class StreamState:
    """Structure-of-arrays owner of a simulation's per-workflow and
    per-task mutable scalars.

    The engines' hot bookkeeping — spare budget, accumulated cost,
    unscheduled/remaining counts, finish clocks, round-mode surplus
    banks, per-task pending-parent counters, the unscheduled mask, and
    the Algorithm-3 ``RedistState`` pools (rank order, position index,
    row mask, float64 budget mirror) — lives in flat numpy arrays
    indexed by wid (per-workflow fields) or by task global id
    (per-task fields), instead of one Python object graph per workflow.
    ``core.engine`` reads and writes it through thin per-workflow
    accessor views (``_WfView``) so the transition semantics stay
    bit-exact with the legacy object path (``REPRO_OBJECT_STATE=1``).

    Two properties make it the unit of scale-out and checkpointing:

    * :meth:`view` returns a zero-copy segment (numpy slice views) —
      ``core.batch_engine.BatchSimEngine`` allocates ONE pooled backing
      for a whole grid and hands each member a view, so thousands of
      open-stream members share a handful of allocations;
    * :meth:`snapshot_arrays` / :meth:`load_arrays` give the persisted
      array block ``repro.ckpt.checkpoint.save_stream`` writes.  The
      Algorithm-3 pools are *derived* state (a pure function of task
      ranks, budgets, and the unscheduled mask) and are deliberately
      not persisted — restore rebuilds them lazily and bit-identically.
    """

    # (name, dtype): persisted per-workflow fields, indexed by wid.
    WF_FIELDS: Tuple[Tuple[str, str], ...] = (
        ("spare", "f8"), ("cost", "f8"), ("pending_surplus", "f8"),
        ("remaining", "i8"), ("finish_ms", "i8"), ("pending_events", "i8"),
        ("arrived", "?"),
    )
    # Persisted per-task fields, indexed by task global id.
    TASK_FIELDS: Tuple[Tuple[str, str], ...] = (
        ("pending_parents", "i8"), ("unscheduled", "?"),
    )
    # Derived Algorithm-3 pools (RedistState backing) — rebuilt, never
    # persisted.  redist_mask is indexed by *position in rank order*
    # within the workflow's segment, matching RedistState.mask.
    POOL_FIELDS: Tuple[Tuple[str, str], ...] = (
        ("redist_order", "i8"), ("redist_pos", "i8"),
        ("redist_mask", "?"), ("redist_budget", "f8"),
    )

    __slots__ = tuple(n for n, _ in WF_FIELDS) \
        + tuple(n for n, _ in TASK_FIELDS) \
        + tuple(n for n, _ in POOL_FIELDS) \
        + ("n_workflows", "n_tasks")

    def __init__(self, n_workflows: int, n_tasks: int):
        self.n_workflows = n_workflows
        self.n_tasks = n_tasks
        for name, dt in self.WF_FIELDS:
            setattr(self, name, np.zeros(n_workflows, dtype=dt))
        for name, dt in self.TASK_FIELDS + self.POOL_FIELDS:
            setattr(self, name, np.zeros(n_tasks, dtype=dt))

    def view(self, wf_lo: int, wf_hi: int,
             task_lo: int, task_hi: int) -> "StreamState":
        """Zero-copy segment view: writes through to this backing."""
        v = object.__new__(StreamState)
        v.n_workflows = wf_hi - wf_lo
        v.n_tasks = task_hi - task_lo
        for name, _ in self.WF_FIELDS:
            setattr(v, name, getattr(self, name)[wf_lo:wf_hi])
        for name, _ in self.TASK_FIELDS + self.POOL_FIELDS:
            setattr(v, name, getattr(self, name)[task_lo:task_hi])
        return v

    def snapshot_arrays(self) -> Dict[str, np.ndarray]:
        """Copies of the persisted fields (derived pools excluded)."""
        return {name: getattr(self, name).copy()
                for name, _ in self.WF_FIELDS + self.TASK_FIELDS}

    def load_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """In-place restore of the persisted fields; the derived
        Algorithm-3 pools are reset (rebuilt lazily on first use)."""
        for name, _ in self.WF_FIELDS + self.TASK_FIELDS:
            dst = getattr(self, name)
            dst[:] = arrays[name]
        for name, dt in self.POOL_FIELDS:
            getattr(self, name)[:] = 0


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WorkflowResult:
    wid: int
    app: str
    n_tasks: int
    budget: float
    cost: float
    arrival_ms: int
    finish_ms: int

    @property
    def makespan_ms(self) -> int:
        return self.finish_ms - self.arrival_ms

    @property
    def budget_met(self) -> bool:
        return self.cost <= self.budget + 1e-6

    @property
    def cost_budget_ratio(self) -> float:
        return self.cost / max(self.budget, 1e-9)


@dataclasses.dataclass
class SimResult:
    """Aggregate output of one simulation run."""

    workflows: List[WorkflowResult]
    vm_seconds_by_type: Dict[str, float]
    vm_busy_seconds_by_type: Dict[str, float]
    vm_count_by_type: Dict[str, int]
    total_events: int = 0
    wall_s: float = 0.0
    # Resource-sharing actuals (the paper's policy claim made measurable):
    # input bytes served from VM-local caches vs staged, and container
    # activations by warmth.  Zeros for policies without containers.
    data_mb_total: float = 0.0
    data_mb_hit: float = 0.0
    container_warm: int = 0
    container_init: int = 0
    container_cold: int = 0
    # Fleet-size-over-time summary (online/open-stream scenarios): the
    # maximum number of concurrently leased VMs and the time-weighted
    # mean over [0, last event].  Computed from the pool's lease
    # intervals at finalize time.
    peak_vms: int = 0
    mean_fleet_vms: float = 0.0
    # Fault-injection tallies (repro_torch.chaos) — zeros on benign runs:
    # spot-lease revocations, failed execution attempts, total task
    # re-executions (failures + preemption-killed attempts), stragglers
    # the platform detected, cost sunk into attempts that produced no
    # output (already included in each workflow's cost — Eq. 5 has no
    # refunds), and spot leases provisioned.
    revocations: int = 0
    task_failures: int = 0
    task_retries: int = 0
    stragglers_detected: int = 0
    wasted_cost: float = 0.0
    spot_vms: int = 0

    @property
    def avg_vm_utilization(self) -> float:
        lease = sum(self.vm_seconds_by_type.values())
        busy = sum(self.vm_busy_seconds_by_type.values())
        return busy / lease if lease > 0 else 0.0

    @property
    def total_vms(self) -> int:
        return sum(self.vm_count_by_type.values())

    @property
    def data_cache_hit_rate(self) -> float:
        """Fraction of input bytes served from a VM-local cache."""
        return self.data_mb_hit / self.data_mb_total \
            if self.data_mb_total > 0 else 0.0

    @property
    def container_hit_rate(self) -> float:
        """Fraction of container activations that skipped the image
        download (active or image-cached)."""
        acts = self.container_warm + self.container_init + self.container_cold
        return (self.container_warm + self.container_init) / acts \
            if acts > 0 else 0.0

    @property
    def budget_met_fraction(self) -> float:
        if not self.workflows:
            return 1.0
        return sum(w.budget_met for w in self.workflows) / len(self.workflows)

    def makespans_by_app(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for w in self.workflows:
            out.setdefault(w.app, []).append(w.makespan_ms)
        return out

    def violated_ratios(self) -> List[float]:
        return [w.cost_budget_ratio for w in self.workflows if not w.budget_met]


# ---------------------------------------------------------------------------
# Deterministic performance-variation draws
# ---------------------------------------------------------------------------


def degradation_tables(
    cfg: PlatformConfig, n_tasks: int, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pre-draw per-task CPU and bandwidth degradation factors.

    Returns (cpu_deg, bw_in_deg, bw_out_deg) arrays in [0, max]; both engines
    consume the same tables so results are bit-identical.
    """
    rng = np.random.default_rng(seed)
    cpu = np.clip(
        rng.normal(cfg.cpu_degradation_mean, cfg.cpu_degradation_std, n_tasks),
        0.0,
        cfg.cpu_degradation_max,
    )
    bw_in = np.clip(
        rng.normal(cfg.bw_degradation_mean, cfg.bw_degradation_std, n_tasks),
        0.0,
        cfg.bw_degradation_max,
    )
    bw_out = np.clip(
        rng.normal(cfg.bw_degradation_mean, cfg.bw_degradation_std, n_tasks),
        0.0,
        cfg.bw_degradation_max,
    )
    return cpu.astype(np.float64), bw_in.astype(np.float64), bw_out.astype(np.float64)
