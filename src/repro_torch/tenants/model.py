"""Tenant and QoS model: compose many tenants into one open workflow stream.

A :class:`Tenant` is a workload source: an application mix (synthetic
Table-1 families and/or imported traces — or a legacy whole-stream
generator), an :class:`~repro_torch.tenants.arrivals.ArrivalProcess`, and a
:class:`QoSClass` that fixes the budget-interval the tenant buys (the
paper's four budget quarters become purchasable service classes) and a
priority used to order same-millisecond arrivals.

A :class:`TenantMix` merges its tenants' streams into a single
arrival-ordered workload whose ``wid`` equals the stream position (the
engine invariant), remembers which tenant owns each workflow, and assigns
budgets per tenant via the uniform draw over ``[min_cost, max_cost]``
(``assign_budgets_uniform`` — the one budget-assignment code path shared
with ``waas.platform``).  Sub-budget *distribution* then runs through the
existing Algorithm-1 predistribution exactly as for closed grids
(``core.batch_engine.predistribute_workload``).

Everything is deterministic in (mix, cfg, seed): tenant ``i`` derives the
sub-seed ``seed + 7919·i`` (tenant 0 keeps the caller's seed, so a
single-tenant mix reproduces the legacy single-stream construction
draw-for-draw).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import budget as budget_mod
from ..core import cost_tables
from ..core.types import PlatformConfig, Workflow
from ..workflows.dax import APP_GENERATORS, generate_workflow
from ..workflows.workload import (SIZE_CLASSES,  # noqa: F401 (re-export)
                                  assign_budgets_uniform)
from . import traces
from .arrivals import ArrivalProcess

# Legacy whole-stream generator signature: (n_workflows, seed) -> list of
# arrival-stamped workflows with wid == position (budgets not yet set).
StreamFactory = Callable[[int, int], List[Workflow]]


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """A purchasable service class.

    ``budget_interval`` is the tenant's draw range over each workflow's
    ``[min_cost, max_cost]`` (the paper's budget intervals, §5);
    ``priority`` orders same-millisecond arrivals in the merged stream
    (higher first) — it does not preempt the scheduler.
    """

    name: str
    budget_interval: Tuple[float, float]
    priority: int


GOLD = QoSClass("gold", (0.75, 1.0), 2)
SILVER = QoSClass("silver", (0.40, 0.75), 1)
BRONZE = QoSClass("bronze", (0.05, 0.40), 0)


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One workload source inside a :class:`TenantMix`.

    ``apps`` entries are synthetic family names (``repro_torch.workflows.dax``)
    or ``"trace:<stem>"`` references to bundled/imported traces; draws
    are uniform over the entries.  ``stream`` replaces the generator with
    a legacy whole-stream factory (see :data:`StreamFactory`) — used by
    ``waas.platform`` to route ML-job streams through the same mix/budget
    machinery.
    """

    name: str
    qos: QoSClass
    apps: Tuple[str, ...] = ()
    arrival: Optional[ArrivalProcess] = None
    n_workflows: int = 10
    sizes: Tuple[str, ...] = ("small",)
    start_ms: int = 0                   # stream offset (e.g. staggered tenants)
    stream: Optional[StreamFactory] = None

    def __post_init__(self):
        if self.stream is None:
            if not self.apps:
                raise ValueError(f"tenant {self.name!r}: needs apps or stream")
            if self.arrival is None:
                raise ValueError(
                    f"tenant {self.name!r}: needs an arrival process")
            for a in self.apps:
                if not a.startswith("trace:") and a not in APP_GENERATORS:
                    raise ValueError(
                        f"tenant {self.name!r}: unknown app {a!r} (not a "
                        f"family in {sorted(APP_GENERATORS)} and not a "
                        f"'trace:<stem>' reference)")


@dataclasses.dataclass
class TenantWorkload:
    """A built merged stream plus its tenant bookkeeping."""

    workflows: List[Workflow]
    tenant_of: Dict[int, str]           # wid -> tenant name
    tenants: Tuple[Tenant, ...]
    seed: int

    @property
    def qos_of(self) -> Dict[str, str]:
        return {t.name: t.qos.name for t in self.tenants}

    @property
    def priority_of(self) -> Dict[str, int]:
        return {t.name: t.qos.priority for t in self.tenants}

    def ideal_ms(self, cfg: PlatformConfig) -> Dict[int, int]:
        """Per-workflow slowdown denominators (see
        :func:`ideal_makespan_ms`)."""
        return {wf.wid: ideal_makespan_ms(cfg, wf) for wf in self.workflows}


def ideal_makespan_ms(cfg: PlatformConfig, wf: Workflow) -> int:
    """Critical-path lower bound: every task at its fastest undegraded
    per-type processing time, no queueing, no provisioning.  The slowdown
    denominator for the per-tenant online metrics."""
    table = cost_tables.table_for(cfg, wf)
    best = table.proc_ms.min(axis=1)
    finish = [0] * wf.n_tasks
    for tid in budget_mod.topological_order(wf):
        t = wf.tasks[tid]
        start = max((finish[p] for p in t.parents), default=0)
        finish[tid] = start + int(best[tid])
    return max(max(finish), 1)


def _retag(wf: Workflow, wid: int) -> None:
    """Renumber a stream member.  Engine-memoized input lists carry
    wid-keyed DataKeys, so a changed wid must drop them (clones share the
    lists by reference; cost/rank caches are wid-independent and stay)."""
    if wf.wid != wid:
        for t in wf.tasks:
            t.inputs_cache = None
        wf.wid = wid


@dataclasses.dataclass(frozen=True)
class TenantMix:
    """A set of tenants composed into one open multi-tenant stream."""

    tenants: Tuple[Tenant, ...]

    def __post_init__(self):
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")

    @property
    def n_workflows(self) -> int:
        return sum(t.n_workflows for t in self.tenants)

    def mean_rate_per_min(self) -> float:
        return sum(t.arrival.mean_rate_per_min() for t in self.tenants
                   if t.arrival is not None)

    def budget_span(self) -> Tuple[float, float]:
        """(min lo, max hi) across the tenants' QoS budget intervals."""
        los = [t.qos.budget_interval[0] for t in self.tenants]
        his = [t.qos.budget_interval[1] for t in self.tenants]
        return (min(los), max(his))

    # -- stream construction -------------------------------------------------
    def _tenant_workflows(
        self, cfg: PlatformConfig, tenant: Tenant, tseed: int
    ) -> List[Workflow]:
        if tenant.stream is not None:
            wfs = tenant.stream(tenant.n_workflows, tseed)
            if tenant.start_ms:
                for wf in wfs:
                    wf.arrival_ms += tenant.start_ms
            rng = np.random.default_rng(tseed)
        else:
            rng = np.random.default_rng(tseed)
            times = tenant.arrival.arrival_times_ms(tenant.n_workflows, rng)
            templates: Dict[str, Workflow] = {}
            wfs = []
            for k in range(tenant.n_workflows):
                entry = tenant.apps[int(rng.integers(len(tenant.apps)))]
                if entry.startswith("trace:"):
                    stem = entry[len("trace:"):]
                    if stem not in templates:
                        templates[stem] = traces.bundled_trace(stem)
                    wf = templates[stem].clone()
                else:
                    size = SIZE_CLASSES[
                        tenant.sizes[int(rng.integers(len(tenant.sizes)))]]
                    wf = generate_workflow(entry, 0, size, rng)
                wf.arrival_ms = tenant.start_ms + times[k]
                wfs.append(wf)
        lo, hi = tenant.qos.budget_interval
        assign_budgets_uniform(cfg, wfs, rng, lo, hi)
        return wfs

    def build(self, cfg: PlatformConfig, seed: int = 0) -> TenantWorkload:
        """Generate every tenant's stream and merge by arrival time.

        Same-millisecond ties resolve by priority (higher QoS first),
        then tenant position, then submission order — the merged position
        becomes the ``wid``, which fixes the engine's same-timestamp
        arrival ordering.  Deterministic in (self, cfg, seed).
        """
        rows: List[Tuple[int, int, int, int, Workflow, Tenant]] = []
        for ti, tenant in enumerate(self.tenants):
            tseed = seed + 7919 * ti
            for k, wf in enumerate(
                    self._tenant_workflows(cfg, tenant, tseed)):
                rows.append((wf.arrival_ms, -tenant.qos.priority, ti, k,
                             wf, tenant))
        rows.sort(key=lambda r: r[:4])
        workflows: List[Workflow] = []
        tenant_of: Dict[int, str] = {}
        for i, (_, _, _, _, wf, tenant) in enumerate(rows):
            _retag(wf, i)
            workflows.append(wf)
            tenant_of[i] = tenant.name
        return TenantWorkload(workflows=workflows, tenant_of=tenant_of,
                              tenants=self.tenants, seed=seed)
