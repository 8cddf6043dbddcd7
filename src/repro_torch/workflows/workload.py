"""Workload generation — Section 5 of the paper.

A workload is a stream of workflows: types drawn uniformly from the five
applications, sizes drawn uniformly from {small≈50, medium≈100, large≈1000}
tasks, arrivals Poisson at a given rate (workflows/minute), and budgets drawn
uniformly from [min_cost, max_cost] as estimated by
``core.budget.min_max_workflow_cost`` (sequential-on-cheapest vs
all-parallel-on-fastest).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import budget as budget_mod
from ..core.types import MS, PlatformConfig, Workflow
from .dax import APP_NAMES, generate_workflow

SIZE_CLASSES = {"small": 50, "medium": 100, "large": 1000}


def assign_budgets_uniform(
    cfg: PlatformConfig,
    wfs: Sequence[Workflow],
    rng: np.random.Generator,
    lo: float,
    hi: float,
) -> None:
    """Draw each workflow's soft budget uniformly from the ``[lo, hi]``
    slice of its ``[min_cost, max_cost]`` range — THE budget-assignment
    path (§5 workload construction), shared by the closed-grid workloads
    below, the tenant mixes (``repro.tenants``), and
    ``waas.platform.assign_budgets``."""
    for wf in wfs:
        cmin, cmax = budget_mod.min_max_workflow_cost(cfg, wf)
        wf.budget = cmin + rng.uniform(lo, hi) * (cmax - cmin)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    n_workflows: int = 100
    arrival_rate_per_min: float = 1.0
    apps: Tuple[str, ...] = APP_NAMES
    sizes: Tuple[str, ...] = ("small", "medium", "large")
    seed: int = 0
    # Budget multiplier range relative to [min_cost, max_cost]; the paper
    # draws uniformly across the full range ("always assumed sufficient").
    budget_lo: float = 0.0
    budget_hi: float = 1.0


def cell_workload(
    cfg: PlatformConfig,
    app: str,
    rate: float,
    budget_interval: Tuple[float, float],
    seed: int,
    n_workflows: int,
    sizes: Tuple[str, ...] = ("small", "medium", "large"),
) -> List[Workflow]:
    """One evaluation-grid cell's workload: a single-application stream at
    the given arrival rate, budgets drawn uniformly from one quarter (the
    paper's four budget intervals) of the [min_cost, max_cost] range."""
    lo, hi = budget_interval
    spec = WorkloadSpec(n_workflows=n_workflows, arrival_rate_per_min=rate,
                        apps=(app,), sizes=sizes, seed=seed,
                        budget_lo=lo, budget_hi=hi)
    return generate_workload(cfg, spec)


def generate_workload(
    cfg: PlatformConfig, spec: WorkloadSpec
) -> List[Workflow]:
    """Build the workload; ``wid`` equals the list index (engine invariant)."""
    rng = np.random.default_rng(spec.seed)
    inter_ms = 60.0 * MS / spec.arrival_rate_per_min
    t = 0.0
    out: List[Workflow] = []
    for wid in range(spec.n_workflows):
        app = spec.apps[int(rng.integers(len(spec.apps)))]
        size = SIZE_CLASSES[spec.sizes[int(rng.integers(len(spec.sizes)))]]
        wf = generate_workflow(app, wid, size, rng)
        wf.arrival_ms = int(t)
        assign_budgets_uniform(cfg, [wf], rng,
                               spec.budget_lo, spec.budget_hi)
        out.append(wf)
        t += rng.exponential(inter_ms)
    return out
