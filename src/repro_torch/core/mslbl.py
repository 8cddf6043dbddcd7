"""MSLBL_MW — the paper's baseline (Chen et al. MSLBL, extended to multiple
workflows per Section 5 of the paper).

Budget distribution: compute the workflow *budget level*
``b = (β − Σ c_min) / (Σ c_max − Σ c_min)`` (clipped to [0,1]) and give each
task ``c_min + b · (c_max − c_min)`` — a safety-net allocation between the
cheapest and fastest execution cost.  Leftover sub-budget of a completed task
rolls over to the next task scheduled (single spare pool per workflow).

``c_min`` / ``c_max`` are the cheapest- and fastest-type columns of the
workflow's precomputed :mod:`core.cost_tables` table — the same numeric
backbone Algorithm 1/3 read, so the EBPSM-vs-MSLBL comparison stays
apples-to-apples down to the bit.
"""
from __future__ import annotations

from . import cost_tables
from .budget import execution_order
from .types import PlatformConfig, Workflow


def distribute_budget_mslbl(cfg: PlatformConfig, wf: Workflow, budget: float) -> None:
    execution_order(cfg, wf)  # also assigns levels/ranks
    table = cost_tables.table_for(cfg, wf)
    cheapest_idx = min(range(len(cfg.vm_types)),
                       key=lambda i: cfg.vm_types[i].mips)
    fastest_idx = max(range(len(cfg.vm_types)),
                      key=lambda i: cfg.vm_types[i].mips)
    c_min = table.est_full_cost[:, cheapest_idx]
    c_max = table.est_full_cost[:, fastest_idx]
    lo, hi = float(c_min.sum()), float(c_max.sum())
    if hi - lo < 1e-9:
        level = 1.0
    else:
        level = (budget - lo) / (hi - lo)
    level = min(max(level, 0.0), 1.0)
    for t in wf.tasks:
        t.budget = float(c_min[t.tid] + level * (c_max[t.tid] - c_min[t.tid]))
