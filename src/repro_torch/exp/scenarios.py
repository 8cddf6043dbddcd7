"""Scenario registry for the paper-grid evaluation.

A :class:`Scenario` names one evaluation grid: applications × arrival
rates × budget intervals × policies × seeds, plus the workload scale.
The paper's experiment design (§5, workload construction following the
authors' WaaS-platform paper) draws each cell's budgets uniformly from
one quarter of the per-workflow ``[min_cost, max_cost]`` range — the four
*budget intervals* — and streams a single application's workflows at a
Poisson arrival rate.

``paper`` is the full grid behind Figs. 3–4 (hours of simulated
scheduling — run it with ``--full``-style patience); ``paper-smoke`` is
the CI-sized reduction (2 apps × 2 rates × 2 budget intervals × all five
policies × 1 seed) that the ``exp-smoke`` CI job gates on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple, Union

from ..chaos import ChaosConfig
from ..core.scheduler import ALL_POLICIES, Policy
from ..tenants import (BRONZE, GOLD, SILVER, Diurnal, MarkovModulated,
                       Poisson, Tenant, TenantMix)

POLICY_BY_NAME: Dict[str, Policy] = {p.name: p for p in ALL_POLICIES}

# The paper's four budget intervals over [min_cost, max_cost].
PAPER_BUDGET_INTERVALS: Tuple[Tuple[float, float], ...] = (
    (0.0, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0),
)

PAPER_APPS = ("cybershake", "epigenome", "ligo", "montage", "sipht")


@dataclasses.dataclass(frozen=True)
class WorkloadCell:
    """One workload configuration (all policies simulate a clone of it)."""

    app: str
    rate: float                       # workflows / minute
    budget_interval: Tuple[float, float]
    seed: int                         # degradation seed; workload seed derives
    index: int                        # stable position in the scenario grid

    @property
    def workload_seed(self) -> int:
        """Deterministic per-cell workload draw, decorrelated from the
        degradation seed (7919 = 1000th prime, no magic beyond reuse)."""
        return 7919 * (self.seed + 1) + self.index


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    apps: Tuple[str, ...]
    rates: Tuple[float, ...]
    budget_intervals: Tuple[Tuple[float, float], ...]
    policies: Tuple[str, ...]
    seeds: Tuple[int, ...]
    n_workflows: int                  # workflows per cell workload
    sizes: Tuple[str, ...]
    # CI floor: every EBPSM cell must keep budget-met % at or above this
    # (recorded from the artifact trajectory; see exp-smoke in ci.yml).
    ebpsm_budget_met_floor: float = 0.0

    def workload_cells(self) -> Iterator[WorkloadCell]:
        idx = 0
        for app in self.apps:
            for rate in self.rates:
                for interval in self.budget_intervals:
                    for seed in self.seeds:
                        yield WorkloadCell(app, rate, interval, seed, idx)
                        idx += 1

    @property
    def n_workload_cells(self) -> int:
        return (len(self.apps) * len(self.rates)
                * len(self.budget_intervals) * len(self.seeds))

    @property
    def n_cells(self) -> int:
        return self.n_workload_cells * len(self.policies)


ALL_POLICY_NAMES = tuple(p.name for p in ALL_POLICIES)

SCENARIOS: Dict[str, Scenario] = {
    "paper": Scenario(
        name="paper",
        description=("Full Figs. 3-4 grid: 5 Pegasus apps x arrival rates "
                     "{0.5, 6, 12} wf/min x 4 budget intervals x all 5 "
                     "policies x 3 seeds, 100 workflows per cell."),
        apps=PAPER_APPS,
        rates=(0.5, 6.0, 12.0),
        budget_intervals=PAPER_BUDGET_INTERVALS,
        policies=ALL_POLICY_NAMES,
        seeds=(0, 1, 2),
        n_workflows=100,
        sizes=("small", "medium", "large"),
        ebpsm_budget_met_floor=0.80,
    ),
    "paper-smoke": Scenario(
        name="paper-smoke",
        description=("CI reduction of the paper grid: 2 apps x 2 rates x "
                     "2 budget intervals x all 5 policies x 1 seed, small "
                     "workloads."),
        apps=("montage", "sipht"),
        rates=(0.5, 6.0),
        budget_intervals=((0.25, 0.5), (0.75, 1.0)),
        policies=ALL_POLICY_NAMES,
        seeds=(0,),
        n_workflows=10,
        sizes=("small",),
        ebpsm_budget_met_floor=0.90,
    ),
    "degradation": Scenario(
        name="degradation",
        description=("Figs. 5-6 companion: EBPSM vs MSLBL_MW under the "
                     "default degradation model across rates and the two "
                     "outer budget intervals."),
        apps=("cybershake", "epigenome", "ligo"),
        rates=(6.0,),
        budget_intervals=((0.0, 0.25), (0.75, 1.0)),
        policies=("EBPSM", "MSLBL_MW"),
        seeds=(0, 1),
        n_workflows=30,
        sizes=("small", "medium"),
        ebpsm_budget_met_floor=0.70,
    ),
}


# ---------------------------------------------------------------------------
# Online (open-stream) scenario families — repro_torch.tenants
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OnlineScenario:
    """An open multi-tenant stream scenario: one :class:`TenantMix`
    streamed through every policy, per seed.

    Unlike the closed :class:`Scenario` grids (one app × one rate × one
    budget interval per cell), an online cell is the *merged* stream —
    heterogeneous apps, imported traces, bursty/diurnal arrivals and
    per-tenant QoS budget classes — with the first ``warmup_s`` of
    arrivals excluded from the metrics (cold-start truncation).
    """

    name: str
    description: str
    mix: TenantMix
    policies: Tuple[str, ...]
    seeds: Tuple[int, ...]
    warmup_s: float = 0.0
    ebpsm_budget_met_floor: float = 0.0
    # CI ceiling on EBPSM's p95 workflow slowdown (0 = not gated).
    # Recorded from the artifact trajectory like the budget-met floor.
    p95_slowdown_ceiling: float = 0.0
    # Fault-injection knobs (repro_torch.chaos); None ⇒ the benign stream.
    chaos: Optional[ChaosConfig] = None
    # CI ceiling on EBPSM's wasted-spend fraction (cost sunk into killed/
    # failed attempts ÷ total spend; 0 = not gated).
    wasted_spend_ceiling: float = 0.0
    # CI floor on live-monitor alert counts, {alert kind name: min count}
    # summed over the scenario's cells (repro_torch.obs.slo.ALERT_KIND_NAMES).
    # Declaring floors REQUIRES the run to carry a monitor (--report-dir
    # or REPRO_MONITOR=1): check_floors fails rather than passing
    # vacuously when the monitor block is disabled.  None ⇒ not gated.
    alert_floors: Optional[Dict[str, int]] = None

    @property
    def n_workload_cells(self) -> int:
        return len(self.seeds)

    @property
    def n_cells(self) -> int:
        return self.n_workload_cells * len(self.policies)

    @property
    def n_workflows(self) -> int:
        return self.mix.n_workflows


# The CI-gated smoke mix: three tenants spanning all four workload axes —
# synthetic + imported-trace apps, three arrival processes, three QoS
# classes — small enough for the exp-smoke job (< 60 s, see ci.yml).
ONLINE_SMOKE_MIX = TenantMix((
    Tenant("astro-survey", GOLD,
           apps=("montage", "trace:montage-18"),
           arrival=Poisson(10.0), n_workflows=24, sizes=("small",)),
    Tenant("bio-lab", SILVER,
           apps=("epigenome", "trace:epigenomics-20"),
           arrival=Diurnal(4.0, 14.0, period_s=300.0),
           n_workflows=16, sizes=("small",)),
    Tenant("seismo-batch", BRONZE,
           apps=("sipht", "trace:seismology-9"),
           arrival=MarkovModulated(2.0, 20.0, mean_dwell_s=60.0),
           n_workflows=24, sizes=("small",)),
))

# The heavy mix: every Table-1 family plus all bundled traces, higher
# rates, staggered tenant onboarding — the intended stress consumer.
ONLINE_HEAVY_MIX = TenantMix((
    Tenant("astro-survey", GOLD,
           apps=("montage", "cybershake", "trace:montage-18"),
           arrival=Poisson(12.0), n_workflows=40,
           sizes=("small", "medium")),
    Tenant("bio-lab", GOLD,
           apps=("epigenome", "trace:epigenomics-20"),
           arrival=Diurnal(4.0, 16.0, period_s=1800.0),
           n_workflows=30, sizes=("small", "medium")),
    Tenant("grav-obs", SILVER,
           apps=("ligo",),
           arrival=MarkovModulated(2.0, 20.0, mean_dwell_s=120.0),
           n_workflows=30, sizes=("small", "medium")),
    Tenant("seismo-batch", BRONZE,
           apps=("sipht", "trace:seismology-9"),
           arrival=MarkovModulated(1.0, 24.0, mean_dwell_s=90.0),
           n_workflows=40, sizes=("small",)),
    Tenant("late-joiner", BRONZE,
           apps=("montage", "sipht"),
           arrival=Poisson(8.0), n_workflows=20, sizes=("small",),
           start_ms=120_000),
))

# The long-horizon mix: ≥1k workflows across the bundled synthetic +
# trace families at low arrival rates, so the merged stream spans a
# multi-hour simulated horizon — the checkpoint/resume consumer
# (``--ckpt-every-s`` / ``--resume``) and the SoA scale testbed.
ONLINE_LONGHAUL_MIX = TenantMix((
    Tenant("astro-survey", GOLD,
           apps=("montage", "trace:montage-18"),
           arrival=Poisson(3.0), n_workflows=360, sizes=("small",)),
    Tenant("bio-lab", SILVER,
           apps=("epigenome", "trace:epigenomics-20"),
           arrival=Diurnal(1.5, 5.0, period_s=3600.0),
           n_workflows=320, sizes=("small",)),
    Tenant("seismo-batch", BRONZE,
           apps=("sipht", "trace:seismology-9"),
           arrival=MarkovModulated(1.0, 6.0, mean_dwell_s=600.0),
           n_workflows=360, sizes=("small",)),
))

# The chaos mixes stream ≥4 workflow families — montage + epigenomics +
# cybershake (seismology-family calibration) + seismology traces plus the
# synthetic generators — so injected churn hits heterogeneous DAG shapes.
ONLINE_CHAOS_MIX = TenantMix((
    Tenant("astro-survey", GOLD,
           apps=("montage", "trace:montage-18"),
           arrival=Poisson(10.0), n_workflows=20, sizes=("small",)),
    Tenant("bio-lab", SILVER,
           apps=("epigenome", "trace:epigenomics-20"),
           arrival=Diurnal(4.0, 14.0, period_s=300.0),
           n_workflows=16, sizes=("small",)),
    Tenant("seismo-batch", BRONZE,
           apps=("trace:cybershake-12", "trace:seismology-9"),
           arrival=MarkovModulated(2.0, 20.0, mean_dwell_s=60.0),
           n_workflows=20, sizes=("small",)),
))

ONLINE_CHAOS_HEAVY_MIX = TenantMix((
    Tenant("astro-survey", GOLD,
           apps=("montage", "cybershake", "trace:montage-18"),
           arrival=Poisson(12.0), n_workflows=36,
           sizes=("small", "medium")),
    Tenant("bio-lab", GOLD,
           apps=("epigenome", "trace:epigenomics-20"),
           arrival=Diurnal(4.0, 16.0, period_s=1800.0),
           n_workflows=28, sizes=("small", "medium")),
    Tenant("grav-obs", SILVER,
           apps=("ligo", "trace:cybershake-12"),
           arrival=MarkovModulated(2.0, 20.0, mean_dwell_s=120.0),
           n_workflows=28, sizes=("small", "medium")),
    Tenant("seismo-batch", BRONZE,
           apps=("sipht", "trace:seismology-9"),
           arrival=MarkovModulated(1.0, 24.0, mean_dwell_s=90.0),
           n_workflows=36, sizes=("small",)),
))

# The CI-gated chaos knobs: 60 % spot discount with a 6/hour revocation
# process, 2 % per-attempt failures (≤ 3 retries, on-demand escalation
# after 2 preemptions) and 5 % stragglers at 4× slowdown, detected at 2×
# the undegraded estimate.
CHAOS_SMOKE = ChaosConfig(
    spot_discount=0.6, revocation_rate=6.0,
    fail_prob=0.02, max_retries=3, escalate_after=2,
    straggler_prob=0.05, straggler_slowdown=4.0, straggler_factor=2.0,
)

# The heavy family doubles the churn: mean spot lifetime 5 simulated
# minutes, 5 % failures, 10 % stragglers.
CHAOS_HEAVY = ChaosConfig(
    spot_discount=0.6, revocation_rate=12.0,
    fail_prob=0.05, max_retries=3, escalate_after=2,
    straggler_prob=0.10, straggler_slowdown=4.0, straggler_factor=2.0,
)

ONLINE_SCENARIOS: Dict[str, OnlineScenario] = {
    "online-smoke": OnlineScenario(
        name="online-smoke",
        description=("CI-sized open-stream mix: 3 tenants (gold/silver/"
                     "bronze QoS) x {Poisson, diurnal, bursty MMPP} "
                     "arrivals x {synthetic, DAX-trace, WfCommons-trace} "
                     "apps, all 5 policies, warm-up truncated."),
        mix=ONLINE_SMOKE_MIX,
        policies=ALL_POLICY_NAMES,
        seeds=(0,),
        warmup_s=30.0,
        ebpsm_budget_met_floor=0.85,
    ),
    "online-heavy": OnlineScenario(
        name="online-heavy",
        description=("Stress open-stream mix: 5 tenants, 160 workflows, "
                     "bursty/diurnal arrivals, staggered onboarding, "
                     "mixed sizes — the autoscaling/admission-control "
                     "testbed."),
        mix=ONLINE_HEAVY_MIX,
        policies=("EBPSM", "MSLBL_MW"),
        seeds=(0, 1),
        warmup_s=120.0,
        ebpsm_budget_met_floor=0.60,
    ),
    "online-longhaul": OnlineScenario(
        name="online-longhaul",
        description=("Long-horizon open stream: 3 tenants, 1040 workflows "
                     "across synthetic + trace families at ~2 h of "
                     "simulated arrivals — the checkpoint/resume and "
                     "SoA-scale consumer; budget-met floor AND p95 "
                     "slowdown ceiling gated."),
        mix=ONLINE_LONGHAUL_MIX,
        policies=("EBPSM", "MSLBL_MW"),
        seeds=(0,),
        warmup_s=600.0,
        # Recorded trajectory: budget_met 0.978, p95 slowdown 10.13
        # (seed 0); floors leave ~3 pp / ~18 % headroom.
        ebpsm_budget_met_floor=0.95,
        p95_slowdown_ceiling=12.0,
    ),
    "online-chaos-smoke": OnlineScenario(
        name="online-chaos-smoke",
        description=("CI-sized adversarial-infrastructure mix: 3 tenants "
                     "across 4 workflow families (montage/epigenomics/"
                     "cybershake/seismology) under spot revocation "
                     "(60 % discount, 6/h churn), 2 % task failures and "
                     "5 % injected stragglers; gates EBPSM budget-met "
                     "and wasted-spend under churn."),
        mix=ONLINE_CHAOS_MIX,
        policies=ALL_POLICY_NAMES,
        seeds=(0,),
        warmup_s=30.0,
        chaos=CHAOS_SMOKE,
        # Recorded trajectory (seed 0): budget_met 0.971, wasted-spend
        # frac 0.073 — floors leave headroom for scheduling drift while
        # still catching absorbed-debt regressions.
        ebpsm_budget_met_floor=0.85,
        wasted_spend_ceiling=0.12,
        # Live-monitor gate: the chaos knobs must trip at least one
        # wasted-spend burn and one straggler-rate spike somewhere in
        # the stream (per-policy monitors summed; repro_torch.obs.monitor).
        alert_floors={"budget_burn": 1, "straggler_spike": 1},
    ),
    "online-chaos": OnlineScenario(
        name="online-chaos",
        description=("Full adversarial-infrastructure stress: 4 tenants, "
                     "128 workflows across 6 families, 12/h spot churn, "
                     "5 % failures, 10 % stragglers at 4x, 2 seeds — "
                     "the resilience testbed behind the chaos metrics."),
        mix=ONLINE_CHAOS_HEAVY_MIX,
        policies=("EBPSM", "EBPSM_NS", "MSLBL_MW"),
        seeds=(0, 1),
        warmup_s=120.0,
        chaos=CHAOS_HEAVY,
        # Recorded trajectory: budget_met 0.939/1.000, wasted-spend frac
        # ~0.147 (seeds 0/1).
        ebpsm_budget_met_floor=0.85,
        wasted_spend_ceiling=0.20,
    ),
}

AnyScenario = Union[Scenario, OnlineScenario]


def get_scenario(name: str) -> AnyScenario:
    if name in SCENARIOS:
        return SCENARIOS[name]
    if name in ONLINE_SCENARIOS:
        return ONLINE_SCENARIOS[name]
    raise SystemExit(
        f"unknown grid {name!r}; choose from "
        f"{sorted(SCENARIOS) + sorted(ONLINE_SCENARIOS)}"
    )
