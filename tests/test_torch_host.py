"""repro_torch's host modules ≡ the reference's on the same inputs.

The port copies the framework-free simulator modules (workloads, cost
tables, Algorithm 1/3 budget code, MSLBL, the per-task ``select``); these
tests hold each copy against its reference on identical seeds:

* the same ``WorkloadSpec`` gives identical ``Workflow`` fields and
  identical ``CostTable`` arrays;
* ``select`` placements on random pools match in both the scalar and the
  vectorized mode (the ``test_dispatcher_matrix.py`` property);
* ``distribute_budget``, ``update_budget``, ``update_budget_fast`` and the
  MSLBL distribution give identical budgets and spares
  (``test_redistribute.py`` pattern).
"""
import random

import numpy as np
import pytest

import repro.core.budget as r_budget
import repro.core.cost_tables as r_tables
import repro.core.scheduler as r_sched
import repro.sim.cloud as r_cloud
import repro.workflows.dax as r_dax
import repro.workflows.workload as r_wl
from repro.core import mslbl as r_mslbl
from repro.core.types import PlatformConfig as RConfig
import repro_torch.core.budget as t_budget
import repro_torch.core.cost_tables as t_tables
import repro_torch.core.scheduler as t_sched
import repro_torch.sim.cloud as t_cloud
import repro_torch.workflows.dax as t_dax
import repro_torch.workflows.workload as t_wl
from repro_torch.core import mslbl as t_mslbl
from repro_torch.core.types import PlatformConfig as TConfig

RCFG, TCFG = RConfig(), TConfig()
APPS = ["montage", "sipht", "epigenome", "ligo", "cybershake"]
TASK_FIELDS = ("tid", "size_mi", "out_mb", "ext_in_mb", "parents",
               "children", "shared_in", "level", "rank", "budget")
TABLE_ARRAYS = ("in_mb", "proc_ms", "rt_out_ms", "est_full_cost",
                "cost_bare", "by_speed", "tier_cost", "cheap_arr", "top_arr")


def assert_same_workflows(a, b):
    assert len(a) == len(b)
    for wa, wb in zip(a, b):
        assert (wa.wid, wa.app, wa.budget, wa.arrival_ms) == \
            (wb.wid, wb.app, wb.budget, wb.arrival_ms)
        assert len(wa.tasks) == len(wb.tasks)
        for ta, tb in zip(wa.tasks, wb.tasks):
            for f in TASK_FIELDS:
                assert getattr(ta, f) == getattr(tb, f), (wa.wid, ta.tid, f)


@pytest.mark.parametrize("spec", [
    dict(n_workflows=6, arrival_rate_per_min=6.0, seed=0),
    dict(n_workflows=5, arrival_rate_per_min=12.0, seed=3,
         sizes=("small", "medium"), budget_lo=0.4, budget_hi=1.0),
    dict(n_workflows=3, arrival_rate_per_min=2.0, seed=9,
         apps=("montage", "cybershake"), sizes=("medium",)),
], ids=["default", "mixed-sizes", "two-apps"])
def test_workload_identical(spec):
    a = r_wl.generate_workload(RCFG, r_wl.WorkloadSpec(**spec))
    b = t_wl.generate_workload(TCFG, t_wl.WorkloadSpec(**spec))
    assert_same_workflows(a, b)


@pytest.mark.parametrize("app", APPS)
def test_cost_tables_identical(app):
    a = r_dax.generate_workflow(app, 0, 60, np.random.default_rng(1))
    b = t_dax.generate_workflow(app, 0, 60, np.random.default_rng(1))
    ta, tb = r_tables.table_for(RCFG, a), t_tables.table_for(TCFG, b)
    for name in TABLE_ARRAYS:
        x, y = getattr(ta, name), getattr(tb, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert ta.tier_list == tb.tier_list and ta.rt_list == tb.rt_list
    assert ta.tiers_monotone == tb.tiers_monotone


def _random_pool(cloud, cfg, rng, n_vms, apps, keys):
    pool = cloud.VMPool(cfg)
    vms = []
    for _ in range(n_vms):
        tag = rng.choice([None, ("wf", rng.randrange(3)),
                          ("app", rng.choice(apps))])
        vm = pool.provision(rng.randrange(len(cfg.vm_types)), 0, tag)
        pool.mark_idle(vm, 0)
        if rng.random() < 0.7:
            pool.activate_container(vm, rng.choice(apps), True)
        for key in rng.sample(keys, rng.randrange(len(keys))):
            vm.cache_put(cfg, key, rng.uniform(1, 600), pool.data_index)
        vms.append(vm)
    return pool, vms


def _placements(pkg, trial, scalar, monkeypatch):
    """Every (policy, task, budget) placement on one random pool."""
    cloud, sched, budget, tables, wl, cfg = pkg
    monkeypatch.setattr(sched, "_SCALAR_FORCED", scalar)
    monkeypatch.setattr(sched, "VECTOR_SELECT_MIN_VMS", 1)
    rng = random.Random(1000 + trial)
    apps = ["montage", "sipht"]
    keys = [("out", 0, i) for i in range(6)] + [("ext", 1, 0)]
    pool, vms = _random_pool(cloud, cfg, rng, rng.randrange(1, 12), apps,
                             keys)
    wf = wl.generate_workload(cfg, wl.WorkloadSpec(
        n_workflows=2, arrival_rate_per_min=12.0, seed=trial % 4,
        sizes=("small",), budget_lo=0.5, budget_hi=1.0))[0]
    budget.distribute_budget(cfg, wf, wf.budget)
    table = tables.table_for(cfg, wf)
    out = []
    for policy in sched.ALL_POLICIES:
        for task in wf.tasks[:4]:
            inputs = [(k, rng.uniform(0, 200)) for k in
                      rng.sample(keys, rng.randrange(1, 4))]
            bud = rng.choice([0.001, 0.5, 5.0, 500.0])
            p = sched.select(cfg, policy, task, wf.wid, wf.app, inputs, bud,
                             vms, table=table, pool=pool)
            out.append((policy.name, p.vm.vmid if p.vm else None,
                        p.new_vmt_idx, p.tier, p.est_finish_ms, p.est_cost))
    return out


REF = (r_cloud, r_sched, r_budget, r_tables, r_wl, RCFG)
PORT = (t_cloud, t_sched, t_budget, t_tables, t_wl, TCFG)


@pytest.mark.parametrize("scalar", [False, True], ids=["vector", "scalar"])
@pytest.mark.parametrize("trial", range(6))
def test_select_matches_reference_random_pools(trial, scalar, monkeypatch):
    want = _placements(REF, trial, scalar, monkeypatch)
    got = _placements(PORT, trial, scalar, monkeypatch)
    assert want == got


def _prepared(dax, budget, cfg, seed, n, app, frac):
    rng = np.random.default_rng(seed)
    wf = dax.generate_workflow(app, 0, n, rng)
    lo, hi = budget.min_max_workflow_cost(cfg, wf)
    spare = budget.distribute_budget(cfg, wf, lo + frac * (hi - lo))
    nsched = int(rng.integers(1, wf.n_tasks + 1))
    sched = set(rng.choice(wf.n_tasks, size=nsched, replace=False).tolist())
    fin = min(sched)
    uns = [t.tid for t in wf.tasks if t.tid not in sched]
    actual = float(rng.uniform(0, 2.5)) * max(wf.tasks[fin].budget, 1.0)
    return wf, spare, fin, uns, actual


@pytest.mark.parametrize("trial", range(6))
def test_budget_algorithms_match_reference(trial):
    """Alg. 1 distribution, scalar and array Alg. 3 updates."""
    app = APPS[trial % 5]
    n = [8, 30, 60, 120, 200, 400][trial]
    frac = [0.0, 0.3, 0.6, 0.9, 1.0, 0.5][trial]
    r = _prepared(r_dax, r_budget, RCFG, trial, n, app, frac)
    t = _prepared(t_dax, t_budget, TCFG, trial, n, app, frac)
    (rwf, rspare, fin, uns, actual), (twf, tspare, *_rest) = r, t
    assert rspare == tspare
    assert [x.budget for x in rwf.tasks] == [x.budget for x in twf.tasks]
    rwf2, twf2 = rwf.clone(), twf.clone()
    assert r_budget.update_budget(RCFG, rwf, fin, actual, rspare, uns) == \
        t_budget.update_budget(TCFG, twf, fin, actual, tspare, uns)
    assert [x.budget for x in rwf.tasks] == [x.budget for x in twf.tasks]
    rs_r = r_budget.RedistState(RCFG, rwf2, uns)
    rs_t = t_budget.RedistState(TCFG, twf2, uns)
    assert r_budget.update_budget_fast(RCFG, rwf2, rs_r, fin, actual,
                                       rspare) == \
        t_budget.update_budget_fast(TCFG, twf2, rs_t, fin, actual, tspare)
    assert [x.budget for x in rwf2.tasks] == [x.budget for x in twf2.tasks]
    assert np.array_equal(rs_r.budget_vec, rs_t.budget_vec)


@pytest.mark.parametrize("app", APPS)
def test_mslbl_distribution_matches_reference(app):
    a = r_dax.generate_workflow(app, 0, 50, np.random.default_rng(7))
    b = t_dax.generate_workflow(app, 0, 50, np.random.default_rng(7))
    lo, hi = r_budget.min_max_workflow_cost(RCFG, a)
    assert (lo, hi) == t_budget.min_max_workflow_cost(TCFG, b)
    r_mslbl.distribute_budget_mslbl(RCFG, a, 0.5 * (lo + hi))
    t_mslbl.distribute_budget_mslbl(TCFG, b, 0.5 * (lo + hi))
    assert [x.budget for x in a.tasks] == [x.budget for x in b.tasks]
