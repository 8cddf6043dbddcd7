"""repro_torch.core.cycles ≡ repro.core.jax_cycles on the same requests.

Two levels:

* direct: identical random pools and task lists are built in both
  packages, and ``multi_cycle`` (several members at once) and
  ``batched_cycle`` must return identical placements;
* in a simulation: every batched cycle that the port's engines run gives
  the placements the reference's engines give at the same point.
"""
import random

import numpy as np
import pytest

import repro.core.jax_cycles as r_cyc
import repro.core.jax_engine as r_je
import repro.core.engine as r_eng
import repro_torch.core.batch_engine as t_be
import repro_torch.core.cycles as t_cyc
import repro_torch.core.engine as t_eng
from repro.core import budget as r_budget, cost_tables as r_tables
from repro.core import scheduler as r_sched
from repro.core.types import PlatformConfig as RConfig
from repro.sim import cloud as r_cloud
from repro.workflows import workload as r_wl
from repro_torch.core import budget as t_budget, cost_tables as t_tables
from repro_torch.core import scheduler as t_sched
from repro_torch.core.types import PlatformConfig as TConfig
from repro_torch.sim import cloud as t_cloud
from repro_torch.workflows import workload as t_wl

REF = dict(cloud=r_cloud, sched=r_sched, budget=r_budget, tables=r_tables,
           wl=r_wl, cfg=RConfig())
PORT = dict(cloud=t_cloud, sched=t_sched, budget=t_budget, tables=t_tables,
            wl=t_wl, cfg=TConfig())
APPS = ["montage", "sipht"]
KEYS = [("out", 0, i) for i in range(8)] + [("ext", 1, 0)]


def _request(pkg, cyc, rng, policy_idx, budget_choices):
    """One CycleRequest on a random pool, built identically per package."""
    cfg = pkg["cfg"]
    pool = pkg["cloud"].VMPool(cfg)
    vms = []
    for _ in range(rng.randrange(8, 40)):
        tag = rng.choice([None, ("app", rng.choice(APPS))])
        vm = pool.provision(rng.randrange(len(cfg.vm_types)), 0, tag)
        pool.mark_idle(vm, 0)
        if rng.random() < 0.6:
            pool.activate_container(vm, rng.choice(APPS), True)
        for key in rng.sample(KEYS, rng.randrange(len(KEYS))):
            vm.cache_put(cfg, key, rng.uniform(1, 600), pool.data_index)
        vms.append(vm)
    wf = pkg["wl"].generate_workload(cfg, pkg["wl"].WorkloadSpec(
        n_workflows=1, arrival_rate_per_min=6.0, seed=rng.randrange(50),
        apps=("montage",), sizes=("small",), budget_lo=0.5,
        budget_hi=1.0))[0]
    pkg["budget"].distribute_budget(cfg, wf, wf.budget)
    table = pkg["tables"].table_for(cfg, wf)
    tasks, tables = [], []
    for task in wf.tasks[:rng.randrange(8, 30)]:
        task.budget = rng.choice(budget_choices)
        inputs = [(k, rng.uniform(0, 200))
                  for k in rng.sample(KEYS, rng.randrange(1, 4))]
        tag = rng.choice([None, ("app", "montage")])
        tasks.append((task, wf.app, tag, inputs))
        tables.append(table)
    policy = pkg["sched"].ALL_POLICIES[policy_idx]
    return cyc.CycleRequest(cfg, policy, tasks, vms, pool, tables=tables)


def _key(placements):
    return [None if p is None else
            (p.vm.vmid if p.vm else None, p.new_vmt_idx, p.tier,
             p.est_finish_ms, p.est_cost) for p in placements]


def _run_multi(pkg, cyc, trial, budget_choices, **kw):
    rng = random.Random(trial)
    reqs = [_request(pkg, cyc, rng, i % 4, budget_choices)
            for i in range(1 + trial % 4)]
    return [_key(p) for p in cyc.multi_cycle(pkg["cfg"], reqs, **kw)]


@pytest.mark.parametrize("budgets", [(500.0,), (0.001, 0.5, 5.0, 500.0)],
                         ids=["sufficient", "mixed"])
@pytest.mark.parametrize("trial", range(5))
def test_multi_cycle_matches_reference(trial, budgets):
    want = _run_multi(REF, r_cyc, trial, budgets, use_pallas=False)
    got = _run_multi(PORT, t_cyc, trial, budgets, device="cpu")
    assert want == got


@pytest.mark.parametrize("trial", range(3))
def test_batched_cycle_matches_reference(trial):
    def run(pkg, cyc, **kw):
        req = _request(pkg, cyc, random.Random(100 + trial), trial,
                       (500.0,))
        return _key(cyc.batched_cycle(pkg["cfg"], req.policy, req.tasks,
                                      req.vms, req.pool, tables=req.tables,
                                      **kw))
    assert run(REF, r_cyc, use_pallas=False) == run(PORT, t_cyc,
                                                   device="cpu")


def _record(monkeypatch, module, name, log):
    """Wrap ``module.name`` so each call's placements are appended."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        log.append(out)
        return out
    monkeypatch.setattr(module, name, wrapped)


def _workload(wl, cfg, seed):
    return wl.generate_workload(cfg, wl.WorkloadSpec(
        n_workflows=8, arrival_rate_per_min=12.0, seed=seed,
        sizes=("small",), budget_lo=0.5, budget_hi=1.0))


@pytest.mark.parametrize("seed", [0, 3])
def test_engine_cycles_match_reference(seed, monkeypatch):
    """Every batched cycle of a SimEngine run and of a grid run places
    exactly what the reference's does at the same point."""
    logs = {}
    for tag, eng, be, cyc, pkg, kw in (
            ("ref", r_eng, r_je, r_cyc, REF, {}),
            ("port", t_eng, t_be, t_cyc, PORT, {"device": "cpu"})):
        cycles, rounds = [], []
        _record(monkeypatch, cyc, "batched_cycle", cycles)
        _record(monkeypatch, be, "multi_cycle", rounds)
        cfg, sched = pkg["cfg"], pkg["sched"]
        eng.SimEngine(cfg, sched.EBPSM, _workload(pkg["wl"], cfg, seed),
                      seed=seed, batched=True, **kw).run()
        be.simulate_batch(cfg, sched.ALL_POLICIES[:4],
                          _workload(pkg["wl"], cfg, seed), seed=seed,
                          batched=True, **kw)
        logs[tag] = ([_key(p) for p in cycles],
                     [[_key(p) for p in r] for r in rounds])
    assert logs["ref"][0] and logs["ref"][1]
    assert logs["ref"] == logs["port"]


def test_round_buffers_cover_and_reset():
    """A smaller round rides the resident covering bucket and the
    used-region reset restores inert padding (the reference's contract),
    through the numpy views of the torch buffers."""
    rb = t_cyc._RoundBuffers()
    tensors, big = rb.get(4, 16, 16)
    big[5][:2, :8, :8] = 7
    t2, again = rb.get(4, 16, 8)
    assert t2[5] is tensors[5]
    assert not tensors[5].any() and not again[5].any()
    assert big[2][0, 0] == -1.0
    assert np.shares_memory(again[5], tensors[5].numpy())
    _, tiny = rb.get(1, 2, 2)
    assert tiny[5].shape == (1, 2, 2)
    assert not tensors[0].is_pinned()
