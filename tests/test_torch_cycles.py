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
import torch

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


INERT = (0.0, 0.0, -1.0, 0.0, 0.0, 0, 1.0, 1.0, 1.0)


def _assert_inert(view):
    for a, value in zip(view.arrays, INERT):
        assert (a == value).all()


def test_round_buffers_cover_and_reset():
    """A smaller round rides the resident covering bucket, laid out at
    its own shape in the same allocation, and sees only inert padding
    after a larger round dirtied every array (the reference's contract),
    through the numpy views of the torch buffers."""
    rb = t_cyc._RoundBuffers()
    big = rb.get(4, 16, 16)
    _assert_inert(big)
    for a in big.arrays:
        a[...] = 7
    again = rb.get(4, 16, 8)
    assert again.bucket is big.bucket
    assert again.tensors[5].shape == (4, 16, 8)
    assert np.shares_memory(again.arrays[5], big.bucket.host.numpy())
    assert again.nbytes < big.nbytes
    _assert_inert(again)
    for a in again.arrays:
        a[...] = 5
    assert rb.get(4, 16, 8) is again          # same shape: same views
    _assert_inert(again)
    tiny = rb.get(1, 2, 2)
    assert tiny.tensors[5].shape == (1, 2, 2)
    _assert_inert(tiny)
    assert not big.bucket.host.is_pinned()


@pytest.mark.parametrize("shape", [(1, 2, 2), (4, 16, 8), (2, 37, 100),
                                   (1, 256, 1024)])
def test_packed_views_aligned_and_shaped_to_the_round(shape):
    """Every array of a packed round starts on a 16-byte boundary, has
    the round's own shape and dtype, and the nine sit back to back
    inside the round's bytes."""
    from repro_torch.kernels.affinity.ops import PackedRound, round_layout
    B, T, V = shape
    bucket = PackedRound(2 * B, 2 * T, 2 * V, torch.device("cpu"))
    view = bucket.view(B, T, V)
    base = bucket.host.data_ptr()
    offsets, nbytes = round_layout(B, T, V)
    want = [(B, T)] * 3 + [(B, T, V)] * 3 + [(B, V)] * 3
    assert view.nbytes == nbytes <= bucket.host.numel()
    for t, a, off, shp in zip(view.tensors, view.arrays, offsets, want):
        assert t.shape == shp and t.is_contiguous()
        assert t.data_ptr() - base == off and off % 16 == 0
        assert off + 4 * t.numel() <= nbytes
        assert a.ctypes.data == t.data_ptr()
    assert view.tensors[5].dtype == torch.int32
    assert all(t.dtype == torch.float32
               for i, t in enumerate(view.tensors) if i != 5)


@pytest.mark.parametrize("trial", range(4))
def test_round_riding_a_larger_bucket_matches_reference(trial, monkeypatch):
    """Rounds staged inside a larger resident bucket (dirtied by an
    earlier, larger round) give the reference's ``multi_cycle``
    placements bit for bit."""
    rb = t_cyc._RoundBuffers()
    dirty = rb.get(8, 64, 64)
    for a in dirty.arrays:
        a[...] = 3
    monkeypatch.setattr(t_cyc._ROUND_BUFFERS, "by_device",
                        {torch.device("cpu"): rb})
    monkeypatch.setattr(t_cyc._RoundBuffers, "COVER_SLACK", 1 << 20)
    shapes = []
    score = t_cyc._score_round

    def counted(cfg, view):
        shapes.append((view.shape, view.bucket.shape))
        return score(cfg, view)
    monkeypatch.setattr(t_cyc, "_score_round", counted)
    budgets = (0.001, 0.5, 5.0, 500.0)
    want = _run_multi(REF, r_cyc, trial, budgets, use_pallas=False)
    got = _run_multi(PORT, t_cyc, trial, budgets, device="cpu")
    assert want == got
    assert shapes and all(b == (8, 64, 64) for _, b in shapes)
    assert any(s != b for s, b in shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("trial", range(3))
def test_cuda_packed_round_matches_plain(trial):
    """The packed round on the card (one copy each way, one launch)
    against the plain version on the same views, bit for bit, for rounds
    at and below their bucket's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.affinity import ops
    rng = np.random.default_rng(trial)
    bucket = ops.PackedRound(4, 256, 1024, torch.device("cuda"))
    for B, T, V in [(4, 256, 1024), (1, 256, 1024), (2, 64, 512),
                    (4, 2, 512), (1, 37, 100)]:
        view = bucket.view(B, T, V)
        view.reset()
        Tr, Vr = max(1, T - 3), max(1, V - 5)
        size, out_mb, budget, miss, cont, tier, mips, bw, price = \
            view.arrays
        size[:, :Tr] = rng.uniform(10, 900, (B, Tr))
        out_mb[:, :Tr] = rng.uniform(1, 150, (B, Tr))
        budget[:, :Tr] = rng.uniform(5, 500, (B, Tr))
        miss[:, :Tr, :Vr] = rng.uniform(0, 200, (B, Tr, Vr))
        cont[:, :Tr, :Vr] = rng.choice([0., 400., 10000.], (B, Tr, Vr))
        tier[:, :Tr, :Vr] = rng.choice([0, 1, 2, 3], (B, Tr, Vr))
        mips[:, :Vr] = rng.choice([2., 4., 8., 16.], (B, Vr))
        bw[:, :Vr] = rng.uniform(5, 40, (B, Vr))
        price[:, :Vr] = rng.choice([1., 2., 4., 8.], (B, Vr))
        want = ops.affinity_ref(*(t.cuda() for t in view.tensors),
                                50.0, 30.0, 1000.0)
        before = ops.LAUNCHES
        got = ops.affinity_round(view, 50.0, 30.0, 1000.0)
        assert ops.LAUNCHES == before + 1
        for w, g in zip(want, got):
            assert np.array_equal(w.cpu().numpy(), g)
