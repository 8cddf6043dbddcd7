"""repro_torch engines ≡ the reference's engines, bit for bit.

``SimEngine`` and ``simulate_batch``/``BatchSimEngine`` of the port run
with ``device="cpu"`` (rounds scored by the plain torch version) and must
reproduce the reference's results exactly: per-workflow finish times and
costs, VM counts and VM-seconds by type — for every policy and seed, both
dispatcher modes, both state layouts, with chaos on, and down to the
structured event logs.  A snapshot taken mid-stream in the port resumes
bit-exact.
"""
import pickle

import numpy as np
import pytest

import repro.chaos as r_chaos
import repro.core.engine as r_eng
import repro.core.jax_cycles as r_cyc
import repro.core.jax_engine as r_be
import repro.core.scheduler as r_sched
import repro.workflows.workload as r_wl
import repro_torch.chaos as t_chaos
import repro_torch.core.batch_engine as t_be
import repro_torch.core.cycles as t_cyc
import repro_torch.core.engine as t_eng
import repro_torch.core.scheduler as t_sched
import repro_torch.workflows.workload as t_wl
from repro.core.types import PlatformConfig as RConfig
from repro_torch.core.types import PlatformConfig as TConfig

RCFG, TCFG = RConfig(), TConfig()
CPU = {"device": "cpu"}
POLICY_NAMES = [p.name for p in r_sched.ALL_POLICIES]
CHAOS_KW = dict(spot_discount=0.6, revocation_rate=8.0, fail_prob=0.05,
                max_retries=3, escalate_after=2, straggler_prob=0.1,
                straggler_slowdown=4.0, straggler_factor=2.0, seed=0)


def pol(sched, name):
    return next(p for p in sched.ALL_POLICIES if p.name == name)


def r_workload(seed, n=8, rate=6.0):
    return r_wl.generate_workload(RCFG, r_wl.WorkloadSpec(
        n_workflows=n, arrival_rate_per_min=rate, seed=seed,
        sizes=("small",), budget_lo=0.5, budget_hi=1.0))


def t_workload(seed, n=8, rate=6.0):
    return t_wl.generate_workload(TCFG, t_wl.WorkloadSpec(
        n_workflows=n, arrival_rate_per_min=rate, seed=seed,
        sizes=("small",), budget_lo=0.5, budget_hi=1.0))


def signature(res):
    return ([w.finish_ms for w in res.workflows],
            [w.cost for w in res.workflows],
            res.vm_count_by_type, res.vm_seconds_by_type)


def chaos_signature(res):
    return signature(res) + ((res.revocations, res.task_failures,
                              res.task_retries, res.stragglers_detected,
                              res.wasted_cost, res.spot_vms),)


@pytest.mark.parametrize("name", POLICY_NAMES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engines_match_reference(name, seed):
    """Both engines, auction forced on, every policy and seed."""
    want = r_be.simulate_batch(RCFG, pol(r_sched, name), r_workload(seed),
                               seed=seed, batched=True).results[0]
    got = t_be.simulate_batch(TCFG, pol(t_sched, name), t_workload(seed),
                              seed=seed, batched=True, **CPU).results[0]
    assert signature(got) == signature(want)
    want = r_eng.SimEngine(RCFG, pol(r_sched, name), r_workload(seed),
                           seed=seed, batched=True).run()
    got = t_eng.SimEngine(TCFG, pol(t_sched, name), t_workload(seed),
                          seed=seed, batched=True, **CPU).run()
    assert signature(got) == signature(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_round_scored_matches_reference(seed, monkeypatch):
    """With the serial-tail threshold at 1, every auction round of these
    small cycles goes through the affinity scoring instead of draining on
    the host — the grid must still equal the reference's."""
    monkeypatch.setattr(r_cyc, "AUCTION_TAIL_PAIRS", 1)
    monkeypatch.setattr(t_cyc, "AUCTION_TAIL_PAIRS", 1)
    rounds = []
    score = t_cyc._score_round

    def counted(*a):
        rounds.append(a[1].shape)
        return score(*a)
    monkeypatch.setattr(t_cyc, "_score_round", counted)
    want = r_be.simulate_batch(RCFG, r_sched.ALL_POLICIES, r_workload(seed),
                               seed=seed, batched=True)
    got = t_be.simulate_batch(TCFG, t_sched.ALL_POLICIES, t_workload(seed),
                              seed=seed, batched=True, **CPU)
    assert len(rounds) > 0
    for a, b in zip(want.results, got.results):
        assert signature(b) == signature(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auto_dispatch_matches_reference(seed):
    """Default ("auto") dispatch on a whole policies × seeds grid."""
    want = r_be.simulate_batch(RCFG, r_sched.ALL_POLICIES, r_workload(seed),
                               seed=[seed, seed + 3])
    got = t_be.simulate_batch(TCFG, t_sched.ALL_POLICIES, t_workload(seed),
                              seed=[seed, seed + 3], **CPU)
    assert [(e.policy, e.seed) for e in got.entries] == \
        [(e.policy, e.seed) for e in want.entries]
    for a, b in zip(want.results, got.results):
        assert signature(b) == signature(a)


@pytest.mark.parametrize("soa", [True, False], ids=["soa", "object"])
def test_state_layouts_match_reference(soa, monkeypatch):
    """SoA and object layouts, with rounds small enough that the
    aggregate dispatcher rides the auction."""
    monkeypatch.setattr(r_be, "AUCTION_MIN_PAIRS_ROUND", 16)
    monkeypatch.setattr(t_be, "AUCTION_MIN_PAIRS_ROUND", 16)
    r_members = [(p, r_workload(i, n=5, rate=12.0), i)
                 for i, p in enumerate(r_sched.ALL_POLICIES)]
    t_members = [(p, t_workload(i, n=5, rate=12.0), i)
                 for i, p in enumerate(t_sched.ALL_POLICIES)]
    r_e = r_be.BatchSimEngine(RCFG, r_members, soa=soa)
    t_e = t_be.BatchSimEngine(TCFG, t_members, soa=soa, **CPU)
    assert (t_e.stream is not None) == soa
    for a, b in zip(r_e.run(), t_e.run()):
        assert signature(b) == signature(a)
    assert t_e.dispatch_stats()["batched_calls"] == \
        r_e.dispatch_stats()["batched_calls"] > 0
    want = r_eng.SimEngine(RCFG, r_sched.EBPSM, r_workload(4), seed=4,
                           soa=soa).run()
    got = t_eng.SimEngine(TCFG, t_sched.EBPSM, t_workload(4), seed=4,
                          soa=soa, **CPU).run()
    assert signature(got) == signature(want)


@pytest.mark.parametrize("name", ["EBPSM", "MSLBL_MW"])
def test_chaos_matches_reference(name):
    r_cfg, t_cfg = r_chaos.ChaosConfig(**CHAOS_KW), \
        t_chaos.ChaosConfig(**CHAOS_KW)
    want = r_be.simulate_batch(RCFG, pol(r_sched, name),
                               r_workload(0, rate=20.0), seed=0,
                               batched=True, chaos=r_cfg).results[0]
    got = t_be.simulate_batch(TCFG, pol(t_sched, name),
                              t_workload(0, rate=20.0), seed=0,
                              batched=True, chaos=t_cfg, **CPU).results[0]
    assert chaos_signature(got) == chaos_signature(want)
    assert want.revocations + want.task_failures > 0
    want = r_eng.SimEngine(RCFG, pol(r_sched, name), r_workload(0, rate=20.0),
                           seed=0, chaos=r_cfg).run()
    got = t_eng.SimEngine(TCFG, pol(t_sched, name), t_workload(0, rate=20.0),
                          seed=0, chaos=t_cfg, **CPU).run()
    assert chaos_signature(got) == chaos_signature(want)


def _log_arrays(log):
    return {k: v.tolist() for k, v in log.to_arrays().items()}


def test_event_logs_match_reference():
    """Member logs and the grid engine's grid log, column for column."""
    kw = dict(batched=True, events=True)
    r_e = r_be.BatchSimEngine(RCFG, [(p, r_workload(2), 2)
                                     for p in r_sched.ALL_POLICIES], **kw)
    t_e = t_be.BatchSimEngine(TCFG, [(p, t_workload(2), 2)
                                     for p in t_sched.ALL_POLICIES],
                              **kw, **CPU)
    r_e.run()
    t_e.run()
    for a, b in zip(r_e.states, t_e.states):
        assert len(a.elog) > 0
        assert _log_arrays(b.elog) == _log_arrays(a.elog)
    assert _log_arrays(t_e.elog) == _log_arrays(r_e.elog)
    assert t_e.dispatch_stats()["events"] == r_e.dispatch_stats()["events"]


def test_trace_rows_match_reference():
    r = r_eng.SimEngine(RCFG, r_sched.EBPSM, r_workload(4), seed=0,
                        batched=True, trace=True)
    r.run()
    t = t_eng.SimEngine(TCFG, t_sched.EBPSM, t_workload(4), seed=0,
                        batched=True, trace=True, **CPU)
    t.run()
    assert t.trace_rows == r.trace_rows


def _members(seed=1):
    return [(p, t_workload(seed, n=6, rate=20.0), seed)
            for p in t_sched.ALL_POLICIES]


@pytest.mark.parametrize("cut_round", [0, 3])
def test_snapshot_resume_bit_exact(cut_round):
    """A port grid cut at a rendezvous round, pickled, and resumed in a
    fresh engine finishes bit-exact with the uninterrupted run."""
    chaos = t_chaos.ChaosConfig(**CHAOS_KW)
    ref = t_be.BatchSimEngine(TCFG, _members(), trace=True, chaos=chaos,
                              batched=True, **CPU)
    want = [chaos_signature(r) for r in ref.run()]
    cut = {}

    def hook(eng):
        if eng.rounds >= cut_round:
            cut["snap"] = pickle.dumps(eng.snapshot())
            return True
        return False

    eng = t_be.BatchSimEngine(TCFG, _members(), trace=True, chaos=chaos,
                              batched=True, **CPU)
    with pytest.raises(t_be.StreamInterrupted):
        eng.run(ckpt_hook=hook)
    eng2 = t_be.BatchSimEngine(TCFG, _members(), trace=True, chaos=chaos,
                               batched=True, **CPU)
    eng2.load_snapshot(pickle.loads(cut["snap"]))
    assert [chaos_signature(r) for r in eng2.run()] == want
    assert [st.trace_rows for st in eng2.states] == \
        [st.trace_rows for st in ref.states]


def test_workloads_not_mutated_and_all_complete():
    wl = t_workload(5)
    before = [[t.budget for t in wf.tasks] for wf in wl]
    grid = t_be.simulate_batch(TCFG, t_sched.ALL_POLICIES, wl, seed=[0, 1],
                               **CPU)
    assert [[t.budget for t in wf.tasks] for wf in wl] == before
    for e in grid.entries:
        assert all(w.finish_ms >= w.arrival_ms for w in e.result.workflows)
        assert np.isfinite([w.cost for w in e.result.workflows]).all()
