"""repro_torch.waas ≡ repro.waas, on the CPU.

The ML-job WaaS platform (slice catalogue, ML job DAGs, EBPSM and the
other policies over them) is numpy and pure Python in both packages; the
port's engines score their batched auction rounds with the plain torch
version here (``device="cpu"``).  Held equal to the reference on the same
seeds, with ``art_dir='/nonexistent'`` (the analytic cost fallback) unless
a test writes its own dry-run artifacts: the stage cost model, every
arch's job DAGs, ``ml_workload`` streams, ``run_platform`` with events and
the monitor, ``compare_policies`` rows, ``sweep`` rows (the defaults, the
reference test's grid, and a grid large enough that its rounds reach the
affinity kernel on a card: ``KERNEL_SWEEP``) and both
``straggler_experiment`` routes.  Equal means equal: the simulations are
bit-exact, so no tolerance is taken.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core.scheduler import EBPSM as J_EBPSM
from repro.core.scheduler import MSLBL_MW as J_MSLBL_MW
from repro.waas import mljobs as jmljobs
from repro.waas import platform as jplatform
from repro.waas import slices as jslices
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.scheduler import EBPSM, MSLBL_MW
from repro_torch.waas import mljobs, platform, slices

NOART = "/nonexistent"
# A sweep whose rendezvous rounds reach the auction (978 of them on the
# CPU, counted at ``cycles._score_round``); the defaults reach none.
KERNEL_SWEEP = dict(n_jobs=400, rates=(1000.0,))
KERNEL_SWEEP_ROUNDS = 978


def _tasks(wf):
    return [(t.tid, t.size_mi, t.out_mb, t.ext_in_mb, list(t.parents),
             list(t.children), list(t.shared_in)) for t in wf.tasks]


def _wf(wf):
    return (wf.wid, wf.app, wf.arrival_ms, _tasks(wf))


def _rows(reports):
    return [(r.metrics.to_dict(), r.slice_mix, r.row()) for r in reports]


def test_slice_catalogue_matches_reference():
    """Field for field (the two packages' dataclasses are distinct
    classes)."""
    assert [dataclasses.asdict(v) for v in slices.SLICE_TYPES] \
        == [dataclasses.asdict(v) for v in jslices.SLICE_TYPES]
    assert slices.GFLOPS_PER_CHIP == jslices.GFLOPS_PER_CHIP
    got = dataclasses.asdict(slices.platform_config(idle_threshold_ms=5))
    assert got == dataclasses.asdict(
        jslices.platform_config(idle_threshold_ms=5))


def test_stage_cost_model_matches_reference(tmp_path):
    """The analytic fallback for every arch and shape, then the measured
    path reading dry-run artifacts (one skipped, one without flops)."""
    arts = {"a": {"arch": "llama3-8b", "shape": "train_4k",
                  "mesh": {"n_devices": 256}, "flops_per_device": 3.5e15},
            "b": {"arch": "qwen3-32b", "shape": "decode_32k",
                  "skipped": "no"},
            "c": {"arch": "hubert-xlarge", "shape": "prefill_32k"}}
    for name, art in arts.items():
        (tmp_path / f"singlepod__{name}.json").write_text(json.dumps(art))
    shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    for art_dir in (NOART, str(tmp_path)):
        t, j = mljobs.StageCostModel(art_dir), jmljobs.StageCostModel(art_dir)
        assert t.measured == j.measured
        for arch in ARCH_IDS:
            assert t.weight_mb(arch) == j.weight_mb(arch)
            for shape in shapes:
                assert t.step_gflops(arch, shape) == j.step_gflops(arch, shape)
    assert mljobs.StageCostModel(str(tmp_path)).measured == {
        ("llama3-8b", "train_4k"): 3.5e15 * 256}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_job_dags_match_reference(arch):
    t, j = mljobs.StageCostModel(NOART), jmljobs.StageCostModel(NOART)
    rt, rj = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):
        ft = mljobs.finetune_job(0, arch, t, rt)
        assert _tasks(ft) == _tasks(jmljobs.finetune_job(0, arch, j, rj))
        sv = mljobs.serve_job(1, arch, t, rt)
        assert _tasks(sv) == _tasks(jmljobs.serve_job(1, arch, j, rj))
        ft.validate()
        sv.validate()


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_ml_workload_matches_reference(seed):
    got = mljobs.ml_workload(30, 3.0, seed=seed, art_dir=NOART)
    want = jmljobs.ml_workload(30, 3.0, seed=seed, art_dir=NOART)
    assert [_wf(w) for w in got] == [_wf(w) for w in want]
    arr = [w.arrival_ms for w in got]
    assert arr == sorted(arr) and len({w.app for w in got}) > 3


def test_run_platform_with_events_and_monitor_matches_reference():
    cfg, jcfg = slices.platform_config(), jslices.platform_config()
    t = platform.run_platform(platform.ml_stream(cfg, 20, 2.0, 3, NOART),
                              EBPSM, cfg, seed=0, events=True, monitor=True,
                              device="cpu")
    j = jplatform.run_platform(jplatform.ml_stream(jcfg, 20, 2.0, 3, NOART),
                               J_EBPSM, jcfg, seed=0, events=True,
                               monitor=True)
    assert _rows([t]) == _rows([j])
    assert t.series == j.series and t.monitor == j.monitor
    assert t.locality_hit_rate > 0.15      # warm base-weight placements


def test_compare_policies_rows_match_reference(monkeypatch):
    """Rows equal; at the defaults no cycle takes the batched (kernel)
    path: none reaches ``AUCTION_MIN_PAIRS`` queue × pool pairs."""
    from repro_torch.core.engine import SimEngine
    batched = []
    cycle = SimEngine._schedule_cycle_batched
    monkeypatch.setattr(SimEngine, "_schedule_cycle_batched",
                        lambda self, idle: batched.append(1)
                        or cycle(self, idle))
    got = platform.compare_policies(art_dir=NOART, device="cpu")
    want = jplatform.compare_policies(art_dir=NOART)
    assert _rows(got) == _rows(want)
    assert len(got) == 5 and not batched


@pytest.mark.parametrize("kw", [
    {},
    dict(n_jobs=6, rates=(2.0,), seeds=(0, 1),
         policies=(EBPSM, MSLBL_MW)),
    KERNEL_SWEEP], ids=["defaults", "two-policies", "kernel-rounds"])
def test_sweep_rows_match_reference(kw, monkeypatch):
    from repro_torch.core import cycles
    jkw = dict(kw)
    if "policies" in kw:
        jkw["policies"] = (J_EBPSM, J_MSLBL_MW)
    rounds = []
    score = cycles._score_round
    monkeypatch.setattr(cycles, "_score_round",
                        lambda cfg, view: rounds.append(1) or score(cfg, view))
    got = platform.sweep(art_dir=NOART, device="cpu", **kw)
    assert got == jplatform.sweep(art_dir=NOART, **jkw)
    assert len(rounds) == (KERNEL_SWEEP_ROUNDS if kw is KERNEL_SWEEP else 0)


@pytest.mark.parametrize("route", [
    dict(n_jobs=12, rate=2.0, seed=2, degradations=(0.1, 0.5)),
    dict(slowdowns=(2.0, 4.0))], ids=["degradation", "chaos"])
def test_straggler_experiment_matches_reference(route):
    got = platform.straggler_experiment(art_dir=NOART, device="cpu", **route)
    assert got == jplatform.straggler_experiment(art_dir=NOART, **route)
    assert sorted(got) == ["EBPSM", "MSLBL_MW"]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    cfg = slices.platform_config()
    wfs = platform.ml_stream(cfg, 2, 2.0, 0, NOART)
    for call in (lambda: platform.sweep(n_jobs=2, art_dir=NOART),
                 lambda: platform.compare_policies(n_jobs=2, art_dir=NOART),
                 lambda: platform.straggler_experiment(n_jobs=2,
                                                       art_dir=NOART),
                 lambda: platform.run_platform(wfs, EBPSM, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.cuda
def test_cuda_sweep_matches_cpu():
    """``KERNEL_SWEEP`` on the card: the same rows as on the CPU, every
    round through the affinity kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.affinity import ops
    before = ops.LAUNCHES
    got = platform.sweep(art_dir=NOART, device="cuda", **KERNEL_SWEEP)
    assert ops.LAUNCHES - before == KERNEL_SWEEP_ROUNDS
    assert got == platform.sweep(art_dir=NOART, device="cpu", **KERNEL_SWEEP)
