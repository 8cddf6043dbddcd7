"""repro_torch.tenants ≡ repro.tenants on the same seeds.

* every arrival process (Poisson, Markov-modulated, diurnal, trace
  replay) draws identical times from identically seeded generators;
* a tenant mix builds identical workflows, budgets, tenant/QoS maps and
  ideal makespans;
* every bundled trace parses to identical workflows, and the port's
  ``tenants/data/`` files are byte-identical to the reference's.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import repro.tenants as r_ten
import repro_torch.tenants as t_ten
from repro.core.types import PlatformConfig as RConfig
from repro_torch.core.types import PlatformConfig as TConfig

ROOT = Path(__file__).resolve().parents[1]
RCFG, TCFG = RConfig(), TConfig()
TASK_FIELDS = ("tid", "size_mi", "out_mb", "ext_in_mb", "parents",
               "children", "shared_in", "level", "rank", "budget")


def assert_same_workflows(a, b):
    assert len(a) == len(b)
    for wa, wb in zip(a, b):
        assert (wa.wid, wa.app, wa.budget, wa.arrival_ms) == \
            (wb.wid, wb.app, wb.budget, wb.arrival_ms)
        assert len(wa.tasks) == len(wb.tasks)
        for ta, tb in zip(wa.tasks, wb.tasks):
            for f in TASK_FIELDS:
                assert getattr(ta, f) == getattr(tb, f), (wa.wid, ta.tid, f)


ARRIVALS = [
    ("Poisson", (6.0,), {}),
    ("Poisson", (0.5,), {}),
    ("MarkovModulated", (1.0, 12.0), dict(mean_dwell_s=30.0)),
    ("MarkovModulated", (0.0, 16.0), dict(mean_dwell_s=45.0)),
    ("Diurnal", (2.0, 10.0), dict(period_s=300.0)),
    ("Diurnal", (3.0, 12.0), dict(period_s=240.0, phase=0.3)),
    ("TraceReplay", (), dict(times_ms=(0, 500, 2_000, 9_000))),
]


@pytest.mark.parametrize("name,args,kw", ARRIVALS,
                         ids=[f"{a[0]}{i}" for i, a in enumerate(ARRIVALS)])
@pytest.mark.parametrize("seed", [0, 7])
def test_arrival_times_identical(name, args, kw, seed):
    r_proc = getattr(r_ten, name)(*args, **kw)
    t_proc = getattr(t_ten, name)(*args, **kw)
    want = r_proc.arrival_times_ms(200, np.random.default_rng(seed))
    got = t_proc.arrival_times_ms(200, np.random.default_rng(seed))
    assert got == want
    assert t_proc.mean_rate_per_min() == r_proc.mean_rate_per_min()


def _mix(pkg):
    return pkg.TenantMix((
        pkg.Tenant("gold-astro", pkg.GOLD,
                   apps=("montage", "trace:montage-18"),
                   arrival=pkg.Poisson(8.0), n_workflows=4),
        pkg.Tenant("silver-bio", pkg.SILVER, apps=("trace:epigenomics-20",),
                   arrival=pkg.Diurnal(3.0, 12.0, period_s=240.0),
                   n_workflows=3),
        pkg.Tenant("bronze-seis", pkg.BRONZE,
                   apps=("sipht", "trace:seismology-9",
                         "trace:cybershake-12"),
                   arrival=pkg.MarkovModulated(2.0, 16.0, mean_dwell_s=45.0),
                   n_workflows=5),
    ))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_tenant_workload_identical(seed):
    want = _mix(r_ten).build(RCFG, seed=seed)
    got = _mix(t_ten).build(TCFG, seed=seed)
    assert_same_workflows(got.workflows, want.workflows)
    assert got.tenant_of == want.tenant_of
    assert got.qos_of == want.qos_of
    assert got.priority_of == want.priority_of
    assert got.ideal_ms(TCFG) == want.ideal_ms(RCFG)
    assert _mix(t_ten).budget_span() == _mix(r_ten).budget_span()
    assert _mix(t_ten).mean_rate_per_min() == _mix(r_ten).mean_rate_per_min()


def _stream_mix(pkg, wl_mod, cfg):
    def stream(n, seed):
        return wl_mod.generate_workload(cfg, wl_mod.WorkloadSpec(
            n_workflows=n, seed=seed, arrival_rate_per_min=4.0,
            sizes=("small", "medium")))
    return pkg.TenantMix((
        pkg.Tenant("early", pkg.GOLD, apps=("ligo", "epigenome"),
                   arrival=pkg.Poisson(3.0), n_workflows=3,
                   sizes=("small", "medium")),
        dataclasses.replace(
            pkg.Tenant("late", pkg.BRONZE, stream=stream, n_workflows=3),
            start_ms=60_000),
    ))


def test_stream_tenant_identical():
    import repro.workflows.workload as r_wl
    import repro_torch.workflows.workload as t_wl
    want = _stream_mix(r_ten, r_wl, RCFG).build(RCFG, seed=2)
    got = _stream_mix(t_ten, t_wl, TCFG).build(TCFG, seed=2)
    assert_same_workflows(got.workflows, want.workflows)
    assert got.tenant_of == want.tenant_of
    assert got.ideal_ms(TCFG) == want.ideal_ms(RCFG)


@pytest.mark.parametrize("name", r_ten.bundled_trace_names())
def test_bundled_trace_identical(name):
    assert t_ten.bundled_trace_names() == r_ten.bundled_trace_names()
    assert_same_workflows([t_ten.bundled_trace(name)],
                          [r_ten.bundled_trace(name)])
    assert t_ten.infer_family(name) == r_ten.infer_family(name)


def test_trace_data_files_byte_identical():
    ref = ROOT / "src" / "repro" / "tenants" / "data"
    port = ROOT / "src" / "repro_torch" / "tenants" / "data"
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in port.iterdir()) == names
    for n in names:
        assert (port / n).read_bytes() == (ref / n).read_bytes(), n
    # The port reads its own copy, never the reference's directory.
    from repro_torch.tenants import traces
    assert Path(traces.DATA_DIR).resolve() == port.resolve()
