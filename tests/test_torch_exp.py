"""repro_torch.exp ≡ repro.exp on the CPU.

* the scenario registries (closed grids, online streams, policies) and
  the workload cells they expand to are equal;
* ``CellMetrics.from_result`` and ``aggregate_by_policy`` give equal
  results on the same ``SimResult`` (and on each package's own engine
  run of the same cell);
* ``run_grid`` on ``paper-smoke`` and ``run_online`` on ``online-smoke``
  and ``online-chaos-smoke`` (``device="cpu"``) give artifacts equal to
  the reference's, field by field, except the backend fields ``wall_s``
  and ``use_pallas``; rows, summaries and ``dispatch`` counts included;
* ``workers=2`` (spawn pool) equals the serial run;
* ``check_floors`` gives the same failures on the same artifact;
* ``main([... "--device", "cpu"])`` writes a ``BENCH_paper_grid.json``,
  a ``paper_grid.md`` and trace/report files equal to the reference
  CLI's, except the backend and wall fields.
"""
import dataclasses
import json
import re
from pathlib import Path

import pytest

from repro.exp import metrics as r_met
from repro.exp import run as r_run
from repro.exp import scenarios as r_scen
from repro_torch.exp import metrics as t_met
from repro_torch.exp import run as t_run
from repro_torch.exp import scenarios as t_scen

BACKEND = ("wall_s", "use_pallas")


def norm(x):
    """Package-neutral form of a registry value: dataclasses become
    (class name, fields), tuples lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: norm(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def as_json(art):
    """The artifact as the CLI writes it (int keys become strings)."""
    return json.loads(json.dumps(art, sort_keys=True))


def assert_same_artifact(got, want, skip=BACKEND):
    got, want = as_json(got), as_json(want)
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in skip:
            assert got[k] == want[k], k


def test_scenario_registries_equal():
    assert list(t_scen.SCENARIOS) == list(r_scen.SCENARIOS)
    assert list(t_scen.ONLINE_SCENARIOS) == list(r_scen.ONLINE_SCENARIOS)
    for name in list(r_scen.SCENARIOS) + list(r_scen.ONLINE_SCENARIOS):
        got, want = t_scen.get_scenario(name), r_scen.get_scenario(name)
        assert norm(got) == norm(want), name
        assert (got.n_cells, got.n_workload_cells, got.n_workflows) == \
            (want.n_cells, want.n_workload_cells, want.n_workflows)
    for name in r_scen.SCENARIOS:
        got = [(norm(c), c.workload_seed)
               for c in t_scen.SCENARIOS[name].workload_cells()]
        want = [(norm(c), c.workload_seed)
                for c in r_scen.SCENARIOS[name].workload_cells()]
        assert got == want, name
    assert norm(t_scen.POLICY_BY_NAME) == norm(r_scen.POLICY_BY_NAME)
    assert t_scen.PAPER_BUDGET_INTERVALS == r_scen.PAPER_BUDGET_INTERVALS
    assert t_scen.PAPER_APPS == r_scen.PAPER_APPS
    with pytest.raises(SystemExit, match="unknown grid"):
        t_scen.get_scenario("no-such-grid")


def _chaos_cell(pkg_engine, pkg_types, pkg_scen, **kw):
    """Two policies over online-chaos-smoke's seed-0 stream, with trace
    rows, events and the live monitor on."""
    cfg = pkg_types.PlatformConfig()
    scen = pkg_scen.get_scenario("online-chaos-smoke")
    tw = scen.mix.build(cfg, 0)
    ideal = tw.ideal_ms(cfg)
    members, pre = [], []
    for name in ("EBPSM", "MSLBL_MW"):
        pol = pkg_scen.POLICY_BY_NAME[name]
        proto, spares = pkg_engine.predistribute_workload(
            cfg, tw.workflows, pol.budget_mode)
        members.append((pol, pkg_types.clone_workload(proto), 0))
        pre.append(spares)
    eng = pkg_engine.BatchSimEngine(
        cfg, members, trace=True, predistributed=pre, events=True,
        chaos=scen.chaos, monitor=True,
        monitor_maps=(tw.tenant_of, tw.qos_of, ideal), **kw)
    results = eng.run()
    return tw, ideal, int(scen.warmup_s * 1000), results, eng.states


def _metrics(met, tw, ideal, warmup, results, states, online):
    out = []
    for name, res, st in zip(("EBPSM", "MSLBL_MW"), results, states):
        kw = dict(tenant_of=tw.tenant_of, qos_of=tw.qos_of, ideal_ms=ideal,
                  warmup_ms=warmup) if online else {}
        out.append(met.CellMetrics.from_result(
            name, res, st.trace_rows, monitor=st.monitor, **kw))
    return out


@pytest.mark.parametrize("online", [False, True], ids=["closed", "online"])
def test_cell_metrics_from_result_equal(online):
    import repro.core.jax_engine as r_eng
    import repro.core.types as r_types
    import repro_torch.core.batch_engine as t_eng
    import repro_torch.core.types as t_types
    ref = _chaos_cell(r_eng, r_types, r_scen)
    port = _chaos_cell(t_eng, t_types, t_scen, device="cpu")
    want = _metrics(r_met, *ref, online)
    # The same SimResult (the reference engine's) through both packages.
    same = _metrics(t_met, *ref, online)
    # Each package's own engine run of the same cell.
    own = _metrics(t_met, *port, online)
    for w, s, o in zip(want, same, own):
        assert s.to_dict() == w.to_dict()
        assert o.to_dict() == w.to_dict()
        assert t_met.format_row(o) == r_met.format_row(w)
        assert t_met.CellMetrics.from_dict(o.to_dict()).to_dict() == \
            o.to_dict()
        assert o.locality_hit_rate == w.locality_hit_rate
    assert t_met.aggregate_by_policy(own) == r_met.aggregate_by_policy(want)
    if online:
        assert own[0].by_tenant and own[0].alerts_total > 0


@pytest.fixture(scope="module")
def paper_smoke():
    """The port's ``paper-smoke`` artifact on the CPU, with events and the
    live monitor on (as ``--trace-dir`` and ``--report-dir`` turn them
    on in the CLI runs it is held against)."""
    return t_run.run_grid(t_scen.get_scenario("paper-smoke"), device="cpu",
                          events=True, monitor=True)


def _cli(tmp, pkg_main, extra=()):
    out = Path(tmp)
    pkg_main(["--grid", "paper-smoke", "--out", str(out),
              "--trace-dir", str(out / "traces"),
              "--report-dir", str(out / "reports"), *extra])
    return out


@pytest.fixture(scope="module")
def ref_cli(tmp_path_factory):
    return _cli(tmp_path_factory.mktemp("ref"), r_run.main)


@pytest.fixture(scope="module")
def port_cli(tmp_path_factory):
    return _cli(tmp_path_factory.mktemp("port"), t_run.main,
                ("--device", "cpu"))


def test_run_grid_paper_smoke_matches_reference(paper_smoke, ref_cli):
    want = json.loads((ref_cli / t_run.ARTIFACT_NAME).read_text())
    assert_same_artifact(paper_smoke, want)
    assert paper_smoke["use_pallas"] == "cpu"
    assert paper_smoke["dispatch"]["rounds"] > 0
    assert len(paper_smoke["cells"]) == 40


@pytest.mark.parametrize("obs", [False, True], ids=["plain", "monitored"])
@pytest.mark.parametrize("name", ["online-smoke", "online-chaos-smoke"])
def test_run_online_matches_reference(name, obs):
    kw = dict(events=True, monitor=True) if obs else {}
    want = r_run.run_online(r_scen.get_scenario(name), **kw)
    got = t_run.run_online(t_scen.get_scenario(name), device="cpu", **kw)
    assert_same_artifact(got, want)
    assert got["use_pallas"] == "cpu"
    assert got["dispatch"]["monitor"]["enabled"] == obs


def test_workers_match_serial():
    """A spawn pool of two workers equals the serial run, and both equal
    the reference; with one cell per batch the chunking coincides, so
    ``dispatch`` (events and monitor blocks included) matches too."""
    def two(pkg):
        return pkg.Scenario(
            name="unit-two-cells", description="two-cell workers grid",
            apps=("montage", "sipht"), rates=(6.0,),
            budget_intervals=((0.5, 1.0),), policies=("EBPSM", "MSLBL_MW"),
            seeds=(0,), n_workflows=3, sizes=("small",))
    kw = dict(cells_per_batch=1, events=True, monitor=True)
    serial = t_run.run_grid(two(t_scen), device="cpu", **kw)
    par = t_run.run_grid(two(t_scen), device="cpu", workers=2, **kw)
    want = r_run.run_grid(two(r_scen), **kw)
    assert par["workers"] == 2
    assert_same_artifact(par, serial, skip=BACKEND + ("workers",))
    assert_same_artifact(serial, want)
    mon = par["dispatch"]["monitor"]
    assert mon["enabled"] and mon["members"] == 4


def _broken(art):
    """Variants of an artifact that each trip one gate of check_floors."""
    out = []
    bad = json.loads(json.dumps(art))
    for row in bad["cells"]:
        if row["policy"] == "EBPSM":
            row["budget_met"] = 0.0
    out.append(bad)
    worse = json.loads(json.dumps(art))
    worse["ebpsm_vs_mslbl_makespan_ratio"] = 1.2
    out.append(worse)
    slow = json.loads(json.dumps(art))
    slow["p95_slowdown_ceiling"] = 1.5
    slow["wasted_spend_ceiling"] = 0.01
    for row in slow["cells"]:
        row["p95_slowdown"] = 9.0
        row["wasted_spend_frac"] = 0.5
    out.append(slow)
    empty = json.loads(json.dumps(art))
    for row in empty["cells"]:
        row["n_workflows"] = 0
        row["n_warmup_excluded"] = 10
    out.append(empty)
    floors = json.loads(json.dumps(art))
    floors["alert_floors"] = {"budget_burn": 1}
    out.append(floors)
    quiet = json.loads(json.dumps(art))
    quiet["alert_floors"] = {"budget_burn": 10 ** 6}
    quiet["dispatch"]["monitor"] = {"enabled": True,
                                    "alerts_by_kind": {"budget_burn": 3}}
    out.append(quiet)
    return out


def test_check_floors_same_failures(paper_smoke):
    assert t_run.check_floors(paper_smoke) == [] == \
        r_run.check_floors(paper_smoke)
    for art in _broken(paper_smoke):
        want = r_run.check_floors(art)
        assert want
        assert t_run.check_floors(art) == want


def test_cli_matches_reference(ref_cli, port_cli):
    got = json.loads((port_cli / t_run.ARTIFACT_NAME).read_text())
    want = json.loads((ref_cli / t_run.ARTIFACT_NAME).read_text())
    assert_same_artifact(got, want)
    assert got["use_pallas"] == "cpu"

    def no_wall(p):
        return re.sub(r"wall [0-9.]+s", "wall", p.read_text())
    assert no_wall(port_cli / t_run.REPORT_NAME) == \
        no_wall(ref_cli / t_run.REPORT_NAME)


def test_cli_trace_and_report_files_identical(ref_cli, port_cli):
    for sub in ("traces", "reports"):
        names = sorted(p.name for p in (ref_cli / sub).iterdir())
        assert names and sorted(
            p.name for p in (port_cli / sub).iterdir()) == names
        for n in names:
            assert (port_cli / sub / n).read_bytes() == \
                (ref_cli / sub / n).read_bytes(), n


def test_write_report_equal(paper_smoke, tmp_path):
    r_run.write_report(paper_smoke, str(tmp_path / "r.md"))
    t_run.write_report(paper_smoke, str(tmp_path / "t.md"))
    assert (tmp_path / "t.md").read_bytes() == (tmp_path / "r.md").read_bytes()


def test_merge_stats_equal(paper_smoke):
    parts = [paper_smoke["dispatch"], dict(paper_smoke["dispatch"])]
    assert t_run._merge_stats(parts) == r_run._merge_stats(parts)
    assert t_run._merge_stats([]) == r_run._merge_stats([])


def test_cli_rejects_closed_grid_checkpoint_flags(tmp_path):
    with pytest.raises(SystemExit, match="online-grid flags"):
        t_run.main(["--grid", "paper-smoke", "--device", "cpu",
                    "--out", str(tmp_path), "--resume"])
