"""repro_torch.obs.export / report ≡ repro.obs.export / report.

* ``chrome_trace``, ``events_jsonl``, ``monitor_payload``,
  ``monitor_json`` and ``dashboard_html`` give byte-identical output to
  the reference's for the same cell: each package's exporter over its
  own engine's event log and monitor, and the port's exporter over the
  reference's log and monitor;
* ``write_cell_trace`` and ``write_cell_report`` write identical files;
* ``tools/check_trace.py`` and ``tools/check_report.py``, run as
  subprocesses, pass on the port's ``--trace-dir`` and ``--report-dir``
  output (grid and stream), and fail on a corrupted file.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core.jax_engine as r_eng
import repro.core.types as r_types
import repro.exp.scenarios as r_scen
import repro.obs as r_obs
import repro_torch.core.batch_engine as t_eng
import repro_torch.core.types as t_types
import repro_torch.exp.scenarios as t_scen
import repro_torch.obs as t_obs
from repro_torch.exp import run as t_run

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("EBPSM", "MSLBL_MW")


def chaos_cell(eng_mod, types, scen_mod, **kw):
    """online-chaos-smoke's seed-0 stream under two policies, events and
    the live monitor on; returns (states, tenant_of, qos_of, vm names)."""
    cfg = types.PlatformConfig()
    scen = scen_mod.get_scenario("online-chaos-smoke")
    tw = scen.mix.build(cfg, 0)
    members, pre = [], []
    for name in POLICIES:
        pol = scen_mod.POLICY_BY_NAME[name]
        proto, spares = eng_mod.predistribute_workload(cfg, tw.workflows,
                                                       pol.budget_mode)
        members.append((pol, types.clone_workload(proto), 0))
        pre.append(spares)
    eng = eng_mod.BatchSimEngine(
        cfg, members, predistributed=pre, events=True, chaos=scen.chaos,
        monitor=True, monitor_maps=(tw.tenant_of, tw.qos_of,
                                    tw.ideal_ms(cfg)), **kw)
    eng.run()
    return (eng.states, tw.tenant_of, tw.qos_of,
            [t.name for t in cfg.vm_types])


@pytest.fixture(scope="module")
def cells():
    return (chaos_cell(r_eng, r_types, r_scen),
            chaos_cell(t_eng, t_types, t_scen, device="cpu"))


def trace_bytes(obs, log, maps, vm_names, label):
    kw = dict(tenant_of=maps[0], qos_of=maps[1]) if maps else {}
    trace = obs.export._dumps(obs.chrome_trace(
        log, label=label, vm_type_names=vm_names, **kw))
    return trace, obs.events_jsonl(log, label=label)


@pytest.mark.parametrize("maps", [True, False], ids=["tenants", "by-wid"])
def test_chrome_trace_and_jsonl_identical(cells, maps):
    (r_states, *r_rest), (t_states, *t_rest) = cells
    for i, (rs, ts) in enumerate(zip(r_states, t_states)):
        label = f"cell{i}"
        want = trace_bytes(r_obs, rs.elog, maps and r_rest[:2], r_rest[2],
                           label)
        assert len(rs.elog) > 0 and want[0].startswith("{")
        assert trace_bytes(t_obs, ts.elog, maps and t_rest[:2], t_rest[2],
                           label) == want
        # The same log through the port's exporter.
        assert trace_bytes(t_obs, rs.elog, maps and r_rest[:2], r_rest[2],
                           label) == want
    assert t_obs.export.TRACE_SCHEMA == r_obs.export.TRACE_SCHEMA
    assert t_obs.export.EVENTS_SCHEMA == r_obs.export.EVENTS_SCHEMA


def test_monitor_json_and_dashboard_identical(cells):
    (r_states, *_), (t_states, *_) = cells
    assert t_obs.MONITOR_SCHEMA == r_obs.MONITOR_SCHEMA
    assert t_obs.MONITOR_SCHEMA_VERSION == r_obs.MONITOR_SCHEMA_VERSION
    for i, (rs, ts) in enumerate(zip(r_states, t_states)):
        label = f"cell{i}"
        want = (r_obs.monitor_payload(rs.monitor, label),
                r_obs.monitor_json(rs.monitor, label),
                r_obs.dashboard_html(rs.monitor, label))
        assert want[0]["alerts"] and "<svg" in want[2]
        for mon in (ts.monitor, rs.monitor):
            assert (t_obs.monitor_payload(mon, label),
                    t_obs.monitor_json(mon, label),
                    t_obs.dashboard_html(mon, label)) == want


def test_written_files_identical(cells, tmp_path):
    (r_states, r_ten, r_qos, names), (t_states, t_ten, t_qos, _) = cells
    for i, (rs, ts) in enumerate(zip(r_states, t_states)):
        label = f"online-chaos-smoke__seed0__{POLICIES[i]}"
        r_obs.write_cell_trace(str(tmp_path / "r"), label, rs.elog,
                               vm_type_names=names, tenant_of=r_ten,
                               qos_of=r_qos)
        t_obs.write_cell_trace(str(tmp_path / "t"), label, ts.elog,
                               vm_type_names=names, tenant_of=t_ten,
                               qos_of=t_qos)
        r_obs.write_cell_report(str(tmp_path / "r"), label, rs.monitor)
        t_obs.write_cell_report(str(tmp_path / "t"), label, ts.monitor)
    want = {p.name: p.read_bytes() for p in (tmp_path / "r").iterdir()}
    got = {p.name: p.read_bytes() for p in (tmp_path / "t").iterdir()}
    assert len(want) == 4 * len(POLICIES) and got == want


def check(tool, *args):
    return subprocess.run([sys.executable, str(ROOT / "tools" / tool),
                           *map(str, args)], capture_output=True, text=True,
                          timeout=120)


def test_validators_pass_on_port_output(tmp_path):
    scen = dataclasses.replace(t_scen.get_scenario("online-chaos-smoke"),
                               policies=("EBPSM",))
    t_run.run_online(scen, device="cpu", trace_dir=tmp_path / "st",
                     report_dir=tmp_path / "sr")
    grid = dataclasses.replace(t_scen.get_scenario("paper-smoke"),
                               apps=("montage",), rates=(6.0,),
                               budget_intervals=((0.5, 1.0),))
    t_run.run_grid(grid, device="cpu", trace_dir=str(tmp_path / "gt"),
                   report_dir=str(tmp_path / "gr"))
    proc = check("check_trace.py", tmp_path / "st", tmp_path / "gt")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = check("check_report.py", tmp_path / "sr",
                 "--require-alert", "budget_burn",
                 "--require-alert", "straggler_spike")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = check("check_report.py", tmp_path / "gr")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # Corrupted files fail them.
    (tmp_path / "gr" / "bad.monitor.json").write_text('{"schema": "nope"}')
    assert check("check_report.py", tmp_path / "gr").returncode == 1
    (tmp_path / "gt" / "bad.trace.json").write_text('{"traceEvents": []}')
    assert check("check_trace.py", tmp_path / "gt").returncode == 1
