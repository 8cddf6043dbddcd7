"""repro_torch.ckpt (the stream half) ≡ repro.ckpt on disk.

* ``save_stream`` / ``restore_stream`` round-trip arrays, residue, meta
  and member count; ``latest_step`` and ``prune`` see the same steps;
  params directories and newer schemas are refused;
* the two packages write byte-identical snapshot directories from the
  same snapshot, and each restores the directory the other wrote (the
  port's ``BatchSimEngine`` snapshot, mid-stream);
* an interrupted-then-resumed ``online-chaos-smoke`` (``run_online`` and
  the CLI, exit code 3 at the interrupt) equals the uninterrupted run:
  artifact rows, dispatch and every trace and report file;
* a stream one package's CLI interrupted finishes under the other's
  ``--resume`` to the reader's uninterrupted run.  The engine residue
  pickles the writer's classes: the port loads the reference's
  ``repro.*`` names as its own copies, with jax blocked, and refuses a
  name it has no copy of; the reference resuming the port's snapshot
  imports ``repro_torch``.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import ckpt as r_ckpt
from repro.exp import run as r_run
from repro_torch import ckpt as t_ckpt
from repro_torch.core.batch_engine import BatchSimEngine, StreamInterrupted
from repro_torch.core.engine import load_residue
from repro_torch.core.scheduler import EBPSM, MSLBL_MW
from repro_torch.core.types import PlatformConfig
from repro_torch.exp import run as t_run
from repro_torch.exp.scenarios import get_scenario
from repro_torch.workflows.workload import WorkloadSpec, generate_workload

CFG = PlatformConfig()
ROOT = Path(__file__).resolve().parents[1]


def synthetic_snap(version=2):
    return {
        "arrays": {
            "m0000.spare": np.array([1.5, 0.25], dtype=np.float64),
            "m0000.remaining": np.array([3, 0], dtype=np.int64),
            "m0000.arrived": np.array([True, False]),
            "grid/rounds": np.arange(6, dtype=np.int32).reshape(2, 3),
        },
        "residue": b"\x00opaque-bytes\xff",
        "version": version,
        "n_members": 1,
    }


def engine():
    members = [(pol, generate_workload(CFG, WorkloadSpec(
        n_workflows=5, arrival_rate_per_min=12.0, seed=40 + i,
        sizes=("small",))), i) for i, pol in enumerate((EBPSM, MSLBL_MW))]
    return BatchSimEngine(CFG, members, device="cpu", events=True,
                          monitor=True)


def signatures(results):
    return [[(w.wid, w.finish_ms, w.cost) for w in r.workflows]
            for r in results]


def engine_snap(cut_round=3):
    """A port ``BatchSimEngine`` snapshot taken at a rendezvous round."""
    eng = engine()
    cut = {}

    def hook(e):
        if e.rounds >= cut_round:
            cut["snap"] = e.snapshot()
            return True
        return False

    with pytest.raises(StreamInterrupted):
        eng.run(ckpt_hook=hook)
    return cut["snap"]


def assert_same_snap(got, want):
    assert got["residue"] == want["residue"]
    assert got["version"] == want["version"]
    assert got.get("n_members") == want.get("n_members")
    assert sorted(got["arrays"]) == sorted(want["arrays"])
    for name, arr in want["arrays"].items():
        g = got["arrays"][name]
        arr = np.asarray(arr)
        assert g.dtype == arr.dtype and np.array_equal(g, arr), name


def test_save_restore_stream_roundtrip(tmp_path):
    snap = synthetic_snap()
    meta = {"scenario": "x", "rows": [{"a": 0.125}], "seed_index": 1}
    path = t_ckpt.save_stream(str(tmp_path), 4, snap, meta=meta)
    assert path == os.path.join(str(tmp_path), "step_00000004")
    assert t_ckpt.latest_step(str(tmp_path)) == 4
    back, step, meta2 = t_ckpt.restore_stream(str(tmp_path))
    assert step == 4 and meta2 == meta
    assert_same_snap(back, snap)
    # No staging directory is left behind.
    assert sorted(os.listdir(tmp_path)) == ["step_00000004"]


def test_latest_step_and_prune(tmp_path):
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None
    for s in (0, 3, 1, 7, 5):
        t_ckpt.save_stream(str(tmp_path), s, synthetic_snap())
    assert t_ckpt.latest_step(str(tmp_path)) == 7
    t_ckpt.prune(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000007"]
    back, step, _ = t_ckpt.restore_stream(str(tmp_path), step=5)
    assert step == 5
    assert_same_snap(back, synthetic_snap())
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore_stream(str(tmp_path / "empty"))


def test_restore_stream_refuses_params_dir(tmp_path):
    r_ckpt.save(str(tmp_path), 1, {"w": np.ones(3)})
    with pytest.raises(ValueError, match="params"):
        t_ckpt.restore_stream(str(tmp_path))


def test_restore_stream_refuses_newer_schema(tmp_path):
    assert t_ckpt.STREAM_SCHEMA_VERSION == r_ckpt.STREAM_SCHEMA_VERSION
    t_ckpt.save_stream(str(tmp_path), 1, synthetic_snap(
        t_ckpt.STREAM_SCHEMA_VERSION + 1))
    with pytest.raises(ValueError, match="newer"):
        t_ckpt.restore_stream(str(tmp_path))


def _files(d):
    return {p.name: p.read_bytes() for p in Path(d).iterdir()}


@pytest.mark.parametrize("which", ["synthetic", "engine"])
def test_both_packages_write_identical_directories(tmp_path, which):
    snap = synthetic_snap() if which == "synthetic" else engine_snap()
    meta = {"scenario": "online-chaos-smoke", "rows": [], "stats": []}
    r = r_ckpt.save_stream(str(tmp_path / "r"), 2, snap, meta=meta)
    t = t_ckpt.save_stream(str(tmp_path / "t"), 2, snap, meta=meta)
    assert _files(t) == _files(r)
    assert json.loads(Path(t, "manifest.json").read_text())["kind"] == \
        "stream"


@pytest.mark.parametrize("writer,reader", [(r_ckpt, t_ckpt), (t_ckpt, r_ckpt)],
                         ids=["reference-to-port", "port-to-reference"])
def test_snapshot_restores_across_packages(tmp_path, writer, reader):
    snap = engine_snap()
    meta = {"scenario": "s", "seed_index": 0, "rows": [{"policy": "EBPSM"}]}
    writer.save_stream(str(tmp_path), 9, snap, meta=meta)
    back, step, meta2 = reader.restore_stream(str(tmp_path))
    assert step == 9 and meta2 == meta
    assert_same_snap(back, snap)
    # The engine resumes from what was read back, to the uninterrupted
    # result.
    eng = engine()
    eng.load_snapshot(back)
    assert signatures(eng.run()) == signatures(engine().run())


def test_online_chaos_smoke_interrupt_resume_identical(tmp_path):
    scen = get_scenario("online-chaos-smoke")
    out = {k: (str(tmp_path / k / "t"), str(tmp_path / k / "r"))
           for k in ("full", "cut")}
    want = t_run.run_online(scen, device="cpu", trace_dir=out["full"][0],
                            report_dir=out["full"][1])
    ck = str(tmp_path / "ck")
    with pytest.raises(StreamInterrupted):
        t_run.run_online(scen, device="cpu", ckpt_dir=ck, ckpt_every_s=0.0,
                         stop_after_ckpts=2, trace_dir=out["cut"][0],
                         report_dir=out["cut"][1])
    assert t_ckpt.latest_step(ck) == 1
    got = t_run.run_online(scen, device="cpu", ckpt_dir=ck, resume=True,
                           trace_dir=out["cut"][0], report_dir=out["cut"][1])
    for k in want:
        if k != "wall_s":
            assert got[k] == want[k], k
    for a, b in zip(out["full"], out["cut"]):
        assert _files(b) == _files(a)


def test_cli_interrupt_exits_3_and_resume_matches(tmp_path):
    ck, full, cut = (str(tmp_path / k) for k in ("ck", "full", "cut"))
    base = ["--grid", "online-chaos-smoke", "--device", "cpu"]
    t_run.main(base + ["--out", full])
    with pytest.raises(SystemExit) as exc:
        t_run.main(base + ["--out", cut, "--ckpt-dir", ck,
                           "--ckpt-every-s", "0", "--stop-after-ckpts", "2"])
    assert exc.value.code == 3
    assert not os.path.exists(os.path.join(cut, t_run.ARTIFACT_NAME))
    t_run.main(base + ["--out", cut, "--ckpt-dir", ck, "--resume"])
    want = json.loads(Path(full, t_run.ARTIFACT_NAME).read_text())
    got = json.loads(Path(cut, t_run.ARTIFACT_NAME).read_text())
    want.pop("wall_s")
    got.pop("wall_s")
    assert got == want
    with pytest.raises(SystemExit, match="scenario"):
        t_run.main(["--grid", "online-smoke", "--device", "cpu",
                    "--out", cut, "--ckpt-dir", ck, "--resume"])


# The port's CLI in a child that blocks jax; prints the reference and jax
# modules it loaded.
RESUME_CHILD = r"""
import sys
sys.modules["jax"] = None
from repro_torch.exp.run import main
main(sys.argv[1:])
print("LOADED", sorted(m for m in sys.modules
                       if m == "repro" or m.startswith("repro.")
                       or m == "jax" or m.startswith(("jax.", "jaxlib"))))
"""


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cli_resume_across_packages(tmp_path, writer):
    ck = str(tmp_path / "ck")
    port = ["--device", "cpu"]

    def args(out, *extra):
        d = tmp_path / out
        return ["--grid", "online-chaos-smoke", "--out", str(d),
                "--trace-dir", str(d / "t"), "--report-dir", str(d / "r"),
                *extra]

    cut = args("cut", "--ckpt-dir", ck, "--ckpt-every-s", "0",
               "--stop-after-ckpts", "2")
    with pytest.raises(SystemExit) as exc:
        if writer == "reference":
            r_run.main(cut)
        else:
            t_run.main(cut + port)
    assert exc.value.code == 3
    resume = args("cut", "--ckpt-dir", ck, "--resume")
    if writer == "reference":
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run([sys.executable, "-c", RESUME_CHILD, *resume,
                               *port], env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.strip().splitlines()[-1] == "LOADED ['jax']"
        t_run.main(args("full") + port)
    else:
        r_run.main(resume)
        r_run.main(args("full"))
    got, want = (json.loads((tmp_path / d / t_run.ARTIFACT_NAME).read_text())
                 for d in ("cut", "full"))
    got.pop("wall_s")
    want.pop("wall_s")
    assert got == want
    for sub in ("t", "r"):
        want_files = _files(tmp_path / "full" / sub)
        assert len(want_files) == 10
        assert _files(tmp_path / "cut" / sub) == want_files


def test_residue_naming_a_class_the_port_lacks_is_refused():
    # A protocol-0 pickle of the class repro.no_such_module.Thing.
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        load_residue(b"crepro.no_such_module\nThing\n.")
    assert load_residue(pickle.dumps({"a": [1, 2.5]})) == {"a": [1, 2.5]}
