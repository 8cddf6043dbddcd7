"""repro_torch's dry run (``launch/dryrun.py``) against the reference's,
on the CPU.

The traces run in processes of their own (a fake process group is
process-wide), all started together by the module fixture ``runs``:
two ``_torch_dryrun_worker.py`` jobs (which import no JAX), the port's
CLI on the smoke configs, and the reference's CLI on one serve cell at
full width (``python -m repro.launch.dryrun``, which sets its own
placeholder device count).  The tests then hold

* the cells, their skip reasons, and the artifact's schema, kind, mesh,
  mesh tag and parameter counts against the reference's;
* internvl2-1b × decode_32k at full width on the (16, 16) mesh: the
  argument bytes equal the reference's but for the one leaf the decode
  step does not read (the vision projection, which the reference's
  compiled program drops); the flops, bytes and collectives are printed
  beside the reference's (``-s``), with no bar: XLA's counts are of a
  fused program (module docstring of ``launch/dryrun.py``);
* on an (8, 1) mesh, each device's flops equal the one-device count at
  the local batch exactly (llama3-8b and mamba2-780m smoke, train step
  and prefill); on a (1, 8) mesh they lie between a whole step's over 8
  and a whole step's; a DTensor matmul counts only the local product,
  also on its first call; on a one-rank mesh the count equals
  ``FlopCounterMode``'s of the same step run for real;
* the expert-parallel all-to-alls of the MoE step are counted;
* the CLI (``--all`` on the smoke configs and a (2, 2) mesh) writes
  artifacts that ``roofline.table`` and ``waas.mljobs.StageCostModel``
  read, and without a card refuses to trace unless asked for the CPU.

In-process, the kernels' operators run on fake CPU tensors: their fakes'
shapes and dtypes, and their flop formulas at ``PERF.md``'s figures, in
``FlopCounterMode`` and in the dry run's ``Count`` alike.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import cells as ref_cells
from repro.models import build as jbuild
from repro_torch.configs.registry import ARCH_IDS, cells
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import dryrun, roofline
from repro_torch.models import build
from repro_torch.waas import mljobs

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_dryrun_worker.py")
REF_CELL = ("internvl2-1b", "decode_32k")
# Argument leaves the reference's compiled decode step does not hold:
# jax drops arguments the program does not read, and decode reads no
# image patches.
UNREAD_BY_DECODE = {"/arg0/patch_proj"}
CLI_SHAPES = ("decode_32k", "long_500k")   # the fast cells, skips among them
TIMEOUT_S = 600


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the module, started together; their outputs
    (JSON results, artifact directories, exit codes and logs)."""
    d = tmp_path_factory.mktemp("dryrun")
    procs = {}

    def start(name, cmd):
        procs[name] = subprocess.Popen(
            cmd, cwd=d, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for job in ("data", "model"):
        start(job, [sys.executable, str(WORKER), job, str(d / f"{job}.json")])
    for shape in CLI_SHAPES:
        start(f"cli/{shape}", [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
            "--shape", shape, "--smoke", "--device", "cpu", "--out",
            str(d / "cli")])
    start("ref", [sys.executable, "-m", "repro.launch.dryrun", "--arch",
                  REF_CELL[0], "--shape", REF_CELL[1], "--out",
                  str(d / "ref")])
    start("no-card", [sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", "llama3-8b", "--shape", "decode_32k", "--out",
                      str(d / "no-card")])
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate(timeout=TIMEOUT_S)
        out[name] = (p.returncode, log)
    for job in ("data", "model"):
        rc, log = out[job]
        assert rc == 0, f"{job} job failed:\n{log[-4000:]}"
        out[job] = json.loads((d / f"{job}.json").read_text())
    out["dir"] = d
    return out


# ---------------------------------------------------------------------------
# Cells and schema
# ---------------------------------------------------------------------------


def test_cells_and_skip_reasons_equal_reference():
    got = [(a, s.name, r) for a, s, r in cells()]
    want = [(a, s.name, r) for a, s, r in ref_cells()]
    assert got == want
    assert sum(r is None for *_, r in got) == 31
    assert sum(r is not None for *_, r in got) == 9


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_counts_equal_reference(arch):
    m, jm = build(arch, device="cpu"), jbuild(arch)
    assert (m.n_params(), m.n_active_params()) == (jm.n_params(),
                                                   jm.n_active_params())


def _ref_artifact(runs):
    rc, log = runs["ref"]
    assert rc == 0, log[-4000:]
    path = runs["dir"] / "ref" / "singlepod__{}__{}.json".format(*REF_CELL)
    return json.loads(path.read_text())


def test_serve_cell_schema_equals_reference(runs):
    got, ref = runs["model"]["internvl2-1b/decode_32k"], _ref_artifact(runs)
    # the port counts at full depth (no probe) and records its device
    assert set(got) == (set(ref) - {"probe_layers"}) | {"device"}
    for key in ("arch", "shape", "kind", "mesh", "mesh_tag", "n_params",
                "n_active_params"):
        assert got[key] == ref[key], key
    assert set(got["memory"]) == set(ref["memory"])
    assert set(got["collectives"]) == set(ref["collectives"])
    assert got["compile_s"] == 0 and got["device"] == "cpu"
    assert got["memory"]["generated_code_bytes"] == 0


def test_serve_cell_argument_bytes_equal_reference(runs):
    got, ref = runs["model"]["internvl2-1b/decode_32k"], _ref_artifact(runs)
    leaves = runs["model"]["leaf_bytes"]
    assert sum(leaves.values()) == got["memory"]["argument_bytes"]
    unread = sum(leaves[k] for k in UNREAD_BY_DECODE)
    assert got["memory"]["argument_bytes"] - unread == \
        ref["memory"]["argument_bytes"]
    print("\n[dryrun] internvl2-1b x decode_32k, port (cpu) | reference:")
    for key in ("flops_per_device", "bytes_accessed_per_device",
                "collective_bytes_per_device"):
        print(f"  {key}: {got[key]:.6g} | {ref[key]:.6g}")
    for key in ("output_bytes", "temp_bytes"):
        print(f"  {key}: {got['memory'][key]} | {ref['memory'][key]}")
    for op in dryrun.COLLECTIVE_OPS:
        g, r = got["collectives"][op], ref["collectives"][op]
        print(f"  {op}: {g['count']} x, {g['bytes']:.6g} B | "
              f"{r['count']} x, {r['bytes']:.6g} B")


# ---------------------------------------------------------------------------
# Counting on the local shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_data_parallel_flops_equal_the_local_batch_count(runs, arch, shape):
    r = runs["data"][f"{arch}/{shape}"]
    assert r["mesh"]["flops"] > 0
    assert r["mesh"]["flops"] == r["one"]["flops"]


def test_data_parallel_train_step_reduces_gradients(runs):
    c = runs["data"]["llama3-8b/train_4k"]["mesh"]["collectives"]
    assert c["all-reduce"]["count"] + c["reduce-scatter"]["count"] > 0


def test_tensor_parallel_flops_lie_between_a_share_and_the_whole(runs):
    r = runs["model"]["llama3-8b/train_4k"]
    whole = r["global"]["flops"]
    assert whole / 8 < r["mesh"]["flops"] < whole
    assert r["mesh"]["coll_bytes"] > 0


def test_one_rank_count_equals_flop_counter_of_the_real_step(runs):
    r = runs["data"]["one_rank"]
    assert r["dry"] == r["real"] > 0


def test_dtensor_matmul_counts_its_local_product_only(runs):
    m = runs["data"]["matmul"]
    assert m["out_local"] == [32, 128]
    assert m["flops"] == [m["local"], m["local"]]


def test_moe_expert_parallel_all_to_all_is_counted(runs):
    r = runs["model"]
    assert r["expert_parallel_calls"] > 0
    a2a = r["qwen2-moe-a2.7b/train_4k"]["collectives"]["all-to-all"]
    assert a2a["count"] > 0 and a2a["bytes"] > 0


def test_memory_counts_arguments_and_temporaries(runs):
    r = runs["data"]["llama3-8b/train_4k"]
    mem, one = r["mesh"]["memory"], r["one"]["memory"]
    # parameters and moments are replicated over data: equal on one device
    # and on the mesh, batch aside; the step's own allocations are the
    # local batch's
    assert mem["temp_bytes"] > mem["argument_bytes"] > 0
    assert abs(mem["temp_bytes"] - one["temp_bytes"]) < 0.05 * \
        one["temp_bytes"]
    assert mem["output_bytes"] > 0


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_artifacts_feed_roofline_and_waas(runs):
    for shape in CLI_SHAPES:
        rc, log = runs[f"cli/{shape}"]
        assert rc == 0, log[-4000:]
    art = runs["dir"] / "cli"
    names = sorted(p.name for p in art.glob("singlepod__*.json"))
    want = sorted(f"singlepod__{a}__{s.name}.json" for a, s, _ in cells()
                  if s.name in CLI_SHAPES)
    assert names == want
    arts = roofline.load_artifacts(str(art))
    skipped = [a for a in arts if "skipped" in a]
    assert len(skipped) == sum(1 for _, s, r in cells()
                               if s.name in CLI_SHAPES and r)
    table = roofline.table(str(art))
    assert len(table.splitlines()) == 2 + len(arts)
    for a in arts:
        if "skipped" not in a:
            assert a["device"] == "cpu" and a["mesh"]["n_devices"] == 4
            assert roofline.analyze(a)["live_gib"] >= 0
    measured = mljobs.StageCostModel(str(art)).measured
    runnable = {(a, s.name) for a, s, r in cells()
                if s.name in CLI_SHAPES and r is None}
    assert set(measured) == runnable
    assert all(v > 0 for v in measured.values())


def test_cli_refuses_to_trace_without_a_card(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, log = runs["no-card"]
    assert rc == 1 and "no CUDA device is available" in log


def test_lower_cell_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.lower_cell("llama3-8b", "decode_32k", False)


def test_dryrun_imports_no_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.launch.dryrun\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


# ---------------------------------------------------------------------------
# The kernels' operators on fake CPU tensors
# ---------------------------------------------------------------------------


def _fa_fake(B, L, H, D, dtype=torch.bfloat16, grad=False):
    return [torch.empty(B, L, H, D, dtype=dtype, requires_grad=grad)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_operators_fakes_and_flops(causal):
    B, L, H, D = 2, 4096, 32, 128
    pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
    with FakeTensorMode():
        q, k, v = _fa_fake(B, L, H, D)
        with FlopCounterMode(display=False) as fc:
            o, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v,
                                                               causal)
            o2 = torch.ops.repro_torch.flash_attention_fwd_nolse(q, k, v,
                                                                 causal)
            dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, o, o, lse, causal)
    assert o.shape == o2.shape == (B, L, H, D) and o.dtype == q.dtype
    assert lse.shape == (B, H, L) and lse.dtype == torch.float32
    assert [t.shape for t in (dq, dk, dv)] == [q.shape] * 3
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert counts == {"repro_torch.flash_attention_fwd": 4 * D * pairs,
                      "repro_torch.flash_attention_fwd_nolse": 4 * D * pairs,
                      "repro_torch.flash_attention_bwd": 10 * D * pairs}


def test_flash_attention_flops_at_the_training_shape():
    """``PERF.md``'s bound for [2, 32, 4096, 128] causal: 0.278003 ms at
    989 TFLOP/s."""
    assert 4 * 128 * fa_ops.attention_pairs(2, 32, 4096, 4096, True) == \
        274_945_015_808
    assert round(274_945_015_808 / 989e12 * 1e3, 6) == 0.278003
    # a causal row i of Lq sees keys up to i + Lk - Lq
    assert fa_ops.attention_pairs(1, 1, 2, 5, True) == 4 + 5


def test_flash_attention_autograd_through_the_operators_on_fakes():
    """Forward and backward through the operators (not the CPU's plain
    version), as a dry run on the card traces them: each counted once,
    the same in ``FlopCounterMode`` and in the dry run's ``Count``."""
    B, L, H, D = 1, 256, 4, 64
    pairs = B * H * L * (L + 1) // 2
    with FakeTensorMode():
        q, k, v = _fa_fake(B, L, H, D, grad=True)
        totals = []
        for mode in (FlopCounterMode(display=False), dryrun.Count()):
            with mode:
                o = fa_ops.flash_attention_fwd(q, k, v, True)[0]
                o.sum().backward()
            totals.append(mode.get_total_flops()
                          if isinstance(mode, FlopCounterMode)
                          else mode.flops)
    assert totals == [14 * D * pairs, 14 * D * pairs]
    assert q.grad.shape == q.shape


def _ssd_fake(B, L, H, P, N, dtype=torch.bfloat16):
    return (torch.empty(B, L, H, P, dtype=dtype),
            torch.empty(B, L, H), torch.empty(H),
            torch.empty(B, L, N, dtype=dtype),
            torch.empty(B, L, N, dtype=dtype))


def test_ssd_forward_operator_fake_and_flops():
    B, L, H, P, N, Q = 2, 4096, 48, 64, 128, 64
    nc = L // Q
    with FakeTensorMode():
        x, dt, A, Bm, Cm = _ssd_fake(B, L, H, P, N)
        with FlopCounterMode(display=False) as fc:
            y, final = torch.ops.repro_torch.ssd_fwd(x, dt, A, Bm, Cm, Q,
                                                     None)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert final.shape == (B, H, N, P) and final.dtype == torch.float32
    chunk = B * H * nc * (2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * N * P)
    carry = 2 * N * B * L * H * P
    assert fc.get_total_flops() == chunk + carry == 22_548_578_304


@pytest.mark.parametrize("state", [False, True])
def test_ssd_backward_operator_fake_and_flops(state):
    B, L, H, P, N, Q = 2, 4096, 48, 64, 128, 64
    nc = L // Q
    with FakeTensorMode():
        x, dt, A, Bm, Cm = _ssd_fake(B, L, H, P, N)
        init = torch.empty(B, H, N, P) if state else None
        with FlopCounterMode(display=False) as fc:
            grads = ssd_ops.ssd_bwd(x, dt, A, Bm, Cm, torch.empty_like(x), Q,
                                    init)
    for g, t in zip(grads, (x, dt, A, Bm, Cm, init)):
        if t is None:
            assert g is None
        else:
            assert g.shape == t.shape and g.dtype == t.dtype
    # the chunk pass for the states, the carry backward, the chunk
    # backward; 16 heads a block at this shape on 132 SMs
    from repro_torch.kernels.ssd.kernel import bwd_heads_per_block
    G = bwd_heads_per_block(B * nc, H, ssd_ops.H100_SMS)
    assert G == 16
    per_head = (2 * Q * Q * N + 6 * Q * Q * P + 10 * Q * N * P)
    want = B * nc * (H * per_head + H // G * 6 * Q * Q * N)
    assert fc.get_total_flops() == want == ssd_ops.ssd_bwd_flops(
        B, L, H, P, N, Q)
