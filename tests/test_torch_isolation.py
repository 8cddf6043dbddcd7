"""repro_torch stands alone: no jax, nothing of the reference package.

* A subprocess that blocks ``jax`` (``sys.modules["jax"] = None``)
  imports ``repro_torch.parallel.ctx`` first (the models import it: no
  cycle), then ``repro_torch.core.batch_engine`` and runs a tiny CPU grid,
  then builds the zamba2-1.2b and qwen2-moe-a2.7b smoke models on the
  CPU (the hybrid and the transformer/MoE stacks), prefills a prompt
  through the serve builders and decodes one token with each, and runs
  a small ``repro_torch.waas.platform.sweep``, and imports the
  parallelism modules (``repro_torch.parallel.*``,
  ``repro_torch.launch.mesh`` and ``roofline``) and builds the rule
  tables' placements; afterwards no ``repro.*`` or ``jax*`` module is
  loaded.  A second such subprocess
  imports ``repro_torch.exp.run`` and runs a one-cell ``paper-smoke``
  grid and a checkpointed, resumed stream with trace and report files.
  A third trains: ``batch_at`` batches through ``make_train_step`` on
  the llama3-8b and zamba2-1.2b smoke models under ``FaultyTrainer``
  (checkpoints written and restored), with ``remat="dots"``.
* A source scan of ``src/repro_torch/`` and ``chip_smoke.py`` finds no
  ``import jax`` and no import of ``repro.``.
* Without a CUDA device, the entry points (the experiment harness and
  its CLI included, and ``restore_section``) refuse to run unless the
  caller asks for the CPU.
* On a card, ``ssd`` under grad goes through its operator and the
  backward kernels give the plain version's gradient, and a train step
  on a one-rank NCCL mesh launches flash attention as the unsharded
  step does (``cuda`` marker).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

CHILD = r"""
import sys
sys.modules["jax"] = None
# first, before anything has loaded the models that import it
from repro_torch.parallel.ctx import scope
from repro_torch.core.batch_engine import simulate_batch
from repro_torch.core.scheduler import ALL_POLICIES
from repro_torch.core.types import PlatformConfig
from repro_torch.workflows.workload import WorkloadSpec, generate_workload
cfg = PlatformConfig()
wl = generate_workload(cfg, WorkloadSpec(n_workflows=3, seed=0,
                                         arrival_rate_per_min=12.0,
                                         sizes=("small",)))
grid = simulate_batch(cfg, ALL_POLICIES, wl, seed=0, batched=True,
                      device="cpu")
assert len(grid.entries) == len(ALL_POLICIES)
import torch
from repro_torch.models import build
from repro_torch.serve.serve_step import build_decode_step, build_prefill
m = build("zamba2-1.2b", smoke=True, device="cpu")
params = m.init(0)
toks = torch.randint(0, m.cfg.vocab, (2, 16),
                     generator=torch.Generator().manual_seed(0))
logits, state = build_prefill(m, "prefill_32k", device="cpu",
                              max_seq=24)(params, {"tokens": toks})
logits, state = build_decode_step(m, "decode_32k", device="cpu")(
    params, state, logits.argmax(-1))
assert logits.shape == (2, 1, m.cfg.vocab) and int(state["length"]) == 17
m = build("qwen2-moe-a2.7b", smoke=True, device="cpu")
params = m.init(0)
logits, state = build_prefill(m, "prefill_32k", device="cpu",
                              max_seq=24)(params, {"tokens": toks})
logits, state = build_decode_step(m, "decode_32k", device="cpu")(
    params, state, logits.argmax(-1))
assert logits.shape == (2, 1, m.cfg.vocab) and int(state["length"]) == 17
from repro_torch.waas.platform import sweep
assert len(sweep(n_jobs=4, rates=(2.0,), art_dir="/nonexistent",
                 device="cpu")) == len(ALL_POLICIES)
import types
from repro_torch.launch import mesh as launch_mesh, roofline
from repro_torch.parallel import collectives, ctx, sharding
stand_in = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4), ndim=2)
for kind in ("train", "serve"):
    pl = sharding.model_param_shardings(m, stand_in, kind)
    assert len(pl["layers"]["attn"]["wq"]) == 2
assert sharding.state_shardings(m, stand_in, "decode_32k")["k"]
assert roofline.PEAK_FLOPS == 989e12 and ctx.current() is None
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.")
             or m == "jax" or m.startswith(("jax.", "jaxlib")))
print("LOADED", bad)
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", CHILD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    # "jax" itself sits in sys.modules as the None blocker, nothing else.
    assert proc.stdout.strip().splitlines()[-1] == "LOADED ['jax']"


EXP_CHILD = r"""
import dataclasses, sys, tempfile
sys.modules["jax"] = None
from repro_torch.exp.run import main, run_grid
from repro_torch.exp.scenarios import get_scenario
one = dataclasses.replace(get_scenario("paper-smoke"), apps=("montage",),
                          rates=(6.0,), budget_intervals=((0.5, 1.0),))
with tempfile.TemporaryDirectory() as d:
    art = run_grid(one, device="cpu", trace_dir=d + "/t", report_dir=d + "/r")
    assert len(art["cells"]) == 5 and art["use_pallas"] == "cpu"
    args = ["--grid", "online-smoke", "--device", "cpu", "--out", d,
            "--ckpt-dir", d + "/ck", "--trace-dir", d + "/t"]
    try:
        main(args + ["--ckpt-every-s", "0", "--stop-after-ckpts", "1"])
        raise AssertionError("the stream was not interrupted")
    except SystemExit as e:
        assert e.code == 3, e.code
    main(args + ["--resume"])
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.")
             or m == "jax" or m.startswith(("jax.", "jaxlib")))
print("LOADED", bad)
"""


def test_experiment_harness_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", EXP_CHILD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "LOADED ['jax']"


TRAIN_CHILD = r"""
import sys, tempfile
sys.modules["jax"] = None
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.ft.faults import FaultPlan, FaultyTrainer
from repro_torch.models import RunConfig, build
from repro_torch.train.optim import init_opt_state
from repro_torch.train.train_step import make_train_step
for arch in ("llama3-8b", "zamba2-1.2b"):
    m = build(arch, RunConfig(remat="dots"), smoke=True, device="cpu")
    params = m.init(0)
    dc = DataConfig(seq_len=32, global_batch=2)
    with tempfile.TemporaryDirectory() as d:
        tr = FaultyTrainer(d, FaultPlan(fail_prob=0.3, seed=5, ckpt_every=2))
        params, opt, hist = tr.run(
            params=params, opt=init_opt_state(params), n_steps=4,
            step_fn=make_train_step(m),
            batch_fn=lambda s: batch_at(dc, s, m.cfg), device="cpu")
    assert hist["step"] == [0, 1, 2, 3] and tr.restarts > 0, (hist, tr)
    assert int(opt["step"]) >= 4
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.")
             or m == "jax" or m.startswith(("jax.", "jaxlib")))
print("LOADED", bad)
"""


def test_training_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", TRAIN_CHILD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "LOADED ['jax']"


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax|import\s+jaxlib|from\s+jaxlib"
    r"|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax_or_reference(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), path


def _tiny():
    from repro_torch.core.scheduler import EBPSM
    from repro_torch.core.types import PlatformConfig
    from repro_torch.workflows.workload import WorkloadSpec, \
        generate_workload
    cfg = PlatformConfig()
    return cfg, EBPSM, generate_workload(cfg, WorkloadSpec(
        n_workflows=2, seed=0, sizes=("small",)))


def test_entry_points_default_to_cuda():
    from repro_torch.core.batch_engine import BatchSimEngine, simulate_batch
    from repro_torch.core.engine import SimEngine
    cfg, policy, wl = _tiny()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_batch(cfg, policy, wl, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchSimEngine(cfg, [(policy, wl, 0)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimEngine(cfg, policy, wl, seed=0)
    # Asking for the CPU runs.
    assert SimEngine(cfg, policy, wl, seed=0, device="cpu").run().workflows


def test_serving_entry_points_default_to_cuda():
    from repro_torch.models import build
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serve.serve_step import build_decode_step, \
        build_prefill
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build("zamba2-1.2b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": [1.0]})
    m = build("zamba2-1.2b", smoke=True, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_prefill(m, "prefill_32k")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_decode_step(m, "decode_32k")


def test_experiment_entry_points_default_to_cuda(tmp_path):
    from repro_torch.exp.run import main, run_grid, run_online
    from repro_torch.exp.scenarios import get_scenario
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_grid(get_scenario("paper-smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_online(get_scenario("online-smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--grid", "paper-smoke", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--grid", "online-smoke", "--out", str(tmp_path)])
    assert not (tmp_path / "BENCH_paper_grid.json").exists()


def test_restore_section_defaults_to_cuda(tmp_path):
    from repro_torch import ckpt
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    tree = {"w": torch.ones(3)}
    ckpt.save(str(tmp_path), 1, tree)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore_section(str(tmp_path), 1, tree)
    got, _ = ckpt.restore_section(str(tmp_path), 1, tree, device="cpu")
    assert torch.equal(got["w"], tree["w"])


@pytest.mark.cuda
def test_ssd_under_grad_on_the_card_gives_the_plain_gradient():
    """On a CUDA tensor under grad, ``ssd`` goes through the operator
    ``repro_torch::ssd_fwd``, whose backward kernels give autograd's
    gradient of the plain version (within 1e-4·max(max|ref|, 1)); without
    grad it launches the forward kernels alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernels have no CPU mode")
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 64, 2, 16), generator=gen, device="cuda")
    dt = 0.01 + 0.19 * torch.rand((1, 64, 2), generator=gen, device="cuda")
    A = -0.5 - torch.rand((2,), generator=gen, device="cuda")
    Bm = torch.randn((1, 64, 16), generator=gen, device="cuda")
    Cm = torch.randn((1, 64, 16), generator=gen, device="cuda")
    dy = torch.randn((1, 64, 2, 16), generator=gen, device="cuda")
    grads = []
    for fn in (ops.ssd, ssd_ref):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y, _ = fn(*leaves, chunk=16)
        grads.append(torch.autograd.grad(y, leaves, dy))
    for g, w in zip(*grads):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            float(w.abs().max()), 1.0)
    before = ops.BWD_LAUNCHES
    with torch.no_grad():
        y, _ = ops.ssd(x, dt, A, Bm, Cm, chunk=16)
    assert y.shape == x.shape and ops.BWD_LAUNCHES == before


@pytest.mark.cuda
def test_mesh_train_step_on_the_card_launches_as_unsharded():
    """A llama3-8b smoke train step on a one-rank NCCL ``("data",
    "model")`` mesh (``build_train_step``) launches flash attention's
    forward and backward as often as the unsharded step, and gives its
    loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import socket
    import torch.distributed as dist
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import RunConfig, build
    from repro_torch.models.common import tree_map
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import build_train_step, \
        make_train_step
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device_type="cuda")
        m = build("llama3-8b", RunConfig(remat="dots"), smoke=True,
                  device="cuda")
        p = m.init(0)
        batch = batch_at(DataConfig(seq_len=64, global_batch=2), 0, m.cfg)
        runs = []
        for fn in (make_train_step(m), build_train_step(m, mesh)[0]):
            fa_ops.LAUNCHES = fa_ops.BWD_LAUNCHES = 0
            q = tree_map(lambda t: t.clone(), p)
            _, _, met = fn(q, init_opt_state(q), batch)
            torch.cuda.synchronize()
            runs.append((fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES,
                         float(met["loss"])))
        assert runs[0] == runs[1] and runs[0][0] == m.cfg.n_layers, runs
    finally:
        dist.destroy_process_group()
