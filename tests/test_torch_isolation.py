"""repro_torch stands alone: no jax, nothing of the reference package.

* A subprocess that blocks ``jax`` (``sys.modules["jax"] = None``)
  imports ``repro_torch.core.batch_engine`` and runs a tiny CPU grid,
  then builds the zamba2-1.2b smoke model on the CPU, prefills a prompt
  through the serve builders and decodes one token; afterwards no
  ``repro.*`` or ``jax*`` module is loaded.
* A source scan of ``src/repro_torch/`` and ``chip_smoke.py`` finds no
  ``import jax`` and no import of ``repro.``.
* Without a CUDA device, the entry points refuse to run unless the caller
  asks for the CPU.
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
