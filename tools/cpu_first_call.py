"""Probe torch's first threaded CPU call of a unary op, one per process.

``python tools/cpu_first_call.py [--ops exp,log,...] [--procs 96]
[--parallel 8] [--port] [--size 24576]``

Starts ``--procs`` fresh Python processes per op, ``--parallel`` at a
time.  Each makes its first call of the op on ``--size`` float32 values
(several threads: torch's default count) and prints the worst relative
error against float64 numpy; a process counts as wrong above 1e-6.
With ``--port`` each imports ``repro_torch`` first (which makes one
single-threaded call of each op in ``repro_torch.device.
CPU_FIRST_CALL_OPS``).  ``--ssd`` instead runs, per process, the SSD
sweep case ``[2, 128, 3, 32, 16, 32]`` of ``tests/test_torch_ssd.py``
through the port's plain ``ssd`` and the reference's ``ssd_ref`` (needs
jax) and prints max |Δ| of y.  Prints one line per op: wrong processes
of all, and the worst error seen.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
TESTS = str(Path(__file__).resolve().parents[1] / "tests")

OP = r"""
import math, sys
import numpy as np
import torch
if sys.argv[3] == "1":
    import repro_torch
name, seed, size = sys.argv[1], int(sys.argv[2]), int(sys.argv[4])
lo, hi = {"exp": (-13, 0), "log": (0.01, 10), "tanh": (-3, 3),
          "sin": (-3, 3), "cos": (-3, 3), "erf": (-2, 2),
          "sqrt": (0.01, 10), "sigmoid": (-6, 6), "rsqrt": (0.01, 10),
          "log1p": (0, 5), "expm1": (-3, 3), "tan": (-1, 1)}[name]
v = np.random.default_rng(seed).uniform(lo, hi, size).astype(np.float32)
got = getattr(torch, name)(torch.from_numpy(v)).double().numpy()
x = v.astype(np.float64)
want = {"erf": np.vectorize(math.erf),
        "sigmoid": lambda t: 1 / (1 + np.exp(-t)),
        "rsqrt": lambda t: 1 / np.sqrt(t)}.get(name, getattr(np, name, None))(x)
print(float((np.abs(got - want) / np.maximum(np.abs(want), 1e-3)).max()))
"""

SSD = r"""
import sys
import numpy as np
import jax.numpy as jnp
import torch
from repro.kernels.ssd.ref import ssd_ref
from repro_torch.kernels.ssd import ops
from test_torch_ssd import make
arrs = make(2 * 128 + 16, 2, 128, 3, 32, 16)
y, _ = ops.ssd(*[torch.from_numpy(a) for a in arrs], chunk=32)
ry, _ = ssd_ref(*[jnp.asarray(a) for a in arrs], chunk=32)
print(float(np.abs(y.numpy() - np.asarray(ry)).max()))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ops", default="exp,log,tanh,sin,cos,erf,sqrt")
    ap.add_argument("--procs", type=int, default=96)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--size", type=int, default=24576)
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--ssd", action="store_true")
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, TESTS)),
               JAX_PLATFORMS="cpu")
    for name in (["ssd"] if args.ssd else args.ops.split(",")):
        worst, wrong, todo = [], 0, list(range(args.procs))
        while todo:
            batch, todo = todo[:args.parallel], todo[args.parallel:]
            cmd = ((lambda s: [sys.executable, "-c", SSD]) if args.ssd else
                   (lambda s: [sys.executable, "-c", OP, name, str(s),
                               "1" if args.port else "0", str(args.size)]))
            procs = [subprocess.Popen(cmd(s), env=env, text=True,
                                      stdout=subprocess.PIPE) for s in batch]
            for p in procs:
                out, _ = p.communicate()
                if p.returncode:
                    raise RuntimeError(f"{name}: a probe process failed")
                err = float(out.strip())
                worst.append(err)
                wrong += err > (1e-4 if args.ssd else 1e-6)
        print(f"{name}: {wrong} of {args.procs} processes wrong, worst "
              f"{max(worst):.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
