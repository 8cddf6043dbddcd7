"""repro_torch's CPU math from the first call of a process.

torch's CPU versions of some unary ops (``repro_torch.device.
CPU_FIRST_CALL_OPS``) have returned values off by up to 1.5e-4 relative
for whole per-thread ranges of the first call in a process when that call
ran on several threads (ROADMAP Queue 3 item 1: the SSD sweep test's
recurring miss).  Importing ``repro_torch`` makes one single-threaded
call of each first; this is checked in a fresh process, since only a
process's first call is at stake.
"""
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.device import CPU_FIRST_CALL_OPS

SRC = str(Path(__file__).resolve().parents[1] / "src")

RECORD = r"""
import torch
called = []
for name in %r:
    def wrap(f, name=name):
        def g(t, *a, **k):
            called.append((name, t.numel()))
            return f(t, *a, **k)
        return g
    setattr(torch, name, wrap(getattr(torch, name)))
import repro_torch
print(called)
"""


def test_import_calls_each_op_once_on_one_element():
    proc = subprocess.run([sys.executable, "-c",
                           RECORD % (CPU_FIRST_CALL_OPS,)],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert eval(proc.stdout.strip()) == [(name, 1)
                                         for name in CPU_FIRST_CALL_OPS]
