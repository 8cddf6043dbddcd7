"""What the A/B timing tools (``ssd_ab.py``, ``fa_ab.py``) share: the
per-launch timer and the card's name and power limit.  Needs a CUDA card
to call."""
from __future__ import annotations

import statistics
import subprocess

import torch

BURST = 10


def ms(fn, reps=15):
    """Median ms per launch over ``reps`` windows of ``BURST`` launches
    back to back (CUDA events), so that the card never waits on the host
    between launches."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(BURST):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / BURST)
    return statistics.median(times)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
