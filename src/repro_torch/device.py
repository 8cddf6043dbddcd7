"""Where the port runs: ``device=None`` means ``"cuda"``."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device with no CUDA available
    raises: the port never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# torch's CPU versions of these unary ops have returned wrong values from
# the first call of each in a process when that call ran on several
# threads: whole per-thread ranges off by up to 1.5e-4 relative (torch
# 2.13 with MKL on an AVX-512 Xeon; ROADMAP Queue 3 item 1).  Once one
# call of the op has finished, later calls are right, so a one-element
# (single-threaded) call of each, made when the package is imported,
# keeps the port's CPU path right from its first call.
CPU_FIRST_CALL_OPS = ("exp", "log", "tanh", "sin", "cos", "erf", "sqrt")


def warm_cpu_math() -> None:
    """One single-threaded call of each of ``CPU_FIRST_CALL_OPS``."""
    one = torch.ones(1)
    for name in CPU_FIRST_CALL_OPS:
        getattr(torch, name)(one)
