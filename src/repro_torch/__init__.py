"""PyTorch/CUDA port of the WaaS simulator (``repro``), module for module.

Host-side simulation code is numpy, copied from the reference; the one
device computation on the simulator's path, the Algorithm-2 task×VM
affinity scoring, is a hand-written CUDA kernel
(:mod:`repro_torch.kernels.affinity`).  Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``.
"""
from .device import warm_cpu_math as _warm_cpu_math

_warm_cpu_math()
