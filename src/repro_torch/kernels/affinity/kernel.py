"""Build and launch the CUDA affinity kernel (``csrc/affinity.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point (``kernels/build.py``), cached
under ``build/`` next to this file, and loaded with ``ctypes``.  Nothing
is built or loaded when this module is imported.

Build flags: ``-O3 -fmad=false`` and no fast-math — the kernel must stay
bitwise equal to the plain torch version (``ref.py``), so every fp32
division is IEEE round-to-nearest and no multiply-add is contracted.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary, check_launch
from .ref import AffinityOut, folded_scalars

MAX_GRID_Y = 65535


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.affinity_launch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 9 + [I] * 3 + [F] * 4 + [P] * 5
    fn.restype = ctypes.c_int


LIB = CudaLibrary("affinity",
                  Path(__file__).resolve().parent / "csrc" / "affinity.cu",
                  ("-fmad=false",), _bind)


_F32, _I32 = torch.float32, torch.int32
_DTYPES = (_F32, _F32, _F32, _F32, _F32, _I32, _F32, _F32, _F32)
_NAMES = ("size_mi", "out_mb", "budget", "missing_mb", "cont_ms", "tier",
          "vm_mips", "vm_bw", "vm_price")


def _check(args, B: int, T: int, V: int, device: torch.device) -> None:
    shapes = ((B, T),) * 3 + ((B, T, V),) * 3 + ((B, V),) * 3
    for name, a, dt, shape in zip(_NAMES, args, _DTYPES, shapes):
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, expected {device}")
        if a.dtype != dt:
            raise ValueError(f"{name} has dtype {a.dtype}, expected {dt}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def affinity_cuda(size_mi, out_mb, budget, missing_mb, cont_ms, tier,
                  vm_mips, vm_bw, vm_price, gs_read: float, gs_write: float,
                  bp_ms: float) -> AffinityOut:
    """Launch the kernel on ``[B, T, V]`` CUDA tensors (task arrays
    ``[B, T]``, VM arrays ``[B, V]``) on the current stream.  Returns the
    four ``[B, T]`` outputs without synchronising."""
    args = (size_mi, out_mb, budget, missing_mb, cont_ms, tier,
            vm_mips, vm_bw, vm_price)
    if missing_mb.dim() != 3:
        raise ValueError(f"missing_mb must be [B, T, V], got "
                         f"{tuple(missing_mb.shape)}")
    B, T, V = missing_mb.shape
    device = missing_mb.device
    if device.type != "cuda":
        raise ValueError(f"affinity_cuda needs CUDA tensors, got {device}")
    if V < 1:
        raise ValueError("affinity needs at least one VM column")
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid's {MAX_GRID_Y}")
    _check(args, B, T, V, device)
    k, rgs_r, rgs_w, rbp = folded_scalars(gs_read, gs_write, bp_ms)
    best_vm = torch.empty((B, T), dtype=_I32, device=device)
    best_tier = torch.empty((B, T), dtype=_I32, device=device)
    est_f = torch.empty((B, T), dtype=_F32, device=device)
    est_c = torch.empty((B, T), dtype=_F32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = LIB.load().affinity_launch(
        *(a.data_ptr() for a in args), B, T, V, k, rgs_r, rgs_w, rbp,
        best_vm.data_ptr(), best_tier.data_ptr(), est_f.data_ptr(),
        est_c.data_ptr(), stream)
    check_launch(err, "affinity")
    return AffinityOut(best_vm, best_tier, est_f, est_c)
