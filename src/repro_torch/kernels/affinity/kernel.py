"""Build and launch the CUDA affinity kernel (``csrc/affinity.cu``).

Two launchers share the kernel: :func:`affinity_cuda` takes nine separate
tensors and checks them on every call; :func:`launch_packed` scores a
packed round (``ops.PackedRound``), whose buffers :func:`check_packed`
checks once, when the bucket is made.

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


def check_packed(bucket) -> None:
    """Check a packed round's buffers once: one CUDA device, 32-bit
    sizes, 16-byte-aligned bases (every array inside sits at a 16-byte
    offset) and a batch the grid can hold."""
    from .ops import round_layout
    Bp, Tp, Vp = bucket.shape
    if Bp > MAX_GRID_Y:
        raise ValueError(f"batch {Bp} exceeds the grid's {MAX_GRID_Y}")
    if min(bucket.shape) < 1:
        raise ValueError(f"empty bucket {list(bucket.shape)}")
    want = {"dev": (bucket.dev, torch.uint8, round_layout(Bp, Tp, Vp)[1]),
            "out_dev": (bucket.out_dev, _I32, 4 * Bp * Tp)}
    for name, (t, dtype, numel) in want.items():
        if t.device != bucket.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{bucket.device}")
        if t.dtype != dtype or t.numel() != numel or not t.is_contiguous():
            raise ValueError(f"{name} must be {numel} contiguous {dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if not bucket.host.is_pinned() or not bucket.out_host.is_pinned():
        raise ValueError("a CUDA bucket's host buffers must be page-locked")


def launch_packed(view, scalars, stream: int) -> None:
    """Launch the kernel on a packed round already on the card (``view``
    is an ``ops.RoundView`` of a bucket that :func:`check_packed`
    accepted); ``scalars`` are ``ref.folded_scalars``.  Does not
    synchronise."""
    B, T, V = view.shape
    err = LIB.load().affinity_launch(*view.in_ptrs, B, T, V, *scalars,
                                     *view.out_ptrs, stream)
    check_launch(err, "affinity")
