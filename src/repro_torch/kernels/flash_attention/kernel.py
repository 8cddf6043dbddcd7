"""Build and launch the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Compiled at first use with ``nvcc`` for ``sm_90a`` (``kernels/build.py``)
and loaded with ``ctypes``; nothing is built when this module is
imported.  Build flags: ``kernels/build.py``'s base flags (``-O3``,
``-Xptxas -v``) and ``-lcuda``, for the driver's
``cuTensorMapEncodeTiled`` that builds the TMA tensor maps; no
``--use_fast_math``, multiply-add contraction allowed — the kernel is
held to a tolerance against the plain version, not to bits.  The bf16
kernel takes its exponentials from ``ex2.approx.ftz`` on the
special-function unit (inline PTX); the fp32 kernel uses the accurate
``expf``.  Both divide by the row sum with the accurate division.

The dtype picks the kernel: bf16 (the model's serving dtype) goes to
``fa_kernel_tc`` (wgmma on the tensor cores, K and V through a TMA ring,
p split into three bf16 terms so that the products stay exact); fp32
(the reference sweep's dtype, held to 2e-5) goes to ``fa_kernel_f32`` on
the CUDA cores.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..build import CudaLibrary, check_launch

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fa_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 4 + [I] * 6 + [ctypes.c_float, I, P]
    fn.restype = ctypes.c_int


LIB = CudaLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    ("-lcuda",), _bind)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel on [B, L, H, D] CUDA tensors on the current
    stream (a non-contiguous input is copied to contiguous first; the
    model's tensors already are).  Returns a new contiguous [B, Lq, H, D]
    tensor in q's dtype without synchronising."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, H, D]")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if k.shape != (B, Lk, H, D) or v.shape != k.shape:
        raise ValueError(f"k, v must be [B, Lk, H, D] = {[B, Lk, H, D]}, "
                         f"got {list(k.shape)} and {list(v.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
    if q.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if causal and Lk < Lq:
        raise ValueError("causal attention needs Lk >= Lq: a query row "
                         "would see no key")
    if Lq < 1 or Lk < 1 or H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"unsupported shape {list(q.shape)}, Lk={Lk}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = LIB.load().fa_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, H, Lq, Lk, D, 1.0 / math.sqrt(D), int(causal),
        stream)
    check_launch(err, "flash attention")
    return out
