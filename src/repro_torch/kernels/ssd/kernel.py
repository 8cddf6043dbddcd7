"""Build and launch the CUDA SSD intra-chunk kernel (``csrc/ssd.cu``).

Compiled at first use with ``nvcc`` for ``sm_90a`` (``kernels/build.py``)
and loaded with ``ctypes``; nothing is built when this module is
imported.  Build flags: ``-O3``, no fast-math, multiply-add contraction
allowed — the kernel is held to a tolerance against the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..build import CudaLibrary, check_launch
from .ref import check_chunk

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232_448      # a block's dynamic shared-memory ceiling
MAX_GRID_YZ = 65535


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_chunk_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 7 + [I] * 7 + [P]
    fn.restype = ctypes.c_int


LIB = CudaLibrary("ssd", Path(__file__).resolve().parent / "csrc" / "ssd.cu",
                  (), _bind)


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one block: x [Q,P], B and C [Q,N+1],
    W [Q,Q+1] and three [Q] vectors, fp32 (as ``smem_floats`` in
    ``csrc/ssd.cu``)."""
    return 4 * (Q * P + 2 * Q * (N + 1) + Q * (Q + 1) + 3 * Q)


def ssd_chunks_cuda(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors: x [B,L,H,P] and Bm, Cm [B,L,N]
    of one dtype (fp32 or bf16), dt and cum [B,L,H] fp32, all contiguous.
    Returns (y_intra [B,L,H,P], states [B,nc,H,N,P]), fp32, without
    synchronising."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, L, H, P], got {list(x.shape)}")
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunks_cuda needs CUDA tensors, got "
                         f"{x.device}")
    nc = check_chunk(L, chunk)
    want = {"dt": ((Bsz, L, H), torch.float32),
            "cum": ((Bsz, L, H), torch.float32),
            "Bm": ((Bsz, L, N), x.dtype), "Cm": ((Bsz, L, N), x.dtype)}
    for name, t in (("dt", dt), ("cum", cum), ("Bm", Bm), ("Cm", Cm)):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {list(shape)} {dtype}, got "
                             f"{list(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    for name, t in (("x", x), ("dt", dt), ("cum", cum), ("Bm", Bm),
                    ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if smem_bytes(chunk, N, P) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk}, N {N}, P {P} need "
                         f"{smem_bytes(chunk, N, P)} bytes of shared "
                         f"memory, above {MAX_SMEM_BYTES}")
    if H > MAX_GRID_YZ or Bsz > MAX_GRID_YZ:
        raise ValueError(f"unsupported shape {list(x.shape)}")
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, nc, H, N, P), dtype=torch.float32,
                         device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = LIB.load().ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), states.data_ptr(), DTYPES[x.dtype],
        Bsz, L, H, P, N, chunk, stream)
    check_launch(err, "SSD chunk")
    return y, states
