"""Build and launch the CUDA SSD kernels (``csrc/ssd.cu``): the
intra-chunk pass (:func:`ssd_chunks_cuda`; bf16 on the tensor cores at
the serving shapes, fp32 on the CUDA cores) and the inter-chunk carry
(:func:`ssd_carry_cuda`).

Compiled at first use with ``nvcc`` for ``sm_90a`` (``kernels/build.py``)
and loaded with ``ctypes``; nothing is built when this module is
imported.  Build flags: ``-O3``, no fast-math, multiply-add contraction
allowed — the kernels are held to a tolerance against the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..build import CudaLibrary, check_launch
from .ref import check_chunk

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232_448      # a block's dynamic shared-memory ceiling
MAX_GRID_YZ = 65535


# bf16 terms of the tensor-core kernel's fp32 operands (W and
# B ⊙ dec_end); PERF.md has the worst ratio to the bar per term count.
TERMS = 2
TC_Q, TC_P, TC_N = 64, 64, (64, 128)   # shapes the tensor-core kernel takes


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [P] * 7 + [I] * 8 + [P]
    lib.ssd_chunk_launch.restype = ctypes.c_int
    lib.ssd_carry_launch.argtypes = [P] * 7 + [I] * 8 + [P]
    lib.ssd_carry_launch.restype = ctypes.c_int


LIB = CudaLibrary("ssd", Path(__file__).resolve().parent / "csrc" / "ssd.cu",
                  (), _bind)


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one block of the CUDA-core kernel: x
    [Q,P], B and C [Q,N+1], W [Q,Q+1] and three [Q] vectors, fp32 (as
    ``smem_floats`` in ``csrc/ssd.cu``)."""
    return 4 * (Q * P + 2 * Q * (N + 1) + Q * (Q + 1) + 3 * Q)


def carry_smem_bytes(N: int, Q: int, c_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one carry block at its widest slice (16
    columns): h_prev [N,16] and C transposed [N,Q] in fp32, and two
    padded [Q, N + 16 bytes] buffers of C as read (as ``carry_smem_bytes``
    in ``csrc/ssd.cu``)."""
    size = 2 if c_dtype == torch.bfloat16 else 4
    return 4 * (N * 16 + N * (Q + Q % 2)) + 2 * Q * (N + 16 // size) * size


def tc_shape(dtype: torch.dtype, Q: int, P: int, N: int) -> bool:
    """Whether the tensor-core kernel takes this chunk pass."""
    return dtype == torch.bfloat16 and Q == TC_Q and P == TC_P \
        and N in TC_N


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def ssd_chunks_cuda(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                    terms: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the chunk kernel on CUDA tensors: x [B,L,H,P] and Bm, Cm
    [B,L,N] of one dtype (fp32 or bf16), dt and cum [B,L,H] fp32, all
    contiguous.  Returns (y_intra [B,L,H,P], states [B,nc,H,N,P]), fp32,
    without synchronising.

    ``terms``: None takes the tensor-core kernel with ``TERMS`` bf16 terms
    where it applies (:func:`tc_shape`) and the CUDA-core kernel
    elsewhere; 0 forces the CUDA-core kernel; 1-3 ask for the tensor-core
    kernel with that many terms."""
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
    tc = tc_shape(x.dtype, chunk, P, N)
    if terms is None:
        terms = TERMS if tc else 0
    if terms not in (0, 1, 2, 3) or (terms and not tc):
        raise ValueError(f"the tensor-core kernel takes bf16 at Q = "
                         f"{TC_Q}, P = {TC_P}, N in {TC_N} with 1-3 terms; "
                         f"got terms={terms} for {x.dtype}, Q {chunk}, "
                         f"P {P}, N {N}")
    if terms:    # 16-byte cp.async copies
        _check_aligned(x=x, Bm=Bm, Cm=Cm)
    if not terms and smem_bytes(chunk, N, P) > MAX_SMEM_BYTES:
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
        Bsz, L, H, P, N, chunk, terms, stream)
    check_launch(err, "SSD chunk")
    return y, states


def ssd_carry_cuda(y_intra: torch.Tensor, states: torch.Tensor,
                   cum: torch.Tensor, Cm: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the carry kernel on CUDA tensors: y_intra [B,L,H,P] and
    states [B,nc,H,N,P] fp32 (the chunk kernel's outputs), cum [B,L,H]
    fp32, Cm [B,L,N] fp32 or bf16, init_state [B,H,N,P] or None.  Returns
    (y [B,L,H,P] in ``out_dtype``, final state [B,H,N,P] fp32) without
    synchronising."""
    if y_intra.dim() != 4 or y_intra.device.type != "cuda":
        raise ValueError(f"ssd_carry_cuda needs a CUDA y_intra [B, L, H, "
                         f"P], got {list(y_intra.shape)} on "
                         f"{y_intra.device}")
    Bsz, L, H, P = y_intra.shape
    N = Cm.shape[-1]
    nc = check_chunk(L, chunk)
    if P % 8 or N % 8:
        raise ValueError(f"the carry kernel needs P and N multiples of 8; "
                         f"got P {P}, N {N}")
    if chunk > 256 or carry_smem_bytes(N, chunk, Cm.dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"the carry kernel takes chunks up to 256 rows "
                         f"(two per thread, 512 threads) and its tiles in "
                         f"shared memory; got Q {chunk}, N {N}")
    want = {"y_intra": (y_intra, (Bsz, L, H, P), (torch.float32,)),
            "states": (states, (Bsz, nc, H, N, P), (torch.float32,)),
            "cum": (cum, (Bsz, L, H), (torch.float32,)),
            "Cm": (Cm, (Bsz, L, N), tuple(DTYPES))}
    if init_state is not None:
        want["init_state"] = (init_state, (Bsz, H, N, P), (torch.float32,))
    for name, (t, shape, dtypes) in want.items():
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(f"{name} must be {list(shape)} of "
                             f"{dtypes}, got {list(t.shape)} {t.dtype}")
        if t.device != y_intra.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on "
                             f"{y_intra.device}")
    if out_dtype not in DTYPES:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    if H > MAX_GRID_YZ or Bsz > MAX_GRID_YZ:
        raise ValueError(f"unsupported shape {list(y_intra.shape)}")
    _check_aligned(y_intra=y_intra, states=states, Cm=Cm,  # 16-byte loads
                   init_state=init_state)
    y = torch.empty((Bsz, L, H, P), dtype=out_dtype, device=y_intra.device)
    final = torch.empty((Bsz, H, N, P), dtype=torch.float32,
                        device=y_intra.device)
    stream = torch.cuda.current_stream(y_intra.device).cuda_stream
    err = LIB.load().ssd_carry_launch(
        y_intra.data_ptr(), states.data_ptr(), cum.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), DTYPES[Cm.dtype], DTYPES[out_dtype],
        Bsz, L, H, P, N, chunk, stream)
    check_launch(err, "SSD carry")
    return y, final
