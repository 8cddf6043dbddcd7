"""Build and launch the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its gradient
(``csrc/flash_attention_bwd.cu``, its own library).

Each is compiled at first use with ``nvcc`` for ``sm_90a``
(``kernels/build.py``) and loaded with ``ctypes``; nothing is built when
this module is imported.  Build flags: ``kernels/build.py``'s base flags
(``-O3``, ``-Xptxas -v``); the forward adds ``-lcuda``, for
``cuTensorMapEncodeTiled`` (libcuda), which builds the TMA tensor maps.  No
``--use_fast_math``, multiply-add contraction allowed — the kernels are
held to a tolerance against the plain versions, not to bits.  The bf16
forward takes its exponentials from ``ex2.approx.ftz`` on the
special-function unit (inline PTX); the fp32 forward and the backward
use the accurate ``expf``.  The forward divides by the row sum with the
accurate division.

The dtype picks the forward kernel: bf16 (the model's serving dtype) goes to
``fa_kernel_tc`` (wgmma on the tensor cores, K and V through a TMA ring,
p split into three bf16 terms so that the products stay exact); fp32
(the reference sweep's dtype, held to 2e-5) goes to ``fa_kernel_f32`` on
the CUDA cores.  Head dims: ``HEAD_DIMS``; at D = 80 the bf16 kernel
lays its tiles out as at D = 128, the columns past 80 zero-filled by the
tensor-map copies, and writes only the first 80 output columns.  With
``lse`` given, either writes each row's log-sum-exp as well.

The backward (:func:`flash_attention_bwd_cuda`) launches three kernels
in order on the CUDA cores, in fp32 for either dtype:
``fa_bwd_preprocess`` (D = rowsum(dO ∘ O)), ``fa_bwd_dkdv`` and
``fa_bwd_dq``; each has its own wrapper here and its plain version in
``ref.py``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..build import CudaLibrary, check_launch

HEAD_DIMS = (32, 64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fa_launch
    fn.argtypes = [P] * 5 + [I] * 6 + [F, I, P]
    fn.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.fa_bwd_preprocess_launch.argtypes = [P] * 3 + [I] * 5 + [P]
    lib.fa_bwd_dkdv_launch.argtypes = [P] * 8 + [I] * 6 + [F, I, P]
    lib.fa_bwd_dq_launch.argtypes = [P] * 7 + [I] * 6 + [F, I, P]
    for fn in (lib.fa_bwd_preprocess_launch, lib.fa_bwd_dkdv_launch,
               lib.fa_bwd_dq_launch):
        fn.restype = ctypes.c_int


CSRC = Path(__file__).resolve().parent / "csrc"
LIB = CudaLibrary("flash_attention", CSRC / "flash_attention.cu",
                  ("-lcuda",), _bind)
LIB_BWD = CudaLibrary("flash_attention_bwd", CSRC / "flash_attention_bwd.cu",
                      (), _bind_bwd)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, what: str) -> None:
    """The shapes, dtypes and devices the kernels take; raises on the
    rest."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, H, D]")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {q.device}")
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, lse: bool = False):
    """Launch the kernel on [B, L, H, D] CUDA tensors on the current
    stream (a non-contiguous input is copied to contiguous first; the
    model's tensors already are).  Returns a new contiguous [B, Lq, H, D]
    tensor in q's dtype without synchronising; with ``lse``, the pair
    (output, log-sum-exp fp32 [B, H, Lq])."""
    _check(q, k, v, causal, "flash_attention_cuda")
    B, Lq, H, D = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    stats = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
             if lse else None)
    err = LIB.load().fa_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        stats.data_ptr() if lse else None, DTYPES[q.dtype], B, H, Lq,
        k.shape[1], D, 1.0 / math.sqrt(D), int(causal), _stream(q))
    check_launch(err, "flash attention")
    return (out, stats) if lse else out


def _check_grad_inputs(q: torch.Tensor, *tensors: torch.Tensor,
                       stats: tuple = ()) -> None:
    """``tensors`` (o, dO) match q; ``stats`` (lse, D) are fp32
    [B, H, Lq] on q's device."""
    B, Lq, H, _ = q.shape
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("o and do must match q's shape, dtype and "
                             "device")
    for t in stats:
        if (t.shape != (B, H, Lq) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"row statistics must be fp32 {[B, H, Lq]} on "
                             f"q's device")


def bwd_preprocess_cuda(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``fa_bwd_preprocess``: D = rowsum(dO ∘ O), fp32 [B, H, Lq]."""
    if o.device.type != "cuda" or do.shape != o.shape \
            or do.dtype != o.dtype or do.device != o.device:
        raise ValueError("o and do must be CUDA tensors of one shape and "
                         "dtype")
    if o.dtype not in DTYPES or o.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"unsupported dtype {o.dtype} or head dim "
                         f"{o.shape[-1]}")
    B, Lq, H, D = o.shape
    o, do = o.contiguous(), do.contiguous()
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=o.device)
    err = LIB_BWD.load().fa_bwd_preprocess_launch(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), DTYPES[o.dtype], B,
        H, Lq, D, _stream(o))
    check_launch(err, "flash attention backward (preprocess)")
    return delta


def bwd_dkdv_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """``fa_bwd_dkdv``: (dK, dV) [B, Lk, H, D] in q's dtype."""
    _check(q, k, v, causal, "bwd_dkdv_cuda")
    _check_grad_inputs(q, do, stats=(lse, delta))
    B, Lq, H, D = q.shape
    q, k, v, do, lse, delta = (t.contiguous()
                               for t in (q, k, v, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = LIB_BWD.load().fa_bwd_dkdv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype], B, H, Lq, k.shape[1],
        D, 1.0 / math.sqrt(D), int(causal), _stream(q))
    check_launch(err, "flash attention backward (dK, dV)")
    return dk, dv


def bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """``fa_bwd_dq``: dQ [B, Lq, H, D] in q's dtype."""
    _check(q, k, v, causal, "bwd_dq_cuda")
    _check_grad_inputs(q, do, stats=(lse, delta))
    B, Lq, H, D = q.shape
    q, k, v, do, lse, delta = (t.contiguous()
                               for t in (q, k, v, do, lse, delta))
    dq = torch.empty_like(q)
    err = LIB_BWD.load().fa_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), DTYPES[q.dtype], B, H, Lq, k.shape[1], D,
        1.0 / math.sqrt(D), int(causal), _stream(q))
    check_launch(err, "flash attention backward (dQ)")
    return dq


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor,
                             causal: bool = True):
    """(dq, dk, dv) of the forward at output ``o`` for the output
    gradient ``do``, from the forward's log-sum-exp ``lse`` (fp32
    [B, H, Lq]): the three backward kernels, one launch each, on the
    current stream without synchronising.  Same checks as the forward;
    ``o`` and ``do`` must match q."""
    _check(q, k, v, causal, "flash_attention_bwd_cuda")
    _check_grad_inputs(q, o, do, stats=(lse,))
    delta = bwd_preprocess_cuda(o, do)
    dk, dv = bwd_dkdv_cuda(q, k, v, do, lse, delta, causal)
    return bwd_dq_cuda(q, k, v, do, lse, delta, causal), dk, dv
