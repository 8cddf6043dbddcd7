"""Build and launch the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its gradient
(``csrc/flash_attention_bwd.cu``, its own library); both include the
Hopper building blocks of ``csrc/fa_hopper.cuh`` and the TF32 ones of
``csrc/fa_tf32.cuh``.

Each is compiled at first use with ``nvcc`` for ``sm_90a``
(``kernels/build.py``, the hash covering the headers too) and loaded with
``ctypes``; nothing is built when this module is imported.  Build flags:
``kernels/build.py``'s base flags (``-O3``, ``-Xptxas -v``) and
``-lcuda``, for ``cuTensorMapEncodeTiled`` (libcuda), which builds the
TMA tensor maps.  No ``--use_fast_math``, multiply-add contraction
allowed — the kernels are held to a tolerance against the plain
versions, not to bits.  The bf16 kernels take their exponentials from
``ex2.approx.ftz`` on the special-function unit (inline PTX); the fp32
kernels use the accurate ``expf``.  The forward divides by the row sum
with the accurate division.

The dtype picks the kernels: bf16 (the models' dtype) goes to the tensor
cores (wgmma, tiles through a TMA ring, p and dS split into three bf16
terms so that the products stay exact); fp32 (the reference sweep's
dtype, held to 2e-5 forward and 1e-4·max backward, which needs fp32
products) to the tensor cores in TF32, forward and backward
(``mma.sync``, every operand split into two TF32 terms and each product
taken as three TF32 products, hi·hi + hi·lo + lo·hi, summed in fp32).

Head dims: every D from 1 to ``MAX_HEAD_DIM`` = 256, the bound the
reference's kernel docstring writes its VMEM budget for; a larger D is
refused.  Each kernel is built for the column buckets ``BUCKETS`` and
takes the true D at run time (:func:`bucket`): the tiles are W columns
wide, the columns past D zero (the tensor-map copies fill them for bf16,
the ``cp.async`` copies' zero fill for fp32), and only the first D output
columns are written.
A bf16 tensor map needs rows of whole 16-byte units, so where a bf16 D is
not a multiple of 8 the wrappers zero-pad q, k, v and dO to the next one
(:func:`padded_dim`) and slice the outputs back; zero columns add exact
zeros to q·kᵀ and give zero output columns, and the scale stays 1/√D of
the true D.  The padding is part of the wrapper's one launch.  The
functions ``*_smem`` mirror the sources' shared-memory formulas per
bucket (the ring depth and, in the backward, the rows a block takes
follow the bucket), each under ``SMEM_LIMIT``.

* Forward (:func:`flash_attention_cuda`): ``fa_kernel_tc`` (bf16) or
  ``fa_kernel_tf32`` (fp32); with ``lse`` given, either writes each row's
  log-sum-exp as well.
* Backward (:func:`flash_attention_bwd_cuda`): three launches in order,
  ``fa_bwd_preprocess`` (D = rowsum(dO ∘ O), either dtype), then dK/dV
  and dQ: ``fa_bwd_dkdv_tc`` and ``fa_bwd_dq_tc`` for bf16,
  ``fa_bwd_dkdv_tf32`` and ``fa_bwd_dq_tf32`` for fp32.  Each step has its own
  wrapper here and its plain version in ``ref.py``; ``BWD_KERNEL_LAUNCHES``
  counts each kernel's launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..build import CudaLibrary, check_launch

MAX_HEAD_DIM = 256
BUCKETS = (32, 64, 128, 192, 256)
SMEM_LIMIT = 232_448   # dynamic shared memory a block may use on Hopper
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    lib.fa_launch.argtypes = [P] * 5 + [I] * 6 + [F, I, P]
    lib.fa_head_bucket.argtypes = [I]
    lib.fa_smem_bytes.argtypes = [I, I]
    for fn in (lib.fa_launch, lib.fa_head_bucket, lib.fa_smem_bytes):
        fn.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.fa_bwd_preprocess_launch.argtypes = [P] * 3 + [I] * 5 + [P]
    lib.fa_bwd_dkdv_launch.argtypes = [P] * 8 + [I] * 6 + [F, I, P]
    lib.fa_bwd_dq_launch.argtypes = [P] * 7 + [I] * 6 + [F, I, P]
    lib.fa_bwd_smem_bytes.argtypes = [I, I]
    for fn in (lib.fa_bwd_preprocess_launch, lib.fa_bwd_dkdv_launch,
               lib.fa_bwd_dq_launch, lib.fa_bwd_smem_bytes):
        fn.restype = ctypes.c_int


CSRC = Path(__file__).resolve().parent / "csrc"
HEADERS = (CSRC / "fa_hopper.cuh", CSRC / "fa_tf32.cuh")
LIB = CudaLibrary("flash_attention", CSRC / "flash_attention.cu",
                  ("-lcuda",), _bind, HEADERS)
LIB_BWD = CudaLibrary("flash_attention_bwd", CSRC / "flash_attention_bwd.cu",
                      ("-lcuda",), _bind_bwd, HEADERS)

# Launches of each backward kernel through the wrappers below (reset them
# to 0 and read them back around a run).
BWD_KERNELS = ("fa_bwd_preprocess", "fa_bwd_dkdv_tf32", "fa_bwd_dq_tf32",
               "fa_bwd_dkdv_tc", "fa_bwd_dq_tc")
BWD_KERNEL_LAUNCHES = dict.fromkeys(BWD_KERNELS, 0)


def bucket(D: int) -> int:
    """The column bucket the kernels take head dim D in (``fa_bucket`` in
    ``csrc/fa_hopper.cuh``); raises outside 1 <= D <= 256."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} is outside 1..{MAX_HEAD_DIM}, the "
                         f"head dims the kernels take")
    return next(w for w in BUCKETS if D <= w)


def padded_dim(D: int, dtype: torch.dtype) -> int:
    """The head dim the kernels are launched at: bf16 D rounded up to a
    multiple of 8 (a tensor map's rows are whole 16-byte units), fp32 D
    itself.  Never past D's bucket."""
    bucket(D)
    return -(-D // 8) * 8 if dtype == torch.bfloat16 else D


# Shared memory (bytes) of each kernel at bucket W, mirroring the
# sources' formulas: 64-row tiles of W bf16 columns in boxes of at most 64
# (``Geo`` in csrc/fa_hopper.cuh); 1024 bytes of slack align the
# tensor-core kernels' base, each mbarrier takes 8.

def tile_bytes(W: int) -> int:
    """A 64-row bf16 tile of bucket W (``Geo<W>::TILE``)."""
    cb = min(W, 64)
    return -(-W // cb) * 64 * cb * 2


def ring_stages(W: int) -> int:
    """Ring stages of ``fa_kernel_tc`` (k, v) and ``fa_bwd_dkdv_tc``
    (q, dO) (``ring_stages`` in csrc/fa_hopper.cuh)."""
    return 4 if W <= 128 else 3 if W <= 192 else 2


def dq_tc_stages(W: int) -> int:
    """(k, v) ring stages of ``fa_bwd_dq_tc``."""
    return 4 if W <= 128 else 2


def dq_tc_warpgroups(W: int) -> int:
    """Consumer warpgroups (64 query rows each) of a ``fa_bwd_dq_tc``
    block: one at W = 256, where two q and dO tiles do not fit."""
    return 2 if W <= 192 else 1


def f32_rows(W: int) -> int:
    """Rows a block of ``fa_kernel_tf32``, ``fa_bwd_dkdv_tf32`` or
    ``fa_bwd_dq_tf32`` owns (queries or keys), and rows of each tile it
    streams (``f32_rows`` in csrc/fa_tf32.cuh)."""
    return 64 if W <= 128 else 32


F32_STAGES = 2  # the fp32 kernels' cp.async ring


def tf32_group(W: int) -> int:
    """Output n-tiles (8 columns each) whose tile sums the fp32 kernels
    take together (``Tf32<W>::NG``)."""
    return W // 8 if W // 8 < 8 else 8 if W < 256 else 4


def fwd_tf32_pv_tiles(D: int) -> int:
    """Output n-tiles over which ``fa_kernel_tf32`` computes p·v at head
    dim D (``pv_tf32``): whole groups of ``tf32_group`` n-tiles, the last
    cut to the fewest of NG, NG / 2 or NG / 4 (at least 2) that reach the
    n-tile holding column D − 1."""
    ng = tf32_group(bucket(D))
    nt = -(-D // 8)
    full, left = nt // ng * ng, nt % ng
    ng2, ng4 = max(ng // 2, 2), max(ng // 4, 2)
    tail = 0 if not left else ng if left > ng2 else ng2 if left > ng4 \
        else ng4
    return full + tail


def fwd_tc_smem(W: int) -> int:
    """``fa_kernel_tc``: two q tiles, the k and v rings, mbarriers."""
    s = ring_stages(W)
    return 1024 + (2 + 2 * s) * tile_bytes(W) + 8 * (1 + 2 * s)


def fwd_tf32_smem(W: int) -> int:
    """``fa_kernel_tf32``: q's hi and lo tiles and the ring's stages of k
    and v tiles; fp32, unpadded (the tiles are swizzled)."""
    r = f32_rows(W)
    return 4 * (2 * r * W + F32_STAGES * 2 * r * W)


def dkdv_tc_smem(W: int) -> int:
    """``fa_bwd_dkdv_tc``: k, v, the (q, dO) ring, each stage's lse and D
    rows for 64 queries in fp32, mbarriers."""
    s = ring_stages(W)
    return (1024 + (2 + 2 * s) * tile_bytes(W) + s * 2 * 64 * 4
            + 8 * (1 + 2 * s))


def dq_tc_smem(W: int) -> int:
    """``fa_bwd_dq_tc``: q and dO per warpgroup, the (k, v) ring,
    mbarriers."""
    s = dq_tc_stages(W)
    return (1024 + (2 * dq_tc_warpgroups(W) + 2 * s) * tile_bytes(W)
            + 8 * (1 + 2 * s))


def dkdv_tf32_smem(W: int) -> int:
    """``fa_bwd_dkdv_tf32``: the k and v tiles, the ring's stages of q
    and dO tiles with their rows' lse and D, and Pᵀ passed between the
    warps of a pair; fp32, unpadded (the tiles are swizzled)."""
    r = f32_rows(W)
    return 4 * (2 * r * W + F32_STAGES * (2 * r * W + 2 * r) + r * r)


def dq_tf32_smem(W: int) -> int:
    """``fa_bwd_dq_tf32``: the q and dO tiles, the ring's stages of k
    and v tiles."""
    r = f32_rows(W)
    return 4 * (2 * r * W + F32_STAGES * 2 * r * W)


# Each kernel's mirror, keyed by kernel name, with the index its
# library's ``fa_smem_bytes`` / ``fa_bwd_smem_bytes`` takes for it.
SMEM = {"fa_kernel_tc": (fwd_tc_smem, 0),
        "fa_kernel_tf32": (fwd_tf32_smem, 1),
        "fa_bwd_dkdv_tc": (dkdv_tc_smem, 0), "fa_bwd_dq_tc": (dq_tc_smem, 1),
        "fa_bwd_dkdv_tf32": (dkdv_tf32_smem, 2),
        "fa_bwd_dq_tf32": (dq_tf32_smem, 3)}


def bwd_kernel(step: str, dtype: torch.dtype) -> str:
    """The kernel that the dK/dV (``step="dkdv"``) or dQ (``"dq"``)
    wrapper launches for ``dtype``: the wgmma one for bf16, the TF32
    ``mma.sync`` one for fp32."""
    return f"fa_bwd_{step}" + ("_tc" if dtype == torch.bfloat16 else "_tf32")


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
    bucket(D)
    if causal and Lk < Lq:
        raise ValueError("causal attention needs Lk >= Lq: a query row "
                         "would see no key")
    if Lq < 1 or Lk < 1 or H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"unsupported shape {list(q.shape)}, Lk={Lk}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the tensor maps need (a
    contiguous view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _padded(*tensors: torch.Tensor) -> tuple:
    """The tensors zero-padded along D to ``padded_dim`` (new, contiguous
    and aligned), or as they are when no padding is needed."""
    D = tensors[0].shape[-1]
    pad = padded_dim(D, tensors[0].dtype) - D
    if not pad:
        return tensors
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in tensors)


def _cut(t: torch.Tensor, D: int) -> torch.Tensor:
    """A padded output's first D columns, contiguous."""
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, lse: bool = False):
    """Launch the kernel on [B, L, H, D] CUDA tensors on the current
    stream (a non-contiguous input is copied to contiguous first; the
    model's tensors already are).  Returns a new contiguous [B, Lq, H, D]
    tensor in q's dtype without synchronising; with ``lse``, the pair
    (output, log-sum-exp fp32 [B, H, Lq])."""
    _check(q, k, v, causal, "flash_attention_cuda")
    B, Lq, H, D = q.shape
    q, k, v = _padded(q.contiguous(), k.contiguous(), v.contiguous())
    out = torch.empty_like(q)
    stats = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
             if lse else None)
    err = LIB.load().fa_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        stats.data_ptr() if lse else None, DTYPES[q.dtype], B, H, Lq,
        k.shape[1], q.shape[-1], 1.0 / math.sqrt(D), int(causal),
        _stream(q))
    check_launch(err, "flash attention")
    out = _cut(out, D)
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
    if o.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {o.dtype}")
    bucket(o.shape[-1])
    B, Lq, H, D = o.shape
    o, do = o.contiguous(), do.contiguous()
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=o.device)
    err = LIB_BWD.load().fa_bwd_preprocess_launch(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), DTYPES[o.dtype], B,
        H, Lq, D, _stream(o))
    check_launch(err, "flash attention backward (preprocess)")
    BWD_KERNEL_LAUNCHES["fa_bwd_preprocess"] += 1
    return delta


def bwd_dkdv_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """``fa_bwd_dkdv_tc`` (bf16) or ``fa_bwd_dkdv_tf32`` (fp32): (dK, dV)
    [B, Lk, H, D] in q's dtype."""
    _check(q, k, v, causal, "bwd_dkdv_cuda")
    _check_grad_inputs(q, do, stats=(lse, delta))
    B, Lq, H, D = q.shape
    q, k, v, do = _padded(*(_tma_ready(t) for t in (q, k, v, do)))
    lse, delta = lse.contiguous(), delta.contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = LIB_BWD.load().fa_bwd_dkdv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype], B, H, Lq, k.shape[1],
        q.shape[-1], 1.0 / math.sqrt(D), int(causal), _stream(q))
    check_launch(err, "flash attention backward (dK, dV)")
    BWD_KERNEL_LAUNCHES[bwd_kernel("dkdv", q.dtype)] += 1
    return _cut(dk, D), _cut(dv, D)


def bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """``fa_bwd_dq_tc`` (bf16) or ``fa_bwd_dq_tf32`` (fp32): dQ [B, Lq, H, D]
    in q's dtype."""
    _check(q, k, v, causal, "bwd_dq_cuda")
    _check_grad_inputs(q, do, stats=(lse, delta))
    B, Lq, H, D = q.shape
    q, k, v, do = _padded(*(_tma_ready(t) for t in (q, k, v, do)))
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty_like(q)
    err = LIB_BWD.load().fa_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), DTYPES[q.dtype], B, H, Lq, k.shape[1], q.shape[-1],
        1.0 / math.sqrt(D), int(causal), _stream(q))
    check_launch(err, "flash attention backward (dQ)")
    BWD_KERNEL_LAUNCHES[bwd_kernel("dq", q.dtype)] += 1
    return _cut(dq, D)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor,
                             causal: bool = True):
    """(dq, dk, dv) of the forward at output ``o`` for the output
    gradient ``do``, from the forward's log-sum-exp ``lse`` (fp32
    [B, H, Lq]): the three backward kernels for q's dtype, one launch
    each, on the current stream without synchronising.  Same checks as
    the forward; ``o`` and ``do`` must match q."""
    _check(q, k, v, causal, "flash_attention_bwd_cuda")
    _check_grad_inputs(q, o, do, stats=(lse,))
    delta = bwd_preprocess_cuda(o, do)
    dk, dv = bwd_dkdv_cuda(q, k, v, do, lse, delta, causal)
    return bwd_dq_cuda(q, k, v, do, lse, delta, causal), dk, dv
