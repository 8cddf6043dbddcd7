"""Build and launch the CUDA SSD kernels (``csrc/ssd.cu``): the
intra-chunk pass (:func:`ssd_chunks_cuda`) and the inter-chunk carry
(:func:`ssd_carry_cuda`); and their gradient (``csrc/ssd_bwd.cu``, its
own library): the carry's two walks (:func:`ssd_carry_bwd_cuda`) and each
chunk's gradients (:func:`ssd_chunk_bwd_cuda`).  The wrappers choose the
kernel by dtype and shape (:func:`fwd_kernels`, :func:`bwd_kernels`): at
Q = P = 64, N in {64, 128} (the models' shapes) the chunk pass and the
chunk backward and the carry backward run on the tensor cores with
``mma.sync`` — bf16 in ``ssd_chunk_tc``, ``ssd_chunk_bwd_tc`` and
``ssd_carry_bwd_tc`` (fp32 operands in ``TERMS`` or ``BWD_TERMS`` bf16
terms), fp32 in ``ssd_chunk_tf32``, ``ssd_chunk_bwd_tf32`` and
``ssd_carry_bwd_tf32`` (TF32, ``TF32_TERMS`` = three products a
product); the next head's or chunks' tiles are copied with ``cp.async``
while a block computes, and every one of them is bound by bytes.  At
the longer chunks ``TILED_Q`` (128, 192 and 256 rows: the Pallas
kernel's own, Mamba2's 256), P = 64, N in {64, 128}, the chunk pass and
the chunk backward run on the tensor cores over 64 x 64 tiles — bf16 in
``ssd_chunk_tc_tiled`` and ``ssd_chunk_bwd_tc_tiled``
(:func:`tiled_shape`), fp32 in ``ssd_chunk_tf32_tiled`` and
``ssd_chunk_bwd_tf32_tiled`` (TF32, :func:`tf32_tiled_shape`) — and the
carry backward is ``ssd_carry_bwd_tc`` or ``ssd_carry_bwd_tf32``, which
walk a chunk in 64-row slabs.  The forward carry is
``ssd_carry_tc`` for bf16 C and ``ssd_carry_tf32`` for fp32 C at Q and N
multiples of 16 (where its layout fits a block).  Every other shape runs
on the CUDA cores in fp32 (``ssd_chunk_kernel``, ``ssd_carry_kernel``,
``ssd_carry_bwd``, ``ssd_chunk_bwd``): P other than 64, N other than 64
and 128, and chunks that are not a multiple of 64 (the models' chunk of
50 rows, prompts under 64 tokens).  A refused launch raises:
there is no fallback from one kernel to the other.
``FWD_KERNEL_LAUNCHES`` and ``BWD_KERNEL_LAUNCHES`` count each kernel's
launches.

Each library is compiled at first use with ``nvcc`` for ``sm_90a``
(``kernels/build.py``) and loaded with ``ctypes``; nothing is built when
this module is imported.  Both sources include ``csrc/ssd_mma.cuh``.
Build flags: ``-O3``, no fast-math, multiply-add contraction allowed —
the kernels are held to a tolerance against the plain version.
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
# TF32 products a product of the fp32 tensor-core kernels (hi·hi + hi·lo +
# lo·hi): the ``terms`` that asks for ``ssd_chunk_tf32`` (``kTf32Terms``
# in csrc/ssd.cu).
TF32_TERMS = 3
TC_Q, TC_P, TC_N = 64, 64, (64, 128)   # shapes the tensor-core kernels take
# Chunks the tensor-core kernels take over 64 x 64 tiles (bf16
# ``ssd_chunk_tc_tiled``, ``ssd_chunk_bwd_tc_tiled``; fp32
# ``ssd_chunk_tf32_tiled``, ``ssd_chunk_bwd_tf32_tiled``), at TC_P and TC_N.
TILED_Q = (128, 192, 256)
# Launches of each forward kernel through the wrappers below (the op's
# forward and its backward's chunk-state launch alike; reset them to 0 and
# read them back around a run).
FWD_KERNELS = ("ssd_chunk_kernel", "ssd_chunk_tc", "ssd_chunk_tf32",
               "ssd_chunk_tc_tiled", "ssd_chunk_tf32_tiled",
               "ssd_carry_kernel", "ssd_carry_tc", "ssd_carry_tf32")
FWD_KERNEL_LAUNCHES = dict.fromkeys(FWD_KERNELS, 0)


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [P] * 7 + [I] * 8 + [P]
    lib.ssd_chunk_launch.restype = ctypes.c_int
    for fn in (lib.ssd_carry_launch, lib.ssd_carry_core_launch):
        fn.argtypes = [P] * 7 + [I] * 8 + [P]
        fn.restype = ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [I] * 4
    lib.ssd_smem_bytes.restype = ctypes.c_int
    lib.ssd_carry_tc_smem_bytes.argtypes = [I] * 5
    lib.ssd_carry_tc_smem_bytes.restype = ctypes.c_int
    for fn in (lib.ssd_carry_plan, lib.ssd_carry_tf32_plan):
        fn.argtypes = [I] * 6 + [P]
        fn.restype = ctypes.c_int
    lib.ssd_chunk_tf32_smem_bytes.argtypes = [I] * 2
    lib.ssd_chunk_tf32_smem_bytes.restype = ctypes.c_int
    lib.ssd_chunk_tf32_heads.argtypes = [I] * 3
    lib.ssd_chunk_tf32_heads.restype = ctypes.c_int
    lib.ssd_chunk_tiled_smem_bytes.argtypes = [I] * 2
    lib.ssd_chunk_tiled_smem_bytes.restype = ctypes.c_int
    lib.ssd_chunk_tf32_tiled_smem_bytes.argtypes = [I] * 2
    lib.ssd_chunk_tf32_tiled_smem_bytes.restype = ctypes.c_int
    lib.ssd_chunk_tf32_tiled_heads.argtypes = [I] * 5
    lib.ssd_chunk_tf32_tiled_heads.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_carry_bwd_launch.argtypes = [P] * 9 + [I] * 8 + [P]
    lib.ssd_chunk_bwd_launch.argtypes = [P] * 13 + [I] * 9 + [P]
    lib.ssd_chunk_bwd_tiled_launch.argtypes = [P] * 14 + [I] * 8 + [P]
    lib.ssd_chunk_bwd_tiled_smem_bytes.argtypes = [I] * 2
    lib.ssd_chunk_bwd_tf32_tiled_smem_bytes.argtypes = [I] * 2
    lib.ssd_bwd_tc_smem_bytes.argtypes = [I] * 3
    lib.ssd_bwd_smem_bytes.argtypes = [I] * 4
    lib.ssd_chunk_bwd_tf32_smem_bytes.argtypes = [I] * 2
    lib.ssd_carry_bwd_tf32_smem_bytes.argtypes = [I]
    for fn in (lib.ssd_carry_bwd_launch, lib.ssd_chunk_bwd_launch,
               lib.ssd_chunk_bwd_tiled_launch,
               lib.ssd_chunk_bwd_tiled_smem_bytes,
               lib.ssd_chunk_bwd_tf32_tiled_smem_bytes,
               lib.ssd_bwd_tc_smem_bytes, lib.ssd_bwd_smem_bytes,
               lib.ssd_chunk_bwd_tf32_smem_bytes,
               lib.ssd_carry_bwd_tf32_smem_bytes):
        fn.restype = ctypes.c_int


CSRC = Path(__file__).resolve().parent / "csrc"
# Both sources include the mma.sync / ldmatrix / cp.async helpers: an edit
# there rebuilds both libraries.
HEADERS = (CSRC / "ssd_mma.cuh",)
LIB = CudaLibrary("ssd", CSRC / "ssd.cu", (), _bind, headers=HEADERS)
LIB_BWD = CudaLibrary("ssd_bwd", CSRC / "ssd_bwd.cu", (), _bind_bwd,
                      headers=HEADERS)

# bf16 terms of the backward tensor-core kernels' fp32 operands (g,
# h_prev, K o dt, the summed dC . B^T gradient, exp(cum) o C); the CPU
# emulation (tests/test_torch_ssd_bwd.py) picks the fewest that keep every
# output within half its bar.  csrc/ssd_bwd.cu's kBwdTerms is the same.
BWD_TERMS = 2
# Launches of each backward kernel through the wrappers below (reset them
# to 0 and read them back around a run): the CUDA-core kernels take the
# shapes the tensor-core ones (``_tc`` for bf16, :func:`tc_shape`;
# ``_tf32`` for fp32, :func:`tf32_shape`; at :func:`tiled_shape` and
# :func:`tf32_tiled_shape` the carries of the dtype and the ``_tiled``
# chunk kernels) do not.
BWD_KERNELS = ("ssd_carry_bwd", "ssd_chunk_bwd", "ssd_carry_bwd_tc",
               "ssd_chunk_bwd_tc", "ssd_carry_bwd_tf32", "ssd_chunk_bwd_tf32",
               "ssd_chunk_bwd_tc_tiled", "ssd_chunk_bwd_tf32_tiled")
# The chunk backward kernels over 64 x 64 tiles (their own C entry point,
# ``ssd_chunk_bwd_tiled_launch``).
TILED_BWD = ("ssd_chunk_bwd_tc_tiled", "ssd_chunk_bwd_tf32_tiled")
BWD_KERNEL_LAUNCHES = dict.fromkeys(BWD_KERNELS, 0)
# The tensor-core carry backward's ring depth and rows of N a block
# (kCarryStages and kCarryRows in csrc/ssd_bwd.cu).
CARRY_BWD_STAGES, CARRY_ROWS = 3, 32
# The longest chunk the kernels take, forward and backward.
MAX_CHUNK = 256
# What ssd_chunk_bwd takes: chunks of 1 to MAX_CHUNK rows, head widths
# P <= 64 (a multiple of 4), state sizes N a power of two from 8 to 128.
BWD_MAX_Q, BWD_MAX_P, BWD_N = MAX_CHUNK, 64, (8, 16, 32, 64, 128)
# Rows of the blocks the CUDA-core chunk kernel, the carry and the
# CUDA-core chunk backward walk a chunk in (kRows, kCarryTile and kBwdRows
# in csrc/).
CHUNK_ROWS = 64


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one block of the CUDA-core kernel, at R =
    min(Q, ``CHUNK_ROWS``) rows a block: dt, cum and dec_end [Q]; x
    [R,P], B and C [R,N+1], W [R,R+1], and y [R,P] where the chunk has
    more than one block; fp32 (as ``smem_floats`` in ``csrc/ssd.cu``)."""
    R = min(Q, CHUNK_ROWS)
    return 4 * (3 * Q + R * P * (2 if Q > R else 1) + 2 * R * (N + 1)
                + R * (R + 1))


def carry_smem_bytes(N: int, Q: int, c_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one carry block at its widest slice (16
    columns), R = min(Q, ``CHUNK_ROWS``) rows a tile: h_prev [N,16] and a
    tile of C transposed [N,R] in fp32, and two padded [R, N + 16 bytes]
    buffers of C as read (as ``carry_smem_bytes`` in ``csrc/ssd.cu``)."""
    size = 2 if c_dtype == torch.bfloat16 else 4
    R = min(Q, CHUNK_ROWS)
    return 4 * (N * 16 + N * (R + R % 2)) + 2 * R * (N + 16 // size) * size


# The tensor-core carries' rings and warps (kCarryTerms, kCarryPlanStages,
# kTermSlots and carry_tc_max_threads in csrc/ssd.cu): h_prev in three
# bf16 terms (``ssd_carry_tc``) or two TF32 planes, hi and lo
# (``ssd_carry_tf32``); at most 640 threads a block at the slices that
# decide whether a kernel takes a shape (16 or 8 columns).
CARRY_TERMS, CARRY_TF32_PLANES, CARRY_PLAN_STAGES = 3, 2, 3
CARRY_TERM_SLOTS, CARRY_TC_MAX_THREADS = 2, 640


def carry_tc_smem_bytes(N: int, Q: int, ps: int = 16, stages: int = 1,
                        c_dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one tensor-core carry block for C of
    ``c_dtype`` (``ssd_carry_tc`` for bf16, ``ssd_carry_tf32`` for fp32)
    with slices of ``ps`` columns and rings of ``stages`` (as
    ``carry_tc_smem_bytes`` in ``csrc/ssd.cu``): the rings' mbarriers; per
    stage a chunk (the state slice [N, ps + 4] fp32 and its last cum, 16
    bytes); the ``CARRY_TERM_SLOTS`` slots of h_prev's planes [N, ps] in
    C's type (three bf16 terms, or the TF32 hi and lo); and per MMA warp
    (one per 16 rows of R = min(Q, ``CHUNK_ROWS``)) per stage its rows of C
    [16, N + 8] in C's type, y_intra [16, ldy] and cum [16] fp32, ldy =
    ``ps`` + 8 (8 at ``ps`` = 8).  The defaults are the smallest plan, the
    size that decides whether the kernel takes a shape."""
    size = 2 if c_dtype == torch.bfloat16 else 4
    planes = CARRY_TERMS if size == 2 else CARRY_TF32_PLANES
    R = min(Q, CHUNK_ROWS)
    ldy = 8 if ps == 8 else ps + 8
    bars = ((2 * stages + 2 * CARRY_TERM_SLOTS) * 8 + 15) // 16 * 16
    chunk = N * (ps + 4) * 4 + 16
    terms = CARRY_TERM_SLOTS * planes * N * ps * size
    mma_stage = 16 * (N + 8) * size + 16 * (ldy + 1) * 4
    return bars + stages * chunk + terms + (R // 16) * stages * mma_stage


def carry_tc_threads(N: int, Q: int, ps: int = 16) -> int:
    """Threads of a tensor-core carry block (``ssd_carry_tc`` or
    ``ssd_carry_tf32``): a producer warp, the chain warps (each 32 values
    of h a lane: 64 // ``ps`` k16 steps of N, 4 at ``ps`` = 8) and one MMA
    warp per 16 rows of a tile."""
    kw = 4 if ps == 8 else 64 // ps
    return 32 * (1 + -(-(N // 16) // kw) + min(Q, CHUNK_ROWS) // 16)


def carry_tc_takes(c_dtype: torch.dtype, Q: int, P: int, N: int) -> bool:
    """Whether the tensor-core carry for C of ``c_dtype`` takes this shape
    (``carry_tc_fits`` in ``csrc/ssd.cu``): Q and N multiples of 16, and
    its smallest plan (a one-stage ring at 16-column slices, 8 where P is
    not a multiple of 16) within a block's shared memory and threads."""
    ps = 16 if P % 16 == 0 else 8
    return (Q % 16 == 0 and N % 16 == 0
            and carry_tc_smem_bytes(N, Q, ps, 1, c_dtype) <= MAX_SMEM_BYTES
            and carry_tc_threads(N, Q, ps) <= CARRY_TC_MAX_THREADS)


def carry_plan(y_dtype: torch.dtype, B: int, H: int, P: int, N: int,
               Q: int, c_dtype: torch.dtype = torch.bfloat16
               ) -> Optional[dict]:
    """The plan the tensor-core carry launches with for C of ``c_dtype``
    at this shape (on the current card; ``ssd_carry_tc`` for bf16,
    ``ssd_carry_tf32`` for fp32): columns a slice, ring stages, blocks,
    threads and shared-memory bytes; None where the shape takes the
    CUDA-core carry."""
    out = (ctypes.c_int * 5)()
    lib = LIB.load()
    entry = (lib.ssd_carry_plan if c_dtype == torch.bfloat16
             else lib.ssd_carry_tf32_plan)
    err = entry(DTYPES[y_dtype], B, H, P, N, Q, ctypes.addressof(out))
    if err == 1:
        return None
    check_launch(err, "SSD carry plan")
    return dict(zip(("ps", "stages", "blocks", "threads", "smem"), out))


def _check_max_chunk(chunk: int, what: str) -> None:
    if chunk > MAX_CHUNK:
        raise ValueError(f"the {what} takes chunks of up to {MAX_CHUNK} "
                         f"rows, got {chunk}")


def tc_shape(dtype: torch.dtype, Q: int, P: int, N: int) -> bool:
    """Whether the bf16 tensor-core kernels (``_tc``) take this chunk."""
    return dtype == torch.bfloat16 and Q == TC_Q and P == TC_P \
        and N in TC_N


def tiled_shape(dtype: torch.dtype, Q: int, P: int, N: int) -> bool:
    """Whether the bf16 tensor-core kernels over 64 x 64 tiles
    (``ssd_chunk_tc_tiled``, ``ssd_chunk_bwd_tc_tiled``) take this
    chunk."""
    return dtype == torch.bfloat16 and Q in TILED_Q and P == TC_P \
        and N in TC_N


def tf32_shape(dtype: torch.dtype, Q: int, P: int, N: int) -> bool:
    """Whether the fp32 tensor-core kernels (``_tf32``) take this chunk:
    fp32 at the bf16 ones' shapes."""
    return dtype == torch.float32 and Q == TC_Q and P == TC_P \
        and N in TC_N


def tf32_tiled_shape(dtype: torch.dtype, Q: int, P: int, N: int) -> bool:
    """Whether the fp32 tensor-core kernels over 64 x 64 tiles
    (``ssd_chunk_tf32_tiled``, ``ssd_chunk_bwd_tf32_tiled``) take this
    chunk: fp32 at :func:`tiled_shape`'s shapes."""
    return dtype == torch.float32 and Q in TILED_Q and P == TC_P \
        and N in TC_N


def fwd_kernels(dtype: torch.dtype, Q: int, P: int, N: int
                ) -> Tuple[str, str]:
    """(chunk, carry) forward kernels :func:`ssd_chunks_cuda` and
    :func:`ssd_carry_cuda` launch for x, B and C of ``dtype`` at this
    shape: ``ssd_chunk_tc`` where :func:`tc_shape` holds,
    ``ssd_chunk_tc_tiled`` where :func:`tiled_shape` does,
    ``ssd_chunk_tf32`` where :func:`tf32_shape` does,
    ``ssd_chunk_tf32_tiled`` where :func:`tf32_tiled_shape` does, else
    ``ssd_chunk_kernel``; where :func:`carry_tc_takes` holds (Q and N
    multiples of 16) ``ssd_carry_tc`` for bf16 C and ``ssd_carry_tf32``
    for fp32 C, else ``ssd_carry_kernel`` (as ``launch_carry`` in
    ``csrc/ssd.cu``)."""
    chunk = ("ssd_chunk_tc" if tc_shape(dtype, Q, P, N) else
             "ssd_chunk_tc_tiled" if tiled_shape(dtype, Q, P, N) else
             "ssd_chunk_tf32" if tf32_shape(dtype, Q, P, N) else
             "ssd_chunk_tf32_tiled" if tf32_tiled_shape(dtype, Q, P, N) else
             "ssd_chunk_kernel")
    carry = ("ssd_carry_kernel" if not carry_tc_takes(dtype, Q, P, N) else
             "ssd_carry_tc" if dtype == torch.bfloat16 else "ssd_carry_tf32")
    return chunk, carry


def chunk_tiled_smem_bytes(N: int, Q: int) -> int:
    """Dynamic shared memory of one ``ssd_chunk_tc_tiled`` block (as
    ``TiledSmem`` in ``csrc/ssd.cu``): the C·Bᵀ fragments of Q / 64 tiles
    (16 KiB each; a state task's slice of B fits there); C_I and B_J [64,
    N + 8] bf16, or the ring of two x tiles [64, 72] bf16, whichever is
    larger; dt and cum of the chunk for two heads, fp32."""
    setup, ring = 2 * TC_Q * (N + 8) * 2, 2 * TC_Q * (TC_P + 8) * 2
    return Q // TC_Q * 16384 + max(setup, ring) + 16 * Q


def chunk_tf32_tiled_smem_bytes(N: int, Q: int) -> int:
    """Dynamic shared memory of one ``ssd_chunk_tf32_tiled`` block (as
    ``Tf32TiledSmem`` in ``csrc/ssd.cu``; the same at N = 64 and 128): the
    C·Bᵀ fragments of Q / 64 tiles (16 KiB each) or a state task's fp32
    slice of B [Q, 68], whichever is larger; the 64-column pieces of C_I
    and B_J [64, 68] fp32, or the ring of two x tiles [64, 68] fp32 (the
    same size); dt and cum of the chunk for two heads, fp32."""
    return max(Q // TC_Q * 16384, Q * (TC_Q + 4) * 4) \
        + 2 * TC_Q * (TC_P + 4) * 4 + 16 * Q


def chunk_tf32_tiled_heads(pairs: int, Q: int, N: int, H: int,
                           sms: int) -> int:
    """Heads per ``ssd_chunk_tf32_tiled`` block
    (``tf32_tiled_heads_per_block`` in ``csrc/ssd.cu``) over ``pairs``
    (batch, chunk) pairs of Q rows on a card of ``sms`` SMs:
    :func:`tf32_heads` over its Q / 64 + N / 64 tasks a pair with two
    blocks an SM.  The outputs do not depend on it."""
    return tf32_heads(pairs * (Q // TC_Q + N // 64), H, 2 * sms)


def chunk_tf32_smem_bytes(N: int, G: int) -> int:
    """Dynamic shared memory of one ``ssd_chunk_tf32`` block with G heads
    (as ``tf32_smem_bytes`` in ``csrc/ssd.cu``): C and B [64, N + 4] and
    two x buffers [64, 68], fp32; dt, cum and dec_end [G, 64]."""
    return 4 * (2 * TC_Q * (N + 4) + 2 * TC_Q * (TC_P + 4) + 3 * G * TC_Q)


def tf32_heads(pairs: int, H: int, slots: int) -> int:
    """Heads per block of the fp32 tensor-core kernels over ``pairs``
    (batch, chunk) pairs when ``slots`` blocks fit the card at once (as
    ``tf32_heads`` in ``csrc/ssd_mma.cuh``): the divisor g of H up to 16
    that minimises ceil(blocks / slots)·(g + 1) — the grid's waves times a
    block's work, its g heads and about one head's more done once a block
    — the larger g on a tie."""
    best, cost = 1, None
    for g in range(1, 17):
        if H % g:
            continue
        c = -(-pairs * (H // g) // slots) * (g + 1)
        if cost is None or c <= cost:
            best, cost = g, c
    return best


def chunk_tf32_heads(pairs: int, H: int, sms: int) -> int:
    """Heads per ``ssd_chunk_tf32`` block (``tf32_heads_per_block`` in
    ``csrc/ssd.cu``) on a card of ``sms`` SMs: :func:`tf32_heads` with two
    blocks an SM.  The outputs do not depend on it."""
    return tf32_heads(pairs, H, 2 * sms)


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _check_tensors(device: torch.device, want: dict) -> None:
    """Each ``name: (tensor, shape, dtypes)`` has that shape, one of the
    dtypes and is contiguous on ``device``; None entries are skipped."""
    for name, (t, shape, dtypes) in want.items():
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes:
            raise ValueError(f"{name} must be {list(shape)} of {dtypes}, got "
                             f"{list(t.shape)} {t.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def ssd_chunks_cuda(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                    terms: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the chunk kernel on CUDA tensors: x [B,L,H,P] and Bm, Cm
    [B,L,N] of one dtype (fp32 or bf16), dt and cum [B,L,H] fp32, all
    contiguous.  Returns (y_intra [B,L,H,P], states [B,nc,H,N,P]), fp32,
    without synchronising.

    ``terms``: None takes the tensor-core kernel where it applies
    (:func:`fwd_kernels`: bf16 with ``TERMS`` bf16 terms, fp32 with
    ``TF32_TERMS`` TF32 products) and the CUDA-core kernel elsewhere; 0
    forces the CUDA-core kernel; for bf16 1-3 ask for ``ssd_chunk_tc``
    with that many terms (``ssd_chunk_tc_tiled``, at ``TILED_Q``, takes
    ``TERMS``), for fp32 ``TF32_TERMS`` for ``ssd_chunk_tf32`` (at
    ``TILED_Q`` ``ssd_chunk_tf32_tiled``)."""
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
    tiled = tiled_shape(x.dtype, chunk, P, N)
    tc = tc_shape(x.dtype, chunk, P, N) or tiled
    tf32_tiled = tf32_tiled_shape(x.dtype, chunk, P, N)
    tf32 = tf32_shape(x.dtype, chunk, P, N) or tf32_tiled
    if terms is None:
        terms = TERMS if tc else TF32_TERMS if tf32 else 0
    if terms and not (tc and terms in ((TERMS,) if tiled else (1, 2, 3))
                      or tf32 and terms == TF32_TERMS):
        raise ValueError(f"the tensor-core kernels take P = {TC_P}, N in "
                         f"{TC_N}: bf16 at Q = {TC_Q} with 1-3 terms and at "
                         f"Q in {TILED_Q} with {TERMS}, fp32 at Q = {TC_Q} "
                         f"and at Q in {TILED_Q} with {TF32_TERMS}; got "
                         f"terms={terms} for {x.dtype}, Q {chunk}, P {P}, "
                         f"N {N}")
    if terms:    # 16-byte cp.async copies
        _check_aligned(x=x, Bm=Bm, Cm=Cm)
    _check_max_chunk(chunk, "SSD chunk kernel")
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
    name = ("ssd_chunk_kernel" if not terms else
            "ssd_chunk_tf32_tiled" if tf32_tiled else
            "ssd_chunk_tf32" if tf32 else
            "ssd_chunk_tc_tiled" if tiled else "ssd_chunk_tc")
    check_launch(err, name)
    FWD_KERNEL_LAUNCHES[name] += 1
    return y, states


def ssd_carry_cuda(y_intra: torch.Tensor, states: torch.Tensor,
                   cum: torch.Tensor, Cm: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.float32,
                   cuda_cores: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the carry kernel on CUDA tensors: y_intra [B,L,H,P] and
    states [B,nc,H,N,P] fp32 (the chunk kernel's outputs), cum [B,L,H]
    fp32, Cm [B,L,N] fp32 or bf16, init_state [B,H,N,P] or None.  Returns
    (y [B,L,H,P] in ``out_dtype``, final state [B,H,N,P] fp32) without
    synchronising.  The kernel follows :func:`fwd_kernels`;
    ``cuda_cores`` forces ``ssd_carry_kernel``."""
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
    _check_max_chunk(chunk, "SSD carry kernel")
    if carry_smem_bytes(N, chunk, Cm.dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"the carry kernel's tiles do not fit shared "
                         f"memory at Q {chunk}, N {N}")
    f32 = (torch.float32,)
    _check_tensors(y_intra.device, {
        "y_intra": (y_intra, (Bsz, L, H, P), f32),
        "states": (states, (Bsz, nc, H, N, P), f32),
        "cum": (cum, (Bsz, L, H), f32),
        "Cm": (Cm, (Bsz, L, N), tuple(DTYPES)),
        "init_state": (init_state, (Bsz, H, N, P), f32)})
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
    lib = LIB.load()
    entry = lib.ssd_carry_core_launch if cuda_cores else lib.ssd_carry_launch
    err = entry(
        y_intra.data_ptr(), states.data_ptr(), cum.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), DTYPES[Cm.dtype], DTYPES[out_dtype],
        Bsz, L, H, P, N, chunk, stream)
    name = ("ssd_carry_kernel" if cuda_cores
            else fwd_kernels(Cm.dtype, chunk, P, N)[1])
    check_launch(err, name)
    FWD_KERNEL_LAUNCHES[name] += 1
    return y, final


def bwd_rows(Q: int) -> int:
    """Rows of the blocks ``ssd_chunk_bwd`` walks a chunk in:
    ``CHUNK_ROWS``, or the chunk rounded up to a multiple of 4 when
    shorter (as ``bwd_rows`` in ``csrc/ssd_bwd.cu``)."""
    return min(-(-Q // 4) * 4, CHUNK_ROWS)


def chunk_bwd_smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one ``ssd_chunk_bwd`` block at T =
    :func:`bwd_rows` rows a block (as ``ChunkBwdSmem`` in
    ``csrc/ssd_bwd.cu``): B and C of a block, C_i·B_jᵀ and the summed
    dC·Bᵀ gradient, x and dy of a block, and the union of g, h_prev, K, V
    and B_j, C_i row-major, rows padded by 4 floats; ten vectors of T and
    the group's 16 dcum tails."""
    T = bwd_rows(Q)
    ldq, ldn, ldp = T + 4, N + 4, P + 4
    union = max(N * ldp + P * ldn, 2 * T * ldq, 2 * T * ldn)
    return 4 * (2 * N * ldq + 2 * T * ldq + 2 * P * ldq + T * ldp + union
                + 10 * T + 16)


def carry_bwd_tc_smem_bytes(nc: int, c_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one ``ssd_carry_bwd_tc`` (bf16) or
    ``ssd_carry_bwd_tf32`` (fp32) block at ``nc`` chunks of any length
    they take, 64 to 256 rows (as ``CarryTcSmem`` in ``csrc/ssd_bwd.cu``):
    rings of ``CARRY_BWD_STAGES`` state slices [32, 64] fp32 and of 64-row
    slabs (C slices [64, 40] and dy tiles [64, 72] in C's type, cum
    columns [64] fp32); every chunk's exp(cum_last), padded to 16
    bytes."""
    size = 2 if c_dtype == torch.bfloat16 else 4
    S, NS = CARRY_BWD_STAGES, CARRY_ROWS
    return (S * NS * TC_P * 4 + S * TC_Q * (NS + 8) * size
            + S * TC_Q * (TC_P + 8) * size + S * TC_Q * 4
            + (nc * 4 + 15) // 16 * 16)


def chunk_bwd_tiled_smem_bytes(N: int, Q: int) -> int:
    """Dynamic shared memory of one ``ssd_chunk_bwd_tc_tiled`` block (as
    ``TiledBwdSmem`` in ``csrc/ssd_bwd.cu``): C_K and B_K [64, N + 8] bf16;
    two x_K and two dy_K buffers [64, 72] bf16; g and h_prev [N, 64] fp32,
    or the group's sums of dW∘E∘dt (Q / 64 tiles of 16 KiB), whichever is
    larger; a two-stage ring of the other row blocks' tiles (x or dy [64,
    72], B or C [64, N + 8], bf16); the staging tile [64, 68] fp32; dt and
    cum of the chunk for two heads, fp32; the per-head partial sums
    (12·64 + 8 floats)."""
    bc, xd = TC_Q * (N + 8) * 2, TC_Q * (TC_P + 8) * 2
    ghp = max(2 * N * TC_P * 4, Q // TC_Q * 16384)
    return (2 * bc + 4 * xd + ghp + 2 * (xd + bc) + TC_Q * (TC_Q + 4) * 4
            + 16 * Q + (12 * TC_Q + 8) * 4)


def chunk_bwd_tf32_tiled_smem_bytes(N: int, Q: int) -> int:
    """Dynamic shared memory of one ``ssd_chunk_bwd_tf32_tiled`` block (as
    ``Tf32TiledBwdSmem`` in ``csrc/ssd_bwd.cu``): C_K and B_K [64, N + 8]
    fp32; a two-stage ring of a head's pair of x and dy tiles [64, 64]
    fp32; a two-stage ring of another row block's C or B [64, N + 8] fp32
    (in the first phase g and h_prev [N, 64] fp32); the staging tile
    [64, 68] fp32; dt and cum of the chunk for two heads, fp32; the
    partial sums (12·64 + 8 floats)."""
    bc, xd = TC_Q * (N + 8) * 4, TC_Q * TC_P * 4
    return (4 * bc + 4 * xd + TC_Q * (TC_Q + 4) * 4 + 16 * Q
            + (12 * TC_Q + 8) * 4)


def chunk_bwd_tf32_smem_bytes(N: int, G: int) -> int:
    """Dynamic shared memory of one ``ssd_chunk_bwd_tf32`` block with G
    heads (as ``ChunkTf32Smem`` in ``csrc/ssd_bwd.cu``): C and B [64,
    N + 8] fp32; the (C·Bᵀ)ᵀ fragments (16 KiB); two x and two dy buffers
    [64, 64], one g and one h_prev [N, 64], fp32; dt and cum [G, 64]; the
    per-head partial sums (10·64 + 8 floats)."""
    return (2 * TC_Q * (N + 8) * 4 + 4 * 8 * 32 * 16 + 4 * TC_Q * TC_P * 4
            + 2 * N * TC_P * 4 + 2 * G * TC_Q * 4 + (10 * TC_Q + 8) * 4)


def bwd_kernels(dtype: torch.dtype, Q: int, P: int, N: int
                ) -> Tuple[str, str]:
    """(carry, chunk) backward kernels the wrappers launch for inputs of
    ``dtype`` at this shape: where the forward's tensor-core chunk kernels
    apply, the bf16 tensor-core pair (:func:`tc_shape`) or the fp32 one
    (:func:`tf32_shape`); at :func:`tiled_shape` and
    :func:`tf32_tiled_shape` the same carry backward of the dtype (in
    64-row slabs) and the tiled chunk backward of the dtype; else the
    CUDA-core pair."""
    if tc_shape(dtype, Q, P, N):
        return "ssd_carry_bwd_tc", "ssd_chunk_bwd_tc"
    if tiled_shape(dtype, Q, P, N):
        return "ssd_carry_bwd_tc", "ssd_chunk_bwd_tc_tiled"
    if tf32_tiled_shape(dtype, Q, P, N):
        return "ssd_carry_bwd_tf32", "ssd_chunk_bwd_tf32_tiled"
    if tf32_shape(dtype, Q, P, N):
        return "ssd_carry_bwd_tf32", "ssd_chunk_bwd_tf32"
    return "ssd_carry_bwd", "ssd_chunk_bwd"


def chunk_bwd_heads(kernel: str, pairs: int, H: int, sms: int,
                    Q: int = TC_Q) -> int:
    """Heads per block (and per dB, dC partial sum) of the chunk backward
    ``kernel`` (a name :func:`bwd_kernels` gives) over ``pairs`` (batch,
    chunk) pairs of ``Q`` rows on a card of ``sms`` SMs:
    ``ssd_chunk_bwd_tf32`` :func:`tf32_heads` with one block an SM (its
    shared memory), the tiled kernels (``TILED_BWD``)
    :func:`bwd_heads_per_block` over their Q / 64 blocks a pair, the
    others :func:`bwd_heads_per_block` over the pairs."""
    if kernel == "ssd_chunk_bwd_tf32":
        return tf32_heads(pairs, H, sms)
    if kernel in TILED_BWD:
        return bwd_heads_per_block(pairs * (Q // TC_Q), H, sms)
    return bwd_heads_per_block(pairs, H, sms)


def bwd_heads_per_block(pairs: int, H: int, sms: int) -> int:
    """Heads per ``ssd_chunk_bwd`` block (one block per SM fits its
    shared memory): the largest divisor of H up to 16 that still gives
    two blocks per SM, on a card of ``sms`` SMs, over ``pairs`` (batch,
    chunk) pairs.  The grouping sets the order dB and dC are summed in,
    so it follows the card's SM count."""
    for g in (16, 8, 4, 2):
        if H % g == 0 and pairs * (H // g) >= 2 * sms:
            return g
    return 1


def ssd_carry_bwd_cuda(states: torch.Tensor, cum: torch.Tensor,
                       Cm: torch.Tensor, dy: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor] = None,
                       dfinal: Optional[torch.Tensor] = None,
                       cuda_cores: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the carry backward on CUDA tensors: states [B,nc,H,N,P]
    fp32 (the chunk kernel's), cum [B,L,H] fp32, Cm [B,L,N] and dy
    [B,L,H,P] of one dtype (fp32 or bf16), init_state and dfinal
    [B,H,N,P] fp32 or None (zeros).  Returns (h_prev, g [B,nc,H,N,P],
    d init_state [B,H,N,P]), fp32, as ``ref.ssd_carry_bwd_ref``, without
    synchronising.

    The kernel follows :func:`bwd_kernels`: ``ssd_carry_bwd_tc`` for bf16
    and ``ssd_carry_bwd_tf32`` for fp32 at the tensor-core shapes and at
    ``TILED_Q`` (P 64, N 64 or 128), ``ssd_carry_bwd`` otherwise or when
    ``cuda_cores`` is set.  A launch
    the kernel refuses (a decay table of the chunks beyond its shared
    memory) raises."""
    if states.dim() != 5 or states.device.type != "cuda":
        raise ValueError(f"ssd_carry_bwd_cuda needs CUDA states [B, nc, H, "
                         f"N, P], got {list(states.shape)} on "
                         f"{states.device}")
    Bsz, nc, H, N, P = states.shape
    L = nc * chunk
    if check_chunk(cum.shape[1], chunk) != nc:
        raise ValueError(f"cum has {cum.shape[1]} steps, states {nc} chunks "
                         f"of {chunk}")
    if P % 8 or N % 8 or N > 256:
        raise ValueError(f"ssd_carry_bwd takes P and N multiples of 8, N up "
                         f"to 256; got P {P}, N {N}")
    _check_max_chunk(chunk, "SSD carry backward")
    slice_p = 16 if P % 16 == 0 else 8
    if 4 * chunk * (N + slice_p) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk}, N {N}: C and dy's slice do not fit "
                         f"a block's shared memory")
    if H > MAX_GRID_YZ or Bsz > MAX_GRID_YZ:
        raise ValueError(f"unsupported shape {list(states.shape)}")
    if Cm.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {Cm.dtype}")
    f32 = (torch.float32,)
    _check_tensors(states.device, {
        "states": (states, (Bsz, nc, H, N, P), f32),
        "cum": (cum, (Bsz, L, H), f32),
        "Cm": (Cm, (Bsz, L, N), (Cm.dtype,)),
        "dy": (dy, (Bsz, L, H, P), (Cm.dtype,)),
        "init_state": (init_state, (Bsz, H, N, P), f32),
        "dfinal": (dfinal, (Bsz, H, N, P), f32)})
    _check_aligned(states=states, init_state=init_state,  # 16-byte loads
                   dfinal=dfinal)
    name = "ssd_carry_bwd" if cuda_cores else bwd_kernels(Cm.dtype, chunk,
                                                          P, N)[0]
    tc = name != "ssd_carry_bwd"
    if tc:
        _check_aligned(Cm=Cm, dy=dy)   # cp.async copies
    h_prev = torch.empty_like(states)
    g = torch.empty_like(states)
    dinit = torch.empty((Bsz, H, N, P), dtype=torch.float32,
                        device=states.device)
    stream = torch.cuda.current_stream(states.device).cuda_stream
    err = LIB_BWD.load().ssd_carry_bwd_launch(
        states.data_ptr(), cum.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), h_prev.data_ptr(),
        g.data_ptr(), dinit.data_ptr(), DTYPES[Cm.dtype], Bsz, L, H, P, N,
        chunk, int(tc), stream)
    check_launch(err, name)
    BWD_KERNEL_LAUNCHES[name] += 1
    return h_prev, g, dinit


def ssd_chunk_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                       g: torch.Tensor, h_prev: torch.Tensor, chunk: int,
                       cuda_cores: bool = False):
    """Launch the chunk backward on CUDA tensors: x, dy [B,L,H,P] and
    Bm, Cm [B,L,N] of one dtype (fp32 or bf16), dt and cum [B,L,H] fp32,
    g and h_prev [B,nc,H,N,P] fp32 (:func:`ssd_carry_bwd_cuda`'s).
    Returns (dx [B,L,H,P], dcum [B,L,H], ddt [B,L,H], dB, dC
    [groups,B,L,N]), fp32, as ``ref.ssd_chunk_bwd_ref`` with
    :func:`chunk_bwd_heads`'s heads per group on x's card, without
    synchronising.  The kernel follows :func:`bwd_kernels`:
    ``ssd_chunk_bwd_tc`` for bf16 and ``ssd_chunk_bwd_tf32`` for fp32 at
    the tensor-core shapes, ``ssd_chunk_bwd_tc_tiled`` for bf16 and
    ``ssd_chunk_bwd_tf32_tiled`` for fp32 at ``TILED_Q`` (each of their row
    blocks writes its terms of the chunk's dcum_last apart, and they are
    added to the last row here in a fixed order), ``ssd_chunk_bwd``
    otherwise or when ``cuda_cores`` is set."""
    if x.dim() != 4 or x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd_cuda needs a CUDA x [B, L, H, P], "
                         f"got {list(x.shape)} on {x.device}")
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = check_chunk(L, chunk)
    if chunk > BWD_MAX_Q or P % 4 or P > BWD_MAX_P or N not in BWD_N:
        raise ValueError(f"ssd_chunk_bwd takes chunks of up to {BWD_MAX_Q} "
                         f"rows, head widths that are multiples of 4 up to "
                         f"{BWD_MAX_P}, and N in {BWD_N}; got Q {chunk}, "
                         f"P {P}, N {N}")
    if x.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    name = "ssd_chunk_bwd" if cuda_cores else bwd_kernels(x.dtype, chunk, P,
                                                          N)[1]
    tc = name != "ssd_chunk_bwd"
    tiled = name in TILED_BWD
    G = chunk_bwd_heads(
        name, Bsz * nc, H,
        torch.cuda.get_device_properties(x.device).multi_processor_count,
        chunk)
    if not tc and chunk_bwd_smem_bytes(chunk, N, P) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk}, N {N}, P {P} need "
                         f"{chunk_bwd_smem_bytes(chunk, N, P)} bytes of "
                         f"shared memory, above {MAX_SMEM_BYTES}")
    if H // G > MAX_GRID_YZ or Bsz > MAX_GRID_YZ:
        raise ValueError(f"unsupported shape {list(x.shape)}")
    f32 = (torch.float32,)
    _check_tensors(x.device, {
        "x": (x, (Bsz, L, H, P), (x.dtype,)),
        "dt": (dt, (Bsz, L, H), f32), "cum": (cum, (Bsz, L, H), f32),
        "Bm": (Bm, (Bsz, L, N), (x.dtype,)),
        "Cm": (Cm, (Bsz, L, N), (x.dtype,)),
        "dy": (dy, (Bsz, L, H, P), (x.dtype,)),
        "g": (g, (Bsz, nc, H, N, P), f32),
        "h_prev": (h_prev, (Bsz, nc, H, N, P), f32)})
    if tc:    # 16-byte cp.async copies
        _check_aligned(x=x, Bm=Bm, Cm=Cm, dy=dy, g=g, h_prev=h_prev)
    dx = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=x.device)
    dcum = torch.empty((Bsz, L, H), dtype=torch.float32, device=x.device)
    ddt = torch.empty_like(dcum)
    dB = torch.empty((H // G, Bsz, L, N), dtype=torch.float32,
                     device=x.device)
    dC = torch.empty_like(dB)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), g.data_ptr(), h_prev.data_ptr(),
            dx.data_ptr(), dcum.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
            dC.data_ptr())
    if tiled:
        tails = torch.empty((Bsz, nc, chunk // TC_Q, H), dtype=torch.float32,
                            device=x.device)
        err = LIB_BWD.load().ssd_chunk_bwd_tiled_launch(
            *ptrs, tails.data_ptr(), DTYPES[x.dtype], Bsz, L, H, P, N, chunk,
            G, stream)
    else:
        err = LIB_BWD.load().ssd_chunk_bwd_launch(
            *ptrs, DTYPES[x.dtype], Bsz, L, H, P, N, chunk, G, int(tc),
            stream)
    check_launch(err, name)
    BWD_KERNEL_LAUNCHES[name] += 1
    if tiled:
        dcum.view(Bsz, nc, chunk, H)[:, :, -1] += tails.sum(2)
    return dx, dcum, ddt, dB, dC
