"""Dispatch for the SSD scan: the CUDA chunk and carry kernels, or the
plain torch version, chosen by the device the tensors lie on.

On a CUDA tensor, :func:`ssd` computes the chunk cumsum, launches the
chunk kernel for the intra-chunk term and the chunk states (on the
tensor cores at P = 64, N in {64, 128}: for bf16 ``ssd_chunk_tc`` at
Q = 64 and ``ssd_chunk_tc_tiled`` at Q = 128, 192 and 256, for fp32
``ssd_chunk_tf32`` at Q = 64 and ``ssd_chunk_tf32_tiled`` at Q = 128,
192 and 256; else ``ssd_chunk_kernel`` on the CUDA cores), then the carry kernel (at Q and N multiples of 16 on the tensor
cores: ``ssd_carry_tc`` for bf16 C, ``ssd_carry_tf32`` for fp32 C; else
``ssd_carry_kernel``), which walks
the chunks in order and writes y in x's dtype and the final state; the
reference keeps that carry in jnp outside its Pallas kernel.  On a CPU
tensor it runs ``ref.ssd_ref``, which autograd differentiates.  There is
no fallback from one to the other.

Every launch goes through an operator (``torch.library.custom_op``) with
a fake, so that the dry run (``launch/dryrun.py``) traces the card's
path under ``FakeTensorMode`` without launching, and with a flop formula
(``torch.utils.flop_counter``):

* ``repro_torch::ssd_fwd``, the two forward launches, with and without
  grad.  Under grad its gradient is registered.  It saves x, dt, A, B, C
  and the initial state, not the chunk states.
* ``repro_torch::ssd_bwd`` (:func:`ssd_bwd`), the gradient: the chunk
  kernel once more for the chunk states, then the carry backward (h_prev
  and the state gradients, two walks over the chunks) and the chunk
  backward (each chunk's gradients) from ``csrc/ssd_bwd.cu`` — at the
  models' shapes (Q = P = 64, N in {64, 128}) for bf16 the tensor-core
  ``ssd_carry_bwd_tc`` and ``ssd_chunk_bwd_tc``, for fp32 the TF32
  ``ssd_carry_bwd_tf32`` and ``ssd_chunk_bwd_tf32``; at Q = 128, 192
  and 256 (P = 64, N in {64, 128}) the same carry backward of the dtype
  (``ssd_carry_bwd_tc`` or ``ssd_carry_bwd_tf32``, walking each chunk in
  64-row slabs) and the tensor-core ``ssd_chunk_bwd_tc_tiled`` (bf16) or
  ``ssd_chunk_bwd_tf32_tiled`` (fp32); else
  the CUDA-core ``ssd_carry_bwd`` and ``ssd_chunk_bwd``
  (``kernel.bwd_kernels``) — and
  it finishes in torch: dB and dC summed over the kernel's head groups in
  a fixed order, the cumsum's gradient (ddt += A·da, dA = Σ dt·da).

The backward kernels take chunks of up to ``kernel.BWD_MAX_Q`` rows, and
:func:`ssd` refuses a longer one under grad.  As one operator the
forward is seen by selective activation checkpointing
(``models/layers.py``'s ``remat="dots"``), which keeps its outputs
instead of launching it again in the backward.

Flops, per (batch, head, chunk) of Q rows, with N the state width and P
the head width (:func:`ssd_fwd_flops`, :func:`ssd_bwd_flops`): the chunk
pass 2Q²N + 2Q²P + 2QNP (C·Bᵀ, its decayed product with x, the chunk
state Bᵀ·x), the carry 2·N per y element (C·h_prev: 2QNP).  The backward
counts the products its three launches issue: the chunk pass again for
the states; the carry backward's (exp(cum) ∘ C)ᵀ·dy, 2QNP; the chunk
backward's x·dyᵀ, (K ∘ dt)ᵀ·dy, B·g, x·gᵀ and dy·h_prevᵀ, 4Q²P + 6QNP,
and once per block of G heads (``kernel.chunk_bwd_heads``) C·Bᵀ and
the head-summed (dW ∘ E ∘ dt)ᵀ against C and B, 6Q²N
(``ssd_chunk_bwd_tc_tiled`` forms C·Bᵀ per head over its tiles, 2Q²N a
head, and the two products once per block, 4Q²N).  Elementwise work
(decays, cumsums, row sums) is not counted.

``LAUNCHES`` counts the forward's chunk-kernel launches,
``CARRY_LAUNCHES`` its carry-kernel launches and ``BWD_LAUNCHES``
backward passes (each launches the chunk kernel once for the states, and
each backward kernel once); ``kernel.FWD_KERNEL_LAUNCHES`` and
``kernel.BWD_KERNEL_LAUNCHES`` count each kernel by name.

:func:`ssd_decode` is the single-token recurrence; the reference has no
kernel for it, so its torch ops are the port on every device.
"""
# No ``from __future__ import annotations``: ``custom_op`` reads the
# operator's schema from the annotations.
from typing import Optional, Tuple

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from .ref import chunk_cumsum, chunk_cumsum_bwd, ssd_decode_ref, ssd_ref

# Kernel launches made through this module (reset them to 0 and read them
# back around a run).
LAUNCHES = 0          # the chunk kernel, in the forward
CARRY_LAUNCHES = 0    # the carry kernel
BWD_LAUNCHES = 0      # backward passes


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_inputs_dtype(x, Bm, Cm) -> torch.dtype:
    """The dtype :func:`_kernel_inputs` gives x, B and C."""
    return x.dtype if Bm.dtype == Cm.dtype == x.dtype else torch.float32


def _kernel_inputs(x, dt, Bm, Cm):
    """x, B and C in one dtype (fp32 holds any of them exactly when they
    differ) and dt in fp32, dense, as the kernels read them."""
    dtype = _kernel_inputs_dtype(x, Bm, Cm)
    x, Bm, Cm = (t.to(dtype) for t in (x, Bm, Cm))
    return _dense(x), dt.float().contiguous(), _dense(Bm), _dense(Cm)


@torch.library.custom_op("repro_torch::ssd_fwd", mutates_args=())
def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
            init_state: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk and carry kernels as one operator: (y [B,L,H,P] in x's
    dtype, final state fp32 [B,H,N,P]).  CUDA tensors only."""
    global LAUNCHES, CARRY_LAUNCHES
    from .kernel import ssd_carry_cuda, ssd_chunks_cuda
    out_dtype = x.dtype
    x, dt, Bm, Cm = _kernel_inputs(x, dt, Bm, Cm)
    cum = chunk_cumsum(dt, A, chunk)
    y_intra, states = ssd_chunks_cuda(x, dt, cum, Bm, Cm, chunk)
    LAUNCHES += 1
    if init_state is not None:
        init_state = _dense(init_state.float())
    y, final = ssd_carry_cuda(y_intra, states, cum, Cm, chunk, init_state,
                              out_dtype)
    CARRY_LAUNCHES += 1
    return y, final


@ssd_fwd.register_fake
def _(x, dt, A, Bm, Cm, chunk, init_state):
    Bsz, _, H, P = x.shape
    return (torch.empty_like(x),
            x.new_empty((Bsz, H, Bm.shape[-1], P), dtype=torch.float32))


def _check_bwd_chunk(chunk: int) -> None:
    from .kernel import BWD_MAX_Q
    if chunk > BWD_MAX_Q:
        raise ValueError(f"the SSD backward kernels take chunks of up to "
                         f"{BWD_MAX_Q} rows, got {chunk}")


@torch.library.custom_op("repro_torch::ssd_bwd", mutates_args=())
def _ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
             chunk: int, init_state: Optional[torch.Tensor],
             dfinal: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward launches as one operator: (dx, ddt, dA, dB, dC in
    their inputs' dtypes, d init_state fp32 [B,H,N,P]).  CUDA tensors
    only."""
    global BWD_LAUNCHES
    from . import kernel
    xk, dtk, Bk, Ck = _kernel_inputs(x, dt, Bm, Cm)
    cum = chunk_cumsum(dtk, A, chunk)
    _, states = kernel.ssd_chunks_cuda(xk, dtk, cum, Bk, Ck, chunk)
    dyk = _dense(dy.to(xk.dtype))
    init = None if init_state is None else _dense(init_state.float())
    if dfinal is not None:
        dfinal = _dense(dfinal.float())
    h_prev, g, dinit = kernel.ssd_carry_bwd_cuda(states, cum, Ck, dyk,
                                                 chunk, init, dfinal)
    del states
    dx, dcum, ddt, dB, dC = kernel.ssd_chunk_bwd_cuda(xk, dtk, cum, Bk, Ck,
                                                      dyk, g, h_prev, chunk)
    ddt_cum, dA = chunk_cumsum_bwd(dcum, dtk, A, chunk)
    BWD_LAUNCHES += 1
    return (dx.to(x.dtype), (ddt + ddt_cum).to(dt.dtype), dA.to(A.dtype),
            dB.sum(0).to(Bm.dtype), dC.sum(0).to(Cm.dtype), dinit)


@_ssd_bwd.register_fake
def _(x, dt, A, Bm, Cm, dy, chunk, init_state, dfinal):
    Bsz, _, H, P = x.shape
    return (x.new_empty(x.shape), dt.new_empty(dt.shape),
            A.new_empty(A.shape), Bm.new_empty(Bm.shape),
            Cm.new_empty(Cm.shape),
            x.new_empty((Bsz, H, Bm.shape[-1], P), dtype=torch.float32))


def ssd_bwd(x, dt, A, Bm, Cm, dy, chunk, init_state=None, dfinal=None):
    """The gradient of :func:`ssd` on CUDA tensors for dy (y's) and dfinal
    (the final state's; None is zeros): (dx, ddt, dA, dB, dC,
    d init_state), each in its input's dtype (None without an
    init_state), through the operator ``repro_torch::ssd_bwd``; see the
    module docstring for the launches."""
    _check_bwd_chunk(chunk)
    *grads, dinit = _ssd_bwd(x, dt, A, Bm, Cm, dy, chunk, init_state,
                             dfinal)
    return (*grads,
            None if init_state is None else dinit.to(init_state.dtype))


# H100 SXM's SM count: the head grouping the backward's flops follow on a
# device that is not a card (``kernel.bwd_heads_per_block``).
H100_SMS = 132


def ssd_fwd_flops(Bsz: int, L: int, H: int, P: int, N: int,
                  chunk: int) -> int:
    """The forward's flops (module docstring): chunk pass and carry."""
    nc = math.ceil(L / chunk)
    Q = chunk
    return (Bsz * H * nc * (2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * N * P)
            + 2 * N * Bsz * L * H * P)


def ssd_bwd_flops(Bsz: int, L: int, H: int, P: int, N: int, chunk: int,
                  sms: int = H100_SMS, dtype: torch.dtype = torch.bfloat16
                  ) -> int:
    """The backward's flops (module docstring): the chunk pass for the
    states, the carry backward's and the chunk backward's products, the
    last with the groups of heads ``kernel.chunk_bwd_heads`` gives the
    chunk backward for inputs of ``dtype`` on a card of ``sms`` SMs.
    ``ssd_chunk_bwd_tc_tiled`` forms C·Bᵀ per head and tile (2Q²N a head)
    and multiplies the group's summed dW∘E∘dt with C and B once a group
    (4Q²N); the other kernels do all three products once a group."""
    from .kernel import bwd_kernels, chunk_bwd_heads
    nc = math.ceil(L / chunk)
    Q = chunk
    name = bwd_kernels(dtype, Q, P, N)[1]
    G = chunk_bwd_heads(name, Bsz * nc, H, sms, Q)
    per_head = ((2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * N * P)
                + 2 * Q * N * P + 4 * Q * Q * P + 6 * Q * N * P)
    if name == "ssd_chunk_bwd_tc_tiled":
        return Bsz * nc * (H * (per_head + 2 * Q * Q * N)
                           + (H // G) * 4 * Q * Q * N)
    return Bsz * nc * (H * per_head + (H // G) * 6 * Q * Q * N)


@register_flop_formula(torch.ops.repro_torch.ssd_fwd)
def _fwd_flops(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk,
               *args, **kwargs) -> int:
    Bsz, L, H, P = x_shape
    return ssd_fwd_flops(Bsz, L, H, P, B_shape[-1], chunk)


@register_flop_formula(torch.ops.repro_torch.ssd_bwd, get_raw=True)
def _bwd_flops(x, dt, A, Bm, Cm, dy, chunk, *args, **kwargs) -> int:
    Bsz, L, H, P = x.shape
    sms = (torch.cuda.get_device_properties(x.device).multi_processor_count
           if x.device.type == "cuda" else H100_SMS)
    return ssd_bwd_flops(Bsz, L, H, P, Bm.shape[-1], chunk, sms,
                         _kernel_inputs_dtype(x, Bm, Cm))


def _setup_context(ctx, inputs, output):
    x, dt, A, Bm, Cm, chunk, init_state = inputs
    ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
    ctx.chunk = chunk


def _backward(ctx, dy, dfinal):
    x, dt, A, Bm, Cm, init_state = ctx.saved_tensors
    dx, ddt, dA, dB, dC, dinit = ssd_bwd(x, dt, A, Bm, Cm, dy, ctx.chunk,
                                         init_state, dfinal)
    return dx, ddt, dA, dB, dC, None, dinit


ssd_fwd.register_autograd(_backward, setup_context=_setup_context)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64,
        init_state: Optional[torch.Tensor] = None,
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See ``ref.ssd_ref`` for shapes: (y in x's dtype, final state fp32)."""
    device = x.device
    if device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
    if device.type != "cuda":
        raise ValueError(f"ssd has no path for device {device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        _check_bwd_chunk(chunk)
    return ssd_fwd(x, dt, A, Bm, Cm, chunk, init_state)


def ssd_decode(x, dt, A, Bm, Cm, state):
    return ssd_decode_ref(x, dt, A, Bm, Cm, state)
