"""Dispatch for the affinity scoring: CUDA kernel or plain torch version,
chosen by the device the tensors lie on.

Three entry points share one core:

* :func:`affinity` — one scheduling cycle, ``[T, V]`` pair arrays.
* :func:`affinity_batch` — a whole grid of independent simulations'
  cycles, ``[B, T, V]``, on nine separate tensors.
* :func:`affinity_round` — the same batched scoring on a packed round
  (:class:`PackedRound`): what ``core.cycles.multi_cycle`` drives.  The
  nine host arrays of a round sit in one buffer at the round's own
  shape, so a round on the card is one host-to-device copy, one launch,
  one copy of the four packed outputs back and one wait.

A CUDA tensor goes to the kernel (``kernel.affinity_cuda``,
``kernel.launch_packed``), a CPU tensor to the plain version
(``ref.affinity_ref``); there is no fallback from one to the other.
``LAUNCHES`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

from math import prod
from typing import Dict, List, Tuple

import numpy as np
import torch

from .ref import AffinityOut, affinity_ref, folded_scalars

# Kernel launches made through this module (reset it to 0 and read it
# back around a run).
LAUNCHES = 0


def affinity_batch(size_mi, out_mb, budget, missing_mb, cont_ms, tier,
                   vm_mips, vm_bw, vm_price, gs_read: float, gs_write: float,
                   bp_ms: float) -> AffinityOut:
    """Batched affinity: every array carries a leading simulation dim ``B``.

    Task arrays are ``[B, T]``, pair arrays ``[B, T, V]``, VM arrays
    ``[B, V]`` (members may pool different VM fleets).  Inert members pad
    with ``tier = 0`` rows, which are infeasible by construction.
    """
    global LAUNCHES
    device = missing_mb.device
    if device.type == "cuda":
        from .kernel import affinity_cuda
        out = affinity_cuda(size_mi, out_mb, budget, missing_mb, cont_ms,
                            tier, vm_mips, vm_bw, vm_price, gs_read,
                            gs_write, bp_ms)
        LAUNCHES += 1
        return out
    if device.type == "cpu":
        return affinity_ref(size_mi, out_mb, budget, missing_mb, cont_ms,
                            tier, vm_mips, vm_bw, vm_price, gs_read,
                            gs_write, bp_ms)
    raise ValueError(f"affinity has no path for device {device}")


def affinity(size_mi, out_mb, budget, missing_mb, cont_ms, tier,
             vm_mips, vm_bw, vm_price, gs_read: float, gs_write: float,
             bp_ms: float) -> AffinityOut:
    """One cycle: task arrays ``[T]``, pair arrays ``[T, V]``, VM arrays
    ``[V]`` — :func:`affinity_batch` at ``B = 1``."""
    out = affinity_batch(*(a.unsqueeze(0) for a in (
        size_mi, out_mb, budget, missing_mb, cont_ms, tier, vm_mips, vm_bw,
        vm_price)), gs_read, gs_write, bp_ms)
    return AffinityOut(*(o[0] for o in out))


# ---------------------------------------------------------------------------
# Packed rounds
# ---------------------------------------------------------------------------

ALIGN = 16      # byte alignment of every array inside a packed round
# The nine arrays in order: size, out_mb, budget [B, T]; missing, cont,
# tier [B, T, V]; mips, bw, price [B, V].  All 32-bit.
DTYPES = (torch.float32,) * 5 + (torch.int32,) + (torch.float32,) * 3
# Inert padding: budget -1 and tier 0 make a pair infeasible; mips, bw and
# price 1 keep every division finite.
INERT = (0.0, 0.0, -1.0, 0.0, 0.0, 0, 1.0, 1.0, 1.0)


def round_shapes(B: int, T: int, V: int) -> Tuple[Tuple[int, ...], ...]:
    return ((B, T),) * 3 + ((B, T, V),) * 3 + ((B, V),) * 3


def round_layout(B: int, T: int, V: int) -> Tuple[Tuple[int, ...], int]:
    """Byte offsets of the nine arrays of a ``[B, T, V]`` round packed
    back to back, each at a 16-byte boundary, and the round's bytes."""
    offsets, n = [], 0
    for shape in round_shapes(B, T, V):
        offsets.append(n)
        n += -(-4 * prod(shape) // ALIGN) * ALIGN
    return tuple(offsets), n


class RoundView:
    """The nine arrays of one ``[B, T, V]`` round, laid out at the round's
    own shape at the front of its :class:`PackedRound`'s buffer.

    ``tensors`` are the host tensors (page-locked for a CUDA bucket),
    ``arrays`` their numpy views, which the auction writes through.  On a
    CUDA bucket the view also holds the slices and kernel arguments its
    round needs, made once, so a round allocates nothing."""

    __slots__ = ("bucket", "shape", "nbytes", "tensors", "arrays",
                 "outputs", "copy_in", "copy_out", "in_ptrs", "out_ptrs")

    def __init__(self, bucket: "PackedRound", B: int, T: int, V: int):
        self.bucket = bucket
        self.shape = (B, T, V)
        offsets, self.nbytes = round_layout(B, T, V)
        host = bucket.host
        self.tensors = tuple(
            host[off:off + 4 * prod(shape)].view(dtype).view(shape)
            for off, shape, dtype in zip(offsets, round_shapes(B, T, V),
                                         DTYPES))
        self.arrays = tuple(t.numpy() for t in self.tensors)
        if bucket.dev is None:
            return
        BT = B * T
        self.copy_in = (bucket.dev[:self.nbytes], host[:self.nbytes])
        self.copy_out = (bucket.out_host[:4 * BT], bucket.out_dev[:4 * BT])
        base = bucket.dev.data_ptr()
        self.in_ptrs = tuple(base + off for off in offsets)
        out = bucket.out_dev.data_ptr()
        self.out_ptrs = tuple(out + 4 * BT * i for i in range(4))
        flat = bucket.out_host.numpy()
        self.outputs = (flat[:BT].reshape(B, T),
                        flat[BT:2 * BT].reshape(B, T),
                        flat[2 * BT:3 * BT].view(np.float32).reshape(B, T),
                        flat[3 * BT:4 * BT].view(np.float32).reshape(B, T))

    def reset(self) -> None:
        """Fill every array of the round with inert padding."""
        for a, value in zip(self.arrays, INERT):
            a.fill(value)


class PackedRound:
    """A resident buffer for auction rounds up to ``[Bp, Tp, Vp]``.

    One host allocation holds the nine arrays of a round (page-locked on
    a CUDA device); a CUDA bucket also keeps one device buffer of the
    same size, a packed 32-bit device buffer for the four ``[B, T]``
    outputs, its page-locked host twin and one event, all allocated and
    checked once, here.  :meth:`view` lays a smaller round out at its own
    shape, so its copy moves its own bytes, not the bucket's."""

    def __init__(self, Bp: int, Tp: int, Vp: int, device: torch.device):
        cuda = device.type == "cuda"
        if cuda and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.shape = (Bp, Tp, Vp)
        self.device = device
        nbytes = round_layout(Bp, Tp, Vp)[1]
        self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
        self.dev = self.out_dev = self.out_host = self.event = None
        self._views: Dict[Tuple[int, int, int], RoundView] = {}
        if cuda:
            from .kernel import check_packed
            self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
            self.out_dev = torch.empty(4 * Bp * Tp, dtype=torch.int32,
                                       device=device)
            self.out_host = torch.empty(4 * Bp * Tp, dtype=torch.int32,
                                        pin_memory=True)
            self.event = torch.cuda.Event()
            check_packed(self)
        elif device.type != "cpu":
            raise ValueError(f"affinity has no path for device {device}")

    def view(self, B: int, T: int, V: int) -> RoundView:
        """The round ``[B, T, V]`` (within the bucket) at its own layout;
        made once per shape."""
        v = self._views.get((B, T, V))
        if v is None:
            Bp, Tp, Vp = self.shape
            if B > Bp or T > Tp or V > Vp:
                raise ValueError(f"round {[B, T, V]} exceeds the bucket "
                                 f"{list(self.shape)}")
            v = self._views[(B, T, V)] = RoundView(self, B, T, V)
        return v


def affinity_round(view: RoundView, gs_read: float, gs_write: float,
                   bp_ms: float) -> List[np.ndarray]:
    """Score a staged round; return ``best_vm``, ``best_tier``,
    ``est_finish`` and ``est_cost`` as ``[B, T]`` host numpy arrays.

    On a CUDA bucket: one asynchronous copy of the round's bytes to the
    card, one kernel launch writing the packed outputs, one copy of them
    back to page-locked memory, and one wait on the bucket's event.  The
    returned arrays are views of the bucket's output buffer, valid until
    its next round.  On the CPU the plain version scores the same
    views."""
    global LAUNCHES
    bucket = view.bucket
    if bucket.dev is None:
        res = affinity_ref(*view.tensors, gs_read, gs_write, bp_ms)
        return [o.numpy() for o in res]
    from .kernel import launch_packed
    stream = torch.cuda.current_stream(bucket.device)
    dst, src = view.copy_in
    dst.copy_(src, non_blocking=True)
    launch_packed(view, folded_scalars(gs_read, gs_write, bp_ms),
                  stream.cuda_stream)
    LAUNCHES += 1
    dst, src = view.copy_out
    dst.copy_(src, non_blocking=True)
    bucket.event.record(stream)
    bucket.event.synchronize()
    return list(view.outputs)
