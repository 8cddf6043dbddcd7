"""Dispatch for the affinity scoring: CUDA kernel or plain torch version,
chosen by the device the tensors lie on.

Two entry points share one core:

* :func:`affinity` — one scheduling cycle, ``[T, V]`` pair arrays.
* :func:`affinity_batch` — a whole grid of independent simulations'
  cycles, ``[B, T, V]``.  This is what ``core.batch_engine`` drives: one
  device pass scores every member's auction round.

A CUDA tensor goes to the kernel (``kernel.affinity_cuda``), a CPU tensor
to the plain version (``ref.affinity_ref``); there is no fallback from
one to the other.  ``LAUNCHES`` counts kernel launches, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

from .ref import AffinityOut, affinity_ref

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
