"""Cost and timing model — Eqs. (1)–(5) of the paper, in integer ms.

Estimated quantities use the advertised VM capacity (the scheduler's view);
actual quantities apply the pre-drawn degradation factors (the cloud's view).
"""
from __future__ import annotations

import math
from typing import Optional

from .types import MS, PlatformConfig, Task, VMType

# Tolerance-ceil: discretization to integer ms must agree bit-for-bit
# between this float64 reference and the float32 affinity kernel.  A bare
# ceil flips across integer boundaries under 1-ulp noise (e.g.
# 30/20 + 30/50 rounds to 2100.0000238 in f32, 2099.99999… in f64); the
# relative backoff makes both land on the same integer.
CEIL_TOL = 1e-6


def ceil_ms(x: float) -> int:
    return int(math.ceil(x * (1.0 - CEIL_TOL)))


def transfer_in_ms(cfg: PlatformConfig, vmt: VMType, mb: float, bw_deg: float = 0.0) -> int:
    """Eq. (1): T^{d_in} = d/b_vmt + d/GS_r (ms)."""
    if mb <= 0.0:
        return 0
    bw = vmt.bandwidth_mbps * (1.0 - bw_deg)
    return ceil_ms(MS * (mb / bw + mb / cfg.gs_read_mbps))


def transfer_out_ms(cfg: PlatformConfig, vmt: VMType, mb: float, bw_deg: float = 0.0) -> int:
    """Eq. (2): T^{d_out} = d/b_vmt + d/GS_w (ms)."""
    if mb <= 0.0:
        return 0
    bw = vmt.bandwidth_mbps * (1.0 - bw_deg)
    return ceil_ms(MS * (mb / bw + mb / cfg.gs_write_mbps))


def runtime_ms(vmt: VMType, size_mi: float, cpu_deg: float = 0.0) -> int:
    """Eq. (3): RT = S_t / p_vmt (ms), optionally degraded."""
    p = vmt.mips * (1.0 - cpu_deg)
    return ceil_ms(MS * size_mi / p)


def processing_ms(
    cfg: PlatformConfig,
    vmt: VMType,
    task: Task,
    in_mb: float,
    cpu_deg: float = 0.0,
    bw_in_deg: float = 0.0,
    bw_out_deg: float = 0.0,
) -> int:
    """Eq. (4): PT = T^{d_in} + RT + T^{d_out}.

    ``in_mb`` is the number of MB that must actually be fetched from global
    storage (cached inputs cost nothing — the resource-sharing policy).
    """
    return (
        transfer_in_ms(cfg, vmt, in_mb, bw_in_deg)
        + runtime_ms(vmt, task.size_mi, cpu_deg)
        + transfer_out_ms(cfg, vmt, task.out_mb, bw_out_deg)
    )


def billed_cost(cfg: PlatformConfig, vmt: VMType, duration_ms: int) -> float:
    """Eq. (5) core: ceil(duration / bp) * c_vmt."""
    bp = cfg.billing_period_ms
    periods = (max(duration_ms, 0) + bp - 1) // bp
    return periods * vmt.cost_per_bp


def task_cost(
    cfg: PlatformConfig,
    vmt: VMType,
    task: Task,
    in_mb: float,
    include_vm_provision: bool,
    container_ms: int,
    cpu_deg: float = 0.0,
    bw_in_deg: float = 0.0,
    bw_out_deg: float = 0.0,
) -> float:
    """Eq. (5): C = ceil((prov_vmt + prov_c + PT)/bp) * c_vmt.

    ``include_vm_provision`` charges prov_vmt when this task triggers a fresh
    VM acquisition; ``container_ms`` is the actually-incurred container
    provisioning time (0 when the image is warm).
    """
    dur = processing_ms(cfg, vmt, task, in_mb, cpu_deg, bw_in_deg, bw_out_deg)
    if include_vm_provision:
        dur += cfg.vm_provision_delay_ms
    dur += container_ms
    return billed_cost(cfg, vmt, dur)


def estimate_full_cost(
    cfg: PlatformConfig, vmt: VMType, task: Task, in_mb: float
) -> float:
    """The scheduler's conservative per-task cost estimate.

    Maximum cost per Eq. (5): assumes fresh VM provisioning, full container
    provisioning, and every input (``in_mb``) fetched from global storage
    (no locality).  Used by budget distribution for both EBPSM and MSLBL so
    the comparison is apples-to-apples.
    """
    return task_cost(
        cfg, vmt, task, in_mb, include_vm_provision=True,
        container_ms=cfg.container_provision_ms,
    )


def total_input_mb(task: Task, out_mb_of: list) -> float:
    """d_t^in = external + shared + all parents' outputs."""
    shared = sum(mb for _, mb in task.shared_in)
    return task.ext_in_mb + shared + sum(out_mb_of[p] for p in task.parents)
