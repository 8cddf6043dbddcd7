"""TPU-slice catalogue: the paper's VM types mapped onto v5e slices.

The mapping is exact (see DESIGN.md §2) — the core EBPSM engine runs
unchanged on top of it:

    VM type (MIPS, ¢/s)      → slice type (chips × eff. GFLOP/s, ¢/s)
    container image           → program + weights bundle for an arch
    container provision delay → weight/program staging from object store
    dataset in local storage  → checkpoint / dataset shard in host RAM
    task size S_t (MI)        → stage GFLOPs (from dry-run cost analysis)

Pricing stays linear in capacity (the paper's Table 2 property that makes
resource sharing profitable: compute cost is speed-invariant, overheads
price at the slice's rate).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..core.types import PlatformConfig, VMType

# Simulation inputs, kept verbatim from the reference for parity: the
# modelled v5e slices' rates, not measurements of the H100 this port runs on.
# v5e: 197 TFLOP/s bf16 per chip; MFU prior for sustained training compute.
CHIP_TFLOPS = 197.0
MFU_PRIOR = 0.40
# 1 "MI" of task size ≡ 1 GFLOP of stage work; a slice's "MIPS" is its
# sustained GFLOP/s.
GFLOPS_PER_CHIP = CHIP_TFLOPS * 1e3 * MFU_PRIOR

# Object-store staging bandwidth per slice (DCN), MB/s — plays the role of
# VM bandwidth b_vmt in Eqs. (1)-(2).
STAGE_BW_MBPS = 2_000.0
OBJ_READ_MBPS = 4_000.0
OBJ_WRITE_MBPS = 2_000.0


def slice_type(name: str, chips: int, host_ram_gb: int) -> VMType:
    return VMType(
        name=name,
        mips=chips * GFLOPS_PER_CHIP,
        storage_mb=host_ram_gb * 1024.0,
        cost_per_bp=chips * 1.0,          # ¢ per chip-second (linear)
        bandwidth_mbps=STAGE_BW_MBPS,
    )


SLICE_TYPES: Tuple[VMType, ...] = (
    slice_type("v5e-2x2", 4, 192),
    slice_type("v5e-4x4", 16, 768),
    slice_type("v5e-8x8", 64, 3072),
    slice_type("v5e-16x16", 256, 12288),
)


def platform_config(**overrides) -> PlatformConfig:
    """PlatformConfig for the TPU-slice WaaS: slice acquisition ≈ 90 s
    (cloud TPU provisioning), bundle staging modelled via Eq. (1) physics
    with the object-store rates above."""
    base = dict(
        vm_types=SLICE_TYPES,
        billing_period_ms=1_000,
        vm_provision_delay_ms=90_000,
        container_download_ms=12_000,     # program+env bundle (~24 GB @ 2 GB/s)
        container_init_ms=3_000,          # runtime + mesh init
        gs_read_mbps=OBJ_READ_MBPS,
        gs_write_mbps=OBJ_WRITE_MBPS,
        idle_threshold_ms=30_000,         # keep warm slices 30 s
    )
    base.update(overrides)
    return PlatformConfig(**base)
