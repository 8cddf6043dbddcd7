"""ML tenant jobs as workflow DAGs, costed from dry-run artifacts.

A tenant job is a DAG of ML *stages* over one of the 10 assigned archs:

  fine-tune:  prep(×K shards) → train segment chain(×M) → eval(×E) → pack
  serve:      warmup → prefill(×P parallel request chunks) → decode chain

Stage sizes come from the compiled dry-run (``flops_per_device × chips``
per step — the same artifact §Roofline reads), so the scheduler's cost
model and the framework's compiled reality stay coupled.  Task size unit:
1 MI ≡ 1 GFLOP; slice "MIPS" ≡ sustained GFLOP/s (slices.py).

Every task of arch X carries ``shared_in = [(X, weight_mb)]`` — the base
checkpoint shared across tenants.  EBPSM's tier-1 rule then lands jobs on
slices that already hold the base model: the paper's data-locality policy
becomes "don't re-stage base weights", usually the dominant overhead.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..configs.registry import ARCH_IDS, get_config
from ..core.types import Task, Workflow
from .slices import GFLOPS_PER_CHIP

# Analytic fallbacks when dry-run artifacts are absent (tests).
_TOKENS = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32,
           "decode_32k": 128, "long_500k": 1}


def _artifact_flops(art_dir: str) -> Dict[Tuple[str, str], float]:
    out: Dict[Tuple[str, str], float] = {}
    for p in glob.glob(os.path.join(art_dir, "singlepod__*.json")):
        with open(p) as f:
            art = json.load(f)
        if "skipped" in art or "flops_per_device" not in art:
            continue
        chips = art["mesh"]["n_devices"]
        out[(art["arch"], art["shape"])] = art["flops_per_device"] * chips
    return out


class StageCostModel:
    """GFLOPs per step per (arch, shape), dry-run-derived with fallback."""

    def __init__(self, art_dir: str = "artifacts/dryrun"):
        self.measured = _artifact_flops(art_dir) if os.path.isdir(art_dir) \
            else {}

    def step_gflops(self, arch: str, shape: str) -> float:
        if (arch, shape) in self.measured:
            return self.measured[(arch, shape)] / 1e9
        cfg = get_config(arch)
        n = cfg.n_layers * cfg.d_model * cfg.d_model * 12  # crude N proxy
        mult = {"train_4k": 6, "prefill_32k": 2, "decode_32k": 2,
                "long_500k": 2}[shape]
        return mult * n * _TOKENS[shape] / 1e9

    def weight_mb(self, arch: str) -> float:
        cfg = get_config(arch)
        # bf16 checkpoint; an analytic parameter count.
        if cfg.n_experts:
            per_l = (cfg.n_experts_padded * 3 * cfg.d_model * cfg.d_ff
                     + 4 * cfg.d_model * cfg.d_model)
        elif cfg.ssm_state:
            per_l = 2 * cfg.d_model * cfg.d_inner * 2
        else:
            per_l = (3 * cfg.d_model * cfg.d_ff
                     + 4 * cfg.d_model * max(cfg.n_heads, 1) * cfg.hd // max(cfg.n_heads, 1) * 4)
            per_l = 3 * cfg.d_model * cfg.d_ff + 4 * cfg.d_model * cfg.d_model
        n = cfg.n_layers * per_l + 2 * cfg.vocab * cfg.d_model
        return n * 2 / 1e6


def finetune_job(wid: int, arch: str, cost: StageCostModel,
                 rng: np.random.Generator, n_segments: int = 4,
                 steps_per_segment: int = 20, n_shards: int = 4,
                 n_eval: int = 3) -> Workflow:
    """prep(×K) → train chain(×M) → eval(×E) → pack."""
    wmb = cost.weight_mb(arch)
    step_g = cost.step_gflops(arch, "train_4k")
    tasks: List[Task] = []

    def add(size_gf, out_mb, parents, ext_mb=0.0, shared=True) -> int:
        tid = len(tasks)
        t = Task(tid=tid, size_mi=float(size_gf), out_mb=float(out_mb),
                 ext_in_mb=float(ext_mb), parents=list(parents))
        if shared:
            t.shared_in = [(arch, wmb)]
        tasks.append(t)
        for p in parents:
            tasks[p].children.append(tid)
        return tid

    # data prep: tokenize/pack shards (I/O-ish, light compute)
    preps = [add(rng.uniform(50, 200), rng.uniform(500, 2000), [],
                 ext_mb=rng.uniform(1000, 4000), shared=False)
             for _ in range(n_shards)]
    prev = None
    for _ in range(n_segments):
        parents = preps if prev is None else [prev]
        prev = add(step_g * steps_per_segment, wmb, parents)
    evals = [add(cost.step_gflops(arch, "prefill_32k") * rng.uniform(0.5, 2),
                 rng.uniform(10, 50), [prev]) for _ in range(n_eval)]
    add(rng.uniform(20, 100), wmb, evals, shared=False)   # package/export
    wf = Workflow(wid=wid, app=arch, tasks=tasks)
    wf.validate()
    return wf


def serve_job(wid: int, arch: str, cost: StageCostModel,
              rng: np.random.Generator, n_prefill: int = 6,
              decode_tokens: int = 512) -> Workflow:
    """warmup → prefill(×P) → decode chain per prefill → collect."""
    cfg = get_config(arch)
    wmb = cost.weight_mb(arch)
    tasks: List[Task] = []

    def add(size_gf, out_mb, parents, ext_mb=0.0, shared=True) -> int:
        tid = len(tasks)
        t = Task(tid=tid, size_mi=float(size_gf), out_mb=float(out_mb),
                 ext_in_mb=float(ext_mb), parents=list(parents))
        if shared:
            t.shared_in = [(arch, wmb)]
        tasks.append(t)
        for p in parents:
            tasks[p].children.append(tid)
        return tid

    warm = add(rng.uniform(10, 50), 1.0, [])
    ends = []
    dec_g = cost.step_gflops(arch, "decode_32k") * decode_tokens
    if cfg.is_encoder_only:
        dec_g = 0.0
    for _ in range(n_prefill):
        pf = add(cost.step_gflops(arch, "prefill_32k") * rng.uniform(0.3, 1),
                 rng.uniform(100, 400), [warm])
        if dec_g > 0:
            d = add(dec_g * rng.uniform(0.5, 1.5), rng.uniform(5, 20), [pf])
            ends.append(d)
        else:
            ends.append(pf)
    add(rng.uniform(5, 20), 5.0, ends, shared=False)      # collect/respond
    wf = Workflow(wid=wid, app=arch, tasks=tasks)
    wf.validate()
    return wf


def ml_workload(n_jobs: int, arrival_rate_per_min: float, seed: int = 0,
                art_dir: str = "artifacts/dryrun",
                archs: Optional[Tuple[str, ...]] = None) -> List[Workflow]:
    """A multi-tenant stream of fine-tune + serve jobs over the arch pool."""
    rng = np.random.default_rng(seed)
    cost = StageCostModel(art_dir)
    archs = archs or ARCH_IDS
    t = 0.0
    out: List[Workflow] = []
    for wid in range(n_jobs):
        arch = archs[int(rng.integers(len(archs)))]
        if rng.random() < 0.5:
            wf = finetune_job(wid, arch, cost, rng,
                              n_segments=int(rng.integers(2, 6)),
                              steps_per_segment=int(rng.integers(5, 30)))
        else:
            wf = serve_job(wid, arch, cost, rng,
                           n_prefill=int(rng.integers(3, 10)))
        wf.arrival_ms = int(t)
        out.append(wf)
        t += rng.exponential(60_000.0 / arrival_rate_per_min)
    return out
