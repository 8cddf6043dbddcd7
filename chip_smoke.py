#!/usr/bin/env python3
"""Smoke test of the repro_torch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device — requires CUDA, prints the card's name and power limit;
2. build — compiles the affinity kernel from ``src/`` with nvcc;
3. kernel vs plain — the CUDA kernel against the plain torch version on
   the card, bitwise, at the reference tests' shapes, the simulator's
   round buckets and a large round; prints per-shape times;
4. engine parity — ``simulate_batch`` scoring rounds on the card against
   the host-only ``SimEngine``, identical results;
5. full width — the paper cell (100 workflows of all sizes at 12 wf/min,
   all five policies, seed 0) through ``simulate_batch`` on the card.

The second-last lines are the kernel record (JSON) and the card's
``nvidia-smi`` name and power limit; the last line is the device record.
"""
from __future__ import annotations

import collections
import functools
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 peak outside the tensor cores
OPS_PER_PAIR = 20              # divides, adds, multiplies, ceils, compares
GS = dict(gs_read=50.0, gs_write=30.0, bp_ms=1000.0)
FIELDS = ("best_vm", "best_tier", "est_finish", "est_cost")
# (B, T, V) shapes: the reference kernel tests' (T, V) at B = 1 and 3, the
# main path's round buckets (half their rows inert), and one large round.
TEST_TV = [(16, 32), (37, 100), (64, 7), (1, 1)]
BUCKETS = [(1, 64, 64), (1, 64, 128), (1, 512, 128), (2, 512, 512),
           (1, 256, 1024), (4, 4, 1024)]
LARGE = (16, 1024, 1024)
HEADLINE = (1, 256, 1024)      # the most frequent bucket of the paper cell
REPS = 10        # timed runs per measurement (the median is kept)
RUN = 20         # back-to-back calls per timed run


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_round(rng, B, T, V, inert_rows=0):
    """Random round at ``[B, T, V]``; the last ``inert_rows`` task rows of
    every member carry the padding ``multi_cycle`` stages (budget -1,
    tier 0)."""
    arrs = [
        rng.uniform(10, 900, (B, T)), rng.uniform(1, 150, (B, T)),
        rng.uniform(5, 500, (B, T)), rng.uniform(0, 200, (B, T, V)),
        rng.choice([0., 400., 10000.], (B, T, V)),
        rng.choice([0, 1, 2, 3], (B, T, V)),
        rng.choice([2., 4., 8., 16.], (B, V)), rng.uniform(5, 40, (B, V)),
        rng.choice([1., 2., 4., 8.], (B, V)),
    ]
    arrs = [a.astype(np.int32 if i == 5 else np.float32)
            for i, a in enumerate(arrs)]
    if inert_rows:
        lo = T - inert_rows
        for i in (0, 1, 3, 4, 5):
            arrs[i][:, lo:] = 0
        arrs[2][:, lo:] = -1.0
    return arrs


def round_bound(B, T, V):
    """Least time (ms) the card could score a round in, and what bounds
    it: the bytes the scoring must move (12 per pair, 12 per VM and 12
    per task read, 16 per task written) at the memory rate, or its fp32
    operations at the fp32 peak."""
    nbytes = 12 * B * T * V + 12 * B * V + 12 * B * T + 16 * B * T
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = OPS_PER_PAIR * B * T * V / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def per_call_ms(torch, fn, run=RUN, reps=REPS) -> float:
    """Median over ``reps`` of (CUDA-event time of ``run`` back-to-back
    calls) / ``run``.  Where a call's host work outlasts its device work,
    this is the host-bound rate at which the card can be fed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / run)
    return statistics.median(times)


def device_ms(torch, fn, name: str, run=RUN):
    """Mean device time (ms) of the kernels whose name contains ``name``,
    from a ``torch.profiler`` trace of ``run`` calls; None when the trace
    holds no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(run):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    """Build from the checkout's source: any library an earlier run left
    in the (git-ignored) build directory is removed first."""
    from repro_torch.kernels.affinity import kernel
    shutil.rmtree(kernel.BUILD_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    lib = kernel.build()
    kernel._load()
    log(f"[build] affinity kernel {lib.relative_to(ROOT)}: nvcc "
        f"{kernel.build_info['seconds']:.3f} s, build + load "
        f"{time.perf_counter() - t0:.3f} s")
    for line in kernel.build_info.get("log", "").splitlines():
        log(f"[build]   {line}")


def phase_kernel(torch) -> dict:
    from repro_torch.kernels.affinity.kernel import affinity_cuda
    from repro_torch.kernels.affinity.ref import affinity_ref
    dev = torch.device("cuda")
    shapes = [((b, t, v), 0) for b in (1, 3) for t, v in TEST_TV]
    shapes += [(s, s[1] // 2) for s in BUCKETS]
    shapes += [(LARGE, 0)]
    log("[kernel] no single PyTorch call computes this function "
        "(library_ms = null)")
    log("[kernel] per call, ms: kernel = wrapper + launch, 20 back-to-back "
        "(CUDA events); device = the kernel alone (torch.profiler); h2d = "
        "the round's nine tensors from pinned memory; plain = the torch "
        "version on the card; bound = the least time for the work")
    log("[kernel] shape             kernel    device      h2d     plain"
        "     bound")
    max_err, rows = 0.0, {}
    for i, ((B, T, V), inert) in enumerate(shapes):
        host = [torch.from_numpy(a).pin_memory()
                for a in make_round(np.random.default_rng(i), B, T, V, inert)]
        args = [h.to(dev) for h in host]
        want = affinity_ref(*args, **GS)
        got = affinity_cuda(*args, **GS)
        torch.cuda.synchronize()
        for name, a, b in zip(FIELDS, want, got):
            if not torch.equal(a, b):
                raise AssertionError(f"kernel != plain at {(B, T, V)}: {name}")
            max_err = max(max_err, float((a.double() - b.double())
                                         .abs().max()))
        launch = functools.partial(affinity_cuda, *args, **GS)
        ms = per_call_ms(torch, launch)
        dev_ms = device_ms(torch, launch, "affinity_kernel")
        h2d = per_call_ms(torch, lambda: [h.to(dev, non_blocking=True)
                                          for h in host])
        plain = per_call_ms(torch, lambda: affinity_ref(*args, **GS), run=5)
        bound, bound_by = round_bound(B, T, V)
        rows[(B, T, V)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                               h2d_ms=h2d, bound_ms=bound, bound_by=bound_by)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.5f}"
        log(f"[kernel] {str([B, T, V]):16s} {ms:9.5f} {dev_txt:>9s} "
            f"{h2d:8.5f} {plain:9.5f} {bound:9.6f}  equal")
    return dict(max_abs_err=max_err, rows=rows)


def signature(res):
    return ([w.finish_ms for w in res.workflows],
            [w.cost for w in res.workflows],
            res.vm_count_by_type, res.vm_seconds_by_type)


def phase_parity() -> None:
    """Grids scored on the card ≡ the host-only SimEngine, on the
    reference engine tests' workload (8 small workflows at 6 wf/min,
    budgets in [0.5, 1.0]), all five policies, seeds 0-2.

    These auctions stay under the serial-tail threshold, which would drain
    them on the host; with the threshold at 1 every auction round is
    scored by the kernel.  Serial and kernel resolution are bit-exact, so
    the results must not move."""
    from repro_torch.core import cycles
    from repro_torch.core.batch_engine import simulate_batch
    from repro_torch.core.engine import SimEngine
    from repro_torch.core.scheduler import ALL_POLICIES
    from repro_torch.core.types import PlatformConfig
    from repro_torch.kernels.affinity import ops
    from repro_torch.workflows.workload import WorkloadSpec, \
        generate_workload
    cfg = PlatformConfig()
    by_name = {p.name: p for p in ALL_POLICIES}
    tail = cycles.AUCTION_TAIL_PAIRS
    cycles.AUCTION_TAIL_PAIRS = 1
    try:
        for seed in (0, 1, 2):
            spec = WorkloadSpec(n_workflows=8, arrival_rate_per_min=6.0,
                                seed=seed, sizes=("small",), budget_lo=0.5,
                                budget_hi=1.0)
            ops.LAUNCHES = 0
            grid = simulate_batch(cfg, ALL_POLICIES,
                                  generate_workload(cfg, spec), seed=seed,
                                  device="cuda", batched=True)
            launches = ops.LAUNCHES
            if launches <= 0:
                raise AssertionError("engine parity run launched no kernel")
            for e in grid.entries:
                ref = SimEngine(cfg, by_name[e.policy],
                                generate_workload(cfg, spec), seed=seed,
                                batched=False).run()
                if signature(ref) != signature(e.result):
                    raise AssertionError(f"grid != SimEngine: {e.policy} "
                                         f"seed {seed}")
            log(f"[parity] seed {seed}: {len(grid.entries)} members "
                f"identical to the host-only SimEngine, {launches} kernel "
                f"launches (serial-tail threshold 1 instead of {tail})")
    finally:
        cycles.AUCTION_TAIL_PAIRS = tail


def phase_full_width(torch) -> int:
    from repro_torch.core import cycles
    from repro_torch.core.batch_engine import simulate_batch
    from repro_torch.core.scheduler import ALL_POLICIES
    from repro_torch.core.types import PlatformConfig
    from repro_torch.kernels.affinity import ops
    from repro_torch.workflows.workload import WorkloadSpec, \
        generate_workload
    cfg = PlatformConfig()
    spec = WorkloadSpec(n_workflows=100, arrival_rate_per_min=12.0, seed=0,
                        sizes=("small", "medium", "large"))
    wl = generate_workload(cfg, spec)
    n_tasks = sum(w.n_tasks for w in wl)
    buckets = collections.Counter()
    round_s = [0.0]
    score_round = cycles._score_round

    def counted(cfg_, tensors, device):
        # Host clock around one round's copy-in, scoring and copy-back
        # (the copy-back synchronises the stream).
        buckets[tuple(tensors[3].shape)] += 1
        t = time.perf_counter()
        out = score_round(cfg_, tensors, device)
        round_s[0] += time.perf_counter() - t
        return out

    cycles._score_round = counted
    try:
        ops.LAUNCHES = 0
        t0 = time.perf_counter()
        grid = simulate_batch(cfg, ALL_POLICIES, wl, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES
    finally:
        cycles._score_round = score_round
    if launches <= 0:
        raise AssertionError("full-width run launched no kernel")
    if sum(buckets.values()) != launches:
        raise AssertionError("bucket count disagrees with the launch count")
    log(f"[full] paper cell: {len(wl)} workflows, {n_tasks} tasks, "
        f"{len(ALL_POLICIES)} policies, seed 0")
    log(f"[full] wall {wall:.3f} s, kernel launches {launches}, rounds on "
        f"the card (H2D + kernel + D2H, host clock) {round_s[0]:.3f} s = "
        f"{round_s[0] / wall:.4f} of wall")
    top = ", ".join(f"{list(k)}x{v}" for k, v in buckets.most_common(12))
    log(f"[full] launches by [B,T,V] bucket ({len(buckets)} buckets): {top}")
    for e in grid.entries:
        res = e.result
        if len(res.workflows) != len(wl) or any(
                w.finish_ms <= w.arrival_ms for w in res.workflows):
            raise AssertionError(f"{e.policy}: not every workflow finished")
        if not np.isfinite([w.cost for w in res.workflows]).all():
            raise AssertionError(f"{e.policy}: non-finite cost")
        mk = statistics.mean(w.makespan_ms for w in res.workflows) / 1e3
        log(f"[full] {e.policy:9s} budget met {res.budget_met_fraction:.2f}"
            f"  mean makespan {mk:.1f} s  VMs {res.total_vms}")
    return launches


def main() -> int:
    import torch
    smi = phase_device(torch)
    phase_build()
    k = phase_kernel(torch)
    phase_parity()
    launches = phase_full_width(torch)
    head = k["rows"][HEADLINE]
    record = {"kernels": [{
        "name": "affinity",
        "route": "cuda",
        "source": "src/repro_torch/kernels/affinity/csrc/affinity.cu",
        "replaces": "src/repro/kernels/affinity/kernel.py:24",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": list(HEADLINE),
        "h2d_ms": head["h2d_ms"],
        "device_ms": head["device_ms"],
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
