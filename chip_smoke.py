#!/usr/bin/env python3
"""Smoke test of the repro_torch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device — requires CUDA, prints the card's name and power limit; turns
   TF32 off for matmuls and cuDNN (the reference's numbers are fp32 or
   bf16, never TF32);
2. build — compiles the three kernel sources from ``src/`` with nvcc,
   one process per source, started together; prints each build's
   registers, shared memory and spills;
3. affinity kernel vs plain — the CUDA kernel against the plain torch
   version on the card, bitwise, at the reference tests' shapes, the
   simulator's round buckets and a large round, both through the nine-
   tensor wrapper and through a packed round (stage, one copy over, the
   kernel, one copy back, one wait); prints per-shape times, the packed
   round's time and its link bound at a host-to-device rate measured
   from one large page-locked copy;
4. engine parity — ``simulate_batch`` scoring rounds on the card against
   the host-only ``SimEngine``, identical results;
5. full width — the paper cell (100 workflows of all sizes at 12 wf/min,
   all five policies, seed 0) through ``simulate_batch`` on the card;
6. attention and SSD kernels vs plain — flash attention and the SSD
   chunk and carry kernels against their plain torch versions on the
   card at the reference sweep's shapes and at zamba2-1.2b's (and
   mamba2-780m's) serving shapes, both request sets' lengths included
   (bf16 attention, on the tensor-core kernel at every head width,
   element by element within one bf16 step of the plain version; the
   bf16 SSD chunk pass on the tensor cores, with the worst ratio to its
   bar at one, two and three bf16 terms); prints kernel, plain, bound
   and library times and achieved TFLOP/s, and the whole ``ssd()``;
7. serving at full width — zamba2-1.2b (38 layers, d_model 2048, seeded
   random fp32 weights, bf16 compute) through ``build`` and the serve
   builders:
   after an untimed warm-up request, (a) 4 requests × 2048-token
   prompts, 32 greedy decode tokens each, every step held against
   ``forward``; (b) 1 request × 32,768-token prompt, 8 decode tokens.
   Every prefill's attention and SSD (chunk and carry) go through the
   kernels (launch counts checked); a ``torch.profiler`` pass then splits
   one prefill and one decode step of each by kernel and gives the
   device's idle share.

The second-last lines are the kernel record (JSON) and the card's
``nvidia-smi`` name and power limit; the last line is the device record.
"""
from __future__ import annotations

import collections
import concurrent.futures
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
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
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


def kernel_libs() -> dict:
    from repro_torch.kernels.affinity import kernel as aff
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    return {"affinity": aff.LIB, "flash_attention": fa.LIB, "ssd": ssd.LIB}


def phase_build() -> None:
    """Build every kernel from the checkout's source, one nvcc process per
    source, all started together; any library an earlier run left in the
    (git-ignored) build directories is removed first."""
    libs = kernel_libs()
    for lib in libs.values():
        shutil.rmtree(lib.build_root, ignore_errors=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        built = {name: pool.submit(lib.build) for name, lib in libs.items()}
        paths = {name: fut.result() for name, fut in built.items()}
    wall = time.perf_counter() - t0
    for name, lib in libs.items():
        lib.load()
        log(f"[build] {name}: {paths[name].relative_to(ROOT)}, nvcc "
            f"{lib.build_info['seconds']:.3f} s, flags "
            f"{' '.join(lib.flags)}")
        for line in lib.build_info.get("log", "").splitlines():
            log(f"[build]   {line}")
    log(f"[build] all {len(libs)} kernels built in parallel in {wall:.3f} s")


def link_rate(torch) -> float:
    """Host-to-device bytes per second of one large page-locked copy
    (256 MiB, CUDA events, median of three after a warm-up)."""
    host = torch.empty(1 << 28, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty_like(host, device="cuda")
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return host.numel() / statistics.median(times)


def host_ms(fn, run=RUN, reps=REPS) -> float:
    """Median over ``reps`` of (host-clock time of ``run`` calls) / ``run``,
    for work that ends in a synchronisation of its own."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(run):
            fn()
        times.append((time.perf_counter() - t) * 1e3 / run)
    return statistics.median(times)


def round_bytes(B, T, V) -> int:
    """Bytes a packed round moves over the link: its nine arrays at its
    own layout one way, the four packed [B, T] outputs back."""
    from repro_torch.kernels.affinity.ops import round_layout
    return round_layout(B, T, V)[1] + 16 * B * T


def phase_kernel(torch) -> dict:
    from repro_torch.kernels.affinity.kernel import affinity_cuda
    from repro_torch.kernels.affinity.ops import PackedRound, affinity_round
    from repro_torch.kernels.affinity.ref import affinity_ref
    dev = torch.device("cuda")
    rate = link_rate(torch)
    shapes = [((b, t, v), 0) for b in (1, 3) for t, v in TEST_TV]
    shapes += [(s, s[1] // 2) for s in BUCKETS]
    shapes += [(LARGE, 0)]
    log(f"[kernel] link: one 256 MiB page-locked host-to-device copy at "
        f"{rate / 1e9:.3f} GB/s")
    log("[kernel] no single PyTorch call computes this function "
        "(library_ms = null)")
    log("[kernel] per call, ms: kernel = wrapper + launch, 20 back-to-back "
        "(CUDA events); device = the kernel alone (torch.profiler); h2d = "
        "the round's nine tensors from pinned memory; round = a packed "
        "round: stage the nine arrays, one copy over, the kernel, one copy "
        "of the packed outputs back, one wait (host clock); link = the "
        "packed round's bytes at the measured link rate; plain = the torch "
        "version on the card; bound = the least time for the scoring")
    log("[kernel] shape             kernel    device      h2d     round"
        "      link     plain     bound")
    max_err, rows = 0.0, {}
    for i, ((B, T, V), inert) in enumerate(shapes):
        arrs = make_round(np.random.default_rng(i), B, T, V, inert)
        host = [torch.from_numpy(a).pin_memory() for a in arrs]
        args = [h.to(dev) for h in host]
        want = affinity_ref(*args, **GS)
        got = affinity_cuda(*args, **GS)
        view = PackedRound(B, T, V, dev).view(B, T, V)

        def stage_and_score():
            for dst, src in zip(view.arrays, arrs):
                dst[...] = src
            return affinity_round(view, **GS)
        packed = stage_and_score()
        torch.cuda.synchronize()
        for name, a, b, c in zip(FIELDS, want, got, packed):
            if not torch.equal(a, b):
                raise AssertionError(f"kernel != plain at {(B, T, V)}: {name}")
            if not np.array_equal(a.cpu().numpy(), c):
                raise AssertionError(f"packed round != plain at "
                                     f"{(B, T, V)}: {name}")
            max_err = max(max_err, float((a.double() - b.double())
                                         .abs().max()))
        launch = functools.partial(affinity_cuda, *args, **GS)
        ms = per_call_ms(torch, launch)
        dev_ms = device_ms(torch, launch, "affinity_kernel")
        h2d = per_call_ms(torch, lambda: [h.to(dev, non_blocking=True)
                                          for h in host])
        rnd = host_ms(stage_and_score)
        link = round_bytes(B, T, V) / rate * 1e3
        plain = per_call_ms(torch, lambda: affinity_ref(*args, **GS), run=5)
        bound, bound_by = round_bound(B, T, V)
        rows[(B, T, V)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                               h2d_ms=h2d, round_ms=rnd, link_ms=link,
                               bound_ms=bound, bound_by=bound_by)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.5f}"
        log(f"[kernel] {str([B, T, V]):16s} {ms:9.5f} {dev_txt:>9s} "
            f"{h2d:8.5f} {rnd:9.5f} {link:9.5f} {plain:9.5f} {bound:9.6f}"
            f"  equal")
        del view
    return dict(max_abs_err=max_err, rows=rows, link_rate=rate)


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


def phase_full_width(torch, rate: float) -> int:
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
    link_bytes = [0]
    score_round = cycles._score_round

    def counted(cfg_, view):
        # Host clock around one round's copy-in, scoring, copy-back and
        # wait; the bytes it moved over the link.
        buckets[view.shape] += 1
        link_bytes[0] += round_bytes(*view.shape)
        t = time.perf_counter()
        out = score_round(cfg_, view)
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
        f"the card (H2D + kernel + D2H + wait, host clock) "
        f"{round_s[0]:.3f} s = {round_s[0] / wall:.4f} of wall, "
        f"{round_s[0] / launches * 1e3:.5f} ms per round; their "
        f"{link_bytes[0] / 1e9:.4f} GB over the link need "
        f"{link_bytes[0] / rate:.4f} s at {rate / 1e9:.3f} GB/s")
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


# ---------------------------------------------------------------------------
# Flash attention and SSD: kernels vs plain on the card
# ---------------------------------------------------------------------------

# (B, L, H, D, causal, dtype): the reference sweep (tests/test_kernels.py,
# test_flash_attention_sweep), then zamba2-1.2b's shared-attention shapes
# for request sets (a) and (b) below.
FA_SWEEP = [(2, 256, 4, 64, True, "float32"),
            (1, 128, 2, 128, False, "float32"),
            (2, 200, 3, 64, True, "float32"),
            (1, 96, 1, 32, True, "float32"),
            (2, 256, 2, 64, True, "bfloat16"),
            (1, 128, 2, 128, False, "bfloat16"),
            (2, 200, 3, 64, True, "bfloat16"),
            (1, 96, 1, 32, True, "bfloat16")]
FA_SERVING = [(4, 2048, 32, 64, True, "bfloat16"),
              (1, 32768, 32, 64, True, "bfloat16")]
FA_HEADLINE = FA_SERVING[0]
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # max|Δ| over the output
# bf16 outputs are also held element by element to one bf16 rounding step
# of the reference plus fp32 slack, |Δ| <= 2^-7·|ref| + 1e-6: the kernel
# and the plain version both compute in fp32 and round once to bf16, so a
# flat bound alone would let small outputs (long rows) be wrong.
FA_BF16_REL, FA_BF16_ABS = 2.0 ** -7, 1e-6
# (B, L, H, P, N, Q): the reference sweep (test_ssd_kernel_sweep), then
# zamba2-1.2b's and mamba2-780m's SSD shapes at a 2048-token prompt and
# zamba2-1.2b's at request set (b)'s 32,768-token prompt.
SSD_SWEEP = [(2, 128, 3, 32, 16, 32), (1, 256, 2, 64, 128, 64),
             (2, 64, 4, 16, 32, 16), (1, 128, 1, 64, 64, 128)]
SSD_SERVING = [(4, 2048, 64, 64, 64, 64), (1, 2048, 48, 64, 128, 64),
               (1, 32768, 64, 64, 64, 64)]
SSD_HEADLINE = SSD_SERVING[0]
SSD_ATOL = 1e-4      # the sweep's absolute bound
SSD_REL = 1e-4       # full width: max|Δ| <= 1e-4 · max|ref|


def esize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def peak_ops(dtype: str) -> float:
    return BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S


def bound(flops: float, nbytes: float, dtype: str):
    """(least ms, what bounds it): operations at the dtype's peak rate or
    bytes at the memory rate, whichever takes longer."""
    by_ops = flops / peak_ops(dtype) * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def fa_pairs(B, L, H, causal):
    """Unmasked (q, k) pairs."""
    return B * H * (L * (L + 1) // 2 if causal else L * L)


def fa_bound(B, L, H, D, causal, dtype):
    """4·D flops per unmasked (q, k) pair; q, k, v and o moved once."""
    return bound(4 * D * fa_pairs(B, L, H, causal),
                 4 * B * L * H * D * esize(dtype), dtype)


def ssd_bound(B, L, H, P, N, Q, dtype):
    """2Q²N + 2Q²P + 2QNP flops per (b, h, chunk); x, dt, cum, y and the
    chunk states per head, B and C once per (b, chunk)."""
    nc = L // Q
    flops = B * H * nc * (2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * N * P)
    nbytes = (B * L * H * P * (esize(dtype) + 4) + 2 * B * L * H * 4
              + 2 * B * L * N * esize(dtype) + B * nc * H * N * P * 4)
    return bound(flops, nbytes, dtype)


def timed_ms(torch, fn, budget_s: float = 0.3, max_reps: int = 25) -> float:
    """Median CUDA-event time (ms) of single calls after one warm-up call;
    at least 3 calls, more while they fit ``budget_s``."""
    fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < max_reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if len(times) >= 3 and sum(times) / 1e3 > budget_s:
            break
    return statistics.median(times)


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def phase_attention(torch) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev = torch.device("cuda")
    log("[fa] per call, ms (CUDA events, median after a warm-up): kernel "
        "(bf16: tensor cores; fp32: CUDA cores); plain = the torch version "
        "on the card; library = F.scaled_dot_product_attention(is_causal) "
        "on the same tensors ([B, H, L, D] views; timed only, never used "
        "by the port); bound = the least time for the work (4·D flops per "
        "pair) and what bounds it; TFLOP/s = those flops over the kernel "
        "time; MMA floor = the bf16 kernel's own tensor-core work (8·D "
        "flops per pair: p·v three times) at the bf16 peak")
    rows, worst = {}, 0.0
    for i, shape in enumerate(FA_SWEEP + FA_SERVING):
        B, L, H, D, causal, dtype = shape
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        tdt = getattr(torch, dtype)
        q, k, v = (torch.randn((B, L, H, D), generator=gen, device=dev)
                   .to(tdt) for _ in range(3))
        got = flash_attention_cuda(q, k, v, causal)
        want = attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        if not err <= FA_TOL[dtype]:
            raise AssertionError(f"flash attention {shape}: max|Δ| {err} "
                                 f"> {FA_TOL[dtype]}")
        rel = ""
        if dtype == "bfloat16":
            ratio = float(((got.float() - want.float()).abs()
                           / (FA_BF16_REL * want.float().abs()
                              + FA_BF16_ABS)).max())
            if not ratio <= 1.0:
                raise AssertionError(
                    f"flash attention {shape}: an element's |Δ| is {ratio} "
                    f"times its bound 2^-7·|ref| + {FA_BF16_ABS}")
            rel = (f"; worst |Δ| / (2^-7·|ref| + {FA_BF16_ABS}) "
                   f"{ratio:.4g} <= 1")
        worst = max(worst, err)
        ms = timed_ms(torch, lambda: flash_attention_cuda(q, k, v, causal))
        plain = timed_ms(torch, lambda: attention_ref(q, k, v, causal))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        bms, bby = fa_bound(B, L, H, D, causal, dtype)
        pairs = fa_pairs(B, L, H, causal)
        tflops = 4 * D * pairs / (ms * 1e-3) / 1e12
        rows[shape] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=bby, err=err,
                           tflops=tflops)
        extra = ""
        if dtype == "bfloat16":
            extra += (f"; MMA floor "
                      f"{8 * D * pairs / BF16_OPS_PER_S * 1e3:.6f}")
        log(f"[fa] [B,H,L,D]={[B, H, L, D]} causal={causal} {dtype}: "
            f"kernel {ms:.5f} plain {plain:.5f} library {lib:.5f} bound "
            f"{bms:.6f} ({bby}); {tflops:.1f} TFLOP/s, kernel/library "
            f"{ms / lib:.2f}{extra}; max|Δ| {err:.3g} <= "
            f"{FA_TOL[dtype]}{rel}")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return dict(rows=rows, max_abs_err=worst)


def ssd_inputs(torch, shape, seed):
    """The reference sweep's recipe on the card: x, B, C normal, dt in
    [0.01, 0.2], A in -[0.5, 2]."""
    B, L, H, P, N, _ = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, L, H, P), generator=gen, device=dev)
    dt = 0.01 + 0.19 * torch.rand((B, L, H), generator=gen, device=dev)
    A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
    Bm = torch.randn((B, L, N), generator=gen, device=dev)
    Cm = torch.randn((B, L, N), generator=gen, device=dev)
    return x, dt, A, Bm, Cm


def carry_bound(B, L, H, P, N, Q, dtype):
    """2·N flops per y element on the CUDA cores; y_intra and the chunk
    states read once (fp32), C and cum, y written in ``dtype`` and the
    final state (fp32)."""
    nc = L // Q
    flops = 2 * B * L * H * N * P + 2 * B * nc * H * N * P
    nbytes = (B * L * H * P * (4 + esize(dtype)) + B * nc * H * N * P * 4
              + B * L * N * esize(dtype) + B * L * H * 4 + B * H * N * P * 4)
    return bound(flops, nbytes, "float32")


def phase_ssd(torch) -> dict:
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.kernel import (TERMS, ssd_carry_cuda,
                                                ssd_chunks_cuda)
    from repro_torch.kernels.ssd.ref import (chunk_cumsum, ssd_carry_ref,
                                             ssd_chunks_ref, ssd_ref)
    log("[ssd] per call, ms: chunk = the chunk kernel (bf16: tensor cores, "
        f"{TERMS} bf16 terms); chunk plain = ssd_chunks_ref; carry = the "
        "carry kernel (y in bf16); carry plain = ssd_carry_ref (ssd_combine "
        "and the cast); scan = the whole ssd() through both kernels vs "
        "ssd_ref; bound = the least time for each kernel's work; no single "
        "PyTorch call computes either function (library_ms = null)")
    rows, worst, carry_worst = {}, 0.0, 0.0

    def hold(shape, name, got, want, bar_rel=SSD_REL):
        nonlocal worst, carry_worst
        err, scale = max_err(torch, got, want), float(want.abs().max())
        if not err <= bar_rel * scale:
            raise AssertionError(f"ssd {shape} {name}: max|Δ| {err} > "
                                 f"{bar_rel} * {scale}")
        if name.startswith("carry"):
            carry_worst = max(carry_worst, err)
        else:
            worst = max(worst, err)
        log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} {name}: max|Δ| {err:.3g} "
            f"<= {bar_rel} * max|ref| {scale:.4g}")

    for i, shape in enumerate(SSD_SWEEP):
        Q = shape[-1]
        x, dt, A, Bm, Cm = ssd_inputs(torch, shape, 200 + i)
        got = ops.ssd(x, dt, A, Bm, Cm, chunk=Q)
        want = ssd_ref(x, dt, A, Bm, Cm, chunk=Q)
        torch.cuda.synchronize()
        errs = [max_err(torch, g, w) for g, w in zip(got, want)]
        if not max(errs) <= SSD_ATOL:
            raise AssertionError(f"ssd {shape}: max|Δ| y {errs[0]}, state "
                                 f"{errs[1]} > {SSD_ATOL}")
        worst = max(worst, *errs)
        log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} float32: max|Δ| y "
            f"{errs[0]:.3g} state {errs[1]:.3g} <= {SSD_ATOL}")
    for i, shape in enumerate(SSD_SERVING):
        B, L, H, P, N, Q = shape
        x, dt, A, Bm, Cm = ssd_inputs(torch, shape, 300 + i)
        # The serving path feeds x, B and C in bf16.
        xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
        del x, Bm, Cm
        cum = chunk_cumsum(dt, A, Q)
        want = tuple(t.contiguous()
                     for t in ssd_chunks_ref(xb, dt, cum, Bb, Cb, Q))
        got = ssd_chunks_cuda(xb, dt, cum, Bb, Cb, Q)
        hold(shape, "y_intra", got[0], want[0])
        hold(shape, "chunk states", got[1], want[1])
        del got
        # The worst ratio to the bar by bf16 term count (the kernel takes
        # TERMS; the others are measured, not held).
        ratios = {}
        for terms in (1, 2, 3):
            g = ssd_chunks_cuda(xb, dt, cum, Bb, Cb, Q, terms=terms)
            ratios[terms] = max(max_err(torch, a, w)
                                / (SSD_REL * float(w.abs().max()))
                                for a, w in zip(g, want))
            del g
        log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} worst max|Δ| / bar by bf16 "
            f"terms: " + ", ".join(f"{t}: {r:.4g}" for t, r in
                                   ratios.items()))
        # The carry kernel against ssd_combine on the plain chunk outputs,
        # with and without an initial state, y in fp32.
        h0 = torch.randn((B, H, N, P), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(400 + i))
        for init, tag in ((None, ""), (h0, " (init state)")):
            gy, gf = ssd_carry_cuda(*want, cum, Cb, Q, init)
            wy, wf = ssd_carry_ref(*want, cum, Cb, Q, init)
            hold(shape, "carry y" + tag, gy, wy)
            hold(shape, "carry final state" + tag, gf, wf)
            del gy, gf, wy, wf
        # The whole scan on the same (bf16-valued) inputs in fp32, so that
        # y is compared before any bf16 rounding; then in bf16, y within
        # one bf16 step of the fp32 reference.
        xf, Bf, Cf = xb.float(), Bb.float(), Cb.float()
        got_scan = ops.ssd(xf, dt, A, Bf, Cf, chunk=Q)
        want_scan = ssd_ref(xf, dt, A, Bf, Cf, chunk=Q)
        hold(shape, "y", got_scan[0], want_scan[0])
        hold(shape, "final state", got_scan[1], want_scan[1])
        del got_scan, xf, Bf, Cf
        yb, fb = ops.ssd(xb, dt, A, Bb, Cb, chunk=Q)
        wy = want_scan[0]
        step = float(((yb.float() - wy).abs()
                      / (2.0 ** -8 * wy.abs() + SSD_REL * float(
                          wy.abs().max()))).max())
        if not step <= 1.0:
            raise AssertionError(f"ssd {shape} bf16 y: {step} times its "
                                 f"bound 2^-8·|ref| + {SSD_REL}·max|ref|")
        hold(shape, "final state (bf16 scan)", fb, want_scan[1])
        log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} y (bf16 scan): worst |Δ| / "
            f"(2^-8·|ref| + {SSD_REL}·max|ref|) {step:.4g} <= 1")
        del yb, fb, want_scan, wy
        yi, st = want
        ms = timed_ms(torch, lambda: ssd_chunks_cuda(xb, dt, cum, Bb, Cb, Q))
        plain = timed_ms(torch, lambda: ssd_chunks_ref(xb, dt, cum, Bb, Cb,
                                                       Q))
        carry = timed_ms(torch, lambda: ssd_carry_cuda(
            yi, st, cum, Cb, Q, None, torch.bfloat16))
        carry_plain = timed_ms(torch, lambda: ssd_carry_ref(
            yi, st, cum, Cb, Q, None, torch.bfloat16))
        scan = timed_ms(torch, lambda: ops.ssd(xb, dt, A, Bb, Cb, chunk=Q))
        scan_plain = timed_ms(torch, lambda: ssd_ref(xb, dt, A, Bb, Cb,
                                                     chunk=Q))
        bms, bby = ssd_bound(*shape, "bfloat16")
        cbms, cbby = carry_bound(*shape, "bfloat16")
        rows[shape] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                           bound_by=bby, carry_ms=carry,
                           carry_plain_ms=carry_plain, carry_bound_ms=cbms,
                           carry_bound_by=cbby, scan_ms=scan,
                           scan_plain_ms=scan_plain, ratios=ratios)
        log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} bfloat16: chunk {ms:.5f} "
            f"plain {plain:.5f} bound {bms:.6f} ({bby}); carry {carry:.5f} "
            f"plain {carry_plain:.5f} bound {cbms:.6f} ({cbby}); scan "
            f"{scan:.5f} vs ssd_ref {scan_plain:.5f}")
        del xb, Bb, Cb, want, yi, st, cum, h0
        torch.cuda.empty_cache()
    return dict(rows=rows, max_abs_err=worst, carry_max_abs_err=carry_worst,
                terms=TERMS)


# ---------------------------------------------------------------------------
# Serving at full width
# ---------------------------------------------------------------------------

# (name, requests, prompt tokens, greedy decode tokens).  (b) is the
# prefill_32k shape's length with its batch cut from 32 to 1 to fit the
# time limit.
REQUESTS = [("a", 4, 2048, 32), ("b", 1, 32768, 8)]
DECODE_BAR = 0.15    # tests/test_models.py: max|Δ| < 0.15·max(max|ref|, 1)


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_request(torch, model, params, B, L, steps, seed, counts=None):
    """Prefill B prompts of L seeded tokens, then ``steps`` greedy decode
    steps, through the serve builders.  ``counts`` (callable → tuple)
    is read around the prefill and the decode loop."""
    from repro_torch.serve.serve_step import build_decode_step, \
        build_prefill
    dev = model.device
    prefill = build_prefill(model, "prefill_32k", device=dev,
                            max_seq=L + steps)
    decode = build_decode_step(model, "decode_32k", device=dev)
    prompt = torch.randint(0, model.cfg.vocab, (B, L), dtype=torch.int64,
                           generator=torch.Generator().manual_seed(seed))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    c0 = counts() if counts else None
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, state = prefill(params, {"tokens": prompt})
    sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    c1 = counts() if counts else None
    tok = logits[:, -1].argmax(-1, keepdim=True)
    fed, dec_logits, step_ms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        fed.append(tok)
        logits, state = decode(params, state, tok)
        dec_logits.append(logits[:, 0])
        tok = logits[:, -1].argmax(-1, keepdim=True)
        sync(torch, dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    c2 = counts() if counts else None
    dec = torch.stack(dec_logits, 1).float()
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError("non-finite decode logits")
    if int(state["length"]) != L + steps:
        raise AssertionError(f"state length {int(state['length'])} != "
                             f"{L + steps}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else float("nan"))
    return dict(prompt=prompt, fed=torch.cat(fed, 1), dec_logits=dec,
                prefill_s=prefill_s, step_ms=step_ms, peak_gib=peak,
                counts=(c0, c1, c2))


def check_decode_vs_forward(torch, model, params, res) -> float:
    """Each decode step's logits against ``forward`` over the prompt plus
    the fed tokens, at the same position.  The forward sequence is padded
    to a whole number of SSD chunks (64) with tokens after every compared
    position, which causality keeps out of the compared logits."""
    prompt, fed = res["prompt"], res["fed"].cpu()
    seq = torch.cat([prompt, fed], 1)
    n = seq.shape[1]
    pad = -n % 64 if n > 64 else 0
    seq = torch.cat([seq, torch.zeros((seq.shape[0], pad),
                                      dtype=seq.dtype)], 1)
    with torch.inference_mode():
        full = model.forward(params, {"tokens": seq.to(model.device)})
    L, steps = prompt.shape[1], fed.shape[1]
    ref = full[:, L:L + steps].float()                   # [B, steps, V]
    err = (res["dec_logits"] - ref).abs().amax(dim=(0, 2))
    bar = DECODE_BAR * ref.abs().amax(dim=(0, 2)).clamp(min=1.0)
    if not bool((err < bar).all()):
        raise AssertionError(f"decode vs forward: max|Δ| per step "
                             f"{err.tolist()} vs bars {bar.tolist()}")
    worst = int((err / bar).argmax())
    log(f"[serve] decode vs forward over {L} + {steps} tokens (padded to "
        f"{seq.shape[1]}), each step under its bar; closest step {worst}: "
        f"max|Δ| {float(err[worst]):.4g} < {float(bar[worst]):.4g}; "
        f"max|Δ| over all steps {float(err.max()):.4g}")
    return float(err.max())


def device_breakdown(torch, fn) -> dict:
    """Device time (ms) of one call of ``fn`` by kernel, from a
    ``torch.profiler`` trace: the ported kernels by name (``ssd_chunk``
    covers ``ssd_chunk_tc`` and ``ssd_chunk_kernel``, ``ssd_carry`` covers
    ``ssd_carry_tc`` and ``ssd_carry_kernel``), every other device kernel
    as ``other``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"fa_kernel": 0.0, "ssd_chunk": 0.0, "ssd_carry": 0.0,
           "other": 0.0}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        name = next((n for n in out if n in ev.key), "other")
        out[name] += us / 1e3
    return out


def check_breakdown(by: dict, what: str) -> None:
    """A prefill runs all three ported kernels: each must show device
    time in its own column."""
    missing = [k for k in ("fa_kernel", "ssd_chunk", "ssd_carry")
               if not by[k] > 0]
    if missing:
        raise AssertionError(f"{what}: no device time under {missing}")


def phase_serving(torch) -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import build
    from repro_torch.models.hybrid import n_attn_apps
    from repro_torch.serve.serve_step import build_decode_step, \
        build_prefill
    model = build("zamba2-1.2b", device="cuda")
    cfg = model.cfg
    t0 = time.perf_counter()
    # Parameters at the RunConfig's param_dtype (fp32), as the reference
    # serves them; the layers cast to the compute dtype as they go.
    params = model.init(0)
    torch.cuda.synchronize()
    log(f"[serve] zamba2-1.2b: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {model.n_params():,} parameters from a seeded "
        f"generator in {time.perf_counter() - t0:.3f} s, parameters "
        f"{model.run.param_dtype}, compute {model.run.compute_dtype}")
    per_prefill = (n_attn_apps(cfg), cfg.n_layers, cfg.n_layers)
    # Warm-up request (cuBLAS handles, the allocator's pools, first
    # launches), outside the timed and counted run.
    serve_request(torch, model, params, 1, 64, 2, seed=0)
    fa_ops.LAUNCHES = 0
    ssd_ops.LAUNCHES = 0
    ssd_ops.CARRY_LAUNCHES = 0
    counts = lambda: (fa_ops.LAUNCHES, ssd_ops.LAUNCHES,  # noqa: E731
                      ssd_ops.CARRY_LAUNCHES)
    results = {}
    for name, B, L, steps in REQUESTS:
        res = serve_request(torch, model, params, B, L, steps, seed=L,
                            counts=counts)
        c0, c1, c2 = res["counts"]
        got = tuple(b - a for a, b in zip(c0, c1))
        if got != per_prefill:
            raise AssertionError(f"({name}) prefill launched {got} (FA, "
                                 f"SSD chunk, SSD carry) kernels, expected "
                                 f"{per_prefill}")
        if c2 != c1:
            raise AssertionError(f"({name}) decode launched a prefill "
                                 f"kernel")
        results[name] = res
        step_ms = res["step_ms"]
        log(f"[serve] ({name}) {B} x {L}-token prompts: prefill "
            f"{res['prefill_s']:.3f} s ({B * L / res['prefill_s']:.1f} "
            f"tokens/s), {got[0]} FA + {got[1]} SSD chunk + {got[2]} SSD "
            f"carry launches; {steps} "
            f"greedy decode steps: median {statistics.median(step_ms):.3f} "
            f"ms, max {max(step_ms):.3f} ms per step (host clock, "
            f"synchronised), {B * steps * 1e3 / sum(step_ms):.1f} tokens/s; "
            f"peak allocated {res['peak_gib']:.3f} GiB")
    launches = counts()
    check_decode_vs_forward(torch, model, params, results["a"])
    # Where the device time goes: one more prefill and decode step of each
    # request set under the profiler; idle share against the unprofiled
    # wall times above.
    for name, B, L, _ in REQUESTS:
        res = results[name]
        prompt = res["prompt"].cuda()
        prefill = build_prefill(model, "prefill_32k", max_seq=L + 1)
        decode = build_decode_step(model, "decode_32k")
        _, state = prefill(params, {"tokens": prompt})
        tok = res["fed"][:, :1]
        for what, fn, wall_ms in (
                ("prefill", lambda: prefill(params, {"tokens": prompt}),
                 res["prefill_s"] * 1e3),
                ("decode step", lambda: decode(params, state, tok),
                 statistics.median(res["step_ms"]))):
            by = device_breakdown(torch, fn)
            if what == "prefill":
                check_breakdown(by, f"({name}) prefill")
            busy = sum(by.values())
            log(f"[serve] ({name}) {what} device time by kernel, ms: "
                + ", ".join(f"{k} {v:.3f}" for k, v in by.items())
                + f"; busy {busy:.3f} of {wall_ms:.3f} wall, idle share "
                f"{max(0.0, 1 - busy / wall_ms):.4f}")
        del state
    return dict(fa_launches=launches[0], ssd_launches=launches[1],
                carry_launches=launches[2])


def main() -> int:
    import torch
    smi = phase_device(torch)
    phase_build()
    k = phase_kernel(torch)
    phase_parity()
    launches = phase_full_width(torch, k["link_rate"])
    fa = phase_attention(torch)
    sd = phase_ssd(torch)
    serve = phase_serving(torch)
    head = k["rows"][HEADLINE]
    fa_head = fa["rows"][FA_HEADLINE]
    ssd_head = sd["rows"][SSD_HEADLINE]
    B, L, H, D, _, _ = FA_HEADLINE
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
        "round_ms": head["round_ms"],
        "link_ms": head["link_ms"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "launches": serve["fa_launches"],
        "max_abs_err": fa["max_abs_err"],
        "ms": fa_head["ms"],
        "plain_ms": fa_head["plain_ms"],
        "bound_ms": fa_head["bound_ms"],
        "bound_by": fa_head["bound_by"],
        "library_ms": fa_head["library_ms"],
        "shape": [B, H, L, D],
        "tflops": fa_head["tflops"],
    }, {
        "name": "ssd_chunk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:22",
        "launches": serve["ssd_launches"],
        "max_abs_err": sd["max_abs_err"],
        "ms": ssd_head["ms"],
        "plain_ms": ssd_head["plain_ms"],
        "bound_ms": ssd_head["bound_ms"],
        "bound_by": ssd_head["bound_by"],
        "library_ms": None,
        "shape": list(SSD_HEADLINE),
        "terms": sd["terms"],
    }, {
        "name": "ssd_carry",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        # No Pallas kernel: the reference's jax.lax.scan and einsum.
        "replaces": "src/repro/kernels/ssd/ops.py:40",
        "tpu_kernel": False,
        "launches": serve["carry_launches"],
        "max_abs_err": sd["carry_max_abs_err"],
        "ms": ssd_head["carry_ms"],
        "plain_ms": ssd_head["carry_plain_ms"],
        "bound_ms": ssd_head["carry_bound_ms"],
        "bound_by": ssd_head["carry_bound_by"],
        "library_ms": None,
        "shape": list(SSD_HEADLINE),
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
