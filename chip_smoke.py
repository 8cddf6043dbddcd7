#!/usr/bin/env python3
"""Smoke test of the repro_torch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device — requires CUDA, prints the card's name and power limit; turns
   TF32 off for matmuls and cuDNN (the reference's numbers are fp32 or
   bf16, never TF32);
2. build — compiles the four kernel sources from ``src/`` with nvcc
   (affinity, flash attention forward and backward, SSD), one process
   per source, started together; prints each build's registers, shared
   memory and spills;
3. affinity kernel vs plain — the CUDA kernel against the plain torch
   version on the card, bitwise, at the reference tests' shapes, the
   main paths' round buckets (the five most frequent of phases 5, 8 and
   10 among them; the three phases check it) and a large round, both
   through
   the nine-tensor wrapper and through a packed round (stage, one copy
   over, the kernel, one copy back, one wait); prints per-shape times,
   the packed round's time and its link bound at a host-to-device rate
   measured from one large page-locked copy;
4. engine parity — ``simulate_batch`` scoring rounds on the card against
   the host-only ``SimEngine``, identical results;
5. full width — the paper cell (100 workflows of all sizes at 12 wf/min,
   all five policies, seed 0) through ``simulate_batch`` on the card;
6. attention and SSD kernels vs plain — flash attention and the SSD
   chunk and carry kernels against their plain torch versions on the
   card at the reference sweep's shapes and at zamba2-1.2b's (and
   mamba2-780m's) serving shapes, both request sets' lengths included;
   flash attention also at head dim 80 (causal and not, fp32 and bf16)
   and at phase 9's serving shapes (head dims 128, 80 and 64, hubert's
   [4,16,2048,80] in both dtypes)
   (bf16 attention, on the tensor-core kernel at every head width,
   element by element within one bf16 step of the plain version; the
   bf16 SSD chunk pass on the tensor cores, with the worst ratio to its
   bar at one, two and three bf16 terms); prints kernel, plain, bound
   and library times and achieved TFLOP/s, and the whole ``ssd()``;
   flash attention's forward also at phase 11's [2, 32, 4096, 128]; the
   three backward kernels (``flash_attention_bwd.cu``) against
   ``attention_bwd_ref`` at the sweep's shapes, head dim 80, phase 11
   (b)'s four archs' attention and [2, 32, 4096, 128] bf16 causal (fp32
   within 1e-4·max(max|ref|, 1), bf16 per element within
   2^-7·|ref| + 1e-5·max|ref|), the forward's log-sum-exp against
   ``attention_lse_ref``; backward, per-kernel, plain, bound and library
   (SDPA forward and backward minus forward) times;
7. serving at full width — zamba2-1.2b (38 layers, d_model 2048, seeded
   random fp32 weights, bf16 compute) through ``build`` and the serve
   builders:
   after an untimed warm-up request, (a) 4 requests × 2048-token
   prompts, 32 greedy decode tokens each, every step held against
   ``forward``; (b) 1 request × 32,768-token prompt, 8 decode tokens.
   Every prefill's attention and SSD (chunk and carry) go through the
   kernels (launch counts checked); a ``torch.profiler`` pass then splits
   one prefill and one decode step of each by kernel and gives the
   device's idle share;
8. experiments — the harness through ``repro_torch.exp.run``: two
   processes started together build the affinity library into an
   emptied build directory (one library left, each launch equal to the
   plain version); (a) ``paper-smoke`` through ``main`` on a two-worker
   spawn pool on the card and in one process on the CPU, one cell per
   batch; (b) ``online-smoke`` and ``online-chaos-smoke`` on the card and
   on the CPU — the card's artifacts equal the CPU's field by field but
   for ``wall_s``, ``use_pallas`` and ``workers``, every trace, JSONL,
   ``monitor.json`` and dashboard file byte-identical, ``--check-floors``
   passing; ``online-chaos-smoke`` stopped after two stream checkpoints
   (exit 3) and resumed equals the uninterrupted run; (c) the paper
   grid's hottest workload cell (montage, 12 wf/min, budgets 0.25–0.5,
   100 workflows of all sizes, five policies, seed 0) through
   ``run_grid(workers=1, device="cuda")``: 23,005 launches, dispatch
   7,928 rounds / 3,051 batched calls, every task placed and every
   makespan and cost finite, rounds timed as in phase 5; then the same
   cell through ``run_grid(device="cpu")``, whose artifact the card's
   equals but for the backend fields;
9. transformer families at full width — llama3-8b (dense, 32 layers,
   d_model 4096, GQA 32/8, head dim 128), qwen2-moe-a2.7b (MoE, 24
   layers, 60→64 experts, top-4, shared FFN 5632, bf16 weights),
   hubert-xlarge (audio encoder, 48 layers, head dim 80, non-causal) and
   internvl2-1b (VLM, 24 layers, head dim 64, 256 patch embeddings),
   seeded random weights, bf16 compute, through ``build`` and the serve
   builders: after an untimed warm-up request, 4 × 2048-position
   prompts and 16 greedy decode tokens (hubert: prefill only); one FA
   launch per layer in every prefill and none in decode (counts
   checked); each decode step held against ``forward``, hubert's
   prefill against the same prefill with the plain attention; the MoE
   router on the card against the CPU on layer 0's input; prefill s,
   decode ms per step, peak GiB and a ``torch.profiler`` split of one
   prefill and decode step;
10. WaaS platform — ``repro_torch.waas.platform.sweep`` on the card and
   on the CPU at its defaults (no round reaches the auction) and at 400
   jobs at 1000 per minute (978 rounds, one affinity launch each, the
   five most frequent buckets held in phase 3): rows equal, launches
   equal to the CPU's count of rounds; then ``straggler_experiment``
   with slowdowns 2 and 4 on both devices, rows equal;
11. training at full width — seeded fp32 weights, bf16 compute, remat
   "dots", through ``build``, ``make_train_step`` and
   ``data.pipeline.batch_at``: (a) llama3-8b, 4 of its 32 layers (32 do
   not fit with AdamW state), 2 x 4096 tokens, one warm-up and 6 timed
   steps: step s, tokens/s, peak GiB, launches per step checked (one FA
   forward per layer, kept by the remat policy; one backward pass of
   three kernels per layer), a ``torch.profiler`` split of one more
   step, its idle share against that step's own wall;
   (b) llama3-8b, qwen2-moe-a2.7b, hubert-xlarge and internvl2-1b at 2
   layers, 1 x 2048: one step's loss and every gradient leaf held
   against the same step with the plain attention on the card (the MoE
   router's experts pinned between the two); (c) ``FaultyTrainer``
   (fail_prob 0.25, seed 1) over 15 steps of llama3-8b smoke on the card
   and on the CPU: same restarts, failed steps and history, losses
   within 2e-2, the card's last checkpoint restored on the CPU bit for
   bit; (d) ``ssd`` under grad on the card raises.

The second-last lines are the kernel record (JSON) and the card's
``nvidia-smi`` name and power limit; the last line is the device record.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import re
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
# main paths' round buckets (half their rows inert), among them the
# HELD_TOP most frequent of phase 5's paper cell, of phase 8's hot cell and
# of phase 10's WaaS sweep (the three phases check that), and one large
# round.
TEST_TV = [(16, 32), (37, 100), (64, 7), (1, 1)]
BUCKETS = [(1, 64, 64), (1, 64, 128), (1, 512, 128), (2, 512, 512),
           (1, 256, 1024), (4, 4, 1024),
           (1, 256, 256), (1, 512, 256), (1, 256, 512), (1, 2, 512),
           (4, 2, 1024), (2, 256, 512), (1, 512, 512),
           (1, 8, 256), (1, 4, 256), (1, 2, 256), (2, 8, 256),
           (2, 16, 256)]
HELD_TOP = 5
LARGE = (16, 1024, 1024)
HEADLINE = (1, 256, 1024)      # the shape the kernel record reports
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
    return {"affinity": aff.LIB, "flash_attention": fa.LIB,
            "flash_attention_bwd": fa.LIB_BWD, "ssd": ssd.LIB}


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


def timed_rounds(torch, fn):
    """Run ``fn()`` with the affinity launch count set to 0 and every
    round's host-clock time (copy-in, scoring, copy-back, wait) summed
    through the ``cycles._score_round`` seam.  Returns ``fn``'s result,
    the wall, the launches, the rounds by ``[B, T, V]`` bucket, the
    seconds in rounds and the bytes the rounds moved over the link."""
    from repro_torch.core import cycles
    from repro_torch.kernels.affinity import ops
    buckets = collections.Counter()
    round_s = [0.0]
    link_bytes = [0]
    score_round = cycles._score_round

    def counted(cfg_, view):
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
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES
    finally:
        cycles._score_round = score_round
    if launches <= 0:
        raise AssertionError("the run launched no affinity kernel")
    if sum(buckets.values()) != launches:
        raise AssertionError("bucket count disagrees with the launch count")
    return out, wall, launches, buckets, round_s[0], link_bytes[0]


def check_held(tag, buckets) -> None:
    """The run's ``HELD_TOP`` most frequent round buckets are among the
    shapes phase 3 holds against the plain version."""
    top = [tuple(b) for b, _ in buckets.most_common(HELD_TOP)]
    missing = [b for b in top if b not in BUCKETS]
    if missing:
        raise AssertionError(f"[{tag}] frequent buckets {missing} are not "
                             f"held against the plain version in phase 3")
    log(f"[{tag}] the {HELD_TOP} most frequent buckets {top} are held "
        f"against the plain version in phase 3")


def log_rounds(tag, wall, launches, buckets, round_s, link_bytes, rate):
    log(f"[{tag}] wall {wall:.3f} s, kernel launches {launches} "
        f"({launches / wall:.1f} per s of wall), rounds on "
        f"the card (H2D + kernel + D2H + wait, host clock) "
        f"{round_s:.3f} s = {round_s / wall:.4f} of wall, "
        f"{round_s / launches * 1e3:.5f} ms per round; their "
        f"{link_bytes / 1e9:.4f} GB over the link need "
        f"{link_bytes / rate:.4f} s at {rate / 1e9:.3f} GB/s")
    top = ", ".join(f"{list(k)}x{v}" for k, v in buckets.most_common(12))
    log(f"[{tag}] launches by [B,T,V] bucket ({len(buckets)} buckets): "
        f"{top}")


def phase_full_width(torch, rate: float) -> int:
    from repro_torch.core.batch_engine import simulate_batch
    from repro_torch.core.scheduler import ALL_POLICIES
    from repro_torch.core.types import PlatformConfig
    from repro_torch.workflows.workload import WorkloadSpec, \
        generate_workload
    cfg = PlatformConfig()
    spec = WorkloadSpec(n_workflows=100, arrival_rate_per_min=12.0, seed=0,
                        sizes=("small", "medium", "large"))
    wl = generate_workload(cfg, spec)
    n_tasks = sum(w.n_tasks for w in wl)
    grid, wall, launches, buckets, round_s, link_bytes = timed_rounds(
        torch, lambda: simulate_batch(cfg, ALL_POLICIES, wl, seed=0))
    log(f"[full] paper cell: {len(wl)} workflows, {n_tasks} tasks, "
        f"{len(ALL_POLICIES)} policies, seed 0")
    log_rounds("full", wall, launches, buckets, round_s, link_bytes, rate)
    check_held("full", buckets)
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
# test_flash_attention_sweep).
FA_SWEEP = [(2, 256, 4, 64, True, "float32"),
            (1, 128, 2, 128, False, "float32"),
            (2, 200, 3, 64, True, "float32"),
            (1, 96, 1, 32, True, "float32"),
            (2, 256, 2, 64, True, "bfloat16"),
            (1, 128, 2, 128, False, "bfloat16"),
            (2, 200, 3, 64, True, "bfloat16"),
            (1, 96, 1, 32, True, "bfloat16")]
# Head dim 80 (hubert-xlarge's), causal and not, in both dtypes.
FA_D80 = [(2, 200, 3, 80, True, "float32"),
          (2, 200, 3, 80, False, "float32"),
          (2, 200, 3, 80, True, "bfloat16"),
          (2, 200, 3, 80, False, "bfloat16")]
# The serving paths' shapes after GQA's head repeat: zamba2-1.2b's request
# sets (a) and (b) (phase 7), then phase 9's llama3-8b, qwen2-moe-a2.7b,
# hubert-xlarge (also in fp32, held to 2e-5) and internvl2-1b at 4 x 2048.
FA_SERVING = [(4, 2048, 32, 64, True, "bfloat16"),
              (1, 32768, 32, 64, True, "bfloat16"),
              (4, 2048, 32, 128, True, "bfloat16"),
              (4, 2048, 16, 128, True, "bfloat16"),
              (4, 2048, 16, 80, False, "bfloat16"),
              (4, 2048, 16, 80, False, "float32"),
              (4, 2048, 16, 64, True, "bfloat16")]
FA_HEADLINE = FA_SERVING[0]
# Phase 11 (a)'s attention: llama3-8b at 2 x 4096 tokens (train_4k's
# sequence), GQA's heads repeated; forward and backward are timed here.
FA_TRAIN = (2, 4096, 32, 128, True, "bfloat16")
# The backward kernels (flash_attention_bwd.cu) against attention_bwd_ref:
# the reference sweep, head dim 80, phase 11 (b)'s four archs' attention
# at 1 x 2048 (llama3-8b, qwen2-moe-a2.7b, hubert-xlarge non-causal,
# internvl2-1b) and the headline training shape.
FA_BWD_SHAPES = FA_SWEEP + FA_D80 + [(1, 2048, 32, 128, True, "bfloat16"),
                                     (1, 2048, 16, 128, True, "bfloat16"),
                                     (1, 2048, 16, 80, False, "bfloat16"),
                                     (1, 2048, 16, 64, True, "bfloat16"),
                                     FA_TRAIN]
# Bars of dq, dk, dv against attention_bwd_ref (the plain version in fp32
# on the same inputs, o and lse): fp32 max|Δ| <= 1e-4·max(max|ref|, 1);
# bf16 per element |Δ| <= 2^-7·|ref| + 1e-5·max|ref| of the tensor (the
# kernels compute in fp32 and round once to bf16).  The forward's lse and
# the preprocess kernel's D: max|Δ| <= 1e-4·max(max|ref|, 1).
FA_BWD_F32 = 1e-4
FA_BWD_BF16_REL, FA_BWD_BF16_ABS = 2.0 ** -7, 1e-5
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
    for i, shape in enumerate(FA_SWEEP + FA_D80 + FA_SERVING + [FA_TRAIN]):
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


def fa_bwd_bounds(B, L, H, D, causal, dtype):
    """(least ms, what bounds it) of the whole backward and of each
    kernel, from the work each must do: the backward 10·D flops per
    unmasked pair (S, dP, dV, dK, dQ at 2·D each) and q, k, v, o, dO, lse
    read, dq, dk, dv written once; dK/dV 8·D per pair (S, dP, dV, dK); dQ
    6·D (S, dP, dQ); the preprocess 2·D flops per row, o and dO read and
    D written."""
    pairs = fa_pairs(B, L, H, causal)
    tile = B * L * H * D * esize(dtype)
    stat = B * H * L * 4
    return {"backward": bound(10 * D * pairs, 8 * tile + stat, dtype),
            "preprocess": bound(2 * D * B * L * H, 2 * tile + stat, dtype),
            "dkdv": bound(8 * D * pairs, 6 * tile + 2 * stat, dtype),
            "dq": bound(6 * D * pairs, 5 * tile + 2 * stat, dtype)}


def bwd_ratio(torch, got, want, dtype) -> float:
    """Worst |Δ| over its bar (at most 1 passes)."""
    g, w = got.float(), want.float()
    if dtype == "float32":
        return float((g - w).abs().max()) / (
            FA_BWD_F32 * max(float(w.abs().max()), 1.0))
    bar = FA_BWD_BF16_REL * w.abs() + FA_BWD_BF16_ABS * float(w.abs().max())
    return float(((g - w).abs() / bar).max())


def phase_attention_bwd(torch) -> dict:
    """The three backward kernels against attention_bwd_ref (and the
    forward's lse against attention_lse_ref) on the card; times of the
    whole backward and of each kernel, the plain version, the bound and
    the library call's backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    dev = torch.device("cuda")
    log("[fa-bwd] per call, ms (CUDA events, median after a warm-up): "
        "backward = fa_bwd_preprocess + fa_bwd_dkdv + fa_bwd_dq through "
        "flash_attention_bwd_cuda (CUDA cores, fp32 arithmetic); plain = "
        "attention_bwd_ref on the card (and each kernel's own plain "
        "step); library = F.scaled_dot_product_attention(is_causal) "
        "forward and backward minus its forward, on [B, H, L, D] views "
        "(timed only, never used by the port); bound = the least time for "
        "each one's work (backward 10·D flops per pair at the dtype's "
        "peak) and what bounds it")
    rows, worst = {}, 0.0
    for i, shape in enumerate(FA_BWD_SHAPES):
        B, L, H, D, causal, dtype = shape
        gen = torch.Generator(device=dev).manual_seed(300 + i)
        tdt = getattr(torch, dtype)
        q, k, v, do = (torch.randn((B, L, H, D), generator=gen, device=dev)
                       .to(tdt) for _ in range(4))
        o, lse = fa.flash_attention_cuda(q, k, v, causal, lse=True)
        want_lse = ref.attention_lse_ref(q, k, causal)
        delta = fa.bwd_preprocess_cuda(o, do)
        want_delta = ref.bwd_preprocess_ref(o, do)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal)
        want = ref.attention_bwd_ref(q, k, v, o, do, lse, causal)
        torch.cuda.synchronize()
        for what, g, w in (("lse", lse, want_lse), ("D", delta, want_delta)):
            err = max_err(torch, g, w)
            if not err <= FA_BWD_F32 * max(float(w.abs().max()), 1.0):
                raise AssertionError(f"flash attention {what} {shape}: "
                                     f"max|Δ| {err}")
        ratios = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.dtype != tdt or g.shape != w.shape:
                raise AssertionError(f"backward {shape}: {name} is "
                                     f"{g.dtype} {list(g.shape)}")
            ratios[name] = bwd_ratio(torch, g, w, dtype)
            if not ratios[name] <= 1.0:
                raise AssertionError(
                    f"flash attention backward {shape}: {name}'s worst "
                    f"|Δ| is {ratios[name]} times its bar")
            worst = max(worst, max_err(torch, g, w))
        del got, want
        ms = {
            "backward": timed_ms(torch, lambda: fa.flash_attention_bwd_cuda(
                q, k, v, o, do, lse, causal), 0.2),
            "preprocess": timed_ms(torch, lambda: fa.bwd_preprocess_cuda(
                o, do), 0.1),
            "dkdv": timed_ms(torch, lambda: fa.bwd_dkdv_cuda(
                q, k, v, do, lse, delta, causal), 0.2),
            "dq": timed_ms(torch, lambda: fa.bwd_dq_cuda(
                q, k, v, do, lse, delta, causal), 0.2)}
        plain = {
            "backward": timed_ms(torch, lambda: ref.attention_bwd_ref(
                q, k, v, o, do, lse, causal), 0.2),
            "preprocess": timed_ms(torch, lambda: ref.bwd_preprocess_ref(
                o, do), 0.1),
            "dkdv": timed_ms(torch, lambda: ref.bwd_dkdv_ref(
                q, k, v, do, lse, delta, causal), 0.2),
            "dq": timed_ms(torch, lambda: ref.bwd_dq_ref(
                q, k, v, do, lse, delta, causal), 0.2)}
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def lib_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        def lib_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        lib = timed_ms(torch, lib_fwd_bwd, 0.2) - timed_ms(torch, lib_fwd,
                                                          0.1)
        bounds = fa_bwd_bounds(B, L, H, D, causal, dtype)
        rows[shape] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bounds=bounds, ratios=ratios)
        parts = "; ".join(
            f"{k} {ms[k]:.5f} (plain {plain[k]:.5f}, bound "
            f"{bounds[k][0]:.6f} {bounds[k][1]})"
            for k in ("preprocess", "dkdv", "dq"))
        log(f"[fa-bwd] [B,H,L,D]={[B, H, L, D]} causal={causal} {dtype}: "
            f"backward {ms['backward']:.5f} plain {plain['backward']:.5f} "
            f"library {lib:.5f} bound {bounds['backward'][0]:.6f} "
            f"({bounds['backward'][1]}), backward/library "
            f"{ms['backward'] / lib:.2f}; {parts}; worst |Δ|/bar "
            + ", ".join(f"{k} {r:.4g}" for k, r in ratios.items())
            + " <= 1")
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot
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


def prompt_batch(torch, cfg, B, L, seed) -> dict:
    """B seeded prompts of L positions, on the host: tokens, with the VLM
    family's patch embeddings (they overwrite the first ``n_patches``
    positions), or the audio family's frame embeddings."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.frame_dim:
        return {"frames": torch.randn((B, L, cfg.frame_dim),
                                      generator=gen).bfloat16()}
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, L), dtype=torch.int64,
                                     generator=gen)}
    if cfg.n_patches:
        batch["patches"] = torch.randn((B, cfg.n_patches, cfg.patch_dim),
                                       generator=gen).bfloat16()
    return batch


def serve_request(torch, model, params, B, L, steps, seed, counts=None):
    """Prefill B seeded prompts of L positions, then ``steps`` greedy
    decode steps, through the serve builders (an encoder-only arch:
    prefill only, ``steps`` = 0).  ``counts`` (callable → tuple) is read
    around the prefill and the decode loop."""
    from repro_torch.serve.serve_step import build_decode_step, \
        build_prefill
    dev = model.device
    prefill = build_prefill(model, "prefill_32k", device=dev,
                            max_seq=L + steps)
    prompt = prompt_batch(torch, model.cfg, B, L, seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    c0 = counts() if counts else None
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, state = prefill(params, prompt)
    sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    c1 = counts() if counts else None
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("non-finite prefill logits")
    if steps:
        decode = build_decode_step(model, "decode_32k", device=dev)
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
    dec = None
    if steps:
        dec = torch.stack(dec_logits, 1).float()
        if not bool(torch.isfinite(dec).all()):
            raise AssertionError("non-finite decode logits")
        if int(state["length"]) != L + steps:
            raise AssertionError(f"state length {int(state['length'])} != "
                                 f"{L + steps}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else float("nan"))
    return dict(prompt=prompt, fed=torch.cat(fed, 1) if fed else None,
                logits=logits, dec_logits=dec, prefill_s=prefill_s,
                step_ms=step_ms, peak_gib=peak, counts=(c0, c1, c2))


def check_decode_vs_forward(torch, model, params, res,
                            tag="serve") -> float:
    """Each decode step's logits against ``forward`` over the prompt plus
    the fed tokens, at the same position.  The forward sequence is padded
    to a whole number of SSD chunks (64) with tokens after every compared
    position, which causality keeps out of the compared logits."""
    prompt, fed = res["prompt"], res["fed"].cpu()
    seq = torch.cat([prompt["tokens"], fed], 1)
    n = seq.shape[1]
    pad = -n % 64 if n > 64 else 0
    seq = torch.cat([seq, torch.zeros((seq.shape[0], pad),
                                      dtype=seq.dtype)], 1)
    batch = dict(prompt, tokens=seq)
    with torch.inference_mode():
        full = model.forward(params, {k: v.to(model.device)
                                      for k, v in batch.items()})
    L, steps = prompt["tokens"].shape[1], fed.shape[1]
    ref = full[:, L:L + steps].float()                   # [B, steps, V]
    err = (res["dec_logits"] - ref).abs().amax(dim=(0, 2))
    bar = DECODE_BAR * ref.abs().amax(dim=(0, 2)).clamp(min=1.0)
    if not bool((err < bar).all()):
        raise AssertionError(f"decode vs forward: max|Δ| per step "
                             f"{err.tolist()} vs bars {bar.tolist()}")
    worst = int((err / bar).argmax())
    log(f"[{tag}] decode vs forward over {L} + {steps} tokens (padded to "
        f"{seq.shape[1]}), each step under its bar; closest step {worst}: "
        f"max|Δ| {float(err[worst]):.4g} < {float(bar[worst]):.4g}; "
        f"max|Δ| over all steps {float(err.max()):.4g}")
    return float(err.max())


def device_breakdown(torch, fn,
                     names=("fa_kernel", "ssd_chunk", "ssd_carry"),
                     span=None) -> dict:
    """Device time (ms) of one call of ``fn`` by kernel, from a
    ``torch.profiler`` trace: the ported kernels by name (``ssd_chunk``
    covers ``ssd_chunk_tc`` and ``ssd_chunk_kernel``, ``ssd_carry`` covers
    ``ssd_carry_tc`` and ``ssd_carry_kernel``, ``fa_kernel`` the forward
    flash-attention kernels), every other device kernel as ``other``.
    A ``span`` list gets the profiled call's own wall time (ms, host
    clock, synchronised), so that busy and wall come from one run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if span is not None:
            span.append((time.perf_counter() - t0) * 1e3)
    out = dict.fromkeys(names + ("other",), 0.0)
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
        prompt = {k: v.cuda() for k, v in res["prompt"].items()}
        prefill = build_prefill(model, "prefill_32k", max_seq=L + 1)
        decode = build_decode_step(model, "decode_32k")
        _, state = prefill(params, prompt)
        tok = res["fed"][:, :1]
        for what, fn, wall_ms in (
                ("prefill", lambda: prefill(params, prompt),
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


# ---------------------------------------------------------------------------
# Experiments: the harness end to end
# ---------------------------------------------------------------------------

# Backend fields of an artifact: everything else must match between the
# card and the CPU.
BACKEND_FIELDS = ("wall_s", "use_pallas", "workers")
# The paper grid's workload cell that sends the most auction rounds to
# the kernel among those timed on the reference; its dispatch counts do
# not depend on the device (the dispatcher decides on pair counts).
HOT_CELL = dict(apps=("montage",), rates=(12.0,),
                budget_intervals=((0.25, 0.5),), seeds=(0,))
HOT_CELL_DISPATCH = {"rounds": 7928, "batched_calls": 3051}
# Rounds the cell scores, counted at the ``_score_round`` seam of a CPU
# run: one kernel launch each on the card.
HOT_CELL_LAUNCHES = 23005

BUILD_RACE = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.kernels.affinity.kernel import LIB, affinity_cuda
from repro_torch.kernels.affinity.ref import affinity_ref
LIB.load()
args = [torch.from_numpy(a).cuda() for a in
        cs.make_round(np.random.default_rng(int(sys.argv[2])), 2, 512, 512,
                      100)]
want = affinity_ref(*args, **cs.GS)
got = affinity_cuda(*args, **cs.GS)
assert all(torch.equal(a, b) for a, b in zip(want, got)), "kernel != plain"
print("nvcc", LIB.build_info.get("seconds"))
"""


def build_race() -> None:
    """Two processes started together each build the affinity library
    into an emptied build directory, load it and hold one launch against
    the plain version: concurrent first builds leave one library and no
    partial file."""
    from repro_torch.kernels.affinity.kernel import LIB
    shutil.rmtree(LIB.build_root, ignore_errors=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_RACE, str(ROOT),
                               str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"concurrent build failed:\n{err[-3000:]}")
    files = sorted(str(f.relative_to(LIB.build_root))
                   for f in LIB.build_root.rglob("*") if f.is_file())
    if len(files) != 1 or not files[0].endswith("libaffinity.so"):
        raise AssertionError(f"concurrent builds left {files}")
    nvcc_s = "; ".join(out.strip() for out, _ in outs)
    log(f"[exp] two processes built the affinity library at once in "
        f"{time.perf_counter() - t0:.3f} s ({nvcc_s} s): one library "
        f"left, {files[0]}; each launch equal to the plain version")


def exp_cli(args, expect_exit=None) -> float:
    """``repro_torch.exp.run.main(args)``; returns its wall.  A run meant
    to stop (``expect_exit``) must exit with that code."""
    from repro_torch.exp import run as exp_run
    t0 = time.perf_counter()
    try:
        exp_run.main(args)
    except SystemExit as e:
        if expect_exit is None or e.code != expect_exit:
            raise
    else:
        if expect_exit is not None:
            raise AssertionError(f"{args}: expected exit {expect_exit}")
    return time.perf_counter() - t0


def exp_args(grid: str, out: Path, device: str, *extra) -> list:
    return ["--grid", grid, "--device", device, "--out", str(out),
            "--trace-dir", str(out / "traces"),
            "--report-dir", str(out / "reports"), *extra]


def same_runs(a: Path, b: Path, what: str, skip=BACKEND_FIELDS) -> dict:
    """Artifacts equal field by field except ``skip``; reports equal but
    for the wall; every trace and report file byte-identical."""
    from repro_torch.exp import run as exp_run
    got = json.loads((a / exp_run.ARTIFACT_NAME).read_text())
    want = json.loads((b / exp_run.ARTIFACT_NAME).read_text())
    diff = sorted(k for k in set(got) | set(want)
                  if k not in skip and got.get(k) != want.get(k))
    if diff:
        raise AssertionError(f"{what}: artifacts differ in {diff}")
    md = [re.sub(r"wall [0-9.]+s", "wall", (d / exp_run.REPORT_NAME)
                 .read_text()) for d in (a, b)]
    if md[0] != md[1]:
        raise AssertionError(f"{what}: {exp_run.REPORT_NAME} differs")
    n = 0
    for sub in ("traces", "reports"):
        names = sorted(p.name for p in (b / sub).iterdir())
        if not names or sorted(p.name for p in (a / sub).iterdir()) != names:
            raise AssertionError(f"{what}: {sub} file lists differ")
        for name in names:
            if (a / sub / name).read_bytes() != (b / sub / name).read_bytes():
                raise AssertionError(f"{what}: {sub}/{name} differs")
        n += len(names)
    log(f"[exp] {what}: artifacts equal but for {', '.join(skip)}; "
        f"{n} trace and report files byte-identical")
    return got


def phase_experiments(torch, rate: float) -> dict:
    """The harness through ``repro_torch.exp.run``: smoke grids on the
    card against the CPU, a stream interrupted and resumed, the floor
    gate, then the paper grid's hottest workload cell at full width."""
    import dataclasses
    import tempfile
    from repro_torch.core.types import PlatformConfig
    from repro_torch.exp import run as exp_run
    from repro_torch.exp.scenarios import get_scenario
    from repro_torch.kernels.affinity import ops
    from repro_torch.workflows.workload import cell_workload
    build_race()
    walls = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_exp_"))
    try:
        # (a) paper-smoke: a spawn pool of two workers on the card against
        # one process on the CPU, one cell per batch so that the pool's
        # chunking is the serial run's.
        per = ["--cells-per-batch", "1"]
        walls["paper-smoke cuda, 2 workers"] = exp_cli(exp_args(
            "paper-smoke", tmp / "a_cuda", "cuda", "--workers", "2",
            "--check-floors", *per))
        walls["paper-smoke cpu"] = exp_cli(exp_args(
            "paper-smoke", tmp / "a_cpu", "cpu", "--workers", "1", *per))
        art = same_runs(tmp / "a_cuda", tmp / "a_cpu",
                        "paper-smoke cuda (2 workers) vs cpu")
        if art["use_pallas"] != "cuda" or art["workers"] != 2:
            raise AssertionError("paper-smoke did not run on the card's pool")
        # (b) the online smoke grids, in-process.
        online = {}
        for grid in ("online-smoke", "online-chaos-smoke"):
            ops.LAUNCHES = 0
            walls[f"{grid} cuda"] = exp_cli(exp_args(
                grid, tmp / f"{grid}_cuda", "cuda", "--check-floors"))
            online[grid] = ops.LAUNCHES
            walls[f"{grid} cpu"] = exp_cli(exp_args(
                grid, tmp / f"{grid}_cpu", "cpu"))
            same_runs(tmp / f"{grid}_cuda", tmp / f"{grid}_cpu",
                      f"{grid} cuda vs cpu")
        # Interrupt after two stream checkpoints (exit 3), then resume.
        cut = tmp / "chaos_cut"
        ck = ["--ckpt-dir", str(tmp / "ckpt")]
        walls["online-chaos-smoke cuda, cut"] = exp_cli(exp_args(
            "online-chaos-smoke", cut, "cuda", *ck, "--ckpt-every-s", "0",
            "--stop-after-ckpts", "2"), expect_exit=3)
        walls["online-chaos-smoke cuda, resumed"] = exp_cli(exp_args(
            "online-chaos-smoke", cut, "cuda", *ck, "--resume"))
        same_runs(cut, tmp / "online-chaos-smoke_cuda",
                  "online-chaos-smoke resumed vs uninterrupted",
                  skip=("wall_s",))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for what, wall in walls.items():
        log(f"[exp] wall {what}: {wall:.3f} s")
    log(f"[exp] floor gate OK on paper-smoke, online-smoke and "
        f"online-chaos-smoke (--check-floors with --report-dir); kernel "
        f"launches in-process: " + ", ".join(f"{g} {n}"
                                             for g, n in online.items()))

    # (c) full width: one workload cell of the paper grid, in-process so
    # that the launch count is this process's; then the same cell on the
    # CPU, which the card's artifact must equal but for the backend fields.
    scen = dataclasses.replace(get_scenario("paper"), **HOT_CELL)
    art, wall, launches, buckets, round_s, link_bytes = timed_rounds(
        torch, lambda: exp_run.run_grid(scen, workers=1, device="cuda"))
    t0 = time.perf_counter()
    cpu = exp_run.run_grid(scen, workers=1, device="cpu")
    cpu_wall = time.perf_counter() - t0
    diff = sorted(k for k in set(art) | set(cpu)
                  if k not in BACKEND_FIELDS and art.get(k) != cpu.get(k))
    if diff:
        raise AssertionError(f"hot cell: card and CPU artifacts differ in "
                             f"{diff}")
    if launches != HOT_CELL_LAUNCHES:
        raise AssertionError(f"hot cell: {launches} kernel launches, "
                             f"expected {HOT_CELL_LAUNCHES}")
    disp = {k: art["dispatch"][k] for k in HOT_CELL_DISPATCH}
    if disp != HOT_CELL_DISPATCH:
        raise AssertionError(f"hot cell dispatch {disp} != "
                             f"{HOT_CELL_DISPATCH}")
    cell, = scen.workload_cells()
    wl = cell_workload(PlatformConfig(), cell.app, cell.rate,
                       cell.budget_interval, cell.workload_seed,
                       scen.n_workflows, scen.sizes)
    n_tasks = sum(w.n_tasks for w in wl)
    if sorted(r["policy"] for r in art["cells"]) != sorted(scen.policies):
        raise AssertionError("hot cell: a policy's row is missing")
    for r in art["cells"]:
        # Every task placed once (the tier histogram counts placements).
        if (r["n_workflows"] != scen.n_workflows
                or sum(r["tier_hist"].values()) != n_tasks):
            raise AssertionError(f"{r['policy']}: not every workflow ran "
                                 f"to its end")
        vals = [r[k] for k in ("mean_makespan_s", "p95_makespan_s",
                               "mean_cost_budget_ratio", "vm_lease_s")]
        if not np.isfinite(vals).all() or min(vals) <= 0:
            raise AssertionError(f"{r['policy']}: makespan or cost not "
                                 f"finite and positive: {vals}")
    log(f"[exp] paper grid cell {HOT_CELL}: {scen.n_workflows} workflows "
        f"({n_tasks} tasks) of sizes {scen.sizes}, {len(scen.policies)} "
        f"policies, through run_grid(workers=1, device='cuda'); the "
        f"artifact equal to the CPU run's (wall {cpu_wall:.3f} s) but for "
        f"{', '.join(BACKEND_FIELDS)}")
    log(f"[exp] dispatch rounds {disp['rounds']}, batched calls "
        f"{disp['batched_calls']} ({disp['rounds'] / wall:.1f} rounds per "
        f"s of wall)")
    log_rounds("exp", wall, launches, buckets, round_s, link_bytes, rate)
    check_held("exp", buckets)
    for pol, s in art["summary_by_policy"].items():
        log(f"[exp] {pol:9s} mean makespan {s['mean_makespan_s']:.1f} s  "
            f"budget met {s['budget_met_mean']:.3f}  cost/budget "
            f"{s['mean_cost_budget_ratio']:.3f}  util "
            f"{s['utilization_mean']:.3f}")
    log(f"[exp] ebpsm_vs_mslbl_makespan_ratio "
        f"{art['ebpsm_vs_mslbl_makespan_ratio']}")
    return dict(launches=launches, wall=wall, round_s=round_s)


# ---------------------------------------------------------------------------
# The transformer families at full width
# ---------------------------------------------------------------------------

# (arch, requests, prompt positions, greedy decode tokens, weight dtype):
# full width and depth, seeded random weights, bf16 compute.  The MoE
# arch holds bf16 weights (15.15 B parameters: ~30 GB, against ~61 GB in
# fp32), as the reference's serve paths do; the others fp32, as phase 7.
# hubert-xlarge is encoder-only: prefill alone.
TRANSFORMERS = [("llama3-8b", 4, 2048, 16, None),
                ("qwen2-moe-a2.7b", 4, 2048, 16, "bfloat16"),
                ("hubert-xlarge", 4, 2048, 0, None),
                ("internvl2-1b", 4, 2048, 16, None)]
# The MoE router on the card against the CPU on one layer's input: in
# fp32 every token routes alike but where the CPU's k-th and (k+1)-th
# gates lie within ROUTING_TIE of each other; in bf16 at most
# ROUTING_FLIP_SHARE of the tokens may route differently (the two
# devices sum the bf16 logits' products in another order).
ROUTING_TIE = 1e-6
ROUTING_FLIP_SHARE = 0.01


def check_routing(torch, model, params, prompt) -> dict:
    """Layer 0's MoE input (embedding, then the layer's attention) on the
    card; its top-k experts per token from the card's router and from the
    CPU's on the same input, in fp32 and in bf16."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import layer_params, position_ids
    from repro_torch.models.layers import attention, rmsnorm
    cfg, run = model.cfg, model.run
    with torch.inference_mode():
        h = tf.embed_inputs(params, {k: v.cuda() for k, v in prompt.items()},
                            cfg, run)
        B, L = h.shape[:2]
        lp = layer_params(params, 0)
        pos = position_ids(B, L, h.device)
        h = h + attention(lp["attn"], rmsnorm(h, lp["ln1"], cfg.rms_eps),
                          pos, cfg, run)
        xt = rmsnorm(h, lp["ln2"], cfg.rms_eps).reshape(B * L, -1)
        router = {"router": lp["moe"]["router"]}
        router_cpu = {"router": router["router"].cpu()}
        out = {}
        for dt in (torch.float32, torch.bfloat16):
            x = xt.to(dt)
            _, e_card = moe_mod._router(router, x, cfg)
            _, e_cpu = moe_mod._router(router_cpu, x.cpu(), cfg)
            differ = (e_card.cpu().sort(-1).values
                      != e_cpu.sort(-1).values).any(-1)
            g = moe_mod._gates(router_cpu, x.cpu(), cfg).sort(
                -1, descending=True).values
            tie = (g[:, cfg.top_k - 1] - g[:, cfg.top_k]) <= ROUTING_TIE
            out[str(dt).replace("torch.", "")] = (
                int(differ.sum()), int((differ & tie).sum()), B * L)
    flips, ties, n = out["float32"]
    if flips != ties:
        raise AssertionError(f"routing: {flips - ties} of {n} tokens route "
                             f"differently on the card in fp32 away from a "
                             f"tie")
    bf, _, _ = out["bfloat16"]
    if bf > ROUTING_FLIP_SHARE * n:
        raise AssertionError(f"routing: {bf} of {n} tokens route "
                             f"differently on the card in bf16")
    log(f"[tf] MoE routing, layer 0's input ({n} tokens, top-{cfg.top_k} of "
        f"{cfg.n_experts}): card vs CPU, tokens whose experts differ: fp32 "
        f"{flips} (all within {ROUTING_TIE} of a tie), bf16 {bf} (bar "
        f"{ROUTING_FLIP_SHARE} of tokens)")
    return out


@contextlib.contextmanager
def routes_recorded():
    """Every ``moe._router`` call's top-k experts, in call order (one
    per MoE layer per model call), while the block runs."""
    from repro_torch.models import moe as moe_mod
    router = moe_mod._router
    routes = []

    def recording(p, xt, cfg):
        w, e = router(p, xt, cfg)
        routes.append(e)
        return w, e
    moe_mod._router = recording
    try:
        yield routes
    finally:
        moe_mod._router = router


def drop_shares(cfg, routes, capacity_factor) -> list:
    """Share of each call's (token, expert) slots past its expert's
    capacity, as ``moe._moe_dense`` sizes it."""
    from repro_torch.models import moe as moe_mod
    e_pad = cfg.n_experts_padded or cfg.n_experts
    out = []
    for e in routes:
        flat = e.reshape(-1).long()
        cap = max(int(math.ceil(flat.numel() / e_pad * capacity_factor)), 8)
        pos = moe_mod._positions_within_expert(flat)
        out.append(float((pos >= cap).float().mean()))
    return out


def check_moe_decode_vs_forward(torch, model, params, B, L, steps) -> dict:
    """An MoE arch's decode held against ``forward`` where the two
    compute the same function: at capacity factor e_pad / top_k no slot
    can drop (at the config's 1.25 the prefill's 8192 tokens overflow
    the experts random weights favour, a 4-token decode step never
    does), and each decode token's experts, recorded per layer, are given
    to ``forward`` at that token's position (a bf16 router that lands on
    another expert moves a logit by more than the bar).  Returns the
    max|Δ| and how many (token, layer) routes ``forward`` would have
    chosen otherwise."""
    from repro_torch.models import moe as moe_mod
    cfg = model.cfg
    k, n = cfg.top_k, cfg.n_layers
    e_pad = cfg.n_experts_padded or cfg.n_experts
    nodrop = dataclasses.replace(
        model, run=model.run.with_(moe_capacity=e_pad / k))
    with routes_recorded() as routes:
        res = serve_request(torch, nodrop, params, B, L, steps, seed=L + 1)
    if max(drop_shares(cfg, routes, e_pad / k)) != 0.0:
        raise AssertionError("a slot dropped at capacity factor e_pad/k")
    dec = routes[n:]                     # step-major, n_layers per step
    router = moe_mod._router
    layer, flips = [0], [0]

    def given(p, xt, cfg_):
        _, e = router(p, xt, cfg_)
        i = layer[0]
        layer[0] += 1
        e = e.reshape(B, -1, k).clone()
        for j in range(steps):
            want = dec[j * n + i].reshape(B, k)
            flips[0] += int((e[:, L + j].sort(-1).values
                             != want.sort(-1).values).any(-1).sum())
            e[:, L + j] = want
        e = e.reshape(-1, k)
        w = moe_mod._gates(p, xt, cfg_).gather(-1, e.long())
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), e
    moe_mod._router = given
    try:
        err = check_decode_vs_forward(torch, nodrop, params, res, "tf")
    finally:
        moe_mod._router = router
    log(f"[tf] decode held against forward at capacity factor {e_pad / k} "
        f"(no slot dropped), each decode token's experts given to forward: "
        f"{flips[0]} of {B * steps * n} (token, layer) routes would have "
        f"differed in bf16")
    return dict(err=err, flips=flips[0], pairs=B * steps * n)


def check_prefill_vs_plain(torch, model, params, res) -> float:
    """An encoder-only prefill (every position's logits) through the
    kernel against the same prefill with the plain attention on the
    card, each position within DECODE_BAR of its largest logit."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    kernel = fa_ops.flash_attention
    fa_ops.flash_attention = \
        lambda q, k, v, causal=True: attention_ref(q, k, v, causal)
    try:
        with torch.inference_mode():
            ref = model.forward(params, {k: v.cuda() for k, v in
                                         res["prompt"].items()}).float()
    finally:
        fa_ops.flash_attention = kernel
    got = res["logits"].float()
    err = (got - ref).abs().amax(-1)
    bar = DECODE_BAR * ref.abs().amax(-1).clamp(min=1.0)
    if not bool((err < bar).all()):
        raise AssertionError(f"prefill vs plain attention: max|Δ| "
                             f"{float(err.max())}")
    log(f"[tf] prefill through the kernel vs the plain attention on the "
        f"card, {ref.shape[0]} x {ref.shape[1]} positions, each under "
        f"{DECODE_BAR}·max(max|ref|, 1): max|Δ| {float(err.max()):.4g}, "
        f"worst ratio to its bar {float((err / bar).max()):.4g}")
    return float(err.max())


def phase_transformers(torch) -> dict:
    import gc
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build
    from repro_torch.serve.serve_step import build_decode_step, \
        build_prefill
    out = {}
    for arch, B, L, steps, wdt in TRANSFORMERS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build(arch, device="cuda")
        cfg = model.cfg
        params = model.init(0, getattr(torch, wdt) if wdt else None)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"[tf] {arch} ({cfg.family}): {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head dim "
            f"{cfg.hd}, causal {cfg.causal}, {model.n_params():,} "
            f"parameters in {wdt or 'float32'} from a seeded generator in "
            f"{init_s:.3f} s (peak {init_gib:.3f} GiB while drawn), compute "
            f"{model.run.compute_dtype}")
        # Warm-up request (cuBLAS handles, the allocator's pools, first
        # launches), outside the timed and counted run.
        serve_request(torch, model, params, 1, cfg.n_patches + 64,
                      min(steps, 2), seed=0)
        fa_ops.LAUNCHES = 0
        with routes_recorded() as routes:
            res = serve_request(torch, model, params, B, L, steps, seed=L,
                                counts=lambda: (fa_ops.LAUNCHES,))
        (c0,), (c1,), (c2,) = res["counts"]
        if c1 - c0 != cfg.n_layers:
            raise AssertionError(f"{arch}: prefill launched {c1 - c0} FA "
                                 f"kernels, expected {cfg.n_layers}")
        if c2 != c1:
            raise AssertionError(f"{arch}: decode launched the FA kernel")
        launches = fa_ops.LAUNCHES
        step_ms = res["step_ms"]
        dec = (f"{steps} greedy decode steps: median "
               f"{statistics.median(step_ms):.3f} ms, max "
               f"{max(step_ms):.3f} ms per step (host clock, "
               f"synchronised), {B * steps * 1e3 / sum(step_ms):.1f} "
               f"tokens/s" if steps else "no decode (encoder-only)")
        log(f"[tf] {arch} {B} x {L}-position prompts: prefill "
            f"{res['prefill_s']:.3f} s ({B * L / res['prefill_s']:.1f} "
            f"positions/s), {c1 - c0} FA launches; {dec}; peak allocated "
            f"{res['peak_gib']:.3f} GiB")
        routing = drops = None
        if cfg.n_experts:
            cf = model.run.moe_capacity
            drops = drop_shares(cfg, routes[:cfg.n_layers], cf)
            dec_drops = drop_shares(cfg, routes[cfg.n_layers:], cf)
            log(f"[tf] {arch} prefill at capacity factor {cf}: dropped "
                f"slot share per layer {[round(d, 4) for d in drops]} "
                f"(mean {statistics.mean(drops):.4f}); decode steps' "
                f"largest {max(dec_drops)}")
            routing = check_routing(torch, model, params, res["prompt"])
            err = check_moe_decode_vs_forward(torch, model, params, B, L,
                                              steps)
        elif steps:
            err = check_decode_vs_forward(torch, model, params, res, "tf")
        else:
            err = check_prefill_vs_plain(torch, model, params, res)
        # Where the device time goes: one more prefill (and decode step)
        # under the profiler; idle share against the unprofiled walls.
        prompt = {k: v.cuda() for k, v in res["prompt"].items()}
        prefill = build_prefill(model, "prefill_32k", max_seq=L + 1)
        calls = [("prefill", lambda: prefill(params, prompt),
                  res["prefill_s"] * 1e3)]
        if steps:
            decode = build_decode_step(model, "decode_32k")
            _, state = prefill(params, prompt)
            tok = res["fed"][:, :1]
            calls.append(("decode step", lambda: decode(params, state, tok),
                          statistics.median(step_ms)))
        split = {}
        for what, fn, wall_ms in calls:
            by = device_breakdown(torch, fn)
            if what == "prefill" and not by["fa_kernel"] > 0:
                raise AssertionError(f"{arch}: no device time under "
                                     f"fa_kernel in a prefill")
            busy = by["fa_kernel"] + by["other"]
            split[what] = dict(fa_kernel=by["fa_kernel"], other=by["other"],
                               busy=busy, wall=wall_ms,
                               idle=max(0.0, 1 - busy / wall_ms))
            log(f"[tf] {arch} {what} device time, ms: fa_kernel "
                f"{by['fa_kernel']:.3f}, other kernels {by['other']:.3f}; "
                f"busy {busy:.3f} of {wall_ms:.3f} wall, idle share "
                f"{split[what]['idle']:.4f}")
        out[arch] = dict(launches=launches, prefill_s=res["prefill_s"],
                         step_ms=(statistics.median(step_ms) if steps
                                  else None),
                         peak_gib=res["peak_gib"], init_gib=init_gib,
                         err=err, routing=routing, drops=drops,
                         split=split)
        del params, model, res, prompt, calls, prefill
        if steps:
            del state, decode
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The ML-job WaaS platform
# ---------------------------------------------------------------------------

# ``sweep``'s defaults (24 jobs, rates 1 and 4 per minute) send no round
# to the auction; this grid (400 jobs at 1000 per minute, the same code)
# sends 978, counted at the ``_score_round`` seam of a CPU run.
WAAS_KERNEL_SWEEP = dict(n_jobs=400, rates=(1000.0,))
WAAS_KERNEL_ROUNDS = 978
NOART = "/nonexistent"   # no dry-run artifacts: the analytic cost model


def cpu_rounds(fn):
    """``fn()`` and the rounds it scores at the ``_score_round`` seam."""
    from repro_torch.core import cycles
    score = cycles._score_round
    n = [0]

    def counted(cfg_, view):
        n[0] += 1
        return score(cfg_, view)
    cycles._score_round = counted
    try:
        t0 = time.perf_counter()
        out = fn()
        return out, n[0], time.perf_counter() - t0
    finally:
        cycles._score_round = score


def check_sweep_rows(rows, n_jobs, what) -> None:
    """Every policy ran every job to its end with one placement per task
    (the tier histogram counts placements), makespans finite and
    positive."""
    from repro_torch.waas.mljobs import ml_workload
    for r in rows:
        wfs = ml_workload(n_jobs, r["rate_wf_per_min"], seed=r["seed"],
                          art_dir=NOART)
        if (r["n_workflows"] != n_jobs or sum(r["tier_hist"].values())
                != sum(w.n_tasks for w in wfs)):
            raise AssertionError(f"{what} {r['policy']}: not every job ran "
                                 f"to its end")
        if not (np.isfinite(r["mean_makespan_s"])
                and r["mean_makespan_s"] > 0):
            raise AssertionError(f"{what} {r['policy']}: makespan "
                                 f"{r['mean_makespan_s']}")


def phase_waas(torch, rate: float) -> dict:
    """``repro_torch.waas.platform`` on the card against the CPU: the
    sweep at its defaults and at ``WAAS_KERNEL_SWEEP``, then the chaos
    straggler experiment.  Sweep rows carry no backend field, so they
    must be equal whole."""
    from repro_torch.kernels.affinity import ops
    from repro_torch.waas import platform
    out = {}
    for tag, kw in (("defaults", {}), ("kernel grid", WAAS_KERNEL_SWEEP)):
        n_jobs = kw.get("n_jobs", 24)
        cpu, rounds, cpu_wall = cpu_rounds(
            lambda: platform.sweep(art_dir=NOART, device="cpu", **kw))
        card = lambda: platform.sweep(art_dir=NOART,  # noqa: E731
                                      device="cuda", **kw)
        if rounds:
            rows, wall, launches, buckets, round_s, link_bytes = \
                timed_rounds(torch, card)
        else:
            ops.LAUNCHES = 0
            t0 = time.perf_counter()
            rows = card()
            wall, launches = time.perf_counter() - t0, ops.LAUNCHES
        if rows != cpu:
            raise AssertionError(f"waas sweep ({tag}): card rows differ "
                                 f"from the CPU's")
        if launches != rounds:
            raise AssertionError(f"waas sweep ({tag}): {launches} launches "
                                 f"on the card, {rounds} rounds on the CPU")
        check_sweep_rows(rows, n_jobs, f"waas sweep ({tag})")
        log(f"[waas] sweep {kw or '(defaults)'}: {len(rows)} rows equal to "
            f"the CPU's; {launches} affinity launches = the CPU's {rounds} "
            f"rounds; wall {wall:.3f} s on the card, {cpu_wall:.3f} s on "
            f"the CPU")
        for r in rows:
            log(f"[waas]   {r['policy']:9s} rate {r['rate_wf_per_min']} "
                f"mean makespan {r['mean_makespan_s']:.3f} s, budget met "
                f"{r['budget_met']:.3f}, utilization "
                f"{r['utilization']:.3f}, locality "
                f"{r['locality_hit_rate']:.3f}")
        out[tag] = dict(launches=launches, wall=wall, cpu_wall=cpu_wall)
    if launches != WAAS_KERNEL_ROUNDS:
        raise AssertionError(f"waas kernel grid: {launches} launches, "
                             f"expected {WAAS_KERNEL_ROUNDS}")
    log_rounds("waas", wall, launches, buckets, round_s, link_bytes, rate)
    check_held("waas", buckets)
    out["round_s"] = round_s
    chaos = dict(slowdowns=(2.0, 4.0), art_dir=NOART)
    card = platform.straggler_experiment(device="cuda", **chaos)
    if card != platform.straggler_experiment(device="cpu", **chaos):
        raise AssertionError("straggler experiment: card rows differ from "
                             "the CPU's")
    for pol, rows in card.items():
        log(f"[waas] stragglers {pol:8s} (slowdown, mean makespan s, budget "
            f"met, detected): {rows}; equal on the CPU")
    return out


# ---------------------------------------------------------------------------
# Training at full width
# ---------------------------------------------------------------------------

# (a) llama3-8b at full width, 2 x 4096 tokens (train_4k's sequence, its
# batch of 256 cut to 2), depth cut from 32 layers to 4: at 32 the fp32
# parameters, gradients and two AdamW moments alone take ~8e9 x 16 bytes,
# more than the card's 80 GB; at 4 they take ~31 GB.
TRAIN_HEADLINE = ("llama3-8b", 4, 2, 4096)
TRAIN_WARMUP, TRAIN_STEPS = 1, 6
# (b) every transformer family: one step at full width, 2 layers, 1 x 2048
# (the plain attention it is held against materialises [B, H, L, L] per
# layer), through the kernels and again with attention_ref on the card.
TRAIN_FAMILIES = ("llama3-8b", "qwen2-moe-a2.7b", "hubert-xlarge",
                  "internvl2-1b")
FAMILY_LAYERS, FAMILY_B, FAMILY_L = 2, 1, 2048
# Both runs compute in bf16 and differ only in the attention (the kernels
# against the plain version, each within one bf16 step of fp32): the loss
# within 2e-2 relative and each gradient leaf within 2e-2·max|ref| of that
# leaf, the bf16 bar of tests/test_torch_train.py (where the port and the
# reference, which rounds p to bf16, stay within 0.0096·max|ref|).
TRAIN_LOSS_REL = 2e-2
TRAIN_GRAD_REL = 2e-2
# (c) FaultyTrainer on the card and on the CPU: the reference test's plan
# (tests/test_train.py::test_faulty_trainer_recovers), 15 steps of
# llama3-8b smoke on batch_at batches of 4 x 64, bf16 compute; losses
# within 2e-2 relative (bf16 on two devices, the card's attention through
# the kernels).
FT_PLAN = dict(fail_prob=0.25, seed=1, ckpt_every=3, keep=2)
FT_STEPS = 15
FT_LOSS_REL = 2e-2
FA_BWD_KERNELS = ("fa_bwd_preprocess", "fa_bwd_dkdv", "fa_bwd_dq")


def train_model(arch: str, n_layers: int, device="cuda", smoke=False):
    """``build`` with remat "dots" (bf16 compute, fp32 parameters: the
    RunConfig's defaults), depth cut to ``n_layers`` unless 0."""
    from repro_torch.models import RunConfig, build
    model = build(arch, RunConfig(remat="dots"), smoke=smoke, device=device)
    if n_layers:
        model = dataclasses.replace(model,
                                    cfg=model.cfg.with_(n_layers=n_layers))
    return model


def phase_train_headline(torch) -> dict:
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import make_train_step
    arch, n_layers, B, L = TRAIN_HEADLINE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = train_model(arch, n_layers)
    cfg = model.cfg
    params = model.init(0)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    log(f"[train] (a) {arch}: {n_layers} of 32 layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head dim "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {model.n_params():,} "
        f"fp32 parameters and AdamW state from a seeded generator in "
        f"{time.perf_counter() - t0:.3f} s ({torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB); bf16 compute, remat {model.run.remat}; batches {B} x {L} "
        f"from data.pipeline.batch_at")
    step = make_train_step(model)
    dc = DataConfig(seed=0, seq_len=L, global_batch=B)
    n = TRAIN_WARMUP + TRAIN_STEPS
    batches = [batch_at(dc, s, cfg) for s in range(n + 1)]
    for s in range(TRAIN_WARMUP):
        params, opt, _ = step(params, opt, batches[s])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES = 0
    fa_ops.BWD_LAUNCHES = 0
    times, losses = [], []
    for s in range(TRAIN_WARMUP, n):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batches[s])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    launches = (fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = (n_layers * TRAIN_STEPS, n_layers * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"(a) {TRAIN_STEPS} steps launched {launches} "
                             f"(FA forward, FA backward passes), expected "
                             f"{want}: remat dots keeps the forward")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(a) non-finite loss {losses}")
    if int(opt["step"]) != n:
        raise AssertionError(f"(a) opt step {int(opt['step'])} != {n}")
    step_s = statistics.median(times)
    log(f"[train] (a) {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: "
        f"median {step_s:.4f} s, max {max(times):.4f} s per step (host "
        f"clock, synchronised), {B * L / step_s:.1f} tokens/s; losses "
        f"{[round(x, 4) for x in losses]}; per step {n_layers} FA forward "
        f"launches (remat dots keeps them) and {n_layers} FA backward "
        f"passes ({3 * n_layers} backward kernel launches); peak allocated "
        f"{peak:.3f} GiB; opt step {int(opt['step'])}")
    # One more step under the profiler: its busy time and its own wall
    # give the idle share.
    span = []
    by = device_breakdown(torch, lambda: step(params, opt, batches[n]),
                          ("fa_kernel",) + FA_BWD_KERNELS, span=span)
    busy = sum(by.values())
    wall = span[0]
    split = dict(by, busy=busy, wall=wall, idle=max(0.0, 1 - busy / wall))
    for name in ("fa_kernel",) + FA_BWD_KERNELS:
        if not by[name] > 0:
            raise AssertionError(f"(a) no device time under {name}")
    log("[train] (a) one profiled step's device time by kernel, ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in by.items())
        + f"; busy {busy:.3f} of that step's {wall:.3f} wall (host clock, "
        f"synchronised; the unprofiled median {step_s * 1e3:.3f}), idle "
        f"share {split['idle']:.4f}")
    del params, opt, step, model, batches
    torch.cuda.empty_cache()
    return dict(fa_launches=launches[0], bwd_launches=launches[1],
                step_s=step_s, tokens_per_s=B * L / step_s, peak_gib=peak,
                split=split, losses=losses)


@contextlib.contextmanager
def routes_pinned():
    """The MoE router with each layer's experts pinned: the first call
    for a layer (keyed by its router weight) records the experts it
    picks, every later call (the recomputation under remat, the second
    run) takes them; the weights are the gates at those experts,
    renormalised, in every call alike (the router's own weights are the
    same values, taken from a sort).  Yields a dict of how many tokens
    the later calls' own router would have routed otherwise."""
    from repro_torch.models import moe as moe_mod
    router = moe_mod._router
    pinned, flips = {}, {}

    def pin(p, xt, cfg):
        # The same ops in every call: a recomputation under remat must
        # repeat its forward's.
        _, e = router(p, xt, cfg)
        key = p["router"].data_ptr()
        pinned.setdefault(key, e)
        flips[key] = int((e.sort(-1).values != pinned[key].sort(-1)
                          .values).any(-1).sum())
        e = pinned[key]
        w = moe_mod._gates(p, xt, cfg).gather(-1, e.long())
        return w / w.sum(-1, keepdim=True).clamp(min=1e-9), e
    moe_mod._router = pin
    try:
        yield flips
    finally:
        moe_mod._router = router


def family_grads(torch, model, params, batch, plain: bool):
    """loss_and_grads of one step, through the kernels or with the
    attention swapped for the plain version on the card (the same
    test-only swap as check_prefill_vs_plain)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.train.train_step import loss_and_grads
    kernel = fa_ops.flash_attention
    if plain:
        fa_ops.flash_attention = \
            lambda q, k, v, causal=True: attention_ref(q, k, v, causal)
    try:
        return loss_and_grads(model, params, batch)
    finally:
        fa_ops.flash_attention = kernel


def phase_train_families(torch) -> dict:
    import gc
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.common import tree_leaves
    out = {}
    for arch in TRAIN_FAMILIES:
        torch.cuda.empty_cache()
        model = train_model(arch, FAMILY_LAYERS)
        cfg = model.cfg
        params = model.init(0)
        batch = batch_at(DataConfig(seed=1, seq_len=FAMILY_L,
                                    global_batch=FAMILY_B), 0, cfg)
        with routes_pinned() as flips:
            before = (fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES)
            loss, _, grads = family_grads(torch, model, params, batch, False)
            torch.cuda.synchronize()
            got = (fa_ops.LAUNCHES - before[0],
                   fa_ops.BWD_LAUNCHES - before[1])
            ref_loss, _, ref_grads = family_grads(torch, model, params,
                                                  batch, True)
            torch.cuda.synchronize()
        if got != (cfg.n_layers, cfg.n_layers):
            raise AssertionError(f"(b) {arch}: one step launched {got} (FA "
                                 f"forward, FA backward passes), expected "
                                 f"{cfg.n_layers} each")
        loss_err = abs(float(loss) - float(ref_loss))
        if not loss_err <= TRAIN_LOSS_REL * abs(float(ref_loss)):
            raise AssertionError(f"(b) {arch}: loss {float(loss)} vs plain "
                                 f"attention's {float(ref_loss)}")
        worst, worst_key = 0.0, None
        keys = [k for k, _ in _flatten(params)]
        for key, g, r in zip(keys, tree_leaves(grads), tree_leaves(ref_grads)):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"(b) {arch}: non-finite grad {key}")
            scale = float(r.abs().max())
            err = float((g - r).abs().max())
            ratio = err / (TRAIN_GRAD_REL * scale) if scale > 0 else (
                0.0 if err == 0 else math.inf)
            if ratio > worst:
                worst, worst_key = ratio, key
        if not worst <= 1.0:
            raise AssertionError(f"(b) {arch}: grad {worst_key} is {worst} "
                                 f"times its bar {TRAIN_GRAD_REL}·max|ref|")
        n_flips = sum(flips.values())
        log(f"[train] (b) {arch} ({cfg.family}): {cfg.n_layers} layers at "
            f"full width, {model.n_params():,} parameters, {FAMILY_B} x "
            f"{FAMILY_L}: {got[0]} FA forward launches and {got[1]} FA "
            f"backward passes in the step; loss {float(loss):.6f} against "
            f"{float(ref_loss):.6f} with the plain attention; {len(keys)} "
            f"gradient leaves, worst |Δ| / ({TRAIN_GRAD_REL}·max|ref|) "
            f"{worst:.4g} ({worst_key}) <= 1"
            + (f"; routes pinned to the kernel run's, {n_flips} token "
               f"routes the plain run would have changed" if cfg.n_experts
               else ""))
        out[arch] = dict(launches=got, loss=float(loss),
                         ref_loss=float(ref_loss), worst=worst)
        del params, grads, ref_grads, model
        gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_faults(torch) -> dict:
    import tempfile
    from repro_torch import ckpt
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.ft.faults import FaultPlan, FaultyTrainer
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import make_train_step
    dc = DataConfig(seed=0, seq_len=64, global_batch=4)
    init = train_model("llama3-8b", 0, "cpu", smoke=True).init(0)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            model = train_model("llama3-8b", 0, dev, smoke=True)
            params = tree_map(lambda t: t.to(dev, copy=True), init)
            tr = FaultyTrainer(f"{tmp}/{dev}", FaultPlan(**FT_PLAN))
            t0 = time.perf_counter()
            params, opt, hist = tr.run(
                params=params, opt=init_opt_state(params), n_steps=FT_STEPS,
                step_fn=make_train_step(model),
                batch_fn=lambda s: batch_at(dc, s, model.cfg), device=dev)
            sync(torch, dev)
            runs[dev] = dict(tr=tr, params=params, opt=opt, hist=hist,
                             wall=time.perf_counter() - t0)
        card, cpu = runs["cuda"], runs["cpu"]
        same = (card["tr"].restarts == cpu["tr"].restarts
                and card["tr"].failed_steps == cpu["tr"].failed_steps
                and card["hist"]["step"] == cpu["hist"]["step"])
        if not same or card["tr"].restarts == 0:
            raise AssertionError(
                f"(c) card restarts {card['tr'].restarts} at "
                f"{card['tr'].failed_steps}, steps {card['hist']['step']}; "
                f"CPU {cpu['tr'].restarts} at {cpu['tr'].failed_steps}, "
                f"{cpu['hist']['step']}")
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(card["hist"]["loss"], cpu["hist"]["loss"]))
        if not rel <= FT_LOSS_REL:
            raise AssertionError(f"(c) losses apart by {rel} relative")
        last = ckpt.latest_step(f"{tmp}/cuda")
        restored, _ = ckpt.restore_section(f"{tmp}/cuda", last, init,
                                           device="cpu")
        restored_opt, _ = ckpt.restore_section(
            f"{tmp}/cuda", last, init_opt_state(init), device="cpu",
            section="opt")
        for a, b in zip(tree_leaves(restored) + tree_leaves(restored_opt),
                        tree_leaves(card["params"])
                        + tree_leaves(card["opt"])):
            if a.dtype != b.dtype or not torch.equal(a, b.cpu()):
                raise AssertionError("(c) the card's last checkpoint does "
                                     "not restore on the CPU bit for bit")
    log(f"[train] (c) FaultyTrainer {FT_PLAN}, {FT_STEPS} steps of "
        f"llama3-8b smoke: card and CPU both restarted "
        f"{card['tr'].restarts} times, failing at steps "
        f"{card['tr'].failed_steps}, history steps equal; losses within "
        f"{rel:.3g} relative (bar {FT_LOSS_REL}); the card's last "
        f"checkpoint (step {last}) restores on the CPU bit for bit; wall "
        f"{card['wall']:.3f} s on the card, {cpu['wall']:.3f} s on the CPU")
    return dict(restarts=card["tr"].restarts,
                failed_steps=card["tr"].failed_steps, loss_rel=rel)


def phase_train_ssd_guard(torch) -> None:
    from repro_torch.kernels.ssd.ops import ssd
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 64, 2, 16), generator=gen, device="cuda",
                    requires_grad=True)
    dt = torch.rand((1, 64, 2), generator=gen, device="cuda")
    A = -torch.rand((2,), generator=gen, device="cuda")
    Bm = torch.randn((1, 64, 16), generator=gen, device="cuda")
    try:
        ssd(x, dt, A, Bm, Bm.clone())
    except NotImplementedError as e:
        log(f"[train] (d) ssd under grad on the card raises: {e}")
        return
    raise AssertionError("(d) ssd under grad on the card returned outputs "
                         "cut from autograd")


def phase_train(torch) -> dict:
    head = phase_train_headline(torch)
    families = phase_train_families(torch)
    faults = phase_train_faults(torch)
    phase_train_ssd_guard(torch)
    return dict(head, families=families, faults=faults)


def main() -> int:
    import torch
    smi = phase_device(torch)
    phase_build()
    k = phase_kernel(torch)
    phase_parity()
    launches = phase_full_width(torch, k["link_rate"])
    fa = phase_attention(torch)
    t0 = time.perf_counter()
    fab = phase_attention_bwd(torch)
    log(f"[fa-bwd] phase 6's backward checks took "
        f"{time.perf_counter() - t0:.3f} s")
    sd = phase_ssd(torch)
    serve = phase_serving(torch)
    exp = phase_experiments(torch, k["link_rate"])
    tf = phase_transformers(torch)
    waas = phase_waas(torch, k["link_rate"])
    t0 = time.perf_counter()
    train = phase_train(torch)
    log(f"[train] phase 11 took {time.perf_counter() - t0:.3f} s")
    from repro_torch.kernels.flash_attention.kernel import \
        HEAD_DIMS as FA_HEAD_DIMS
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
        # The experiment harness's full-width cell (phase 8).
        "launches_exp_run": exp["launches"],
        # The WaaS platform's kernel grid (phase 10).
        "launches_waas": waas["kernel grid"]["launches"],
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
        "head_dims": list(FA_HEAD_DIMS),
        # Phase 9: launches per arch (one prefill each).
        "launches_transformers": {a: r["launches"] for a, r in tf.items()},
        # Phase 11 (a): the training headline's timed steps (remat dots
        # keeps each forward: one launch per layer per step).
        "launches_train": train["fa_launches"],
        "train": {key: fa["rows"][FA_TRAIN][key]
                  for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "err")},
        # Every serving shape of phase 6 ([B, H, L, D], causal, dtype).
        "serving": [dict(shape=[b, h, l, d], causal=c, dtype=dt,
                         **{key: fa["rows"][(b, l, h, d, c, dt)][key]
                            for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "err")})
                    for b, l, h, d, c, dt in FA_SERVING],
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
    bwd = fab["rows"][FA_TRAIN]
    Bt, Lt, Ht, Dt, _, _ = FA_TRAIN
    whole = dict(ms=bwd["ms"]["backward"],
                 plain_ms=bwd["plain_ms"]["backward"],
                 bound_ms=bwd["bounds"]["backward"][0],
                 bound_by=bwd["bounds"]["backward"][1],
                 library_ms=bwd["library_ms"])
    for key, name in zip(("preprocess", "dkdv", "dq"), FA_BWD_KERNELS):
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bwd.cu",
            # No Pallas kernel: XLA's gradient of the jnp attention.
            "replaces": "src/repro/models/layers.py:145",
            "tpu_kernel": False,
            # Phase 11 (a): each backward pass launches each kernel once.
            "launches": train["bwd_launches"],
            "max_abs_err": fab["max_abs_err"],
            "ms": bwd["ms"][key],
            "plain_ms": bwd["plain_ms"][key],
            "bound_ms": bwd["bounds"][key][0],
            "bound_by": bwd["bounds"][key][1],
            # No single PyTorch call computes one kernel's share; the
            # whole backward's library time is under "backward".
            "library_ms": None,
            "shape": [Bt, Ht, Lt, Dt],
            "backward": whole,
            # Phase 11 (b): backward passes in one step per arch.
            "launches_families": {a: r["launches"][1] for a, r in
                                  train["families"].items()},
        })
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
