#!/usr/bin/env python3
"""Smoke test of the repro_torch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device — requires CUDA, prints the card's name and power limit; turns
   TF32 off for matmuls and cuDNN (the reference's numbers are fp32 or
   bf16, never TF32);
2. build — compiles the five kernel sources from ``src/`` with nvcc
   (affinity, flash attention forward and backward, SSD forward and
   backward), one process per source, started together; prints each
   build's registers, shared memory and spills;
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
   flash attention also at head dim 80 (causal and not, fp32 and bf16),
   at phase 9's serving shapes (head dims 128, 80 and 64, hubert's
   [4,16,2048,80] in both dtypes) and at phase 14's ([4,32,2048,96],
   [4,16,2048,256], and forward and backward [2,32,4096,96],
   [2,16,4096,256]); the head-dim domain at small shapes (16 head dims
   from 1 to 256, both dtypes, three shapes each: forward, lse and the
   backward kernels at the bars below, two passes bit for bit equal);
   every flash-attention kernel at every column bucket without a spill
   and with the shared memory of ``kernel.py``'s mirror
   (bf16 attention, on the tensor-core kernel at every head width,
   element by element within one bf16 step of the plain version; the
   bf16 SSD chunk pass on the tensor cores, with the worst ratio to its
   bar at one, two and three bf16 terms); prints kernel, plain, bound
   and library times and achieved TFLOP/s, and the whole ``ssd()``;
   flash attention's forward also at phase 11's [2, 32, 4096, 128], and
   in fp32 (``fa_kernel_tf32``, every product three TF32 tensor-core
   products) at phase 11 (b)'s [1, 32, 2048, 128], at [2, 32, 4096, 128]
   and at [1, 8, 32768, 128] causal, each fp32 row with its lse and the
   kernel's 3×TF32 MMA floor, every row's second pass equal bit for bit;
   the
   backward (``flash_attention_bwd.cu``: the preprocess, then for bf16
   the tensor-core ``fa_bwd_dkdv_tc`` and ``fa_bwd_dq_tc``, whose
   registers, dynamic shared memory and spills from ``-Xptxas -v`` are
   printed and must show no spill, for fp32 ``fa_bwd_dkdv_tf32`` and
   ``fa_bwd_dq_tf32`` on the tensor cores in three TF32 terms, likewise
   checked) against ``attention_bwd_ref`` at the sweep's shapes, head
   dim 80, phase 11 (b)'s archs' attention (llama3-8b's in fp32 too) and
   [2, 32, 4096, 128] bf16 and fp32 causal (fp32 within
   1e-4·max(max|ref|, 1), bf16 per element within
   2^-7·|ref| + 1e-5·max|ref|), a second pass equal bit for bit, the
   forward's log-sum-exp against ``attention_lse_ref``; backward,
   per-kernel, plain, bound, MMA floor and library (SDPA forward and
   backward minus forward, with the backend SDPA picked) times; the
   preprocess also at every column bucket and at head dims 1, 33, 80,
   96 and 200, both dtypes, on aligned tensors and on views one element
   into a larger buffer (two passes bit for bit), then timed through its
   C entry point at phase 11's and 14's training shapes with its share
   of the byte bound and its builds' registers and spills; the SSD
   carry ``ssd_carry_tc`` at the serving shapes, phase 11 (d)'s
   [2, 4096, 48, 64, 128, 64] and [8, 256, 64, 64, 64, 64] (more groups
   than blocks: each block walks a second group) against
   ``ssd_carry_ref`` with and without an initial state, two passes bit
   for bit, timed through its C entry point with the plan it launches
   (slice width, ring stages, blocks, shared memory equal to
   ``kernel.py``'s mirror), its share of the byte
   bound and its builds' registers and spills; the fp32 chunk pass at
   ``SSD_TF32_SHAPES`` (Q = P = 64: the sweep's N = 128 shape, (b)'s
   fp32 step's [1, 2048, 48, 64, 128, 64] and the two training shapes at
   2 x 4096): ``ssd_chunk_tf32`` (TF32 ``mma.sync``, three products a
   product; no spill) and the CUDA-core ``ssd_chunk_kernel`` on the same
   inputs against ``ssd_chunks_ref``, both timed through the C entry
   point in turns, and likewise the fp32 carries ``ssd_carry_tf32`` (its
   plan, no spill, two passes bitwise) and ``ssd_carry_kernel`` against
   ``ssd_carry_ref``; the SSD backward (``ssd_bwd.cu``:
   at Q = P = 64, N in {64, 128} for bf16 the tensor-core
   ``ssd_carry_bwd_tc`` and ``ssd_chunk_bwd_tc``, for fp32 the TF32
   ``ssd_carry_bwd_tf32`` and ``ssd_chunk_bwd_tf32``, the
   tensor-core kernels' registers, dynamic shared memory and spills from
   ``-Xptxas -v`` printed and showing no spill, the fp32 pair held and
   timed in turns with the CUDA-core ``ssd_carry_bwd`` and
   ``ssd_chunk_bwd`` through the C entry points at the fp32 training
   shapes; for every other shape the CUDA-core
   ``ssd_carry_bwd`` and ``ssd_chunk_bwd``; and the whole backward of
   the op ``repro_torch::ssd_fwd``) against ``ssd_carry_bwd_ref``,
   ``ssd_chunk_bwd_ref`` and ``ssd_bwd_ref`` at the reference sweep's
   shapes (chunks of 16 to 128 rows), at ``SSD_CHUNKS`` (mamba2-780m's
   heads at 2 x 4096 in chunks of 128 and 256, and a 50-row chunk; the
   forward's chunk and carry kernels and the whole ``ssd()`` held there
   too, each timed), at phase 11's training shapes [2, 4096, 48, 64, 128, 64] (mamba2-780m) and
   [2, 4096, 64, 64, 64, 64] (zamba2-1.2b), bf16 and fp32, and at (b)'s
   fp32 mamba2-780m step, [1, 2048, 48, 64, 128, 64], with a
   nonzero initial state and final-state gradient (each
   gradient within 1e-4·max(max|ref|, 1), the op's bf16 gradients within
   one bf16 step more; a second pass equal bit for bit; the worst ratio
   printed), with kernel, plain, bound and MMA-floor times, and at the
   bf16 training shapes also the CUDA-core kernels on the same inputs
   (held too); and at ``SSD_TILED`` (mamba2-780m's heads at 2 x 4096 in
   chunks of 128 and 256, zamba2-1.2b's in chunks of 256), bf16 and
   fp32, the tensor-core kernels over 64 x 64 tiles and the tensor-core
   carry backward in 64-row slabs: ``ssd()`` under grad with every SSD
   count set to 0 before it and read after (the launches of
   ``ssd_chunk_tc_tiled``, ``ssd_carry_bwd_tc`` and
   ``ssd_chunk_bwd_tc_tiled``, or of ``ssd_chunk_tf32_tiled``,
   ``ssd_carry_bwd_tf32`` and ``ssd_chunk_bwd_tf32_tiled``, counted by
   name), y, the final state and every gradient against ``ssd_ref`` and
   its autograd; each kernel and its CUDA-core counterpart against the
   plain version (a second pass bitwise), timed through the C entry
   points in turns beside its bound, wrapper and plain times, and in
   fp32 the carry these chunks take (``ssd_carry_tf32``) in turns with
   ``ssd_carry_kernel``; every kernel's builds (no spill; the carry
   backward at 1 to 4 slabs a chunk) and shared memory (= kernel.py's
   mirrors);
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
   three kernels per layer: the preprocess, ``fa_bwd_dkdv_tc`` and
   ``fa_bwd_dq_tc``, each counted), a ``torch.profiler`` split of one
   more step, its idle share against that step's own wall and FA's
   backward's share of its device time;
   (b) llama3-8b, qwen2-moe-a2.7b, hubert-xlarge and internvl2-1b at 2
   layers, 1 x 2048, and llama3-8b again with fp32 compute (the fp32
   backward kernels): one step's loss and every gradient leaf held
   against the same step with the plain attention on the card (the MoE
   router's experts pinned between the two); likewise mamba2-780m at 2
   layers and zamba2-1.2b at 6 (one shared-attention application), held
   against the same step with the plain attention and ``ssd_ref``, their
   SSD launches (forward chunk and carry, backward passes (each one
   chunk-state launch), ``ssd_carry_bwd_tc``, ``ssd_chunk_bwd_tc``: one
   each per layer; each forward kernel by name) and FA launches checked,
   and mamba2-780m again with fp32 compute, which takes
   ``ssd_chunk_tf32``, ``ssd_carry_tf32``, ``ssd_carry_bwd_tf32`` and
   ``ssd_chunk_bwd_tf32`` (two launches of each checked; its step also
   timed in turns with the same step sent to the SSD's four CUDA-core
   kernels), and on a 2 x 50 batch
   (bf16, chunk min(64, L) = 50: the CUDA-core forward and backward
   kernels, named in the log); (c) ``FaultyTrainer``
   (fail_prob 0.25, seed 1) over 15 steps of llama3-8b smoke on the card
   and on the CPU: same restarts, failed steps and history, losses
   within 2e-2, the card's last checkpoint restored on the CPU bit for
   bit; (d) mamba2-780m at full width and depth (48 layers, d_model
   1536, 48 SSD heads, P 64, N 128), 2 x 4096 tokens, one warm-up and 6
   timed steps: step s, tokens/s, peak GiB, launches per step checked
   (48 each of the SSD forward's chunk and carry launches, backward
   passes (each one chunk-state launch), ``ssd_carry_bwd_tc`` and
   ``ssd_chunk_bwd_tc``; none of the CUDA-core pair), a
   ``torch.profiler`` split of one more step by kernel, its idle share
   and the SSD backward's share of device time;
12. mesh — a one-rank NCCL process group and its (1, 1) ``("data",
   "model")`` mesh (no other backend is tried): (a) llama3-8b as in
   11 (a) and (b) mamba2-780m as in 11 (d), one step through
   ``build_train_step`` on the mesh against the unsharded step from
   equal parameters and moments: loss, parameters and moments bitwise
   (else phase 11's bar, the differing leaves named), every kernel's
   launches equal; then 6 steps of each in turns, medians printed
   side by side (DTensor's host overhead); (c) llama3-8b (4 layers)
   and zamba2-1.2b served through the builders with ``mesh=`` and
   without, 4 x 2048 prompts and 16 and 32 greedy decode tokens:
   logits bitwise (else the decode bar), the state on
   ``state_shardings``' placements, launches equal; (d) the
   simulator's round buffers on the mesh (``set_round_buffer_mesh``):
   phase 4's seed-0 grid unchanged, one paper-smoke cell equal with
   and without, the same affinity launches.  Every time printed
   stands beside the card's name and power limit;
13. dry run — ``repro_torch.launch.dryrun`` on the card's path (the
   kernels' operators through their fakes, nothing launched): (a)
   phase 11 (a)'s step traced on a one-rank fake group's (1, 1) mesh
   (its own process) against the same step run on the card: flops
   equal to ``FlopCounterMode``'s count exactly, predicted peak
   (arguments + temporaries) within 10% of ``max_memory_allocated``;
   (b) ``python -m repro_torch.launch.dryrun`` on the (16, 16) mesh of a
   256-rank fake group for llama3-8b train_4k, qwen2-moe-a2.7b
   train_4k, mamba2-780m prefill_32k, llama3-8b decode_32k and
   zamba2-1.2b long_500k at full width and depth, the five processes
   started together, each exiting 0: trace s, flops, bytes and
   collective bytes per device, live GiB, and the roofline table; (c)
   phase 10's sweep (defaults) with ``art_dir`` on those artifacts, on
   the card and on the CPU: rows equal, launches equal to the CPU's
   rounds, every cost read of a cell with an artifact equal to its flops;
14. dense model at head dims 96 and 256 — llama3-8b's widths (d_model
   4096, d_ff 14336, vocab 128256) with its heads replaced through
   ``ModelConfig``: (i) 32/8 heads of 96 (Phi-3-mini's geometry), (ii)
   16/8 heads of 256 (Gemma-7B's), each served as phase 9's llama3-8b
   (32 layers, 4 × 2048 prompts, 16 greedy decode tokens held against
   ``forward``, one FA launch per layer per prefill, a profiled
   prefill) and trained as phase 11 (a) (4 of 32 layers, 2 × 4096, 6
   timed steps, launches per step checked, a profiled step) and 11 (b)
   (2 layers, 1 × 2048, loss and gradients against the plain attention
   within 2e-2).

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
import os
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
TF32_OPS_PER_S = 494.7e12      # H100 SXM dense TF32 tensor-core peak
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


# Run in a fresh process by ``sdpa_backends``: argv[1] is a JSON list of
# [B, L, H, D, causal, dtype]; prints one JSON list of [backend, kernels].
SDPA_TRACE = r"""
import json
import sys
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
MARKS = (("cudnn", ("cudnn",)), ("flash", ("flash",)),
         ("efficient", ("fmha", "attention_kernel", "efficient")))
out = []
for B, L, H, D, causal, dtype in json.loads(sys.argv[1]):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen, device="cuda")
                   .to(getattr(torch, dtype)).transpose(1, 2)
                   for _ in range(4))
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd():
        o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        torch.autograd.grad(o, (q, k, v), do)
    fwd_bwd()
    torch.cuda.synchronize()
    names = {}
    # Up to three traces: one of a call of a few microseconds has come
    # back holding no device kernel on the card.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd_bwd()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                names[ev.key] = names.get(ev.key, 0.0) + getattr(
                    ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if names:
            break
    if not names:
        raise SystemExit(f"SDPA at {[B, L, H, D, causal, dtype]}: the "
                         f"profiler's trace holds no device kernel")
    row = ["math", ""]
    for backend, marks in MARKS:
        hits = sorted((n for n in names
                       if any(m in n.lower() for m in marks)),
                      key=lambda n: -names[n])
        if hits:
            row = [backend, "; ".join(h[:80] for h in hits[:2])]
            break
    out.append(row)
    del q, k, v, do
print(json.dumps(out))
"""


def sdpa_backends(shapes) -> list:
    """(backend, kernels) of SDPA's forward and backward at each
    (B, L, H, D, causal, dtype), on [B, H, L, D] views as phase 6 times
    them, read from a ``torch.profiler`` trace of one call: "cudnn",
    "flash", "efficient" (the CUTLASS memory-efficient kernels) or "math"
    (no fused attention kernel); kernels = the names of the longest ones.
    The traces are taken in a fresh process: in this one, after phase 5's
    thousands of affinity launches, traces hold no device kernel until a
    later phase (cause not found).  A shape whose three traces hold no
    device kernel is an error."""
    proc = subprocess.run([sys.executable, "-c", SDPA_TRACE,
                           json.dumps([list(s) for s in shapes])],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"SDPA trace failed ({proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return [tuple(r) for r in json.loads(proc.stdout.strip().splitlines()[-1])]


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
            "flash_attention_bwd": fa.LIB_BWD, "ssd": ssd.LIB,
            "ssd_bwd": ssd.LIB_BWD}


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


def phase_parity(seeds=(0, 1, 2), tag="parity") -> dict:
    """Grids scored on the card ≡ the host-only SimEngine, on the
    reference engine tests' workload (8 small workflows at 6 wf/min,
    budgets in [0.5, 1.0]), all five policies, seeds 0-2.

    These auctions stay under the serial-tail threshold, which would drain
    them on the host; with the threshold at 1 every auction round is
    scored by the kernel.  Serial and kernel resolution are bit-exact, so
    the results must not move.  Returns, per seed, the members'
    signatures and the kernel launches."""
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
    out = {}
    try:
        for seed in seeds:
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
            out[seed] = ([signature(e.result) for e in grid.entries],
                         launches)
            log(f"[{tag}] seed {seed}: {len(grid.entries)} members "
                f"identical to the host-only SimEngine, {launches} kernel "
                f"launches (serial-tail threshold 1 instead of {tail})")
    finally:
        cycles.AUCTION_TAIL_PAIRS = tail
    return out


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
# Phase 11 (b)'s fp32 step (llama3-8b, fp32 compute): the fp32 kernels'
# (fa_kernel_tf32, fa_bwd_dkdv_tf32, fa_bwd_dq_tf32) shape on a main path.
FA_TRAIN_F32 = (1, 2048, 32, 128, True, "float32")
# One long fp32 row set, forward only: 32,768 keys, where a sum carried
# across the key tiles would drift furthest (the kernels sum each tile
# from zero); its plain version is timed once.
FA_LONG_F32 = (1, 32768, 8, 128, True, "float32")
# Phase 14's attention, llama3-8b's widths at head dims 96 (32 heads,
# Phi-3-mini's) and 256 (16 heads, Gemma-7B's), GQA's heads repeated: the
# 4 x 2048 prefill (forward) and the 2 x 4096 train step (forward and
# backward).
FA_HD_SERVING = [(4, 2048, 32, 96, True, "bfloat16"),
                 (4, 2048, 16, 256, True, "bfloat16")]
FA_HD_TRAIN = [(2, 4096, 32, 96, True, "bfloat16"),
               (2, 4096, 16, 256, True, "bfloat16")]
# The head-dim domain (1 <= D <= 256) at small shapes, forward and
# backward, both dtypes: each column bucket below, inside and at its top,
# multiples of 8 and not (a bf16 D that is not is padded to one), odd
# ones; (B, Lq, Lk, H, causal): a ragged causal square, non-causal with
# Lq > Lk, causal over a cached prefix.
FA_DOMAIN_DIMS = (1, 8, 17, 24, 32, 48, 64, 80, 96, 100, 112, 128, 160,
                  192, 200, 256)
FA_DOMAIN_SHAPES = ((2, 200, 200, 3, True), (1, 130, 70, 2, False),
                    (1, 70, 333, 2, True))
# The backward kernels (flash_attention_bwd.cu) against attention_bwd_ref:
# the reference sweep, head dim 80, phase 11 (b)'s four archs' attention
# at 1 x 2048 (llama3-8b, qwen2-moe-a2.7b, hubert-xlarge non-causal,
# internvl2-1b; llama3-8b also in fp32) and the headline training shape,
# in bf16 and (the fp32 kernels at 4096 keys) fp32.
FA_TRAIN_F32_4K = FA_TRAIN[:5] + ("float32",)
FA_BWD_SHAPES = FA_SWEEP + FA_D80 + [(1, 2048, 32, 128, True, "bfloat16"),
                                     (1, 2048, 16, 128, True, "bfloat16"),
                                     (1, 2048, 16, 80, False, "bfloat16"),
                                     (1, 2048, 16, 64, True, "bfloat16"),
                                     FA_TRAIN_F32, FA_TRAIN,
                                     FA_TRAIN_F32_4K] + FA_HD_TRAIN
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
# zamba2-1.2b's heads at 8 x 256 tokens: 512 groups of the carry's
# 64-column slices, more than the card holds at once.
SSD_CARRY_GROUPS = (8, 256, 64, 64, 64, 64)
SSD_ATOL = 1e-4      # the sweep's absolute bound
SSD_REL = 1e-4       # full width: max|Δ| <= 1e-4 · max|ref|
# Chunks beyond 64 rows and one that is not a multiple of 4, forward and
# backward, bf16 and fp32: mamba2-780m's heads (48 of P 64, N 128) at
# 2 x 4096 tokens in chunks of 128 and of 256 (Mamba2's own chunk_size),
# held to SSD_REL; a 50-row chunk at small widths, held to SSD_ATOL as
# the sweep.
SSD_CHUNKS = [(2, 4096, 48, 64, 128, 128), (2, 4096, 48, 64, 128, 256),
              (1, 50, 2, 16, 16, 50)]


def esize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def peak_ops(dtype: str) -> float:
    return BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S


def bound(flops: float, nbytes: float, dtype: str, ops_per_s=None):
    """(least ms, what bounds it): operations at ``ops_per_s`` (default
    the dtype's peak rate) or bytes at the memory rate, whichever takes
    longer."""
    by_ops = flops / (ops_per_s or peak_ops(dtype)) * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def fa_pairs(B, L, H, causal):
    """Unmasked (q, k) pairs."""
    return B * H * (L * (L + 1) // 2 if causal else L * L)


def fa_bound(B, L, H, D, causal, dtype):
    """4·D flops per unmasked (q, k) pair; q, k, v and o moved once.  fp32
    products are priced at the faster of the CUDA cores and three TF32
    tensor-core products a product (TF32_OPS_PER_S / 3), as
    ``fa_bwd_bounds`` prices them."""
    return bound(4 * D * fa_pairs(B, L, H, causal),
                 4 * B * L * H * D * esize(dtype), dtype,
                 None if dtype == "bfloat16"
                 else max(FP32_OPS_PER_S, TF32_OPS_PER_S / 3))


def fa_mma_floor(B, L, H, D, causal, dtype):
    """A forward kernel's own tensor-core work at its type's peak (ms):
    bf16 ``fa_kernel_tc`` 8·W flops a pair (q·k once, p·v three times, W
    the head dim's column bucket) at the bf16 peak; fp32
    ``fa_kernel_tf32`` 6·(8⌈D/8⌉ + its p·v columns) (both products three
    TF32 products) at the dense TF32 peak."""
    from repro_torch.kernels.flash_attention.kernel import (
        bucket, fwd_tf32_pv_tiles)
    pairs = fa_pairs(B, L, H, causal)
    if dtype == "bfloat16":
        return 8 * bucket(D) * pairs / BF16_OPS_PER_S * 1e3
    cols = 8 * -(-D // 8) + 8 * fwd_tf32_pv_tiles(D)
    return 6 * cols * pairs / TF32_OPS_PER_S * 1e3


# fp32 products on the tensor cores (ssd_chunk_tf32, ssd_chunk_bwd_tf32,
# the fp32 flash-attention kernels): three TF32 products a product.
TF32_X3_OPS_PER_S = TF32_OPS_PER_S / 3


def ssd_bound(B, L, H, P, N, Q, dtype, ops_per_s=None):
    """What the chunk pass needs, as ``ssd_bwd_bounds`` counts it: per
    (b, h, chunk) W·x over the lower triangle, Q(Q+1)·P flops, and the
    chunk state Bᵀ·(x ∘ dec_end), 2QNP; per (b, chunk) C·Bᵀ over the lower
    triangle, Q(Q+1)·N (B and C have no head axis).  Bytes: x, dt, cum, y
    and the chunk states per head, B and C once per (b, chunk).  Flops at
    ``ops_per_s`` (default the dtype's peak: the CUDA cores for fp32;
    ``ssd_chunk_tf32`` is priced at TF32_X3_OPS_PER_S)."""
    nc = L // Q
    flops = B * nc * (H * (Q * (Q + 1) * P + 2 * Q * N * P)
                      + Q * (Q + 1) * N)
    nbytes = (B * L * H * P * (esize(dtype) + 4) + 2 * B * L * H * 4
              + 2 * B * L * N * esize(dtype) + B * nc * H * N * P * 4)
    return bound(flops, nbytes, dtype, ops_per_s)


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
    from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                         attention_ref)
    dev = torch.device("cuda")
    log("[fa] per call, ms (CUDA events, median after a warm-up): kernel "
        "(bf16: fa_kernel_tc on wgmma; fp32: fa_kernel_tf32 on mma.sync, "
        "every product three TF32 products on split operands); plain = "
        "the torch version on the card (timed once at 32,768 fp32 keys); "
        "library = F.scaled_dot_product_attention(is_causal) on the same "
        "tensors ([B, H, L, D] views; timed only, never used by the "
        "port); bound = the least time for the work (4·D flops per pair "
        "at the bf16 peak, fp32 at three TF32 tensor-core products a "
        "product, 164.9 TFLOP/s) and what bounds it; TFLOP/s = those "
        "flops over the kernel time; MMA floor = the kernel's own "
        "tensor-core work at its type's peak (bf16: 8·W flops per pair, "
        "W the head dim's column bucket: q·k once, p·v three times; fp32, "
        "3×TF32: 6·(8⌈D/8⌉ + the p·v columns it computes) at 494.7 "
        "TFLOP/s); fp32 rows also hold the lse to 1e-4·max(max|ref|, 1); "
        "every row's second pass equal bit for bit")
    rows, worst = {}, 0.0
    for i, shape in enumerate(FA_SWEEP + FA_D80 + FA_SERVING + [FA_TRAIN]
                              + FA_HD_SERVING + FA_HD_TRAIN
                              + [FA_TRAIN_F32, FA_TRAIN_F32_4K,
                                 FA_LONG_F32]):
        B, L, H, D, causal, dtype = shape
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        tdt = getattr(torch, dtype)
        q, k, v = (torch.randn((B, L, H, D), generator=gen, device=dev)
                   .to(tdt) for _ in range(3))
        got, lse = flash_attention_cuda(q, k, v, causal, lse=True)
        again = flash_attention_cuda(q, k, v, causal)
        want = attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash attention {shape}: two passes "
                                 f"differ")
        err = max_err(torch, got, want)
        if not err <= FA_TOL[dtype]:
            raise AssertionError(f"flash attention {shape}: max|Δ| {err} "
                                 f"> {FA_TOL[dtype]}")
        rel = ""
        if dtype == "float32":
            want_lse = attention_lse_ref(q, k, causal)
            lse_err = max_err(torch, lse, want_lse)
            lse_bar = FA_BWD_F32 * max(float(want_lse.abs().max()), 1.0)
            if not lse_err <= lse_bar:
                raise AssertionError(f"flash attention {shape}: lse max|Δ| "
                                     f"{lse_err} > {lse_bar}")
            rel = f"; lse max|Δ| {lse_err:.3g} <= {lse_bar:.3g}"
            del want_lse
        if dtype == "bfloat16":
            ratio = fwd_ratio(torch, got, want, dtype)
            if not ratio <= 1.0:
                raise AssertionError(
                    f"flash attention {shape}: an element's |Δ| is {ratio} "
                    f"times its bound 2^-7·|ref| + {FA_BF16_ABS}")
            rel = (f"; worst |Δ| / (2^-7·|ref| + {FA_BF16_ABS}) "
                   f"{ratio:.4g} <= 1")
        worst = max(worst, err)
        ms = timed_ms(torch, lambda: flash_attention_cuda(q, k, v, causal))
        plain = timed_ms(torch, lambda: attention_ref(q, k, v, causal),
                         max_reps=1 if shape == FA_LONG_F32 else 25)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        bms, bby = fa_bound(B, L, H, D, causal, dtype)
        pairs = fa_pairs(B, L, H, causal)
        tflops = 4 * D * pairs / (ms * 1e-3) / 1e12
        floor = fa_mma_floor(B, L, H, D, causal, dtype)
        rows[shape] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=bby, err=err,
                           tflops=tflops, mma_floor_ms=floor)
        log(f"[fa] [B,H,L,D]={[B, H, L, D]} causal={causal} {dtype}: "
            f"kernel {ms:.5f} plain {plain:.5f} library {lib:.5f} bound "
            f"{bms:.6f} ({bby}); {tflops:.1f} TFLOP/s, kernel/library "
            f"{ms / lib:.2f}; "
            f"{'3×TF32 ' if dtype == 'float32' else ''}MMA floor "
            f"{floor:.6f}; max|Δ| {err:.3g} <= {FA_TOL[dtype]}{rel}")
        del q, k, v, got, again, lse, want
    torch.cuda.empty_cache()
    return dict(rows=rows, max_abs_err=worst)


def fa_bwd_bounds(B, L, H, D, causal, dtype):
    """(least ms, what bounds it) of the whole backward and of each
    kernel, from the work each must do: the backward 10·D flops per
    unmasked pair (S, dP, dV, dK, dQ at 2·D each) and q, k, v, o, dO, lse
    read, dq, dk, dv written once; dK/dV 8·D per pair (S, dP, dV, dK); dQ
    6·D (S, dP, dQ); the preprocess 2·D flops per row, o and dO read and
    D written.  fp32 products are priced at the faster of the CUDA cores
    and three TF32 tensor-core products a product (TF32_OPS_PER_S / 3),
    which holds them to the fp32 bar; the preprocess's row sums stay on
    the CUDA cores."""
    pairs = fa_pairs(B, L, H, causal)
    tile = B * L * H * D * esize(dtype)
    stat = B * H * L * 4
    mm = (None if dtype == "bfloat16"
          else max(FP32_OPS_PER_S, TF32_OPS_PER_S / 3))
    return {"backward": bound(10 * D * pairs, 8 * tile + stat, dtype, mm),
            "preprocess": bound(2 * D * B * L * H, 2 * tile + stat, dtype),
            "dkdv": bound(8 * D * pairs, 6 * tile + 2 * stat, dtype, mm),
            "dq": bound(6 * D * pairs, 5 * tile + 2 * stat, dtype, mm)}


def ptxas_report(lib, kernel: str) -> list:
    """(D, registers, spill stores, spill loads) of each instantiation of
    ``kernel`` in ``lib``'s ``-Xptxas -v`` output."""
    out = []
    for name, regs in lib.ptxas().items():
        d = re.search(rf"{kernel}ILi(\d+)E", name)
        if d:
            out.append((int(d.group(1)), *regs))
    return sorted(out)


def check_builds(lib, tag: str, kernels: dict) -> dict:
    """Registers, dynamic shared memory and spills of tensor-core kernels
    from this run's build (phase 2; ``-Xptxas -v``): ``kernels`` maps a
    kernel's name to (the template values it is built for, its shared
    memory for a value, a note on its registers).  Raises on a spill or
    a missing instantiation."""
    lib.load()
    out = {}
    for name, (values, smem, note) in kernels.items():
        rows = ptxas_report(lib, name)
        if [r[0] for r in rows] != list(values):
            raise AssertionError(f"{name}: ptxas reported "
                                 f"{[r[0] for r in rows]}, expected "
                                 f"{list(values)}")
        for v, regs, st, ld in rows:
            if st or ld:
                raise AssertionError(f"{name}<{v}> spills: {st} bytes "
                                     f"stored, {ld} loaded")
            log(f"[{tag}] {name}<{v}>: {regs} registers a thread{note}, "
                f"{smem(v):,} bytes of dynamic shared memory, spills {st} "
                f"stores / {ld} loads")
            out[f"{name}<{v}>"] = dict(registers=regs, smem=smem(v),
                                       spill_stores=st, spill_loads=ld)
    return out


# setmaxnreg's split of each flash-attention wgmma kernel's registers, and
# the fp32 (TF32 mma.sync) kernels' blocks.
FA_REG_NOTES = {
    "fa_kernel_tc": " at launch (setmaxnreg: 240 a consumer, 24 the "
                    "producer)",
    "fa_bwd_dkdv_tc": " at launch (setmaxnreg: 232 a consumer, 40 the "
                      "producer)",
    "fa_bwd_dq_tc": " at launch (setmaxnreg: 232 a consumer, 40 the "
                    "producer)"}
FA_REG_NOTES.update(dict.fromkeys(
    ("fa_kernel_tf32", "fa_bwd_dkdv_tf32", "fa_bwd_dq_tf32"),
    " (one block an SM: 256 threads up to W = 128, 128 above)"))


def check_tc_builds(fa) -> dict:
    """Every flash-attention kernel (forward and backward, wgmma and
    TF32 mma.sync) at every column bucket: no spill, and each library's
    shared memory equal to ``kernel.py``'s mirror."""
    out = {}
    for lib_obj, tag, size in (
            (fa.LIB, "fa", lambda which, W: fa.LIB.load().fa_smem_bytes(
                which, W)),
            (fa.LIB_BWD, "fa-bwd",
             lambda which, W: fa.LIB_BWD.load().fa_bwd_smem_bytes(which,
                                                                   W))):
        kernels = {}
        for name, (mirror, which) in fa.SMEM.items():
            if (name.startswith("fa_kernel")) != (lib_obj is fa.LIB):
                continue
            for W in fa.BUCKETS:
                got = size(which, W)
                if got != mirror(W) or not got <= fa.SMEM_LIMIT:
                    raise AssertionError(
                        f"{name}<{W}>: the library's shared memory {got} "
                        f"against kernel.py's {mirror(W)} (limit "
                        f"{fa.SMEM_LIMIT})")
            kernels[name] = (fa.BUCKETS,
                             lambda W, w=which: size(w, W),
                             FA_REG_NOTES.get(name, ""))
        out.update(check_builds(lib_obj, tag, kernels))
    buckets = [fa.LIB.load().fa_head_bucket(D)
               for D in range(0, fa.MAX_HEAD_DIM + 2)]
    want = [0] + [fa.bucket(D) for D in range(1, fa.MAX_HEAD_DIM + 1)] + [0]
    if buckets != want:
        raise AssertionError("the library's head-dim buckets differ from "
                             "kernel.bucket's")
    log(f"[fa] head dims 1..{fa.MAX_HEAD_DIM} in buckets {fa.BUCKETS}, the "
        f"library's fa_head_bucket equal to kernel.bucket at every D; "
        f"every kernel's shared memory equal to its mirror in kernel.py")
    return out


def bwd_ratio(torch, got, want, dtype) -> float:
    """Worst |Δ| over its bar (at most 1 passes)."""
    g, w = got.float(), want.float()
    if dtype == "float32":
        return float((g - w).abs().max()) / (
            FA_BWD_F32 * max(float(w.abs().max()), 1.0))
    bar = FA_BWD_BF16_REL * w.abs() + FA_BWD_BF16_ABS * float(w.abs().max())
    return float(((g - w).abs() / bar).max())


def fwd_ratio(torch, got, want, dtype) -> float:
    """Worst forward |Δ| over its bar: fp32 FA_TOL, bf16 per element
    2^-7·|ref| + 1e-6 (at most 1 passes)."""
    g, w = got.float(), want.float()
    if dtype == "float32":
        return float((g - w).abs().max()) / FA_TOL[dtype]
    return float(((g - w).abs() / (FA_BF16_REL * w.abs()
                                    + FA_BF16_ABS)).max())


def phase_attention_domain(torch) -> dict:
    """Every head dim of FA_DOMAIN_DIMS at FA_DOMAIN_SHAPES, both dtypes:
    the forward (with its lse) and the three backward kernels against
    the plain versions at phase 6's bars, each run twice, bitwise equal;
    returns the worst ratio to its bar per dtype and direction."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    dev = torch.device("cuda")
    worst = {}
    t0 = time.perf_counter()
    n = 0
    for D in FA_DOMAIN_DIMS:
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            for B, Lq, Lk, H, causal in FA_DOMAIN_SHAPES:
                gen = torch.Generator(device=dev).manual_seed(D + Lq)
                q, do = (torch.randn((B, Lq, H, D), generator=gen,
                                     device=dev).to(tdt) for _ in range(2))
                k, v = (torch.randn((B, Lk, H, D), generator=gen,
                                    device=dev).to(tdt) for _ in range(2))
                o, lse = fa.flash_attention_cuda(q, k, v, causal, lse=True)
                o2, lse2 = fa.flash_attention_cuda(q, k, v, causal, lse=True)
                got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal)
                again = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                    causal)
                want_o = ref.attention_ref(q, k, v, causal)
                want_lse = ref.attention_lse_ref(q, k, causal)
                want = ref.attention_bwd_ref(q, k, v, o, do, lse, causal)
                torch.cuda.synchronize()
                case = f"D={D} {dtype} {[B, Lq, Lk, H]} causal={causal}"
                if not (torch.equal(o, o2) and torch.equal(lse, lse2)
                        and all(torch.equal(a, g)
                                for a, g in zip(got, again))):
                    raise AssertionError(f"flash attention {case}: two "
                                         f"passes differ")
                if o.shape != q.shape or o.dtype != tdt:
                    raise AssertionError(f"flash attention {case}: output "
                                         f"{o.dtype} {list(o.shape)}")
                ratios = {"fwd": fwd_ratio(torch, o, want_o, dtype)}
                lse_err = max_err(torch, lse, want_lse)
                if not lse_err <= FA_BWD_F32 * max(
                        float(want_lse.abs().max()), 1.0):
                    raise AssertionError(f"flash attention lse {case}: "
                                         f"max|Δ| {lse_err}")
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    if g.shape != w.shape or g.dtype != tdt:
                        raise AssertionError(f"backward {case}: {name} is "
                                             f"{g.dtype} {list(g.shape)}")
                    ratios[name] = bwd_ratio(torch, g, w, dtype)
                bad = {k: r for k, r in ratios.items() if not r <= 1.0}
                if bad:
                    raise AssertionError(f"flash attention {case}: worst "
                                         f"|Δ| over its bar {bad}")
                for key, r in ratios.items():
                    slot = (dtype, "fwd" if key == "fwd" else "bwd")
                    worst[slot] = max(worst.get(slot, 0.0), r)
                n += 1
                del q, k, v, do, o, o2, lse, lse2, got, again, want
    log(f"[fa] head-dim domain: {n} cases (D in {list(FA_DOMAIN_DIMS)}, "
        f"bf16 and fp32, (B, Lq, Lk, H, causal) in "
        f"{[list(s) for s in FA_DOMAIN_SHAPES]}): forward, lse and the "
        f"backward kernels within phase 6's bars, two passes equal bit "
        f"for bit, in {time.perf_counter() - t0:.3f} s; worst |Δ|/bar "
        + ", ".join(f"{dt} {d} {r:.4g}" for (dt, d), r in
                    sorted(worst.items())))
    torch.cuda.empty_cache()
    return {f"{dt} {d}": r for (dt, d), r in worst.items()}


def phase_attention_bwd(torch) -> dict:
    """The three backward kernels against attention_bwd_ref (and the
    forward's lse against attention_lse_ref) on the card; times of the
    whole backward and of each kernel, the plain version, the bound and
    the library call's backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    dev = torch.device("cuda")
    builds = check_tc_builds(fa)
    log("[fa-bwd] per call, ms (CUDA events, median after a warm-up): "
        "backward = fa_bwd_preprocess, then dK/dV and dQ through "
        "flash_attention_bwd_cuda (bf16: fa_bwd_dkdv_tc and fa_bwd_dq_tc "
        "on wgmma, P and dS in three bf16 terms; fp32: fa_bwd_dkdv_tf32 "
        "and fa_bwd_dq_tf32 on mma.sync, every product three TF32 "
        "products on split operands); plain = "
        "attention_bwd_ref on the card (and each kernel's own plain "
        "step); library = F.scaled_dot_product_attention(is_causal) "
        "forward and backward minus its forward, on [B, H, L, D] views "
        "(timed only, never used by the port), with the backend SDPA "
        "picked (from the kernel names of a profiler trace in a fresh "
        "process); bound = the least time for each one's work (backward "
        "10·D flops per pair at the dtype's peak: bf16 tensor cores, fp32 "
        "three TF32 tensor-core products a product, 164.9 TFLOP/s) and "
        "what bounds it; MMA floor = a kernel's own tensor-core work at "
        "its type's peak (bf16: dK/dV 18·W flops per pair, dQ 10·W; fp32, "
        "3×TF32: dK/dV 24·W, dQ 18·W at 494.7 TFLOP/s; W the head dim's "
        "column bucket)")
    backends = sdpa_backends(FA_BWD_SHAPES)
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
        again = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal)
        want = ref.attention_bwd_ref(q, k, v, o, do, lse, causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            raise AssertionError(f"flash attention backward {shape}: two "
                                 f"passes differ (the kernels use no "
                                 f"atomics)")
        del again
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
        backend, lib_kernels = backends[i]
        bounds = fa_bwd_bounds(B, L, H, D, causal, dtype)
        names = {"preprocess": "fa_bwd_preprocess",
                 "dkdv": fa.bwd_kernel("dkdv", tdt),
                 "dq": fa.bwd_kernel("dq", tdt)}
        pairs = fa_pairs(B, L, H, causal)
        W = fa.bucket(D)
        floor = ({"dkdv": 18 * W * pairs / BF16_OPS_PER_S * 1e3,
                  "dq": 10 * W * pairs / BF16_OPS_PER_S * 1e3}
                 if dtype == "bfloat16" else
                 {"dkdv": 24 * W * pairs / TF32_OPS_PER_S * 1e3,
                  "dq": 18 * W * pairs / TF32_OPS_PER_S * 1e3})
        rows[shape] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           library_backend=backend, bounds=bounds,
                           mma_floor_ms=floor, ratios=ratios)
        parts = "; ".join(
            f"{names[k]} {ms[k]:.5f} (plain {plain[k]:.5f}, bound "
            f"{bounds[k][0]:.6f} {bounds[k][1]}"
            + (f", {'3×TF32 ' if dtype == 'float32' else ''}MMA floor "
               f"{floor[k]:.6f}" if k in floor else "") + ")"
            for k in ("preprocess", "dkdv", "dq"))
        log(f"[fa-bwd] [B,H,L,D]={[B, H, L, D]} causal={causal} {dtype}: "
            f"backward {ms['backward']:.5f} plain {plain['backward']:.5f} "
            f"library {lib:.5f} ({backend}: {lib_kernels}) bound "
            f"{bounds['backward'][0]:.6f} "
            f"({bounds['backward'][1]}), backward/library "
            f"{ms['backward'] / lib:.2f}; {parts}; worst |Δ|/bar "
            + ", ".join(f"{k} {r:.4g}" for k, r in ratios.items())
            + " <= 1")
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()
    pre = preprocess_rows(torch)
    return dict(rows=rows, max_abs_err=worst, builds=builds, preprocess=pre)


# fa_bwd_preprocess's domain: every column bucket's top, and head dims
# whose rows its 16-byte pieces do not fit (1, 33, 200 in bf16; 1, 33 in
# fp32) or fit in uneven counts (80, 96), at (2, 300, 3, D), each also on
# a view one element into a larger buffer (misaligned); then its time at
# the training shapes that launch it: phase 11 (a)'s, (b)'s fp32 llama3-8b
# step's and phase 14's.
FA_PRE_DIMS = (1, 32, 33, 64, 80, 96, 128, 192, 200, 256)
FA_PRE_SHAPES = [FA_TRAIN, FA_TRAIN_F32] + FA_HD_TRAIN


def offset_view(torch, t, offset: int):
    """``t``'s values in a contiguous view ``offset`` elements into a
    larger buffer (not 16-byte aligned at offset 1)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def preprocess_rows(torch) -> dict:
    """fa_bwd_preprocess against bwd_preprocess_ref (max|Δ| <=
    FA_BWD_F32·max(max|ref|, 1)), two passes bitwise, at FA_PRE_DIMS in
    both dtypes, aligned and not; then at FA_PRE_SHAPES its time through
    the C entry point (BURST launches back to back) and through the
    wrapper, the plain version's, its byte bound and share of it; its
    builds' registers and spills."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    dev = torch.device("cuda")
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for D in FA_PRE_DIMS:
            for offset in (0, 1):
                gen = torch.Generator(device=dev).manual_seed(7 * D + offset)
                o, do = (offset_view(torch, torch.randn(
                    (2, 300, 3, D), generator=gen, device=dev).to(tdt),
                    offset) for _ in range(2))
                got = fa.bwd_preprocess_cuda(o, do)
                again = fa.bwd_preprocess_cuda(o, do)
                want = ref.bwd_preprocess_ref(o, do)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"fa_bwd_preprocess D {D} {dtype} "
                                         f"offset {offset}: two passes "
                                         f"differ")
                ratio = max_err(torch, got, want) / (
                    FA_BWD_F32 * max(float(want.abs().max()), 1.0))
                if not ratio <= 1.0:
                    raise AssertionError(f"fa_bwd_preprocess D {D} {dtype} "
                                         f"offset {offset}: {ratio} times "
                                         f"its bar")
                worst = max(worst, ratio)
    log(f"[fa-bwd] fa_bwd_preprocess at D {list(FA_PRE_DIMS)}, fp32 and "
        f"bf16, aligned and one element off: worst max|Δ| / "
        f"({FA_BWD_F32}·max(max|ref|, 1)) {worst:.4g} <= 1; two passes "
        f"bitwise")
    lib = fa.LIB_BWD.load()
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for i, shape in enumerate(FA_PRE_SHAPES):
        B, L, H, D, causal, dtype = shape
        tdt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(500 + i)
        o, do = (torch.randn((B, L, H, D), generator=gen, device=dev)
                 .to(tdt) for _ in range(2))
        delta = torch.empty((B, H, L), device=dev)
        ms = burst_ms(torch, lambda: lib.fa_bwd_preprocess_launch(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), fa.DTYPES[tdt],
            B, H, L, D, stream))
        want = ref.bwd_preprocess_ref(o, do)
        torch.cuda.synchronize()
        ratio = max_err(torch, delta, want) / (
            FA_BWD_F32 * max(float(want.abs().max()), 1.0))
        if not ratio <= 1.0:
            raise AssertionError(f"fa_bwd_preprocess {shape}: {ratio} "
                                 f"times its bar")
        wrapped = timed_ms(torch, lambda: fa.bwd_preprocess_cuda(o, do), 0.1)
        plain = timed_ms(torch, lambda: ref.bwd_preprocess_ref(o, do), 0.1)
        bms, bby = fa_bwd_bounds(B, L, H, D, causal, dtype)["preprocess"]
        rows[shape] = dict(entry_ms=ms, ms=wrapped, plain_ms=plain,
                           bound_ms=bms, bound_by=bby, bound_share=bms / ms,
                           ratio=ratio)
        log(f"[fa-bwd] fa_bwd_preprocess [B,H,L,D]={[B, H, L, D]} {dtype}: "
            f"{ms:.5f} ms a launch through fa_bwd_preprocess_launch "
            f"({ab_common().BURST} back to back), {wrapped:.5f} through the "
            f"wrapper, "
            f"plain {plain:.5f}, bound {bms:.6f} ({bby}), {bms / ms:.3f} "
            f"of it; max|Δ| / bar {ratio:.4g}")
        del o, do, delta, want
    builds = build_rows(fa.LIB_BWD, "fa_bwd_preprocess")
    log("[fa-bwd] fa_bwd_preprocess's builds (-Xptxas -v; no dynamic "
        "shared memory, 2,048 bytes static): " + "; ".join(
            f"<{k}> {v[0]} registers, spills {v[1]} / {v[2]}"
            for k, v in sorted(builds.items())))
    torch.cuda.empty_cache()
    return dict(rows=rows, domain_worst=worst, builds=builds)


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


def carry_bound(B, L, H, P, N, Q, dtype, ops_per_s=None):
    """2·N flops per y element, on the CUDA cores unless ``ops_per_s``
    says otherwise (``ssd_carry_tf32`` at TF32_X3_OPS_PER_S); y_intra and
    the chunk states read once (fp32), C and cum, y written in ``dtype``
    and the final state (fp32)."""
    nc = L // Q
    flops = 2 * B * L * H * N * P + 2 * B * nc * H * N * P
    nbytes = (B * L * H * P * (4 + esize(dtype)) + B * nc * H * N * P * 4
              + B * L * N * esize(dtype) + B * L * H * 4 + B * H * N * P * 4)
    return bound(flops, nbytes, "float32", ops_per_s)


def burst_ms(torch, fn) -> float:
    """Median ms per launch of a C entry point, BURST launches back to back
    a window (``tools/ab_common.py``'s ``ms``), so that no wrapper's host
    time lands between launches; fails if a launch is refused."""
    if fn() != 0:
        raise AssertionError("a timed launch failed")
    return ab_common().ms(fn)


def turns(torch, new, old) -> tuple:
    """(new, old, old, new) ms a launch of two C entry points
    (``burst_ms``): a kernel and the one it is held against, in turns."""
    return (burst_ms(torch, new), burst_ms(torch, old),
            burst_ms(torch, old), burst_ms(torch, new))


def ab_common():
    """``tools/ab_common.py``, the A/B tools' timer (BURST launches a
    window)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import ab_common as module
    return module


def build_rows(lib, kernel: str) -> dict:
    """{template arguments: [registers, spill stores, spill loads]} of each
    instantiation of ``kernel`` in ``lib``'s ``-Xptxas -v`` output (this
    process's build), the arguments written plainly: fp32 or bf16, vec or
    scalar, integers."""
    out = {}
    for name, regs in lib.ptxas().items():
        m = re.search(rf"{kernel}I(.*?)EE", name)
        if not m:
            continue
        args = (m.group(1).replace("13__nv_bfloat16", "bf16 ")
                .replace("Lb1E", "vec ").replace("Lb0E", "scalar "))
        args = re.sub(r"Li(\d+)E?", r"\1 ", args)
        if args.startswith("f"):
            args = "fp32 " + args[1:]
        out[" ".join(args.split())] = list(regs)
    return out


def carry_row(torch, shape, yi, st, cum, Cb, h0, hold) -> dict:
    """``ssd_carry_tc`` at one bf16 shape: y (fp32) and the final state
    against ``ssd_carry_ref`` with and without an initial state (``hold``,
    SSD_REL), two passes bitwise (y in bf16), then its time through the C
    entry point (y in bf16, BURST launches back to back), the plan it
    launches with (its shared memory equal to ``kernel.py``'s mirror) and
    its share of the byte bound."""
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd.ref import ssd_carry_ref
    B, L, H, P, N, Q = shape
    for init, tag in ((None, ""), (h0, " (init state)")):
        gy, gf = sk.ssd_carry_cuda(yi, st, cum, Cb, Q, init)
        wy, wf = ssd_carry_ref(yi, st, cum, Cb, Q, init)
        hold(shape, "carry y" + tag, gy, wy)
        hold(shape, "carry final state" + tag, gf, wf)
        del gy, gf, wy, wf
    y, final = sk.ssd_carry_cuda(yi, st, cum, Cb, Q, h0, torch.bfloat16)
    again = sk.ssd_carry_cuda(yi, st, cum, Cb, Q, h0, torch.bfloat16)
    torch.cuda.synchronize()
    if not (torch.equal(y, again[0]) and torch.equal(final, again[1])):
        raise AssertionError(f"ssd_carry_tc {shape}: two passes differ")
    del again
    lib = sk.LIB.load()
    stream = torch.cuda.current_stream().cuda_stream
    code = sk.DTYPES[torch.bfloat16]
    ms = burst_ms(torch, lambda: lib.ssd_carry_launch(
        yi.data_ptr(), st.data_ptr(), cum.data_ptr(), Cb.data_ptr(), None,
        y.data_ptr(), final.data_ptr(), code, code, B, L, H, P, N, Q,
        stream))
    plan = sk.carry_plan(torch.bfloat16, B, H, P, N, Q)
    mirror = sk.carry_tc_smem_bytes(N, Q, plan["ps"], plan["stages"])
    if plan["smem"] != mirror:
        raise AssertionError(f"ssd_carry_tc {shape}: the library's plan "
                             f"has {plan['smem']} bytes of shared memory, "
                             f"kernel.py's mirror {mirror}")
    bms, bby = carry_bound(*shape, "bfloat16")
    log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} ssd_carry_tc (y bf16): "
        f"{ms:.5f} ms a launch through ssd_carry_launch "
        f"({ab_common().BURST} back to back), bound {bms:.6f} ({bby}), "
        f"{bms / ms:.3f} of it; plan {plan['ps']}-column slices, "
        f"{plan['stages']}-stage rings, "
        f"{plan['blocks']} blocks of {plan['threads']} threads, "
        f"{plan['smem']:,} bytes of shared memory; two passes bitwise")
    del y, final
    return dict(entry_ms=ms, plan=plan, bound_ms=bms, bound_by=bby,
                bound_share=bms / ms)


# fp32 at the fp32 tensor-core kernels' shapes (Q = P = 64, N 128 and 64):
# the reference sweep's, phase 11 (b)'s fp32 mamba2-780m step (1 x 2048,
# where a main path launches them), and mamba2-780m's and zamba2-1.2b's
# heads at 2 x 4096.
SSD_TF32_SHAPES = [SSD_SWEEP[1], (1, 2048, 48, 64, 128, 64),
                   (2, 4096, 48, 64, 128, 64), (2, 4096, 64, 64, 64, 64)]


def ssd_tf32_rows(torch) -> dict:
    """Phase 6's fp32 forward at SSD_TF32_SHAPES: ``ssd_chunk_tf32`` and
    the CUDA-core ``ssd_chunk_kernel`` (``terms=0``) on the same inputs
    against ``ssd_chunks_ref``, each output within
    SSD_REL·max(max|ref|, 1) (the sweep's 1e-4 where max|ref| < 1), the
    new kernel's second pass bitwise; both timed through the C entry point
    in turns (new, CUDA cores, CUDA cores, new), the new one also through
    its wrapper, the plain version once; likewise the fp32 carries,
    ``ssd_carry_tf32`` (``ssd_carry_launch``) and ``ssd_carry_kernel``
    (``cuda_cores=True``, ``ssd_carry_core_launch``) against
    ``ssd_carry_ref`` with an initial state, the plan ``ssd_carry_tf32``
    launches with (its shared memory equal to kernel.py's mirror); each
    beside its bound, the new kernels' products priced at
    TF32_X3_OPS_PER_S, the CUDA-core kernels' at the fp32 CUDA-core rate.
    Also the heads a block and shared memory the chunk kernel launches
    with (equal to kernel.py's mirrors), and both new kernels' builds
    (no spill)."""
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd.ref import (chunk_cumsum, ssd_carry_ref,
                                             ssd_chunks_ref)
    lib = sk.LIB.load()
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32 = torch.float32
    rows, worst = {}, {"ssd_chunk_tf32": 0.0, "ssd_chunk_kernel": 0.0,
                       "ssd_carry_tf32": 0.0, "ssd_carry_kernel": 0.0}

    def held(shape, name, got, want):
        err, scale = max_err(torch, got, want), float(want.abs().max())
        if not err <= SSD_REL * max(scale, 1.0):
            raise AssertionError(f"ssd {shape} {name}: max|Δ| {err} > "
                                 f"{SSD_REL} * max({scale}, 1)")
        return err / (SSD_REL * max(scale, 1.0)), err

    for i, shape in enumerate(SSD_TF32_SHAPES):
        B, L, H, P, N, Q = shape
        x, dt, A, Bm, Cm = ssd_inputs(torch, shape, 380 + i)
        cum = chunk_cumsum(dt, A, Q)
        want = tuple(t.contiguous()
                     for t in ssd_chunks_ref(x, dt, cum, Bm, Cm, Q))
        got = sk.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
        again = sk.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
        core = sk.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q, terms=0)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ssd_chunk_tf32 {shape}: two passes "
                                 f"differ")
        ratio = {}

        def hold_all(name, pairs):
            r = [held(shape, f"{name} {what}", o, w) for what, o, w in pairs]
            ratio[name] = max(v for v, _ in r)
            worst[name] = max(worst[name], *(e for _, e in r))
        for name, out in (("ssd_chunk_tf32", got),
                          ("ssd_chunk_kernel", core)):
            hold_all(name, zip(("y_intra", "chunk states"), out, want))
        del again, core
        yi, st = want
        h0 = torch.randn((B, H, N, P), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(390 + i))
        wy, wf = ssd_carry_ref(yi, st, cum, Cm, Q, h0)
        cy, cf = sk.ssd_carry_cuda(yi, st, cum, Cm, Q, h0)
        again = sk.ssd_carry_cuda(yi, st, cum, Cm, Q, h0)
        ky, kf = sk.ssd_carry_cuda(yi, st, cum, Cm, Q, h0, cuda_cores=True)
        torch.cuda.synchronize()
        if not (torch.equal(cy, again[0]) and torch.equal(cf, again[1])):
            raise AssertionError(f"ssd_carry_tf32 {shape}: two passes "
                                 f"differ")
        for name, y_, f_ in (("ssd_carry_tf32", cy, cf),
                             ("ssd_carry_kernel", ky, kf)):
            hold_all(name, (("y", y_, wy), ("final state", f_, wf)))
        del wy, wf, again, ky, kf
        y, states = got
        code = sk.DTYPES[f32]

        def chunk_call(terms):
            return lambda: lib.ssd_chunk_launch(
                x.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), states.data_ptr(), code, B, L,
                H, P, N, Q, terms, stream)

        def carry_call(entry):
            return lambda: entry(
                yi.data_ptr(), st.data_ptr(), cum.data_ptr(), Cm.data_ptr(),
                None, cy.data_ptr(), cf.data_ptr(), code, code, B, L, H, P,
                N, Q, stream)
        t = turns(torch, chunk_call(sk.TF32_TERMS), chunk_call(0))
        tc = turns(torch, carry_call(lib.ssd_carry_launch),
                   carry_call(lib.ssd_carry_core_launch))
        wrapper = timed_ms(torch, lambda: sk.ssd_chunks_cuda(x, dt, cum, Bm,
                                                             Cm, Q))
        carry_wrapper = timed_ms(torch, lambda: sk.ssd_carry_cuda(
            yi, st, cum, Cm, Q))
        plain = timed_ms(torch, lambda: ssd_chunks_ref(x, dt, cum, Bm, Cm,
                                                       Q), 0.2)
        carry_plain = timed_ms(torch, lambda: ssd_carry_ref(yi, st, cum, Cm,
                                                            Q), 0.2)
        G = lib.ssd_chunk_tf32_heads(B, L, H)
        smem = lib.ssd_chunk_tf32_smem_bytes(N, G)
        if G != sk.chunk_tf32_heads(B * L // Q, H, sms) or \
                smem != sk.chunk_tf32_smem_bytes(N, G):
            raise AssertionError(f"ssd_chunk_tf32 {shape}: the library "
                                 f"takes {G} heads a block and {smem} "
                                 f"bytes, kernel.py's mirrors disagree")
        plan = sk.carry_plan(f32, B, H, P, N, Q, c_dtype=f32)
        mirror = sk.carry_tc_smem_bytes(N, Q, plan["ps"], plan["stages"],
                                        f32)
        if plan["smem"] != mirror:
            raise AssertionError(f"ssd_carry_tf32 {shape}: the library's "
                                 f"plan has {plan['smem']} bytes of shared "
                                 f"memory, kernel.py's mirror {mirror}")
        bms, bby = ssd_bound(*shape, "float32", TF32_X3_OPS_PER_S)
        cbms, cbby = ssd_bound(*shape, "float32")
        kbms, kbby = carry_bound(*shape, "float32", TF32_X3_OPS_PER_S)
        kcbms, kcbby = carry_bound(*shape, "float32")
        rows[shape] = dict(
            entry_ms=(t[0] + t[3]) / 2, core_entry_ms=(t[1] + t[2]) / 2,
            turns=list(t), ms=wrapper, plain_ms=plain, bound_ms=bms,
            bound_by=bby, core_bound_ms=cbms, core_bound_by=cbby,
            carry_entry_ms=(tc[0] + tc[3]) / 2,
            carry_core_entry_ms=(tc[1] + tc[2]) / 2, carry_turns=list(tc),
            carry_ms=carry_wrapper, carry_plain_ms=carry_plain,
            carry_bound_ms=kbms, carry_bound_by=kbby,
            carry_core_bound_ms=kcbms, carry_core_bound_by=kcbby,
            carry_plan=plan, heads_per_block=G, smem=smem, ratio=ratio)
        log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} float32 forward: "
            f"ssd_chunk_tf32 / ssd_chunk_kernel through ssd_chunk_launch, "
            f"in turns (new, CUDA cores, CUDA cores, new), ms a launch "
            + ", ".join(f"{v:.5f}" for v in t)
            + f" (new / CUDA cores {(t[0] + t[3]) / (t[1] + t[2]):.4f}); "
            f"ssd_chunk_tf32 bound {bms:.6f} ({bby}, 3×TF32), "
            f"{bms / rows[shape]['entry_ms']:.3f} of it; ssd_chunk_kernel "
            f"bound {cbms:.6f} ({cbby}); wrapper {wrapper:.5f}, plain "
            f"{plain:.5f}; {G} heads a block, {smem:,} bytes of shared "
            f"memory; ssd_carry_tf32 / ssd_carry_kernel through "
            f"ssd_carry_launch / ssd_carry_core_launch in turns "
            + ", ".join(f"{v:.5f}" for v in tc)
            + f" (new / CUDA cores {(tc[0] + tc[3]) / (tc[1] + tc[2]):.4f}),"
            f" bound {kbms:.6f} ({kbby}), "
            f"{kbms / rows[shape]['carry_entry_ms']:.3f} of it; wrapper "
            f"{carry_wrapper:.5f}, plain {carry_plain:.5f}; plan "
            f"{plan['ps']}-column slices, {plan['stages']}-stage rings, "
            f"{plan['blocks']} blocks of {plan['threads']} threads, "
            f"{plan['smem']:,} bytes; worst max|Δ|/bar "
            + ", ".join(f"{k} {v:.4g}" for k, v in ratio.items())
            + "; ssd_chunk_tf32's and ssd_carry_tf32's two passes bitwise")
        del x, dt, A, Bm, Cm, cum, want, got, yi, st, y, states, cy, cf, h0
        torch.cuda.empty_cache()
    # Per N at 16 heads a block (two blocks an SM at N = 128); raises on a
    # spill.
    builds = check_builds(sk.LIB, "ssd", {"ssd_chunk_tf32": (
        [64, 128], lambda n: lib.ssd_chunk_tf32_smem_bytes(n, 16), "")})
    carry_builds = build_rows(sk.LIB, "ssd_carry_tf32")
    spills = {k: v for k, v in carry_builds.items() if v[1] or v[2]}
    if len(carry_builds) != 8 or spills:
        raise AssertionError(f"ssd_carry_tf32's builds {carry_builds}: "
                             f"expected 8 (y fp32 or bf16 at 8, 16, 32 and "
                             f"64 columns), no spill")
    log("[ssd] ssd_carry_tf32's builds (-Xptxas -v; shared memory is the "
        "plan's, above): " + "; ".join(
            f"<{k}> {v[0]} registers, spills {v[1]} / {v[2]}"
            for k, v in sorted(carry_builds.items())))
    return dict(rows=rows, worst=worst, builds=builds,
                carry_builds=carry_builds)


def phase_ssd(torch) -> dict:
    from repro_torch.kernels.ssd import kernel as sk
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
    carry_rows = {}

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
        # with and without an initial state, y in fp32; two passes
        # bitwise, its time through the C entry point and its plan.
        h0 = torch.randn((B, H, N, P), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(400 + i))
        carry_rows[shape] = carry_row(torch, shape, *want, cum, Cb, h0, hold)
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
    # Phase 11 (d)'s carry (mamba2-780m, 2 x 4096, bf16 C): 48 launches a
    # step, held and timed as above, beside its wrapper and plain times.
    shape = SSD_TRAIN[0]
    B, L, H, P, N, Q = shape
    x, dt, A, Bm, Cm = ssd_inputs(torch, shape, 350)
    xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    del x, Bm, Cm
    cum = chunk_cumsum(dt, A, Q)
    yi, st = (t.contiguous() for t in ssd_chunks_ref(xb, dt, cum, Bb, Cb, Q))
    h0 = torch.randn((B, H, N, P), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(450))
    carry_rows[shape] = carry_row(torch, shape, yi, st, cum, Cb, h0, hold)
    carry_rows[shape].update(
        ms=timed_ms(torch, lambda: ssd_carry_cuda(yi, st, cum, Cb, Q, None,
                                                  torch.bfloat16)),
        plain_ms=timed_ms(torch, lambda: ssd_carry_ref(yi, st, cum, Cb, Q,
                                                       None, torch.bfloat16)))
    del xb, Bb, Cb, yi, st, cum, h0, dt, A
    torch.cuda.empty_cache()
    # A persistent grid with more groups than blocks: its rings run on
    # across a group boundary, h or the initial state is loaded again and
    # a second final state written by the same block.
    shape = SSD_CARRY_GROUPS
    B, L, H, P, N, Q = shape
    x, dt, A, Bm, Cm = ssd_inputs(torch, shape, 360)
    xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    cum = chunk_cumsum(dt, A, Q)
    yi, st = (t.contiguous() for t in ssd_chunks_ref(xb, dt, cum, Bb, Cb, Q))
    h0 = torch.randn((B, H, N, P), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(460))
    carry_rows[shape] = carry_row(torch, shape, yi, st, cum, Cb, h0, hold)
    plan = carry_rows[shape]["plan"]
    if not plan["blocks"] < B * H * (P // plan["ps"]):
        raise AssertionError(f"ssd_carry_tc {shape}: plan {plan} gives "
                             "every group a block of its own")
    del x, Bm, Cm, xb, Bb, Cb, yi, st, cum, h0, dt, A
    for shape, r in rows.items():
        carry_rows[shape].update(ms=r["carry_ms"], plain_ms=r["carry_plain_ms"])
    builds = build_rows(sk.LIB, "ssd_carry_tc")
    log("[ssd] ssd_carry_tc's builds (-Xptxas -v; shared memory is the "
        "plan's, above): " + "; ".join(
            f"<{k}> {v[0]} registers, spills {v[1]} / {v[2]}"
            for k, v in sorted(builds.items())))
    t0 = time.perf_counter()
    chunks = ssd_chunk_rows(torch, hold)
    log(f"[ssd] the chunks of SSD_CHUNKS took {time.perf_counter() - t0:.3f} "
        f"s")
    tf32 = ssd_tf32_rows(torch)
    return dict(rows=rows, chunks=chunks, max_abs_err=worst,
                carry_max_abs_err=carry_worst, terms=TERMS,
                carry_rows=carry_rows, carry_builds=builds, tf32=tf32)


def ssd_chunk_rows(torch, hold) -> dict:
    """Phase 6 at SSD_CHUNKS, bf16 and fp32: the chunk kernel against
    ssd_chunks_ref, the carry (y in fp32, with and without an initial
    state) against ssd_carry_ref on the plain chunk outputs, and the
    whole ssd() against ssd_ref (fp32: y and the final state; bf16: y
    within one bf16 step of the fp32 reference on the same bf16 values),
    each within SSD_REL·max|ref| at full width or SSD_ATOL at the small
    shape; then each timed beside its plain version and its bound."""
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.kernel import (fwd_kernels,
                                                ssd_carry_cuda,
                                                ssd_chunks_cuda)
    from repro_torch.kernels.ssd.ref import (chunk_cumsum, ssd_carry_ref,
                                             ssd_chunks_ref, ssd_ref)
    # Each library's shared memory at these chunks, as it reports it,
    # equal to kernel.py's mirror and within a block's limit.
    fwd = sk.LIB.load().ssd_smem_bytes
    bwd = sk.LIB_BWD.load().ssd_bwd_smem_bytes
    for _, _, _, P, N, Q in SSD_CHUNKS + SSD_SERVING:
        for got, want, what in (
                (fwd(0, Q, N, P), sk.smem_bytes(Q, N, P), "chunk kernel"),
                (fwd(1, Q, N, P), sk.carry_smem_bytes(N, Q, torch.float32),
                 "carry (fp32 C)"),
                (fwd(2, Q, N, P), sk.carry_smem_bytes(N, Q, torch.bfloat16),
                 "carry (bf16 C)"),
                (fwd(3, Q, N, P), None, "ssd_carry_tc"),
                (bwd(0, Q, N, P), sk.chunk_bwd_smem_bytes(Q, N, P),
                 "ssd_chunk_bwd"),
                (bwd(1, Q, N, P), 4 * Q * (N + 16), "ssd_carry_bwd")):
            if not 0 < got <= sk.MAX_SMEM_BYTES or want not in (None, got):
                raise AssertionError(f"{what} at Q {Q}, N {N}, P {P}: the "
                                     f"library reports {got} bytes, "
                                     f"kernel.py {want}")
    log("[ssd] shared memory at SSD_CHUNKS and SSD_SERVING, bytes, as the "
        "libraries report it (= kernel.py's mirrors): " + "; ".join(
            f"Q {Q} N {N} P {P}: chunk {fwd(0, Q, N, P)}, carry "
            f"{fwd(1, Q, N, P)} / {fwd(2, Q, N, P)} / {fwd(3, Q, N, P)}, "
            f"chunk bwd {bwd(0, Q, N, P)}, carry bwd {bwd(1, Q, N, P)}"
            for _, _, _, P, N, Q in SSD_CHUNKS))
    rows = {}
    for i, shape in enumerate(SSD_CHUNKS):
        B, L, H, P, N, Q = shape
        small = L * H < 4096
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            x, dt, A, Bm, Cm = ssd_inputs(torch, shape, 700 + i)
            x, Bm, Cm = (t.to(tdt) for t in (x, Bm, Cm))
            names = fwd_kernels(tdt, Q, P, N)
            tag = f"{dtype} ({names[0]}, {names[1]})"

            def held(name, got, want):
                if small:
                    err = max_err(torch, got, want)
                    if not err <= SSD_ATOL:
                        raise AssertionError(f"ssd {shape} {name}: max|Δ| "
                                             f"{err} > {SSD_ATOL}")
                    log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} {name}: max|Δ| "
                        f"{err:.3g} <= {SSD_ATOL}")
                else:
                    hold(shape, name, got, want)
            cum = chunk_cumsum(dt, A, Q)
            want = tuple(t.contiguous()
                         for t in ssd_chunks_ref(x, dt, cum, Bm, Cm, Q))
            got = ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
            held("y_intra " + tag, got[0], want[0])
            held("chunk states " + tag, got[1], want[1])
            del got
            h0 = torch.randn((B, H, N, P), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(710 + i))
            for init, note in ((None, ""), (h0, " (init state)")):
                gy, gf = ssd_carry_cuda(*want, cum, Cm, Q, init)
                wy, wf = ssd_carry_ref(*want, cum, Cm, Q, init)
                held("carry y " + tag + note, gy, wy)
                held("carry final state " + tag + note, gf, wf)
                del gy, gf, wy, wf
            xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
            want_scan = ssd_ref(xf, dt, A, Bf, Cf, chunk=Q)
            got_scan = ops.ssd(x, dt, A, Bm, Cm, chunk=Q)
            if dtype == "float32":
                held("y " + tag, got_scan[0], want_scan[0])
            else:
                wy = want_scan[0]
                step = float(((got_scan[0].float() - wy).abs()
                              / (2.0 ** -8 * wy.abs() + SSD_REL * max(
                                  float(wy.abs().max()), 1.0))).max())
                if not step <= 1.0:
                    raise AssertionError(f"ssd {shape} bf16 y: {step} times "
                                         f"its bound")
                log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} y {tag}: worst |Δ| / "
                    f"(2^-8·|ref| + {SSD_REL}·max(max|ref|, 1)) {step:.4g} "
                    f"<= 1")
            held("final state " + tag, got_scan[1], want_scan[1])
            del got_scan, want_scan, xf, Bf, Cf
            yi, st = want
            ms = timed_ms(torch, lambda: ssd_chunks_cuda(x, dt, cum, Bm, Cm,
                                                         Q))
            plain = timed_ms(torch, lambda: ssd_chunks_ref(x, dt, cum, Bm,
                                                           Cm, Q), 0.2)
            carry = timed_ms(torch, lambda: ssd_carry_cuda(
                yi, st, cum, Cm, Q, None, tdt))
            carry_plain = timed_ms(torch, lambda: ssd_carry_ref(
                yi, st, cum, Cm, Q, None, tdt), 0.2)
            scan = timed_ms(torch, lambda: ops.ssd(x, dt, A, Bm, Cm,
                                                   chunk=Q))
            scan_plain = timed_ms(torch, lambda: ssd_ref(x, dt, A, Bm, Cm,
                                                         chunk=Q), 0.2)
            bms, bby = ssd_bound(*shape, dtype)
            cbms, cbby = carry_bound(*shape, dtype)
            rows[(shape, dtype)] = dict(
                kernels=names, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=bby, carry_ms=carry, carry_plain_ms=carry_plain,
                carry_bound_ms=cbms, carry_bound_by=cbby, scan_ms=scan,
                scan_plain_ms=scan_plain)
            log(f"[ssd] [B,L,H,P,N,Q]={list(shape)} {tag}: chunk {ms:.5f} "
                f"plain {plain:.5f} bound {bms:.6f} ({bby}); carry "
                f"{carry:.5f} plain {carry_plain:.5f} bound {cbms:.6f} "
                f"({cbby}); scan {scan:.5f} vs ssd_ref {scan_plain:.5f}")
            del x, dt, A, Bm, Cm, cum, want, yi, st, h0
            torch.cuda.empty_cache()
    return rows


# The SSD backward (ssd_bwd.cu) against its plain versions, on the same
# inputs with a nonzero initial state and final-state gradient: the
# reference sweep's shapes (chunks of 16 to 128 rows), phase 11's training
# shapes, mamba2-780m's and zamba2-1.2b's at 2 x 4096, and SSD_CHUNKS
# (chunks of 128, 256 and 50 rows), each in bf16 and fp32.  Bar: per
# gradient max|Δ| <= 1e-4·max(max|ref|, 1); a bf16 gradient of the whole
# op (rounded once from fp32, as the plain version's) per element within
# 2^-7·|ref| more, one bf16 step.
SSD_TRAIN = [(2, 4096, 48, 64, 128, 64), (2, 4096, 64, 64, 64, 64)]
SSD_BWD_SHAPES = [(s, dt) for s in SSD_SWEEP + SSD_TRAIN + SSD_CHUNKS
                  for dt in ("bfloat16", "float32")]
# Phase 11 (b)'s fp32 mamba2-780m step (1 x 2048), which launches the
# CUDA-core backward kernels on a main path.
SSD_TRAIN_F32 = ((1, 2048, 48, 64, 128, 64), "float32")
SSD_BWD_SHAPES.append(SSD_TRAIN_F32)
SSD_BWD_BAR = 1e-4
SSD_BWD_BF16_REL = 2.0 ** -7


def ssd_bwd_bounds(B, L, H, P, N, Q, dtype, ops_per_s=None):
    """(least ms, what bounds it) of each backward kernel and the whole
    backward: flops at ``ops_per_s`` (default the inputs' dtype's peak, as
    ``ssd_bound``; the fp32 tensor-core kernels, ``ssd_chunk_bwd_tf32``,
    ``ssd_carry_bwd_tf32`` and ``ssd_chunk_bwd_tf32_tiled``, are priced at
    TF32_X3_OPS_PER_S) against bytes.  Carry: 2·N·P flops per (row, head)
    for Cᵀ·dy and 2 per state element and chunk for each walk; the chunk
    states read, h_prev and g written (fp32), C, dy, cum, init, dfinal and
    d init_state once.
    Chunk: per (b, chunk, head) 2Q²P (dW and dx over the lower triangle)
    + 6QNP (dx's state term, g·x, dy·h_prev), per (b, chunk) 3Q²N (C·Bᵀ
    and the dC, dB products); x, dy, dt, cum, B, C, g and h_prev read,
    dx, dcum, ddt, dB and dC written once (a kernel's partial sums of dB
    and dC per group of heads are its own traffic).  Whole: the
    chunk states (2QNP per (b, chunk, head); the gradient needs no
    y_intra) and both kernels' flops; its inputs read and gradients
    written once."""
    nc = L // Q
    e = esize(dtype)
    stack = B * nc * H * N * P * 4
    state = B * H * N * P * 4
    carry_f = 2 * B * L * H * N * P + 4 * B * nc * H * N * P
    chunk_f = B * nc * (H * (2 * Q * Q * P + 6 * Q * N * P) + 3 * Q * Q * N)
    state_f = B * H * nc * 2 * Q * N * P
    carry_b = (3 * stack + B * L * N * e + B * L * H * P * e + B * L * H * 4
               + 3 * state)
    chunk_b = (2 * B * L * H * P * e + 2 * B * L * H * 4 + 2 * B * L * N * e
               + 2 * stack + B * L * H * P * 4 + 2 * B * L * H * 4
               + 2 * B * L * N * 4)
    whole_b = (3 * B * L * H * P * e + 2 * B * L * H * 4 + 4 * B * L * N * e
               + 3 * state + 2 * H * 4)
    return {"carry": bound(carry_f, carry_b, dtype, ops_per_s),
            "chunk": bound(chunk_f, chunk_b, dtype, ops_per_s),
            "backward": bound(state_f + carry_f + chunk_f, whole_b, dtype,
                              ops_per_s)}


def ssd_bwd_mma_floors(B, L, H, P, N, Q, groups, terms):
    """The bf16 tensor-core kernels' own MMA work at the bf16 peak (ms),
    as issued: ssd_chunk_bwd_tc per (b, chunk, head) dW = dy·xᵀ once and
    dx's intra term ``terms`` times over the 10 of 16 k16 × m16 blocks at
    or below the diagonal (2Q²P·10/16 each), B·g, x·gᵀ and dy·h_prevᵀ
    ``terms`` times (2QNP each); per (b, chunk, group) C·Bᵀ once and the
    dC, dB products ``terms`` times over the same blocks (2Q²N·10/16
    each).  ssd_carry_bwd_tc: (exp(cum)∘C)ᵀ·dy ``terms`` times, 2QNP per
    (b, chunk, head)."""
    nc, tri = L // Q, 10 / 16
    chunk = B * nc * (H * (2 * Q * Q * P * tri * (1 + terms)
                           + 3 * 2 * Q * N * P * terms)
                      + groups * 2 * Q * Q * N * tri * (1 + 2 * terms))
    carry = B * nc * H * 2 * Q * N * P * terms
    return {"chunk": chunk / BF16_OPS_PER_S * 1e3,
            "carry": carry / BF16_OPS_PER_S * 1e3}


def check_ssd_tc_builds(sk) -> dict:
    """The SSD backward's tensor-core kernels: the chunk kernels per N (16
    heads a block), the carries (slices of 32 rows of N) per slab count S
    of their chunks, Q = 64 S up to 256 (shared memory at 2 x 4096 rows,
    8192 // Q chunks)."""
    lib = sk.LIB_BWD.load()
    slabs = [q // 64 for q in (64,) + sk.TILED_Q]

    def chunks(S):
        return 2 * 4096 // (64 * S)
    note = " (the template value: 64-row slabs a chunk)"
    return check_builds(sk.LIB_BWD, "ssd-bwd", {
        "ssd_chunk_bwd_tc": ([64, 128],
                             lambda n: lib.ssd_bwd_tc_smem_bytes(0, n, 16),
                             ""),
        "ssd_chunk_bwd_tf32": (
            [64, 128], lambda n: lib.ssd_chunk_bwd_tf32_smem_bytes(n, 16),
            ""),
        "ssd_carry_bwd_tc": (
            slabs, lambda S: lib.ssd_bwd_tc_smem_bytes(1, 128, chunks(S)),
            note),
        "ssd_carry_bwd_tf32": (
            slabs, lambda S: lib.ssd_carry_bwd_tf32_smem_bytes(chunks(S)),
            note)})


def hold_grads(torch, what, names, got, again, want) -> dict:
    """Each gradient against the plain version's (the bars above) and a
    second pass bit for bit; returns (worst ratio to the bar, max|Δ|) per
    name."""
    out = {}
    for name, g, a, w in zip(names, got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"{what} {name}: two passes differ (the "
                                 f"kernels use no atomics)")
        gf, wf = g.float(), w.float()
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what} {name}: {g.dtype} "
                                 f"{list(g.shape)}, plain {w.dtype} "
                                 f"{list(w.shape)}")
        err = (gf - wf).abs()
        scale = SSD_BWD_BAR * max(float(wf.abs().max()), 1.0)
        if g.dtype == torch.bfloat16:
            ratio = float((err / (SSD_BWD_BF16_REL * wf.abs() + scale))
                          .max())
        else:
            ratio = float(err.max()) / scale
        if not ratio <= 1.0:
            raise AssertionError(f"{what} {name}: worst |Δ| is {ratio} "
                                 f"times its bar")
        out[name] = (ratio, float(err.max()))
    return out


def carry_bwd_call(torch, sk, cargs, tc):
    """A call of the carry backward's C entry point on ``cargs`` (the
    wrapper's) into outputs made beforehand: ``tc`` 1 the tensor-core
    kernel for the inputs' dtype, 0 ``ssd_carry_bwd``."""
    states, cum, Cm, dy, Q, h0, df = cargs
    B, nc, H, N, P = states.shape
    outs = [torch.empty_like(states), torch.empty_like(states),
            torch.empty((B, H, N, P), device="cuda")]
    lib = sk.LIB_BWD.load()
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: lib.ssd_carry_bwd_launch(
        *(t.data_ptr() for t in (states, cum, Cm, dy, h0, df, *outs)),
        sk.DTYPES[Cm.dtype], B, nc * Q, H, P, N, Q, tc, stream)


def chunk_bwd_call(torch, sk, args, G, tc):
    """A call of the chunk backward's C entry point on ``args`` (the
    wrapper's) into outputs made beforehand: ``tc`` 1 the tensor-core
    kernel for the inputs' dtype, 0 ``ssd_chunk_bwd``."""
    x, dt, cum, Bm, Cm, dy, g, h_prev, Q = args
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    outs = [torch.empty(s, device="cuda") for s in (
        (B, L, H, P), (B, L, H), (B, L, H), (H // G, B, L, N),
        (H // G, B, L, N))]
    lib = sk.LIB_BWD.load()
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: lib.ssd_chunk_bwd_launch(
        *(t.data_ptr() for t in (x, dt, cum, Bm, Cm, dy, g, h_prev, *outs)),
        sk.DTYPES[x.dtype], B, L, H, P, N, Q, G, tc, stream)


def phase_ssd_bwd(torch) -> dict:
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import (chunk_cumsum, ssd_bwd_ref,
                                             ssd_carry_bwd_ref,
                                             ssd_chunk_bwd_ref)
    builds = check_ssd_tc_builds(sk)
    log("[ssd-bwd] per call, ms (CUDA events, median after a warm-up): "
        "carry = the carry backward (h_prev and g, two walks), chunk = the "
        "chunk backward (each chunk's gradients), each the kernel the "
        "wrappers dispatch to (kernel.bwd_kernels: bf16 at Q = P = 64, N "
        f"in {{64, 128}} on the tensor cores, ssd_carry_bwd_tc and "
        f"ssd_chunk_bwd_tc with fp32 operands in {sk.BWD_TERMS} bf16 terms; "
        "fp32 there ssd_carry_bwd_tf32 and ssd_chunk_bwd_tf32 (TF32, three "
        "products a product, priced at the 3×TF32 rate); every other shape "
        "on the CUDA cores, ssd_carry_bwd and "
        "ssd_chunk_bwd); backward = the op's whole backward (ops.ssd_bwd: "
        "the chunk-state launch, both kernels, the groups' sum and the "
        "cumsum's gradient); plain = ssd_carry_bwd_ref, ssd_chunk_bwd_ref, "
        "ssd_bwd_ref on the card; bound = the least time for each one's "
        "work (flops at the inputs' dtype's peak, or bytes) and what "
        "bounds it; MMA floor = a tensor-core kernel's own MMA work at the "
        "bf16 peak; at the bf16 training shapes also the CUDA-core kernels "
        "on the same inputs (cuda_cores=True); no single PyTorch call "
        "computes any of them (library: none)")
    rows, worst = {}, {}
    errs = dict.fromkeys(sk.BWD_KERNELS, 0.0)
    carry_names = ("h_prev", "g", "d init_state")
    chunk_names = ("dx", "dcum", "ddt", "dB", "dC")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (shape, dtype) in enumerate(SSD_BWD_SHAPES):
        B, L, H, P, N, Q = shape
        tdt = getattr(torch, dtype)
        names = dict(zip(("carry", "chunk"), sk.bwd_kernels(tdt, Q, P, N)))
        tc = names["chunk"].endswith("_tc")
        x, dt, A, Bm, Cm = ssd_inputs(torch, shape, 500 + i)
        gen = torch.Generator(device="cuda").manual_seed(600 + i)
        dy, h0, df = (torch.randn(s, generator=gen, device="cuda")
                      for s in ((B, L, H, P), (B, H, N, P), (B, H, N, P)))
        x, Bm, Cm, dy = (t.to(tdt) for t in (x, Bm, Cm, dy))
        cum = chunk_cumsum(dt, A, Q)
        _, states = sk.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
        cargs = (states, cum, Cm, dy, Q, h0, df)
        want_carry = ssd_carry_bwd_ref(*cargs)
        held = {"carry": hold_grads(
            torch, f"{names['carry']} {shape} {dtype}", carry_names,
            sk.ssd_carry_bwd_cuda(*cargs), sk.ssd_carry_bwd_cuda(*cargs),
            want_carry)}
        h_prev, g, _ = want_carry
        G = sk.chunk_bwd_heads(names["chunk"], B * L // Q, H, sms, Q)
        args = (x, dt, cum, Bm, Cm, dy, g, h_prev, Q)
        want_chunk = ssd_chunk_bwd_ref(*args, G)
        held["chunk"] = hold_grads(
            torch, f"{names['chunk']} {shape} {dtype}", chunk_names,
            sk.ssd_chunk_bwd_cuda(*args), sk.ssd_chunk_bwd_cuda(*args),
            want_chunk)
        whole = (x, dt, A, Bm, Cm, dy, Q, h0, df)
        held["backward"] = hold_grads(
            torch, f"SSD backward {shape} {dtype}",
            ("dx", "ddt", "dA", "dB", "dC", "d init_state"),
            ops.ssd_bwd(*whole), ops.ssd_bwd(*whole), ssd_bwd_ref(*whole))
        torch.cuda.synchronize()
        for k in ("carry", "chunk"):
            errs[names[k]] = max(errs[names[k]],
                                 *(e for _, e in held[k].values()))
        for k, v in held.items():
            worst[k] = max(worst.get(k, 0.0), *(r for r, _ in v.values()))
        ms = {"carry": timed_ms(torch, lambda: sk.ssd_carry_bwd_cuda(
                  *cargs)),
              "chunk": timed_ms(torch, lambda: sk.ssd_chunk_bwd_cuda(*args)),
              "backward": timed_ms(torch, lambda: ops.ssd_bwd(*whole))}
        plain = {"carry": timed_ms(torch, lambda: ssd_carry_bwd_ref(
                     *cargs), 0.2),
                 "chunk": timed_ms(torch, lambda: ssd_chunk_bwd_ref(
                     *args, G), 0.2),
                 "backward": timed_ms(torch, lambda: ssd_bwd_ref(*whole),
                                      0.2)}
        bounds = ssd_bwd_bounds(B, L, H, P, N, Q, dtype)
        tf32 = names["chunk"].endswith("_tf32")
        if tf32:
            core_bound = {k: bounds[k] for k in ("carry", "chunk")}
            bounds = ssd_bwd_bounds(B, L, H, P, N, Q, dtype,
                                    TF32_X3_OPS_PER_S)
        row = dict(ms=ms, plain_ms=plain, bounds=bounds, held=held,
                   heads_per_block=G, names=names)
        extra = ""
        if tc:
            row["mma"] = ssd_bwd_mma_floors(B, L, H, P, N, Q, H // G,
                                            sk.BWD_TERMS)
            extra = "; MMA floor " + ", ".join(
                f"{k} {v:.6f}" for k, v in row["mma"].items())
        if tc and shape in SSD_TRAIN:
            # The CUDA-core kernels on the same bf16 inputs, held and
            # timed.
            core = {
                "carry": hold_grads(
                    torch, f"ssd_carry_bwd {shape} {dtype}", carry_names,
                    sk.ssd_carry_bwd_cuda(*cargs, cuda_cores=True),
                    sk.ssd_carry_bwd_cuda(*cargs, cuda_cores=True),
                    want_carry),
                "chunk": hold_grads(
                    torch, f"ssd_chunk_bwd {shape} {dtype}", chunk_names,
                    sk.ssd_chunk_bwd_cuda(*args, cuda_cores=True),
                    sk.ssd_chunk_bwd_cuda(*args, cuda_cores=True),
                    want_chunk)}
            for k, name in (("carry", "ssd_carry_bwd"),
                            ("chunk", "ssd_chunk_bwd")):
                errs[name] = max(errs[name],
                                 *(e for _, e in core[k].values()))
            row["core_ms"] = {
                "carry": timed_ms(torch, lambda: sk.ssd_carry_bwd_cuda(
                    *cargs, cuda_cores=True)),
                "chunk": timed_ms(torch, lambda: sk.ssd_chunk_bwd_cuda(
                    *args, cuda_cores=True))}
            extra += (f"; on the CUDA cores: ssd_carry_bwd "
                      f"{row['core_ms']['carry']:.5f}, ssd_chunk_bwd "
                      f"{row['core_ms']['chunk']:.5f}")
        if tf32 and L * H >= 4096:
            # The CUDA-core kernels on the same fp32 inputs (ssd_chunk_bwd
            # with the heads a block it takes), held; each pair through
            # its C entry point in turns (new, CUDA cores, CUDA cores,
            # new).
            Gc = sk.bwd_heads_per_block(B * L // Q, H, sms)
            core = {
                "carry": hold_grads(
                    torch, f"ssd_carry_bwd {shape} {dtype}", carry_names,
                    sk.ssd_carry_bwd_cuda(*cargs, cuda_cores=True),
                    sk.ssd_carry_bwd_cuda(*cargs, cuda_cores=True),
                    want_carry),
                "chunk": hold_grads(
                    torch, f"ssd_chunk_bwd {shape} {dtype}", chunk_names,
                    sk.ssd_chunk_bwd_cuda(*args, cuda_cores=True),
                    sk.ssd_chunk_bwd_cuda(*args, cuda_cores=True),
                    ssd_chunk_bwd_ref(*args, Gc))}
            for k, name in (("carry", "ssd_carry_bwd"),
                            ("chunk", "ssd_chunk_bwd")):
                errs[name] = max(errs[name],
                                 *(e for _, e in core[k].values()))
            calls = {"carry": (carry_bwd_call(torch, sk, cargs, 1),
                               carry_bwd_call(torch, sk, cargs, 0)),
                     "chunk": (chunk_bwd_call(torch, sk, args, G, 1),
                               chunk_bwd_call(torch, sk, args, Gc, 0))}
            t = {k: (burst_ms(torch, new), burst_ms(torch, old),
                     burst_ms(torch, old), burst_ms(torch, new))
                 for k, (new, old) in calls.items()}
            row.update(
                core_ms={
                    "carry": timed_ms(torch, lambda: sk.ssd_carry_bwd_cuda(
                        *cargs, cuda_cores=True)),
                    "chunk": timed_ms(torch, lambda: sk.ssd_chunk_bwd_cuda(
                        *args, cuda_cores=True))},
                core_bound=core_bound, turns=t,
                entry_ms={k: (v[0] + v[3]) / 2 for k, v in t.items()},
                core_entry_ms={k: (v[1] + v[2]) / 2 for k, v in t.items()})
            for k in ("carry", "chunk"):
                v = t[k]
                extra += (f"; {names[k]} / ssd_{k}_bwd through "
                          f"ssd_{k}_bwd_launch in turns (new, CUDA cores, "
                          f"CUDA cores, new), ms a launch "
                          + ", ".join(f"{u:.5f}" for u in v)
                          + f" (new / CUDA cores "
                          f"{(v[0] + v[3]) / (v[1] + v[2]):.4f}); "
                          f"ssd_{k}_bwd wrapper {row['core_ms'][k]:.5f}, "
                          f"bound {core_bound[k][0]:.6f} "
                          f"({core_bound[k][1]}, CUDA cores)")
        rows[(shape, dtype)] = row
        log(f"[ssd-bwd] [B,L,H,P,N,Q]={list(shape)} {dtype} ({G} heads "
            f"per block): "
            + "; ".join(f"{names.get(k, k)} {ms[k]:.5f} plain "
                        f"{plain[k]:.5f} bound {bounds[k][0]:.6f} "
                        f"({bounds[k][1]})"
                        for k in ("carry", "chunk", "backward"))
            + extra + "; worst |Δ|/bar " + ", ".join(
                f"{k} {max(r for r, _ in v.values()):.4g}"
                for k, v in held.items())
            + " <= 1, two passes equal")
        del x, dt, A, Bm, Cm, dy, h0, df, cum, states, h_prev, g, args
        del whole, cargs, want_carry, want_chunk
        torch.cuda.empty_cache()
    log("[ssd-bwd] worst |Δ|/bar over every shape: " + ", ".join(
        f"{k} {v:.4g}" for k, v in worst.items()))
    return dict(rows=rows, worst=worst, errs=errs, builds=builds)


# The chunks the tiled tensor-core kernels take: mamba2-780m's heads (48
# of P 64, N 128) at 2 x 4096 tokens in chunks of 128 and 256, and
# zamba2-1.2b's (64 of P 64, N 64) in chunks of 256 rows; bf16 and fp32.
SSD_TILED = SSD_CHUNKS[:2] + [(2, 4096, 64, 64, 64, 256)]
# By dtype: the terms that ask for the tiled forward kernel, and
# kernel.py's mirrors of the tiled kernels' shared memory (forward,
# backward), each reported by the library under its name with ``ssd_``
# before it.
TILED_KERNELS = {
    "bfloat16": ("TERMS", "chunk_tiled_smem_bytes",
                 "chunk_bwd_tiled_smem_bytes"),
    "float32": ("TF32_TERMS", "chunk_tf32_tiled_smem_bytes",
                "chunk_bwd_tf32_tiled_smem_bytes")}


def ssd_tiled_rows(torch, dtype: str) -> dict:
    """Phase 6's chunks of 128 to 256 rows at SSD_TILED in ``dtype``: the
    main path first, ``ops.ssd`` under grad with every SSD count set to 0
    just before it and read just after (the launches ``ssd_step_counts``
    names: the tiled forward kernel twice, the dtype's tensor-core carry
    backward and the tiled chunk backward once each),
    y and the final state against ``ssd_ref`` and each gradient against
    autograd of ``ssd_ref`` on the same values in fp32
    (SSD_BWD_BAR·max(max|ref|, 1), plus one bf16 step for a bf16 y or
    gradient); then the tiled forward kernel (``kernel.fwd_kernels``) and the
    CUDA-core ``ssd_chunk_kernel`` (``terms=0``) against ``ssd_chunks_ref``
    (SSD_REL·max|ref|) and the tiled chunk backward and the CUDA-core
    ``ssd_chunk_bwd`` (``cuda_cores=True``) against ``ssd_chunk_bwd_ref``
    with each one's heads a group, and the tensor-core carry backward
    (``ssd_carry_bwd_tc`` or ``ssd_carry_bwd_tf32``, 64-row slabs) and
    the CUDA-core ``ssd_carry_bwd`` against ``ssd_carry_bwd_ref``
    (hold_grads), the new kernels' second passes bitwise; each pair timed
    through its C entry points in turns (new, CUDA cores, CUDA cores,
    new), the new ones also through their wrappers, the plain versions
    once, each beside its bound (fp32's tensor-core products at
    TF32_X3_OPS_PER_S; the CUDA cores' bound beside it).  In fp32 also
    the carry at these chunks, ``ssd_carry_tf32`` and ``ssd_carry_kernel``
    through their C entry points in turns.  Also the libraries' shared
    memory at every tiled chunk equal to kernel.py's mirrors, and both
    kernels' builds (no spill; the carry backward's are
    ``check_ssd_tc_builds``')."""
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import (chunk_cumsum, ssd_carry_bwd_ref,
                                             ssd_carry_ref,
                                             ssd_chunk_bwd_ref,
                                             ssd_chunks_ref, ssd_ref)
    terms_name, fmirror, bmirror = TILED_KERNELS[dtype]
    fsmem, bsmem = "ssd_" + fmirror, "ssd_" + bmirror
    dt_ = getattr(torch, dtype)
    fname = sk.fwd_kernels(dt_, 256, 64, 128)[0]
    bwd_carry, bname = sk.bwd_kernels(dt_, 256, 64, 128)
    if not (fname.endswith("_tiled") and bname.endswith("_tiled")
            and bwd_carry != "ssd_carry_bwd"):
        raise AssertionError(f"{dtype} at chunks of 256 rows: the wrappers "
                             f"name {fname}, {bwd_carry} and {bname}")
    lib, lib_bwd = sk.LIB.load(), sk.LIB_BWD.load()
    for N in (64, 128):
        for Q in sk.TILED_Q:
            for got, want, what in (
                    (getattr(lib, fsmem)(N, Q), getattr(sk, fmirror)(N, Q),
                     fname),
                    (getattr(lib_bwd, bsmem)(N, Q),
                     getattr(sk, bmirror)(N, Q), bname)):
                if got != want or not 0 < got <= sk.MAX_SMEM_BYTES:
                    raise AssertionError(f"{what} at N {N}, Q {Q}: the "
                                         f"library reports {got} bytes, "
                                         f"kernel.py {want}")
    builds = check_builds(sk.LIB, "ssd", {fname: (
        [64, 128], lambda n: getattr(lib, fsmem)(n, 256), " (at Q = 256)")})
    builds.update(check_builds(sk.LIB_BWD, "ssd-bwd", {bname: (
        [64, 128], lambda n: getattr(lib_bwd, bsmem)(n, 256),
        " (at Q = 256)")}))
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32 = dt_ == torch.float32
    code = sk.DTYPES[dt_]
    new_terms = getattr(sk, terms_name)
    ops_rate = TF32_X3_OPS_PER_S if f32 else None
    rows, launches = {}, {fname: 0, bwd_carry: 0, bname: 0}
    worst = dict.fromkeys((fname, bwd_carry, bname, "ssd_chunk_kernel",
                           "ssd_carry_bwd", "ssd_chunk_bwd", "ssd"), 0.0)

    for i, shape in enumerate(SSD_TILED):
        B, L, H, P, N, Q = shape
        x, dt, A, Bm, Cm = ssd_inputs(torch, shape, 800 + i)
        gen = torch.Generator(device="cuda").manual_seed(810 + i)
        dy, h0, df = (torch.randn(s, generator=gen, device="cuda")
                      for s in ((B, L, H, P), (B, H, N, P), (B, H, N, P)))
        x, Bm, Cm, dy = (t.to(dt_) for t in (x, Bm, Cm, dy))
        if sk.fwd_kernels(dt_, Q, P, N)[0] != fname or \
                sk.bwd_kernels(dt_, Q, P, N) != (bwd_carry, bname):
            raise AssertionError(f"{shape} {dtype}: the wrappers do not name "
                                 f"the tiled kernels")
        # The main path: ssd() under grad, forward and backward.
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, dt, A, Bm, Cm, h0)]
        reset_ssd_counts()
        y, final = ops.ssd(*leaves[:5], chunk=Q, init_state=leaves[5])
        got = torch.autograd.grad((y, final), leaves, (dy, df))
        torch.cuda.synchronize()
        counts = ssd_counts()
        want_counts = ssd_step_counts(dt_, Q, P, N, 1)
        if counts != want_counts:
            raise AssertionError(f"ssd {shape} {dtype} under grad launched "
                                 f"{counts}, expected {want_counts}")
        for name in launches:
            launches[name] += counts[name]
        plain = [t.float().clone().requires_grad_(True)
                 for t in (x, dt, A, Bm, Cm, h0)]
        wy, wf = ssd_ref(*plain[:5], chunk=Q, init_state=plain[5])
        want = torch.autograd.grad((wy, wf), plain, (dy.float(), df))
        y, final, wy, wf = (t.detach() for t in (y, final, wy, wf))
        step = float(((y.float() - wy).abs()
                      / ((0.0 if f32 else 2.0 ** -8) * wy.abs()
                         + SSD_REL * max(float(wy.abs().max()), 1.0))).max())
        if not step <= 1.0:
            raise AssertionError(f"ssd {shape} {dtype} y: {step} times its "
                                 f"bound")
        ratios = {"y": step, "final state": max_err(torch, final, wf)
                  / (SSD_REL * max(float(wf.abs().max()), 1.0))}
        for name, t, g, w in zip(("dx", "ddt", "dA", "dB", "dC",
                                  "d init_state"), leaves, got, want):
            scale = SSD_BWD_BAR * max(float(w.abs().max()), 1.0)
            bar = scale + (SSD_BWD_BF16_REL * w.abs()
                           if t.dtype == torch.bfloat16 else 0.0)
            ratios[name] = float(((g.float() - w).abs() / bar).max())
        if not max(ratios.values()) <= 1.0:
            raise AssertionError(f"ssd {shape} {dtype} under grad: worst "
                                 f"|Δ|/bar {ratios}")
        worst["ssd"] = max(worst["ssd"], *ratios.values())
        del leaves, y, final, got, plain, wy, wf, want
        torch.cuda.empty_cache()

        # The forward kernels against the plain chunk pass.
        cum = chunk_cumsum(dt, A, Q)
        want = tuple(t.contiguous()
                     for t in ssd_chunks_ref(x, dt, cum, Bm, Cm, Q))
        got = sk.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
        again = sk.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
        core = sk.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q, terms=0)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{fname} {shape}: two passes differ")
        for name, out in ((fname, got), ("ssd_chunk_kernel", core)):
            for what, o, w in zip(("y_intra", "chunk states"), out, want):
                err, scale = max_err(torch, o, w), float(w.abs().max())
                if not err <= SSD_REL * scale:
                    raise AssertionError(f"{name} {shape} {what}: max|Δ| "
                                         f"{err} > {SSD_REL} * {scale}")
                ratios[f"{name} {what}"] = err / (SSD_REL * scale)
                worst[name] = max(worst[name], err)
        del again, core
        states = want[1]
        yo, so = got

        # The carry backward kernels against their plain version.
        cargs = (states, cum, Cm, dy, Q, h0, df)
        want_carry = ssd_carry_bwd_ref(*cargs)
        for name, core_ in ((bwd_carry, False), ("ssd_carry_bwd", True)):
            held = hold_grads(
                torch, f"{name} {shape}", ("h_prev", "g", "d init_state"),
                sk.ssd_carry_bwd_cuda(*cargs, cuda_cores=core_),
                sk.ssd_carry_bwd_cuda(*cargs, cuda_cores=core_), want_carry)
            worst[name] = max(worst[name], *(e for _, e in held.values()))
            ratios.update({f"{name} {k}": r for k, (r, _) in held.items()})

        # The chunk backward kernels against their plain version.
        h_prev, g, _ = want_carry
        args = (x, dt, cum, Bm, Cm, dy, g, h_prev, Q)
        G = sk.chunk_bwd_heads(bname, B * L // Q, H, sms, Q)
        Gc = sk.chunk_bwd_heads("ssd_chunk_bwd", B * L // Q, H, sms, Q)
        names = ("dx", "dcum", "ddt", "dB", "dC")
        for name, out, again, groups in (
                (bname, sk.ssd_chunk_bwd_cuda(*args),
                 sk.ssd_chunk_bwd_cuda(*args), G),
                ("ssd_chunk_bwd", sk.ssd_chunk_bwd_cuda(*args,
                                                        cuda_cores=True),
                 sk.ssd_chunk_bwd_cuda(*args, cuda_cores=True), Gc)):
            held = hold_grads(torch, f"{name} {shape}", names, out, again,
                              ssd_chunk_bwd_ref(*args, groups))
            worst[name] = max(worst[name], *(e for _, e in held.values()))
            ratios.update({f"{name} {k}": r for k, (r, _) in held.items()})
            del out, again
        torch.cuda.synchronize()

        # Each pair through its C entry points in turns.
        def chunk_call(terms):
            return lambda: lib.ssd_chunk_launch(
                x.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), yo.data_ptr(), so.data_ptr(), code, B, L, H,
                P, N, Q, terms, stream)
        tails = torch.empty((B, L // Q, Q // 64, H), device="cuda")
        outs = [torch.empty(s, device="cuda") for s in (
            (B, L, H, P), (B, L, H), (B, L, H), (H // G, B, L, N),
            (H // G, B, L, N))]
        tiled_bwd = lambda: lib_bwd.ssd_chunk_bwd_tiled_launch(  # noqa: E731
            *(t.data_ptr() for t in (x, dt, cum, Bm, Cm, dy, g, h_prev,
                                     *outs, tails)),
            code, B, L, H, P, N, Q, G, stream)
        t_fwd = turns(torch, chunk_call(new_terms), chunk_call(0))
        t_bwd = turns(torch, tiled_bwd,
                      chunk_bwd_call(torch, sk, args, Gc, 0))
        t_cbwd = turns(torch, carry_bwd_call(torch, sk, cargs, 1),
                       carry_bwd_call(torch, sk, cargs, 0))
        fwd_wrapper = timed_ms(torch, lambda: sk.ssd_chunks_cuda(
            x, dt, cum, Bm, Cm, Q))
        bwd_wrapper = timed_ms(torch, lambda: sk.ssd_chunk_bwd_cuda(*args))
        cbwd_wrapper = timed_ms(torch, lambda: sk.ssd_carry_bwd_cuda(*cargs))
        fwd_plain = timed_ms(torch, lambda: ssd_chunks_ref(x, dt, cum, Bm, Cm,
                                                           Q), 0.2)
        bwd_plain = timed_ms(torch, lambda: ssd_chunk_bwd_ref(*args, G), 0.2)
        cbwd_plain = timed_ms(torch, lambda: ssd_carry_bwd_ref(*cargs), 0.2)
        fbms, fbby = ssd_bound(*shape, dtype, ops_rate)
        cfbms, cfbby = ssd_bound(*shape, dtype)
        bounds = ssd_bwd_bounds(*shape, dtype, ops_rate)
        core_bounds = ssd_bwd_bounds(*shape, dtype)
        bbms, bbby = bounds["chunk"]
        cbbms, cbbby = core_bounds["chunk"]
        cbms, cbby = bounds["carry"]
        ccbms, ccbby = core_bounds["carry"]
        rows[shape] = dict(
            counts={k: counts[k] for k in launches},
            fwd=dict(entry_ms=(t_fwd[0] + t_fwd[3]) / 2,
                     core_entry_ms=(t_fwd[1] + t_fwd[2]) / 2,
                     turns=list(t_fwd), ms=fwd_wrapper, plain_ms=fwd_plain,
                     bound_ms=fbms, bound_by=fbby, core_bound_ms=cfbms,
                     core_bound_by=cfbby),
            bwd=dict(entry_ms=(t_bwd[0] + t_bwd[3]) / 2,
                     core_entry_ms=(t_bwd[1] + t_bwd[2]) / 2,
                     turns=list(t_bwd), ms=bwd_wrapper, plain_ms=bwd_plain,
                     bound_ms=bbms, bound_by=bbby, core_bound_ms=cbbms,
                     core_bound_by=cbbby, heads_per_block=G,
                     core_heads_per_block=Gc),
            carry_bwd=dict(entry_ms=(t_cbwd[0] + t_cbwd[3]) / 2,
                           core_entry_ms=(t_cbwd[1] + t_cbwd[2]) / 2,
                           turns=list(t_cbwd), ms=cbwd_wrapper,
                           plain_ms=cbwd_plain, bound_ms=cbms,
                           bound_by=cbby, core_bound_ms=ccbms,
                           core_bound_by=ccbby),
            ratios=ratios)
        r = rows[shape]
        carry = ""
        if f32:
            # The fp32 carry at these chunks: ssd_carry_tf32 against
            # ssd_carry_kernel on the plain chunk outputs.
            cy = torch.empty((B, L, H, P), device="cuda")
            cf = torch.empty((B, H, N, P), device="cuda")
            yi = want[0]
            wy, wf = ssd_carry_ref(yi, states, cum, Cm, Q, h0)
            for cname, core_ in (("ssd_carry_tf32", False),
                                 ("ssd_carry_kernel", True)):
                gy, gf = sk.ssd_carry_cuda(yi, states, cum, Cm, Q, h0,
                                           cuda_cores=core_)
                for what, o, w in (("y", gy, wy), ("final state", gf, wf)):
                    err = max_err(torch, o, w)
                    scale = SSD_REL * max(float(w.abs().max()), 1.0)
                    if not err <= scale:
                        raise AssertionError(f"{cname} {shape} {what}: "
                                             f"max|Δ| {err} > {scale}")
                    ratios[f"{cname} {what}"] = err / scale
            del gy, gf, wy, wf

            def carry_call(entry):
                return lambda: entry(
                    yi.data_ptr(), states.data_ptr(), cum.data_ptr(),
                    Cm.data_ptr(), None, cy.data_ptr(), cf.data_ptr(), code,
                    code, B, L, H, P, N, Q, stream)
            t_carry = turns(torch, carry_call(lib.ssd_carry_launch),
                            carry_call(lib.ssd_carry_core_launch))
            kbms, kbby = carry_bound(*shape, dtype, TF32_X3_OPS_PER_S)
            plan = sk.carry_plan(dt_, B, H, P, N, Q, c_dtype=dt_)
            r["carry"] = dict(entry_ms=(t_carry[0] + t_carry[3]) / 2,
                              core_entry_ms=(t_carry[1] + t_carry[2]) / 2,
                              turns=list(t_carry), bound_ms=kbms,
                              bound_by=kbby, plan=plan)
            carry = (f"; ssd_carry_tf32 / ssd_carry_kernel through "
                     f"ssd_carry_launch / ssd_carry_core_launch in turns "
                     + ", ".join(f"{v:.5f}" for v in t_carry)
                     + f", bound {kbms:.6f} ({kbby}), plan {plan}")
            del cy, cf, yi
        log(f"[ssd-tiled] [B,L,H,P,N,Q]={list(shape)} {dtype}: main path "
            f"ssd() under grad launched {r['counts']}; "
            f"{fname} / ssd_chunk_kernel through ssd_chunk_launch "
            f"in turns (new, CUDA cores, CUDA cores, new), ms a launch "
            + ", ".join(f"{v:.5f}" for v in t_fwd)
            + f" (new / CUDA cores "
            f"{(t_fwd[0] + t_fwd[3]) / (t_fwd[1] + t_fwd[2]):.4f}), bound "
            f"{fbms:.6f} ({fbby}), {fbms / r['fwd']['entry_ms']:.3f} of it "
            f"(CUDA cores' {cfbms:.6f}, {cfbby}); "
            f"wrapper {fwd_wrapper:.5f}, plain {fwd_plain:.5f}; "
            f"{bname} ({G} heads a group) / ssd_chunk_bwd "
            f"({Gc}) through their entry points in turns "
            + ", ".join(f"{v:.5f}" for v in t_bwd)
            + f" (new / CUDA cores "
            f"{(t_bwd[0] + t_bwd[3]) / (t_bwd[1] + t_bwd[2]):.4f}), bound "
            f"{bbms:.6f} ({bbby}), {bbms / r['bwd']['entry_ms']:.3f} of it "
            f"(CUDA cores' {cbbms:.6f}, {cbbby}); "
            f"wrapper {bwd_wrapper:.5f}, plain {bwd_plain:.5f}; "
            f"{bwd_carry} / ssd_carry_bwd through ssd_carry_bwd_launch in "
            f"turns "
            + ", ".join(f"{v:.5f}" for v in t_cbwd)
            + f" (new / CUDA cores "
            f"{(t_cbwd[0] + t_cbwd[3]) / (t_cbwd[1] + t_cbwd[2]):.4f}), "
            f"bound {cbms:.6f} ({cbby}), "
            f"{cbms / r['carry_bwd']['entry_ms']:.3f} of it (CUDA cores' "
            f"{ccbms:.6f}, {ccbby}); wrapper {cbwd_wrapper:.5f}, plain "
            f"{cbwd_plain:.5f}{carry}; worst "
            f"|Δ|/bar " + ", ".join(f"{k} {v:.4g}" for k, v in ratios.items())
            + "; the new kernels' second passes bitwise")
        del x, dt, A, Bm, Cm, dy, h0, df, cum, want, got, yo, so, states
        del h_prev, g, args, outs, tails, cargs, want_carry
        torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches, worst=worst, builds=builds)


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
                     span=None, others=None) -> dict:
    """Device time (ms) of one call of ``fn`` by kernel, from a
    ``torch.profiler`` trace: the ported kernels by name, each kernel
    under the first name of ``names`` it contains (``ssd_chunk`` covers
    ``ssd_chunk_tc``, ``ssd_chunk_tf32`` and ``ssd_chunk_kernel``,
    ``ssd_carry`` covers ``ssd_carry_tc``, ``ssd_carry_tf32`` and
    ``ssd_carry_kernel``, ``fa_kernel`` the forward flash-attention
    kernels), every other device kernel as ``other``.
    A ``span`` list gets the profiled call's own wall time (ms, host
    clock, synchronised), so that busy and wall come from one run; an
    ``others`` dict gets the ``other`` kernels' device time (ms) by
    name."""
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
        if name == "other" and others is not None:
            others[ev.key] = others.get(ev.key, 0.0) + us / 1e3
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
# (b) every family: one step at full width, 1 x 2048 (the plain attention
# it is held against materialises [B, H, L, L] per layer), through the
# kernels and again with attention_ref and ssd_ref on the card: (arch,
# layers), the transformer families and mamba2-780m at 2 layers,
# zamba2-1.2b at 6, whose sixth applies the shared attention block
# (models/hybrid.py:61).
TRAIN_FAMILIES = (("llama3-8b", 2), ("qwen2-moe-a2.7b", 2),
                  ("hubert-xlarge", 2), ("internvl2-1b", 2),
                  ("mamba2-780m", 2), ("zamba2-1.2b", 6))
# and two archs with fp32 compute: the steps that take the fp32 backward
# kernels (flash attention's TF32 pair, the SSD's TF32 kernels:
# ssd_chunk_tf32, ssd_carry_tf32, ssd_carry_bwd_tf32, ssd_chunk_bwd_tf32),
# held to the same bars.
TRAIN_FP32 = (("llama3-8b", 2), ("mamba2-780m", 2))
FAMILY_B, FAMILY_L = 1, 2048
# and mamba2-780m on a short batch, 2 x 50 tokens (bf16 compute, 2
# layers): models/ssm.py takes chunk = min(64, L) = 50, a chunk that is
# not a multiple of 4, which the CUDA-core SSD kernels take forward and
# backward (arch, layers, compute, batch, tokens).
TRAIN_SHORT = (("mamba2-780m", 2, "bfloat16", 2, 50),)
# Both runs compute in bf16 and differ only in the attention and the SSD
# (the kernels against the plain versions, each within one bf16 step of
# fp32): the loss
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
# The backward kernels a bf16 training step launches (one each per layer).
FA_BWD_KERNELS = ("fa_bwd_preprocess", "fa_bwd_dkdv_tc", "fa_bwd_dq_tc")
# (d) mamba2-780m at full width and depth: 48 layers, d_model 1536, 48 SSD
# heads (P 64, N 128), 2 x 4096 tokens (train_4k's sequence, its batch of
# 256 cut to 2); its parameters, gradients and AdamW moments take ~12.5 GB,
# so no depth cut.
TRAIN_SSM = ("mamba2-780m", 48, 2, 4096)
# The SSD's launch counters in kernels/ssd/ops.py: the forward's chunk and
# carry launches and backward passes (each launches the chunk kernel once
# for the chunk states).
SSD_COUNTERS = ("LAUNCHES", "CARRY_LAUNCHES", "BWD_LAUNCHES")
# The profiler's names for the SSD kernels, the backward's first (each
# contains a forward kernel's name): a kernel lands under the first it
# contains, so ssd_carry_bwd_tc and ssd_carry_bwd_tf32 under
# ssd_carry_bwd, ssd_carry_tc and ssd_carry_tf32 under ssd_carry.
SSD_PROFILE = ("ssd_chunk_bwd", "ssd_carry_bwd", "ssd_chunk", "ssd_carry")
OTHERS_SHOWN = 10    # (d) lists this many of the other kernels by time


def train_model(arch: str, n_layers: int, device="cuda", smoke=False,
                compute="bfloat16", over=None):
    """``build`` with remat "dots" (bf16 compute unless ``compute`` says
    otherwise, fp32 parameters: the RunConfig's defaults), depth cut to
    ``n_layers`` unless 0, the config's fields in ``over`` replaced."""
    import torch
    from repro_torch.models import RunConfig, build
    run = RunConfig(remat="dots", compute_dtype=getattr(torch, compute))
    model = build(arch, run, smoke=smoke, device=device)
    if n_layers:
        over = dict(over or {}, n_layers=n_layers)
    if over:
        model = dataclasses.replace(model, cfg=model.cfg.with_(**over))
    return model


def bwd_kernel_launches(fa) -> dict:
    """The backward kernels' launch counts, reset to 0."""
    got = dict(fa.BWD_KERNEL_LAUNCHES)
    for name in fa.BWD_KERNEL_LAUNCHES:
        fa.BWD_KERNEL_LAUNCHES[name] = 0
    return got


def ssd_counts() -> dict:
    """The SSD's launch counters (``SSD_COUNTERS``) and each forward and
    backward kernel's."""
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ops as ssd_ops
    return dict({c: getattr(ssd_ops, c) for c in SSD_COUNTERS},
                **sk.FWD_KERNEL_LAUNCHES, **sk.BWD_KERNEL_LAUNCHES)


def reset_ssd_counts() -> None:
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ops as ssd_ops
    for c in SSD_COUNTERS:
        setattr(ssd_ops, c, 0)
    for d in (sk.FWD_KERNEL_LAUNCHES, sk.BWD_KERNEL_LAUNCHES):
        for k in d:
            d[k] = 0


def ssd_step_counts(dtype, Q: int, P: int, N: int, passes: int) -> dict:
    """``ssd_counts()`` after ``passes`` SSD layers trained once each under
    remat dots: one forward (a chunk and a carry launch) and one backward
    pass (the chunk kernel again for the states, then the backward pair
    ``kernel.bwd_kernels`` names) per layer."""
    from repro_torch.kernels.ssd import kernel as sk
    want = dict.fromkeys(SSD_COUNTERS + sk.FWD_KERNELS + sk.BWD_KERNELS, 0)
    if passes:
        chunk, carry = sk.fwd_kernels(dtype, Q, P, N)
        want.update(dict.fromkeys(SSD_COUNTERS, passes))
        want[chunk], want[carry] = 2 * passes, passes
        for k in sk.bwd_kernels(dtype, Q, P, N):
            want[k] = passes
    return want


def timed_steps(torch, tag, arch, n_layers, B, L, describe, reset,
                over=None) -> dict:
    """Build ``arch`` (``train_model``: seeded fp32 weights, bf16
    compute, remat "dots", the config's fields in ``over`` replaced),
    take ``TRAIN_WARMUP`` steps, call ``reset`` (launch counts to 0),
    then ``TRAIN_STEPS`` timed steps (host clock, synchronised) on
    ``data.pipeline.batch_at`` batches of B x L."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = train_model(arch, n_layers, over=over)
    cfg = model.cfg
    params = model.init(0)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    log(f"[train] ({tag}) {arch}: {describe(cfg)}; {model.n_params():,} "
        f"fp32 parameters and AdamW state from a seeded generator in "
        f"{time.perf_counter() - t0:.3f} s "
        f"({torch.cuda.max_memory_allocated() / 2**30:.3f} GiB); bf16 "
        f"compute, remat {model.run.remat}; batches {B} x {L} from "
        f"data.pipeline.batch_at")
    step = make_train_step(model)
    dc = DataConfig(seed=0, seq_len=L, global_batch=B)
    n = TRAIN_WARMUP + TRAIN_STEPS
    batches = [batch_at(dc, s, cfg) for s in range(n + 1)]
    for s in range(TRAIN_WARMUP):
        params, opt, _ = step(params, opt, batches[s])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    times, losses = [], []
    for s in range(TRAIN_WARMUP, n):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batches[s])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"({tag}) non-finite loss {losses}")
    if int(opt["step"]) != n:
        raise AssertionError(f"({tag}) opt step {int(opt['step'])} != {n}")
    return dict(model=model, params=params, opt=opt, step=step,
                next_batch=batches[n], times=times, losses=losses,
                peak=torch.cuda.max_memory_allocated() / 2**30,
                step_s=statistics.median(times))


def profiled_step(torch, tag, run, names, others=None) -> dict:
    """One more step of ``run`` under the profiler: device time by kernel
    (``names``; each must show some), busy time, the step's own wall and
    the idle share between them (``others``: see device_breakdown)."""
    span = []
    by = device_breakdown(torch, lambda: run["step"](
        run["params"], run["opt"], run["next_batch"]), names, span=span,
        others=others)
    for name in names:
        if not by[name] > 0:
            raise AssertionError(f"({tag}) no device time under {name}")
    busy = sum(by.values())
    return dict(by, busy=busy, wall=span[0],
                idle=max(0.0, 1 - busy / span[0]))


def check_train_launches(tag: str, n_layers: int) -> tuple:
    """The FA launches of ``TRAIN_STEPS`` bf16 steps at ``n_layers``
    layers since the counts were reset: one forward (remat dots keeps
    it) and one backward pass per layer per step, each backward pass one
    launch of each of ``FA_BWD_KERNELS``.  Returns ((forward launches,
    backward passes), each backward kernel's launches), the latter
    reset to 0."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    launches = (fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES)
    by_kernel = bwd_kernel_launches(fa)
    want = (n_layers * TRAIN_STEPS, n_layers * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"({tag}) {TRAIN_STEPS} steps launched "
                             f"{launches} (FA forward, FA backward "
                             f"passes), expected {want}: remat dots keeps "
                             f"the forward")
    want_k = {n: (want[1] if n in FA_BWD_KERNELS else 0) for n in by_kernel}
    if by_kernel != want_k:
        raise AssertionError(f"({tag}) backward kernel launches "
                             f"{by_kernel}, expected {want_k}: bf16 goes to "
                             f"the tensor-core kernels")
    return launches, by_kernel


def reset_fa_counts() -> None:
    """Flash attention's launch counts (forward, backward passes, each
    backward kernel) to 0."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    fa_ops.LAUNCHES = 0
    fa_ops.BWD_LAUNCHES = 0
    bwd_kernel_launches(fa)


def phase_train_headline(torch) -> dict:
    arch, n_layers, B, L = TRAIN_HEADLINE
    run = timed_steps(
        torch, "a", arch, n_layers, B, L,
        lambda c: f"{n_layers} of 32 layers, d_model {c.d_model}, heads "
                  f"{c.n_heads}/{c.n_kv_heads}, head dim {c.hd}, d_ff "
                  f"{c.d_ff}, vocab {c.vocab}", reset_fa_counts)
    launches, by_kernel = check_train_launches("a", n_layers)
    step_s, times, losses = run["step_s"], run["times"], run["losses"]
    log(f"[train] (a) {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: "
        f"median {step_s:.4f} s, max {max(times):.4f} s per step (host "
        f"clock, synchronised), {B * L / step_s:.1f} tokens/s; losses "
        f"{[round(x, 4) for x in losses]}; per step {n_layers} FA forward "
        f"launches (remat dots keeps them) and {n_layers} FA backward "
        f"passes ({3 * n_layers} backward kernel launches: "
        + ", ".join(f"{k} {v}" for k, v in by_kernel.items())
        + " over the steps); peak allocated "
        f"{run['peak']:.3f} GiB; opt step {int(run['opt']['step'])}")
    split = profiled_step(torch, "a", run, ("fa_kernel",) + FA_BWD_KERNELS)
    fa_bwd_ms = sum(split[name] for name in FA_BWD_KERNELS)
    split["fa_bwd_share"] = fa_bwd_ms / split["busy"]
    log("[train] (a) one profiled step's device time by kernel, ms: "
        + ", ".join(f"{k} {split[k]:.3f}" for k in
                    ("fa_kernel",) + FA_BWD_KERNELS + ("other",))
        + f"; busy {split['busy']:.3f} of that step's {split['wall']:.3f} "
        f"wall (host clock, synchronised; the unprofiled median "
        f"{step_s * 1e3:.3f}), idle share {split['idle']:.4f}; FA backward "
        f"{fa_bwd_ms:.3f} ms, {split['fa_bwd_share']:.4f} of the step's "
        f"device time")
    peak = run["peak"]
    del run
    torch.cuda.empty_cache()
    return dict(fa_launches=launches[0], bwd_launches=launches[1],
                bwd_kernel_launches=by_kernel, step_s=step_s,
                tokens_per_s=B * L / step_s, peak_gib=peak, split=split,
                losses=losses)


def phase_train_ssm(torch) -> dict:
    arch, n_layers, B, L = TRAIN_SSM

    run = timed_steps(
        torch, "d", arch, n_layers, B, L,
        lambda c: f"{c.n_layers} layers, d_model {c.d_model}, "
                  f"{c.ssm_heads} SSD heads (P {c.ssm_head_dim}, N "
                  f"{c.ssm_state}), vocab {c.vocab}", reset_ssd_counts)
    counts = ssd_counts()
    cfg = run["model"].cfg
    want_d = ssd_step_counts(torch.bfloat16, 64, cfg.ssm_head_dim,
                             cfg.ssm_state, n_layers * TRAIN_STEPS)
    if counts != want_d:
        raise AssertionError(
            f"(d) {TRAIN_STEPS} steps launched {counts}, expected "
            f"{want_d}: remat dots keeps the SSD forward (one chunk and one "
            f"carry launch per layer), and each backward pass launches the "
            f"chunk kernel for the states and each bf16 tensor-core "
            f"backward kernel once")
    step_s, times, losses = run["step_s"], run["times"], run["losses"]
    log(f"[train] (d) {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: "
        f"median {step_s:.4f} s, max {max(times):.4f} s per step (host "
        f"clock, synchronised), {B * L / step_s:.1f} tokens/s; losses "
        f"{[round(x, 4) for x in losses]}; per step {n_layers} SSD "
        f"forward chunk and carry launches (remat dots keeps them) and "
        f"{n_layers} backward passes (the chunk-state launch, "
        f"ssd_carry_bwd_tc and ssd_chunk_bwd_tc each); over the steps "
        + ", ".join(f"{k} {v}" for k, v in counts.items())
        + f"; peak allocated {run['peak']:.3f} GiB; opt step "
        f"{int(run['opt']['step'])}")
    others = {}
    split = profiled_step(torch, "d", run, SSD_PROFILE, others)
    bwd_ms = split["ssd_chunk_bwd"] + split["ssd_carry_bwd"]
    split["ssd_bwd_share"] = bwd_ms / split["busy"]
    log("[train] (d) one profiled step's device time by kernel, ms: "
        + ", ".join(f"{k} {split[k]:.3f}" for k in SSD_PROFILE + ("other",))
        + f" (ssd_chunk: the forward's launches and the backward's "
        f"chunk-state launches); busy {split['busy']:.3f} of that step's "
        f"{split['wall']:.3f} wall (host clock, synchronised; the "
        f"unprofiled median {step_s * 1e3:.3f}), idle share "
        f"{split['idle']:.4f}; the two SSD backward kernels "
        f"(ssd_carry_bwd_tc, ssd_chunk_bwd_tc) {bwd_ms:.3f} ms, "
        f"{split['ssd_bwd_share']:.4f} of the step's device time")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:OTHERS_SHOWN]
    log(f"[train] (d) the {OTHERS_SHOWN} largest of the other kernels, ms: "
        + "; ".join(f"{k[:90]} {v:.3f}" for k, v in top))
    split["top_other"] = dict(top)
    peak = run["peak"]
    del run
    torch.cuda.empty_cache()
    return dict(ssd_launches=counts, step_s=step_s,
                tokens_per_s=B * L / step_s, peak_gib=peak, split=split,
                losses=losses)


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
    attention and the SSD swapped for their plain versions on the card
    (the same test-only swap as check_prefill_vs_plain)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.train.train_step import loss_and_grads
    kernels = fa_ops.flash_attention, ssd_ops.ssd
    if plain:
        fa_ops.flash_attention = \
            lambda q, k, v, causal=True: attention_ref(q, k, v, causal)
        ssd_ops.ssd = ssd_ref
    try:
        return loss_and_grads(model, params, batch)
    finally:
        fa_ops.flash_attention, ssd_ops.ssd = kernels


def grads_vs_plain(torch, tag, params, loss, ref_loss, grads,
                   ref_grads) -> tuple:
    """A step's loss within TRAIN_LOSS_REL of the plain versions' and
    every gradient leaf within TRAIN_GRAD_REL·max|ref| of the leaf.
    Returns (leaf keys, the worst ratio to its bar, its leaf)."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.models.common import tree_leaves
    loss_err = abs(float(loss) - float(ref_loss))
    if not loss_err <= TRAIN_LOSS_REL * abs(float(ref_loss)):
        raise AssertionError(f"{tag}: loss {float(loss)} vs the plain "
                             f"versions' {float(ref_loss)}")
    worst, worst_key = 0.0, None
    keys = [k for k, _ in _flatten(params)]
    for key, g, r in zip(keys, tree_leaves(grads), tree_leaves(ref_grads)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag}: non-finite grad {key}")
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        ratio = err / (TRAIN_GRAD_REL * scale) if scale > 0 else (
            0.0 if err == 0 else math.inf)
        if ratio > worst:
            worst, worst_key = ratio, key
    if not worst <= 1.0:
        raise AssertionError(f"{tag}: grad {worst_key} is {worst} times "
                             f"its bar {TRAIN_GRAD_REL}·max|ref|")
    return keys, worst, worst_key


def family_launches(cfg) -> tuple:
    """(FA applications, SSD layers) in one pass of ``cfg``'s model."""
    from repro_torch.models.hybrid import n_attn_apps
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.family == "hybrid":
        return n_attn_apps(cfg), cfg.n_layers
    return cfg.n_layers, 0


@contextlib.contextmanager
def ssd_on_cuda_cores():
    """The SSD's four kernels sent to their CUDA-core versions inside the
    block (``terms=0`` for the chunk pass, ``cuda_cores=True`` for the
    carry, the carry backward and the chunk backward): what an fp32 step
    launched before the fp32 tensor-core kernels."""
    from repro_torch.kernels.ssd import kernel as sk
    names = ("ssd_chunks_cuda", "ssd_carry_cuda", "ssd_carry_bwd_cuda",
             "ssd_chunk_bwd_cuda")
    saved = {n: getattr(sk, n) for n in names}
    sk.ssd_chunks_cuda = functools.partial(saved[names[0]], terms=0)
    for n in names[1:]:
        setattr(sk, n, functools.partial(saved[n], cuda_cores=True))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(sk, n, fn)


STEP_TURNS = 5   # timed steps of each kind in ssd_step_turns


def ssd_step_turns(torch, model, params, batch, tag) -> dict:
    """One (b) step (loss and gradients) timed in turns on the SSD's
    CUDA-core kernels and on the tensor-core ones: each warmed up once,
    then STEP_TURNS of each, alternating which goes first; host clock,
    synchronised; median ms of each."""
    def step(core):
        with ssd_on_cuda_cores() if core else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            family_grads(torch, model, params, batch, False)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
    times = {True: [], False: []}
    step(True)
    step(False)
    for k in range(STEP_TURNS):
        for core in ((True, False) if k % 2 == 0 else (False, True)):
            times[core].append(step(core))
    out = {"cuda_cores": statistics.median(times[True]),
           "tensor_cores": statistics.median(times[False]),
           "turns": {"cuda_cores": times[True],
                     "tensor_cores": times[False]}}
    log(f"[train] (b) {tag}: one step in turns, median of {STEP_TURNS} "
        f"(host clock, synchronised): on the SSD's CUDA-core kernels "
        f"{out['cuda_cores']:.3f} ms, on the tensor-core ones "
        f"{out['tensor_cores']:.3f} ms ("
        f"{out['tensor_cores'] / out['cuda_cores']:.4f}); each run "
        + ", ".join(f"{v:.3f}" for v in times[False]) + " against "
        + ", ".join(f"{v:.3f}" for v in times[True]))
    return out


def phase_train_families(torch) -> dict:
    import gc
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import kernel as sk
    out = {}
    for arch, n_layers, compute, B, L in (
            [(a, n, "bfloat16", FAMILY_B, FAMILY_L)
             for a, n in TRAIN_FAMILIES]
            + [(a, n, "float32", FAMILY_B, FAMILY_L)
               for a, n in TRAIN_FP32]
            + list(TRAIN_SHORT)):
        torch.cuda.empty_cache()
        model = train_model(arch, n_layers, compute=compute)
        cfg = model.cfg
        params = model.init(0)
        batch = batch_at(DataConfig(seed=1, seq_len=L, global_batch=B), 0,
                         cfg)
        with routes_pinned() as flips:
            before = (fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES)
            ssd_before = ssd_counts()
            bwd_kernel_launches(fa)
            loss, _, grads = family_grads(torch, model, params, batch, False)
            torch.cuda.synchronize()
            got = (fa_ops.LAUNCHES - before[0],
                   fa_ops.BWD_LAUNCHES - before[1])
            by_kernel = bwd_kernel_launches(fa)
            ssd_got = {k: v - ssd_before[k] for k, v in ssd_counts().items()}
            ref_loss, _, ref_grads = family_grads(torch, model, params,
                                                  batch, True)
            torch.cuda.synchronize()
        n_fa, n_ssd = family_launches(cfg)
        if got != (n_fa, n_fa):
            raise AssertionError(f"(b) {arch}: one step launched {got} (FA "
                                 f"forward, FA backward passes), expected "
                                 f"{n_fa} each")
        dt = getattr(torch, compute)
        # The SSD's counters and the kernels the dispatch picks for this
        # compute dtype at models/ssm.py's chunk, min(64, L): per layer a
        # forward and a backward pass.
        Q = min(64, L)
        want_ssd = ssd_step_counts(dt, Q, cfg.ssm_head_dim, cfg.ssm_state,
                                   n_ssd)
        if ssd_got != want_ssd:
            raise AssertionError(f"(b) {arch} {compute}: one step launched "
                                 f"{ssd_got} of the SSD, expected "
                                 f"{want_ssd}")
        if n_ssd and compute == "float32" and Q == 64:
            # The fp32 tensor-core SSD kernels, each once per layer.
            tf32 = {k: ssd_got[k] for k in (
                "ssd_carry_tf32", "ssd_carry_bwd_tf32", "ssd_chunk_bwd_tf32")}
            if tf32 != dict.fromkeys(tf32, n_ssd):
                raise AssertionError(f"(b) {arch} fp32: {tf32}, expected "
                                     f"{n_ssd} launches of each")
        ran = {"fa_bwd_preprocess", fa.bwd_kernel("dkdv", dt),
               fa.bwd_kernel("dq", dt)}
        want_k = {n: (n_fa if n in ran else 0) for n in by_kernel}
        if by_kernel != want_k:
            raise AssertionError(f"(b) {arch} {compute}: backward kernel "
                                 f"launches {by_kernel}, expected {want_k}")
        keys, worst, worst_key = grads_vs_plain(
            torch, f"(b) {arch}", params, loss, ref_loss, grads, ref_grads)
        n_flips = sum(flips.values())
        fwd = (" (" + ", ".join(sk.fwd_kernels(
            dt, Q, cfg.ssm_head_dim, cfg.ssm_state)) + f" at chunk {Q})"
            if n_ssd else "")
        log(f"[train] (b) {arch} ({cfg.family}, {compute} compute): "
            f"{cfg.n_layers} layers at "
            f"full width, {model.n_params():,} parameters, {B} x "
            f"{L}: {got[0]} FA forward launches and {got[1]} FA "
            f"backward passes in the step ("
            + ", ".join(f"{k} {v}" for k, v in by_kernel.items() if v)
            + ")"
            + (f", SSD " + ", ".join(f"{k} {v}" for k, v in ssd_got.items()
                                     if v) + fwd if n_ssd else "")
            + f"; loss {float(loss):.6f} against "
            f"{float(ref_loss):.6f} with the plain "
            + ("attention and ssd_ref" if n_ssd and n_fa else
               "ssd_ref" if n_ssd else "attention")
            + f"; {len(keys)} gradient leaves, worst |Δ| / "
            f"({TRAIN_GRAD_REL}·max|ref|) {worst:.4g} ({worst_key}) <= 1"
            + (f"; routes pinned to the kernel run's, {n_flips} token "
               f"routes the plain run would have changed" if cfg.n_experts
               else ""))
        key = arch if compute == "bfloat16" else f"{arch} {compute}"
        if L != FAMILY_L:
            key = f"{key} {B}x{L}"
        out[key] = dict(launches=got, bwd_kernel_launches=by_kernel,
                        ssd_launches=ssd_got, loss=float(loss),
                        ref_loss=float(ref_loss), worst=worst,
                        chunk=Q if n_ssd else None)
        if compute == "float32" and n_ssd:
            out[key]["step_ms"] = ssd_step_turns(torch, model, params,
                                                 batch, key)
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


def phase_train(torch) -> dict:
    head = phase_train_headline(torch)
    families = phase_train_families(torch)
    faults = phase_train_faults(torch)
    ssm = phase_train_ssm(torch)
    return dict(head, families=families, faults=faults, ssm=ssm)


# ---------------------------------------------------------------------------
# The mesh path: one-rank NCCL mesh against the unsharded path
# ---------------------------------------------------------------------------

# (tag, arch, layers (0: all), batch, tokens): phase 11 (a)'s and (d)'s
# configurations, one step compared, then MESH_STEPS timed in turns.
MESH_TRAIN = (("a", "llama3-8b", 4, 2, 4096), ("b", "mamba2-780m", 0, 2, 4096))
MESH_STEPS = 6
# (arch, layers (0: all), requests, prompt tokens, greedy decode tokens):
# phase 9's llama3-8b cut to 4 layers, phase 7's zamba2-1.2b request (a).
MESH_SERVE = (("llama3-8b", 4, 4, 2048, 16), ("zamba2-1.2b", 0, 4, 2048, 32))
# The paper-smoke cell that sends the most rounds to the kernel (19 on
# the CPU; its montage cells send none).
MESH_SIM_CELL = dict(apps=("sipht",), rates=(6.0,),
                     budget_intervals=((0.75, 1.0),))


@contextlib.contextmanager
def one_rank_mesh(torch):
    """A one-rank NCCL process group on a free local port and its (1, 1)
    ``("data", "model")`` mesh, destroyed on exit.  No other backend is
    tried: without NCCL this raises."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        dist.barrier()
        yield mesh
    finally:
        dist.destroy_process_group()


def kernel_counts() -> dict:
    """Every kernel launch counter of the model path: flash attention's
    forward and backward passes and backward kernels, the SSD's
    counters and backward kernels."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return dict({"fa": fa_ops.LAUNCHES, "fa_bwd": fa_ops.BWD_LAUNCHES},
                **{f"fa:{k}": v for k, v in fa.BWD_KERNEL_LAUNCHES.items()},
                **ssd_counts())


def reset_kernel_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    fa_ops.LAUNCHES = fa_ops.BWD_LAUNCHES = 0
    for k in fa.BWD_KERNEL_LAUNCHES:
        fa.BWD_KERNEL_LAUNCHES[k] = 0
    reset_ssd_counts()


def counted(torch, fn):
    """``fn()`` with every launch counter set to 0 just before; returns
    its result, its wall (host clock, synchronised) and the counts."""
    reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernel_counts()


def distributed_copy(tree, mesh, placements):
    """A DTensor copy of ``tree`` on ``placements``, one leaf at a time
    (never two copies of the whole tree beside the original)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.common import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [
        distribute_tensor(x.clone(), mesh, pl, src_data_rank=None)
        for x, pl in zip(tree_leaves(tree), tree_leaves(placements))])


def same_bits(a, b) -> bool:
    """Equal dtypes, shapes and bits (``a`` may be a one-rank DTensor)."""
    import torch
    from repro_torch.parallel.sharding import whole
    a = whole(a)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(ints), b.view(ints))


def mesh_train(torch, mesh, tag, arch, n_layers, B, L, smi) -> dict:
    """One step of ``arch`` through ``build_train_step`` on the mesh
    against the unsharded ``make_train_step``, from equal parameters and
    moments on the same batch: loss, parameters and moments bitwise (else
    phase 11's bar, each differing leaf named), every launch count
    equal; then ``MESH_STEPS`` steps of each in turns, timed."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.parallel.sharding import whole
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import build_train_step, \
        make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = train_model(arch, n_layers)
    cfg = model.cfg
    params = model.init(0)
    opt = init_opt_state(params)
    fn, ppl, opl, _ = build_train_step(model, mesh, "train_4k")
    dparams = distributed_copy(params, mesh, ppl)
    dopt = distributed_copy(opt, mesh, opl)
    step = make_train_step(model)
    dc = DataConfig(seed=0, seq_len=L, global_batch=B)
    batches = [batch_at(dc, s, cfg) for s in range(1 + MESH_STEPS)]
    (params, opt, met), plain_s, c_plain = counted(
        torch, lambda: step(params, opt, batches[0]))
    (dparams, dopt, dmet), mesh_s, c_mesh = counted(
        torch, lambda: fn(dparams, dopt, batches[0]))
    if c_plain != c_mesh or not c_plain.get("fa", 0) + c_plain.get(
            "LAUNCHES", 0) > 0:
        raise AssertionError(f"(12 {tag}) launches on the mesh {c_mesh}, "
                             f"unsharded {c_plain}")
    pairs = [("loss", dmet["loss"], met["loss"])]
    pairs += [(f"params/{k}", a, b) for (k, a), (_, b) in
              zip(_flatten(dparams), _flatten(params))]
    pairs += [(f"opt/{k}", a, b) for (k, a), (_, b) in
              zip(_flatten(dopt), _flatten(opt))]
    diff = [n for n, a, b in pairs if not same_bits(a, b)]
    if diff:
        rel = max(abs(float(dmet["loss"]) - float(met["loss"]))
                  / abs(float(met["loss"])), 0.0)
        worst = max(float((whole(a).float() - b.float()).abs().max())
                    / max(float(b.float().abs().max()), 1e-30)
                    for n, a, b in pairs[1:] if n in diff)
        if not (rel <= TRAIN_LOSS_REL and worst <= TRAIN_GRAD_REL):
            raise AssertionError(f"(12 {tag}) mesh step differs in {diff[:8]}"
                                 f"; loss rel {rel}, worst leaf {worst}")
        log(f"[mesh] (12 {tag}) NOT bitwise: {len(diff)} of {len(pairs)} "
            f"differ ({diff[:8]}); loss rel {rel:.3g}, worst leaf "
            f"{worst:.3g} of its max (phase 11's bar {TRAIN_GRAD_REL})")
    times = {"plain": [], "mesh": []}
    for s in range(1, 1 + MESH_STEPS):
        order = ("plain", "mesh") if s % 2 else ("mesh", "plain")
        for which in order:
            if which == "plain":
                (params, opt, _), t, c = counted(
                    torch, lambda: step(params, opt, batches[s]))
            else:
                (dparams, dopt, _), t, c = counted(
                    torch, lambda: fn(dparams, dopt, batches[s]))
            if c != c_plain:
                raise AssertionError(f"(12 {tag}) {which} step {s} launched "
                                     f"{c}, expected {c_plain}")
            times[which].append(t)
    med = {k: statistics.median(v) for k, v in times.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[mesh] (12 {tag}) {arch}, {cfg.n_layers} layers, {B} x {L}, remat "
        f"{model.run.remat}: one step on the (1, 1) NCCL mesh against the "
        f"unsharded step: loss {float(met['loss']):.6f}, "
        + ("loss, parameters and moments bitwise equal"
           if not diff else f"{len(diff)} leaves off by a rounding")
        + f" ({len(pairs)} compared); launches per step equal: "
        + ", ".join(f"{k} {v}" for k, v in c_plain.items() if v)
        + f"; {MESH_STEPS} steps each in turns: median {med['mesh']:.4f} s "
        f"on the mesh, {med['plain']:.4f} s unsharded ({med['mesh'] / med['plain']:.4f}x; "
        f"host clock, synchronised), first steps {mesh_s:.4f} / "
        f"{plain_s:.4f} s; peak allocated {peak:.3f} GiB; {smi}")
    del params, opt, dparams, dopt
    torch.cuda.empty_cache()
    return dict(launches=c_plain, bitwise=not diff, differ=diff,
                mesh_s=med["mesh"], plain_s=med["plain"], peak_gib=peak)


def mesh_serve(torch, mesh, arch, n_layers, B, L, steps, smi) -> dict:
    """Prefill B seeded prompts of L positions and ``steps`` greedy decode
    steps through the serve builders with ``mesh=`` and without: logits
    bitwise (else the decode bar, 0.15·max(max|ref|, 1)), the state on
    ``state_shardings``' placements, launch counts equal."""
    from repro_torch.models import build
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.serve_step import build_decode_step, \
        build_prefill
    torch.cuda.empty_cache()
    model = build(arch, device="cuda")
    if n_layers:
        model = dataclasses.replace(model,
                                    cfg=model.cfg.with_(n_layers=n_layers))
    cfg = model.cfg
    params = model.init(0)
    prompt = prompt_batch(torch, cfg, B, L, seed=L)
    runs = {}
    for which in ("plain", "mesh"):
        m = mesh if which == "mesh" else None
        p = params if m is None else shd.distribute(
            params, mesh, shd.model_param_shardings(model, mesh, "serve"))
        prefill = build_prefill(model, "prefill_32k", device="cuda",
                                max_seq=L + steps, mesh=m)
        decode = build_decode_step(model, "decode_32k", device="cuda",
                                   mesh=m)
        (logits, state), pre_s, c_pre = counted(
            torch, lambda: prefill(p, prompt))
        placed = m is None or shd.placements_of(state) == \
            shd.state_shardings(model, mesh, "prefill_32k")
        outs, step_s = [shd.whole(logits)], []
        reset_kernel_counts()
        for _ in range(steps):
            tok = shd.whole(logits)[:, -1].argmax(-1, keepdim=True)
            (logits, state), t, _ = counted(
                torch, lambda: decode(p, state, tok))
            outs.append(shd.whole(logits))
            step_s.append(t)
        c_dec = kernel_counts()
        placed = placed and (m is None or shd.placements_of(state) ==
                             shd.state_shardings(model, mesh, "decode_32k"))
        if not placed:
            raise AssertionError(f"(12 c) {arch}: the mesh state is not on "
                                 f"state_shardings' placements")
        runs[which] = dict(outs=outs, pre_s=pre_s, counts=(c_pre, c_dec),
                           dec_ms=statistics.median(step_s) * 1e3,
                           length=int(shd.whole(state["length"])))
        del p, state
    a, b = runs["mesh"], runs["plain"]
    if a["counts"] != b["counts"] or a["length"] != L + steps \
            or b["length"] != L + steps:
        raise AssertionError(f"(12 c) {arch}: launches {a['counts']} and "
                             f"length {a['length']} on the mesh, "
                             f"{b['counts']} and {b['length']} unsharded, "
                             f"length {L + steps} expected")
    diff = [i for i, (x, y) in enumerate(zip(a["outs"], b["outs"]))
            if not same_bits(x, y)]
    worst = max((float((x.float() - y.float()).abs().max())
                 / max(float(y.float().abs().max()), 1.0)
                 for x, y in zip(a["outs"], b["outs"])), default=0.0)
    if diff and not worst <= 0.15:
        raise AssertionError(f"(12 c) {arch}: logits differ at steps {diff}"
                             f", worst {worst}")
    log(f"[mesh] (12 c) {arch}, {cfg.n_layers} layers, {B} x {L} and "
        f"{steps} decode tokens: logits "
        + ("bitwise equal" if not diff else
           f"differ at steps {diff[:8]} (worst {worst:.3g}, bar 0.15)")
        + f" to the unsharded builders'; state on state_shardings' "
        f"placements; launches (prefill, decode) equal: "
        + ", ".join(f"{k} {v}" for k, v in b["counts"][0].items() if v)
        + f" per prefill; prefill {a['pre_s']:.4f} s on the mesh, "
        f"{b['pre_s']:.4f} unsharded; decode median {a['dec_ms']:.3f} ms "
        f"on the mesh, {b['dec_ms']:.3f} unsharded (host clock, "
        f"synchronised); {smi}")
    del params
    torch.cuda.empty_cache()
    return dict(launches=b["counts"], bitwise=not diff, worst=worst,
                mesh_prefill_s=a["pre_s"], plain_prefill_s=b["pre_s"],
                mesh_decode_ms=a["dec_ms"], plain_decode_ms=b["dec_ms"])


def mesh_simulator(torch, mesh, parity: dict, smi) -> dict:
    """The simulator's round-buffer seam with the mesh set: phase 4's
    seed-0 grid gives phase 4's SimResults and launches, and one
    paper-smoke cell gives the artifact and launches it gives without."""
    import tempfile
    from repro_torch.core import cycles
    from repro_torch.exp.run import run_grid
    from repro_torch.exp.scenarios import get_scenario
    from repro_torch.kernels.affinity import ops as aff_ops
    from repro_torch.parallel.sharding import replicated
    one = dataclasses.replace(get_scenario("paper-smoke"), **MESH_SIM_CELL)
    arts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for which in ("plain", "mesh"):
            cycles.set_round_buffer_mesh(mesh if which == "mesh" else None)
            try:
                if which == "mesh":
                    if cycles._ROUND_BUFFER_PLACEMENT != replicated(mesh):
                        raise AssertionError("(12 d) the round buffers' "
                                             "placement is not replicated")
                    again = phase_parity((0,), tag="mesh d")
                    if again[0] != parity[0]:
                        raise AssertionError("(12 d) phase 4's seed-0 grid "
                                             "moved with the mesh set")
                aff_ops.LAUNCHES = 0
                art = run_grid(one, device="cuda",
                               trace_dir=f"{tmp}/{which}")
                arts[which] = (art, aff_ops.LAUNCHES)
            finally:
                cycles.set_round_buffer_mesh(None)
    (a, na), (b, nb) = arts["mesh"], arts["plain"]
    diff = sorted(k for k in set(a) | set(b)
                  if k not in BACKEND_FIELDS and a.get(k) != b.get(k))
    if diff or na != nb or not na > 0:
        raise AssertionError(f"(12 d) the paper-smoke cell differs in {diff}"
                             f"; launches {na} with the mesh, {nb} without")
    log(f"[mesh] (12 d) round buffers on the mesh (replicated): phase 4's "
        f"seed-0 grid identical, {parity[0][1]} launches as in phase 4; "
        f"one paper-smoke cell ({len(a['cells'])} rows) equal with and "
        f"without the mesh, {na} affinity launches each; {smi}")
    return dict(launches=na, parity_launches=parity[0][1])


def phase_mesh(torch, parity: dict, smi: str) -> dict:
    out = {}
    with one_rank_mesh(torch) as mesh:
        log(f"[mesh] one-rank NCCL group, mesh {mesh.mesh_dim_names} "
            f"{tuple(mesh.shape)} on {torch.cuda.get_device_name(0)}")
        for tag, arch, n_layers, B, L in MESH_TRAIN:
            out[tag] = mesh_train(torch, mesh, tag, arch, n_layers, B, L, smi)
        out["c"] = {arch: mesh_serve(torch, mesh, arch, n_layers, B, L,
                                     steps, smi)
                    for arch, n_layers, B, L, steps in MESH_SERVE}
        out["d"] = mesh_simulator(torch, mesh, parity, smi)
    return out



# ---------------------------------------------------------------------------
# Phase 13: the dry run
# ---------------------------------------------------------------------------

# (a) Phase 11 (a)'s step (TRAIN_HEADLINE), traced by the dry run on a
# one-rank fake group's (1, 1) mesh in a process of its own (a process
# group is process-wide, and phase 12's NCCL group has come and gone in
# this one); writes the counts to the file named.
DRY_ONE_RANK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
arch, n_layers, B, L = cs.TRAIN_HEADLINE
assert SHAPES["train_4k"].seq_len == L
model = cs.train_model(arch, n_layers)
dryrun.fake_group(1)
counts = dryrun.trace(model, make_mesh((1, 1), ("data", "model")),
                      "train_4k", B)
with open(sys.argv[2], "w") as f:
    json.dump(counts, f)
"""
# Predicted peak live bytes (arguments + temporaries) within this share of
# the real step's torch.cuda.max_memory_allocated.
DRY_MEM_REL = 0.10
# (b) One cell per kind at full width and depth on the production
# (16, 16) mesh: train (dense; MoE, expert parallel), prefill (SSM),
# decode (dense, a 32k KV cache), long-context decode (hybrid).
DRY_CELLS = (("llama3-8b", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"),
             ("mamba2-780m", "prefill_32k"), ("llama3-8b", "decode_32k"),
             ("zamba2-1.2b", "long_500k"))
DRY_TIMEOUT_S = 600


def dry_live(art: dict) -> int:
    """The roofline's live bytes of an artifact: arguments and
    temporaries, and a prefill's new cache (``roofline.analyze``)."""
    mem = art["memory"]
    live = mem["argument_bytes"] + mem["temp_bytes"]
    return live + (mem["output_bytes"] if art["kind"] == "prefill" else 0)


def dry_one_rank(torch, smi: str) -> dict:
    """(a): the dry run's flops and peak of phase 11 (a)'s step against
    the same step run on the card: ``FlopCounterMode``'s count of one
    step after a warm-up (the same operators and formulas: equal
    exactly) and its ``max_memory_allocated`` (within DRY_MEM_REL)."""
    import tempfile
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import make_train_step
    arch, n_layers, B, L = TRAIN_HEADLINE
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "counts.json"
        subprocess.run([sys.executable, "-c", DRY_ONE_RANK, str(ROOT),
                        str(out)], check=True, timeout=DRY_TIMEOUT_S)
        dry = json.loads(out.read_text())
    dry_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    model = train_model(arch, n_layers)
    params = model.init(0)
    opt = init_opt_state(params)
    step = make_train_step(model)
    dc = DataConfig(seed=0, seq_len=L, global_batch=B)
    params, opt, _ = step(params, opt, batch_at(dc, 0, model.cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        params, opt, met = step(params, opt, batch_at(dc, 1, model.cfg))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(float(met["loss"])):
        raise AssertionError(f"(a) non-finite loss {float(met['loss'])}")
    real = fc.get_total_flops()
    mem = dry["memory"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    log(f"[dryrun] (a) {arch} ({n_layers} layers, {B} x {L}, remat "
        f"{model.run.remat}) on a one-rank fake mesh, traced in "
        f"{dry['trace_s']:.3f} s ({dry_s:.3f} s with the process): flops "
        f"{dry['flops']:.0f} predicted, {real} counted by FlopCounterMode "
        f"in the real step ("
        + ", ".join(f"{k} {v}" for k, v in
                    fc.get_flop_counts()["Global"].items())
        + f"); peak {predicted / 2**30:.3f} GiB predicted (arguments "
        f"{mem['argument_bytes'] / 2**30:.3f}, temporaries "
        f"{mem['temp_bytes'] / 2**30:.3f}), {peak / 2**30:.3f} GiB "
        f"max_memory_allocated ({predicted / peak:.4f}); {smi}")
    if dry["flops"] != real:
        raise AssertionError(f"(a) dry-run flops {dry['flops']} != the real "
                             f"step's {real}")
    if abs(predicted - peak) > DRY_MEM_REL * peak:
        raise AssertionError(f"(a) predicted peak {predicted} bytes is not "
                             f"within {DRY_MEM_REL} of the real {peak}")
    del params, opt, step
    torch.cuda.empty_cache()
    return dict(flops=real, predicted_gib=predicted / 2**30,
                peak_gib=peak / 2**30, trace_s=dry["trace_s"])


def dry_cells(art_dir: Path, smi: str) -> dict:
    """(b): ``python -m repro_torch.launch.dryrun`` for each of DRY_CELLS
    (all started together, each its own process), exit 0 each; each
    cell's trace time, flops and live bytes per device, and the roofline
    table over them."""
    from repro_torch.launch import roofline
    t0 = time.perf_counter()
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--out", str(art_dir)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cell in DRY_CELLS}
    logs = {cell: p.communicate(timeout=DRY_TIMEOUT_S)[0]
            for cell, p in procs.items()}
    wall = time.perf_counter() - t0
    failed = [c for c, p in procs.items() if p.returncode != 0]
    if failed:
        raise AssertionError("dry run failed for " + "; ".join(
            f"{c}:\n{logs[c][-3000:]}" for c in failed))
    out = {}
    for arch, shape in DRY_CELLS:
        art = json.loads((art_dir / f"singlepod__{arch}__{shape}.json")
                         .read_text())
        if art["device"] != "cuda" or art["mesh"]["n_devices"] != 256:
            raise AssertionError(f"({arch}, {shape}) traced on "
                                 f"{art['device']}, {art['mesh']}")
        live = dry_live(art)
        out[(arch, shape)] = dict(trace_s=art["lower_s"],
                                  flops=art["flops_per_device"],
                                  live_gib=live / 2**30)
        log(f"[dryrun] (b) {arch} x {shape} on {art['mesh']['axes']}: "
            f"traced in {art['lower_s']} s, flops/dev "
            f"{art['flops_per_device']:.6g}, bytes/dev "
            f"{art['bytes_accessed_per_device']:.6g}, collective bytes/dev "
            f"{art['collective_bytes_per_device']:.6g}, live "
            f"{live / 2**30:.3f} GiB/dev")
    log(f"[dryrun] (b) {len(DRY_CELLS)} processes together in {wall:.3f} s "
        f"({smi}); roofline (H100 rates):")
    for row in roofline.table(str(art_dir)).splitlines():
        log(f"[dryrun]   {row}")
    return dict(cells=out, wall=wall)


def dry_waas(torch, art_dir: Path) -> dict:
    """(c): phase 10's sweep (defaults) with ``art_dir`` set to (b)'s
    artifacts, on the card and on the CPU: rows equal, launches equal to
    the CPU's rounds; every cost it reads of a cell with an artifact is
    that artifact's flops (the rest take the analytic fallback)."""
    from repro_torch.kernels.affinity import ops
    from repro_torch.waas import mljobs, platform
    measured = mljobs.StageCostModel(str(art_dir)).measured
    want = {c for c in DRY_CELLS}
    if not set(measured) <= want or len(measured) != len(want):
        raise AssertionError(f"(c) the cost model reads {sorted(measured)} "
                             f"from the artifacts, expected {sorted(want)}")
    reads = []
    original = mljobs.StageCostModel.step_gflops

    def recorded(self, arch, shape):
        got = original(self, arch, shape)
        reads.append(((arch, shape), (arch, shape) in self.measured,
                      got == self.measured.get((arch, shape), -1.0) / 1e9))
        return got
    mljobs.StageCostModel.step_gflops = recorded
    try:
        cpu, rounds, cpu_wall = cpu_rounds(
            lambda: platform.sweep(art_dir=str(art_dir), device="cpu"))
        ops.LAUNCHES = 0
        t0 = time.perf_counter()
        rows = platform.sweep(art_dir=str(art_dir), device="cuda")
        wall, launches = time.perf_counter() - t0, ops.LAUNCHES
    finally:
        mljobs.StageCostModel.step_gflops = original
    if rows != cpu:
        raise AssertionError("(c) sweep on the dry-run artifacts: card rows "
                             "differ from the CPU's")
    if launches != rounds:
        raise AssertionError(f"(c) {launches} launches on the card, "
                             f"{rounds} rounds on the CPU")
    hits = [c for c, m, _ in reads if m]
    if not hits or not all(same for _, m, same in reads if m):
        raise AssertionError("(c) the sweep read no cost from the dry-run "
                             "artifacts, or one not equal to its flops")
    fallback = sorted({c for c, m, _ in reads if not m})
    check_sweep_rows(rows, 24, "(c) sweep on the dry-run artifacts")
    log(f"[dryrun] (c) WaaS sweep (defaults) on the artifacts: {len(rows)} "
        f"rows, card = CPU; {launches} affinity launches = the CPU's "
        f"{rounds} rounds; {len(reads)} stage costs read, {len(hits)} from "
        f"the artifacts ({sorted(set(hits))}), the rest from the analytic "
        f"fallback for cells without one ({fallback}); wall {wall:.3f} s on "
        f"the card, {cpu_wall:.3f} s on the CPU")
    return dict(rows=len(rows), reads=len(reads), from_artifacts=len(hits),
                launches=launches)


def phase_dryrun(torch, smi: str) -> dict:
    import tempfile
    out = {"a": dry_one_rank(torch, smi)}
    with tempfile.TemporaryDirectory() as tmp:
        out["b"] = dry_cells(Path(tmp), smi)
        out["c"] = dry_waas(torch, Path(tmp))
    return out


# ---------------------------------------------------------------------------
# Dense models at head dims outside the kernels' first four
# ---------------------------------------------------------------------------

# llama3-8b's widths (src/repro/configs/llama3_8b.py: d_model 4096, d_ff
# 14336, vocab 128256, 32 layers, RoPE θ 500k) with the attention's head
# geometry replaced through the port's ModelConfig (a config the
# reference's ModelConfig takes too, not a new arch of the zoo): (i) 32
# query heads of 96 over 8 kv heads, Phi-3-mini's head geometry; (ii) 16
# of 256 over 8, Gemma-7B's.
HEAD_DIM_VARIANTS = (("hd96", dict(n_heads=32, n_kv_heads=8, head_dim=96)),
                     ("hd256", dict(n_heads=16, n_kv_heads=8,
                                    head_dim=256)))
# Serving as phase 9's llama3-8b (full depth, seeded fp32 weights, bf16
# compute): requests, prompt positions, greedy decode tokens.
HD_SERVE = (4, 2048, 16)
# Training as phase 11 (a): 4 of 32 layers, 2 x 4096 tokens.
HD_TRAIN_LAYERS, HD_TRAIN_B, HD_TRAIN_L = 4, 2, 4096
# And as 11 (b): one step at 2 layers, 1 x 2048, against the plain
# attention.
HD_HOLD_LAYERS = 2


def head_dim_serving(torch, tag, over) -> dict:
    """Phase 9's llama3-8b request with the replaced heads: after a
    warm-up request, 4 x 2048 prompts and 16 greedy decode tokens, one FA
    launch per layer per prefill and none in decode, each decode step
    held against ``forward``, one profiled prefill."""
    import gc
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build
    from repro_torch.serve.serve_step import build_prefill
    B, L, steps = HD_SERVE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build("llama3-8b", device="cuda")
    model = dataclasses.replace(model, cfg=model.cfg.with_(**over))
    cfg = model.cfg
    params = model.init(0)
    log(f"[hd] {tag} serving: llama3-8b's widths, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head "
        f"dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{model.n_params():,} seeded fp32 parameters, compute "
        f"{model.run.compute_dtype}")
    serve_request(torch, model, params, 1, 64, 2, seed=0)
    fa_ops.LAUNCHES = 0
    res = serve_request(torch, model, params, B, L, steps, seed=L,
                        counts=lambda: (fa_ops.LAUNCHES,))
    (c0,), (c1,), (c2,) = res["counts"]
    if c1 - c0 != cfg.n_layers or c2 != c1:
        raise AssertionError(f"({tag}) prefill launched {c1 - c0} FA "
                             f"kernels (expected {cfg.n_layers}), decode "
                             f"{c2 - c1} (expected 0)")
    err = check_decode_vs_forward(torch, model, params, res, "hd")
    step_ms = statistics.median(res["step_ms"])
    prompt = {k: v.cuda() for k, v in res["prompt"].items()}
    prefill = build_prefill(model, "prefill_32k", max_seq=L + 1)
    by = device_breakdown(torch, lambda: prefill(params, prompt))
    if not by["fa_kernel"] > 0:
        raise AssertionError(f"({tag}) no device time under fa_kernel in "
                             f"a prefill")
    busy = by["fa_kernel"] + by["other"]
    wall = res["prefill_s"] * 1e3
    log(f"[hd] {tag} {B} x {L}-position prompts: prefill "
        f"{res['prefill_s']:.4f} s ({B * L / res['prefill_s']:.1f} "
        f"positions/s), {c1 - c0} FA launches; {steps} greedy decode "
        f"steps: median {step_ms:.3f} ms, max {max(res['step_ms']):.3f} "
        f"ms per step (host clock, synchronised); peak allocated "
        f"{res['peak_gib']:.3f} GiB; one profiled prefill's device time, "
        f"ms: fa_kernel {by['fa_kernel']:.3f}, other kernels "
        f"{by['other']:.3f}, busy {busy:.3f} of {wall:.3f} wall, idle "
        f"share {max(0.0, 1 - busy / wall):.4f}")
    out = dict(launches=c1 - c0, prefill_s=res["prefill_s"],
               step_ms=step_ms, peak_gib=res["peak_gib"], err=err,
               fa_ms=by["fa_kernel"], other_ms=by["other"], busy=busy,
               idle=max(0.0, 1 - busy / wall))
    del params, model, res, prompt, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return out


def head_dim_training(torch, tag, over) -> dict:
    """Phase 11 (a)'s step with the replaced heads (4 of 32 layers,
    2 x 4096, remat dots, 6 timed steps, launches checked, one profiled
    step), then 11 (b)'s one step at 2 layers, 1 x 2048, against the
    plain attention."""
    import gc
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels.flash_attention import ops as fa_ops
    run = timed_steps(
        torch, tag, "llama3-8b", HD_TRAIN_LAYERS, HD_TRAIN_B, HD_TRAIN_L,
        lambda c: f"{HD_TRAIN_LAYERS} of 32 layers, d_model {c.d_model}, "
                  f"heads {c.n_heads}/{c.n_kv_heads}, head dim {c.hd}",
        reset_fa_counts, over=over)
    launches, by_kernel = check_train_launches(tag, HD_TRAIN_LAYERS)
    step_s = run["step_s"]
    tokens = HD_TRAIN_B * HD_TRAIN_L / step_s
    split = profiled_step(torch, tag, run, ("fa_kernel",) + FA_BWD_KERNELS)
    fa_bwd_ms = sum(split[name] for name in FA_BWD_KERNELS)
    log(f"[hd] {tag} training: {TRAIN_STEPS} steps after {TRAIN_WARMUP} "
        f"warm-up: median {step_s:.4f} s, max {max(run['times']):.4f} s "
        f"per step (host clock, synchronised), {tokens:.1f} tokens/s; "
        f"losses {[round(x, 4) for x in run['losses']]}; "
        f"{launches[0]} FA forward launches and {launches[1]} backward "
        f"passes (" + ", ".join(f"{k} {v}" for k, v in by_kernel.items()
                                if v)
        + f"); peak allocated {run['peak']:.3f} GiB; one profiled step, "
        f"ms: fa_kernel {split['fa_kernel']:.3f}, FA backward "
        f"{fa_bwd_ms:.3f} ("
        + ", ".join(f"{k} {split[k]:.3f}" for k in FA_BWD_KERNELS)
        + f"), other {split['other']:.3f}; busy {split['busy']:.3f} of "
        f"{split['wall']:.3f} wall, idle share {split['idle']:.4f}")
    out = dict(fa_launches=launches[0], bwd_launches=launches[1],
               bwd_kernel_launches=by_kernel, step_s=step_s,
               tokens_per_s=tokens, peak_gib=run["peak"],
               fa_fwd_ms=split["fa_kernel"], fa_bwd_ms=fa_bwd_ms,
               busy=split["busy"], idle=split["idle"])
    del run
    gc.collect()
    torch.cuda.empty_cache()
    model = train_model("llama3-8b", HD_HOLD_LAYERS, over=over)
    params = model.init(0)
    batch = batch_at(DataConfig(seed=1, seq_len=FAMILY_L,
                                global_batch=FAMILY_B), 0, model.cfg)
    reset_fa_counts()
    loss, _, grads = family_grads(torch, model, params, batch, False)
    torch.cuda.synchronize()
    got = (fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES)
    if got != (HD_HOLD_LAYERS, HD_HOLD_LAYERS):
        raise AssertionError(f"({tag}) the {FAMILY_B} x {FAMILY_L} step "
                             f"launched {got} (FA forward, backward "
                             f"passes), expected {HD_HOLD_LAYERS} each")
    ref_loss, _, ref_grads = family_grads(torch, model, params, batch, True)
    torch.cuda.synchronize()
    keys, worst, worst_key = grads_vs_plain(
        torch, f"({tag}) {FAMILY_B} x {FAMILY_L}", params, loss, ref_loss,
        grads, ref_grads)
    log(f"[hd] {tag} one step at {HD_HOLD_LAYERS} layers, {FAMILY_B} x "
        f"{FAMILY_L}, through the kernels against the plain attention on "
        f"the card: loss {float(loss):.6f} against {float(ref_loss):.6f}; "
        f"{len(keys)} gradient leaves, worst |Δ| / ({TRAIN_GRAD_REL}·"
        f"max|ref|) {worst:.4g} ({worst_key}) <= 1")
    out.update(loss=float(loss), ref_loss=float(ref_loss), worst=worst)
    del params, grads, ref_grads, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_head_dims(torch) -> dict:
    """Phase 14: both HEAD_DIM_VARIANTS served and trained on the
    hand-written kernels."""
    out = {}
    for tag, over in HEAD_DIM_VARIANTS:
        out[tag] = dict(serve=head_dim_serving(torch, tag, over),
                        train=head_dim_training(torch, tag, over))
    return out


def main() -> int:
    import torch
    smi = phase_device(torch)
    phase_build()
    k = phase_kernel(torch)
    parity = phase_parity()
    launches = phase_full_width(torch, k["link_rate"])
    fa = phase_attention(torch)
    fa["domain"] = phase_attention_domain(torch)
    t0 = time.perf_counter()
    fab = phase_attention_bwd(torch)
    log(f"[fa-bwd] phase 6's backward checks took "
        f"{time.perf_counter() - t0:.3f} s")
    sd = phase_ssd(torch)
    t0 = time.perf_counter()
    sdb = phase_ssd_bwd(torch)
    log(f"[ssd-bwd] phase 6's SSD backward checks took "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sdt = ssd_tiled_rows(torch, "bfloat16")
    log(f"[ssd-tiled] phase 6's bf16 tiled SSD checks took "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sdt32 = ssd_tiled_rows(torch, "float32")
    log(f"[ssd-tiled] phase 6's fp32 tiled SSD checks took "
        f"{time.perf_counter() - t0:.3f} s")
    serve = phase_serving(torch)
    exp = phase_experiments(torch, k["link_rate"])
    tf = phase_transformers(torch)
    waas = phase_waas(torch, k["link_rate"])
    t0 = time.perf_counter()
    train = phase_train(torch)
    log(f"[train] phase 11 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    mesh = phase_mesh(torch, parity, smi)
    log(f"[mesh] phase 12 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    phase_dryrun(torch, smi)
    log(f"[dryrun] phase 13 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    hd = phase_head_dims(torch)
    log(f"[hd] phase 14 took {time.perf_counter() - t0:.3f} s")
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    # Phase 11 (b)'s 2 x 50 mamba2-780m step (chunk 50).
    short = train["families"]["{} {}x{}".format(*TRAIN_SHORT[0][:1],
                                                *TRAIN_SHORT[0][3:])]

    def fwd_chunks(which):
        """Phase 6's rows at SSD_CHUNKS for the chunk (0) or carry (1)
        kernel."""
        pre = ("", "carry_")[which]
        return [dict(shape=list(sh), dtype=dt, kernel=r["kernels"][which],
                     **{key: r[pre + key] for key in (
                         "ms", "plain_ms", "bound_ms", "bound_by")})
                for (sh, dt), r in sd["chunks"].items()]

    def bwd_chunks(key, name):
        """Phase 6's backward rows at SSD_CHUNKS where ``name`` ran."""
        return [dict(shape=list(sh), dtype=dt, ms=r["ms"][key],
                     plain_ms=r["plain_ms"][key],
                     bound_ms=r["bounds"][key][0],
                     bound_by=r["bounds"][key][1],
                     backward=dict(ms=r["ms"]["backward"],
                                   plain_ms=r["plain_ms"]["backward"],
                                   bound_ms=r["bounds"]["backward"][0],
                                   bound_by=r["bounds"]["backward"][1]))
                for (sh, dt), r in sdb["rows"].items()
                if sh in SSD_CHUNKS and r["names"][key] == name]
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
        # Phase 12 (d): one paper-smoke cell with the mesh set.
        "launches_mesh": mesh["d"]["launches"],
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
        # The head dims the kernels take: 1..256 in column buckets (bf16
        # padded to a multiple of 8), swept at small shapes in phase 6.
        "head_dims": {"domain": [1, fa_kernel.MAX_HEAD_DIM],
                      "buckets": list(fa_kernel.BUCKETS),
                      "swept": list(FA_DOMAIN_DIMS),
                      "worst_ratio_to_bar": fa["domain"]},
        # Phase 14: launches per prefill and per 6 timed train steps.
        "launches_head_dims": {
            tag: {"prefill": r["serve"]["launches"],
                  "train": r["train"]["fa_launches"]}
            for tag, r in hd.items()},
        # Phase 6 at phase 14's shapes ([B, H, L, D], causal, dtype).
        "head_dim_rows": [dict(shape=[b, h, l, d], causal=c, dtype=dt,
                               **{key: fa["rows"][(b, l, h, d, c, dt)][key]
                                  for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms",
                                              "err")})
                          for b, l, h, d, c, dt in FA_HD_SERVING
                          + FA_HD_TRAIN],
        # Phase 9: launches per arch (one prefill each).
        "launches_transformers": {a: r["launches"] for a, r in tf.items()},
        # Phase 11 (a): the training headline's timed steps (remat dots
        # keeps each forward: one launch per layer per step).
        "launches_train": train["fa_launches"],
        # Phase 12: one step (a) and one request each (c) on the
        # one-rank mesh, equal to the unsharded path's.
        "launches_mesh": {"train": mesh["a"]["launches"]["fa"],
                          **{a: r["launches"][0]["fa"]
                             for a, r in mesh["c"].items()}},
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
        # Phase 12: one mamba2-780m step (b) and one zamba2-1.2b prefill
        # (c) on the one-rank mesh, equal to the unsharded path's.
        "launches_mesh": {"train": mesh["b"]["launches"]["LAUNCHES"],
                          "zamba2-1.2b": mesh["c"]["zamba2-1.2b"][
                              "launches"][0]["LAUNCHES"]},
        # Phase 11 (b)'s 2 x 50 step (chunk 50), and phase 6 at chunks
        # of 128, 256 and 50 rows.
        "launches_short": short["ssd_launches"]["LAUNCHES"],
        "chunks": fwd_chunks(0),
    }, {
        "name": "ssd_carry",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        # No Pallas kernel: the reference's jax.lax.scan and einsum.
        "replaces": "src/repro/kernels/ssd/ops.py:40",
        "tpu_kernel": False,
        "launches": serve["carry_launches"],
        "launches_mesh": {"train": mesh["b"]["launches"]["CARRY_LAUNCHES"],
                          "zamba2-1.2b": mesh["c"]["zamba2-1.2b"][
                              "launches"][0]["CARRY_LAUNCHES"]},
        "max_abs_err": sd["carry_max_abs_err"],
        "ms": ssd_head["carry_ms"],
        "plain_ms": ssd_head["carry_plain_ms"],
        "bound_ms": ssd_head["carry_bound_ms"],
        "bound_by": ssd_head["carry_bound_by"],
        "library_ms": None,
        "shape": list(SSD_HEADLINE),
        "launches_short": short["ssd_launches"]["CARRY_LAUNCHES"],
        # Phase 11 (d): the mamba2-780m step's 6 timed steps.
        "launches_train": train["ssm"]["ssd_launches"]["CARRY_LAUNCHES"],
        "chunks": fwd_chunks(1),
        # ssd_carry_tc at the serving shapes and (d)'s: its time through
        # the C entry point, its plan and share of the byte bound.
        "entry_ms": sd["carry_rows"][SSD_HEADLINE]["entry_ms"],
        "rows": [dict(shape=list(sh), **r)
                 for sh, r in sd["carry_rows"].items()],
        "build": sd["carry_builds"],
    }]}
    # The fp32 forward (TF32 tensor cores) at phase 11 (b)'s fp32 step,
    # which launched it once per layer; phase 6's fp32 rows beside it.
    f32_run = train["families"][f"{TRAIN_FP32[0][0]} float32"]
    fwd32 = fa["rows"][FA_TRAIN_F32]
    Bt, Lt, Ht, Dt, _, _ = FA_TRAIN_F32
    record["kernels"].append({
        "name": "fa_kernel_tf32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "launches": f32_run["launches"][0],
        "max_abs_err": max(r["err"] for sh, r in fa["rows"].items()
                           if sh[5] == "float32"),
        **{key: fwd32[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "mma_floor_ms")},
        "shape": [Bt, Ht, Lt, Dt],
        "dtype": "float32",
        # Every fp32 row of phase 6 ([B, H, L, D], causal).
        "rows": [dict(shape=[b, h, l, d], causal=c,
                      **{key: r[key] for key in (
                          "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "mma_floor_ms", "err")})
                 for (b, l, h, d, c, dt), r in fa["rows"].items()
                 if dt == "float32"],
        "build": {k: v for k, v in fab["builds"].items()
                  if k.startswith("fa_kernel_tf32<")},
    })
    # The backward's kernels: the bf16 ones (and the preprocess) at the
    # training headline, launched by phase 11 (a); the fp32 ones (TF32
    # tensor cores) at phase 11 (b)'s fp32 step, which launched them.
    for key, name, shape, launches in (
            ("preprocess", "fa_bwd_preprocess", FA_TRAIN,
             train["bwd_kernel_launches"]),
            ("dkdv", "fa_bwd_dkdv_tc", FA_TRAIN,
             train["bwd_kernel_launches"]),
            ("dq", "fa_bwd_dq_tc", FA_TRAIN, train["bwd_kernel_launches"]),
            ("dkdv", "fa_bwd_dkdv_tf32", FA_TRAIN_F32,
             f32_run["bwd_kernel_launches"]),
            ("dq", "fa_bwd_dq_tf32", FA_TRAIN_F32,
             f32_run["bwd_kernel_launches"])):
        bwd = fab["rows"][shape]
        Bt, Lt, Ht, Dt, causal, dtype = shape
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bwd.cu",
            # No Pallas kernel: XLA's gradient of the jnp attention.
            "replaces": "src/repro/models/layers.py:145",
            "tpu_kernel": False,
            # Phase 11: each backward pass launches the kernel once.
            "launches": launches[name],
            # Phase 12 (a): one bf16 step on the one-rank mesh.
            "launches_mesh": mesh["a"]["launches"].get("fa:" + name, 0),
            "max_abs_err": fab["max_abs_err"],
            "ms": bwd["ms"][key],
            "plain_ms": bwd["plain_ms"][key],
            "bound_ms": bwd["bounds"][key][0],
            "bound_by": bwd["bounds"][key][1],
            # The kernel's own tensor-core work at its type's peak.
            **({"mma_floor_ms": bwd["mma_floor_ms"][key]}
               if key in bwd["mma_floor_ms"] else {}),
            # No single PyTorch call computes one kernel's share; the
            # whole backward's library time is under "backward".
            "library_ms": None,
            "shape": [Bt, Ht, Lt, Dt],
            "dtype": dtype,
            "backward": dict(ms=bwd["ms"]["backward"],
                             plain_ms=bwd["plain_ms"]["backward"],
                             bound_ms=bwd["bounds"]["backward"][0],
                             bound_by=bwd["bounds"]["backward"][1],
                             library_ms=bwd["library_ms"],
                             library_backend=bwd["library_backend"]),
            # Phase 11 (b): launches in one step per arch (and dtype).
            "launches_families": {a: r["bwd_kernel_launches"][name]
                                  for a, r in train["families"].items()},
            # Phase 14: launches in the 6 timed steps per head dim.
            "launches_head_dims": {
                tag: r["train"]["bwd_kernel_launches"][name]
                for tag, r in hd.items()},
            **({"build": {k: v for k, v in fab["builds"].items()
                          if k.startswith(name + "<")}}
               if name != "fa_bwd_preprocess" else {
                   "build": fab["preprocess"]["builds"],
                   "entry_ms": fab["preprocess"]["rows"][shape]["entry_ms"],
                   "rows": [dict(shape=list(sh), **r) for sh, r in
                            fab["preprocess"]["rows"].items()]}),
        })
    # The SSD's fp32 forward kernels at (b)'s fp32 mamba2-780m step (1 x
    # 2048): ssd_chunk_tf32 and ssd_carry_tf32, which that step launched,
    # and the CUDA-core ssd_chunk_kernel and ssd_carry_kernel timed on the
    # same inputs, launched on a main path by (b)'s 2 x 50 step (chunk 50).
    ssm_f32 = train["families"]["mamba2-780m float32"]
    f32_fwd = sd["tf32"]["rows"][SSD_TRAIN_F32[0]]
    for name, pre, launches in (("ssd_chunk_tf32", "", ssm_f32),
                                ("ssd_chunk_kernel", "core_", short),
                                ("ssd_carry_tf32", "carry_", ssm_f32),
                                ("ssd_carry_kernel", "carry_core_", short)):
        carry = pre.startswith("carry_")
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
            **({"replaces": "src/repro/kernels/ssd/kernel.py:22"}
               if not carry else {
                   # No Pallas kernel: the reference's jax.lax.scan and
                   # einsum.
                   "replaces": "src/repro/kernels/ssd/ops.py:40",
                   "tpu_kernel": False}),
            "launches": launches["ssd_launches"][name],
            "max_abs_err": sd["tf32"]["worst"][name],
            # Through the C entry point (BURST launches a window), in
            # turns with the other kernel.
            "ms": f32_fwd[pre + "entry_ms"],
            "plain_ms": f32_fwd["carry_plain_ms" if carry else "plain_ms"],
            "bound_ms": f32_fwd[pre + "bound_ms"],
            "bound_by": f32_fwd[pre + "bound_by"],
            "library_ms": None,
            "shape": list(SSD_TRAIN_F32[0]),
            "dtype": "float32",
            **({"wrapper_ms": f32_fwd["ms"],
                "heads_per_block": f32_fwd["heads_per_block"],
                "smem": f32_fwd["smem"],
                "build": sd["tf32"]["builds"],
                "cuda_core_ms": f32_fwd["core_entry_ms"]}
               if pre == "" else {}),
            **({"wrapper_ms": f32_fwd["carry_ms"],
                "plan": f32_fwd["carry_plan"],
                "build": sd["tf32"]["carry_builds"],
                "cuda_core_ms": f32_fwd["carry_core_entry_ms"]}
               if pre == "carry_" else {}),
            # Phase 11 (b): launches in one step per arch (and dtype).
            "launches_families": {
                a: r["ssd_launches"][name]
                for a, r in train["families"].items()
                if r["ssd_launches"][name]},
            # Phase 6 at SSD_TF32_SHAPES (fp32).
            "rows": [dict(shape=list(sh), **{
                k: r[k] for k in ("entry_ms", "core_entry_ms", "turns", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "core_bound_ms", "core_bound_by",
                                  "heads_per_block", "smem", "ratio")})
                     if not carry else dict(shape=list(sh), **{
                k[6:]: r[k] for k in (
                    "carry_entry_ms", "carry_core_entry_ms", "carry_turns",
                    "carry_ms", "carry_plain_ms", "carry_bound_ms",
                    "carry_bound_by", "carry_core_bound_ms",
                    "carry_core_bound_by", "carry_plan")})
                     for sh, r in sd["tf32"]["rows"].items()],
        })
    # The SSD backward's kernels: the tensor-core pair at phase 11 (d)'s
    # shape (mamba2-780m, 2 x 4096, bf16), launched by (d); at (b)'s fp32
    # mamba2-780m step (1 x 2048) the fp32 tensor-core pair, which it
    # launched, and the CUDA-core pair timed on the same inputs, launched
    # on a main path by (b)'s 2 x 50 step.
    tiled_of = {"ssd_carry_bwd_tc": sdt, "ssd_carry_bwd_tf32": sdt32}
    for key, name, (shape, dtype), launches in (
            ("carry", "ssd_carry_bwd_tc", (SSD_TRAIN[0], "bfloat16"),
             train["ssm"]["ssd_launches"]),
            ("chunk", "ssd_chunk_bwd_tc", (SSD_TRAIN[0], "bfloat16"),
             train["ssm"]["ssd_launches"]),
            ("carry", "ssd_carry_bwd_tf32", SSD_TRAIN_F32,
             ssm_f32["ssd_launches"]),
            ("chunk", "ssd_chunk_bwd_tf32", SSD_TRAIN_F32,
             ssm_f32["ssd_launches"]),
            ("carry", "ssd_carry_bwd", SSD_TRAIN_F32,
             short["ssd_launches"]),
            ("chunk", "ssd_chunk_bwd", SSD_TRAIN_F32,
             short["ssd_launches"])):
        row = sdb["rows"][(shape, dtype)]
        tc = name.endswith("_tc")
        # The CUDA-core kernels beside the fp32 tensor-core ones.
        core = name in ("ssd_carry_bwd", "ssd_chunk_bwd")
        bnd = row["core_bound"][key] if core else row["bounds"][key]
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu",
            # No Pallas kernel: XLA's gradient of the jnp SSD.
            "replaces": "src/repro/kernels/ssd/ref.py:19",
            "tpu_kernel": False,
            # (d): one launch per layer per step; (b): one per layer.
            "launches": launches[name],
            # Phase 12 (b): one bf16 step on the one-rank mesh.
            "launches_mesh": mesh["b"]["launches"].get(name, 0),
            "max_abs_err": sdb["errs"][name],
            "ms": row["core_ms"][key] if core else row["ms"][key],
            "plain_ms": row["plain_ms"][key],
            "bound_ms": bnd[0],
            "bound_by": bnd[1],
            # Through the C entry point, in turns with the other kernel.
            **({"entry_ms": row["core_entry_ms" if core else "entry_ms"][
                key]} if "entry_ms" in row else {}),
            # No single PyTorch call computes either, or the whole
            # backward (under "backward").
            "library_ms": None,
            "shape": list(shape),
            "dtype": dtype,
            "heads_per_block": row["heads_per_block"],
            "backward": dict(ms=row["ms"]["backward"],
                             plain_ms=row["plain_ms"]["backward"],
                             bound_ms=row["bounds"]["backward"][0],
                             bound_by=row["bounds"]["backward"][1]),
            # Phase 11 (b): launches in one step per arch (and dtype).
            "launches_families": {
                a: r["ssd_launches"][name]
                for a, r in train["families"].items()
                if r["ssd_launches"][name]},
            # Phase 11 (b)'s 2 x 50 step, and phase 6 at chunks of 128,
            # 256 and 50 rows where this kernel ran.
            "launches_short": short["ssd_launches"][name],
            "chunks": bwd_chunks(key, name),
            **({# The CUDA-core kernel on the same inputs.
                "cuda_core_ms": row["core_ms"][key],
                "build": {k: v for k, v in sdb["builds"].items()
                          if k.startswith(name + "<")}}
               if tc or name.endswith("_tf32") else {}),
            # The carries at chunks of 128 to 256 rows (64-row slabs):
            # launched by phase 6's ssd() under grad at SSD_TILED, each
            # shape timed through the C entry point in turns with
            # ssd_carry_bwd.
            **({"launches_tiled": tiled_of[name]["launches"][name],
                "tiled_rows": [
                    dict(shape=list(sh), launches=v["counts"][name],
                         **v["carry_bwd"])
                    for sh, v in tiled_of[name]["rows"].items()]}
               if name in tiled_of else {}),
        })
    # The tensor-core kernels over 64 x 64 tiles at chunks of 128 to 256
    # rows, bf16 and fp32: launched by phase 6's ssd() under grad at
    # SSD_TILED (the counts set to 0 before each shape's run and read after
    # it), timed at mamba2-780m's heads in chunks of 256 rows, every
    # SSD_TILED shape under "rows".
    for name, key, source, replaces, tiled, dtype in (
            ("ssd_chunk_tc_tiled", "fwd", "ssd.cu",
             "src/repro/kernels/ssd/kernel.py:22", sdt, "bfloat16"),
            ("ssd_chunk_bwd_tc_tiled", "bwd", "ssd_bwd.cu",
             "src/repro/kernels/ssd/ref.py:19", sdt, "bfloat16"),
            ("ssd_chunk_tf32_tiled", "fwd", "ssd.cu",
             "src/repro/kernels/ssd/kernel.py:22", sdt32, "float32"),
            ("ssd_chunk_bwd_tf32_tiled", "bwd", "ssd_bwd.cu",
             "src/repro/kernels/ssd/ref.py:19", sdt32, "float32")):
        r = tiled["rows"][SSD_TILED[1]][key]
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/" + source,
            "replaces": replaces,
            **({} if key == "fwd" else {
                # No Pallas kernel: XLA's gradient of the jnp SSD.
                "tpu_kernel": False}),
            "launches": tiled["launches"][name],
            "max_abs_err": tiled["worst"][name],
            # Through the C entry point (BURST launches a window), in
            # turns with the CUDA-core kernel.
            "ms": r["entry_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "shape": list(SSD_TILED[1]),
            "dtype": dtype,
            "wrapper_ms": r["ms"],
            "cuda_core_ms": r["core_entry_ms"],
            "build": {k: v for k, v in tiled["builds"].items()
                      if k.startswith(name + "<")},
            "rows": [dict(shape=list(sh), launches=v["counts"][name],
                          **v[key]) for sh, v in tiled["rows"].items()],
            # fp32: the carry these chunks take (ssd_carry_tf32), in turns
            # with ssd_carry_kernel.
            **({"carry_rows": [dict(shape=list(sh), **v["carry"])
                               for sh, v in tiled["rows"].items()]}
               if dtype == "float32" and key == "fwd" else {}),
        })
    idle = [k["name"] for k in record["kernels"] if not k["launches"] > 0]
    if idle:
        raise AssertionError(f"kernels never launched on their main path: "
                             f"{idle}")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
