"""Time the SSD models' main paths of two checkouts, in turns, on one card.

``python tools/ssd_e2e_ab.py --old DIR [--reps 5] [--steps 12]``

``DIR`` is the root of another checkout (for example a ``git archive`` of
the parent commit).  The script runs itself four times as a child
process, on ``DIR/src``, then this checkout's ``src``, this one's again,
then ``DIR/src`` (old, new, new, old), each building its own kernels.  A
child measures, with seeded weights and synchronised host clocks:

* zamba2-1.2b served at full width: prefill of 4 x 2048 tokens, and of
  one 32,768-token prompt;
* mamba2-780m served at full width and depth: prefill of 4 x 2048;
* mamba2-780m trained at full width and depth (48 layers), bf16 compute,
  remat "dots", 2 x 4096 tokens a step (``data.pipeline.batch_at``).

Each is warmed up once, then taken ``--reps`` times (the train step
``--steps`` times: its host-clock time moves more); the child prints one
JSON line of its times (s).  The parent prints the card's name and
power limit, each child's medians and, per path, the new checkout's
median over the old one's.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROMPT, LONG_PROMPT = (4, 2048), (1, 32768)
TRAIN = ("mamba2-780m", 2, 4096)


def prefill_times(torch, arch: str, reps: int, prompt=PROMPT) -> list:
    from repro_torch.models import build
    from repro_torch.serve.serve_step import build_prefill
    model = build(arch, device="cuda")
    params = model.init(0)
    B, L = prompt
    prefill = build_prefill(model, "prefill_32k", device=model.device,
                            max_seq=L)
    gen = torch.Generator().manual_seed(L)
    prompt = {"tokens": torch.randint(0, model.cfg.vocab, (B, L),
                                      dtype=torch.int64, generator=gen)}
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill(params, prompt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{arch}: non-finite prefill logits")
    del model, params, logits
    torch.cuda.empty_cache()
    return times[1:]


def step_times(torch, reps: int) -> list:
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import RunConfig, build
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import make_train_step
    arch, B, L = TRAIN
    run = RunConfig(remat="dots", compute_dtype=torch.bfloat16)
    model = build(arch, run, device="cuda")
    params = model.init(0)
    opt = init_opt_state(params)
    step = make_train_step(model)
    dc = DataConfig(seed=0, seq_len=L, global_batch=B)
    times = []
    for s in range(reps + 1):
        batch = batch_at(dc, s, model.cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not math.isfinite(float(met["loss"])):
        raise AssertionError(f"{arch}: non-finite loss")
    del model, params, opt
    torch.cuda.empty_cache()
    return times[1:]


def child(reps: int, steps: int) -> int:
    import torch
    out = {"zamba2-1.2b prefill": prefill_times(torch, "zamba2-1.2b", reps),
           "zamba2-1.2b 32k prefill": prefill_times(torch, "zamba2-1.2b",
                                                    reps, LONG_PROMPT),
           "mamba2-780m prefill": prefill_times(torch, "mamba2-780m", reps),
           "mamba2-780m step": step_times(torch, steps)}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, str(args.child.resolve()))
        return child(args.reps, args.steps)
    if args.old is None:
        ap.error("--old is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    srcs = {"old": args.old.resolve() / "src", "new": ROOT / "src"}
    runs = {"old": [], "new": []}
    for tag in ("old", "new", "new", "old"):
        env = dict(os.environ, PYTHONPATH=str(srcs[tag]))
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(srcs[tag]), "--reps", str(args.reps), "--steps",
             str(args.steps)],
            capture_output=True, text=True, env=env, cwd=srcs[tag].parent)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            raise SystemExit(f"{tag} child failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tag].append(res)
        print(f"{tag}: " + "; ".join(
            f"{k} median {statistics.median(v):.5f} s of "
            f"{', '.join(f'{t:.5f}' for t in v)}" for k, v in res.items()),
            flush=True)
    for key in runs["old"][0]:
        med = {tag: statistics.median(t for r in runs[tag] for t in r[key])
               for tag in runs}
        low = {tag: min(t for r in runs[tag] for t in r[key])
               for tag in runs}
        print(f"{key}: median old {med['old']:.5f} s, new {med['new']:.5f} "
              f"s, new / old {med['new'] / med['old']:.4f}; fastest old "
              f"{low['old']:.5f} s, new {low['new']:.5f} s, new / old "
              f"{low['new'] / low['old']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
