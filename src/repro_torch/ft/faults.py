"""Fault tolerance: failure injection, restart loop, straggler model.

The paper explicitly defers task failure to future work; we implement it
as a beyond-paper feature at two levels:

1. **Training level** — ``FaultyTrainer`` wraps a train loop with
   (a) periodic async-ish checkpointing, (b) injected step failures
   (probability per step), (c) restart-from-latest with elastic
   re-shard: the restore may target a different mesh.
2. **Scheduler level** — the WaaS simulator can mark tasks failed at
   runtime; EBPSM re-queues them and the budget-update loop (Alg. 3)
   absorbs the wasted cost exactly like any other uncertainty.  Straggler
   mitigation reuses the paper's own mechanism: a task whose actual
   runtime exceeds ``straggler_factor ×`` estimate triggers sub-budget
   re-distribution for its successors onto faster VMs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np

from .. import ckpt


@dataclasses.dataclass
class FaultPlan:
    fail_prob: float = 0.0          # per-step failure probability
    seed: int = 0
    ckpt_every: int = 10
    keep: int = 2


class StepFailure(RuntimeError):
    pass


class FaultyTrainer:
    """Drives (train_step, state) with failure injection + restart."""

    def __init__(self, ckpt_dir: str, plan: FaultPlan):
        self.ckpt_dir = ckpt_dir
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.restarts = 0
        self.failed_steps: list[int] = []

    def maybe_fail(self, step: int) -> None:
        if self.rng.random() < self.plan.fail_prob:
            self.failed_steps.append(step)
            raise StepFailure(f"injected failure at step {step}")

    def run(self, *, params, opt, n_steps: int, step_fn: Callable,
            batch_fn: Callable[[int], Any], device=None,
            start_step: int = 0, mesh=None, shardings=None,
            opt_shardings=None):
        """Returns (params, opt, history).  ``step_fn(params,opt,batch)``.

        A restart restores params and opt from the latest checkpoint onto
        ``device`` (``None`` means ``"cuda"``) or, with ``mesh``, split
        onto it: params by ``shardings`` and opt by ``opt_shardings``
        (trees of placement lists, as ``train_step.build_train_step``
        returns them; the reference restores opt unsharded, which on a
        mesh here means replicated).  Under a process group every rank
        runs this loop with the same plan, so all fail and restart at
        the same steps.  ``step_fn`` may update params and opt in place
        (``train_step.make_train_step`` does): a restart replaces both
        with the restored trees, and a failure is injected before the
        step runs, so no half-applied update survives."""
        history: Dict[str, list] = {"loss": [], "step": []}
        step = start_step
        while step < n_steps:
            try:
                self.maybe_fail(step)
                params, opt, metrics = step_fn(params, opt, batch_fn(step))
                history["loss"].append(float(metrics["loss"]))
                history["step"].append(step)
                step += 1
                if step % self.plan.ckpt_every == 0:
                    ckpt.save_sections(self.ckpt_dir, step,
                                       {"params": params, "opt": opt})
                    ckpt.prune(self.ckpt_dir, self.plan.keep)
            except StepFailure:
                self.restarts += 1
                last = ckpt.latest_step(self.ckpt_dir)
                restore_to = start_step if last is None else last
                # Roll the history back with the parameters: entries at
                # or past the restore point are about to be re-executed
                # and would otherwise appear twice (and the final
                # history would carry losses from abandoned lineages).
                # Steps ascend, so one reverse scan finds the cut.
                cut = len(history["step"])
                while cut > 0 and history["step"][cut - 1] >= restore_to:
                    cut -= 1
                del history["step"][cut:]
                del history["loss"][cut:]
                if last is None:     # no checkpoint yet → restart from init
                    step = start_step
                    continue
                params, _ = ckpt.restore_section(
                    self.ckpt_dir, last, params, device, "params",
                    **self._onto(mesh, shardings, params))
                opt, _ = ckpt.restore_section(
                    self.ckpt_dir, last, opt, device, "opt",
                    **self._onto(mesh, opt_shardings, opt))
                step = last
        return params, opt, history

    @staticmethod
    def _onto(mesh, shardings, template) -> Dict[str, Any]:
        """restore_section's mesh keywords: a missing placement tree
        means replicated leaves."""
        if mesh is None:
            return {}
        if shardings is None:
            from ..models.common import tree_map
            from ..parallel.sharding import replicated
            shardings = tree_map(lambda _: replicated(mesh), template)
        return {"mesh": mesh, "placements": shardings}
