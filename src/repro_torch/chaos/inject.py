"""Chaos knobs and the deterministic injection draws.

Three perturbation families, one config:

* **Spot revocation** — VMs provision as spot instances at
  ``(1 - spot_discount) ×`` the on-demand price; each spot VM draws an
  exponential lifetime (mean ``1 / revocation_rate`` hours) at provision
  time and is force-terminated when it elapses.  A revocation kills the
  in-flight task (its spend so far is sunk), evicts every cache the VM
  held, requeues the task and re-runs Algorithm 3 with the wasted spend
  as *negative* surplus so the spare pool + unscheduled sub-budgets
  absorb it.  ``escalate_after=N`` switches a task's *triggered
  provisions* to on-demand (full price, non-revocable) once it has been
  preempted N times — the bounded backoff ladder.
* **Task failure** — every execution attempt flips a pre-drawn Bernoulli
  coin; a failed attempt bills its full actual cost (no refunds in
  Eq. 5), caches no output, and requeues the task through the same
  debt-absorbing path.  Attempts beyond ``max_retries`` never fail, so
  the bound also guarantees termination.
* **Stragglers** — a seeded subset of tasks runs ``straggler_slowdown ×``
  slower (compute leg only, on top of the benign CPU-degradation model);
  at finish the platform *detects* a straggler when the actual compute
  time exceeds ``straggler_factor ×`` the undegraded estimate, surfaced
  as the ``stragglers_detected`` metric and ``STRAGGLER_DETECT`` events.

Determinism contract
--------------------
Every draw is a pure function of ``(ChaosConfig, simulation seed,
stable entity id)``: task draws are pre-drawn arrays indexed by the
task's global id and attempt number (the ``degradation_tables``
pattern), VM lifetimes are keyed by vmid — and vmid allocation order is
itself deterministic and engine-independent.  The same ``(seed,
config)`` therefore yields bit-exact event streams across repeat runs,
across ``SimEngine`` vs ``BatchSimEngine``, across the SoA and object
state layouts, and through checkpoint/resume (the mutable chaos state —
attempt counters, wasted-spend tally — rides the snapshot residue;
the draws are derived state, rebuilt at construction).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

# Seed-sequence namespace tag separating the chaos streams from the
# degradation tables (which consume the bare seed).
CHAOS_SEED_TAG = 0xC8A05

# Sub-stream keys under the tag (fail / straggler / vm-lifetime).
_STREAM_FAIL, _STREAM_STRAGGLER, _STREAM_LIFETIME = 1, 2, 3

MS_PER_HOUR = 3_600_000.0


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Injection knobs; all zero ⇒ disabled (the benign default).

    ``revocation_rate`` is expected revocations per spot-VM-*hour*;
    ``fail_prob`` is per execution attempt; ``straggler_prob`` is per
    task (re-executions of a straggler task stay slow — slowness models
    the task's placement/input pathology, not a coin per attempt)."""

    spot_discount: float = 0.0      # fraction off the on-demand price
    revocation_rate: float = 0.0    # revocations per spot-VM-hour
    fail_prob: float = 0.0          # per-attempt Bernoulli failure
    max_retries: int = 3            # attempts ≥ this never fail (bounded)
    escalate_after: Optional[int] = None  # preemptions → on-demand provisions
    straggler_prob: float = 0.0     # fraction of tasks inflated
    straggler_slowdown: float = 4.0  # compute-leg runtime multiplier
    straggler_factor: float = 1.5   # detection: actual > factor × estimate
    seed: int = 0                   # chaos stream seed (xor'd with sim seed)

    def __post_init__(self) -> None:
        if not 0.0 <= self.spot_discount < 1.0:
            raise ValueError(f"spot_discount={self.spot_discount} "
                             "(expected [0, 1))")
        if self.revocation_rate < 0.0:
            raise ValueError(f"revocation_rate={self.revocation_rate} < 0")
        if not 0.0 <= self.fail_prob <= 1.0:
            raise ValueError(f"fail_prob={self.fail_prob} (expected [0, 1])")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} < 0")
        if self.escalate_after is not None and self.escalate_after < 0:
            raise ValueError(f"escalate_after={self.escalate_after} < 0")
        if not 0.0 <= self.straggler_prob <= 1.0:
            raise ValueError(f"straggler_prob={self.straggler_prob} "
                             "(expected [0, 1])")
        if self.straggler_slowdown < 1.0:
            raise ValueError(f"straggler_slowdown="
                             f"{self.straggler_slowdown} < 1")
        if self.straggler_factor < 1.0:
            raise ValueError(f"straggler_factor={self.straggler_factor} < 1")

    @property
    def enabled(self) -> bool:
        """Any injection active?  False ⇒ the engines skip every chaos
        branch (zero-cost-disabled, like ``profile``/``events``)."""
        return (self.spot_enabled or self.fail_prob > 0.0
                or self.straggler_prob > 0.0)

    @property
    def spot_enabled(self) -> bool:
        """Spot pricing/revocation active (discount without churn and
        churn without discount are both valid configurations)."""
        return self.spot_discount > 0.0 or self.revocation_rate > 0.0

    def knobs(self) -> dict:
        """JSON-ready knob dump for artifacts and reports."""
        return dataclasses.asdict(self)


class ChaosDraws:
    """Pre-drawn injection tables for one simulation (derived state:
    rebuilt bit-identically from ``(config, seed)`` — never snapshotted)."""

    __slots__ = ("cfg", "fail_u", "straggler", "_life_key", "_life_scale")

    def __init__(self, cfg: ChaosConfig, total_tasks: int, seed: int):
        self.cfg = cfg
        key = (CHAOS_SEED_TAG, cfg.seed, seed)
        # Per-(task, attempt) failure uniforms: thresholding keeps the
        # *set* of failing attempts monotone in fail_prob, and bounding
        # the table at max_retries attempts makes termination structural
        # (an attempt index past the table never fails).
        self.fail_u = (
            np.random.default_rng((*key, _STREAM_FAIL))
            .random((total_tasks, cfg.max_retries))
            if cfg.fail_prob > 0.0 and cfg.max_retries > 0
            else np.zeros((total_tasks, 0)))
        self.straggler = (
            np.random.default_rng((*key, _STREAM_STRAGGLER))
            .random(total_tasks) < cfg.straggler_prob
            if cfg.straggler_prob > 0.0
            else np.zeros(total_tasks, bool))
        self._life_key = (*key, _STREAM_LIFETIME)
        self._life_scale = (MS_PER_HOUR / cfg.revocation_rate
                            if cfg.revocation_rate > 0.0 else 0.0)

    def fails(self, gid: int, attempt: int) -> bool:
        """Does execution ``attempt`` (0-based) of global task ``gid``
        fail?  Attempts ≥ ``max_retries`` (including extra re-executions
        forced by revocations) always succeed."""
        if attempt >= self.fail_u.shape[1]:
            return False
        return bool(self.fail_u[gid, attempt] < self.cfg.fail_prob)

    def vm_lifetime_ms(self, vmid: int) -> int:
        """Exponential spot lifetime for a VM, keyed by vmid (vmids are
        append-only list indices, so the allocation order — and hence
        every lifetime — is identical across engines and layouts)."""
        rng = np.random.default_rng((*self._life_key, vmid))
        return max(1, int(math.ceil(rng.exponential(self._life_scale))))


def chaos_draws(cfg: Optional[ChaosConfig], total_tasks: int,
                seed: int) -> Optional[ChaosDraws]:
    """Build the draw tables, or None when injection is off."""
    if cfg is None or not cfg.enabled:
        return None
    return ChaosDraws(cfg, total_tasks, seed)
