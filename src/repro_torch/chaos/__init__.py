"""Deterministic fault injection (``repro_torch.chaos``).

Adversarial-infrastructure layer for the WaaS simulator: spot/preemptible
VM revocation, per-task failure with bounded retry, and straggler
(runtime-inflation) injection — all first-class simulated events wired
through both engines (``core.engine.SimState`` transitions, driven by
``SimEngine`` and ``core.batch_engine.BatchSimEngine`` alike).

See :mod:`repro_torch.chaos.inject` for the knobs and the determinism contract,
docs/ARCHITECTURE.md § Fault model for the state transitions, and the
``online-chaos-smoke`` / ``online-chaos`` scenario families
(``repro.exp.scenarios``) for the CI-gated consumers.
"""
from .inject import (CHAOS_SEED_TAG, ChaosConfig,  # noqa: F401
                     ChaosDraws, chaos_draws)
