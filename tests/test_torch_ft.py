"""repro_torch's ``FaultyTrainer`` ≡ the reference's, on the CPU.

Both draw their failures from the same numpy generator, so with the
reference tests' plans (``tests/test_train.py``: fail_prob 0.25 seed 1,
0.3 seed 5, 0.35 seed 7) they must fail at the same steps, restart as
often, and end with the same history of steps; each side checkpoints
into its own directory and restores from it.  Both train llama3-8b smoke
from the reference's ``init(PRNGKey(0))`` on the reference test's
``tiny_batch``, in fp32 compute (``remat="none"``, lr 1e-3), so the
losses agree within 1e-5 relative (fp32 sums in another order) and
the final params within 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft.faults import FaultPlan as JFaultPlan
from repro.ft.faults import FaultyTrainer as JFaultyTrainer
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.train import optim as joptim
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.ft.faults import FaultPlan, FaultyTrainer, StepFailure
from repro_torch.models import RunConfig, build
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optim as toptim
from repro_torch.train.train_step import make_train_step

RUN = RunConfig(remat="none", learning_rate=1e-3,
                compute_dtype=torch.float32)
JRUN = JRunConfig(remat="none", learning_rate=1e-3, scan_layers=False,
                  compute_dtype=jnp.float32)
# (fail_prob, seed, ckpt_every, keep, n_steps): the reference tests'.
PLANS = [(0.25, 1, 3, 2, 15), (0.3, 5, 4, 2, 12), (0.35, 7, 2, 3, 10)]


def tiny_batch(step=0, B=4, L=32):
    """The reference test's batch (tests/test_train.py::tiny_batch)."""
    rng = np.random.default_rng(step)
    toks = rng.integers(0, 16, (B, L)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's params (``init(PRNGKey(0))``) and its compiled
    train step, shared by the plans."""
    jm = jbuild("llama3-8b", JRUN, smoke=True)
    return (jm.init(jax.random.PRNGKey(0)),
            jax.jit(j_make_train_step(jm)))


def _reference_run(plan, tmp):
    fail_prob, seed, every, keep, n = plan
    jp, jstep = _reference()
    tr = JFaultyTrainer(tmp, JFaultPlan(fail_prob=fail_prob, seed=seed,
                                        ckpt_every=every, keep=keep))
    batch = {k: jnp.asarray(v) for k, v in tiny_batch(0).items()}
    params, opt, hist = tr.run(params=jp, opt=joptim.init_opt_state(jp),
                               n_steps=n, step_fn=jstep,
                               batch_fn=lambda s: batch)
    return (jax.tree.map(np.asarray, jp), tr.restarts,
            list(tr.failed_steps), hist, jax.tree.map(np.asarray, params),
            int(opt["step"]))


@pytest.mark.parametrize("plan", PLANS)
def test_failure_pattern_matches_reference(plan, tmp_path):
    fail_prob, seed, every, keep, n = plan
    jp, restarts, failed, jhist, jparams, jstep = _reference_run(
        plan, str(tmp_path / "ref"))
    assert restarts > 0, "fault injection never fired"
    m = build("llama3-8b", RUN, smoke=True, device="cpu")
    params = params_from_numpy(jp, device="cpu")
    tr = FaultyTrainer(str(tmp_path / "port"),
                       FaultPlan(fail_prob=fail_prob, seed=seed,
                                 ckpt_every=every, keep=keep))
    params, opt, hist = tr.run(params=params,
                               opt=toptim.init_opt_state(params),
                               n_steps=n, step_fn=make_train_step(m),
                               batch_fn=lambda s: tiny_batch(0),
                               device="cpu")
    assert tr.restarts == restarts
    assert tr.failed_steps == failed
    assert hist["step"] == jhist["step"]
    assert hist["loss"] == pytest.approx(jhist["loss"], rel=1e-5)
    assert int(opt["step"]) == jstep >= n
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5
    assert hist["loss"][-1] < hist["loss"][0]


def test_faulty_trainer_history_rolls_back_with_restart(tmp_path):
    """A restart truncates history to the restore point: the final
    history is exactly one entry per step with no duplicates from
    re-executed (abandoned-lineage) steps (the reference's test, on the
    port)."""
    m = build("llama3-8b", RUN, smoke=True, device="cpu")
    params = m.init(0)
    tr = FaultyTrainer(str(tmp_path), FaultPlan(fail_prob=0.3, seed=5,
                                                ckpt_every=4, keep=2))
    params, opt, hist = tr.run(params=params,
                               opt=toptim.init_opt_state(params),
                               n_steps=12, step_fn=make_train_step(m),
                               batch_fn=lambda s: tiny_batch(0),
                               device="cpu")
    assert tr.restarts > 0, "fault injection never fired — raise fail_prob"
    assert hist["step"] == list(range(12))
    assert len(hist["loss"]) == len(hist["step"])


def test_injected_failure_is_a_step_failure():
    tr = FaultyTrainer("/nonexistent", FaultPlan(fail_prob=1.0))
    with pytest.raises(StepFailure, match="step 3"):
        tr.maybe_fail(3)
    assert tr.failed_steps == [3]
