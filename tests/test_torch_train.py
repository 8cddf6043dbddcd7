"""repro_torch's training slice ≡ the reference's, on the CPU.

The reference's parameters (``m.init(PRNGKey(0))``) are carried into the
port with ``params_from_numpy``; the same seeded numpy batches go through
both.  The reference runs with ``use_pallas=False`` (it trains through
its jnp attention and SSD, which XLA differentiates) and
``scan_layers=False`` (its layers unrolled, as the port runs them), its
gradients and steps compiled with ``jax.jit``; the port's CPU path
differentiates its plain torch versions.  bf16 is compared on the dense
arch only: inside compiled code XLA may keep bf16 intermediates in fp32,
which moves a bf16 MoE router onto other experts (see
``tests/test_torch_transformer.py``); the dense arch stays within the
bf16 bars below with half their width to spare.

Compared:

* ``lr_schedule`` within 1 fp32 ulp (both evaluate the same fp32
  expression; ``cos`` may round apart by one ulp); ``global_norm`` and
  one ``adamw_update`` (params, mu, nu, step) within 1e-6 relative
  (fp32 sums in another order);
* ``loss_and_grads`` for all ten archs in fp32 compute: the loss and
  every gradient leaf within 1e-4·max(max|ref|, 1) of
  ``jax.value_and_grad(model.loss)`` (fp32 sums in another order; the
  MoE archs route alike in fp32);
* llama3-8b in bf16 compute: every gradient leaf within
  ``BF16_GRAD``·max|ref| of the leaf, the loss within 2e-2 relative.
  bf16 rounds at other places in the two frameworks, and the
  reference's ``_sdpa_ref`` rounds p to bf16 before p·v where the port's
  plain attention keeps p in fp32 (``kernels/flash_attention/ref.py``);
* 8 steps of ``make_train_step`` on llama3-8b smoke (the reference
  test's ``tiny_batch``, ``RunConfig(remat="none", learning_rate=1e-3)``)
  in fp32 and bf16 compute, losses and final params (bars at the tests;
  in bf16 the parameter update is held on its own scale, and the test
  shows that params left unchanged fail it); ``microbatch=2`` against
  the reference's accumulation path; ``cast_params_once``: its
  gradients leaf by leaf against ``jax.value_and_grad`` of the
  reference's casting loss, and eight steps;
* the remat policies none, dots and full give equal gradients in the
  port (bit for bit: recomputation repeats the same CPU ops);
* the port's own versions of the reference's ``test_loss_decreases`` and
  ``test_grad_accumulation_equivalence``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.train import optim as joptim
from repro.train.train_step import loss_and_grads as j_loss_and_grads
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.models import RunConfig, build
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optim as toptim
from repro_torch.train.train_step import (cast_loss_and_grads,
                                          loss_and_grads, make_train_step)

ARCHS = ("llama3-8b", "qwen2-moe-a2.7b", "hubert-xlarge", "internvl2-1b",
         "qwen3-32b", "moonshot-v1-16b-a3b", "phi3-medium-14b",
         "deepseek-coder-33b", "zamba2-1.2b", "mamba2-780m")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, L = 2, 32
# bf16 compute: a gradient leaf within this share of its largest
# element (see the module docstring for why bf16 differs).
BF16_GRAD = 2e-2


def _np(x):
    if hasattr(x, "dtype") and x.dtype == jnp.bfloat16:
        return np.asarray(jnp.asarray(x, jnp.float32))
    return np.asarray(x)


def _tnp(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _jleaves(tree):
    return [_np(x) for x in jax.tree.leaves(tree)]


def _tleaves(tree):
    return [_tnp(x) for x in tree_leaves(tree)]


def _keys(tree):
    return ["/".join(str(getattr(p, "key", p)) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _init(arch):
    """The reference's ``init(PRNGKey(0))`` of an arch's smoke config, as
    numpy (it does not depend on the run config); drawn once per
    module."""
    jm = jbuild(arch, JRunConfig(), smoke=True)
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _pair(arch, dtype_name="float32", run=None, jrun=None):
    """(reference model, its params as numpy, port model)."""
    jdt, tdt = DTYPES[dtype_name]
    jrun = (jrun or JRunConfig(remat="none")).with_(
        use_pallas=False, scan_layers=False, compute_dtype=jdt)
    run = (run or RunConfig(remat="none")).with_(compute_dtype=tdt)
    jm = jbuild(arch, jrun, smoke=True)
    tm = build(arch, run, smoke=True, device="cpu")
    return jm, _init(arch), tm


def _tp(jp):
    return params_from_numpy(jp, device="cpu")


def _batch(cfg, seed=7):
    """Seeded numpy inputs of one family: tokens (and labels), audio
    frames, VLM patches; a mask for the loss."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    batch = {"labels": toks, "mask": rng.random((B, L)) < 0.8}
    if cfg.frame_dim:
        batch["frames"] = rng.normal(size=(B, L, cfg.frame_dim)) \
            .astype(np.float32)
    else:
        batch["tokens"] = toks
    if cfg.n_patches:
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return batch


def tiny_batch(step=0, B=4, L=32):
    """The reference test's batch (tests/test_train.py::tiny_batch)."""
    rng = np.random.default_rng(step)
    toks = rng.integers(0, 16, (B, L)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(ref, got, tol, what):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max|Δ| {err:.3g} > {tol:.3g}"


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10000])
def test_lr_schedule_matches_reference(step):
    ref = np.float32(joptim.lr_schedule(jnp.asarray(step), 1e-3))
    got = np.float32(toptim.lr_schedule(torch.tensor(step), 1e-3))
    ulp = np.spacing(np.abs(ref)) if ref != 0 else np.float32(0)
    assert abs(float(got) - float(ref)) <= float(ulp), (step, ref, got)


def _grad_like(jp, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.normal(size=x.shape) * 0.05).astype(np.float32), jp)


def test_global_norm_matches_reference():
    _, jp, _ = _pair("llama3-8b")
    g = _grad_like(jp, 1)
    ref = float(jax.jit(joptim.global_norm)(jax.tree.map(jnp.asarray, g)))
    got = float(toptim.global_norm(_tp(g)))
    assert got == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    """Two updates from the same params, grads and state (the second from
    non-zero moments); ``clip`` 1.0 clips, 100.0 does not."""
    run = RunConfig(learning_rate=1e-3, grad_clip=clip)
    jrun = JRunConfig(learning_rate=1e-3, grad_clip=clip)
    _, jp, _ = _pair("llama3-8b")
    jparams = jax.tree.map(jnp.asarray, jp)
    jopt = joptim.init_opt_state(jparams)
    tparams = _tp(jp)
    topt = toptim.init_opt_state(tparams)
    jupdate = jax.jit(joptim.adamw_update, static_argnums=3)
    for seed in (1, 2):
        g = _grad_like(jp, seed)
        jparams, jopt, jm = jupdate(jparams, jax.tree.map(jnp.asarray, g),
                                    jopt, jrun)
        tparams, topt, tm = toptim.adamw_update(tparams, _tp(g), topt, run)
    assert int(topt["step"]) == int(jopt["step"]) == 2
    assert topt["step"].dtype == torch.int32 and topt["step"].dim() == 0
    for what, ref, got in (("params", jparams, tparams),
                           ("mu", jopt["mu"], topt["mu"]),
                           ("nu", jopt["nu"], topt["nu"])):
        for k, r, t in zip(_keys(ref), _jleaves(ref), _tleaves(got)):
            _close(r, t, 1e-6 * max(np.abs(r).max(), 1e-30),
                   f"{what}/{k}")
    for key in ("grad_norm", "lr"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def _grads_pair(arch, dtype_name):
    """The reference's gradients (compiled) and the port's."""
    jm, jp, tm = _pair(arch, dtype_name)
    batch = _batch(jm.cfg)
    jloss, jmet, jg = jax.jit(functools.partial(j_loss_and_grads, jm))(
        jax.tree.map(jnp.asarray, jp), _j(batch))
    tloss, tmet, tg = loss_and_grads(tm, _tp(jp), _t(batch))
    return jloss, jg, tloss, tg


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_fp32(arch):
    jloss, jg, tloss, tg = _grads_pair(arch, "float32")
    _close(_np(jloss), _tnp(tloss), 1e-4 * max(abs(float(jloss)), 1.0),
           "loss")
    assert _keys(jg) == sorted(_keys(jg))
    for k, r, t in zip(_keys(jg), _jleaves(jg), _tleaves(tg)):
        _close(r, t, 1e-4 * max(np.abs(r).max(), 1.0), f"grad {k}")


def test_loss_and_grads_match_reference_bf16():
    jloss, jg, tloss, tg = _grads_pair("llama3-8b", "bfloat16")
    _close(_np(jloss), _tnp(tloss), 2e-2 * abs(float(jloss)), "loss")
    for k, r, t in zip(_keys(jg), _jleaves(jg), _tleaves(tg)):
        _close(r, t, BF16_GRAD * np.abs(r).max(), f"grad {k}")


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

RUN = RunConfig(remat="none", learning_rate=1e-3)
JRUN = JRunConfig(remat="none", learning_rate=1e-3)


def _steps(jm, tm, jp, batches):
    """The reference's and the port's train step over ``batches`` from
    the same params: (ref losses, ref params, port losses, port params,
    port opt).  The reference's step is compiled."""
    jstep = jax.jit(j_make_train_step(jm))
    jparams = jax.tree.map(jnp.asarray, jp)
    jopt = joptim.init_opt_state(jparams)
    tstep = make_train_step(tm)
    tparams = _tp(jp)
    topt = toptim.init_opt_state(tparams)
    jl, tl = [], []
    for b in batches:
        jparams, jopt, jmet = jstep(jparams, jopt, _j(b))
        tparams, topt, tmet = tstep(tparams, topt, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    assert int(topt["step"]) == int(jopt["step"]) == len(batches)
    return jl, jparams, tl, tparams, topt


def _lr_sum(n, base=1e-3):
    return sum(float(joptim.lr_schedule(jnp.asarray(s), base))
               for s in range(1, n + 1))


def _update_err(p0, ref, got):
    """Per leaf, |Δgot − Δref|₂ / |Δref|₂ with Δ = params − ``p0``, the
    worst leaf's: how far the port's parameter update lies from the
    reference's, on the scale of the update itself.  A run that leaves
    the params unchanged scores 1."""
    worst = 0.0
    for k, a, r, t in zip(_keys(ref), _jleaves(p0), _jleaves(ref),
                          _tleaves(got)):
        a = np.asarray(a, np.float64)
        dr = np.asarray(r, np.float64) - a
        dt = np.asarray(t, np.float64) - a
        worst = max(worst, float(np.linalg.norm(dt - dr)
                                 / np.linalg.norm(dr)))
    return worst


# bf16 parameter updates: within this share of the reference's update,
# leaf by leaf (``_update_err``).  An Adam step in warm-up moves each
# parameter by about ±lr_t whatever its gradient's size, so an absolute
# bar on the params would have to exceed Σ lr_t, which a step that never
# updates also meets; measured on the update's own scale the two runs
# differ by 1.7e-2 at most (elements whose bf16 gradients straddle 0 take
# Adam steps of the other sign), and a run without updates by 1.
BF16_UPDATE = 5e-2

# (loss bar relative, param check) by compute dtype.  fp32: sums in
# another order, 1e-5 relative on the loss and 1e-5 absolute on params
# (8 warm-up steps move a parameter by up to Σ lr_t = 3.6e-4).  bf16: the
# losses within 2e-3 relative (4e-5 measured; 8 steps lower the loss by
# 4e-2 relative, so a run that does not learn fails), the update within
# BF16_UPDATE.
TRAJECTORY = {"float32": 1e-5, "bfloat16": 2e-3}


def _check_params(dtype_name, jp, jparams, tparams, what):
    if dtype_name == "float32":
        for k, r, t in zip(_keys(jparams), _jleaves(jparams),
                           _tleaves(tparams)):
            _close(r, t, 1e-5, f"param {k} {what}")
        return
    err = _update_err(jp, jparams, tparams)
    assert err <= BF16_UPDATE, f"params {what}: update off by {err:.3g}"


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_trajectory_matches_reference(dtype_name):
    jm, jp, tm = _pair("llama3-8b", dtype_name, RUN, JRUN)
    n = 8
    jl, jparams, tl, tparams, _ = _steps(jm, tm, jp, [tiny_batch(0)] * n)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert b == pytest.approx(a, rel=TRAJECTORY[dtype_name]), \
            (i, jl, tl)
    _check_params(dtype_name, jp, jparams, tparams, f"after {n} steps")
    # The checks can tell: params left where they started fail them.
    assert not tl[-1] == pytest.approx(jl[0], rel=TRAJECTORY[dtype_name])
    with pytest.raises(AssertionError):
        _check_params(dtype_name, jp, jparams, _tp(jp), "never updated")


def test_microbatch_matches_reference_accumulation():
    """``microbatch=2``: the reference's Python-loop accumulation (its
    ``scan_layers=False`` branch), fp32; the aux loss is dropped from the
    metrics in both."""
    run = RUN.with_(microbatch=2)
    jm, jp, tm = _pair("qwen2-moe-a2.7b", "float32", run,
                       JRUN.with_(microbatch=2))
    jl, jparams, tl, tparams, _ = _steps(jm, tm, jp,
                                         [tiny_batch(3), tiny_batch(4)])
    assert tl == pytest.approx(jl, rel=1e-5)
    for k, r, t in zip(_keys(jparams), _jleaves(jparams),
                       _tleaves(tparams)):
        _close(r, t, 1e-5, f"param {k}")
    m = make_train_step(tm)
    p = _tp(jp)
    _, _, met = m(p, toptim.init_opt_state(p), tiny_batch(3))
    assert set(met) == {"loss", "grad_norm", "lr"}


def _j_cast_loss_and_grads(jm, params, batch):
    """The reference step's ``cast_params_once`` loss (its ``lf``: the
    floating leaves cast to the compute dtype inside the grad) and its
    ``jax.value_and_grad``, compiled."""
    dt = jm.run.compute_dtype

    def lf(p32):
        pc = jax.tree.map(lambda x: x.astype(dt)
                          if jnp.issubdtype(x.dtype, jnp.floating) else x,
                          p32)
        return jm.loss(pc, batch)
    (loss, _), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(params)
    return loss, grads


def test_cast_params_once_matches_reference():
    """One bf16 tree-cast at step entry, differentiated through: the
    loss and every fp32 gradient leaf against ``jax.value_and_grad`` of
    the reference's casting loss at the bf16 bars of
    ``test_loss_and_grads_match_reference_bf16``, then eight steps of each
    train step at the bf16 trajectory bars (fp32 params)."""
    run = RUN.with_(cast_params_once=True)
    jm, jp, tm = _pair("llama3-8b", "bfloat16", run,
                       JRUN.with_(cast_params_once=True))
    batch = _batch(jm.cfg)
    jloss, jg = _j_cast_loss_and_grads(jm, jax.tree.map(jnp.asarray, jp),
                                       _j(batch))
    tloss, _, tg = cast_loss_and_grads(tm, _tp(jp), _t(batch))
    _close(_np(jloss), _tnp(tloss), 2e-2 * abs(float(jloss)), "loss")
    for k, r, t in zip(_keys(jg), _jleaves(jg), tree_leaves(tg)):
        assert t.dtype == torch.float32, k
        _close(r, _tnp(t), BF16_GRAD * np.abs(r).max(), f"grad {k}")
    n = 8
    jl, jparams, tl, tparams, _ = _steps(jm, tm, jp, [tiny_batch(0)] * n)
    assert tl == pytest.approx(jl, rel=TRAJECTORY["bfloat16"])
    for k, r, t in zip(_keys(jparams), _jleaves(jparams),
                       _tleaves(tparams)):
        assert r.dtype == np.float32 and t.dtype == np.float32, k
    _check_params("bfloat16", jp, jparams, tparams, f"after {n} steps")
    bad = build("llama3-8b", run.with_(microbatch=2), smoke=True,
                device="cpu")
    p = bad.init(0)
    with pytest.raises(ValueError, match="not combined"):
        make_train_step(bad)(p, toptim.init_opt_state(p), tiny_batch(0))


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "zamba2-1.2b"])
def test_remat_policies_give_equal_grads(arch, remat):
    """Recomputation repeats the same CPU ops on the same inputs: the
    gradients equal remat="none"'s bit for bit."""
    jm, jp, _ = _pair(arch)
    batch = _t(_batch(jm.cfg))
    grads = {}
    for policy in ("none", remat):
        tm = build(arch, RunConfig(remat=policy, compute_dtype=torch.float32),
                   smoke=True, device="cpu")
        loss, _, g = loss_and_grads(tm, _tp(jp), batch)
        grads[policy] = (loss, tree_leaves(g))
    assert torch.equal(grads["none"][0], grads[remat][0])
    for a, b in zip(grads["none"][1], grads[remat][1]):
        assert torch.equal(a, b)


def test_train_step_with_a_mesh_raises():
    """A mesh must be a ``DeviceMesh``: anything else is refused."""
    tm = build("llama3-8b", RUN, smoke=True, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(tm, mesh=object())


def test_unknown_remat_policy_raises():
    tm = build("llama3-8b", RUN.with_(remat="some"), smoke=True,
               device="cpu")
    p = tm.init(0)
    with pytest.raises(ValueError, match="remat"):
        loss_and_grads(tm, p, _t(tiny_batch(0)))


# The reference's own training tests, on the port.

def test_loss_decreases():
    m = build("llama3-8b", RUN, smoke=True, device="cpu")
    params = m.init(0)
    opt = toptim.init_opt_state(params)
    step = make_train_step(m)
    losses = []
    for _ in range(16):
        params, opt, metrics = step(params, opt, tiny_batch(0))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses
    assert int(opt["step"]) == 16


def test_grad_accumulation_equivalence():
    m1 = build("llama3-8b", RUN, smoke=True, device="cpu")
    m2 = build("llama3-8b", RUN.with_(microbatch=2), smoke=True,
               device="cpu")
    params = m1.init(1)
    b = tiny_batch(3)
    clone = lambda t: {k: clone(v) if isinstance(v, dict)  # noqa: E731
                       else v.clone() for k, v in t.items()}
    p1, _, _ = make_train_step(m1)(clone(params),
                                   toptim.init_opt_state(params), b)
    p2, _, _ = make_train_step(m2)(clone(params),
                                   toptim.init_opt_state(params), b)
    d = max(float((a - c).abs().max())
            for a, c in zip(tree_leaves(p1), tree_leaves(p2)))
    assert d < 5e-3   # accumulation ≈ full batch
