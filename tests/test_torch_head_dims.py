"""repro_torch's dense model at head dims the kernels' old domain refused
(96 and 256) ≡ the reference's, on the CPU.

llama3-8b's smoke config with its attention's head geometry replaced by
``dataclasses.replace`` on each framework's ``ModelConfig`` (a config
both take, not a new arch): 4 query heads of 96 over 1 kv head
(Phi-3-mini's head width, 32 heads of 96) and 2 heads of 256 over 1
(Gemma-7B's, 16 heads of 256).  The reference's parameters
(``init(PRNGKey(0))`` of the replaced config) are carried into the port
with ``params_from_numpy``; the same seeded numpy batch goes through
both.  The reference runs ``use_pallas=False, scan_layers=False`` (its
jnp attention, layers unrolled, as the port runs them), its gradients
compiled with ``jax.jit``; the port's CPU path runs and differentiates
its plain attention.

Bars, as ``tests/test_torch_transformer.py``'s and
``tests/test_torch_train.py``'s: in fp32 compute the logits, the loss
and every gradient leaf within 1e-4·max(max|ref|, 1); in bf16 the logits
within 2e-2·max(max|ref|, 1), the loss within 2e-2 relative and each
gradient leaf within 2e-2·max|ref| of the leaf (bf16 rounds at other
places in the two frameworks).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.train.train_step import loss_and_grads as j_loss_and_grads
from repro_torch.models import RunConfig, build
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.train_step import loss_and_grads

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (query heads, kv heads, head dim) replacing the smoke config's 4/1 x 32.
HEADS = {"hd96": (4, 1, 96), "hd256": (2, 1, 256)}
B, L = 2, 32
BF16_REL = 2e-2


def _np(x):
    if hasattr(x, "dtype") and x.dtype == jnp.bfloat16:
        return np.asarray(jnp.asarray(x, jnp.float32))
    return np.asarray(x)


def _tnp(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _keys(tree):
    return ["/".join(str(getattr(p, "key", p)) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _pair(heads, dtype_name):
    """(reference model, its params as numpy, port model, its params)."""
    jdt, tdt = DTYPES[dtype_name]
    n_heads, n_kv, hd = HEADS[heads]
    jm = jbuild("llama3-8b", JRunConfig(remat="none", use_pallas=False,
                                        scan_layers=False,
                                        compute_dtype=jdt), smoke=True)
    jm = dataclasses.replace(jm, cfg=dataclasses.replace(
        jm.cfg, n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd))
    tm = build("llama3-8b", RunConfig(remat="none", compute_dtype=tdt),
               smoke=True, device="cpu")
    tm = dataclasses.replace(tm, cfg=dataclasses.replace(
        tm.cfg, n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, jp, tm, params_from_numpy(jp, device="cpu")


def _batch(vocab, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, L)).astype(np.int32)
    return {"tokens": toks, "labels": toks, "mask": rng.random((B, L)) < 0.8}


def _close(ref, got, tol, what):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max())
    assert err <= tol, f"{what}: max|Δ| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("heads", list(HEADS))
def test_config_takes_the_head_geometry(heads, dtype_name):
    """Both frameworks' models carry the replaced heads: the port's
    attention projections are [d_model, H·D] wide and its parameter tree
    and shapes are the reference's."""
    jm, jp, tm, tp = _pair(heads, dtype_name)
    n_heads, n_kv, hd = HEADS[heads]
    assert tm.cfg.hd == jm.cfg.hd == hd
    assert tm.n_params() == jm.n_params()
    assert _keys(jp) == sorted(_keys(jp))
    for key, r, t in zip(_keys(jp), jax.tree.leaves(jp), tree_leaves(tp)):
        assert tuple(r.shape) == tuple(t.shape), key


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("heads", list(HEADS))
def test_forward_matches_reference(heads, dtype_name):
    jm, jp, tm, tp = _pair(heads, dtype_name)
    batch = _batch(jm.cfg.vocab)
    ref = _np(jm.forward(jax.tree.map(jnp.asarray, jp),
                         {"tokens": jnp.asarray(batch["tokens"])}))
    got = tm.forward(tp, {"tokens": torch.from_numpy(batch["tokens"])})
    assert got.dtype == DTYPES[dtype_name][1]
    rel = 1e-4 if dtype_name == "float32" else BF16_REL
    _close(ref, _tnp(got), rel * max(np.abs(ref).max(), 1.0),
           "forward logits")


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("heads", list(HEADS))
def test_loss_and_grads_match_reference(heads, dtype_name):
    jm, jp, tm, tp = _pair(heads, dtype_name)
    batch = _batch(jm.cfg.vocab)
    jloss, _, jg = jax.jit(functools.partial(j_loss_and_grads, jm))(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _, tg = loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    if dtype_name == "float32":
        _close(_np(jloss), _tnp(tloss), 1e-4 * max(abs(float(jloss)), 1.0),
               "loss")
    else:
        _close(_np(jloss), _tnp(tloss), BF16_REL * abs(float(jloss)), "loss")
    for key, r, t in zip(_keys(jg), jax.tree.leaves(jg), tree_leaves(tg)):
        r = _np(r)
        tol = (1e-4 * max(np.abs(r).max(), 1.0) if dtype_name == "float32"
               else BF16_REL * np.abs(r).max())
        _close(r, _tnp(t), tol, f"grad {key}")
