"""repro_torch's params checkpoints ≡ the reference's, on the CPU.

The port's ``save_sections`` / ``restore_section`` keep the reference's
on-disk schema (one ``.npy`` per leaf, keys the ``"/"``-joined dict paths
in sorted-key order, a ``manifest.json`` with each leaf's file, shape
and dtype), so either package restores the other's checkpoints bit for
bit.  Also: roundtrip, ``prune`` and ``latest_step`` (the reference's
``tests/test_train.py`` cases, on the port), the shape-mismatch
``ValueError``, and bf16 leaves written in the reference's encoding
(numpy ``'<V2'`` words, manifest dtype ``"bfloat16"``) without
``ml_dtypes``.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.train import optim as joptim
from repro_torch import ckpt
from repro_torch.models import RunConfig, build
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optim as toptim


def _model():
    return build("llama3-8b", RunConfig(remat="none"), smoke=True,
                 device="cpu")


def _state(seed=0):
    """Port params and an opt state with non-zero moments and step 3."""
    m = _model()
    params = m.init(seed)
    opt = toptim.init_opt_state(params)
    gen = torch.Generator().manual_seed(seed + 1)
    for t in tree_leaves(opt["mu"]) + tree_leaves(opt["nu"]):
        t.copy_(torch.rand(t.shape, generator=gen))
    opt["step"] = torch.tensor(3, dtype=torch.int32)
    return params, opt


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_roundtrip(tmp_path):
    params, opt = _state()
    d = str(tmp_path)
    ckpt.save(d, 7, params, opt, extra={"note": "x"})
    assert ckpt.latest_step(d) == 7
    restored, step = ckpt.restore(d, None, params, device="cpu")
    assert step == 7
    _equal(params, restored)
    opt_r, _ = ckpt.restore(d, 7, opt, device="cpu", section="opt")
    _equal(opt, opt_r)
    assert opt_r["step"].dtype == torch.int32 and int(opt_r["step"]) == 3
    man = _manifest(d, 7)
    assert man["kind"] == "params" and man["extra"] == {"note": "x"}


def test_checkpoint_prune(tmp_path):
    params, _ = _state()
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, params)
    ckpt.prune(d, keep=2)
    assert ckpt.latest_step(d) == 4
    assert not os.path.exists(os.path.join(d, "step_00000001"))
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]


def test_restore_section_rejects_shape_mismatch(tmp_path):
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    ckpt.save(str(tmp_path), 1, params)
    bad = {"w": torch.ones((8, 4)), "b": torch.zeros((4,))}
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_section(str(tmp_path), 1, bad, "cpu", "params")


def test_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_section(str(tmp_path), None, {"w": torch.ones(1)},
                             "cpu")


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference writes params and an opt state; the port restores
    both onto its own trees, bitwise."""
    jm = jbuild("llama3-8b", JRunConfig(remat="none"), smoke=True)
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = joptim.init_opt_state(jp)
    rng = np.random.default_rng(0)
    jopt = {"mu": jax.tree.map(lambda x: jnp.asarray(
                rng.random(x.shape, np.float32)), jopt["mu"]),
            "nu": jopt["nu"], "step": jnp.asarray(5, jnp.int32)}
    d = str(tmp_path)
    jckpt.save(d, 2, jp, jopt)
    m = _model()
    tparams = m.init(1)
    topt = toptim.init_opt_state(tparams)
    got, step = ckpt.restore_section(d, None, tparams, "cpu", "params")
    assert step == 2
    _equal(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), got)
    got_opt, _ = ckpt.restore_section(d, 2, topt, "cpu", "opt")
    _equal(params_from_numpy(jax.tree.map(np.asarray, jopt), "cpu"),
           got_opt)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port writes; the reference restores, bitwise; the manifests
    of the two packages' writes of the same state agree in keys, shapes
    and dtypes."""
    params, opt = _state()
    d = str(tmp_path / "port")
    ckpt.save(d, 4, params, opt)
    jm = jbuild("llama3-8b", JRunConfig(remat="none"), smoke=True)
    jtemplate = jm.init(jax.random.PRNGKey(1))
    jparams, _ = jckpt.restore_section(d, 4, jtemplate, None, "params")
    jopt_t = joptim.init_opt_state(jtemplate)
    jopt, _ = jckpt.restore_section(d, 4, jopt_t, None, "opt")
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(opt), jax.tree.leaves(jopt)):
        assert np.asarray(b).dtype == a.numpy().dtype
        assert np.array_equal(a.numpy(), np.asarray(b))
    ref_dir = str(tmp_path / "ref")
    jckpt.save(ref_dir, 4, jparams, jopt)
    mine, theirs = _manifest(d, 4), _manifest(ref_dir, 4)
    for section in ("params", "opt"):
        assert list(mine[section]) == list(theirs[section])
        assert mine[section] == theirs[section]


def test_bf16_leaves_in_the_reference_encoding(tmp_path):
    """A bf16 leaf is written as the reference's ``np.save`` of an
    ``ml_dtypes`` bfloat16 array writes it (same bytes), and each package
    reads the other's bf16 leaf back bit for bit."""
    vals = torch.tensor([[1.5, -2.0, 3.140625], [0.0, -0.0, 65280.0]])
    tree = {"w": vals.to(torch.bfloat16), "s": torch.tensor(1.0)}
    mine = str(tmp_path / "port")
    ckpt.save(mine, 1, tree)
    jtree = {"w": jnp.asarray(vals.numpy(), jnp.bfloat16),
             "s": jnp.asarray(1.0)}
    theirs = str(tmp_path / "ref")
    jckpt.save(theirs, 1, jtree)
    m, t = _manifest(mine, 1), _manifest(theirs, 1)
    assert m["params"] == t["params"]
    assert m["params"]["w"]["dtype"] == "bfloat16"
    for name in ("params__w.npy", "params__s.npy"):
        with open(os.path.join(mine, "step_00000001", name), "rb") as f, \
                open(os.path.join(theirs, "step_00000001", name), "rb") as g:
            assert f.read() == g.read(), name
    got, _ = ckpt.restore_section(theirs, 1, tree, "cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    raw = np.load(os.path.join(mine, "step_00000001", "params__w.npy"))
    assert np.array_equal(raw.view(ml_dtypes.bfloat16).astype(np.float32),
                          vals.numpy())
