"""repro_torch's parallelism against the reference, on the CPU.

Single-process cases hold the port's rule tables, ``logical_to_pspec``,
``input_axes`` / ``state_axes``, placements, int8 quantization, partial
attention and roofline against the reference on the same inputs.

The mesh cases run in one 8-rank gloo group (a 2 × 4 ``("data",
"model")`` mesh), spawned once for the module by ``mesh_run``: each rank
runs ``_torch_parallel_worker.py`` (which imports no JAX), and rank 0
writes every result to one file, which the tests then hold against

* the port's unsharded step, builders and trainer on the same seeded
  inputs (llama3-8b and zamba2-1.2b smoke, fp32 compute; within
  1e-4·max(max|ref|, 1) per leaf, and each gradient within 1e-4 of its
  own largest entry);
* for the qwen2-moe-a2.7b smoke step through the expert-parallel path,
  the port's unsharded step and the reference's unsharded
  ``jax.jit(make_train_step(m))``: at the reference mesh test's setup
  and its bar of 5e-2 (each rank's capacity comes from its local tokens,
  so it drops other slots than the one-device step does), and at a
  capacity that drops no slot, where loss, gradient norm and gradients
  are held within 1e-4;
* numpy combines of the reference's per-shard ``quantize_int8`` and
  ``_partial_attn`` for the collectives.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_worker import (DENSE, MESH, MOE, MOE_NO_DROP, MOE_RUN,
                                    WORLD, attn_inputs, dense_batch,
                                    fp32_run, tokens, unflatten)
from repro.configs.registry import ARCH_IDS
from repro.configs.shapes import SHAPES
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.parallel import collectives as jcoll
from repro.train import optim as joptim
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.launch import roofline
from repro_torch.models import RunConfig, build
from repro_torch.models import common as tcommon
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import collectives as tcoll
from repro_torch.parallel import sharding as shd

WORKER = Path(__file__).with_name("_torch_parallel_worker.py")
ROOT = Path(__file__).resolve().parents[1]
FP32 = fp32_run()


def _stand_in(data: int, model: int):
    """What the placements read of a mesh: its names, shape and rank."""
    return SimpleNamespace(mesh_dim_names=("data", "model"),
                           shape=(data, model), ndim=2)


def _bar(got: torch.Tensor, ref: torch.Tensor) -> bool:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) <= 1e-4 * max(
        float(ref.abs().max()), 1.0)


# ---------------------------------------------------------------------------
# Single process: rule tables and placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["TRAIN_RULES", "SERVE_RULES", "LONG_RULES"])
def test_rule_tables_equal_reference(name):
    assert getattr(tcommon, name) == getattr(jcommon, name)


LOGICAL_CASES = [
    (("embed", "ffn"), None, None),
    (("vocab", "embed"), None, None),
    (("nope",), None, None),
    (("embed", "kv_heads", None), (4096, 8, 128), {"data": 16, "model": 16}),
    (("embed", "kv_heads", None), (4096, 16, 128), {"data": 16, "model": 16}),
    (("vocab", "heads"), None, None),
    (("pod_batch", "seq"), (32, 4096), {"data": 2, "model": 4}),
]


@pytest.mark.parametrize("axes,shape,sizes", LOGICAL_CASES)
@pytest.mark.parametrize("rules", ["TRAIN_RULES", "LONG_RULES"])
def test_logical_to_pspec_equals_reference(axes, shape, sizes, rules):
    names = ("data", "model")
    got = tcommon.logical_to_pspec(axes, getattr(tcommon, rules), names,
                                   shape, sizes)
    ref = jcommon.logical_to_pspec(axes, getattr(jcommon, rules), names,
                                   shape, sizes)
    assert got == tuple(ref)


def _ref_pspecs(jm, rules, sizes):
    names = tuple(sizes)
    tree = jcommon.param_pspecs(jm.specs(), rules, names, sizes)
    return [tuple(p) for p in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("sizes", [(16, 16), (2, 4)], ids=["16x16", "2x4"])
def test_param_pspecs_equal_reference(arch, sizes):
    """Every ParamSpec of every arch, under the three rule tables; the
    placements of the port's ``model_param_shardings`` are those of the
    reference's specs."""
    sz = {"data": sizes[0], "model": sizes[1]}
    jm = jbuild(arch)
    tm = build(arch, device="cpu")
    mesh = _stand_in(*sizes)
    for rn in ("TRAIN_RULES", "SERVE_RULES", "LONG_RULES"):
        ref = _ref_pspecs(jm, getattr(jcommon, rn), sz)
        got = tree_leaves(tcommon.param_pspecs(
            tm.specs(), getattr(tcommon, rn), ("data", "model"), sz))
        assert got == ref, rn
    placed = tree_leaves(shd.model_param_shardings(tm, mesh, "serve"))
    assert placed == [tcommon.placements(p, mesh)
                      for p in _ref_pspecs(jm, jcommon.SERVE_RULES, sz)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_state_axes_equal_reference(arch):
    jm = jbuild(arch)
    tm = build(arch, device="cpu")
    from repro.configs.shapes import skip_reason
    for shape in SHAPES:
        if skip_reason(jm.cfg, SHAPES[shape]):
            continue
        assert tm.input_axes(shape) == jm.input_axes(shape), shape
    assert tm.state_axes() == jm.state_axes()


def _ref_state_pspecs(jm, sizes, shape_name, long_context):
    """The reference's ``state_shardings`` specs, by its own recipe
    (``repro/parallel/sharding.py``) with ``logical_to_pspec`` called
    directly: its ``NamedSharding`` needs a real mesh."""
    names = tuple(sizes)
    rules = jcommon.LONG_RULES if long_context else jcommon.SERVE_RULES
    out = {}
    for k, sds in jm.state_specs(shape_name).items():
        a = jm.state_axes()[k]
        if k in ("k", "v") and not long_context \
                and jm.cfg.n_kv_heads % sizes["model"] != 0:
            a = tuple(("seq_model" if x == "seq" else x) for x in a)
            rules = dict(rules)
            rules["seq_model"] = "model"
        out[k] = tuple(jcommon.logical_to_pspec(a, rules, names, sds.shape,
                                                sizes))
    return out


@pytest.mark.parametrize("arch,shape_name,long_context", [
    ("llama3-8b", "decode_32k", False),      # 8 kv heads at TP 16
    ("zamba2-1.2b", "decode_32k", False),
    ("zamba2-1.2b", "long_500k", True),
    ("qwen3-32b", "prefill_32k", False),
])
def test_state_and_batch_shardings_equal_reference(arch, shape_name,
                                                   long_context):
    sizes = {"data": 16, "model": 16}
    mesh = _stand_in(16, 16)
    jm = jbuild(arch)
    tm = build(arch, device="cpu")
    ref = _ref_state_pspecs(jm, sizes, shape_name, long_context)
    got = shd.state_shardings(tm, mesh, shape_name, long_context)
    assert got == {k: tcommon.placements(p, mesh) for k, p in ref.items()}
    rules = jcommon.LONG_RULES if long_context else jcommon.SERVE_RULES
    specs = jm.input_specs(shape_name)
    want = {k: tcommon.placements(tuple(jcommon.logical_to_pspec(
        a, rules, ("data", "model"), specs[k].shape, sizes)), mesh)
        for k, a in jm.input_axes(shape_name).items()}
    assert shd.batch_shardings(tm, mesh, shape_name, "serve",
                               long_context) == want


def test_state_shardings_take_the_sequence_rule_and_long_rules():
    """8 kv heads at TP 16: the KV cache's sequence goes over 'model';
    above 100,000 tokens the serve builders take LONG_RULES."""
    from torch.distributed.tensor import Shard
    mesh = _stand_in(16, 16)
    tm = build("llama3-8b", device="cpu")
    assert tm.cfg.n_kv_heads == 8
    st = shd.state_shardings(tm, mesh, "decode_32k")
    assert st["k"] == [Shard(1), Shard(2)]          # batch/data, seq/model
    assert shd.rules_for("serve", SHAPES["long_500k"].seq_len > 100_000) \
        is tcommon.LONG_RULES
    zm = build("zamba2-1.2b", device="cpu")
    st = shd.state_shardings(zm, mesh, "long_500k", long_context=True)
    assert zm.cfg.n_kv_heads % 16 == 0
    assert st["k"] == [Shard(2), Shard(3)]   # seq/data, kv heads/model


# ---------------------------------------------------------------------------
# Single process: collectives' local parts, roofline
# ---------------------------------------------------------------------------


def test_quantize_int8_bitwise_equals_reference():
    x = np.random.default_rng(3).normal(size=(257,)).astype(np.float32) * 3
    jq, js = jcoll.quantize_int8(jnp.asarray(x))
    tq, ts = tcoll.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    jd = jcoll.dequantize_int8(jq, js)
    td = tcoll.dequantize_int8(tq, ts)
    assert np.asarray(jd).tobytes() == td.numpy().tobytes()


def test_partial_attention_equals_reference():
    args = attn_inputs()
    ref = jcoll._partial_attn(*map(jnp.asarray, args))
    got = tcoll._partial_attn(*map(torch.from_numpy, args))
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-6 * max(np.abs(r).max(), 1)


def test_roofline_analyze_uses_h100_constants(tmp_path):
    """The reference's formulas with the H100's rates: 989e12 bf16
    FLOP/s, 3.35e12 B/s HBM, 900e9 B/s NVLink, 80 GiB."""
    art = {"arch": "llama3-8b", "shape": "train_4k", "kind": "train",
           "mesh": {"axes": {"data": 16, "model": 16}, "n_devices": 256},
           "n_active_params": 8.0e9, "flops_per_device": 3.1e15,
           "bytes_accessed_per_device": 4.2e12,
           "collective_bytes_per_device": 1.7e11,
           "memory": {"argument_bytes": 3 * 2**30, "temp_bytes": 5 * 2**30,
                      "generated_code_bytes": 2**20, "output_bytes": 2**30}}
    got = roofline.analyze(art)
    sh = SHAPES["train_4k"]
    terms = {"compute_s": 3.1e15 / 989e12, "memory_s": 4.2e12 / 3.35e12,
             "collective_s": 1.7e11 / 900e9}
    mf = 6.0 * 8.0e9 * sh.seq_len * sh.global_batch / 256
    bound = max(terms.values())
    live = 3 * 2**30 + 5 * 2**30 + 2**20
    want = {**{k: round(v, 6) for k, v in terms.items()},
            "dominant": max(terms, key=terms.get).replace("_s", ""),
            "model_flops_per_device": mf,
            "useful_flops_ratio": round(mf / 3.1e15, 4),
            "roofline_fraction": round(min(
                (min(mf, 3.1e15) / 989e12) / bound, 1.0), 4),
            "live_gib": round(live / 2**30, 2),
            "hbm_fit_ok": live < 80 * 2**30}
    assert got == want
    (tmp_path / "singlepod__llama3-8b__train_4k.json").write_text(
        json.dumps(art))
    assert "| llama3-8b | train_4k |" in roofline.table(str(tmp_path))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recompute_carries_the_scope(policy):
    """For a CUDA device autograd runs the backward — and so the
    recomputation of a checkpointed layer body — on a thread of its own,
    where the thread-local scope is not set.  The body built under a
    scope must see it when recomputed; here the backward runs on another
    thread by hand."""
    import threading
    from repro_torch.models.layers import remat
    from repro_torch.parallel import ctx
    seen = []

    def body(x):
        seen.append(ctx.current())
        return torch.sin(x @ x)

    mesh = _stand_in(1, 1)
    x = torch.ones(3, 3, requires_grad=True)
    with ctx.scope(mesh, tcommon.TRAIN_RULES):
        y = remat(body, RunConfig(remat=policy))(x).sum()
    assert ctx.current() is None
    t = threading.Thread(target=y.backward)
    t.start()
    t.join(30)
    assert not t.is_alive() and x.grad is not None
    assert len(seen) == 2 and all(c is not None and c[0] is mesh
                                  for c in seen), seen


def test_a_nested_scope_keeps_implicit_replication_on():
    """Leaving a nested scope (a recomputed layer body) leaves DTensor's
    implicit replication on for the step around it, whose backward still
    meets plain tensors saved in the forward."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel import ctx
    mesh = _stand_in(1, 1)
    flag = lambda: DTensor._op_dispatcher._allow_implicit_replication  # noqa: E731
    assert not flag()
    with ctx.scope(mesh, tcommon.TRAIN_RULES):
        with ctx.scope(mesh, tcommon.SERVE_RULES):
            assert ctx.current()[1] is tcommon.SERVE_RULES
        assert flag() and ctx.current()[1] is tcommon.TRAIN_RULES
    assert not flag() and ctx.current() is None


def test_make_host_mesh_and_desc_over_one_rank():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, mesh_desc
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=4, device_type="cpu")
        assert mesh_desc(mesh) == {"axes": {"data": 1, "model": 1},
                                   "n_devices": 1}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 8 ranks: the run, and the parent's references
# ---------------------------------------------------------------------------


def _moe_inputs(path: Path) -> None:
    """The reference mesh test's qwen2-moe-a2.7b smoke parameters
    (``init(PRNGKey(0))``), as numpy."""
    jm = jbuild(MOE, JRunConfig(**MOE_RUN), smoke=True)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    flat = {"/".join(str(k.key) for k in kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(path, **flat)


def _unsharded_prefill_state(arch: str, path: Path) -> None:
    from repro_torch.serve.serve_step import build_prefill
    m = build(arch, FP32, smoke=True, device="cpu")
    _, state = build_prefill(m, "prefill_32k", device="cpu", max_seq=24)(
        m.init(0), {"tokens": torch.from_numpy(tokens(2, 4, 16))})
    torch.save(state, path)


@pytest.fixture(scope="module")
def mesh_run():
    """One 8-rank gloo group for the module: its results, and the
    directory it wrote (checkpoints, inputs)."""
    with tempfile.TemporaryDirectory() as d:
        out = Path(d)
        _moe_inputs(out / "moe.npz")
        for arch in DENSE:
            _unsharded_prefill_state(arch, out / f"{arch}-state.pt")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT / "src")
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(port), d], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert all(p.returncode == 0 for p in procs), \
            "\n".join(x[-3000:] for x in logs)
        yield torch.load(out / "results.pt"), out


def _port_step(arch: str, run: RunConfig, params, batch):
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import make_train_step
    m = build(arch, run, smoke=True, device="cpu")
    p = params if params is not None else m.init(0)
    return make_train_step(m)(p, init_opt_state(p), batch)


def _gradients_close(got, ref) -> None:
    """Each leaf within 1e-4 of its own largest entry.  AdamW's first
    moment after one step is a tenth of the clipped gradient (global
    norm at most 1), so its entries lie far below 1 and a bar of
    1e-4·max(max|ref|, 1) would hold nothing; this bar is tighter."""
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), i


def _moe_unsharded(against: str, run_kwargs: dict, flat: dict,
                   fp32: bool = False):
    """The one-device qwen2-moe-a2.7b step from the reference's
    parameters (fp32 compute if ``fp32``): leaves of (params, mu), loss
    and gradient norm."""
    t = tokens(0, 4, 32)
    if fp32:
        run_kwargs = dict(run_kwargs, compute_dtype=(
            torch.float32 if against == "port" else jnp.float32))
    if against == "port":
        p, o, met = _port_step(MOE, RunConfig(**run_kwargs),
                               params_from_numpy(unflatten(flat),
                                                 device="cpu"),
                               {"tokens": t, "labels": t})
        leaves = tree_leaves
    else:
        jm = jbuild(MOE, JRunConfig(**run_kwargs), smoke=True)
        jp = jax.tree.map(jnp.asarray, unflatten(flat))
        batch = {"tokens": jnp.asarray(t), "labels": jnp.asarray(t)}
        p, o, met = jax.jit(j_make_train_step(jm))(
            jp, joptim.init_opt_state(jp), batch)
        leaves = lambda tree: [torch.tensor(np.asarray(x, np.float32))  # noqa: E731
                               for x in jax.tree.leaves(tree)]
    return (leaves(p), leaves(o["mu"]), float(met["loss"]),
            float(met["grad_norm"]))


@pytest.mark.parametrize("against", ["port", "reference"])
def test_moe_expert_parallel_step_matches_unsharded(mesh_run, against):
    """The 2 × 4 qwen2-moe-a2.7b step at the reference mesh test's setup
    goes through the expert-parallel all-to-all path (once per MoE layer)
    and lands within that test's 5e-2 of the unsharded step, the port's
    and the reference's: each rank's capacity comes from its local
    tokens, so the two paths drop different slots."""
    res, out = mesh_run
    got = res["moe"]
    assert got["ep_calls"] == build(MOE, smoke=True,
                                    device="cpu").cfg.n_layers
    ref_p, _, ref_loss, _ = _moe_unsharded(against, MOE_RUN,
                                           dict(np.load(out / "moe.npz")))
    d = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(tree_leaves(got["params"]), ref_p))
    assert d < 5e-2, d
    assert abs(float(got["loss"]) - ref_loss) < 5e-2


@pytest.mark.parametrize("against", ["port", "reference"])
def test_moe_expert_parallel_gradients_match_unsharded_without_drops(
        mesh_run, against):
    """In fp32 compute at a capacity that drops no slot, the
    expert-parallel and the one-device step compute the same function
    (in bf16 the two paths' sums round apart): loss within
    1e-4·max(|ref|, 1), the gradient norm within 1e-4 of itself, and each
    gradient (AdamW's first moment) within 1e-4 of its largest entry.
    This holds the backward of the two all-to-alls and the replicated
    router's summed gradient.  (One step moves a parameter by at most
    the warmup's learning rate, 1e-5, so parameters are not held here.)"""
    res, out = mesh_run
    got = res["moe_no_drop"]
    assert got["ep_calls"] == build(MOE, smoke=True,
                                    device="cpu").cfg.n_layers
    _, ref_mu, ref_loss, ref_gnorm = _moe_unsharded(
        against, MOE_NO_DROP, dict(np.load(out / "moe.npz")), fp32=True)
    assert abs(float(got["loss"]) - ref_loss) <= 1e-4 * max(abs(ref_loss), 1)
    assert abs(float(got["grad_norm"]) - ref_gnorm) <= 1e-4 * ref_gnorm
    _gradients_close(tree_leaves(got["mu"]), ref_mu)


@pytest.mark.parametrize("arch", DENSE)
def test_mesh_train_step_matches_unsharded(mesh_run, arch):
    got = mesh_run[0][arch]
    p, o, met = _port_step(arch, FP32, None, dense_batch())
    assert got["placements"]
    assert _bar(got["loss"], met["loss"])
    assert _bar(got["grad_norm"], met["grad_norm"])
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(p)):
        assert _bar(a, b)
    for key in ("mu", "nu"):
        for a, b in zip(tree_leaves(got["opt"][key]), tree_leaves(o[key])):
            assert _bar(a, b)
    _gradients_close(tree_leaves(got["opt"]["mu"]), tree_leaves(o["mu"]))
    assert int(got["opt"]["step"]) == int(o["step"]) == 1


def _close_state(got: dict, ref: dict) -> None:
    """fp32 leaves within the bar; a bf16 KV cache within the bar plus
    one bf16 step (2^-7 of the element): the two runs' fp32 keys and
    values agree within the bar (a tensor-parallel product sums in
    another order), and each is rounded to bf16 on its own."""
    assert set(got) == set(ref)
    for k in ref:
        g, r = got[k].float(), ref[k].float()
        bar = 1e-4 * max(float(r.abs().max()), 1.0)
        if ref[k].dtype == torch.bfloat16:
            bar = bar + 2.0 ** -7 * r.abs()
        assert bool(((g - r).abs() <= bar).all()), k


@pytest.mark.parametrize("arch", DENSE)
def test_mesh_prefill_matches_unsharded(mesh_run, arch):
    from repro_torch.serve.serve_step import build_prefill
    got = mesh_run[0][arch]["prefill"]
    m = build(arch, FP32, smoke=True, device="cpu")
    logits, state = build_prefill(m, "prefill_32k", device="cpu",
                                  max_seq=24)(
        m.init(0), {"tokens": torch.from_numpy(tokens(2, 4, 16))})
    assert got["placed"]
    assert _bar(got["logits"], logits)
    _close_state(got["state"], state)


@pytest.mark.parametrize("arch", DENSE)
def test_mesh_decode_matches_unsharded(mesh_run, arch):
    from repro_torch.serve.serve_step import build_decode_step
    res, out = mesh_run
    got = res[arch]["decode"]
    m = build(arch, FP32, smoke=True, device="cpu")
    state = torch.load(out / f"{arch}-state.pt")
    logits, state = build_decode_step(m, "decode_32k", device="cpu")(
        m.init(0), state, torch.from_numpy(tokens(3, 4, 1)))
    assert got["placed"]
    assert _bar(got["logits"], logits)
    _close_state(got["state"], state)


def test_quantized_psum_matches_numpy_combine(mesh_run):
    """psum of the int8 payloads in int32, pmax of the scales, the mean
    over the 4 model shards: bit for bit."""
    got = mesh_run[0]["collectives"]
    qs, scales = [], []
    for j in range(MESH[1]):
        x = np.random.default_rng(20 + j).normal(size=(257,)) \
            .astype(np.float32)
        q, s = jcoll.quantize_int8(jnp.asarray(x))
        qs.append(np.asarray(q).astype(np.int32))
        scales.append(np.float32(s))
        if j == 0:
            resid = x - np.asarray(jcoll.dequantize_int8(q, s))
    total = np.sum(qs, axis=0).astype(np.int32)
    mean = total.astype(np.float32) * np.max(scales) / np.float32(MESH[1])
    assert got["mean"].numpy().tobytes() == mean.astype(np.float32).tobytes()
    assert got["residual"].numpy().tobytes() == resid.tobytes()


def test_seq_sharded_decode_attention_matches_numpy_combine(mesh_run):
    got = mesh_run[0]["collectives"]["attn"].numpy()
    q, k, v, valid = attn_inputs()
    S = k.shape[1] // MESH[1]
    parts = [[np.asarray(t) for t in jcoll._partial_attn(
        *map(jnp.asarray, (q, k[:, j * S:(j + 1) * S],
                           v[:, j * S:(j + 1) * S],
                           valid[:, j * S:(j + 1) * S])))]
        for j in range(MESH[1])]
    g = np.max([m for m, _, _ in parts], axis=0)
    l_g = sum(l * np.exp(m - g) for m, l, _ in parts)
    o_g = sum(o * np.exp(m - g)[..., None] for m, _, o in parts)
    want = o_g / np.maximum(l_g, 1e-30)[..., None]
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0)
    # and the combine is the unsharded attention
    m, l, o = jcoll._partial_attn(*map(jnp.asarray, (q, k, v, valid)))
    full = np.asarray(o) / np.asarray(l)[..., None]
    assert np.abs(got - full).max() <= 1e-5 * max(np.abs(full).max(), 1.0)


@pytest.mark.parametrize("onto", ["4x2", "one-process"])
def test_checkpoint_restores_onto_another_mesh(mesh_run, onto):
    from repro_torch import ckpt
    res, out = mesh_run
    m = build("llama3-8b", FP32, smoke=True, device="cpu")
    want = m.init(0)
    if onto == "4x2":
        assert res["reshard"]["placed"]
        got = res["reshard"]["params"]
    else:
        got, _ = ckpt.restore_section(str(out / "ckpt"), 1, want,
                                      device="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_faulty_trainer_on_the_mesh_equals_an_uninterrupted_run(mesh_run):
    ft = mesh_run[0]["ft"]
    assert ft["faulty"]["restarts"] > 0 and ft["clean"]["restarts"] == 0
    assert ft["faulty"]["hist"] == ft["clean"]["hist"]
    assert ft["faulty"]["hist"]["step"] == [0, 1, 2, 3]
    for key in ("params", "opt"):
        for a, b in zip(tree_leaves(ft["faulty"][key]),
                        tree_leaves(ft["clean"][key])):
            assert torch.equal(a, b)
