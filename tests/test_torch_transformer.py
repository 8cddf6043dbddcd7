"""repro_torch's transformer families (dense, MoE, audio, VLM) ≡ the
reference's, on the CPU.

The reference's parameters (``m.init(PRNGKey(0))``) are carried into the
port with ``params_from_numpy``; the same seeded numpy inputs (tokens,
frames, patches) go through both at the smoke sizes (``reduce_config``).
The reference runs its flash-attention Pallas kernel in interpret mode
(``use_pallas=True``), the port its plain torch version (CPU tensors).
The reference runs its layers unrolled (``scan_layers=False``), op by op
as the port does: inside its compiled ``lax.scan`` body XLA keeps some
bf16 intermediates in fp32 (excess precision), so at bfloat16 a MoE
router's bf16 logits can land on another expert than the same model run
op by op, which moves a logit by more than the bf16 bar below.
Compared for all eight transformer archs: forward logits (and, in
fp32, the loss with the MoE auxiliary loss); prefill logits and every cache leaf, then
three decode steps, logits and caches (an encoder-only arch: prefill is
``forward``, no state); the parameter tree, the full configs' parameter
counts and the ``(shape, dtype)`` stand-ins; the MoE router and
load-balance loss in fp32.

Tolerances, as ``tests/test_torch_models.py``'s: at
``compute_dtype=float32`` logits within 1e-4·max(max|ref|, 1) and cache
leaves within 1e-4 plus one bf16 step, 2^-7·|ref| (both store the cache
in bf16, and fp32 keys that differ by 1e-7 may round to neighbouring
bf16 values); at bfloat16, 2e-2·max(max|ref|, 1) for both (bf16 rounds
at other places in the two frameworks).  Router outputs in fp32: the
same experts, weights within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro_torch.models import RunConfig, build
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy

ARCHS = ("llama3-8b", "qwen2-moe-a2.7b", "hubert-xlarge", "internvl2-1b",
         "qwen3-32b", "moonshot-v1-16b-a3b", "phi3-medium-14b",
         "deepseek-coder-33b")
DECODERS = tuple(a for a in ARCHS if a != "hubert-xlarge")
MOE = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, L, MAX_SEQ, STEPS = 2, 32, 40, 3


def _np(x):
    if hasattr(x, "dtype") and x.dtype == jnp.bfloat16:
        return np.asarray(jnp.asarray(x, jnp.float32))
    return np.asarray(x)


def _tnp(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _check(ref, got, dtype_name, what, cache=False):
    bf16_leaf = hasattr(ref, "dtype") and ref.dtype == jnp.bfloat16
    ref = _np(ref).astype(np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    if dtype_name == "float32":
        tol = 1e-4 if cache else 1e-4 * max(np.abs(ref).max(), 1.0)
        if bf16_leaf:
            tol = tol + 2.0 ** -7 * np.abs(ref)
    else:
        tol = 2e-2 * max(np.abs(ref).max(), 1.0)
    err = np.abs(ref - got)
    assert float((err - tol).max()) <= 0, \
        f"{what}: max|Δ| {err.max():.3g} beyond its bound"


def _batch(cfg, n, seed=7):
    """Seeded numpy inputs of one family, n positions: tokens (and
    labels), audio frames, VLM patches; a mask for the loss."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    batch = {"labels": toks, "mask": rng.random((B, n)) < 0.8}
    if cfg.frame_dim:
        batch["frames"] = rng.normal(size=(B, n, cfg.frame_dim)) \
            .astype(np.float32)
    else:
        batch["tokens"] = toks
    if cfg.n_patches:
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch, device="cpu"):
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def pairs():
    """(arch, dtype, device) → (reference model, its params, port model,
    its params), built once per module."""
    cache = {}

    def get(arch, dtype_name, device="cpu"):
        key = (arch, dtype_name, device)
        if key not in cache:
            jdt, tdt = DTYPES[dtype_name]
            jm = jbuild(arch, JRunConfig(remat="none", use_pallas=True,
                                         scan_layers=False,
                                         compute_dtype=jdt), smoke=True)
            tm = build(arch, RunConfig(remat="none", compute_dtype=tdt),
                       smoke=True, device=device)
            jp = jm.init(jax.random.PRNGKey(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device=device)
            cache[key] = (jm, jp, tm, tp)
        return cache[key]
    return get


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(pairs, arch, dtype_name):
    jm, jp, tm, tp = pairs(arch, dtype_name)
    batch = _batch(jm.cfg, L)
    ref = jm.forward(jp, _j(batch))
    got = tm.forward(tp, _t(batch))
    assert got.dtype == DTYPES[dtype_name][1]
    _check(ref, _tnp(got), dtype_name, "forward logits")
    if dtype_name != "float32":
        return
    jloss, jmet = jm.loss(jp, _j(batch))
    tloss, tmet = tm.loss(tp, _t(batch))
    assert sorted(jmet) == sorted(tmet)
    for key in jmet:
        _check(jmet[key], _tnp(tmet[key]), dtype_name, key)
    _check(jloss, _tnp(tloss), dtype_name, "loss")


def check_prefill_and_decode(pairs, arch, dtype_name, device):
    jm, jp, tm, tp = pairs(arch, dtype_name, device)
    batch = _batch(jm.cfg, L + STEPS)
    prompt = {k: (v[:, :L] if k in ("tokens", "frames") else v)
              for k, v in batch.items() if k not in ("labels", "mask")}
    jl, js = jm.prefill(jp, _j(prompt), MAX_SEQ)
    tl, ts = tm.prefill(tp, _t(prompt, device), MAX_SEQ)
    _check(jl, _tnp(tl), dtype_name, "prefill logits")
    if jm.cfg.is_encoder_only:
        assert js is None and ts is None
        return
    assert sorted(js) == sorted(ts) == ["k", "length", "v"]
    toks = batch["tokens"]
    for step in range(STEPS + 1):
        assert int(js["length"]) == int(ts["length"]) == L + step
        for key in ("k", "v"):
            assert ts[key].dtype == torch.bfloat16
            _check(js[key], _tnp(ts[key]), dtype_name,
                   f"cache {key} after {step} decode steps", cache=True)
        if step == STEPS:
            break
        tok = toks[:, L + step:L + step + 1]
        jl, js = jm.decode_step(jp, js, jnp.asarray(tok))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(tok).to(device))
        _check(jl, _tnp(tl), dtype_name, f"decode logits, step {step}")


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(pairs, arch, dtype_name):
    check_prefill_and_decode(pairs, arch, dtype_name, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "hubert-xlarge", "internvl2-1b"])
def test_cuda_prefill_and_decode_match_reference(pairs, arch, dtype_name):
    """The same comparison with the port on the card: every layer's
    attention in the prefill goes through the flash-attention kernel
    (D = 32 at the smoke sizes); decode launches none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.flash_attention import ops as fa_ops
    before = fa_ops.LAUNCHES
    check_prefill_and_decode(pairs, arch, dtype_name, "cuda")
    n_layers = pairs(arch, dtype_name, "cuda")[2].cfg.n_layers
    assert fa_ops.LAUNCHES - before == n_layers


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_forward(arch):
    """The port against itself, with the reference's own bar
    (``tests/test_models.py``): decoding token L after a prefill of L
    equals the forward pass over L + 1 tokens at position L."""
    tm = build(arch, RunConfig(remat="none"), smoke=True, device="cpu")
    params = tm.init(0)
    batch = _t(_batch(tm.cfg, 17))
    prompt = dict(batch, tokens=batch["tokens"][:, :16])
    del prompt["labels"], prompt["mask"]
    _, state = tm.prefill(params, prompt, 24)
    dec, state2 = tm.decode_step(params, state, batch["tokens"][:, 16:17])
    full = tm.forward(params, dict(prompt, tokens=batch["tokens"]))
    ref = full[:, 16, :].float()
    scale = float(ref.abs().max()) or 1.0
    assert float((dec[:, 0, :].float() - ref).abs().max()) \
        < 0.15 * max(scale, 1.0)
    assert int(state2["length"]) == 17


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_full_configs(arch):
    tm, jm = build(arch, device="cpu"), jbuild(arch)
    assert tm.n_params() == jm.n_params()
    assert tm.n_active_params() == jm.n_active_params()


def _walk(j, t, path, leaf):
    assert isinstance(t, dict) == isinstance(j, dict), path
    if isinstance(j, dict):
        assert sorted(j) == sorted(t), path
        for k in j:
            _walk(j[k], t[k], path + (k,), leaf)
        return
    leaf(j, t, path)


def _same_shape_dtype(j, t, path):
    """A reference (shape, dtype) stand-in and a port one, or a port
    tensor, agree."""
    shape, dt = (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) \
        else t
    assert (tuple(shape), str(dt).replace("torch.", "")) \
        == (tuple(j.shape), str(j.dtype)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Same nested keys, shapes and dtypes as the reference's init (smoke
    size), and as its bf16 ``abstract`` at full size."""
    jm, tm = jbuild(arch, smoke=True), build(arch, smoke=True, device="cpu")
    _walk(jm.init(jax.random.PRNGKey(0)), tm.init(0), (), _same_shape_dtype)
    _walk(jbuild(arch).abstract(jnp.bfloat16),
          build(arch, device="cpu").abstract(torch.bfloat16), (),
          _same_shape_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_state_specs_match_reference(arch):
    from repro.configs.shapes import SHAPE_ORDER, SHAPES, skip_reason
    jm, tm = jbuild(arch), build(arch, device="cpu")
    for name in SHAPE_ORDER:
        if skip_reason(jm.cfg, SHAPES[name]):
            with pytest.raises(ValueError, match="skipped"):
                tm.input_specs(name)
            continue
        _walk(jm.input_specs(name), tm.input_specs(name), (name,),
              _same_shape_dtype)
        js, ts = jm.state_specs(name), tm.state_specs(name)
        assert (js is None) == (ts is None), name
        if js is not None:
            _walk(js, ts, (name,), _same_shape_dtype)


def test_init_casts_leaf_by_leaf():
    """``init(seed, dtype)``: bf16 leaves (the serve paths' weights),
    seeded; the ones-initialised norms stay exact."""
    tm = build("qwen2-moe-a2.7b", smoke=True, device="cpu")
    a, b = tm.init(3, torch.bfloat16), tm.init(3, torch.bfloat16)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
    w = a["layers"]["moe"]["w_gate"].float()
    assert 0.015 < float(w.std()) < 0.025
    assert torch.equal(a["ln_f"], torch.ones_like(a["ln_f"]))


@pytest.mark.parametrize("arch", MOE)
def test_router_and_load_balance_match_reference(arch):
    """fp32: the same top-k experts in the same order, the same
    normalised weights (1e-6), the same within-expert positions and the
    same load-balance loss (1e-6)."""
    jm = jbuild(arch, JRunConfig(compute_dtype=jnp.float32), smoke=True)
    tm = build(arch, RunConfig(compute_dtype=torch.float32), smoke=True,
               device="cpu")
    lp = jax.tree.map(lambda x: np.asarray(x[0]),
                      jm.init(jax.random.PRNGKey(0))["layers"]["moe"])
    tp = params_from_numpy(lp, device="cpu")
    x = np.random.default_rng(5).normal(size=(4, 64, jm.cfg.d_model)) \
        .astype(np.float32)
    jw, je = jmoe._router(lp, jnp.asarray(x.reshape(-1, x.shape[-1])),
                          jm.cfg)
    tw, te = tmoe._router(tp, torch.from_numpy(x.reshape(-1, x.shape[-1])),
                          tm.cfg)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    np.testing.assert_allclose(np.asarray(jw), tw.numpy(), atol=1e-6)
    e_pad = jm.cfg.n_experts_padded
    np.testing.assert_array_equal(
        np.asarray(jmoe._positions_within_expert(je.reshape(-1), e_pad)),
        tmoe._positions_within_expert(te.reshape(-1).long()).numpy())
    np.testing.assert_allclose(
        float(jmoe.moe_load_balance_loss(lp, jnp.asarray(x), jm.cfg,
                                         jm.run)),
        float(tmoe.moe_load_balance_loss(tp, torch.from_numpy(x), tm.cfg,
                                         tm.run)), atol=1e-6)


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25])
def test_moe_dispatch_matches_reference(capacity_factor):
    """``_moe_dense`` in fp32, with and without dropped slots (a quarter
    of the capacity drops most of them): outputs within 1e-5."""
    arch = "qwen2-moe-a2.7b"
    jm = jbuild(arch, JRunConfig(compute_dtype=jnp.float32), smoke=True)
    tm = build(arch, RunConfig(compute_dtype=torch.float32), smoke=True,
               device="cpu")
    lp = jax.tree.map(lambda x: np.asarray(x[0]),
                      jm.init(jax.random.PRNGKey(1))["layers"]["moe"])
    x = np.random.default_rng(6).normal(size=(2, 48, jm.cfg.d_model)) \
        .astype(np.float32)
    ref = jmoe._moe_dense(lp, jnp.asarray(x), jm.cfg, jm.run,
                          capacity_factor)
    got = tmoe._moe_dense(params_from_numpy(lp, device="cpu"),
                          torch.from_numpy(x), tm.cfg, tm.run,
                          capacity_factor)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=1e-5)


def test_serve_builders_encoder_only():
    """hubert-xlarge serves a prefill (every position's logits, no state)
    and refuses a decode cell, as ``configs/shapes.py::skip_reason``
    skips it."""
    from repro_torch.serve.serve_step import build_decode_step, \
        build_prefill
    tm = build("hubert-xlarge", smoke=True, device="cpu")
    params = tm.init(0)
    frames = torch.from_numpy(_batch(tm.cfg, L)["frames"])
    logits, state = build_prefill(tm, "prefill_32k", device="cpu")(
        params, {"frames": frames})
    assert state is None and logits.shape == (B, L, tm.cfg.vocab)
    with pytest.raises(ValueError, match="no decode step"):
        build_decode_step(tm, "decode_32k", device="cpu")
