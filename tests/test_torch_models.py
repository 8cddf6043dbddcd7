"""repro_torch's SSM/hybrid serving path ≡ the reference's, on the CPU.

The reference's parameters (``m.init(PRNGKey(0))``) are carried into the
port with ``params_from_numpy``; the same seeded numpy tokens go through
both.  The reference runs its Pallas kernels in interpret mode
(``use_pallas=True``), the port its plain torch versions (CPU tensors).
Compared: forward logits and loss; prefill logits and every state leaf;
then four decode steps, logits and states.

Tolerances: at ``compute_dtype=float32`` logits within
1e-4·max(max|ref|, 1) and states within atol 1e-4 (fp32 sums in another
order); at bfloat16, 2e-2·max(max|ref|, 1) for both (bf16 rounds at
other places in the two frameworks).  KV caches are stored in bf16 in
both whatever the compute dtype, so at float32 two keys that differ by
1e-7 before storage may round to neighbouring bf16 values: the k and v
leaves get one bf16 step, 2^-7·|ref|, on top of the 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro_torch.models import RunConfig, build
from repro_torch.models.convert import params_from_numpy

ARCHS = ("zamba2-1.2b", "mamba2-780m")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, L, MAX_SEQ, STEPS = 2, 32, 40, 4


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if hasattr(x, "dtype") \
        and x.dtype == jnp.bfloat16 else np.asarray(x)


def _tnp(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _check(ref, got, dtype_name, what, state=False):
    bf16_leaf = hasattr(ref, "dtype") and ref.dtype == jnp.bfloat16
    ref = _np(ref).astype(np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    if dtype_name == "float32":
        tol = 1e-4 if state else 1e-4 * max(np.abs(ref).max(), 1.0)
        if bf16_leaf:
            tol = tol + 2.0 ** -7 * np.abs(ref)
    else:
        tol = 2e-2 * max(np.abs(ref).max(), 1.0)
    err = np.abs(ref - got)
    worst = float((err - tol).max()) if ref.size else 0.0
    assert worst <= 0, f"{what}: max|Δ| {err.max():.3g} beyond its bound"


def _pair(arch, dtype_name, device="cpu"):
    jdt, tdt = DTYPES[dtype_name]
    jm = jbuild(arch, JRunConfig(remat="none", use_pallas=True,
                                 compute_dtype=jdt), smoke=True)
    tm = build(arch, RunConfig(remat="none", compute_dtype=tdt), smoke=True,
               device=device)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=device)
    return jm, jp, tm, tp


def _tokens(cfg, n):
    return np.random.default_rng(7).integers(0, cfg.vocab, (B, n)) \
        .astype(np.int32)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype_name):
    jm, jp, tm, tp = _pair(arch, dtype_name)
    toks = _tokens(jm.cfg, L)
    ref = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _check(ref, _tnp(got), dtype_name, "forward logits")
    jloss, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(toks)})
    tloss, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(toks)})
    _check(jloss, _tnp(tloss), dtype_name, "loss")


def check_prefill_and_decode(arch, dtype_name, device):
    jm, jp, tm, tp = _pair(arch, dtype_name, device)
    toks = _tokens(jm.cfg, L + STEPS)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :L])}, MAX_SEQ)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :L])
                             .to(device)}, MAX_SEQ)
    _check(jl, _tnp(tl), dtype_name, "prefill logits")
    assert sorted(js) == sorted(ts)
    for step in range(STEPS + 1):
        for key in js:
            if key == "length":
                assert int(js[key]) == int(ts[key]) == L + step
                continue
            assert ts[key].dtype == {"float32": torch.float32,
                                     "bfloat16": torch.bfloat16}[
                str(js[key].dtype)], key
            _check(js[key], _tnp(ts[key]), dtype_name,
                   f"state {key} after {step} decode steps", state=True)
        if step == STEPS:
            break
        tok = toks[:, L + step:L + step + 1]
        jl, js = jm.decode_step(jp, js, jnp.asarray(tok))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(tok).to(device))
        _check(jl, _tnp(tl), dtype_name, f"decode logits, step {step}")


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype_name):
    check_prefill_and_decode(arch, dtype_name, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_prefill_and_decode_match_reference(arch, dtype_name):
    """The same comparison with the port on the card: its prefill goes
    through the flash-attention and SSD kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    before = (fa_ops.LAUNCHES, ssd_ops.LAUNCHES)
    check_prefill_and_decode(arch, dtype_name, "cuda")
    assert ssd_ops.LAUNCHES > before[1]
    assert (fa_ops.LAUNCHES > before[0]) == (arch == "zamba2-1.2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port against itself, with the reference's own bar
    (``tests/test_models.py``): decoding token L after a prefill of L
    equals the forward pass over L + 1 tokens at position L."""
    tm = build(arch, RunConfig(remat="none"), smoke=True, device="cpu")
    params = tm.init(0)
    toks = torch.from_numpy(_tokens(tm.cfg, 17).astype(np.int64))
    _, state = tm.prefill(params, {"tokens": toks[:, :16]}, 24)
    dec, state2 = tm.decode_step(params, state, toks[:, 16:17])
    full = tm.forward(params, {"tokens": toks})
    ref = full[:, 16, :].float()
    scale = float(ref.abs().max()) or 1.0
    assert float((dec[:, 0, :].float() - ref).abs().max()) \
        < 0.15 * max(scale, 1.0)
    assert int(state2["length"]) == 17


@pytest.mark.parametrize("arch,n", [("zamba2-1.2b", 1_170_313_344),
                                    ("mamba2-780m", 857_686_272)])
def test_param_counts_full_configs(arch, n):
    assert build(arch, device="cpu").n_params() == n \
        == jbuild(arch).n_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Same nested keys, shapes and dtypes as the reference's init."""
    jm = jbuild(arch, smoke=True)
    tm = build(arch, smoke=True, device="cpu")
    jp = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                      jm.init(jax.random.PRNGKey(0)))
    tp = tm.init(0)

    def walk(j, t, path):
        assert isinstance(t, dict) == isinstance(j, dict), path
        if isinstance(j, dict):
            assert sorted(j) == sorted(t), path
            for k in j:
                walk(j[k], t[k], path + (k,))
            return
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) \
            == (tuple(j[0]), j[1]), path
    walk(jp, tp, ())


def test_init_is_seeded():
    tm = build("zamba2-1.2b", smoke=True, device="cpu")
    a, b, c = tm.init(3), tm.init(3), tm.init(4)
    wa, wb, wc = (p["layers"]["ssm"]["w_x"] for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert torch.equal(a["layers"]["ssm"]["D"],
                       torch.ones_like(a["layers"]["ssm"]["D"]))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "hubert-xlarge", "internvl2-1b"])
def test_transformer_families_not_ported_yet(arch):
    m = build(arch, smoke=True, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        m.specs()


def test_serve_builders_run_on_cpu():
    from repro_torch.serve.serve_step import build_decode_step, build_prefill
    tm = build("zamba2-1.2b", smoke=True, device="cpu")
    params = tm.init(0)
    prefill = build_prefill(tm, "prefill_32k", device="cpu", max_seq=40)
    decode = build_decode_step(tm, "decode_32k", device="cpu")
    toks = torch.from_numpy(_tokens(tm.cfg, L).astype(np.int64))
    logits, state = prefill(params, {"tokens": toks})
    assert logits.shape == (B, 1, tm.cfg.vocab)
    assert state["k"].shape == (2, B, 40, tm.cfg.n_kv_heads, tm.cfg.hd)
    nxt = logits.argmax(-1)
    logits2, state = decode(params, state, nxt)
    assert torch.isfinite(logits2.float()).all()
    assert int(state["length"]) == L + 1
    with pytest.raises(KeyError):
        build_prefill(tm, "no_such_shape", device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        build_prefill(tm, "prefill_32k", device="cpu", max_seq=8)(
            params, {"tokens": toks})
