"""repro_torch flash attention ≡ the reference's, on the CPU.

The port's plain version (``repro_torch.kernels.flash_attention.ref``,
what ``ops.flash_attention`` runs on CPU tensors) is held against the
reference's Pallas kernel in interpret mode and its jnp ``attention_ref``
on the same seeded numpy inputs, at the reference sweep's shapes
(``tests/test_kernels.py``) and tolerances: 2e-5 in fp32, 2e-2 in bf16
(the jnp oracle rounds logits and probabilities to bf16, the kernel and
the port's plain version keep them in fp32).  The CUDA kernel is held
against the plain version on the card (``cuda`` marker).

The backward: the plain ``attention_bwd_ref`` (and ``attention_lse_ref``)
against torch.autograd of ``attention_ref`` and ``jax.vjp`` of the
reference's ``attention_ref``; the custom operator's autograd wiring and
launch counts with the kernels' entry points swapped for their plain
versions; the backward kernels against ``attention_bwd_ref`` on the card.

The bf16 kernel runs both products on the tensor cores with p split into
three bf16 terms; ``emulate_tensor_core_kernel`` repeats that arithmetic
on the CPU, so the split is held to the card's element bar here too.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_fa
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref as ref_mod
from repro_torch.kernels.flash_attention.ref import attention_ref

DT = {"float32": (jnp.float32, torch.float32, 2e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SWEEP = [(2, 256, 4, 64, True, "float32"),
         (1, 128, 2, 128, False, "float32"),
         (2, 200, 3, 64, True, "float32"),      # not a block multiple
         (1, 96, 1, 32, True, "float32"),
         (2, 256, 2, 64, True, "bfloat16")]


def make(seed, B, Lq, Lk, H, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, H, D)).astype(np.float32)
            for n in (Lq, Lk, Lk)]


def as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if hasattr(x, "dtype") and x.dtype == jnp.bfloat16 \
        else (x.float().numpy() if isinstance(x, torch.Tensor)
              else np.asarray(x))


def both(arrs, dtype):
    jdt, tdt, _ = DT[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("B,L,H,D,causal,dtype", SWEEP)
def test_plain_matches_reference_sweep(B, L, H, D, causal, dtype):
    js, ts = both(make(B * L + D, B, L, L, H, D), dtype)
    got = ops.flash_attention(*ts, causal=causal)
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    tol = DT[dtype][2]
    for ref in (j_fa(*js, causal=causal, interpret=True),
                j_ref(*js, causal=causal)):
        np.testing.assert_allclose(as_np(got), as_np(ref), atol=tol)


# hubert-xlarge's head dim (80, not a multiple of 64), causal and not
# (the model is non-causal), at a ragged length; same tolerances.
D80 = [(2, 200, 3, 80, causal, dtype) for causal in (True, False)
       for dtype in DT]


@pytest.mark.parametrize("B,L,H,D,causal,dtype", D80)
def test_plain_matches_reference_head_dim_80(B, L, H, D, causal, dtype):
    js, ts = both(make(B * L + D, B, L, L, H, D), dtype)
    got = ops.flash_attention(*ts, causal=causal)
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    tol = DT[dtype][2]
    for ref in (j_fa(*js, causal=causal, interpret=True),
                j_ref(*js, causal=causal)):
        np.testing.assert_allclose(as_np(got), as_np(ref), atol=tol)


@pytest.mark.parametrize("Lq,Lk", [(1, 40), (16, 200), (64, 64), (7, 129)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_lk_ne_lq(Lq, Lk, causal):
    """Cached-prefix shapes: the causal mask's offset is Lk − Lq."""
    js, ts = both(make(Lq * Lk, 2, Lq, Lk, 2, 64), "float32")
    got = ops.flash_attention(*ts, causal=causal)
    for ref in (j_fa(*js, causal=causal, interpret=True),
                j_ref(*js, causal=causal)):
        np.testing.assert_allclose(as_np(got), as_np(ref), atol=2e-5)


@pytest.mark.parametrize("max_logits", [1, 777, 200 * 200 * 6])
def test_row_blocking_changes_nothing(max_logits):
    """The plain version's query-row blocks (which keep the 32k prompt's
    logits in memory) give the same rows as one block."""
    _, ts = both(make(3, 2, 200, 200, 3, 64), "float32")
    whole = attention_ref(*ts, causal=True, max_logits=1 << 40)
    got = attention_ref(*ts, causal=True, max_logits=max_logits)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6)


def test_cpu_path_launches_nothing():
    _, ts = both(make(1, 1, 32, 32, 1, 32), "float32")
    before = ops.LAUNCHES
    ops.flash_attention(*ts)
    assert ops.LAUNCHES == before


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    _, ts = both(make(1, 1, 32, 32, 1, 32), "float32")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_cuda(*ts)


# bf16 outputs are held element by element to one bf16 step of the plain
# version plus fp32 slack (chip_smoke.py's FA_BF16_REL and FA_BF16_ABS).
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-6
LOG2E = float(np.float32(math.log2(math.e)))
KEY_TILE = 64  # keys per tile in the bf16 kernel


def element_ratio(got, want):
    """Largest |got − want| / (2^-7·|want| + 1e-6); at most 1 passes."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (BF16_REL * w.abs() + BF16_ABS)).max())


def split_bf16(p, terms=3):
    """p as a sum of bf16 terms, each the rounding of what the earlier
    ones left; returns the terms and the fp32 residual."""
    parts, rest = [], p
    for _ in range(terms):
        t = rest.to(torch.bfloat16)
        parts.append(t)
        rest = rest - t.float()
    return parts, rest


def fma(a, b, c):
    """a·b + c rounded once to fp32 (exact in double for fp32 inputs)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_tensor_core_kernel(q, k, v, causal=True, terms=3, scale=None):
    """The bf16 CUDA kernel's arithmetic in torch, on the CPU.

    Per key tile of 64: raw logits S from bf16 q·kᵀ summed in fp32,
    masked with -1e30; with c = scale·log2(e) in fp32, the running row
    max m of S, mL = m·c, p = exp2(fma(S, c, −mL)) and O's rescale factor
    alpha = exp2(mL_old − mL_new); the tile's T = p1·V + p2·V + p3·V with
    p split into bf16 terms and V in bf16, summed in fp32 from zero; then
    O = fma(O, alpha, T); finally O / l in q's dtype.  This model uses an
    exact exp2 and sums rounded to nearest; the card's ``ex2.approx.ftz``
    and the tensor cores' accumulation are covered only by the
    ``cuda``-marked tests and chip_smoke.py's phase 6.
    ``scale`` defaults to 1/√D.  Returns the output and the largest
    split residual."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    c = (torch.tensor(scale, dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32))
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    m = torch.full((B, H, Lq, 1), -1e30)
    mL = m * c
    l = torch.zeros((B, H, Lq, 1))
    o = torch.zeros((B, H, Lq, D))
    qi = torch.arange(Lq)[:, None] + (Lk - Lq)
    residual = 0.0
    for k0 in range(0, Lk, KEY_TILE):
        x = qf @ kf[:, :, k0:k0 + KEY_TILE].transpose(-1, -2)
        if causal:
            ki = torch.arange(k0, min(k0 + KEY_TILE, Lk))[None, :]
            x = torch.where(qi >= ki, x, torch.tensor(-1e30))
        m = torch.maximum(m, x.amax(-1, keepdim=True))
        mL_new = m * c
        alpha = torch.exp2(mL - mL_new)
        p = torch.exp2(fma(x, c, -mL_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        parts, rest = split_bf16(p, terms)
        residual = max(residual, float(rest.abs().max()))
        vt = vf[:, :, k0:k0 + KEY_TILE]
        t = parts[0].float() @ vt
        for part in parts[1:]:
            t = t + part.float() @ vt
        o = fma(o, alpha, t)
        mL = mL_new
    return (o / l).permute(0, 2, 1, 3).to(q.dtype), residual


@pytest.mark.parametrize("L", [256, 2048])
def test_three_term_split_meets_the_bf16_element_bar(L):
    """The tensor-core kernel's arithmetic (bf16 products, p in three
    bf16 terms) stays within one bf16 step of the plain version at every
    element, and the three terms hold p exactly."""
    _, ts = both(make(L, 1, L, L, 1, 64), "bfloat16")
    got, residual = emulate_tensor_core_kernel(*ts, causal=True)
    want = attention_ref(*ts, causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert residual == 0.0
    assert element_ratio(got, want) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_three_term_split_meets_the_bf16_element_bar_at_head_dim_80(causal):
    """At D = 80 the kernel multiplies tiles laid out as at D = 128 whose
    columns 80..127 are zero: the emulation at D = 128 on zero-padded q,
    k and v (scale 1/√80, as the wrapper passes) gives the same first 80
    columns and zeros after them, within the element bar of the plain
    version at D = 80."""
    _, ts = both(make(80, 1, 256, 256, 2, 80), "bfloat16")
    padded = [torch.nn.functional.pad(t, (0, 48)) for t in ts]
    got, residual = emulate_tensor_core_kernel(
        *padded, causal=causal, scale=1.0 / math.sqrt(80))
    want = attention_ref(*ts, causal=causal)
    assert residual == 0.0
    assert torch.equal(got[..., 80:], torch.zeros_like(got[..., 80:]))
    assert element_ratio(got[..., :80], want) <= 1.0


def test_one_bf16_term_misses_the_element_bar():
    """Why the split: p rounded once to bf16 (the usual tensor-core flash
    attention) breaks the element bar by orders of magnitude."""
    _, ts = both(make(256, 1, 256, 256, 1, 64), "bfloat16")
    got, residual = emulate_tensor_core_kernel(*ts, causal=True, terms=1)
    assert residual > 0.0
    assert element_ratio(got, attention_ref(*ts, causal=True)) > 10.0


# (B, Lq, Lk, H, D, causal, dtype): the reference sweep, a cached-prefix
# shape and zamba2-1.2b's serving head width at a short prompt; then the
# bf16 (tensor-core) kernel at every head width, a ragged length and
# cached-prefix shapes; then D = 80 (hubert-xlarge) in both dtypes,
# causal and not, at its serving length too.
CUDA_SHAPES = [s[:2] + (s[1],) + s[2:] for s in SWEEP] + [
    (2, 16, 200, 2, 64, True, "float32"),
    (1, 2048, 2048, 32, 64, True, "bfloat16"),
    (1, 96, 96, 1, 32, True, "bfloat16"),
    (1, 128, 128, 2, 128, False, "bfloat16"),
    (2, 200, 200, 3, 64, True, "bfloat16"),
    (2, 16, 200, 2, 64, True, "bfloat16"),
    (2, 100, 300, 2, 128, True, "bfloat16"),
    (2, 200, 200, 3, 80, True, "float32"),
    (2, 200, 200, 3, 80, False, "float32"),
    (2, 200, 200, 3, 80, True, "bfloat16"),
    (2, 200, 200, 3, 80, False, "bfloat16"),
    (1, 2048, 2048, 4, 80, False, "bfloat16"),
    (2, 16, 200, 2, 80, True, "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,D,causal,dtype", CUDA_SHAPES)
def test_cuda_kernel_matches_plain(B, Lq, Lk, H, D, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    _, ts = both(make(B * Lq + Lk, B, Lq, Lk, H, D), dtype)
    ts = [t.cuda() for t in ts]
    want = attention_ref(*ts, causal=causal)
    got = flash_attention_cuda(*ts, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=DT[dtype][2])
    if dtype == "bfloat16":
        assert element_ratio(got, want) <= 1.0


# ---------------------------------------------------------------------------
# The backward: plain versions, the autograd wiring and the kernels
# ---------------------------------------------------------------------------
#
# ``attention_bwd_ref`` (the backward kernels' oracle) is held against
# torch.autograd of ``attention_ref`` and against ``jax.vjp`` of the
# reference's jnp ``attention_ref``, in fp32, within the fp32 bar
# 1e-4·max(max|ref|, 1) (fp32 sums in another order), at the reference
# sweep's fp32 shapes, every head dim, causal and not, and a cached-prefix
# shape (Lk > Lq).

BWD_SHAPES = [(B, L, L, H, D, causal) for B, L, H, D, causal, dtype in SWEEP
              if dtype == "float32"] + [
    (2, 200, 200, 3, 80, True), (2, 200, 200, 3, 80, False),
    (1, 64, 64, 2, 128, True), (2, 16, 200, 2, 64, True),
    (1, 50, 70, 2, 32, False)]


def grad_bar(ref):
    """The fp32 bar: 1e-4·max(max|ref|, 1)."""
    return 1e-4 * max(float(ref.abs().max()), 1.0)


def grad_inputs(B, Lq, Lk, H, D, seed=0, dtype=torch.float32):
    arrs = make(seed, B, Lq, Lk, H, D)
    do = np.random.default_rng(seed + 1).normal(
        size=(B, Lq, H, D)).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in arrs + [do]]


@pytest.mark.parametrize("B,Lq,Lk,H,D,causal", BWD_SHAPES)
def test_bwd_ref_matches_autograd_and_reference_vjp(B, Lq, Lk, H, D,
                                                    causal):
    import jax
    q, k, v, do = grad_inputs(B, Lq, Lk, H, D, seed=Lq + D)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = attention_ref(*leaves, causal=causal)
    auto = torch.autograd.grad(o, leaves, do)
    lse = ref_mod.attention_lse_ref(q, k, causal)
    got = ref_mod.attention_bwd_ref(q, k, v, o.detach(), do, lse, causal)
    _, vjp = jax.vjp(lambda a, b, c: j_ref(a, b, c, causal=causal),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(do.numpy()))
    for name, g, a, j in zip("qkv", got, auto, jgrads):
        assert g.dtype == torch.float32 and g.shape == a.shape
        for want in (a, torch.from_numpy(np.array(j))):
            err = float((g - want.float()).abs().max())
            assert err <= grad_bar(want), (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_ref_is_the_rows_logsumexp(causal):
    """Against the reference's masked fp32 logits (jnp), row by row."""
    q, k, _, _ = grad_inputs(2, 40, 72, 3, 32, seed=5)
    got = ref_mod.attention_lse_ref(q, k, causal, max_logits=1000)
    qj, kj = jnp.asarray(q.numpy()), jnp.asarray(k.numpy())
    logits = jnp.einsum("bqhd,bkhd->bhqk", qj, kj) / np.sqrt(32.0)
    if causal:
        qi = jnp.arange(40)[:, None] + 32
        logits = jnp.where(qi >= jnp.arange(72)[None, :], logits, -1e30)
    want = np.asarray(jax_logsumexp(logits, axis=-1))
    assert got.shape == (2, 3, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def jax_logsumexp(x, axis):
    import jax
    return jax.nn.logsumexp(x, axis=axis)


def test_bwd_ref_row_blocking_changes_only_the_sum_order():
    """dK and dV sum the query blocks' contributions: blocked and whole
    agree to fp32 rounding of those sums (1e-5 absolute; the gradients
    here are O(1))."""
    q, k, v, do = grad_inputs(2, 100, 100, 2, 64, seed=9)
    o = attention_ref(q, k, v, causal=True)
    lse = ref_mod.attention_lse_ref(q, k, True)
    whole = ref_mod.attention_bwd_ref(q, k, v, o, do, lse, True,
                                      max_logits=1 << 40)
    parts = ref_mod.attention_bwd_ref(q, k, v, o, do, lse, True,
                                      max_logits=777)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The CUDA entry points swapped for their plain versions, so that
    the custom forward operator and its registered backward run on CPU
    tensors: the autograd wiring, the saved tensors and the launch counts
    are checked here; the kernels' arithmetic only on the card."""
    from repro_torch.kernels.flash_attention import kernel

    def fwd(q, k, v, causal=True, lse=False):
        o = attention_ref(q, k, v, causal)
        return (o, ref_mod.attention_lse_ref(q, k, causal)) if lse else o
    monkeypatch.setattr(kernel, "flash_attention_cuda", fwd)
    monkeypatch.setattr(kernel, "flash_attention_bwd_cuda",
                        ref_mod.attention_bwd_ref)
    monkeypatch.setattr(ops, "LAUNCHES", 0)
    monkeypatch.setattr(ops, "BWD_LAUNCHES", 0)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_gives_the_plain_gradient(plain_kernels, causal):
    q, k, v, do = grad_inputs(2, 48, 48, 2, 32, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention_fwd(*leaves, causal)[0]
    got = torch.autograd.grad(out, leaves, do)
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == (1, 1)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*plain, causal=causal), plain,
                               do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= grad_bar(w)


@pytest.mark.parametrize("remat,fwd_launches", [("none", 1), ("dots", 1),
                                                ("full", 2)])
def test_remat_dots_keeps_the_forward_launch(plain_kernels, remat,
                                             fwd_launches):
    """Under ``remat="dots"`` selective checkpointing keeps the forward
    operator's output, as the reference's ``checkpoint_dots`` keeps
    attention's products: one forward launch per step; ``"full"``
    launches it again in the backward."""
    from repro_torch.models.common import RunConfig
    from repro_torch.models.layers import remat as remat_policy
    q, k, v, do = grad_inputs(1, 32, 32, 2, 32, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    body = remat_policy(lambda a, b, c: ops.flash_attention_fwd(
        a * 2, b, c, True)[0].sin(), RunConfig(remat=remat))
    torch.autograd.grad(body(*leaves), leaves, do)
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == (fwd_launches, 1)


def test_cpu_path_under_grad_is_the_plain_version():
    q, k, v, do = grad_inputs(1, 32, 32, 1, 32, seed=6)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES)
    torch.autograd.grad(ops.flash_attention(*leaves), leaves, do)
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == before


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    from repro_torch.kernels.flash_attention import kernel
    q, k, v, do = grad_inputs(1, 32, 32, 1, 32)
    lse = torch.zeros((1, 1, 32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.flash_attention_bwd_cuda(q, k, v, q, do, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.bwd_preprocess_cuda(q, do)


# Bars of the backward kernels against ``attention_bwd_ref`` on the card
# (chip_smoke.py's FA_BWD_*): fp32 |Δ| <= 1e-4·max(max|ref|, 1); bf16 (the
# plain version in fp32 on the same bf16 inputs, o and lse) |Δ| <=
# 2^-7·|ref| + 1e-5·max|ref| per element of each tensor: the kernels
# compute in fp32 and round once to bf16.
BWD_BF16_REL, BWD_BF16_ABS = 2.0 ** -7, 1e-5
CUDA_BWD_SHAPES = [s + (dt,) for s in BWD_SHAPES
                   for dt in ("float32", "bfloat16")] + [
    (1, 2048, 2048, 8, 128, True, "bfloat16"),
    (1, 1024, 1024, 4, 80, False, "bfloat16"),
    (1, 1024, 1024, 4, 64, True, "bfloat16")]


def bwd_within_bar(got, want, dtype):
    g, w = got.float(), want.float()
    if dtype == "float32":
        return float((g - w).abs().max()) <= grad_bar(w)
    bar = BWD_BF16_REL * w.abs() + BWD_BF16_ABS * float(w.abs().max())
    return bool(((g - w).abs() <= bar).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,D,causal,dtype", CUDA_BWD_SHAPES)
def test_cuda_backward_kernels_match_plain(B, Lq, Lk, H, D, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.flash_attention import kernel
    tdt = DT[dtype][1]
    q, k, v, do = (t.cuda() for t in grad_inputs(B, Lq, Lk, H, D, 1, tdt))
    o, lse = kernel.flash_attention_cuda(q, k, v, causal, lse=True)
    want_lse = ref_mod.attention_lse_ref(q, k, causal)
    torch.cuda.synchronize()
    assert float((lse - want_lse).abs().max()) <= 1e-4 * max(
        float(want_lse.abs().max()), 1.0)
    got = kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal)
    want = ref_mod.attention_bwd_ref(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and g.shape == w.shape, name
        assert bwd_within_bar(g, w, dtype), name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_autograd_function_matches_plain_autograd(causal):
    """``flash_attention`` under grad on CUDA tensors (fp32): the kernels'
    gradient against torch.autograd of the plain version, one forward
    and one backward pass counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, do = (t.cuda() for t in grad_inputs(2, 200, 200, 3, 64, 2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES)
    out = ops.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    assert (ops.LAUNCHES - before[0], ops.BWD_LAUNCHES - before[1]) == (1, 1)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*plain, causal=causal), plain,
                               do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= grad_bar(w)
