"""repro_torch flash attention ≡ the reference's, on the CPU.

The port's plain version (``repro_torch.kernels.flash_attention.ref``,
what ``ops.flash_attention`` runs on CPU tensors) is held against the
reference's Pallas kernel in interpret mode and its jnp ``attention_ref``
on the same seeded numpy inputs, at the reference sweep's shapes
(``tests/test_kernels.py``) and tolerances: 2e-5 in fp32, 2e-2 in bf16
(the jnp oracle rounds logits and probabilities to bf16, the kernel and
the port's plain version keep them in fp32).  The CUDA kernel is held
against the plain version on the card (``cuda`` marker).

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


def emulate_tensor_core_kernel(q, k, v, causal=True, terms=3):
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
    Returns the output and the largest split residual."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    c = (torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
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
# cached-prefix shapes.
CUDA_SHAPES = [s[:2] + (s[1],) + s[2:] for s in SWEEP] + [
    (2, 16, 200, 2, 64, True, "float32"),
    (1, 2048, 2048, 32, 64, True, "bfloat16"),
    (1, 96, 96, 1, 32, True, "bfloat16"),
    (1, 128, 128, 2, 128, False, "bfloat16"),
    (2, 200, 200, 3, 64, True, "bfloat16"),
    (2, 16, 200, 2, 64, True, "bfloat16"),
    (2, 100, 300, 2, 128, True, "bfloat16")]


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
