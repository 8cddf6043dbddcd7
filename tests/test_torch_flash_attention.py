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
The bf16 backward kernels do the same with P and dS
(``emulate_tensor_core_bwd``); both emulations also take the order the
kernels use above a column bucket of 128 (``carry``).  The fp32 backward
kernels take every product as three TF32 products on split operands
(``emulate_tf32_bwd``, ``tf32_rna``), held here to the fp32 bar against
the reference's ``jax.vjp``; one or two TF32 products miss it.

Head dims: the plain forward and backward against the reference across
1 <= D <= 256 (``HEAD_DIMS``), the kernels' buckets and bf16 padding,
and the Python mirrors of the kernels' shared memory.
"""
import functools
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


# Head dims across the kernels' domain (1 <= D <= 256): below, inside and
# at the top of each column bucket, multiples of 8 and not (100, 200 are
# padded to 104, 200 in bf16 on the card), with Lk != Lq (a cached
# prefix under causal).
HEAD_DIMS = (8, 24, 48, 96, 100, 112, 160, 192, 200, 256)
DOMAIN = [(D, causal, dtype) for D in HEAD_DIMS for causal in (True, False)
          for dtype in DT]


@pytest.mark.parametrize("D,causal,dtype", DOMAIN)
def test_plain_matches_reference_at_every_head_dim(D, causal, dtype):
    js, ts = both(make(D, 1, 40, 72, 2, D), dtype)
    got = ops.flash_attention(*ts, causal=causal)
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    tol = DT[dtype][2]
    for ref in (j_fa(*js, causal=causal, interpret=True),
                j_ref(*js, causal=causal)):
        np.testing.assert_allclose(as_np(got), as_np(ref), atol=tol)


@pytest.mark.parametrize("D,causal,dtype", DOMAIN)
def test_plain_backward_matches_reference_vjp_at_every_head_dim(D, causal,
                                                                dtype):
    """The port's plain backward (``attention_bwd_ref`` from the plain
    forward's output and log-sum-exp) against ``jax.vjp`` of the
    reference's jnp attention on the same inputs, at the forward's
    tolerances."""
    import jax
    jdt, tdt, tol = DT[dtype]
    arrs = make(D + 1, 1, 40, 72, 2, D)
    do = np.random.default_rng(D).normal(size=(1, 40, 2, D)) \
        .astype(np.float32)
    q, k, v, dot = (torch.from_numpy(a).to(tdt) for a in arrs + [do])
    o = attention_ref(q, k, v, causal)
    lse = ref_mod.attention_lse_ref(q, k, causal)
    got = ref_mod.attention_bwd_ref(q, k, v, o, dot, lse, causal)
    _, vjp = jax.vjp(lambda a, b, c: j_ref(a, b, c, causal=causal),
                     *(jnp.asarray(a, jdt) for a in arrs))
    want = vjp(jnp.asarray(do, jdt))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and g.shape == w.shape, name
        np.testing.assert_allclose(as_np(g), as_np(w), atol=tol,
                                   err_msg=name)


def test_buckets_cover_every_head_dim():
    """Every D from 1 to 256 lands in the smallest bucket that holds it,
    at a launch width (bf16: the next multiple of 8) inside that bucket;
    D = 0 and D = 257 are refused with the limit named."""
    from repro_torch.kernels.flash_attention import kernel
    for D in range(1, kernel.MAX_HEAD_DIM + 1):
        w = kernel.bucket(D)
        assert w in kernel.BUCKETS and D <= w
        assert all(b < D for b in kernel.BUCKETS if b < w)
        padded = kernel.padded_dim(D, torch.bfloat16)
        assert padded % 8 == 0 and D <= padded < D + 8 and padded <= w
        assert kernel.padded_dim(D, torch.float32) == D
    for D in (0, kernel.MAX_HEAD_DIM + 1):
        with pytest.raises(ValueError, match="outside 1..256"):
            kernel.bucket(D)
        with pytest.raises(ValueError, match="outside 1..256"):
            kernel.padded_dim(D, torch.bfloat16)


def test_padding_round_trip():
    """The wrappers' zero-padding along D and the cut back: a bf16 D that
    is not a multiple of 8 is padded with zero columns to the next one
    (new contiguous tensors) and a padded output cut back to its first D
    columns, contiguous; fp32 and bf16 multiples of 8 pass untouched."""
    from repro_torch.kernels.flash_attention import kernel
    _, ts = both(make(3, 1, 20, 30, 2, 100), "bfloat16")
    padded = kernel._padded(*ts)
    assert all(p.shape[-1] == 104 and p.is_contiguous() for p in padded)
    assert all(torch.equal(p[..., :100], t) and not p[..., 100:].any()
               for p, t in zip(padded, ts))
    cut = kernel._cut(padded[0], 100)
    assert cut.is_contiguous() and torch.equal(cut, ts[0])
    assert kernel._cut(ts[0], 100) is ts[0]
    fp32 = [t.float() for t in ts]
    assert all(a is b for a, b in zip(kernel._padded(*fp32), fp32))
    _, even = both(make(3, 1, 20, 30, 2, 96), "bfloat16")
    assert all(a is b for a, b in zip(kernel._padded(*even), even))


# The fp32 kernels' shared memory at each bucket, as the sources' headers
# state it (64 rows a block up to W = 128, 32 above).
TF32_SMEM = {"fa_kernel_tf32": {32: 49_152, 64: 98_304, 128: 196_608,
                                192: 147_456, 256: 196_608},
             "fa_bwd_dkdv_tf32": {32: 66_560, 64: 115_712, 128: 214_016,
                                  192: 152_064, 256: 201_216},
             "fa_bwd_dq_tf32": {32: 49_152, 64: 98_304, 128: 196_608,
                                192: 147_456, 256: 196_608}}


@pytest.mark.parametrize("W", [32, 64, 128, 192, 256])
@pytest.mark.parametrize("name", ["fa_kernel_tc", "fa_kernel_tf32",
                                  "fa_bwd_dkdv_tc", "fa_bwd_dq_tc",
                                  "fa_bwd_dkdv_tf32", "fa_bwd_dq_tf32"])
def test_shared_memory_fits_at_every_bucket(name, W):
    """The Python mirrors of the sources' shared-memory formulas (checked
    against the libraries' own on the card by chip_smoke.py) stay under
    the 232,448 bytes a Hopper block may use at every bucket; the fp32
    backward's are the source's stated figures."""
    from repro_torch.kernels.flash_attention import kernel
    smem, _ = kernel.SMEM[name]
    assert 0 < smem(W) <= kernel.SMEM_LIMIT == 232_448
    if name in TF32_SMEM:
        assert smem(W) == TF32_SMEM[name][W]
        assert kernel.f32_rows(W) == (64 if W <= 128 else 32)


@pytest.mark.parametrize("D,tiles", [(1, 2), (8, 2), (17, 4), (32, 4),
                                     (48, 8), (64, 8), (80, 10), (96, 12),
                                     (100, 16), (128, 16), (160, 20),
                                     (192, 24), (200, 26), (256, 32)])
def test_tf32_forward_pv_stops_at_the_last_head_column(D, tiles):
    """``fa_kernel_tf32`` computes p·v over whole groups of
    ``Tf32<W>::NG`` output n-tiles and a last group cut to 2, 4 or NG
    n-tiles, never short of column D − 1 and never past its bucket: D =
    80 takes 10 n-tiles of its bucket's 16 (the 3×TF32 MMA floor that
    chip_smoke.py prints counts these)."""
    from repro_torch.kernels.flash_attention import kernel
    W = kernel.bucket(D)
    assert kernel.tf32_group(W) == {32: 4, 64: 8, 128: 8, 192: 8,
                                    256: 4}[W]
    got = kernel.fwd_tf32_pv_tiles(D)
    assert got == tiles and 8 * got >= D and got <= W // 8


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


def emulate_tensor_core_kernel(q, k, v, causal=True, terms=3, scale=None,
                               carry=False):
    """The bf16 CUDA kernel's arithmetic in torch, on the CPU.

    Per key tile of 64: raw logits S from bf16 q·kᵀ summed in fp32,
    masked with -1e30; with c = scale·log2(e) in fp32, the running row
    max m of S, mL = m·c, p = exp2(fma(S, c, −mL)) and O's rescale factor
    alpha = exp2(mL_old − mL_new); the tile's T = p1·V + p2·V + p3·V with
    p split into bf16 terms and V in bf16, summed in fp32 from zero; then
    O = fma(O, alpha, T); finally O / l in q's dtype.  With ``carry`` (the
    kernel's order at column buckets above 128) O = O·alpha first and each
    k16 step's product of each term is added to O itself, in the kernel's
    order (``carry_sum``).  This model uses an
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
        if carry:
            o = carry_sum(o * alpha, [t.float() for t in parts], vt)
        else:
            o = fma(o, alpha, tile_sum([t.float() for t in parts], vt))
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


@pytest.mark.parametrize("L", [256, 2048])
@pytest.mark.parametrize("D", [192, 256])
def test_carried_accumulator_meets_the_bf16_element_bar(D, L):
    """At the buckets above 128 the kernel rescales O and lets each k16
    step's product of the three terms accumulate into it (no tile sum
    fits the registers beside O): that order stays within one bf16 step
    of the plain version at every element."""
    _, ts = both(make(L + D, 1, L, L, 1, D), "bfloat16")
    got, residual = emulate_tensor_core_kernel(*ts, causal=True, carry=True)
    want = attention_ref(*ts, causal=True)
    assert residual == 0.0
    assert element_ratio(got, want) <= 1.0


# A head dim below its bucket, padded as the kernels see it: bf16 24 in
# bucket 32; 96 (Phi-3-mini's) in 128 with the tile sums; 200 in 256,
# carried.
PADDED = [(24, 32, False), (96, 128, False), (200, 256, True)]


@pytest.mark.parametrize("D,W,carry", PADDED)
def test_padded_head_dims_meet_the_bf16_element_bar(D, W, carry):
    """Tiles of the bucket's W columns, zero past D (scale 1/√D): the
    first D output columns within the element bar of the plain version
    at D, zeros after them."""
    _, ts = both(make(D, 1, 256, 256, 2, D), "bfloat16")
    padded = [torch.nn.functional.pad(t, (0, W - D)) for t in ts]
    for causal in (True, False):
        got, residual = emulate_tensor_core_kernel(
            *padded, causal=causal, scale=1.0 / math.sqrt(D), carry=carry)
        assert residual == 0.0
        assert not got[..., D:].any()
        assert element_ratio(got[..., :D],
                             attention_ref(*ts, causal=causal)) <= 1.0


def test_one_bf16_term_misses_the_element_bar():
    """Why the split: p rounded once to bf16 (the usual tensor-core flash
    attention) breaks the element bar by orders of magnitude."""
    _, ts = both(make(256, 1, 256, 256, 1, 64), "bfloat16")
    got, residual = emulate_tensor_core_kernel(*ts, causal=True, terms=1)
    assert residual > 0.0
    assert element_ratio(got, attention_ref(*ts, causal=True)) > 10.0


def emulate_tensor_core_bwd(q, k, v, do, lse, delta, causal=True, terms=3,
                            scale=None, carry=False):
    """The bf16 backward kernels' arithmetic (``fa_bwd_dkdv_tc``,
    ``fa_bwd_dq_tc``) in torch, on the CPU.

    Per (64-key, 64-query) tile: S = q·kᵀ and dP = dO·vᵀ from bf16
    inputs summed in fp32; with c = scale·log2(e) and l2 = lse·log2(e) in
    fp32, P = exp2(fma(S, c, −l2)), 0 where masked; dS = P ∘ (dP − D).
    P and dS are split into bf16 terms; each tile's dV = Σ Pᵀ-terms·dO,
    dK = Σ dSᵀ-terms·q and dQ = Σ dS-terms·k is summed in fp32 from
    zero and added to an fp32 running sum (dK/dV over the query tiles in
    order, dQ over the key tiles in order), as the kernels fold each
    tile; with ``carry`` (the kernels' order at column buckets above 128)
    each k16 step's product of each term is added to the running sum
    itself (``carry_sum``).  dK and dQ are scaled once at the end and all
    three rounded to
    q's dtype.  Tiles wholly above the causal diagonal are skipped, as
    the kernels skip them.  This model uses an exact exp2 and sums
    rounded to nearest; the card's ``ex2.approx.ftz`` and the tensor
    cores' own accumulation are covered by the ``cuda``-marked tests and
    chip_smoke.py's phase 6.  ``lse`` and ``delta`` are fp32 [B, H, Lq];
    ``scale`` defaults to 1/√D.  Returns (dq, dk, dv) and the largest
    split residual."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    c = f32(scale) * f32(LOG2E)
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    l2 = (lse.float() * f32(LOG2E))[..., None]
    dl = delta.float()[..., None]
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    off = Lk - Lq
    residual = 0.0

    def terms_of(x):
        nonlocal residual
        parts, rest = split_bf16(x, terms)
        residual = max(residual, float(rest.abs().max()))
        return [t.float() for t in parts]

    for k0 in range(0, Lk, KEY_TILE):
        ks, vs = kf[:, :, k0:k0 + KEY_TILE], vf[:, :, k0:k0 + KEY_TILE]
        ki = torch.arange(k0, min(k0 + KEY_TILE, Lk))[None, :]
        for q0 in range(0, Lq, KEY_TILE):
            if causal and min(q0 + KEY_TILE, Lq) - 1 + off < k0:
                continue
            qs, dos = qf[:, :, q0:q0 + KEY_TILE], dof[:, :, q0:q0 + KEY_TILE]
            s = qs @ ks.transpose(-1, -2)
            dp = dos @ vs.transpose(-1, -2)
            p = torch.exp2(fma(s, c, -l2[:, :, q0:q0 + KEY_TILE]))
            if causal:
                qi = torch.arange(q0, min(q0 + KEY_TILE, Lq))[:, None] + off
                p = torch.where(qi >= ki, p, torch.zeros(()))
            ds = p * (dp - dl[:, :, q0:q0 + KEY_TILE])
            p_t, ds_t = terms_of(p), terms_of(ds)
            for acc, rows, a_terms, b in (
                    (dv, slice(k0, k0 + KEY_TILE),
                     [t.transpose(-1, -2) for t in p_t], dos),
                    (dk, slice(k0, k0 + KEY_TILE),
                     [t.transpose(-1, -2) for t in ds_t], qs),
                    (dq, slice(q0, q0 + KEY_TILE), ds_t, ks)):
                if carry:
                    acc[:, :, rows] = carry_sum(acc[:, :, rows], a_terms, b)
                else:
                    acc[:, :, rows] += tile_sum(a_terms, b)
    sc = f32(scale)
    return tuple((g * m).permute(0, 2, 1, 3).to(q.dtype)
                 for g, m in ((dq, sc), (dk, sc), (dv, 1.0))), residual


def tile_sum(a_terms, b):
    """Σ a·b over the terms, summed in fp32 from zero in term order."""
    t = a_terms[0] @ b
    for a in a_terms[1:]:
        t = t + a @ b
    return t


def carry_sum(acc, a_terms, b, step=16):
    """acc + Σ a·b with each k16 step's product of each term added to acc
    in turn (steps outer, terms inner), as wgmma accumulates into a
    carried accumulator; fp32 sums."""
    for j in range(0, b.shape[-2], step):
        for a in a_terms:
            acc = acc + a[..., j:j + step] @ b[..., j:j + step, :]
    return acc


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
    (2, 16, 200, 2, 80, True, "bfloat16")] + [
    # Every bucket, inside and at its top, padded or not, both dtypes,
    # causal over a cached prefix and non-causal with Lq > Lk.
    (B, Lq, Lk, 2, D, causal, dtype) for D in HEAD_DIMS
    for B, Lq, Lk, causal in ((1, 130, 200, True), (2, 100, 70, False))
    for dtype in DT] + [
    (4, 2048, 2048, 4, 96, True, "bfloat16"),
    (1, 2048, 2048, 4, 256, True, "bfloat16")]


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
    for wrapper in (kernel.bwd_dkdv_cuda, kernel.bwd_dq_cuda):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            wrapper(q, k, v, do, lse, lse)


def test_backward_kernels_follow_the_dtype():
    """bf16 goes to the wgmma kernels, fp32 to the TF32 mma.sync ones; a
    tensor the tensor maps would read at an odd offset is copied to an
    aligned one first, not refused."""
    from repro_torch.kernels.flash_attention import kernel
    assert kernel.bwd_kernel("dkdv", torch.bfloat16) == "fa_bwd_dkdv_tc"
    assert kernel.bwd_kernel("dq", torch.bfloat16) == "fa_bwd_dq_tc"
    assert kernel.bwd_kernel("dkdv", torch.float32) == "fa_bwd_dkdv_tf32"
    assert kernel.bwd_kernel("dq", torch.float32) == "fa_bwd_dq_tf32"
    assert set(kernel.BWD_KERNEL_LAUNCHES) == set(kernel.BWD_KERNELS)
    flat = torch.arange(1 + 2 * 3 * 32, dtype=torch.bfloat16)
    view = flat[1:].view(1, 2, 3, 32)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    ready = kernel._tma_ready(view)
    assert ready.data_ptr() % 16 == 0 and torch.equal(ready, view)
    whole = flat[:-1].view(1, 2, 3, 32)
    assert kernel._tma_ready(whole).data_ptr() == whole.data_ptr()


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
    (1, 1024, 1024, 4, 64, True, "bfloat16"),
    # The tensor-core kernels at ragged lengths: non-causal with Lq > Lk
    # and Lq < Lk, causal with Lk > Lq (the diagonal inside a key tile),
    # at every head dim.
    (2, 130, 70, 2, 128, False, "bfloat16"),
    (1, 70, 130, 3, 80, False, "bfloat16"),
    (2, 100, 300, 2, 128, True, "bfloat16"),
    (1, 70, 333, 2, 80, True, "bfloat16"),
    (2, 190, 250, 2, 64, True, "bfloat16"),
    (1, 33, 100, 4, 32, True, "bfloat16")] + [
    (B, Lq, Lk, 2, D, causal, dtype) for D in HEAD_DIMS
    for B, Lq, Lk, causal in ((1, 130, 200, True), (2, 100, 70, False))
    for dtype in ("float32", "bfloat16")] + [
    (1, 2048, 2048, 4, 96, True, "bfloat16"),
    (1, 2048, 2048, 4, 256, True, "bfloat16")]


def bwd_within_bar(got, want, dtype):
    g, w = got.float(), want.float()
    if dtype == "float32":
        return float((g - w).abs().max()) <= grad_bar(w)
    bar = BWD_BF16_REL * w.abs() + BWD_BF16_ABS * float(w.abs().max())
    return bool(((g - w).abs() <= bar).all())


def bwd_bf16_ratio(got, want):
    """Worst |Δ| / (2^-7·|ref| + 1e-5·max|ref|) of one tensor; at most 1
    passes."""
    g, w = got.float(), want.float()
    bar = BWD_BF16_REL * w.abs() + BWD_BF16_ABS * float(w.abs().max())
    return float(((g - w).abs() / bar).max())


def bf16_bwd_case(L, H, D, causal, seed):
    """bf16 q, k, v, dO and what the kernels get from the forward and the
    preprocess (o, lse, D), with attention_bwd_ref's (dq, dk, dv)."""
    q, k, v, do = grad_inputs(1, L, L, H, D, seed=seed, dtype=torch.bfloat16)
    o = attention_ref(q, k, v, causal)
    lse = ref_mod.attention_lse_ref(q, k, causal)
    delta = ref_mod.bwd_preprocess_ref(o, do)
    want = ref_mod.attention_bwd_ref(q, k, v, o, do, lse, causal)
    return (q, k, v, do, lse, delta), want


@pytest.mark.parametrize("L", [256, 2048])
def test_backward_three_term_split_meets_the_bf16_element_bar(L):
    """The bf16 backward kernels' arithmetic (bf16 products, P and dS in
    three bf16 terms, each tile summed from zero and added in fp32) keeps
    dq, dk and dv within the element bar of attention_bwd_ref, and the
    three terms hold P and dS exactly."""
    args, want = bf16_bwd_case(L, 1, 64, True, seed=L)
    got, residual = emulate_tensor_core_bwd(*args, causal=True)
    assert residual == 0.0
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert bwd_bf16_ratio(g, w) <= 1.0, name


@pytest.mark.parametrize("causal", [True, False])
def test_backward_three_term_split_meets_the_bf16_element_bar_at_head_dim_80(
        causal):
    """At D = 80 the kernels multiply tiles laid out as at D = 128 whose
    columns 80..127 are zero: the emulation at D = 128 on zero-padded q,
    k, v and dO (scale 1/√80) gives zeros past column 80 and, before it,
    dq, dk and dv within the element bar of the plain version at D = 80."""
    args, want = bf16_bwd_case(256, 2, 80, causal, seed=80)
    padded = [torch.nn.functional.pad(t, (0, 48)) for t in args[:4]]
    got, residual = emulate_tensor_core_bwd(
        *padded, *args[4:], causal=causal, scale=1.0 / math.sqrt(80))
    assert residual == 0.0
    for name, g, w in zip("qkv", got, want):
        assert torch.equal(g[..., 80:], torch.zeros_like(g[..., 80:])), name
        assert bwd_bf16_ratio(g[..., :80], w) <= 1.0, name


@pytest.mark.parametrize("L", [256, 2048])
@pytest.mark.parametrize("D", [192, 256])
def test_backward_carried_accumulator_meets_the_bf16_element_bar(D, L):
    """At the buckets above 128 the bf16 backward kernels add each k16
    step's product of the three terms of Pᵀ or dS to the running dV, dK
    or dQ itself: dq, dk and dv stay within the element bar."""
    args, want = bf16_bwd_case(L, 1, D, True, seed=L + D)
    got, residual = emulate_tensor_core_bwd(*args, causal=True, carry=True)
    assert residual == 0.0
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert bwd_bf16_ratio(g, w) <= 1.0, name


@pytest.mark.parametrize("D,W,carry", PADDED)
def test_backward_padded_head_dims_meet_the_bf16_element_bar(D, W, carry):
    """The backward on tiles of W columns, zero past D (scale 1/√D): zeros
    past column D and, before it, dq, dk and dv within the element bar of
    the plain version at D."""
    for causal in (True, False):
        args, want = bf16_bwd_case(256, 2, D, causal, seed=D)
        padded = [torch.nn.functional.pad(t, (0, W - D)) for t in args[:4]]
        got, residual = emulate_tensor_core_bwd(
            *padded, *args[4:], causal=causal, scale=1.0 / math.sqrt(D),
            carry=carry)
        assert residual == 0.0
        for name, g, w in zip("qkv", got, want):
            assert not g[..., D:].any(), name
            assert bwd_bf16_ratio(g[..., :D], w) <= 1.0, name


def test_backward_one_bf16_term_misses_the_element_bar():
    """Why the split: P and dS rounded once to bf16 (the usual
    tensor-core backward) break the element bar."""
    args, want = bf16_bwd_case(256, 1, 64, True, seed=256)
    got, residual = emulate_tensor_core_bwd(*args, causal=True, terms=1)
    assert residual > 0.0
    assert max(bwd_bf16_ratio(g, w) for g, w in zip(got, want)) > 10.0


def tf32_rna(x):
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds (the fp32 backward
    kernels' ``split_tf32`` does it in integer arithmetic): half a TF32
    step added to the bits, the 13 bits below cleared; ±inf stays, NaN
    stays NaN, a value past the largest TF32 goes to inf."""
    x = x.float()
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return torch.where(torch.isnan(x), x, r.view(torch.float32))


def tf32_cut(x):
    """fp32 ``x`` as the tensor cores read a .tf32 operand: its 13 lowest
    bits dropped (the kernels pass lo = x − hi unrounded)."""
    u = x.float().contiguous().view(torch.int32)
    return (u & -0x2000).view(torch.float32)


def tf32_product(a, b, terms=3, apart=False):
    """a @ b as the fp32 backward kernels take it on the tensor cores:
    hi = tf32_rna(x), lo = tf32_cut(x − hi) for each operand, TF32
    products exact in fp32 and summed in fp32.  ``terms``: 1 is
    hi·hi (plain TF32), 2 adds lo_a·hi_b (only a split), 3 adds
    hi_a·lo_b as well (the kernels' hi·hi + hi·lo + lo·hi).  ``apart``:
    the correction terms summed on their own and added to hi·hi at the
    end (the forward's q·kᵀ, ``qk_tf32``).

    The operands are the kernels', the sums are not: torch's fp32 matmul
    rounds where the tensor cores' accumulation over each k8 step cuts
    its low bits, so a fault of that kind (a sum carried across many
    tiles drifting) shows only on the card, where phase 6 of
    chip_smoke.py holds the kernels to the same bar."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    t = ah @ bh
    terms_lo = [tf32_cut(a - ah) @ bh] if terms >= 2 else []
    if terms >= 3:
        terms_lo.insert(0, ah @ tf32_cut(b - bh))
    if apart and terms_lo:
        return t + sum(terms_lo[1:], terms_lo[0])
    for x in reversed(terms_lo):
        t = t + x
    return t


def emulate_tf32_bwd(q, k, v, do, lse, delta, causal=True, terms=3,
                     scale=None, rows=64):
    """The fp32 backward kernels' arithmetic (``fa_bwd_dkdv_tf32``,
    ``fa_bwd_dq_tf32``) in torch, on the CPU, with each product's sum
    rounded where the tensor cores cut it (``tf32_product``).

    Blocks of ``rows`` keys (dK/dV) or queries (dQ) against tiles of
    ``rows`` of the other side (``kernel.f32_rows``), tiles wholly
    above the causal diagonal skipped.  Per tile: Sᵀ = k·qᵀ and
    dPᵀ = v·dOᵀ summed from zero (``tf32_product``), P = exp(fma(S,
    scale, −lse)) in fp32, 0 where masked, dS = P ∘ (dP − D); each
    tile's dV = Pᵀ·dO, dK = dSᵀ·q is summed from zero and added to an
    fp32 running sum.  dQ: each half of a key tile's rows summed from
    zero into that half's running sum, the halves added at the end.  dK
    and dQ scaled once at the end.  Returns (dq, dk, dv) in fp32."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    sc = torch.tensor(scale, dtype=torch.float32)
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    lse, dl = lse.float()[..., None], delta.float()[..., None]
    off = Lk - Lq

    def p_ds(qs, ks, dos, vs, q0, k0):
        s = tf32_product(qs, ks.transpose(-1, -2), terms)
        dp = tf32_product(dos, vs.transpose(-1, -2), terms)
        p = torch.exp(fma(s, sc, -lse[:, :, q0:q0 + qs.shape[2]]))
        if causal:
            qi = torch.arange(q0, q0 + qs.shape[2])[:, None] + off
            ki = torch.arange(k0, k0 + ks.shape[2])[None, :]
            p = torch.where(qi >= ki, p, torch.zeros(()))
        return p, p * (dp - dl[:, :, q0:q0 + qs.shape[2]])

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, Lk, rows):
        ks, vs = kf[:, :, k0:k0 + rows], vf[:, :, k0:k0 + rows]
        first = max(0, k0 - off) // rows if causal else 0
        for q0 in range(first * rows, Lq, rows):
            qs, dos = qf[:, :, q0:q0 + rows], dof[:, :, q0:q0 + rows]
            p, ds = p_ds(qs, ks, dos, vs, q0, k0)
            dv[:, :, k0:k0 + rows] += tf32_product(p.transpose(-1, -2), dos,
                                                   terms)
            dk[:, :, k0:k0 + rows] += tf32_product(ds.transpose(-1, -2), qs,
                                                   terms)
    dq = torch.zeros_like(qf)
    for q0 in range(0, Lq, rows):
        qs, dos = qf[:, :, q0:q0 + rows], dof[:, :, q0:q0 + rows]
        last = min(q0 + rows, Lq) - 1 + off if causal else Lk - 1
        halves = [torch.zeros_like(qs), torch.zeros_like(qs)]
        for k0 in range(0, min(Lk, last + 1), rows):
            for h in (0, 1):
                a = k0 + h * rows // 2
                ks = kf[:, :, a:min(a + rows // 2, Lk)]
                if not ks.shape[2]:
                    continue
                _, ds = p_ds(qs, ks, dos, vf[:, :, a:a + ks.shape[2]], q0, a)
                halves[h] += tf32_product(ds, ks, terms)
        dq[:, :, q0:q0 + rows] = halves[0] + halves[1]
    return tuple((g * m).permute(0, 2, 1, 3)
                 for g, m in ((dq, sc), (dk, sc), (dv, 1.0)))


@functools.lru_cache(maxsize=None)
def tf32_case(B, L, H, D, causal, seed):
    """fp32 q, k, v, dO; what the kernels get from the forward and the
    preprocess (lse, D); the reference's ``jax.vjp`` of its fp32
    ``attention_ref``."""
    import jax
    q, k, v, do = grad_inputs(B, L, L, H, D, seed=seed)
    o = attention_ref(q, k, v, causal)
    lse = ref_mod.attention_lse_ref(q, k, causal)
    delta = ref_mod.bwd_preprocess_ref(o, do)
    _, vjp = jax.vjp(lambda a, b, c: j_ref(a, b, c, causal=causal),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(
        do.numpy()))]
    return (q, k, v, do, lse, delta), want


# (B, L, H, D, causal): the reference sweep's fp32 shapes, head dim 80
# (hubert-xlarge) both ways, and W = 256 (32 rows a block).
TF32_SHAPES = [(B, L, H, D, causal) for B, L, H, D, causal, dtype in SWEEP
               if dtype == "float32"] + [
    (2, 200, 3, 80, True), (1, 256, 2, 80, False), (1, 256, 2, 256, True)]


def tf32_ratios(terms):
    """Worst |Δ| / (1e-4·max(max|ref|, 1)) of dq, dk, dv per shape."""
    from repro_torch.kernels.flash_attention import kernel
    out = {}
    for B, L, H, D, causal in TF32_SHAPES:
        args, want = tf32_case(B, L, H, D, causal, seed=L + D)
        got = emulate_tf32_bwd(*args, causal=causal, terms=terms,
                               rows=kernel.f32_rows(kernel.bucket(D)))
        out[(B, L, H, D, causal)] = max(
            float((g - w).abs().max()) / grad_bar(w)
            for g, w in zip(got, want))
    return out


def test_tf32_rna_rounds_as_cvt_rna_tf32():
    """Ties go away from zero on either sign, a value under the tie goes
    down, the tie of the smallest subnormals rounds up to the next TF32
    subnormal, ±inf and NaN stay; every result has its 13 low bits clear
    and lies within half a TF32 step (2^-11 relative) of its input."""
    one = 1.0 + 2.0 ** -10                     # the TF32 after 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0 + 3 * 2.0 ** -11,
                      float("inf"), float("-inf"), 0.0, -0.0])
    want = torch.tensor([one, -one, 1.0, 1.0 + 2.0 ** -9, float("inf"),
                         float("-inf"), 0.0, -0.0])
    got = tf32_rna(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    # Subnormals: a tie, one under it, a tie above an odd step, and a
    # negative tie (bits 0x80001000 → 0x80002000).
    neg = -(1 << 31)
    sub = torch.tensor([0x1000, 0x0FFF, 0x3000, neg + 0x1000],
                       dtype=torch.int32).view(torch.float32)
    bits = tf32_rna(sub).view(torch.int32).tolist()
    assert bits == [0x2000, 0, 0x4000, neg + 0x2000]
    nan = tf32_rna(torch.tensor([float("nan"), -float("nan")]))
    assert torch.isnan(nan).all()
    assert float(tf32_rna(torch.tensor([3.4028235e38]))[0]) == float("inf")
    r = torch.from_numpy(np.random.default_rng(0).normal(
        size=10_000).astype(np.float32)) * 1e3
    t = tf32_rna(r)
    assert not (t.view(torch.int32) & 0x1FFF).any()
    assert ((t - r).abs() <= r.abs() * 2.0 ** -11).all()
    assert torch.equal(tf32_cut(t), t)


@pytest.mark.parametrize("B,L,H,D,causal", TF32_SHAPES)
def test_tf32_three_terms_meet_the_fp32_backward_bar(B, L, H, D, causal):
    """The fp32 backward kernels' arithmetic (every product three TF32
    products on split operands, tile sums from zero added in fp32) keeps
    dq, dk and dv within 1e-4·max(max|ref|, 1) of the reference's fp32
    ``jax.vjp``, with a margin of 10: at the sweep's shapes, head dim 80
    and the 256 bucket's 32-row blocks."""
    from repro_torch.kernels.flash_attention import kernel
    args, want = tf32_case(B, L, H, D, causal, seed=L + D)
    got = emulate_tf32_bwd(*args, causal=causal,
                           rows=kernel.f32_rows(kernel.bucket(D)))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert float((g - w).abs().max()) <= 0.1 * grad_bar(w), name


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_tf32_term_counts(terms):
    """One TF32 product (plain TF32) and two (only one operand split) miss
    the fp32 bar at every shape; three (hi·hi + hi·lo + lo·hi, the
    kernels') meet it.  The worst ratios are printed (``-s``)."""
    ratios = tf32_ratios(terms)
    print(f"\nterms={terms}: worst max|Δ|/bar " + ", ".join(
        f"{list(k)} {v:.4f}" for k, v in ratios.items()))
    if terms < 3:
        assert min(ratios.values()) > 1.0, ratios
    else:
        assert max(ratios.values()) <= 0.1, ratios


def emulate_tf32_fwd(q, k, v, causal=True, terms=3, rows=64, width=None):
    """The fp32 forward kernel's arithmetic (``fa_kernel_tf32``) in torch,
    on the CPU, each product's sum rounded where the tensor cores cut it
    (``tf32_product``).

    Key tiles of ``rows`` keys (``kernel.f32_rows``), each split into
    halves of ``rows / 2``; a block's warps take half h of every tile
    with their own running row max m, sum l and output O.  Per half: S =
    q·kᵀ summed from zero (hi·hi apart from hi·lo + lo·hi, added at
    the end), logits S·scale, −1e30 where masked; m_new =
    max(m, row max), alpha = exp(m − m_new), p = exp(x − m_new) (0 where
    masked), l = l·alpha + Σp, the half's T = p·v summed from zero and O
    = fma(O, alpha, T).  At the end the halves merge: m = max(m₀, m₁),
    aₕ = exp(mₕ − m), l = l₀a₀ + l₁a₁, O = O₀a₀ + O₁a₁; out = O / l, lse
    = m + log l.  A tile or half that a block skips (past its causal
    diagonal, past Lk) leaves the state as a wholly masked one does, so
    every row runs every half here.  ``width``: q, k, v zero-padded to
    that many columns (the kernel's bucket), the output cut back to D;
    scale stays 1/√D.  Returns (out [B, Lq, H, D], lse [B, H, Lq])."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    sc = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    pad = (width or D) - D
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, pad))
                  .permute(0, 2, 1, 3) for t in (q, k, v))
    qi = torch.arange(Lq)[:, None] + (Lk - Lq)
    half = rows // 2
    m = [torch.full((B, H, Lq, 1), -1e30) for _ in range(2)]
    l = [torch.zeros((B, H, Lq, 1)) for _ in range(2)]
    o = [torch.zeros_like(qf) for _ in range(2)]
    for k0 in range(0, Lk, rows):
        for h in (0, 1):
            a = k0 + h * half
            if a >= Lk:
                continue
            ks, vs = kf[:, :, a:a + half], vf[:, :, a:a + half]
            ki = torch.arange(a, a + ks.shape[2])[None, :]
            ok = qi >= ki if causal else torch.ones((Lq, ks.shape[2]),
                                                    dtype=torch.bool)
            x = torch.where(ok, tf32_product(qf, ks.transpose(-1, -2),
                                             terms, apart=True) * sc,
                            torch.tensor(-1e30))
            m_new = torch.maximum(m[h], x.amax(-1, keepdim=True))
            alpha = torch.exp(m[h] - m_new)
            p = torch.where(ok, torch.exp(x - m_new), torch.zeros(()))
            l[h] = l[h] * alpha + p.sum(-1, keepdim=True)
            o[h] = fma(o[h], alpha, tf32_product(p, vs, terms))
            m[h] = m_new
    mm = torch.maximum(m[0], m[1])
    a0, a1 = torch.exp(m[0] - mm), torch.exp(m[1] - mm)
    denom = (l[0] * a0 + l[1] * a1).clamp_min(1e-30)
    out = fma(o[0], a0, o[1] * a1) / denom
    return (out[..., :D].permute(0, 2, 1, 3),
            (mm + torch.log(denom)).squeeze(-1))


@functools.lru_cache(maxsize=None)
def tf32_fwd_case(B, L, H, D, causal, seed):
    """fp32 q, k, v and the reference's fp32 ``attention_ref`` output and
    the rows' log-sum-exp (``jax.nn.logsumexp`` of its masked logits)."""
    q, k, v = (torch.from_numpy(a) for a in make(seed, B, L, L, H, D))
    qj, kj, vj = (jnp.asarray(t.numpy()) for t in (q, k, v))
    want = torch.from_numpy(np.array(j_ref(qj, kj, vj, causal=causal)))
    logits = jnp.einsum("bqhd,bkhd->bhqk", qj, kj) / np.sqrt(
        np.float32(D))
    if causal:
        logits = jnp.where(jnp.arange(L)[:, None] >= jnp.arange(L)[None],
                           logits, -1e30)
    lse = torch.from_numpy(np.array(jax_logsumexp(logits, axis=-1)))
    return (q, k, v), want, lse


# (B, L, H, D, causal): D = 64 causal at 256 and 2,048 keys, D = 80 (its
# bucket 128) both ways, and D = 256 (32 rows a block) at 2,048 keys.
TF32_FWD_SHAPES = [(1, 256, 2, 64, True), (1, 2048, 2, 64, True),
                   (2, 200, 3, 80, True), (2, 200, 3, 80, False),
                   (1, 2048, 1, 256, False)]


def tf32_fwd_ratios(B, L, H, D, causal, terms):
    """Worst |Δ| of the emulated output over 2e-5 and of its lse over
    1e-4·max(max|ref|, 1)."""
    from repro_torch.kernels.flash_attention import kernel
    args, want, want_lse = tf32_fwd_case(B, L, H, D, causal, seed=L + D)
    W = kernel.bucket(D)
    got, lse = emulate_tf32_fwd(*args, causal=causal, terms=terms,
                                rows=kernel.f32_rows(W), width=W)
    assert got.shape == want.shape and lse.shape == want_lse.shape
    return (float((got - want).abs().max()) / DT["float32"][2],
            float((lse - want_lse).abs().max()) / grad_bar(want_lse))


@pytest.mark.parametrize("B,L,H,D,causal", TF32_FWD_SHAPES)
def test_tf32_forward_meets_the_fp32_bar(B, L, H, D, causal):
    """The fp32 forward kernel's arithmetic (every product three TF32
    products on split operands, each tile's S and p·v summed from zero,
    O = O·alpha + T in fp32, the key halves merged at the end) keeps the
    output within 2e-5 and the lse within 1e-4·max(max|ref|, 1) of the
    reference's fp32 ``attention_ref``."""
    out, lse = tf32_fwd_ratios(B, L, H, D, causal, terms=3)
    print(f"\n{[B, L, H, D]} causal={causal}: worst |Δ|/bar out {out:.4f}"
          f", lse {lse:.4f}")
    assert out <= 1.0 and lse <= 1.0


@pytest.mark.parametrize("terms", [1, 2])
def test_tf32_forward_fewer_terms_miss_the_bar(terms):
    """One TF32 product (plain TF32) and two (one operand split) miss the
    forward's 2e-5 bar at every shape."""
    ratios = {s: tf32_fwd_ratios(*s, terms=terms)[0]
              for s in TF32_FWD_SHAPES}
    print(f"\nterms={terms}: worst |Δ|/2e-5 " + ", ".join(
        f"{list(k)} {v:.3f}" for k, v in ratios.items()))
    assert min(ratios.values()) > 1.0, ratios


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
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    got = kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal)
    want = ref_mod.attention_bwd_ref(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and g.shape == w.shape, name
        assert bwd_within_bar(g, w, dtype), name
    # bf16 goes to the tensor-core kernels, fp32 to the CUDA-core ones.
    ran = {n for n, c in kernel.BWD_KERNEL_LAUNCHES.items()
           if c != before[n]}
    assert ran == {"fa_bwd_preprocess", kernel.bwd_kernel("dkdv", tdt),
                   kernel.bwd_kernel("dq", tdt)}
    # No atomics: a second pass gives the same bits.
    again = kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    for name, g, a in zip("qkv", got, again):
        assert torch.equal(g, a), name


def _offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t``'s values in a contiguous view that starts ``offset`` elements
    into a larger buffer (misaligned for 16-byte loads at offset 1)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 33, 80, 96, 128, 200, 256])
def test_cuda_preprocess_matches_plain_at_odd_dims_and_views(D, dtype,
                                                            offset):
    """``fa_bwd_preprocess`` against ``bwd_preprocess_ref`` within
    1e-4·max(max|ref|, 1), at head dims that take its 16-byte pieces and
    dims that do not, on aligned tensors and on views one element into a
    larger buffer (which take its element-wise variant), with an odd
    number of heads and query rows not a multiple of its block's; two
    passes bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import kernel
    tdt = DT[dtype][1]
    rng = np.random.default_rng(D)
    o, do = (_offset_view(torch.from_numpy(rng.normal(
        size=(2, 37, 3, D)).astype(np.float32)).to(tdt).cuda(), offset)
        for _ in range(2))
    assert (o.data_ptr() % 16 == 0) == (offset == 0)
    before = kernel.BWD_KERNEL_LAUNCHES["fa_bwd_preprocess"]
    got = kernel.bwd_preprocess_cuda(o, do)
    again = kernel.bwd_preprocess_cuda(o, do)
    want = ref_mod.bwd_preprocess_ref(o, do)
    torch.cuda.synchronize()
    assert kernel.BWD_KERNEL_LAUNCHES["fa_bwd_preprocess"] == before + 2
    assert got.shape == (2, 3, 37) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * max(
        float(want.abs().max()), 1.0)
    assert torch.equal(got, again)


# A train step's bf16 gradient bar (chip_smoke.py's TRAIN_GRAD_REL): the
# kernels take D from the stored bf16 output, as FA2 does, which moves the
# gradient by up to ~1% of its max against autograd of the plain version.
AUTOGRAD_BF16_REL = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,D", [(2, 200, 3, 64), (1, 130, 2, 128),
                                     (1, 100, 2, 80), (2, 96, 2, 32),
                                     (1, 100, 2, 96), (1, 100, 2, 100),
                                     (1, 130, 2, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_autograd_function_matches_plain_autograd(causal, dtype, B, L,
                                                       H, D):
    """``flash_attention`` under grad on CUDA tensors: the kernels'
    gradient against torch.autograd of the plain version (fp32 within
    1e-4·max, bf16 within 2e-2·max), one forward and one backward pass
    counted, the backward on the dtype's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.flash_attention import kernel
    tdt = DT[dtype][1]
    q, k, v, do = (t.cuda() for t in grad_inputs(B, L, L, H, D, 2, tdt))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES)
    tc_before = kernel.BWD_KERNEL_LAUNCHES[kernel.bwd_kernel("dkdv", tdt)]
    out = ops.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    assert (ops.LAUNCHES - before[0], ops.BWD_LAUNCHES - before[1]) == (1, 1)
    assert kernel.BWD_KERNEL_LAUNCHES[
        kernel.bwd_kernel("dkdv", tdt)] == tc_before + 1
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*plain, causal=causal), plain,
                               do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == tdt
        err = float((g.float() - w.float()).abs().max())
        if dtype == "float32":
            assert err <= grad_bar(w)
        else:
            assert err <= AUTOGRAD_BF16_REL * float(w.float().abs().max())
