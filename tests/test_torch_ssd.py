"""repro_torch SSD scan ≡ the reference's, on the CPU.

The port's plain version (``repro_torch.kernels.ssd.ref``, what
``ops.ssd`` runs on CPU tensors) is held against the reference's
``ssd(use_pallas=True)`` (its Pallas chunk kernel in interpret mode) and
its jnp ``ssd_ref`` on the same seeded numpy inputs, at the reference
sweep's shapes (``tests/test_kernels.py``) and tolerance: y and the
final state within atol 1e-4 (fp32 sums in another order).  The decode
recurrence is held against ``ssd_decode_ref``.  The CUDA kernels are
held against the plain versions on the card (``cuda`` marker).

The bf16 chunk kernel runs its products on the tensor cores with its two
fp32 operands (W and B ⊙ dec_end) split into bf16 terms;
``emulate_tensor_core_chunks`` repeats that arithmetic on the CPU, so the
split is held to the kernel's bars here too.  The fp32 ones
(``ssd_chunk_tf32``, and the carry ``ssd_carry_tf32``) take three TF32
products a product; ``_ssd_tf32.emulate_tf32_chunks`` and
``emulate_tf32_carry`` repeat them and are held against the plain
versions and the reference's own chunk pass and scan, and
``emulate_tf32_chunks_tiled`` repeats ``ssd_chunk_tf32_tiled``'s walk at
chunks of 128 to 256 rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ssd_tf32 import (emulate_tf32_carry, emulate_tf32_chunks,
                       emulate_tf32_chunks_tiled)
from repro.kernels.ssd.kernel import ssd_chunks as j_chunks
from repro.kernels.ssd.ops import ssd as j_ssd
from repro.kernels.ssd.ref import ssd_decode_ref as j_decode
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import (chunk_cumsum, ssd_carry_ref,
                                         ssd_chunks_ref, ssd_combine,
                                         ssd_decode_ref, ssd_ref)

SWEEP = [(2, 128, 3, 32, 16, 32), (1, 256, 2, 64, 128, 64),
         (2, 64, 4, 16, 32, 16), (1, 128, 1, 64, 64, 128)]
# Chunks beyond the sweep's: Mamba2's own chunk of 256 rows at its head
# width and state size, and a chunk of 50 rows (not a multiple of 4), what
# models/ssm.py picks for a 50-token sequence.
CHUNKS = [(1, 512, 2, 64, 128, 256), (1, 50, 2, 16, 16, 50)]


def make(seed, B, L, H, P, N):
    """The test_kernels.py recipe: x, dt ∈ [0.01, 0.2], A ∈ −[0.5, 2],
    B, C normal."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(B, L, H)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, size=(H,))).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32)]


def jt(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a)
                                            for a in arrs]


def close(got, ref, atol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("B,L,H,P,N,Q", SWEEP + CHUNKS)
def test_plain_matches_reference_sweep(B, L, H, P, N, Q):
    seed = B * L + N
    js, ts = jt(make(seed, B, L, H, P, N))
    y, s = ops.ssd(*ts, chunk=Q)
    assert y.dtype == torch.float32 and s.shape == (B, H, N, P)
    refs = (j_ssd(*js, chunk=Q, use_pallas=True), j_ssd_ref(*js, chunk=Q))
    # Both sides still hold the seeded inputs, so a mismatch below comes
    # from a computation, not from an input changed under it (ROADMAP
    # Queue 3 item 1: the misses recorded here came from torch's first
    # threaded exp of the process, which repro_torch now warms).
    for a, j, t in zip(make(seed, B, L, H, P, N), js, ts):
        assert np.array_equal(np.asarray(j), a)
        assert np.array_equal(t.numpy(), a)
    for ry, rs in refs:
        close(y, ry)
        close(s, rs)


@pytest.mark.parametrize("B,L,H,P,N,Q", SWEEP[:2])
def test_plain_matches_reference_init_state(B, L, H, P, N, Q):
    arrs = make(7 + L, B, L, H, P, N)
    h0 = np.random.default_rng(8).normal(size=(B, H, N, P)).astype(
        np.float32)
    js, ts = jt(arrs)
    y, s = ops.ssd(*ts, chunk=Q, init_state=torch.from_numpy(h0))
    for ry, rs in (j_ssd(*js, chunk=Q, use_pallas=True,
                         init_state=jnp.asarray(h0)),
                   j_ssd_ref(*js, chunk=Q, init_state=jnp.asarray(h0))):
        close(y, ry)
        close(s, rs)


def test_plain_bf16_input_keeps_dtype():
    """The serving path feeds bf16 x, B, C: y comes back in bf16, the
    state in fp32, as the reference's."""
    arrs = make(11, 2, 64, 4, 16, 32)
    js, ts = jt(arrs)
    for i in (0, 3, 4):
        js[i], ts[i] = js[i].astype(jnp.bfloat16), ts[i].bfloat16()
    y, s = ops.ssd(*ts, chunk=16)
    ry, rs = j_ssd(*js, chunk=16, use_pallas=True)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ry.astype(jnp.float32)),
                               atol=2e-2 * max(float(np.abs(
                                   np.asarray(ry.astype(jnp.float32)))
                                   .max()), 1.0))
    close(s, rs)


def test_chunked_equals_sequential_recurrence():
    B, L, H, P, N = 1, 64, 2, 16, 8
    js, ts = jt(make(0, B, L, H, P, N))
    y, s = ssd_ref(*ts, chunk=16)
    x, dt, A, Bm, Cm = ts
    state = torch.zeros((B, H, N, P))
    ys = []
    for t in range(L):
        yt, state = ops.ssd_decode(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                   state)
        ys.append(yt)
    close(torch.stack(ys, 1), y.numpy())
    close(state, s.numpy())


@pytest.mark.parametrize("B,H,P,N", [(2, 3, 32, 16), (1, 8, 64, 128)])
def test_decode_matches_reference(B, H, P, N):
    rng = np.random.default_rng(B * H + N)
    arrs = [rng.normal(size=(B, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(B, H)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, size=(H,))).astype(np.float32),
            rng.normal(size=(B, N)).astype(np.float32),
            rng.normal(size=(B, N)).astype(np.float32),
            rng.normal(size=(B, H, N, P)).astype(np.float32)]
    js, ts = jt(arrs)
    y, s = ssd_decode_ref(*ts)
    ry, rs = j_decode(*js)
    close(y, ry, 1e-5)
    close(s, rs, 1e-5)


def test_chunk_must_divide_length():
    _, ts = jt(make(0, 1, 48, 2, 16, 8))
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd(*ts, chunk=32)


def test_masked_decay_never_multiplies_inf():
    """Steep decay: exp(cum_i − cum_j) for i < j overflows to inf, and the
    masked entry must still be 0 (no inf·0 = nan)."""
    arrs = make(4, 1, 64, 2, 16, 8)
    arrs[1][:] = 50.0                      # dt·A ≈ −50..−100 per step
    js, ts = jt(arrs)
    y, s = ops.ssd(*ts, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ry, rs = j_ssd_ref(*js, chunk=64)
    close(y, ry)
    close(s, rs)


def test_cpu_path_launches_nothing():
    _, ts = jt(make(0, 1, 32, 2, 16, 8))
    before = ops.LAUNCHES
    ops.ssd(*ts, chunk=16)
    assert ops.LAUNCHES == before


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels.ssd.kernel import smem_bytes, ssd_chunks_cuda
    _, ts = jt(make(0, 1, 32, 2, 16, 8))
    cum = chunk_cumsum(ts[1], ts[2], 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd_chunks_cuda(ts[0], ts[1], cum, ts[3], ts[4], 16)
    # The largest tiles the reference's sweep and the two models use fit
    # a block's shared memory.
    assert smem_bytes(128, 64, 64) <= 232_448
    assert smem_bytes(64, 128, 64) <= 232_448


# (B, L, H, P, N, Q, dtype): the reference sweep, then zamba2-1.2b's and
# mamba2-780m's head widths at short prompts, in the serving dtype; then
# chunks of more than one block of rows (256, 128, and 100: a short last
# block), of 50 rows (not a multiple of 4) and of one row.
CUDA_SHAPES = [s + ("float32",) for s in SWEEP] + [
    (1, 256, 64, 64, 64, 64, "bfloat16"),
    (1, 128, 48, 64, 128, 64, "bfloat16")] + [
    s + (dt,) for s in CHUNKS for dt in ("float32", "bfloat16")] + [
    (1, 256, 4, 64, 128, 128, "bfloat16"), (1, 300, 2, 32, 64, 100, "float32"),
    (1, 8, 2, 8, 8, 1, "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q,dtype", CUDA_SHAPES)
def test_cuda_kernel_matches_plain(B, L, H, P, N, Q, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.ssd.kernel import ssd_chunks_cuda
    _, ts = jt(make(B * L + N, B, L, H, P, N))
    ts = [t.cuda() for t in ts]
    if dtype == "bfloat16":
        for i in (0, 3, 4):
            ts[i] = ts[i].bfloat16()
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    want = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    got = ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1.0), err


# ---------------------------------------------------------------------------
# The tensor-core chunk kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def bf16_terms(v, n):
    """``n`` bf16-valued fp32 terms of ``v``: each the round-to-nearest
    bf16 of what the earlier ones left, as the kernel splits."""
    terms = []
    for _ in range(n):
        t = v.bfloat16().float()
        terms.append(t)
        v = v - t
    return terms


def emulate_tensor_core_chunks(x, dt, cum, Bm, Cm, chunk, terms):
    """The bf16 chunk kernels' arithmetic: x, B and C in bf16; C·Bᵀ with
    exact products and fp32 sums; W and B ⊙ dec_end in fp32, each split
    into ``terms`` bf16 terms whose products are exact, summed in fp32.
    Over chunks longer than 64 rows, ``ssd_chunk_tc_tiled``'s walk over
    64 × 64 tiles: y of row block I summed over the column blocks J <= I
    in order, the state over every J in order (at 64 rows the one tile of
    ``ssd_chunk_tc``).  Returns (y_intra [B,L,H,P], states [B,nc,H,N,P])."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = L // chunk
    f32 = torch.float32
    xc = x.bfloat16().float().reshape(Bsz, nc, chunk, H, P)
    Bc = Bm.bfloat16().float().reshape(Bsz, nc, chunk, N)
    Cc = Cm.bfloat16().float().reshape(Bsz, nc, chunk, N)
    dtc = dt.to(f32).reshape(Bsz, nc, chunk, H)
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    iota = torch.arange(chunk)
    causal = (iota[:, None] >= iota[None, :])[None, None, :, :, None]
    seg = cumc[:, :, :, None, :] - cumc[:, :, None, :, :]
    w = torch.where(causal, cb[..., None] * torch.exp(seg)
                    * dtc[:, :, None, :, :], 0.0)           # [b,c,i,j,h]
    de = torch.exp(cumc[:, :, -1:, :] - cumc) * dtc         # [b,c,j,h]
    bd = Bc[:, :, :, None, :] * de[..., None]               # [b,c,j,h,n]
    R = min(chunk, 64)
    blocks = [slice(k * R, (k + 1) * R) for k in range(chunk // R)]
    y = torch.zeros_like(xc)
    st = torch.zeros((Bsz, nc, H, N, P))
    for J, j in enumerate(blocks):
        for I in range(J, len(blocks)):
            i = blocks[I]
            y[:, :, i] += sum(torch.einsum("bcijh,bcjhp->bcihp", t,
                                           xc[:, :, j])
                              for t in bf16_terms(w[:, :, i, j], terms))
        st += sum(torch.einsum("bcjhn,bcjhp->bchnp", t, xc[:, :, j])
                  for t in bf16_terms(bd[:, :, j], terms))
    return y.reshape(Bsz, L, H, P), st


# The sweep's shapes (bar: 1e-4 absolute), a narrow zamba2-like shape at
# ssd_chunk_tc's Q = 64, and ssd_chunk_tc_tiled's chunks of 128, 192 and
# 256 rows at both state sizes (bar: 1e-4·max|ref|, the full-width bar).
TILED_SHAPES = [(1, 256, 2, 64, 128, 128), (1, 384, 2, 64, 64, 192),
                (1, 512, 2, 64, 128, 256), (1, 512, 3, 64, 64, 256)]
EMU_SHAPES = [s + ("sweep",) for s in SWEEP] + [
    (2, 256, 4, 64, 64, 64, "full")] + [s + ("full",) for s in TILED_SHAPES]


def emulation_ratios(terms):
    """Worst max|Δ| / bar over y_intra and the states, per shape, of the
    emulated kernel against ``ssd_chunks_ref`` on the same bf16 inputs."""
    out = {}
    for B, L, H, P, N, Q, bar in EMU_SHAPES:
        _, ts = jt(make(B * L + N, B, L, H, P, N))
        x, dt, A, Bm, Cm = ts
        x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
        cum = chunk_cumsum(dt, A, Q)
        want = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
        got = emulate_tensor_core_chunks(x, dt, cum, Bm, Cm, Q, terms)
        worst = 0.0
        for g, w in zip(got, want):
            scale = 1.0 if bar == "sweep" else float(w.abs().max())
            worst = max(worst, float((g - w).abs().max()) / (1e-4 * scale))
        out[(B, L, H, P, N, Q)] = worst
    return out


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_tensor_core_emulation_meets_the_bar(terms):
    """Two terms (the kernel's default) and three keep y_intra and the
    states within the bars; one term (a single bf16 rounding) misses
    them, which is why the kernel splits.  The worst ratios are printed
    (``-s``)."""
    from repro_torch.kernels.ssd.kernel import TERMS
    assert TERMS == 2
    ratios = emulation_ratios(terms)
    print(f"\nterms={terms}: worst max|Δ|/bar " + ", ".join(
        f"{list(k)} {v:.4f}" for k, v in ratios.items()))
    if terms == 1:
        assert min(ratios.values()) > 1.0, ratios
    else:
        assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("B,L,H,P,N,Q", TILED_SHAPES)
def test_tiled_chunk_emulation_meets_the_bar(B, L, H, P, N, Q):
    """``ssd_chunk_tc_tiled``'s arithmetic (two bf16 terms, the tile walk)
    on bf16 inputs against the plain chunk pass, and against the
    reference's own: its Pallas ``ssd_chunks`` in interpret mode on the
    same bf16 values, each output within 1e-4·max|ref|; carried by the
    plain carry, y and the final state within 1e-4·max|ref| of the
    reference's ``ssd_ref`` and ``ssd(use_pallas=True)``."""
    from repro_torch.kernels.ssd.kernel import TERMS, tiled_shape
    assert tiled_shape(torch.bfloat16, Q, P, N)
    arrs = make(B * L + N + 3, B, L, H, P, N)
    for i in (0, 3, 4):   # the values the bf16 kernel reads, exactly
        arrs[i] = torch.from_numpy(arrs[i]).bfloat16().float().numpy()
    js, ts = jt(arrs)
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    got = emulate_tensor_core_chunks(x.bfloat16(), dt, cum, Bm.bfloat16(),
                                     Cm.bfloat16(), Q, TERMS)
    wants = (ssd_chunks_ref(x, dt, cum, Bm, Cm, Q),
             j_chunks(*(jnp.asarray(t.numpy())
                        for t in (x, dt, cum, Bm, Cm)), Q))
    for want in wants:
        for g, w in zip(got, want):
            w = np.asarray(w)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()), err
    y, final = ssd_combine(*got, cum, Cm, Q)
    for ry, rs in (j_ssd_ref(*js, chunk=Q),
                   j_ssd(*js, chunk=Q, use_pallas=True)):
        for g, w in ((y, ry), (final, rs)):
            w = np.asarray(w)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()), err


def test_tiled_terms_is_the_kernels_term_count():
    """``ssd_chunk_tc_tiled`` is built with ``kernel.TERMS`` bf16 terms
    (``kTiledTerms``), the count the emulation above holds to the bar;
    the wrapper asks for no other."""
    import re
    from repro_torch.kernels.ssd import kernel
    src = (kernel.CSRC / "ssd.cu").read_text()
    assert re.findall(r"constexpr int kTiledTerms = (\d+);", src) == [
        str(kernel.TERMS)]


def test_tiled_tiles_fit_shared_memory():
    """``ssd_chunk_tc_tiled``'s shared memory (``kernel.chunk_tiled_smem_
    bytes``) at every chunk and state size it takes leaves room for two
    blocks an SM (228 KiB, 1 KiB reserved a block): at its largest, N =
    128 and Q = 256, the C·Bᵀ fragments of four tiles, C_I and B_J, and dt
    and cum of two heads."""
    from repro_torch.kernels.ssd.kernel import (TILED_Q,
                                                chunk_tiled_smem_bytes)
    for N in (64, 128):
        for Q in TILED_Q:
            assert 2 * (chunk_tiled_smem_bytes(N, Q) + 1024) <= 228 * 1024
    assert chunk_tiled_smem_bytes(128, 256) == (4 * 16384 + 2 * 64 * 136 * 2
                                                + 4 * 256 * 4)


def test_three_terms_hold_fp32_exactly():
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=4096).astype(np.float32)) * 37.0
    assert torch.equal(sum(bf16_terms(v, 3)), v)


def test_carry_plain_is_combine_then_cast():
    """The carry kernel's plain version: ``ssd_combine`` with y cast."""
    _, ts = jt(make(5, 1, 64, 2, 16, 8))
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, 16)
    yi, st = ssd_chunks_ref(x, dt, cum, Bm, Cm, 16)
    y, f = ssd_carry_ref(yi, st, cum, Cm, 16, out_dtype=torch.bfloat16)
    y32, f32 = ssd_combine(yi, st, cum, Cm, 16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y32.bfloat16())
    assert torch.equal(f, f32)


def test_carry_wrapper_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels.ssd.kernel import ssd_carry_cuda
    _, ts = jt(make(0, 1, 32, 2, 16, 8))
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, 16)
    yi, st = ssd_chunks_ref(x, dt, cum, Bm, Cm, 16)
    with pytest.raises(ValueError, match="needs a CUDA"):
        ssd_carry_cuda(yi, st, cum, Cm, 16)


def _cuda_inputs(B, L, H, P, N, Q, dtype):
    _, ts = jt(make(B * L + N, B, L, H, P, N))
    ts = [t.cuda() for t in ts]
    if dtype == "bfloat16":
        for i in (0, 3, 4):
            ts[i] = ts[i].bfloat16()
    return ts


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 64, 64, 64, 64),
                                         (1, 128, 48, 64, 128, 64),
                                         (2, 512, 8, 64, 64, 64)])
def test_cuda_tensor_core_kernel_matches_plain(B, L, H, P, N, Q, terms):
    """The bf16 chunk path on the tensor cores against the plain version,
    within 1e-4·max|ref| for y_intra and the states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.ssd.kernel import ssd_chunks_cuda
    x, dt, A, Bm, Cm = _cuda_inputs(B, L, H, P, N, Q, "bfloat16")
    cum = chunk_cumsum(dt, A, Q)
    want = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    got = ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q, terms=terms)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("B,L,H,P,N,Q,dtype",
                         [SWEEP[0] + ("float32",), SWEEP[3] + ("float32",),
                          (1, 256, 64, 64, 64, 64, "bfloat16"),
                          (2, 512, 8, 64, 128, 64, "bfloat16"),
                          # short prompts: an odd chunk, and N > 2 Q on
                          # the tensor cores
                          (1, 14, 2, 16, 64, 7, "bfloat16"),
                          (1, 48, 2, 64, 128, 16, "bfloat16"),
                          # chunks walked in tiles of 64 rows: 256 on
                          # both kernels, a short last tile on each (100
                          # and 80), 50 rows of bf16 on the CUDA cores
                          (1, 512, 4, 64, 128, 256, "bfloat16"),
                          (1, 512, 4, 64, 128, 256, "float32"),
                          (1, 300, 2, 32, 64, 100, "float32"),
                          (1, 160, 2, 64, 128, 80, "bfloat16"),
                          (1, 50, 2, 16, 16, 50, "bfloat16"),
                          # the tensor-core carry's 64-column slices
                          # (256 groups, one a block) and its 8-column
                          # slices (P = 40)
                          (4, 512, 64, 64, 64, 64, "bfloat16"),
                          (1, 128, 4, 40, 32, 32, "bfloat16")])
def test_cuda_carry_kernel_matches_plain(B, L, H, P, N, Q, dtype,
                                         with_init):
    """The carry kernel against ``ssd_combine``: y in fp32 and the final
    state within 1e-4·max|ref|, and y in bf16 within one bf16 step of
    the fp32 plain value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _hold_carry(B, L, H, P, N, Q, dtype, with_init)


@pytest.mark.cuda
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_cuda_carry_blocks_walk_several_groups(with_init):
    """zamba2-1.2b's heads at 8 x 256 tokens: 512 groups of 64 columns,
    more than the SMs hold at once, so the persistent grid's blocks each
    walk a second group (rings running on across the group boundary, h
    or the initial state loaded again, a second final state written); held
    as in ``test_cuda_carry_kernel_matches_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.ssd.kernel import carry_plan
    B, L, H, P, N, Q = 8, 256, 64, 64, 64, 64
    plan = carry_plan(torch.bfloat16, B, H, P, N, Q)
    assert plan["blocks"] < B * H * (P // plan["ps"]), plan
    _hold_carry(B, L, H, P, N, Q, "bfloat16", with_init)


def _hold_carry(B, L, H, P, N, Q, dtype, with_init):
    """The carry kernel against ``ssd_combine`` at one shape (the bars of
    ``test_cuda_carry_kernel_matches_plain``)."""
    from repro_torch.kernels.ssd.kernel import ssd_carry_cuda
    x, dt, A, Bm, Cm = _cuda_inputs(B, L, H, P, N, Q, dtype)
    cum = chunk_cumsum(dt, A, Q)
    yi, st = (t.contiguous() for t in ssd_chunks_ref(x, dt, cum, Bm, Cm, Q))
    h0 = None
    if with_init:
        h0 = torch.from_numpy(np.random.default_rng(8).normal(
            size=(B, H, N, P)).astype(np.float32)).cuda()
    want_y, want_f = ssd_combine(yi, st, cum, Cm, Q, h0)
    got_y, got_f = ssd_carry_cuda(yi, st, cum, Cm.contiguous(), Q, h0)
    got_b, got_fb = ssd_carry_cuda(yi, st, cum, Cm.contiguous(), Q, h0,
                                   torch.bfloat16)
    torch.cuda.synchronize()
    scale = float(want_y.abs().max())
    assert float((got_y - want_y).abs().max()) <= 1e-4 * scale
    fscale = float(want_f.abs().max())
    assert float((got_f - want_f).abs().max()) <= 1e-4 * fscale
    assert torch.equal(got_f, got_fb) and got_b.dtype == torch.bfloat16
    step = 2.0 ** -8 * want_y.abs() + 1e-4 * scale
    assert bool(((got_b.float() - want_y).abs() <= step).all())


@pytest.mark.cuda
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_cuda_ssd_launches_both_kernels(with_init):
    """``ops.ssd`` on CUDA tensors: one chunk and one carry launch, and
    the result of ``ssd_ref`` within the full-width bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, L, H, P, N, Q = 2, 256, 8, 64, 64, 64
    x, dt, A, Bm, Cm = _cuda_inputs(B, L, H, P, N, Q, "float32")
    h0 = (torch.from_numpy(np.random.default_rng(9).normal(
        size=(B, H, N, P)).astype(np.float32)).cuda()
        if with_init else None)
    before = (ops.LAUNCHES, ops.CARRY_LAUNCHES)
    got = ops.ssd(x, dt, A, Bm, Cm, chunk=Q, init_state=h0)
    want = ssd_ref(x, dt, A, Bm, Cm, chunk=Q, init_state=h0)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.CARRY_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


# ---------------------------------------------------------------------------
# The CUDA-core chunk kernel's walk over blocks of rows, emulated on the CPU
# ---------------------------------------------------------------------------

def fma(a, b, c):
    """fmaf in fp32: the product of two fp32 values is exact in fp64, so
    the sum is rounded once there, then to fp32 (off from fmaf only where
    the two roundings meet a tie)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_blocked_chunks(x, dt, cum, Bm, Cm, chunk, rows):
    """``ssd_chunk_kernel``'s walk, element by element in its order: row
    blocks I of ``rows`` rows (the last one short where ``rows`` does not
    divide the chunk); for each, the column blocks J <= I in order, W's
    tile at (I, J) (C·Bᵀ as an fmaf chain over n, times exp(cum_i - cum_j)
    and dt_j where i >= j, else 0), and each y element's fmaf chain over
    the j of J with j <= i (the kernel's ``jn`` cut), carried from one
    block J to the next (its ``ys``) and written at J = I; the chunk
    state's fmaf chain over every j, walked while I is the last row
    block, carried across J.  Returns (y_intra, states) as
    ``ssd_chunks_ref``."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = L // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(Bsz, nc, chunk, H, P)
    dtc = dt.to(f32).reshape(Bsz, nc, chunk, H)
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H)
    Bc = Bm.to(f32).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(f32).reshape(Bsz, nc, chunk, N)
    de = torch.exp(cumc[:, :, -1:, :] - cumc) * dtc     # dec_end · dt
    y = torch.empty_like(xc)
    st = torch.empty((Bsz, nc, H, N, P))
    nb = -(-chunk // rows)
    for I in range(nb):
        i0, ni = I * rows, min(rows, chunk - I * rows)
        ys = torch.zeros((Bsz, nc, ni, H, P))
        for J in range(I + 1):
            j0, nj = J * rows, min(rows, chunk - J * rows)
            cb = torch.zeros((Bsz, nc, ni, nj))
            for n in range(N):
                cb = fma(Cc[:, :, i0:i0 + ni, None, n],
                         Bc[:, :, None, j0:j0 + nj, n], cb)
            i = torch.arange(i0, i0 + ni)[:, None]
            j = torch.arange(j0, j0 + nj)[None, :]
            lower = (i >= j)[None, None, :, :, None]
            seg = cumc[:, :, i0:i0 + ni, None] - cumc[:, :, None, j0:j0 + nj]
            w = torch.where(lower, cb[..., None] * torch.exp(
                torch.where(lower, seg, 0.0)) * dtc[:, :, None, j0:j0 + nj],
                0.0)
            for jj in range(nj):
                keep = (j0 + jj <= torch.arange(i0, i0 + ni))[
                    None, None, :, None, None]
                ys = torch.where(keep, fma(w[:, :, :, jj, :, None],
                                           xc[:, :, None, j0 + jj], ys), ys)
            if I == nb - 1:
                acc = torch.zeros_like(st) if J == 0 else st
                for jj in range(nj):
                    acc = fma(Bc[:, :, None, j0 + jj, :, None],
                              (xc[:, :, j0 + jj]
                               * de[:, :, j0 + jj, :, None])[:, :, :, None],
                              acc)
                st = acc
        y[:, :, i0:i0 + ni] = ys
    return y.reshape(Bsz, L, H, P), st


# Chunks of 128 (the sweep's) and 256 rows (two and four blocks of 64),
# 100 (a short second block) and 50 (one block).
BLOCKED = [SWEEP[3], CHUNKS[0], (1, 300, 2, 32, 64, 100), CHUNKS[1]]


@pytest.mark.parametrize("B,L,H,P,N,Q", BLOCKED)
def test_blocked_chunk_emulation_meets_the_bar(B, L, H, P, N, Q):
    """The blocked walk at the kernel's rows a block (min(Q,
    ``kernel.CHUNK_ROWS``)) against ``ssd_chunks_ref`` within the kernel's
    bar (max|Δ| <= 1e-4·max(max|ref|, 1)), and with the plain carry
    against the reference's ``ssd_ref`` and ``ssd(use_pallas=True)``
    within the sweep's 1e-4."""
    from repro_torch.kernels.ssd.kernel import CHUNK_ROWS
    js, ts = jt(make(B * L + N + 1, B, L, H, P, N))
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    got = emulate_blocked_chunks(x, dt, cum, Bm, Cm, Q, min(Q, CHUNK_ROWS))
    want = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1.0), err
    y, final = ssd_combine(*got, cum, Cm, Q)
    for ry, rs in (j_ssd_ref(*js, chunk=Q),
                   j_ssd(*js, chunk=Q, use_pallas=True)):
        close(y, ry)
        close(final, rs)


def test_tiles_fit_shared_memory_at_every_chunk():
    """At every chunk from 1 to 256 rows, the chunk kernel's blocks and
    the carry's tiles fit a block's shared memory at the models' widest
    head (P 64, N 128) and at N 256."""
    from repro_torch.kernels.ssd.kernel import (MAX_SMEM_BYTES,
                                                carry_smem_bytes, smem_bytes)
    for Q in range(1, 257):
        for N in (128, 256):
            assert smem_bytes(Q, N, 64) <= MAX_SMEM_BYTES
            for dtype in (torch.float32, torch.bfloat16):
                assert carry_smem_bytes(N, Q, dtype) <= MAX_SMEM_BYTES
    # At Q <= 64 the kernel is one block, with the first port's tiles.
    assert smem_bytes(64, 128, 64) == 4 * (64 * 64 + 2 * 64 * 129
                                           + 64 * 65 + 3 * 64)


@pytest.mark.parametrize("N", [16, 64, 128, 256])
def test_tensor_core_carry_fits_shared_memory_at_every_chunk(N):
    """At every chunk from 1 to 256 rows that ``fwd_kernels`` sends to
    ``ssd_carry_tc`` (bf16 C, Q a multiple of 16), the kernel's smallest
    plan (one head a block, a one-stage ring) fits a block's shared memory
    and thread limit at both slice widths, so that no chunk the first
    design took falls to the CUDA cores; and the plans the models' shapes
    take fit too."""
    from repro_torch.kernels.ssd.kernel import (CARRY_PLAN_STAGES,
                                                CARRY_TC_MAX_THREADS,
                                                MAX_SMEM_BYTES,
                                                carry_tc_smem_bytes,
                                                carry_tc_threads,
                                                fwd_kernels)
    taken = []
    for Q in range(1, 257):
        if fwd_kernels(torch.bfloat16, Q, 64, N)[1] != "ssd_carry_tc":
            assert Q % 16
            continue
        taken.append(Q)
        for ps in (16, 8):
            assert carry_tc_smem_bytes(N, Q, ps) <= MAX_SMEM_BYTES
            assert carry_tc_threads(N, Q, ps) <= CARRY_TC_MAX_THREADS
    assert taken == list(range(16, 257, 16))
    # At chunk 64 the plan's deepest ring fits at 16-column slices at every
    # N, and at the models' widths (N <= 128) a 32-column slice with a
    # one-stage ring does.
    assert carry_tc_smem_bytes(N, 64, 16, CARRY_PLAN_STAGES) <= MAX_SMEM_BYTES
    if N <= 128:
        assert carry_tc_smem_bytes(N, 64, 32, 1) <= MAX_SMEM_BYTES
        assert carry_tc_threads(N, 64, 32) <= CARRY_TC_MAX_THREADS


@pytest.mark.cuda
def test_cuda_tensor_core_carry_shared_memory_equals_mirror():
    """The library's ``ssd_smem_bytes(3, ...)`` equals
    ``kernel.carry_tc_smem_bytes`` at every chunk the tensor-core carry
    takes, N in (16, 64, 128, 256); at the models' shapes the plan it
    launches with has the mirror's shared memory and threads at its heads
    and stages, and no more blocks than groups."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sizes come from the library")
    from repro_torch.kernels.ssd import kernel
    size = kernel.LIB.load().ssd_smem_bytes
    for N in (16, 64, 128, 256):
        for Q in range(16, 257, 16):
            assert size(3, Q, N, 64) == kernel.carry_tc_smem_bytes(N, Q)
    for B, L, H, P, N, Q in ((1, 32768, 64, 64, 64, 64),
                             (4, 2048, 64, 64, 64, 64),
                             (2, 4096, 48, 64, 128, 64)):
        plan = kernel.carry_plan(torch.bfloat16, B, H, P, N, Q)
        assert plan["smem"] == kernel.carry_tc_smem_bytes(
            N, Q, plan["ps"], plan["stages"]) <= kernel.MAX_SMEM_BYTES
        assert plan["threads"] == kernel.carry_tc_threads(N, Q, plan["ps"])
        assert 1 <= plan["blocks"] <= B * H * (P // plan["ps"])
    assert kernel.carry_plan(torch.bfloat16, 1, 2, 64, 64, 50) is None


@pytest.mark.cuda
def test_cuda_forward_tiles_fit_shared_memory():
    """The libraries' own sizes at Q = 256, N = 128, P = 64, equal to
    kernel.py's mirrors and within a block's shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sizes come from the library")
    from repro_torch.kernels.ssd import kernel
    size = kernel.LIB.load().ssd_smem_bytes
    Q, N, P = 256, 128, 64
    want = [kernel.smem_bytes(Q, N, P),
            kernel.carry_smem_bytes(N, Q, torch.float32),
            kernel.carry_smem_bytes(N, Q, torch.bfloat16)]
    for which, w in enumerate(want):
        assert size(which, Q, N, P) == w <= kernel.MAX_SMEM_BYTES
    assert 0 < size(3, Q, N, P) <= kernel.MAX_SMEM_BYTES
    assert size(4, Q, N, P) == -1


# ---------------------------------------------------------------------------
# The fp32 tensor-core chunk kernel (TF32, three products a product)
# ---------------------------------------------------------------------------

# fp32 at ssd_chunk_tf32's shapes (Q = P = 64): the reference sweep's
# N = 128 shape, and N = 64 with more heads and chunks.
TF32_SHAPES = [SWEEP[1], (2, 256, 4, 64, 64, 64)]


def tf32_case(B, L, H, P, N, Q):
    js, ts = jt(make(B * L + N + 2, B, L, H, P, N))
    x, dt, A, Bm, Cm = ts
    return js, ts, chunk_cumsum(dt, A, Q)


@pytest.mark.parametrize("B,L,H,P,N,Q", TF32_SHAPES)
def test_tf32_chunk_emulation_meets_the_bar(B, L, H, P, N, Q):
    """``ssd_chunk_tf32``'s arithmetic against the reference's own chunk
    pass, its Pallas ``ssd_chunks`` in interpret mode, within a tenth of
    1e-4·max(max|ref|, 1); carried by the plain carry, y and the final
    state within the sweep's 1e-4 of the reference's ``ssd_ref`` and
    ``ssd(use_pallas=True)``."""
    js, ts, cum = tf32_case(B, L, H, P, N, Q)
    x, dt, A, Bm, Cm = ts
    got = emulate_tf32_chunks(x, dt, cum, Bm, Cm, Q)
    want = j_chunks(*(jnp.asarray(t.numpy()) for t in (x, dt, cum, Bm, Cm)),
                    Q)
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 0.1 * 1e-4 * max(float(np.abs(w).max()), 1.0), err
    y, final = ssd_combine(*got, cum, Cm, Q)
    for ry, rs in (j_ssd_ref(*js, chunk=Q),
                   j_ssd(*js, chunk=Q, use_pallas=True)):
        close(y, ry)
        close(final, rs)


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_tf32_chunk_term_counts(terms):
    """One TF32 product a product (plain TF32) misses 1e-4·max|ref| of
    ``ssd_chunks_ref`` on the same inputs; three (hi·hi + hi·lo + lo·hi,
    the kernel's ``kernel.TF32_TERMS``) meet it.  The worst ratios are
    printed (``-s``)."""
    from repro_torch.kernels.ssd.kernel import TF32_TERMS
    assert TF32_TERMS == 3
    ratios = {}
    for shape in TF32_SHAPES:
        _, ts, cum = tf32_case(*shape)
        x, dt, A, Bm, Cm = ts
        Q = shape[-1]
        got = emulate_tf32_chunks(x, dt, cum, Bm, Cm, Q, terms)
        want = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
        ratios[shape] = max(float((g - w).abs().max())
                            / (1e-4 * float(w.abs().max()))
                            for g, w in zip(got, want))
    print(f"\nTF32 products={terms}: worst max|Δ|/bar " + ", ".join(
        f"{list(k)} {v:.4f}" for k, v in ratios.items()))
    if terms == 1:
        assert min(ratios.values()) > 1.0, ratios
    if terms == 3:
        assert max(ratios.values()) <= 0.1, ratios


def test_forward_dispatch_by_dtype_and_shape():
    """fp32 at Q = P = 64, N in {64, 128} takes ``ssd_chunk_tf32``, bf16
    there ``ssd_chunk_tc``; bf16 at Q = 128, 192, 256 (P 64, N 64 or 128)
    ``ssd_chunk_tc_tiled``, fp32 there ``ssd_chunk_tf32_tiled``; every
    other chunk, head width or state size the CUDA-core kernel.  The carry: at Q
    and N multiples of 16 ``ssd_carry_tc`` for bf16 C and
    ``ssd_carry_tf32`` for fp32 C, else ``ssd_carry_kernel`` (the models'
    chunk of 50, odd chunks)."""
    from repro_torch.kernels.ssd.kernel import FWD_KERNELS, fwd_kernels
    f32, bf = torch.float32, torch.bfloat16
    assert fwd_kernels(f32, 64, 64, 128) == ("ssd_chunk_tf32",
                                             "ssd_carry_tf32")
    assert fwd_kernels(f32, 64, 64, 64) == ("ssd_chunk_tf32",
                                            "ssd_carry_tf32")
    assert fwd_kernels(bf, 64, 64, 128) == ("ssd_chunk_tc", "ssd_carry_tc")
    for Q in (128, 192, 256):
        for N in (64, 128):
            assert fwd_kernels(bf, Q, 64, N) == ("ssd_chunk_tc_tiled",
                                                 "ssd_carry_tc")
            assert fwd_kernels(f32, Q, 64, N) == ("ssd_chunk_tf32_tiled",
                                                  "ssd_carry_tf32")
    for Q, P, N in ((32, 64, 128), (64, 32, 128), (64, 64, 32),
                    (128, 32, 128), (256, 64, 32), (100, 64, 64),
                    (50, 16, 16), (50, 64, 128)):
        for dtype in (f32, bf):
            assert fwd_kernels(dtype, Q, P, N)[0] == "ssd_chunk_kernel"
    for Q, P, N in ((32, 64, 128), (64, 32, 128), (128, 64, 128),
                    (256, 64, 128), (16, 16, 32), (32, 40, 16)):
        assert fwd_kernels(f32, Q, P, N)[1] == "ssd_carry_tf32"
        assert fwd_kernels(bf, Q, P, N)[1] == "ssd_carry_tc"
    for Q, P, N in ((50, 16, 16), (100, 32, 64), (64, 64, 40), (7, 16, 64)):
        for dtype in (f32, bf):
            assert fwd_kernels(dtype, Q, P, N)[1] == "ssd_carry_kernel"
    assert set(FWD_KERNELS) == {
        fwd_kernels(dt, Q, 64, N)[k] for dt in (f32, bf)
        for Q, N in ((64, 128), (256, 128), (50, 16)) for k in (0, 1)}


def test_tf32_tiles_fit_two_blocks_an_sm():
    """``ssd_chunk_tf32``'s shared memory (``kernel.chunk_tf32_smem_bytes``)
    at its largest, N = 128 with 16 heads a block, leaves room for two
    blocks an SM (228 KiB, 1 KiB reserved a block).  Its heads a block
    (``kernel.tf32_heads``: the fewest waves of two blocks an SM, each
    weighed by G + 1): 6 at the (b) fp32 step's 1 × 2048 (256 blocks, one
    wave on 132 SMs), 12 at mamba2-780m's 2 × 4096 (512 blocks, two)."""
    from repro_torch.kernels.ssd.kernel import (chunk_tf32_heads,
                                                chunk_tf32_smem_bytes)
    assert chunk_tf32_smem_bytes(128, 16) == 4 * (2 * 64 * 132 + 2 * 64 * 68
                                                  + 3 * 16 * 64)
    assert 2 * (chunk_tf32_smem_bytes(128, 16) + 1024) <= 228 * 1024
    G = chunk_tf32_heads(32, 48, 132)
    assert G == 6 and 32 * 48 // G <= 2 * 132
    assert chunk_tf32_heads(128, 48, 132) == 12
    assert chunk_tf32_heads(128, 64, 132) == 16
    assert chunk_tf32_heads(1, 3, 132) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 2, 64, 128, 64),
                                         (1, 128, 48, 64, 128, 64),
                                         (2, 512, 8, 64, 64, 64)])
def test_cuda_tf32_chunk_kernel_matches_plain(B, L, H, P, N, Q):
    """``ssd_chunk_tf32`` on fp32 inputs against the plain version, within
    1e-4·max|ref| for y_intra and the states, a second pass equal bit for
    bit, each launch counted under its name; ``terms=0`` still takes the
    CUDA-core kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.ssd import kernel
    x, dt, A, Bm, Cm = _cuda_inputs(B, L, H, P, N, Q, "float32")
    cum = chunk_cumsum(dt, A, Q)
    before = dict(kernel.FWD_KERNEL_LAUNCHES)
    want = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    got = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    again = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    core = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q, terms=0)
    torch.cuda.synchronize()
    for g, a, c, w in zip(got, again, core, want):
        assert torch.equal(g, a)
        for t in (g, c):
            err = float((t - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), err
    for name in kernel.FWD_KERNELS:
        assert kernel.FWD_KERNEL_LAUNCHES[name] == before[name] + {
            "ssd_chunk_tf32": 2, "ssd_chunk_kernel": 1}.get(name, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 4, 64, 128, 128),
                                         (1, 384, 3, 64, 64, 192),
                                         (2, 512, 8, 64, 128, 256),
                                         (1, 512, 4, 64, 64, 256)])
def test_cuda_tiled_chunk_kernel_matches_plain(B, L, H, P, N, Q):
    """``ssd_chunk_tc_tiled`` on bf16 inputs against the plain version,
    within 1e-4·max|ref| for y_intra and the states, a second pass equal
    bit for bit, each launch counted under its name; ``terms=0`` still
    takes the CUDA-core kernel at these chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.ssd import kernel
    x, dt, A, Bm, Cm = _cuda_inputs(B, L, H, P, N, Q, "bfloat16")
    cum = chunk_cumsum(dt, A, Q)
    before = dict(kernel.FWD_KERNEL_LAUNCHES)
    want = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    got = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    again = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    core = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q, terms=0)
    torch.cuda.synchronize()
    for g, a, c, w in zip(got, again, core, want):
        assert torch.equal(g, a)
        for t in (g, c):
            err = float((t - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), err
    for name in kernel.FWD_KERNELS:
        assert kernel.FWD_KERNEL_LAUNCHES[name] == before[name] + {
            "ssd_chunk_tc_tiled": 2, "ssd_chunk_kernel": 1}.get(name, 0)


@pytest.mark.cuda
def test_cuda_tiled_shared_memory_equals_mirror():
    """The library's ``ssd_chunk_tiled_smem_bytes`` equals kernel.py's
    mirror at every chunk and state size the kernel takes, and refuses
    anything else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sizes come from the library")
    from repro_torch.kernels.ssd import kernel
    lib = kernel.LIB.load()
    for N in (64, 128):
        for Q in kernel.TILED_Q:
            assert lib.ssd_chunk_tiled_smem_bytes(N, Q) == \
                kernel.chunk_tiled_smem_bytes(N, Q) <= kernel.MAX_SMEM_BYTES
    for N, Q in ((32, 128), (128, 64), (128, 320), (64, 100)):
        assert lib.ssd_chunk_tiled_smem_bytes(N, Q) == -1


@pytest.mark.cuda
def test_cuda_tf32_shared_memory_equals_mirror():
    """The library's ``ssd_chunk_tf32_smem_bytes`` and
    ``ssd_chunk_tf32_heads`` equal kernel.py's mirrors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sizes come from the library")
    from repro_torch.kernels.ssd import kernel
    lib = kernel.LIB.load()
    for N in (64, 128):
        for G in range(1, 17):
            assert lib.ssd_chunk_tf32_smem_bytes(N, G) == \
                kernel.chunk_tf32_smem_bytes(N, G) <= kernel.MAX_SMEM_BYTES
    assert lib.ssd_chunk_tf32_smem_bytes(32, 4) == -1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, L, H in ((1, 2048, 48), (2, 4096, 48), (1, 256, 2)):
        assert lib.ssd_chunk_tf32_heads(B, L, H) == kernel.chunk_tf32_heads(
            B * L // 64, H, sms)


# ---------------------------------------------------------------------------
# The fp32 tensor-core chunk kernel over 64 x 64 tiles (Q = 128, 192, 256)
# ---------------------------------------------------------------------------

# fp32 at ssd_chunk_tf32_tiled's chunks of 128, 192 and 256 rows at both
# state sizes.
TF32_TILED_SHAPES = [(1, 256, 2, 64, 128, 128), (1, 384, 2, 64, 64, 192),
                     (1, 512, 2, 64, 128, 256)]


def tf32_tiled_ratios(terms):
    """Worst max|Δ| / (1e-4·max|ref|) over y_intra and the states of the
    emulated ``ssd_chunk_tf32_tiled`` against ``ssd_chunks_ref``, per
    shape of ``TF32_TILED_SHAPES``."""
    out = {}
    for shape in TF32_TILED_SHAPES:
        _, ts, cum = tf32_case(*shape)
        x, dt, A, Bm, Cm = ts
        Q = shape[-1]
        got = emulate_tf32_chunks_tiled(x, dt, cum, Bm, Cm, Q, terms)
        want = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
        out[shape] = max(float((g - w).abs().max())
                         / (1e-4 * float(w.abs().max()))
                         for g, w in zip(got, want))
    return out


@pytest.mark.parametrize("B,L,H,P,N,Q", TF32_TILED_SHAPES)
def test_tf32_tiled_chunk_emulation_meets_the_bar(B, L, H, P, N, Q):
    """``ssd_chunk_tf32_tiled``'s arithmetic (three TF32 products a
    product, its walk over 64 x 64 tiles) against the plain chunk pass and
    the reference's own, its Pallas ``ssd_chunks`` in interpret mode, each
    output within a tenth of 1e-4·max|ref|, and within 1e-5 of it of the
    unbroken walk (``emulate_tf32_chunks``: only fp32 sums in another
    order); carried by the plain carry, y and the final state within
    1e-4·max|ref| of the reference's ``ssd_ref`` and
    ``ssd(use_pallas=True)``."""
    from repro_torch.kernels.ssd.kernel import tf32_tiled_shape
    assert tf32_tiled_shape(torch.float32, Q, P, N)
    js, ts, cum = tf32_case(B, L, H, P, N, Q)
    x, dt, A, Bm, Cm = ts
    got = emulate_tf32_chunks_tiled(x, dt, cum, Bm, Cm, Q)
    whole = emulate_tf32_chunks(x, dt, cum, Bm, Cm, Q)
    wants = (ssd_chunks_ref(x, dt, cum, Bm, Cm, Q),
             j_chunks(*(jnp.asarray(t.numpy())
                        for t in (x, dt, cum, Bm, Cm)), Q))
    for want in wants:
        for g, u, w in zip(got, whole, want):
            w = np.asarray(w)
            scale = 1e-4 * float(np.abs(w).max())
            assert float(np.abs(g.numpy() - w).max()) <= 0.1 * scale
            assert float((g - u).abs().max()) <= 0.1 * 1e-4 * scale
    y, final = ssd_combine(*got, cum, Cm, Q)
    for ry, rs in (j_ssd_ref(*js, chunk=Q),
                   j_ssd(*js, chunk=Q, use_pallas=True)):
        for g, w in ((y, ry), (final, rs)):
            w = np.asarray(w)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()), err


@pytest.mark.parametrize("terms", [1, 3])
def test_tf32_tiled_chunk_term_counts(terms):
    """At the tiled chunks one TF32 product a product misses
    1e-4·max|ref| of ``ssd_chunks_ref``; three (``kernel.TF32_TERMS``)
    keep y_intra and the states within a tenth of it.  The worst ratios
    are printed (``-s``)."""
    ratios = tf32_tiled_ratios(terms)
    print(f"\nTF32 products={terms}: tiled worst max|Δ|/bar " + ", ".join(
        f"{list(k)} {v:.4f}" for k, v in ratios.items()))
    if terms == 1:
        assert min(ratios.values()) > 1.0, ratios
    else:
        assert max(ratios.values()) <= 0.1, ratios


def test_tf32_tiled_tiles_fit_two_blocks_an_sm():
    """``ssd_chunk_tf32_tiled``'s shared memory
    (``kernel.chunk_tf32_tiled_smem_bytes``) at every chunk it takes
    leaves room for two blocks an SM (228 KiB, 1 KiB reserved a block): at
    Q = 256 a state task's fp32 slice of B [256, 68], larger than four
    tiles' C·Bᵀ fragments, the ring of two x tiles [64, 68] and dt and cum
    of two heads.  Its heads a block (``kernel.chunk_tf32_tiled_heads``):
    12 at mamba2-780m's 2 × 4096 in chunks of 256 on 132 SMs."""
    from repro_torch.kernels.ssd.kernel import (TILED_Q,
                                                chunk_tf32_tiled_heads,
                                                chunk_tf32_tiled_smem_bytes)
    for N in (64, 128):
        for Q in TILED_Q:
            assert 2 * (chunk_tf32_tiled_smem_bytes(N, Q) + 1024) \
                <= 228 * 1024
    assert chunk_tf32_tiled_smem_bytes(128, 256) == (256 * 68 * 4
                                                     + 2 * 64 * 68 * 4
                                                     + 4 * 256 * 4)
    assert chunk_tf32_tiled_smem_bytes(64, 128) == (2 * 64 * 68 * 4 * 2
                                                    + 4 * 128 * 4)
    assert chunk_tf32_tiled_heads(32, 256, 128, 48, 132) == 12
    assert chunk_tf32_tiled_heads(1, 128, 64, 3, 132) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 4, 64, 128, 128),
                                         (1, 384, 3, 64, 64, 192),
                                         (2, 512, 8, 64, 128, 256),
                                         (1, 512, 4, 64, 64, 256)])
def test_cuda_tf32_tiled_chunk_kernel_matches_plain(B, L, H, P, N, Q):
    """``ssd_chunk_tf32_tiled`` on fp32 inputs against the plain version,
    within 1e-4·max|ref| for y_intra and the states, a second pass equal
    bit for bit, each launch counted under its name; ``terms=0`` still
    takes the CUDA-core kernel at these chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.ssd import kernel
    x, dt, A, Bm, Cm = _cuda_inputs(B, L, H, P, N, Q, "float32")
    cum = chunk_cumsum(dt, A, Q)
    before = dict(kernel.FWD_KERNEL_LAUNCHES)
    want = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    got = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    again = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    core = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q, terms=0)
    torch.cuda.synchronize()
    for g, a, c, w in zip(got, again, core, want):
        assert torch.equal(g, a)
        for t in (g, c):
            err = float((t - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), err
    for name in kernel.FWD_KERNELS:
        assert kernel.FWD_KERNEL_LAUNCHES[name] == before[name] + {
            "ssd_chunk_tf32_tiled": 2, "ssd_chunk_kernel": 1}.get(name, 0)


@pytest.mark.cuda
def test_cuda_tf32_tiled_shared_memory_equals_mirror():
    """The library's ``ssd_chunk_tf32_tiled_smem_bytes`` and
    ``ssd_chunk_tf32_tiled_heads`` equal kernel.py's mirrors at every
    chunk and state size the kernel takes, and refuse anything else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sizes come from the library")
    from repro_torch.kernels.ssd import kernel
    lib = kernel.LIB.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for N in (64, 128):
        for Q in kernel.TILED_Q:
            assert lib.ssd_chunk_tf32_tiled_smem_bytes(N, Q) == \
                kernel.chunk_tf32_tiled_smem_bytes(N, Q) \
                <= kernel.MAX_SMEM_BYTES
            for B, L, H in ((2, 4096, 48), (1, Q, 3)):
                assert lib.ssd_chunk_tf32_tiled_heads(B, L, H, N, Q) == \
                    kernel.chunk_tf32_tiled_heads(B * L // Q, Q, N, H, sms)
    for N, Q in ((32, 128), (128, 64), (128, 320), (64, 100)):
        assert lib.ssd_chunk_tf32_tiled_smem_bytes(N, Q) == -1


# ---------------------------------------------------------------------------
# The fp32 tensor-core carry (TF32, three products a product)
# ---------------------------------------------------------------------------

def tf32_carry_ratios(shape, terms, init):
    """Worst max|Δ| / (1e-4·max(max|ref|, 1)) of the emulated
    ``ssd_carry_tf32`` against ``ssd_carry_ref`` (y, final state) on the
    plain chunk outputs, with a nonzero initial state where ``init``."""
    B, L, H, P, N, Q = shape
    _, ts, cum = tf32_case(*shape)
    x, dt, A, Bm, Cm = ts
    yi, st = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    h0 = torch.from_numpy(np.random.default_rng(11).normal(
        size=(B, H, N, P)).astype(np.float32)) if init else None
    got = emulate_tf32_carry(yi, st, cum, Cm, Q, h0, terms=terms)
    want = ssd_carry_ref(yi, st, cum, Cm, Q, h0)
    return max(float((g - w).abs().max())
               / (1e-4 * max(float(w.abs().max()), 1.0))
               for g, w in zip(got, want))


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("B,L,H,P,N,Q", TF32_SHAPES)
def test_tf32_carry_emulation_meets_the_bar(B, L, H, P, N, Q, with_init):
    """``ssd_carry_tf32``'s arithmetic keeps y and the final state within
    a tenth of 1e-4·max(max|ref|, 1) of ``ssd_carry_ref``; the whole fp32
    SSD with both emulated tensor-core kernels (``ssd_chunk_tf32``, then
    ``ssd_carry_tf32``) is within the sweep's 1e-4 of the reference's
    ``ssd(use_pallas=True)`` (its Pallas chunk kernel in interpret mode and
    its jnp carry) and ``ssd_ref`` on the same seeded inputs."""
    shape = (B, L, H, P, N, Q)
    assert tf32_carry_ratios(shape, 3, with_init) <= 0.1
    js, ts, cum = tf32_case(*shape)
    x, dt, A, Bm, Cm = ts
    h0 = np.random.default_rng(12).normal(size=(B, H, N, P)).astype(
        np.float32) if with_init else None
    th0 = None if h0 is None else torch.from_numpy(h0)
    jh0 = None if h0 is None else jnp.asarray(h0)
    yi, st = emulate_tf32_chunks(x, dt, cum, Bm, Cm, Q)
    y, final = emulate_tf32_carry(yi, st, cum, Cm, Q, th0)
    for ry, rs in (j_ssd(*js, chunk=Q, use_pallas=True, init_state=jh0),
                   j_ssd_ref(*js, chunk=Q, init_state=jh0)):
        close(y, ry)
        close(final, rs)


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_tf32_carry_term_counts(terms):
    """One TF32 product a product (plain TF32) misses 1e-4·max|ref| of
    ``ssd_carry_ref`` on the same inputs; three (``ssd_carry_tf32``'s
    hi·hi + hi·lo + lo·hi) keep y and the final state within a tenth of
    it.  The worst ratios are printed (``-s``)."""
    ratios = {shape: tf32_carry_ratios(shape, terms, True)
              for shape in TF32_SHAPES}
    print(f"\nTF32 products={terms}: carry worst max|Δ|/bar " + ", ".join(
        f"{list(k)} {v:.4f}" for k, v in ratios.items()))
    if terms == 1:
        assert min(ratios.values()) > 1.0, ratios
    if terms == 3:
        assert max(ratios.values()) <= 0.1, ratios


def test_tf32_carry_fits_shared_memory():
    """``ssd_carry_tf32``'s shared memory (``kernel.carry_tc_smem_bytes``
    with fp32 C: C's tiles in fp32, h_prev in two TF32 planes): at
    mamba2-780m's N = 128 and chunk 64, 84,288 bytes at 16-column slices
    and one stage (two blocks an SM), 187,264 at three (one), and a
    32-column slice fits two stages but not three; every chunk from 16 to
    256 rows in steps of 16 at N up to 256 fits its smallest plan, so that
    ``fwd_kernels`` names it there."""
    from repro_torch.kernels.ssd.kernel import (MAX_SMEM_BYTES,
                                                carry_tc_smem_bytes,
                                                carry_tc_takes,
                                                carry_tc_threads)
    f32 = torch.float32
    assert carry_tc_smem_bytes(128, 64, 16, 1, f32) == 84_288
    assert 2 * (carry_tc_smem_bytes(128, 64, 16, 1, f32) + 1024) \
        <= 228 * 1024
    assert carry_tc_smem_bytes(128, 64, 16, 3, f32) == 187_264
    assert carry_tc_smem_bytes(128, 64, 32, 2, f32) <= MAX_SMEM_BYTES \
        < carry_tc_smem_bytes(128, 64, 32, 3, f32)
    # The bf16 kernel's sizes are those it had: bf16 is the default.
    assert carry_tc_smem_bytes(128, 64, 16, 2) == 92_768
    assert carry_tc_threads(128, 64, 16) == 224
    for N in (16, 64, 128, 256):
        for Q in range(16, 257, 16):
            assert carry_tc_takes(f32, Q, 64, N)
            assert carry_tc_takes(f32, Q, 40, N)


@pytest.mark.cuda
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 2, 64, 128, 64),
                                         (1, 2048, 48, 64, 128, 64),
                                         (2, 512, 8, 64, 64, 64),
                                         (1, 128, 4, 40, 32, 32)])
def test_cuda_tf32_carry_kernel_matches_plain(B, L, H, P, N, Q, with_init):
    """``ssd_carry_tf32`` on fp32 C against ``ssd_carry_ref``: y (fp32)
    and the final state within 1e-4·max(max|ref|, 1), a second pass equal
    bit for bit, y in bf16 with the same final state, each launch counted
    under its name; ``cuda_cores=True`` still takes ``ssd_carry_kernel``,
    held too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.ssd import kernel
    x, dt, A, Bm, Cm = _cuda_inputs(B, L, H, P, N, Q, "float32")
    cum = chunk_cumsum(dt, A, Q)
    yi, st = (t.contiguous() for t in ssd_chunks_ref(x, dt, cum, Bm, Cm, Q))
    h0 = torch.from_numpy(np.random.default_rng(13).normal(
        size=(B, H, N, P)).astype(np.float32)).cuda() if with_init else None
    before = dict(kernel.FWD_KERNEL_LAUNCHES)
    got = kernel.ssd_carry_cuda(yi, st, cum, Cm, Q, h0)
    again = kernel.ssd_carry_cuda(yi, st, cum, Cm, Q, h0)
    yb, fb = kernel.ssd_carry_cuda(yi, st, cum, Cm, Q, h0, torch.bfloat16)
    core = kernel.ssd_carry_cuda(yi, st, cum, Cm, Q, h0, cuda_cores=True)
    want = ssd_carry_ref(yi, st, cum, Cm, Q, h0)
    torch.cuda.synchronize()
    for g, a, c, w in zip(got, again, core, want):
        bar = 1e-4 * max(float(w.abs().max()), 1.0)
        assert torch.equal(g, a)
        assert float((g - w).abs().max()) <= bar
        assert float((c - w).abs().max()) <= bar
    assert torch.equal(fb, got[1]) and yb.dtype == torch.bfloat16
    assert torch.equal(yb, got[0].bfloat16())
    for name in kernel.FWD_KERNELS:
        assert kernel.FWD_KERNEL_LAUNCHES[name] == before[name] + {
            "ssd_carry_tf32": 3, "ssd_carry_kernel": 1}.get(name, 0)


@pytest.mark.cuda
def test_cuda_tf32_carry_shared_memory_equals_mirror():
    """The library's ``ssd_carry_tc_smem_bytes`` equals
    ``kernel.carry_tc_smem_bytes`` for both C types at every slice, ring
    depth and chunk the tensor-core carries take, N in (16, 64, 128, 256);
    at the fp32 shapes phase 6 times, ``ssd_carry_tf32``'s plan has the
    mirror's shared memory and threads and no more blocks than groups."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sizes come from the library")
    from repro_torch.kernels.ssd import kernel
    size = kernel.LIB.load().ssd_carry_tc_smem_bytes
    for dtype in (torch.float32, torch.bfloat16):
        for N in (16, 64, 128, 256):
            for Q in range(16, 257, 16):
                for ps in (8, 16, 32, 64):
                    for stages in (1, 2, 3):
                        assert size(kernel.DTYPES[dtype], N, Q, ps,
                                    stages) == kernel.carry_tc_smem_bytes(
                                        N, Q, ps, stages, dtype)
    assert size(2, 128, 64, 16, 1) == size(0, 128, 64, 16, 4) == -1
    f32 = torch.float32
    for B, L, H, P, N, Q in ((1, 2048, 48, 64, 128, 64),
                             (2, 4096, 48, 64, 128, 64),
                             (2, 4096, 64, 64, 64, 64)):
        plan = kernel.carry_plan(f32, B, H, P, N, Q, c_dtype=f32)
        assert plan["smem"] == kernel.carry_tc_smem_bytes(
            N, Q, plan["ps"], plan["stages"], f32) <= kernel.MAX_SMEM_BYTES
        assert plan["threads"] == kernel.carry_tc_threads(N, Q, plan["ps"])
        assert 1 <= plan["blocks"] <= B * H * (P // plan["ps"])
    assert kernel.carry_plan(f32, 1, 2, 64, 64, 50, c_dtype=f32) is None
