"""repro_torch SSD scan ≡ the reference's, on the CPU.

The port's plain version (``repro_torch.kernels.ssd.ref``, what
``ops.ssd`` runs on CPU tensors) is held against the reference's
``ssd(use_pallas=True)`` (its Pallas chunk kernel in interpret mode) and
its jnp ``ssd_ref`` on the same seeded numpy inputs, at the reference
sweep's shapes (``tests/test_kernels.py``) and tolerance: y and the
final state within atol 1e-4 (fp32 sums in another order).  The decode
recurrence is held against ``ssd_decode_ref``.  The CUDA kernel is held
against the plain version on the card (``cuda`` marker).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as j_ssd
from repro.kernels.ssd.ref import ssd_decode_ref as j_decode
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import (chunk_cumsum, ssd_chunks_ref,
                                         ssd_decode_ref, ssd_ref)

SWEEP = [(2, 128, 3, 32, 16, 32), (1, 256, 2, 64, 128, 64),
         (2, 64, 4, 16, 32, 16), (1, 128, 1, 64, 64, 128)]


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


@pytest.mark.parametrize("B,L,H,P,N,Q", SWEEP)
def test_plain_matches_reference_sweep(B, L, H, P, N, Q):
    js, ts = jt(make(B * L + N, B, L, H, P, N))
    y, s = ops.ssd(*ts, chunk=Q)
    assert y.dtype == torch.float32 and s.shape == (B, H, N, P)
    for ry, rs in (j_ssd(*js, chunk=Q, use_pallas=True),
                   j_ssd_ref(*js, chunk=Q)):
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
# mamba2-780m's head widths at short prompts, in the serving dtype.
CUDA_SHAPES = [s + ("float32",) for s in SWEEP] + [
    (1, 256, 64, 64, 64, 64, "bfloat16"),
    (1, 128, 48, 64, 128, 64, "bfloat16")]


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
