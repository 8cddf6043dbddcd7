"""repro_torch flash attention ≡ the reference's, on the CPU.

The port's plain version (``repro_torch.kernels.flash_attention.ref``,
what ``ops.flash_attention`` runs on CPU tensors) is held against the
reference's Pallas kernel in interpret mode and its jnp ``attention_ref``
on the same seeded numpy inputs, at the reference sweep's shapes
(``tests/test_kernels.py``) and tolerances: 2e-5 in fp32, 2e-2 in bf16
(the jnp oracle rounds logits and probabilities to bf16, the kernel and
the port's plain version keep them in fp32).  The CUDA kernel is held
against the plain version on the card (``cuda`` marker).
"""
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


# (B, Lq, Lk, H, D, causal, dtype): the reference sweep, a cached-prefix
# shape and zamba2-1.2b's serving head width at a short prompt.
CUDA_SHAPES = [s[:2] + (s[1],) + s[2:] for s in SWEEP] + [
    (2, 16, 200, 2, 64, True, "float32"),
    (1, 2048, 2048, 32, 64, True, "bfloat16")]


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
