"""repro_torch affinity scoring ≡ the reference's, bit for bit.

The plain torch version (``repro_torch.kernels.affinity.ref``) must equal
the reference's jnp oracle (``affinity(use_pallas=False)``) and its Pallas
kernel run by the interpreter (``use_pallas=True``) on all four outputs,
with no tolerance: the torch version writes the folded arithmetic the
compiled oracle evaluates (see ref.py).  The CUDA kernel is held against
the plain version on the card (``cuda`` marker).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.affinity import ops as jops
from repro_torch.kernels.affinity import ops as tops
from repro_torch.kernels.affinity.ref import BIG, affinity_ref

GS = dict(gs_read=50., gs_write=30., bp_ms=1000.)
FIELDS = ("best_vm", "best_tier", "est_finish", "est_cost")


def make_inputs(rng, T, V, lead=()):
    """The test_kernels.py input recipe, optionally with a batch dim."""
    return [
        rng.uniform(10, 900, lead + (T,)).astype(np.float32),
        rng.uniform(1, 150, lead + (T,)).astype(np.float32),
        rng.uniform(5, 500, lead + (T,)).astype(np.float32),
        rng.uniform(0, 200, lead + (T, V)).astype(np.float32),
        rng.choice([0., 400., 10000.], lead + (T, V)).astype(np.float32),
        rng.choice([0, 1, 2, 3], lead + (T, V)).astype(np.int32),
        rng.choice([2., 4., 8., 16.], lead + (V,)).astype(np.float32),
        rng.uniform(5, 40, lead + (V,)).astype(np.float32),
        rng.choice([1., 2., 4., 8.], lead + (V,)).astype(np.float32),
    ]


def jax_out(arrs, use_pallas, batch=False):
    fn = jops.affinity_batch if batch else jops.affinity
    return [np.asarray(o) for o in
            fn(*map(jnp.asarray, arrs), use_pallas=use_pallas, **GS)]


def torch_out(arrs, batch=False):
    fn = tops.affinity_batch if batch else tops.affinity
    return [o.numpy() for o in fn(*map(torch.from_numpy, arrs), **GS)]


def assert_bitwise(want, got):
    for name, a, b in zip(FIELDS, want, got):
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def check_both_oracles(arrs, batch=False):
    got = torch_out(arrs, batch)
    assert_bitwise(jax_out(arrs, False, batch), got)
    assert_bitwise(jax_out(arrs, True, batch), got)
    return got


@pytest.mark.parametrize("T,V", [(16, 32), (37, 100), (64, 7), (1, 1)])
def test_plain_matches_reference_kernel_shapes(T, V):
    rng = np.random.default_rng(T * 1000 + V)
    arrs = make_inputs(rng, T, V)
    arrs[7] = np.full(V, 20.0, np.float32)   # test_kernels.py's fixed bw
    check_both_oracles(arrs)


@pytest.mark.parametrize("trial", range(8))
def test_plain_matches_reference_random_shapes(trial):
    rng = np.random.default_rng(500 + trial)
    T, V = int(rng.integers(1, 301)), int(rng.integers(1, 601))
    check_both_oracles(make_inputs(rng, T, V))


@pytest.mark.parametrize("B,T,V", [(1, 64, 64), (2, 32, 128), (4, 4, 256)])
def test_plain_matches_reference_padded_buckets(B, T, V):
    """Power-of-two buckets with half the rows and the tail members inert
    (budget -1, tier 0, mips/bw/price 1), as ``multi_cycle`` stages them."""
    rng = np.random.default_rng(B * T * V)
    arrs = make_inputs(rng, T, V, (B,))
    live_t, live_v = T // 2, (3 * V) // 4
    size, out_mb, budget, miss, cont, tier, mips, bw, price = arrs
    for a in (size, out_mb, miss, cont):
        a[:, live_t:] = 0
    budget[:, live_t:] = -1.0
    tier[:, live_t:] = 0
    tier[:, :, live_v:] = 0
    for a in (mips, bw, price):
        a[:, live_v:] = 1.0
    if B > 1:                                # a wholly inert member
        for a in (size, out_mb, miss, cont, tier):
            a[-1] = 0
        budget[-1] = -1.0
        for a in (mips, bw, price):
            a[-1] = 1.0
    got = check_both_oracles(arrs, batch=True)
    assert (got[0][:, live_t:] == -1).all()
    assert (got[1][:, live_t:] == 9).all()


def test_plain_matches_reference_batch_b3():
    rng = np.random.default_rng(3)
    check_both_oracles(make_inputs(rng, 45, 90, (3,)), batch=True)


def test_all_infeasible_rows():
    """Budgets below every cost and tier-0 rows: -1 / 9 / BIG / BIG."""
    rng = np.random.default_rng(11)
    arrs = make_inputs(rng, 12, 40)
    arrs[2][:6] = 0.0          # budget too small for any VM
    arrs[5][6:] = 0            # out of scope everywhere
    got = check_both_oracles(arrs)
    big = np.float32(BIG)
    assert (got[0] == -1).all() and (got[1] == 9).all()
    assert (got[2] == big).all() and (got[3] == big).all()


def test_tier_priority():
    """A slower tier-1 VM must beat a faster tier-3 VM (Alg. 2 ordering)."""
    arrs = [np.asarray([100.0], np.float32), np.asarray([10.0], np.float32),
            np.asarray([1e6], np.float32),
            np.zeros((1, 2), np.float32), np.zeros((1, 2), np.float32),
            np.asarray([[1, 3]], np.int32),
            np.asarray([2.0, 16.0], np.float32),      # tier-3 VM 8× faster
            np.full(2, 20.0, np.float32), np.asarray([1.0, 8.0], np.float32)]
    got = check_both_oracles(arrs)
    assert got[0][0] == 0 and got[1][0] == 1


def test_dispatch_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(5)
    arrs = [torch.from_numpy(a) for a in make_inputs(rng, 9, 13, (2,))]
    before = tops.LAUNCHES
    out = tops.affinity_batch(*arrs, **GS)
    assert tops.LAUNCHES == before           # no kernel launch on the CPU
    ref = affinity_ref(*arrs, **GS)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_resolve_device():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper validates before it builds or launches anything."""
    from repro_torch.kernels.affinity.kernel import affinity_cuda
    arrs = [torch.from_numpy(a)
            for a in make_inputs(np.random.default_rng(0), 4, 6, (1,))]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        affinity_cuda(*arrs, **GS)
    with pytest.raises(ValueError, match=r"must be \[B, T, V\]"):
        affinity_cuda(*arrs[:3], arrs[3][0], *arrs[4:], **GS)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V", [(1, 16, 32), (3, 37, 100), (1, 64, 7),
                                   (1, 1, 1), (2, 512, 512), (4, 4, 1024)])
def test_cuda_kernel_matches_plain(B, T, V):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.affinity.kernel import affinity_cuda
    rng = np.random.default_rng(B * T * V)
    arrs = [torch.from_numpy(a).cuda()
            for a in make_inputs(rng, T, V, (B,))]
    want = affinity_ref(*arrs, **GS)
    got = affinity_cuda(*arrs, **GS)
    torch.cuda.synchronize()
    for name, a, b in zip(FIELDS, want, got):
        assert torch.equal(a, b), name
