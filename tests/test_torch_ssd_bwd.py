"""repro_torch's SSD gradient ≡ autograd and the reference's, on the CPU.

The port's plain backward (``repro_torch.kernels.ssd.ref``:
``ssd_carry_bwd_ref``, ``ssd_chunk_bwd_ref`` and ``ssd_bwd_ref``, explicit
formulas, what the two backward kernels compute) is held against torch
autograd of ``ssd_ref`` and against ``jax.vjp`` of the reference's jnp
``ssd_ref`` on the same seeded numpy inputs: the reference sweep's shapes
(``tests/test_torch_ssd.py``) and one at Q = 64, N = 128, fp32 and bf16
x, B, C and dy, with the initial state and the final state's gradient
both zero and both nonzero.  Bars: fp32 gradients within
1e-4·max(max|ref|, 1) (fp32 sums in another order); bf16 gradients (dx,
dB, dC are returned in their inputs' dtype, computed in fp32 and rounded
once on both sides) within 2^-7·|ref| + 1e-4·max(max|ref|, 1) per
element, one bf16 rounding step.

Each plain backward piece is held against autograd of the forward piece
it differentiates; the operator ``repro_torch::ssd_fwd`` with its kernel
entry points swapped for their plain versions against autograd of
``ssd_ref``, with its launch counts, and under the remat policies in a
mamba2 smoke step.  The CUDA kernels are held against their plain
versions on the card (``cuda`` marker).  The fp32 tensor-core backward
kernels' arithmetic (``ssd_chunk_bwd_tf32`` and ``ssd_carry_bwd_tf32``:
three TF32 products a product) is emulated on the CPU
(``_ssd_tf32.emulate_tf32_chunk_bwd``, ``emulate_tf32_carry_bwd``) and
held against the plain versions and, with the fp32 forward kernel's
emulated chunk states, against ``jax.vjp`` of the reference's
``ssd_ref`` and ``ssd``; at chunks of 128 to 256 rows likewise
``ssd_chunk_bwd_tf32_tiled``'s walk over 64 x 64 tiles
(``emulate_tf32_chunk_bwd_tiled``), and both tensor-core carry
backwards' walk over 64-row slabs (``emulate_tensor_core_carry_bwd``,
``emulate_tf32_carry_bwd``).
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ssd_tf32 import (emulate_tf32_carry_bwd, emulate_tf32_chunk_bwd,
                       emulate_tf32_chunk_bwd_tiled, emulate_tf32_chunks,
                       emulate_tf32_chunks_tiled)
from repro.kernels.ssd.ops import ssd as j_ssd
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro_torch.kernels.ssd import kernel, ops
from repro_torch.kernels.ssd import ref as ref_mod
from repro_torch.kernels.ssd.ref import (chunk_cumsum, chunk_cumsum_bwd,
                                         ssd_bwd_ref, ssd_carry_bwd_ref,
                                         ssd_chunk_bwd_ref, ssd_chunks_ref,
                                         ssd_combine, ssd_ref)

# (B, L, H, P, N, Q): the reference sweep, then Q = 64 with N = 128; then
# Mamba2's own chunk of 256 rows at its head width and state size, and a
# chunk of 50 rows (not a multiple of 4: a 50-token sequence's).
SHAPES = [(2, 128, 3, 32, 16, 32), (1, 256, 2, 64, 128, 64),
          (2, 64, 4, 16, 32, 16), (1, 128, 1, 64, 64, 128),
          (2, 128, 4, 16, 128, 64), (1, 512, 2, 64, 128, 256),
          (1, 50, 2, 16, 16, 50)]
NAMES = ("x", "dt", "A", "B", "C", "init_state")
BF16_REL = 2.0 ** -7


def make(seed, B, L, H, P, N, state):
    """The sweep's recipe (x, B, C normal, dt in [0.01, 0.2], A in
    -[0.5, 2]), dy normal, and the initial state and dfinal: None,
    zeros or normal (``state``)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrs = [rng.normal(size=(B, L, H, P)).astype(f32),
            rng.uniform(0.01, 0.2, size=(B, L, H)).astype(f32),
            (-rng.uniform(0.5, 2.0, size=(H,))).astype(f32),
            rng.normal(size=(B, L, N)).astype(f32),
            rng.normal(size=(B, L, N)).astype(f32)]
    dy = rng.normal(size=(B, L, H, P)).astype(f32)
    pair = {"none": (None, None),
            "zero": (np.zeros((B, H, N, P), f32),) * 2,
            "nonzero": tuple(rng.normal(size=(B, H, N, P)).astype(f32)
                             for _ in range(2))}[state]
    return arrs, dy, pair[0], pair[1]


def torch_inputs(arrs, dy, h0, df, dtype):
    """Tensors of the numpy inputs, x, B, C and dy in ``dtype``."""
    ts = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        ts[i] = ts[i].to(dtype)
    opt = [None if a is None else torch.from_numpy(a) for a in (h0, df)]
    return ts, torch.from_numpy(dy).to(dtype), opt[0], opt[1]


def autograd_grads(ts, dy, h0, df, chunk):
    """torch autograd of ssd_ref: grads of (x, dt, A, B, C[, init]), in
    fp32 on the inputs' values (``ssd_ref`` casts C to fp32 in two
    places, so with bf16 leaves autograd would round dC's two parts to
    bf16 apart and again as it sums them)."""
    leaves = [t.float().clone().requires_grad_(True) for t in ts]
    dy = dy.float()
    init = None if h0 is None else h0.clone().requires_grad_(True)
    y, final = ssd_ref(*leaves, chunk=chunk, init_state=init)
    outs, cots = [y], [dy]
    if df is not None:
        outs.append(final)
        cots.append(df)
    wrt = leaves + ([init] if init is not None else [])
    return torch.autograd.grad(outs, wrt, cots)


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_vjp(chunk, args, dy, dfinal):
    def f(*a):
        return j_ssd_ref(*a[:5], chunk=chunk,
                         init_state=a[5] if len(a) > 5 else None)
    (y, final), vjp = jax.vjp(f, *args)
    return vjp((dy, jnp.zeros_like(final) if dfinal is None else dfinal))


def jax_grads(arrs, dy, h0, df, chunk, dtype):
    """jax.vjp of the reference's jnp ssd_ref on the same inputs (one
    compile per shape and dtype)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xs = [jnp.asarray(a) for a in arrs]
    for i in (0, 3, 4):
        xs[i] = xs[i].astype(jdt)
    args = tuple(xs + ([jnp.asarray(h0)] if h0 is not None else []))
    return _jax_vjp(chunk, args, jnp.asarray(dy).astype(jdt),
                    None if df is None else jnp.asarray(df))


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_grad_close(name, got, want):
    """The module docstring's bars: fp32 max|Δ| <= 1e-4·max(max|ref|, 1);
    a bf16 gradient per element within one bf16 rounding step."""
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    scale = 1e-4 * max(float(np.abs(w).max()), 1.0)
    bf16 = (got.dtype == torch.bfloat16 if isinstance(got, torch.Tensor)
            else got.dtype == jnp.bfloat16)
    if bf16:
        bad = np.abs(g - w) > BF16_REL * np.abs(w) + scale
        assert not bad.any(), (name, float(np.abs(g - w).max()))
    else:
        assert float(np.abs(g - w).max()) <= scale, (
            name, float(np.abs(g - w).max()), scale)


CASES = [(s, dt, st) for s in SHAPES for dt in ("float32", "bfloat16")
         for st in ("zero", "nonzero")]


@pytest.mark.parametrize("shape,dtype,state", CASES)
def test_bwd_ref_matches_autograd_and_reference_vjp(shape, dtype, state):
    B, L, H, P, N, Q = shape
    tdt = getattr(torch, dtype)
    arrs, dy, h0, df = make(B * L + N, B, L, H, P, N, state)
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, tdt)
    got = ssd_bwd_ref(*ts, tdy, chunk=Q, init_state=th0, dfinal=tdf)
    for t, g in zip(ts + [th0], got):
        assert g.dtype == t.dtype and g.shape == t.shape
    want = autograd_grads(ts, tdy, th0, tdf, Q)
    for name, g, w in zip(NAMES, got, want):
        assert_grad_close(name, g, w)
    for name, g, w in zip(NAMES, got, jax_grads(arrs, dy, h0, df, Q, tdt)):
        assert_grad_close(name, g, w)


def test_bwd_ref_without_init_state_or_dfinal():
    """No initial state: no gradient for it; no dfinal: zeros."""
    arrs, dy, _, _ = make(3, 1, 64, 2, 16, 32, "none")
    ts, tdy, _, _ = torch_inputs(arrs, dy, None, None, torch.float32)
    got = ssd_bwd_ref(*ts, tdy, chunk=16)
    assert got[5] is None
    zero = torch.zeros((1, 2, 32, 16))
    with_zero = ssd_bwd_ref(*ts, tdy, chunk=16, dfinal=zero)
    for g, w in zip(got[:5], with_zero[:5]):
        assert torch.equal(g, w)
    for name, g, w in zip(NAMES, got, autograd_grads(ts, tdy, None, None,
                                                     16)):
        assert_grad_close(name, g, w)


# ---------------------------------------------------------------------------
# Each piece against autograd of the forward piece it differentiates
# ---------------------------------------------------------------------------

def piece_inputs(shape, seed, state="nonzero"):
    B, L, H, P, N, Q = shape
    arrs, dy, h0, df = make(seed, B, L, H, P, N, state)
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.float32)
    x, dt, A, Bm, Cm = ts
    return x, dt, A, Bm, Cm, tdy, th0, tdf, chunk_cumsum(dt, A, Q)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_carry_bwd_ref_is_the_carry_gradient(shape):
    """g is the gradient of the chunk states and d init_state the initial
    state's through ``ssd_combine``; h_prev the states entering each
    chunk."""
    Q = shape[-1]
    x, dt, A, Bm, Cm, dy, h0, df, cum = piece_inputs(shape, 11)
    y_intra, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    st = states.clone().requires_grad_(True)
    init = h0.clone().requires_grad_(True)
    y, final = ssd_combine(y_intra, st, cum, Cm, Q, init)
    want_g, want_init = torch.autograd.grad((y, final), (st, init), (dy, df))
    h_prev, g, dinit = ssd_carry_bwd_ref(states, cum, Cm, dy, Q, h0, df)
    assert_grad_close("g", g, want_g)
    assert_grad_close("init", dinit, want_init)
    h = h0
    decay = torch.exp(cum.reshape(*states.shape[:2], Q, -1)[:, :, -1])
    for c in range(states.shape[1]):
        assert torch.allclose(h_prev[:, c], h, atol=1e-5)
        h = decay[:, c, :, None, None] * h + states[:, c]
    assert torch.allclose(h, final, atol=1e-5)


def chunk_piece_loss(x, dt, cum, Bm, Cm, dy, g, h_prev, Q):
    """The scalar whose gradient ``ssd_chunk_bwd_ref`` returns: y_intra
    and y_inter against dy, the chunk states and the chunk decay against
    g, with h_prev held fixed."""
    Bsz, L, H, P = x.shape
    nc = L // Q
    y_intra, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    cumc = cum.reshape(Bsz, nc, Q, H)
    y_inter = torch.einsum("bcin,bchnp->bcihp",
                           Cm.reshape(Bsz, nc, Q, -1), h_prev) \
        * torch.exp(cumc)[..., None]
    decay = torch.exp(cumc[:, :, -1, :])[..., None, None]
    return ((y_intra * dy).sum() + (states * g).sum()
            + (y_inter * dy.reshape(Bsz, nc, Q, H, P)).sum()
            + (decay * h_prev * g).sum())


@pytest.mark.parametrize("heads_per_group", [1, 2])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[4]])
def test_chunk_bwd_ref_is_the_chunk_gradient(shape, heads_per_group):
    Q, H = shape[-1], shape[2]
    if H % heads_per_group:
        heads_per_group = H
    x, dt, A, Bm, Cm, dy, h0, df, cum = piece_inputs(shape, 12)
    _, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    h_prev, g, _ = ssd_carry_bwd_ref(states, cum, Cm, dy, Q, h0, df)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, cum, Bm, Cm)]
    want = torch.autograd.grad(
        chunk_piece_loss(*leaves, dy, g, h_prev, Q), leaves)
    dx, dcum, ddt, dB, dC = ssd_chunk_bwd_ref(x, dt, cum, Bm, Cm, dy, g,
                                              h_prev, Q, heads_per_group)
    assert dB.shape == (H // heads_per_group,) + Bm.shape
    for name, got, w in zip(("dx", "ddt", "dcum", "dB", "dC"),
                            (dx, ddt, dcum, dB.sum(0), dC.sum(0)), want):
        assert_grad_close(name, got, w)


def test_cumsum_bwd_is_the_cumsum_gradient():
    x, dt, A, Bm, Cm, dy, _, _, _ = piece_inputs(SHAPES[0], 13)
    dcum = torch.randn(dt.shape, generator=torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_(True) for t in (dt, A)]
    want = torch.autograd.grad(chunk_cumsum(*leaves, 32), leaves, dcum)
    for name, g, w in zip(("ddt", "dA"),
                          chunk_cumsum_bwd(dcum, dt, A, 32), want):
        assert_grad_close(name, g, w)


# ---------------------------------------------------------------------------
# The operator, with its kernel entry points swapped for the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def plain_kernels(monkeypatch):
    """The CUDA entry points swapped for their plain versions, so that the
    custom operator and its registered backward run on CPU tensors: the
    autograd wiring, the saved tensors, the backward's chunk length and
    the launch counts are checked here; the kernels' arithmetic only on
    the card."""
    monkeypatch.setattr(
        kernel, "ssd_chunks_cuda",
        lambda x, dt, cum, Bm, Cm, chunk, terms=None:
        ssd_chunks_ref(x, dt, cum, Bm, Cm, chunk))
    monkeypatch.setattr(kernel, "ssd_carry_cuda", ref_mod.ssd_carry_ref)
    monkeypatch.setattr(kernel, "ssd_carry_bwd_cuda", ssd_carry_bwd_ref)
    monkeypatch.setattr(kernel, "ssd_chunk_bwd_cuda", ssd_chunk_bwd_ref)
    for name in ("LAUNCHES", "CARRY_LAUNCHES", "BWD_LAUNCHES"):
        monkeypatch.setattr(ops, name, 0)


def counts():
    return (ops.LAUNCHES, ops.CARRY_LAUNCHES, ops.BWD_LAUNCHES)


@pytest.mark.parametrize("shape,state", [(SHAPES[0], "none"),
                                         (SHAPES[1], "nonzero"),
                                         (SHAPES[4], "nonzero")])
def test_operator_gives_the_plain_gradient(plain_kernels, shape, state):
    """One forward launch of each kernel, one backward pass (which
    launches the chunk kernel once more for the states)."""
    B, L, H, P, N, Q = shape
    arrs, dy, h0, df = make(21, B, L, H, P, N, state)
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    init = None if th0 is None else th0.clone().requires_grad_(True)
    y, final = ops.ssd_fwd(*leaves, Q, init)
    outs, cots = ([y, final], [tdy, tdf]) if tdf is not None else ([y],
                                                                   [tdy])
    wrt = leaves + ([init] if init is not None else [])
    got = torch.autograd.grad(outs, wrt, cots)
    assert counts() == (1, 1, 1)
    for name, g, w in zip(NAMES, got, autograd_grads(ts, tdy, th0, tdf, Q)):
        assert_grad_close(name, g, w)


def test_operator_keeps_bf16_gradients_in_their_dtypes(plain_kernels):
    B, L, H, P, N, Q = SHAPES[2]
    arrs, dy, h0, df = make(22, B, L, H, P, N, "nonzero")
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    y, final = ops.ssd_fwd(*leaves, Q, th0)
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32
    got = torch.autograd.grad((y, final), leaves, (tdy, tdf))
    want = ssd_bwd_ref(*ts, tdy, chunk=Q, init_state=th0, dfinal=tdf)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_backward_refuses_a_chunk_above_the_kernels():
    """The backward kernels take chunks of up to 256 rows; a longer one is
    refused before anything launches."""
    assert kernel.BWD_MAX_Q == 256
    B, L, H, P, N, Q = 1, 512, 1, 16, 16, 512
    arrs, dy, _, _ = make(23, B, L, H, P, N, "none")
    ts, tdy, _, _ = torch_inputs(arrs, dy, None, None, torch.float32)
    with pytest.raises(ValueError, match="chunks of up to 256 rows, got 512"):
        ops.ssd_bwd(*ts, tdy, Q)


def smoke_batch(cfg, B=2, L=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, L), dtype=np.int64)
    return {"tokens": torch.from_numpy(toks).int(),
            "labels": torch.from_numpy(toks).int()}


@pytest.mark.parametrize("remat,fwd_launches", [("none", 1), ("dots", 1),
                                                ("full", 2)])
def test_remat_dots_keeps_the_ssd_forward(plain_kernels, monkeypatch,
                                          remat, fwd_launches):
    """A mamba2 smoke step through the operator: under ``remat="dots"``
    selective checkpointing keeps its outputs (one forward launch per
    layer, as the reference's ``checkpoint_dots`` keeps the jnp SSD's
    einsums); ``"full"`` launches it again in the backward.  The
    gradients equal those through ``ssd_ref``'s autograd."""
    from repro_torch.models import RunConfig, build
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.train_step import loss_and_grads
    model = build("mamba2-780m", RunConfig(remat=remat,
                                           compute_dtype=torch.float32),
                  smoke=True, device="cpu")
    params = model.init(0)
    batch = smoke_batch(model.cfg)
    _, _, want = loss_and_grads(model, params, batch)
    monkeypatch.setattr(ops, "ssd", lambda x, dt, A, Bm, Cm, chunk=64,
                        init_state=None: ops.ssd_fwd(x, dt, A, Bm, Cm, chunk,
                                                     init_state))
    _, _, got = loss_and_grads(model, params, batch)
    n = model.cfg.n_layers
    assert counts() == (fwd_launches * n, fwd_launches * n, n)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            float(w.abs().max()), 1.0)


def test_cpu_path_under_grad_is_the_plain_version():
    arrs, dy, _, _ = make(5, 1, 32, 2, 16, 8, "none")
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    before = counts()
    y, _ = ops.ssd(*leaves, chunk=16)
    torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert counts() == before


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    x, dt, A, Bm, Cm, dy, h0, df, cum = piece_inputs(SHAPES[0], 14)
    _, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, 32)
    with pytest.raises(ValueError, match="needs CUDA states"):
        kernel.ssd_carry_bwd_cuda(states, cum, Cm, dy, 32)
    with pytest.raises(ValueError, match="needs a CUDA x"):
        kernel.ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, states, states, 32)
    # The training shapes (mamba2-780m, zamba2-1.2b), the sweep's and
    # Mamba2's chunk of 256 fit a block's shared memory.
    for Q, N, P in ((64, 128, 64), (64, 64, 64), (32, 16, 32), (16, 32, 16),
                    (128, 64, 64), (256, 128, 64), (50, 16, 16)):
        assert kernel.chunk_bwd_smem_bytes(Q, N, P) <= kernel.MAX_SMEM_BYTES
    # Heads per block on an H100 SXM (132 SMs) and PCIe (114): mamba2-780m
    # at 2 x 4096 (128 (batch, chunk) pairs, 48 heads), zamba2-1.2b at
    # 1 x 2048 (32 pairs, 64 heads).
    assert kernel.bwd_heads_per_block(128, 48, 132) == 16
    assert kernel.bwd_heads_per_block(32, 64, 132) == 4
    assert kernel.bwd_heads_per_block(32, 64, 114) == 8
    assert kernel.bwd_heads_per_block(1, 3, 132) == 1


def c_signatures(source):
    """{entry point: [ctypes type per parameter]} of the ``extern "C"``
    functions of a CUDA source: a pointer parameter is c_void_p, an int
    c_int."""
    import ctypes
    import re
    text = source.read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        out[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                     for p in params.split(",")]
    return out


@pytest.mark.parametrize("lib", ["LIB", "LIB_BWD"])
def test_ctypes_bindings_match_the_c_entry_points(lib):
    """Every entry point is bound with one ctypes type per C parameter:
    an int too few would pass the stream as a 32-bit int."""
    import types
    library = getattr(kernel, lib)
    want = c_signatures(library.source)
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                    for n in want})
    library._bind(fake)
    assert want
    for name, types_ in want.items():
        assert getattr(fake, name).argtypes == types_, name


# ---------------------------------------------------------------------------
# The tensor-core backward kernels' arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def bf16_terms(v, n):
    """``n`` bf16-valued fp32 terms of ``v``: each the round-to-nearest
    bf16 of what the earlier ones left, as the kernels split."""
    terms = []
    for _ in range(n):
        t = v.bfloat16().float()
        terms.append(t)
        v = v - t
    return terms


def split_sum(v, n):
    """What a product sees of ``v`` split into ``n`` bf16 terms, each
    multiplied exactly by a bf16 partner: the sum of the terms."""
    return sum(bf16_terms(v, n))


def emulate_tensor_core_carry_bwd(states, cum, Cm, dy, chunk, init_state,
                                  dfinal, terms):
    """``ssd_carry_bwd_tc``'s arithmetic: the walks in fp32; each chunk's
    Σ_i exp(cum_i) C_i ⊗ dy_i with exp(cum_i)·C_i (fp32) split into
    ``terms`` bf16 terms and dy as read (bf16), exact products, fp32
    sums, the chunk's 64-row slabs summed in order (one slab up to 64
    rows)."""
    Bsz, nc, H, N, P = states.shape
    f32 = torch.float32
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H)
    decay = torch.exp(cumc[:, :, -1, :])[..., None, None]
    h = (torch.zeros((Bsz, H, N, P)) if init_state is None
         else init_state.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = decay[:, c] * h + states[:, c]
    ec = Cm.bfloat16().float().reshape(Bsz, nc, chunk, 1, N) \
        * torch.exp(cumc)[..., None]                       # [b,c,i,h,n]
    dyc = dy.bfloat16().float().reshape(Bsz, nc, chunk, H, P)
    ecs, slab = split_sum(ec, terms), min(chunk, 64)
    cdy = sum(torch.einsum("bcihn,bcihp->bchnp", ecs[:, :, s:s + slab],
                           dyc[:, :, s:s + slab])
              for s in range(0, chunk, slab))
    g = torch.zeros((Bsz, H, N, P)) if dfinal is None else dfinal.to(f32)
    gs = [g] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = decay[:, c] * g + cdy[:, c]
    return torch.stack(h_prevs, 1), torch.stack(gs, 1), g


def emulate_tensor_core_chunk_bwd(x, dt, cum, Bm, Cm, dy, g, h_prev, chunk,
                                  heads_per_group, terms):
    """``ssd_chunk_bwd_tc``'s arithmetic, and over 64 × 64 tiles
    ``ssd_chunk_bwd_tc_tiled``'s (the same values; only fp32 sums run in
    another order): x, B, C and dy in bf16; C·Bᵀ and dW = dy·xᵀ with exact
    products and fp32 sums; every product with an fp32 operand (K∘dt for
    dx, g for B·g and x·gᵀ, h_prev for dy·h_prevᵀ, the group's summed
    dW∘E∘dt for dB and dC) with that operand split into ``terms`` bf16
    terms; ⟨B_j ⊗ x_j, g⟩ as x_j · (B·g)_j and the other reductions in
    fp32.  Returns what ``ssd_chunk_bwd_ref`` does."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc, G = L // chunk, heads_per_group
    f32 = torch.float32
    xc = x.bfloat16().float().reshape(Bsz, nc, chunk, H, P)
    dyc = dy.bfloat16().float().reshape(Bsz, nc, chunk, H, P)
    dtc = dt.to(f32).reshape(Bsz, nc, chunk, H)
    cumc = cum.to(f32).reshape(Bsz, nc, chunk, H)
    Bc = Bm.bfloat16().float().reshape(Bsz, nc, chunk, N)
    Cc = Cm.bfloat16().float().reshape(Bsz, nc, chunk, N)
    gt, ht = split_sum(g.to(f32), terms), split_sum(h_prev.to(f32), terms)
    iota = torch.arange(chunk)
    causal = (iota[:, None] >= iota[None, :])[None, None, :, :, None]
    seg = cumc[:, :, :, None, :] - cumc[:, :, None, :, :]
    E = torch.where(causal, torch.exp(seg), 0.0)            # [b,c,i,j,h]
    K = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None] * E
    dt_j = dtc[:, :, None, :, :]
    dW = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    V = dW * K
    T = V * dt_j
    dexp = torch.exp(cumc[:, :, -1:, :] - cumc)
    d = dexp * dtc
    bg = torch.einsum("bcjn,bchnp->bcjhp", Bc, gt)
    dx = torch.einsum("bcijh,bcihp->bcjhp", split_sum(K * dt_j, terms), dyc) \
        + d[..., None] * bg
    ured = (xc * bg).sum(-1)
    ecum = torch.exp(cumc)
    dyh = torch.einsum("bcihp,bchnp->bcihn", dyc, ht)
    dcum = T.sum(3) - T.sum(2) - d * ured \
        + ecum * torch.einsum("bcin,bcihn->bcih", Cc, dyh)
    dcum[:, :, -1, :] += (d * ured).sum(2) + torch.exp(cumc[:, :, -1, :]) \
        * (g * h_prev).sum((-2, -1))
    ddt = V.sum(2) + dexp * ured
    dCB = split_sum((dW * E * dt_j).reshape(Bsz, nc, chunk, chunk, H // G, G)
                    .sum(5), terms)
    shape = (-1, Bsz, L, N)
    gx = torch.einsum("bcjhp,bchnp->bcjhn", xc, gt)
    dB = torch.einsum("bcijg,bcin->gbcjn", dCB, Cc).reshape(shape) \
        + ref_mod._group_heads(d[..., None] * gx, G)
    dC = torch.einsum("bcijg,bcjn->gbcin", dCB, Bc).reshape(shape) \
        + ref_mod._group_heads(ecum[..., None] * dyh, G)
    return (dx.reshape(Bsz, L, H, P), dcum.reshape(Bsz, L, H),
            ddt.reshape(Bsz, L, H), dB, dC)


# The tensor-core kernels' shapes (Q = P = 64, N = 128 and 64), a few heads
# and chunks, bf16 inputs with a nonzero initial state and dfinal.
BWD_EMU_SHAPES = [(1, 256, 4, 64, 128, 64), (2, 256, 4, 64, 64, 64)]


def bwd_emulation_ratios(terms):
    """Worst max|Δ| / (1e-4·max(max|ref|, 1)) per output of each emulated
    kernel against its plain version on the same inputs, over
    ``BWD_EMU_SHAPES``."""
    worst = {}
    for B, L, H, P, N, Q in BWD_EMU_SHAPES:
        arrs, dy, h0, df = make(B * L + N, B, L, H, P, N, "nonzero")
        ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.bfloat16)
        x, dt, A, Bm, Cm = ts
        cum = chunk_cumsum(dt, A, Q)
        _, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
        args = (states, cum, Cm, tdy, Q, th0, tdf)
        want = ssd_carry_bwd_ref(*args)
        got = emulate_tensor_core_carry_bwd(*args, terms)
        named = list(zip(("h_prev", "g", "d init_state"), got, want))
        h_prev, g = want[0], want[1]
        args = (x, dt, cum, Bm, Cm, tdy, g, h_prev, Q, 2)
        named += zip(("dx", "dcum", "ddt", "dB", "dC"),
                     emulate_tensor_core_chunk_bwd(*args, terms),
                     ssd_chunk_bwd_ref(*args))
        for name, a, w in named:
            bar = 1e-4 * max(float(w.abs().max()), 1.0)
            worst[name] = max(worst.get(name, 0.0),
                              float((a - w).abs().max()) / bar)
    return worst


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_tensor_core_bwd_emulation_meets_the_bar(terms):
    """``BWD_TERMS`` (2) and three terms keep every output of both
    emulated kernels within half its bar, three nearly exact; one term (a
    single bf16 rounding) misses the bar.  The worst ratios are printed
    (``-s``)."""
    assert kernel.BWD_TERMS == 2
    ratios = bwd_emulation_ratios(terms)
    print(f"\nterms={terms}: worst max|Δ|/bar " + ", ".join(
        f"{k} {v:.4f}" for k, v in ratios.items()))
    if terms == 1:
        assert max(ratios.values()) > 1.0, ratios
    else:
        # BWD_TERMS is the fewest terms with a margin of 2 on every output.
        assert max(ratios.values()) <= 0.5, ratios
    if terms == 3:
        assert max(ratios.values()) <= 0.01, ratios


BWD_TC = ("ssd_carry_bwd_tc", "ssd_chunk_bwd_tc")
BWD_TF32 = ("ssd_carry_bwd_tf32", "ssd_chunk_bwd_tf32")
BWD_CORE = ("ssd_carry_bwd", "ssd_chunk_bwd")
BWD_TILED = ("ssd_carry_bwd_tc", "ssd_chunk_bwd_tc_tiled")
BWD_TF32_TILED = ("ssd_carry_bwd_tf32", "ssd_chunk_bwd_tf32_tiled")


@pytest.mark.parametrize("dtype,Q,P,N,want", [
    ("bfloat16", 64, 64, 128, BWD_TC), ("bfloat16", 64, 64, 64, BWD_TC),
    ("float32", 64, 64, 128, BWD_TF32), ("float32", 64, 64, 64, BWD_TF32)]
    + [("bfloat16", Q, 64, N, BWD_TILED) for Q in (128, 192, 256)
       for N in (64, 128)]
    + [(dt, Q, P, N, BWD_CORE) for dt in ("bfloat16", "float32")
       for Q, P, N in ((32, 64, 128), (64, 32, 128), (64, 64, 32),
                       (16, 16, 32), (128, 32, 128), (100, 64, 64),
                       (50, 64, 128))]
    + [("float32", Q, 64, 128, BWD_TF32_TILED) for Q in (128, 256)]
    + [("float32", Q, 64, N, BWD_TF32_TILED)
       for Q, N in ((192, 128), (128, 64), (192, 64), (256, 64))])
def test_backward_dispatch_by_dtype_and_shape(dtype, Q, P, N, want):
    """At the forward tensor-core kernels' shapes (Q = P = 64, N in {64,
    128}) bf16 takes the ``_tc`` pair and fp32 the ``_tf32`` pair; at Q =
    128, 192, 256 (P 64, N 64 or 128) the carry backward of the dtype
    (``ssd_carry_bwd_tc`` or ``ssd_carry_bwd_tf32``, in 64-row slabs) and
    the tiled chunk backward of the dtype, ``ssd_chunk_bwd_tc_tiled`` or
    ``ssd_chunk_bwd_tf32_tiled``; at any other chunk (chunks not a
    multiple of 64), head width or state size either dtype takes the
    CUDA-core pair; the pairs name every backward kernel."""
    assert kernel.bwd_kernels(getattr(torch, dtype), Q, P, N) == want
    assert set(BWD_TC + BWD_TF32 + BWD_CORE + BWD_TILED
               + BWD_TF32_TILED) == set(kernel.BWD_KERNELS)


def test_bwd_terms_is_the_kernels_term_count():
    """``BWD_TERMS``, which the CPU emulation holds to the bars, is the
    term count the tensor-core kernels are built with (``kBwdTerms``)."""
    src = (kernel.CSRC / "ssd_bwd.cu").read_text()
    found = re.findall(r"constexpr int kBwdTerms = (\d+);", src)
    assert found == [str(kernel.BWD_TERMS)]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (B, L, H, P, N, Q, dtype): the sweep at the backward's chunk, the two
# models' head widths at short sequences, both dtypes.
CUDA_SHAPES = [(2, 128, 3, 32, 16, 32, "float32"),
               (1, 256, 2, 64, 128, 64, "float32"),
               (2, 64, 4, 16, 32, 16, "float32"),
               (1, 128, 1, 64, 64, 64, "float32"),
               (1, 256, 48, 64, 128, 64, "bfloat16"),
               (1, 256, 64, 64, 64, 64, "bfloat16"),
               (2, 256, 48, 64, 128, 64, "float32")]
# Chunks the backward took from this slice on: the sweep's 128 and
# Mamba2's 256 (blocks of 64 rows), 100 (a short last block), 50 and 7
# (one block, padded to a multiple of 4) and a single row, both dtypes.
CHUNK_SHAPES = [s + (dt,) for s in ((1, 128, 1, 64, 64, 128),
                                    (1, 512, 4, 64, 128, 256),
                                    (1, 50, 2, 16, 16, 50))
                for dt in ("float32", "bfloat16")] + [
    (1, 300, 2, 32, 64, 100, "float32"), (1, 28, 3, 24, 32, 7, "bfloat16"),
    (1, 8, 2, 8, 8, 1, "float32")]
CUDA_SHAPES += CHUNK_SHAPES


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD backward kernels have no "
                    "CPU mode")


def card_inputs(shape, seed, dtype):
    B, L, H, P, N, Q = shape
    x, dt, A, Bm, Cm, dy, h0, df, _ = piece_inputs(shape, seed)
    tdt = getattr(torch, dtype)
    x, Bm, Cm, dy = (t.to(tdt).cuda() for t in (x, Bm, Cm, dy))
    dt, A, h0, df = (t.cuda() for t in (dt, A, h0, df))
    return x, dt, A, Bm, Cm, dy, h0, df, chunk_cumsum(dt, A, Q)


def within(got, want):
    return float((got - want).abs().max()) <= 1e-4 * max(
        float(want.abs().max()), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q,dtype", CUDA_SHAPES)
def test_cuda_backward_kernels_match_plain(B, L, H, P, N, Q, dtype):
    """Each kernel against its plain version on the same inputs (fp32
    max|Δ| <= 1e-4·max(max|ref|, 1)); a second pass equal bit for bit."""
    needs_card()
    shape = (B, L, H, P, N, Q)
    x, dt, A, Bm, Cm, dy, h0, df, cum = card_inputs(shape, 30, dtype)
    _, states = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    got = kernel.ssd_carry_bwd_cuda(states, cum, Cm, dy, Q, h0, df)
    again = kernel.ssd_carry_bwd_cuda(states, cum, Cm, dy, Q, h0, df)
    want = ssd_carry_bwd_ref(states, cum, Cm, dy, Q, h0, df)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and within(g, w)
    h_prev, g = want[0], want[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    G = kernel.chunk_bwd_heads(
        kernel.bwd_kernels(getattr(torch, dtype), Q, P, N)[1], B * L // Q, H,
        sms, Q)
    got = kernel.ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, g, h_prev, Q)
    again = kernel.ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, g, h_prev, Q)
    want = ssd_chunk_bwd_ref(x, dt, cum, Bm, Cm, dy, g, h_prev, Q, G)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b) and within(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q,dtype",
                         CUDA_SHAPES[:6] + CHUNK_SHAPES)
def test_cuda_operator_matches_plain_autograd(B, L, H, P, N, Q, dtype):
    """``ssd`` under grad on the card: the forward kernels, then the
    backward kernels, against torch autograd of ``ssd_ref`` on the card,
    each gradient within 1e-4·max(max|ref|, 1) in fp32 (bf16 gradients
    within one bf16 step of it)."""
    needs_card()
    shape = (B, L, H, P, N, Q)
    x, dt, A, Bm, Cm, dy, h0, df, _ = card_inputs(shape, 31, dtype)
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm, h0)]
    y, final = ops.ssd(*leaves[:5], chunk=Q, init_state=leaves[5])
    got = torch.autograd.grad((y, final), leaves, (dy, df))
    # The plain gradient in fp32 on the inputs' values (see
    # autograd_grads).
    plain = [t.float().clone().requires_grad_(True)
             for t in (x, dt, A, Bm, Cm, h0)]
    y2, f2 = ssd_ref(*plain[:5], chunk=Q, init_state=plain[5])
    want = torch.autograd.grad((y2, f2), plain, (dy.float(), df))
    torch.cuda.synchronize()
    ran = kernel.bwd_kernels(getattr(torch, dtype), Q, P, N)
    for name in kernel.BWD_KERNELS:
        assert kernel.BWD_KERNEL_LAUNCHES[name] == before[name] + (
            name in ran)
    for t, g, w in zip(leaves, got, want):
        assert g.dtype == t.dtype
        scale = 1e-4 * max(float(w.float().abs().max()), 1.0)
        bar = scale + (BF16_REL * w.float().abs()
                       if g.dtype == torch.bfloat16 else 0.0)
        assert bool(((g.float() - w.float()).abs() <= bar).all())


@pytest.mark.cuda
def test_tensor_core_backward_tiles_fit_shared_memory():
    """At the training shapes, as the library reports them:
    ssd_chunk_bwd_tc with 16 heads per block (one block an SM),
    ssd_carry_bwd_tc with two blocks an SM (the carry's decay table at 64
    and 512 chunks)."""
    needs_card()
    smem = kernel.LIB_BWD.load().ssd_bwd_tc_smem_bytes
    for N in (64, 128):
        assert 0 < smem(0, N, 16) <= kernel.MAX_SMEM_BYTES
    assert smem(0, 128, 16) == 229_920
    for nc in (64, 512):
        assert 2 * (smem(1, 128, nc) + 1024) <= 228 * 1024
    assert smem(2, 128, 16) == smem(0, 32, 16) == -1


@pytest.mark.cuda
def test_cuda_chunk_backward_tiles_fit_shared_memory():
    """The backward library's own sizes at Q = 256, N = 128, P = 64 (the
    CUDA-core chunk kernel's blocks of 64 rows, the carry's C and dy
    slice), equal to kernel.py's mirrors and within a block's shared
    memory."""
    needs_card()
    size = kernel.LIB_BWD.load().ssd_bwd_smem_bytes
    Q, N, P = 256, 128, 64
    assert size(0, Q, N, P) == kernel.chunk_bwd_smem_bytes(Q, N, P)
    assert size(1, Q, N, P) == 4 * Q * (N + 16)
    for which in (0, 1):
        assert 0 < size(which, Q, N, P) <= kernel.MAX_SMEM_BYTES
    assert size(2, Q, N, P) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 48, 64, 128, 64),
                                         (1, 256, 64, 64, 64, 64)])
def test_cuda_tensor_core_backward_kernels_match_plain(B, L, H, P, N, Q):
    """``ssd_carry_bwd_tc`` and ``ssd_chunk_bwd_tc`` on bf16 inputs
    against their plain versions
    (fp32 max|Δ| <= 1e-4·max(max|ref|, 1)), a second pass equal bit for
    bit, each launch counted under its own name."""
    needs_card()
    shape = (B, L, H, P, N, Q)
    x, dt, A, Bm, Cm, dy, h0, df, cum = card_inputs(shape, 32, "bfloat16")
    _, states = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    args = (states, cum, Cm, dy, Q, h0, df)
    got = kernel.ssd_carry_bwd_cuda(*args)
    again = kernel.ssd_carry_bwd_cuda(*args)
    want = ssd_carry_bwd_ref(*args)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and within(g, w)
    h_prev, g = want[0], want[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    G = kernel.bwd_heads_per_block(B * L // Q, H, sms)
    args = (x, dt, cum, Bm, Cm, dy, g, h_prev, Q)
    got = kernel.ssd_chunk_bwd_cuda(*args)
    again = kernel.ssd_chunk_bwd_cuda(*args)
    want = ssd_chunk_bwd_ref(*args, G)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b) and within(a, w)
    for name in kernel.BWD_KERNELS:
        assert kernel.BWD_KERNEL_LAUNCHES[name] == before[name] + 2 * (
            name.endswith("_tc"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Q", [("bfloat16", 32), ("float32", 32),
                                     ("float32", 64)])
def test_cuda_wrappers_send_other_inputs_to_the_cuda_cores(dtype, Q):
    """bf16 and fp32 at a chunk of 32 reach the CUDA-core kernels through
    the wrappers' dispatch; fp32 at the tensor-core shape the ``_tf32``
    pair."""
    needs_card()
    shape = (1, 256, 4, 64, 128, Q)
    x, dt, A, Bm, Cm, dy, h0, df, cum = card_inputs(shape, 33, dtype)
    _, states = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    ran = kernel.bwd_kernels(getattr(torch, dtype), Q, 64, 128)
    assert ran[0] == ("ssd_carry_bwd" if Q == 32 else "ssd_carry_bwd_tf32")
    h_prev, g, _ = kernel.ssd_carry_bwd_cuda(states, cum, Cm, dy, Q, h0, df)
    got = kernel.ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, g, h_prev, Q)
    want = ssd_chunk_bwd_ref(x, dt, cum, Bm, Cm, dy, g, h_prev, Q,
                             kernel.chunk_bwd_heads(
                                 ran[1], 256 // Q, 4,
                                 torch.cuda.get_device_properties(
                                     0).multi_processor_count))
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert within(a, w)
    for name in kernel.BWD_KERNELS:
        assert kernel.BWD_KERNEL_LAUNCHES[name] == before[name] + (
            name in ran)


@pytest.mark.cuda
def test_cuda_tensor_core_launch_failure_raises(monkeypatch):
    """A refused ``_tc`` launch raises; the wrapper launches no other
    kernel in its place and counts nothing."""
    needs_card()
    import types
    shape = (1, 128, 2, 64, 64, 64)
    x, dt, A, Bm, Cm, dy, h0, df, cum = card_inputs(shape, 34, "bfloat16")
    _, states = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, 64)
    calls = []

    def refuse(*args):
        calls.append(args)
        return 1     # cudaErrorInvalidValue
    fake = types.SimpleNamespace(ssd_carry_bwd_launch=refuse,
                                 ssd_chunk_bwd_launch=refuse)
    monkeypatch.setattr(kernel.LIB_BWD, "load", lambda: fake)
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    with pytest.raises(RuntimeError, match="ssd_carry_bwd_tc"):
        kernel.ssd_carry_bwd_cuda(states, cum, Cm, dy, 64, h0, df)
    g = torch.zeros_like(states)
    with pytest.raises(RuntimeError, match="ssd_chunk_bwd_tc"):
        kernel.ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, g, g, 64)
    assert len(calls) == 2 and kernel.BWD_KERNEL_LAUNCHES == before


# ---------------------------------------------------------------------------
# The CUDA-core chunk backward's walk over blocks of rows, emulated
# ---------------------------------------------------------------------------

def emulate_blocked_chunk_bwd(x, dt, cum, Bm, Cm, dy, g, h_prev, chunk,
                              heads_per_group):
    """``ssd_chunk_bwd``'s walk in fp32, as ``ssd_chunk_bwd_ref``'s
    outputs.  Each chunk is cut into blocks of T = ``kernel.bwd_rows``
    rows, zeros past the chunk.  Phase 1, block k by block k: the state
    and inter terms (dx's d_j Bᵀ_j g, dB's d_j g x_j and dC's exp(cum_i)
    h_prev dy_i summed over each group's heads, dcum's inter − d·U, ddt's
    dex·U) and the intra term of the pair (k, k); dcum_last's chunk terms
    summed block by block and added at the end.  Phase 2, pairs (i, j)
    with i > j, j the outer walk: the pair's intra term added to what
    phase 1 wrote.  A pair's intra term: dW, K and V on its tile and the
    group's sum of dW ∘ E ∘ dt; dcum_i += row sums of V ∘ dt, dcum_j −=
    dt_j · column sums of V, ddt_j += the column sums, dx_j += dt_j (Kᵀ
    dy_i), dC_i and dB_j from the group's sum."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc, G = L // chunk, heads_per_group
    T = kernel.bwd_rows(chunk)
    nb = -(-chunk // T)
    Qp = nb * T
    f32 = torch.float32

    def padded(t, tail):     # [B, L, *tail] → [B, nc, Qp, *tail], zeros
        t = t.to(f32).reshape(Bsz, nc, chunk, *tail)
        out = torch.zeros((Bsz, nc, Qp) + tuple(tail))
        out[:, :, :chunk] = t
        return out
    xc, dyc = padded(x, (H, P)), padded(dy, (H, P))
    dtc, cumc = padded(dt, (H,)), padded(cum, (H,))
    Bc, Cc = padded(Bm, (N,)), padded(Cm, (N,))
    valid = torch.arange(Qp) < chunk
    g, h_prev = g.to(f32), h_prev.to(f32)
    cl = cum.to(f32).reshape(Bsz, nc, chunk, H)[:, :, -1, :]  # [B,nc,H]
    vmask = valid[None, None, :, None]
    ecum = torch.where(vmask, torch.exp(cumc), 0.0)
    dex = torch.where(vmask, torch.exp(cl[:, :, None, :] - cumc), 0.0)
    d = dex * dtc

    def by_group(t):          # [B,nc,r,H,N] → [B,nc,r,groups,N]
        return t.reshape(*t.shape[:3], H // G, G, N).sum(4)
    dx = torch.zeros_like(xc)
    dcum, ddt = torch.zeros_like(dtc), torch.zeros_like(dtc)
    dB = torch.zeros((Bsz, nc, Qp, H // G, N))
    dC = torch.zeros_like(dB)

    def pair(I, J):           # the intra term of blocks (i, j), i >= j
        i, j = slice(I * T, (I + 1) * T), slice(J * T, (J + 1) * T)
        rows_i, rows_j = torch.arange(Qp)[i], torch.arange(Qp)[j]
        mask = ((rows_i[:, None] >= rows_j[None, :])
                & valid[i][:, None] & valid[j][None, :])[
            None, None, :, :, None]
        seg = cumc[:, :, i, None, :] - cumc[:, :, None, j, :]
        E = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
        cb = torch.einsum("bcin,bcjn->bcij", Cc[:, :, i], Bc[:, :, j])
        Km = cb[..., None] * E
        dW = torch.einsum("bcihp,bcjhp->bcijh", dyc[:, :, i], xc[:, :, j])
        V = dW * Km
        dt_j = dtc[:, :, None, j, :]
        dcb = (dW * E * dt_j).reshape(*dW.shape[:4], H // G, G).sum(5)
        dcum[:, :, i] += (V * dt_j).sum(3)
        colv = V.sum(2)
        dcum[:, :, j] -= dtc[:, :, j] * colv
        ddt[:, :, j] += colv
        dx[:, :, j] += dtc[:, :, j, :, None] * torch.einsum(
            "bcijh,bcihp->bcjhp", Km, dyc[:, :, i])
        dC[:, :, i] += torch.einsum("bcijg,bcjn->bcign", dcb, Bc[:, :, j])
        dB[:, :, j] += torch.einsum("bcijg,bcin->bcjgn", dcb, Cc[:, :, i])

    tail = torch.exp(cl) * (g * h_prev).sum((-2, -1))        # [B,nc,H]
    for K in range(nb):
        k = slice(K * T, (K + 1) * T)
        dx[:, :, k] = d[:, :, k, :, None] * torch.einsum(
            "bcjn,bchnp->bcjhp", Bc[:, :, k], g)
        gx = torch.einsum("bcjhp,bchnp->bcjhn", xc[:, :, k], g)
        ured = torch.einsum("bcjn,bcjhn->bcjh", Bc[:, :, k], gx)
        dB[:, :, k] = by_group(d[:, :, k, :, None] * gx)
        dyh = torch.einsum("bcihp,bchnp->bcihn", dyc[:, :, k], h_prev)
        inter = ecum[:, :, k] * torch.einsum("bcin,bcihn->bcih",
                                             Cc[:, :, k], dyh)
        dC[:, :, k] = by_group(ecum[:, :, k, :, None] * dyh)
        dcum[:, :, k] = inter - d[:, :, k] * ured
        ddt[:, :, k] = dex[:, :, k] * ured
        tail = tail + (d[:, :, k] * ured).sum(2)
        pair(K, K)
    dcum[:, :, chunk - 1] += tail
    for J in range(nb):
        for I in range(J + 1, nb):
            pair(I, J)

    def cut(t):               # [B, nc, Qp, *tail] → [B, L, *tail]
        return t[:, :, :chunk].reshape(Bsz, L, *t.shape[3:])
    return (cut(dx), cut(dcum), cut(ddt), cut(dB).permute(2, 0, 1, 3),
            cut(dC).permute(2, 0, 1, 3))


# Chunks of 128 and 256 rows (two and four blocks), 100 (a short second
# block) and 50 (one block padded to 52 rows); groups of two heads.
BLOCKED = [(1, 256, 2, 64, 64, 128), (1, 512, 2, 64, 128, 256),
           (1, 300, 2, 32, 64, 100), (1, 100, 4, 16, 16, 50)]


@pytest.mark.parametrize("shape", BLOCKED)
def test_blocked_chunk_bwd_emulation_meets_the_bar(shape):
    """The blocked walk against ``ssd_chunk_bwd_ref`` (fp32 max|Δ| <=
    1e-4·max(max|ref|, 1), the kernels' bar), and with the plain carry
    backward and the cumsum's gradient against ``jax.vjp`` of the
    reference's ``ssd_ref``."""
    B, L, H, P, N, Q = shape
    arrs, dy, h0, df = make(B * L + N + 2, B, L, H, P, N, "nonzero")
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.float32)
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    _, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    h_prev, g, dinit = ssd_carry_bwd_ref(states, cum, Cm, tdy, Q, th0, tdf)
    got = emulate_blocked_chunk_bwd(x, dt, cum, Bm, Cm, tdy, g, h_prev, Q, 2)
    want = ssd_chunk_bwd_ref(x, dt, cum, Bm, Cm, tdy, g, h_prev, Q, 2)
    for name, a, w in zip(("dx", "dcum", "ddt", "dB", "dC"), got, want):
        assert a.shape == w.shape, name
        assert_grad_close(name, a, w)
    dx, dcum, ddt, dB, dC = got
    ddt_cum, dA = chunk_cumsum_bwd(dcum, dt, A, Q)
    whole = (dx, ddt + ddt_cum, dA, dB.sum(0), dC.sum(0), dinit)
    for name, a, w in zip(NAMES, whole, jax_grads(arrs, dy, h0, df, Q,
                                                  torch.float32)):
        assert_grad_close(name, a, w)


# ---------------------------------------------------------------------------
# The bf16 tensor-core chunk backward over 64 x 64 tiles
# ---------------------------------------------------------------------------

# ssd_chunk_bwd_tc_tiled's chunks of 128, 192 and 256 rows at both state
# sizes, heads in groups of two.
TILED_BWD_SHAPES = [(1, 256, 2, 64, 128, 128), (1, 384, 4, 64, 64, 192),
                    (1, 512, 2, 64, 128, 256), (1, 512, 4, 64, 64, 256)]


def tiled_bwd_case(shape):
    """Inputs whose x, B, C and dy are bf16 values (so that the
    reference's fp32 run reads what the kernel reads), with a nonzero
    initial state and dfinal; the chunk backward's arguments with the plain
    carry backward's h_prev and g (the emulated ``ssd_carry_bwd_tc`` at
    these chunks is held apart, ``test_tiled_carry_bwd_emulation_meets_
    the_bar``), and d init_state."""
    B, L, H, P, N, Q = shape
    arrs, dy, h0, df = make(B * L + N + 5, B, L, H, P, N, "nonzero")
    for i in (0, 3, 4):
        arrs[i] = torch.from_numpy(arrs[i]).bfloat16().float().numpy()
    dy = torch.from_numpy(dy).bfloat16().float().numpy()
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.bfloat16)
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    _, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    h_prev, g, dinit = ssd_carry_bwd_ref(states, cum, Cm, tdy, Q, th0, tdf)
    return (arrs, dy, h0, df), (x, dt, cum, Bm, Cm, tdy, g, h_prev, Q, 2), \
        dinit


def tiled_bwd_ratios(terms):
    """Worst max|Δ| / (1e-4·max(max|ref|, 1)) per output of the emulated
    ``ssd_chunk_bwd_tc_tiled`` against ``ssd_chunk_bwd_ref`` over
    ``TILED_BWD_SHAPES``."""
    worst = {}
    for shape in TILED_BWD_SHAPES:
        _, args, _ = tiled_bwd_case(shape)
        for name, a, w in zip(("dx", "dcum", "ddt", "dB", "dC"),
                              emulate_tensor_core_chunk_bwd(*args, terms),
                              ssd_chunk_bwd_ref(*args)):
            bar = 1e-4 * max(float(w.abs().max()), 1.0)
            worst[name] = max(worst.get(name, 0.0),
                              float((a - w).abs().max()) / bar)
    return worst


@pytest.mark.parametrize("shape", TILED_BWD_SHAPES)
def test_tiled_chunk_bwd_emulation_meets_the_bar(shape):
    """``ssd_chunk_bwd_tc_tiled``'s arithmetic (``BWD_TERMS`` bf16 terms,
    the group's dW∘E∘dt summed over its heads, then split) against
    ``ssd_chunk_bwd_ref`` on the same inputs; with the plain carry
    backward and the cumsum's gradient, the whole gradient against
    ``jax.vjp`` of the reference's ``ssd_ref`` on the same values, each
    within 1e-4·max(max|ref|, 1)."""
    Q, N = shape[-1], shape[4]
    assert kernel.bwd_kernels(torch.bfloat16, Q, 64, N) == BWD_TILED
    (arrs, dy, h0, df), args, dinit = tiled_bwd_case(shape)
    got = emulate_tensor_core_chunk_bwd(*args, kernel.BWD_TERMS)
    for name, a, w in zip(("dx", "dcum", "ddt", "dB", "dC"), got,
                          ssd_chunk_bwd_ref(*args)):
        assert_grad_close(name, a, w)
    dx, dcum, ddt, dB, dC = got
    ddt_cum, dA = chunk_cumsum_bwd(dcum, args[1], torch.from_numpy(arrs[2]),
                                   Q)
    whole = (dx, ddt + ddt_cum, dA, dB.sum(0), dC.sum(0), dinit)
    for name, a, w in zip(NAMES, whole, jax_grads(arrs, dy, h0, df, Q,
                                                  torch.float32)):
        assert_grad_close(name, a, w)


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_tiled_chunk_bwd_term_counts(terms):
    """At the tiled chunks one bf16 term misses the bar; ``BWD_TERMS`` (2)
    keeps every output within half of it, three nearly exact.  The worst
    ratios are printed (``-s``)."""
    ratios = tiled_bwd_ratios(terms)
    print(f"\nterms={terms}: worst max|Δ|/bar " + ", ".join(
        f"{k} {v:.4f}" for k, v in ratios.items()))
    if terms == 1:
        assert max(ratios.values()) > 1.0, ratios
    else:
        assert max(ratios.values()) <= 0.5, ratios
    if terms == 3:
        assert max(ratios.values()) <= 0.01, ratios


def test_tiled_backward_tiles_fit_shared_memory():
    """``ssd_chunk_bwd_tc_tiled``'s shared memory at every chunk and state
    size it takes fits a block (one block an SM), and its heads a block
    follow its Q / 64 blocks a (batch, chunk) pair: 16 at mamba2-780m's
    and zamba2-1.2b's 2 x 4096 at chunks of 128 and 256 on 132 SMs."""
    for N in (64, 128):
        for Q in kernel.TILED_Q:
            assert kernel.chunk_bwd_tiled_smem_bytes(N, Q) \
                <= kernel.MAX_SMEM_BYTES
    assert kernel.chunk_bwd_tiled_smem_bytes(128, 256) == 215_072
    name = "ssd_chunk_bwd_tc_tiled"
    for H, Q in ((48, 128), (48, 256), (64, 256)):
        assert kernel.chunk_bwd_heads(name, 2 * 4096 // Q, H, 132, Q) == 16
    assert kernel.chunk_bwd_heads(name, 2, 4, 132, 256) == 1


def test_tiled_backward_flops_count_its_products():
    """The op's flop count follows the tiled kernels: in bf16 C·Bᵀ per
    head (2Q²N) and the group's dW∘E∘dt against C and B once per block of
    16 heads (4Q²N); in fp32 (``ssd_chunk_bwd_tf32_tiled``) C·Bᵀ and both
    products once per block of its G heads (6Q²N); the chunk pass, carry
    backward and per-head products as at Q = 64."""
    B, L, H, P, N, Q = 2, 4096, 48, 64, 128, 256
    nc = L // Q
    per_head = (2 * Q * Q * N + 6 * Q * Q * P + 10 * Q * N * P)
    assert ops.ssd_bwd_flops(B, L, H, P, N, Q) == B * nc * (
        H * (per_head + 2 * Q * Q * N) + H // 16 * 4 * Q * Q * N)
    G = kernel.chunk_bwd_heads("ssd_chunk_bwd_tf32_tiled", B * nc, H, 132, Q)
    assert ops.ssd_bwd_flops(B, L, H, P, N, Q, dtype=torch.float32) == \
        B * nc * (H * per_head + H // G * 6 * Q * Q * N)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 4, 64, 128, 128),
                                         (1, 384, 6, 64, 64, 192),
                                         (2, 512, 8, 64, 128, 256),
                                         (1, 512, 4, 64, 64, 256)])
def test_cuda_tiled_backward_kernel_matches_plain(B, L, H, P, N, Q):
    """``ssd_chunk_bwd_tc_tiled`` on bf16 inputs against its plain version
    with its heads a group (fp32 max|Δ| <= 1e-4·max(max|ref|, 1)), a
    second pass equal bit for bit, each launch counted under its name;
    ``cuda_cores=True`` still takes ``ssd_chunk_bwd``, held too."""
    needs_card()
    shape = (B, L, H, P, N, Q)
    x, dt, A, Bm, Cm, dy, h0, df, cum = card_inputs(shape, 35, "bfloat16")
    _, states = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    h_prev, g, _ = ssd_carry_bwd_ref(states, cum, Cm, dy, Q, h0, df)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    args = (x, dt, cum, Bm, Cm, dy, g, h_prev, Q)
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    got = kernel.ssd_chunk_bwd_cuda(*args)
    again = kernel.ssd_chunk_bwd_cuda(*args)
    core = kernel.ssd_chunk_bwd_cuda(*args, cuda_cores=True)
    torch.cuda.synchronize()
    want = ssd_chunk_bwd_ref(*args, kernel.chunk_bwd_heads(
        "ssd_chunk_bwd_tc_tiled", B * L // Q, H, sms, Q))
    want_core = ssd_chunk_bwd_ref(*args, kernel.bwd_heads_per_block(
        B * L // Q, H, sms))
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b) and within(a, w)
    for c, w in zip(core, want_core):
        assert within(c, w)
    for name in kernel.BWD_KERNELS:
        assert kernel.BWD_KERNEL_LAUNCHES[name] == before[name] + {
            "ssd_chunk_bwd_tc_tiled": 2, "ssd_chunk_bwd": 1}.get(name, 0)


@pytest.mark.cuda
def test_cuda_tiled_backward_shared_memory_equals_mirror():
    """The library's ``ssd_chunk_bwd_tiled_smem_bytes`` equals kernel.py's
    mirror at every chunk and state size the kernel takes, and refuses
    anything else."""
    needs_card()
    lib = kernel.LIB_BWD.load()
    for N in (64, 128):
        for Q in kernel.TILED_Q:
            assert lib.ssd_chunk_bwd_tiled_smem_bytes(N, Q) == \
                kernel.chunk_bwd_tiled_smem_bytes(N, Q)
    for N, Q in ((32, 128), (128, 64), (128, 320), (64, 100)):
        assert lib.ssd_chunk_bwd_tiled_smem_bytes(N, Q) == -1


# ---------------------------------------------------------------------------
# The fp32 tensor-core chunk backward (TF32, three products a product)
# ---------------------------------------------------------------------------

# fp32 at ssd_chunk_bwd_tf32's shapes (Q = P = 64): the reference sweep's
# N = 128 shape and N = 64 with more heads and chunks, heads in groups of
# two as the kernel groups them.
TF32_BWD_SHAPES = [(1, 256, 2, 64, 128, 64), (2, 256, 4, 64, 64, 64)]


def tf32_bwd_case(shape, terms=3):
    """The inputs, the fp32 kernels' emulated chunk backward at ``terms``
    (with the emulated forward kernel's chunk states through the plain
    carry backward, as the op's backward launches them) and the plain
    chunk backward on the same g and h_prev."""
    B, L, H, P, N, Q = shape
    arrs, dy, h0, df = make(B * L + N + 3, B, L, H, P, N, "nonzero")
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.float32)
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    _, states = emulate_tf32_chunks(x, dt, cum, Bm, Cm, Q, terms)
    h_prev, g, dinit = ssd_carry_bwd_ref(states, cum, Cm, tdy, Q, th0, tdf)
    args = (x, dt, cum, Bm, Cm, tdy, g, h_prev, Q, 2)
    got = emulate_tf32_chunk_bwd(*args, terms=terms)
    return (arrs, dy, h0, df, ts, cum, dinit), got, ssd_chunk_bwd_ref(*args)


@pytest.mark.parametrize("shape", TF32_BWD_SHAPES)
def test_tf32_chunk_bwd_emulation_meets_the_bar(shape):
    """``ssd_chunk_bwd_tf32``'s arithmetic keeps every output within a
    tenth of 1e-4·max(max|ref|, 1) of ``ssd_chunk_bwd_ref``; finished as
    the op finishes (the groups' sums, the cumsum's gradient), with the
    fp32 forward kernel's emulated chunk states, every gradient is within
    1e-4·max(max|ref|, 1) of the reference's ``jax.vjp`` of ``ssd_ref``."""
    Q = shape[-1]
    (arrs, dy, h0, df, ts, cum, dinit), got, want = tf32_bwd_case(shape)
    for name, a, w in zip(("dx", "dcum", "ddt", "dB", "dC"), got, want):
        assert a.shape == w.shape, name
        bar = 1e-4 * max(float(w.abs().max()), 1.0)
        assert float((a - w).abs().max()) <= 0.1 * bar, name
    dx, dcum, ddt, dB, dC = got
    ddt_cum, dA = chunk_cumsum_bwd(dcum, ts[1], ts[2], Q)
    grads = (dx, ddt + ddt_cum, dA, dB.sum(0), dC.sum(0), dinit)
    for name, g, w in zip(NAMES, grads, jax_grads(arrs, dy, h0, df, Q,
                                                  torch.float32)):
        assert_grad_close(name, g, w)


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_tf32_chunk_bwd_term_counts(terms):
    """One TF32 product a product (plain TF32) misses the fp32 bar of
    ``ssd_chunk_bwd_ref``; three (the kernel's) keep every output within a
    tenth of it.  The worst ratios are printed (``-s``)."""
    worst = {}
    for shape in TF32_BWD_SHAPES:
        _, got, want = tf32_bwd_case(shape, terms)
        for name, a, w in zip(("dx", "dcum", "ddt", "dB", "dC"), got, want):
            bar = 1e-4 * max(float(w.abs().max()), 1.0)
            worst[name] = max(worst.get(name, 0.0),
                              float((a - w).abs().max()) / bar)
    print(f"\nTF32 products={terms}: worst max|Δ|/bar " + ", ".join(
        f"{k} {v:.4f}" for k, v in worst.items()))
    if terms == 1:
        assert max(worst.values()) > 1.0, worst
    if terms == 3:
        assert max(worst.values()) <= 0.1, worst


def test_tf32_backward_tiles_fit_shared_memory():
    """``ssd_chunk_bwd_tf32``'s shared memory (``kernel.
    chunk_bwd_tf32_smem_bytes``) fits a block at N = 128 with 16 heads a
    block, the most ``kernel.tf32_heads`` gives; a second g and h_prev
    buffer would not.  Its heads a block (one block an SM): 12 at the (b)
    fp32 step's 1 × 2048 (128 blocks, one wave on 132 SMs), 16 at 2 ×
    4096; ``chunk_bwd_heads`` gives the bf16 and CUDA-core kernels' rule
    elsewhere."""
    assert kernel.chunk_bwd_tf32_smem_bytes(128, 16) == 227_872
    assert kernel.chunk_bwd_tf32_smem_bytes(128, 16) <= kernel.MAX_SMEM_BYTES
    assert kernel.chunk_bwd_tf32_smem_bytes(128, 16) + 2 * 128 * 64 * 4 > \
        kernel.MAX_SMEM_BYTES
    assert kernel.chunk_bwd_tf32_smem_bytes(64, 16) <= kernel.MAX_SMEM_BYTES
    assert kernel.chunk_bwd_heads("ssd_chunk_bwd_tf32", 32, 48, 132) == 12
    assert kernel.chunk_bwd_heads("ssd_chunk_bwd_tf32", 128, 48, 132) == 16
    for name in ("ssd_chunk_bwd_tc", "ssd_chunk_bwd"):
        assert kernel.chunk_bwd_heads(name, 32, 48, 132) == \
            kernel.bwd_heads_per_block(32, 48, 132) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 48, 64, 128, 64),
                                         (1, 256, 64, 64, 64, 64),
                                         (2, 512, 8, 64, 128, 64)])
def test_cuda_tf32_backward_kernel_matches_plain(B, L, H, P, N, Q):
    """``ssd_chunk_bwd_tf32`` on fp32 inputs against its plain version
    (max|Δ| <= 1e-4·max(max|ref|, 1)), a second pass equal bit for bit,
    each launch counted under its name; ``cuda_cores=True`` still takes
    ``ssd_chunk_bwd``."""
    needs_card()
    shape = (B, L, H, P, N, Q)
    x, dt, A, Bm, Cm, dy, h0, df, cum = card_inputs(shape, 35, "float32")
    _, states = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    h_prev, g, _ = ssd_carry_bwd_ref(states, cum, Cm, dy, Q, h0, df)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    args = (x, dt, cum, Bm, Cm, dy, g, h_prev, Q)
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    got = kernel.ssd_chunk_bwd_cuda(*args)
    again = kernel.ssd_chunk_bwd_cuda(*args)
    core = kernel.ssd_chunk_bwd_cuda(*args, cuda_cores=True)
    # Each kernel's partial dB, dC sums over its own groups of heads.
    want = ssd_chunk_bwd_ref(*args, kernel.tf32_heads(B * L // Q, H, sms))
    want_core = ssd_chunk_bwd_ref(
        *args, kernel.bwd_heads_per_block(B * L // Q, H, sms))
    torch.cuda.synchronize()
    for a, b, c, w, wc in zip(got, again, core, want, want_core):
        assert torch.equal(a, b) and within(a, w) and within(c, wc)
    for name in kernel.BWD_KERNELS:
        assert kernel.BWD_KERNEL_LAUNCHES[name] == before[name] + {
            "ssd_chunk_bwd_tf32": 2, "ssd_chunk_bwd": 1}.get(name, 0)


@pytest.mark.cuda
def test_cuda_tf32_backward_shared_memory_equals_mirror():
    """The library's ``ssd_chunk_bwd_tf32_smem_bytes`` equals kernel.py's
    mirror at every group size, within a block's shared memory."""
    needs_card()
    size = kernel.LIB_BWD.load().ssd_chunk_bwd_tf32_smem_bytes
    for N in (64, 128):
        for G in range(1, 17):
            assert size(N, G) == kernel.chunk_bwd_tf32_smem_bytes(N, G) \
                <= kernel.MAX_SMEM_BYTES
    assert size(32, 4) == -1


# ---------------------------------------------------------------------------
# The fp32 tensor-core chunk backward over 64 x 64 tiles (Q = 128 to 256)
# ---------------------------------------------------------------------------

# fp32 at ssd_chunk_bwd_tf32_tiled's chunks of 128, 192 and 256 rows at
# both state sizes, heads in groups of two.
TF32_TILED_BWD_SHAPES = [(1, 256, 2, 64, 128, 128), (1, 384, 2, 64, 64, 192),
                         (1, 512, 2, 64, 128, 256)]


def tf32_tiled_bwd_case(shape, terms=3):
    """As ``tf32_bwd_case`` at the tiled chunks: the inputs, the emulated
    ``ssd_chunk_bwd_tf32_tiled`` at ``terms`` (with the emulated
    ``ssd_chunk_tf32_tiled``'s chunk states through the plain carry
    backward) and the plain chunk backward on the same g and h_prev."""
    B, L, H, P, N, Q = shape
    arrs, dy, h0, df = make(B * L + N + 7, B, L, H, P, N, "nonzero")
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.float32)
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    _, states = emulate_tf32_chunks_tiled(x, dt, cum, Bm, Cm, Q, terms)
    h_prev, g, dinit = ssd_carry_bwd_ref(states, cum, Cm, tdy, Q, th0, tdf)
    args = (x, dt, cum, Bm, Cm, tdy, g, h_prev, Q, 2)
    got = emulate_tf32_chunk_bwd_tiled(*args, terms=terms)
    return (arrs, dy, h0, df, ts, cum, dinit), got, ssd_chunk_bwd_ref(*args)


@pytest.mark.parametrize("shape", TF32_TILED_BWD_SHAPES)
def test_tf32_tiled_chunk_bwd_emulation_meets_the_bar(shape):
    """``ssd_chunk_bwd_tf32_tiled``'s arithmetic keeps every output within
    a tenth of 1e-4·max(max|ref|, 1) of ``ssd_chunk_bwd_ref``; finished as
    the op finishes, with the fp32 tiled forward kernel's emulated chunk
    states, every gradient is within 1e-4·max(max|ref|, 1) of the
    reference's ``jax.vjp`` of ``ssd_ref``."""
    Q, N = shape[-1], shape[4]
    assert kernel.bwd_kernels(torch.float32, Q, 64, N) == BWD_TF32_TILED
    (arrs, dy, h0, df, ts, cum, dinit), got, want = tf32_tiled_bwd_case(
        shape)
    for name, a, w in zip(("dx", "dcum", "ddt", "dB", "dC"), got, want):
        assert a.shape == w.shape, name
        bar = 1e-4 * max(float(w.abs().max()), 1.0)
        assert float((a - w).abs().max()) <= 0.1 * bar, name
    dx, dcum, ddt, dB, dC = got
    ddt_cum, dA = chunk_cumsum_bwd(dcum, ts[1], ts[2], Q)
    grads = (dx, ddt + ddt_cum, dA, dB.sum(0), dC.sum(0), dinit)
    for name, g, w in zip(NAMES, grads, jax_grads(arrs, dy, h0, df, Q,
                                                  torch.float32)):
        assert_grad_close(name, g, w)


@pytest.mark.parametrize("terms", [1, 3])
def test_tf32_tiled_chunk_bwd_term_counts(terms):
    """At the tiled chunks one TF32 product a product misses the fp32 bar
    of ``ssd_chunk_bwd_ref``; three (the kernel's) keep every output
    within a tenth of it.  The worst ratios are printed (``-s``)."""
    worst = {}
    for shape in TF32_TILED_BWD_SHAPES:
        _, got, want = tf32_tiled_bwd_case(shape, terms)
        for name, a, w in zip(("dx", "dcum", "ddt", "dB", "dC"), got, want):
            bar = 1e-4 * max(float(w.abs().max()), 1.0)
            worst[name] = max(worst.get(name, 0.0),
                              float((a - w).abs().max()) / bar)
    print(f"\nTF32 products={terms}: tiled worst max|Δ|/bar " + ", ".join(
        f"{k} {v:.4f}" for k, v in worst.items()))
    if terms == 1:
        assert max(worst.values()) > 1.0, worst
    else:
        assert max(worst.values()) <= 0.1, worst


def test_tf32_tiled_backward_tiles_fit_shared_memory():
    """``ssd_chunk_bwd_tf32_tiled``'s shared memory (``kernel.
    chunk_bwd_tf32_tiled_smem_bytes``) fits a block at every chunk and
    state size it takes: 229,408 bytes at N = 128, Q = 256, where
    ``ssd_chunk_bwd_tc_tiled``'s layout in fp32 (its bf16 tiles at four
    bytes) would need 327,712.  Its heads a block follow the bf16 tiled
    kernel's rule."""
    for N in (64, 128):
        for Q in kernel.TILED_Q:
            assert kernel.chunk_bwd_tf32_tiled_smem_bytes(N, Q) \
                <= kernel.MAX_SMEM_BYTES
    assert kernel.chunk_bwd_tf32_tiled_smem_bytes(128, 256) == 229_408
    bc, xd = 64 * 136 * 4, 64 * 64 * 4
    as_bf16_layout = (2 * bc + 4 * xd + max(2 * 128 * 64 * 4, 4 * 16384)
                      + 2 * (xd + bc) + 64 * 68 * 4 + 16 * 256
                      + (12 * 64 + 8) * 4)
    assert as_bf16_layout == 327_712 > kernel.MAX_SMEM_BYTES
    for args in ((2 * 4096 // 256, 48, 132, 256), (2, 4, 132, 256)):
        assert kernel.chunk_bwd_heads("ssd_chunk_bwd_tf32_tiled", *args) == \
            kernel.chunk_bwd_heads("ssd_chunk_bwd_tc_tiled", *args)


def test_core_backward_flops_at_a_chunk_the_tiled_kernels_refuse():
    """At a chunk of 256 rows that no tiled kernel takes (N = 32), the
    op's flop count in either dtype follows ``ssd_chunk_bwd``: C·Bᵀ and
    the group's dW∘E∘dt against C and B once per block of G heads
    (6Q²N)."""
    B, L, H, P, N, Q = 2, 4096, 48, 64, 32, 256
    nc = L // Q
    per_head = (2 * Q * Q * N + 6 * Q * Q * P + 10 * Q * N * P)
    G = kernel.bwd_heads_per_block(B * nc, H, 132)
    for dtype in (torch.bfloat16, torch.float32):
        assert kernel.bwd_kernels(dtype, Q, P, N) == BWD_CORE
        assert ops.ssd_bwd_flops(B, L, H, P, N, Q, dtype=dtype) == \
            B * nc * (H * per_head + H // G * 6 * Q * Q * N)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 4, 64, 128, 128),
                                         (1, 384, 6, 64, 64, 192),
                                         (2, 512, 8, 64, 128, 256),
                                         (1, 512, 4, 64, 64, 256)])
def test_cuda_tf32_tiled_backward_kernel_matches_plain(B, L, H, P, N, Q):
    """``ssd_chunk_bwd_tf32_tiled`` on fp32 inputs against its plain
    version with its heads a group (max|Δ| <= 1e-4·max(max|ref|, 1)), a
    second pass equal bit for bit, each launch counted under its name;
    ``cuda_cores=True`` still takes ``ssd_chunk_bwd``, held too."""
    needs_card()
    shape = (B, L, H, P, N, Q)
    x, dt, A, Bm, Cm, dy, h0, df, cum = card_inputs(shape, 36, "float32")
    _, states = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    h_prev, g, _ = ssd_carry_bwd_ref(states, cum, Cm, dy, Q, h0, df)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    args = (x, dt, cum, Bm, Cm, dy, g, h_prev, Q)
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    got = kernel.ssd_chunk_bwd_cuda(*args)
    again = kernel.ssd_chunk_bwd_cuda(*args)
    core = kernel.ssd_chunk_bwd_cuda(*args, cuda_cores=True)
    torch.cuda.synchronize()
    want = ssd_chunk_bwd_ref(*args, kernel.chunk_bwd_heads(
        "ssd_chunk_bwd_tf32_tiled", B * L // Q, H, sms, Q))
    want_core = ssd_chunk_bwd_ref(*args, kernel.bwd_heads_per_block(
        B * L // Q, H, sms))
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b) and within(a, w)
    for c, w in zip(core, want_core):
        assert within(c, w)
    for name in kernel.BWD_KERNELS:
        assert kernel.BWD_KERNEL_LAUNCHES[name] == before[name] + {
            "ssd_chunk_bwd_tf32_tiled": 2, "ssd_chunk_bwd": 1}.get(name, 0)


@pytest.mark.cuda
def test_cuda_tf32_tiled_backward_shared_memory_equals_mirror():
    """The library's ``ssd_chunk_bwd_tf32_tiled_smem_bytes`` equals
    kernel.py's mirror at every chunk and state size the kernel takes, and
    refuses anything else."""
    needs_card()
    lib = kernel.LIB_BWD.load()
    for N in (64, 128):
        for Q in kernel.TILED_Q:
            assert lib.ssd_chunk_bwd_tf32_tiled_smem_bytes(N, Q) == \
                kernel.chunk_bwd_tf32_tiled_smem_bytes(N, Q)
    for N, Q in ((32, 128), (128, 64), (128, 320), (64, 100)):
        assert lib.ssd_chunk_bwd_tf32_tiled_smem_bytes(N, Q) == -1


# ---------------------------------------------------------------------------
# The fp32 tensor-core carry backward (TF32, three products a product)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0,))
def _jax_ops_vjp(chunk, args, dy, dfinal):
    """jax.vjp of the reference's ``ssd`` (its default path) with an
    initial state."""
    def f(*a):
        return j_ssd(*a[:5], chunk=chunk, init_state=a[5])
    _, vjp = jax.vjp(f, *args)
    return vjp((dy, dfinal))


def tf32_carry_bwd_ratios(shape, terms):
    """Worst max|Δ| / (1e-4·max(max|ref|, 1)) per output of the emulated
    ``ssd_carry_bwd_tf32`` against ``ssd_carry_bwd_ref`` on the same
    inputs (a nonzero initial state and dfinal)."""
    B, L, H, P, N, Q = shape
    arrs, dy, h0, df = make(B * L + N + 4, B, L, H, P, N, "nonzero")
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.float32)
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    _, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, Q)
    args = (states, cum, Cm, tdy, Q, th0, tdf)
    return {name: float((a - w).abs().max())
            / (1e-4 * max(float(w.abs().max()), 1.0))
            for name, a, w in zip(("h_prev", "g", "d init_state"),
                                  emulate_tf32_carry_bwd(*args, terms=terms),
                                  ssd_carry_bwd_ref(*args))}


@pytest.mark.parametrize("shape", TF32_BWD_SHAPES)
def test_tf32_carry_bwd_emulation_meets_the_bar(shape):
    """``ssd_carry_bwd_tf32``'s arithmetic keeps h_prev, g and d
    init_state within a tenth of 1e-4·max(max|ref|, 1) of
    ``ssd_carry_bwd_ref``; the whole fp32 backward with every fp32
    tensor-core kernel emulated (the chunk states of ``ssd_chunk_tf32``,
    ``ssd_carry_bwd_tf32``, then ``ssd_chunk_bwd_tf32``, finished as the
    op finishes) is within 1e-4·max(max|ref|, 1) of ``jax.vjp`` of the
    reference's ``ssd`` on the same seeded inputs (dx, dt, dA, dB, dC, d
    init_state)."""
    assert max(tf32_carry_bwd_ratios(shape, 3).values()) <= 0.1
    B, L, H, P, N, Q = shape
    arrs, dy, h0, df = make(B * L + N + 5, B, L, H, P, N, "nonzero")
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, torch.float32)
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    _, states = emulate_tf32_chunks(x, dt, cum, Bm, Cm, Q)
    h_prev, g, dinit = emulate_tf32_carry_bwd(states, cum, Cm, tdy, Q, th0,
                                              tdf)
    dx, dcum, ddt, dB, dC = emulate_tf32_chunk_bwd(
        x, dt, cum, Bm, Cm, tdy, g, h_prev, Q, 2)
    ddt_cum, dA = chunk_cumsum_bwd(dcum, dt, A, Q)
    grads = (dx, ddt + ddt_cum, dA, dB.sum(0), dC.sum(0), dinit)
    want = _jax_ops_vjp(Q, tuple(jnp.asarray(a) for a in arrs + [h0]),
                        jnp.asarray(dy), jnp.asarray(df))
    for name, got, w in zip(NAMES, grads, want):
        assert_grad_close(name, got, w)


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_tf32_carry_bwd_term_counts(terms):
    """One TF32 product a product (plain TF32) misses the fp32 bar of
    ``ssd_carry_bwd_ref`` in g and d init_state; three (the kernel's)
    keep every output within a tenth of it.  The worst ratios are printed
    (``-s``)."""
    worst = {}
    for shape in TF32_BWD_SHAPES:
        for name, r in tf32_carry_bwd_ratios(shape, terms).items():
            worst[name] = max(worst.get(name, 0.0), r)
    print(f"\nTF32 products={terms}: carry backward worst max|Δ|/bar "
          + ", ".join(f"{k} {v:.4f}" for k, v in worst.items()))
    assert worst["h_prev"] == 0.0   # the forward walk has no product
    if terms == 1:
        assert min(worst["g"], worst["d init_state"]) > 1.0, worst
    if terms == 3:
        assert max(worst.values()) <= 0.1, worst


def test_tf32_carry_bwd_fits_two_blocks_an_sm():
    """``ssd_carry_bwd_tf32``'s shared memory (``kernel.
    carry_bwd_tc_smem_bytes`` with fp32 C: the bf16 kernel's rings with C
    and dy in fp32): 111,488 bytes at (b)'s 32 chunks of 64 rows, 111,616
    at 64, two blocks an SM up to 512 chunks (a 32k sequence); the bf16
    kernel's sizes are those it had."""
    f32, bf = torch.float32, torch.bfloat16
    assert kernel.carry_bwd_tc_smem_bytes(64, f32) == 111_616
    assert kernel.carry_bwd_tc_smem_bytes(32, f32) == 111_488
    assert kernel.carry_bwd_tc_smem_bytes(64, bf) == 68_608
    for nc in (32, 64, 512):
        assert 2 * (kernel.carry_bwd_tc_smem_bytes(nc, f32) + 1024) \
            <= 228 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 256, 48, 64, 128, 64),
                                         (1, 256, 64, 64, 64, 64),
                                         (1, 2048, 48, 64, 128, 64),
                                         (2, 512, 8, 64, 128, 64)])
def test_cuda_tf32_carry_bwd_kernel_matches_plain(B, L, H, P, N, Q):
    """``ssd_carry_bwd_tf32`` on fp32 inputs against its plain version
    (max|Δ| <= 1e-4·max(max|ref|, 1)), with and without an initial state
    and dfinal, a second pass equal bit for bit, each launch counted under
    its name; ``cuda_cores=True`` still takes ``ssd_carry_bwd``, held
    too."""
    needs_card()
    shape = (B, L, H, P, N, Q)
    x, dt, A, Bm, Cm, dy, h0, df, cum = card_inputs(shape, 36, "float32")
    _, states = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    for extra in ((h0, df), (None, None)):
        args = (states, cum, Cm, dy, Q) + extra
        got = kernel.ssd_carry_bwd_cuda(*args)
        again = kernel.ssd_carry_bwd_cuda(*args)
        core = kernel.ssd_carry_bwd_cuda(*args, cuda_cores=True)
        want = ssd_carry_bwd_ref(*args)
        torch.cuda.synchronize()
        for a, b, c, w in zip(got, again, core, want):
            assert torch.equal(a, b) and within(a, w) and within(c, w)
    for name in kernel.BWD_KERNELS:
        assert kernel.BWD_KERNEL_LAUNCHES[name] == before[name] + {
            "ssd_carry_bwd_tf32": 4, "ssd_carry_bwd": 2}.get(name, 0)


@pytest.mark.cuda
def test_cuda_tf32_carry_bwd_shared_memory_equals_mirror():
    """The library's ``ssd_carry_bwd_tf32_smem_bytes`` and
    ``ssd_bwd_tc_smem_bytes(1, ...)`` equal ``kernel.
    carry_bwd_tc_smem_bytes`` for fp32 and bf16 at 1 to 512 chunks."""
    needs_card()
    lib = kernel.LIB_BWD.load()
    for nc in range(1, 513):
        assert lib.ssd_carry_bwd_tf32_smem_bytes(nc) == \
            kernel.carry_bwd_tc_smem_bytes(nc, torch.float32)
        assert lib.ssd_bwd_tc_smem_bytes(1, 128, nc) == \
            kernel.carry_bwd_tc_smem_bytes(nc, torch.bfloat16)
    assert lib.ssd_carry_bwd_tf32_smem_bytes(0) == -1


# ---------------------------------------------------------------------------
# The tensor-core carry backward at chunks of 128 to 256 rows (64-row slabs)
# ---------------------------------------------------------------------------

# Every tiled chunk at both state sizes, L = 768 (which 128, 192 and 256
# divide), two heads.
TILED_CARRY_SHAPES = [(1, 768, 2, 64, N, Q) for Q in kernel.TILED_Q
                      for N in (64, 128)]


def tiled_carry_case(shape, dtype):
    """Inputs with a nonzero initial state and dfinal (in bf16: x, B, C and
    dy rounded to bf16 values, so that the reference's fp32 run reads what
    the kernels read), the chunk states of the dtype's emulated tiled
    forward kernel (bf16: the plain chunk pass, which ``ssd_chunk_tc_
    tiled``'s emulation meets), and the emulated carry backward of the
    dtype (``ssd_carry_bwd_tc`` with ``BWD_TERMS``, ``ssd_carry_bwd_tf32``
    with three TF32 products) beside ``ssd_carry_bwd_ref`` on the same
    states."""
    B, L, H, P, N, Q = shape
    bf16 = dtype == torch.bfloat16
    arrs, dy, h0, df = make(B * L + N + Q, B, L, H, P, N, "nonzero")
    if bf16:
        for i in (0, 3, 4):
            arrs[i] = torch.from_numpy(arrs[i]).bfloat16().float().numpy()
        dy = torch.from_numpy(dy).bfloat16().float().numpy()
    ts, tdy, th0, tdf = torch_inputs(arrs, dy, h0, df, dtype)
    x, dt, A, Bm, Cm = ts
    cum = chunk_cumsum(dt, A, Q)
    chunks = ssd_chunks_ref if bf16 else emulate_tf32_chunks_tiled
    _, states = chunks(x, dt, cum, Bm, Cm, Q)
    cargs = (states, cum, Cm, tdy, Q, th0, tdf)
    got = (emulate_tensor_core_carry_bwd(*cargs, kernel.BWD_TERMS) if bf16
           else emulate_tf32_carry_bwd(*cargs))
    return (arrs, dy, h0, df), ts, tdy, cum, got, ssd_carry_bwd_ref(*cargs)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", TILED_CARRY_SHAPES)
def test_tiled_carry_bwd_emulation_meets_the_bar(shape, dtype):
    """The dtype's tensor-core carry backward at Q = 128, 192 and 256,
    each chunk's (exp(cum) ∘ C)ᵀ·dy a fixed-order sum of its 64-row slabs'
    products: h_prev, g and d init_state within half (bf16, ``BWD_TERMS``
    bf16 terms) or a tenth (fp32, three TF32 products) of
    1e-4·max(max|ref|, 1) of ``ssd_carry_bwd_ref``, the forward walk
    exact; then the whole gradient from the emulated kernels of the slice
    (that carry backward, the dtype's tiled chunk backward, finished as
    the op finishes) within 1e-4·max(max|ref|, 1) of ``jax.vjp`` of the
    reference's ``ssd_ref`` on the same values."""
    B, L, H, P, N, Q = shape
    tdt = getattr(torch, dtype)
    assert kernel.bwd_kernels(tdt, Q, P, N) == (
        BWD_TILED if tdt == torch.bfloat16 else BWD_TF32_TILED)
    (arrs, dy, h0, df), ts, tdy, cum, got, want = tiled_carry_case(shape,
                                                                   tdt)
    margin = 0.5 if tdt == torch.bfloat16 else 0.1
    for name, a, w in zip(("h_prev", "g", "d init_state"), got, want):
        bar = 1e-4 * max(float(w.abs().max()), 1.0)
        assert float((a - w).abs().max()) <= margin * bar, name
    assert torch.equal(got[0], want[0])
    h_prev, g, dinit = got
    x, dt, A, Bm, Cm = ts
    args = (x, dt, cum, Bm, Cm, tdy, g, h_prev, Q, 2)
    dx, dcum, ddt, dB, dC = (
        emulate_tensor_core_chunk_bwd(*args, kernel.BWD_TERMS)
        if tdt == torch.bfloat16 else emulate_tf32_chunk_bwd_tiled(*args))
    ddt_cum, dA = chunk_cumsum_bwd(dcum, dt, A, Q)
    whole = (dx, ddt + ddt_cum, dA, dB.sum(0), dC.sum(0), dinit)
    for name, a, w in zip(NAMES, whole, jax_grads(arrs, dy, h0, df, Q,
                                                  torch.float32)):
        assert_grad_close(name, a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,L,H,P,N,Q", [(1, 768, 4, 64, 128, 128),
                                         (1, 768, 6, 64, 64, 192),
                                         (2, 1024, 8, 64, 128, 256),
                                         (1, 512, 4, 64, 64, 256)])
def test_cuda_tiled_carry_bwd_kernels_match_plain(B, L, H, P, N, Q, dtype):
    """``ssd_carry_bwd_tc`` (bf16) and ``ssd_carry_bwd_tf32`` (fp32) at the
    tiled chunks against their plain version (max|Δ| <=
    1e-4·max(max|ref|, 1)), with and without an initial state and
    dfinal, a second pass equal bit for bit, each launch counted under its
    name; ``cuda_cores=True`` still takes ``ssd_carry_bwd``, held too."""
    needs_card()
    shape = (B, L, H, P, N, Q)
    x, dt, A, Bm, Cm, dy, h0, df, cum = card_inputs(shape, 37, dtype)
    _, states = kernel.ssd_chunks_cuda(x, dt, cum, Bm, Cm, Q)
    name = kernel.bwd_kernels(getattr(torch, dtype), Q, P, N)[0]
    assert name == ("ssd_carry_bwd_tc" if dtype == "bfloat16"
                    else "ssd_carry_bwd_tf32")
    before = dict(kernel.BWD_KERNEL_LAUNCHES)
    for extra in ((h0, df), (None, None)):
        args = (states, cum, Cm, dy, Q) + extra
        got = kernel.ssd_carry_bwd_cuda(*args)
        again = kernel.ssd_carry_bwd_cuda(*args)
        core = kernel.ssd_carry_bwd_cuda(*args, cuda_cores=True)
        want = ssd_carry_bwd_ref(*args)
        torch.cuda.synchronize()
        for a, b, c, w in zip(got, again, core, want):
            assert torch.equal(a, b) and within(a, w) and within(c, w)
    for k in kernel.BWD_KERNELS:
        assert kernel.BWD_KERNEL_LAUNCHES[k] == before[k] + {
            name: 4, "ssd_carry_bwd": 2}.get(k, 0)
