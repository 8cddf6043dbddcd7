"""Plain-torch version of the Mamba2 SSD (state-space duality) chunked scan.

Computes, per head h with scalar decay ``a_t = dt_t * A_h`` (A < 0):

    s_t = exp(a_t) * s_{t-1} + dt_t * B_t ⊗ x_t          (state  [N, P])
    y_t = C_t · s_t                                       (output [P])

via the SSD chunk decomposition, split the way the CUDA kernel splits it:

* :func:`chunk_cumsum` — within-chunk cumulative sum of ``dt * A``;
* :func:`ssd_chunks_ref` — the intra-chunk "masked attention" term and
  each chunk's own state (the kernel's plain version);
* :func:`ssd_combine` — the inter-chunk state carry and its ``C · h``
  contribution; with the cast to the output dtype
  (:func:`ssd_carry_ref`) it is the carry kernel's plain version.

The gradient is split the way the two backward kernels split it, as
explicit formulas (not autograd):

* :func:`ssd_carry_bwd_ref` — a forward walk that rebuilds the state
  entering each chunk (h_prev) and a reverse walk that carries the
  gradient of the state leaving each chunk (g);
* :func:`ssd_chunk_bwd_ref` — each chunk's gradients from its inputs,
  dy, g and h_prev (dB and dC as per-group partial sums over heads);
* :func:`ssd_bwd_ref` — both, with :func:`chunk_cumsum_bwd`.

:func:`ssd_decode_ref` is the single-token recurrence.  The reference
has no kernel for it (plain jnp), so this torch version *is* the port of
the decode step on every device, not a fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

F32 = torch.float32


def check_chunk(L: int, chunk: int) -> int:
    """Number of chunks; the sequence must be a whole number of them."""
    if chunk < 1 or L % chunk != 0:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"SSD chunk {chunk}")
    return L // chunk


def chunk_cumsum(dt: torch.Tensor, A: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """dt: [B, L, H]; A: [H] → cum [B, L, H] (fp32), restarting every
    ``chunk`` steps."""
    Bsz, L, H = dt.shape
    nc = check_chunk(L, chunk)
    a = dt.to(F32) * A.to(F32)[None, None, :]
    return torch.cumsum(a.reshape(Bsz, nc, chunk, H), dim=2).reshape(
        Bsz, L, H)


def ssd_chunks_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk pass.  x: [B,L,H,P]; dt, cum: [B,L,H]; Bm, Cm: [B,L,N]
    → (y_intra [B,L,H,P], states [B,nc,H,N,P]), both fp32; the states
    lack the inter-chunk carry."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = check_chunk(L, chunk)
    xc = x.to(F32).reshape(Bsz, nc, chunk, H, P)
    dtc = dt.to(F32).reshape(Bsz, nc, chunk, H)
    cumc = cum.to(F32).reshape(Bsz, nc, chunk, H)
    Bc = Bm.to(F32).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(F32).reshape(Bsz, nc, chunk, N)
    # y_i += sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i·B_j) x_j.  For j > i
    # the exponent is positive and may overflow: select 0 there.
    seg = cumc[:, :, :, None, :] - cumc[:, :, None, :, :]   # [B,nc,i,j,H]
    iota = torch.arange(chunk, device=x.device)
    causal = (iota[:, None] >= iota[None, :])[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(seg), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    # S_c = sum_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j
    dec_end = torch.exp(cumc[:, :, -1:, :] - cumc) * dtc    # [B,nc,Q,H]
    states = torch.einsum("bcjn,bcjhp->bchnp", Bc,
                          xc * dec_end[..., None])
    return y_intra.reshape(Bsz, L, H, P), states


def ssd_combine(y_intra: torch.Tensor, states: torch.Tensor,
                cum: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carry the chunk states across chunks and add their contribution:
    y_i += exp(cum_i) C_i · h_prev.  Returns (y [B,L,H,P] fp32, final
    state [B,H,N,P] fp32)."""
    Bsz, L, H, P = y_intra.shape
    N = states.shape[3]
    nc = check_chunk(L, chunk)
    cumc = cum.to(F32).reshape(Bsz, nc, chunk, H)
    chunk_decay = torch.exp(cumc[:, :, -1, :])              # [B,nc,H]
    h = (torch.zeros((Bsz, H, N, P), dtype=F32, device=y_intra.device)
         if init_state is None else init_state.to(F32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                    # [B,nc,H,N,P]
    Cc = Cm.to(F32).reshape(Bsz, nc, chunk, N)
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cc, h_prev) \
        * torch.exp(cumc)[..., None]
    y = y_intra.reshape(Bsz, nc, chunk, H, P) + y_inter
    return y.reshape(Bsz, L, H, P), h


def ssd_carry_ref(y_intra: torch.Tensor, states: torch.Tensor,
                  cum: torch.Tensor, Cm: torch.Tensor, chunk: int,
                  init_state: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = F32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The carry kernel's plain version: :func:`ssd_combine`, then y cast
    to ``out_dtype``."""
    y, final = ssd_combine(y_intra, states, cum, Cm, chunk, init_state)
    return y.to(out_dtype), final


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64,
            init_state: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,L,H,P]; dt: [B,L,H] (>0); A: [H] (<0); Bm, Cm: [B,L,N].

    Returns (y [B,L,H,P] in x's dtype, final_state [B,H,N,P] fp32)."""
    cum = chunk_cumsum(dt, A, chunk)
    y_intra, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, chunk)
    y, final = ssd_combine(y_intra, states, cum, Cm, chunk, init_state)
    return y.to(x.dtype), final


def ssd_carry_bwd_ref(states: torch.Tensor, cum: torch.Tensor,
                      Cm: torch.Tensor, dy: torch.Tensor, chunk: int,
                      init_state: Optional[torch.Tensor] = None,
                      dfinal: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The carry backward kernel's plain version.  states [B,nc,H,N,P]
    (the chunk pass's), cum [B,L,H], Cm [B,L,N], dy [B,L,H,P] (the
    gradient of y) → (h_prev, g, d init_state), fp32: h_prev [B,nc,H,N,P]
    is the state entering each chunk, g [B,nc,H,N,P] the gradient of the
    state leaving it (of S_c), d init_state [B,H,N,P].

    Forward walk: h_prev_c = h, h = exp(cum_last,c) h + S_c.  Reverse
    walk from g = dfinal (zeros when None): g_c = g, then
    g = exp(cum_last,c) g + Σ_i exp(cum_i) C_i ⊗ dy_i over chunk c; what
    is left is d init_state."""
    Bsz, nc, H, N, P = states.shape
    check_chunk(cum.shape[1], chunk)
    cumc = cum.to(F32).reshape(Bsz, nc, chunk, H)
    decay = torch.exp(cumc[:, :, -1, :])[..., None, None]   # [B,nc,H,1,1]
    h = (torch.zeros((Bsz, H, N, P), dtype=F32, device=states.device)
         if init_state is None else init_state.to(F32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = decay[:, c] * h + states[:, c]
    dyc = dy.to(F32).reshape(Bsz, nc, chunk, H, P) * torch.exp(cumc)[..., None]
    cdy = torch.einsum("bcin,bcihp->bchnp",
                       Cm.to(F32).reshape(Bsz, nc, chunk, N), dyc)
    g = (torch.zeros((Bsz, H, N, P), dtype=F32, device=states.device)
         if dfinal is None else dfinal.to(F32))
    gs = [g] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = decay[:, c] * g + cdy[:, c]
    return torch.stack(h_prevs, dim=1), torch.stack(gs, dim=1), g


def _group_heads(t: torch.Tensor, heads_per_group: int) -> torch.Tensor:
    """[B,nc,Q,H,N] → [groups,B,L,N]: the sum over each group's heads."""
    Bsz, nc, Q, H, N = t.shape
    t = t.reshape(Bsz, nc, Q, H // heads_per_group, heads_per_group, N)
    return t.sum(4).permute(3, 0, 1, 2, 4).reshape(-1, Bsz, nc * Q, N)


def ssd_chunk_bwd_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                      g: torch.Tensor, h_prev: torch.Tensor, chunk: int,
                      heads_per_group: int = 1):
    """The chunk backward kernel's plain version: each chunk's gradients.
    x, dy [B,L,H,P]; dt, cum [B,L,H]; Bm, Cm [B,L,N]; g, h_prev
    [B,nc,H,N,P] (:func:`ssd_carry_bwd_ref`'s).  Returns fp32 (dx
    [B,L,H,P], dcum [B,L,H], ddt [B,L,H] (the direct part, without the
    cumsum's), dB, dC [groups,B,L,N]: sums over each group of
    ``heads_per_group`` heads, to be summed over groups).

    With E_ij = exp(cum_i − cum_j)·[i ≥ j], K = (C·Bᵀ) ∘ E, W_ij =
    K_ij dt_j and dW_ij = dy_i · x_j:
    intra — dx += Wᵀ dy, dC·Bᵀ's gradient dW ∘ E ∘ dt_j gives dC and dB,
    T = dW ∘ W gives dcum_i += Σ_j T_ij and dcum_j −= Σ_i T_ij,
    ddt_j += Σ_i dW_ij K_ij;
    state (S = Σ_j d_j B_j ⊗ x_j, d_j = exp(cum_last − cum_j) dt_j) —
    dx_j += d_j Bᵀ_j g, dB_j += d_j g x_j, U_j = d_j ⟨B_j ⊗ x_j, g⟩:
    dcum_last += Σ U, dcum_j −= U_j, ddt_j += exp(cum_last − cum_j)
    ⟨B_j ⊗ x_j, g⟩;
    inter (y_i += exp(cum_i) C_i · h_prev) — dC_i += exp(cum_i) h_prev
    dy_i, dcum_i += exp(cum_i) ⟨C_i · h_prev, dy_i⟩, and the chunk decay
    dcum_last += exp(cum_last) ⟨g, h_prev⟩."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = check_chunk(L, chunk)
    if heads_per_group < 1 or H % heads_per_group:
        raise ValueError(f"{heads_per_group} heads per group do not "
                         f"divide {H} heads")
    xc = x.to(F32).reshape(Bsz, nc, chunk, H, P)
    dyc = dy.to(F32).reshape(Bsz, nc, chunk, H, P)
    dtc = dt.to(F32).reshape(Bsz, nc, chunk, H)
    cumc = cum.to(F32).reshape(Bsz, nc, chunk, H)
    Bc = Bm.to(F32).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(F32).reshape(Bsz, nc, chunk, N)
    g, h_prev = g.to(F32), h_prev.to(F32)
    # Intra-chunk term, [B,nc,i,j,H]; E is selected to 0 above the
    # diagonal, where the exponent may overflow.
    seg = cumc[:, :, :, None, :] - cumc[:, :, None, :, :]
    iota = torch.arange(chunk, device=x.device)
    causal = (iota[:, None] >= iota[None, :])[None, None, :, :, None]
    E = torch.where(causal, torch.exp(seg), 0.0)
    K = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None] * E
    dt_j = dtc[:, :, None, :, :]
    dW = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    dx = torch.einsum("bcijh,bcihp->bcjhp", K * dt_j, dyc)
    V = dW * K
    T = V * dt_j
    dcum = T.sum(3) - T.sum(2)
    ddt = V.sum(2)
    dCB = (dW * E * dt_j).reshape(Bsz, nc, chunk, chunk, H // heads_per_group,
                                  heads_per_group).sum(5)
    dC = torch.einsum("bcijg,bcjn->gbcin", dCB, Bc)
    dB = torch.einsum("bcijg,bcin->gbcjn", dCB, Cc)
    # State term.
    dexp = torch.exp(cumc[:, :, -1:, :] - cumc)             # [B,nc,Q,H]
    d = dexp * dtc
    dx = dx + d[..., None] * torch.einsum("bcjn,bchnp->bcjhp", Bc, g)
    gx = torch.einsum("bcjhp,bchnp->bcjhn", xc, g)
    ured = torch.einsum("bcjn,bcjhn->bcjh", Bc, gx)
    dcum = dcum - d * ured
    ddt = ddt + dexp * ured
    dlast = (d * ured).sum(2)                              # [B,nc,H]
    # Inter-chunk term.
    ecum = torch.exp(cumc)
    dyh = torch.einsum("bcihp,bchnp->bcihn", dyc, h_prev)
    dcum = dcum + ecum * torch.einsum("bcin,bcihn->bcih", Cc, dyh)
    dlast = dlast + torch.exp(cumc[:, :, -1, :]) * (g * h_prev).sum((-2, -1))
    dcum[:, :, -1, :] += dlast
    shape = (-1, Bsz, L, N)
    dB = dB.reshape(shape) + _group_heads(d[..., None] * gx, heads_per_group)
    dC = dC.reshape(shape) + _group_heads(ecum[..., None] * dyh,
                                          heads_per_group)
    return (dx.reshape(Bsz, L, H, P), dcum.reshape(Bsz, L, H),
            ddt.reshape(Bsz, L, H), dB, dC)


def chunk_cumsum_bwd(dcum: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`chunk_cumsum` for dcum [B,L,H]: (its part
    of ddt [B,L,H], dA [H]), fp32.  da is dcum's reverse cumulative sum
    within each chunk; ddt = A da, dA = Σ dt da."""
    Bsz, L, H = dcum.shape
    nc = check_chunk(L, chunk)
    da = dcum.to(F32).reshape(Bsz, nc, chunk, H).flip(2).cumsum(2).flip(2)
    da = da.reshape(Bsz, L, H)
    return da * A.to(F32)[None, None, :], (da * dt.to(F32)).sum((0, 1))


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                chunk: int = 64, init_state: Optional[torch.Tensor] = None,
                dfinal: Optional[torch.Tensor] = None):
    """The gradient of :func:`ssd_ref` for dy (y's) and dfinal (the final
    state's; None is zeros): (dx, ddt, dA, dB, dC, d init_state), each in
    its input's dtype (d init_state fp32, None without an init_state)."""
    cum = chunk_cumsum(dt, A, chunk)
    _, states = ssd_chunks_ref(x, dt, cum, Bm, Cm, chunk)
    h_prev, g, dinit = ssd_carry_bwd_ref(states, cum, Cm, dy, chunk,
                                         init_state, dfinal)
    dx, dcum, ddt, dB, dC = ssd_chunk_bwd_ref(x, dt, cum, Bm, Cm, dy, g,
                                              h_prev, chunk)
    ddt_cum, dA = chunk_cumsum_bwd(dcum, dt, A, chunk)
    return (dx.to(x.dtype), (ddt + ddt_cum).to(dt.dtype), dA.to(A.dtype),
            dB.sum(0).to(Bm.dtype), dC.sum(0).to(Cm.dtype),
            None if init_state is None else dinit.to(init_state.dtype))


def ssd_decode_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  x: [B,H,P]; dt: [B,H]; Bm, Cm: [B,N];
    state: [B,H,N,P] → (y [B,H,P] in x's dtype, new state fp32)."""
    a = dt.to(F32) * A.to(F32)[None, :]
    dec = torch.exp(a)[:, :, None, None]
    upd = torch.einsum("bn,bhp->bhnp", Bm.to(F32),
                       dt.to(F32)[..., None] * x.to(F32))
    new = dec * state.to(F32) + upd
    y = torch.einsum("bn,bhnp->bhp", Cm.to(F32), new)
    return y.to(x.dtype), new
