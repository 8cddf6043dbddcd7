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
