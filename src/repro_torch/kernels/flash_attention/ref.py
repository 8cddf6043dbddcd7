"""Plain-torch version of flash attention and its gradient (the kernels'
oracles).

Forward: the function the reference's Pallas kernel computes: q, k and v
taken to fp32, logits scaled and masked in fp32 (a masked logit is
``-1e30``), softmax and ``p @ v`` in fp32, the output cast to q's dtype.
(The reference's jnp ``attention_ref`` rounds the logits and ``p`` to
q's dtype instead; in fp32 the two agree.)  :func:`attention_lse_ref` is
the row statistic the kernel keeps for the backward: the log-sum-exp of
each row's scaled, masked logits, ``m + log l``, fp32 ``[B, H, Lq]``.

Backward: the gradient XLA takes of the reference's jnp attention in
fp32, written out the way the backward kernels split it, each step the
plain version of one kernel:

* :func:`bwd_preprocess_ref` — D = rowsum(dO ∘ O), fp32 ``[B, H, Lq]``;
* :func:`bwd_dkdv_ref` — P = exp(S − lse) recomputed from the saved
  log-sum-exp, dV = Pᵀ dO, dS = P ∘ (dO Vᵀ − D), dK = scale · dSᵀ Q;
* :func:`bwd_dq_ref` — dQ = scale · dS K.

:func:`attention_bwd_ref` runs the three.  Everything is fp32 whatever
the inputs' dtype; dq, dk and dv come out in q's dtype.

Query rows go in blocks so that no block's logits exceed ``max_logits``
elements (a 32k-token prompt would otherwise need ``[B, H, L, L]`` in
fp32); every row's softmax is independent, so the blocking changes no
result, and dK and dV sum the blocks' contributions.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30
MAX_LOGITS = 1 << 28


def _scale(D: int) -> torch.Tensor:
    return torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)


def _row_block(B: int, H: int, Lk: int, max_logits: int) -> int:
    return max(1, max_logits // max(B * H * Lk, 1))


def _logits(qs: torch.Tensor, k32: torch.Tensor, s: int, Lq: int,
            causal: bool, scale: torch.Tensor) -> torch.Tensor:
    """Scaled, masked fp32 logits ``[B, H, bq, Lk]`` of query rows
    s .. s + bq - 1."""
    Lk = k32.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k32) * scale
    if causal:
        qi = torch.arange(s, s + qs.shape[1],
                          device=qs.device)[:, None] + (Lk - Lq)
        ki = torch.arange(Lk, device=qs.device)[None, :]
        logits = torch.where(qi >= ki, logits, NEG_INF)
    return logits


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  max_logits: int = MAX_LOGITS) -> torch.Tensor:
    """q: [B, Lq, H, D]; k, v: [B, Lk, H, D] → [B, Lq, H, D]."""
    B, Lq, H, D = q.shape
    scale = _scale(D)
    rows = _row_block(B, H, k.shape[1], max_logits)
    k32, v32 = k.float(), v.float()
    outs = []
    for s in range(0, Lq, rows):
        p = torch.softmax(_logits(q[:, s:s + rows], k32, s, Lq, causal,
                                  scale), dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v32))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                      max_logits: int = MAX_LOGITS) -> torch.Tensor:
    """Log-sum-exp of each row's scaled, masked logits: fp32 [B, H, Lq]."""
    B, Lq, H, D = q.shape
    scale = _scale(D)
    rows = _row_block(B, H, k.shape[1], max_logits)
    k32 = k.float()
    return torch.cat([torch.logsumexp(_logits(q[:, s:s + rows], k32, s, Lq,
                                              causal, scale), dim=-1)
                      for s in range(0, Lq, rows)], dim=-1)


def bwd_preprocess_ref(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO ∘ O) in fp32: [B, Lq, H, D] × 2 → [B, H, Lq]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _p_ds(qs, dos, k32, v32, lse_s, delta_s, s, Lq, causal, scale):
    """P = exp(S − lse) and dS = P ∘ (dO Vᵀ − D) for one block of query
    rows, fp32 [B, H, bq, Lk]; a masked pair has P = dS = 0."""
    p = torch.exp(_logits(qs, k32, s, Lq, causal, scale)
                  - lse_s[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dos.float(), v32)
    return p, p * (dp - delta_s[..., None])


def bwd_dkdv_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = True, max_logits: int = MAX_LOGITS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK, dV [B, Lk, H, D] in q's dtype, from q, k, v, dO, the forward's
    log-sum-exp and D (both fp32 [B, H, Lq])."""
    B, Lq, H, D = q.shape
    scale = _scale(D)
    rows = _row_block(B, H, k.shape[1], max_logits)
    k32, v32 = k.float(), v.float()
    dk = torch.zeros_like(k32)
    dv = torch.zeros_like(v32)
    for s in range(0, Lq, rows):
        qs, dos = q[:, s:s + rows].float(), do[:, s:s + rows].float()
        p, ds = _p_ds(qs, dos, k32, v32, lse[..., s:s + rows],
                      delta[..., s:s + rows], s, Lq, causal, scale)
        dv += torch.einsum("bhqk,bqhd->bkhd", p, dos)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return (dk * scale).to(q.dtype), dv.to(q.dtype)


def bwd_dq_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
               causal: bool = True, max_logits: int = MAX_LOGITS
               ) -> torch.Tensor:
    """dQ [B, Lq, H, D] in q's dtype (see :func:`bwd_dkdv_ref`)."""
    B, Lq, H, D = q.shape
    scale = _scale(D)
    rows = _row_block(B, H, k.shape[1], max_logits)
    k32, v32 = k.float(), v.float()
    outs = []
    for s in range(0, Lq, rows):
        _, ds = _p_ds(q[:, s:s + rows], do[:, s:s + rows], k32, v32,
                      lse[..., s:s + rows], delta[..., s:s + rows], s, Lq,
                      causal, scale)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale)
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      causal: bool = True, max_logits: int = MAX_LOGITS
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_ref` at output ``o`` (in q's
    dtype) for the output gradient ``do``, given the forward's
    log-sum-exp ``lse`` (fp32 [B, H, Lq])."""
    delta = bwd_preprocess_ref(o, do)
    dk, dv = bwd_dkdv_ref(q, k, v, do, lse, delta, causal, max_logits)
    dq = bwd_dq_ref(q, k, v, do, lse, delta, causal, max_logits)
    return dq, dk, dv
