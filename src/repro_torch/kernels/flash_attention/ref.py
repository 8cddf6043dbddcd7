"""Plain-torch version of flash attention (the kernel's oracle).

The function the reference's Pallas kernel computes: q, k and v taken to
fp32, logits scaled and masked in fp32 (a masked logit is ``-1e30``),
softmax and ``p @ v`` in fp32, the output cast to q's dtype.  (The
reference's jnp ``attention_ref`` rounds the logits and ``p`` to q's
dtype instead; in fp32 the two agree.)  Query rows go in blocks so that
no block's logits exceed ``max_logits`` elements (a 32k-token prompt
would otherwise need ``[B, H, L, L]`` in fp32); every row's softmax is
independent, so the blocking changes no result.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  max_logits: int = 1 << 28) -> torch.Tensor:
    """q: [B, Lq, H, D]; k, v: [B, Lk, H, D] → [B, Lq, H, D]."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    rows = max(1, max_logits // max(B * H * Lk, 1))
    ki = torch.arange(Lk, device=q.device)[None, :]
    k32, v32 = k.float(), v.float()
    outs = []
    for s in range(0, Lq, rows):
        qs = q[:, s:s + rows].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qs, k32) * scale
        if causal:
            qi = torch.arange(s, s + qs.shape[1],
                              device=q.device)[:, None] + (Lk - Lq)
            logits = torch.where(qi >= ki, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v32))
    return torch.cat(outs, dim=1).to(q.dtype)
