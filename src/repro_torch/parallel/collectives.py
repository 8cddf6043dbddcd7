"""Distributed-optimization collectives (the reference's
``repro/parallel/collectives.py``).

- ``quantized_psum``: int8 all-reduce with per-tensor scale and error
  feedback — a quarter of the bytes of an fp32 gradient reduction, at
  the cost of a quantization residual carried by the caller.
- ``seq_sharded_decode_attention``: decode attention with the KV cache
  sharded by *sequence*; each shard computes partial (max, sumexp,
  weighted-V) statistics and the exact softmax is reconstructed with a
  log-sum-exp combine (a max and two sums instead of gathering the
  cache).

The reference's ``psum`` / ``pmax`` over a named mesh axis are
``all_reduce`` with ``SUM`` / ``MAX`` over that mesh dimension's process
group (``mesh.get_group(name)``); each function takes the group, and is
called by every rank of it with its own shard.  Neither has a caller in
the reference's steps, and neither is wired into a step here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

F32 = torch.float32


# ---------------------------------------------------------------------------
# Quantized gradient all-reduce (error feedback)
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def quantized_psum(x: torch.Tensor, group,
                   residual: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce mean of ``x`` over ``group`` in int8.

    Returns (mean, new_residual).  The residual (local quantization
    error) is added back into the next step's input — error feedback, so
    the bias does not accumulate."""
    xf = x.to(F32)
    if residual is not None:
        xf = xf + residual
    q, scale = quantize_int8(xf)
    new_residual = xf - dequantize_int8(q, scale)
    # int8 payload summed in int32 to avoid overflow.
    total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    n = _all_reduce(torch.ones((), dtype=F32, device=x.device),
                    dist.ReduceOp.SUM, group)
    # Single-scale approximation: the max scale across shards.
    smax = _all_reduce(scale, dist.ReduceOp.MAX, group)
    mean = total.to(F32) * smax / n
    return mean.to(x.dtype), new_residual


# ---------------------------------------------------------------------------
# Sequence-sharded decode attention (LSE combine)
# ---------------------------------------------------------------------------


def _partial_attn(q, k, v, valid):
    """q: [B,H,D]; k,v: [B,S,H,D]; valid: [B,S] → partial stats."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhd,bshd->bhs", q.to(F32), k.to(F32)) * scale
    s = torch.where(valid[:, None, :], s, -1e30)
    m = torch.amax(s, dim=-1)                                 # [B,H]
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)                                  # [B,H]
    o = torch.einsum("bhs,bshd->bhd", p, v.to(F32))           # unnormalized
    return m, l, o


def seq_sharded_decode_attention(q, k_shard, v_shard, valid_shard, group):
    """Exact distributed decode attention over a sequence-sharded cache.

    q: [B,H,D] (the same on every rank); k/v_shard: [B,S_loc,H,D];
    valid: [B,S_loc]; each rank of ``group`` holds one slice of the
    sequence."""
    m, l, o = _partial_attn(q, k_shard, v_shard, valid_shard)
    g = _all_reduce(m, dist.ReduceOp.MAX, group)              # global max
    corr = torch.exp(m - g)
    l_g = _all_reduce(l * corr, dist.ReduceOp.SUM, group)
    o_g = _all_reduce(o * corr[..., None], dist.ReduceOp.SUM, group)
    return (o_g / torch.clamp(l_g, min=1e-30)[..., None]).to(q.dtype)
