"""Mixture-of-Experts layer: top-k routing with capacity dispatch on one
device (the reference's ``_moe_dense``).

The reference's expert-parallel ``_moe_shard_map`` (tokens bucketed per
destination shard, exchanged with all-to-alls) comes with the
parallelism slice (ROADMAP Queue 1 item 11); with no mesh in scope the
reference takes ``_moe_dense`` as well, so both compute the same thing.

Position-within-expert uses a stable argsort and ``searchsorted``, as the
reference does.  The dispatch scatter (``.at[idx].add``) is
``index_add_``: a dropped slot adds zeros to a kept slot of its expert,
which is exact in any order, so the sum is deterministic on the card
too.  Top-k is a stable descending sort, so that equal gates (frequent
in bf16) pick the lower expert index first, as ``jax.lax.top_k`` does.

Routed-expert counts padded for expert parallelism
(``n_experts_padded``) hold dead experts that the router never selects.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamSpec, RunConfig, spec
from .layers import mlp, mlp_specs


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    e = cfg.n_experts_padded or cfg.n_experts
    s: Dict[str, ParamSpec] = {
        "router": spec((cfg.d_model, e), ("embed", "experts")),
        "w_gate": spec((e, cfg.d_model, cfg.d_ff), ("experts", "embed", "expert_ffn")),
        "w_up": spec((e, cfg.d_model, cfg.d_ff), ("experts", "embed", "expert_ffn")),
        "w_down": spec((e, cfg.d_ff, cfg.d_model), ("experts", "expert_ffn", "embed"),
                       init="scaled"),
    }
    if cfg.shared_ff:
        s["shared"] = mlp_specs(cfg, d_ff=cfg.shared_ff)
        s["shared_gate"] = spec((cfg.d_model, 1), ("embed", None))
    return s


def _gates(params, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Softmax over the router's fp32 logits, dead experts at 0."""
    e_pad = cfg.n_experts_padded or cfg.n_experts
    logits = (xt @ params["router"].to(xt.dtype)).float()
    if e_pad > cfg.n_experts:
        live = torch.arange(e_pad, device=xt.device) < cfg.n_experts
        logits = torch.where(live[None, :], logits, -1e30)
    return torch.softmax(logits, dim=-1)


def _router(params, xt: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt: [T, d] → (top_w [T,k] f32 normalized, top_e [T,k] i32)."""
    gates = _gates(params, xt, cfg)
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :cfg.top_k], top_e[:, :cfg.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e.to(torch.int32)


def _positions_within_expert(flat_e: torch.Tensor) -> torch.Tensor:
    """Rank of each slot within its expert bucket, FIFO by slot order."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order].contiguous()
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(n, dtype=torch.int64,
                              device=flat_e.device) - first
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def _expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf: [E, C, d] grouped tokens → [E, C, d] (SwiGLU per expert)."""
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    return torch.bmm(F.silu(g) * u, w_down)


def _moe_dense(params, x: torch.Tensor, cfg: ModelConfig, run: RunConfig,
               capacity_factor: float) -> torch.Tensor:
    cdt = run.compute_dtype
    B, S, d = x.shape
    T = B * S
    e_pad = cfg.n_experts_padded or cfg.n_experts
    k = cfg.top_k
    xt = x.reshape(T, d)
    top_w, top_e = _router(params, xt, cfg)

    capacity = max(int(math.ceil(T * k / e_pad * capacity_factor)), 8)
    flat_e = top_e.reshape(-1).long()
    pos = _positions_within_expert(flat_e)
    keep = pos < capacity

    idx = flat_e * capacity + torch.clamp(pos, max=capacity - 1)
    src = (xt.repeat_interleave(k, dim=0)
           * keep[:, None].to(xt.dtype)).to(cdt)
    buf = torch.zeros((e_pad * capacity, d), dtype=cdt, device=x.device)
    buf.index_add_(0, idx, src)

    yb = _expert_ffn(buf.reshape(e_pad, capacity, d),
                     params["w_gate"].to(cdt), params["w_up"].to(cdt),
                     params["w_down"].to(cdt)).reshape(e_pad * capacity, d)
    out_k = yb[idx].reshape(T, k, d)
    w = (top_w * keep.reshape(T, k)).to(cdt)
    # einsum("tkd,tk->td"): one [1, k] x [k, d] product per token.
    return torch.bmm(w[:, None, :], out_k).reshape(B, S, d)


def moe(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
        run: RunConfig, capacity_factor: Optional[float] = None
        ) -> torch.Tensor:
    """x: [B, S, d] → [B, S, d]: the routed experts plus the shared
    expert, if any, behind its sigmoid gate."""
    if capacity_factor is None:
        capacity_factor = run.moe_capacity
    cdt = run.compute_dtype
    B, S, d = x.shape
    y = _moe_dense(params, x, cfg, run, capacity_factor)
    if cfg.shared_ff:
        xt = x.reshape(B * S, d)
        sg = torch.sigmoid((xt @ params["shared_gate"].to(cdt))
                           .float()).to(cdt)
        y = y + (mlp(params["shared"], xt, run) * sg).reshape(B, S, d)
    return y


def moe_load_balance_loss(params, x: torch.Tensor, cfg: ModelConfig,
                          run: RunConfig) -> torch.Tensor:
    """Auxiliary load-balancing loss (Switch-style fraction·prob)."""
    e_pad = cfg.n_experts_padded or cfg.n_experts
    xt = x.reshape(x.shape[0] * x.shape[1], -1).to(run.compute_dtype)
    gates = _gates(params, xt, cfg)
    top1 = torch.argmax(gates, dim=-1)
    frac = F.one_hot(top1, e_pad).float().mean(0)
    prob = gates.mean(0)
    return cfg.n_experts * torch.sum(frac * prob)
