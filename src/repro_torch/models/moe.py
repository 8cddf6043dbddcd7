"""Mixture-of-Experts layer: top-k routing with capacity dispatch.

Two paths, chosen as the reference chooses them (:func:`moe`):

* ``_moe_dense`` — every expert on every token of the batch, one device
  (on a mesh: the whole problem on every rank);
* ``_moe_expert_parallel`` — the reference's ``_moe_shard_map``: on a
  mesh with a ``'model'`` axis, each rank routes its local tokens,
  buckets them per destination shard (capacity from the *local* token
  count) and exchanges them with one all-to-all over ``'model'``; each
  rank runs its own ``e_pad / tp`` experts and a second all-to-all
  brings the outputs back.

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

from ..parallel import ctx
from .common import ModelConfig, ParamSpec, RunConfig, spec
from .layers import mlp, mlp_specs, seq_split, seq_whole

# Calls of the expert-parallel path (reset to 0 and read back around a
# run to see which path a step took).
EXPERT_PARALLEL_CALLS = 0


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


def _moe_expert_parallel(params, x: torch.Tensor, cfg: ModelConfig,
                         run: RunConfig, capacity_factor: float, mesh,
                         batch_axis: str, seq_axis: Optional[str]
                         ) -> torch.Tensor:
    """The reference's ``_moe_shard_map``, run by ``ctx.local_call``
    (router replicated, experts split over ``'model'``, tokens as
    ``(batch_axis, seq_axis, None)``)."""
    global EXPERT_PARALLEL_CALLS
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd
    from ..parallel.sharding import mesh_axis_sizes
    cdt = run.compute_dtype
    e_pad = cfg.n_experts_padded or cfg.n_experts
    k = cfg.top_k
    tp = mesh_axis_sizes(mesh)["model"]
    e_local = e_pad // tp
    group = mesh.get_group("model")

    def a2a(t: torch.Tensor) -> torch.Tensor:
        """Tiled all-to-all: row block j goes to model shard j."""
        return all_to_all_single_autograd(t.contiguous(), None, None, group)

    def body(router, w_gate, w_up, w_down, x_loc):
        Bl, Sl, d = x_loc.shape
        Tl = Bl * Sl
        xt = x_loc.reshape(Tl, d)
        top_w, top_e = _router({"router": router}, xt, cfg)

        cap = max(int(math.ceil(Tl * k / e_pad * capacity_factor)), 4)
        flat_e = top_e.reshape(-1).long()                # [Tl*k]
        pos = _positions_within_expert(flat_e)
        keep = pos < cap
        # destination shard flat_e // e_local, local expert flat_e % e_local
        idx = flat_e * cap + torch.clamp(pos, max=cap - 1)
        src = (xt.repeat_interleave(k, dim=0)
               * keep[:, None].to(xt.dtype)).to(cdt)
        send = torch.zeros((tp * e_local * cap, d), dtype=cdt,
                           device=x_loc.device)
        send.index_add_(0, idx, src)
        recv = a2a(send)
        # my experts' tokens from every source: [tp*cap per expert]
        grouped = recv.reshape(tp, e_local, cap, d).transpose(0, 1)
        y = _expert_ffn(grouped.reshape(e_local, tp * cap, d),
                        w_gate, w_up, w_down)
        y = y.reshape(e_local, tp, cap, d).transpose(0, 1)
        back = a2a(y.reshape(tp * e_local * cap, d))
        out_k = back[idx].reshape(Tl, k, d)
        w = (top_w * keep.reshape(Tl, k)).to(cdt)
        return torch.bmm(w[:, None, :], out_k).reshape(Bl, Sl, d)

    EXPERT_PARALLEL_CALLS += 1
    xax = (batch_axis, seq_axis, None)
    wax = ("experts", None, None)
    return ctx.local_call(
        body, (params["router"].to(cdt), params["w_gate"].to(cdt),
               params["w_up"].to(cdt), params["w_down"].to(cdt), x),
        ((None, None), wax, wax, wax, xax), ((xax, x.shape),))


def _expert_parallel_axes(x: torch.Tensor, cfg: ModelConfig):
    """(mesh, batch axis, seq axis) when ``x`` lies on a mesh in scope on
    which the reference takes its expert-parallel path — a ``'model'``
    axis of tp > 1 that divides the padded experts, a batch that divides
    the data axes — else None.  The sequence is split over ``'model'``
    when the rules put the residual stream there and it divides."""
    scope = ctx.current()
    if scope is None or not ctx.is_dtensor(x):
        return None
    from ..parallel.sharding import mesh_axis_sizes
    mesh, rules = scope
    sizes = mesh_axis_sizes(mesh)
    e_pad = cfg.n_experts_padded or cfg.n_experts
    tp = sizes.get("model", 1)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    B, S, _ = x.shape
    if not (tp > 1 and e_pad % tp == 0 and B % dp == 0):
        return None
    seq = "seq_act" if (rules.get("seq_act") == "model"
                        and S % tp == 0) else None
    return mesh, ("pod_batch" if "pod" in sizes else "batch"), seq


def moe(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
        run: RunConfig, capacity_factor: Optional[float] = None
        ) -> torch.Tensor:
    """x: [B, S, d] → [B, S, d]: the routed experts plus the shared
    expert, if any, behind its sigmoid gate.  The expert-parallel path
    when a mesh in scope allows it (``_expert_parallel_axes``), else the
    dense path (on a mesh: gathered, the same on every rank)."""
    if capacity_factor is None:
        capacity_factor = run.moe_capacity
    cdt = run.compute_dtype
    ep = _expert_parallel_axes(x, cfg)
    if ep is not None:
        y = _moe_expert_parallel(params, x, cfg, run, capacity_factor, *ep)
    else:
        names = ("router", "w_gate", "w_up", "w_down")
        whole = tuple((None,) * params[n].ndim for n in names)
        y = ctx.local_call(
            lambda x, *w: _moe_dense(dict(zip(names, w)), x, cfg, run,
                                     capacity_factor),
            (x,) + tuple(params[n] for n in names),
            ((None, None, None),) + whole, (((None, None, None), x.shape),))
    if cfg.shared_ff:
        # [B, S, d] products are the reference's [B*S, d] ones (matmul
        # folds the leading dims), the sequence whole on a mesh; the gate
        # joins the expert's output laid out as it is (``seq_split``).
        xw = seq_whole(x)
        sg = seq_split(torch.sigmoid((xw @ params["shared_gate"].to(cdt))
                                     .float()).to(cdt))
        y = y + mlp(params["shared"], xw, run) * sg
    return seq_split(y)


def moe_load_balance_loss(params, x: torch.Tensor, cfg: ModelConfig,
                          run: RunConfig) -> torch.Tensor:
    """Auxiliary load-balancing loss (Switch-style fraction·prob).  On a
    mesh the tokens are laid out on the batch first (the embedding's own
    layout splits d_model, which DTensor's reshape backward mishandles)."""
    e_pad = cfg.n_experts_padded or cfg.n_experts
    x = ctx.constrain(x, ("batch", None, None))
    xt = x.reshape(x.shape[0] * x.shape[1], -1).to(run.compute_dtype)
    gates = _gates(params, xt, cfg)
    top1 = torch.argmax(gates, dim=-1)
    frac = F.one_hot(top1, e_pad).float().mean(0)
    prob = gates.mean(0)
    return cfg.n_experts * torch.sum(frac * prob)
