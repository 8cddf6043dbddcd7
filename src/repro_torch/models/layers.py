"""Core layers: RMSNorm, RoPE, GQA attention (prefill + cached decode), SwiGLU.

Pure functions over parameter dicts, in the reference's layouts
(``[B, L, H, D]`` activations, ``[d_model, H, D]`` projections).
Full-sequence attention always goes through
``kernels/flash_attention/ops.py``: the CUDA kernel for CUDA tensors, the
plain torch version for CPU tensors.  Decode attention is plain torch on
every device: the reference has no kernel for it (jnp at
``repro/models/layers.py::decode_attention``), so these ops are the port
of it, not a fallback.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt_mod

from ..kernels.flash_attention import ops as fa_ops
from .common import ModelConfig, ParamSpec, RunConfig, spec

F32 = torch.float32

# ---------------------------------------------------------------------------
# Remat policy
# ---------------------------------------------------------------------------


# The ops whose outputs ``remat="dots"`` keeps: every matrix product
# (what ``jax.checkpoint_policies.checkpoint_dots`` keeps, attention's
# einsums included) and the flash-attention forward, which on the card
# computes those einsums in one kernel (registered by this module's import
# of the kernel's ops).
_SAVED_BY_DOTS = frozenset((
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
    torch.ops.repro_torch.flash_attention_fwd.default))


def _dots_policy(ctx, op, *args, **kwargs):
    P = ckpt_mod.CheckpointPolicy
    return P.MUST_SAVE if op in _SAVED_BY_DOTS else P.PREFER_RECOMPUTE


def remat(fn: Callable, run: RunConfig) -> Callable:
    """The reference's remat policy around a layer body.  ``"none"``:
    the plain body; ``"full"``: nothing kept, the body recomputed in the
    backward (``jax.checkpoint`` with ``nothing_saveable``); ``"dots"``:
    selective checkpointing that keeps the matrix products' outputs
    (``checkpoint_dots``).  Without grad (serving) every policy runs the
    plain body: there is no backward to recompute for."""
    if run.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {run.remat!r}")
    if run.remat == "none":
        return fn
    kw: Dict[str, Any] = {"use_reentrant": False}
    if run.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt_mod.create_selective_checkpoint_contexts, _dots_policy)

    def body(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt_mod.checkpoint(fn, *args, **kw)
    return body


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(F32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(F32)).to(dt)


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., L, H, D]; positions: [..., L] integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [D/2]
    ang = positions[..., None].to(F32) * freqs              # [..., L, D/2]
    cos = torch.cos(ang)[..., None, :]                      # [..., L, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention parameter specs
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    hd = cfg.hd
    s: Dict[str, ParamSpec] = {
        "wq": spec((cfg.d_model, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": spec((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": spec((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": spec((cfg.n_heads, hd, cfg.d_model), ("heads", "head_dim", "embed"),
                   init="scaled"),
    }
    if cfg.qk_norm:
        s["q_norm"] = spec((hd,), (None,), init="ones")
        s["k_norm"] = spec((hd,), (None,), init="ones")
    return s


# ---------------------------------------------------------------------------
# Attention forward (training / prefill) — full sequence
# ---------------------------------------------------------------------------


def _proj_heads(x: torch.Tensor, w: torch.Tensor, cdt) -> torch.Tensor:
    """``einsum("bld,dhk->blhk", x, w)``: [B, L, d] × [d, H, D]."""
    d, H, D = w.shape
    return (x @ w.to(cdt).reshape(d, H * D)).unflatten(-1, (H, D))


def _out_proj(o: torch.Tensor, w: torch.Tensor, cdt) -> torch.Tensor:
    """``einsum("blhk,hkd->bld", o, w)``: [B, L, H, D] × [H, D, d]."""
    H, D, d = w.shape
    return o.flatten(-2) @ w.to(cdt).reshape(H * D, d)


def project_qkv(params: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig, run: RunConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B,L,Hq,D], k and v [B,L,Hkv,D]: projected, q/k-normed, roped."""
    cdt = run.compute_dtype
    q = _proj_heads(x, params["wq"], cdt)
    k = _proj_heads(x, params["wk"], cdt)
    v = _proj_heads(x, params["wv"], cdt)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, params["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend(params: Dict[str, torch.Tensor], q: torch.Tensor,
           k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
           run: RunConfig, causal: bool) -> torch.Tensor:
    """Flash attention over projected q/k/v, then the output projection."""
    # GQA: repeat KV heads up to query heads (outside the kernel).
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    o = fa_ops.flash_attention(q, k, v, causal=causal)
    return _out_proj(o, params["wo"], run.compute_dtype)


def attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
              positions: torch.Tensor, cfg: ModelConfig, run: RunConfig,
              causal: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence GQA attention.  x: [B, L, d_model]."""
    causal = cfg.causal if causal is None else causal
    q, k, v = project_qkv(params, x, positions, cfg, run)
    return attend(params, q, k, v, cfg, run, causal)


# ---------------------------------------------------------------------------
# Attention with KV cache (decode)
# ---------------------------------------------------------------------------


def kv_cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                   n_apps: int = 0, dtype=torch.bfloat16) -> Dict[str, Tuple]:
    """(shape, dtype) of each cache leaf.  ``n_apps`` > 0 builds a
    hybrid-model cache (one per shared-attention application)."""
    layers = n_apps if n_apps else cfg.n_layers
    shape = (layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": (shape, dtype), "v": (shape, dtype),
            "length": ((), torch.int32)}


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in kv_cache_specs(cfg, batch, max_seq,
                                                 dtype=dtype).items()}


def decode_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: torch.Tensor, cfg: ModelConfig,
                     run: RunConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: [B, 1, d].  k/v_cache: [B, S, Hkv, D].

    Returns (out [B,1,d], k_cache, v_cache).  The new token is written at
    ``length`` — in place: the caches passed in are updated and returned,
    which spares copying a cache of ``max_seq`` slots every step.
    Attention spans the first ``length+1`` cache slots (masked)."""
    cdt = run.compute_dtype
    B, S, Hkv, D = k_cache.shape
    q = _proj_heads(x, params["wq"], cdt)
    k = _proj_heads(x, params["wk"], cdt)
    v = _proj_heads(x, params["wv"], cdt)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, params["k_norm"], cfg.rms_eps)
    pos = length.to(torch.int32).expand(B, 1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    slot = length.reshape(1).long()
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    rep = cfg.n_heads // cfg.n_kv_heads
    kk = k_cache.to(cdt)
    vv = v_cache.to(cdt)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=F32)
    # [B,1,Hq,D] x [B,S,Hkv,D] — group query heads over kv heads.
    qg = q.reshape(B, 1, Hkv, rep, D)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, kk).to(F32) * scale
    mask = torch.arange(S, device=x.device) <= length
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(cdt)
    o = torch.einsum("bhrqk,bkhd->bqhrd", p, vv).reshape(B, 1, Hkv * rep, D)
    return _out_proj(o, params["wo"], cdt), k_cache, v_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    ff = d_ff if d_ff is not None else cfg.d_ff
    return {
        "w_gate": spec((cfg.d_model, ff), ("embed", "ffn")),
        "w_up": spec((cfg.d_model, ff), ("embed", "ffn")),
        "w_down": spec((ff, cfg.d_model), ("ffn", "embed"), init="scaled"),
    }


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        run: RunConfig) -> torch.Tensor:
    cdt = run.compute_dtype
    g = x @ params["w_gate"].to(cdt)
    u = x @ params["w_up"].to(cdt)
    return (F.silu(g) * u) @ params["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s = {"tok": spec((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        s["unembed"] = spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return s


def embed(params, tokens: torch.Tensor, run: RunConfig) -> torch.Tensor:
    return params["tok"].to(run.compute_dtype)[tokens]


def logits_out(params, x: torch.Tensor, cfg: ModelConfig,
               run: RunConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["tok"].to(run.compute_dtype).T
    else:
        w = params["unembed"].to(run.compute_dtype)
    return x @ w


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (optionally masked) positions; fp32 accumulation."""
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(F32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
