"""Transformer families: dense/MoE decoder LMs, encoder-only (HuBERT),
and the VLM backbone (InternVL2: stubbed patch embeddings + decoder LM).

The reference's parameter tree: layers stacked along a leading
``[n_layers, ...]`` axis, the same tree for the forward, prefill and
decode paths.  Layers are a Python loop over views into the stacked
leaves (the reference's ``jax.lax.scan``).  Under grad each layer body
runs inside the reference's remat policy (``layers.remat``).  Each
layer body constrains the residual stream to ``("batch", "seq_act",
None)`` before and after attention, as the reference does; outside a
sharding scope (``parallel.ctx``) that is a no-op.

Full-sequence attention goes through ``layers.attend``, and so through
the flash-attention kernel on every CUDA tensor; decode attention is
``layers.decode_attention`` (plain torch, as in the reference).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..parallel.ctx import constrain
from . import moe as moe_mod
from .common import (ModelConfig, RunConfig, layer_params, position_ids,
                     spec, stacked, tree_map)
from .layers import (attend, attn_specs, cross_entropy, decode_attention,
                     embed, embed_specs, init_kv_cache, logits_out, mlp,
                     mlp_specs, project_qkv, remat, rmsnorm)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {"ln1": spec((cfg.d_model,), (None,), init="ones"),
                         "ln2": spec((cfg.d_model,), (None,), init="ones"),
                         "attn": attn_specs(cfg)}
    if cfg.n_experts:
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg)
    return s


def decoder_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {
        "embed": embed_specs(cfg),
        "layers": tree_map(lambda sp: stacked(cfg.n_layers, sp),
                           layer_specs(cfg)),
        "ln_f": spec((cfg.d_model,), (None,), init="ones"),
    }
    if cfg.n_patches:      # VLM frontend stub: projection of patch embeds
        s["patch_proj"] = spec((cfg.patch_dim, cfg.d_model), ("patch", "embed"))
    if cfg.frame_dim:      # audio frontend stub: projection of frame embeds
        s["frame_proj"] = spec((cfg.frame_dim, cfg.d_model), ("patch", "embed"))
    return s


# ---------------------------------------------------------------------------
# Forward (training / scoring)
# ---------------------------------------------------------------------------


def _ffn(lp, hn: torch.Tensor, cfg: ModelConfig,
         run: RunConfig) -> torch.Tensor:
    if cfg.n_experts:
        return moe_mod.moe(lp["moe"], hn, cfg, run)
    return mlp(lp["mlp"], hn, run)


def _layer_body(h: torch.Tensor, lp, positions, cfg: ModelConfig,
                run: RunConfig, cache=None) -> torch.Tensor:
    """One block.  ``cache`` = (k, v) slices of a KV cache: the layer's
    keys (post-qk-norm, post-RoPE) and values are written into their
    first L slots, the layout ``decode_attention`` reads."""
    h = constrain(h, ("batch", "seq_act", None))
    q, k, v = project_qkv(lp["attn"], rmsnorm(h, lp["ln1"], cfg.rms_eps),
                          positions, cfg, run)
    if cache is not None:
        L = h.shape[1]
        cache[0][:, :L] = k
        cache[1][:, :L] = v
    h = h + attend(lp["attn"], q, k, v, cfg, run, cfg.causal)
    h = constrain(h, ("batch", "seq_act", None))
    return h + _ffn(lp, rmsnorm(h, lp["ln2"], cfg.rms_eps), cfg, run)


def backbone(params, h: torch.Tensor, positions, cfg: ModelConfig,
             run: RunConfig) -> torch.Tensor:
    body = remat(
        lambda hh, lp: _layer_body(hh, lp, positions, cfg, run), run)
    for i in range(cfg.n_layers):
        h = body(h, layer_params(params, i))
    return rmsnorm(h, params["ln_f"], cfg.rms_eps)


def embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 run: RunConfig) -> torch.Tensor:
    """Token / frame / patch embedding, per family."""
    cdt = run.compute_dtype
    if cfg.frame_dim:                      # audio encoder: frames only
        return batch["frames"].to(cdt) @ params["frame_proj"].to(cdt)
    h = embed(params["embed"], batch["tokens"], run)
    if cfg.n_patches:                      # VLM: patches overwrite the prefix
        pe = batch["patches"].to(cdt) @ params["patch_proj"].to(cdt)
        h = torch.cat([pe, h[:, cfg.n_patches:, :]], dim=1)
    return h


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            run: RunConfig) -> torch.Tensor:
    h = embed_inputs(params, batch, cfg, run)
    B, L = h.shape[:2]
    h = backbone(params, h, position_ids(B, L, h.device), cfg, run)
    return logits_out(params["embed"], h, cfg, run)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            run: RunConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward(params, batch, cfg, run)
    mask = batch.get("mask")
    if cfg.is_encoder_only:
        loss = cross_entropy(logits, batch["labels"], mask)
    else:
        # next-token prediction; mask covers padding / patch prefix
        m = None if mask is None else mask[:, 1:]
        loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:], m)
    metrics = {"loss": loss}
    if cfg.n_experts:
        # router balance measured at the input embedding of layer 0 (the
        # reference's cheap proxy)
        h = embed_inputs(params, batch, cfg, run)
        aux = moe_mod.moe_load_balance_loss(
            layer_params(params, 0)["moe"], h, cfg, run)
        metrics["aux_loss"] = aux
        loss = loss + 0.01 * aux
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------


def prefill(params, batch, cfg: ModelConfig, run: RunConfig, max_seq: int):
    """Run the full prompt, return (last_logits, kv_cache).

    The cache holds ``max_seq`` slots in bf16 per layer, the prompt's in
    the first L; keys are stored post-qk-norm / post-RoPE, the layout
    ``decode_attention`` writes, so decode is O(1) per step.  One pass
    over the layers (the reference projects k and v a second time for
    the cache; the numbers are the same)."""
    h = embed_inputs(params, batch, cfg, run)
    B, L = h.shape[:2]
    if L > max_seq:
        raise ValueError(f"prompt of {L} tokens exceeds max_seq {max_seq}")
    positions = position_ids(B, L, h.device)
    cache = init_kv_cache(cfg, B, max_seq, device=h.device)
    for i in range(cfg.n_layers):
        h = _layer_body(h, layer_params(params, i), positions, cfg, run,
                        (cache["k"][i], cache["v"][i]))
    h = rmsnorm(h, params["ln_f"], cfg.rms_eps)
    logits = logits_out(params["embed"], h[:, -1:, :], cfg, run)
    cache["length"] = torch.tensor(L, dtype=torch.int32, device=h.device)
    return logits, cache


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig,
                run: RunConfig):
    """tokens: [B, 1] → (logits [B,1,V], updated cache).  The cache's k
    and v are updated in place (``layers.decode_attention``) and returned
    in the new cache."""
    h = embed(params["embed"], tokens, run)
    length = cache["length"]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        a, _, _ = decode_attention(lp["attn"],
                                   rmsnorm(h, lp["ln1"], cfg.rms_eps),
                                   cache["k"][i], cache["v"][i], length,
                                   cfg, run)
        h = h + a
        h = h + _ffn(lp, rmsnorm(h, lp["ln2"], cfg.rms_eps), cfg, run)
    h = rmsnorm(h, params["ln_f"], cfg.rms_eps)
    logits = logits_out(params["embed"], h, cfg, run)
    return logits, {"k": cache["k"], "v": cache["v"], "length": length + 1}
