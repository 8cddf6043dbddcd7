"""SSM decoder LMs: pure Mamba2 (mamba2-780m) and the Zamba2-style hybrid
(Mamba2 stack + ONE weight-shared attention block applied every
``attn_every`` layers, each application with its own KV cache).

``attn_every = 0`` → pure SSM.  Both support O(1)-state decode.

Layers are a Python loop over the stacked ``[n_layers, ...]`` parameter
leaves (the reference's ``lax.scan`` + ``lax.cond``).  :func:`prefill`
runs every layer once and takes each layer's final SSD state from the
same scan that produces its output; the reference runs the stack twice
only because a scan cannot emit per-layer states of another shape, and
the numbers are the same.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .common import (ModelConfig, RunConfig, layer_params, position_ids,
                     spec, stacked, tree_map)
from .layers import (attend, attention, attn_specs, cross_entropy,
                     decode_attention, embed, embed_specs, kv_cache_specs,
                     logits_out, mlp, mlp_specs, project_qkv, remat,
                     rmsnorm)
from .ssm import (ssm_block, ssm_block_decode, ssm_block_with_state,
                  ssm_specs, ssm_state_specs)

SSM_KEYS = ("ssd", "conv_x", "conv_B", "conv_C")


def n_attn_apps(cfg: ModelConfig) -> int:
    return 0 if not cfg.attn_every else cfg.n_layers // cfg.attn_every


def hybrid_specs(cfg: ModelConfig) -> Dict[str, Any]:
    per_layer = {"ln": spec((cfg.d_model,), (None,), init="ones"),
                 "ssm": ssm_specs(cfg)}
    s: Dict[str, Any] = {
        "embed": embed_specs(cfg),
        "layers": tree_map(lambda sp: stacked(cfg.n_layers, sp), per_layer),
        "ln_f": spec((cfg.d_model,), (None,), init="ones"),
    }
    if cfg.attn_every:
        # Zamba2's shared block is a full transformer block (attn + MLP),
        # ONE weight set applied at every attn_every-th layer.
        s["shared_attn"] = {"ln": spec((cfg.d_model,), (None,), init="ones"),
                            "attn": attn_specs(cfg),
                            "ln2": spec((cfg.d_model,), (None,), init="ones"),
                            "mlp": mlp_specs(cfg)}
    return s


def _shared_block(sa, x: torch.Tensor, positions, cfg: ModelConfig,
                  run: RunConfig) -> torch.Tensor:
    x = x + attention(sa["attn"], rmsnorm(x, sa["ln"], cfg.rms_eps),
                      positions, cfg, run)
    return x + mlp(sa["mlp"], rmsnorm(x, sa["ln2"], cfg.rms_eps), run)


def _is_attn_layer(cfg: ModelConfig, i: int) -> bool:
    return bool(cfg.attn_every) and \
        (i % cfg.attn_every) == (cfg.attn_every - 1)


def forward(params, batch, cfg: ModelConfig, run: RunConfig) -> torch.Tensor:
    h = embed(params["embed"], batch["tokens"], run)
    B, L = h.shape[:2]
    positions = position_ids(B, L, h.device)

    def layer(hh, lp, sa):
        """One layer and, at every ``attn_every``-th, the shared block:
        the reference's scanned (and rematerialised) body."""
        hh = hh + ssm_block(lp["ssm"], rmsnorm(hh, lp["ln"], cfg.rms_eps),
                            cfg, run)
        if sa is not None:
            hh = _shared_block(sa, hh, positions, cfg, run)
        return hh
    body = remat(layer, run)
    for i in range(cfg.n_layers):
        sa = params["shared_attn"] if _is_attn_layer(cfg, i) else None
        h = body(h, layer_params(params, i), sa)
    h = rmsnorm(h, params["ln_f"], cfg.rms_eps)
    return logits_out(params["embed"], h, cfg, run)


def loss_fn(params, batch, cfg: ModelConfig, run: RunConfig):
    logits = forward(params, batch, cfg, run)
    mask = batch.get("mask")
    m = None if mask is None else mask[:, 1:]
    loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:], m)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def state_specs(cfg: ModelConfig, batch: int, max_seq: int,
                state_dtype=torch.float32) -> Dict[str, Tuple]:
    """Shape and dtype of every decode-state leaf.  KV caches are bf16
    whatever the compute dtype, as in the reference."""
    s: Dict[str, Tuple] = dict(ssm_state_specs(cfg, batch, cfg.n_layers,
                                               state_dtype))
    apps = n_attn_apps(cfg)
    if apps:
        s.update(kv_cache_specs(cfg, batch, max_seq, n_apps=apps))
    s["length"] = ((), torch.int32)
    return s


def init_state(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in state_specs(cfg, batch, max_seq).items()}


def prefill(params, batch, cfg: ModelConfig, run: RunConfig, max_seq: int):
    """Full-prompt pass producing SSM states + (hybrid) KV caches, in one
    pass over the layers."""
    h = embed(params["embed"], batch["tokens"], run)
    B, L = h.shape[:2]
    if L > max_seq:
        raise ValueError(f"prompt of {L} tokens exceeds max_seq {max_seq}")
    if L < cfg.ssm_conv_width - 1:
        raise ValueError(f"prompt of {L} tokens is shorter than the conv "
                         f"buffer ({cfg.ssm_conv_width - 1})")
    positions = position_ids(B, L, h.device)
    state = init_state(cfg, B, max_seq, h.device)
    sa = params.get("shared_attn")
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        out, st = ssm_block_with_state(
            lp["ssm"], rmsnorm(h, lp["ln"], cfg.rms_eps), cfg, run)
        h = h + out
        for key in SSM_KEYS:
            state[key][i] = st[key]
        if _is_attn_layer(cfg, i):
            app = i // cfg.attn_every
            hn = rmsnorm(h, sa["ln"], cfg.rms_eps)
            q, k, v = project_qkv(sa["attn"], hn, positions, cfg, run)
            state["k"][app, :, :L] = k
            state["v"][app, :, :L] = v
            h = h + attend(sa["attn"], q, k, v, cfg, run, cfg.causal)
            h = h + mlp(sa["mlp"], rmsnorm(h, sa["ln2"], cfg.rms_eps), run)
    h = rmsnorm(h, params["ln_f"], cfg.rms_eps)
    logits = logits_out(params["embed"], h[:, -1:, :], cfg, run)
    state["length"] = torch.tensor(L, dtype=torch.int32, device=h.device)
    return logits, state


def decode_step(params, state, tokens: torch.Tensor, cfg: ModelConfig,
                run: RunConfig):
    """tokens: [B,1] → (logits, new state).  O(1) per step for SSM layers,
    O(cache length) for the hybrid's shared-attention applications.

    The KV caches of ``state`` are updated in place and returned in the
    new state (see ``layers.decode_attention``); the SSM states are new
    tensors."""
    h = embed(params["embed"], tokens, run)[:, 0, :]     # [B, d]
    length = state["length"]
    sa = params.get("shared_attn")
    new_state = {k: torch.empty_like(state[k]) for k in SSM_KEYS}
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        st_i = {k: state[k][i] for k in SSM_KEYS}
        out, new_st = ssm_block_decode(
            lp["ssm"], rmsnorm(h, lp["ln"], cfg.rms_eps), st_i, cfg, run)
        h = h + out
        for key in SSM_KEYS:
            new_state[key][i] = new_st[key]
        if _is_attn_layer(cfg, i):
            app = i // cfg.attn_every
            hn = rmsnorm(h[:, None, :], sa["ln"], cfg.rms_eps)
            a, _, _ = decode_attention(sa["attn"], hn, state["k"][app],
                                       state["v"][app], length, cfg, run)
            h = h + a[:, 0, :]
            h = h + mlp(sa["mlp"], rmsnorm(h, sa["ln2"], cfg.rms_eps), run)
    h = rmsnorm(h, params["ln_f"], cfg.rms_eps)
    logits = logits_out(params["embed"], h[:, None, :], cfg, run)
    if n_attn_apps(cfg):
        new_state["k"], new_state["v"] = state["k"], state["v"]
    new_state["length"] = length + 1
    return logits, new_state
