"""Mamba2 (SSD) block: projections + causal depthwise conv + SSD scan.

The full-sequence block runs the SSD scan through ``kernels/ssd/ops.py``
(the CUDA kernel for CUDA tensors, the plain torch version for CPU
tensors).  The decode step's recurrence (``ssd_decode``) has no kernel in
the reference, so its torch ops are the port of it on every device.
On a mesh both run on each rank's batch and head shard
(``parallel.ctx.local_call``): every head's scan is independent.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd import ops as ssd_ops
from ..parallel.ctx import local_call
from .common import ModelConfig, ParamSpec, RunConfig, spec
from .layers import rmsnorm, seq_split, seq_whole

F32 = torch.float32

# Logical axes of the SSD scan's operands (``ref.ssd_ref``'s shapes).
_X = ("batch", None, "ssm_heads", None)          # x, y: [B, L, H, P]
_DT = ("batch", None, "ssm_heads")               # dt: [B, L, H]
_A = ("ssm_heads",)                              # A: [H]
_BC = ("batch", None, None)                      # B, C: [B, L, N]
_STATE = ("batch", "ssm_heads", None, None)      # state: [B, H, N, P]


def ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    di = cfg.d_inner
    H = cfg.ssm_heads
    N = cfg.ssm_state
    cw = cfg.ssm_conv_width
    return {
        "w_x": spec((cfg.d_model, di), ("embed", "ssm_inner")),
        "w_z": spec((cfg.d_model, di), ("embed", "ssm_inner")),
        "w_B": spec((cfg.d_model, N), ("embed", None)),
        "w_C": spec((cfg.d_model, N), ("embed", None)),
        "w_dt": spec((cfg.d_model, H), ("embed", "ssm_heads")),
        "dt_bias": spec((H,), ("ssm_heads",), init="zeros"),
        "A_log": spec((H,), ("ssm_heads",), init="zeros"),
        "D": spec((H,), ("ssm_heads",), init="ones"),
        "conv_x": spec((cw, di), ("conv_w", "ssm_inner"), init="normal"),
        "conv_B": spec((cw, N), ("conv_w", None), init="normal"),
        "conv_C": spec((cw, N), ("conv_w", None), init="normal"),
        "gate_norm": spec((di,), ("ssm_inner",), init="ones"),
        "w_out": spec((di, cfg.d_model), ("ssm_inner", "embed"), init="scaled"),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's ``F.softplus``
    switches to ``x`` above a threshold instead)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: [B,L,C]; w: [K,C].  The taps are
    unrolled in x's dtype, as in the reference (``F.conv1d`` would go
    through cuDNN, in TF32 for fp32 by default).  The K-1 leading zeros
    are concatenated rather than padded: some DTensor releases give
    ``constant_pad_nd`` a placement for one mesh dimension only."""
    K = w.shape[0]
    L = x.shape[1]
    zero = torch.zeros_like(x[:, :1])
    xp = torch.cat([zero] * (K - 1) + [x], dim=1)
    out = torch.zeros_like(x)
    for k in range(K):  # K is tiny (4)
        out = out + xp[:, k:k + L, :] * w[k][None, None, :]
    return out


def _conv_decode(buf: torch.Tensor, xt: torch.Tensor, w: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step causal conv.  buf: [B,K-1,C] (past inputs); xt: [B,C]."""
    full = torch.cat([buf, xt[:, None, :]], dim=1)         # [B,K,C]
    y = torch.einsum("bkc,kc->bc", full, w)
    return y, full[:, 1:, :]


def _split_heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, L, di = x.shape
    return x.reshape(B, L, H, di // H)


def ssm_block_with_state(params, x: torch.Tensor, cfg: ModelConfig,
                         run: RunConfig
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba2 block.  x: [B, L, d_model] → (out, the
    layer's final decode state: the SSD state from the same scan and the
    last K-1 pre-conv inputs, fp32)."""
    cdt = run.compute_dtype
    x = seq_whole(x)
    H = cfg.ssm_heads
    K = cfg.ssm_conv_width
    xt = x @ params["w_x"].to(cdt)
    bt = x @ params["w_B"].to(cdt)
    ct = x @ params["w_C"].to(cdt)
    xz = F.silu(_causal_conv(xt, params["conv_x"].to(cdt)))
    Bm = F.silu(_causal_conv(bt, params["conv_B"].to(cdt)))
    Cm = F.silu(_causal_conv(ct, params["conv_C"].to(cdt)))
    dt = softplus((x @ params["w_dt"].to(cdt)).to(F32)
                  + params["dt_bias"].to(F32))
    A = -torch.exp(params["A_log"].to(F32))
    xh = _split_heads(xz, H)
    chunk = min(64, x.shape[1])
    B, _, H, P = xh.shape
    y, final = local_call(
        lambda *a: ssd_ops.ssd(*a, chunk=chunk), (xh, dt, A, Bm, Cm),
        (_X, _DT, _A, _BC, _BC),
        ((_X, xh.shape), (_STATE, (B, H, cfg.ssm_state, P))))
    y = y.to(cdt) + params["D"].to(cdt)[None, None, :, None] * xh
    y = y.reshape(x.shape[0], x.shape[1], cfg.d_inner)
    z = F.silu(x @ params["w_z"].to(cdt))
    y = rmsnorm(y * z, params["gate_norm"], cfg.rms_eps)
    state = {"ssd": final,
             "conv_x": xt[:, -(K - 1):, :].to(F32),
             "conv_B": bt[:, -(K - 1):, :].to(F32),
             "conv_C": ct[:, -(K - 1):, :].to(F32)}
    return seq_split(y @ params["w_out"].to(cdt)), state


def ssm_block(params, x: torch.Tensor, cfg: ModelConfig,
              run: RunConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x: [B, L, d_model]."""
    return ssm_block_with_state(params, x, cfg, run)[0]


# ---------------------------------------------------------------------------
# Decode: recurrent single-token step with (conv buffers + SSD state)
# ---------------------------------------------------------------------------


def ssm_state_specs(cfg: ModelConfig, batch: int, n_layers: int,
                    dtype=F32) -> Dict[str, Tuple[Tuple[int, ...],
                                                  torch.dtype]]:
    """Shape and dtype of every SSM state leaf."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    K = cfg.ssm_conv_width
    return {
        "ssd": ((n_layers, batch, H, N, P), dtype),
        "conv_x": ((n_layers, batch, K - 1, cfg.d_inner), dtype),
        "conv_B": ((n_layers, batch, K - 1, N), dtype),
        "conv_C": ((n_layers, batch, K - 1, N), dtype),
    }


# Logical axes of each SSM state leaf.
SSM_STATE_AXES = {
    "ssd": ("layers", "batch", "ssm_heads", None, None),
    "conv_x": ("layers", "batch", None, "ssm_inner"),
    "conv_B": ("layers", "batch", None, None),
    "conv_C": ("layers", "batch", None, None),
}


def init_ssm_state(cfg: ModelConfig, batch: int, n_layers: int,
                   dtype=F32, device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in ssm_state_specs(cfg, batch, n_layers,
                                                  dtype).items()}


def ssm_block_decode(params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                     cfg: ModelConfig, run: RunConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, d_model]; per-layer state slices (no leading layer axis)."""
    cdt = run.compute_dtype
    H = cfg.ssm_heads
    xt = x @ params["w_x"].to(cdt)
    bt = x @ params["w_B"].to(cdt)
    ct = x @ params["w_C"].to(cdt)
    xc, conv_x = _conv_decode(state["conv_x"].to(cdt), xt,
                              params["conv_x"].to(cdt))
    bc, conv_B = _conv_decode(state["conv_B"].to(cdt), bt,
                              params["conv_B"].to(cdt))
    cc, conv_C = _conv_decode(state["conv_C"].to(cdt), ct,
                              params["conv_C"].to(cdt))
    xc, bc, cc = F.silu(xc), F.silu(bc), F.silu(cc)
    dt = softplus((x @ params["w_dt"].to(cdt)).to(F32)
                  + params["dt_bias"].to(F32))
    A = -torch.exp(params["A_log"].to(F32))
    xh = xc.reshape(x.shape[0], H, cfg.ssm_head_dim)
    # decode operands drop the length axis: x [B,H,P], dt [B,H], B/C [B,N]
    x1, dt1, bc1 = (_X[0],) + _X[2:], _DT[:1] + _DT[2:], _BC[:1] + _BC[2:]
    ssd_state = state["ssd"].to(F32)
    y, ssd_state = local_call(
        ssd_ops.ssd_decode, (xh, dt, A, bc, cc, ssd_state),
        (x1, dt1, _A, bc1, bc1, _STATE),
        ((x1, xh.shape), (_STATE, ssd_state.shape)))
    y = y.to(cdt) + params["D"].to(cdt)[None, :, None] * xh
    y = y.reshape(x.shape[0], cfg.d_inner)
    z = F.silu(x @ params["w_z"].to(cdt))
    y = rmsnorm(y * z, params["gate_norm"], cfg.rms_eps)
    out = y @ params["w_out"].to(cdt)
    new_state = {"ssd": ssd_state.to(state["ssd"].dtype),
                 "conv_x": conv_x.to(state["conv_x"].dtype),
                 "conv_B": conv_B.to(state["conv_B"].dtype),
                 "conv_C": conv_C.to(state["conv_C"].dtype)}
    return out, new_state
