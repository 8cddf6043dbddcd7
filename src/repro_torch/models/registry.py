"""Model facade: one object per architecture exposing the whole lifecycle —
specs → init → loss/forward → prefill/decode — plus ``(shape, dtype)``
stand-ins for the inputs (``input_specs``), the serving state
(``state_specs``) and the parameters (``abstract``), and the logical
axes of the inputs and the state (``input_axes``, ``state_axes``) for
the sharding rules.

The SSM and hybrid families (mamba2-780m, zamba2-1.2b) go to
``models/hybrid.py``; the dense, MoE, audio and VLM families to
``models/transformer.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..device import resolve_device
from . import hybrid as hybrid_mod
from . import transformer as tf_mod
from .common import (ModelConfig, RunConfig, abstract_params, init_params,
                     param_count, reduce_config)
from .layers import kv_cache_axes, kv_cache_specs

SSM_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass
class Model:
    arch: str
    cfg: ModelConfig
    run: RunConfig
    device: torch.device

    @property
    def _mod(self):
        return hybrid_mod if self.cfg.family in SSM_FAMILIES else tf_mod

    # ---- parameters -------------------------------------------------------
    def specs(self):
        if self.cfg.family in SSM_FAMILIES:
            return hybrid_mod.hybrid_specs(self.cfg)
        return tf_mod.decoder_specs(self.cfg)

    def init(self, seed: Union[int, torch.Generator] = 0,
             dtype: Optional[torch.dtype] = None):
        """Parameters on the model's device, drawn from a generator on
        that device (an int seeds a new one).  ``dtype`` overrides the
        floating leaves' (serve paths hold bf16 weights), cast as drawn."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return init_params(gen, self.specs(), self.cfg.init_std, self.device,
                           dtype)

    def abstract(self, dtype: Optional[torch.dtype] = None):
        """(shape, dtype) of every parameter leaf; ``dtype`` overrides the
        floating leaves' (serve paths hold bf16 weights)."""
        return abstract_params(self.specs(), dtype)

    def n_params(self) -> int:
        return param_count(self.specs())

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top-k routed experts)."""
        total = self.n_params()
        cfg = self.cfg
        if not cfg.n_experts:
            return total
        e = cfg.n_experts_padded or cfg.n_experts
        per_expert = 3 * cfg.d_model * cfg.d_ff
        return total - (e - cfg.top_k) * cfg.n_layers * per_expert

    # ---- training ---------------------------------------------------------
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        return self._mod.loss_fn(params, batch, self.cfg, self.run)

    def forward(self, params, batch) -> torch.Tensor:
        return self._mod.forward(params, batch, self.cfg, self.run)

    # ---- serving ----------------------------------------------------------
    def prefill(self, params, batch, max_seq: int):
        """(last-token logits, state); an encoder-only arch has no decode
        state: (``forward``'s logits, None)."""
        if self.cfg.is_encoder_only:
            return self.forward(params, batch), None
        return self._mod.prefill(params, batch, self.cfg, self.run, max_seq)

    def decode_step(self, params, state, tokens):
        return self._mod.decode_step(params, state, tokens, self.cfg,
                                     self.run)

    # ---- input stand-ins ---------------------------------------------------
    def input_specs(self, shape_name: str) -> Dict[str, Tuple]:
        """(shape, dtype) of every model input of this cell.

        train → the training batch; prefill → the prompt batch;
        decode → one new token (the cache/state comes from state_specs).
        """
        from ..configs.shapes import SHAPES, skip_reason
        shape = SHAPES[shape_name]
        reason = skip_reason(self.cfg, shape)
        if reason:
            raise ValueError(f"{self.arch} × {shape_name} skipped: {reason}")
        cfg = self.cfg
        B, L = shape.global_batch, shape.seq_len
        i32, bf16 = torch.int32, torch.bfloat16
        if shape.kind == "train":
            if cfg.family == "audio":
                return {"frames": ((B, L, cfg.frame_dim), bf16),
                        "labels": ((B, L), i32),
                        "mask": ((B, L), torch.bool)}
            batch: Dict[str, Tuple] = {"tokens": ((B, L), i32),
                                       "labels": ((B, L), i32)}
            if cfg.family == "vlm":
                batch["patches"] = ((B, cfg.n_patches, cfg.patch_dim), bf16)
                batch["mask"] = ((B, L), torch.bool)
            return batch
        if shape.kind == "prefill":
            if cfg.family == "audio":
                return {"frames": ((B, L, cfg.frame_dim), bf16)}
            batch = {"tokens": ((B, L), i32)}
            if cfg.family == "vlm":
                batch["patches"] = ((B, cfg.n_patches, cfg.patch_dim), bf16)
            return batch
        return {"tokens": ((B, 1), i32)}

    def input_axes(self, shape_name: str) -> Dict[str, Tuple]:
        """Logical axes of each input tensor (for sharding via rules)."""
        from ..configs.shapes import SHAPES
        decode = SHAPES[shape_name].kind == "decode"
        ax: Dict[str, Tuple] = {}
        for k in self.input_specs(shape_name):
            if k in ("tokens", "labels", "mask"):
                ax[k] = ("batch", None if decode else "seq")
            elif k == "frames":
                ax[k] = ("batch", "seq", None)
            elif k == "patches":
                ax[k] = ("batch", None, None)
        return ax

    def state_axes(self) -> Dict[str, Tuple]:
        """Logical axes of each decode-state leaf."""
        if self.cfg.family in SSM_FAMILIES:
            return hybrid_mod.state_axes(self.cfg)
        return kv_cache_axes()

    def state_specs(self, shape_name: str) -> Optional[Dict[str, Tuple]]:
        """(shape, dtype) of the decode/prefill state (KV cache / SSM
        state) of this cell; for prefill shapes, the state prefill
        returns.  None where there is none (train; encoder-only
        prefill)."""
        from ..configs.shapes import SHAPES
        shape = SHAPES[shape_name]
        cfg = self.cfg
        if shape.kind == "train" or (shape.kind == "prefill"
                                     and cfg.is_encoder_only):
            return None
        B, S = shape.global_batch, shape.seq_len
        if cfg.family in SSM_FAMILIES:
            return hybrid_mod.state_specs(cfg, B, S)
        return kv_cache_specs(cfg, B, S)


def build(arch: str, run: Optional[RunConfig] = None, smoke: bool = False,
          device: Union[None, str, torch.device] = None) -> Model:
    """``device=None`` means ``"cuda"`` and raises without CUDA; pass
    ``device="cpu"`` for the plain torch versions on the CPU."""
    from ..configs.registry import get_config
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = reduce_config(cfg)
    return Model(arch=arch, cfg=cfg, run=run or RunConfig(), device=dev)
