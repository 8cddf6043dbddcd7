"""Model facade: one object per architecture exposing specs → init →
loss/forward → prefill/decode.

This slice carries the SSM and hybrid families (mamba2-780m,
zamba2-1.2b).  The transformer families (dense, moe, audio, vlm) come
with ``models/transformer.py`` and ``models/moe.py`` in a later slice
(ROADMAP Queue 1 item 7) and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..device import resolve_device
from . import hybrid as hybrid_mod
from .common import (ModelConfig, RunConfig, init_params, param_count,
                     reduce_config)

SSM_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass
class Model:
    arch: str
    cfg: ModelConfig
    run: RunConfig
    device: torch.device

    def _hybrid(self):
        if self.cfg.family not in SSM_FAMILIES:
            raise NotImplementedError(
                f"{self.arch} ({self.cfg.family}): the transformer families "
                f"are not ported yet (ROADMAP Queue 1 item 7)")
        return hybrid_mod

    # ---- parameters -------------------------------------------------------
    def specs(self):
        return self._hybrid().hybrid_specs(self.cfg)

    def init(self, seed: Union[int, torch.Generator] = 0):
        """Parameters on the model's device, drawn from a generator on
        that device (an int seeds a new one)."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return init_params(gen, self.specs(), self.cfg.init_std, self.device)

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
        return self._hybrid().loss_fn(params, batch, self.cfg, self.run)

    def forward(self, params, batch) -> torch.Tensor:
        return self._hybrid().forward(params, batch, self.cfg, self.run)

    # ---- serving ----------------------------------------------------------
    def prefill(self, params, batch, max_seq: int):
        return self._hybrid().prefill(params, batch, self.cfg, self.run,
                                      max_seq)

    def decode_step(self, params, state, tokens):
        return self._hybrid().decode_step(params, state, tokens, self.cfg,
                                          self.run)


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
