"""Serving step builders: prefill and single-token decode.

Each builder returns a function that moves its inputs to the device and
runs the model under ``torch.inference_mode()``.  A cell that
``configs/shapes.py::skip_reason`` skips is refused: an encoder-only
arch has a prefill (``forward``'s logits, no state) and no decode step.

With ``mesh=`` (a ``DeviceMesh``) the step runs sharded, as the
reference's: parameters on the ``SERVE_RULES`` placements (``LONG_RULES``
above 100,000 tokens), batches on the batch placements, plain-tensor
inputs split onto them, the model inside ``parallel.ctx.scope``; the
returned state is pinned to ``parallel.sharding.state_shardings``, and
decode's in-place KV-cache update keeps the cache's placement.  The
sharded step runs under ``torch.no_grad()``: DTensor views cannot be
made of inference tensors.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..configs.shapes import SHAPES, skip_reason
from ..device import resolve_device
from ..models.registry import Model
from ..parallel import ctx
from ..parallel import sharding as shd


def _layout(model: Model, shape_name: str, mesh):
    """(rules, parameter, batch and state placements) of a sharded cell."""
    long_ctx = SHAPES[shape_name].seq_len > 100_000
    return (shd.rules_for("serve", long_ctx),
            shd.model_param_shardings(model, mesh, "serve", long_ctx),
            shd.batch_shardings(model, mesh, shape_name, "serve", long_ctx),
            shd.state_shardings(model, mesh, shape_name, long_ctx))


def _on_device(model: Model, shape_name: str, device) -> torch.device:
    if shape_name not in SHAPES:
        raise KeyError(f"unknown shape {shape_name!r}; known: "
                       f"{sorted(SHAPES)}")
    reason = skip_reason(model.cfg, SHAPES[shape_name])
    if reason:
        raise ValueError(f"{model.arch} × {shape_name} skipped: {reason}")
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"model was built for {model.device}, not {dev}")
    return dev


def build_prefill(model: Model, shape_name: str,
                  device: Union[None, str, torch.device] = None,
                  max_seq: Optional[int] = None, *, mesh=None) -> Callable:
    """``prefill(params, batch) -> (last-token logits, state)``; the state
    holds caches of ``max_seq`` slots (default: the shape's ``seq_len``).
    An encoder-only arch returns ``(logits of every position, None)``."""
    dev = _on_device(model, shape_name, device)
    max_seq = max_seq or SHAPES[shape_name].seq_len

    def prefill(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            return model.prefill(params, batch, max_seq)
    if mesh is None:
        return prefill
    rules, param_pl, batch_pl, state_pl = _layout(model, shape_name, mesh)

    def sharded(params, batch):
        params = shd.distribute(params, mesh, param_pl)
        batch = shd.distribute({k: v.to(dev) for k, v in batch.items()},
                               mesh, batch_pl)
        with ctx.scope(mesh, rules), torch.no_grad():
            logits, state = model.prefill(params, batch, max_seq)
            if state is not None:
                state = shd.distribute(state, mesh, state_pl)
        return logits, state
    return sharded


def build_decode_step(model: Model, shape_name: str,
                      device: Union[None, str, torch.device] = None,
                      *, mesh=None) -> Callable:
    """``decode(params, state, tokens [B, 1]) -> (logits, state)``; the
    KV caches of ``state`` are updated in place."""
    dev = _on_device(model, shape_name, device)

    def decode(params, state, tokens):
        with torch.inference_mode():
            return model.decode_step(params, state, tokens.to(dev))
    if mesh is None:
        return decode
    rules, param_pl, batch_pl, state_pl = _layout(model, shape_name, mesh)

    def sharded(params, state, tokens):
        params = shd.distribute(params, mesh, param_pl)
        state = shd.distribute(state, mesh, state_pl)
        tokens = shd.distribute({"tokens": tokens.to(dev)}, mesh,
                                batch_pl)["tokens"]
        with ctx.scope(mesh, rules), torch.no_grad():
            logits, state = model.decode_step(params, state, tokens)
            state = shd.distribute(state, mesh, state_pl)
        return logits, state
    return sharded
