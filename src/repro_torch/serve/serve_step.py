"""Serving step builders: prefill and single-token decode, on one device.

Each builder returns a function that moves its inputs to the device and
runs the model under ``torch.inference_mode()``.  A cell that
``configs/shapes.py::skip_reason`` skips is refused: an encoder-only
arch has a prefill (``forward``'s logits, no state) and no decode step.
The reference's mesh, parameter shardings and pinned output shardings
come with the parallelism slice (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..configs.shapes import SHAPES, skip_reason
from ..device import resolve_device
from ..models.registry import Model


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
                  max_seq: Optional[int] = None) -> Callable:
    """``prefill(params, batch) -> (last-token logits, state)``; the state
    holds caches of ``max_seq`` slots (default: the shape's ``seq_len``).
    An encoder-only arch returns ``(logits of every position, None)``."""
    dev = _on_device(model, shape_name, device)
    max_seq = max_seq or SHAPES[shape_name].seq_len

    def prefill(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            return model.prefill(params, batch, max_seq)
    return prefill


def build_decode_step(model: Model, shape_name: str,
                      device: Union[None, str, torch.device] = None
                      ) -> Callable:
    """``decode(params, state, tokens [B, 1]) -> (logits, state)``; the
    KV caches of ``state`` are updated in place."""
    dev = _on_device(model, shape_name, device)

    def decode(params, state, tokens):
        with torch.inference_mode():
            return model.decode_step(params, state, tokens.to(dev))
    return decode
