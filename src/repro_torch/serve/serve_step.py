"""Serving step builders: prefill and single-token decode, on one device.

Each builder returns a function that moves its integer inputs to the
device and runs the model under ``torch.inference_mode()``.  The
reference's mesh, parameter shardings and pinned output shardings come
with the parallelism slice (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..configs.shapes import SHAPES
from ..device import resolve_device
from ..models.registry import Model


def _on_device(model: Model, shape_name: str, device) -> torch.device:
    if shape_name not in SHAPES:
        raise KeyError(f"unknown shape {shape_name!r}; known: "
                       f"{sorted(SHAPES)}")
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"model was built for {model.device}, not {dev}")
    return dev


def build_prefill(model: Model, shape_name: str,
                  device: Union[None, str, torch.device] = None,
                  max_seq: Optional[int] = None) -> Callable:
    """``prefill(params, batch) -> (last-token logits, state)``; the state
    holds caches of ``max_seq`` slots (default: the shape's ``seq_len``)."""
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
