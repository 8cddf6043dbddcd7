"""Shared model machinery: configs, parameter specs, initialisation.

Parameters are plain nested dicts of tensors.  Every leaf is declared
once as a :class:`ParamSpec` carrying its shape, dtype, initializer and
logical axis names; the spec tree yields the materialized parameters and
the parameter count.  The logical axes stay on the specs for the
sharding rules of a later slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

PyTree = Any


# ---------------------------------------------------------------------------
# Model configuration — one dataclass covers all 10 assigned families.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # attention query heads (0 for attn-free)
    n_kv_heads: int               # GQA KV heads
    d_ff: int                     # dense FFN width (per-expert width for MoE)
    vocab: int
    head_dim: int = 0             # 0 → d_model // n_heads
    # MoE
    n_experts: int = 0
    n_experts_padded: int = 0     # padded for expert-parallel divisibility
    top_k: int = 0
    shared_ff: int = 0            # always-on shared-expert width
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    # Hybrid (Zamba2): one weight-shared attention block applied every
    # ``attn_every`` SSM layers.
    attn_every: int = 0
    # Attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True           # False for encoder-only (HuBERT)
    # VLM frontend stub
    n_patches: int = 0            # patch-embedding positions (precomputed)
    patch_dim: int = 0
    # Audio frontend stub
    frame_dim: int = 0            # precomputed frame-embedding width
    # Norm/init
    rms_eps: float = 1e-6
    init_std: float = 0.02
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing → eligible for long_500k."""
        return self.family in ("ssm", "hybrid")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything about *how* to run, as opposed to *what* the model is.

    The reference's ``use_pallas`` is gone: a kernel follows the device
    its tensors lie on.  ``scan_layers`` is gone too: layers are a Python
    loop.  The training and sharding knobs are kept as data for the
    slices that read them."""

    seq_len: int = 4096
    global_batch: int = 256
    microbatch: int = 0            # 0 → no gradient accumulation
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: str = "dots"            # none | dots | full
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    grad_compression: str = "none"   # none | int8  (error-feedback all-reduce)
    seq_parallel: bool = True        # shard the residual stream over 'model'
    cast_params_once: bool = False
    moe_capacity: float = 1.25
    # Serving
    decode_seq_shard: bool = False   # shard KV cache over 'data' by sequence

    def with_(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis names (same rank)
    init: str = "normal"                 # normal | zeros | ones | scaled
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def spec(shape: Sequence[int], axes: Sequence[Optional[str]],
         init: str = "normal", dtype: torch.dtype = torch.float32
         ) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, dtype)


def stacked(n: int, s: ParamSpec) -> ParamSpec:
    """Stack a per-layer spec along a leading 'layers' axis."""
    return ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    """Map ``fn`` over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: PyTree) -> list:
    """Leaves in sorted-key order (the order ``jax.tree.leaves`` uses)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree: PyTree, leaves: Sequence) -> PyTree:
    """``tree``'s nested dicts with its leaves replaced by ``leaves``,
    taken in sorted-key order (``tree_leaves``' inverse)."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def _init_leaf(s: ParamSpec, base_std: float, gen: torch.Generator,
               device: torch.device,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dt = dtype if dtype is not None and s.dtype.is_floating_point \
        else s.dtype
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=device)
    std = base_std
    if s.init == "scaled":  # output projections: scale by 1/sqrt(2*fan-in-ish)
        std = base_std / math.sqrt(2.0)
    if dtype is None or len(s.shape) < 3:
        return (torch.randn(s.shape, generator=gen, dtype=torch.float32,
                            device=device) * std).to(dt)
    # Cast as drawn, one slice of the leading (layer) axis at a time, so
    # that no fp32 copy of a whole stacked leaf is ever held.
    out = torch.empty(s.shape, dtype=dt, device=device)
    for i in range(s.shape[0]):
        out[i] = torch.randn(s.shape[1:], generator=gen,
                             dtype=torch.float32, device=device) * std
    return out


def init_params(gen: torch.Generator, spec_tree: PyTree,
                base_std: float = 0.02,
                device: Union[str, torch.device] = "cpu",
                dtype: Optional[torch.dtype] = None) -> PyTree:
    """Materialize a spec tree: leaves drawn from ``gen`` in sorted-key
    order (normal·std, ``scaled`` = std/√2, zeros, ones) on ``device``,
    which must be the generator's device.  ``dtype`` overrides the
    floating leaves' dtype (serving holds bf16 weights, as the
    reference's ``Model.abstract(dtype)`` does); each leaf of rank 3 or
    more is then drawn and cast a leading slice at a time."""
    device = torch.device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return _init_leaf(t, base_std, gen, device, dtype)
    return walk(spec_tree)


def abstract_params(spec_tree: PyTree,
                    dtype: Optional[torch.dtype] = None) -> PyTree:
    """(shape, dtype) of every leaf, nothing allocated; ``dtype``
    overrides the floating leaves'."""
    return tree_map(lambda s: (s.shape, dtype if dtype is not None
                               and s.dtype.is_floating_point else s.dtype),
                    spec_tree)


def param_count(spec_tree: PyTree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))


# ---------------------------------------------------------------------------
# Tiny helpers shared across model files
# ---------------------------------------------------------------------------


def layer_params(params: PyTree, i: int) -> PyTree:
    """Layer ``i``'s parameters: views into the stacked
    ``params["layers"]`` leaves (the reference scans over them)."""
    return tree_map(lambda x: x[i], params["layers"])


def position_ids(B: int, L: int, device) -> torch.Tensor:
    """Positions 0 .. L-1 of each of B rows, int32 ``[B, L]``."""
    return torch.arange(L, dtype=torch.int32, device=device).expand(B, L)


def cast_tree(tree: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test reduction: same family/topology, tiny dims."""
    kw: Dict[str, Any] = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.attn_every == 0 else 4),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab=max(min(cfg.vocab, 512), 64),
        head_dim=32 if cfg.has_attention else 0,
    )
    if cfg.has_attention:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(max(cfg.n_kv_heads * 4 // max(cfg.n_heads, 1), 1), 4)
    if cfg.n_experts:
        kw["n_experts"] = 8
        kw["n_experts_padded"] = 8
        kw["top_k"] = min(cfg.top_k, 2)
        kw["shared_ff"] = 128 if cfg.shared_ff else 0
    if cfg.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 32
    if cfg.attn_every:
        kw["attn_every"] = 2
    if cfg.n_patches:
        kw["n_patches"] = 16
        kw["patch_dim"] = 64
    if cfg.frame_dim:
        kw["frame_dim"] = 64
    return cfg.with_(**kw)
