"""Per-architecture configs (one module per assigned arch) + shapes."""
from .registry import ARCH_IDS, cells, get_config  # noqa: F401
from .shapes import SHAPES, SHAPE_ORDER, Shape, skip_reason  # noqa: F401
