"""Model zoo behind one functional facade (SSM and hybrid families so
far)."""
from .common import ModelConfig, RunConfig  # noqa: F401
from .registry import Model, build  # noqa: F401
