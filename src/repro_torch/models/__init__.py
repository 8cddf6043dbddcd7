"""Model zoo: the 10 assigned architectures behind one functional
facade."""
from .common import ModelConfig, RunConfig  # noqa: F401
from .registry import Model, build  # noqa: F401
