"""ckpt substrate: atomic step-dir, versioned simulation-stream snapshots
(see ``checkpoint``)."""
from .checkpoint import (STREAM_SCHEMA_VERSION, latest_step, prune,
                         restore_stream, save_stream)

__all__ = [
    "STREAM_SCHEMA_VERSION",
    "latest_step",
    "prune",
    "restore_stream",
    "save_stream",
]
