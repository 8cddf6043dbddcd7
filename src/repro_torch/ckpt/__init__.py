"""ckpt substrate: atomic step-dir checkpoints for parameter trees and
versioned simulation-stream snapshots (see ``checkpoint``)."""
from .checkpoint import (STREAM_SCHEMA_VERSION, latest_step, prune, restore,
                         restore_section, restore_stream, save,
                         save_sections, save_stream)

__all__ = [
    "STREAM_SCHEMA_VERSION",
    "latest_step",
    "prune",
    "restore",
    "restore_section",
    "restore_stream",
    "save",
    "save_sections",
    "save_stream",
]
