"""Serving step builders (single device)."""
