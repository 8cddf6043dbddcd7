"""ft substrate."""
