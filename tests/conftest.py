"""Shared pytest settings: registers the marker for tests that need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where none is present")
