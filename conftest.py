"""Repository-wide pytest settings: registers the ``cuda`` marker, which
tags tests that need an NVIDIA card (they skip with a reason without one)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped where none is present")
