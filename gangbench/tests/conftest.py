"""Registers the ``gpu`` marker for the benchmark's own tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card; skips without one. On the card: "
        "python -m pytest -q -m gpu gangbench/tests")
