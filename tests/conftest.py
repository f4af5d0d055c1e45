"""Shared pytest settings: registers the ``gpu`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card (CUDA kernels have no CPU mode); skips "
        "without one. Run on the card: python -m pytest -q -m gpu "
        "tests/test_torch_flash_attention.py tests/test_torch_moe_gmm.py "
        "tests/test_torch_ssd_scan.py tests/test_torch_rglru_scan.py")
