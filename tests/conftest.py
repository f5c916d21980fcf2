def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (run on the "
        "card with `python -m pytest -q -m gpu tests/test_torch_gpu.py`)")
