def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the repro_torch kernels); skips without one")
