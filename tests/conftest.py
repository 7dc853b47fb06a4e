def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernels have no CPU "
        "mode); skips where torch.cuda.is_available() is False")
