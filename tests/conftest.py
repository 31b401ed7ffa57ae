def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the port's CUDA kernels); "
        "skips with a reason where there is none")
