"""The kernels: CUDA C++ sources in ``csrc/``, their ctypes wrappers, and
the plain PyTorch versions in ``ref``."""
