"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version.  ``build.py`` compiles them with nvcc at first use."""
