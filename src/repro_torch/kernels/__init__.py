"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version.  ``build.py`` compiles them with nvcc at first use."""
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref

__all__ = ["int8_matmul", "int8_matmul_ref"]
