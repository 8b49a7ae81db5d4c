from repro_torch.kernels.int8_matmul.ops import int8_matmul, int8_matmul_2d
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_2d_ref,
                                                 int8_matmul_ref)

__all__ = ["int8_matmul", "int8_matmul_2d", "int8_matmul_ref",
           "int8_matmul_2d_ref"]
