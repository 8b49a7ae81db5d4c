"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version.  ``build.py`` compiles them with nvcc at first use.  The
names are the reference's ``repro.kernels`` exports: each kernel's
wrapper and its plain reference."""
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref
from repro_torch.kernels.lut_exp import lut_exp, lut_exp_ref
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_reference)
from repro_torch.kernels.streaming_attention import (attention_ref,
                                                     streaming_attention)

__all__ = ["lut_exp", "lut_exp_ref",
           "streaming_attention", "attention_ref",
           "paged_attention", "paged_attention_reference",
           "int8_matmul", "int8_matmul_ref"]
