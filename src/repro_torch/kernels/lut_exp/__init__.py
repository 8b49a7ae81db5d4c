from repro_torch.kernels.lut_exp.ops import device_table, lut_exp
from repro_torch.kernels.lut_exp.ref import lut_exp_ref

__all__ = ["lut_exp", "lut_exp_ref", "device_table"]
