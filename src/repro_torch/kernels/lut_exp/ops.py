"""Public wrapper of the LUT-exp kernel (``csrc/lut_exp.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise — also when autograd would need a gradient through it (the kernel
has no backward yet).  ``lut_exp.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.lut_exp import make_table
from repro_torch.kernels import build
from repro_torch.kernels.lut_exp.ref import lut_exp_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_tables: Dict[torch.device, torch.Tensor] = {}


def device_table(device: torch.device) -> torch.Tensor:
    """The 128-entry table, resident on ``device`` (one copy per device)."""
    if device not in _tables:
        _tables[device] = make_table(device=device)
    return _tables[device]


def _library() -> ctypes.CDLL:
    lib = build.load("lut_exp")
    fn = lib.lut_exp_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def lut_exp(x: torch.Tensor, *, order: int = 1) -> torch.Tensor:
    """LUT e^x of any shape, in ``x.dtype`` (f32 or bf16)."""
    if x.device.type == "cpu":
        return lut_exp_ref(x, order=order)
    if x.device.type != "cuda":
        raise ValueError(f"lut_exp: unsupported device {x.device}")
    build.refuse_grad("lut_exp", x, why=" (the MoE router softmax and the "
                      "SSM discretisation train through it)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"lut_exp kernel takes float32 or bfloat16, got {x.dtype}")
    if order not in (0, 1):
        raise ValueError(f"lut_exp order must be 0 or 1, got {order}")
    if not x.is_contiguous():
        raise ValueError("lut_exp kernel needs a contiguous input")
    lib = _library()
    out = torch.empty_like(x)
    err = lib.lut_exp_launch(
        x.data_ptr(), out.data_ptr(), device_table(x.device).data_ptr(),
        x.numel(), _DTYPES[x.dtype], order,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "lut_exp launch")
    lut_exp.launches += 1
    return out


lut_exp.launches = 0
