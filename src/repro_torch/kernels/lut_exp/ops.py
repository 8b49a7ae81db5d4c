"""Public wrapper of the LUT-exp kernel (``csrc/lut_exp.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``lut_exp.launches`` counts kernel launches.

Under autograd (an input that requires a gradient, gradients enabled) the
call is one ``torch.autograd.Function`` (``_LutExp``): it saves ``x``, and
its backward is ``lut_exp_bwd`` — the backward kernel on the card
(``lut_exp_bwd_kernel``, counted in ``lut_exp.bwd_launches``), the plain
backward (``ref.py::lut_exp_bwd_ref``) on the CPU.  At order 0 the LUT is
piecewise constant and the backward returns zeros without a launch, as
``jax.grad`` gives them (a leaf that reaches the loss only through the
LUT, Mamba's ``A_log``, still gets its zero gradient).  Without a gradient
the call is the plain launch and builds no autograd node (serving,
captured steps).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.lut_exp import make_table
from repro_torch.kernels import build
from repro_torch.kernels.lut_exp.ref import lut_exp_bwd_ref, lut_exp_ref

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
    bwd = lib.lut_exp_bwd_launch
    bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib


def _check_cuda(x: torch.Tensor, order: int) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"lut_exp kernel takes float32 or bfloat16, got {x.dtype}")
    if order not in (0, 1):
        raise ValueError(f"lut_exp order must be 0 or 1, got {order}")
    if not x.is_contiguous():
        raise ValueError("lut_exp kernel needs a contiguous input")


def _launch(x: torch.Tensor, order: int) -> torch.Tensor:
    lib = _library()
    out = torch.empty_like(x)
    err = lib.lut_exp_launch(
        x.data_ptr(), out.data_ptr(), device_table(x.device).data_ptr(),
        x.numel(), _DTYPES[x.dtype], order, build.stream(x.device))
    build.check(lib, err, "lut_exp launch")
    lut_exp.launches += 1
    return out


class _LutExp(torch.autograd.Function):
    """The kernel under autograd (the plain versions of ``ref.py`` on the
    CPU)."""

    @staticmethod
    def forward(ctx, x, order):
        ctx.save_for_backward(x)
        ctx.order = order
        if x.device.type == "cpu":
            return lut_exp_ref(x, order=order)
        return _launch(x, order)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return lut_exp_bwd(x, g, order=ctx.order), None


def lut_exp_bwd(x: torch.Tensor, g: torch.Tensor, *,
                order: int = 1) -> torch.Tensor:
    """The gradient of ``lut_exp(x, order=order)`` for the incoming
    gradient ``g`` (``x``'s shape), in ``x.dtype``: the backward kernel on
    the card (order 1; order 0 is zeros without a launch), the plain
    backward (``lut_exp_bwd_ref``) on the CPU."""
    if x.device.type == "cpu":
        return lut_exp_bwd_ref(x, g, order=order)
    if x.device.type != "cuda":
        raise ValueError(f"lut_exp_bwd: unsupported device {x.device}")
    _check_cuda(x, order)
    if g.device != x.device or g.shape != x.shape:
        raise ValueError(f"lut_exp_bwd: g {tuple(g.shape)} on {g.device} "
                         f"must be x's {tuple(x.shape)} on {x.device}")
    if order == 0:
        return torch.zeros_like(x)
    return _launch_bwd(x, g.to(x.dtype).contiguous())


def _launch_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    lib = _library()
    gx = torch.empty_like(x)
    err = lib.lut_exp_bwd_launch(
        x.data_ptr(), g.data_ptr(), gx.data_ptr(),
        device_table(x.device).data_ptr(), x.numel(), _DTYPES[x.dtype],
        build.stream(x.device))
    build.check(lib, err, "lut_exp_bwd launch")
    lut_exp.bwd_launches += 1
    return gx


def lut_exp(x: torch.Tensor, *, order: int = 1) -> torch.Tensor:
    """LUT e^x of any shape, in ``x.dtype`` (f32 or bf16); differentiable
    (``_LutExp``) where autograd needs a gradient through it."""
    grad = torch.is_grad_enabled() and x.requires_grad
    if x.device.type == "cpu":
        return _LutExp.apply(x, order) if grad else lut_exp_ref(x, order=order)
    if x.device.type != "cuda":
        raise ValueError(f"lut_exp: unsupported device {x.device}")
    _check_cuda(x, order)
    if grad:
        return _LutExp.apply(x, order)
    return _launch(x, order)


lut_exp.launches = 0
lut_exp.bwd_launches = 0
