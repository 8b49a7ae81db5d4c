"""Plain PyTorch version of the LUT-exp kernel and of its backward: the
shared core math."""
from __future__ import annotations

import torch

from repro_torch.core.lut_exp import (K, LN2, LOG2E, UNDERFLOW_X, decompose,
                                      make_table, pow2_int)
from repro_torch.core.lut_exp import lut_exp as _core_lut_exp


def lut_exp_ref(x: torch.Tensor, *, order: int = 1) -> torch.Tensor:
    """e^x computed in f32, returned in ``x.dtype`` (the kernel's contract)."""
    return _core_lut_exp(x, order=order)


def lut_exp_bwd_ref(x: torch.Tensor, g: torch.Tensor, *,
                    order: int = 1) -> torch.Tensor:
    """The gradient of ``lut_exp_ref(x, order=order)`` for the incoming
    gradient ``g``, in ``x.dtype``: the closed form that autograd of the
    plain version reduces to, one rounded f32 operation per step —
    ``gx = ((((g·A)·ln2/K) + 0)·K)·log2e`` with ``A = 2^n·T[d]``: the
    floors carry no gradient, but autograd adds their zeros where the
    paths join, so a product that underflowed to −0 becomes +0; 0 where
    ``x < UNDERFLOW_X``; a bf16 ``g`` is widened first and ``gx`` rounded
    once.  At order 0 the function is piecewise constant: zeros, as
    ``jax.grad`` gives."""
    if order == 0:
        return torch.zeros_like(x)
    xf = x.to(torch.float32)
    n, d, _ = decompose(xf, K)
    a = pow2_int(n) * make_table(K, device=x.device)[d.long()]
    gx = ((g.to(torch.float32) * a) * (LN2 / K) + 0.0) * K * LOG2E
    gx = torch.where(xf < UNDERFLOW_X, torch.zeros_like(gx), gx)
    return gx.to(x.dtype)
