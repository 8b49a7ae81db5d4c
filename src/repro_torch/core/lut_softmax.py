"""Softmax built on the LUT exponential (port of
``src/repro/core/lut_softmax.py``): the mask value, logit soft-capping, the
masked five-step softmax of paper §III-B, and the exponential each
``exp_mode`` names."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.lut_exp import lut_exp, make_table

NEG_INF = -1e30  # finite mask value: keeps (x - max) well-defined everywhere

ExpFn = Callable[[torch.Tensor], torch.Tensor]
EXP_MODES = ("lut", "lut0", "exact")


def exp_fn(exp_mode: str, device=None) -> ExpFn:
    """The exponential of ``exp_mode``: the LUT at order 1 (``lut``) or 0
    (``lut0``), or ``torch.exp`` (``exact``)."""
    if exp_mode == "exact":
        return torch.exp
    if exp_mode not in EXP_MODES:
        raise ValueError(f"exp_mode must be lut, lut0 or exact, got {exp_mode!r}")
    table = make_table(device=device)
    order = 1 if exp_mode == "lut" else 0
    return lambda x: lut_exp(x, order=order, table=table)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def lut_softmax(x: torch.Tensor, dim: int = -1, *,
                where: Optional[torch.Tensor] = None,
                exp: Optional[ExpFn] = None,
                cap: Optional[float] = None) -> torch.Tensor:
    """softmax(x) with the LUT exponent (``exp``, default ``exp_fn("lut")``);
    ``where`` False positions get probability 0, and a fully masked row is
    all zeros."""
    exp = exp or exp_fn("lut", x.device)
    x = softcap(x, cap)
    if where is not None:
        x = torch.where(where, x, NEG_INF)
    m = torch.amax(x, dim=dim, keepdim=True)
    # Fully masked rows: max == NEG_INF → shift to 0 to avoid inf - inf.
    m = torch.where(m <= NEG_INF, 0.0, m)
    e = exp(x - m)
    if where is not None:
        e = torch.where(where, e, 0.0)
    s = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.clamp(s, min=1e-30)
