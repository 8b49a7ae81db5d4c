"""Plain PyTorch version of the LUT-exp kernel: the shared core math."""
from __future__ import annotations

import torch

from repro_torch.core.lut_exp import lut_exp as _core_lut_exp


def lut_exp_ref(x: torch.Tensor, *, order: int = 1) -> torch.Tensor:
    """e^x computed in f32, returned in ``x.dtype`` (the kernel's contract)."""
    return _core_lut_exp(x, order=order)
