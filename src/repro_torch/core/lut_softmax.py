"""Softmax helpers shared by the attention references (port of
``src/repro/core/lut_softmax.py``: the mask value and logit soft-capping)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite mask value: keeps (x - max) well-defined everywhere


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
