"""Device resolution and matmul precision for the port's entry points.

Entry points run on the card unless the caller names the CPU.  There is no
silent fallback: asking for CUDA on a machine without a card raises.
``dense`` is the model's full-precision product, shared by the layers and
the INT8 dispatch point's full-precision branch.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a visible card raises.
    A CUDA device comes back with its index (``cuda`` → ``cuda:N`` of the
    current device), so it compares equal to its tensors' devices."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def configure_matmul_precision() -> None:
    """Full-precision products on the card.  The reference accumulates every
    projection in f32 (``preferred_element_type=f32``), so TF32 products and
    bf16 partial reductions — both of which round before the final sum —
    would break parity with it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated in f32, in ``x.dtype``.  On the card a same-dtype
    product goes to cuBLAS, which accumulates in f32 and rounds once
    (``configure_matmul_precision`` forbids reduced-precision reductions);
    elsewhere the operands are widened to f32 first."""
    if x.device.type == "cuda" and x.dtype == w.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)
