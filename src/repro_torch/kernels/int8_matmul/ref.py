"""Plain PyTorch version of the int8 matmul kernel, in the kernel's order
(the reference's Pallas kernel, ``src/repro/kernels/int8_matmul/kernel.py``):
the exact int32 accumulator, then ``acc·(x_scale·w_scale)``.  The reference
core (``core.quant.int8_matmul``) applies ``(acc·x_scale)·w_scale`` instead;
the two orders land within two f32 ulps of each other."""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor, int8_accumulate, quantize_dynamic


def int8_matmul_2d_ref(xv: torch.Tensor, wv: torch.Tensor,
                       x_scale: torch.Tensor, w_scale: torch.Tensor, *,
                       with_acc: bool = False):
    """int8 (M, K) × int8 (K, N) → f32 (M, N), scales applied.
    x_scale: one f32 (per tensor); w_scale: (1, N) f32 (per channel).
    ``with_acc`` also returns the int32 accumulator."""
    acc = int8_accumulate(xv, wv)
    scale = x_scale.reshape(1, 1) * w_scale.reshape(1, -1)
    out = acc.to(torch.float32) * scale
    return (out, acc) if with_acc else out


def int8_matmul_ref(x: torch.Tensor, wq: QTensor) -> torch.Tensor:
    """x (…, K) float × wq (K, N) QTensor → (…, N) f32."""
    *lead, k = x.shape
    xq = quantize_dynamic(x)
    out = int8_matmul_2d_ref(xq.values.reshape(-1, k), wq.values, xq.scale,
                             wq.scale)
    return out.reshape(*lead, wq.values.shape[1])
