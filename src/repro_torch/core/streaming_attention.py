"""KV-row quantisation for int8 page pools (port of
``src/repro/core/streaming_attention.py::quantize_kv_rows``)."""
from __future__ import annotations

import torch


def quantize_kv_rows(x: torch.Tensor):
    """(B, H, L, D) float → (int8 values, (B, H, L) f32 per-row scales).

    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
    values match the reference bit for bit."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1)
    s = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -128, 127).to(torch.int8)
    return q, s
