"""Plain PyTorch version of the streaming-attention kernel (port of
``src/repro/kernels/streaming_attention/ref.py``): the materialised-logits
baseline of ``repro_torch.core``, so kernel↔plain agreement also certifies
the kernel against the model code."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.streaming_attention import naive_attention


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: Optional[float] = None, causal: bool = False,
                  window: Optional[int] = None, cap: Optional[float] = None,
                  exp_mode: str = "lut", q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """(B, Hq, Lq, D) × (B, Hkv, Lkv, D) → (B, Hq, Lq, D)."""
    return naive_attention(q, k, v, scale=scale, causal=causal, window=window,
                           cap=cap, exp_mode=exp_mode, q_offset=q_offset,
                           kv_len=kv_len)
