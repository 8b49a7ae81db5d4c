"""Gradient compression with error feedback for the data-parallel
all-reduce (port of ``src/repro/parallel/grad_compress.py``).

Casting gradients to bf16 *before* the reduction halves the bytes on the
wire; the quantisation error is carried in a per-leaf f32 residual and
re-injected next step (error feedback), so the *accumulated* update is
unbiased (Karimireddy et al., 2019).  The trees are the port's flat
``{key: tensor}`` dicts.  ``compressed_psum``, the explicit collective,
comes with the training half of tensor parallelism (ROADMAP.md §1 item
5).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def feedback_init(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_with_feedback(grads: Params, residual: Params
                           ) -> Tuple[Params, Params]:
    """→ (bf16 gradients to reduce, new residual): residual' = (g +
    residual) − bf16(g + residual), the low-order bits lost to the cast
    replayed into the next step instead of discarded."""
    sent, new_r = {}, {}
    for k, g in grads.items():
        corrected = g.float() + residual[k]
        sent[k] = corrected.to(torch.bfloat16)
        new_r[k] = corrected - sent[k].float()
    return sent, new_r


def decompress(grads: Params, like: Params) -> Params:
    return {k: g.float() for k, g in grads.items()}
