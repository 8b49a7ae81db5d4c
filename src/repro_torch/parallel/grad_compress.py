"""Gradient compression with error feedback for the data-parallel
all-reduce (port of ``src/repro/parallel/grad_compress.py``).

Casting gradients to bf16 *before* the reduction halves the bytes on the
wire; the quantisation error is carried in a per-leaf f32 residual and
re-injected next step (error feedback), so the *accumulated* update is
unbiased (Karimireddy et al., 2019).  The trees are the port's flat
``{key: tensor}`` dicts.

Two entry points, as in the reference: ``compress_with_feedback`` (the
transform the trainer applies to each rank's block of the gradient) and
``compressed_psum`` (the explicit bf16-on-the-wire sum over a mesh axis,
for code that owns its collectives).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.parallel.collectives import all_gather

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


def compressed_psum(tree: Params, axis) -> Params:
    """The sum over ``axis`` (a ``MeshAxis`` or process group) of each
    leaf cast to bf16, widened to f32: bf16 on the wire.  The bf16 leaves
    travel in an all-gather and are summed in f32 in rank order, then
    rounded to bf16 once, as the reference's bf16 ``psum`` computes it on
    XLA's CPU backend (gloo's own bf16 all-reduce rounds its partial sums
    to bf16, which moves the result's last bit at 3 or more ranks)."""
    out = {}
    for k, g in tree.items():
        parts = all_gather(g.to(torch.bfloat16)[None], axis, dim=0)
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        out[k] = acc.to(torch.bfloat16).float()
    return out
