"""Attention over a sequence split across ranks — the distributed form of
HASTILY §IV (port of ``src/repro/core/ring_attention.py``).

``ring_attention``: the KV sequence is split across a mesh axis; each
rank's KV block travels the ring, one hop a step, while its Q stays
resident.  This is the paper's fine-grained pipeline lifted one level:
the vector fed through the pipeline is a KV block travelling between
ranks, and the online max/sum rescale is the associative combine that
makes the row pipeline legal.

``distributed_decode_attention``: one new token attends to a KV cache
split over a mesh axis.  Each rank produces partial (m, Σexp, acc) and
the partials are combined by all-reduces — the paper's multi-core softmax
gather (§III-B2, Fig. 5), with ranks as cores.

``axis`` is a ``launch/mesh.py::MeshAxis`` or a process group.  Both
compute in f32 with plain tensor ops (the reference's are jnp, not a
Pallas kernel); the exponential of ``exp_mode`` "lut" / "lut0" is the
port's ``lut_exp`` wrapper — kernel #1 on a CUDA tensor.  A hop of the
ring is ``parallel/collectives.py::exchange``: gloo's point-to-point
takes CPU tensors only, so a CUDA block travels through a host copy.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.lut_softmax import NEG_INF, softcap
from repro_torch.core.streaming_attention import _split_heads
from repro_torch.kernels.lut_exp.ops import lut_exp
from repro_torch.parallel.collectives import (all_reduce, axis_index,
                                              axis_size, exchange)


def _exp_fn(exp_mode: str):
    """The exponential of ``exp_mode`` on shifted logits (x ≤ 0)."""
    if exp_mode == "exact":
        return torch.exp
    if exp_mode not in ("lut", "lut0"):
        raise ValueError(f"exp_mode must be lut, lut0 or exact, got "
                         f"{exp_mode!r}")
    order = 1 if exp_mode == "lut" else 0
    return lambda x: lut_exp(x.contiguous(), order=order)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis,
                   *, scale: Optional[float] = None, causal: bool = False,
                   window: Optional[int] = None, cap: Optional[float] = None,
                   exp_mode: str = "lut") -> torch.Tensor:
    """Ring attention over a sequence-split KV.  Shapes are per rank:

    q: (B, Hq, Lq_loc, D), k/v: (B, Hkv, Lkv_loc, D).  Rank i owns global
    rows [i·Lq_loc, (i+1)·Lq_loc).  Returns the local (B, Hq, Lq_loc, D)
    output in q's dtype.  Step r attends to the block rank i − r owns,
    masked by global positions; n steps, n − 1 hops."""
    n = axis_size(axis)
    idx = axis_index(axis)
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    exp = _exp_fn(exp_mode)
    dev = q.device
    qg = _split_heads(q.float(), hkv)
    q_pos = idx * lq + torch.arange(lq, dtype=torch.int32, device=dev)
    m = torch.full(qg.shape[:-1], NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    k_blk, v_blk = k.float(), v.float()
    for r in range(n):
        src = (idx - r) % n      # original owner of the block now resident
        kv_pos = src * lkv + torch.arange(lkv, dtype=torch.int32, device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_blk) * scale
        s = softcap(s, cap)
        mask = torch.ones((lq, lkv), dtype=torch.bool, device=dev)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= (q_pos[:, None] - kv_pos[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.where(mask, exp(s - m_new[..., None]), 0.0)
        alpha = exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, v_blk)
        m = m_new
        if r + 1 < n:            # pass the block one hop along the ring
            k_blk = exchange(k_blk, axis, send_to=(idx + 1) % n,
                             recv_from=(idx - 1) % n)
            v_blk = exchange(v_blk, axis, send_to=(idx + 1) % n,
                             recv_from=(idx - 1) % n)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, lq, d).to(q.dtype)


def distributed_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, axis, *,
                                 kv_len: Union[int, torch.Tensor],
                                 scale: Optional[float] = None,
                                 window: Optional[int] = None,
                                 cap: Optional[float] = None,
                                 exp_mode: str = "lut") -> torch.Tensor:
    """One-token decode against a sequence-split KV cache (paper Fig. 5).

    q: (B, Hq, 1, D), the same on every rank; caches (B, Hkv, Lloc, D),
    rank i holding rows [i·Lloc, (i+1)·Lloc).  ``kv_len`` is the *global*
    number of valid cache rows.  Returns the (B, Hq, 1, D) output, the
    same on every rank."""
    idx = axis_index(axis)
    b, hq, lq, d = q.shape
    hkv, lloc = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    exp = _exp_fn(exp_mode)
    dev = q.device
    qg = _split_heads(q.float(), hkv)
    kv_pos = idx * lloc + torch.arange(lloc, dtype=torch.int32, device=dev)
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=dev)
    q_pos = kv_len - 1           # the new token's absolute position

    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_cache.float()) * scale
    s = softcap(s, cap)
    mask = kv_pos < kv_len
    if window is not None:
        mask &= (q_pos - kv_pos) < window
    s = torch.where(mask, s, NEG_INF)

    # --- the multi-core softmax: local partials + the gather across ranks
    m_loc = torch.amax(s, dim=-1)
    m = all_reduce(m_loc, "max", axis)
    p = torch.where(mask, exp(s - m[..., None]), 0.0)
    l_loc = torch.sum(p, dim=-1)
    acc_loc = torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache.float())
    l = all_reduce(l_loc, "sum", axis)
    acc = all_reduce(acc_loc, "sum", axis)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, lq, d).to(q.dtype)
