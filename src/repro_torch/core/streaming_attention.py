"""Streaming attention in plain PyTorch (port of
``src/repro/core/streaming_attention.py``, HASTILY §IV).

``streaming_attention`` is the forward of the reference's online-softmax
scan: it walks the KV sequence ``block_k`` rows at a time, carrying the
running (max m, denominator l, weighted accumulator), so the ``l×l`` logits
never exist.  ``naive_attention`` materialises the logits (the "PUMA"
baseline and the correctness oracle).  Both compute in f32, take GQA
through the ``(B, Hkv, G, Lq, D)`` grouped layout, and return q's dtype.
Autograd runs through them as through any torch code; the reference's
custom flash backward and the quantized scan come with later slices.

``quantize_kv_rows`` is the int8 KV-row quantiser of the page pools.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.lut_softmax import NEG_INF, exp_fn, lut_softmax, softcap

IntLike = Union[int, torch.Tensor]


def _split_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, Lq, D) → (B, Hkv, G, Lq, D) grouped-query layout."""
    b, hq, lq, d = q.shape
    assert hq % n_kv == 0, f"GQA requires Hq % Hkv == 0, got {hq} % {n_kv}"
    return q.reshape(b, n_kv, hq // n_kv, lq, d)


def _positions(q_offset: IntLike, lq: int, device) -> torch.Tensor:
    return (torch.as_tensor(q_offset, dtype=torch.int32, device=device)
            + torch.arange(lq, dtype=torch.int32, device=device))


def _block_mask(causal: bool, window: Optional[int], q_pos: torch.Tensor,
                kv_idx: torch.Tensor, kv_pos: torch.Tensor,
                kv_len) -> torch.Tensor:
    """Boolean (Bp, 1, 1, Lq, bk) mask for one KV block.

    ``kv_idx`` (bk,) is the structural slot index (bounds the valid prefix
    via ``kv_len``); ``kv_pos`` (Bp, bk) is each slot's absolute position
    (negative = never written)."""
    qp = q_pos[None, :, None]              # (1, Lq, 1)
    kp = kv_pos[:, None, :]                # (Bp, 1, bk)
    m = (kp >= 0) & (kv_idx[None, None, :] < kv_len)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & ((qp - kp) < window)
    return m[:, None, None]                # (Bp, 1, 1, Lq, bk)


def _blocked_kv(x: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H, L, D) → (nb, B, H, block, D), padding L up to a block multiple."""
    b, h, l, d = x.shape
    nb = -(-l // block)
    x = F.pad(x, (0, 0, 0, nb * block - l))
    return x.reshape(b, h, nb, block, d).movedim(2, 0)


def _blocked_pos(p: torch.Tensor, block: int) -> torch.Tensor:
    """(Bp, L) int32 → (nb, Bp, block), padding with -1 (= invalid slot)."""
    bp, l = p.shape
    nb = -(-l // block)
    p = F.pad(p, (0, nb * block - l), value=-1)
    return p.reshape(bp, nb, block).movedim(1, 0)


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None, causal: bool = False,
                        window: Optional[int] = None,
                        cap: Optional[float] = None, block_k: int = 512,
                        exp_mode: str = "lut", q_offset: IntLike = 0,
                        kv_len: Optional[IntLike] = None,
                        kv_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HASTILY streaming attention, the online-softmax scan.

    q (B, Hq, Lq, D); k, v (B, Hkv, Lkv, D) with Hq % Hkv == 0.
    ``q_offset`` is the absolute position of row 0, ``kv_len`` masks a
    partly filled cache, ``kv_pos`` (B, Lkv) gives explicit slot positions
    (-1 = never written).  → (B, Hq, Lq, D) in q's dtype.
    """
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    bk = min(block_k, max(lkv, 1))
    dev = q.device
    qg = _split_heads(q.float(), hkv)
    q_pos = _positions(q_offset, lq, dev)
    kv_len = lkv if kv_len is None else kv_len
    if kv_pos is None:
        kv_pos = torch.arange(lkv, dtype=torch.int32, device=dev)[None, :]
    kb, vb = _blocked_kv(k, bk), _blocked_kv(v, bk)
    pb = _blocked_pos(kv_pos.to(torch.int32), bk)
    exp = exp_fn(exp_mode, dev)
    g = hq // hkv
    m = torch.full((b, hkv, g, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, lq, v.shape[-1]), dtype=torch.float32,
                      device=dev)
    for j in range(kb.shape[0]):
        kv_idx = j * bk + torch.arange(bk, dtype=torch.int32, device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb[j].float()) * scale
        s = softcap(s, cap)
        mask = _block_mask(causal, window, q_pos, kv_idx, pb[j], kv_len)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.where(mask, exp(s - m_new[..., None]), 0.0)
        alpha = exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, vb[j].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, lq, -1).to(q.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = False,
                    window: Optional[int] = None, cap: Optional[float] = None,
                    exp_mode: str = "exact", q_offset: IntLike = 0,
                    kv_len: Optional[IntLike] = None,
                    kv_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Materialised-logits baseline (the "PUMA" dataflow): O(l²) memory.
    The correctness oracle every other attention path is held against."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qg = _split_heads(q.float(), hkv)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    q_pos = _positions(q_offset, lq, dev)
    kv_idx = torch.arange(lkv, dtype=torch.int32, device=dev)
    if kv_pos is None:
        kv_pos = kv_idx[None, :]
    mask = _block_mask(causal, window, q_pos, kv_idx, kv_pos.to(torch.int32),
                       lkv if kv_len is None else kv_len)
    p = lut_softmax(s, where=mask, exp=exp_fn(exp_mode, dev), cap=cap)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, lq, -1).to(q.dtype)


def quantize_kv_rows(x: torch.Tensor):
    """(B, H, L, D) float → (int8 values, (B, H, L) f32 per-row scales).

    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
    values match the reference bit for bit."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1)
    s = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -128, 127).to(torch.int8)
    return q, s
