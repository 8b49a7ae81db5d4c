"""Streaming attention in plain PyTorch (port of
``src/repro/core/streaming_attention.py``, HASTILY §IV).

``streaming_attention`` is the forward of the reference's online-softmax
scan: it walks the KV sequence ``block_k`` rows at a time, carrying the
running (max m, denominator l, weighted accumulator), so the ``l×l`` logits
never exist.  ``naive_attention`` materialises the logits (the "PUMA"
baseline and the correctness oracle).  Both compute in f32, take GQA
through the ``(B, Hkv, G, Lq, D)`` grouped layout, and return q's dtype.
Under autograd the scan is the reference's custom VJP
(``_StreamingAttention``, ``_fwd`` / ``_bwd``): the forward keeps ``out``
and the per-row logsumexp ``lse = m + log(max(l, 1e-30))``, and the
backward re-streams the KV blocks with ``p = exp(s_c − lse)`` through
the mode's exponential, so a LUT softmax differentiates as ``exp`` does
(autograd through the LUT itself would see its floors: at ``lut0`` a zero
gradient).  No (Lq, Lkv) tensor is kept between the passes.

``q_offset`` and ``kv_len`` are Python ints or (B,) tensors: one position
per batch row, as the slot engine's batched decode gives each slot its
own (the reference ``vmap``s a single-row step instead).  Ints stay on the
host, so a call inside a CUDA graph capture copies nothing to the card.

``streaming_attention_quantized`` is the scan over an int8 KV cache with
per-row scales, each block dequantised inside the loop (the reference's
jnp scan; no TPU kernel computes it), and ``quantize_kv_rows`` the int8
KV-row quantiser of the caches and page pools.
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
    """Row positions: (1, Lq) from an int offset, (B, Lq) from a (B,) one."""
    rows = torch.arange(lq, dtype=torch.int32, device=device)[None]
    if isinstance(q_offset, torch.Tensor):
        return q_offset.to(torch.int32).reshape(-1, 1) + rows
    return rows + int(q_offset)


def _per_row(x: IntLike):
    """A (B,) tensor → (B, 1, 1), broadcasting against (B, Lq, bk); an int
    or a 0-d tensor as it is."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.reshape(-1, 1, 1)
    return x


def _block_mask(causal: bool, window: Optional[int], q_pos: torch.Tensor,
                kv_idx: torch.Tensor, kv_pos: torch.Tensor,
                kv_len) -> torch.Tensor:
    """Boolean (Bp, 1, 1, Lq, bk) mask for one KV block.

    ``q_pos`` (1 or B, Lq) are the query rows' positions; ``kv_idx`` (bk,)
    is the structural slot index (bounds the valid prefix via ``kv_len``,
    an int or (B,)); ``kv_pos`` (1 or B, bk) is each slot's absolute
    position (negative = never written)."""
    qp = q_pos[:, :, None]                 # (1 or B, Lq, 1)
    kp = kv_pos[:, None, :]                # (Bp, 1, bk)
    m = (kp >= 0) & (kv_idx[None, None, :] < _per_row(kv_len))
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


def _fwd_scan(qg, kb, vb, pb, q_pos, kv_len, *, scale, causal, window, cap,
              exp_mode):
    """Online-softmax forward over the blocked K/V → (out, lse), f32, in
    the grouped layout."""
    b, hkv, g, lq, _ = qg.shape
    nb, bk = kb.shape[0], kb.shape[3]
    dev = qg.device
    exp = exp_fn(exp_mode, dev)
    m = torch.full((b, hkv, g, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, lq, vb.shape[-1]), dtype=torch.float32,
                      device=dev)
    for j in range(nb):
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
    l_safe = torch.clamp(l, min=1e-30)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def _bwd_scan(qg, kb, vb, pb, q_pos, kv_len, out, lse, dout, *, scale,
              causal, window, cap, exp_mode):
    """The reference's flash-style ``_bwd``: re-stream the KV blocks, with
    δ = rowsum(dO·O), the recomputed logits, ``p = exp(s_c − lse)``, the
    softcap's chain rule ``1 − (s_c/cap)²``, and per-block dK/dV →
    (dq, dk, dv), f32, dk/dv blocked."""
    nb, bk = kb.shape[0], kb.shape[3]
    dev = qg.device
    exp = exp_fn(exp_mode, dev)
    dout = dout.float()
    delta = torch.sum(dout * out, dim=-1)
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j in range(nb):
        kv_idx = j * bk + torch.arange(bk, dtype=torch.int32, device=dev)
        k_blk, v_blk = kb[j].float(), vb[j].float()
        s_c = softcap(torch.einsum("bhgqd,bhkd->bhgqk", qg, k_blk) * scale,
                      cap)
        mask = _block_mask(causal, window, q_pos, kv_idx, pb[j], kv_len)
        p = exp(torch.where(mask, s_c, NEG_INF) - lse[..., None])
        p = torch.where(mask, p, 0.0)
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, dout))
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dout, v_blk)
        ds = p * (dp - delta[..., None])
        if cap is not None:
            ds = ds * (1.0 - (s_c / cap) ** 2)
        ds = ds * scale                      # d(q·k)
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, k_blk)
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qg))
    return dq, torch.stack(dks), torch.stack(dvs)


class _StreamingAttention(torch.autograd.Function):
    """The scan with the reference's custom VJP: saves q, k, v, out and
    lse, never a (Lq, Lkv) tensor."""

    @staticmethod
    def forward(ctx, qg, k, v, pb, q_pos, kv_len, kw):
        bk = kw["block_k"]
        kb, vb = _blocked_kv(k, bk), _blocked_kv(v, bk)
        out, lse = _fwd_scan(qg, kb, vb, pb, q_pos, kv_len,
                             **_scan_kw(kw))
        ctx.save_for_backward(qg, k, v, pb, q_pos, out, lse)
        ctx.kv_len, ctx.kw = kv_len, kw
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, pb, q_pos, out, lse = ctx.saved_tensors
        bk, lkv = ctx.kw["block_k"], k.shape[2]
        kb, vb = _blocked_kv(k, bk), _blocked_kv(v, bk)
        dq, dkb, dvb = _bwd_scan(qg, kb, vb, pb, q_pos, ctx.kv_len, out, lse,
                                 dout, **_scan_kw(ctx.kw))

        def unblock(xb):                     # (nb, B, H, bk, D) → (B, H, L, D)
            x = xb.movedim(0, 2).flatten(2, 3)
            return x[:, :, :lkv]

        return (dq, unblock(dkb).to(k.dtype), unblock(dvb).to(v.dtype),
                None, None, None, None)


def _scan_kw(kw):
    return {n: kw[n] for n in ("scale", "causal", "window", "cap",
                               "exp_mode")}


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
    partly filled cache (each an int or (B,)), ``kv_pos`` (B, Lkv) gives
    explicit slot positions (-1 = never written).  → (B, Hq, Lq, D) in q's
    dtype.  Differentiable through the reference's custom VJP.
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
    pb = _blocked_pos(kv_pos.to(torch.int32), bk)
    kw = dict(scale=scale, causal=causal, window=window, cap=cap,
              exp_mode=exp_mode, block_k=bk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _StreamingAttention.apply(qg, k, v, pb, q_pos, kv_len, kw)
    else:
        out, _ = _fwd_scan(qg, _blocked_kv(k, bk), _blocked_kv(v, bk), pb,
                           q_pos, kv_len, **_scan_kw(kw))
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


def streaming_attention_quantized(q: torch.Tensor, kq: torch.Tensor,
                                  vq: torch.Tensor, k_scale: torch.Tensor,
                                  v_scale: torch.Tensor, *,
                                  scale: Optional[float] = None,
                                  causal: bool = True,
                                  window: Optional[int] = None,
                                  cap: Optional[float] = None,
                                  block_k: int = 512, exp_mode: str = "lut",
                                  q_offset: IntLike = 0,
                                  kv_len: Optional[IntLike] = None,
                                  kv_pos: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Streaming attention over an int8 KV cache (inference only; port of
    the reference's ``streaming_attention_quantized``).

    kq/vq (B, Hkv, Lkv, D) int8; k_scale/v_scale (B, Hkv, Lkv) f32 per-row
    scales.  Each KV block is dequantised inside the scan, so the f32
    transient is one block while the cache stays int8.  A single query row
    skips the scan, as the reference's does: its logits are O(L) already,
    and its weights are normalised after P·V (``out / Σp``), in the
    reference's order.  → (B, Hq, Lq, D) in q's dtype.
    """
    b, hq, lq, d = q.shape
    hkv, lkv = kq.shape[1], kq.shape[2]
    scale = d ** -0.5 if scale is None else scale
    bk = min(block_k, max(lkv, 1))
    dev = q.device
    qg = _split_heads(q.float(), hkv)
    q_pos = _positions(q_offset, lq, dev)
    kv_len = lkv if kv_len is None else kv_len
    if kv_pos is None:
        kv_pos = torch.arange(lkv, dtype=torch.int32, device=dev)[None, :]
    kv_pos = kv_pos.to(torch.int32)
    exp = exp_fn(exp_mode, dev)

    if lq == 1:
        kf = kq.float() * k_scale[..., None]
        vf = vq.float() * v_scale[..., None]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
        s = softcap(s, cap)
        kv_idx = torch.arange(lkv, dtype=torch.int32, device=dev)
        mask = _block_mask(causal, window, q_pos, kv_idx, kv_pos, kv_len)
        s = torch.where(mask, s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        m = torch.where(m <= NEG_INF, 0.0, m)
        p = torch.where(mask, exp(s - m), 0.0)
        out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        denom = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
        return (out / denom).reshape(b, hq, lq, d).to(q.dtype)

    kb, vb = _blocked_kv(kq, bk), _blocked_kv(vq, bk)
    ksb = _blocked_kv(k_scale[..., None], bk)
    vsb = _blocked_kv(v_scale[..., None], bk)
    pb = _blocked_pos(kv_pos, bk)
    g = hq // hkv
    m = torch.full((b, hkv, g, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, lq, d), dtype=torch.float32, device=dev)
    for j in range(kb.shape[0]):
        k_blk = kb[j].float() * ksb[j]
        v_blk = vb[j].float() * vsb[j]
        kv_idx = j * bk + torch.arange(bk, dtype=torch.int32, device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_blk) * scale
        s = softcap(s, cap)
        mask = _block_mask(causal, window, q_pos, kv_idx, pb[j], kv_len)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.where(mask, exp(s - m_new[..., None]), 0.0)
        alpha = exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, lq, d).to(q.dtype)


def quantize_kv_rows(x: torch.Tensor):
    """(B, H, L, D) float → (int8 values, (B, H, L) f32 per-row scales).

    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
    values match the reference bit for bit."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1)
    s = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -128, 127).to(torch.int8)
    return q, s
