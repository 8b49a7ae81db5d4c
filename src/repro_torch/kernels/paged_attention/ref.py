"""Plain PyTorch paged attention (port of
``src/repro/kernels/paged_attention/ref.py``): the CPU path, and the version
the CUDA kernel is held against on the card.

Each lane's query rows attend its KV pages in place in the pool, walking
the page table ``block_pages`` pages at a time with an online-softmax
(max, sum, accumulator) combine.  Query row ``i`` of a lane sits at
position ``kv_len - Lq + i`` and sees pool rows up to that position (decode
is ``Lq == 1``); an optional window and logit softcap apply per row.  Int8
pools dequantise with per-row scales, per block or per page (``dequant``,
numerically identical).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lut_softmax import NEG_INF, exp_fn, softcap


def default_block_pages(page_size: int, block_k: int = 128) -> int:
    """Pages per scan step so one block is ~``block_k`` KV rows."""
    return max(1, block_k // max(page_size, 1))


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              kv_len, *, scale: Optional[float] = None,
                              cap: Optional[float] = None,
                              window: Optional[int] = None,
                              exp_mode: str = "lut",
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              block_pages: Optional[int] = None,
                              dequant: str = "block") -> torch.Tensor:
    """q (B, Hq, Lq, D); pools (N, Hkv, ps, D); page_table (B, P) int32;
    kv_len (B,) live rows per lane including the query chunk; optional
    int8 scales (N, Hkv, ps) f32.  → (B, Hq, Lq, D) in q's dtype."""
    if dequant not in ("block", "page"):
        raise ValueError(f"dequant must be 'block' or 'page', got {dequant!r}")
    b, hq, lq, d = q.shape
    _, hkv, ps, dv = v_pool.shape
    assert hq % hkv == 0, f"GQA requires Hq % Hkv == 0, got {hq} % {hkv}"
    g = hq // hkv
    p = page_table.shape[1]
    if scale is None:
        scale = d ** -0.5
    exp = exp_fn(exp_mode, q.device)
    dev = q.device

    bp = min(block_pages or default_block_pages(ps), p)
    nb = -(-p // bp)
    pad = nb * bp - p
    # Padded table slots index page 0 harmlessly: their structural rows are
    # >= P·ps >= kv_len for every lane, so the length mask drops them.
    tbl = F.pad(page_table, (0, pad)) if pad else page_table
    tbl = tbl.long()
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=dev)
    kv_len = torch.broadcast_to(kv_len, (b,))
    q_pos = kv_len[:, None] - lq + torch.arange(lq, dtype=torch.int32,
                                                device=dev)[None, :]
    qg = q.to(torch.float32).reshape(b, hkv, g, lq, d)

    def gather_block(pool, ids):
        blk = pool[ids].movedim(1, 2)                 # (B, Hkv, bp, ...)
        s = blk.shape
        return blk.reshape(s[:2] + (bp * ps,) + s[4:])

    m = torch.full((b, hkv, g, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, lq, dv), dtype=torch.float32, device=dev)
    for j in range(nb):
        ids = tbl[:, j * bp:(j + 1) * bp]                           # (B, bp)
        k_blk = gather_block(k_pool, ids).to(torch.float32)
        v_blk = gather_block(v_pool, ids).to(torch.float32)
        if k_scale is not None:
            ks = gather_block(k_scale, ids)                        # (B, Hkv, bp·ps)
            vs = gather_block(v_scale, ids)
            if dequant == "page":
                k_blk = torch.cat(
                    [k_blk[..., i * ps:(i + 1) * ps, :]
                     * ks[..., i * ps:(i + 1) * ps, None]
                     for i in range(bp)], dim=-2)
                v_blk = torch.cat(
                    [v_blk[..., i * ps:(i + 1) * ps, :]
                     * vs[..., i * ps:(i + 1) * ps, None]
                     for i in range(bp)], dim=-2)
            else:
                k_blk = k_blk * ks[..., None]
                v_blk = v_blk * vs[..., None]
        row = j * bp * ps + torch.arange(bp * ps, dtype=torch.int32, device=dev)
        mask = row[None, None, :] <= q_pos[:, :, None]             # (B, Lq, bk)
        if window is not None:
            mask &= (q_pos[:, :, None] - row[None, None, :]) < window
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_blk) * scale
        s = softcap(s, cap)
        mk = mask[:, None, None]
        s = torch.where(mk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        pw = torch.where(mk, exp(s - m_new[..., None]), 0.0)
        alpha = exp(m - m_new)
        l = l * alpha + pw.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd",
                                                    pw, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, lq, dv).to(q.dtype)
