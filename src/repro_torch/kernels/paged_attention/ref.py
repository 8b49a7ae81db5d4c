"""Plain PyTorch paged attention (port of
``src/repro/kernels/paged_attention/ref.py``): the CPU path, and the version
the CUDA kernel is held against on the card.

Each lane's query rows attend its KV pages in place in the pool, walking
the page table ``block_pages`` pages at a time with an online-softmax
(max, sum, accumulator) combine.  Query row ``i`` of a lane sits at
position ``kv_len - Lq + i`` and sees pool rows up to that position (decode
is ``Lq == 1``); an optional window and logit softcap apply per row.  Int8
pools dequantise with per-row scales, per block or per page (``dequant``,
numerically identical).  With ``kv_split`` the table is cut into ranges
of that many pages, each scanned from a fresh start, and the ranges'
partials are merged as the CUDA kernel's split-KV pass and its combine do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lut_softmax import NEG_INF, exp_fn, softcap


def default_block_pages(page_size: int, block_k: int = 128) -> int:
    """Pages per scan step so one block is ~``block_k`` KV rows."""
    return max(1, block_k // max(page_size, 1))


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     exp) -> torch.Tensor:
    """Merge per-split online-softmax partials: the paper's reduce-and-gather
    (local maxima and exp-sums, then one global reduction).

    m, l (S, ...) and acc (S, ..., D), f32, split s's running max, sum and
    unnormalised accumulator; ``exp`` the softmax's exponential.  With M the
    max over splits and w_s = exp(m_s − M), → Σ w_s·acc_s / max(Σ w_s·l_s,
    1e-30).  A split that saw no key (m = NEG_INF, l = 0, acc = 0) adds
    nothing; one split gives acc / max(l, 1e-30) exactly (exp(0) = 1)."""
    mx = m.amax(dim=0)
    w = exp(m - mx)
    num = (w[..., None] * acc).sum(dim=0)
    den = (w * l).sum(dim=0)
    return num / torch.clamp(den, min=1e-30)[..., None]


def paged_combine_reference(part_m: torch.Tensor, part_l: torch.Tensor,
                            part_acc: torch.Tensor, kv_len, *, page_size: int,
                            kv_split: int, exp_mode: str = "lut"
                            ) -> torch.Tensor:
    """The combine pass of the CUDA kernel, plain: partials (B, Hkv, S, R)
    and (B, Hkv, S, R, D) → (B, Hkv, R, D) f32.  Lane b's live splits are
    the first ⌈⌈kv_len[b] / page_size⌉ / kv_split⌉; the others (a
    workspace the split pass never wrote) are read as splits that saw no
    key."""
    dev = part_m.device
    s = part_m.shape[2]
    kv_len = torch.as_tensor(kv_len, dtype=torch.int64, device=dev)
    pages = torch.clamp(kv_len, min=0) + page_size - 1
    live_n = (torch.div(pages, page_size, rounding_mode="floor")
              + kv_split - 1) // kv_split
    live = (torch.arange(s, device=dev)[None, :] < live_n[:, None])
    live = live[:, None, :, None]                              # (B, 1, S, 1)
    m = torch.where(live, part_m, NEG_INF).movedim(2, 0)
    l = torch.where(live, part_l, 0.0).movedim(2, 0)
    acc = torch.where(live[..., None], part_acc, 0.0).movedim(2, 0)
    return combine_partials(m, l, acc, exp_fn(exp_mode, dev))


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              kv_len, *, scale: Optional[float] = None,
                              cap: Optional[float] = None,
                              window: Optional[int] = None,
                              exp_mode: str = "lut",
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              block_pages: Optional[int] = None,
                              dequant: str = "block",
                              kv_split: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, Lq, D); pools (N, Hkv, ps, D); page_table (B, P) int32;
    kv_len (B,) live rows per lane including the query chunk; optional
    int8 scales (N, Hkv, ps) f32.  → (B, Hq, Lq, D) in q's dtype.

    ``kv_split`` (pages): each range of that many table slots is scanned
    from a fresh (max, sum, accumulator), and the ranges are merged by
    :func:`combine_partials` (split-KV, as the CUDA kernel computes it).
    ``None`` scans the whole table as one range and divides directly."""
    if dequant not in ("block", "page"):
        raise ValueError(f"dequant must be 'block' or 'page', got {dequant!r}")
    if kv_split is not None and kv_split < 1:
        raise ValueError(f"kv_split must be >= 1 page, got {kv_split}")
    b, hq, lq, d = q.shape
    hkv = v_pool.shape[1]
    assert hq % hkv == 0, f"GQA requires Hq % Hkv == 0, got {hq} % {hkv}"
    g = hq // hkv
    p = page_table.shape[1]
    if scale is None:
        scale = d ** -0.5
    exp = exp_fn(exp_mode, q.device)
    dev = q.device
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=dev)
    kv_len = torch.broadcast_to(kv_len, (b,))
    q_pos = kv_len[:, None] - lq + torch.arange(lq, dtype=torch.int32,
                                                device=dev)[None, :]
    qg = q.to(torch.float32).reshape(b, hkv, g, lq, d)
    scan = dict(scale=scale, cap=cap, window=window, exp=exp, k_scale=k_scale,
                v_scale=v_scale, block_pages=block_pages, dequant=dequant)
    if kv_split is None:
        m, l, acc = _scan(qg, k_pool, v_pool, page_table, 0, q_pos, **scan)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
    else:
        parts = [_scan(qg, k_pool, v_pool, page_table[:, s0:s0 + kv_split],
                       s0, q_pos, **scan) for s0 in range(0, p, kv_split)]
        out = combine_partials(*(torch.stack(t) for t in zip(*parts)), exp)
    return out.reshape(b, hq, lq, -1).to(q.dtype)


def _scan(qg, k_pool, v_pool, page_table, slot0, q_pos, *, scale, cap,
          window, exp, k_scale, v_scale, block_pages, dequant):
    """The online-softmax page-block scan over table slots ``slot0 ..
    slot0 + P'`` (``page_table`` holds those P' columns) → (m, l, acc), f32,
    from a fresh start."""
    b, hkv, g, lq, d = qg.shape
    _, _, ps, dv = v_pool.shape
    p = page_table.shape[1]
    dev = qg.device
    bp = min(block_pages or default_block_pages(ps), p)
    nb = -(-p // bp)
    pad = nb * bp - p
    # Padded table slots index page 0 harmlessly: their structural rows lie
    # at or past the range's end, which the mask drops.
    tbl = F.pad(page_table, (0, pad)) if pad else page_table
    tbl = tbl.long()
    col0, col_end = slot0 * ps, (slot0 + p) * ps

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
        row = col0 + j * bp * ps + torch.arange(bp * ps, dtype=torch.int32,
                                                device=dev)
        mask = ((row[None, None, :] <= q_pos[:, :, None])
                & (row < col_end)[None, None, :])                  # (B, Lq, bk)
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
    return m, l, acc
