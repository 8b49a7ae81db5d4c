"""Varlen (ragged) paged attention over one packed token stream (port of
``src/repro/kernels/paged_attention/varlen.py``).

    q            (T, Hq, D)   packed query rows, lane segments abutting
    token_pages  (T, P)       each token's own page-table row
    q_pos        (T,)         each token's absolute position = causal bound
    cu_seqlens   (S+1,)       lane boundaries; with ``block_q > 1`` they
                              drive the q-block tiling below

Untiled (batch = T): each token is a one-row lane with ``kv_len = q_pos+1``.
Tiled (``block_q = Bq > 1`` with ``cu_seqlens``): the stream is cut into
``NB = T//Bq + S`` blocks of up to Bq contiguous same-lane rows, each block
one lane of a chunked-prefill call whose page-table row is its lane's and
whose ``kv_len`` is ``q_pos[start] + Bq``; outputs scatter back through the
token→slot map.  Each KV page is then read once per q-block, not once per
token.  The layout, the regather and the scatter stay here in PyTorch; the
attention itself is the kernel's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_reference


def varlen_positions(cu_seqlens, seq_lens) -> np.ndarray:
    """Per-token absolute positions of a packed stream → (T,) int32: lane
    ``i`` holds positions ``seq_lens[i] - n_i .. seq_lens[i] - 1``."""
    cu = np.asarray(cu_seqlens, np.int64)
    lens = np.asarray(seq_lens, np.int64)
    pos = np.zeros((int(cu[-1]),), np.int32)
    for i in range(len(cu) - 1):
        n = int(cu[i + 1] - cu[i])
        pos[cu[i]:cu[i + 1]] = np.arange(lens[i] - n, lens[i], dtype=np.int32)
    return pos


def validate_cu_seqlens(cu_seqlens, t: int) -> torch.Tensor:
    """Validate lane boundaries against the stream width ``t`` → int32 tensor.

    Shape checks always apply.  Value checks (``cu[0] == 0``, non-decreasing,
    ``cu[-1] == t``) run on host values — a numpy array, a list or a CPU
    tensor — and raise ``ValueError``.  A CUDA tensor skips them rather than
    synchronise with the device: the engine validates the scheduler's host
    copy before the step.  Dead padding rows must be covered by a trailing
    pseudo-segment ending at ``t``.
    """
    on_card = torch.is_tensor(cu_seqlens) and cu_seqlens.device.type != "cpu"
    cu = torch.as_tensor(cu_seqlens).to(torch.int32)
    if cu.dim() != 1 or cu.shape[0] < 2:
        raise ValueError(
            f"cu_seqlens must be 1-D with >= 2 entries, got shape "
            f"{tuple(cu.shape)}")
    if not on_card:
        host = cu.numpy()
        if int(host[0]) != 0:
            raise ValueError(f"cu_seqlens must start at 0, got {host[0]}")
        if np.any(np.diff(host) < 0):
            raise ValueError(
                f"cu_seqlens must be non-decreasing, got {host.tolist()}")
        if int(host[-1]) != t:
            raise ValueError(
                f"cu_seqlens[-1] = {int(host[-1])} must equal the packed "
                f"stream width T = {t}; cover dead padding rows with a "
                f"trailing pseudo-segment instead of truncating")
    return cu


def q_block_layout(cu: torch.Tensor, q_pos: torch.Tensor, t: int, bq: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Cut the packed stream into q-blocks of ``bq`` same-lane rows →
    ``rows`` (NB, bq), ``start`` (NB,), ``kv_len`` (NB,) and ``slot`` (t,),
    all int32 on ``cu``'s device (see the reference for their meaning).
    Dead blocks have ``kv_len`` pinned to 1 and clamped rows."""
    dev = cu.device
    i32 = dict(dtype=torch.int32, device=dev)
    s = cu.shape[0] - 1
    nb = t // bq + s
    n = cu[1:] - cu[:-1]
    nbi = (n + bq - 1) // bq
    off = torch.cat([torch.zeros((1,), **i32),
                     torch.cumsum(nbi, 0).to(torch.int32)])
    blk = torch.arange(nb, **i32)
    lane = torch.clamp(torch.searchsorted(off, blk, right=True).to(torch.int32)
                       - 1, 0, s - 1).long()
    start = cu[lane] + (blk - off[lane]) * bq
    live = blk < off[-1]
    rows = start[:, None] + torch.arange(bq, **i32)[None, :]
    rows = torch.clamp(rows, 0, t - 1)
    start = torch.clamp(start, 0, t - 1)
    kv_len = torch.where(live, q_pos[start.long()].to(torch.int32) + bq,
                         torch.ones_like(start))
    tok = torch.arange(t, **i32)
    lane_t = torch.clamp(torch.searchsorted(cu, tok, right=True).to(torch.int32)
                         - 1, 0, s - 1).long()
    within = tok - cu[lane_t]
    slot = (off[lane_t] + within // bq) * bq + within % bq
    slot = torch.clamp(slot, 0, nb * bq - 1)
    return rows, start, kv_len, slot


Attend = Callable[..., torch.Tensor]


class VarlenLayout(NamedTuple):
    """One step's q-block layout (``q_block_layout``'s four arrays), or
    ``None`` for an untiled call — the same for every layer, so a step
    computes it once (``varlen_layout``) and hands it to each."""
    blocks: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]]


def varlen_layout(cu_seqlens, q_pos, t: int, block_q: Optional[int],
                  device) -> VarlenLayout:
    """Validate ``cu_seqlens`` against the stream width ``t`` and, when the
    call is tiled (``block_q > 1`` with lane boundaries), cut the stream
    into q-blocks → :class:`VarlenLayout` on ``device``."""
    cu = (validate_cu_seqlens(cu_seqlens, t).to(device)
          if cu_seqlens is not None else None)
    bq = None if block_q is None else int(min(block_q, max(t, 1)))
    if cu is None or bq is None or bq <= 1:
        return VarlenLayout(None)
    q_pos = torch.as_tensor(q_pos).to(device=device, dtype=torch.int32)
    return VarlenLayout(q_block_layout(cu, q_pos, t, bq))


def _tiled(q, token_pages, blocks, attend) -> torch.Tensor:
    """Regather (T,)-stream → (NB, Hq, Bq, D) blocks, attend, scatter back."""
    t, hq, d = q.shape
    rows, start, kv_len, slot = blocks
    nb, bq = rows.shape
    qb = q[rows.reshape(-1).long()].reshape(nb, bq, hq, d)
    qb = qb.transpose(1, 2).contiguous()                 # (NB, Hq, bq, D)
    tbl = token_pages[start.long()].contiguous()         # (NB, P)
    out = attend(qb, tbl, kv_len)                        # (NB, Hq, bq, Dv)
    flat = out.transpose(1, 2).reshape(-1, hq, out.shape[-1])
    return flat[slot.long()]                             # (T, Hq, Dv)


def _varlen(attend_4d: Attend, q, k_pool, v_pool, token_pages, q_pos, *,
            cu_seqlens, scale, cap, window, exp_mode, k_scale, v_scale,
            block_q, block_pages, dequant, kv_split, layout) -> torch.Tensor:
    t = q.shape[0]
    if layout is None:
        layout = varlen_layout(cu_seqlens, q_pos, t, block_q, q.device)
    kw = dict(scale=scale, cap=cap, window=window, exp_mode=exp_mode,
              k_scale=k_scale, v_scale=v_scale, block_pages=block_pages,
              dequant=dequant, kv_split=kv_split)
    if layout.blocks is not None:
        return _tiled(q, token_pages, layout.blocks,
                      lambda qb, tbl, kv_len: attend_4d(
                          qb, k_pool, v_pool, tbl, kv_len, **kw))
    q_pos = torch.as_tensor(q_pos).to(device=q.device, dtype=torch.int32)
    out = attend_4d(q.reshape(t, q.shape[1], 1, q.shape[2]), k_pool, v_pool,
                    token_pages, q_pos + 1, **kw)
    return out[:, :, 0, :]


def paged_attention_varlen(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, token_pages: torch.Tensor,
                           q_pos, *,
                           cu_seqlens: Optional[Sequence[int]] = None,
                           scale: Optional[float] = None,
                           cap: Optional[float] = None,
                           window: Optional[int] = None,
                           exp_mode: str = "lut",
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           block_q: Optional[int] = None,
                           block_pages: Optional[int] = None,
                           dequant: str = "block",
                           kv_split: Optional[int] = None,
                           layout: Optional[VarlenLayout] = None
                           ) -> torch.Tensor:
    """Ragged paged attention over a packed (T,)-token stream → (T, Hq, D),
    through :func:`~repro_torch.kernels.paged_attention.ops.paged_attention`
    (the CUDA kernel on the card, the plain version on the CPU).
    ``layout`` is the step's :func:`varlen_layout`, computed here when the
    caller passes none."""
    return _varlen(paged_attention, q, k_pool, v_pool, token_pages, q_pos,
                   cu_seqlens=cu_seqlens, scale=scale, cap=cap, window=window,
                   exp_mode=exp_mode, k_scale=k_scale, v_scale=v_scale,
                   block_q=block_q, block_pages=block_pages, dequant=dequant,
                   kv_split=kv_split, layout=layout)


def paged_attention_varlen_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     token_pages: torch.Tensor, q_pos, *,
                                     cu_seqlens: Optional[Sequence[int]] = None,
                                     scale: Optional[float] = None,
                                     cap: Optional[float] = None,
                                     window: Optional[int] = None,
                                     exp_mode: str = "lut",
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None,
                                     block_q: Optional[int] = None,
                                     block_pages: Optional[int] = None,
                                     dequant: str = "block",
                                     kv_split: Optional[int] = None,
                                     layout: Optional[VarlenLayout] = None
                                     ) -> torch.Tensor:
    """The same reduction, always through the plain page-block scan — on any
    device (the card's comparison path)."""
    return _varlen(paged_attention_reference, q, k_pool, v_pool, token_pages,
                   q_pos, cu_seqlens=cu_seqlens, scale=scale, cap=cap,
                   window=window, exp_mode=exp_mode, k_scale=k_scale,
                   v_scale=v_scale, block_q=block_q, block_pages=block_pages,
                   dequant=dequant, kv_split=kv_split, layout=layout)
