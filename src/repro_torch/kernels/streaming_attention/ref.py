"""Plain PyTorch versions of the streaming-attention kernels (port of
``src/repro/kernels/streaming_attention/ref.py``): the forward is the
materialised-logits baseline of ``repro_torch.core``, so kernel↔plain
agreement also certifies the kernel against the model code; the forward
with the per-row logsumexp and the backward are the core scan's custom
VJP taken over one block of every key (the blocking changes only the
summation order of the backward's sums)."""
from __future__ import annotations

import importlib
from typing import Optional, Tuple

import torch

from repro_torch.core.streaming_attention import naive_attention

# the module (``repro_torch.core`` re-exports the function under its name)
_sa = importlib.import_module("repro_torch.core.streaming_attention")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: Optional[float] = None, causal: bool = False,
                  window: Optional[int] = None, cap: Optional[float] = None,
                  exp_mode: str = "lut", q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """(B, Hq, Lq, D) × (B, Hkv, Lkv, D) → (B, Hq, Lq, D)."""
    return naive_attention(q, k, v, scale=scale, causal=causal, window=window,
                           cap=cap, exp_mode=exp_mode, q_offset=q_offset,
                           kv_len=kv_len)


def _blocks(q, k, v, scale, q_offset, kv_len, block_k=None):
    """The grouped f32 q, the keys and values in blocks of ``block_k`` (one
    block of every key by default), their positions, the row positions and
    the key count."""
    hkv, lkv = k.shape[1], k.shape[2]
    qg = _sa._split_heads(q.float(), hkv)
    bk = block_k or max(lkv, 1)
    pos = torch.arange(lkv, dtype=torch.int32, device=q.device)[None, :]
    return (qg, _sa._blocked_kv(k, bk), _sa._blocked_kv(v, bk),
            _sa._blocked_pos(pos, bk),
            _sa._positions(q_offset, q.shape[2], q.device),
            lkv if kv_len is None else kv_len,
            q.shape[-1] ** -0.5 if scale is None else scale)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: Optional[float] = None, causal: bool = False,
                      window: Optional[int] = None,
                      cap: Optional[float] = None, exp_mode: str = "lut",
                      q_offset: int = 0, kv_len: Optional[int] = None,
                      block_k: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (``attention_ref``'s output, the f32 per-row logsumexp (B, Hq,
    Lq) = m + log(max(l, 1e-30))): what the forward kernel writes when it
    is asked for ``lse``.  The lse's online softmax takes the keys in
    blocks of ``block_k`` (None: one block); at ``lut0`` the lse depends on
    the blocking, so a check of the kernel passes the kernel's own
    (``ops.block_k``)."""
    out = attention_ref(q, k, v, scale=scale, causal=causal, window=window,
                        cap=cap, exp_mode=exp_mode, q_offset=q_offset,
                        kv_len=kv_len)
    qg, kb, vb, pb, q_pos, kv_len, scale = _blocks(q, k, v, scale, q_offset,
                                                   kv_len, block_k)
    _, lse = _sa._fwd_scan(qg, kb, vb, pb, q_pos, kv_len, scale=scale,
                           causal=causal, window=window, cap=cap,
                           exp_mode=exp_mode)
    return out, lse.reshape(q.shape[:3])


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, scale: Optional[float] = None,
                      causal: bool = False, window: Optional[int] = None,
                      cap: Optional[float] = None, exp_mode: str = "lut",
                      q_offset: int = 0, kv_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's flash backward (``_bwd``) over one block: δ =
    rowsum(dO·O) in f32, ``p = exp(s_c − lse)`` through the mode's
    exponential, the softcap's chain rule → (dq, dk, dv) in q's, k's and
    v's dtypes.  ``out`` (B, Hq, Lq, D) and ``lse`` (B, Hq, Lq) are the
    forward's."""
    qg, kb, vb, pb, q_pos, kv_len, scale = _blocks(q, k, v, scale, q_offset,
                                                   kv_len)
    grouped = lambda t: _sa._split_heads(t.float(), k.shape[1])  # noqa: E731
    dq, dkb, dvb = _sa._bwd_scan(
        qg, kb, vb, pb, q_pos, kv_len, grouped(out),
        lse.reshape(qg.shape[:4]), grouped(dout), scale=scale, causal=causal,
        window=window, cap=cap, exp_mode=exp_mode)
    lkv = k.shape[2]
    return (dq.reshape(q.shape).to(q.dtype),
            dkb[0][:, :, :lkv].to(k.dtype), dvb[0][:, :, :lkv].to(v.dtype))
