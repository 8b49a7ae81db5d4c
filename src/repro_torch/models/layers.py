"""Transformer building blocks (port of ``src/repro/models/layers.py``):
dense (optionally biased), RMSNorm and LayerNorm, the per-head RMS norm of
QK-norm, RoPE, token (optionally scaled by √d_model) and learned position
embeddings, the untied and tied unembed with the final logit softcap, the
gated and plain MLP, and the branches of the attention layer: the
full-sequence branch (``attn_apply``, through the attention registry),
cache-free or over a contiguous cache (``attn_cache_init``: a ring buffer,
an int8 cache or a plain one), the padded-block (``page_table``) branch
of the paged serving step, over the page pool (``attn_apply`` with a
``page_table``), and its ragged (``token_pages``) branch
(``attn_apply_ragged``).  Each reads the layer's
``kind``: a ``local`` layer attends within ``cfg.window`` and rotates with
``cfg.local_rope_theta`` when it is set.
Functions on tensors; parameters are plain tensors.  Projections, the MLP
and the unembed stay PyTorch products, as the reference leaves them to
XLA; attention goes through the port's kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.core.attention_api import (attention, backend_for_config,
                                            ragged_attention)
from repro_torch.core.streaming_attention import (
    quantize_kv_rows, streaming_attention_quantized)
from repro_torch.device import dense
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.parallel.collectives import (all_gather, axis_index,
                                              axis_size, band, gather_grad)

Params = Dict[str, torch.Tensor]


def dense_apply(w: torch.Tensor, x: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w accumulated in f32, cast back to ``x.dtype`` (``device.
    dense``), then ``+ b`` in that dtype."""
    y = dense(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def norm_apply(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm with a ``1 + scale`` weight, computed in f32."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + 1e-6) * (1.0 + scale.to(torch.float32))
    return y.to(x.dtype)


def layer_norm_apply(scale: torch.Tensor, bias: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """LayerNorm as the reference computes it: f32, population variance,
    eps 1e-6 inside the rsqrt (not ``F.layer_norm``'s 1e-5)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def norm(cfg: ModelConfig, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """The config's norm with parameters ``p[name]`` (and ``p[name + "_b"]``)."""
    if cfg.norm == "layernorm":
        return layer_norm_apply(p[name], p[name + "_b"], x)
    return norm_apply(p[name], x)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm of q or k (QK-norm), ``1 + scale`` weighted, in
    f32.  x: (B, H, L, Dh), scale (Dh,)."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope_apply(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, H, L, D); pos: (L,) or (B, L) positions."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = pos.to(torch.float32)[..., :, None] * freqs       # (…, L, D/2)
    if angles.dim() == 3:
        angles = angles[:, None]                               # (B, 1, L, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def embed_apply(cfg: ModelConfig, table: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """Token rows; with ``cfg.embed_scale`` times √d_model, that factor
    first rounded to the table's dtype as the reference's
    ``jnp.asarray(d ** 0.5, x.dtype)`` rounds it (√3584 → 59.75 in bf16).
    The product of two values of that dtype is exact in f32, so one
    rounding of it equals the reference's product."""
    x = table[tokens.long()]
    if cfg.embed_scale:
        factor = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
        x = x * factor
    return x


def embed_full(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """Token rows plus, for learned positions, the position rows, added in
    the working dtype."""
    x = embed_apply(cfg, params["embed"], tokens)
    if cfg.pos_embedding == "learned":
        x = x + params["positions"][pos.long()]
    return x


class _MatmulF32Out(torch.autograd.Function):
    """``aten::mm.dtype`` (bf16 × bf16 → f32), which has no derivative,
    with the reference's: its einsum's transpose takes the f32 cotangent
    against the widened other operand and casts the result to the
    operand's dtype, so both gradients are f32 products cast once."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.mm(g, w.t().float()).to(x.dtype)
        dw = torch.mm(x.t().float(), g).to(w.dtype)
        return dx, dw


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final logits in f32, through ``lm_head`` or, for tied embeddings,
    the token table, then gemma2's final softcap ``cap · tanh(z / cap)``
    in f32.  On the card a bf16 ``x`` and head go through one bf16 × bf16
    GEMM with an f32 output (``aten::mm.dtype``), as the reference's einsum
    with ``preferred_element_type=f32``: exact products summed in f32, and
    no f32 copy of the head (under autograd ``_MatmulF32Out`` adds the
    backward).  Elsewhere both operands are widened to f32."""
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    if x.device.type == "cuda" and x.dtype == head.dtype == torch.bfloat16:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or head.requires_grad):
            out = _MatmulF32Out.apply(x2, head)
        else:
            out = torch.mm(x2, head, out_dtype=torch.float32)
        logits = out.reshape(*x.shape[:-1], head.shape[-1])
    else:
        logits = torch.matmul(x.to(torch.float32), head.to(torch.float32))
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


_ACTS = {"silu": F.silu, "relu": F.relu,
         # jax.nn.gelu defaults to the tanh approximation
         "gelu": lambda x: F.gelu(x, approximate="tanh")}


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    act = _ACTS[cfg.act]
    h = dense_apply(p["up"], x, p.get("up_b"))
    if cfg.mlp_gated:
        h = act(dense_apply(p["gate"], x)) * h
    else:
        h = act(h)
    return dense_apply(p["down"], h, p.get("down_b"))


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, l, hd = x.shape
    return x.reshape(b, l, n, hd // n).transpose(1, 2)        # (B, H, L, Dh)


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, pos: torch.Tensor,
         kind: str):
    """q, k, v (B, H, L, Dh) of ``x``: biased projections, QK-norm, then
    RoPE at the kind's theta (the reference's order); → (q, k, v, window)
    with the kind's window."""
    q = _heads(dense_apply(p["wq"], x, p.get("wq_b")), cfg.num_heads)
    k = _heads(dense_apply(p["wk"], x, p.get("wk_b")), cfg.num_kv_heads)
    v = _heads(dense_apply(p["wv"], x, p.get("wv_b")), cfg.num_kv_heads)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    theta = cfg.rope_theta
    if kind == "local" and cfg.local_rope_theta is not None:
        theta = cfg.local_rope_theta
    if cfg.pos_embedding == "rope":
        q = rope_apply(q, pos, theta)
        k = rope_apply(k, pos, theta)
    return q, k, v, (cfg.window if kind == "local" else None)


def attn_apply_ragged(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, *, pos: torch.Tensor,
                      kind: str = "global",
                      cache: Dict[str, torch.Tensor],
                      token_pages: torch.Tensor,
                      cu_seqlens: Optional[torch.Tensor],
                      kernel_config: Optional[KernelConfig] = None,
                      attend: Callable = None,
                      layout=None, tp_axis=None) -> torch.Tensor:
    """The ragged branch of the reference ``attn_apply`` (layers.py:238-349).

    ``x`` is one (1, T, d_model) packed stream, ``pos`` (T,) each token's
    position, ``token_pages`` (T, P) each token's page-table row and
    ``cache`` this layer's pool views {"k", "v"[, "ks", "vs"]} of shape
    (N+1, Hkv, ps, Dh) (scales (N+1, Hkv, ps)).  ``kind`` is the layer's
    (``cfg.layer_kinds()``): a local layer's window, and the config's
    scale and softcap, reach the varlen attention.  Each token's K/V row is
    written at (its page, pos % ps) — quantised on the way in for int8
    pools; dead rows carry an all-scratch table row, so their writes land
    on the scratch page — and attention reads the pool through the tables.

    The reference donates the pool buffer to the jitted step; here the
    write updates the pool in place (``index_put_`` on the layer's view of
    the stacked pool).  ``layout`` is the step's q-block layout
    (``varlen_layout``), computed once per step rather than per layer, at
    ``kernel_config``'s ``block_q``; ``None`` consults the tuner's active
    config (``attention_api.ragged_attention``).

    ``tp_axis`` — a mesh axis (``launch/mesh.py::MeshAxis``) or process
    group — when this rank of a tensor-parallel engine holds one band of
    the KV heads (``cache["k"]`` (N+1, Hkv/n, ps, Dh)): q/k/v are sliced
    to the rank's head band after RoPE and QK-norm, the band's rows are
    written (an int8 pool quantises the band's rows only) and attended,
    and one all-gather rebuilds the (T, Hq, Dh) head axis in rank order
    before ``wo``.  The gather moves exactly what one device feeds
    ``wo``, so every rank's output is bitwise the single-device one.
    """
    _, t, _ = x.shape
    q, k, v, window = _qkv(cfg, p, x, pos[None], kind)
    # the local pool's head count tells the shard factor
    shards = 1 if tp_axis is None else cfg.num_kv_heads // cache["k"].shape[1]
    if shards > 1:
        hkv_l = cache["k"].shape[1]
        hq_l = cfg.num_heads // shards
        band = axis_index(tp_axis)
        q = q[:, band * hq_l:(band + 1) * hq_l]
        k = k[:, band * hkv_l:(band + 1) * hkv_l]
        v = v[:, band * hkv_l:(band + 1) * hkv_l]

    ps = cache["k"].shape[2]
    slot = torch.clamp(torch.div(pos, ps, rounding_mode="floor"), 0,
                       token_pages.shape[1] - 1)
    pids = torch.gather(token_pages, 1, slot[:, None].long())[:, 0].long()
    off = torch.remainder(pos, ps).long()

    def put(pool, val):
        # val (1, H, T, …) → rows-major (T, H, …), one row per (page, offset)
        pool[pids, :, off] = val[0].transpose(0, 1).to(pool.dtype)

    kw = dict(scale=cfg.attn_scale or cfg.d_head ** -0.5,
              cap=cfg.attn_softcap, window=window, exp_mode=cfg.exp_mode)
    if "ks" in cache:                       # int8 pool: values + row scales
        kq, ks = quantize_kv_rows(k)
        vq, vs = quantize_kv_rows(v)
        put(cache["k"], kq)
        put(cache["v"], vq)
        put(cache["ks"], ks)
        put(cache["vs"], vs)
        kw.update(k_scale=cache["ks"], v_scale=cache["vs"])
    else:
        put(cache["k"], k)
        put(cache["v"], v)
    qt = q[0].transpose(0, 1).contiguous()                      # (T, Hq, Dh)
    out = ragged_attention(qt, cache["k"], cache["v"], token_pages, pos,
                           kernel_config=kernel_config, attend=attend,
                           cu_seqlens=cu_seqlens, layout=layout,
                           **kw)                                # (T, Hq', Dh)
    if shards > 1:
        out = all_gather(out, tp_axis, dim=1)                   # (T, Hq, Dh)
    return dense_apply(p["wo"], out.reshape(1, t, cfg.num_heads * cfg.d_head))


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                    kind: str = "global", dtype=None,
                    device=None) -> Params:
    """One layer's contiguous KV cache (port of the reference's
    ``attn_cache_init``, layers.py:436-460).  A local layer whose window is
    below ``max_len`` gets a ring buffer of ``window`` rows, ``k``/``v``
    (B, Hkv, window, Dh) and ``pos`` (B, window) int32, each slot's absolute
    position (-1: never written): O(window) in place of O(max_len), the
    cache-side statement of HASTILY's O(l) → O(1) streaming.  Otherwise
    (B, Hkv, max_len, Dh) rows, int8 with f32 row scales ``ks``/``vs``
    (B, Hkv, max_len) under ``cfg.kv_quant``."""
    dt = dtype or getattr(torch, cfg.dtype)
    if is_ring(cfg, kind, max_len):
        shape = (batch, cfg.num_kv_heads, cfg.window, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "pos": torch.full((batch, cfg.window), -1, dtype=torch.int32,
                                  device=device)}
    shape = (batch, cfg.num_kv_heads, max_len, cfg.d_head)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "vs": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def is_ring(cfg: ModelConfig, kind: str, max_len: int) -> bool:
    """Does a layer of ``kind`` keep a ring buffer in a cache of
    ``max_len`` rows?"""
    return kind == "local" and cfg.window is not None and cfg.window < max_len


def _write_rows(t: torch.Tensor, val: torch.Tensor, idx) -> None:
    """``val`` (B, H, l[, Dh]) into ``t`` (B, H, T[, Dh]) at rows idx ..
    idx + l - 1, in place.  ``idx`` is an int, or (B,) with l == 1: each
    batch row its own.  The start is clamped as ``dynamic_update_slice``
    clamps it, so the rows always land inside ``t``."""
    n, l = t.shape[2], val.shape[2]
    if isinstance(idx, torch.Tensor):
        if l != 1:
            raise ValueError(f"per-row cache indices take one row each, got "
                             f"{l}")
        rows = torch.clamp(idx.long(), 0, n - 1)
        b = torch.arange(t.shape[0], device=t.device)
        t[b, :, rows] = val[:, :, 0].to(t.dtype)
        return
    start = max(0, min(int(idx), n - l))
    t[:, :, start:start + l] = val.to(t.dtype)


def _ring_write(cache: Params, k: torch.Tensor, v: torch.Tensor, idx) -> None:
    """The ring buffer's write (the reference's ``:355-388``): slot =
    position mod window.  A decode row (l == 1, ``idx`` an int or (B,))
    takes one slot per batch row; a prefill of l rows at ``idx`` (an int)
    keeps its last ``window`` rows."""
    lc, l = cache["k"].shape[2], k.shape[2]
    if l == 1:
        b = k.shape[0]
        pos = (idx.to(torch.int32) if isinstance(idx, torch.Tensor) else
               torch.full((b,), int(idx), dtype=torch.int32, device=k.device))
        slot = torch.remainder(pos, lc).long()
        _write_rows(cache["k"], k, slot)
        _write_rows(cache["v"], v, slot)
        cache["pos"][torch.arange(b, device=k.device), slot] = pos
        return
    keep = min(l, lc)
    pos_keep = (int(idx) + l - keep
                + torch.arange(keep, dtype=torch.int32, device=k.device))
    slots = torch.remainder(pos_keep, lc).long()
    cache["k"][:, :, slots] = k[:, :, l - keep:].to(cache["k"].dtype)
    cache["v"][:, :, slots] = v[:, :, l - keep:].to(cache["v"].dtype)
    cache["pos"][:, slots] = pos_keep[None, :]


def attn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
               pos: torch.Tensor, kind: str = "global",
               causal: bool = True, cache: Optional[Params] = None,
               cache_index=None, page_table: Optional[torch.Tensor] = None,
               q_len: Optional[torch.Tensor] = None,
               tp_axis=None) -> torch.Tensor:
    """The full-sequence and padded-block branches of the reference
    ``attn_apply`` (layers.py:160-433).  x (B, L, D), pos (L,) or (B, L)
    positions (RoPE).

    With a ``page_table`` (B, P), ``cache`` is one layer's page pool
    (``_attend_padded``): a right-aligned block, ``cache_index`` (B,)
    the row of each lane's first block row and ``q_len`` (B,) its live
    rows (None: all).

    Without a cache the whole sequence attends itself.  With one
    (``attn_cache_init``), the new K/V rows are written at ``cache_index``
    — an int (a prefill, or every row at one position), or (B,) for a
    single-row decode whose batch rows sit at positions of their own —
    in place, and the rows attend:

    - a ring buffer: a decode row against the ring through its slot
      positions; a prefill (l > 1) within its own chunk, before the ring
      keeps the chunk's last ``window`` rows;
    - an int8 cache: through ``streaming_attention_quantized`` over the
      whole cache, masked by ``kv_len = cache_index + l``;
    - a plain cache: over the whole cache, masked by ``kv_len``.

    Ring and plain calls go through the attention registry
    (``cfg.attn_backend``, ``fallback=True``): with an int ``cache_index``
    the lengths are static, so on the card ``auto`` resolves a prefill to
    the CUDA streaming-attention kernel and a decode row to
    ``naive_decode``, as the reference resolves them on a TPU.

    ``tp_axis`` — a mesh axis whose ranks all run this layer on the same
    rows (a training step's model axis) — makes the cache-free branch
    attend this rank's band of the heads when the KV head count divides
    the axis (else every rank attends all heads): q/k/v are cut to the
    band after RoPE and QK-norm (``collectives.band``: the bands'
    gradients are all-gathered back), and one all-gather rebuilds the
    head axis in rank order before ``wo`` (``gather_grad`` without a sum:
    each rank keeps its band of the gradient), as ``attn_apply_ragged``
    does for serving.  A head's arithmetic does not depend on how many
    heads a call holds, so the output and every rank's gradients are the
    single-device ones."""
    b, l, _ = x.shape
    q, k, v, window = _qkv(cfg, p, x, pos, kind)
    banded = (tp_axis is not None and cache is None and page_table is None
              and axis_size(tp_axis) > 1
              and cfg.num_kv_heads % axis_size(tp_axis) == 0)
    if banded:
        q, k, v = (band(t, tp_axis, 1) for t in (q, k, v))
    scale = cfg.attn_scale or cfg.d_head ** -0.5
    if page_table is not None:
        out = _attend_padded(cfg, q, k, v, window, causal=causal, cache=cache,
                             cache_index=cache_index, page_table=page_table,
                             q_len=q_len)
        out = out.transpose(1, 2).reshape(b, l, cfg.num_heads * cfg.d_head)
        return dense_apply(p["wo"], out)
    q_offset, kv_len, kv_pos = 0, None, None
    if cache is not None and "pos" in cache:
        _ring_write(cache, k, v, cache_index)
        if l == 1:
            k, v, kv_pos = cache["k"], cache["v"], cache["pos"]
        q_offset = cache_index
    elif cache is not None and "ks" in cache:
        kq, ks = quantize_kv_rows(k)
        vq, vs = quantize_kv_rows(v)
        for name, val in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
            _write_rows(cache[name], val, cache_index)
        out = streaming_attention_quantized(
            q, cache["k"], cache["v"], cache["ks"], cache["vs"], scale=scale,
            causal=causal, window=window, cap=cfg.attn_softcap,
            block_k=cfg.block_k, exp_mode=cfg.exp_mode, q_offset=cache_index,
            kv_len=cache_index + l)
        out = out.transpose(1, 2).reshape(b, l, cfg.num_heads * cfg.d_head)
        return dense_apply(p["wo"], out)
    elif cache is not None:
        _write_rows(cache["k"], k, cache_index)
        _write_rows(cache["v"], v, cache_index)
        k, v = cache["k"], cache["v"]
        q_offset, kv_len = cache_index, cache_index + l
    out = attention(q, k, v,
                    backend=backend_for_config(cfg.attn_backend,
                                               cfg.attn_impl),
                    scale=scale, causal=causal,
                    window=window, cap=cfg.attn_softcap, block_k=cfg.block_k,
                    exp_mode=cfg.exp_mode, q_offset=q_offset, kv_len=kv_len,
                    kv_pos=kv_pos, fallback=True)
    if banded:
        out = gather_grad(out, tp_axis, 1, sum_grads=False)
    out = out.transpose(1, 2).reshape(b, l, cfg.num_heads * cfg.d_head)
    return dense_apply(p["wo"], out)


def _attend_padded(cfg: ModelConfig, q, k, v, window, *, causal: bool,
                   cache: Params, cache_index: torch.Tensor,
                   page_table: torch.Tensor,
                   q_len: Optional[torch.Tensor]) -> torch.Tensor:
    """The padded-block branch of the reference ``attn_apply``
    (layers.py:236-339, the ``page_table`` half) → (B, Hq, L, Dh).

    ``cache`` is the layer's pool views {"k", "v"[, "ks", "vs"]}, (N+1,
    Hkv, ps, Dh) (scales (N+1, Hkv, ps)), page N the scratch page.  Row
    ``i`` of lane ``b`` sits at position ``cache_index[b] + i``; rows
    ``i >= L - q_len[b]`` are live.  Each live row's K/V is written at
    (its page, position mod ps), quantised on the way in for an int8 pool,
    in place; padding rows — their positions may be negative, an idle
    lane's all are — write to the scratch page, the table lookup clamped
    first, with floor division and floor modulo as ``jnp`` computes them.
    Several padding rows may write one (scratch page, offset): which one
    lands is not fixed, and nothing reads it.  Attention then reads the
    pool through the table with ``kv_len = cache_index + L``: kernel #2's
    block entry on the card, its plain version on the CPU (the registry's
    ``paged`` backend for float pools, ``paged_attention`` itself with the
    row scales for int8 ones, as in the reference).  A row that sees no
    key (an idle lane's, a negative position's) comes out zero."""
    b, _, l, _ = q.shape
    ps = cache["k"].shape[2]
    scratch = cache["k"].shape[0] - 1
    idx = cache_index.to(torch.int32)
    kv_len = idx + l
    rows = idx[:, None] + torch.arange(l, dtype=torch.int32,
                                       device=q.device)[None]      # (B, L)
    if q_len is None:
        live = torch.ones(rows.shape, dtype=torch.bool, device=q.device)
    else:
        live = (torch.arange(l, dtype=torch.int32, device=q.device)[None]
                >= l - q_len.to(torch.int32)[:, None])
    slot = torch.clamp(torch.div(rows, ps, rounding_mode="floor"), 0,
                       page_table.shape[1] - 1)
    pids = torch.where(live, torch.gather(page_table, 1, slot.long()),
                       scratch).long()
    off = torch.remainder(rows, ps).long()

    def put(pool, val):
        # val (B, Hkv, L, …) → rows-major (B, L, Hkv, …), one row per
        # (page, offset); the transient is O(B·L), never a gathered view
        pool[pids, :, off] = val.transpose(1, 2).to(pool.dtype)

    kw = dict(scale=cfg.attn_scale or cfg.d_head ** -0.5,
              cap=cfg.attn_softcap, window=window, exp_mode=cfg.exp_mode)
    table = page_table.to(torch.int32).contiguous()
    if "ks" in cache:                       # int8 pool: values + row scales
        kq, ks = quantize_kv_rows(k)
        vq, vs = quantize_kv_rows(v)
        put(cache["k"], kq)
        put(cache["v"], vq)
        put(cache["ks"], ks)
        put(cache["vs"], vs)
        return paged_attention(q.contiguous(), cache["k"], cache["v"], table,
                               kv_len, k_scale=cache["ks"],
                               v_scale=cache["vs"], **kw)
    put(cache["k"], k)
    put(cache["v"], v)
    return attention(q.contiguous(), cache["k"], cache["v"],
                     backend=backend_for_config(cfg.attn_backend,
                                                cfg.attn_impl),
                     causal=causal, block_k=cfg.block_k, fallback=True,
                     kv_len=kv_len, page_table=table, **kw)
