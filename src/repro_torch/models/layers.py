"""Transformer building blocks (port of ``src/repro/models/layers.py``):
dense (optionally biased), RMSNorm and LayerNorm, RoPE, token and learned
position embeddings, the untied and tied unembed, the gated and plain MLP,
and two branches of the attention layer: the cache-free full-sequence
branch (``attn_apply``, through the attention registry) and the ragged
(``token_pages``) branch of the paged serving step (``attn_apply_ragged``).
Functions on tensors; parameters are plain tensors.  Projections, the MLP
and the unembed stay PyTorch products, as the reference leaves them to
XLA; attention goes through the port's kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.core.attention_api import attention, backend_for_config
from repro_torch.core.streaming_attention import quantize_kv_rows
from repro_torch.device import dense
from repro_torch.kernels.paged_attention.varlen import paged_attention_varlen

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


def embed_apply(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def embed_full(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """Token rows plus, for learned positions, the position rows, added in
    the working dtype."""
    x = embed_apply(params["embed"], tokens)
    if cfg.pos_embedding == "learned":
        x = x + params["positions"][pos.long()]
    return x


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final logits in f32, through ``lm_head`` or, for tied embeddings,
    the token table.  On the card a bf16 ``x`` and head go through one
    bf16 × bf16 GEMM with an f32 output (``aten::mm.dtype``), as the
    reference's einsum with ``preferred_element_type=f32``: exact products
    summed in f32, and no f32 copy of the head.  Elsewhere both operands
    are widened to f32."""
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    if x.device.type == "cuda" and x.dtype == head.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), head,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], head.shape[-1])
    return torch.matmul(x.to(torch.float32), head.to(torch.float32))


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


def attn_apply_ragged(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, *, pos: torch.Tensor,
                      cache: Dict[str, torch.Tensor],
                      token_pages: torch.Tensor,
                      cu_seqlens: Optional[torch.Tensor],
                      kernel_config: Dict, attend: Callable = None,
                      layout=None) -> torch.Tensor:
    """The ragged branch of the reference ``attn_apply`` (layers.py:238-349).

    ``x`` is one (1, T, d_model) packed stream, ``pos`` (T,) each token's
    position, ``token_pages`` (T, P) each token's page-table row and
    ``cache`` this layer's pool views {"k", "v"[, "ks", "vs"]} of shape
    (N+1, Hkv, ps, Dh) (scales (N+1, Hkv, ps)).  Each token's K/V row is
    written at (its page, pos % ps) — quantised on the way in for int8
    pools; dead rows carry an all-scratch table row, so their writes land
    on the scratch page — and attention reads the pool through the tables.

    The reference donates the pool buffer to the jitted step; here the
    write updates the pool in place (``index_put_`` on the layer's view of
    the stacked pool).  ``layout`` is the step's q-block layout
    (``varlen_layout``), computed once per step rather than per layer.
    """
    attend = attend or paged_attention_varlen
    _, t, _ = x.shape
    q = _heads(dense_apply(p["wq"], x), cfg.num_heads)
    k = _heads(dense_apply(p["wk"], x), cfg.num_kv_heads)
    v = _heads(dense_apply(p["wv"], x), cfg.num_kv_heads)
    q = rope_apply(q, pos[None], cfg.rope_theta)
    k = rope_apply(k, pos[None], cfg.rope_theta)

    ps = cache["k"].shape[2]
    slot = torch.clamp(torch.div(pos, ps, rounding_mode="floor"), 0,
                       token_pages.shape[1] - 1)
    pids = torch.gather(token_pages, 1, slot[:, None].long())[:, 0].long()
    off = torch.remainder(pos, ps).long()

    def put(pool, val):
        # val (1, H, T, …) → rows-major (T, H, …), one row per (page, offset)
        pool[pids, :, off] = val[0].transpose(0, 1).to(pool.dtype)

    kw = dict(scale=cfg.d_head ** -0.5, exp_mode=cfg.exp_mode,
              block_q=kernel_config["block_q"],
              block_pages=kernel_config["block_pages"],
              dequant=kernel_config["dequant"])
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
    out = attend(qt, cache["k"], cache["v"], token_pages, pos,
                 cu_seqlens=cu_seqlens, layout=layout, **kw)    # (T, Hq, Dh)
    return dense_apply(p["wo"], out.reshape(1, t, cfg.num_heads * cfg.d_head))


def attn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
               pos: torch.Tensor, kind: str = "global",
               causal: bool = True) -> torch.Tensor:
    """The cache-free branch of the reference ``attn_apply``
    (layers.py:160-433): the whole sequence attends itself through the
    attention registry (``cfg.attn_backend``; on the card ``auto`` resolves
    multi-row calls to the CUDA streaming-attention kernel).  x (B, L, D),
    pos (L,) positions (RoPE)."""
    b, l, _ = x.shape
    q = _heads(dense_apply(p["wq"], x, p.get("wq_b")), cfg.num_heads)
    k = _heads(dense_apply(p["wk"], x, p.get("wk_b")), cfg.num_kv_heads)
    v = _heads(dense_apply(p["wv"], x, p.get("wv_b")), cfg.num_kv_heads)
    if cfg.pos_embedding == "rope":
        q = rope_apply(q, pos, cfg.rope_theta)
        k = rope_apply(k, pos, cfg.rope_theta)
    out = attention(q, k, v,
                    backend=backend_for_config(cfg.attn_backend,
                                               cfg.attn_impl),
                    scale=cfg.attn_scale or cfg.d_head ** -0.5,
                    causal=causal,
                    window=cfg.window if kind == "local" else None,
                    cap=cfg.attn_softcap, block_k=cfg.block_k,
                    exp_mode=cfg.exp_mode, fallback=True)
    out = out.transpose(1, 2).reshape(b, l, cfg.num_heads * cfg.d_head)
    return dense_apply(p["wo"], out)
