"""Dense decoder LM for ragged serving (port of ``src/repro/models/lm.py``:
``period_layout``, ``trunk_cache_init``, the cached ragged path of
``trunk_apply`` and ``lm_step_ragged``).

Parameters are one flat dict (``params.py``): per-layer weights are stacked
on a leading layer axis, as the reference's scanned ``periods`` leaves are,
and layer ``i`` reads the views ``w[i]``.  The page pool has the reference
layout too: ``k``/``v`` are (L, N+1, Hkv, ps, Dh), int8 scales
(L, N+1, Hkv, ps) f32, and page ``N`` is the scratch page.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "up", "gate", "down")

#: Block shapes of the tiled varlen dataflow — the reference autotuner's CPU
#: row for deepseek-7b-smoke (``src/repro/configs/autotune.json``).
KERNEL_CONFIG = {"block_q": 8, "block_pages": 8, "dequant": "block"}


def period_layout(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, int]:
    """→ (kinds within one period, n full periods, n tail layers).  The
    dense decoder is all global layers: one-layer periods, no tail."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense family only; "
            f"the other families are a later slice")
    return ("global",), cfg.num_layers, 0


def trunk_cache_init(cfg: ModelConfig, pages: int, page_size: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """The page pool: ``pages`` pages (the last one the scratch page)."""
    _, nper, _ = period_layout(cfg)
    shape = (nper, pages, cfg.num_kv_heads, page_size, cfg.d_head)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:4], dtype=torch.float32, device=device),
                "vs": torch.zeros(shape[:4], dtype=torch.float32, device=device)}
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def trunk_apply_ragged(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                       pos: torch.Tensor, caches: Dict[str, torch.Tensor],
                       token_pages: torch.Tensor,
                       cu_seqlens: Optional[torch.Tensor],
                       kernel_config: Dict,
                       attend: Optional[Callable] = None) -> torch.Tensor:
    """Every layer over the packed stream, writing its pool rows in place."""
    _, nper, _ = period_layout(cfg)
    for i in range(nper):
        p = {k: params[k][i] for k in LAYER_KEYS}
        cache = {k: v[i] for k, v in caches.items()}
        x = x + L.attn_apply_ragged(
            cfg, p, L.norm_apply(p["ln1"], x), pos=pos, cache=cache,
            token_pages=token_pages, cu_seqlens=cu_seqlens,
            kernel_config=kernel_config, attend=attend)
        x = x + L.mlp_apply(p, L.norm_apply(p["ln2"], x))
    return x


def lm_step_ragged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   caches: Dict[str, torch.Tensor], token_pages: torch.Tensor,
                   pos: torch.Tensor, last_idx: torch.Tensor,
                   cu_seqlens: Optional[torch.Tensor] = None,
                   kernel_config: Optional[Dict] = None, *,
                   greedy: bool = False,
                   attend: Optional[Callable] = None) -> torch.Tensor:
    """The token-level (ragged) serving step over one packed (T,) stream.

    ``tokens``/``pos`` (T,), ``token_pages`` (T, P), ``last_idx`` (lanes,)
    stream index of each lane's last token.  Writes every token's KV rows
    into ``caches`` in place and returns the (lanes, V) f32 logits of the
    ``last_idx`` rows — or, with ``greedy=True``, the (lanes,) int32 greedy
    picks, chosen on the device so only the picks leave it.  ``attend``
    replaces the varlen attention (default: through the kernel wrapper).
    """
    pos = pos.to(torch.int32)
    x = L.embed_apply(params["embed"], tokens)[None]            # (1, T, D)
    x = trunk_apply_ragged(cfg, params, x, pos=pos, caches=caches,
                           token_pages=token_pages, cu_seqlens=cu_seqlens,
                           kernel_config=kernel_config or KERNEL_CONFIG,
                           attend=attend)
    x = L.norm_apply(params["final_norm"], x)
    # (lanes,) gather before unembedding: only each lane's last row is needed
    x = x[0][last_idx.long()]
    logits = L.unembed_apply(params["lm_head"], x)
    if greedy:
        from repro_torch.serving.sampling import greedy_rows
        return greedy_rows(logits)
    return logits
