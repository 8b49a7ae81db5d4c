"""Language models of the port (port of ``src/repro/models/lm.py``):
``period_layout``, the cache-free full-sequence forward (``trunk_apply``,
``lm_apply``, ``cross_entropy``, ``lm_loss``) that BERT encoding and dense
scoring run, and the ragged serving path of the dense decoder
(``trunk_cache_init``, ``trunk_apply_ragged``, ``lm_step_ragged``).

Parameters are one flat dict (``params.py``): per-layer weights are stacked
on a leading layer axis, as the reference's scanned ``periods`` leaves are,
and layer ``i`` reads the views ``w[i]``.  The page pool has the reference
layout too: ``k``/``v`` are (L, N+1, Hkv, ps, Dh), int8 scales
(L, N+1, Hkv, ps) f32, and page ``N`` is the scratch page.

Every layer is pre-norm, as the reference's ``_layer_apply`` is for every
family — BERT included: the reference never reads ``cfg.postnorm`` on this
path, so its "BERT" is a pre-LN encoder with a final LayerNorm, and the
port computes the same.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import configure_matmul_precision
from repro_torch.kernels.paged_attention.varlen import varlen_layout
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]



def layer_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The per-layer parameter keys of ``cfg``: weights, then the biases of
    biased projections and LayerNorms (``<weight>_b``)."""
    keys = ["ln1", "wq", "wk", "wv", "wo", "ln2", "up", "down"]
    if cfg.mlp_gated:
        keys.append("gate")
    if cfg.attn_bias:
        keys += ["wq_b", "wk_b", "wv_b"]
        if not cfg.mlp_gated:
            keys += ["up_b", "down_b"]
    if cfg.norm == "layernorm":
        keys += ["ln1_b", "ln2_b"]
    return tuple(keys)

#: Block shapes of the tiled varlen dataflow — the reference autotuner's CPU
#: row for deepseek-7b-smoke (``src/repro/configs/autotune.json``).
KERNEL_CONFIG = {"block_q": 8, "block_pages": 8, "dequant": "block"}


def period_layout(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, int]:
    """→ (kinds within one period, n full periods, n tail layers).  The
    dense decoder and BERT are all global layers: one-layer periods, no
    tail."""
    if cfg.family not in ("dense", "bert"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the port runs the dense and bert "
            f"families only; the other families are a later slice")
    return ("global",), cfg.num_layers, 0


def _ragged_family(cfg: ModelConfig) -> int:
    """The ragged serving path serves the dense decoder only; → its layers."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: ragged serving runs the dense decoder "
            f"only; the other families are a later slice")
    return period_layout(cfg)[1]


def _layer(cfg: ModelConfig, params: Params, i: int) -> Params:
    return {k: params[k][i] for k in layer_keys(cfg)}


# --------------------------------------------------------------------------
# cache-free full-sequence forward
# --------------------------------------------------------------------------

def trunk_apply(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                pos: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Every layer over the whole sequence: pre-norm attention, then the
    pre-norm MLP, each added to the residual stream."""
    kinds, nper, _ = period_layout(cfg)
    for i in range(nper):
        p = _layer(cfg, params, i)
        x = x + L.attn_apply(cfg, p, L.norm(cfg, p, "ln1", x), pos=pos,
                             kind=kinds[0], causal=causal)
        x = x + L.mlp_apply(cfg, p, L.norm(cfg, p, "ln2", x))
    return x


def lm_apply(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
             causal: bool = True) -> torch.Tensor:
    """tokens (B, L) → f32 logits (B, L, V), no cache (the reference's
    ``lm_apply`` with ``caches=None``: positions 0..L-1, ``q_offset`` 0)."""
    if tokens.device.type == "cuda":
        configure_matmul_precision()
    pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                       device=tokens.device)
    x = L.embed_full(cfg, params, tokens, pos)
    x = trunk_apply(cfg, params, x, pos=pos, causal=causal)
    x = L.norm(cfg, params, "final_norm", x)
    return L.unembed(cfg, params, x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32 (masked mean with ``mask``)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of the causal LM: logits at 0..L-2 against tokens
    1..L-1."""
    tokens = batch["tokens"]
    logits = lm_apply(cfg, params, tokens)
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:], batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


# --------------------------------------------------------------------------
# ragged serving step
# --------------------------------------------------------------------------


def trunk_cache_init(cfg: ModelConfig, pages: int, page_size: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """The page pool: ``pages`` pages (the last one the scratch page)."""
    nper = _ragged_family(cfg)
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
    """Every layer over the packed stream, writing its pool rows in place.
    The lane boundaries are validated and cut into q-blocks once, here, for
    all layers (the reference's ``jit`` hoists the same work)."""
    layout = varlen_layout(cu_seqlens, pos, x.shape[1],
                           kernel_config["block_q"], x.device)
    for i in range(_ragged_family(cfg)):
        p = _layer(cfg, params, i)
        cache = {k: v[i] for k, v in caches.items()}
        x = x + L.attn_apply_ragged(
            cfg, p, L.norm_apply(p["ln1"], x), pos=pos, cache=cache,
            token_pages=token_pages, cu_seqlens=cu_seqlens,
            kernel_config=kernel_config, attend=attend, layout=layout)
        x = x + L.mlp_apply(cfg, p, L.norm_apply(p["ln2"], x))
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
    logits = L.unembed(cfg, params, x)
    if greedy:
        from repro_torch.serving.sampling import greedy_rows
        return greedy_rows(logits)
    return logits
