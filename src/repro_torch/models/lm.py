"""Language models of the port (port of ``src/repro/models/lm.py``):
``period_layout``, the full-sequence forward (``trunk_apply``,
``lm_apply``, ``cross_entropy``, ``lm_loss``) that BERT encoding and the
decoders' scoring run cache-free and the decoders' cached path runs over
a contiguous cache (``trunk_cache_init``, ``lm_prefill``,
``lm_decode_step``), and the decoders' two serving steps over the page
pool: the padded block (``lm_prefill_chunk_paged``, the engine's oracle
mode) and the ragged stream (``trunk_apply_ragged``,
``lm_step_ragged``).  The decoders are the dense family, the
vision-language family (``vlm``: a dense trunk whose full-sequence
forward takes the frontend's patch embeddings, ``prefix_embed`` (B, Lp,
D), ahead of the tokens; the ragged step serves it as text, as the
reference's does) and the MoE family,
whose layers run ``models/moe.py::moe_apply`` in place of the MLP; the
full-sequence forward sums the MoE layers' load-balancing losses
(``aux``) and ``lm_loss`` adds ``cfg.router_aux_weight`` times it, as the
reference.

Parameters are one flat dict (``params.py``): per-layer weights are stacked
on a leading layer axis in layer order, and layer ``i`` reads the views
``w[i]``; layer ``n·len(pattern) + j`` is the reference's scanned
``periods/{j}`` leaf ``[n]``.  The page pool is one stack in layer order
too: ``k``/``v`` are (L, N+1, Hkv, ps, Dh), int8 scales (L, N+1, Hkv, ps)
f32, and page ``N`` is the scratch page; a layer's kind
(``cfg.layer_kinds()``) decides only its window and RoPE theta.  The
contiguous cache is the same stack with batch rows for pages and
``max_len`` rows for a page (one function builds both, as in the
reference), plus ``ring_*`` leaves for the local layers that keep a ring
buffer (``layers.attn_cache_init``), which the pool never holds
(``serving/paged.py::check_pageable``).

Every layer is pre-norm, as the reference's ``_layer_apply`` is for every
family — BERT included: the reference never reads ``cfg.postnorm`` on this
path, so its "BERT" is a pre-LN encoder with a final LayerNorm, and the
port computes the same.  ``post_block_norm`` (gemma) adds a norm on the
attention output and one on the MLP output, each before its residual add.

The SSM families run the same entry points without the ragged step (the
page pool cannot hold O(1) state: ``serving/paged.py::check_pageable``):
a Mamba layer is pre-norm (one ``ln``) around ``models/mamba.py::
mamba_apply`` (falcon-mamba, ``family="ssm"``) or ``models/mamba2.py::
mamba2_apply`` (zamba2, ``family="hybrid"``) plus the residual.  The
hybrid's shared attention + MLP block (one set of ``shared_*`` weights)
runs before the Mamba layers of every whole period of ``hybrid_period``;
the tail layers after the last period run without it.  Its contiguous
cache holds each layer's ``conv`` and ``h`` / ``S`` state and one
``k``/``v`` per period for the shared block, the batch on axis 1 of
every leaf as in the attention caches.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.attention_api import ragged_kernel_config
from repro_torch.device import configure_matmul_precision
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.paged_attention.varlen import varlen_layout
from repro_torch.models import layers as L
from repro_torch.models.mamba import MAMBA_KEYS, mamba_apply, mamba_cache_init
from repro_torch.models.mamba2 import (MAMBA2_KEYS, mamba2_apply,
                                       mamba2_cache_init)
from repro_torch.models.moe import moe_apply
from repro_torch.parallel.collectives import all_reduce
from repro_torch.parallel.ctx import maybe_shard

Params = Dict[str, torch.Tensor]
SSM_FAMILIES = ("ssm", "hybrid")
# the attention decoders: the page pool and the ragged step serve these
DECODER_FAMILIES = ("dense", "vlm", "moe")


def layer_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The per-layer parameter keys of ``cfg``: an attention block's
    (``block_keys``), or a Mamba layer's norm and mixer leaves."""
    if cfg.family in SSM_FAMILIES:
        keys = MAMBA2_KEYS if cfg.ssm_variant == "mamba2" else MAMBA_KEYS
        return tuple(keys) + (("ln_b",) if cfg.norm == "layernorm" else ())
    return block_keys(cfg)


def shared_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The hybrid's shared attention block: ``shared_<key>`` for each key
    of ``block_keys``, one set for the whole model (none elsewhere)."""
    if cfg.family != "hybrid":
        return ()
    return tuple("shared_" + k for k in block_keys(cfg))


def block_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """An attention block's parameter keys: weights (an MoE layer's
    ``router`` and its experts' ``up`` / ``down`` / ``gate`` in place of
    the MLP's), then the biases of biased projections and LayerNorms
    (``<weight>_b``)."""
    moe = cfg.family == "moe"
    keys = ["ln1", "wq", "wk", "wv", "wo", "ln2"]
    keys += ["router", "up", "down"] if moe else ["up", "down"]
    if cfg.mlp_gated:
        keys.append("gate")
    if cfg.qk_norm:
        keys += ["q_norm", "k_norm"]
    if cfg.post_block_norm:
        keys += ["ln1_post", "ln2_post"]
    if cfg.attn_bias:
        keys += ["wq_b", "wk_b", "wv_b"]
        if not (cfg.mlp_gated or moe):
            keys += ["up_b", "down_b"]
    if cfg.norm == "layernorm":
        keys += ["ln1_b", "ln2_b"]
        if cfg.post_block_norm:
            keys += ["ln1_post_b", "ln2_post_b"]
    return tuple(keys)


def period_layout(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, int]:
    """→ (kinds within one period, n full periods, n tail layers), as the
    reference's: one period is one cycle of ``cfg.pattern``, or for the
    hybrid ``hybrid_period`` Mamba layers.  Only the hybrid may leave a
    tail (zamba2: 6 periods of 6 and 2 more); elsewhere a tail raises, as
    no other config the port registers has one."""
    if cfg.family == "hybrid":
        kinds = ("mamba",) * max(cfg.hybrid_period, 1)
        return (kinds,) + divmod(cfg.num_layers, len(kinds))
    if cfg.family not in DECODER_FAMILIES + ("bert", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the LM trunk runs the dense, vlm, moe, "
            f"ssm, hybrid and bert families; an encoder-decoder runs "
            f"models/encdec.py")
    kinds = cfg.pattern
    bad = sorted(set(kinds) - ({"mamba"} if cfg.family == "ssm"
                               else {"local", "global"}))
    if bad:
        raise NotImplementedError(f"{cfg.name}: layer kinds {bad}: the port "
                                  f"runs local and global attention layers "
                                  f"and the SSM family's mamba layers")
    nper, tail = divmod(cfg.num_layers, len(kinds))
    if tail:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.num_layers} layers leave a tail of {tail} "
            f"after {nper} periods of {kinds}; the port has no tail layers "
            f"outside the hybrid")
    return kinds, nper, tail


def _ragged_family(cfg: ModelConfig) -> Tuple[str, ...]:
    """The ragged serving path serves the dense, vlm and MoE decoders,
    whose layers are local or global attention; → the kind of every
    layer."""
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: ragged serving runs the dense, vlm and "
            f"moe decoders only")
    period_layout(cfg)
    return cfg.layer_kinds()


def _layer(cfg: ModelConfig, params: Params, i: int) -> Params:
    return {k: params[k][i] for k in layer_keys(cfg)}


def _shared(cfg: ModelConfig, params: Params) -> Params:
    """The hybrid's shared block under ``block_keys``' names."""
    return {k[len("shared_"):]: params[k] for k in shared_keys(cfg)}


def _block(cfg: ModelConfig, p: Params, x: torch.Tensor,
           attend: Callable[[torch.Tensor], torch.Tensor], *,
           with_aux: bool = False, dp_axes=()
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer: pre-norm attention (``attend`` of the normed stream),
    then the pre-norm MLP — or, for the MoE family, the experts — each
    through its post-block norm where the config has one, each added to
    the residual stream → (x, the MoE layer's load-balancing loss with
    ``with_aux``, else None; over the global batch of ``dp_axes``)."""
    def post(name, h):
        return L.norm(cfg, p, name, h) if cfg.post_block_norm else h
    x = x + post("ln1_post", attend(L.norm(cfg, p, "ln1", x)))
    h = L.norm(cfg, p, "ln2", x)
    aux = None
    if cfg.family == "moe":
        h, aux = moe_apply(cfg, p, h, with_aux=with_aux, dp_axes=dp_axes)
    else:
        h = L.mlp_apply(cfg, p, h)
    return x + post("ln2_post", h), aux


# --------------------------------------------------------------------------
# full-sequence forward, cache-free or over a contiguous cache
# --------------------------------------------------------------------------

def layer_caches(cfg: ModelConfig, caches: Dict[str, torch.Tensor]
                 ) -> List[Dict[str, torch.Tensor]]:
    """Each layer's views of the stacked contiguous cache, in layer order:
    a local layer's ring leaves where the cache has them, else the next
    layer of the ``k``/``v`` (and int8 ``ks``/``vs``) stack; a Mamba
    layer's ``conv`` and ``h`` (Mamba-1) or ``S`` (Mamba-2)."""
    if cfg.family in SSM_FAMILIES:
        state = "S" if cfg.ssm_variant == "mamba2" else "h"
        return [{"conv": caches["conv"][i], state: caches[state][i]}
                for i in range(cfg.num_layers)]
    ring = "ring_pos" in caches
    flat = [k for k in ("k", "v", "ks", "vs") if k in caches]
    out, i_flat, i_ring = [], 0, 0
    for kind in cfg.layer_kinds():
        if ring and kind == "local":
            out.append({"k": caches["ring_k"][i_ring],
                        "v": caches["ring_v"][i_ring],
                        "pos": caches["ring_pos"][i_ring]})
            i_ring += 1
        else:
            out.append({k: caches[k][i_flat] for k in flat})
            i_flat += 1
    return out


def trunk_apply(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                pos: torch.Tensor, causal: bool = True,
                caches: Optional[Dict[str, torch.Tensor]] = None,
                cache_index=None, with_aux: bool = False,
                page_table: Optional[torch.Tensor] = None,
                q_len: Optional[torch.Tensor] = None,
                tp_axis=None, dp_axes=()
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Every layer (``_block``) over the whole sequence; with ``caches``
    (``trunk_cache_init``) each layer writes its K/V rows at
    ``cache_index`` in place and attends over its cache → (x, with
    ``with_aux`` the f32 sum of the MoE layers' load-balancing losses —
    0 for a dense trunk —, else None).  With a ``page_table`` (B, P)
    ``caches`` is the page pool and x a right-aligned block of ``q_len``
    (B,) live rows per lane (``layers.attn_apply``'s padded branch); an
    MoE layer routes every row of the block, padding included, as the
    reference.  A training step on a mesh passes ``tp_axis`` (the
    cache-free attention of each layer whose KV heads divide it runs on
    this rank's head band, ``layers.attn_apply``) and ``dp_axes`` (the
    axes whose ranks hold the other rows of the batch: the MoE
    load-balancing statistics are the global batch's)."""
    if page_table is not None:
        _ragged_family(cfg)
    if cfg.family in SSM_FAMILIES:
        x = _ssm_trunk(cfg, params, x, pos=pos, causal=causal, caches=caches,
                       cache_index=cache_index, tp_axis=tp_axis)
        return x, (torch.zeros((), dtype=torch.float32, device=x.device)
                   if with_aux else None)
    period_layout(cfg)
    views = (layer_caches(cfg, caches) if caches is not None
             else [None] * cfg.num_layers)
    aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                 if with_aux else None)
    for i, kind in enumerate(cfg.layer_kinds()):
        # the reference's sequence-parallel carry constraint (lm.py:181)
        x = maybe_shard(x, ("dp", "sp", None))
        p = _layer(cfg, params, i)
        x, aux = _block(cfg, p, x, lambda h: L.attn_apply(
            cfg, p, h, pos=pos, kind=kind, causal=causal, cache=views[i],
            cache_index=cache_index, page_table=page_table, q_len=q_len,
            tp_axis=tp_axis), with_aux=with_aux, dp_axes=dp_axes)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _ssm_trunk(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
               pos: torch.Tensor, causal: bool,
               caches: Optional[Dict[str, torch.Tensor]], cache_index,
               tp_axis=None) -> torch.Tensor:
    """The SSM families' trunk: every Mamba layer pre-norm around its
    mixer plus the residual; for the hybrid, the shared block (global
    attention over period ``j``'s ``k``/``v`` with a cache) before the
    layers of each whole period ``j``, none before the tail."""
    kinds, nper, _ = period_layout(cfg)
    apply = mamba2_apply if cfg.ssm_variant == "mamba2" else mamba_apply
    views = (layer_caches(cfg, caches) if caches is not None
             else [None] * cfg.num_layers)
    shared = _shared(cfg, params)
    kv = [k for k in ("k", "v", "ks", "vs") if caches is not None and k in caches]
    for i in range(cfg.num_layers):
        j, slot = divmod(i, len(kinds))
        if shared and slot == 0 and j < nper:
            view = {k: caches[k][j] for k in kv} if caches is not None else None
            x, _ = _block(cfg, shared, x, lambda h: L.attn_apply(
                cfg, shared, h, pos=pos, kind="global", causal=causal,
                cache=view, cache_index=cache_index, tp_axis=tp_axis))
        p = _layer(cfg, params, i)
        x = x + apply(cfg, p, L.norm(cfg, p, "ln", x), cache=views[i])
    return x


def positions(n: int, cache_index, device) -> torch.Tensor:
    """Rows 0..n-1 past ``cache_index`` (None: 0): (n,) int32 positions
    for an int, (B, n) for a (B,) tensor, one row per batch row."""
    pos = torch.arange(n, dtype=torch.int32, device=device)
    if isinstance(cache_index, torch.Tensor):
        return cache_index.to(torch.int32).reshape(-1, 1) + pos[None]
    return pos if cache_index is None else pos + int(cache_index)


def lm_apply(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
             prefix_embed: Optional[torch.Tensor] = None,
             causal: bool = True,
             caches: Optional[Dict[str, torch.Tensor]] = None,
             cache_index=None,
             logits_rows: Optional[int] = None, with_aux: bool = False,
             page_table: Optional[torch.Tensor] = None,
             q_len: Optional[torch.Tensor] = None,
             tp_axis=None, dp_axes=()):
    """tokens (B, L) → f32 logits (B, L', V) (the reference's ``lm_apply``),
    or with ``with_aux`` (logits, the summed MoE load-balancing loss).
    ``prefix_embed`` (B, Lp, D) (vlm patches) is cast to the stream's dtype
    and prepended to the token embeddings, so L' = Lp + L and the tokens
    sit at positions Lp.. past the offset.  Without ``caches``: positions
    0..L'-1.  With them, the rows sit at ``cache_index`` + 0..L'-1,
    ``cache_index`` an int or (B,) (each batch row its own position, (B,
    L') positions), and every layer writes its K/V rows into ``caches`` in
    place.  ``logits_rows=n`` unembeds only the last n positions (the
    (B, L', V) logits are the largest activation).  ``page_table`` (B, P)
    and ``q_len`` (B,): ``caches`` is the page pool and the tokens a
    right-aligned block (``lm_prefill_chunk_paged``).  ``tp_axis`` /
    ``dp_axes``: a training step on a mesh (``trunk_apply``)."""
    if tokens.device.type == "cuda":
        configure_matmul_precision()
    lp = 0 if prefix_embed is None else prefix_embed.shape[1]
    pos = positions(lp + tokens.shape[1], cache_index, tokens.device)
    x = L.embed_full(cfg, params, tokens, pos[..., lp:])
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
    x, aux = trunk_apply(cfg, params, x, pos=pos, causal=causal,
                         caches=caches, cache_index=cache_index,
                         with_aux=with_aux, page_table=page_table,
                         q_len=q_len, tp_axis=tp_axis, dp_axes=dp_axes)
    x = L.norm(cfg, params, "final_norm", x)
    if logits_rows is not None:
        x = x[:, -logits_rows:]
    logits = L.unembed(cfg, params, x)
    # the reference keeps the vocab dim sharded through the loss (lm.py:293)
    logits = maybe_shard(logits, ("dp", None, "tp"))
    return (logits, aux) if with_aux else logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  dp_axes=()) -> torch.Tensor:
    """Mean token cross-entropy in f32 (masked mean with ``mask``).

    ``dp_axes``: the mesh axes over which the ranks hold equal blocks of
    the batch's rows.  The result is then this rank's term of the global
    loss, whose mean over those ranks is the global batch's: the mean of
    its rows, or with a mask its masked numerator over the global mask's
    sum, times the ranks' count."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        den, n = torch.sum(mask), 1
        for a in dp_axes:
            den, n = all_reduce(den, "sum", a), n * a.size
        return torch.sum(nll * mask) / torch.clamp(den, min=1.0) * n
    return torch.mean(nll)


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, tp_axis=None, dp_axes=()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of the causal LM: the tokens' logits at 0..L-2
    against tokens 1..L-1 (behind a ``prefix_embed`` of the batch, whose
    rows score nothing), plus ``cfg.router_aux_weight`` times the MoE
    load-balancing loss (0 for a dense model) → (loss, {"ce", "aux"}).
    ``tp_axis`` / ``dp_axes``: a training step on a mesh (``lm_apply``,
    ``cross_entropy``)."""
    tokens, prefix = batch["tokens"], batch.get("prefix_embed")
    logits, aux = lm_apply(cfg, params, tokens, prefix_embed=prefix,
                           with_aux=True, tp_axis=tp_axis, dp_axes=dp_axes)
    logits = logits[:, logits.shape[1] - tokens.shape[1]:]
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:], batch.get("loss_mask"),
                       dp_axes)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


def lm_prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               caches: Dict[str, torch.Tensor], *,
               prefix_embed: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fill the caches from position 0 (port of the reference's
    ``lm_prefill``), ``prefix_embed``'s Lp rows ahead of the tokens →
    (last-position f32 logits (B, V), caches), the caches written in
    place; the next decode index is Lp + L.  The cache index is the host
    int 0, so every layer's lengths are static: on the card ``auto`` runs
    each layer on the streaming-attention kernel.  Only the last row is
    unembedded."""
    logits = lm_apply(cfg, params, tokens, prefix_embed=prefix_embed,
                      caches=caches, cache_index=0, logits_rows=1)
    return logits[:, -1], caches


def lm_decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                   caches: Dict[str, torch.Tensor], index
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token (B,) at absolute position ``index`` — an int, or (B,), one
    per batch row — → (f32 logits (B, V), caches), the caches written in
    place (port of the reference's ``lm_decode_step``)."""
    logits = lm_apply(cfg, params, token[:, None], caches=caches,
                      cache_index=index)
    return logits[:, -1], caches


def lm_prefill_chunk_paged(cfg: ModelConfig, params: Params,
                           tokens: torch.Tensor,
                           caches: Dict[str, torch.Tensor],
                           page_table: torch.Tensor, kv_len: torch.Tensor,
                           q_len: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The padded-block serving step (port of the reference's
    ``lm_prefill_chunk_paged``): a right-aligned (B, C) block of tokens
    per lane — ``q_len[b]`` live tokens ending at row ``kv_len[b] - 1``,
    the rest left-padding.  Decode lanes are ``q_len == 1``, prefill
    lanes a chunk of ``q_len <= C`` prompt tokens, idle lanes ``q_len ==
    0`` (``kv_len`` 0).  Every live row's K/V is written in place at its
    (page, offset) through ``page_table`` (B, P) and attention runs
    through the table (kernel #2's block entry on the card); padding rows
    write to the pool's scratch page.  → (the last row's f32 logits
    (B, V), caches), the pool written in place.  The last row is the
    lane's newest live token, so the caller samples from it exactly when
    the step consumed the lane's final known token."""
    c = tokens.shape[1]
    offset = kv_len.to(torch.int32) - c                 # the block's start
    logits = lm_apply(cfg, params, tokens, caches=caches,
                      cache_index=offset, page_table=page_table,
                      q_len=q_len.to(torch.int32), logits_rows=1)
    return logits[:, -1], caches


# --------------------------------------------------------------------------
# caches and the ragged serving step
# --------------------------------------------------------------------------


def trunk_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """The decoders' KV cache, stacked in layer order: ``k``/``v``
    (L', batch, Hkv, max_len, Dh), int8 with f32 row scales ``ks``/``vs``
    (L', batch, Hkv, max_len) under ``cfg.kv_quant``, over the L' layers
    without a ring buffer, and, where local layers keep one
    (``layers.is_ring``), ``ring_k``/``ring_v`` (Lr, batch, Hkv, window,
    Dh) and ``ring_pos`` (Lr, batch, window) over those.  The page pool is
    this cache with a page per batch row and ``max_len`` = the page size
    (the last page the scratch page); the pool never has ring leaves.

    The SSM families' cache (``serving/engine.py``'s slots; the pool
    refuses it) is each Mamba layer's state, stacked: ``conv`` (L, batch,
    K-1, C) in the model dtype, ``h`` (L, batch, d_inner, n) or ``S`` (L,
    batch, H, N, P) in f32; for the hybrid also the shared block's
    ``k``/``v`` (periods, batch, Hkv, max_len, Dh) (int8 with ``ks``/``vs``
    under ``cfg.kv_quant``), one per period."""
    if cfg.family in SSM_FAMILIES:
        init = (mamba2_cache_init if cfg.ssm_variant == "mamba2"
                else mamba_cache_init)
        c = init(cfg, batch, cfg.num_layers, device=device)
        if cfg.family == "hybrid":
            nper = period_layout(cfg)[1]
            c.update({k: v[None].expand((nper,) + v.shape).clone()
                      for k, v in L.attn_cache_init(cfg, batch, max_len,
                                                    device=device).items()})
        return c
    period_layout(cfg)
    kinds = cfg.layer_kinds()
    n_ring = sum(L.is_ring(cfg, kind, max_len) for kind in kinds)

    def stacked(leaves, n):
        return {k: v[None].expand((n,) + v.shape).clone()
                for k, v in leaves.items()}
    c = stacked(L.attn_cache_init(cfg, batch, max_len, device=device),
                len(kinds) - n_ring)
    if n_ring:
        ring = stacked(L.attn_cache_init(cfg, batch, max_len, kind="local",
                                         device=device), n_ring)
        c.update({f"ring_{k}": v for k, v in ring.items()})
    return c


def trunk_apply_ragged(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                       pos: torch.Tensor, caches: Dict[str, torch.Tensor],
                       token_pages: torch.Tensor,
                       cu_seqlens: Optional[torch.Tensor],
                       kernel_config: Optional[KernelConfig] = None,
                       attend: Optional[Callable] = None,
                       tp_axis=None) -> torch.Tensor:
    """Every layer over the packed stream, writing its pool rows in place.
    The lane boundaries are validated and cut into q-blocks of
    ``kernel_config.block_q`` rows once, here, for all layers (the
    reference's ``jit`` hoists the same work).  An MoE layer routes every
    row of the stream, dead padding rows included, as the reference; the
    load-balancing loss is not computed (the reference drops it).
    ``tp_axis``: every attention layer attends this rank's head band
    (``layers.attn_apply_ragged``)."""
    kernel_config = ragged_kernel_config(kernel_config, x.device.type)
    layout = varlen_layout(cu_seqlens, pos, x.shape[1],
                           kernel_config.block_q, x.device)
    views = layer_caches(cfg, caches)
    for i, kind in enumerate(_ragged_family(cfg)):
        # the reference's sequence-parallel carry constraint (lm.py:181)
        x = maybe_shard(x, ("dp", "sp", None))
        p = _layer(cfg, params, i)
        x, _ = _block(cfg, p, x, lambda h: L.attn_apply_ragged(
            cfg, p, h, pos=pos, kind=kind, cache=views[i],
            token_pages=token_pages, cu_seqlens=cu_seqlens,
            kernel_config=kernel_config, attend=attend, layout=layout,
            tp_axis=tp_axis))
    return x


def lm_step_ragged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   caches: Dict[str, torch.Tensor], token_pages: torch.Tensor,
                   pos: torch.Tensor, last_idx: torch.Tensor,
                   cu_seqlens: Optional[torch.Tensor] = None,
                   kernel_config: Optional[KernelConfig] = None, *,
                   greedy: bool = False,
                   sampling: Optional[Dict[str, torch.Tensor]] = None,
                   attend: Optional[Callable] = None,
                   tp_axis=None) -> torch.Tensor:
    """The token-level (ragged) serving step over one packed (T,) stream.

    ``tokens``/``pos`` (T,), ``token_pages`` (T, P), ``last_idx`` (lanes,)
    stream index of each lane's last token, or (lanes, 1 + k) for a
    speculative verify step: row j of a lane is its decode row plus its
    j-th drafted row.  Writes every token's KV rows into ``caches`` in
    place and returns the f32 logits of the ``last_idx`` rows, (lanes, V)
    or (lanes, 1 + k, V) — or, with ``greedy=True``, the int32 greedy picks
    of ``last_idx``'s shape, chosen on the device so only the picks leave
    it.  ``sampling`` — per-lane tensors ``{temperature, top_k, top_p, seed,
    counter}``, each (lanes,) — returns the picks of the in-step sampler
    instead (``serving/sampling.py::sample_in_step``; a verify lane's rows
    ≥ 1 greedy).  ``kernel_config`` is the varlen attention's block shapes
    (``kernels/autotune.py``; ``None`` consults the tuner's active config).
    ``attend`` replaces the varlen attention (default: through the kernel
    wrapper).

    ``tp_axis`` — a mesh axis or process group — when this rank of
    ``EngineCore(mesh=N)`` holds one KV-head band of the pool: every
    attention layer (the dense, MoE and vlm trunks alike) attends its
    band and all-gathers the head axis (``layers.attn_apply_ragged``);
    embed, norms, MLP / experts, unembed and sampling run replicated and
    unchanged.
    """
    if last_idx.dim() not in (1, 2):
        raise ValueError(f"last_idx must be (lanes,) or (lanes, 1 + k), got "
                         f"shape {tuple(last_idx.shape)}")
    pos = pos.to(torch.int32)
    x = L.embed_apply(cfg, params["embed"], tokens)[None]       # (1, T, D)
    x = trunk_apply_ragged(cfg, params, x, pos=pos, caches=caches,
                           token_pages=token_pages, cu_seqlens=cu_seqlens,
                           kernel_config=kernel_config,
                           attend=attend, tp_axis=tp_axis)
    x = L.norm(cfg, params, "final_norm", x)
    # gather before unembedding: only the picked rows are needed
    x = x[0][last_idx.long()]
    logits = L.unembed(cfg, params, x)
    logits = maybe_shard(logits, ("dp", "tp") if last_idx.dim() == 1
                         else ("dp", None, "tp"))
    # Deferred import: repro_torch.serving imports this module.
    if sampling is not None:
        from repro_torch.serving.sampling import sample_in_step
        return sample_in_step(logits, **sampling)
    if greedy:
        from repro_torch.serving.sampling import greedy_rows
        return greedy_rows(logits)
    return logits
