"""Encoder–decoder backbone (port of ``src/repro/models/encdec.py``:
seamless-m4t-large-v2).

The speech frontend (w2v-BERT conformer) is a stub, as in the reference:
the inputs are precomputed frame embeddings ``frames`` (B, L_src,
d_model).  The encoder is ``enc_layers`` bidirectional pre-norm blocks
(``lm._block`` with ``causal=False``, RoPE at positions 0..L_src-1) and a
final ``enc_norm``.  Each of the ``dec_layers`` decoder layers runs
``ln1`` → causal self-attention (over the contiguous cache when there is
one) → ``lnx`` → cross-attention → ``ln2`` → the MLP, each added to the
residual stream, then ``dec_norm`` and the tied unembed.

Cross-attention reads K/V that are projected **once** from the encoder
output (``cross_kvs_init``: one ``cross_wk`` / ``cross_wv`` projection
per decoder layer per prefill, stacked on the layer axis) and carried
through every decode step; neither its q nor its K get RoPE.  It is
non-causal attention of L query rows against the L_src encoder rows
through the registry (``fallback=True``): on the card a multi-row call is
the streaming-attention kernel and a decode row ``naive_decode``, as the
reference resolves them on a TPU.

Parameters (``params.py``): the encoder's block leaves ``enc_<key>``
stacked on ``enc_layers`` (``lm.block_keys``), ``enc_norm``; the
decoder's ``decoder_keys`` stacked on ``dec_layers`` — the self-attention
block's ``lm.block_keys`` without post-block norms (the reference's
decoder layer has none), ``lnx`` and the cross-attention's
``cross_w{q,k,v,o}`` —, ``dec_norm``; ``embed``, tied.  The decoder's
cache is ``encdec_cache_init``: a plain (or int8) K/V stack over the
decoder layers, written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.attention_api import attention, backend_for_config
from repro_torch.models import layers as L
from repro_torch.models.lm import (_block, block_keys, cross_entropy,
                                   positions)

Params = Dict[str, torch.Tensor]


def encoder_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The encoder's per-layer keys: ``enc_`` + each of ``block_keys``."""
    return tuple("enc_" + k for k in block_keys(cfg))


def decoder_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """A decoder layer's keys: the self-attention block's (no post-block
    norms), then ``lnx`` and the cross-attention's projections and its
    q/k/v biases."""
    keys = list(block_keys(cfg.replace(post_block_norm=False)))
    keys += ["lnx", "cross_wq", "cross_wk", "cross_wv", "cross_wo"]
    if cfg.attn_bias:
        keys += ["cross_wq_b", "cross_wk_b", "cross_wv_b"]
    if cfg.norm == "layernorm":
        keys.append("lnx_b")
    return tuple(keys)


def _layer(params: Params, keys, i: int, prefix: str = "") -> Params:
    return {k[len(prefix):]: params[k][i] for k in keys}


def _cross_kv(cfg: ModelConfig, p: Params, enc_out: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """One decoder layer's cross K/V (B, Hkv, L_src, Dh) of the encoder
    output."""
    k = L.dense_apply(p["cross_wk"], enc_out, p.get("cross_wk_b"))
    v = L.dense_apply(p["cross_wv"], enc_out, p.get("cross_wv_b"))
    return {"k": L._heads(k, cfg.num_kv_heads),
            "v": L._heads(v, cfg.num_kv_heads)}


def _cross_attn(cfg: ModelConfig, p: Params, x: torch.Tensor,
                kv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Non-causal attention of x's rows against the cross K/V."""
    b, l, _ = x.shape
    q = L._heads(L.dense_apply(p["cross_wq"], x, p.get("cross_wq_b")),
                 cfg.num_heads)
    out = attention(q, kv["k"], kv["v"],
                    backend=backend_for_config(cfg.attn_backend,
                                               cfg.attn_impl),
                    scale=cfg.attn_scale or cfg.d_head ** -0.5, causal=False,
                    block_k=cfg.block_k, exp_mode=cfg.exp_mode, fallback=True)
    out = out.transpose(1, 2).reshape(b, l, cfg.num_heads * cfg.d_head)
    return L.dense_apply(p["cross_wo"], out)


def _dec_block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                     pos: torch.Tensor, cross_kv: Dict[str, torch.Tensor],
                     cache: Optional[Params], cache_index) -> torch.Tensor:
    x = x + L.attn_apply(cfg, p, L.norm(cfg, p, "ln1", x), pos=pos,
                         causal=True, cache=cache, cache_index=cache_index)
    x = x + _cross_attn(cfg, p, L.norm(cfg, p, "lnx", x), cross_kv)
    return x + L.mlp_apply(cfg, p, L.norm(cfg, p, "ln2", x))


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, L_src, D) stub embeddings → encoder output (B, L_src, D)
    in the model dtype."""
    pos = positions(frames.shape[1], None, frames.device)
    x = frames.to(getattr(torch, cfg.dtype))
    keys = encoder_keys(cfg)
    for i in range(cfg.enc_layers):
        p = _layer(params, keys, i, "enc_")
        x, _ = _block(cfg, p, x, lambda h: L.attn_apply(
            cfg, p, h, pos=pos, causal=False))
    return L.norm(cfg, params, "enc_norm", x)


def cross_kvs_init(cfg: ModelConfig, params: Params, enc_out: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The encoder output projected to every decoder layer's cross K/V,
    stacked: ``k``/``v`` (dec_layers, B, Hkv, L_src, Dh)."""
    names = [k for k in decoder_keys(cfg)
             if k in ("cross_wk", "cross_wv", "cross_wk_b", "cross_wv_b")]
    kvs = [_cross_kv(cfg, _layer(params, names, i), enc_out)
           for i in range(cfg.dec_layers)]
    return {k: torch.stack([kv[k] for kv in kvs]) for k in ("k", "v")}


def decode_trunk(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 cross_kvs: Dict[str, torch.Tensor], *,
                 caches: Optional[Params] = None, cache_index=None,
                 logits_rows: Optional[int] = None) -> torch.Tensor:
    """tokens (B, L) at positions ``cache_index`` + 0..L-1 (0 without a
    cache; an int, or (B,) for a decode row) through every decoder layer
    → f32 logits (B, L, V), or of the last ``logits_rows`` rows.  With
    ``caches`` (``encdec_cache_init``) each layer writes its K/V rows in
    place and attends over its cache."""
    pos = positions(tokens.shape[1], cache_index, tokens.device)
    x = L.embed_full(cfg, params, tokens, pos)
    keys = decoder_keys(cfg)
    flat = [k for k in ("k", "v", "ks", "vs")
            if caches is not None and k in caches]
    for i in range(cfg.dec_layers):
        x = _dec_block_apply(
            cfg, _layer(params, keys, i), x, pos=pos,
            cross_kv={k: v[i] for k, v in cross_kvs.items()},
            cache={k: caches[k][i] for k in flat} if flat else None,
            cache_index=cache_index)
    x = L.norm(cfg, params, "dec_norm", x)
    if logits_rows is not None:
        x = x[:, -logits_rows:]
    return L.unembed(cfg, params, x)


def encdec_loss(cfg: ModelConfig, params: Params,
                batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of the decoder over ``tokens`` given the encoded
    ``frames`` → (ce, {"ce", "aux": 0})."""
    ckv = cross_kvs_init(cfg, params, encode(cfg, params, batch["frames"]))
    tokens = batch["tokens"]
    logits = decode_trunk(cfg, params, tokens, ckv)
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:], batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                              device=ce.device)}


def encdec_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> Params:
    """The decoder's self-attention cache: one layer's ``attn_cache_init``
    leaves stacked on ``dec_layers`` (``k``/``v`` (dec_layers, batch, Hkv,
    max_len, Dh), int8 with ``ks``/``vs`` under ``cfg.kv_quant``)."""
    one = L.attn_cache_init(cfg, batch, max_len, device=device)
    return {k: v[None].expand((cfg.dec_layers,) + v.shape).clone()
            for k, v in one.items()}


def encdec_prefill(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                   tokens: torch.Tensor, caches: Params
                   ) -> Tuple[torch.Tensor, Params, Dict[str, torch.Tensor]]:
    """Encode, project the cross K/V once, prefill the decoder from
    position 0 → (last-row f32 logits (B, V), the caches written in place,
    the cross K/V).  The cache index is the host int 0, so on the card
    every multi-row attention of the prefill is the streaming-attention
    kernel."""
    ckv = cross_kvs_init(cfg, params, encode(cfg, params, frames))
    logits = decode_trunk(cfg, params, tokens, ckv, caches=caches,
                          cache_index=0, logits_rows=1)
    return logits[:, -1], caches, ckv


def encdec_decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                       caches: Params, cross_kvs: Dict[str, torch.Tensor],
                       index) -> Tuple[torch.Tensor, Params]:
    """One token (B,) at position ``index`` (an int or (B,)) against the
    carried cross K/V → (f32 logits (B, V), the caches written in place)."""
    logits = decode_trunk(cfg, params, token[:, None], cross_kvs,
                          caches=caches, cache_index=index)
    return logits[:, -1], caches
