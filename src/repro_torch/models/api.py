"""Uniform model API (port of ``src/repro/models/api.py``):
``build_model(cfg)`` → a ``Model`` with ``init``, ``loss``,
``init_cache``, ``prefill``, ``decode_step`` and ``step_ragged``.

Three families: ``bert`` (``prefill`` encodes a batch and returns the
logits of every position; ``loss`` is the masked-LM cross-entropy against
``labels``), ``dense`` and ``moe`` (``loss`` scores a batch causally:
next-token cross-entropy, or against ``labels`` of the tokens' shape,
plus ``cfg.router_aux_weight`` times the MoE load-balancing loss; the
MoE decoder has the dense one's entries, its layers' MLPs replaced by
``models/moe.py``), ``ssm`` (falcon-mamba: Mamba-1 layers,
``models/mamba.py``) and ``hybrid`` (zamba2: Mamba-2 layers,
``models/mamba2.py``, and a shared attention block), whose O(1) state
the page pool cannot hold: they have every entry but ``step_ragged``
and are served by the slot engine.  All run the
forward ``models.lm.lm_apply``, whose attention goes through the registry
(``cfg.attn_backend``) to the CUDA streaming-attention kernel on the card.
Inference only: the kernel has no backward yet.

The decoders' cached path: ``init_cache(batch, max_len)`` builds the
contiguous cache (``lm.trunk_cache_init``: ring buffers for local layers
whose window is below ``max_len``, int8 under ``cfg.kv_quant``) on the
card unless ``device`` says otherwise; ``prefill(params, {"tokens": (B,
L)}, caches)`` fills it from position 0 and ``decode_step(params, token
(B,), caches, index)`` appends one row at ``index`` (an int or (B,)),
each → (last-row f32 logits (B, V), caches), the caches written in place
(the reference returns new ones).  ``step_ragged`` is
``lm.lm_step_ragged``, the paged serving step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.attention_api import backend_for_config, get_backend
from repro_torch.device import resolve_device
from repro_torch.models import lm as LM
from repro_torch.params import init_params

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]              # (generator, device=None) → params
    loss: Callable[[Params, Batch], Tuple[torch.Tensor, Dict]]
    init_cache: Optional[Callable] = None    # (batch, max_len, device=None) → caches
    prefill: Optional[Callable] = None       # (params, batch, caches) → (logits, state)
    decode_step: Optional[Callable] = None   # (params, token, state, index) → (logits, state)
    # (params, tokens (T,), pools, token_pages (T, P), pos (T,), last_idx
    # (lanes,) or (lanes, 1+k), ...) → logits: the ragged serving step
    step_ragged: Optional[Callable] = None


def _bert_loss(cfg, params, batch):
    logits = LM.lm_apply(cfg, params, batch["tokens"], causal=False)
    ce = LM.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def _bert_encode(cfg, params, batch, caches=None):
    return LM.lm_apply(cfg, params, batch["tokens"], causal=False), caches


def _lm_loss_with_labels(cfg, params, batch):
    labels = batch.get("labels")
    if labels is not None and labels.shape == batch["tokens"].shape:
        logits, aux = LM.lm_apply(cfg, params, batch["tokens"], with_aux=True)
        ce = LM.cross_entropy(logits, labels, batch.get("loss_mask"))
        return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}
    return LM.lm_loss(cfg, params, batch)


def _init_cache(cfg, batch, max_len, device=None):
    return LM.trunk_cache_init(cfg, batch, max_len, resolve_device(device))


def _lm_prefill(cfg, params, batch, caches):
    return LM.lm_prefill(cfg, params, batch["tokens"], caches)


def build_model(cfg: ModelConfig) -> Model:
    # Fail fast on a mistyped backend name (resolution itself is per call).
    name = backend_for_config(cfg.attn_backend, cfg.attn_impl)
    if name != "auto":
        get_backend(name)
    init = functools.partial(init_params, cfg)
    if cfg.family == "bert":
        return Model(cfg=cfg, init=init,
                     loss=functools.partial(_bert_loss, cfg),
                     prefill=functools.partial(_bert_encode, cfg),
                     decode_step=None)   # encoder-only: no decode step
    if cfg.family in ("dense", "moe", "ssm", "hybrid"):
        ragged = cfg.family in ("dense", "moe")
        return Model(cfg=cfg, init=init,
                     loss=functools.partial(_lm_loss_with_labels, cfg),
                     init_cache=functools.partial(_init_cache, cfg),
                     prefill=functools.partial(_lm_prefill, cfg),
                     decode_step=functools.partial(LM.lm_decode_step, cfg),
                     step_ragged=(functools.partial(LM.lm_step_ragged, cfg)
                                  if ragged else None))
    raise NotImplementedError(
        f"family {cfg.family!r}: the port builds the dense, moe, ssm, "
        f"hybrid and bert families only; the other families are a later "
        f"slice")
