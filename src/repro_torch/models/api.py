"""Uniform model API (port of ``src/repro/models/api.py``):
``build_model(cfg)`` → a ``Model`` with ``init``, ``loss`` and ``prefill``.

Two families: ``bert`` (``prefill`` encodes a batch and returns the logits
of every position; ``loss`` is the masked-LM cross-entropy against
``labels``) and ``dense`` (``loss`` scores a batch causally: next-token
cross-entropy, or against ``labels`` of the tokens' shape).  Every entry
point runs the cache-free forward ``models.lm.lm_apply``, whose attention
goes through the registry (``cfg.attn_backend``) to the CUDA
streaming-attention kernel on the card.  Inference only: the kernel has no
backward yet.  The dense cached ``prefill`` and ``decode_step`` raise
``NotImplementedError``; serving runs through ``serving.EngineCore``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.attention_api import backend_for_config, get_backend
from repro_torch.models import lm as LM
from repro_torch.params import init_params

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]              # (generator, device=None) → params
    loss: Callable[[Params, Batch], Tuple[torch.Tensor, Dict]]
    prefill: Optional[Callable] = None       # (params, batch, caches) → (logits, state)
    decode_step: Optional[Callable] = None   # (params, token, state, index) → (logits, state)


def _bert_loss(cfg, params, batch):
    logits = LM.lm_apply(cfg, params, batch["tokens"], causal=False)
    ce = LM.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def _bert_encode(cfg, params, batch, caches=None):
    return LM.lm_apply(cfg, params, batch["tokens"], causal=False), caches


def _lm_loss_with_labels(cfg, params, batch):
    labels = batch.get("labels")
    if labels is not None and labels.shape == batch["tokens"].shape:
        logits = LM.lm_apply(cfg, params, batch["tokens"])
        ce = LM.cross_entropy(logits, labels, batch.get("loss_mask"))
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}
    return LM.lm_loss(cfg, params, batch)


def _later(what: str):
    def entry(*a, **k):
        raise NotImplementedError(
            f"{what} is not ported yet: it lands with the dense cached-path "
            f"slice of the PyTorch port (ROADMAP.md); serve through "
            f"repro_torch.serving.EngineCore")
    return entry


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
    if cfg.family == "dense":
        return Model(cfg=cfg, init=init,
                     loss=functools.partial(_lm_loss_with_labels, cfg),
                     prefill=_later("the dense cached prefill"),
                     decode_step=_later("the dense cached decode step"))
    raise NotImplementedError(
        f"family {cfg.family!r}: the port builds the dense and bert families "
        f"only; the other families are a later slice")
