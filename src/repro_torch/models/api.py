"""Uniform model API (port of ``src/repro/models/api.py``):
``build_model(cfg)`` → a ``Model`` with ``init``, ``loss``,
``init_cache``, ``prefill``, ``decode_step``, ``prefill_chunk_paged``
and ``step_ragged``; and
``init_params``, ``batch_specs``, ``cache_specs`` and ``input_specs``.

The families: ``bert`` (``prefill`` encodes a batch and returns the
logits of every position; ``loss`` is the masked-LM cross-entropy against
``labels``), ``dense``, ``vlm`` and ``moe`` (``loss`` scores a batch
causally: next-token cross-entropy, or against ``labels`` of the tokens'
shape, plus ``cfg.router_aux_weight`` times the MoE load-balancing loss;
the MoE decoder has the dense one's entries, its layers' MLPs replaced by
``models/moe.py``; a vlm batch may carry ``prefix_embed`` (B, Lp, D),
the frontend's patch embeddings ahead of the tokens, whose rows ``loss``
does not score), ``ssm`` (falcon-mamba: Mamba-1 layers,
``models/mamba.py``) and ``hybrid`` (zamba2: Mamba-2 layers,
``models/mamba2.py``, and a shared attention block), whose O(1) state
the page pool cannot hold: they have every entry but the two paged steps
and are served by the slot engine; and ``encdec`` (seamless-m4t:
``models/encdec.py``), whose batch carries ``frames`` (B, L_src, D), the
stub audio frontend's embeddings: ``loss``, ``init_cache``, ``prefill``
and ``decode_step`` only, as in the reference, which serves it through no
engine.  The forward's attention goes through the registry
(``cfg.attn_backend``) to the CUDA streaming-attention kernel on the card,
and ``loss`` differentiates: every attention backward of a training step
runs the kernel's backward (``runtime/trainer.py``).  On a mesh the
trainer calls ``loss(params, batch, tp_axis=, dp_axes=)``: each layer's
attention on this rank's head band, and the cross-entropy and the MoE
statistics over the data-parallel ranks' rows (``lm.lm_apply``,
``lm.cross_entropy``).

The decoders' cached path: ``init_cache(batch, max_len)`` builds the
contiguous cache (``lm.trunk_cache_init``: ring buffers for local layers
whose window is below ``max_len``, int8 under ``cfg.kv_quant``; bert's
too, which nothing reads) on the card unless ``device`` says otherwise;
``prefill(params, {"tokens": (B, L)[, "prefix_embed"]}, caches)`` fills
it from position 0 and ``decode_step(params, token (B,), caches, index)``
appends one row at ``index`` (an int or (B,); Lp + L + t behind a
prefix), each → (last-row f32 logits (B, V), caches), the caches written
in place (the reference returns new ones).  encdec's ``prefill(params,
{"frames", "tokens"}, caches)`` → (logits, ``{"self": caches, "cross":
the cross K/V}``), and its ``decode_step`` carries ``"cross"`` through
unchanged.  The attention decoders' two paged serving steps:
``step_ragged`` is ``lm.lm_step_ragged`` and ``prefill_chunk_paged``
``lm.lm_prefill_chunk_paged``, the padded block.  The reference gives
both to the SSM families too, whose O(1) state the pool cannot hold;
here they are None there.

The specs are the reference's ``jax.ShapeDtypeStruct`` stand-ins as
``torch.empty(..., device="meta")`` tensors: shapes and dtypes, no
storage.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.attention_api import backend_for_config, get_backend
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM

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
    # (params, tokens (B, C), pools, page_table (B, P), kv_len (B,),
    # q_len (B,)) → (last-row logits (B, V), pools): the padded-block
    # serving step (EngineCore mode="padded"'s workhorse)
    prefill_chunk_paged: Optional[Callable] = None
    # (params, tokens (T,), pools, token_pages (T, P), pos (T,), last_idx
    # (lanes,) or (lanes, 1+k), ...) → logits: the ragged serving step
    step_ragged: Optional[Callable] = None


def _bert_loss(cfg, params, batch, *, tp_axis=None, dp_axes=()):
    logits = LM.lm_apply(cfg, params, batch["tokens"], causal=False,
                         tp_axis=tp_axis)
    ce = LM.cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                          dp_axes)
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def _bert_encode(cfg, params, batch, caches=None):
    return LM.lm_apply(cfg, params, batch["tokens"], causal=False), caches


def _lm_loss_with_labels(cfg, params, batch, *, tp_axis=None, dp_axes=()):
    labels = batch.get("labels")
    if labels is not None and labels.shape == batch["tokens"].shape:
        prefix = batch.get("prefix_embed")
        logits, aux = LM.lm_apply(cfg, params, batch["tokens"],
                                  prefix_embed=prefix, with_aux=True,
                                  tp_axis=tp_axis, dp_axes=dp_axes)
        lp = 0 if prefix is None else prefix.shape[1]
        ce = LM.cross_entropy(logits[:, lp:], labels, batch.get("loss_mask"),
                              dp_axes)
        return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}
    return LM.lm_loss(cfg, params, batch, tp_axis=tp_axis, dp_axes=dp_axes)


def _init_cache(cfg, batch, max_len, device=None):
    init = (ED.encdec_cache_init if cfg.family == "encdec"
            else LM.trunk_cache_init)
    return init(cfg, batch, max_len, resolve_device(device))


def _lm_prefill(cfg, params, batch, caches):
    return LM.lm_prefill(cfg, params, batch["tokens"], caches,
                         prefix_embed=batch.get("prefix_embed"))


def _encdec_prefill(cfg, params, batch, caches):
    self_c = caches["self"] if "self" in caches else caches
    logits, self_c, ckv = ED.encdec_prefill(cfg, params, batch["frames"],
                                            batch["tokens"], self_c)
    return logits, {"self": self_c, "cross": ckv}


def _encdec_decode(cfg, params, token, state, index):
    logits, self_c = ED.encdec_decode_step(cfg, params, token, state["self"],
                                           state["cross"], index)
    return logits, {"self": self_c, "cross": state["cross"]}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Seeded weights of ``cfg`` with the reference's distributions
    (``params.init_params``), on the card unless ``device`` says
    otherwise."""
    # Deferred import: ``params`` imports this package's modules.
    from repro_torch.params import init_params as draw
    return draw(cfg, generator, device)


def build_model(cfg: ModelConfig) -> Model:
    # Fail fast on a mistyped backend name (resolution itself is per call).
    name = backend_for_config(cfg.attn_backend, cfg.attn_impl)
    if name != "auto":
        get_backend(name)
    init = functools.partial(init_params, cfg)
    init_cache = functools.partial(_init_cache, cfg)
    if cfg.family == "encdec":
        return Model(cfg=cfg, init=init,
                     loss=functools.partial(ED.encdec_loss, cfg),
                     init_cache=init_cache,
                     prefill=functools.partial(_encdec_prefill, cfg),
                     decode_step=functools.partial(_encdec_decode, cfg))
    if cfg.family == "bert":
        return Model(cfg=cfg, init=init,
                     loss=functools.partial(_bert_loss, cfg),
                     init_cache=init_cache,
                     prefill=functools.partial(_bert_encode, cfg),
                     decode_step=None)   # encoder-only: no decode step
    if cfg.family in LM.DECODER_FAMILIES + LM.SSM_FAMILIES:
        ragged = cfg.family in LM.DECODER_FAMILIES
        return Model(cfg=cfg, init=init,
                     loss=functools.partial(_lm_loss_with_labels, cfg),
                     init_cache=init_cache,
                     prefill=functools.partial(_lm_prefill, cfg),
                     decode_step=functools.partial(LM.lm_decode_step, cfg),
                     prefill_chunk_paged=(
                         functools.partial(LM.lm_prefill_chunk_paged, cfg)
                         if ragged else None),
                     step_ragged=(functools.partial(LM.lm_step_ragged, cfg)
                                  if ragged else None))
    raise NotImplementedError(f"family {cfg.family!r}: the port builds the "
                              f"dense, vlm, moe, ssm, hybrid, encdec and "
                              f"bert families")


# --------------------------------------------------------------------------
# shape stand-ins (meta tensors; no storage)
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int,
                with_labels: bool = True) -> Batch:
    """A training / prefill batch's stand-ins, the frontend stubs' too:
    ``frames`` (encdec) or ``prefix_embed`` (vlm), (batch, frontend_len,
    d_model) bf16."""
    specs = {"tokens": _meta((batch, seq), torch.int32)}
    if with_labels:
        specs["labels"] = _meta((batch, seq), torch.int32)
    stub = {"encdec": "frames", "vlm": "prefix_embed"}.get(cfg.family)
    if stub:
        specs[stub] = _meta((batch, cfg.frontend_len, cfg.d_model),
                            torch.bfloat16)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The cache's stand-ins: ``init_cache``'s leaves; for encdec
    ``{"self": those, "cross": the cross K/V (dec_layers, batch, Hkv,
    frontend_len, Dh)}`` in the model dtype."""
    specs = build_model(cfg).init_cache(batch, max_len, device="meta")
    if cfg.family == "encdec":
        shape = (cfg.dec_layers, batch, cfg.num_kv_heads, cfg.frontend_len,
                 cfg.d_head)
        dt = getattr(torch, cfg.dtype)
        return {"self": specs, "cross": {"k": _meta(shape, dt),
                                         "v": _meta(shape, dt)}}
    return specs


def input_specs(cfg: ModelConfig, kind: str, seq: int, batch: int) -> Dict:
    """Every input but the parameters of the step ``kind`` (train |
    prefill | decode); a vlm cache also holds the prefix's rows."""
    cache_len = seq + (cfg.frontend_len if cfg.family == "vlm" else 0)
    if kind == "train":
        return {"batch": batch_specs(cfg, batch, seq)}
    if kind == "prefill":
        return {"batch": batch_specs(cfg, batch, seq, with_labels=False),
                "caches": cache_specs(cfg, batch, cache_len)}
    if kind == "decode":
        return {"token": _meta((batch,), torch.int32),
                "state": cache_specs(cfg, batch, cache_len),
                "index": _meta((), torch.int32)}
    raise ValueError(f"unknown step kind {kind!r}")
