"""Parameters of the port's models (dense decoder and BERT encoder).

``from_flat`` takes the reference's parameters as the flat
``{path: np.ndarray}`` dict of ``checkpoint/store.py::flatten_tree`` (numpy
only, no JAX needed); ``init_params`` draws fresh weights from the same
distributions as the reference's ``lm_init`` for runs where no reference
weights exist (the full-width runs on the card).  Both are entry points
and run on the card unless the caller names the CPU.

The port's layout is one flat dict: ``embed`` (V, D), ``positions``
(max_position, D) for learned positions, ``final_norm`` (D,) [+
``final_norm_b``], ``lm_head`` (D, V) when embeddings are untied, and the
per-layer leaves of ``models.lm.layer_keys`` stacked on a leading layer
axis, e.g. ``wq`` (L, D, Hq·Dh) and its bias ``wq_b`` (L, Hq·Dh) — the
reference's scanned ``trunk/periods/0/...`` leaves.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import layer_keys, period_layout

_LAYER_PATHS = {
    "ln1": "ln1/scale", "ln2": "ln2/scale",
    "ln1_b": "ln1/bias", "ln2_b": "ln2/bias",
    "wq": "attn/wq/w", "wk": "attn/wk/w", "wv": "attn/wv/w",
    "wq_b": "attn/wq/b", "wk_b": "attn/wk/b", "wv_b": "attn/wv/b",
    "wo": "attn/wo/w",
    "up": "mlp/up/w", "gate": "mlp/gate/w", "down": "mlp/down/w",
    "up_b": "mlp/up/b", "down_b": "mlp/down/b",
}


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    """numpy → torch, exactly.  bf16 leaves (ml_dtypes arrays) cross by bit
    view: int16 bits → ``torch.bfloat16``."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def param_paths(cfg: ModelConfig) -> Dict[str, str]:
    """Port key → reference flat path."""
    period_layout(cfg)
    paths = {"embed": "embed/tokens", "final_norm": "final_norm/scale"}
    if cfg.pos_embedding == "learned":
        paths["positions"] = "embed/positions"
    if cfg.norm == "layernorm":
        paths["final_norm_b"] = "final_norm/bias"
    if not cfg.tie_embeddings:
        paths["lm_head"] = "lm_head/w"
    for k in layer_keys(cfg):
        paths[k] = "trunk/periods/0/" + _LAYER_PATHS[k]
    return paths


def from_flat(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The reference's flat parameter dict → the port's parameters on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    paths = param_paths(cfg)
    extra = sorted(set(flat) - set(paths.values()))
    if extra:
        raise ValueError(f"reference leaves the port does not model: {extra}")
    missing = sorted(set(paths.values()) - set(flat))
    if missing:
        raise KeyError(f"reference parameters lack {missing}")
    return {k: _to_torch(flat[p]).to(dev) for k, p in paths.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights with ``lm_init``'s distributions: dense weights
    normal·d_in^-0.5, biases 0, the token and position tables normal·0.02,
    norm scales 1 (RMSNorm multiplies by ``1 + scale``), LayerNorm biases
    0.  Drawn in f32 one layer at a time on ``device`` (default: the card)
    with ``generator`` (which must live there), then cast to
    ``cfg.dtype``."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    _, n, _ = period_layout(cfg)
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.d_head
    hq, hkv = cfg.num_heads * dh, cfg.num_kv_heads * dh

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * std).to(dt)

    def stacked(d_in, d_out):
        w = torch.empty((n, d_in, d_out), dtype=dt, device=dev)
        for i in range(n):
            w[i] = normal((d_in, d_out), d_in ** -0.5)
        return w

    def const(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    p = {"embed": normal((cfg.vocab_size, d), 0.02)}
    if cfg.pos_embedding == "learned":
        p["positions"] = normal((cfg.max_position, d), 0.02)
    p["final_norm"] = const((d,), 1.0)
    widths = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d),
              "up": (d, f), "gate": (d, f), "down": (f, d)}
    for k in layer_keys(cfg):
        if k in widths:
            p[k] = stacked(*widths[k])
        elif k in ("ln1", "ln2"):
            p[k] = const((n, d), 1.0)
        else:                                   # biases: <weight>_b
            w = k[:-2]
            p[k] = const((n, widths[w][1] if w in widths else d), 0.0)
    if cfg.norm == "layernorm":
        p["final_norm_b"] = const((d,), 0.0)
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    return p
