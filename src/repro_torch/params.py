"""Parameters of the port's dense decoder.

``from_flat`` takes the reference's parameters as the flat
``{path: np.ndarray}`` dict of ``checkpoint/store.py::flatten_tree`` (numpy
only, no JAX needed); ``init_params`` draws fresh weights from the same
distributions as the reference's ``lm_init`` for runs where no reference
weights exist (the full-width run on the card).

The port's layout is one flat dict: ``embed`` (V, D), ``final_norm`` (D,),
``lm_head`` (D, V), and the per-layer leaves of
``models.lm.LAYER_KEYS`` stacked on a leading layer axis, e.g. ``wq``
(L, D, Hq·Dh) — the reference's scanned ``trunk/periods/0/...`` leaves.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.lm import LAYER_KEYS, period_layout

_LAYER_PATHS = {
    "ln1": "ln1/scale", "ln2": "ln2/scale",
    "wq": "attn/wq/w", "wk": "attn/wk/w", "wv": "attn/wv/w",
    "wo": "attn/wo/w",
    "up": "mlp/up/w", "gate": "mlp/gate/w", "down": "mlp/down/w",
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
    paths = {"embed": "embed/tokens", "final_norm": "final_norm/scale",
             "lm_head": "lm_head/w"}
    for k in LAYER_KEYS:
        paths[k] = "trunk/periods/0/" + _LAYER_PATHS[k]
    return paths


def from_flat(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
              device=None) -> Dict[str, torch.Tensor]:
    """The reference's flat parameter dict → the port's parameters."""
    paths = param_paths(cfg)
    extra = sorted(set(flat) - set(paths.values()))
    if extra:
        raise ValueError(f"reference leaves the port does not model: {extra}")
    missing = sorted(set(paths.values()) - set(flat))
    if missing:
        raise KeyError(f"reference parameters lack {missing}")
    return {k: _to_torch(flat[p]).to(device) for k, p in paths.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """Random weights with ``lm_init``'s distributions: dense weights
    normal·d_in^-0.5, the token table normal·0.02, norm scales 1 (RMSNorm
    multiplies by ``1 + scale``).  Drawn in f32 one layer at a time on
    ``device`` with ``generator`` (which must live there), then cast to
    ``cfg.dtype``."""
    dt = getattr(torch, cfg.dtype)
    _, n, _ = period_layout(cfg)
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.d_head

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(dt)

    def stacked(d_in, d_out):
        w = torch.empty((n, d_in, d_out), dtype=dt, device=device)
        for i in range(n):
            w[i] = normal((d_in, d_out), d_in ** -0.5)
        return w

    p = {"embed": normal((cfg.vocab_size, d), 0.02),
         "final_norm": torch.ones((d,), dtype=dt, device=device),
         "ln1": torch.ones((n, d), dtype=dt, device=device),
         "ln2": torch.ones((n, d), dtype=dt, device=device),
         "wq": stacked(d, cfg.num_heads * dh),
         "wk": stacked(d, cfg.num_kv_heads * dh),
         "wv": stacked(d, cfg.num_kv_heads * dh),
         "wo": stacked(cfg.num_heads * dh, d),
         "up": stacked(d, f),
         "gate": stacked(d, f),
         "down": stacked(f, d),
         "lm_head": normal((d, cfg.vocab_size), d ** -0.5)}
    return p
