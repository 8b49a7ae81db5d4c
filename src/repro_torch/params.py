"""Parameters of the port's models (dense and MoE decoders, BERT encoder).

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
axis in layer order, e.g. ``wq`` (L, D, Hq·Dh) and its bias ``wq_b``
(L, Hq·Dh); an MoE layer's ``router`` (L, D, E) stays f32 and its
experts are ``up`` / ``gate`` (L, E, D, F) and ``down`` (L, E, F, D), the
reference's ``moe/...`` leaves.  The reference scans periods of
``len(cfg.pattern)`` layers: its leaf ``trunk/periods/{j}/...`` is (L / len(pattern), ...), and its
row ``n`` is the port's layer ``n·len(pattern) + j``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import layer_keys, period_layout

_LAYER_PATHS = {
    "ln1": "ln1/scale", "ln2": "ln2/scale",
    "ln1_b": "ln1/bias", "ln2_b": "ln2/bias",
    "ln1_post": "ln1_post/scale", "ln2_post": "ln2_post/scale",
    "ln1_post_b": "ln1_post/bias", "ln2_post_b": "ln2_post/bias",
    "q_norm": "attn/q_norm", "k_norm": "attn/k_norm",
    "wq": "attn/wq/w", "wk": "attn/wk/w", "wv": "attn/wv/w",
    "wq_b": "attn/wq/b", "wk_b": "attn/wk/b", "wv_b": "attn/wv/b",
    "wo": "attn/wo/w",
    "up": "mlp/up/w", "gate": "mlp/gate/w", "down": "mlp/down/w",
    "up_b": "mlp/up/b", "down_b": "mlp/down/b",
}
_MOE_PATHS = {"router": "moe/router/w", "up": "moe/up", "gate": "moe/gate",
              "down": "moe/down"}


def _to_torch(arr) -> torch.Tensor:
    """numpy → torch, exactly (a tensor passes as it is).  bf16 leaves
    (ml_dtypes arrays) cross by bit view: int16 bits → ``torch.bfloat16``."""
    if torch.is_tensor(arr):
        return arr
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def param_paths(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """Port key → the reference flat paths it is made of: one for a
    model-wide leaf; for a per-layer leaf, one per slot ``j`` of the
    period, ``trunk/periods/{j}/...``."""
    kinds, _, _ = period_layout(cfg)
    paths = {"embed": ("embed/tokens",), "final_norm": ("final_norm/scale",)}
    if cfg.pos_embedding == "learned":
        paths["positions"] = ("embed/positions",)
    if cfg.norm == "layernorm":
        paths["final_norm_b"] = ("final_norm/bias",)
    if not cfg.tie_embeddings:
        paths["lm_head"] = ("lm_head/w",)
    names = dict(_LAYER_PATHS, **(_MOE_PATHS if cfg.family == "moe" else {}))
    for k in layer_keys(cfg):
        paths[k] = tuple(f"trunk/periods/{j}/{names[k]}"
                         for j in range(len(kinds)))
    return paths


def from_flat(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The reference's flat parameter dict (numpy arrays, or CPU tensors as
    ``checkpoint.restore_flat`` gives them) → the port's parameters on
    ``device`` (default: the card): period slot ``j``'s row ``n`` becomes
    layer ``n·len(pattern) + j``."""
    dev = resolve_device(device)
    paths = param_paths(cfg)
    known = {p for ps in paths.values() for p in ps}
    extra = sorted(set(flat) - known)
    if extra:
        raise ValueError(f"reference leaves the port does not model: {extra}")
    missing = sorted(known - set(flat))
    if missing:
        raise KeyError(f"reference parameters lack {missing}")
    out = {}
    for k, ps in paths.items():
        parts = [_to_torch(flat[p]) for p in ps]
        t = parts[0] if len(parts) == 1 else torch.stack(parts, 1).flatten(0, 1)
        out[k] = t.to(dev)
    return out


def to_flat(params: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The inverse of ``from_flat``: the port's parameters → the
    reference's flat paths, each leaf a view of the port's tensor on its
    device."""
    out = {}
    for k, ps in param_paths(cfg).items():
        for j, p in enumerate(ps):
            out[p] = params[k] if len(ps) == 1 else params[k][j::len(ps)]
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights with ``lm_init``'s distributions: dense weights
    normal·d_in^-0.5 (each MoE expert's too, and the f32 router's),
    biases 0, the token and position tables normal·0.02, norm scales 1 (RMSNorm and the QK-norm multiply by ``1 + scale``),
    LayerNorm biases 0.  Drawn in f32 one layer at a time on ``device``
    (default: the card) with ``generator`` (which must live there), then
    cast to ``cfg.dtype``; the constant leaves draw nothing, so a seed
    draws the same weights whatever norms and biases a config adds."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    period_layout(cfg)
    n = cfg.num_layers
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.d_head
    hq, hkv = cfg.num_heads * dh, cfg.num_kv_heads * dh

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * std).to(dt)

    def stacked(d_in, d_out, experts=(), dtype=dt):
        # one matrix at a time: a grok-1 expert stack is 1.6 G values
        w = torch.empty((n, *experts, d_in, d_out), dtype=dtype, device=dev)
        for m in w.view(-1, d_in, d_out):
            m.copy_(torch.randn((d_in, d_out), generator=generator,
                                dtype=torch.float32, device=dev)
                    * d_in ** -0.5)
        return w

    def const(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    p = {"embed": normal((cfg.vocab_size, d), 0.02)}
    if cfg.pos_embedding == "learned":
        p["positions"] = normal((cfg.max_position, d), 0.02)
    p["final_norm"] = const((d,), 1.0)
    widths = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d),
              "up": (d, f), "gate": (d, f), "down": (f, d)}
    moe = cfg.family == "moe"
    for k in layer_keys(cfg):
        if k == "router":
            p[k] = stacked(d, cfg.num_experts, dtype=torch.float32)
        elif moe and k in ("up", "gate", "down"):
            p[k] = stacked(*widths[k], experts=(cfg.num_experts,))
        elif k in widths:
            p[k] = stacked(*widths[k])
        elif k in ("ln1", "ln2", "ln1_post", "ln2_post"):
            p[k] = const((n, d), 1.0)
        elif k in ("q_norm", "k_norm"):
            p[k] = const((n, dh), 1.0)
        else:                                   # biases: <weight>_b
            w = k[:-2]
            p[k] = const((n, widths[w][1] if w in widths else d), 0.0)
    if cfg.norm == "layernorm":
        p["final_norm_b"] = const((d,), 0.0)
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    return p
