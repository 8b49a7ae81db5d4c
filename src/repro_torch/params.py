"""Parameters of the port's models (dense, vlm, MoE, Mamba and hybrid
decoders, the encoder-decoder, BERT encoder).

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
row ``n`` is the port's layer ``n·len(pattern) + j``.  The vlm family's
leaves are the dense ones (Qwen2: ``wq_b``/``wk_b``/``wv_b``, no ``wo``
or MLP bias).  The encoder-decoder's (``models/encdec.py``) are already
stacked in the reference (``jax.vmap`` over layers, no periods): its
``encoder/...`` leaves are the port's ``enc_<key>``, ``decoder/{ln1,
self_attn, lnx, cross_attn, ln2, mlp}/...`` its ``decoder_keys``
(``cross_attn/...`` as ``cross_<key>``), and ``enc_norm`` / ``dec_norm``
end each stack.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.encdec import decoder_keys, encoder_keys
from repro_torch.models.lm import (block_keys, layer_keys, period_layout,
                                   shared_keys)

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
_MAMBA_PATHS = {"ln": "ln/scale", "ln_b": "ln/bias",
                **{k: f"mix/{k}/w" for k in ("in_proj", "x_proj", "dt_proj",
                                             "out_proj")},
                **{k: f"mix/{k}" for k in ("conv_w", "conv_b", "dt_bias",
                                           "A_log", "D", "norm_scale")}}


def _to_torch(arr) -> torch.Tensor:
    """numpy → torch, exactly (a tensor passes as it is).  bf16 leaves
    (ml_dtypes arrays) cross by bit view: int16 bits → ``torch.bfloat16``."""
    if torch.is_tensor(arr):
        return arr
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _encdec_paths(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """The encoder-decoder's keys → their one (stacked) reference path."""
    paths = {"embed": ("embed/tokens",)}
    norms = ("enc_norm", "dec_norm")
    for k in encoder_keys(cfg):
        paths[k] = (f"encoder/{_LAYER_PATHS[k[len('enc_'):]]}",)
    for k in decoder_keys(cfg):
        if k.startswith("cross_"):
            leaf = "cross_" + _LAYER_PATHS[k[len("cross_"):]]
        elif k.startswith("lnx"):
            leaf = "lnx/bias" if k.endswith("_b") else "lnx/scale"
        else:
            leaf = _LAYER_PATHS[k].replace("attn/", "self_attn/", 1)
        paths[k] = (f"decoder/{leaf}",)
    for n in norms:
        paths[n] = (f"{n}/scale",)
        if cfg.norm == "layernorm":
            paths[n + "_b"] = (f"{n}/bias",)
    return paths


def _stacking(cfg: ModelConfig) -> Tuple[set, int, int]:
    """(the keys stacked from period slots, slots per period, periods):
    none for the encoder-decoder, whose reference leaves are stacked."""
    if cfg.family == "encdec":
        return set(), 0, 0
    kinds, nper, _ = period_layout(cfg)
    return set(layer_keys(cfg)), (len(kinds) if nper else 0), nper


def param_paths(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """Port key → the reference flat paths it is made of: one for a
    model-wide leaf (and for an encoder-decoder's stacked leaf); for a
    per-layer leaf, one per slot ``j`` of the period,
    ``trunk/periods/{j}/...``, then one per tail layer ``i``,
    ``trunk/tail/{i}/...``."""
    if cfg.family == "encdec":
        return _encdec_paths(cfg)
    kinds, nper, tail = period_layout(cfg)
    paths = {"embed": ("embed/tokens",), "final_norm": ("final_norm/scale",)}
    if cfg.pos_embedding == "learned":
        paths["positions"] = ("embed/positions",)
    if cfg.norm == "layernorm":
        paths["final_norm_b"] = ("final_norm/bias",)
    if not cfg.tie_embeddings:
        paths["lm_head"] = ("lm_head/w",)
    names = dict(_LAYER_PATHS, **(_MOE_PATHS if cfg.family == "moe" else {}),
                 **(_MAMBA_PATHS if "mamba" in kinds else {}))
    for k in layer_keys(cfg):
        paths[k] = (tuple(f"trunk/periods/{j}/{names[k]}"
                          for j in range(len(kinds)) if nper)
                    + tuple(f"trunk/tail/{i}/{names[k]}"
                            for i in range(tail)))
    for k in shared_keys(cfg):
        paths[k] = (f"trunk/shared_attn/{_LAYER_PATHS[k[len('shared_'):]]}",)
    return paths


def from_flat(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The reference's flat parameter dict (numpy arrays, or CPU tensors as
    ``checkpoint.restore_flat`` gives them) → the port's parameters on
    ``device`` (default: the card): period slot ``j``'s row ``n`` becomes
    layer ``n·len(pattern) + j``, and tail layer ``i`` follows the last
    period."""
    dev = resolve_device(device)
    paths = param_paths(cfg)
    layered, per, _ = _stacking(cfg)    # per: period paths ahead of the tail's
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
        if k in layered:
            head = [torch.stack(parts[:per], 1).flatten(0, 1)] if per else []
            t = torch.cat(head + [x[None] for x in parts[per:]])
        else:
            t = parts[0]
        out[k] = t.to(dev)
    return out


def to_flat(params: Mapping[str, torch.Tensor],
            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The inverse of ``from_flat``: the port's parameters → the
    reference's flat paths, each leaf a view of the port's tensor on its
    device."""
    layered, per, nper = _stacking(cfg)
    out = {}
    for k, ps in param_paths(cfg).items():
        for j, p in enumerate(ps):
            if k not in layered:
                out[p] = params[k]
            elif j < per:
                out[p] = params[k][:nper * per][j::per]
            else:                                # tail layer j - per
                out[p] = params[k][nper * per + j - per]
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random weights with ``lm_init``'s distributions: dense weights
    normal·d_in^-0.5 (each MoE expert's too, and the f32 router's),
    biases 0, the token and position tables normal·0.02, norm scales 1 (RMSNorm and the QK-norm multiply by ``1 + scale``),
    LayerNorm biases 0.  An encoder-decoder draws its encoder's block
    leaves over ``enc_layers`` and its decoder's over ``dec_layers``, each
    cross-attention leaf as its self-attention counterpart.  A Mamba
    layer draws ``mamba_init`` / ``mamba2_init``'s: its projections and the conv normal·fan-in^-0.5
    (the conv's fan-in the kernel width), the conv bias 0, ``dt_bias``
    log(expm1(0.01)), ``D`` 1, and ``A_log`` log(1..n) per channel
    (S4D-real, Mamba-1) or log(linspace(1, 16, H)) (Mamba-2), with
    ``A_log``, ``D`` and Mamba-2's ``dt_bias`` in f32.  Drawn in f32 one
    layer at a time on ``device`` (default: the card) with ``generator``
    (which must live there), then cast to ``cfg.dtype``; the constant
    leaves draw nothing, so a seed draws the same weights whatever norms
    and biases a config adds."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    encdec = cfg.family == "encdec"
    if not encdec:
        period_layout(cfg)
    n = cfg.num_layers
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.d_head
    hq, hkv = cfg.num_heads * dh, cfg.num_kv_heads * dh

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * std).to(dt)

    def stacked(d_in, d_out, experts=(), dtype=dt, layers=n):
        # one matrix at a time: a grok-1 expert stack is 1.6 G values
        w = torch.empty((layers, *experts, d_in, d_out), dtype=dtype,
                        device=dev)
        for m in w.view(-1, d_in, d_out):
            m.copy_(torch.randn((d_in, d_out), generator=generator,
                                dtype=torch.float32, device=dev)
                    * d_in ** -0.5)
        return w

    def const(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    p = {"embed": normal((cfg.vocab_size, d), 0.02)}
    if cfg.pos_embedding == "learned":
        p["positions"] = normal((cfg.max_position, d), 0.02)
    norms = ("enc_norm", "dec_norm") if encdec else ("final_norm",)
    for name in norms:
        p[name] = const((d,), 1.0)
    widths = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d),
              "up": (d, f), "gate": (d, f), "down": (f, d)}
    moe = cfg.family == "moe"

    def block(keys, layers):
        out = {}
        for key in keys:       # cross_<k> is drawn as its counterpart <k>
            k = key[len("cross_"):] if key.startswith("cross_") else key
            if k == "router":
                out[key] = stacked(d, cfg.num_experts, dtype=torch.float32)
            elif moe and k in ("up", "gate", "down"):
                out[key] = stacked(*widths[k], experts=(cfg.num_experts,))
            elif k in widths:
                out[key] = stacked(*widths[k], layers=layers)
            elif k in ("ln1", "ln2", "lnx", "ln1_post", "ln2_post"):
                out[key] = const((layers, d), 1.0)
            elif k in ("q_norm", "k_norm"):
                out[key] = const((layers, dh), 1.0)
            else:                                   # biases: <weight>_b
                w = k[:-2]
                out[key] = const((layers, widths[w][1] if w in widths else d),
                                 0.0)
        return out

    if encdec:
        enc = block(block_keys(cfg), cfg.enc_layers)
        p.update({"enc_" + k: v for k, v in enc.items()})
        p.update(block(decoder_keys(cfg), cfg.dec_layers))
    elif cfg.family in ("ssm", "hybrid"):
        p.update(_mamba_leaves(cfg, stacked, const, dev))
        shared = block([k[len("shared_"):] for k in shared_keys(cfg)], 1)
        p.update({"shared_" + k: v[0] for k, v in shared.items()})
    else:
        p.update(block(layer_keys(cfg), n))
    if cfg.norm == "layernorm":
        p.update({name + "_b": const((d,), 0.0) for name in norms})
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    return p


def _mamba_leaves(cfg: ModelConfig, stacked, const,
                  dev: torch.device) -> Dict[str, torch.Tensor]:
    """Every Mamba layer's leaves, stacked (``init_params``' draw)."""
    n, d, di, k = cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_conv
    f32 = torch.float32
    dt_bias = float(np.log(np.expm1(np.float32(0.01))))
    if cfg.ssm_variant == "mamba2":
        h = cfg.d_inner // cfg.ssm_head_dim
        c = di + 2 * cfg.ssm_groups * cfg.ssm_state
        p = {"in_proj": stacked(d, 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state
                                + h),
             "conv_w": stacked(k, c), "conv_b": const((n, c), 0.0),
             "dt_bias": const((n, h), dt_bias, f32),
             "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                               device=dev)).expand(n, h).clone(),
             "D": const((n, h), 1.0, f32), "norm_scale": const((n, di), 1.0),
             "out_proj": stacked(di, d)}
    else:
        r, s = cfg.dt_rank, cfg.ssm_state
        a = torch.arange(1, s + 1, dtype=f32, device=dev)
        p = {"in_proj": stacked(d, 2 * di), "conv_w": stacked(k, di),
             "conv_b": const((n, di), 0.0), "x_proj": stacked(di, r + 2 * s),
             "dt_proj": stacked(r, di), "dt_bias": const((n, di), dt_bias),
             "A_log": torch.log(a).expand(n, di, s).clone(),
             "D": const((n, di), 1.0, f32), "out_proj": stacked(di, d)}
    p["ln"] = const((n, d), 1.0)
    if cfg.norm == "layernorm":
        p["ln_b"] = const((n, d), 0.0)
    return p
