"""Model configuration for the PyTorch port: the dense decoder fields only.

An own copy of the reference ``ModelConfig`` (``src/repro/configs/base.py``)
cut to what the port's dense ragged serving path implements — a
llama-style decoder: RMSNorm, RoPE, SiLU-gated MLP, untied embeddings —
plus the two configurations this slice serves: ``deepseek-7b`` at its
published widths and ``deepseek-7b-smoke``, the reduced variant every CPU
test builds.  Field names, defaults and the ``reduced`` rule match the
reference, so a config built here and one built there describe the same
model.  Soft-capping, tied embeddings and the other families' fields
arrive with the slices that serve them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "dense"

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    rope_theta: float = 10_000.0

    dtype: str = "bfloat16"
    exp_mode: str = "lut"                      # lut | lut0 | exact
    kv_quant: bool = False                     # int8 KV pools

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def d_head(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant with the reference's widths (``reduced`` in
    ``src/repro/configs/base.py``): 2 layers, d_model 64, 4 heads over 2 kv
    heads of 16, d_ff 128, vocab 512."""
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2), d_model=64, d_ff=128,
        vocab_size=512, num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16)


# [arXiv:2401.02954; hf]
DEEPSEEK_7B = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
)

_REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in [DEEPSEEK_7B]}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
