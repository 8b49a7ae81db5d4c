"""Model configuration for the PyTorch port: the dense and BERT families.

An own copy of the reference ``ModelConfig`` (``src/repro/configs/base.py``)
cut to what the port implements: the llama-style decoder the ragged
serving path runs (RMSNorm, RoPE, SiLU-gated MLP, untied embeddings), and
the cache-free full-sequence forward (``models/lm.py::lm_apply``) that the
dense family's scoring and the BERT encoder share (LayerNorm, learned
positions, biased projections, GELU, tied embeddings).  The configurations
are ``deepseek-7b``, ``bert-base`` and ``bert-large`` at their published
widths, and their ``-smoke`` variants, which every CPU test builds.  Field
names, defaults and the ``reduced`` rule match the reference, so a config
built here and one built there describe the same model.

``postnorm`` is kept for parity only: the reference's ``lm_apply`` never
reads it (its ``_layer_apply`` is pre-norm for every family), so both
packages compute a pre-LN BERT with a final LayerNorm.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "dense"                      # dense | bert

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention behaviour ---
    rope_theta: float = 10_000.0
    window: Optional[int] = None               # sliding window (local layers)
    attn_softcap: Optional[float] = None       # gemma2 logit soft-capping
    attn_bias: bool = False                    # bert: biased q/k/v and MLP
    attn_scale: Optional[float] = None         # default 1/sqrt(head_dim)

    # --- mlp / norms / embeddings ---
    mlp_gated: bool = True
    act: str = "silu"                          # silu | gelu | relu
    norm: str = "rmsnorm"                      # rmsnorm | layernorm
    postnorm: bool = False                     # parity only (module docstring)
    pos_embedding: str = "rope"                # rope | learned
    tie_embeddings: bool = True
    max_position: int = 1 << 20                # learned-position table size

    # --- numerics & HASTILY technique toggles ---
    dtype: str = "bfloat16"
    # Attention backend (core/attention_api registry): "auto" resolves per
    # call from the device platform and the call's shape; or pin one of the
    # registered names ("naive" | "naive_decode" | "jnp" | "pallas").
    attn_backend: str = "auto"
    # Legacy selector, honoured when attn_backend == "auto":
    # streaming (HASTILY) | naive (baseline) | pallas (kernel forward)
    attn_impl: str = "streaming"
    exp_mode: str = "lut"                      # lut | lut0 | exact
    block_k: int = 512                         # streaming-scan KV block
    kv_quant: bool = False                     # int8 KV pools

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def d_head(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant with the reference's rule (``reduced`` in
    ``src/repro/configs/base.py``): 2 layers, d_model 64, 4 heads over at
    most 2 kv heads of 16, d_ff 128, vocab 512, a window of 8 where there
    is one, 4096 learned positions and a 16-row streaming block."""
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2), d_model=64, d_ff=128,
        vocab_size=512, num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16, window=8 if cfg.window else None, max_position=4096,
        block_k=16)


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
    tie_embeddings=False,
)

# [paper Table III]: encoder-only, learned positions, GELU, MHA.
BERT_BASE = ModelConfig(
    name="bert-base",
    family="bert",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30522,
    mlp_gated=False,
    act="gelu",
    norm="layernorm",
    postnorm=True,
    pos_embedding="learned",
    max_position=8192,
    attn_bias=True,
    tie_embeddings=True,
)

BERT_LARGE = BERT_BASE.replace(
    name="bert-large",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
)

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in [DEEPSEEK_7B, BERT_BASE, BERT_LARGE]}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
