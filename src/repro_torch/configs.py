"""Model configuration for the PyTorch port: the dense, MoE, SSM, hybrid,
vision-language, encoder-decoder and BERT families.

An own copy of the reference ``ModelConfig`` (``src/repro/configs/base.py``)
cut to what the port implements: the dense decoders the ragged serving
path runs — llama-style (RMSNorm, RoPE, SiLU-gated MLP, untied
embeddings), gemma-style (a cycled local/global ``layer_pattern`` with a
sliding window and a local RoPE theta, attention and final logit
softcaps, QK-norm, post-block norms, GeGLU, embeddings scaled by
√d_model) and starcoder2-style (LayerNorm, biased projections, plain GELU
MLP); the token-choice top-k MoE decoders (``family="moe"``: each layer's
MLP is ``num_experts`` gated experts behind a router, a token sent to
``experts_per_token`` of them, ``models/moe.py``); and the cache-free
full-sequence forward (``models/lm.py::lm_apply``) that the decoders'
scoring and the BERT encoder share (learned positions, tied
embeddings); the attention-free Mamba-1 decoder (``family="ssm"``:
every layer a selective-scan block, ``models/mamba.py``) and the Mamba-2
hybrid (``family="hybrid"``: Mamba-2 blocks, ``models/mamba2.py``, with
one shared attention + MLP block run again before every period of
``hybrid_period`` of them); the vision-language decoder (``family="vlm"``:
a Qwen2 trunk whose ``frontend_len`` patch embeddings, a stub of the
vision frontend, are prepended to the tokens) and the encoder-decoder
(``family="encdec"``: ``enc_layers`` bidirectional layers over
``frontend_len`` stub audio frames, ``dec_layers`` decoder layers with
cross-attention, ``models/encdec.py``).  The configurations are
``deepseek-7b``, ``gemma2-9b``, ``gemma3-12b``, ``starcoder2-3b``,
``granite-moe-3b-a800m``, ``grok-1-314b``, ``falcon-mamba-7b``,
``zamba2-1.2b``, ``internvl2-1b``, ``seamless-m4t-large-v2``,
``bert-base`` and ``bert-large`` at their published widths, and their
``-smoke`` variants, which every CPU test builds.
Field names, defaults and the ``reduced`` rule match the reference, so a
config built here and one built there describe the same model.

``postnorm`` is kept for parity only: the reference's ``lm_apply`` never
reads it (its ``_layer_apply`` is pre-norm for every family), so both
packages compute a pre-LN BERT with a final LayerNorm.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "dense"      # dense | moe | ssm | hybrid | vlm | encdec | bert

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention behaviour ---
    rope_theta: float = 10_000.0
    local_rope_theta: Optional[float] = None   # gemma3: local layers use 10k
    window: Optional[int] = None               # sliding window (local layers)
    layer_pattern: Tuple[str, ...] = ()        # cycled over layers
    attn_softcap: Optional[float] = None       # gemma2 logit soft-capping
    final_softcap: Optional[float] = None      # gemma2 final-logit soft-capping
    qk_norm: bool = False                      # gemma3
    attn_bias: bool = False                    # starcoder2 / bert: biases
    attn_scale: Optional[float] = None         # default 1/sqrt(head_dim)
    post_block_norm: bool = False              # gemma2/3: post-attn/mlp norms

    # --- mlp / norms / embeddings ---
    mlp_gated: bool = True
    act: str = "silu"                          # silu | gelu | relu
    norm: str = "rmsnorm"                      # rmsnorm | layernorm
    postnorm: bool = False                     # parity only (module docstring)
    pos_embedding: str = "rope"                # rope | learned | none
    tie_embeddings: bool = True
    embed_scale: bool = False                  # gemma: embeddings · sqrt(d)
    max_position: int = 1 << 20                # learned-position table size

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group: int = 512                       # tokens per dispatch group

    # --- SSM ---
    ssm_state: int = 0
    ssm_variant: str = ""                      # mamba1 | mamba2
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64                     # mamba2
    ssm_groups: int = 1                        # mamba2 B/C groups
    ssm_chunk: int = 128                       # chunked-scan length
    ssm_dt_rank: int = 0                       # mamba1 (0 → d_model//16)
    hybrid_period: int = 0                     # zamba2: shared attn every N blocks

    # --- encoder-decoder ---
    enc_layers: int = 0
    dec_layers: int = 0

    # --- modality frontend stubs ---
    frontend: str = ""                         # audio | vision | ""
    frontend_len: int = 256                    # patches / frames of the prefix

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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 1)

    @property
    def pattern(self) -> Tuple[str, ...]:
        """The per-layer kinds, cycled over the layers (``mamba`` for the
        SSM family; the hybrid's periods are ``models/lm.py::
        period_layout``'s)."""
        if self.layer_pattern:
            return self.layer_pattern
        return ("mamba",) if self.family == "ssm" else ("global",)

    def layer_kinds(self) -> Tuple[str, ...]:
        """The kind of every layer, in layer order."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant with the reference's rule (``reduced`` in
    ``src/repro/configs/base.py``): 2 layers — two whole periods of a
    ``layer_pattern`` where there is one —, d_model 64, 4 heads over at
    most 2 kv heads of 16 (none for an attention-free model), d_ff 128,
    vocab 512, a window of 8 where there is one, 4096 learned positions,
    a 16-row streaming block and an 8-row scan chunk; an MoE config keeps
    at most 8 experts and 2 per token, an SSM or hybrid one a state of at
    most 8 and Mamba-2 heads of 16, and a hybrid 2 periods of 2 blocks
    plus 2 more (4 periods, no tail)."""
    n_small = max(2 * len(cfg.pattern), 2)
    kw = dict(
        num_layers=(n_small if cfg.num_layers and cfg.layer_pattern
                    else min(cfg.num_layers, n_small)),
        d_model=64, d_ff=128, vocab_size=512,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16 if cfg.num_heads else 0,
        window=8 if cfg.window else None, max_position=4096,
        frontend_len=4 if cfg.frontend else 256, block_k=16, ssm_chunk=8)
    if cfg.family == "moe":
        kw.update(num_experts=min(cfg.num_experts, 8),
                  experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=min(cfg.ssm_state, 8), ssm_head_dim=16)
    if cfg.family == "hybrid":
        kw.update(num_layers=max(cfg.hybrid_period, 2) + 2,
                  hybrid_period=max(min(cfg.hybrid_period, 2), 2))
    if cfg.family == "encdec":
        kw.update(enc_layers=2, dec_layers=2, num_layers=0)
    return cfg.replace(name=cfg.name + "-smoke", **kw)


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

# [arXiv:2408.00118; hf]  alternating (local window-4096, global) layers,
# attention-logit softcap 50, final-logit softcap 30, GeGLU, embeddings
# scaled by sqrt(d_model); query_pre_attn_scalar 256 → attn_scale 1/16
GEMMA2_9B = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_gated=True,
    act="gelu",
    norm="rmsnorm",
    embed_scale=True,
    post_block_norm=True,
    attn_scale=0.0625,
    tie_embeddings=True,
)

# [hf:google/gemma-3-1b-pt; unverified]  five local (window 1024, rope 10k)
# layers per one global (rope 1M) layer; QK-norm instead of a logit softcap
GEMMA3_12B = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1_000_000.0,
    local_rope_theta=10_000.0,
    qk_norm=True,
    mlp_gated=True,
    act="gelu",
    norm="rmsnorm",
    embed_scale=True,
    post_block_norm=True,
    tie_embeddings=True,
)

# [arXiv:2402.19173; hf]  GQA 12:1, LayerNorm, non-gated GELU MLP, biased
# projections
STARCODER2_3B = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    mlp_gated=False,
    act="gelu",
    norm="layernorm",
    attn_bias=True,
    rope_theta=999_999.4,
    tie_embeddings=True,
)

# [hf:ibm-granite; hf]  IBM Granite 3.0 MoE: 40 gated SiLU experts of
# width 512, top-8, GQA 3:1
GRANITE_MOE_3B = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    mlp_gated=True,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)

# [hf:xai-org/grok-1; unverified]  8 gelu-gated experts of width 32768,
# top-2, GQA 6:1, attention-logit softcap 30
GROK_1_314B = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    mlp_gated=True,
    act="gelu",
    norm="rmsnorm",
    attn_softcap=30.0,
    tie_embeddings=True,
)

# [arXiv:2410.05355; unverified]  attention-free Mamba-1: d_inner 8192
# (expand 2), state 16, conv 4, dt_rank 256 (d_model / 16)
FALCON_MAMBA_7B = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    d_ff=0,
    vocab_size=65024,
    ssm_variant="mamba1",
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    norm="rmsnorm",
    pos_embedding="none",
    tie_embeddings=False,
)

# [arXiv:2411.15242; hf]  38 Mamba-2 blocks (state 64, heads of 64) and
# one shared transformer block (32 × 64 MHA, d_ff 8192, GELU-gated) run
# again before every period of 6 blocks (weights reused, KV per period)
ZAMBA2_1P2B = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_variant="mamba2",
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_groups=1,
    hybrid_period=6,
    mlp_gated=True,
    act="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
)

# [arXiv:2404.16821; hf]  InternViT + Qwen2-0.5B: the LM trunk (GQA 7:1,
# QKV biases, RoPE theta 1e6); the vision frontend is a stub, 256 patch
# embeddings of d_model prepended to the tokens
INTERNVL2_1B = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    mlp_gated=True,
    act="silu",
    norm="rmsnorm",
    attn_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend="vision",
    frontend_len=256,
)

# [arXiv:2308.11596; hf]  24 encoder + 24 decoder layers, MHA 16 × 64,
# LayerNorm, plain GELU MLP; the speech frontend (w2v-BERT) is a stub, 256
# frame embeddings of d_model
SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp_gated=False,
    act="gelu",
    norm="layernorm",
    pos_embedding="rope",
    tie_embeddings=True,
    frontend="audio",
    frontend_len=256,
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
    c.name: c for c in [DEEPSEEK_7B, GEMMA2_9B, GEMMA3_12B, STARCODER2_3B,
                        GRANITE_MOE_3B, GROK_1_314B, FALCON_MAMBA_7B,
                        ZAMBA2_1P2B, INTERNVL2_1B, SEAMLESS_M4T_LARGE_V2,
                        BERT_BASE, BERT_LARGE]}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
