"""Unified attention entry point: one call, pluggable backends (port of
``src/repro/core/attention_api.py``).

Backends are registered with :func:`register_backend`; each carries a
``supports`` predicate (validates an explicit choice) and an ``auto_ok``
gate (``backend="auto"`` takes the first eligible name in ``_AUTO_ORDER``).
The port registers the reference's contiguous backends under the
reference's names, so a config means the same in both packages:

- ``naive``: materialised logits, the oracle;
- ``naive_decode``: the same for single-row queries;
- ``jnp``: the online-softmax scan (plain torch here; the reference's name
  for its pure-jnp scan is kept);
- ``pallas``: the streaming-attention kernel — the CUDA kernel
  (``csrc/streaming_attention.cu``, with its backward kernel
  ``csrc/streaming_attention_bwd.cu`` under autograd) on a CUDA tensor,
  its plain versions on a CPU tensor.  ``auto`` picks it where the reference's ``auto`` picks the
  Pallas kernel on a TPU: static lengths, no position table, more than one
  query row, with platform ``cuda`` in place of ``tpu``.

The ragged paged call of the serving step is not a registered backend
here: the model's ragged branch (``models/layers.py``) calls
:func:`ragged_attention`, the counterpart of the reference's
``paged_varlen`` backend, whose block shapes come from a ``KernelConfig``
(``kernels/autotune.py``) — the caller's, else the tuner's active config.
The ring backend comes with the sharded slice.

All backends share one signature: ``fn(q, k, v, **kwargs)`` with q
``(B, Hq, Lq, D)``, k/v ``(B, Hkv, Lkv, D)``, ``Hq % Hkv == 0``, returning
``(B, Hq, Lq, D)`` in q's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.streaming_attention import (naive_attention,
                                                  streaming_attention)
from repro_torch.kernels.autotune import (KernelConfig, active_config,
                                         config_kwargs)
from repro_torch.kernels.paged_attention.varlen import paged_attention_varlen
from repro_torch.kernels.streaming_attention import (
    streaming_attention as streaming_attention_kernel)

AttentionFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttentionCall:
    """Static facts about one attention call that drive backend resolution."""
    lq: int
    lkv: int
    platform: str                 # the tensors' device type: cuda | cpu
    static_lengths: bool          # q_offset / kv_len are python ints (or None)
    has_kv_pos: bool              # ring-buffer position table supplied


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    fn: AttentionFn
    supports: Callable[[AttentionCall], bool]
    auto_ok: Callable[[AttentionCall], bool]   # gate for backend="auto"
    doc: str = ""


_REGISTRY: Dict[str, BackendSpec] = {}

#: resolution order for ``backend="auto"`` — first auto-eligible backend
#: wins (the reference's order, less the backends not ported).
_AUTO_ORDER: Tuple[str, ...] = ("pallas", "naive_decode", "jnp", "naive")


def register_backend(name: str, *, supports: Callable[[AttentionCall], bool],
                     auto_ok: Optional[Callable[[AttentionCall], bool]] = None,
                     doc: str = "") -> Callable[[AttentionFn], AttentionFn]:
    """Decorator: register ``fn`` as attention backend ``name``."""
    def deco(fn: AttentionFn) -> AttentionFn:
        _REGISTRY[name] = BackendSpec(name=name, fn=fn, supports=supports,
                                      auto_ok=auto_ok or supports,
                                      doc=doc or (fn.__doc__ or ""))
        return fn
    return deco


def get_backend(name: str) -> BackendSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown attention backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def backend_for_config(attn_backend: str, attn_impl: str = "streaming") -> str:
    """Map config fields to a registry name: ``attn_backend`` wins when set;
    at its ``"auto"`` default the legacy ``attn_impl`` ("streaming" |
    "naive" | "pallas") is honoured, "streaming" meaning auto."""
    if attn_backend and attn_backend != "auto":
        return attn_backend
    legacy = {"streaming": "auto", "naive": "naive", "pallas": "pallas"}
    if attn_impl not in legacy:
        raise KeyError(f"unknown attn_impl {attn_impl!r}; "
                       f"known: {sorted(legacy)}")
    return legacy[attn_impl]


# --------------------------------------------------------------------------
# resolution
# --------------------------------------------------------------------------

def _is_static(x) -> bool:
    return x is None or isinstance(x, (int, float))


def describe_call(q, k, *, q_offset=0, kv_len=None,
                  kv_pos=None) -> AttentionCall:
    return AttentionCall(
        lq=q.shape[2], lkv=k.shape[2],
        platform=q.device.type,
        static_lengths=_is_static(q_offset) and _is_static(kv_len),
        has_kv_pos=kv_pos is not None)


def resolve_backend(backend: str, call: AttentionCall, *,
                    fallback: bool = False) -> BackendSpec:
    """Explicit name → validate; ``"auto"`` → first eligible in _AUTO_ORDER.

    ``fallback=True`` downgrades an unsupported explicit choice to auto
    resolution instead of raising (the config-driven model path)."""
    if backend != "auto":
        spec = get_backend(backend)
        if spec.supports(call):
            return spec
        if not fallback:
            raise ValueError(
                f"attention backend {backend!r} does not support this call: "
                f"{call}")
    for name in _AUTO_ORDER:
        spec = _REGISTRY.get(name)
        if spec is not None and spec.auto_ok(call):
            return spec
    raise ValueError(f"no registered attention backend supports this call: "
                     f"{call}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              backend: str = "auto",
              scale: Optional[float] = None,
              causal: bool = False,
              window: Optional[int] = None,
              cap: Optional[float] = None,
              block_k: int = 512,
              exp_mode: str = "lut",
              q_offset=0,
              kv_len=None,
              kv_pos: Optional[torch.Tensor] = None,
              fallback: bool = False) -> torch.Tensor:
    """The single attention entry point (see module docstring)."""
    call = describe_call(q, k, q_offset=q_offset, kv_len=kv_len, kv_pos=kv_pos)
    spec = resolve_backend(backend, call, fallback=fallback)
    return spec.fn(q, k, v, scale=scale, causal=causal, window=window,
                   cap=cap, block_k=block_k, exp_mode=exp_mode,
                   q_offset=q_offset, kv_len=kv_len, kv_pos=kv_pos)


# --------------------------------------------------------------------------
# built-in backends
# --------------------------------------------------------------------------

@register_backend(
    "naive",
    supports=lambda call: True,
    doc="Materialised-logits reference (PUMA dataflow): O(l²) memory; the "
        "correctness oracle every other backend is tested against.")
def _naive(q, k, v, *, scale, causal, window, cap, block_k, exp_mode,
           q_offset, kv_len, kv_pos):
    del block_k  # logits are materialised in one piece
    return naive_attention(q, k, v, scale=scale, causal=causal, window=window,
                           cap=cap, exp_mode=exp_mode, q_offset=q_offset,
                           kv_len=kv_len, kv_pos=kv_pos)


@register_backend(
    "naive_decode",
    supports=lambda call: call.lq == 1,
    doc="Single-token decode: the logits row is O(L) already, so the KV-block "
        "scan buys nothing.")
def _naive_decode(q, k, v, **kw):
    return _naive(q, k, v, **kw)


@register_backend(
    "jnp",
    supports=lambda call: True,
    doc="The streaming scan (HASTILY §IV): online softmax over KV blocks, "
        "O(l) memory, dynamic lengths and positions.  Plain torch in the "
        "port; the name is the reference's.")
def _jnp(q, k, v, *, scale, causal, window, cap, block_k, exp_mode,
         q_offset, kv_len, kv_pos):
    return streaming_attention(q, k, v, scale=scale, causal=causal,
                               window=window, cap=cap, block_k=block_k,
                               exp_mode=exp_mode, q_offset=q_offset,
                               kv_len=kv_len, kv_pos=kv_pos)


def _pallas_supported(call: AttentionCall) -> bool:
    # The kernel wants static lengths, no position tables, and multi-row
    # queries (decode rows go to naive_decode).
    return call.static_lengths and not call.has_kv_pos and call.lq > 1


@register_backend(
    "pallas",
    supports=_pallas_supported,
    # Its plain version keeps it runnable on the CPU when explicitly
    # selected, but auto resolution only picks the kernel on the card.
    auto_ok=lambda call: _pallas_supported(call) and call.platform == "cuda",
    doc="The streaming-attention kernel forward (csrc/streaming_attention.cu "
        "on the card, its plain version on the CPU) with its backward kernel "
        "(csrc/streaming_attention_bwd.cu; the plain flash backward on the "
        "CPU) attached as one autograd Function — kernel on the forward and "
        "the backward, as the reference's Pallas forward carries the jnp "
        "flash backward.  Static lengths only.")
def _pallas(q, k, v, *, scale, causal, window, cap, block_k, exp_mode,
            q_offset, kv_len, kv_pos):
    assert kv_pos is None, "pallas backend has no ring-buffer support"
    del block_k  # the kernel picks its own tiles
    return streaming_attention_kernel(
        q, k, v, scale=scale, causal=causal, window=window, cap=cap,
        exp_mode=exp_mode, q_offset=int(q_offset),
        kv_len=None if kv_len is None else int(kv_len))


# --------------------------------------------------------------------------
# the ragged paged call
# --------------------------------------------------------------------------

def ragged_kernel_config(kernel_config: Optional[KernelConfig],
                         platform: str) -> KernelConfig:
    """The block shapes of a ragged call: ``kernel_config`` when given,
    else the tuner's active config for ``platform`` (``cpu`` | ``cuda``),
    as the reference's ``paged_varlen`` backend consults
    ``active_config()``."""
    return kernel_config if kernel_config is not None else active_config(
        platform)


def ragged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, token_pages: torch.Tensor,
                     q_pos: torch.Tensor, *,
                     kernel_config: Optional[KernelConfig] = None,
                     attend: Optional[AttentionFn] = None,
                     **kw) -> torch.Tensor:
    """Varlen paged attention over one packed (T, Hq, D) stream with the
    block shapes of ``kernel_config`` (``ragged_kernel_config``):
    ``block_q`` cuts the q-blocks, ``block_pages`` and ``dequant`` shape
    the plain version, ``kv_split`` the card's kernel.  ``attend`` replaces
    ``paged_attention_varlen`` (same signature); ``kw`` are its other
    keywords."""
    kc = ragged_kernel_config(kernel_config, q.device.type)
    return (attend or paged_attention_varlen)(
        q, k_pool, v_pool, token_pages, q_pos, **config_kwargs(kc), **kw)
