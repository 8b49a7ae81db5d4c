"""Unified attention entry point: one call, pluggable backends (port of
``src/repro/core/attention_api.py``).

Backends are registered with :func:`register_backend`; each carries a
``supports`` predicate (validates an explicit choice) and an ``auto_ok``
gate (``backend="auto"`` takes the first eligible name in ``_AUTO_ORDER``).
The port registers the reference's backends under the reference's names,
so a config means the same in both packages:

- ``naive``: materialised logits, the oracle;
- ``naive_decode``: the same for single-row queries;
- ``jnp``: the online-softmax scan (plain torch here; the reference's name
  for its pure-jnp scan is kept);
- ``pallas``: the streaming-attention kernel — the CUDA kernel
  (``csrc/streaming_attention.cu``, with its backward kernel
  ``csrc/streaming_attention_bwd.cu`` under autograd) on a CUDA tensor,
  its plain versions on a CPU tensor.  ``auto`` picks it where the reference's ``auto`` picks the
  Pallas kernel on a TPU: static lengths, no position table, more than one
  query row, with platform ``cuda`` in place of ``tpu``;
- ``paged``: the padded paged convention (``page_table`` (B, P) and
  ``kv_len`` (B,) over page pools): kernel #2's block entry
  (``kernels/paged_attention.paged_attention``, ``csrc/paged_attention.cu``
  on the card, its plain version on the CPU);
- ``paged_varlen``: the ragged convention (``q_pos`` (T,) and per-token
  table rows (T, P)): :func:`ragged_attention` over one packed stream,
  block shapes from a ``KernelConfig`` (``kernels/autotune.py``) — the
  caller's, else the tuner's active config.  The model's ragged branch
  (``models/layers.py::attn_apply_ragged``) calls :func:`ragged_attention`
  itself, with the q-block layout it computed once per step.  With an
  ``axis_name`` (a mesh axis of ``launch/mesh.py``) q/k/v carry this
  rank's head band against its local pool band, and the full head axis
  is rebuilt with one all-gather;
- ``ring``: ring attention (``core/ring_attention.py``) over a KV
  sequence split across the ranks of ``axis_name``; only an explicit
  axis makes a call eligible (the reference's "inside shard_map").

All contiguous backends
share one signature: ``fn(q, k, v, **kwargs)`` with q ``(B, Hq, Lq, D)``,
k/v ``(B, Hkv, Lkv, D)``, ``Hq % Hkv == 0``, returning ``(B, Hq, Lq, D)``
in q's dtype; the paged ones take page pools ``(N, Hkv, ps, D)`` for k/v.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.ring_attention import ring_attention
from repro_torch.core.streaming_attention import (naive_attention,
                                                  streaming_attention)
from repro_torch.kernels.autotune import (KernelConfig, active_config,
                                         config_kwargs)
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.varlen import paged_attention_varlen
from repro_torch.kernels.streaming_attention import (
    streaming_attention as streaming_attention_kernel)
from repro_torch.parallel.collectives import all_gather

AttentionFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttentionCall:
    """Static facts about one attention call that drive backend resolution."""
    lq: int
    lkv: int
    platform: str                 # the tensors' device type: cuda | cpu
    static_lengths: bool          # q_offset / kv_len are python ints (or None)
    has_kv_pos: bool              # ring-buffer position table supplied
    has_page_table: bool = False  # k/v are page pools + a (B, P) page table
    is_ragged: bool = False       # packed (1, Hq, T, D) stream + q_pos (T,)
    inside_shard_map: bool = False  # an axis_name (a mesh axis) was given


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    fn: AttentionFn
    supports: Callable[[AttentionCall], bool]
    auto_ok: Callable[[AttentionCall], bool]   # gate for backend="auto"
    doc: str = ""


_REGISTRY: Dict[str, BackendSpec] = {}

#: resolution order for ``backend="auto"`` — first auto-eligible backend
#: wins (the reference's order).  "paged_varlen"/"paged" are the only
#: backends that read page pools (varlen for packed ragged streams, paged
#: for (lanes, C) blocks), "ring" is only eligible with an axis, "naive"
#: is the last resort.
_AUTO_ORDER: Tuple[str, ...] = ("paged_varlen", "paged", "pallas",
                                "naive_decode", "jnp", "ring", "naive")


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


def describe_call(q, k, *, q_offset=0, kv_len=None, kv_pos=None,
                  page_table=None, q_pos=None,
                  axis_name=None) -> AttentionCall:
    return AttentionCall(
        lq=q.shape[2], lkv=k.shape[2],
        platform=q.device.type,
        static_lengths=_is_static(q_offset) and _is_static(kv_len),
        has_kv_pos=kv_pos is not None,
        has_page_table=page_table is not None,
        is_ragged=q_pos is not None,
        inside_shard_map=axis_name is not None)


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
              page_table: Optional[torch.Tensor] = None,
              q_pos: Optional[torch.Tensor] = None,
              cu_seqlens: Optional[torch.Tensor] = None,
              kernel_config: Optional[KernelConfig] = None,
              axis_name=None,
              fallback: bool = False) -> torch.Tensor:
    """The single attention entry point (see module docstring).

    ``page_table`` switches the calling convention to *paged*: k/v are page
    pools ``(N, Hkv, page_size, D)``, ``page_table`` the (B, P) physical
    page of each table slot and ``kv_len`` the (B,) live rows per lane,
    query rows included (``Lq > 1`` is a chunked-prefill block at
    positions ``kv_len - Lq + i``, the causal intra-chunk mask implied).
    Only the ``paged`` backend resolves such calls.  ``q_pos`` switches it
    to *ragged*: q is one packed stream ``(1, Hq, T, D)``, ``page_table``
    holds per-token rows ``(T, P)`` and ``q_pos`` (T,) each token's
    position; only ``paged_varlen`` resolves those, with ``cu_seqlens``
    (the lane boundaries) and ``kernel_config`` (its block shapes).
    ``axis_name`` — a mesh axis (``launch/mesh.py::MeshAxis``) or a
    process group — makes the call a rank's part of a split one: the
    ragged backend's head band, or the ``ring`` backend's sequence
    block."""
    call = describe_call(q, k, q_offset=q_offset, kv_len=kv_len, kv_pos=kv_pos,
                         page_table=page_table, q_pos=q_pos,
                         axis_name=axis_name)
    spec = resolve_backend(backend, call, fallback=fallback)
    kw = dict(scale=scale, causal=causal, window=window, cap=cap,
              block_k=block_k, exp_mode=exp_mode, q_offset=q_offset,
              kv_len=kv_len, kv_pos=kv_pos)
    if page_table is not None:
        kw["page_table"] = page_table
    if q_pos is not None:
        kw.update(q_pos=q_pos, cu_seqlens=cu_seqlens,
                  kernel_config=kernel_config)
    if axis_name is not None:
        kw["axis_name"] = axis_name
    return spec.fn(q, k, v, **kw)


# --------------------------------------------------------------------------
# built-in backends
# --------------------------------------------------------------------------

@register_backend(
    "naive",
    supports=lambda call: not call.inside_shard_map
    and not call.has_page_table,
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
    supports=lambda call: call.lq == 1 and not call.inside_shard_map
    and not call.has_page_table,
    doc="Single-token decode: the logits row is O(L) already, so the KV-block "
        "scan buys nothing.")
def _naive_decode(q, k, v, **kw):
    return _naive(q, k, v, **kw)


@register_backend(
    "jnp",
    supports=lambda call: not call.inside_shard_map
    and not call.has_page_table,
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
    return (call.static_lengths and not call.has_kv_pos
            and not call.inside_shard_map and not call.has_page_table
            and call.lq > 1)


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


@register_backend(
    "paged",
    supports=lambda call: call.has_page_table and not call.is_ragged
    and not call.inside_shard_map and not call.has_kv_pos,
    doc="Paged attention: reads KV pages in place from the pool through the "
        "(B, P) page table — kernel #2's block entry "
        "(csrc/paged_attention.cu: a split pass and paged_combine) on the "
        "card, its plain page-block scan on the CPU.  Lq == 1 is decode; "
        "Lq > 1 is a chunked-prefill block (causal intra-chunk mask "
        "implied).  No gathered contiguous cache view is made.")
def _paged(q, k, v, *, scale, causal, window, cap, block_k, exp_mode,
           q_offset, kv_len, kv_pos, page_table):
    assert kv_pos is None, "paged backend has no ring-buffer support"
    assert kv_len is not None, "paged calls must pass per-lane kv_len"
    assert causal or q.shape[2] == 1, \
        "paged chunks are causal by construction — bidirectional multi-row " \
        "paged attention is not supported"
    # Query row i sits at position kv_len - Lq + i, so the per-row bound is
    # both the length mask and the causal intra-chunk mask; block_k is a
    # streaming-scan tile size (page blocks follow the page size).
    del causal, q_offset, block_k
    return paged_attention(q, k, v, page_table, kv_len, scale=scale, cap=cap,
                           window=window, exp_mode=exp_mode)


@register_backend(
    "paged_varlen",
    supports=lambda call: call.has_page_table and call.is_ragged
    and not call.has_kv_pos,
    doc="Ragged (varlen) paged attention: q is one packed (1, Hq, T, D) "
        "token stream with per-token page-table rows (T, P) and per-token "
        "causal bounds q_pos (T,) — the token-level serving step, no "
        "(lanes, C) padding.  cu_seqlens lane boundaries switch on the "
        "q-block-tiled dataflow; block shapes come from the KernelConfig "
        "(ragged_attention): kernel #2 on the card, its plain version on "
        "the CPU.  With axis_name q/k/v carry this rank's head band against "
        "its local pool band; one all-gather rebuilds the head axis "
        "(HASTILY's reduce-and-gather with the online-softmax reduce kept "
        "per-head-local).")
def _paged_varlen(q, k, v, *, scale, causal, window, cap, block_k, exp_mode,
                  q_offset, kv_len, kv_pos, page_table, q_pos,
                  cu_seqlens=None, kernel_config=None, axis_name=None):
    assert kv_pos is None, "ragged backend has no ring-buffer support"
    assert causal, "ragged paged streams are causal by construction"
    assert q.shape[0] == 1, \
        f"ragged q is one packed (1, Hq, T, D) stream, got batch {q.shape[0]}"
    # Positions live in q_pos; kv_len/q_offset are the padded convention's
    # fields and block_k a streaming-scan tile size.
    del causal, q_offset, kv_len, block_k
    qt = q[0].transpose(0, 1).contiguous()              # (T, Hq, D)
    out = ragged_attention(qt, k, v, page_table, q_pos,
                           kernel_config=kernel_config, cu_seqlens=cu_seqlens,
                           scale=scale, cap=cap, window=window,
                           exp_mode=exp_mode)
    if axis_name is not None:
        # Head bands concatenate in axis order — pure data movement, so
        # per-head outputs are bitwise what one device would compute.
        out = all_gather(out, axis_name, dim=1)
    return out.transpose(0, 1)[None]                    # (1, Hq, T, D)


@register_backend(
    "ring",
    supports=lambda call: call.inside_shard_map
    and not call.has_page_table,
    doc="Ring attention across ranks: KV blocks travel a mesh axis one hop "
        "a step while resident Q streams them (HASTILY §IV lifted to the "
        "ranks; core/ring_attention.py).  Only with an axis_name.")
def _ring(q, k, v, *, scale, causal, window, cap, block_k, exp_mode,
          q_offset, kv_len, kv_pos, axis_name):
    del block_k  # the ring hop is the block
    if (kv_pos is not None or kv_len is not None
            or not _is_static(q_offset) or q_offset != 0):
        raise ValueError("ring backend: positions derive from the mesh; "
                         "kv_pos/kv_len/q_offset are not supported")
    return ring_attention(q, k, v, axis_name, scale=scale, causal=causal,
                          window=window, cap=cap, exp_mode=exp_mode)


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
