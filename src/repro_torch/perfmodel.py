"""The roofline the kernel-config tuner scores against (port of the tuner's
half of ``src/repro/perfmodel/model.py``): ``PlatformSpec``, the platform
table, and the bytes / FLOPs / grid-step model of one q-block-tiled varlen
paged-attention step.

``PlatformSpec``, the ``cpu`` and ``tpu`` entries of ``PLATFORMS``,
``platform_spec``, ``varlen_attention_traffic`` and
``varlen_attention_roofline`` are the reference's, unchanged: on the
reference's inputs they give the reference's numbers.  The ``cuda`` entry
and ``paged_kernel_roofline`` are the port's own: the model of the card's
kernel (``csrc/paged_attention.cu``), whose split pass and combine have
terms the Pallas grid lacks.  On the card that model is a reported
diagnostic: the tuner measures every candidate there and prints the
model's prediction beside each time, and the measurement alone picks (on
the H100 the model's own pick measured mid-field, PERF.md §6).  The
paper's CIM model (``Hardware`` and the
rest of the reference module) is not read by the tuner and is not copied.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """Roofline constants of the machine running the *serving kernels*.

    Not Table II — the jnp scan / Pallas kernel run on a host CPU or a TPU,
    and the tuner needs their balance point, not HASTILY's.  Numbers are
    order-of-magnitude (a tile choice flips on ratios, not absolutes).
    """
    name: str
    mem_bw_gbs: float        # sustained bytes/s feeding the kernel
    flops: float             # peak f32 FLOP/s
    dispatch_ns: float       # fixed cost per page-walk grid step
    dequant_page_ns: float   # extra per-page cost of page-granular dequant


PLATFORMS: Dict[str, PlatformSpec] = {
    # host CPU running the jnp page-block scan (XLA:CPU, ~1 socket)
    "cpu": PlatformSpec("cpu", mem_bw_gbs=40.0, flops=2e11,
                        dispatch_ns=400.0, dequant_page_ns=200.0),
    # one TPU core running the Pallas scalar-prefetch kernel; per-page
    # dequant is free there (the kernel walks one page per step anyway)
    "tpu": PlatformSpec("tpu", mem_bw_gbs=1.2e3, flops=2e14,
                        dispatch_ns=120.0, dequant_page_ns=0.0),
    # One H100 SXM 80GB running csrc/paged_attention.cu.  The bandwidth and
    # the peak are NVIDIA's datasheet figures (HBM3 3.35 TB/s; f32 on the
    # CUDA cores 67 TFLOP/s — the kernel runs no tensor-core instruction),
    # not measurements.  ``dispatch_ns`` is the cost of one wave of blocks
    # over the SMs (``paged_kernel_roofline``), an order-of-magnitude
    # guess; the kernel dequantises each staged tile, so ``dequant`` costs
    # nothing apart.
    "cuda": PlatformSpec("cuda", mem_bw_gbs=3.35e3, flops=67e12,
                         dispatch_ns=150.0, dequant_page_ns=0.0),
}


def platform_spec(name: str | None = None) -> PlatformSpec:
    return PLATFORMS.get(name or "", PLATFORMS["cpu"])


def varlen_attention_traffic(segments, *, block_q: int, block_pages: int,
                             page_size: int, hq: int, hkv: int, head_dim: int,
                             kv_bytes: int = 4,
                             scaled: bool = False) -> Dict[str, float]:
    """Bytes moved / FLOPs / grid steps of one tiled varlen step.

    ``segments``: iterable of ``(n_new, kv_len)`` lane chunks (kv_len counts
    the new rows).  ``block_q = 1`` is the untiled batch = T dataflow.  KV
    bytes dominate: every q-block walks its lane's live pages, so pages are
    read ``ceil(n/Bq)`` times per lane instead of ``n`` — the tiling win the
    autotuner is shopping for.  ``scaled`` adds the int8 dequant-scale
    planes (4 bytes/row alongside ``kv_bytes``/elem rows).
    """
    bq = max(1, int(block_q))
    bp = max(1, int(block_pages))
    row_bytes = 2 * head_dim * kv_bytes * hkv        # K + V, all kv heads
    if scaled:
        row_bytes += 2 * 4 * hkv                     # k_scale + v_scale rows
    bytes_kv = bytes_q = flops = steps = pages = 0.0
    for n_new, kv_len in segments:
        n_new = int(n_new)
        kv_len = int(kv_len)
        if n_new <= 0:
            continue
        nb = -(-n_new // bq)
        for j in range(nb):
            rows = min(bq, n_new - j * bq)
            kv_blk = kv_len - n_new + j * bq + rows  # block's causal horizon
            p_live = -(-kv_blk // page_size)
            pages += p_live
            bytes_kv += p_live * page_size * row_bytes
            bytes_q += 2 * rows * hq * head_dim * 4  # q read + out write
            flops += 4.0 * rows * (p_live * page_size) * hq * head_dim
            steps += -(-p_live // bp)
    return {"bytes_kv": bytes_kv, "bytes_q": bytes_q, "flops": flops,
            "grid_steps": steps, "pages_read": pages,
            "bytes_total": bytes_kv + bytes_q}


def varlen_attention_roofline(spec: PlatformSpec, traffic: Dict[str, float],
                              *, block_pages: int = 1,
                              dequant: str = "block") -> float:
    """Predicted step seconds: max(bytes/BW, flops/peak) + grid overheads."""
    t_mem = traffic["bytes_total"] / (spec.mem_bw_gbs * 1e9)
    t_cmp = traffic["flops"] / spec.flops
    t_grid = traffic["grid_steps"] * spec.dispatch_ns * 1e-9
    if dequant == "page" and block_pages > 1:
        t_grid += traffic["pages_read"] * spec.dequant_page_ns * 1e-9
    return max(t_mem, t_cmp) + t_grid


# --------------------------------------------------------------------------
# the card's kernel: split pass + combine
# --------------------------------------------------------------------------

#: Streaming multiprocessors of an H100 SXM (the grid's waves).
SMS = 132


def paged_kernel_traffic(segments: Iterable[Tuple[int, int]], *,
                         block_q: int, kv_split: int, page_size: int,
                         hq: int, hkv: int, head_dim: int, kv_bytes: int = 2,
                         q_bytes: int = 2, scaled: bool = False
                         ) -> Dict[str, float]:
    """Bytes / FLOPs / blocks of one varlen step through the card's kernel.

    The model of ``csrc/paged_attention.cu`` as the varlen path calls it:
    the stream is cut into q-blocks of ``block_q`` rows of one lane, and one
    block of the split pass is (q-block, kv head, row tile, split), walking
    at most ``kv_split`` pages of the q-block's lane.  Against the Pallas
    grid's model above it counts

    - every row of a q-block, dead ones too: a decode lane at ``block_q``
      8 computes 8 rows and writes 8 rows of partials (``R = Hq/Hkv ·
      block_q`` rows per kv head, in ⌈R / MAX_ROW_TILE⌉ row tiles, each of
      which reads the q-block's pages again);
    - the f32 partials each live split writes and ``paged_combine`` reads
      back, ``R × (D + 2) × 4`` bytes per (q-block, kv head, split) each
      way; a split past the q-block's live pages exits before writing;
    - the pool's own element size ``kv_bytes`` (bf16 2, int8 1 plus the
      two f32 scale planes) and the query's ``q_bytes``;
    - ``blocks``: the live blocks of the grid, which run in waves over the
      card's ``SMS`` multiprocessors (``paged_kernel_roofline``).
    """
    # Deferred import: the kernels package reaches this module through
    # the tuner that ``core.attention_api`` imports.
    from repro_torch.kernels.paged_attention.ops import MAX_ROW_TILE
    bq = max(1, int(block_q))
    split = max(1, int(kv_split))
    group = hq // hkv
    rows = group * bq                                # block rows per kv head
    tiles = -(-rows // MAX_ROW_TILE)
    row_bytes = 2 * head_dim * kv_bytes              # K + V, one kv head
    if scaled:
        row_bytes += 2 * 4
    bytes_kv = bytes_q = bytes_part = flops = blocks = 0.0
    for n_new, kv_len in segments:
        n_new, kv_len = int(n_new), int(kv_len)
        for j in range(-(-n_new // bq)):
            live = min(bq, n_new - j * bq)
            kv_blk = kv_len - n_new + j * bq + live  # the block's horizon
            p_live = -(-kv_blk // page_size)
            n_split = -(-p_live // split)
            bytes_kv += tiles * hkv * p_live * page_size * row_bytes
            bytes_q += 2 * bq * hq * head_dim * q_bytes
            bytes_part += 2 * hkv * n_split * rows * (head_dim + 2) * 4
            flops += 4.0 * rows * hkv * p_live * page_size * head_dim
            blocks += hkv * tiles * n_split
    return {"bytes_kv": bytes_kv, "bytes_q": bytes_q,
            "bytes_partials": bytes_part, "flops": flops, "blocks": blocks,
            "bytes_total": bytes_kv + bytes_q + bytes_part}


def paged_kernel_roofline(spec: PlatformSpec, traffic: Dict[str, float]
                          ) -> float:
    """Predicted seconds of the card's kernel: max(bytes/BW, flops/peak)
    plus ``dispatch_ns`` for every wave of blocks over ``SMS``.  Reported
    beside the measured time; it prunes no candidate."""
    t_mem = traffic["bytes_total"] / (spec.mem_bw_gbs * 1e9)
    t_cmp = traffic["flops"] / spec.flops
    waves = -(-traffic["blocks"] // SMS)
    return max(t_mem, t_cmp) + waves * spec.dispatch_ns * 1e-9
