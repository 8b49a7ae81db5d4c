"""The port's performance models (port of
``src/repro/perfmodel/model.py``): the paper's analytical CIM model, and
the roofline the kernel-config tuner scores against.

**The CIM model** (the paper's Figs 7-13): HASTILY against PUMA and the
A40 as closed-form structural formulas over the Table II hardware
(``hardware.py``) — softmax latency and energy per vector
(``softmax_latency_s``, ``softmax_energy_j``, ``softmax_cores``), the
encoder layer (``encoder_layer_latency_s``, ``encoder_layer_energy_j``,
``softmax_fraction``), end to end (``bert_ops``,
``end_to_end_latency_s``, ``end_to_end_tops``, ``node_power_w``,
``tops_per_watt``) and ``headline_numbers``.  The reference's functions
copied unchanged: on the reference's inputs they give its numbers, float
for float.  It is arithmetic on the paper's constants — a model of the
paper's design, measured on no card.

**The tuner's roofline**: ``PlatformSpec``, the ``cpu`` and ``tpu``
entries of ``PLATFORMS``, ``platform_spec``, ``varlen_attention_traffic``
and ``varlen_attention_roofline`` are the reference's, unchanged.  The
``cuda`` entry and ``paged_kernel_traffic`` / ``paged_kernel_roofline``
are the port's own: the model of the card's kernel
(``csrc/paged_attention.cu``), whose split pass and combine have terms the
Pallas grid lacks.  On the card that model is a reported diagnostic: the
tuner measures every candidate there and prints the model's prediction
beside each time, and the measurement alone picks (on the H100 the
model's own pick measured mid-field, PERF.md §6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Tuple

from repro_torch.perfmodel.hardware import DEFAULT_HW, GPU, Hardware


# --------------------------------------------------------------------------
# softmax (per vector of length l) — Fig 7 / Fig 8
# --------------------------------------------------------------------------

def softmax_cores(hw: Hardware, l: int) -> int:
    """Cores the multicore softmax spreads one l-vector over: one per 512
    columns, at most 16 (paper §III-B2)."""
    return max(1, min(16, l // 512))


def softmax_latency_s(hw: Hardware, l: int, mode: str,
                      alu_width: int | None = None) -> float:
    """mode ∈ {puma, uclm, multicore, hastily}.

    ``hastily`` = min(uclm, multicore): the compiler schedules whichever is
    faster (multicore only pays off once the tree gather amortises —
    Fig 7's "no difference at smaller l")."""
    w = alu_width or hw.alu_width
    cyc = hw.cycle_s
    if mode == "puma":
        # max, sub, reduce on VFU + software exp + reciprocal-multiply
        per_elem = 3 + hw.c_exp_sw + hw.c_div
        return (l / w) * per_elem * cyc
    if mode == "uclm":
        lookup = math.ceil(l / hw.arrays_per_core) * hw.c_lookup
        per_elem = 3 + hw.c_vfu_misc + hw.c_div
        return ((l / w) * per_elem + lookup) * cyc
    if mode == "multicore":
        n = softmax_cores(hw, l)
        lc = l / n
        lookup = math.ceil(lc / hw.arrays_per_core) * hw.c_lookup
        per_elem = 3 + hw.c_vfu_misc + hw.c_div
        tree = 2 * math.log2(max(n, 2)) * hw.c_comm if n > 1 else 0.0
        return ((lc / w) * per_elem + lookup + tree) * cyc
    if mode == "hastily":
        return min(softmax_latency_s(hw, l, "uclm", w),
                   softmax_latency_s(hw, l, "multicore", w))
    raise ValueError(mode)


def softmax_energy_j(hw: Hardware, l: int, mode: str) -> float:
    """Per-vector softmax energy (Fig 8): 5 VFU element ops + 2 RF word
    accesses; PUMA adds the software-exp surcharge, the LUT path the SRAM
    lookup's energy, multicore the tree gather's shared-memory words."""
    base = 5 * hw.e_vfu_op + 2 * hw.e_rf_word
    if mode == "puma":
        return l * (base + hw.e_exp_sw_extra)
    e_lut = hw.p_uclm_lt * (hw.c_lookup * hw.cycle_s) / hw.array_cols
    e = l * (base + e_lut)
    if mode in ("multicore", "hastily"):
        n = softmax_cores(hw, l)
        if n > 1 and (mode == "multicore"
                      or softmax_latency_s(hw, l, "multicore")
                      < softmax_latency_s(hw, l, "uclm")):
            e += 2 * math.log2(n) * n * hw.e_comm_word
    return e


# --------------------------------------------------------------------------
# encoder layer — Fig 9 / 10 / 11
# --------------------------------------------------------------------------

def _layer_op_counts(l: int, d: int, d_ff: int | None = None,
                     heads: int | None = None) -> Dict[str, float]:
    """MAC·2 op counts per encoder layer (the paper's TOPS convention)."""
    d_ff = d_ff or 4 * d
    heads = heads or d // 64
    static = l * (4 * d * d + 2 * d * d_ff)          # QKVO + FF1 + FF2
    dynamic = 2 * l * l * d                           # QK^T + SV
    return {"static": 2 * static, "dynamic": 2 * dynamic,
            "total": 2 * (static + dynamic)}


def mvm_stage_s(hw: Hardware) -> float:
    return hw.t_mvm_ns * 1e-9


def encoder_layer_latency_s(hw: Hardware, l: int, d: int, *,
                            softmax_mode: str = "hastily",
                            pipelined: str = "fine",
                            d_ff: int | None = None) -> float:
    """One encoder layer (attention + FFN), Fig 9.  ``pipelined``:
    ``none`` — the six MatMul blocks back to back plus l softmax vectors;
    ``coarse`` — PUMA's block dataflow (MatMuls overlap, the softmax
    serialises); ``fine`` — HASTILY §IV (the softmax shows only when slower
    than one crossbar stage)."""
    t_mvm = mvm_stage_s(hw)
    t_sm = softmax_latency_s(hw, l, softmax_mode)
    if pipelined == "none":
        return 6 * l * t_mvm + l * t_sm
    if pipelined == "coarse":
        return 2 * l * t_mvm + l * t_sm
    return 2 * l * max(t_mvm, t_sm)


def softmax_fraction(hw: Hardware, l: int, d: int, mode: str) -> float:
    """Fig 10: the softmax's share of an un-pipelined layer's runtime."""
    t_total = encoder_layer_latency_s(hw, l, d, softmax_mode=mode,
                                      pipelined="none")
    t_sm = l * softmax_latency_s(hw, l, mode)
    return t_sm / t_total


def encoder_layer_energy_j(hw: Hardware, l: int, d: int, *,
                           softmax_mode: str = "hastily",
                           d_ff: int | None = None) -> float:
    """Fig 11: crossbar MVM energy per op plus the softmax term."""
    ops = _layer_op_counts(l, d, d_ff)
    e_mvm = ops["total"] * hw.e_op
    e_sm = l * softmax_energy_j(hw, l, softmax_mode)
    return e_mvm + e_sm


# --------------------------------------------------------------------------
# end-to-end — Fig 12 / 13
# --------------------------------------------------------------------------

def bert_ops(n_layers: int, l: int, d: int, d_ff: int) -> float:
    per = _layer_op_counts(l, d, d_ff)["total"]
    return n_layers * per


def end_to_end_latency_s(hw: Hardware, n_layers: int, l: int, d: int,
                         d_ff: int, *, pipelined: str = "fine",
                         softmax_mode: str = "hastily",
                         batch: int = 1) -> float:
    """HASTILY's pipeline: N layers drain in (N+1)·l MVM-stage times (§IV),
    at most 2 batches' weights resident (§VI-C); PUMA holds 4 (coarse)."""
    if pipelined == "fine":
        t_sm = softmax_latency_s(hw, l, softmax_mode)
        stage = max(mvm_stage_s(hw), t_sm)
        per_pass = (n_layers + 1) * l * stage
        return math.ceil(batch / 2) * per_pass
    per_layer = encoder_layer_latency_s(hw, l, d, softmax_mode=softmax_mode,
                                        pipelined=pipelined, d_ff=d_ff)
    return math.ceil(batch / 4) * n_layers * per_layer


def end_to_end_tops(hw: Hardware, n_layers: int, l: int, d: int, d_ff: int,
                    *, pipelined: str = "fine",
                    softmax_mode: str = "hastily",
                    batch: int = 1) -> float:
    ops = batch * bert_ops(n_layers, l, d, d_ff)
    t = end_to_end_latency_s(hw, n_layers, l, d, d_ff, pipelined=pipelined,
                             softmax_mode=softmax_mode, batch=batch)
    return ops / t / 1e12


def node_power_w(hw: Hardware, tops: float) -> float:
    """P = the idle floor + power proportional to e_op (Fig 13's
    model-size-invariant TOPS/W follows from this form)."""
    return hw.p_idle + tops * 1e12 * hw.e_op


def tops_per_watt(hw: Hardware, n_layers: int, l: int, d: int, d_ff: int,
                  *, batch: int = 1) -> float:
    t = end_to_end_tops(hw, n_layers, l, d, d_ff, batch=batch)
    return t / node_power_w(hw, t)


# --------------------------------------------------------------------------
# kernel roofline: q-block-tiled varlen paged attention
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# headline claim summary
# --------------------------------------------------------------------------

BERT_BASE = dict(n_layers=12, d=768, d_ff=3072, heads=12)
BERT_LARGE = dict(n_layers=24, d=1024, d_ff=4096, heads=16)


def headline_numbers(hw: Hardware = DEFAULT_HW) -> Dict[str, float]:
    """The paper's headline claims as the model predicts them."""
    out = {
        "softmax_puma_8192_w16_us":
            softmax_latency_s(hw, 8192, "puma", 16) * 1e6,
        "softmax_uclm_8192_w16_us":
            softmax_latency_s(hw, 8192, "uclm", 16) * 1e6,
        "softmax_multicore_8192_w16_us":
            softmax_latency_s(hw, 8192, "multicore", 16) * 1e6,
        "softmax_w64_gain_pct":
            100 * (1 - softmax_latency_s(hw, 8192, "multicore", 64)
                   / softmax_latency_s(hw, 8192, "multicore", 16)),
        "softmax_energy_ratio_puma_4096":
            softmax_energy_j(hw, 4096, "puma")
            / softmax_energy_j(hw, 4096, "multicore"),
        "tops_bert_base": end_to_end_tops(
            hw, BERT_BASE["n_layers"], 512, BERT_BASE["d"],
            BERT_BASE["d_ff"], batch=2),
        "tops_bert_large": end_to_end_tops(
            hw, BERT_LARGE["n_layers"], 512, BERT_LARGE["d"],
            BERT_LARGE["d_ff"], batch=2),
        "tops_puma_bert_base": end_to_end_tops(
            hw, BERT_BASE["n_layers"], 512, BERT_BASE["d"],
            BERT_BASE["d_ff"], pipelined="coarse", softmax_mode="puma",
            batch=1),
        "tops_w_hastily": tops_per_watt(
            hw, BERT_BASE["n_layers"], 512, BERT_BASE["d"],
            BERT_BASE["d_ff"], batch=2),
        "gpu_tops_bert_base": GPU.tops_bert_base_b1,
        "softmax_frac_puma_1024":
            softmax_fraction(hw, 1024, 768, "puma"),
        "softmax_frac_hastily_1024":
            softmax_fraction(hw, 1024, 768, "hastily"),
    }
    out["speedup_tops_vs_gpu_base"] = (out["tops_bert_base"]
                                       / GPU.tops_bert_base_b1)
    out["tops_w_vs_gpu_b1"] = out["tops_w_hastily"] / GPU.tops_w_b1
    out["tops_w_vs_gpu_b4"] = out["tops_w_hastily"] / GPU.tops_w_b4
    return out
