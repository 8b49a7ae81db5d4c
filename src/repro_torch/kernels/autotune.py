"""Roofline-guided kernel-config tuner for the varlen paged attention (port
of ``src/repro/kernels/autotune.py``).

    candidate  = (block_q, block_pages, dequant) on the CPU; on the card
                 (block_q, kv_split) — the card's kernel walks and
                 dequantises one page at a time, so ``block_pages`` and
                 ``dequant`` shape only the plain version there
    score      = the roofline of ``repro_torch.perfmodel`` over a mix of
                 serving steps, each step weighted by how often the traffic
                 runs it (the reference's model on ``cpu`` / ``tpu``; on
                 ``cuda`` the card's kernel model, reported beside the
                 measurement and never used to prune it)
    validate   = optionally time the real call: the plain version on the
                 CPU, kernel #2 on the card as the captured serving step
                 replays it (a CUDA graph, CUDA events, a cold L2)
    persist    = a JSON table keyed ``{model}::{platform}``, the port's own
                 file (``kernels/autotune.json``), which ``EngineCore``
                 resolves at construction

``KernelConfig`` is frozen and hashable: an engine's captured steps bake
it in.  ``source`` records provenance ("default" | "tuned").  Entry points
take the ``cuda`` platform unless the caller names another; measuring on
``cuda`` without a card raises.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.perfmodel import (PlatformSpec, paged_kernel_roofline,
                                   paged_kernel_traffic, platform_spec,
                                   varlen_attention_roofline,
                                   varlen_attention_traffic)

#: segments of one serving step: ``(n_new_tokens, kv_len_after)`` per lane
Workload = Sequence[Tuple[int, int]]
#: workload name → how many of the traffic's steps it stands for (absent: 1)
Weights = Optional[Dict[str, float]]


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Block shapes of the varlen paged attention (static facts).
    ``kv_split`` is the card's pages per split (``None``: the kernel's
    ``default_kv_split(page_size)``); the plain version on the CPU ignores
    it and scans unsplit, as the reference does."""
    block_q: int = 8            # q-block rows; 1 = untiled batch=T dataflow
    block_pages: Optional[int] = None   # pages per scan step (None = auto)
    dequant: str = "block"      # int8 scale granularity: "block" | "page"
    source: str = "default"     # "default" | "tuned" — provenance
    kv_split: Optional[int] = None      # the card's pages per split

    def describe(self) -> Dict[str, object]:
        return {"block_q": self.block_q, "block_pages": self.block_pages,
                "dequant": self.dequant, "source": self.source,
                "kv_split": self.kv_split}


DEFAULT_CONFIG = KernelConfig()


@dataclasses.dataclass(frozen=True)
class KernelGeom:
    """The model/pool facts the roofline needs about one deployment."""
    hq: int
    hkv: int
    head_dim: int
    page_size: int
    kv_bytes: int = 4           # 4 f32, 2 bf16, 1 int8 (+ scale planes)
    q_bytes: int = 4            # the query's element size (the card's model)

    @property
    def scaled(self) -> bool:
        return self.kv_bytes == 1


_BYTES = {"float32": 4, "bfloat16": 2}


def geom_for(cfg, *, page_size: int, quantized: bool = False) -> KernelGeom:
    """KernelGeom from a ModelConfig (``num_heads``/``num_kv_heads``/
    ``d_head``) plus the engine's pool facts: the pool's element size from
    its dtype (int8 when ``quantized``, else ``cfg.dtype``)."""
    item = _BYTES[cfg.dtype]
    return KernelGeom(hq=cfg.num_heads, hkv=cfg.num_kv_heads or cfg.num_heads,
                      head_dim=cfg.d_head, page_size=page_size,
                      kv_bytes=1 if quantized else item, q_bytes=item)


# --------------------------------------------------------------------------
# candidate space + representative workloads
# --------------------------------------------------------------------------

#: pages per split the card's sweep considers: 1 is left out, since the
#: workspace grows as 1 / kv_split (ROADMAP §2 #2, "Workspace")
CUDA_KV_SPLITS = (2, 4, 8, 16)


def candidate_space(page_size: int, *, max_block_q: int = 32,
                    max_block_pages: int = 8,
                    platform: str = "cuda") -> List[KernelConfig]:
    """Every candidate the sweep considers on ``platform``.

    Bq = 1 (the untiled baseline) stays in the space on purpose: on an
    all-decode workload tiling buys nothing, and the sweep should be able
    to say so rather than assume tiling always wins.  On ``cuda`` the
    space is ``block_q × kv_split``, ``block_pages`` and ``dequant`` left
    at their defaults.
    """
    bqs = [b for b in (1, 4, 8, 16, 32) if b <= max_block_q]
    if platform == "cuda":
        return [KernelConfig(block_q=bq, kv_split=n)
                for bq in bqs for n in CUDA_KV_SPLITS]
    bps = [p for p in (1, 2, 4, 8) if p <= max_block_pages]
    return [KernelConfig(block_q=bq, block_pages=bp, dequant=dq)
            for bq in bqs for bp in bps
            for dq in ("block", "page")]


def default_workloads(*, lanes: int = 8, chunk: int = 32,
                      decode_ctx: int = 256) -> Dict[str, Workload]:
    """The serving-step mix the score integrates over: the two full-width
    extremes the padded dispatch used to special-case, plus the mixed step
    ragged batching exists for."""
    return {
        "all_decode": [(1, decode_ctx)] * lanes,
        "all_prefill": [(chunk, chunk)] * lanes,
        "mixed": [(chunk, chunk), (chunk, 2 * chunk)]
                 + [(1, decode_ctx)] * (lanes - 2),
    }


# --------------------------------------------------------------------------
# scoring + optional measurement
# --------------------------------------------------------------------------

def predict_step_s(config: KernelConfig, geom: KernelGeom,
                   workloads: Dict[str, Workload],
                   spec: PlatformSpec, weights: Weights = None) -> float:
    """Roofline-predicted seconds summed over the workload mix, each
    workload times its weight: the reference's model, or on ``cuda`` the
    card's kernel model."""
    from repro_torch.kernels.paged_attention.ops import default_kv_split
    w = weights or {}
    total = 0.0
    if spec.name == "cuda":
        split = config.kv_split or default_kv_split(geom.page_size)
        for name, segments in workloads.items():
            total += w.get(name, 1.0) * paged_kernel_roofline(
                spec, paged_kernel_traffic(
                    segments, block_q=config.block_q, kv_split=split,
                    page_size=geom.page_size, hq=geom.hq, hkv=geom.hkv,
                    head_dim=geom.head_dim, kv_bytes=geom.kv_bytes,
                    q_bytes=geom.q_bytes, scaled=geom.scaled))
        return total
    bp = config.block_pages or max(1, 128 // max(geom.page_size, 1))
    for name, segments in workloads.items():
        traffic = varlen_attention_traffic(
            segments, block_q=config.block_q, block_pages=bp,
            page_size=geom.page_size, hq=geom.hq, hkv=geom.hkv,
            head_dim=geom.head_dim, kv_bytes=geom.kv_bytes,
            scaled=geom.scaled)
        total += w.get(name, 1.0) * varlen_attention_roofline(
            spec, traffic, block_pages=bp, dequant=config.dequant)
    return total


_DTYPES = {4: torch.float32, 2: torch.bfloat16}


def synthetic_step(segments: Workload, geom: KernelGeom, device,
                   seed: int = 0) -> Tuple[tuple, dict]:
    """A synthetic pool and packed stream for one workload, built as the
    reference's ``measure_step_s`` builds them (lane ``i`` owns pages
    ``i·P … (i+1)·P − 1``; one scratch page) → the positional arguments
    and the keyword arguments of ``paged_attention_varlen`` short of the
    block shapes.  Pools and queries take the geometry's element sizes
    (an int8 pool gets f32 scales)."""
    from repro_torch.kernels.paged_attention.varlen import varlen_positions
    rng = np.random.default_rng(seed)
    lens_new = [n for n, _ in segments]
    kv_lens = [kv for _, kv in segments]
    cu = np.concatenate([[0], np.cumsum(lens_new)]).astype(np.int32)
    t = int(cu[-1])
    ps = geom.page_size
    per_lane = max(-(-max(kv_lens) // ps), 1)
    n_pages = per_lane * len(segments)
    shape = (n_pages + 1, geom.hkv, ps, geom.head_dim)
    dev = lambda a, dt=None: torch.from_numpy(a).to(device, dt)  # noqa: E731
    kw = dict(cu_seqlens=dev(cu), k_scale=None, v_scale=None)
    if geom.scaled:
        k_pool = dev(rng.integers(-127, 127, size=shape).astype(np.int8))
        v_pool = dev(rng.integers(-127, 127, size=shape).astype(np.int8))
        kw["k_scale"] = kw["v_scale"] = dev(
            rng.uniform(0.01, 0.03, size=shape[:3]).astype(np.float32))
    else:
        dt = _DTYPES[geom.kv_bytes]
        k_pool = dev(rng.normal(size=shape).astype(np.float32), dt)
        v_pool = dev(rng.normal(size=shape).astype(np.float32), dt)
    q = dev(rng.normal(size=(t, geom.hq, geom.head_dim)).astype(np.float32),
            _DTYPES[geom.q_bytes])
    tbl = np.zeros((t, per_lane), np.int32)
    for i in range(len(segments)):
        tbl[cu[i]:cu[i + 1]] = np.arange(i * per_lane, (i + 1) * per_lane,
                                         dtype=np.int32)
    pos = varlen_positions(cu, kv_lens)
    return (q, k_pool, v_pool, dev(tbl), dev(pos)), kw


def config_kwargs(config: KernelConfig) -> dict:
    """The block-shape keywords of ``paged_attention_varlen`` for
    ``config``."""
    return dict(block_q=config.block_q, block_pages=config.block_pages,
                dequant=config.dequant, kv_split=config.kv_split)


#: ~1 ms of spinning at an H100's boost clock, ahead of each timed replay
_SPIN_CYCLES = 2_000_000
#: bytes zeroed before each timed replay: more than the H100's 50 MB L2
_FLUSH_BYTES = 256 << 20


def _replay_s(run, device: torch.device, iters: int) -> float:
    """Device seconds of ``run`` as a captured serving step replays it:
    the call captured once as a CUDA graph (after a warm call on a side
    stream, with the garbage collector off, as ``serving/graphs.py``
    captures), then the minimum over ``iters`` replays timed with CUDA
    events, each after the L2 is flushed and behind a spin that lets the
    host enqueue the replay before the first event fires."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            run()
    finally:
        if gc_was_on:
            gc.enable()
    flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=device)
    best = float("inf")
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) * 1e-3)
    return best


def measure_step_s(config: KernelConfig, geom: KernelGeom,
                   workloads: Dict[str, Workload], *, device="cuda",
                   iters: int = 3, weights: Weights = None,
                   steps: Optional[Dict[str, Tuple[tuple, dict]]] = None
                   ) -> float:
    """Time the real call on a synthetic pool built from the workloads
    (``synthetic_step``), summed over the workloads, each times its weight.

    The q-block layout is cut once, outside the clock, as a serving step
    cuts it once for all its layers.  On the card (the default; raises
    without one) the call is kernel #2 with the regather around it, timed
    as the captured step runs it (``_replay_s``: a CUDA graph replayed
    from a cold L2), after one eager call that builds the kernel; with
    ``device="cpu"`` it is the plain version, timed with the host clock.
    Each workload counts with its *minimum* over ``iters`` repetitions —
    the noise-robust microbenchmark estimator (scheduler hiccups only ever
    add time).  ``steps`` holds each workload's ``synthetic_step`` built
    once on the device, so that a sweep draws its pools once, not once per
    candidate."""
    from repro_torch.kernels.paged_attention.varlen import (
        paged_attention_varlen, varlen_layout)
    dev = resolve_device(device)
    w = weights or {}
    total = 0.0
    for name, segments in workloads.items():
        args, kw = (steps or {}).get(name) or synthetic_step(segments, geom,
                                                              dev)
        kw = dict(kw, **config_kwargs(config))
        kw["layout"] = varlen_layout(kw["cu_seqlens"], args[4],
                                     args[0].shape[0], config.block_q, dev)
        run = lambda: paged_attention_varlen(*args, **kw)  # noqa: E731
        run()                                 # build outside the clock
        if dev.type == "cuda":
            best = _replay_s(run, dev, iters)
        else:
            best = float("inf")
            for _ in range(iters):
                t0 = time.perf_counter()
                run()
                best = min(best, time.perf_counter() - t0)
        total += w.get(name, 1.0) * best
    return total


def tune(geom: KernelGeom, *, platform: str = "cuda",
         workloads: Optional[Dict[str, Workload]] = None,
         candidates: Optional[List[KernelConfig]] = None,
         measure: bool = False, top_k_measure: Optional[int] = None,
         iters: int = 3,
         weights: Weights = None) -> Tuple[KernelConfig, List[Dict]]:
    """Sweep the candidate space; return (winner, per-candidate report).

    Pure roofline by default (no device needed); ``measure=True`` re-ranks
    the roofline's ``top_k_measure`` finalists by timing the real call on
    ``platform``'s device — the cheap analytic model prunes, the hardware
    decides.  ``top_k_measure=None`` is the reference's 3 finalists on
    ``cpu`` / ``tpu``, and every candidate on ``cuda``: there the card's
    kernel model is a reported diagnostic, not a filter (on the H100 its
    own pick measured mid-field, PERF.md §6).  ``weights`` weights each
    workload by the steps it stands for, in the prediction and the
    measurement alike.  A candidate that fails to build or launch raises.

    The incumbent ``DEFAULT_CONFIG`` is always in the sweep, so the winner
    predicts no worse than the default *by construction*.
    """
    spec = platform_spec(platform)
    wl = workloads or default_workloads()
    cands = list(candidates or candidate_space(geom.page_size,
                                               platform=platform))
    if DEFAULT_CONFIG not in cands:
        cands.append(DEFAULT_CONFIG)
    if top_k_measure is None:
        top_k_measure = len(cands) if platform == "cuda" else 3
    report = []
    for c in cands:
        report.append({"config": c.describe(),
                       "predicted_s": predict_step_s(c, geom, wl, spec,
                                                     weights)})
    order = sorted(range(len(cands)), key=lambda i: report[i]["predicted_s"])
    if measure:
        finalists = order[:max(1, top_k_measure)]
        dev = resolve_device(platform)
        steps = {name: synthetic_step(seg, geom, dev)
                 for name, seg in wl.items()}
        for i in finalists:
            report[i]["measured_s"] = measure_step_s(
                cands[i], geom, wl, device=platform, iters=iters,
                weights=weights, steps=steps)
        best = min(finalists, key=lambda i: report[i]["measured_s"])
    else:
        best = order[0]
    winner = dataclasses.replace(cands[best], source="tuned")
    return winner, report


# --------------------------------------------------------------------------
# persistence: the per-(model, platform) table
# --------------------------------------------------------------------------

def table_path(path: Optional[os.PathLike] = None) -> Path:
    """Resolution order: explicit arg → $REPRO_TORCH_AUTOTUNE_PATH → the
    port's committed table beside this module."""
    if path is not None:
        return Path(path)
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_PATH")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent / "autotune.json"


def _key(model: str, platform: str) -> str:
    return f"{model}::{platform}"


def load_table(path: Optional[os.PathLike] = None) -> Dict[str, Dict]:
    p = table_path(path)
    if not p.exists():
        return {}
    try:
        return json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def save_config(model: str, platform: str, config: KernelConfig, *,
                path: Optional[os.PathLike] = None) -> Path:
    p = table_path(path)
    table = load_table(p)
    table[_key(model, platform)] = config.describe()
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    return p


def resolve_config(model: str, platform: str = "cuda", *,
                   path: Optional[os.PathLike] = None) -> KernelConfig:
    """Tuned config for (model, platform) if persisted, else the default.

    Falls back ``model::platform`` → ``default::platform`` →
    ``DEFAULT_CONFIG`` so a table tuned for one model still seeds its
    platform's siblings.  Keys the table holds that ``KernelConfig`` does
    not know are dropped.
    """
    table = load_table(path)
    for key in (_key(model, platform), _key("default", platform)):
        entry = table.get(key)
        if entry is not None:
            known = {f.name for f in dataclasses.fields(KernelConfig)}
            entry = {k: v for k, v in entry.items() if k in known}
            return KernelConfig(**{**entry, "source": "tuned"})
    return DEFAULT_CONFIG


# --------------------------------------------------------------------------
# process-wide active config (what a ragged call without one consults)
# --------------------------------------------------------------------------

_ACTIVE: Optional[KernelConfig] = None


def set_active_config(config: Optional[KernelConfig]) -> None:
    """Pin the config ragged attention calls use when they pass none.
    ``None`` reverts to on-disk resolution."""
    global _ACTIVE
    _ACTIVE = config


def active_config(platform: str = "cuda") -> KernelConfig:
    if _ACTIVE is not None:
        return _ACTIVE
    return resolve_config("default", platform)
