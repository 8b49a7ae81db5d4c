"""The PyTorch port's main paths on one NVIDIA H100: build, check, encode,
serve, score.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. print the card (``torch.cuda.get_device_name`` and ``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/csrc`` with nvcc for
   sm_90a and print ptxas's registers / shared memory / spills; the bf16
   streaming-attention kernels' lines again, and their SASS HMMA counts
   (``cuobjdump``): each head-dim instantiation must hold tensor-core
   instructions; likewise the int8 matmul's wgmma kernels and their SASS
   IGMMA counts;
3. hold the LUT-exp kernel bit-equal to its plain version (the reference
   sweep shapes and edge values, orders 0/1, f32/bf16, and an unaligned
   view);
4. hold the paged-attention kernel (split pass + combine) to its plain
   version cut into the same splits, at full-width shapes (32 heads of 128,
   page size 16, ~1000 pages, 8 lanes with 37 to ~2000 live rows, shuffled
   tables): decode and q-block-tiled steps over f32, bf16 and int8 pools,
   GQA, softcap, window, lut0 and exact exp, each at the default split and
   at one page per split;
5. hold the streaming-attention kernel to its plain version at BERT-large
   widths (16 × 64, l 512 and 4096) and deepseek widths (32 × 128, causal,
   l 2048), f32 and bf16, with GQA 4:1, window, softcap, q_offset/kv_len,
   ragged Lq/Lkv, rows that see no key, lut0 and exact exp, each in both
   dtypes, bf16 also against the f32 plain version (``PV_LIMITS``: P·V
   stays the f32 product); every bf16 call counted on the tensor-core
   kernel, every f32 call on the CUDA-core one;
6. encode with BERT-large at full width and depth (random weights from a
   seed) through ``build_model(cfg).prefill`` on 8 × 512 and 1 × 4096
   tokens: 24 streaming-attention launches per forward (bf16: all on the
   tensor-core kernel), tokens/s, peak memory; the masked-LM loss; logits
   through the kernel held against the same forward through the plain
   attention, in bf16 and f32 (f32: all 24 on the CUDA-core kernel);
7. serve 8 requests of deepseek-7b at full width and full depth through
   ``EngineCore`` with a bf16 pool, then an int8 pool, each in two arms:
   the eager arm (``capture=False``, the step dispatched op by op) and
   the captured arm (``capture=True``, the default: one CUDA graph per
   (stream width, table width), replayed).  The captured arm's first
   pass runs in lockstep with an eager twin (equal plans; equal picks on
   every lane save a near-tie shown by PR 11's margin rule), warm passes
   repeat until one captures nothing new (at most 3), then
   ``obs.mark_warm()`` and a measured pass (step p50/p99, tokens/s, peak
   memory, TTFT/TPOT from the registry, ``step_retraces_total``); every
   pass's greedy streams equal the eager arm's.  Kernel launches are
   counted over each timed pass (paged attention's split pass and its
   combine, each = layers × steps, replayed steps included).  Profiler
   windows (``obs.arm_profiler``) over one mixed and one pure-decode step
   of each arm print ``profile_summary`` (device time by kernel and by
   group, kernels launched, host launch calls, device idle share) and
   keep the traces gzipped under ``chiprun_out/traces/``.  Then hold one
   full-width ragged step's logits through the kernel against the same
   step through the plain attention, in bf16 on the served pool and in
   f32; score 2 × 1024 tokens causally through ``build_model(cfg).loss``
   (one streaming-attention launch per layer: bf16 on the tensor-core
   kernel, f32 on the CUDA-core one) against the plain attention, in bf16
   and in f32;
8. hold the activation quantisation kernel (``quantize_dynamic``)
   bit-equal to its plain version, int8 values and scale, f32 and bf16:
   ragged and unaligned sizes, all zeros, exact .5 ties, an outlier,
   bits=4; hold both int8 matmul variants (wgmma, and mma.sync) bit-exactly
   to their plain version on both weight layouts, accumulators and
   outputs: the reference suite's shapes, a batch, M = 1 and 8, ragged M,
   N and K, and all-±127 operands past 2^24;
9. the INT8 path at BERT-large width and depth: quantise the 144 projection
   weights (wq, wk, wv, wo, up, down of 24 layers) with ``quantize(w,
   axis=0)`` (K-major) and push real activations of 8 × 512 tokens through
   ``dense_maybe_quant``: 144 quantisation launches, 144 wgmma launches, 0
   mma.sync, 0 weight transposes; every output bit-equal to the plain
   version, int32 accumulators included, and within 3% (relative) of the
   bf16 product in f32; the pass timed whole, by part (quantisations,
   products, GELUs) and by its host work alone; the pass captured once as
   a CUDA graph (a measurement), its replay bit-equal to the eager pass
   and timed beside it;
10. time each kernel at its main path's shapes (paged attention, its
   combine and the LUT exp at the engine's decode step, paged attention
   also at a mixed step of one 256-token prefill chunk and 7 decodes, and
   at both shapes beside SDPA three ways: as a caller sees it, the device
   time alone and the host time per call, with a sweep over 4, 8 and 16
   pages per split; streaming attention at the BERT
   encode and deepseek scoring shapes, with exact exp and the f32 CUDA-core
   kernel beside it; the int8 matmul at the BERT-large projections, device
   alone too, with its mma.sync variant, each wgmma tile width and
   ``_int_mm`` on both weight layouts; the quantisation kernel at the
   pass's two input shapes; the LUT exp device alone and host per call)
   beside its plain version, a library yardstick and its roofline bound,
   and print the ``{"kernels": [...]}`` line; the end-to-end times beside
   the readings before the split-KV kernel and the bf16 unembed;
11. print the card's name and power limit, then ``{"ok": true, "device":
   {...}}`` as the last line.

Exits non-zero without a result when no CUDA card is visible.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEV = "cuda"
MODEL = "deepseek-7b"
ENGINE = dict(lanes=8, page_size=16, num_pages=1024, chunk_size=256)
PROMPT_LENS = (64, 1024)           # prompt lengths drawn in [lo, hi]
MAX_NEW = 32
HQ, D, PS, N_PAGES = 32, 128, 16, 1000          # attention-check widths
KV_LENS = [37, 311, 598, 870, 1142, 1414, 1700, 1990]     # 37 … ~2000
CHUNK = 128                        # the prefill chunk of the tiled checks

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,    # dense; f32 off tensor cores
              "int8": 1979e12}
F32_TOL = dict(atol=2e-5, rtol=1e-4)
SA_TOL = dict(atol=3e-5, rtol=1e-4)  # the reference kernel suite's
BERT = "bert-large"
BERT_SHAPES = ((8, 512), (1, 4096))  # the paper's l, and the top of its sweep
MASK_ID = 103                        # [MASK] in BERT's WordPiece vocab
SCORE_SHAPE = (2, 1024)              # deepseek-7b causal scoring batch
INT8_TOKENS = (8, 512)               # the BERT-large int8 pass
INT8_PROJ = ("wq", "wk", "wv", "wo", "up", "down")
INT8_REL_TOL = 0.03                  # the reference's own bound (test_quant.py)
# The readings on this card before the split-KV paged kernel and the bf16
# unembed (PERF.md), printed beside this run's: encode, scoring and
# engine-step ms
EARLIER_MS = {"bert 8x512": 24.1, "bert 1x4096": 33.7, "scoring bf16": 104.0,
              "scoring f32": 584.2, "step p50 bf16": 70.78,
              "step p50 int8": 91.61}
KV_SPLIT_SWEEP = (4, 8, 16)        # pages per split timed at the decode shape
WARM_PASSES = 3                    # the captured arm's warm passes, at most,
                                   # the lockstep pass included
MIXED_CHUNK = (256, 512)           # the mixed step's chunk: (tokens, live rows)
# (M, K, N, what): the projections of an 8 × 512 batch, then the reference
# microbenchmark's shape
INT8_TIMED = [(4096, 1024, 1024, "wq/wk/wv/wo"), (4096, 1024, 4096, "up"),
              (4096, 4096, 1024, "down"),
              (256, 1024, 1024, "benchmarks/microbench.py bench_int8")]


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ----------------------------------------------------------------- helpers --

def cuda_ms(fn, *, iters=20, warmup=3, flush=None, spin=False):
    """Median time of ``fn`` in ms, CUDA events around each call; ``flush``
    (untimed) runs before each call to evict the L2 cache.  The events
    start when the host reaches ``fn``, so a call whose host work outlasts
    its device work reads its host time.  ``spin`` puts ~1 ms of spinning
    on the stream ahead of each call, so the host has enqueued all of
    ``fn`` before the first event fires: the device time alone."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


SPIN_CYCLES = 2_000_000            # ~1 ms at the H100's boost clock


def host_ms(fn, *, calls=50):
    """Host time of one call of ``fn`` in ms: ``calls`` calls enqueued back
    to back while the stream spins (~20 ms), so no call waits on the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20 * SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def interleaved_ms(timers, *, rounds=5):
    """Each zero-argument timer of ``timers`` run ``rounds`` times in turn
    (A, B, C, A, B, C, …) → name → the median of its readings.  Readings
    drift within a call; turns spread the drift over every configuration."""
    out = {k: [] for k in timers}
    for _ in range(rounds):
        for k, timer in timers.items():
            out[k].append(timer())
    return {k: float(np.median(v)) for k, v in out.items()}


def bf16_ulps(got, want, atol=F32_TOL["atol"]) -> float:
    """Largest |got − want| beyond the f32 atol, in bf16 ulps of the larger
    magnitude.  Both sides sum in f32 and round once to bf16, so they may
    land one ulp apart; near zero, where the f32 sums cancel, the f32
    tolerance's atol is the floor instead."""
    import torch
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    excess = ((g - w).abs() - atol).clamp_min(0.0)
    return float((excess / ulp).max())


# The bf16 tensor-core attention kernel multiplies p_hi + p_lo (two bf16
# halves of each f32 weight) by V so that P·V stays the plain version's f32
# product.  Within one bf16 ulp does not show that: p rounded once, or p_hi
# alone, stays within it.  These two statistics do (limits chosen from a
# float64 model of a 512-key softmax before any card run: the split reads
# rms ratio 1.0000 and bias ~2e-5, p rounded once 1.30, p_hi alone 2.03 and
# −2.3e-3).
PV_LIMITS = dict(rms_ratio=1.05, bias=2.0 ** -12)


def bf16_pv_precision(got, want32) -> dict:
    """bf16 outputs ``got`` against the f32 plain version ``want32``:
    ``rms_ratio``, the rms of got − want over the rms of bf16(want) − want
    (1 when the kernel's f32 result rounds as the plain one does), and
    ``bias``, Σ(got − want)·want / Σ want² (0 unless the weights are
    rounded one way)."""
    import torch
    g, w = got.double(), want32.double()
    base = float((want32.to(torch.bfloat16).double() - w).square().mean()
                 .sqrt())
    rms = float((g - w).square().mean().sqrt())
    ratio = rms / base if base > 0 else (0.0 if rms == 0 else np.inf)
    return dict(rms_ratio=ratio,
                bias=float(((g - w) * w).sum() / w.square().sum()))


def pv_precision_ok(stats) -> bool:
    return (stats["rms_ratio"] <= PV_LIMITS["rms_ratio"]
            and abs(stats["bias"]) <= PV_LIMITS["bias"])


# ------------------------------------------------------------------ phases --

def phase_card():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[card] {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi_line


def sass_counts(lib, opcode):
    """Per kernel function of a built library, how many SASS instructions
    carry ``opcode`` (``cuobjdump -sass`` from the toolkit that built it)."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib}: {out.stderr.strip()}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def phase_build():
    """Build every kernel; → the tensor-core attention kernels' ptxas lines
    (registers, spills) and their SASS tensor-core instruction counts."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"({build.build_dir()})")
    report = build.ptxas_report()
    for name, lines in report.items():
        for line in lines:
            log(f"[ptxas {name}] {line}")
    tc_kernel = "tensor_core16attention_kernel"    # the mangled name's tail
    tc = [line for line in report["streaming_attention"] if tc_kernel in line]
    for line in tc:
        log(f"[tensor_core kernel] {line}")
    hmma = {fn: n for fn, n in sass_counts(libs["streaming_attention"],
                                           "HMMA").items()
            if tc_kernel in fn}
    log(f"[tensor_core kernel] SASS HMMA instructions per instantiation "
        f"(head dim × exp mode): {sorted(hmma.values())}")
    if not tc or len(hmma) != len(tc) or not all(hmma.values()):
        fail(f"streaming attention: the bf16 kernels are not all on the tensor "
             f"cores (ptxas {len(tc)}, HMMA {hmma})")
    wg_kernel = "wgmma_kernel"
    wg = [line for line in report["int8_matmul"] if wg_kernel in line]
    for line in wg:
        log(f"[int8 wgmma kernel] {line}")
    igmma = {fn: n for fn, n in sass_counts(libs["int8_matmul"],
                                            "IGMMA").items()
             if wg_kernel in fn}
    log(f"[int8 wgmma kernel] SASS IGMMA instructions per tile width: "
        f"{sorted(igmma.values())}")
    if not wg or len(igmma) != len(wg) or not all(igmma.values()):
        fail(f"int8 matmul: the wgmma kernels hold no wgmma instructions "
             f"(ptxas {len(wg)}, IGMMA {igmma})")
    return dict(ptxas=tc, sass_hmma=hmma, int8_wgmma_ptxas=wg,
                int8_sass_igmma=igmma)


def phase_lut_exp():
    import torch
    from repro_torch.kernels.lut_exp import lut_exp, lut_exp_ref
    rng = np.random.default_rng(0)
    shapes = [(7,), (128,), (3, 5, 11), (256, 128), (1, 1), (1000,),
              (1 << 20,)]
    edges = np.array([-1e30, -100.0, 0.0, 80.0], np.float32)
    checked = 0
    for shape in shapes:
        x = rng.uniform(-20, 20, size=shape).astype(np.float32)
        for dt in (torch.float32, torch.bfloat16):
            for order in (0, 1):
                for arr in (x, np.concatenate([edges, x.reshape(-1)])):
                    xt = torch.from_numpy(arr).to(DEV, dt)
                    got = lut_exp(xt, order=order)
                    want = lut_exp_ref(xt, order=order)
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                                else torch.int32),
                                       want.view(torch.int16 if dt == torch.bfloat16
                                                 else torch.int32)):
                        fail(f"lut_exp not bit-equal: shape {shape} {dt} "
                             f"order {order}")
                    checked += 1
    # a start off the 16-byte grid: the element-wise path
    base = torch.from_numpy(rng.uniform(-20, 20, 4099).astype(np.float32)).to(DEV)
    for dt in (torch.float32, torch.bfloat16):
        xt = base.to(dt)[1:]
        if not bits_equal(lut_exp(xt).float(), lut_exp_ref(xt).float()):
            fail(f"lut_exp not bit-equal on an unaligned {dt} view")
        checked += 1
    log(f"[lut_exp] bit-equal to the plain version in {checked} cases")
    # the form the tensor-core attention kernel inlines (lut_exp_nonpos):
    # bit-equal on x <= 0, with the floors where the table index turns
    from repro_torch.kernels.streaming_attention.ops import softmax_exp
    grid = (np.arange(-126 * 128, 1, dtype=np.float64) / 128
            * np.log(2.0)).astype(np.float32)
    x = np.concatenate([edges[:3], np.float32([-0.0, -1e-45, -87.0]), grid,
                        np.nextafter(grid, np.float32(-np.inf)),
                        np.minimum(np.nextafter(grid, np.float32(np.inf)), 0),
                        -rng.uniform(0, 100, 1 << 22).astype(np.float32)])
    xt = torch.from_numpy(x).to(DEV)
    for order in (0, 1):
        got, want = softmax_exp(xt, order=order), lut_exp_ref(xt, order=order)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"lut_exp_nonpos (order {order}) not bit-equal to the plain "
                 f"LUT on x <= 0")
    log(f"[lut_exp] lut_exp_nonpos (the tensor-core attention kernel's form) "
        f"bit-equal to the plain version on {x.size} values x <= 0, orders 0/1")


def make_stream(spec, *, hq=None, hkv=None, d=None, ps=None, n_pages=None,
                pool="bfloat16", q_dtype="bfloat16", seed=0, lanes=8,
                exact_logits=False, width=None):
    """A full-width packed stream in the engine's layout: ``spec`` lists
    (new tokens, live rows after the step) per lane; pages drawn without
    replacement from a shuffled pool; dead rows pad to a power of two; cu
    carries a trailing pseudo-segment and zero-width repeats (lanes + 2);
    ``width`` overrides the stream width (a scheduler bucket).
    ``exact_logits`` draws q and k as small integers, so every q·k sum is
    exact in f32 whatever its order."""
    import torch
    from repro_torch.core.streaming_attention import quantize_kv_rows
    from repro_torch.kernels.paged_attention import varlen_positions
    hq, d, ps = hq or HQ, d or D, ps or PS
    hkv, n_pages = hkv or hq, n_pages or N_PAGES
    rng = np.random.default_rng(seed)
    need = [-(-kv // ps) for _, kv in spec]
    assert sum(need) <= n_pages
    perm = rng.permutation(n_pages)
    width_p = 1 << (max(need) - 1).bit_length()
    nq = np.array([n for n, _ in spec])
    live = int(nq.sum())
    width = width or 1 << (live - 1).bit_length()
    table = np.full((width, width_p), n_pages, np.int32)     # scratch page
    cu = np.concatenate([[0], np.cumsum(nq)]).astype(np.int32)
    off = 0
    for i, k in enumerate(need):
        table[cu[i]:cu[i + 1], :k] = perm[off:off + k]
        off += k
    pos = np.zeros(width, np.int32)
    pos[:live] = varlen_positions(cu, [kv for _, kv in spec])
    cu_full = np.full(lanes + 2, width, np.int32)
    cu_full[:len(cu)] = cu
    g = torch.Generator(device=DEV).manual_seed(seed)
    shape = (n_pages + 1, hkv, ps, d)
    k = torch.randn(shape, generator=g, device=DEV)
    v = torch.randn(shape, generator=g, device=DEV)
    q = torch.randn((width, hq, d), generator=g, device=DEV)
    if exact_logits:
        k = torch.randint(-3, 4, shape, generator=g, device=DEV).float()
        q = torch.randint(-3, 4, q.shape, generator=g, device=DEV).float()
    dev = lambda a: torch.from_numpy(a).to(DEV)  # noqa: E731
    out = dict(q=q.to(getattr(torch, q_dtype)), table=dev(table),
               pos=dev(pos), cu=dev(cu_full), spec=spec, live=live,
               hq=hq, hkv=hkv, d=d, ks=None, vs=None)
    if pool == "int8":
        kq, ks = quantize_kv_rows(k.reshape(1, -1, ps, d))
        vq, vs = quantize_kv_rows(v.reshape(1, -1, ps, d))
        out.update(k=kq.reshape(shape), v=vq.reshape(shape),
                   ks=ks.reshape(shape[:3]), vs=vs.reshape(shape[:3]))
    else:
        out.update(k=k.to(getattr(torch, pool)), v=v.to(getattr(torch, pool)))
    return out


def phase_paged_attention():
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_varlen,
        paged_attention_varlen_reference)
    from repro_torch.kernels.paged_attention.ops import default_kv_split
    decode = [(1, kv) for kv in KV_LENS]
    tiled = [(1, kv) for kv in KV_LENS]
    tiled[3] = (CHUNK, KV_LENS[3])                  # one prefill chunk
    cases = [
        ("decode f32", decode, 1, dict(pool="float32", q_dtype="float32"), {}),
        ("decode bf16", decode, 1, dict(pool="bfloat16"), {}),
        ("decode int8", decode, 1, dict(pool="int8"), {}),
        ("tiled f32", tiled, 8, dict(pool="float32", q_dtype="float32"), {}),
        ("tiled bf16", tiled, 8, dict(pool="bfloat16"), {}),
        ("tiled int8", tiled, 8, dict(pool="int8"), {}),
        ("tiled gqa 4:1 bf16", tiled, 8, dict(pool="bfloat16", hkv=HQ // 4),
         {}),
        ("tiled cap=50 f32", tiled, 8, dict(pool="float32", q_dtype="float32"),
         dict(cap=50.0)),
        ("tiled window=256 f32", tiled, 8,
         dict(pool="float32", q_dtype="float32"), dict(window=256)),

        # The order-0 LUT steps by 0.54% at table boundaries, so a logit
        # one rounding apart can flip a table index: the plain version scans
        # one page per step in the kernel's splits, as the kernel does, over
        # integer q and k whose logits are exact on both sides.
        ("tiled lut0 f32", tiled, 8,
         dict(pool="float32", q_dtype="float32", exact_logits=True),
         dict(exp_mode="lut0", block_pages=1)),
        ("tiled exact f32", tiled, 8, dict(pool="float32", q_dtype="float32"),
         dict(exp_mode="exact")),
    ]
    for i, (name, spec, bq, mk, kw) in enumerate(cases):
        s = make_stream(spec, seed=i, **mk)
        args = (s["q"], s["k"], s["v"], s["table"], s["pos"])
        for kv_split in (default_kv_split(s["k"].shape[2]), 1):
            kws = dict(dict(block_pages=8), **kw, cu_seqlens=s["cu"],
                       block_q=bq, k_scale=s["ks"], v_scale=s["vs"],
                       kv_split=kv_split)
            before = paged_attention.launches, paged_attention.combine_launches
            got = paged_attention_varlen(*args, **kws)
            torch.cuda.synchronize()
            if (paged_attention.launches, paged_attention.combine_launches) != (
                    before[0] + 1, before[1] + 1):
                fail(f"paged attention {name}: split pass and combine not "
                     f"launched once each")
            want = paged_attention_varlen_reference(*args, **kws)
            rows = slice(0, s["live"])               # dead rows are garbage
            g, w = got[rows], want[rows]
            if not torch.isfinite(got).all():
                fail(f"paged attention {name}: non-finite output")
            if got.dtype == torch.float32:
                err = float((g - w).abs().max())
                ok = torch.allclose(g, w, **F32_TOL)
                msg = f"max|Δ| {err:.3g} (atol 2e-5, rtol 1e-4)"
            else:
                err = bf16_ulps(g, w)
                ok = err <= 1.0
                msg = f"max {err:.2f} bf16 ulp beyond atol 2e-5 (limit 1)"
            log(f"[paged_attention] {name}, {kv_split} pages per split "
                f"({s['table'].shape[1]} table slots): {msg}")
            if not ok:
                fail(f"paged attention {name} at {kv_split} pages per split "
                     f"disagrees with the plain version: {msg}")


def sa_inputs(shape, dtype, seed, integers=False):
    """q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D) drawn on the card from a seed;
    ``integers`` draws q and k as small integers, so every logit is exact."""
    import torch
    b, hq, hkv, lq, lkv, d = shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    if integers:
        draw = lambda *s: torch.randint(-3, 4, s, generator=g,  # noqa: E731
                                        device=DEV).float()
    else:
        draw = lambda *s: torch.randn(s, generator=g, device=DEV)  # noqa: E731
    q, k = draw(b, hq, lq, d), draw(b, hkv, lkv, d)
    v = torch.randn((b, hkv, lkv, d), generator=g, device=DEV)
    dt = getattr(torch, dtype)
    return q.to(dt), k.to(dt), v.to(dt)


# (name, (B, Hq, Hkv, Lq, Lkv, D), dtype, kwargs): BERT-large widths at the
# paper's l and the top of its sweep, deepseek widths causal, then every
# option of the kernel at full width.
SA_CASES = [
    ("bert-large l512 f32", (8, 16, 16, 512, 512, 64), "float32", {}),
    ("bert-large l512 bf16", (8, 16, 16, 512, 512, 64), "bfloat16", {}),
    ("bert-large l4096 f32", (1, 16, 16, 4096, 4096, 64), "float32", {}),
    ("bert-large l4096 bf16", (1, 16, 16, 4096, 4096, 64), "bfloat16", {}),
    ("deepseek causal l2048 f32", (1, 32, 32, 2048, 2048, 128), "float32",
     dict(causal=True)),
    ("deepseek causal l2048 bf16", (1, 32, 32, 2048, 2048, 128), "bfloat16",
     dict(causal=True)),
    ("gqa 4:1 causal bf16", (2, 32, 8, 1024, 1024, 128), "bfloat16",
     dict(causal=True)),
    ("window 256 causal f32", (1, 32, 32, 2048, 2048, 128), "float32",
     dict(causal=True, window=256)),
    ("softcap 50 f32", (2, 16, 16, 512, 512, 64), "float32", dict(cap=50.0)),
    ("q_offset 1000 kv_len 1290 gqa f32", (2, 32, 8, 300, 1400, 128),
     "float32", dict(causal=True, q_offset=1000, kv_len=1290)),
    ("ragged Lq 1000 Lkv 1037 gqa f32", (3, 16, 4, 1000, 1037, 64), "float32",
     {}),
    ("rows that see no key f32", (1, 16, 16, 200, 512, 64), "float32",
     dict(causal=True, q_offset=560, window=100)),
    ("exact l512 f32", (8, 16, 16, 512, 512, 64), "float32",
     dict(exp_mode="exact")),
    ("exact causal l2048 bf16", (1, 32, 32, 2048, 2048, 128), "bfloat16",
     dict(causal=True, exp_mode="exact")),
    # The order-0 LUT depends on the online-softmax blocking and a logit one
    # rounding apart can flip a table index: held against the plain scan at
    # the kernel's 64-key tiles over integer q and k (exact logits, in bf16
    # too).
    ("lut0 l512 f32", (8, 16, 16, 512, 512, 64), "float32",
     dict(exp_mode="lut0")),
    ("lut0 causal l2048 f32", (1, 32, 32, 2048, 2048, 128), "float32",
     dict(causal=True, exp_mode="lut0")),
]
# bf16 twins of the f32-only cases: the tensor-core kernel on every option
SA_CASES += [(name[:-len(" f32")] + " bf16", shape, "bfloat16", kw)
             for name, shape, dtype, kw in SA_CASES[7:]
             if dtype == "float32"]
# the kernel each dtype launches (ops.kernel_variant)
VARIANT = {"float32": "cuda_core", "bfloat16": "tensor_core"}


def phase_streaming_attention():
    """Kernel #3 against its plain version on every case of ``SA_CASES``:
    f32 within the reference kernel suite's atol 3e-5 / rtol 1e-4, bf16
    within one bf16 ulp beyond that atol and, against the f32 plain
    version, within ``PV_LIMITS`` (lut0 excepted: its plain scan is held
    bit-close at the kernel's blocking instead); each launch counted under
    the kernel its dtype selects (bf16: tensor cores, f32: CUDA cores)."""
    import torch
    from repro_torch.core.streaming_attention import (
        streaming_attention as attention_scan)
    from repro_torch.kernels.streaming_attention import (attention_ref,
                                                         streaming_attention)
    from repro_torch.kernels.streaming_attention.ops import BLOCK_K
    worst = {}
    for i, (name, shape, dtype, kw) in enumerate(SA_CASES):
        lut0 = kw.get("exp_mode") == "lut0"
        q, k, v = sa_inputs(shape, dtype, seed=100 + i, integers=lut0)
        before = streaming_attention.launches
        by = dict(streaming_attention.launches_by_variant)
        got = streaming_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        by[VARIANT[dtype]] += 1
        if (streaming_attention.launches != before + 1
                or streaming_attention.launches_by_variant != by):
            fail(f"streaming attention {name}: the {VARIANT[dtype]} kernel "
                 f"was not launched once ({streaming_attention.launches_by_variant})")
        want32 = None if lut0 else attention_ref(q.float(), k.float(),
                                                 v.float(), **kw)
        want = (attention_scan(q, k, v, block_k=BLOCK_K, **kw) if lut0
                else want32.to(q.dtype))
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"streaming attention {name}: shape {tuple(got.shape)} or "
                 f"non-finite output")
        if "window" in kw and "q_offset" in kw:        # rows past the keys
            blind = torch.arange(shape[3], device=DEV) + kw["q_offset"] \
                - kw["window"] + 1 >= shape[4]
            if got[:, :, blind].any():
                fail(f"streaming attention {name}: a row that sees no key "
                     f"is not 0")
        if got.dtype == torch.float32:
            err = float((got - want).abs().max())
            ok = torch.allclose(got, want, **SA_TOL)
            msg = f"max|Δ| {err:.3g} (atol 3e-5, rtol 1e-4)"
        else:
            err = bf16_ulps(got, want, SA_TOL["atol"])
            ok = err <= 1.0
            msg = f"max {err:.2f} bf16 ulp beyond atol 3e-5 (limit 1)"
            if not lut0:
                pv = bf16_pv_precision(got, want32)
                ok = ok and pv_precision_ok(pv)
                msg += (f"; against f32: rms {pv['rms_ratio']:.4f}× the "
                        f"rounding's (limit {PV_LIMITS['rms_ratio']}), bias "
                        f"{pv['bias']:.2e} (limit ±2^-12)")
        worst[name] = err
        log(f"[streaming_attention] {name}: {msg}")
        if not ok:
            fail(f"streaming attention {name} disagrees with the plain "
                 f"version: {msg}")
        del q, k, v, got, want, want32
    torch.cuda.empty_cache()
    return worst


def reset_streaming_counts():
    from repro_torch.kernels.streaming_attention import streaming_attention
    streaming_attention.launches = 0
    for v in streaming_attention.launches_by_variant:
        streaming_attention.launches_by_variant[v] = 0


def expect_variant(label, variant, n):
    """Since the last reset, kernel #3 launched ``n`` times, all of them
    the ``variant`` kernel."""
    from repro_torch.kernels.streaming_attention import streaming_attention
    by = streaming_attention.launches_by_variant
    want = {v: (n if v == variant else 0) for v in by}
    log(f"[{label}] streaming attention launches by kernel: {by}")
    if by != want:
        fail(f"{label}: streaming attention launches by kernel {by}, "
             f"expected {want}")


def hold_logits(label, k_logits, p_logits, p2_logits, floor):
    """Kernel logits against the plain attention's, with the serving step's
    margin rule (``phase_step_vs_plain``):
    the kernel must sit within 3× the spread between two plain schedules
    (materialised logits and the online-softmax scan) on this very input,
    ``floor`` at least; greedy picks must agree on every row whose top-2
    margin exceeds twice the measured gap."""
    import torch
    for lg in (k_logits, p_logits, p2_logits):
        if not torch.isfinite(lg).all():
            fail(f"{label}: non-finite logits")
    err = float((k_logits - p_logits).abs().max())
    spread = float((p2_logits - p_logits).abs().max())
    tol = max(3.0 * spread, floor)
    flat_p = p_logits.reshape(-1, p_logits.shape[-1])
    top2 = torch.topk(flat_p, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = (k_logits.reshape(flat_p.shape).argmax(-1) == flat_p.argmax(-1))
    decided = margin > 2 * err
    log(f"[{label}] kernel vs plain attention max|Δlogit| {err:.3g}; plain "
        f"materialised vs scan {spread:.3g} (limit {tol:.3g}); logit std "
        f"{float(p_logits.std()):.3f}; argmax agrees on "
        f"{int(agree.sum())}/{agree.numel()} rows, all {int(decided.sum())} "
        f"rows with a top-2 margin > 2×max|Δ| must")
    if err > tol:
        fail(f"{label}: logits differ by {err} > {tol}")
    if not agree[decided].all():
        fail(f"{label}: argmax differs on a row with a clear margin")
    return dict(max_abs_logit=err, plain_spread=spread, limit=tol,
                rows=agree.numel(), agree=int(agree.sum()),
                decided=int(decided.sum()))


def hold_loss(label, losses, floor):
    """(kernel, materialised plain, plain scan) losses: the kernel within 3×
    the plain schedules' spread, ``floor`` at least."""
    k, p, p2 = losses
    err, spread = abs(k - p), abs(p2 - p)
    tol = max(3.0 * spread, floor)
    log(f"[{label}] kernel {k:.6f}, plain {p:.6f}, plain scan {p2:.6f}: "
        f"|Δ| {err:.3g} (limit {tol:.3g})")
    if not np.isfinite(losses).all() or err > tol:
        fail(f"{label}: kernel {k} vs plain {p} (limit {tol})")
    return dict(kernel=k, plain=p, plain_scan=p2, limit=tol)


def logits_three_ways(cfg, params, tokens, causal):
    """``lm_apply`` logits through the kernel (``auto``), the materialised
    plain attention (``naive``) and the plain scan (``jnp``)."""
    from repro_torch.models.lm import lm_apply
    return [lm_apply(cfg.replace(attn_backend=b), params, tokens,
                     causal=causal) for b in ("auto", "naive", "jnp")]


def phase_bert():
    """BERT-large at full width and depth: encode 8 × 512 and 1 × 4096
    tokens through ``build_model(cfg).prefill`` (24 kernel launches per
    forward), the masked-LM loss, and the logits held against the plain
    attention in bf16 and f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.streaming_attention import streaming_attention
    from repro_torch.models.api import build_model
    cfg = get_config(BERT)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(1), DEV)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"[weights] {cfg.name}: {sum(p.numel() for p in params.values()) / 1e6:.1f}"
        f" M parameters, {n_bytes / 1e9:.2f} GB {cfg.dtype}, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    facts = {"launches": 0, "forwards": {}}
    for b, l in BERT_SHAPES:
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, l)).astype(np.int32)).to(DEV)
        batch = {"tokens": tokens}
        model.prefill(params, batch)                  # warm: cuBLAS plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_streaming_counts()
        paged_attention.launches = 0
        logits, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        launches = streaming_attention.launches
        if launches != cfg.num_layers or paged_attention.launches:
            fail(f"bert encode {b}×{l}: streaming attention launched "
                 f"{launches} times (expected {cfg.num_layers}), paged "
                 f"{paged_attention.launches}")
        expect_variant(f"bert encode {b}×{l}", "tensor_core", cfg.num_layers)
        if logits.shape != (b, l, cfg.vocab_size) or not torch.isfinite(
                logits).all():
            fail(f"bert encode {b}×{l}: logits {tuple(logits.shape)} not "
                 f"finite")
        facts["launches"] += launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        walls = []
        for _ in range(5):                            # host clock, synced
            t0 = time.perf_counter()
            model.prefill(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        f = dict(ms=wall * 1e3, ms_all=[w * 1e3 for w in walls],
                 tok_s=b * l / wall, launches=launches, peak_gib=peak)
        log(f"[bert encode {b}×{l}] median of 5 forwards {f['ms']:.1f} ms "
            f"(earlier: {EARLIER_MS[f'bert {b}x{l}']} ms) → "
            f"{f['tok_s']:.0f} tokens/s; peak {peak:.2f} GiB; "
            f"streaming_attention launches {launches} in the counted forward")
        f["bf16"] = hold_logits(f"bert {b}×{l} bf16", *logits_three_ways(
            cfg, params, tokens, causal=False), floor=1e-2)
        facts["forwards"][f"{b}x{l}"] = f
        del logits
    # the masked-LM loss on the 8 × 512 batch: 15% of positions masked
    b, l = BERT_SHAPES[0]
    tokens = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
    masked = rng.random((b, l)) < 0.15
    batch = {"tokens": torch.from_numpy(np.where(masked, MASK_ID, tokens)
                                        .astype(np.int32)).to(DEV),
             "labels": torch.from_numpy(tokens).to(DEV),
             "loss_mask": torch.from_numpy(masked.astype(np.float32)).to(DEV)}
    reset_streaming_counts()
    losses = [float(build_model(cfg.replace(attn_backend=be)).loss(
        params, batch)[0]) for be in ("auto", "naive", "jnp")]
    if streaming_attention.launches != cfg.num_layers:
        fail("bert loss did not run through the kernel")
    expect_variant("bert loss", "tensor_core", cfg.num_layers)
    facts["mlm_loss"] = hold_loss("bert MLM loss", losses, floor=1e-3)
    log(f"[bert loss] masked-LM loss on {b}×{l} ({int(masked.sum())} masked): "
        f"{losses[0]:.4f} through the kernel, {losses[1]:.4f} plain (ln V = "
        f"{np.log(cfg.vocab_size):.4f})")
    # f32: the same weights widened
    c32 = cfg.replace(dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    del params
    for b, l in BERT_SHAPES:
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, l)).astype(np.int32)).to(DEV)
        reset_streaming_counts()
        three = logits_three_ways(c32, p32, tokens, causal=False)
        expect_variant(f"bert {b}×{l} f32", "cuda_core", cfg.num_layers)
        facts["forwards"][f"{b}x{l}"]["f32"] = hold_logits(
            f"bert {b}×{l} f32", *three, floor=1e-3)
        del three
    del p32
    torch.cuda.empty_cache()
    return facts


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


# (leading dims, K, N, x dtype): the reference kernel suite's shapes, its
# batched case, M = 1 and 8 at BERT-large widths, ragged K (byte staging;
# K % 16 ≠ 0 runs mma.sync only; 208 and 48 are whole TMA rows but not
# whole 128-byte stages) and N (masked and scalar stores)
INT8_CASES = [((64,), 256, 128, "float32"), ((17,), 300, 130, "float32"),
              ((4,), 128, 512, "float32"), ((257,), 1024, 384, "float32"),
              ((1,), 128, 128, "float32"), ((2, 3), 256, 64, "float32"),
              ((1,), 1024, 4096, "bfloat16"), ((8,), 4096, 1024, "bfloat16"),
              ((257,), 1024, 384, "bfloat16"), ((33,), 200, 96, "float32"),
              ((130,), 256, 100, "bfloat16"), ((70,), 208, 260, "bfloat16"),
              ((5,), 48, 20, "float32")]


# the quantisation kernel's cases: (name, shape, bits); "ties" holds exact
# .5 quotients (absmax 127 → scale 1), "outlier" one value 10^4 times the
# rest, "unaligned" a start off the 16-byte grid (element-wise path)
QUANT_CASES = [("ragged", (257, 131), 8), ("ragged", (7,), 8),
               ("ragged", (3, 5, 11), 8), ("unaligned", (4098,), 8),
               ("zeros", (64, 48), 8), ("ties", (96, 40), 8),
               ("outlier", (512, 64), 8), ("bits4", (33, 77), 4),
               ("bert", (8, 512, 1024), 8)]


def quant_input(name, shape, dt, g):
    import torch
    if name == "zeros":
        return torch.zeros(shape, device=DEV, dtype=dt)
    if name == "ties":
        x = torch.randint(-126, 126, shape, generator=g, device=DEV).float() + 0.5
        x[0, 0] = 127.0
        return x.to(dt)
    x = torch.randn((shape[0] + 1,) if name == "unaligned" else shape,
                    generator=g, device=DEV) * 3
    if name == "outlier":
        x[100, 7] = -3.0e4
    x = x.to(dt)
    return x[1:] if name == "unaligned" else x


def phase_quantize_checks():
    """The activation quantisation kernel against its plain version, bit
    for bit (int8 values and the f32 scale), f32 and bf16."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device=DEV).manual_seed(23)
    checked = 0
    for name, shape, bits in QUANT_CASES:
        for dt in (torch.float32, torch.bfloat16):
            x = quant_input(name, shape, dt, g)
            before = quant.quantize_dynamic.launches
            got = quant.quantize_dynamic(x, bits=bits)
            want = quant._quantize(x, torch.amax(torch.abs(x.to(torch.float32))),
                                   bits)
            torch.cuda.synchronize()
            if quant.quantize_dynamic.launches != before + 1:
                fail(f"quantize_dynamic {name} {shape}: kernel not launched")
            if not (torch.equal(got.values, want.values) and got.scale.shape == ()
                    and bits_equal(got.scale, want.scale)):
                fail(f"quantize_dynamic {name} {shape} {dt} bits {bits}: not "
                     f"bit-equal to the plain version (scale {float(got.scale)!r}"
                     f" vs {float(want.scale)!r})")
            if name == "ties" and float(got.scale) != 1.0:
                fail(f"quantize_dynamic ties: scale {float(got.scale)} != 1")
            checked += 1
    log(f"[quantize_dynamic] bit-equal to the plain version (int8 values and "
        f"scale) in {checked} cases: ragged and unaligned sizes, all zeros, "
        f".5 ties, an outlier, bits=4, f32 and bf16")


def int8_both_layouts(wv):
    """w as ``quantize(w, axis=0)`` stores it (K-major) and row-major."""
    return {"k_major": wv.t().contiguous().t(), "row": wv.contiguous()}


def phase_int8_checks():
    """Kernel #4 against its plain version, bit for bit: the f32 output of
    the public wrapper and, through the 2-D entry, the int32 accumulator;
    each variant the shape allows (wgmma where K % 16 == 0, mma.sync
    always), on both weight layouts."""
    import torch
    from repro_torch.core.quant import quantize, quantize_dynamic
    from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_2d,
                                                 int8_matmul_2d_ref,
                                                 int8_matmul_ref)
    phase_quantize_checks()
    g = torch.Generator(device=DEV).manual_seed(13)
    by_variant = {"wgmma": 0, "mma_sync": 0}
    for lead, k, n, dt in INT8_CASES:
        x = torch.randn((*lead, k), generator=g, device=DEV).to(getattr(torch, dt))
        wq = quantize(torch.randn((k, n), generator=g, device=DEV), axis=0)
        before = int8_matmul.launches
        got = int8_matmul(x, wq)
        torch.cuda.synchronize()
        if int8_matmul.launches != before + 1:
            fail(f"int8_matmul {lead}×{k}×{n}: kernel not launched")
        if not bits_equal(got, int8_matmul_ref(x, wq)):
            fail(f"int8_matmul {lead}×{k}×{n} {dt}: not bit-equal to the "
                 f"plain version")
        xq = quantize_dynamic(x)
        xv = xq.values.reshape(-1, k)
        ref, ref_acc = int8_matmul_2d_ref(xv, wq.values, xq.scale, wq.scale,
                                          with_acc=True)
        variants = ("wgmma", "mma_sync") if k % 16 == 0 else ("mma_sync",)
        for variant in variants:
            for lay, wv in int8_both_layouts(wq.values).items():
                out, acc = int8_matmul_2d(xv, wv, xq.scale, wq.scale,
                                          with_acc=True, variant=variant)
                by_variant[variant] += 1
                if not (torch.equal(acc, ref_acc) and bits_equal(out, ref)):
                    fail(f"int8_matmul {lead}×{k}×{n} {dt} {variant}, w {lay}: "
                         f"not bit-equal to the plain version (max|Δacc| "
                         f"{int((acc.long() - ref_acc.long()).abs().max())})")
    # all-±127 operands: |acc| past 2^24, where int→f32 rounds
    k, n = 4096, 1024
    xv = torch.where(torch.rand((256, k), generator=g, device=DEV) < 0.9, 127,
                     -127).to(torch.int8)
    wv = torch.where(torch.rand((k, n), generator=g, device=DEV) < torch.linspace(
        0.5, 1.0, n, device=DEV), 127, -127).to(torch.int8)
    xs = torch.full((), 0.01, device=DEV)
    ws = torch.rand((1, n), generator=g, device=DEV) + 0.5
    ref, ref_acc = int8_matmul_2d_ref(xv, wv, xs, ws, with_acc=True)
    big = int(ref_acc.abs().max())
    for variant in ("wgmma", "mma_sync"):
        for lay, w in int8_both_layouts(wv).items():
            out, acc = int8_matmul_2d(xv, w, xs, ws, with_acc=True,
                                      variant=variant)
            by_variant[variant] += 1
            if big <= 2 ** 24 or not (torch.equal(acc, ref_acc)
                                      and bits_equal(out, ref)):
                fail(f"int8_matmul ±127 {variant}, w {lay}: max|acc| {big}, "
                     f"not bit-equal to the plain version")
    log(f"[int8_matmul] bit-equal to the plain version (accumulators and f32 "
        f"outputs) in {len(INT8_CASES) + 1} cases, {by_variant} calls per "
        f"variant over both weight layouts; ±127 operands reach |acc| = "
        f"{big} > 2^24")


def phase_int8_bert():
    """The INT8 path at BERT-large width and depth: the 144 projection
    weights quantised per output channel (K-major values), real activations
    of 8 × 512 tokens (the layer-norm'd embeddings for the K = 1024
    products, the GELU of up's int8 output for down) through
    ``dense_maybe_quant``.  Counts zeroed just before the pass and read just
    after: the quantisation kernel, #4 by variant and by (M, K, N), and the
    weight transposes; then every output held bit-exactly to the plain
    version (through the 2-D entry for the int32 accumulators, launches
    outside the counted pass) and against the bf16 product in f32.  The
    pass is timed whole and by part (host clock around work that ends in a
    sync, medians of 5): the 144 quantisations alone on the pass's own
    activations, the 144 products alone on activations quantised
    beforehand, and the 24 GELUs; and its host time alone (``host_ms``: the
    pass enqueued behind a spin, no sync)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.quant import dense_maybe_quant, quantize, quantize_dynamic
    from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_2d,
                                                 int8_matmul_2d_ref)
    from repro_torch.models.layers import embed_full, layer_norm_apply
    from repro_torch.params import init_params
    from repro_torch.serving.graphs import CapturedCall
    cfg = get_config(BERT)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(1), DEV)
    t0 = time.perf_counter()
    qw = {(key, i): quantize(params[key][i], axis=0)
          for i in range(cfg.num_layers) for key in INT8_PROJ}
    torch.cuda.synchronize()
    quant_ms = (time.perf_counter() - t0) * 1e3
    if not all(q.values.stride() == (1, q.values.shape[0]) for q in qw.values()):
        fail("int8 bert: quantize(w, axis=0) did not store the weights K-major")
    b, l = INT8_TOKENS
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, l))
                              .astype(np.int32)).to(DEV)
    x = layer_norm_apply(params["ln1"][0], params["ln1_b"][0], embed_full(
        cfg, params, tokens, torch.arange(l, device=DEV)))
    dt = x.dtype

    def project(inp, wq, by_shape):
        before = int8_matmul.launches
        y = dense_maybe_quant(inp, wq)
        if by_shape is not None:
            mkn = f"{inp.numel() // inp.shape[-1]}x{wq.shape[0]}x{wq.shape[1]}"
            by_shape[mkn] = by_shape.get(mkn, 0) + int8_matmul.launches - before
        return y

    def forward_projections(by_shape=None):
        outs = {}
        for i in range(cfg.num_layers):
            for key in INT8_PROJ[:5]:
                outs[key, i] = (x, project(x, qw[key, i], by_shape))
            h = F.gelu(outs["up", i][1], approximate="tanh").to(dt)
            outs["down", i] = (h, project(h, qw["down", i], by_shape))
        return outs

    forward_projections()                             # warm
    torch.cuda.synchronize()
    by_shape = {}
    int8_matmul.launches = 0
    int8_matmul.launches_by_variant.update(wgmma=0, mma_sync=0)
    int8_matmul.transposes = 0
    quant.quantize_dynamic.launches = 0
    t0 = time.perf_counter()
    outs = forward_projections(by_shape)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = int8_matmul.launches
    counts = dict(int8_matmul=launches,
                  by_variant=dict(int8_matmul.launches_by_variant),
                  transposes=int8_matmul.transposes,
                  quantize_dynamic=quant.quantize_dynamic.launches)
    if (launches != len(qw) or sum(by_shape.values()) != launches
            or counts["by_variant"] != {"wgmma": len(qw), "mma_sync": 0}
            or counts["transposes"] != 0
            or counts["quantize_dynamic"] != len(qw)):
        fail(f"int8 bert pass: launches {counts} ({by_shape}), expected "
             f"{len(qw)} quantisations, {len(qw)} wgmma products, 0 mma.sync, "
             f"0 transposes")

    def synced_ms(fn):                                # host clock, synced
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    walls = synced_ms(forward_projections)
    pass_host_ms = host_ms(forward_projections, calls=1)
    inputs = [(inp, qw[k]) for k, (inp, _) in outs.items()]
    quant_walls = synced_ms(lambda: [quantize_dynamic(inp) for inp, _ in inputs])
    pre = [(quantize_dynamic(inp), wq) for inp, wq in inputs]
    pre = [(xq.values.reshape(-1, wq.shape[0]), xq.scale, wq) for xq, wq in pre]
    kernel_walls = synced_ms(lambda: [int8_matmul_2d(xv, wq.values, xs, wq.scale)
                                      for xv, xs, wq in pre])
    ups = [outs["up", i][1] for i in range(cfg.num_layers)]
    gelu_walls = synced_ms(lambda: [F.gelu(u, approximate="tanh").to(dt)
                                    for u in ups])
    xd, wd = inputs[0]
    call_host_ms = host_ms(lambda: dense_maybe_quant(xd, wd))
    del pre, ups, inputs

    def forward_bf16():
        for i in range(cfg.num_layers):
            for key in INT8_PROJ[:5]:
                y = dense_maybe_quant(x, params[key][i])
            dense_maybe_quant(F.gelu(y, approximate="tanh"), params["down"][i])

    bf16_walls = synced_ms(forward_bf16)

    worst = {key: 0.0 for key in INT8_PROJ}
    for (key, i), (inp, y) in outs.items():
        wq = qw[key, i]
        xq = quantize_dynamic(inp)
        xv = xq.values.reshape(-1, inp.shape[-1])
        out, acc = int8_matmul_2d(xv, wq.values, xq.scale, wq.scale,
                                  with_acc=True)
        ref, ref_acc = int8_matmul_2d_ref(xv, wq.values, xq.scale, wq.scale,
                                          with_acc=True)
        if not (torch.equal(acc, ref_acc) and bits_equal(out, ref)
                and bits_equal(y.reshape(ref.shape), ref)):
            fail(f"int8 bert {key}[{i}]: not bit-equal to the plain version")
        full = torch.matmul(inp.float(), params[key][i].float())
        rel = float(torch.linalg.norm(y - full) / torch.linalg.norm(full))
        worst[key] = max(worst[key], rel)
        if not y.isfinite().all() or y.shape != (b, l, wq.values.shape[1]):
            fail(f"int8 bert {key}[{i}]: output {tuple(y.shape)} not finite")
    if max(worst.values()) >= INT8_REL_TOL:
        fail(f"int8 bert: relative error to the bf16 product {worst} >= "
             f"{INT8_REL_TOL}")
    # The same pass captured once as a CUDA graph (a measurement: no model
    # path replays it), its replay held bit-equal to the eager outputs and
    # its launches counted through the capture's recorded counts.
    t0 = time.perf_counter()
    cap = CapturedCall(forward_projections, torch.device(DEV))
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    int8_matmul.launches = 0
    int8_matmul.launches_by_variant.update(wgmma=0, mma_sync=0)
    quant.quantize_dynamic.launches = 0
    replayed = cap.replay()
    torch.cuda.synchronize()
    graph_counts = dict(int8_matmul=int8_matmul.launches,
                        by_variant=dict(int8_matmul.launches_by_variant),
                        quantize_dynamic=quant.quantize_dynamic.launches)
    if graph_counts != dict(int8_matmul=len(qw), quantize_dynamic=len(qw),
                            by_variant={"wgmma": len(qw), "mma_sync": 0}):
        fail(f"int8 bert graph: one replay counted {graph_counts}")
    for key, (_, y) in outs.items():
        if not bits_equal(replayed[key][1], y):
            fail(f"int8 bert graph {key}: the replay is not bit-equal to the "
                 f"eager pass")
    graph_walls = synced_ms(cap.replay)
    del cap, replayed
    med = lambda w: float(np.median(w))  # noqa: E731
    facts = dict(launches=launches, launches_by_shape=by_shape, counts=counts,
                 weights=len(qw), quantize_ms=quant_ms, first_pass_ms=wall_ms,
                 ms=med(walls), ms_all=walls, host_ms=pass_host_ms,
                 quantize_dynamic_ms=med(quant_walls),
                 kernels_only_ms=med(kernel_walls), gelu_ms=med(gelu_walls),
                 call_host_ms=call_host_ms, bf16_ms=med(bf16_walls),
                 rel_err_vs_bf16=worst, graph_ms=med(graph_walls),
                 graph_ms_all=graph_walls, graph_capture_ms=capture_ms,
                 graph_counts=graph_counts)
    log(f"[int8 bert] {len(qw)} projection weights quantised (K-major) in "
        f"{quant_ms:.0f} ms; over {b}×{l} tokens: {counts} "
        f"({by_shape}), every output and accumulator bit-equal to the plain "
        f"version; the {len(qw)} projections take {facts['ms']:.2f} ms "
        f"(median of 5, host clock, synced), their host work alone "
        f"{pass_host_ms:.2f} ms; by part (synced): the {len(qw)} "
        f"quantisations {facts['quantize_dynamic_ms']:.2f} ms, the "
        f"{len(qw)} products on pre-quantised inputs "
        f"{facts['kernels_only_ms']:.2f} ms, the {cfg.num_layers} GELUs "
        f"{facts['gelu_ms']:.2f} ms; one dense_maybe_quant call's host time "
        f"{call_host_ms:.4f} ms; bf16 {facts['bf16_ms']:.2f} ms; worst "
        f"relative error to the bf16 product "
        + ", ".join(f"{k} {v:.4f}" for k, v in worst.items())
        + f" (limit {INT8_REL_TOL}); captured as one CUDA graph "
        f"({capture_ms:.0f} ms to capture): a replay takes "
        f"{facts['graph_ms']:.2f} ms (median of 5, synced) against the eager "
        f"pass's {facts['ms']:.2f}, bit-equal, counting {graph_counts}")
    del params, qw, outs, x
    torch.cuda.empty_cache()
    return facts


def phase_scoring(cfg, params, label, floor):
    """deepseek-7b causal scoring (``build_model(cfg).loss``) on 2 × 1024
    tokens: one kernel launch per layer, the loss and the logits held
    against the plain attention."""
    import torch
    from repro_torch.kernels.streaming_attention import streaming_attention
    from repro_torch.models.api import build_model
    b, l = SCORE_SHAPE
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, l))
                              .astype(np.int32)).to(DEV)
    reset_streaming_counts()
    t0 = time.perf_counter()
    loss = float(build_model(cfg).loss(params, {"tokens": tokens})[0])
    wall = time.perf_counter() - t0
    launches = streaming_attention.launches
    if launches != cfg.num_layers:
        fail(f"deepseek scoring {label}: streaming attention launched "
             f"{launches} times, expected {cfg.num_layers}")
    expect_variant(f"deepseek scoring {label}", VARIANT[cfg.dtype],
                   cfg.num_layers)
    losses = [loss] + [float(build_model(cfg.replace(attn_backend=be)).loss(
        params, {"tokens": tokens})[0]) for be in ("naive", "jnp")]
    log(f"[scoring {label}] deepseek-7b next-token loss on {b}×{l}: {loss:.4f} "
        f"through the kernel ({launches} launches, {wall * 1e3:.0f} ms incl. "
        f"the first call), {losses[1]:.4f} plain (ln V = "
        f"{np.log(cfg.vocab_size):.4f})")
    held = hold_logits(f"scoring {label}", *logits_three_ways(
        cfg, params, tokens, causal=True), floor=floor)
    held["loss"] = hold_loss(f"scoring {label} loss", losses, floor=floor / 10)
    walls = []
    for _ in range(3):                                # warm; host clock, synced
        t0 = time.perf_counter()
        build_model(cfg).loss(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"[scoring {label}] warm forward + loss, median of 3: "
        f"{np.median(walls):.1f} ms ({walls}; earlier: "
        f"{EARLIER_MS[f'scoring {label}']} ms)")
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=wall * 1e3, warm_ms=float(np.median(walls)),
                warm_ms_all=walls, **held)


def zero_paged_counts():
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.kernels.paged_attention import paged_attention
    paged_attention.launches = 0
    paged_attention.combine_launches = 0
    lut_exp.launches = 0


def read_paged_counts():
    from repro_torch.kernels.lut_exp import lut_exp
    from repro_torch.kernels.paged_attention import paged_attention
    return dict(paged_attention=paged_attention.launches,
                paged_combine=paged_attention.combine_launches,
                lut_exp=lut_exp.launches)


def submit_all(eng, prompts, uid0=0):
    from repro_torch.serving import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=uid0 + i, prompt=p, max_new=MAX_NEW))
    return list(range(uid0, uid0 + len(prompts)))


def timed_pass(eng, cfg, prompts, uid0, tag):
    """Serve the requests once; counts zeroed just before the pass and read
    just after → facts of the pass (streams in request order)."""
    import torch
    uids = submit_all(eng, prompts, uid0)
    eng.finished.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_paged_counts()
    step_ms, kinds, model_steps = [], [], 0
    t0 = time.perf_counter()
    while eng.scheduler.has_work():
        s0 = time.perf_counter()
        out = eng.step()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        kinds.append((out.prefill_tokens, out.decode_tokens, out.lanes))
        model_steps += out.lanes > 0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_paged_counts()
    peak = torch.cuda.max_memory_allocated()
    done = {r.uid: r.tokens for r in eng.finished}
    if sorted(done) != uids or any(len(done[u]) != MAX_NEW for u in uids):
        fail(f"engine {tag}: not every request produced {MAX_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for u in uids for t in done[u]):
        fail(f"engine {tag}: token outside the vocab")
    for kernel in ("paged_attention", "paged_combine"):
        if launches[kernel] != cfg.num_layers * model_steps:
            fail(f"engine {tag}: {kernel} launched {launches[kernel]} times, "
                 f"expected layers × steps = {cfg.num_layers} × {model_steps}")
    if eng.pages_in_use != 0:
        fail(f"engine {tag}: {eng.pages_in_use} pages leaked")
    gen = sum(len(done[u]) for u in uids)
    prompt_toks = sum(len(p) for p in prompts)
    return dict(steps=model_steps, launches=launches, generated=gen,
                prompt_tokens=prompt_toks, wall_s=wall, tok_s=gen / wall,
                all_tok_s=(gen + prompt_toks) / wall,
                step_ms_p50=float(np.percentile(step_ms, 50)),
                step_ms_p99=float(np.percentile(step_ms, 99)),
                peak_gib=peak / 2 ** 30, kinds=kinds,
                streams=[done[u] for u in uids])


def phase_engine(cfg, params, kv_quant: bool, prompts):
    """The eager arm: serve the requests with ``capture=False`` (the step
    dispatched op by op); → (engine, facts of the run)."""
    from repro_torch.serving import EngineCore
    c = cfg.replace(kv_quant=kv_quant)
    eng = EngineCore(c, params, device=DEV, capture=False, **ENGINE)
    tag = "int8" if kv_quant else "bf16"
    facts = dict(pool=tag, **timed_pass(eng, c, prompts, 0, f"eager {tag}"))
    log(f"[engine {tag}] eager: {facts['steps']} steps, {facts['generated']} "
        f"tokens generated, {facts['prompt_tokens']} prompt tokens in "
        f"{facts['wall_s']:.2f} s → {facts['tok_s']:.1f} generated tok/s "
        f"({facts['all_tok_s']:.1f} incl. prompt); step ms p50 "
        f"{facts['step_ms_p50']:.2f} (earlier: "
        f"{EARLIER_MS[f'step p50 {tag}']}) p99 {facts['step_ms_p99']:.2f}; "
        f"peak {facts['peak_gib']:.2f} GiB; launches {facts['launches']}")
    return eng, facts


def step_logits(eng, batch):
    """The live lanes' (lanes, V) f32 logits of ``batch`` through ``eng``'s
    pool, eagerly, after the engine ran it (the step rewrites its own KV
    rows with the same values, so it reads the history the step read)."""
    import torch
    from repro_torch.models.lm import KERNEL_CONFIG, lm_step_ragged
    a = {k: torch.from_numpy(v).to(DEV)
         for k, v in eng.step_arrays(batch).items()}
    lg = lm_step_ragged(eng.cfg, eng.params, a["tokens"], eng.kv.pool,
                        a["table"], a["pos"], a["last_idx"], a["cu"],
                        KERNEL_CONFIG)
    return lg[:len(batch.plans)].cpu().numpy()


def spy_batches(eng, seen):
    inner = eng.scheduler.batch_for

    def spy(wants):
        batch, pre = inner(wants)
        seen[eng] = batch
        return batch, pre
    eng.scheduler.batch_for = spy


def lockstep_pass(ce, twin, prompts, tag, windows):
    """The captured engine and an eager twin serve the same requests step
    by step: equal plans every step, and the same greedy pick on every lane
    unless PR 11's margin rule shows a near-tie (the eager logits' top-2
    margin at that lane below the largest logit gap between the two
    engines on that step), which forks the request: its later tokens are
    not compared.  ``windows`` {step index: logdir} arms the twin's
    profiler on those steps (the eager arm's trace) → (forks, traces)."""
    seen, forks, traces = {}, [], {}
    for eng in (ce, twin):
        spy_batches(eng, seen)
        submit_all(eng, prompts, uid0=100)
        eng.finished.clear()
    i = 0
    while ce.scheduler.has_work() or twin.scheduler.has_work():
        if i in windows:
            twin.obs.arm_profiler(1, windows[i])
        oc, oe = ce.step(), twin.step()
        bc, be = seen[ce], seen[twin]
        plan = [(p.run.req.uid, p.q_len) for p in be.plans]
        if plan != [(p.run.req.uid, p.q_len) for p in bc.plans]:
            fail(f"compiled {tag}: step {i} planned differently from the eager "
                 f"twin")
        forked = {f["uid"] for f in forks}
        diff = [u for u in oe.tokens if u not in forked
                and oc.tokens.get(u) != oe.tokens[u]]
        if diff:
            lc, le = step_logits(ce, bc), step_logits(twin, be)
            gap = float(np.abs(lc - le).max())
            for u in diff:
                lane = [uid for uid, _ in plan].index(u)
                top2 = np.sort(le[lane])[-2:]
                margin = float(top2[1] - top2[0])
                fork = dict(uid=u, step=i, margin=margin, gap=gap,
                            captured=oc.tokens.get(u), eager=oe.tokens[u])
                log(f"[compiled {tag}] lane of request {u} differs at step {i}: "
                    f"{fork}")
                if not margin < gap:
                    fail(f"compiled {tag}: request {u} differs from the eager "
                         f"twin at step {i} with a top-2 margin {margin} not "
                         f"below the logit gap {gap}")
                forks.append(fork)
        if i in windows:
            traces[i] = twin.obs.last_trace
        i += 1
    for eng in (ce, twin):
        del eng.scheduler.batch_for                 # the spy
    return forks, traces


def step_kind_indices(kinds):
    """Step indices of the pass's first mixed step and first step in which
    every lane decodes and none prefills."""
    mixed = next(i for i, (pf, dc, _) in enumerate(kinds) if pf and dc)
    decode = next(i for i, (pf, dc, n) in enumerate(kinds)
                  if not pf and dc == n == ENGINE["lanes"])
    return {"mixed": mixed, "decode": decode}


KERNEL_GROUPS = (("paged_attention_kernel", "paged split pass"),
                 ("paged_combine", "paged combine"),
                 ("gemm", "GEMM"), ("gemv", "GEMM"), ("xmma", "GEMM"),
                 ("nvjet", "GEMM"),
                 ("cutlass", "GEMM"), ("Memcpy", "copy"), ("Memset", "copy"),
                 ("index", "index / gather / scatter"),
                 ("scatter", "index / gather / scatter"),
                 ("gather", "index / gather / scatter"),
                 ("reduce", "reduce"), ("elementwise", "elementwise"),
                 ("vectorized", "elementwise"))


def kernel_group(name):
    low = name.lower()
    for key, group in KERNEL_GROUPS:
        if key.lower() in low:
            return group
    return "other"


def read_window(path, label):
    """Summarise a profiler window's trace (``profile_summary``), print it,
    and keep the trace gzipped beside it; fails when the window wrote no
    trace."""
    import gzip
    import os
    from repro_torch.serving.tracing import profile_summary
    if path is None or not os.path.exists(path):
        fail(f"profiler window {label} wrote no trace")
    s = profile_summary(path, top=None)
    groups = {}
    for name, ms in s["by_name"].items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    top = dict(list(s["by_name"].items())[:8])
    with open(path, "rb") as f_in, gzip.open(path + ".gz", "wb") as f_out:
        f_out.write(f_in.read())
    os.remove(path)
    out = dict(launches=s["launches"], device_ms=s["device_ms"],
               window_ms=s["window_ms"], busy_ms=s["busy_ms"],
               idle_share=s["idle_share"],
               kernel_span_ms=s["kernel_span_ms"],
               kernel_span_idle_share=s["kernel_span_idle_share"],
               host_launch_calls=s["host_launch_calls"],
               launch_call_ms=s["launch_call_ms"],
               by_group=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
               top=top, trace=os.path.relpath(path + ".gz", ROOT))
    log(f"[profile {label}] {s['launches']} kernels on the device, "
        f"{s['device_ms']:.3f} ms device time in a {s['window_ms']:.3f} ms "
        f"window: idle share {s['idle_share']:.3f}, "
        f"{s['kernel_span_idle_share']:.3f} between the first and the last "
        f"kernel ({s['kernel_span_ms']:.3f} ms apart); host launch calls "
        f"{s['host_launch_calls']}, {s['launch_call_ms']:.3f} ms of host "
        f"time; by group (ms) "
        + json.dumps({k: round(v, 4) for k, v in out["by_group"].items()})
        + "; top kernels (ms) "
        + json.dumps({k[:60]: round(v, 4) for k, v in top.items()})
        + f"; trace {out['trace']}")
    if not s["launches"]:
        log(f"[profile {label}] the trace holds no device event: device "
            f"times, launches and idle share of this window not measured")
    return out


def phase_compiled(cfg, params, kv_quant: bool, prompts, eager):
    """The captured arm: one engine with ``capture=True`` (one CUDA graph per
    (T, P), replayed) serves the same requests.

    Pass 1 runs in lockstep with a fresh eager twin (``lockstep_pass``),
    whose profiler takes the eager arm's windows; warm passes repeat until
    one captures nothing new (at most ``WARM_PASSES``, pass 1 included);
    then ``obs.mark_warm()`` and a measured pass (``timed_pass``: launches equal
    layers × model steps on replayed steps); then a pass with the replayed
    arm's profiler windows.  Every pass's greedy streams must equal the
    eager arm's, save a lane the lockstep showed to be a near-tie."""
    import torch
    from repro_torch.serving import EngineCore
    c = cfg.replace(kv_quant=kv_quant)
    tag = "int8" if kv_quant else "bf16"
    kinds = step_kind_indices(eager["kinds"])
    ce = EngineCore(c, params, device=DEV, **ENGINE)
    twin = EngineCore(c, params, device=DEV, capture=False, **ENGINE)
    tdir = ROOT / "chiprun_out" / "traces"
    forks, traces = lockstep_pass(
        ce, twin, prompts, tag,
        {i: str(tdir / f"{tag}_eager_{k}") for k, i in kinds.items()})
    windows = {f"eager {k}": read_window(traces[i], f"{tag} eager {k} step {i}")
               for k, i in kinds.items()}
    del twin
    torch.cuda.empty_cache()
    excused = {f["uid"] - 100 for f in forks}

    def check_streams(streams, label):
        for j, (got, want) in enumerate(zip(streams, eager["streams"])):
            if j not in excused and got != want:
                fail(f"compiled {tag} {label}: request {j}'s greedy stream "
                     f"differs from the eager arm's")

    check_streams([r.tokens for r in sorted(ce.finished, key=lambda r: r.uid)],
                  "pass 1")
    captures = [ce.graphs.captures]
    ms_at = [len(ce.graphs.capture_ms)]
    uid0 = 200
    while captures[-1] and len(captures) < WARM_PASSES:
        before = ce.graphs.captures
        f = timed_pass(ce, c, prompts, uid0, f"compiled {tag} warm")
        check_streams(f["streams"], f"warm pass {len(captures) + 1}")
        captures.append(ce.graphs.captures - before)
        ms_at.append(len(ce.graphs.capture_ms))
        uid0 += 100
    cap_ms = ce.graphs.capture_ms
    per_pass_ms = [cap_ms[a:b] for a, b in zip([0] + ms_at[:-1], ms_at)]
    ce.obs.mark_warm()
    reg = ce.obs.registry
    win, snap = ce.obs.engine_window(), reg.snapshot()
    measured = timed_pass(ce, c, prompts, uid0, f"compiled {tag}")
    check_streams(measured["streams"], "measured pass")
    lat = ce.obs.engine_latency_summary(win)
    delta = reg.delta(snap)
    retraces = int(reg.value("step_retraces_total"))
    uid0 += 100
    submit_all(ce, prompts, uid0)                    # the replayed windows
    ce.finished.clear()
    at = {i: k for k, i in kinds.items()}
    i = 0
    while ce.scheduler.has_work():
        if i in at:
            ce.obs.arm_profiler(1, str(tdir / f"{tag}_replayed_{at[i]}"))
        ce.step()
        if i in at:
            windows[f"replayed {at[i]}"] = read_window(
                ce.obs.last_trace, f"{tag} replayed {at[i]} step {i}")
        i += 1
    check_streams([r.tokens for r in sorted(ce.finished, key=lambda r: r.uid)],
                  "profiled pass")
    if ce.obs.registry.value("step_retraces_total") != retraces:
        fail(f"compiled {tag}: the profiled pass captured again")
    facts = dict(
        pool=tag, captures_per_pass=captures,
        capture_ms=[float(np.median(m)) if m else 0.0 for m in per_pass_ms],
        capture_ms_all=cap_ms, keys=sorted(ce.graphs.keys),
        step_retraces_total=retraces,
        step_traces_total=int(reg.value("step_traces_total")),
        forks=forks, ttft_ms_p50=lat["ttft_ms_p50"],
        ttft_ms_p99=lat["ttft_ms_p99"], tpot_ms=lat["tpot_ms"],
        registry_delta={k: v for k, v in delta.items() if v},
        windows=windows, step_kinds=kinds,
        **{k: v for k, v in measured.items() if k not in ("streams", "kinds")})
    log(f"[compiled {tag}] captures per pass {captures} (pass 1 in lockstep "
        f"with the eager twin), median ms per capture "
        f"{[round(m, 1) for m in facts['capture_ms']]}; keys (T, P) "
        f"{facts['keys']}; after mark_warm(): step_retraces_total {retraces}; "
        f"measured pass: {measured['steps']} steps, step ms p50 "
        f"{measured['step_ms_p50']:.2f} p99 {measured['step_ms_p99']:.2f} "
        f"(eager {eager['step_ms_p50']:.2f} / {eager['step_ms_p99']:.2f}); "
        f"{measured['tok_s']:.1f} generated tok/s ({measured['all_tok_s']:.1f} "
        f"incl. prompt; eager {eager['tok_s']:.1f}); peak "
        f"{measured['peak_gib']:.2f} GiB (eager {eager['peak_gib']:.2f}); "
        f"TTFT p50 {lat['ttft_ms_p50']:.1f} p99 {lat['ttft_ms_p99']:.1f} ms, "
        f"TPOT {lat['tpot_ms']:.2f} ms (registry); launches "
        f"{measured['launches']} = layers × steps; greedy streams equal the "
        f"eager arm's on all {len(prompts)} requests"
        + (f" save near-tie forks {forks}" if forks else ""))
    del ce
    torch.cuda.empty_cache()
    return facts


def phase_step_vs_plain(cfg, params, pool, label: str, floor: float):
    """One full-width ragged step (7 decode lanes + a prefill chunk) over
    ``pool``, through the kernel and through the plain attention (passed
    explicitly, at 8 pages per online-softmax step and at 1).  Each run
    rewrites the step's own rows before attending, so all three read the
    same history.

    Tolerance: the kernel must sit within 3× the spread between the two
    plain schedules on this very step (``floor`` at least) — in bf16 every
    attention output rounds once, so schedules land up to an ulp apart and
    the gap travels through the layers; in f32 only the sum order differs.
    Greedy picks must agree on every lane whose top-2 margin exceeds twice
    the measured gap."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention_varlen_reference)
    from repro_torch.models.lm import KERNEL_CONFIG, lm_step_ragged
    from repro_torch.serving.scheduler import default_token_buckets
    rng = np.random.default_rng(7)
    spec = [(1, kv) for kv in KV_LENS[1:]] + [(CHUNK, 3 * CHUNK)]
    ps, n_pages = pool["k"].shape[3], pool["k"].shape[1] - 1
    need = [-(-kv // ps) for _, kv in spec]
    perm = rng.permutation(n_pages)
    nq = np.array([n for n, _ in spec])
    live = int(nq.sum())
    buckets = default_token_buckets(ENGINE["lanes"] + ENGINE["chunk_size"])
    width = min(w for w in buckets if w >= live)
    pw = 1 << (max(need) - 1).bit_length()
    table = np.full((width, pw), n_pages, np.int32)            # scratch page
    cu = np.concatenate([[0], np.cumsum(nq)]).astype(np.int32)
    pos = np.zeros(width, np.int32)
    off = 0
    for i, (n, kv) in enumerate(spec):
        table[cu[i]:cu[i + 1], :need[i]] = perm[off:off + need[i]]
        off += need[i]
        pos[cu[i]:cu[i + 1]] = np.arange(kv - n, kv)
    tokens = np.zeros(width, np.int32)
    tokens[:live] = rng.integers(0, cfg.vocab_size, live)
    cu_full = np.full(ENGINE["lanes"] + 2, width, np.int32)
    cu_full[:len(cu)] = cu
    last_idx = (cu[1:] - 1).astype(np.int32)
    dev = lambda a: torch.from_numpy(a).to(DEV)  # noqa: E731
    args = (cfg, params, dev(tokens), pool, dev(table), dev(pos),
            dev(last_idx), dev(cu_full), KERNEL_CONFIG)
    k_logits = lm_step_ragged(*args)
    p_logits = lm_step_ragged(*args, attend=paged_attention_varlen_reference)
    p1_logits = lm_step_ragged(*args, attend=lambda *a, **kw: (
        paged_attention_varlen_reference(*a, **{**kw, "block_pages": 1})))
    torch.cuda.synchronize()
    for lg in (k_logits, p_logits, p1_logits):
        if lg.shape != (len(spec), cfg.vocab_size) or not torch.isfinite(lg).all():
            fail(f"{label} step: logits {tuple(lg.shape)} not finite")
    err = float((k_logits - p_logits).abs().max())
    spread = float((p1_logits - p_logits).abs().max())
    tol = max(3.0 * spread, floor)
    top2 = torch.topk(p_logits, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    agree = (k_logits.argmax(-1) == p_logits.argmax(-1)).cpu().numpy()
    decided = margin > 2 * err
    log(f"[step {label}] full-width ragged step ({live} live rows, width "
        f"{width}, {cfg.num_layers} layers): kernel vs plain attention "
        f"max|Δlogit| {err:.3g}; plain 8-page vs 1-page schedule "
        f"{spread:.3g} (limit {tol:.3g}); logit std "
        f"{float(p_logits.std()):.3f}; greedy picks agree on "
        f"{int(agree.sum())}/{len(agree)} lanes; {int(decided.sum())} lanes "
        f"with a top-2 margin > 2×max|Δ|, all must agree")
    if err > tol:
        fail(f"{label} step logits differ by {err} > {tol}")
    if not agree[decided].all():
        fail(f"{label} step: greedy pick differs on a lane with a clear margin")
    return dict(max_abs_logit=err, plain_schedule_spread=spread, limit=tol,
                agree=int(agree.sum()), decided=int(decided.sum()),
                lanes=len(agree))


def phase_step_f32(cfg, params):
    """The same step in f32: weights widened (the bf16 dict is consumed to
    make room), a fresh f32 pool with random history rows."""
    import torch
    from repro_torch.models.lm import trunk_cache_init
    c = cfg.replace(dtype="float32")
    for k in list(params):
        params[k] = params.pop(k).float()
    pool = trunk_cache_init(c, ENGINE["num_pages"] + 1, ENGINE["page_size"],
                            DEV)
    g = torch.Generator(device=DEV).manual_seed(3)
    for leaf in pool.values():
        leaf.normal_(generator=g)
    return phase_step_vs_plain(c, params, pool, "f32", floor=1e-3)


def attention_work(s, itemsize):
    """Bytes and operations the main-path attention call needs: every live
    KV row read once (values + int8 scales), q read and out written once,
    the table and lengths; QKᵀ and P·V over each live row's visible
    columns."""
    hq, hkv, d = s["hq"], s["hkv"], s["d"]
    rows_kv = sum(kv for _, kv in s["spec"])
    scale_bytes = 2 * 4 if s["ks"] is not None else 0
    kv_bytes = rows_kv * hkv * (2 * d * s["k"].element_size() + scale_bytes)
    t = s["q"].shape[0]
    io = 2 * t * hq * d * itemsize + s["table"].numel() * 4
    vis = sum(sum(kv - n + i + 1 for i in range(n)) for n, kv in s["spec"])
    flops = 4.0 * d * hq * vis
    return kv_bytes + io, flops


def q_blocks(s, bq=8):
    """The tiled call the varlen path makes for stream ``s``: (q-blocks,
    pools, block tables, block kv_len) and the int8 scales."""
    from repro_torch.kernels.paged_attention import q_block_layout
    hq, d = s["hq"], s["d"]
    rows, start, kvl, _ = q_block_layout(s["cu"], s["pos"], s["q"].shape[0], bq)
    qb = s["q"][rows.reshape(-1).long()].reshape(rows.shape[0], bq, hq, d)
    qb = qb.transpose(1, 2).contiguous()
    tbl = s["table"][start.long()].contiguous()
    return (qb, s["k"], s["v"], tbl, kvl), dict(k_scale=s["ks"], v_scale=s["vs"])


def lane_views(s, lanes):
    """Per lane of ``s`` (indices into its spec): the gathered contiguous K
    and V (dequantised for int8), as bf16 (1, Hkv, kv, D) views."""
    import torch
    ps = s["k"].shape[2]
    kf, vf = s["k"], s["v"]
    if s["ks"] is not None:
        kf = kf.float() * s["ks"][..., None]
        vf = vf.float() * s["vs"][..., None]
    out = []
    for i in lanes:
        kv = s["spec"][i][1]
        ids = s["table"][s["cu"][i].long(), :-(-kv // ps)].long()
        g = lambda pool: (pool[ids].transpose(0, 1).reshape(  # noqa: E731
            1, s["hkv"], -1, s["d"])[:, :, :kv].bfloat16())
        out.append((g(kf), g(vf)))
    return out


def paged_bound(s, itemsize):
    nbytes, flops = attention_work(s, itemsize)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def time_paged(a, kw, library, flush):
    """Kernel #2 (both launches) on the tiled call ``a``/``kw`` beside the
    library yardstick ``library``, in interleaved rounds: ``ms`` and
    ``library_ms`` as a caller sees them (CUDA events from the host's call:
    the wrapper's host work shows where it outlasts the card's), the same
    two with a spin lead (``device_ms``, ``library_device_ms``: the card's
    work alone), the host time of one call of each (``host_ms``,
    ``library_host_ms``), and the device time at each pages-per-split
    of ``KV_SPLIT_SWEEP`` (``kv_split_sweep_device_ms``)."""
    from repro_torch.kernels.paged_attention import paged_attention
    kernel = lambda: paged_attention(*a, **kw)  # noqa: E731
    timers = {
        "ms": lambda: cuda_ms(kernel, flush=flush),
        "library_ms": lambda: cuda_ms(library, flush=flush),
        "device_ms": lambda: cuda_ms(kernel, flush=flush, spin=True),
        "library_device_ms": lambda: cuda_ms(library, flush=flush, spin=True)}
    for n in KV_SPLIT_SWEEP:
        timers[n] = lambda n=n: cuda_ms(
            lambda: paged_attention(*a, **kw, kv_split=n), flush=flush,
            spin=True)
    med = interleaved_ms(timers)
    return dict(
        **{k: med[k] for k in ("ms", "library_ms", "device_ms",
                               "library_device_ms")},
        host_ms=host_ms(kernel), library_host_ms=host_ms(library),
        kv_split_sweep_device_ms={n: med[n] for n in KV_SPLIT_SWEEP})


def paged_times(t) -> str:
    sweep = ", ".join(f"{n} pages {v:.4f}"
                      for n, v in t["kv_split_sweep_device_ms"].items())
    return (f"kernel {t['ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms; device "
            f"alone (spin lead) kernel {t['device_ms']:.4f} ms, sdpa "
            f"{t['library_device_ms']:.4f} ms; host per call kernel "
            f"{t['host_ms']:.4f} ms, sdpa {t['library_host_ms']:.4f} ms; "
            f"split sweep, device alone: {sweep} ms (medians of 5 "
            f"interleaved rounds)")


def phase_timing(engine_facts):
    """Each kernel at the engine's decode-step shape (8 lanes decoding at
    the served requests' mid-decode lengths, block_q 8), beside its plain
    version, a library call and its bound; paged attention also at 4, 8
    and 16 pages per split and at a mixed step (one 256-token prefill chunk
    and 7 decodes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.lut_exp import lut_exp, lut_exp_ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_reference)
    from repro_torch.kernels.paged_attention.ops import (default_kv_split,
                                                         paged_combine)
    from repro_torch.kernels.paged_attention.ref import paged_combine_reference
    from repro_torch.serving.scheduler import default_token_buckets
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    flush = lambda: flush_buf.zero_()  # noqa: E731
    kv_lens = engine_facts["decode_kv_lens"]
    kernels = []
    for pool in ("bfloat16", "int8"):
        s = make_stream([(1, kv) for kv in kv_lens], pool=pool,
                        n_pages=ENGINE["num_pages"], seed=11)
        hq, d, ps = s["hq"], s["d"], s["k"].shape[2]
        a, kw = q_blocks(s)
        split = default_kv_split(ps)
        plain_kw = dict(kw, block_pages=8, kv_split=split)
        got = paged_attention(*a, **kw)
        want = paged_attention_reference(*a, **plain_kw)
        err = float((got.float() - want.float()).abs().max())
        plain = cuda_ms(lambda: paged_attention_reference(*a, **plain_kw),
                        iters=5, flush=flush)
        # yardstick: SDPA (exact exp, not the same function) over a gathered
        # contiguous bf16 view padded to the longest lane, with a length mask
        lmax = max(kv_lens)
        views = lane_views(s, range(8))
        kg = torch.cat([F.pad(k, (0, 0, 0, lmax - k.shape[2])) for k, _ in views])
        vg = torch.cat([F.pad(v, (0, 0, 0, lmax - v.shape[2])) for _, v in views])
        qd = s["q"][:8].reshape(8, 1, hq, d).transpose(1, 2).contiguous()
        mask = (torch.arange(lmax, device=DEV)[None, :]
                < torch.tensor(kv_lens, device=DEV)[:, None])[:, None, None]
        entry = time_paged(a, kw, lambda: F.scaled_dot_product_attention(
            qd, kg, vg, attn_mask=mask), flush)
        bound, bound_by, nbytes, flops = paged_bound(s, 2)
        name = "paged_attention" if pool == "bfloat16" else "paged_attention_int8"
        entry = dict(
            launches=engine_facts["launches"][pool]["paged_attention"],
            max_abs_err=err, **entry, kernel_ms=entry["ms"], plain_ms=plain,
            bound_ms=bound, bound_by=bound_by, kv_split=split,
            shape=f"decode step: 8 lanes, kv {kv_lens}, block_q 8, "
                  f"{hq} heads × {d}, ps {ps}, {s['table'].shape[1]} table "
                  f"slots, {pool} pool; both launches (split pass + combine)")
        if pool == "bfloat16":
            kernels.append(dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:132",
                **entry,
                library="scaled_dot_product_attention over a gathered bf16 "
                        "view (exact exp, not the same function)"))
            decode = s
        else:                        # the same kernel over an int8 pool
            kernels[-1]["int8_pool"] = entry
        log(f"[time] {name}: {paged_times(entry)}; plain {plain:.3f} ms, bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")

    # the mixed step: one 256-token prefill chunk and 7 decode lanes in one
    # stream of the scheduler's bucket width, bf16 pool
    n_chunk, kv_chunk = MIXED_CHUNK
    spec = [(n_chunk, kv_chunk)] + [(1, kv) for kv in kv_lens[:7]]
    live = sum(n for n, _ in spec)
    width = min(w for w in default_token_buckets(
        ENGINE["lanes"] + ENGINE["chunk_size"]) if w >= live)
    s = make_stream(spec, pool="bfloat16", n_pages=ENGINE["num_pages"],
                    seed=12, width=width)
    a, kw = q_blocks(s)
    split = default_kv_split(s["k"].shape[2])
    plain_kw = dict(kw, block_pages=8, kv_split=split)
    got = paged_attention(*a, **kw)
    want = paged_attention_reference(*a, **plain_kw)
    mixed_err = float((got.float() - want.float()).abs().max())
    mixed_plain = cuda_ms(lambda: paged_attention_reference(*a, **plain_kw),
                          iters=5, flush=flush)
    views = lane_views(s, range(len(spec)))
    qc = s["q"][:n_chunk].transpose(0, 1)[None]               # (1, Hq, n, D)
    qpos = kv_chunk - n_chunk + torch.arange(n_chunk, device=DEV)
    cmask = torch.arange(kv_chunk, device=DEV)[None, :] <= qpos[:, None]
    lmax = max(kv for _, kv in spec[1:])
    kd = torch.cat([F.pad(k, (0, 0, 0, lmax - k.shape[2])) for k, _ in views[1:]])
    vd = torch.cat([F.pad(v, (0, 0, 0, lmax - v.shape[2])) for _, v in views[1:]])
    qd = s["q"][n_chunk:live].reshape(7, 1, s["hq"], s["d"]).transpose(1, 2)
    qd = qd.contiguous()
    dmask = (torch.arange(lmax, device=DEV)[None, :] < torch.tensor(
        [kv for _, kv in spec[1:]], device=DEV)[:, None])[:, None, None]
    mixed = time_paged(a, kw, lambda: (
        F.scaled_dot_product_attention(qc, *views[0], attn_mask=cmask),
        F.scaled_dot_product_attention(qd, kd, vd, attn_mask=dmask)), flush)
    bound, bound_by, nbytes, flops = paged_bound(s, 2)
    kernels[0]["mixed_step"] = dict(
        **mixed, plain_ms=mixed_plain, bound_ms=bound, bound_by=bound_by,
        max_abs_err=mixed_err, kv_split=split,
        library="two scaled_dot_product_attention calls on gathered bf16 "
                "views (the chunk with its causal mask; the 7 decodes)",
        shape=f"one {n_chunk}-token chunk at kv {kv_chunk} + 7 decodes at "
              f"kv {kv_lens[:7]}, stream width {width}, block_q 8, bf16 pool")
    log(f"[time] paged_attention mixed step ({kernels[0]['mixed_step']['shape']}"
        f"): {paged_times(mixed)}; plain {mixed_plain:.3f} ms, bound "
        f"{bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP); max|Δ| {mixed_err:.3g}")

    # the combine alone, at the decode step's workspace shape: partials as
    # the split pass leaves them, never-written splits NaN
    a, _ = q_blocks(decode)
    kvl, ps = a[4], decode["k"].shape[2]
    split = default_kv_split(ps)
    nb, hkv, rows, d = a[0].shape[0], decode["hkv"], a[0].shape[2], decode["d"]
    n_split = -(-a[3].shape[1] // split)
    g = torch.Generator(device=DEV).manual_seed(13)
    pm = torch.randn((nb, hkv, n_split, rows), generator=g, device=DEV) * 3
    pl = torch.rand((nb, hkv, n_split, rows), generator=g, device=DEV) * 40 + 1
    pa = torch.randn((nb, hkv, n_split, rows, d), generator=g,
                     device=DEV) * pl[..., None]
    live_n = torch.clamp((kvl.long() + ps - 1) // ps + split - 1, min=0) // split
    dead = torch.arange(n_split, device=DEV)[None, :] >= live_n[:, None]
    dead = dead[:, None, :, None]
    pm, pl = pm.masked_fill(dead, float("nan")), pl.masked_fill(dead, float("nan"))
    pa = pa.masked_fill(dead[..., None], float("nan"))
    ckw = dict(page_size=ps, kv_split=split, exp_mode="lut")
    got = paged_combine(pm, pl, pa, kvl, **ckw)          # f32 out: the check
    want = paged_combine_reference(pm, pl, pa, kvl, **ckw)
    if not torch.isfinite(got).all():
        fail("paged_combine read a split the split pass never wrote")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **F32_TOL):
        fail(f"paged_combine disagrees with its plain version: max|Δ| {err}")
    ms = cuda_ms(lambda: paged_combine(pm, pl, pa, kvl, **ckw,
                                       dtype=torch.bfloat16), flush=flush)
    plain = cuda_ms(lambda: paged_combine_reference(pm, pl, pa, kvl, **ckw),
                    iters=5, flush=flush)
    # bytes and operations the step needs: each live row's partials of the
    # splits its own keys span and its output (the rule of attention_work);
    # the block_q 8 tiling's dead rows of live q-blocks are counted apart
    row_splits = lambda vis: -(-(-(-vis // ps)) // split)  # noqa: E731
    need = decode["hq"] // hkv * sum(row_splits(kv - n + i + 1)
                                     for n, kv in decode["spec"]
                                     for i in range(n))
    live_rows = decode["live"]
    nbytes = (need * hkv * (d + 2) * 4 + live_rows * decode["hq"] * d * 2
              + nb * 4)
    flops = 2.0 * need * hkv * (d + 1)
    n_live = int(torch.clamp(live_n, max=n_split).sum())
    dead_bytes = (n_live * hkv * rows * (d + 2) * 4 + nb * hkv * rows * d * 2
                  + nb * 4 - nbytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    kernels.append(dict(
        name="paged_combine", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:132",
        launches=engine_facts["launches"]["bfloat16"]["paged_combine"],
        max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        shape=f"decode-step workspace: {nb} q-blocks × {hkv} heads × "
              f"{n_split} splits × {rows} rows × {d}, {n_live} live "
              f"(q-block, split) pairs per head, {live_rows} live rows of "
              f"{nb * rows}, bf16 out",
        dead_row_bytes=dead_bytes))
    log(f"[time] paged_combine: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
        f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.3f} MB of the "
        f"live rows; the dead rows of block_q 8 add {dead_bytes / 1e6:.2f} MB,"
        f" {dead_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate); "
        f"max|Δ| {err:.3g} against the plain merge in f32 (atol 2e-5, rtol "
        f"1e-4)")

    # LUT exp: every logit that call computes, as one tensor of s − m values
    n = sum(kv_lens) * HQ * 8
    x = (torch.rand(n, device=DEV) * -30.0).contiguous()
    got, want = lut_exp(x), lut_exp_ref(x)
    err = float((got - want).abs().max())
    med = interleaved_ms({
        "ms": lambda: cuda_ms(lambda: lut_exp(x), flush=flush),
        "device_ms": lambda: cuda_ms(lambda: lut_exp(x), flush=flush, spin=True),
        "library_ms": lambda: cuda_ms(lambda: torch.exp(x), flush=flush)})
    ms, lib = med["ms"], med["library_ms"]
    lut_host = host_ms(lambda: lut_exp(x))
    plain = cuda_ms(lambda: lut_exp_ref(x), flush=flush)
    t_bytes = 8.0 * n / HBM_BYTES_PER_S * 1e3
    t_ops = 12.0 * n / PEAK_FLOPS["float32"] * 1e3
    kernels.append(dict(
        name="lut_exp", route="cuda", source="src/repro_torch/csrc/lut_exp.cu",
        replaces="src/repro/kernels/lut_exp/kernel.py:95",
        launches=engine_facts["launches"]["bfloat16"]["lut_exp"],
        on_main_path=False,
        inlined_in="paged_attention and streaming_attention "
                   "(csrc/lut_exp.cuh, every launch)",
        max_abs_err=err, ms=ms, kernel_ms=ms, device_ms=med["device_ms"],
        host_ms=lut_host, plain_ms=plain, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib, library="torch.exp (exact exp, not the same function)",
        shape=f"{n} f32 logits (the decode step's s − m values)"))
    log(f"[time] lut_exp: kernel {ms:.4f} ms, device alone "
        f"{med['device_ms']:.4f} ms, host per call {lut_host:.4f} ms, plain "
        f"{plain:.4f} ms, torch.exp {lib:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({n} elements; medians of 5 "
        f"interleaved rounds)")
    kernels.append(time_streaming(flush, engine_facts))
    kernels.append(time_int8(flush, engine_facts["int8_bert"]))
    kernels.append(time_quantize(flush, engine_facts["int8_bert"]))
    return kernels


def time_int8(flush, facts):
    """Kernel #4 at the BERT-large projection shapes of an 8 × 512 batch and
    at the reference microbenchmark's shape: the 2-D kernel (int8 in, f32
    out, scales applied) on a K-major w, as the pass calls it — as a caller
    sees it, the device time alone (spin lead) and at each wgmma tile width
    — beside the mma.sync variant on a row-major w (PR 16's design on the
    same call), its plain version, ``torch._int_mm`` alone and plus the same
    scale multiply, each with w row-major and column-major (the library
    yardstick is the faster with the scales; the port never calls it), and
    for context a bf16 ``torch.matmul`` of the same shape.  Launches per
    forward are those counted for each shape in the BERT-large pass.  Bytes:
    x, w, the scales read once and the f32 output written once; operations:
    2·M·N·K at the int8 tensor-core peak."""
    import torch
    from repro_torch.kernels.int8_matmul import int8_matmul_2d, int8_matmul_2d_ref
    from repro_torch.kernels.int8_matmul.ops import TILE_N, default_tile_n
    g = torch.Generator(device=DEV).manual_seed(17)
    timed = {}
    for m, k, n, what in INT8_TIMED:
        xv = torch.randint(-127, 128, (m, k), generator=g, device=DEV,
                           dtype=torch.int8)
        wv = torch.randint(-127, 128, (k, n), generator=g, device=DEV,
                           dtype=torch.int8)
        wk = wv.t().contiguous().t()                  # as quantize stores it
        xs = torch.rand((), generator=g, device=DEV) * 0.01
        ws = torch.rand((1, n), generator=g, device=DEV) * 0.01
        got, want = int8_matmul_2d(xv, wk, xs, ws), int8_matmul_2d_ref(xv, wv, xs, ws)
        err = float((got - want).abs().max())
        kernel = lambda: int8_matmul_2d(xv, wk, xs, ws)  # noqa: E731
        timers = {
            "ms": lambda: cuda_ms(kernel, flush=flush),
            "device_ms": lambda: cuda_ms(kernel, flush=flush, spin=True),
            "mma_sync_ms": lambda: cuda_ms(lambda: int8_matmul_2d(
                xv, wv, xs, ws, variant="mma_sync"), flush=flush),
            "mma_sync_device_ms": lambda: cuda_ms(lambda: int8_matmul_2d(
                xv, wv, xs, ws, variant="mma_sync"), flush=flush, spin=True)}
        for tile in TILE_N:
            timers[f"tile_{tile}"] = lambda tile=tile: cuda_ms(
                lambda: int8_matmul_2d(xv, wk, xs, ws, tile_n=tile),
                flush=flush, spin=True)
        layouts = {"row": wv, "col": wk}
        lib_equal = {}
        for lay, w in layouts.items():
            lib_equal[lay] = bits_equal(torch._int_mm(xv, w).float() * (xs * ws), got)
            timers[f"int_mm_{lay}"] = lambda w=w: cuda_ms(
                lambda: torch._int_mm(xv, w), flush=flush)
            timers[f"lib_{lay}"] = lambda w=w: cuda_ms(
                lambda: torch._int_mm(xv, w).float() * (xs * ws), flush=flush)
        med = interleaved_ms(timers)
        plain = cuda_ms(lambda: int8_matmul_2d_ref(xv, wv, xs, ws), iters=5,
                        flush=flush)
        lib_by = {lay: med[f"lib_{lay}"] for lay in layouts}
        int_mm = {lay: med[f"int_mm_{lay}"] for lay in layouts}
        best = min(lib_by, key=lib_by.get)
        xb, wb = xv.bfloat16(), wv.bfloat16()
        bf16 = cuda_ms(lambda: torch.matmul(xb, wb), flush=flush)
        nbytes = m * k + k * n + 4 * n + 4 + 4 * m * n
        ops = 2.0 * m * n * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS["int8"] * 1e3
        bound = max(t_bytes, t_ops)
        ms, dev = med["ms"], med["device_ms"]
        label = f"{m}x{k}x{n}"
        timed[label] = dict(
            max_abs_err=err, ms=ms, device_ms=dev, tops=ops / ms / 1e9,
            bound_share=bound / ms, plain_ms=plain, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_by[best], library_w_layout=best,
            library_bit_equal=lib_equal, library_ms_by_w_layout=lib_by,
            int_mm_alone_ms_by_w_layout=int_mm,
            mma_sync_ms=med["mma_sync_ms"],
            mma_sync_device_ms=med["mma_sync_device_ms"],
            wgmma_device_ms_by_tile_n={t: med[f"tile_{t}"] for t in TILE_N},
            tile_n=default_tile_n(m, n), bf16_matmul_ms=bf16,
            launches_per_forward=facts["launches_by_shape"].get(label, 0),
            shape=f"M {m} × K {k} × N {n} ({what}), w K-major")
        tiles = ", ".join(f"{t}: {med[f'tile_{t}']:.4f}" for t in TILE_N)
        log(f"[time] int8_matmul {label} ({what}): wgmma kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s, {bound / ms:.0%} of the bound), "
            f"device alone {dev:.4f} ms (by tile width, device alone: "
            f"{tiles}; default {default_tile_n(m, n)}); mma.sync variant "
            f"{med['mma_sync_ms']:.4f} ms (device alone "
            f"{med['mma_sync_device_ms']:.4f}); plain {plain:.3f} ms; "
            f"_int_mm alone row/col-major w {int_mm['row']:.4f}/"
            f"{int_mm['col']:.4f} ms, +scale {lib_by['row']:.4f}/"
            f"{lib_by['col']:.4f} ms (bit-equal {lib_equal}); launches per "
            f"forward {timed[label]['launches_per_forward']}; bf16 matmul "
            f"{bf16:.4f} ms; bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.1f} GOP) (medians of 5 interleaved rounds)")
        del xv, wv, wk, xb, wb, got, want, layouts
    first = timed.pop(f"{INT8_TIMED[0][0]}x{INT8_TIMED[0][1]}x{INT8_TIMED[0][2]}")
    return dict(
        name="int8_matmul", route="cuda", source="src/repro_torch/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul/kernel.py:49",
        launches=facts["launches"],
        launches_by_variant=facts["counts"]["by_variant"], **first,
        library="torch._int_mm + the same scale multiply, w in the faster "
                "of row- and column-major",
        bert_int8_projections=facts, **timed)


# (M, K) bf16 activations of the BERT-large pass: the K = 1024 inputs and
# the K = 4096 GELU outputs
QUANT_TIMED = [(4096, 1024), (4096, 4096)]


def time_quantize(flush, facts):
    """The activation quantisation kernel at the pass's two input shapes
    (bf16): as a caller sees it, device alone, host per call, beside the
    plain version (the eager chain it replaces).  Bytes: x read once, the
    int8 values and the scale written once; no PyTorch call computes the
    same function (``torch.quantize_per_tensor_dynamic`` is affine, with a
    zero point), so ``library_ms`` is null."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device=DEV).manual_seed(29)
    timed = {}
    for m, k in QUANT_TIMED:
        x = (torch.randn((m, k), generator=g, device=DEV) * 2).bfloat16()
        plain = lambda: quant._quantize(  # noqa: E731
            x, torch.amax(torch.abs(x.to(torch.float32))), 8)
        got, want = quant.quantize_dynamic(x), plain()
        err = float((got.values.float() - want.values.float()).abs().max())
        if err != 0 or not bits_equal(got.scale, want.scale):
            fail(f"quantize_dynamic ({m}, {k}): not bit-equal when timed")
        kernel = lambda: quant.quantize_dynamic(x)  # noqa: E731
        med = interleaved_ms({
            "ms": lambda: cuda_ms(kernel, flush=flush),
            "device_ms": lambda: cuda_ms(kernel, flush=flush, spin=True),
            "plain_ms": lambda: cuda_ms(plain, flush=flush)})
        nbytes = 2 * m * k + m * k + 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        timed[f"{m}x{k}"] = dict(
            max_abs_err=err, **med, host_ms=host_ms(kernel), bound_ms=bound,
            bound_by="bytes", library_ms=None, bound_share=bound / med["ms"],
            shape=f"({m}, {k}) bf16 → int8 + one f32 scale")
        log(f"[time] quantize_dynamic ({m}, {k}) bf16: kernel {med['ms']:.4f} "
            f"ms ({bound / med['ms']:.0%} of the bound), device alone "
            f"{med['device_ms']:.4f} ms, host per call "
            f"{timed[f'{m}x{k}']['host_ms']:.4f} ms, plain "
            f"{med['plain_ms']:.4f} ms, bound {bound:.4f} ms "
            f"({nbytes / 1e6:.1f} MB) (medians of 5 interleaved rounds)")
    first = timed.pop(f"{QUANT_TIMED[0][0]}x{QUANT_TIMED[0][1]}")
    return dict(
        name="quantize_dynamic", route="cuda",
        source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/core/quant.py:45 (jnp, outside the Pallas kernel)",
        launches=facts["counts"]["quantize_dynamic"], **first,
        library=None, **timed)


def streaming_shapes():
    """(label, (B, Hq, Hkv, Lq, Lkv, D), causal) of kernel #3's main-path
    calls: the BERT-large encodes and the deepseek-7b scoring batch."""
    shapes = [(f"l{l}", (b, 16, 16, l, l, 64), False) for b, l in BERT_SHAPES]
    b, l = SCORE_SHAPE
    shapes.append((f"scoring_{b}x{l}", (b, 32, 32, l, l, 128), True))
    return shapes


def time_streaming(flush, facts):
    """Kernel #3 at its main paths' shapes: the BERT-large encodes (bf16, 16
    heads × 64, bidirectional) and the deepseek-7b scoring batch (bf16, 32
    heads × 128, causal): the tensor-core kernel, its plain version, SDPA
    (exact exp, the same mask) and the bound; beside them the same kernel
    with exp_mode "exact" (expf in place of the LUT: what the softmax's
    exponential costs) and the f32 CUDA-core kernel on the same inputs
    widened.  Bytes: q, k, v read once and out written once; operations:
    the QKᵀ and P·V products over the visible keys, at the bf16
    tensor-core peak (the split P·V's second product is the kernel's cost,
    not the function's work)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.streaming_attention import (attention_ref,
                                                         streaming_attention)
    shapes = streaming_shapes()
    timed = {}
    for label, shape, causal in shapes:
        b, hq, _, l, _, d = shape
        q, k, v = sa_inputs(shape, "bfloat16", seed=7)
        q32, k32, v32 = q.float(), k.float(), v.float()
        got = streaming_attention(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        err = float((got.float() - want.float()).abs().max())
        ms = cuda_ms(lambda: streaming_attention(q, k, v, causal=causal),
                     flush=flush)
        exact = cuda_ms(lambda: streaming_attention(
            q, k, v, causal=causal, exp_mode="exact"), flush=flush)
        f32 = cuda_ms(lambda: streaming_attention(q32, k32, v32, causal=causal),
                      flush=flush)
        plain = cuda_ms(lambda: attention_ref(q, k, v, causal=causal),
                        iters=5, flush=flush)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), flush=flush)
        nbytes = 4.0 * q.numel() * q.element_size()
        visible = l * (l + 1) / 2 if causal else l * l
        flops = 4.0 * b * hq * visible * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        timed[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib, tflops=flops / ms / 1e9, exact_exp_ms=exact,
            f32_cuda_core_ms=f32, f32_cuda_core_tflops=flops / f32 / 1e9,
            shape=f"B {b}, {hq} heads × {d}, l {l}, bf16, "
                  f"{'causal' if causal else 'bidirectional'}")
        log(f"[time] streaming_attention {label} ({timed[label]['shape']}): "
            f"tensor-core kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"exact exp {exact:.4f} ms, f32 CUDA-core kernel {f32:.4f} ms "
            f"({flops / f32 / 1e9:.1f} TFLOP/s), plain {plain:.3f} ms, sdpa "
            f"{lib:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        del q, k, v, q32, k32, v32, got, want
    first = timed.pop(shapes[0][0])
    return dict(
        name="streaming_attention", route="cuda",
        source="src/repro_torch/csrc/streaming_attention.cu",
        replaces="src/repro/kernels/streaming_attention/kernel.py:130",
        launches=facts["bert"]["launches"],
        launches_per_forward=facts["bert"]["launches"] // len(BERT_SHAPES),
        scoring_launches=facts["scoring"]["bf16"]["launches"],
        **first, library="scaled_dot_product_attention (exact exp, not the "
                         "same function)",
        **timed, tensor_core_build=facts["build"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.params import init_params

    t_start = time.perf_counter()
    name, smi_line = phase_card()
    built = phase_build()
    phase_lut_exp()
    phase_paged_attention()
    sa_worst = phase_streaming_attention()
    bert = phase_bert()
    phase_int8_checks()
    int8_bert = phase_int8_bert()

    cfg = get_config(MODEL)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    log(f"[weights] {cfg.name}: {n_params / 1e9:.2f} B parameters, "
        f"{sum(p.numel() * p.element_size() for p in params.values()) / 1e9:.1f}"
        f" GB {cfg.dtype}, drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    log(f"[requests] 8 prompts of {sorted(int(n) for n in lens)} tokens, "
        f"max_new {MAX_NEW}")

    facts = {"launches": {}, "eager_launches": {}}
    compiled = {}
    for kv_quant in (False, True):
        tag, pool = ("int8", "int8") if kv_quant else ("bf16", "bfloat16")
        eng, f = phase_engine(cfg, params, kv_quant, prompts)
        facts[tag] = f
        facts["eager_launches"][pool] = f["launches"]
        if not kv_quant:
            steps = {"bf16": phase_step_vs_plain(cfg, params, eng.kv.pool,
                                                 "bf16", floor=1e-2)}
        del eng
        torch.cuda.empty_cache()
        compiled[tag] = phase_compiled(cfg, params, kv_quant, prompts, f)
        # the main path: the engine as a user builds it, capture on
        facts["launches"][pool] = compiled[tag]["launches"]
    scoring = {"bf16": phase_scoring(cfg, params, "bf16", floor=1e-2)}
    steps["f32"] = phase_step_f32(cfg, params)       # widens params to f32
    scoring["f32"] = phase_scoring(cfg.replace(dtype="float32"), params,
                                   "f32", floor=1e-3)
    del params
    torch.cuda.empty_cache()
    facts["decode_kv_lens"] = [int(n) + MAX_NEW // 2 for n in lens]
    facts["bert"], facts["scoring"] = bert, scoring
    facts["int8_bert"] = int8_bert
    facts["build"] = built
    kernels = phase_timing(facts)

    summary = {k: {kk: vv for kk, vv in facts[k].items()
                   if kk not in ("streams", "kinds")} for k in ("bf16", "int8")}
    summary["compiled"] = compiled
    summary["step_vs_plain"] = steps
    summary["streaming_attention_checks"] = sa_worst
    summary["bert"] = bert
    summary["scoring"] = scoring
    summary["int8_bert"] = int8_bert
    log("[summary] " + json.dumps(summary))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
