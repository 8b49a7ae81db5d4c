"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch
<id> [...]`` (the flags of ``src/repro/launch/serve.py``, plus ``--device``).

Default is the front door: an :class:`AsyncLMServer` around the port's
``EngineCore``, driven by a Poisson arrival trace (``--rate`` req/s) of
streaming clients with per-request sampling params
(``--temperature/--top-k/--top-p/--seed/--stop``), reporting sustained
req/s, TTFT p50/p99 and time-per-output-token.  ``--batch`` runs the
synchronous submit-all-then-drain driver instead.  Weights are drawn from
a seed (``params.init_params``), or with ``--ckpt-dir`` restored from the
latest step of a checkpoint the reference's store wrote
(``checkpoint.restore_params``).  The engine's kernel config is resolved
from the port's tuner table (``kernels/autotune.json``) and printed beside
the engine line.  A model whose cache the page pool rejects
(``UnsupportedCacheLayout``: a sliding window narrower than a page) is
served by the slot-contiguous ``ServingEngine`` instead, through the
synchronous ``--batch`` loop and without ``/metrics``, as the
reference's launcher falls back.  A model neither engine serves (the
encoder-decoder: ``EngineCore`` refuses it with ``no_paged_step``, the
slot engine with ``NotImplementedError``) exits non-zero with the slot
engine's message.  Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore_params
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.params import init_params
from repro_torch.serving import (AsyncLMServer, EngineCore, Request,
                                 SamplingParams, ServingEngine,
                                 UnsupportedCacheLayout, start_metrics_server,
                                 write_metrics_json)


def _parse_stop(spec: str):
    """``"5,9;12"`` → ((5, 9), (12,)): ';' splits sequences, ',' tokens."""
    if not spec:
        return ()
    return tuple(tuple(int(t) for t in s.split(",")) for s in spec.split(";"))


def _requests(args, cfg):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        sp = SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p,
            seed=(None if args.temperature <= 0 else args.seed + i),
            stop=_parse_stop(args.stop))
        reqs.append(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new=args.max_new, sampling=sp))
    return reqs


def _run_async(eng, args, cfg) -> None:
    reqs = _requests(args, cfg)
    rng = np.random.default_rng(1)
    # Poisson arrivals: exponential inter-arrival gaps at --rate req/s
    # (rate 0 → everyone arrives at t=0, the burst case).
    arrivals = (np.cumsum(rng.exponential(1.0 / args.rate, len(reqs)))
                if args.rate > 0 else np.zeros(len(reqs)))

    async def client(server, req, delay):
        await asyncio.sleep(delay)
        toks = []
        async for tok in server.generate(req):
            toks.append(tok)
        return toks

    async def main():
        server = AsyncLMServer(eng, max_waiting=args.max_waiting,
                               admission=args.admission)
        # /metrics + /metrics.json off this very loop (--metrics-port):
        # the scrape endpoint shares the process with the serve loop and
        # reads the same registry summary() reports from.
        exporter = None
        if args.metrics_port is not None:
            exporter = await start_metrics_server(server.obs.registry,
                                                  port=args.metrics_port)
            port = exporter.sockets[0].getsockname()[1]
            print(f"metrics: http://127.0.0.1:{port}/metrics")
        try:
            async with server:
                await asyncio.gather(*[
                    client(server, r, float(d))
                    for r, d in zip(reqs, arrivals)])
        finally:
            if exporter is not None:
                exporter.close()
                await exporter.wait_closed()
        return server.summary()

    t0 = time.perf_counter()
    s = asyncio.run(main())
    dt = time.perf_counter() - t0
    print(f"async serve loop: {s['requests']} requests / {s['tokens']} "
          f"tokens in {dt:.2f}s over {s['steps']} steps "
          f"(offered rate {args.rate or 'burst'} req/s)")
    print(f"  sustained {s['req_s']:.2f} req/s · TTFT p50 "
          f"{s['ttft_ms_p50']:.1f}ms p99 {s['ttft_ms_p99']:.1f}ms · "
          f"TPOT {s['tpot_ms']:.2f}ms")


def _run_batch(eng, args, cfg) -> None:
    for r in _requests(args, cfg):
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in done)
    print(f"batch driver: served {len(done)} requests, {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok/dt:.1f} tok/s)")
    for r in done[:4]:
        print(f"  req {r.uid}: {r.tokens[:12]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--lanes", "--slots", dest="lanes", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=16)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable shared-prefix KV reuse (radix cache + "
                         "copy-on-write page sharing)")
    ap.add_argument("--cache-pages", type=int, default=None,
                    help="cap on resident prefix-cache pages (default: "
                         "bounded only by the pool, reclaimed LRU-first)")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-then-verify speculative decoding: an n-gram "
                         "prompt-lookup proposer drafts up to --spec-k "
                         "tokens per greedy decode lane, verified in the "
                         "same ragged step (greedy output is unchanged)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per lane per step")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="per-request sampling seed base (request i draws "
                         "from seed+i; streams are batch-invariant)")
    ap.add_argument("--stop", default="",
                    help="stop sequences as token ids: ',' joins tokens in "
                         "a sequence, ';' separates sequences (e.g. '5,9;12')")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate in req/s (0 = burst: all "
                         "requests arrive at t=0)")
    ap.add_argument("--max-waiting", type=int, default=64,
                    help="intake queue bound (admission backpressure)")
    ap.add_argument("--admission", choices=("wait", "reject"),
                    default="wait",
                    help="backpressure policy when intake is full")
    ap.add_argument("--batch", action="store_true",
                    help="synchronous submit-all-then-drain driver instead "
                         "of the async serve loop")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write a JSON snapshot of the metrics registry "
                         "on exit")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="N",
                    help="serve GET /metrics (Prometheus text) and "
                         "/metrics.json on 127.0.0.1:N off the serve "
                         "loop's own asyncio loop (0 = ephemeral port; "
                         "async driver only)")
    ap.add_argument("--profile-steps", type=int, default=None, metavar="N",
                    help="capture a torch.profiler trace window around the "
                         "next N engine steps")
    ap.add_argument("--profile-dir", default="torch-trace",
                    help="torch.profiler trace output dir (--profile-steps)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain PyTorch "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.ckpt_dir:
        params, step, _ = restore_params(args.ckpt_dir, cfg, device)
        print(f"restored checkpoint step {step}")
    else:
        params = init_params(cfg,
                             torch.Generator(device=device).manual_seed(0),
                             device)
    slot = False
    try:
        # ceil per lane: a --max-len request must always fit its worst case
        pages_per_lane = -(-args.max_len // args.page_size)
        eng = EngineCore(cfg, params, lanes=args.lanes,
                         page_size=args.page_size,
                         num_pages=args.lanes * pages_per_lane,
                         chunk_size=args.chunk_size, max_len=args.max_len,
                         prefix_cache=args.prefix_cache,
                         cache_pages=args.cache_pages,
                         speculative=args.speculative, spec_k=args.spec_k,
                         device=device)
        print(f"engine: EngineCore on {device} (paged, chunk="
              f"{args.chunk_size}, prefix_cache="
              f"{'on' if args.prefix_cache else 'off'}, speculative="
              f"{f'k={args.spec_k}' if args.speculative else 'off'})")
        print(f"kernel_config: {eng.kernel_config.describe()}")
    except UnsupportedCacheLayout as e:
        print(f"engine: ServingEngine on {device} (slot-contiguous, sync "
              f"only) — {e}")
        try:
            eng = ServingEngine(cfg, params, slots=args.lanes,
                                max_len=args.max_len, device=device)
        except NotImplementedError as refusal:      # no engine serves it
            raise SystemExit(f"serve: {refusal}") from None
        slot = True

    if args.profile_steps and not slot:
        eng.obs.arm_profiler(args.profile_steps, args.profile_dir)
        print(f"profiler: tracing next {args.profile_steps} steps "
              f"into {args.profile_dir}")

    if args.batch or slot:
        _run_batch(eng, args, cfg)
    else:
        _run_async(eng, args, cfg)

    if args.metrics_json and not slot:
        write_metrics_json(eng.obs.registry, args.metrics_json)
        print(f"metrics snapshot: {args.metrics_json}")

    stats = getattr(eng, "prefix_stats", {})
    if stats:
        print(f"prefix cache: hit_rate {stats['hit_rate']:.3f} "
              f"({stats['hit_tokens']} of {stats['lookup_tokens']} known "
              f"tokens), {stats['cached_pages']} pages cached, "
              f"{stats['cow_copies']} CoW copies")
    spec = getattr(eng, "spec_stats", {})
    if spec:
        print(f"speculative: {spec['accepted_tokens']} of "
              f"{spec['drafted_tokens']} drafts accepted "
              f"(acceptance {spec['acceptance']:.3f}, "
              f"+{spec['accepted_per_spec_step']:.2f} tok per "
              f"drafting step over {spec['spec_steps']} steps)")


if __name__ == "__main__":
    main()
