"""The port's async front door (``serving/server.py``), metrics endpoint and
serve CLI: twins of ``tests/test_server.py`` on the port's engine.

- stream identity: tokens streamed per client equal the batch driver's,
  and the JAX reference's server streams on the same requests and weights;
  a sampled stream through the server is seed-reproducible;
- cancellation: a client breaking out aborts its request, its pages free
  before the next step, the survivors finish unperturbed; a client
  cancelled before admission never reaches the engine;
- backpressure: ``admission="reject"`` sheds a burst, ``"wait"`` serves
  everyone;
- validation: a bad request raises in its client's context;
- shutdown: a draining shutdown finishes resident work and refuses new
  work, ``drain=False`` aborts what is in flight;
- ``start_metrics_server`` serves ``/metrics`` and ``/metrics.json`` on an
  ephemeral port; ``python -m repro_torch.launch.serve`` runs on the CPU.

Each test owns its loop through ``asyncio.run``.
"""
import asyncio
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serving import (AsyncLMServer, EngineCore,  # noqa: E402
                                 InvalidRequest, Request, RequestState,
                                 SamplingParams, ServerClosed,
                                 ServerOverloaded, start_metrics_server)
from tests._torch_twin import build, prompts_for  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("deepseek-7b-smoke").replace(dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def engine(smoke, **kw):
    cfg, params = smoke
    for k, v in dict(lanes=4, page_size=4, num_pages=64,
                     chunk_size=8).items():
        kw.setdefault(k, v)
    return EngineCore(cfg, params, device="cpu", **kw)


def reqs_for(cfg, n, *, seed=0, max_new=6, **sp):
    prompts = prompts_for(cfg.vocab_size, seed,
                          tuple(4 + 3 * i for i in range(n)))
    sampling = SamplingParams(**sp) if sp else None
    return [Request(uid=i, prompt=p, max_new=max_new, sampling=sampling)
            for i, p in enumerate(prompts)]


async def consume(server, req, *, cancel_after=None):
    toks = []
    async for tok in server.generate(req):
        toks.append(tok)
        if cancel_after is not None and len(toks) >= cancel_after:
            break
    return toks


def _drain_batch(smoke, reqs):
    eng = engine(smoke)
    for r in reqs:
        eng.submit(r)
    while eng.scheduler.has_work():
        eng.step()
    return {r.uid: r.tokens for r in eng.finished}


# ------------------------------------------------------- stream identity --

def test_streams_match_batch_driver(smoke):
    cfg, _ = smoke
    want = _drain_batch(smoke, reqs_for(cfg, 5))
    eng = engine(smoke)

    async def main():
        async with AsyncLMServer(eng) as server:
            outs = await asyncio.gather(
                *[consume(server, r) for r in reqs_for(cfg, 5)])
        return outs, server.summary()

    outs, summary = asyncio.run(main())
    assert dict(enumerate(outs)) == want
    assert summary["requests"] == 5 and summary["cancelled"] == 0
    assert summary["tokens"] == sum(len(t) for t in want.values())
    assert summary["ttft_ms_p50"] <= summary["ttft_ms_p99"]
    assert eng.pages_in_use == 0


def test_streams_equal_reference_server():
    """The JAX ``AsyncLMServer`` and the port's, on the same f32 weights and
    requests (greedy and seeded): equal streams."""
    from repro.serving import AsyncLMServer as JServer
    from repro.serving import EngineCore as JEngine
    from repro.serving import Request as JRequest
    from repro.serving import SamplingParams as JSamplingParams
    jc, tc, jparams, tparams = build("float32", False)
    kw = dict(lanes=4, page_size=4, num_pages=64, chunk_size=8)

    def serve(server_cls, eng, reqs):
        async def main():
            async with server_cls(eng) as server:
                return await asyncio.gather(*[consume(server, r)
                                              for r in reqs])
        return asyncio.run(main())

    def reqs(cls, sp_cls):
        sp = [None, sp_cls(temperature=0.9, top_k=40, top_p=0.9, seed=3),
              None, sp_cls(temperature=1.2, seed=2 ** 32 - 1)]
        return [cls(uid=i, prompt=p, max_new=6, sampling=sp[i])
                for i, p in enumerate(prompts_for(tc.vocab_size, 1,
                                                  (4, 9, 7, 12)))]

    want = serve(JServer, JEngine(jc, jparams, **kw),
                 reqs(JRequest, JSamplingParams))
    got = serve(AsyncLMServer, EngineCore(tc, tparams, device="cpu", **kw),
                reqs(Request, SamplingParams))
    assert got == want and all(len(t) == 6 for t in got)


def test_sampled_stream_through_server_is_seed_reproducible(smoke):
    cfg, _ = smoke

    def serve_once():
        eng = engine(smoke)

        async def main():
            async with AsyncLMServer(eng) as server:
                return await asyncio.gather(*[
                    consume(server, r)
                    for r in reqs_for(cfg, 3, temperature=1.0, seed=7)])
        return asyncio.run(main())

    first = serve_once()
    assert first == serve_once()
    assert first == list(_drain_batch(smoke, reqs_for(
        cfg, 3, temperature=1.0, seed=7)).values())


# ---------------------------------------------------------- cancellation --

def test_cancel_frees_pages_and_survivors_finish(smoke):
    cfg, _ = smoke
    want = _drain_batch(smoke, reqs_for(cfg, 5))
    eng = engine(smoke)
    rs = reqs_for(cfg, 5, max_new=8)
    resident_after_abort = []
    inner_step, inner_abort = eng.step, eng.abort

    def abort(uid):
        out = inner_abort(uid)
        resident_after_abort.append(uid)
        return out

    def step():
        for uid in resident_after_abort:     # freed before the next step
            assert uid not in {r.req.uid for r in eng.scheduler.running}
        return inner_step()

    eng.step, eng.abort = step, abort

    async def main():
        async with AsyncLMServer(eng) as server:
            outs = await asyncio.gather(*[
                consume(server, r, cancel_after=2 if r.uid == 3 else None)
                for r in rs])
        return outs, server.summary()

    outs, summary = asyncio.run(main())
    assert summary["cancelled"] == 1 and resident_after_abort == [3]
    assert rs[3].state == RequestState.ABORTED
    assert len(outs[3]) == 2
    for uid in (0, 1, 2, 4):
        assert outs[uid][:6] == want[uid]
    assert eng.pages_in_use == 0


def test_cancel_before_admission_never_reaches_engine(smoke):
    cfg, _ = smoke
    eng = engine(smoke, lanes=1)

    async def main():
        async with AsyncLMServer(eng) as server:
            task = asyncio.ensure_future(
                consume(server, reqs_for(cfg, 1, max_new=4)[0]))
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        return server.summary()

    assert asyncio.run(main())["requests"] == 0
    assert not eng.scheduler.has_work()


# ----------------------------------------------------------- backpressure --

def test_admission_reject_sheds_burst(smoke):
    cfg, _ = smoke
    eng = engine(smoke, lanes=1)

    async def main():
        served, shed = [], 0
        async with AsyncLMServer(eng, max_waiting=1,
                                 admission="reject") as server:
            async def client(r):
                nonlocal shed
                try:
                    served.append(await consume(server, r))
                except ServerOverloaded:
                    shed += 1
            await asyncio.gather(*[client(r) for r in reqs_for(cfg, 8)])
        return served, shed

    served, shed = asyncio.run(main())
    assert shed > 0 and len(served) + shed == 8
    assert all(len(t) == 6 for t in served)


def test_admission_wait_serves_everyone(smoke):
    cfg, _ = smoke
    eng = engine(smoke, lanes=1)

    async def main():
        async with AsyncLMServer(eng, max_waiting=1) as server:
            return await asyncio.gather(
                *[consume(server, r) for r in reqs_for(cfg, 6)])

    outs = asyncio.run(main())
    assert len(outs) == 6 and all(len(t) == 6 for t in outs)


# ------------------------------------------------------------- validation --

def test_invalid_request_raises_in_client_context(smoke):
    cfg, _ = smoke
    eng = engine(smoke)
    good = reqs_for(cfg, 1)[0]
    bad = Request(uid=9, prompt=good.prompt, max_new=4,
                  sampling=SamplingParams(stop=((cfg.vocab_size + 5,),)))

    async def main():
        async with AsyncLMServer(eng) as server:
            with pytest.raises(InvalidRequest, match="vocab"):
                await consume(server, bad)
            return await consume(server, good)

    assert len(asyncio.run(main())) == 6


# --------------------------------------------------------------- shutdown --

def test_shutdown_drains_then_refuses_new_work(smoke):
    cfg, _ = smoke
    eng = engine(smoke)
    rs = reqs_for(cfg, 2)

    async def main():
        server = await AsyncLMServer(eng).start()
        tasks = [asyncio.ensure_future(consume(server, r)) for r in rs]
        await asyncio.sleep(0)
        await server.shutdown(drain=True)
        outs = [await t for t in tasks]
        with pytest.raises(ServerClosed):
            await consume(server, reqs_for(cfg, 1, seed=3)[0])
        return outs

    assert all(len(t) == 6 for t in asyncio.run(main()))


def test_shutdown_no_drain_aborts_in_flight(smoke):
    cfg, _ = smoke
    eng = engine(smoke)
    rs = reqs_for(cfg, 3, max_new=48)

    async def main():
        server = await AsyncLMServer(eng).start()
        tasks = [asyncio.ensure_future(consume(server, r)) for r in rs]
        while server.steps < 2:
            await asyncio.sleep(0.01)
        await server.shutdown(drain=False)
        return [await t for t in tasks], server

    outs, server = asyncio.run(main())
    assert all(len(t) < 48 for t in outs)
    assert server.cancelled == 3 and eng.pages_in_use == 0


def test_server_rejects_bad_engine_and_policy(smoke):
    with pytest.raises(TypeError, match="abort"):
        AsyncLMServer(object())
    with pytest.raises(ValueError, match="admission"):
        AsyncLMServer(engine(smoke), admission="drop")


# ------------------------------------------------------ metrics endpoint --

def test_metrics_endpoint_serves_text_and_json(smoke):
    cfg, _ = smoke
    eng = engine(smoke)

    async def get(port, path):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        await writer.drain()
        body = await reader.read()
        writer.close()
        await writer.wait_closed()
        return body

    async def main():
        server = AsyncLMServer(eng)
        exporter = await start_metrics_server(server.obs.registry, port=0)
        try:
            async with server:
                await asyncio.gather(*[consume(server, r)
                                       for r in reqs_for(cfg, 2)])
            port = exporter.sockets[0].getsockname()[1]
            return [await get(port, p)
                    for p in ("/metrics", "/metrics.json", "/nope")]
        finally:
            exporter.close()
            await exporter.wait_closed()

    text, js, missing = asyncio.run(main())
    assert text.startswith(b"HTTP/1.0 200") and b"stream_requests_total 2" in text
    assert js.startswith(b"HTTP/1.0 200") and b"application/json" in js
    assert missing.startswith(b"HTTP/1.0 404")


# ------------------------------------------------------------- serve CLI --

@pytest.mark.parametrize("extra", [
    ["--rate", "0", "--temperature", "0.8", "--top-k", "50", "--top-p",
     "0.95", "--metrics-port", "0"],
    ["--batch", "--prefix-cache"]])
def test_serve_cli_runs_on_the_cpu(extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "deepseek-7b-smoke", "--device", "cpu", "--requests", "3",
         "--max-new", "4", "--max-len", "64"] + extra,
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "engine: EngineCore on cpu" in out.stdout
    assert ("async serve loop: 3 requests / 12 tokens" in out.stdout
            or "batch driver: served 3 requests, 12 tokens" in out.stdout)


def test_serve_cli_checkpoint_is_a_later_slice(tmp_path, capsys):
    """The checkpoint read path came with the kernel-config slice: the CLI
    restores a checkpoint the reference's store wrote, with the parameters
    bit for bit, and serves it (it raised ``NotImplementedError`` before)."""
    import jax
    from repro.checkpoint.store import flatten_tree, save
    from repro.configs import get_config as j_get_config
    from repro.models import build_model
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.params import from_flat
    params = build_model(j_get_config("deepseek-7b-smoke")).init(
        jax.random.PRNGKey(1))
    save(str(tmp_path), 2, {"params": params})
    seen = {}
    inner = serve.EngineCore

    def spy(cfg, p, **kw):
        seen["params"] = p
        return inner(cfg, p, **kw)
    serve.EngineCore = spy
    try:
        serve.main(["--arch", "deepseek-7b-smoke", "--device", "cpu",
                    "--batch", "--requests", "1", "--max-new", "2",
                    "--ckpt-dir", str(tmp_path)])
    finally:
        serve.EngineCore = inner
    out = capsys.readouterr().out
    assert "restored checkpoint step 2" in out
    assert "batch driver: served 1 requests, 2 tokens" in out
    want = from_flat(flatten_tree(params), get_config("deepseek-7b-smoke"),
                     "cpu")
    for k, w in want.items():
        assert torch.equal(seen["params"][k].view(torch.int16),
                           w.view(torch.int16)), k
