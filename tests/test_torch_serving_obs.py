"""The port's serving observability and its captured step, on the CPU.

- **metrics**: the same observations fed to the reference's and the port's
  ``Histogram`` and ``MetricsRegistry`` give equal quantiles, means,
  snapshots, deltas, Prometheus text and JSON (``serving/metrics.py`` is a
  copy, and must stay one);
- **twin engines**: on the mixed trace of ``test_torch_engine_mixed.py``
  (bf16 and int8 pools), after every step the port's registry (counters,
  gauges, histogram counts) and step ring (less the host-clock
  ``dur_ms``) equal the JAX engine's, and ``step_traces_total`` equals the
  JAX engine's ``trace_count``: one capture per new (T, P) where the
  reference compiles once;
- **spans**: the port's twins of the reference's preemption and
  mid-prefill abort span tests (``tests/test_observability.py:286,305``);
- **retrace sentinel**: the twins of
  ``test_warm_engine_serves_fresh_traffic_with_zero_retraces`` and
  ``test_sentinel_catches_table_width_hwm_revert``
  (``tests/test_observability.py:427,447``) on the port's CPU
  ``StepGraphs``;
- **StepGraphs**: one set of static buffers per (T, P) key, reused across
  steps (same ``data_ptr``); narrower-P keys dropped when P grows;
  ``capture=False`` and ``metrics=False`` engines token-identical and the
  latter inert;
- **profiler window** and ``profile_summary``; the launch-counter list of
  ``serving/graphs.py`` covers every counter a kernel wrapper bumps.

Exact equality throughout: the registries count host events, and the
engines' token streams are the twin harness's own gate."""
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.serving import metrics as j_metrics  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serving import EngineCore, Request, Scheduler  # noqa: E402
from repro_torch.serving import graphs as t_graphs  # noqa: E402
from repro_torch.serving import metrics as t_metrics  # noqa: E402
from repro_torch.serving.graphs import StepGraphs  # noqa: E402
from repro_torch.serving.tracing import profile_summary  # noqa: E402
from tests._torch_twin import prompts_for, run_twins  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


# ------------------------------------------------------------- metrics --

def _feed(mod, seed):
    """One seeded stream of metric updates into a fresh registry of
    ``mod``; → (registry, snapshot taken halfway)."""
    rng = np.random.default_rng(seed)
    r = mod.MetricsRegistry()
    c = r.counter("reqs_total", "requests")
    g = r.gauge("pool_pages", "pages")
    h = r.histogram("lat_ms", "latency", max_samples=64)
    h2 = r.histogram("ttft_ms", bounds=(1.0, 10.0, 100.0))
    snap = None
    for i in range(200):
        if i == 100:
            snap = r.snapshot()
        k = rng.integers(0, 5)
        if k == 0:
            c.inc(int(rng.integers(1, 4)))
        elif k == 1:
            c.inc(1, packing=str(rng.choice(["ragged", "padded"])))
        elif k == 2:
            g.set_max(float(rng.integers(0, 50)))
        else:
            h.observe(float(rng.gamma(2.0, 20.0)))
            h2.observe(float(rng.integers(0, 200)) / 2)
    return r, snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_reference(seed):
    jr, jsnap = _feed(j_metrics, seed)
    tr, tsnap = _feed(t_metrics, seed)
    assert jsnap == tsnap
    assert jr.snapshot() == tr.snapshot()
    assert jr.delta(jsnap) == tr.delta(tsnap)
    assert jr.ratio("reqs_total", "lat_ms", since=jsnap) == tr.ratio(
        "reqs_total", "lat_ms", since=tsnap)
    assert jr.prometheus_text() == tr.prometheus_text()
    assert jr.json_text() == tr.json_text()
    for name in ("lat_ms", "ttft_ms"):
        jh, th = jr.get(name), tr.get(name)
        assert (jh.count(), jh.sum()) == (th.count(), th.sum())
        for skip in (0, 37, 150):
            assert jh.mean(skip=skip) == th.mean(skip=skip)
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                assert jh.percentile(q, skip=skip) == th.percentile(
                    q, skip=skip)


def test_write_metrics_json(tmp_path):
    r, _ = _feed(t_metrics, 3)
    path = tmp_path / "m.json"
    t_metrics.write_metrics_json(r, str(path))
    assert json.loads(path.read_text()) == json.loads(r.json_text())


# -------------------------------------------------------- twin engines --

def _registry_view(reg):
    """Counters and gauges by series; histograms by count (their values
    are host clocks)."""
    return {name: (v["count"] if v["type"] == "histogram" else v["series"])
            for name, v in reg.snapshot().items()}


def _ring_view(obs):
    return [{k: v for k, v in rec.items() if k != "dur_ms"}
            for rec in obs.ring.records()]


def _same_observability(je, te, step):
    assert _registry_view(te.obs.registry) == _registry_view(
        je.obs.registry), step
    assert _ring_view(te.obs) == _ring_view(je.obs), step
    assert te.obs.registry.value("step_traces_total") == je.trace_count
    assert te.trace_count == je.trace_count, step
    assert (te.obs.tracer.open_spans().keys()
            == je.obs.tracer.open_spans().keys()), step


MIXED = dict(lens=(3, 21, 9, 14, 6), news=(7, 5, 9, 4, 6), seed=13,
             engine=dict(lanes=3, page_size=8, num_pages=24, chunk_size=8))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_twin_registries_equal_after_every_step(monkeypatch, kv_quant):
    out = run_twins(monkeypatch, dtype="bfloat16", kv_quant=kv_quant,
                    prompts=prompts_for(512, MIXED["seed"], MIXED["lens"]),
                    max_new=MIXED["news"], engine_kw=MIXED["engine"],
                    on_step=_same_observability)
    assert out["mixed"] and out["pages_in_use"] == (0, 0)


# ---------------------------------------------------------------- spans --

def test_abort_mid_prefill_closes_span(smoke):
    cfg, params = smoke
    eng = EngineCore(cfg, params, lanes=2, page_size=4, num_pages=32,
                     chunk_size=4, device="cpu")
    prompt, = prompts_for(cfg.vocab_size, 5, (24,))    # 6 chunks of 4
    eng.submit(Request(uid=0, prompt=prompt, max_new=8))
    eng.step()
    assert eng.abort(0)
    span = eng.obs.tracer.span(0)
    assert span.status == "aborted"
    assert span.event_names() == ["submitted", "admitted", "aborted"]
    assert eng.obs.tracer.open_spans() == {}
    assert eng.obs.registry.value("requests_aborted_total") == 1
    assert eng.obs.registry.value("requests_finished_total") == 0
    assert eng.pages_in_use == 0


def test_preempt_and_resume_events_in_span(smoke):
    cfg, params = smoke
    specs = [(4, 26), (12, 14)]                # contended at 8 pages
    prompts = prompts_for(cfg.vocab_size, 21, [lp for lp, _ in specs])
    eng = EngineCore(cfg, params, lanes=2, page_size=4, num_pages=8,
                     chunk_size=4, device="cpu")
    for uid, (_, mn) in enumerate(specs):
        eng.submit(Request(uid=uid, prompt=prompts[uid], max_new=mn))
    _drain(eng)
    reg = eng.obs.registry
    assert reg.value("preemptions_total") >= 1
    assert reg.value("requests_resumed_total") == reg.value(
        "preemptions_total")
    assert reg.value("requests_finished_total") == 2
    preempted = [uid for uid in (0, 1)
                 if "preempted" in eng.obs.tracer.span(uid).event_names()]
    assert preempted, "pool contention never evicted anyone"
    for uid in preempted:
        span = eng.obs.tracer.span(uid)
        names = span.event_names()
        assert span.status == "finished"
        assert names.index("preempted") < names.index("resumed")
    assert eng.obs.tracer.open_spans() == {}


# ----------------------------------------------------- retrace sentinel --

_BUCKETS = (1, 2, 4, 8, 16)        # pow2-only: solo(3) and 3+1 both -> 4


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("deepseek-7b-smoke")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _sentinel_engine(cfg, params):
    return EngineCore(cfg, params, lanes=2, page_size=4, num_pages=24,
                      chunk_size=8, max_len=64, token_buckets=_BUCKETS,
                      device="cpu")


def _drain(eng):
    steps = 0
    while eng.scheduler.has_work():
        eng.step()
        steps += 1
        assert steps < 2000
    return steps


def _sentinel_warm_pass(eng, cfg, uid0):
    """The reference's warm-up pass: a long request grows its table past
    the 16-page bucket, two short ones co-batch with its decode, and the
    long one drains last."""
    long_p, = prompts_for(cfg.vocab_size, 17, (16,))
    eng.submit(Request(uid=uid0, prompt=long_p, max_new=40))
    for _ in range(20):
        if not eng.scheduler.has_work():
            break
        eng.step()
    for j, p in enumerate(prompts_for(cfg.vocab_size, 29 + uid0, (3, 3))):
        eng.submit(Request(uid=uid0 + 1 + j, prompt=p, max_new=3))
    _drain(eng)
    eng.finished.clear()


def _sentinel_probe(eng, cfg, uid):
    p, = prompts_for(cfg.vocab_size, 43, (3,))
    eng.submit(Request(uid=uid, prompt=p, max_new=3))
    _drain(eng)
    return int(eng.obs.registry.value("step_retraces_total"))


def _warm(eng, cfg):
    for i in range(6):
        t0 = eng.trace_count
        _sentinel_warm_pass(eng, cfg, uid0=10 * i)
        if eng.trace_count == t0:
            break
    return t0


def test_warm_engine_serves_fresh_traffic_with_zero_retraces(smoke):
    """Warm passes repeat until one captures nothing new; after
    ``mark_warm()`` fresh solo traffic replays cached graphs only."""
    cfg, params = smoke
    eng = _sentinel_engine(cfg, params)
    t0 = _warm(eng, cfg)
    assert eng.trace_count == t0, "warm-up never became capture-stable"
    assert eng.obs.registry.value("step_traces_total") == eng.trace_count
    assert eng.graphs.captures == eng.trace_count
    eng.obs.mark_warm()
    assert _sentinel_probe(eng, cfg, uid=900) == 0


def test_sentinel_catches_table_width_hwm_revert(smoke, monkeypatch):
    """Without the table-width high-water mark the same warm-up and probe
    capture again: a solo short request packs at a table width whose keys
    were dropped (or never seen)."""
    orig = Scheduler.pack

    def pack_without_hwm(self, plans):
        self._table_pages = 1
        return orig(self, plans)

    monkeypatch.setattr(Scheduler, "pack", pack_without_hwm)
    cfg, params = smoke
    eng = _sentinel_engine(cfg, params)
    _warm(eng, cfg)
    eng.obs.mark_warm()
    assert _sentinel_probe(eng, cfg, uid=900) > 0


# ---------------------------------------------------------- StepGraphs --

def _arrays(t, p, lanes=2, fill=0):
    cu = np.full((lanes + 2,), t, np.int32)
    cu[0] = 0
    return dict(tokens=np.full((t,), fill, np.int32),
                pos=np.arange(t, dtype=np.int32),
                table=np.full((t, p), fill, np.int32),
                last_idx=np.zeros((lanes,), np.int32), cu=cu)


def test_step_graphs_keys_buffers_and_drops():
    """Static buffers per (T, P), filled from each step's arrays; a capture
    on every new key and none on a repeat; keys of narrower P dropped when
    P grows past every key's, keys of equal or wider P kept."""
    seen = []

    def step_fn(tokens, pos, table, last_idx, cu):
        seen.append(tuple(t.data_ptr() for t in (tokens, pos, table,
                                                 last_idx, cu)))
        # logits whose greedy pick is tokens[i] + table.sum()
        return torch.nn.functional.one_hot(
            (tokens[:2] + table.sum()).long(), 64).float()

    captures = []
    g = StepGraphs(step_fn, lanes=2, vocab=64, device=torch.device("cpu"),
                   on_capture=lambda: captures.append(1))
    out = g.run(**_arrays(4, 2, fill=1))
    assert out.tolist() == [9, 9] and g.captures == 1
    out = g.run(**_arrays(4, 2, fill=3))
    assert out.tolist() == [27, 27] and g.captures == 1
    assert seen[0] == seen[1]                   # the same static buffers
    assert out.data_ptr() == g.keys[4, 2].picks.data_ptr()
    g.run(**_arrays(8, 2))
    assert sorted(g.keys) == [(4, 2), (8, 2)] and len(captures) == 2
    g.run(**_arrays(4, 4))
    assert sorted(g.keys) == [(4, 4)] and g.captures == 3
    g.run(**_arrays(8, 2))                      # narrower P: captured anew
    assert sorted(g.keys) == [(4, 4), (8, 2)] and len(captures) == 4


def test_engine_reuses_key_buffers_across_steps(smoke):
    cfg, params = smoke
    eng = EngineCore(cfg, params, lanes=3, page_size=8, num_pages=24,
                     chunk_size=8, device="cpu")
    ptrs = {}
    for i, p in enumerate(prompts_for(cfg.vocab_size, 13, MIXED["lens"])):
        eng.submit(Request(uid=i, prompt=p, max_new=MIXED["news"][i]))
    while eng.scheduler.has_work():
        eng.step()
        for k, key in eng.graphs.keys.items():
            got = {n: b.data_ptr() for n, b in key.bufs.items()}
            assert ptrs.setdefault(k, got) == got, k
    assert eng.graphs.captures == eng.trace_count == len(ptrs)
    assert len(eng.graphs.keys) < len(ptrs)     # narrower P dropped


def _serve(eng, cfg):
    reqs = [Request(uid=i, prompt=p, max_new=5) for i, p in
            enumerate(prompts_for(cfg.vocab_size, 3, (3, 9, 14, 6)))]
    for r in reqs:
        eng.submit(r)
    _drain(eng)
    return {r.uid: r.tokens for r in reqs}


def test_metrics_off_and_eager_engines_token_identical(smoke):
    """``metrics=False`` writes nothing and ``capture=False`` captures
    nothing; both serve the captured engine's tokens."""
    cfg, params = smoke
    kw = dict(lanes=3, page_size=8, num_pages=24, chunk_size=8, device="cpu")
    on = EngineCore(cfg, params, **kw)
    off = EngineCore(cfg, params, metrics=False, **kw)
    eager = EngineCore(cfg, params, capture=False, **kw)
    want = _serve(on, cfg)
    assert _serve(off, cfg) == want
    assert _serve(eager, cfg) == want
    assert not off.obs.enabled
    assert off.obs.registry.value("steps_total") == 0
    assert off.obs.registry.value("step_traces_total") == 0
    assert len(off.obs.ring) == 0 and off.obs.tracer.open_spans() == {}
    assert off.trace_count == on.trace_count > 0     # the engine still counts
    assert eager.trace_count == 0 and not eager.graphs.keys
    assert on.obs.registry.value("steps_total") > 0
    assert on.obs.h_ttft_ms.count() == len(want)


def test_dropped_engine_frees_without_the_cycle_collector(smoke):
    """An engine holds no reference cycle: dropping it frees its pool (and,
    on the card, its graphs) at once, not at the next collection."""
    import gc
    import weakref
    cfg, params = smoke
    gc.disable()
    try:
        eng = EngineCore(cfg, params, lanes=3, page_size=8, num_pages=24,
                         chunk_size=8, device="cpu")
        _serve(eng, cfg)
        refs = [weakref.ref(eng), weakref.ref(eng.kv.pool["k"]),
                weakref.ref(eng.graphs)]
        del eng
        assert [r() for r in refs] == [None] * 3
    finally:
        gc.enable()


# ---------------------------------------------------- profiler window --

def test_profiler_window_writes_a_trace(smoke, tmp_path):
    """An armed window covers exactly the next N steps and leaves a Chrome
    trace; on the CPU it holds host events only (no kernel, no device
    time)."""
    cfg, params = smoke
    eng = EngineCore(cfg, params, lanes=3, page_size=8, num_pages=24,
                     chunk_size=8, device="cpu")
    for i, p in enumerate(prompts_for(cfg.vocab_size, 3, (3, 9))):
        eng.submit(Request(uid=i, prompt=p, max_new=4))
    eng.step()
    eng.obs.arm_profiler(2, str(tmp_path / "win"))
    eng.step()
    assert eng.obs.last_trace is None              # still open
    eng.step()
    assert eng.obs.profiler_error is None
    path = eng.obs.last_trace
    assert path is not None and os.path.exists(path)
    s = profile_summary(path)
    assert s["launches"] == 0 and s["device_ms"] == 0.0
    assert s["window_ms"] > 0 and s["busy_share"] == 0.0
    eng.step()
    assert eng.obs.last_trace == path              # the window closed


def test_profile_summary_of_a_trace():
    """Device time by name, kernel launches, launch API calls, and the busy
    share as the union of device intervals over the span of all events."""
    ev = [dict(ph="X", cat="Trace", name="PyTorch Profiler", ts=-50,
               dur=300),
          dict(ph="X", cat="overhead", name="Activity Buffer Request",
               ts=-40, dur=10),
          dict(ph="X", cat="cpu_op", name="aten::mm", ts=0, dur=100),
          dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=5,
               dur=2),
          dict(ph="X", cat="cuda_runtime", name="cudaGraphLaunch", ts=8,
               dur=2),
          dict(ph="X", cat="kernel", name="gemm", ts=10, dur=20),
          dict(ph="X", cat="kernel", name="gemm", ts=20, dur=20),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=60, dur=10),
          dict(ph="X", cat="kernel", name="paged", ts=90, dur=30),
          dict(ph="i", cat="kernel", name="marker", ts=0)]
    s = profile_summary({"traceEvents": ev})
    assert s["by_name"] == {"gemm": 0.04, "paged": 0.03, "Memcpy DtoH": 0.01}
    assert s["launches"] == 3
    assert s["host_launch_calls"] == {"cudaLaunchKernel": 1,
                                      "cudaGraphLaunch": 1}
    assert s["launch_call_ms"] == pytest.approx(0.004)
    assert s["window_ms"] == pytest.approx(0.12)     # the wrappers left out
    assert s["busy_ms"] == pytest.approx(0.07)       # 10-40, 60-70, 90-120
    assert s["idle_share"] == pytest.approx(1 - 7 / 12)
    assert s["kernel_span_ms"] == pytest.approx(0.11)   # 10 to 120
    assert s["kernel_span_idle_share"] == pytest.approx(1 - 6 / 11)


# ------------------------------------------------------ launch counters --

def test_launch_counter_list_covers_every_wrapper_counter():
    """Every ``<wrapper>.<counter> +=`` in the port's kernel wrappers is in
    ``graphs.LAUNCH_COUNTERS``, so a replay advances all of them."""
    bumped = set()
    for path in SRC.rglob("*.py"):
        text = path.read_text()
        fns = set(re.findall(r"^def (\w+)\(", text, re.M))
        for obj, attr in re.findall(
                r"^\s*(\w+)\.(\w+)(?:\[[^\]]*\])?\s*\+=", text, re.M):
            if obj in fns:
                bumped.add((obj, attr))
    listed = {(fn.__name__, attr) for fn, attr in t_graphs.LAUNCH_COUNTERS}
    assert bumped and bumped <= listed, bumped - listed


def test_launch_counts_round_trip():
    before = t_graphs.launch_counts()
    delta = {(0, None): 3, (4, "tensor_core"): 2}
    t_graphs._add_counts(delta)
    after = t_graphs.launch_counts()
    assert after[0, None] - before[0, None] == 3
    assert after[4, "tensor_core"] - before[4, "tensor_core"] == 2
    t_graphs._add_counts(delta, sign=-1)
    assert t_graphs.launch_counts() == before
