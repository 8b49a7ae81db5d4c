"""Request-lifecycle spans, the step trace ring, the retrace sentinel and
the profiler window of the port's serving stack (port of
``src/repro/serving/tracing.py``).

``ServingObservability`` is the one object threaded through the serving
stack (EngineCore, Scheduler, PagedKVCache).  It owns

* a :class:`~repro_torch.serving.metrics.MetricsRegistry`, the single
  source of truth for every counter, gauge and histogram the stack
  reports (the reference's names, so the two registries compare);
* a :class:`RequestTracer` recording one span per request (submitted →
  admitted → first_token → finished/aborted, with preemption and resume);
* a :class:`StepTraceRing` of the scheduler's last N step decisions
  (bucket width, table width, live/padded rows, pool occupancy);
* the **retrace sentinel**: ``serving/graphs.py::StepGraphs`` calls
  ``step_traced()`` on every capture of the step — the port's counterpart
  of the reference's jit trace — so ``step_traces_total`` counts captures
  always and ``step_retraces_total`` only after :meth:`mark_warm`: a
  capture in warm traffic is a shape the scheduler failed to keep stable;
* a ``torch.profiler`` window over the next N steps
  (:meth:`ServingObservability.arm_profiler`) and :func:`profile_summary`,
  the device-side split of its trace.

The hooks of the slices still to come (speculative decoding, the prefix
cache and copy-on-write, the streaming front door) are kept as the
reference's counters.  Every hook early-returns when ``enabled=False``
and everything stays on the host, off the captured step.
"""
from __future__ import annotations

import gzip
import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.metrics import MetricsRegistry

__all__ = [
    "SpanEvent",
    "RequestSpan",
    "RequestTracer",
    "StepTraceRing",
    "ServingObservability",
    "profile_summary",
]


# ------------------------------------------------------------- spans --

@dataclass
class SpanEvent:
    name: str
    t: float
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class RequestSpan:
    uid: int
    start_t: float
    events: List[SpanEvent] = field(default_factory=list)
    status: Optional[str] = None          # "finished" | "aborted" | ...
    end_t: Optional[float] = None

    @property
    def open(self) -> bool:
        return self.status is None

    def event_names(self) -> List[str]:
        return [e.name for e in self.events]

    def first(self, name: str) -> Optional[SpanEvent]:
        for e in self.events:
            if e.name == name:
                return e
        return None

    def duration_ms(self) -> float:
        end = self.end_t if self.end_t is not None else self.start_t
        return (end - self.start_t) * 1e3


class RequestTracer:
    """One span per request uid; bounded deque of closed spans."""

    def __init__(self, max_finished: int = 1024, clock=time.perf_counter):
        self.clock = clock
        self._open: Dict[int, RequestSpan] = {}
        self.finished: deque = deque(maxlen=max_finished)

    def begin(self, uid: int, **attrs) -> RequestSpan:
        stale = self._open.pop(uid, None)
        if stale is not None:            # uid reuse with a leaked span
            stale.status = "orphaned"
            stale.end_t = self.clock()
            self.finished.append(stale)
        now = self.clock()
        span = RequestSpan(uid=uid, start_t=now)
        span.events.append(SpanEvent("submitted", now, dict(attrs)))
        self._open[uid] = span
        return span

    def event(self, uid: int, name: str, **attrs) -> None:
        span = self._open.get(uid)
        if span is not None:             # unknown uid: deliberate no-op
            span.events.append(SpanEvent(name, self.clock(), dict(attrs)))

    def end(self, uid: int, status: str, **attrs) -> Optional[RequestSpan]:
        span = self._open.pop(uid, None)
        if span is None:
            return None
        now = self.clock()
        span.events.append(SpanEvent(status, now, dict(attrs)))
        span.status = status
        span.end_t = now
        self.finished.append(span)
        return span

    def open_spans(self) -> Dict[int, RequestSpan]:
        return dict(self._open)

    def span(self, uid: int) -> Optional[RequestSpan]:
        """The open span for uid, else the most recent closed one."""
        got = self._open.get(uid)
        if got is not None:
            return got
        for span in reversed(self.finished):
            if span.uid == uid:
                return span
        return None


class StepTraceRing:
    """Bounded ring of per-step scheduler-decision records (dicts)."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)

    def append(self, record: Dict[str, object]) -> None:
        self._ring.append(record)

    def records(self) -> List[Dict[str, object]]:
        return list(self._ring)

    def last(self) -> Optional[Dict[str, object]]:
        return self._ring[-1] if self._ring else None

    def __len__(self) -> int:
        return len(self._ring)


# ----------------------------------------------------- observability --

class ServingObservability:
    """The bundle threaded through the serving stack.

    All mutating hooks early-return when ``enabled`` is False; family
    handles are pre-bound in ``__init__`` so the hot hooks are attribute
    bumps, not dict lookups.
    """

    def __init__(self, enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 ring_capacity: int = 512):
        self.enabled = enabled
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = RequestTracer()
        self.ring = StepTraceRing(ring_capacity)
        self.warm = False
        self._profiler: Optional[dict] = None
        self._windows = 0                      # profiler windows closed
        self.last_trace: Optional[str] = None  # Chrome trace of the last one
        self.profiler_error: Optional[str] = None

        r = self.registry
        # -- step/engine counters
        self.c_steps = r.counter(
            "steps_total", "engine steps executed")
        self.c_mixed_steps = r.counter(
            "mixed_steps_total", "steps co-batching prefill and decode")
        self.c_traces = r.counter(
            "step_traces_total", "step graph captures (lifetime)")
        self.c_retraces = r.counter(
            "step_retraces_total", "step graph captures after mark_warm()")
        self.c_prefill_toks = r.counter(
            "prefill_tokens_total", "prompt tokens processed")
        self.c_decode_toks = r.counter(
            "decode_tokens_total", "decode tokens processed")
        self.c_live_rows = r.counter(
            "live_rows_total", "live token rows packed into steps")
        self.c_padded_rows = r.counter(
            "padded_rows_total", "padded stream width summed over steps")
        self.c_tokens_out = r.counter(
            "tokens_generated_total", "tokens committed to requests")
        self.c_trim_prefill = r.counter(
            "trimmed_prefill_tokens_total",
            "prefill tokens deferred by bucket trimming")
        self.c_trim_drafts = r.counter(
            "spec_trimmed_draft_tokens_total",
            "draft tokens dropped by trim/degrade before packing")
        # -- request lifecycle
        self.c_submitted = r.counter(
            "requests_submitted_total", "requests entering the scheduler")
        self.c_admitted = r.counter(
            "requests_admitted_total", "waiting->running admissions")
        self.c_resumed = r.counter(
            "requests_resumed_total", "preempted->running resumptions")
        self.c_finished = r.counter(
            "requests_finished_total", "requests completed")
        self.c_aborted = r.counter(
            "requests_aborted_total", "requests aborted/cancelled")
        self.c_preempted = r.counter(
            "preemptions_total", "requests preempted by page pressure")
        # -- speculative decoding
        self.c_drafted = r.counter(
            "spec_drafted_tokens_total", "draft tokens entering verify")
        self.c_accepted = r.counter(
            "spec_accepted_tokens_total", "draft tokens accepted")
        self.c_spec_steps = r.counter(
            "spec_steps_total", "steps that verified at least one draft")
        self.c_proposals = r.counter(
            "spec_proposals_total", "proposer calls that drafted tokens")
        self.c_proposed = r.counter(
            "spec_proposed_tokens_total", "tokens drafted by the proposer")
        # -- prefix cache / pages
        self.c_prefix_lookups = r.counter(
            "prefix_lookups_total", "prefix-cache lookups at admission")
        self.c_prefix_lookup_toks = r.counter(
            "prefix_lookup_tokens_total", "prompt tokens offered for reuse")
        self.c_prefix_hits = r.counter(
            "prefix_hits_total", "lookups that matched cached pages")
        self.c_prefix_hit_toks = r.counter(
            "prefix_hit_tokens_total", "prompt tokens served from cache")
        self.c_prefix_shared = r.counter(
            "prefix_shared_page_grants_total", "cached pages granted shared")
        self.c_prefix_evicted = r.counter(
            "prefix_evicted_pages_total", "cached pages evicted")
        self.c_cow = r.counter(
            "cow_copies_total", "copy-on-write page copies")
        # -- streaming front door
        self.c_stream_requests = r.counter(
            "stream_requests_total", "streamed requests finished")
        self.c_stream_cancelled = r.counter(
            "stream_cancelled_total", "streamed requests cancelled")
        self.c_stream_tokens = r.counter(
            "stream_tokens_total", "tokens emitted to streams")
        # -- gauges
        self.g_pool_in_use = r.gauge(
            "pool_pages_in_use", "page-pool pages currently referenced")
        self.g_pool_free = r.gauge(
            "pool_pages_free", "page-pool pages on the free heap")
        self.g_pool_peak = r.gauge(
            "pool_pages_in_use_peak", "high-water pages in use")
        self.g_waiting = r.gauge(
            "scheduler_waiting", "requests queued for admission")
        self.g_running = r.gauge(
            "scheduler_running", "requests resident in lanes")
        self.g_table_pages = r.gauge(
            "step_table_pages", "page-table width of the last step")
        self.g_cached_pages = r.gauge(
            "prefix_cached_pages", "pages held by the prefix cache")
        self.g_reclaimable = r.gauge(
            "prefix_reclaimable_pages", "cache-only pages reclaimable")
        self.g_mesh = r.gauge(
            "mesh_devices", "tensor-parallel mesh size")
        self.g_coll_per_tok = r.gauge(
            "collective_bytes_per_token",
            "analytic per-device all-gather bytes per packed token")
        self.g_coll_per_step = r.gauge(
            "collective_bytes_per_step",
            "measured per-device collective bytes per step")
        # -- histograms
        self.h_step_ms = r.histogram(
            "step_latency_ms", "wall time of EngineCore.step()")
        self.h_ttft_ms = r.histogram(
            "request_ttft_ms", "submit to first committed token")
        self.h_tpot_ms = r.histogram(
            "request_tpot_ms", "mean inter-token time per finished request")
        self.h_stream_ttft_ms = r.histogram(
            "stream_ttft_ms", "server submit to first streamed token")
        self.h_stream_tpot_ms = r.histogram(
            "stream_tpot_ms", "server mean inter-token time per stream")

    # ------------------------------------------------- retrace sentinel --
    def step_traced(self) -> None:
        """Called by ``StepGraphs`` on every capture of the step (a miss in
        its per-(T, P) graph cache), i.e. once per new input shape — where
        the reference's jitted closure calls it on every XLA trace."""
        if not self.enabled:
            return
        self.c_traces.inc()
        if self.warm:
            self.c_retraces.inc()

    def mark_warm(self) -> None:
        """Every trace after this counts as a retrace (a bug signal)."""
        self.warm = True

    # ---------------------------------------------------- request hooks --
    def request_submitted(self, uid: int, prompt_len: int = 0,
                          max_new: int = 0) -> None:
        if not self.enabled:
            return
        self.c_submitted.inc()
        self.tracer.begin(uid, prompt_len=prompt_len, max_new=max_new)

    def request_admitted(self, uid: int, hit_tokens: int = 0,
                         resumed: bool = False) -> None:
        if not self.enabled:
            return
        if resumed:
            self.c_resumed.inc()
            self.tracer.event(uid, "resumed")
        else:
            self.c_admitted.inc()
            attrs = {"prefix_hit_tokens": hit_tokens} if hit_tokens else {}
            self.tracer.event(uid, "admitted", **attrs)

    def request_preempted(self, uid: int) -> None:
        if not self.enabled:
            return
        self.c_preempted.inc()
        self.tracer.event(uid, "preempted")

    def request_finished(self, uid: int, aborted: bool = False,
                         generated: int = 0) -> None:
        if not self.enabled:
            return
        if aborted:
            self.c_aborted.inc()
        else:
            self.c_finished.inc()
        span = self.tracer.end(uid, "aborted" if aborted else "finished",
                               generated=generated)
        if span is not None and not aborted and generated > 1:
            first = span.first("first_token")
            if first is not None:
                self.h_tpot_ms.observe(
                    (span.end_t - first.t) * 1e3 / (generated - 1))

    def tokens_committed(self, uid: int, n: int, first: bool) -> None:
        if not self.enabled or n <= 0:
            return
        self.c_tokens_out.inc(n)
        if first:
            self.tracer.event(uid, "first_token")
            span = self.tracer.span(uid)
            if span is not None and span.open:
                self.h_ttft_ms.observe(
                    (span.events[-1].t - span.start_t) * 1e3)

    def spec_proposed(self, tokens: int) -> None:
        if not self.enabled:
            return
        self.c_proposals.inc()
        self.c_proposed.inc(tokens)

    def spec_verify(self, uid: int, drafted: int, accepted: int) -> None:
        if not self.enabled or drafted <= 0:
            return
        self.tracer.event(uid, "spec_verify",
                          drafted=drafted, accepted=accepted)

    def cow_copy(self) -> None:
        """Counter-only: PagedKVCache.cow() calls this for every copy."""
        if not self.enabled:
            return
        self.c_cow.inc()

    def request_cow(self, uid: int) -> None:
        """Span-only: the scheduler attributes a CoW to a request."""
        if not self.enabled:
            return
        self.tracer.event(uid, "cow_copy")

    # ------------------------------------------------ prefix-cache hooks --
    def prefix_lookup(self, tokens: int, hit_tokens: int,
                      shared_pages: int) -> None:
        if not self.enabled:
            return
        self.c_prefix_lookups.inc()
        self.c_prefix_lookup_toks.inc(tokens)
        if hit_tokens:
            self.c_prefix_hits.inc()
            self.c_prefix_hit_toks.inc(hit_tokens)
            self.c_prefix_shared.inc(shared_pages)

    def prefix_evicted(self, pages: int = 1) -> None:
        if not self.enabled:
            return
        self.c_prefix_evicted.inc(pages)

    # ------------------------------------------------------- step hook --
    def record_step(self, out, *, dur_ms: float, sched, kv,
                    cache=None, table_pages: int = 0,
                    trimmed_prefill: int = 0, trimmed_drafts: int = 0,
                    width: int = 0) -> None:
        """Called once per EngineCore.step() with the StepOutput."""
        if self._profiler is not None:
            self._profiler_tick()
        if not self.enabled:
            return
        self.c_steps.inc()
        if out.prefill_tokens and out.decode_tokens:
            self.c_mixed_steps.inc()
        self.c_prefill_toks.inc(out.prefill_tokens)
        self.c_decode_toks.inc(out.decode_tokens)
        self.c_live_rows.inc(out.live_rows)
        self.c_padded_rows.inc(out.padded_rows)
        if out.drafted_tokens:
            self.c_drafted.inc(out.drafted_tokens)
            self.c_accepted.inc(out.accepted_tokens)
            self.c_spec_steps.inc()
        if trimmed_prefill:
            self.c_trim_prefill.inc(trimmed_prefill)
        if trimmed_drafts:
            self.c_trim_drafts.inc(trimmed_drafts)
        self.h_step_ms.observe(dur_ms)

        in_use = kv.num_pages - len(kv.free)
        self.g_pool_in_use.set(in_use)
        self.g_pool_free.set(len(kv.free))
        self.g_pool_peak.set_max(in_use)
        self.g_waiting.set(len(sched.waiting))
        self.g_running.set(len(sched.running))
        self.g_table_pages.set(table_pages)
        reclaimable = 0
        if cache is not None:
            self.g_cached_pages.set(cache.cached_pages)
            reclaimable = cache.reclaimable_pages
            self.g_reclaimable.set(reclaimable)
        self.ring.append({
            "step": int(self.c_steps.value()),
            "width": width,
            "table_pages": table_pages,
            "live_rows": out.live_rows,
            "padded_rows": out.padded_rows,
            "prefill_tokens": out.prefill_tokens,
            "decode_tokens": out.decode_tokens,
            "drafted_tokens": out.drafted_tokens,
            "accepted_tokens": out.accepted_tokens,
            "trimmed_prefill_tokens": trimmed_prefill,
            "trimmed_draft_tokens": trimmed_drafts,
            "pool_pages_in_use": in_use,
            "cache_reclaimable_pages": reclaimable,
            "dur_ms": dur_ms,
        })

    def reset_peaks(self) -> None:
        """Re-anchor high-water gauges (bench passes call this)."""
        self.g_pool_peak.set(self.g_pool_in_use.value())

    # ------------------------------------------------ torch profiler --
    def arm_profiler(self, steps: int, logdir: str) -> None:
        """Opt-in: a ``torch.profiler`` window (CPU activities, and CUDA
        ones where a card is visible) over the next ``steps`` engine steps.
        It opens at the top of the first of them (``step_begin``), closes
        after the last one's ``record_step`` (the step has synchronised on
        its picks by then) and writes a Chrome trace into ``logdir``; its
        path lands in ``last_trace`` (read it with :func:`profile_summary`).
        A profiler error closes the window and lands in ``profiler_error``:
        observability never stops the engine."""
        self._profiler = {"left": int(steps), "dir": logdir, "prof": None}

    def step_begin(self) -> None:
        """Called at the top of every EngineCore.step(): opens an armed
        profiler window."""
        p = self._profiler
        if p is None or p["prof"] is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        try:
            prof.start()
        except RuntimeError as e:
            self.profiler_error = repr(e)
            self._profiler = None
            return
        p["prof"] = prof

    def _profiler_tick(self) -> None:
        p = self._profiler
        if p is None or p["prof"] is None:
            return
        p["left"] -= 1
        if p["left"] > 0:
            return
        self._profiler = None
        self._windows += 1
        path = os.path.join(p["dir"], f"trace_{self._windows}.json")
        try:
            p["prof"].stop()
            os.makedirs(p["dir"], exist_ok=True)
            p["prof"].export_chrome_trace(path)
        except (RuntimeError, OSError) as e:
            self.profiler_error = repr(e)
            return
        self.last_trace = path

    # ------------------------------------------------- summary windows --
    def engine_window(self) -> Dict[str, int]:
        """Anchor for a per-pass latency window over the engine-side
        TTFT/TPOT histograms (bench batch arms)."""
        return {"ttft_n": self.h_ttft_ms.count(),
                "tpot_n": self.h_tpot_ms.count()}

    def engine_latency_summary(self, window: Dict[str, int]) -> Dict[str, float]:
        skip_t, skip_p = window["ttft_n"], window["tpot_n"]
        return {
            "ttft_ms_p50": self.h_ttft_ms.percentile(0.50, skip=skip_t),
            "ttft_ms_p99": self.h_ttft_ms.percentile(0.99, skip=skip_t),
            "tpot_ms": self.h_tpot_ms.mean(skip=skip_p),
        }

    def server_window(self) -> Dict[str, float]:
        """Anchor for a per-server-instance summary window."""
        return {"requests": self.c_stream_requests.value(),
                "tokens": self.c_stream_tokens.value(),
                "ttft_n": self.h_stream_ttft_ms.count(),
                "tpot_n": self.h_stream_tpot_ms.count()}

    def stream_finished(self, submitted_t: float, first_t: Optional[float],
                        end_t: float, emitted: int) -> None:
        """Server-side terminal accounting for one finished stream."""
        if not self.enabled or first_t is None:
            return
        self.c_stream_requests.inc()
        self.c_stream_tokens.inc(emitted)
        self.h_stream_ttft_ms.observe((first_t - submitted_t) * 1e3)
        if emitted > 1:
            self.h_stream_tpot_ms.observe(
                (end_t - first_t) * 1e3 / (emitted - 1))

    def stream_cancelled(self) -> None:
        if not self.enabled:
            return
        self.c_stream_cancelled.inc()

    def server_summary(self, window: Optional[Dict[str, float]],
                       *, steps: int, cancelled: int,
                       span: Tuple[Optional[float], Optional[float]],
                       ) -> Dict[str, float]:
        """The registry view behind the front door's ``summary()``
        (``AsyncLMServer`` in the reference; a later slice of the port)."""
        w = window or {"requests": 0, "tokens": 0, "ttft_n": 0, "tpot_n": 0}
        n = int(self.c_stream_requests.value() - w["requests"])
        if n == 0:
            return {"requests": 0, "cancelled": cancelled, "steps": steps}
        t0, t1 = span
        elapsed = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        return {
            "requests": n,
            "cancelled": cancelled,
            "steps": steps,
            "req_s": n / elapsed if elapsed > 0 else float("inf"),
            "ttft_ms_p50": self.h_stream_ttft_ms.percentile(
                0.50, skip=int(w["ttft_n"])),
            "ttft_ms_p99": self.h_stream_ttft_ms.percentile(
                0.99, skip=int(w["ttft_n"])),
            "tpot_ms": self.h_stream_tpot_ms.mean(skip=int(w["tpot_n"])),
            "tokens": int(self.c_stream_tokens.value() - w["tokens"]),
        }

    def spec_window(self) -> Dict[str, dict]:
        return self.registry.snapshot()

    def spec_summary(self, since: Dict[str, dict]) -> Dict[str, float]:
        d = self.registry.delta(since)
        drafted = d.get("spec_drafted_tokens_total", 0)
        accepted = d.get("spec_accepted_tokens_total", 0)
        spec_steps = d.get("spec_steps_total", 0)
        return {
            "drafted_tokens": int(drafted),
            "accepted_tokens": int(accepted),
            "spec_steps": int(spec_steps),
            "acceptance": accepted / drafted if drafted else 0.0,
            "accepted_per_spec_step":
                accepted / spec_steps if spec_steps else 0.0,
        }


# --------------------------------------------------- profile summary --

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_PROFILER_CATS = ("Trace", "overhead")       # the profiler's own events


def _union_us(spans: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profile_summary(trace, top: Optional[int] = 12) -> Dict[str, object]:
    """The device-side split of a profiler window's Chrome trace (a path,
    gzipped or not, or the parsed dict) →

    * ``by_name``: device self time in ms by kernel (and memcpy / memset)
      name, largest first, the first ``top`` of them (all with ``None``);
      ``device_ms`` all of it;
    * ``launches``: kernels executed on the device in the window;
      ``host_launch_calls``: the host's launch API calls
      (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``, …)
      by name — a replayed graph is one call for all its kernels — and
      ``launch_call_ms`` their host time;
    * ``window_ms``: the span of the recorded host and device events (the
      profiler's own wrapper and buffer events left out); ``busy_ms``: the
      union of the device intervals; ``busy_share`` and ``idle_share`` of
      the window;
    * ``kernel_span_ms``: first kernel to last, and
      ``kernel_span_idle_share``, the share of it no kernel ran — for a
      replayed graph the idle inside the graph, free of the launch call's
      host time (which the profiler's own instrumentation inflates).
    """
    if not isinstance(trace, dict):
        path = os.fspath(trace)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e and "ts" in e
              and e.get("cat") not in _PROFILER_CATS]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    calls: Dict[str, int] = {}
    call_us = 0.0
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "Launch" in e["name"]:
            calls[e["name"]] = calls.get(e["name"], 0) + 1
            call_us += float(e["dur"])

    def span(evs):
        if not evs:
            return 0.0
        return (max(float(e["ts"]) + float(e["dur"]) for e in evs)
                - min(float(e["ts"]) for e in evs))

    kernels = [e for e in dev if e.get("cat") == "kernel"]
    window, kspan = span(events), span(kernels)
    busy = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in dev])
    kbusy = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in kernels])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    share = busy / window if window else 0.0
    return {"by_name": dict(ranked[:top]),
            "device_ms": sum(by_name.values()),
            "launches": len(kernels),
            "host_launch_calls": calls, "launch_call_ms": call_us / 1e3,
            "window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "busy_share": share, "idle_share": 1.0 - share if window else 0.0,
            "kernel_span_ms": kspan / 1e3,
            "kernel_span_idle_share": 1.0 - kbusy / kspan if kspan else 0.0}
