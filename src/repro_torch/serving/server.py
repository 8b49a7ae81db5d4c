"""AsyncLMServer: the asyncio front door around ``EngineCore.step()`` (port
of ``src/repro/serving/server.py``; the engine is the port's, the loop the
same).

The engine is a library — submit/step/finished.  Serving millions of users
needs a *process*: request intake with admission backpressure, per-token
streaming, cancellation that frees resources immediately, graceful drain.
This module is that process, as one serve loop and one async generator:

    intake queue ──► submit ──► EngineCore.step() ──► stream deltas ──► client
         ▲                          │        ▲                            │
         │ backpressure             │        └── abort (pages freed) ◄────┘
         └── reject / wait          ▼             on cancel/disconnect
                              graceful drain

- **Intake / backpressure** — ``generate()`` validates eagerly (a bad
  request raises :class:`~repro_torch.serving.sampling.InvalidRequest` in the
  client's own context, never mid-serve) and enqueues onto a *bounded*
  queue.  ``admission="wait"`` suspends the client until a slot opens —
  backpressure propagates to the caller; ``admission="reject"`` raises
  :class:`ServerOverloaded` immediately (shed load at the door).
- **The serve loop** — single task, and the only place the engine is
  touched (submit/abort/step are serialized by construction; no locks).
  Each iteration drains intake, processes pending aborts — so a cancelled
  request's pages are free *before* the next step runs — then executes one
  ``engine.step()`` in a worker thread (``asyncio.to_thread``: clients
  keep streaming/connecting while the device works) and flushes new
  tokens to every client's stream.
- **Streaming** — per-token deltas come from ``req.tokens[emitted:safe]``,
  not from ``StepOutput.tokens`` (a speculative step commits several
  tokens at once; the cursor form loses nothing).  ``safe`` holds back any
  suffix that could still complete a stop sequence
  (:func:`~repro_torch.serving.sampling.stop_holdback`) — a streamed token is
  never retracted.
- **Cancellation** — a client breaking out of (or erroring inside) the
  async-for lands in the generator's ``finally``: the uid joins the abort
  set and the loop calls ``EngineCore.abort()`` before its next step —
  scheduler release, prefix-cache publish of full pages, lane freed within
  one step.  Disconnect and explicit cancel are the same path.
- **Shutdown** — ``shutdown(drain=True)`` stops intake and lets resident
  work finish; ``drain=False`` aborts every in-flight client first.  The
  async context manager form does a draining shutdown on exit.

Latency telemetry (TTFT / TPOT / sustained req/s) flows into the engine's
metrics registry (``serving/tracing.py``); :meth:`AsyncLMServer.summary`
is a thin window over it — ``chip_smoke.py``'s front-door phase, the
``/metrics`` exposition and ``--metrics-json`` all read the same counters.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import AsyncIterator, Dict, Optional, Set

from repro_torch.serving.api import Request
from repro_torch.serving.sampling import stop_holdback
from repro_torch.serving.tracing import ServingObservability

_DONE = object()          # end-of-stream sentinel on a client's queue


class ServerOverloaded(RuntimeError):
    """Admission rejected: the intake queue is full (``admission="reject"``)."""


class ServerClosed(RuntimeError):
    """The server is shutting down; no new requests are admitted."""


@dataclasses.dataclass
class _Client:
    req: Request
    queue: asyncio.Queue            # int tokens | Exception | _DONE
    submitted_t: float
    first_t: Optional[float] = None
    emitted: int = 0
    cancelled: bool = False


class AsyncLMServer:
    """Asyncio serve loop around an
    :class:`~repro_torch.serving.core.EngineCore` (any engine with
    ``abort``).

    ::

        server = AsyncLMServer(engine, max_waiting=64)
        async with server:
            async for tok in server.generate(req):
                ...                       # break == cancel; pages freed

    ``max_waiting`` bounds the intake queue (requests the engine has not
    yet admitted); ``admission`` picks the backpressure policy: ``"wait"``
    (default) suspends ``generate()`` until a slot opens, ``"reject"``
    raises :class:`ServerOverloaded` at the door.
    """

    def __init__(self, engine, *, max_waiting: int = 64,
                 admission: str = "wait"):
        if admission not in ("wait", "reject"):
            raise ValueError(f"unknown admission policy {admission!r}; "
                             f"expected 'wait' or 'reject'")
        if not hasattr(engine, "abort"):
            raise TypeError("AsyncLMServer needs an engine with abort() — "
                            "EngineCore — to cancel mid-flight requests")
        self.engine = engine
        self.admission = admission
        self.max_waiting = max_waiting
        self._intake: Optional[asyncio.Queue] = None
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._clients: Dict[int, _Client] = {}
        self._aborts: Set[int] = set()
        self._closing = False
        self.steps = 0
        self.cancelled = 0
        # The engine's observability bundle is the telemetry home; an
        # engine serving with metrics off gets a private (enabled) one so
        # summary() keeps working either way.
        obs = getattr(engine, "obs", None)
        self.obs = (obs if obs is not None and obs.enabled
                    else ServingObservability())
        self._window: Optional[dict] = None     # registry anchor at start()
        self._span_t0: Optional[float] = None   # earliest finished submit
        self._span_t1: Optional[float] = None   # latest finish

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "AsyncLMServer":
        if self._task is not None:
            raise RuntimeError("server already started")
        self._intake = asyncio.Queue(maxsize=self.max_waiting)
        self._wake = asyncio.Event()
        self._window = self.obs.server_window()
        self._task = asyncio.create_task(self._serve(), name="lm-serve-loop")
        return self

    async def shutdown(self, drain: bool = True) -> None:
        """Stop the serve loop.  ``drain=True`` finishes resident work
        first (intake closes immediately); ``drain=False`` aborts every
        in-flight client.  Idempotent; re-raises a crashed loop's error."""
        self._closing = True
        if not drain:
            for uid in list(self._clients):
                self._aborts.add(uid)
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    async def __aenter__(self) -> "AsyncLMServer":
        return await self.start()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        # On a client-side exception, don't block exit on a full drain.
        await self.shutdown(drain=exc_type is None)

    # ------------------------------------------------------------- clients
    async def generate(self, req: Request) -> AsyncIterator[int]:
        """Submit ``req`` and stream its generated tokens as they commit.

        The stream ends when the request finishes (stop/eos/max_new).
        Closing the generator early — client disconnect, ``break``, task
        cancellation — aborts the request; its lane and pages are free
        before the next engine step."""
        if self._closing:
            raise ServerClosed("server is shutting down")
        if self._task is None:
            raise RuntimeError("server not started (use 'async with' or "
                               "await start())")
        self.engine.validate(req)      # fail in the client's own context
        client = _Client(req=req, queue=asyncio.Queue(),
                         submitted_t=time.perf_counter())
        if self.admission == "reject":
            try:
                self._intake.put_nowait(client)
            except asyncio.QueueFull:
                raise ServerOverloaded(
                    f"intake queue full ({self.max_waiting} waiting)")
        else:
            await self._intake.put(client)     # backpressure: suspend here
        self._wake.set()
        try:
            while True:
                item = await client.queue.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            if not req.done:                   # cancelled / disconnected
                client.cancelled = True
                self._aborts.add(req.uid)
                if self._wake is not None:
                    self._wake.set()

    # ---------------------------------------------------------- serve loop
    def _drain_intake(self) -> None:
        while True:
            try:
                client = self._intake.get_nowait()
            except asyncio.QueueEmpty:
                return
            if client.cancelled:               # gone before admission
                continue
            try:
                self.engine.submit(client.req)
            except Exception as e:             # pragma: no cover - eager
                client.queue.put_nowait(e)     # validation catches these
                continue
            self._clients[client.req.uid] = client

    def _process_aborts(self) -> None:
        while self._aborts:
            uid = self._aborts.pop()
            self.engine.abort(uid)
            client = self._clients.pop(uid, None)
            if client is not None:
                self.cancelled += 1
                self.obs.stream_cancelled()
                client.queue.put_nowait(_DONE)

    def _flush(self) -> None:
        """Push each live request's newly-committed tokens to its client.

        Deltas are cursor-based over ``req.tokens`` (speculative steps
        commit several at once) minus the stop-holdback suffix; a finished
        request's final truncation has already been applied by the engine,
        so everything left streams out, then the end-of-stream sentinel."""
        now = time.perf_counter()
        for uid, client in list(self._clients.items()):
            req = client.req
            safe = (len(req.tokens) if req.done
                    else stop_holdback(req.tokens, req.sampling.stop))
            while client.emitted < safe:
                if client.first_t is None:
                    client.first_t = now
                client.queue.put_nowait(req.tokens[client.emitted])
                client.emitted += 1
            if req.done:
                if client.first_t is not None:
                    self._span_t0 = (client.submitted_t
                                     if self._span_t0 is None
                                     else min(self._span_t0,
                                              client.submitted_t))
                    self._span_t1 = (now if self._span_t1 is None
                                     else max(self._span_t1, now))
                self.obs.stream_finished(client.submitted_t, client.first_t,
                                         now, client.emitted)
                client.queue.put_nowait(_DONE)
                del self._clients[uid]

    async def _serve(self) -> None:
        try:
            while True:
                self._drain_intake()
                self._process_aborts()
                if not self.engine.scheduler.has_work():
                    if (self._closing and self._intake.empty()
                            and not self._aborts):
                        return
                    self._wake.clear()
                    # re-check after clear (lost-wakeup race), then park
                    if (self._intake.empty() and not self._aborts
                            and not self._closing):
                        await self._wake.wait()
                    continue
                # One engine step off-loop: intake/cancel keep flowing
                # while the device works.  The loop is the only engine
                # toucher, so submit/abort/step are serialized for free.
                await asyncio.to_thread(self.engine.step)
                self.steps += 1
                self._flush()
        except BaseException as e:
            for client in self._clients.values():
                client.queue.put_nowait(e)
            self._clients.clear()
            raise

    # ------------------------------------------------------------ telemetry
    def summary(self) -> dict:
        """Latency aggregate over this server instance's finished requests
        — a thin window over the metrics registry (sustained req/s over
        the serving span, TTFT p50/p99 submit → first streamed token, TPOT
        mean inter-token time after the first).  The same counters feed
        ``/metrics`` and ``--metrics-json``; nothing is recomputed here."""
        return self.obs.server_summary(
            self._window, steps=self.steps, cancelled=self.cancelled,
            span=(self._span_t0, self._span_t1))
