"""The ragged serving step captured as one CUDA graph per (token bucket,
table width) — the port's counterpart of the reference's jitted step
(``src/repro/serving/core.py``: ``jax.jit(ragged_fn, donate_argnums=(1,))``,
one compile per input shape).

``StepGraphs`` keys the step by ``(T, P)``: the packed stream's width and
the page table's width, exactly the shapes the reference retraces on.  The
scheduler buckets T and holds P at its power-of-two high-water mark, so the
keys stay few.  Each key owns static input buffers — tokens and pos (T,),
the table (T, P), last_idx, cu (lanes + 2,) — and the int32 greedy picks.
``last_idx`` and the picks have one shape fixed per engine, never part of
the key: (lanes,), or (lanes, 1 + spec_k) for a speculative engine, whose
row j of a lane is its decode row plus its j-th draft (the reference
likewise compiles the verify step once, whatever a step's draft count).
Every key's step also writes its ``last_idx`` logits into one f32 buffer
of the engine, ``logits`` (pick shape × V).
A step copies the scheduler's numpy arrays into them
through pinned host staging (``non_blocking``) and replays the key's graph;
reusing the staging is safe because the engine reads the picks on the host
every step, which waits for the copies.

Sampling adds no key.  The reference draws inside its jitted step behind a
``lax.cond`` that skips the draw when no lane samples; a CUDA graph cannot
branch on device data, so the branch is taken on the host, from the
lanes' temperatures, which the host has.  A step that samples passes its
five (lanes,) arrays (temperature, top_k, top_p, seed, counter): they are
staged into the sampler's static buffers and one sampler graph per engine
(``serving/sampling.py::sample_in_step`` over ``logits``; its shape is the
engine's) replays after the step, its picks returned in place of the
greedy ones.  It is captured on the first sampled step, counted in
``sampler_captures``, never in ``captures`` (the reference traces its step
once per shape, whatever the sampling params).  An all-greedy step never
runs it.

On the card a new key runs the step once eagerly on a side stream (the
warm-up: it builds the kernels, puts the LUT on the card and is this
step's result), then captures it into one memory pool that every key
shares; later steps of the key replay it, serially on one stream.  A
capture that fails raises: there is no quiet fall-back to eager.  When P
grows past every key's, the keys of narrower P are dropped, since the
high-water mark never lets them recur.

On the CPU a capture is the plain version of one: the same keys, buffers
and counts, with the step function re-run on the static buffers in place
of a replay.

The kernel wrappers count launches in Python, which a replay does not run;
``CapturedCall`` records each counter's change during a capture, puts the
counters back (a capture executes nothing) and adds the change on every
replay, so the counters keep meaning "launches executed".
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import quantize_dynamic
from repro_torch.kernels.int8_matmul.ops import int8_matmul
from repro_torch.kernels.lut_exp.ops import lut_exp
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.streaming_attention.ops import (
    streaming_attention, streaming_attention_bwd)
from repro_torch.serving.sampling import greedy_rows, sample_in_step

#: Every launch counter of the port's kernel wrappers: (wrapper, attribute);
#: an attribute holds an int or a dict of ints.
LAUNCH_COUNTERS = (
    (paged_attention, "launches"), (paged_attention, "combine_launches"),
    (lut_exp, "launches"),
    (streaming_attention, "launches"),
    (streaming_attention, "launches_by_variant"),
    (int8_matmul, "launches"), (int8_matmul, "launches_by_variant"),
    (int8_matmul, "transposes"),
    (quantize_dynamic, "launches"),
    (streaming_attention_bwd, "launches"),
    (streaming_attention_bwd, "launches_by_variant"),
    (lut_exp, "bwd_launches"),
)


def launch_counts() -> Dict[Tuple[int, Optional[str]], int]:
    """Every launch counter's value, keyed by (counter index, dict key)."""
    out = {}
    for i, (fn, attr) in enumerate(LAUNCH_COUNTERS):
        v = getattr(fn, attr)
        if isinstance(v, dict):
            out.update({(i, k): n for k, n in v.items()})
        else:
            out[i, None] = v
    return out


def _add_counts(delta: Dict[Tuple[int, Optional[str]], int],
                sign: int = 1) -> None:
    for (i, key), n in delta.items():
        fn, attr = LAUNCH_COUNTERS[i]
        if key is None:
            setattr(fn, attr, getattr(fn, attr) + sign * n)
        else:
            getattr(fn, attr)[key] += sign * n


class CapturedCall:
    """``fn()`` captured once as a CUDA graph on ``device`` (into ``pool``,
    a ``torch.cuda.graph_pool_handle()``, when given).

    The constructor runs ``fn`` once eagerly on a side stream (its launches
    counted as they ran), then captures it;
    ``replay()`` runs the graph on the current stream, adds the capture's
    launch counts and returns ``out``, the tensors the captured call
    returned — rewritten in place by every replay.  Raises when ``fn``
    cannot be captured (a host read of a device value, a synchronising
    call, a launch on another stream)."""

    def __init__(self, fn: Callable, device: torch.device, pool=None):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: a graph of a dropped
        # engine that a reference cycle kept alive would be destroyed
        # mid-capture, which invalidates the capture.
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn()
        finally:
            if gc_was_on:
                gc.enable()
            after = launch_counts()
            self.delta = {k: n - before.get(k, 0) for k, n in after.items()
                          if n != before.get(k, 0)}
            _add_counts(self.delta, sign=-1)   # the capture ran nothing

    def replay(self):
        self.graph.replay()
        _add_counts(self.delta)
        return self.out


class _Staged:
    """Static input buffers (``shapes``: name → (shape, dtype)), their
    pinned host staging on the card, an int32 picks output and, on the
    card, the captured call that fills it."""

    def __init__(self, shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 pick_shape: Tuple[int, ...], device: torch.device):
        self.bufs = {k: torch.zeros(s, dtype=dt, device=device)
                     for k, (s, dt) in shapes.items()}
        self.host = ({k: torch.zeros(s, dtype=dt).pin_memory()
                      for k, (s, dt) in shapes.items()}
                     if device.type == "cuda" else None)
        self.picks = torch.zeros(pick_shape, dtype=torch.int32, device=device)
        self.call: Optional[CapturedCall] = None

    def stage(self, arrays: Dict[str, np.ndarray]) -> None:
        for k in self.bufs:
            if self.host is None:
                self.bufs[k].copy_(torch.from_numpy(arrays[k]))
            else:
                self.host[k].numpy()[...] = arrays[k]
                self.bufs[k].copy_(self.host[k], non_blocking=True)


def _key(t: int, p: int, pick_shape: Tuple[int, ...],
         device: torch.device) -> _Staged:
    """One (T, P) key's step inputs, all int32."""
    shapes = dict(tokens=(t,), pos=(t,), table=(t, p), last_idx=pick_shape,
                  cu=(pick_shape[0] + 2,))
    return _Staged({k: (s, torch.int32) for k, s in shapes.items()},
                   pick_shape, device)


def _sampler(lanes: int, pick_shape: Tuple[int, ...],
             device: torch.device) -> _Staged:
    """The sampler's five (lanes,) inputs; seed and counter hold uint32
    values in int64."""
    return _Staged(dict(temperature=((lanes,), torch.float32),
                        top_k=((lanes,), torch.int32),
                        top_p=((lanes,), torch.float32),
                        seed=((lanes,), torch.int64),
                        counter=((lanes,), torch.int64)),
                   pick_shape, device)


class StepGraphs:
    """The engine's per-(T, P) cache of captured ragged steps, and its one
    sampler.

    ``step_fn(tokens, pos, table, last_idx, cu)`` runs one step on device
    tensors and returns the f32 logits of the ``last_idx`` rows:
    ``(lanes, vocab)``, or ``(lanes, verify_rows, vocab)`` when
    ``verify_rows`` is given (a speculative engine's 1 + spec_k); the
    captured step copies them into ``logits`` and writes their greedy picks;
    the sampler draws from ``logits``.  ``on_capture()`` is called on
    every step capture (the retrace sentinel).  ``run`` stages one step's
    arrays and returns the picks on the device, without reading them.
    ``capture_ms`` holds each card capture's host time: the warm-up step,
    the wait for it, the capture and the graph's instantiation."""

    def __init__(self, step_fn: Callable[..., torch.Tensor], *, lanes: int,
                 vocab: int, device: torch.device,
                 verify_rows: Optional[int] = None,
                 on_capture: Callable[[], None] = lambda: None):
        self.step_fn = step_fn
        self.lanes = lanes
        self.pick_shape = ((lanes,) if verify_rows is None
                           else (lanes, verify_rows))
        self.device = device
        self.on_capture = on_capture
        self.keys: Dict[Tuple[int, int], _Staged] = {}
        self.captures = 0
        self.capture_ms: List[float] = []
        self.logits = torch.zeros(self.pick_shape + (vocab,),
                                  dtype=torch.float32, device=device)
        self.sampler: Optional[_Staged] = None
        self.sampler_captures = 0
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)

    def _step_into(self, key: _Staged) -> Callable[[], torch.Tensor]:
        b = key.bufs

        def step():
            logits = self.step_fn(b["tokens"], b["pos"], b["table"],
                                  b["last_idx"], b["cu"])
            self.logits.copy_(logits)
            return greedy_rows(logits, out=key.picks)
        return step

    def _sample_into(self, s: _Staged) -> Callable[[], torch.Tensor]:
        return lambda: s.picks.copy_(sample_in_step(self.logits, **s.bufs))

    def _call(self, staged: _Staged, fn: Callable[[], torch.Tensor]
              ) -> torch.Tensor:
        """A new staged call's first run: captured on the card (its warm-up
        is this run's result), plainly run on the CPU."""
        if self.device.type != "cuda":
            return fn()
        staged.call = CapturedCall(fn, self.device, pool=self.pool)
        return staged.picks

    def run(self, tokens: np.ndarray, pos: np.ndarray, table: np.ndarray,
            last_idx: np.ndarray, cu: np.ndarray,
            sampling: Optional[Dict[str, np.ndarray]] = None
            ) -> torch.Tensor:
        """One step → its picks: the greedy ones, or with ``sampling`` (the
        five (lanes,) arrays of a step in which some lane samples) the
        sampler's."""
        picks = self._run_step(tokens, pos, table, last_idx, cu)
        if sampling is None:
            return picks
        s = self.sampler
        if s is None:
            s = _sampler(self.lanes, self.pick_shape, self.device)
            s.stage(sampling)
            self.sampler_captures += 1
            picks = self._call(s, self._sample_into(s))
            self.sampler = s                # kept once its capture succeeded
            return picks
        s.stage(sampling)
        if s.call is not None:
            return s.call.replay()
        return self._sample_into(s)()             # the CPU's replay

    def _run_step(self, tokens, pos, table, last_idx, cu) -> torch.Tensor:
        t, p = table.shape
        if last_idx.shape != self.pick_shape:
            raise ValueError(f"last_idx of shape {last_idx.shape}; this "
                             f"engine's steps pick {self.pick_shape}")
        key = self.keys.get((t, p))
        arrays = dict(tokens=tokens, pos=pos, table=table, last_idx=last_idx,
                      cu=cu)
        if key is not None:
            key.stage(arrays)
            if key.call is not None:
                return key.call.replay()
            return self._step_into(key)()       # the CPU's replay
        widest = max((pp for _, pp in self.keys), default=p)
        key = _key(t, p, self.pick_shape, self.device)
        key.stage(arrays)
        self.captures += 1
        self.on_capture()
        t0 = time.perf_counter()
        picks = self._call(key, self._step_into(key))
        if self.device.type == "cuda":
            self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        if p > widest:
            # Dropped after the new capture, so the shared pool always keeps
            # a live graph (a pool whose last graph died cannot be reused).
            self.keys = {k: v for k, v in self.keys.items() if k[1] >= p}
        self.keys[t, p] = key
        return picks
