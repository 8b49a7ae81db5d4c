"""The ragged serving step captured as one CUDA graph per (token bucket,
table width) — the port's counterpart of the reference's jitted step
(``src/repro/serving/core.py``: ``jax.jit(ragged_fn, donate_argnums=(1,))``,
one compile per input shape).

``StepGraphs`` keys the step by ``(T, P)``: the packed stream's width and
the page table's width, exactly the shapes the reference retraces on.  The
scheduler buckets T and holds P at its power-of-two high-water mark, so the
keys stay few.  Each key owns static input buffers — tokens and pos (T,),
the table (T, P), last_idx (lanes,), cu (lanes + 2,) — and the (lanes,)
int32 picks output.  A step copies the scheduler's numpy arrays into them
through pinned host staging (``non_blocking``) and replays the key's graph;
reusing the staging is safe because the engine reads the picks on the host
every step, which waits for the copies.

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

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import quantize_dynamic
from repro_torch.kernels.int8_matmul.ops import int8_matmul
from repro_torch.kernels.lut_exp.ops import lut_exp
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.streaming_attention.ops import streaming_attention

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
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn()
        finally:
            after = launch_counts()
            self.delta = {k: n - before.get(k, 0) for k, n in after.items()
                          if n != before.get(k, 0)}
            _add_counts(self.delta, sign=-1)   # the capture ran nothing

    def replay(self):
        self.graph.replay()
        _add_counts(self.delta)
        return self.out


class _Key:
    """One (T, P) key: static inputs, host staging, the picks output and,
    on the card, the captured step."""

    def __init__(self, t: int, p: int, lanes: int, device: torch.device):
        shapes = dict(tokens=(t,), pos=(t,), table=(t, p),
                      last_idx=(lanes,), cu=(lanes + 2,))
        self.bufs = {k: torch.zeros(s, dtype=torch.int32, device=device)
                     for k, s in shapes.items()}
        self.picks = torch.zeros((lanes,), dtype=torch.int32, device=device)
        self.host = ({k: torch.zeros(s, dtype=torch.int32).pin_memory()
                      for k, s in shapes.items()}
                     if device.type == "cuda" else None)
        self.call: Optional[CapturedCall] = None

    def stage(self, arrays: Dict[str, np.ndarray]) -> None:
        for k in self.bufs:
            if self.host is None:
                self.bufs[k].copy_(torch.from_numpy(arrays[k]))
            else:
                self.host[k].numpy()[...] = arrays[k]
                self.bufs[k].copy_(self.host[k], non_blocking=True)


class StepGraphs:
    """The engine's per-(T, P) cache of captured ragged steps.

    ``step_fn(tokens, pos, table, last_idx, cu)`` runs one step on device
    tensors and returns the (lanes,) int32 picks; ``on_capture()`` is
    called on every capture (the retrace sentinel).  ``run`` stages one
    step's arrays and returns the picks on the device, without reading
    them.  ``capture_ms`` holds each card capture's host time: the warm-up
    step, the wait for it, the capture and the graph's instantiation."""

    def __init__(self, step_fn: Callable[..., torch.Tensor], *, lanes: int,
                 device: torch.device,
                 on_capture: Callable[[], None] = lambda: None):
        self.step_fn = step_fn
        self.lanes = lanes
        self.device = device
        self.on_capture = on_capture
        self.keys: Dict[Tuple[int, int], _Key] = {}
        self.captures = 0
        self.capture_ms: List[float] = []
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)

    def _step_into(self, key: _Key) -> Callable[[], torch.Tensor]:
        b = key.bufs
        return lambda: key.picks.copy_(self.step_fn(
            b["tokens"], b["pos"], b["table"], b["last_idx"], b["cu"]))

    def run(self, tokens: np.ndarray, pos: np.ndarray, table: np.ndarray,
            last_idx: np.ndarray, cu: np.ndarray) -> torch.Tensor:
        t, p = table.shape
        key = self.keys.get((t, p))
        arrays = dict(tokens=tokens, pos=pos, table=table, last_idx=last_idx,
                      cu=cu)
        if key is not None:
            key.stage(arrays)
            if key.call is not None:
                return key.call.replay()
            return self._step_into(key)()       # the CPU's replay
        widest = max((pp for _, pp in self.keys), default=p)
        key = _Key(t, p, self.lanes, self.device)
        key.stage(arrays)
        self.captures += 1
        self.on_capture()
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            key.call = CapturedCall(self._step_into(key), self.device,
                                    pool=self.pool)
            self.capture_ms.append((time.perf_counter() - t0) * 1e3)
            picks = key.picks                   # the warm-up's picks
        else:
            picks = self._step_into(key)()
        if p > widest:
            # Dropped after the new capture, so the shared pool always keeps
            # a live graph (a pool whose last graph died cannot be reused).
            self.keys = {k: v for k, v in self.keys.items() if k[1] >= p}
        self.keys[t, p] = key
        return picks
