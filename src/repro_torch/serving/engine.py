"""The slot-contiguous serving engine (port of ``src/repro/serving/engine.py``:
``_EngineBase``, ``ServingEngine``, and the deprecated ``PagedServingEngine``
shim over ``EngineCore``, at the end).

``ServingEngine`` serves the vlm family as text, as the reference's does,
and refuses the encoder-decoder (``NotImplementedError``): its prefill
takes tokens only, and an encoder-decoder needs its frames.  It serves
the cache layouts the page pool rejects
(``UnsupportedCacheLayout``): a local layer whose window is narrower than a
page keeps a ring buffer of ``window`` rows (``models/layers.py::
attn_cache_init``), and a Mamba layer O(1) state (``models/mamba.py``,
``models/mamba2.py``), neither of which can page.  Each of B slots owns one
batch row of the model's contiguous cache (``Model.init_cache(slots,
max_len)``): ``max_len`` rows of every global layer, int8 with row scales
under ``cfg.kv_quant``, a ring of ``window`` rows per local layer when the
window is below ``max_len``, or a Mamba layer's conv and scan state (and
the hybrid's shared block's ``max_len`` rows per period).

Admission prefills one request at b = 1 (``Model.prefill``) straight into
its slot's rows, views of the engine's cache, after resetting them to the
cache's initial values (zeros, ring positions -1).  The prefill's lengths
are host ints, so on the card every layer runs the streaming-attention
kernel (#3).  Decode runs all slots at once: one ``Model.decode_step`` of
(slots,) tokens at a (slots,) position vector — the counterpart of the
reference's ``vmap`` of the single-row step over slots — whose single-row
attention resolves to ``naive_decode`` as in the reference (the int8
cache's to ``streaming_attention_quantized``).  A free slot decodes too,
at its stale position, into rows the next admission resets.

On the card the decode is one captured CUDA graph (``capture=True``, the
default: ``serving/graphs.py::CapturedCall``), the counterpart of the
reference's ``jax.jit(decode_all, donate_argnums=(2,))``: its shapes are
fixed for the engine's life, the caches are written in place (the
donation), and only the (slots,) token and position vectors are copied in
before a replay.  The first decode step runs eagerly on a side stream and
is captured; its warm-up is that step's result.  ``capture=False``
dispatches the decode op by op.  On the CPU the decode runs plainly.
The greedy picks are made in the graph (``greedy_rows``); a sampled
request draws from its slot's logits row with ``sampling.sample_row``, the
reference's per-request oracle, so its stream depends only on its own
seed, as on ``EngineCore``.

``tap(req, logits_row)``, when set, sees each request's logits row before
its token is picked (the row is a device tensor, valid until the next
step).  ``prefill_ms`` ((prompt length, ms) per admission) and
``decode_ms`` (per decode step) are host times, each ending in the read of
a pick; each keeps the last ``TIMINGS_KEPT``.
"""
from __future__ import annotations

import collections
import functools
import time
import warnings
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import (DeviceLike, configure_matmul_precision,
                                resolve_device)
from repro_torch.models.api import Model, build_model
from repro_torch.serving.api import Request, RequestState
from repro_torch.serving.core import EngineCore, greedy_token
from repro_torch.serving.graphs import CapturedCall
from repro_torch.serving.sampling import (InvalidRequest, greedy_rows,
                                          sample_row, stop_hit,
                                          validate_stop_tokens)

__all__ = ["PagedServingEngine", "Request", "ServingEngine"]

TIMINGS_KEPT = 4096        # the newest host timings an engine keeps


class _EngineBase:
    """Request lifecycle of the slot-contiguous engine."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor], *,
                 slots: int, max_len: int, seed: int, device: DeviceLike):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_matmul_precision()
        for name, t in params.items():
            if t.device != self.device:
                raise ValueError(f"parameter {name!r} lives on {t.device}, "
                                 f"the engine on {self.device}")
        if cfg.family == "encdec":
            raise NotImplementedError(
                f"{cfg.name}: family 'encdec' — the slot engine prefills a "
                f"request from its tokens alone, and an encoder-decoder "
                f"needs its encoder's frames (the reference's ServingEngine "
                f"cannot serve it either); run Model.prefill / decode_step")
        self.cfg = cfg
        self.model = build_model(cfg)
        if self.model.decode_step is None:
            raise ValueError(f"{cfg.name}: encoder-only — no decode step")
        self.params = params
        self.slots = slots
        self.max_len = max_len
        del seed   # sampling keys are per request (SamplingParams.seed)
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int64)          # per-slot next index
        self.last_tok = np.zeros(slots, np.int64)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.tap: Optional[Callable[[Request, torch.Tensor], None]] = None

    # ------------------------------------------------------------------ API
    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise InvalidRequest("prompt", "empty prompt", uid=req.uid)
        if len(req.prompt) + req.max_new > self.max_len:
            raise InvalidRequest(
                "max_new", f"prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds max_len {self.max_len}", uid=req.uid)
        validate_stop_tokens(req.sampling, self.cfg.vocab_size, uid=req.uid)
        self.queue.append(req)

    # shared with EngineCore so both surfaces stay token-identical
    greedy_token = staticmethod(greedy_token)

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        """The request's token from its (V,) logits row: the greedy pick,
        else a draw through the in-step sampler's single-row oracle (same
        keys, same pipeline as ``EngineCore``)."""
        if self.tap is not None:
            self.tap(req, logits)
        if req.sampling.greedy:
            return self.greedy_token(logits)
        return sample_row(logits, req.sampling, len(req.tokens))

    def _commit(self, req: Request, tok: int) -> bool:
        """Append one sampled token; → True when the request is done
        (stop sequence / eos / max_new).  A completed stop match is
        truncated from the output before it ever surfaces."""
        req.tokens.append(int(tok))
        cut = stop_hit(req.tokens, req.sampling.stop)
        if cut is not None:
            del req.tokens[cut:]
            return True
        return self._should_finish(req, int(tok))

    def _finish(self, req: Request) -> None:
        req.done = True
        req.state = RequestState.FINISHED
        self.finished.append(req)

    @staticmethod
    def _should_finish(req: Request, tok: int) -> bool:
        """Completion predicate, shared so both engines stay token-identical."""
        return (len(req.tokens) >= req.max_new
                or (req.eos_id is not None and tok == req.eos_id))

    def step(self) -> int:
        raise NotImplementedError

    def run(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or any(a is not None for a in self.active)):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving did not drain")
        return self.finished


def _decode_all(model: Model, params, caches, toks, idx, logits,
                picks) -> torch.Tensor:
    """One decode step of every slot on the static buffers: the (slots,)
    tokens ``toks`` at positions ``idx`` → their logits into ``logits``,
    their greedy picks into ``picks`` (returned); the caches written in
    place."""
    lg, _ = model.decode_step(params, toks, caches, idx)
    logits.copy_(lg)
    return greedy_rows(lg, out=picks)


class ServingEngine(_EngineBase):
    """Slot-contiguous engine: each of B slots owns one batch row of every
    cache leaf (``max_len`` rows, or a ring of ``window`` rows).  Runs on
    ``cuda`` unless ``device`` says otherwise; ``capture`` runs the decode
    as one captured CUDA graph on the card (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor], *,
                 slots: int = 4, max_len: int = 256, seed: int = 0,
                 device: DeviceLike = None, capture: bool = True):
        super().__init__(cfg, params, slots=slots, max_len=max_len, seed=seed,
                         device=device)
        dev = self.device
        self.caches = self.model.init_cache(slots, max_len, device=dev)
        self.capture = capture
        self.captures = 0
        self.prefill_ms: Deque[Tuple[int, float]] = collections.deque(
            maxlen=TIMINGS_KEPT)
        self.decode_ms: Deque[float] = collections.deque(maxlen=TIMINGS_KEPT)
        self._toks = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._idx = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.logits = torch.zeros((slots, cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self._picks = torch.zeros((slots,), dtype=torch.int32, device=dev)
        # The decode closes over the model, weights, caches and buffers,
        # never over the engine, so dropping the engine frees its graph.
        self._decode = functools.partial(_decode_all, self.model, params,
                                         self.caches, self._toks, self._idx,
                                         self.logits, self._picks)
        self._graph: Optional[CapturedCall] = None

    def _slot_caches(self, slot: int) -> Dict[str, torch.Tensor]:
        """Slot ``slot``'s rows of every cache leaf: (layers, 1, …) views."""
        return {k: v[:, slot:slot + 1] for k, v in self.caches.items()}

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            lp = len(req.prompt)
            t0 = time.perf_counter()
            one = self._slot_caches(slot)
            for k, t in one.items():
                t.fill_(-1 if k == "ring_pos" else 0)
            tokens = torch.from_numpy(
                np.asarray(req.prompt, np.int32)[None]).to(self.device)
            logits, _ = self.model.prefill(self.params, {"tokens": tokens},
                                           one)
            tok = self._sample(logits[0], req)
            self.prefill_ms.append((lp, (time.perf_counter() - t0) * 1e3))
            # the prefill's own sample may already satisfy stop/eos/max_new
            if self._commit(req, tok):
                self._finish(req)
                continue
            req.state = RequestState.DECODE
            self.active[slot] = req
            self.pos[slot] = lp
            self.last_tok[slot] = tok

    def _decode_picks(self) -> torch.Tensor:
        """Stage the slots' tokens and positions, run the decode → the
        greedy picks (slots,) on the device."""
        self._toks.copy_(torch.from_numpy(self.last_tok.astype(np.int32)))
        self._idx.copy_(torch.from_numpy(self.pos.astype(np.int32)))
        if self._graph is not None:
            return self._graph.replay()
        if self.capture and not self.captures:
            self.captures += 1           # on the CPU, a plain run stands in
            if self.device.type == "cuda":
                self._graph = CapturedCall(self._decode, self.device)
                return self._picks
        return self._decode()

    def step(self) -> int:
        """Admit + decode one token for every active slot.  → #active."""
        self._admit()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0
        t0 = time.perf_counter()
        picks = self._decode_picks().cpu().numpy()
        for s in live:
            req = self.active[s]
            if req.sampling.greedy and self.tap is None:
                tok = int(picks[s])
            else:
                tok = self._sample(self.logits[s], req)
            done = self._commit(req, tok)
            self.pos[s] += 1
            self.last_tok[s] = tok
            if done:
                self._finish(req)
                self.active[s] = None           # recycle immediately
        self.decode_ms.append((time.perf_counter() - t0) * 1e3)
        return len(live)


class PagedServingEngine:
    """Deprecated shim: ``PagedServingEngine(...)`` ≡ ``EngineCore(...)``
    (the reference's, kept for its callers).

    ``slots`` maps to ``lanes``; ``submit`` / ``step`` / ``run`` and the
    introspection surface (``queue`` / ``active`` / ``finished`` / ``kv`` /
    ``pages_in_use`` / ``page_tables``) delegate to the core, which runs
    on the card unless ``device`` says otherwise.  Building one warns with
    a ``DeprecationWarning``."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor], *,
                 slots: int = 4, page_size: int = 16, num_pages: int = 64,
                 max_len: Optional[int] = None, seed: int = 0,
                 chunk_size: Optional[int] = None,
                 prefix_cache: bool = False, device: DeviceLike = None):
        warnings.warn(
            "PagedServingEngine is deprecated: build "
            "repro_torch.serving.EngineCore directly (same constructor, "
            "request-level step API)", DeprecationWarning, stacklevel=2)
        self.core = EngineCore(cfg, params, lanes=slots, page_size=page_size,
                               num_pages=num_pages, max_len=max_len,
                               seed=seed, chunk_size=chunk_size or page_size,
                               prefix_cache=prefix_cache, device=device)
        self.cfg = cfg
        self.slots = slots

    # delegated API ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.core.submit(req)

    def step(self) -> int:
        return self.core.step().lanes

    def run(self, max_steps: int = 10_000) -> List[Request]:
        return self.core.run(max_steps)

    # compat introspection --------------------------------------------------
    @property
    def kv(self):
        return self.core.kv

    @property
    def max_len(self) -> int:
        return self.core.max_len

    @property
    def finished(self) -> List[Request]:
        return self.core.finished

    @property
    def queue(self) -> List[Request]:
        return [r.req for r in self.core.scheduler.waiting]

    @property
    def active(self) -> List[Optional[Request]]:
        live: List[Optional[Request]] = [
            r.req for r in self.core.scheduler.running]
        return live + [None] * (self.slots - len(live))

    @property
    def page_tables(self) -> List[List[int]]:
        return self.core.page_tables

    @property
    def pages_in_use(self) -> int:
        return self.core.pages_in_use
