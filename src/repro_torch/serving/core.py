"""EngineCore: one ``step()`` drives every serving phase through the pool
(port of ``src/repro/serving/core.py``, ragged mode).

Each step the scheduler packs chunked prefill and decodes into one dense
``(T,)`` token stream (``RaggedBatch``), bucketed to a few widths; the
model's ragged step writes every token's KV rows into the page pool in
place, runs the q-block-tiled varlen paged attention (the CUDA kernel on
the card), gathers each lane's last row, unembeds it and picks the greedy
token on the device.  Only the (lanes,) picks come back to the host, which
commits them, advances cursors and retires finished requests.

The step runs through ``StepGraphs`` (``serving/graphs.py``): on the card
one CUDA graph per (stream width, table width), captured on the key's
first step and replayed after — the port's counterpart of the reference's
``jax.jit`` of the step, counted by the same retrace sentinel
(``trace_count``, ``step_traces_total``).  ``capture=False`` runs the step
eagerly, op by op, as ``jax.disable_jit`` does for the reference: the
checks' eager arm.  Every step is recorded in ``obs``
(``ServingObservability``: the reference's registry, request spans, step
ring and profiler window); ``metrics=False`` makes every hook a no-op.

Later slices of the port bring the rest of the reference engine: seeded
sampling (``temperature > 0``), speculative decoding, the prefix cache,
tensor-parallel meshes and the padded oracle mode; asking for any of them
raises ``NotImplementedError`` here.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, configure_matmul_precision, resolve_device
from repro_torch.kernels.paged_attention.varlen import validate_cu_seqlens
from repro_torch.models.lm import KERNEL_CONFIG, lm_step_ragged
from repro_torch.serving.api import Request, RequestState, StepOutput
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.paged import PagedKVCache
from repro_torch.serving.sampling import (InvalidRequest, stop_hit,
                                          validate_stop_tokens)
from repro_torch.serving.scheduler import RaggedBatch, Scheduler
from repro_torch.serving.tracing import ServingObservability


def _ragged_step(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 kv: PagedKVCache, tokens, pos, table, last_idx,
                 cu) -> torch.Tensor:
    """One ragged step on device tensors → the (lanes,) greedy picks."""
    return lm_step_ragged(cfg, params, tokens, kv.pool, table, pos, last_idx,
                          cu, KERNEL_CONFIG, greedy=True)


def _later(feature: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet: it lands with the {slice_name} slice "
        f"of the PyTorch port (see ROADMAP.md)")


class EngineCore:
    """Request-level serving engine: ``submit(Request)`` → repeated
    ``step()`` → finished requests accumulate in ``finished``; ``run()``
    drains everything.  Runs on ``cuda`` unless ``device`` says otherwise.
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor], *,
                 lanes: int = 4, page_size: int = 16, num_pages: int = 64,
                 chunk_size: int = 16, max_len: Optional[int] = None,
                 step_tokens: Optional[int] = None, mode: str = "ragged",
                 token_buckets: Optional[Sequence[int]] = None,
                 prefix_cache: bool = False, speculative: bool = False,
                 mesh=None, device: DeviceLike = None, metrics: bool = True,
                 registry=None, trace_ring: int = 512, capture: bool = True):
        if mode == "padded":
            raise _later("mode='padded' (the padded-block oracle)",
                         "other-families and contiguous-path")
        if mode != "ragged":
            raise ValueError(f"unknown EngineCore mode {mode!r}")
        if prefix_cache:
            raise _later("prefix_cache", "prefix-cache and copy-on-write")
        if speculative:
            raise _later("speculative decoding", "speculative-decoding")
        if mesh not in (None, 1):
            raise _later("a tensor-parallel mesh", "TP-serving")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_matmul_precision()
        for name, t in params.items():
            if t.device != self.device:
                raise ValueError(f"parameter {name!r} lives on {t.device}, "
                                 f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.lanes = lanes
        self.max_len = max_len or num_pages * page_size
        # One observability bundle for the whole stack (serving/tracing.py);
        # ``registry=`` lets several engines share one.
        self.obs = ServingObservability(enabled=metrics, registry=registry,
                                        ring_capacity=trace_ring)
        self.kv = PagedKVCache(cfg, num_pages, page_size, device=self.device,
                               obs=self.obs)
        self.scheduler = Scheduler(self.kv, lanes=lanes, chunk_size=chunk_size,
                                   step_tokens=step_tokens,
                                   token_buckets=token_buckets, obs=self.obs)
        self.finished: List[Request] = []
        self.capture = capture
        # The step closes over the config, weights and pool, never over the
        # engine: an engine holds no reference cycle, so dropping it frees
        # its pool and graphs at once.
        self._step = functools.partial(_ragged_step, cfg, params, self.kv)
        self.graphs = StepGraphs(self._step, lanes=lanes, device=self.device,
                                 on_capture=self.obs.step_traced)
        self.obs.g_mesh.set(1)
        self.obs.g_coll_per_tok.set(0)

    @property
    def trace_count(self) -> int:
        """Step captures so far: the reference's count of jit traces."""
        return self.graphs.captures

    # ------------------------------------------------------------------ API
    def validate(self, req: Request) -> None:
        """Budget vs ``max_len``, empty prompt, stop ids vs the vocab; a
        sampled request (temperature > 0) is a later slice."""
        if not req.sampling.greedy:
            raise _later("temperature > 0 sampling", "seeded-sampling")
        if len(req.prompt) + req.max_new > self.max_len:
            raise InvalidRequest(
                "max_new", f"prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds max_len {self.max_len}", uid=req.uid)
        if len(req.prompt) == 0:
            raise InvalidRequest("prompt", "empty prompt", uid=req.uid)
        validate_stop_tokens(req.sampling, self.cfg.vocab_size, uid=req.uid)

    def submit(self, req: Request) -> None:
        self.validate(req)
        self.scheduler.submit(req)

    def abort(self, uid: int) -> bool:
        """Cancel a request; a running one releases its lane and pages now."""
        return self.scheduler.abort(uid)

    def step(self) -> StepOutput:
        """Schedule → one packed model step → commit/finish, recorded in
        ``obs``."""
        self.obs.step_begin()
        t0 = time.perf_counter()
        out = self._step_ragged()
        s = self.scheduler
        self.obs.record_step(
            out, dur_ms=(time.perf_counter() - t0) * 1e3, sched=s,
            kv=self.kv, table_pages=s._table_pages,
            trimmed_prefill=s.trimmed_prefill_step, width=out.padded_rows)
        return out

    def _step_ragged(self) -> StepOutput:
        s = self.scheduler
        batch, preempted = s.batch_for(s.begin_step())
        return self._run_stream(batch, preempted)

    def step_arrays(self, batch: RaggedBatch) -> Dict[str, np.ndarray]:
        """The step function's host inputs for ``batch``: its packed
        ``tokens``, ``pos`` and ``table``, and two static-shape arrays."""
        # Stream index of each plan's final token; idle tail lanes point at
        # row 0 (their pick is computed and never read).
        last_idx = np.zeros((self.lanes,), np.int32)
        last_idx[:len(batch.plans)] = batch.cu_seqlens[1:] - 1
        # Lane boundaries, static (lanes + 2,) shape: the plans' boundaries,
        # the dead padding rows as one trailing pseudo-segment ending at T,
        # then zero-width repeats.  Validated here, on the host copy.
        cu = np.full((self.lanes + 2,), batch.width, np.int32)
        cu[:len(batch.cu_seqlens)] = batch.cu_seqlens
        validate_cu_seqlens(cu, batch.width)
        return dict(tokens=batch.tokens, pos=batch.pos, table=batch.table,
                    last_idx=last_idx, cu=cu)

    def _run_stream(self, batch: RaggedBatch, preempted) -> StepOutput:
        """Execute a RaggedBatch as one packed token stream."""
        plans = batch.plans
        if not plans:
            return StepOutput(tokens={}, finished=(), preempted=preempted,
                              lanes=0, prefill_tokens=0, decode_tokens=0)
        arrays = self.step_arrays(batch)
        if self.capture:
            picks = self.graphs.run(**arrays)
        else:
            picks = self._step(**{k: torch.from_numpy(a).to(self.device)
                                  for k, a in arrays.items()})
        return self._finish(plans, preempted, picks=picks.cpu().numpy(),
                            live=batch.live, padded=batch.width)

    def _finish(self, plans, preempted, *, picks: np.ndarray, live: int,
                padded: int) -> StepOutput:
        """Advance cursors, commit each sampling lane's token, check stop
        sequences / eos / max_new, retire finished requests."""
        out_tokens = {}
        finished = []
        n_prefill = sum(p.q_len for p in plans
                        if p.run.req.state is RequestState.PREFILL)
        n_decode = sum(1 for p in plans
                       if p.run.req.state is RequestState.DECODE)
        for i, p in enumerate(plans):
            run, req = p.run, p.run.req
            sample = p.sample
            run.rows += p.q_len
            if not sample:
                continue
            tok = int(picks[i])
            start = len(req.tokens)
            req.tokens.append(tok)
            out_tokens[req.uid] = tok
            self.obs.tokens_committed(req.uid, 1, first=(start == 0))
            done = False
            cut = stop_hit(req.tokens, req.sampling.stop)
            if cut is not None:
                # The match never surfaces; it may swallow earlier tokens,
                # so report the last survivor of this step, or nothing, and
                # clamp the cursor to the surviving known tokens.
                del req.tokens[cut:]
                done = True
                if len(req.tokens) > start:
                    out_tokens[req.uid] = req.tokens[-1]
                else:
                    out_tokens.pop(req.uid, None)
                run.rows = min(run.rows, run.known())
            elif (len(req.tokens) >= req.max_new
                  or (req.eos_id is not None and tok == req.eos_id)):
                done = True
            if done:
                req.done = True
                finished.append(req.uid)
                self.finished.append(req)
                self.scheduler.finish(run)
        return StepOutput(tokens=out_tokens, finished=tuple(finished),
                          preempted=preempted, lanes=len(plans),
                          prefill_tokens=n_prefill, decode_tokens=n_decode,
                          live_rows=live, padded_rows=padded)

    def run(self, max_steps: int = 100_000) -> List[Request]:
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving did not drain")
        return self.finished

    # -------------------------------------------------------- introspection
    @property
    def pages_in_use(self) -> int:
        return self.kv.num_pages - len(self.kv.free)
