"""EngineCore: one ``step()`` drives every serving phase through the pool
(port of ``src/repro/serving/core.py``), in one of two packings:
``mode="ragged"`` (the default; below) or ``mode="padded"``, the
reference's equivalence oracle (at the end).

Each step the scheduler packs chunked prefill and decodes into one dense
``(T,)`` token stream (``RaggedBatch``), bucketed to a few widths; the
model's ragged step writes every token's KV rows into the page pool in
place, runs the q-block-tiled varlen paged attention (the CUDA kernel on
the card), gathers each lane's last row, unembeds it and picks each lane's
token on the device.  Only the (lanes,) picks come back to the host, which
commits them, advances cursors and retires finished requests.

Sampling runs on the device too (``serving/sampling.py``): each lane's
(temperature, top_k, top_p, seed, counter) ride in as five (lanes,)
arrays (``_sampling_inputs``), the draw's key is
``fold_in(PRNGKey(seed), #generated)`` of the request alone, so a sampled
stream does not change with batching, the prefix cache or preemption, and
temperature ≤ 0 lanes keep the greedy pick bit for bit.  A step in which
no sampling lane has a temperature > 0 skips the draw, decided on the
host from the requests' params (the reference's ``lax.cond``).

The step runs through ``StepGraphs`` (``serving/graphs.py``): on the card
one CUDA graph per (stream width, table width), captured on the key's
first step and replayed after — the port's counterpart of the reference's
``jax.jit`` of the step, counted by the same retrace sentinel
(``trace_count``, ``step_traces_total``).  ``capture=False`` runs the step
eagerly, op by op, as ``jax.disable_jit`` does for the reference: the
checks' eager arm, which runs the draw eagerly when a lane samples.  Every
step is recorded in ``obs``
(``ServingObservability``: the reference's registry, request spans, step
ring and profiler window); ``metrics=False`` makes every hook a no-op.

Shared-prefix reuse (``prefix_cache=True``): admission probes a radix
cache of page-aligned token blocks (``serving/prefix_cache.py``) and
grants the hit's resident pages; chunked prefill starts at the first cold
token, and a partial page is copy-on-written in place before the step
(``PagedKVCache.cow``).  Speculative decoding (``speculative=True``): a
host proposer (``serving/spec.py``) drafts up to ``spec_k`` tokens per
greedy decode lane, the drafted rows ride the same packed stream, the step
picks greedily at every drafted position through a (lanes, 1 + spec_k)
``last_idx``, and ``_finish`` commits the longest accepted prefix and
rolls the rest back through ``PagedKVCache.uncommit``.  Streams are
identical with either feature on or off.

The varlen attention's block shapes (``block_q``, and ``kv_split``, the
card kernel's pages per split) come from a ``KernelConfig``: the
``kernel_config=`` argument, else the tuner's table
(``kernels/autotune.py``) for (model, platform), resolved once at
construction and recorded in every step's ``StepOutput.kernel_config``.

The padded oracle (``mode="padded"``): each step runs one right-aligned
``(lanes, C)`` block (``Scheduler.schedule``, then
``models/lm.py::lm_prefill_chunk_paged``): per lane ``q_len`` live tokens
ending at row ``kv_len - 1``, dead rows left-padding, idle lanes at
``kv_len`` 0; C is 1 on a decode-only step and ``chunk_size`` whenever a
lane prefills, and the table width is bucketed to a power of two.  Its
attention is kernel #2's block entry on the card (one split pass and one
combine per layer per step).  The step comes back as (lanes, V) logits;
greedy lanes take ``greedy_rows`` and sampling lanes draw one row each
through ``sampling.sample_row`` (the in-step sampler on one row, #1 on
the card), so both modes share one sampling semantics.  It runs eagerly,
never captured (``capture`` is not read): an oracle, not a fast path.
``trace_count`` counts its distinct (C, table width) shapes, the
counterpart of the reference's ``jit`` traces.  Speculative decoding
needs the ragged step (``ValueError``, as in the reference).

Tensor-parallel serving (``mesh=N``): SPMD over the N ranks of a
``torch.distributed`` process group (``launch/mesh.py``; gloo, so N ranks
may share one card).  Every rank builds the same engine from the full,
replicated params and runs the same host scheduling — free heap,
refcounts, page tables, prefix cache and sampler seeds are identical on
every rank — but its pool holds only its band of the KV heads
(``PagedKVCache(heads=Hkv/N)``, ``parallel/sharding.py::pool_specs``).
Each layer of the ragged step slices its band of q/k/v, writes and
attends it, and rebuilds the head axis with one all-gather before
``wo`` (``layers.attn_apply_ragged``): HASTILY's reduce-and-gather, the
online-softmax reduce kept per head.  The gather only moves data, so
every rank's picks equal the single-device engine's.  ``mesh=None`` and
``mesh=1`` take the single-device path: no process group, no
collective.  The mesh step runs eagerly, op by op: gloo's collectives
are host calls, which a CUDA graph cannot capture, so ``capture`` is not
read and ``trace_count`` counts the distinct (stream width, table width)
keys, as the padded oracle counts its block shapes.
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
from repro_torch.kernels.autotune import KernelConfig, resolve_config
from repro_torch.launch.mesh import LAUNCH_HINT, Mesh, world_size
from repro_torch.models.api import build_model
from repro_torch.models.lm import (SSM_FAMILIES, lm_prefill_chunk_paged,
                                   lm_step_ragged, trunk_cache_init)
from repro_torch.parallel.collectives import TRAFFIC
from repro_torch.parallel.sharding import pool_specs, shardings_of
from repro_torch.serving.api import (Request, RequestState, StepOutput,
                                     UnsupportedCacheLayout)
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.paged import PagedKVCache
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.sampling import (InvalidRequest, greedy_rows,
                                          sample_row, stop_hit,
                                          validate_stop_tokens)
from repro_torch.serving.scheduler import LanePlan, RaggedBatch, Scheduler
from repro_torch.serving.spec import NGramProposer
from repro_torch.serving.tracing import ServingObservability


def greedy_token(logits) -> int:
    """Deterministic greedy pick of one (V,) logits row: the *lowest* index
    among joint maxima (``sampling.greedy_rows``), so exact ties break the
    same way on every engine and device.  The slot engine and
    ``EngineCore`` share it."""
    return int(greedy_rows(torch.as_tensor(logits)))


def greedy_tokens(logits) -> np.ndarray:
    """``greedy_token`` over leading axes, in numpy: (..., V) → (...,), the
    lowest index among each row's joint maxima (the reference's
    ``greedy_tokens``, the speculative verify rule's pick)."""
    lg = np.asarray(logits)
    hit = lg == lg.max(axis=-1, keepdims=True)
    return np.min(np.where(hit, np.arange(lg.shape[-1]), lg.shape[-1]),
                  axis=-1)


def _ragged_step(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 kv: PagedKVCache, kernel_config: KernelConfig, tokens, pos,
                 table, last_idx, cu, *, greedy: bool = False,
                 sampling=None, tp_axis=None) -> torch.Tensor:
    """One ragged step on device tensors → the ``last_idx`` rows' f32
    logits, or the picks, of ``last_idx``'s shape, with ``greedy`` (the
    greedy ones) or ``sampling`` (the sampler's); ``tp_axis``: this rank's
    head band of a mesh step."""
    return lm_step_ragged(cfg, params, tokens, kv.pool, table, pos, last_idx,
                          cu, kernel_config, greedy=greedy, sampling=sampling,
                          tp_axis=tp_axis)


def _padded_step(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 kv: PagedKVCache, tokens, table, kv_len,
                 q_len) -> torch.Tensor:
    """One padded block step on device tensors → the lanes' last-row f32
    logits (lanes, V); the pool is written in place."""
    return lm_prefill_chunk_paged(cfg, params, tokens, kv.pool, table, kv_len,
                                  q_len)[0]


class EngineCore:
    """Request-level serving engine: ``submit(Request)`` → repeated
    ``step()`` → finished requests accumulate in ``finished``; ``run()``
    drains everything.  Runs on ``cuda`` unless ``device`` says otherwise.

    ``mode`` is ``"ragged"`` (the packed stream, captured on the card
    unless ``capture=False``) or ``"padded"`` (the (lanes, C) block
    oracle, eager).  ``kernel_config`` pins the varlen attention's block
    shapes; by default the engine resolves them once, here, from the
    tuner's table for (``cfg.name``, the device's platform: ``cpu`` |
    ``cuda``), as the reference does (the padded block reads none of them:
    its kernel runs at its default split).  ``seed`` is accepted and
    ignored, as the reference ignores it: seeds are per request
    (``SamplingParams.seed``).  ``mesh`` is ``None`` / ``1`` (one
    device), an int N > 1 (the "model" axis over the N ranks of the
    initialised default group) or a ``launch/mesh.py::Mesh`` with a
    "model" axis; every rank constructs and drives the engine alike
    (module docstring).
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor], *,
                 lanes: int = 4, page_size: int = 16, num_pages: int = 64,
                 chunk_size: int = 16, max_len: Optional[int] = None,
                 step_tokens: Optional[int] = None, mode: str = "ragged",
                 token_buckets: Optional[Sequence[int]] = None,
                 prefix_cache: bool = False,
                 cache_pages: Optional[int] = None, seed: int = 0,
                 speculative: bool = False, spec_k: int = 4, proposer=None,
                 kernel_config: Optional[KernelConfig] = None,
                 mesh=None, device: DeviceLike = None, metrics: bool = True,
                 registry=None, trace_ring: int = 512, capture: bool = True):
        if mode not in ("ragged", "padded"):
            raise ValueError(f"unknown EngineCore mode {mode!r}; "
                             f"expected 'ragged' or 'padded'")
        self.mesh = self._resolve_mesh(mesh)
        n = self.mesh_size
        if self.mesh is not None:
            if mode != "ragged":
                raise ValueError("mesh > 1 requires mode='ragged' (the "
                                 "padded oracle step is single-device)")
            if cfg.num_heads % n or cfg.num_kv_heads % n:
                raise ValueError(
                    f"mesh of {n} ranks must divide num_heads="
                    f"{cfg.num_heads} and num_kv_heads={cfg.num_kv_heads}")
        self.tp_axis = None if self.mesh is None else self.mesh.axis("model")
        if speculative and mode != "ragged":
            # The verify step is the ragged step (drafted rows ride the
            # packed stream); the padded block extracts last-row logits
            # only and has no lane room for 1 + k chunks.
            raise ValueError("speculative decoding requires mode='ragged'")
        if speculative and spec_k < 1:
            raise ValueError(f"speculative decoding needs spec_k >= 1, "
                             f"got {spec_k}")
        if (build_model(cfg).step_ragged is None
                and cfg.family not in SSM_FAMILIES):
            # the reference's words and kind; the SSM families reach the
            # pool's own refusal (``ssm_state``), as they do there
            raise UnsupportedCacheLayout(
                "no_paged_step", cfg.name,
                f"the {cfg.family} family exposes no paged chunk step")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_matmul_precision()
        for name, t in params.items():
            if t.device != self.device:
                raise ValueError(f"parameter {name!r} lives on {t.device}, "
                                 f"the engine on {self.device}")
        self.cfg = cfg
        self.mode = mode
        self.params = params
        self.lanes = lanes
        self.chunk_size = chunk_size
        self.max_len = max_len or num_pages * page_size
        # One observability bundle for the whole stack (serving/tracing.py);
        # ``registry=`` lets several engines share one.
        self.obs = ServingObservability(enabled=metrics, registry=registry,
                                        ring_capacity=trace_ring)
        # A rank's pool is its block of the whole pool under the sharding
        # rules: the KV heads (dim 2) split over "model", page ids whole.
        self.pool_specs, heads = None, None
        if self.mesh is not None:
            whole = trunk_cache_init(cfg, num_pages + 1, page_size, "meta")
            self.pool_specs = pool_specs(whole, self.mesh)
            _, count = shardings_of(self.pool_specs, self.mesh)["k"][2]
            heads = cfg.num_kv_heads // count
        self.kv = PagedKVCache(cfg, num_pages, page_size, device=self.device,
                               obs=self.obs, heads=heads)
        self.prefix_cache = (RadixPrefixCache(self.kv, max_pages=cache_pages,
                                              obs=self.obs)
                             if prefix_cache else None)
        self.speculative = speculative
        self.spec_k = spec_k if speculative else 0
        self.proposer = ((proposer if proposer is not None
                          else NGramProposer(obs=self.obs))
                         if speculative else None)
        self.scheduler = Scheduler(self.kv, lanes=lanes, chunk_size=chunk_size,
                                   step_tokens=step_tokens,
                                   token_buckets=token_buckets,
                                   prefix_cache=self.prefix_cache,
                                   spec_k=self.spec_k, proposer=self.proposer,
                                   obs=self.obs)
        self.finished: List[Request] = []
        self.drafted_total = 0          # speculative accounting, lifetime
        self.accepted_total = 0
        self.spec_steps = 0             # steps that carried >= 1 draft
        self.capture = capture
        del seed   # per-request (SamplingParams.seed), as in the reference
        # Static for the engine's lifetime: every captured (T, P) key bakes
        # in its block_q and kv_split, and no two engines share a graph or
        # a graph pool (each StepGraphs owns its pool), so another config
        # means another engine.
        self.kernel_config = (kernel_config if kernel_config is not None
                              else resolve_config(cfg.name, self.device.type))
        # The step closes over the config, weights and pool, never over the
        # engine: an engine holds no reference cycle, so dropping it frees
        # its pool and graphs at once.
        self._shapes = set()        # eager steps' (C | T, table width) keys
        if mode == "padded":
            self._step = functools.partial(_padded_step, cfg, params, self.kv)
            self.graphs = None
        elif self.mesh is not None:
            self._step = functools.partial(_ragged_step, cfg, params, self.kv,
                                           self.kernel_config,
                                           tp_axis=self.tp_axis)
            self.graphs = None
        else:
            self._step = functools.partial(_ragged_step, cfg, params, self.kv,
                                           self.kernel_config)
            self.graphs = StepGraphs(
                self._step, lanes=lanes, vocab=cfg.vocab_size,
                device=self.device,
                verify_rows=self.spec_k + 1 if speculative else None,
                on_capture=self.obs.step_traced)
        self.obs.g_mesh.set(self.mesh_size)
        self.obs.g_coll_per_tok.set(self.collective_bytes_per_token)

    @staticmethod
    def _resolve_mesh(mesh):
        """Normalise ``mesh``: None / 1 / a one-rank Mesh → None (the
        single-device path); an int N > 1 → a ("model",) mesh over the
        default group, which must hold exactly N ranks; a port ``Mesh``
        with a "model" axis passes through."""
        if mesh is None:
            return None
        if isinstance(mesh, int):
            if mesh <= 1:
                return None
            n = world_size()
            if n != mesh:
                raise ValueError(
                    f"mesh of {mesh} ranks requested but only {n} in the "
                    f"default process group: {LAUNCH_HINT}")
            return Mesh((mesh,), ("model",))
        if "model" not in mesh.axis_names:
            raise ValueError(f"serving mesh needs a 'model' axis, got "
                             f"{mesh.axis_names}")
        return mesh if mesh.size > 1 else None

    @property
    def trace_count(self) -> int:
        """The reference's count of jit traces: step captures (ragged),
        or the distinct (T, table width) keys of the eager mesh step, or
        the distinct (C, table width) block shapes (padded)."""
        if self.graphs is None:
            return len(self._shapes)
        return self.graphs.captures

    # ------------------------------------------------------------------ API
    def validate(self, req: Request) -> None:
        """Budget vs ``max_len``, empty prompt, stop ids vs the vocab."""
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
        """Schedule → one model step in the engine's packing (ragged
        stream / padded block) → commit/finish, recorded in ``obs``."""
        self.obs.step_begin()
        t0 = time.perf_counter()
        out = (self._step_ragged() if self.mode == "ragged"
               else self._step_padded())
        s = self.scheduler
        self.obs.record_step(
            out, dur_ms=(time.perf_counter() - t0) * 1e3, sched=s,
            kv=self.kv, cache=self.prefix_cache, table_pages=s._table_pages,
            trimmed_prefill=s.trimmed_prefill_step,
            trimmed_drafts=s.trimmed_draft_step, width=out.padded_rows)
        return out

    def _step_ragged(self) -> StepOutput:
        return self._run_stream(*self.scheduler.schedule_ragged())

    def _step_padded(self) -> StepOutput:
        """The right-aligned (lanes, C) block step (the oracle mode)."""
        return self._run_block(*self.scheduler.schedule())

    def _block_arrays(self, plans: List[LanePlan]) -> Dict[str, np.ndarray]:
        """The padded step's host inputs for ``plans``: ``tokens`` (lanes,
        C) right-aligned, ``table`` (lanes, P) scratch-filled, ``kv_len``
        and ``q_len`` (lanes,), idle lanes at 0.  C is 1 when every lane
        decodes one row, else ``chunk_size``; P the longest table rounded
        up to a power of two (the reference's retrace bucketing)."""
        c = 1 if all(p.q_len == 1 for p in plans) else self.chunk_size
        width = max(len(p.run.pages) for p in plans)
        width = 1 << max(width - 1, 0).bit_length()
        b = self.lanes
        tokens = np.zeros((b, c), np.int32)
        kv_len = np.zeros((b,), np.int32)
        q_len = np.zeros((b,), np.int32)
        table = np.full((b, width), self.kv.scratch, np.int32)
        for i, p in enumerate(plans):
            tokens[i, c - p.q_len:] = p.stream_tokens()
            kv_len[i] = p.run.rows + p.q_len
            q_len[i] = p.q_len
            table[i, :len(p.run.pages)] = p.run.pages
        return dict(tokens=tokens, table=table, kv_len=kv_len, q_len=q_len)

    def _run_block(self, plans: List[LanePlan], preempted) -> StepOutput:
        """Execute lane plans as one right-aligned (lanes, C) block,
        eagerly; a new (C, table width) shape counts as a trace."""
        if not plans:
            return StepOutput(
                tokens={}, finished=(), preempted=preempted, lanes=0,
                prefill_tokens=0, decode_tokens=0,
                prefix_hit_tokens=self.scheduler.prefix_hit_tokens_step)
        arrays = self._block_arrays(plans)
        self._count_shape(arrays["tokens"].shape[1], arrays["table"].shape[1])
        logits = self._step(**{k: torch.from_numpy(v).to(self.device)
                               for k, v in arrays.items()})
        return self._finish(plans, preempted, logits=logits,
                            live=sum(p.q_len for p in plans),
                            padded=arrays["tokens"].size)

    def _count_shape(self, width: int, table_width: int) -> None:
        """An eager step's key: a new one counts as a trace."""
        if (width, table_width) not in self._shapes:
            self._shapes.add((width, table_width))
            self.obs.step_traced()

    def step_arrays(self, batch: RaggedBatch) -> Dict[str, np.ndarray]:
        """The step function's host inputs for ``batch``: its packed
        ``tokens``, ``pos`` and ``table``, and two static-shape arrays."""
        # Stream index of each plan's final token; idle tail lanes point at
        # row 0 (their pick is computed and never read).  A speculative
        # engine always passes (lanes, 1 + spec_k): row j of lane i is the
        # lane's decode row plus its j-th draft, clamped to its last draft,
        # so a step's draft count never changes a shape.
        if self.speculative:
            last_idx = np.zeros((self.lanes, self.spec_k + 1), np.int32)
            ramp = np.arange(self.spec_k + 1, dtype=np.int32)
            for i, p in enumerate(batch.plans):
                d = len(p.drafts)
                base = int(batch.cu_seqlens[i + 1]) - 1 - d
                last_idx[i] = base + np.minimum(ramp, d)
        else:
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
            return StepOutput(
                tokens={}, finished=(), preempted=preempted, lanes=0,
                prefill_tokens=0, decode_tokens=0,
                prefix_hit_tokens=self.scheduler.prefix_hit_tokens_step)
        arrays = self.step_arrays(batch)
        sampling = self._sampling_inputs(plans)
        if self.graphs is None:
            self._count_shape(batch.width, arrays["table"].shape[1])
        if self.capture and self.graphs is not None:
            picks = self.graphs.run(**arrays, sampling=sampling)
        else:
            dev = lambda a: {k: torch.from_numpy(v).to(self.device)  # noqa: E731
                             for k, v in a.items()}
            picks = self._step(**dev(arrays), greedy=True,
                               sampling=sampling and dev(sampling))
        return self._finish(plans, preempted, picks=picks.cpu().numpy(),
                            live=batch.live, padded=batch.width)

    def _sampling_inputs(self, plans) -> Optional[Dict[str, np.ndarray]]:
        """Per-lane sampling arrays for the in-step draw, all (lanes,), or
        None when no lane samples a token with a temperature > 0 this step
        (the draw is skipped).  Idle tail lanes get temperature 0;
        ``counter`` is the request's generated-token count, which with
        ``seed`` fixes the lane's key."""
        if all(not p.sample or p.run.req.sampling.greedy for p in plans):
            return None
        n = self.lanes
        temp = np.zeros((n,), np.float32)
        top_k = np.zeros((n,), np.int32)       # 0 = off
        top_p = np.ones((n,), np.float32)      # 1 = off
        seed = np.zeros((n,), np.int64)        # uint32 values
        counter = np.zeros((n,), np.int64)
        for i, p in enumerate(plans):
            sp = p.run.req.sampling
            temp[i] = max(sp.temperature, 0.0)
            top_k[i] = sp.top_k or 0
            top_p[i] = 1.0 if sp.top_p is None else sp.top_p
            seed[i] = sp.seed or 0
            counter[i] = len(p.run.req.tokens)
        return dict(temperature=temp, top_k=top_k, top_p=top_p, seed=seed,
                    counter=counter)

    def _finish(self, plans, preempted, *, live: int, padded: int,
                picks: Optional[np.ndarray] = None,
                logits: Optional[torch.Tensor] = None) -> StepOutput:
        """Advance cursors, commit or verify each sampling lane's tokens,
        check stop sequences / eos / max_new after every committed token,
        retire finished requests.

        The ragged step hands back ``picks``, drawn on the device, (lanes,)
        or (lanes, 1 + k); the padded block its (lanes, V) ``logits``:
        greedy lanes take ``greedy_rows`` (one transfer for the step) and
        each sampling lane draws its row through ``sample_row``.

        A drafting lane streamed ``1 + d`` rows; its picks ``g[0..d]`` are
        the greedy tokens at every drafted position, and it commits
        ``g[0..acc]``, ``acc`` the longest prefix with ``g[j] ==
        drafts[j]``: the tokens sequential greedy decode would produce.
        The cursor advances by ``base + committed − 1`` (the last committed
        token's row is next step's write) and ``uncommit`` returns every
        page that holds only rejected rows."""
        out_tokens = {}
        finished = []
        n_prefill = sum(p.q_len for p in plans
                        if p.run.req.state is RequestState.PREFILL)
        n_decode = sum(1 for p in plans
                       if p.run.req.state is RequestState.DECODE)
        drafted = sum(len(p.drafts) for p in plans)
        accepted = 0
        if logits is not None:
            greedy = greedy_rows(logits).cpu().numpy()
        for i, p in enumerate(plans):
            run, req = p.run, p.run.req
            if not p.sample:
                run.rows += p.q_len
                continue
            base = p.q_len - len(p.drafts)
            if p.drafts:
                g = picks[i, :len(p.drafts) + 1]
                acc = 0
                while acc < len(p.drafts) and int(g[acc]) == p.drafts[acc]:
                    acc += 1
                commit = [int(t) for t in g[:acc + 1]]
            elif picks is not None:
                commit = [int(picks[i, 0] if picks.ndim == 2 else picks[i])]
            elif req.sampling.greedy:
                commit = [int(greedy[i])]
            else:
                commit = [sample_row(logits[i], req.sampling,
                                     len(req.tokens))]
            done = stopped = False
            n = 0
            start = len(req.tokens)
            for tok in commit:        # eos / max_new / stop can cut it short
                req.tokens.append(tok)
                out_tokens[req.uid] = tok
                n += 1
                cut = stop_hit(req.tokens, req.sampling.stop)
                if cut is not None:
                    del req.tokens[cut:]     # the match never surfaces
                    done = stopped = True
                    break
                if (len(req.tokens) >= req.max_new
                        or (req.eos_id is not None and tok == req.eos_id)):
                    done = True
                    break
            run.rows += base + n - 1
            if stopped:
                # The cut may swallow earlier tokens: report the last
                # survivor of this step, or nothing, and clamp the cursor to
                # the surviving known tokens.
                if len(req.tokens) > start:
                    out_tokens[req.uid] = req.tokens[-1]
                else:
                    out_tokens.pop(req.uid, None)
                run.rows = min(run.rows, run.known())
            self.obs.tokens_committed(req.uid, n, first=(start == 0))
            if p.drafts:
                accepted += n - 1
                self.obs.spec_verify(req.uid, len(p.drafts), n - 1)
                run.pages = self.kv.uncommit(run.pages, run.rows)
            if done:
                req.done = True
                finished.append(req.uid)
                self.finished.append(req)
                if self.proposer is not None and \
                        hasattr(self.proposer, "observe"):
                    self.proposer.observe(req.known_tokens())
                self.scheduler.finish(run)
        self.drafted_total += drafted
        self.accepted_total += accepted
        if drafted:
            self.spec_steps += 1
        return StepOutput(tokens=out_tokens, finished=tuple(finished),
                          preempted=preempted, lanes=len(plans),
                          prefill_tokens=n_prefill, decode_tokens=n_decode,
                          live_rows=live, padded_rows=padded,
                          prefix_hit_tokens=(
                              self.scheduler.prefix_hit_tokens_step),
                          drafted_tokens=drafted, accepted_tokens=accepted,
                          kernel_config=(self.kernel_config.describe()
                                         if self.mode == "ragged" else None))

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
        return self.kv.num_pages - self.kv.free_pages

    @property
    def mesh_size(self) -> int:
        """Ranks on the serving mesh's model axis (1 = single-device)."""
        return 1 if self.mesh is None else int(self.mesh.shape["model"])

    @property
    def collective_bytes_per_token(self) -> int:
        """Per-rank bytes *received* by the step's collectives for each
        token row streamed, by the reference's formula: one head
        all-gather per attention layer, ``Hq · Dh · 4 · (N−1)/N`` each — the
        reference gathers the f32 pre-``wo`` attention output.  0
        off-mesh.  The port gathers what its single-device path feeds
        ``wo``, the attention output in the model's dtype, so on a bf16
        model :meth:`measure_collective_bytes` reads half of this × width
        (the real bytes)."""
        n = self.mesh_size
        if n == 1:
            return 0
        per_layer = self.cfg.num_heads * self.cfg.d_head * 4
        return self.cfg.num_layers * per_layer * (n - 1) // n

    def measure_collective_bytes(self, width: Optional[int] = None) -> int:
        """*Measured* per-rank collective bytes of one ragged step at
        stream width ``width`` (default: the widest token bucket) and the
        current table-width high-water mark: the bytes this rank received
        through the all-gather wrapper (``parallel/collectives.py``)
        while the step ran.  The reference walks the compiled HLO; the port
        runs the step — every rank must call this together — on dead rows
        whose all-scratch table writes only the scratch page.  Publishes
        the ``collective_bytes_per_step`` gauge; 0 off-mesh.  Equals
        ``collective_bytes_per_token × width`` where the model's dtype is
        f32 (every packed row, live or dead, runs every layer's gather)."""
        if self.mesh is None:
            self.obs.g_coll_per_step.set(0)
            return 0
        t = int(width or self.scheduler.token_buckets[-1])
        lanes = self.lanes
        cu = np.full((lanes + 2,), t, np.int32)
        cu[0] = 0
        last_idx = (np.zeros((lanes, self.spec_k + 1), np.int32)
                    if self.speculative else np.zeros((lanes,), np.int32))
        arrays = dict(
            tokens=np.zeros((t,), np.int32), pos=np.zeros((t,), np.int32),
            table=np.full((t, self.scheduler._table_pages), self.kv.scratch,
                          np.int32),
            last_idx=last_idx, cu=cu)
        before = TRAFFIC["all_gather_bytes"]
        self._step(**{k: torch.from_numpy(v).to(self.device)
                      for k, v in arrays.items()}, greedy=True)
        total = TRAFFIC["all_gather_bytes"] - before
        self.obs.g_coll_per_step.set(total)
        return total

    @property
    def prefix_stats(self) -> dict:
        """Prefix-cache telemetry (empty when the cache is off)."""
        return self.prefix_cache.stats() if self.prefix_cache else {}

    @property
    def spec_stats(self) -> dict:
        """Speculative-decoding telemetry (empty when not drafting):
        ``acceptance`` is accepted / drafted, ``accepted_per_spec_step`` the
        extra tokens each drafting step committed."""
        if not self.speculative:
            return {}
        return {
            "drafted_tokens": self.drafted_total,
            "accepted_tokens": self.accepted_total,
            "spec_steps": self.spec_steps,
            "acceptance": (self.accepted_total / self.drafted_total
                           if self.drafted_total else 0.0),
            "accepted_per_spec_step": (self.accepted_total / self.spec_steps
                                       if self.spec_steps else 0.0),
        }

    @property
    def page_tables(self) -> List[List[int]]:
        """Live page table per resident request (scheduler ticket order)."""
        return [list(r.pages) for r in self.scheduler.running]
