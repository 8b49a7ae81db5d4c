"""Continuous-batching scheduler: requests → one packed token stream per
step (port of ``src/repro/serving/scheduler.py``, numpy only).

A request is a cursor (``rows``) into its known tokens (prompt ⊕
generated).  Each step a resident request streams the next
``q_len = min(chunk, remaining, budget)`` tokens; it samples exactly when
the cursor reaches the end of its known tokens.  Policy, as in the
reference:

- FCFS admission against the page pool (known tokens + one decode row);
- token-budget fairness: decode lanes first, then prefill chunks oldest
  first, ``step_tokens`` per step;
- preemption by eviction: when the pool runs dry the youngest resident is
  evicted, its cursor rewinds to zero and it re-queues by its ticket;
- the packed stream is bucketed to a few widths, prefill chunk tails
  trimmed (youngest first) so live work lands on a bucket edge, and the
  page-table width is held at its high-water mark.

Every lifecycle event goes to ``obs`` (the engine's
``ServingObservability``) at the reference's points: submitted, finished,
aborted, preempted and admitted (or resumed).

The prefix-cache and speculative-draft branches of the reference belong to
later slices.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.api import Request, RequestState
from repro_torch.serving.paged import PagedKVCache
from repro_torch.serving.sampling import InvalidRequest
from repro_torch.serving.tracing import ServingObservability


def default_token_buckets(max_tokens: int) -> Tuple[int, ...]:
    """Stream widths {2^k} ∪ {3·2^(k-1)} up to (and one past) ``max_tokens``."""
    ws = {1}
    w = 1
    while w < max_tokens:
        w *= 2
        ws.add(w)
        ws.add(w + w // 2)
    return tuple(sorted(ws))


@dataclasses.dataclass(eq=False)
class RunningRequest:
    """A resident request: its pages and cursor (identity equality)."""
    req: Request
    ticket: int
    pages: List[int] = dataclasses.field(default_factory=list)
    rows: int = 0                     # KV rows already resident

    def known(self) -> int:
        return len(self.req.prompt) + len(self.req.tokens)

    def remaining(self) -> int:
        return self.known() - self.rows

    def next_tokens(self, n: int) -> np.ndarray:
        """The next ``n`` known tokens from the cursor."""
        lp = len(self.req.prompt)
        head = np.asarray(self.req.prompt[self.rows:self.rows + n], np.int32)
        need = n - len(head)
        if need <= 0:
            return head
        off = max(0, self.rows - lp)
        tail = np.asarray(self.req.tokens[off:off + need], np.int32)
        return np.concatenate([head, tail]) if len(head) else tail


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """One lane of one step: stream ``q_len`` tokens of ``run``'s cursor."""
    run: RunningRequest
    q_len: int

    @property
    def sample(self) -> bool:
        return self.run.rows + self.q_len == self.run.known()

    def stream_tokens(self) -> np.ndarray:
        return self.run.next_tokens(self.q_len)


@dataclasses.dataclass(frozen=True)
class RaggedBatch:
    """One step's plans packed into a dense token stream.  Rows past
    ``live`` are dead bucket padding: token 0, position 0, lane −1, an
    all-scratch table row."""
    plans: List[LanePlan]
    tokens: np.ndarray        # (width,) int32
    pos: np.ndarray           # (width,) int32
    lane_id: np.ndarray       # (width,) int32; −1 dead
    table: np.ndarray         # (width, P) int32
    cu_seqlens: np.ndarray    # (len(plans)+1,) int32
    live: int
    width: int


class Scheduler:
    def __init__(self, kv: PagedKVCache, *, lanes: int = 4,
                 chunk_size: int = 16, step_tokens: Optional[int] = None,
                 token_buckets: Optional[Sequence[int]] = None, obs=None):
        assert chunk_size >= 1
        self.obs = obs if obs is not None else ServingObservability(
            enabled=False)
        self.kv = kv
        self.lanes = lanes
        self.chunk_size = chunk_size
        self.step_tokens = step_tokens or (lanes + chunk_size)
        self.token_buckets: Tuple[int, ...] = tuple(sorted(
            set(token_buckets) | {1} if token_buckets
            else default_token_buckets(self.step_tokens)))
        assert self.token_buckets[-1] >= self.step_tokens, (
            f"token_buckets {self.token_buckets} do not cover "
            f"step_tokens={self.step_tokens}")
        self.waiting: List[RunningRequest] = []     # ordered by ticket
        self.running: List[RunningRequest] = []     # ordered by ticket
        self._table_pages = 1                       # table-width high-water mark
        self._ticket = 0
        self._evicted_now: List[int] = []
        self.trimmed_prefill_step = 0               # tokens, this step

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise InvalidRequest("prompt", "empty prompt", uid=req.uid)
        worst = len(req.prompt) + req.max_new
        if self.kv.pages_needed(worst) > self.kv.num_pages:
            raise InvalidRequest(
                "max_new",
                f"needs {self.kv.pages_needed(worst)} pages worst-case "
                f"(> pool of {self.kv.num_pages}) — raise num_pages",
                uid=req.uid)
        req.state = RequestState.WAITING
        self.waiting.append(RunningRequest(req, self._ticket))
        self._ticket += 1
        self.obs.request_submitted(req.uid, prompt_len=len(req.prompt),
                                   max_new=req.max_new)

    def finish(self, run: RunningRequest) -> None:
        """Release a completed request's lane and pages."""
        self.running.remove(run)
        self.kv.release(run.pages)
        run.pages = []
        run.req.state = RequestState.FINISHED
        self.obs.request_finished(run.req.uid, generated=len(run.req.tokens))

    def abort(self, uid: int) -> bool:
        """Cancel a waiting or running request by uid → True if found."""
        for run in self.waiting:
            if run.req.uid == uid:
                self.waiting.remove(run)
                run.req.done = True
                run.req.state = RequestState.ABORTED
                self.obs.request_finished(uid, aborted=True,
                                          generated=len(run.req.tokens))
                return True
        for run in self.running:
            if run.req.uid == uid:
                self.running.remove(run)
                run.pages = self.kv.uncommit(run.pages, run.rows)
                self.kv.release(run.pages)
                run.pages = []
                run.req.done = True
                run.req.state = RequestState.ABORTED
                self.obs.request_finished(uid, aborted=True,
                                          generated=len(run.req.tokens))
                return True
        return False

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------- internal
    def _preempt_youngest(self, older_than: int) -> bool:
        """Evict the youngest resident with ticket > ``older_than``; its
        cursor rewinds and it re-queues by ticket.  → False if none."""
        victims = [r for r in self.running if r.ticket > older_than]
        if not victims:
            return False
        victim = max(victims, key=lambda r: r.ticket)
        self.running.remove(victim)
        self.kv.release(victim.pages)
        victim.pages = []
        victim.rows = 0
        victim.req.state = RequestState.PREEMPTED
        self._evicted_now.append(victim.req.uid)
        self.obs.request_preempted(victim.req.uid)
        bisect.insort(self.waiting, victim, key=lambda r: r.ticket)
        return True

    def _grant_pages(self, run: RunningRequest, rows_after: int) -> bool:
        """Extend ``run``'s table to cover ``rows_after`` rows, evicting
        younger residents if the pool runs dry → False if ``run`` lost."""
        need = self.kv.pages_needed(rows_after) - len(run.pages)
        while need > self.kv.available_pages:
            if not self._preempt_youngest(older_than=run.ticket):
                return False              # run is the youngest: it waits
        for _ in range(need):
            run.pages.append(self.kv.alloc())
        return True

    def _admit(self) -> None:
        while self.waiting and len(self.running) < self.lanes:
            cand = self.waiting[0]
            if self.kv.pages_needed(cand.known() + 1) > self.kv.available_pages:
                break                     # FCFS: the head blocks the queue
            self.waiting.pop(0)
            resumed = cand.req.state is RequestState.PREEMPTED
            cand.rows = 0
            cand.req.state = RequestState.PREFILL
            self.obs.request_admitted(cand.req.uid, resumed=resumed)
            bisect.insort(self.running, cand, key=lambda r: r.ticket)

    def _plan_wants(self) -> Dict[int, int]:
        """Split the step's token budget: ticket → q_len, decodes first."""
        budget = self.step_tokens
        wants: Dict[int, int] = {}
        for run in sorted(self.running,
                          key=lambda r: (r.remaining() > 1, r.ticket)):
            q = min(self.chunk_size, run.remaining(), budget)
            if q <= 0:
                continue
            budget -= q
            wants[run.ticket] = q
        return wants

    def _grant_plans(self, wants: Dict[int, int]) -> List[LanePlan]:
        """Grant pages in strict ticket order, only for budgeted tokens."""
        plans: List[LanePlan] = []
        for run in list(sorted(self.running, key=lambda r: r.ticket)):
            if run not in self.running:
                continue                              # evicted by an elder
            q = wants.get(run.ticket)
            if q is None:
                continue
            if not self._grant_pages(run, run.rows + q):
                continue
            run.req.state = (RequestState.DECODE if run.remaining() == 1
                             else RequestState.PREFILL)
            plans.append(LanePlan(run, q))
        return plans

    def begin_step(self) -> Dict[int, int]:
        """Admit waiters and split the token budget → ticket → q_len."""
        self._evicted_now = []
        self.trimmed_prefill_step = 0
        self._admit()
        return self._plan_wants()

    # -------------------------------------------------------- ragged plan
    def _bucket_up(self, t: int) -> int:
        for w in self.token_buckets:
            if w >= t:
                return w
        return self.token_buckets[-1]

    def _trim_to_bucket(self, wants: Dict[int, int]) -> Dict[int, int]:
        """Trim prefill chunk tails (youngest first, never a decode, every
        lane keeps >= 1 token) so the live stream lands on a bucket edge;
        pad up when the edge is unreachable."""
        total = sum(wants.values())
        if total == 0 or total in self.token_buckets:
            return wants
        runs = {r.ticket: r for r in self.running}
        floor = sum(1 for t in wants if runs[t].remaining() == 1)
        below = [w for w in self.token_buckets if floor <= w <= total]
        if not below:
            return wants                              # decode-bound: pad up
        cut = total - below[-1]
        trimmable = sum(q - 1 for t, q in wants.items()
                        if runs[t].remaining() > 1)
        if cut > trimmable:
            return wants                              # would starve: pad up
        for tkt in sorted(wants, reverse=True):       # prefill: youngest 1st
            if cut == 0:
                break
            if runs[tkt].remaining() == 1:
                continue
            take = min(cut, wants[tkt] - 1)
            wants[tkt] -= take
            cut -= take
            self.trimmed_prefill_step += take
        return wants

    def pack(self, plans: List[LanePlan]) -> RaggedBatch:
        """Flatten lane plans into one dense bucketed token stream."""
        live = sum(p.q_len for p in plans)
        width = self._bucket_up(max(live, 1))
        pw = max((len(p.run.pages) for p in plans), default=1)
        pw = 1 << max(pw - 1, 0).bit_length()         # table-width bucket
        self._table_pages = max(self._table_pages, pw)
        pw = self._table_pages
        tokens = np.zeros((width,), np.int32)
        pos = np.zeros((width,), np.int32)
        lane_id = np.full((width,), -1, np.int32)
        table = np.full((width, pw), self.kv.scratch, np.int32)
        cu = np.zeros((len(plans) + 1,), np.int32)
        t = 0
        for i, p in enumerate(plans):
            q = p.q_len
            tokens[t:t + q] = p.stream_tokens()
            pos[t:t + q] = p.run.rows + np.arange(q, dtype=np.int32)
            lane_id[t:t + q] = i
            table[t:t + q, :len(p.run.pages)] = np.asarray(
                p.run.pages, np.int32)[None, :]
            t += q
            cu[i + 1] = t
        return RaggedBatch(plans=plans, tokens=tokens, pos=pos,
                           lane_id=lane_id, table=table, cu_seqlens=cu,
                           live=live, width=width)

    def batch_for(self, wants: Dict[int, int]
                  ) -> Tuple[RaggedBatch, Tuple[int, ...]]:
        """Trim to a bucket edge, grant pages, pack → (batch, preempted)."""
        plans = self._grant_plans(self._trim_to_bucket(wants))
        return self.pack(plans), tuple(self._evicted_now)
