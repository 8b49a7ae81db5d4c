"""Continuous-batching scheduler: requests → one packed token stream per
step, or one right-aligned block of lane plans for the padded oracle
(port of ``src/repro/serving/scheduler.py``, numpy only).

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
- prefix reuse (``prefix_cache``): admission probes the radix cache with
  the request's known tokens, grants the hit's resident pages shared and
  starts the cursor at the first cold token; full pages are published back
  on finish, abort and eviction, and a shared page the coming rows would
  write into is copy-on-written before the step runs;
- speculative drafts (``spec_k``, ``proposer``): decode lanes may stream
  up to ``spec_k`` drafted tokens after their decode token, paid from
  leftover step budget only, shrunk before anyone is preempted and trimmed
  first at the bucket edge;
- the packed stream is bucketed to a few widths, drafts and then prefill
  chunk tails trimmed (youngest first) so live work lands on a bucket
  edge, and the page-table width is held at its high-water mark.

Every lifecycle event goes to ``obs`` (the engine's
``ServingObservability``) at the reference's points: submitted, finished,
aborted, preempted, admitted (or resumed) and copy-on-write.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.api import Request, RequestState
from repro_torch.serving.paged import PagedKVCache
from repro_torch.serving.prefix_cache import RadixPrefixCache
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
    # memoised admission probe (cache.version, PrefixHit); cleared on
    # eviction, where replayed generation grows the known stream
    probe: Optional[tuple] = None

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
    """One lane of one step: stream ``q_len`` tokens of ``run``'s cursor,
    the last ``len(drafts)`` of them drafted (past the known stream,
    verified in the same step)."""
    run: RunningRequest
    q_len: int
    drafts: Tuple[int, ...] = ()

    @property
    def sample(self) -> bool:
        return (self.run.rows + self.q_len - len(self.drafts)
                == self.run.known())

    def stream_tokens(self) -> np.ndarray:
        """The q_len tokens this lane streams: known-stream chunk ⊕ drafts."""
        base = self.run.next_tokens(self.q_len - len(self.drafts))
        if not self.drafts:
            return base
        return np.concatenate([base, np.asarray(self.drafts, np.int32)])


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
                 token_buckets: Optional[Sequence[int]] = None,
                 prefix_cache: Optional[RadixPrefixCache] = None,
                 spec_k: int = 0, proposer=None, obs=None):
        assert chunk_size >= 1
        self.obs = obs if obs is not None else ServingObservability(
            enabled=False)
        self.kv = kv
        self.cache = prefix_cache
        self.lanes = lanes
        self.chunk_size = chunk_size
        self.spec_k = spec_k
        self.proposer = proposer
        self._drafts: Dict[int, Tuple[int, ...]] = {}   # ticket → drafts
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
        self.prefix_hit_tokens_step = 0             # granted this step
        self.trimmed_prefill_step = 0               # tokens, this step
        self.trimmed_draft_step = 0                 # tokens, this step

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
        """Release a completed request's lane and pages, its full pages
        published to the prefix cache first."""
        self.running.remove(run)
        self._publish(run)
        self.kv.release(run.pages)
        run.pages = []
        run.req.state = RequestState.FINISHED
        self.obs.request_finished(run.req.uid, generated=len(run.req.tokens))
        if self.cache is not None:
            self.cache.enforce_budget()

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
                # A drafting lane's table may still cover its drafts: trim
                # to the committed rows before publishing, so no page past
                # the cursor reaches the cache.
                run.pages = self.kv.uncommit(run.pages, run.rows)
                self._publish(run)
                self.kv.release(run.pages)
                run.pages = []
                run.req.done = True
                run.req.state = RequestState.ABORTED
                self.obs.request_finished(uid, aborted=True,
                                          generated=len(run.req.tokens))
                if self.cache is not None:
                    self.cache.enforce_budget()
                return True
        return False

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------- internal
    def _publish(self, run: RunningRequest) -> None:
        """Publish ``run``'s full resident pages into the prefix cache, keyed
        by the tokens whose rows they hold.  Clamped to the cursor: only
        pages whose every row the engine committed are eligible, so a
        mid-prefill abort never publishes granted-but-unwritten rows."""
        if self.cache is None or run.rows < self.kv.page_size:
            return
        full = run.rows // self.kv.page_size
        self.cache.insert(run.req.known_tokens()[:run.rows],
                          run.pages[:full])

    def _preempt_youngest(self, older_than: int) -> bool:
        """Evict the youngest resident with ticket > ``older_than``, its full
        pages published first; its cursor rewinds and it re-queues by
        ticket.  → False if none."""
        victims = [r for r in self.running if r.ticket > older_than]
        if not victims:
            return False
        victim = max(victims, key=lambda r: r.ticket)
        self.running.remove(victim)
        self._publish(victim)
        self.kv.release(victim.pages)
        victim.pages = []
        victim.rows = 0
        victim.probe = None               # known tokens grew: stale match
        victim.req.state = RequestState.PREEMPTED
        self._evicted_now.append(victim.req.uid)
        self.obs.request_preempted(victim.req.uid)
        bisect.insort(self.waiting, victim, key=lambda r: r.ticket)
        if self.cache is not None:
            self.cache.enforce_budget()
        return True

    def _cow_credit(self, page: int) -> bool:
        """True when copy-on-writing ``page`` hands its original straight
        back to the reclaimable pool (its only other holder is the cache)."""
        return (self.kv.ref[page] == 2 and self.cache is not None
                and self.cache.holds(page))

    def _page_demand(self, run: RunningRequest, rows_after: int):
        """→ (new pages, indices of shared pages to copy, copies whose
        original returns to the reclaimable pool) for ``rows_after``."""
        ps = self.kv.page_size
        lo = run.rows // ps
        hi = min((rows_after - 1) // ps + 1, len(run.pages))
        need = self.kv.pages_needed(rows_after) - len(run.pages)
        cow = [i for i in range(lo, hi) if self.kv.ref[run.pages[i]] > 1]
        credit = sum(1 for i in cow if self._cow_credit(run.pages[i]))
        return need, cow, credit

    def _fits_unforced(self, run: RunningRequest, rows_after: int) -> bool:
        """Would ``_grant_pages(run, rows_after)`` succeed without evicting
        anyone?"""
        need, cow, credit = self._page_demand(run, rows_after)
        avail = self.kv.available_pages
        return need + len(cow) - credit <= avail and (not cow or avail >= 1)

    def _grant_pages(self, run: RunningRequest, rows_after: int) -> bool:
        """Extend ``run``'s table to cover ``rows_after`` rows, evicting
        younger residents if the pool runs dry; shared pages the coming rows
        write into (a partial hit's page) are copy-on-written here, before
        the step runs.  The budget counts each copy and credits originals
        that return to the reclaimable pool.  → False if ``run`` lost."""
        while not self._fits_unforced(run, rows_after):
            if self._preempt_youngest(older_than=run.ticket):
                continue
            # No victim left: take sole ownership of a cache-only shared
            # page (a leaf eviction, no copy) before wedging the lane.
            _, cow, _ = self._page_demand(run, rows_after)
            if self.cache is not None and any(
                    self.kv.ref[run.pages[i]] == 2
                    and self.cache.release_hold(run.pages[i]) for i in cow):
                continue
            return False                  # run is the youngest: it waits
        need, cow, _ = self._page_demand(run, rows_after)
        # credit-yielding copies first: each returns its original to the
        # reclaimable pool before the next copy draws on it
        for i in sorted(cow, key=lambda i: not self._cow_credit(run.pages[i])):
            old = run.pages[i]
            run.pages[i] = self.kv.cow(old)
            if run.pages[i] != old:
                self.obs.request_cow(run.req.uid)
        for _ in range(need):
            run.pages.append(self.kv.alloc())
        return True

    def _admit(self) -> None:
        while self.waiting and len(self.running) < self.lanes:
            cand = self.waiting[0]
            # Probe the cache with the known tokens (prompt ⊕ replayed
            # generation), memoised against the tree's version while the
            # head waits; nothing is granted until admission passes.
            hit = None
            if self.cache is not None:
                if cand.probe is not None and \
                        cand.probe[0] == self.cache.version:
                    hit = cand.probe[1]
                else:
                    hit = self.cache.match(cand.req.known_tokens())
                    cand.probe = (self.cache.version, hit)
            # The pool must hold the known tokens plus one decode row, less
            # the hit's resident pages; granting pins the hit's cache-only
            # pages, so they leave the available side.
            need = self.kv.pages_needed(cand.known() + 1)
            avail = self.kv.available_pages
            if hit is not None:
                need -= len(hit.pages)
                avail -= sum(1 for p in hit.pages if self.kv.ref[p] == 1)
            if need > avail:
                break                     # FCFS: the head blocks the queue
            self.waiting.pop(0)
            resumed = cand.req.state is RequestState.PREEMPTED
            if hit is not None:
                self.cache.grant(hit, cand.known())
                cand.pages = list(hit.pages)
                cand.rows = hit.tokens
                self.prefix_hit_tokens_step += hit.tokens
            else:
                cand.rows = 0
            cand.req.state = RequestState.PREFILL
            self.obs.request_admitted(
                cand.req.uid, hit_tokens=hit.tokens if hit is not None else 0,
                resumed=resumed)
            bisect.insort(self.running, cand, key=lambda r: r.ticket)

    def _plan_wants(self) -> Dict[int, int]:
        """Split the step's token budget: ticket → q_len.  Decode lanes
        first, then prefill chunks oldest first; only leftover budget funds
        drafts (oldest greedy decode lane first, up to ``spec_k`` each)."""
        budget = self.step_tokens
        wants: Dict[int, int] = {}
        decodes: List[RunningRequest] = []
        for run in sorted(self.running,
                          key=lambda r: (r.remaining() > 1, r.ticket)):
            q = min(self.chunk_size, run.remaining(), budget)
            if q <= 0:
                continue
            budget -= q
            wants[run.ticket] = q
            if run.remaining() == 1:
                decodes.append(run)
        if self.spec_k > 0 and self.proposer is not None and budget > 0:
            for run in sorted(decodes, key=lambda r: r.ticket):
                if budget <= 0:
                    break
                if run.req.temperature > 0.0:
                    continue    # acceptance is argmax equality: greedy only
                # d accepted drafts commit d + 1 tokens: never draft past
                # max_new
                cap = min(self.spec_k, budget,
                          run.req.max_new - len(run.req.tokens) - 1)
                if cap <= 0:
                    continue
                drafts = tuple(
                    int(t) for t in
                    self.proposer(run.req.known_tokens(), cap))[:cap]
                if not drafts:
                    continue
                self._drafts[run.ticket] = drafts
                wants[run.ticket] += len(drafts)
                budget -= len(drafts)
        return wants

    @property
    def drafting(self) -> bool:
        """True while the current step carries speculative drafts."""
        return bool(self._drafts)

    def _grant_plans(self, wants: Dict[int, int]) -> List[LanePlan]:
        """Grant pages in strict ticket order, only for budgeted tokens.
        When a drafted chunk would need a preemption, its drafts shrink
        until the grant fits unforced: only a mandatory token evicts."""
        plans: List[LanePlan] = []
        for run in list(sorted(self.running, key=lambda r: r.ticket)):
            if run not in self.running:
                continue                              # evicted by an elder
            q = wants.get(run.ticket)
            if q is None:
                continue
            drafts = orig = self._drafts.get(run.ticket, ())
            while drafts and not self._fits_unforced(run, run.rows + q):
                drafts = drafts[:-1]                  # degrade, don't evict
                q -= 1
            if len(drafts) != len(orig):
                self.trimmed_draft_step += len(orig) - len(drafts)
                if drafts:
                    self._drafts[run.ticket] = drafts
                else:
                    del self._drafts[run.ticket]
            if not self._grant_pages(run, run.rows + q):
                continue
            run.req.state = (RequestState.DECODE if run.remaining() == 1
                             else RequestState.PREFILL)
            plans.append(LanePlan(run, q, tuple(drafts)))
        return plans

    def begin_step(self) -> Dict[int, int]:
        """Admit waiters and split the token budget → ticket → q_len.
        Then exactly one of :meth:`plans_for` (the padded block, the
        engine's ``mode="padded"`` oracle) or :meth:`batch_for` (the ragged
        stream) finishes the step."""
        self._evicted_now = []
        self.prefix_hit_tokens_step = 0
        self.trimmed_prefill_step = 0
        self.trimmed_draft_step = 0
        self._drafts = {}
        self._admit()
        return self._plan_wants()

    def plans_for(self, wants: Dict[int, int]
                  ) -> Tuple[List[LanePlan], Tuple[int, ...]]:
        """Finish a step as padded-block lane plans → (plans, preempted):
        pages granted for every budgeted token, no trim to a bucket."""
        plans = self._grant_plans(wants)
        return plans, tuple(self._evicted_now)

    def schedule(self) -> Tuple[List[LanePlan], Tuple[int, ...]]:
        """→ (lane plans for this step, uids preempted while planning).
        The engine runs these as one right-aligned (lanes, C) block — the
        padded step; :meth:`schedule_ragged` is the packed-stream twin."""
        return self.plans_for(self.begin_step())

    # -------------------------------------------------------- ragged plan
    def _bucket_up(self, t: int) -> int:
        for w in self.token_buckets:
            if w >= t:
                return w
        return self.token_buckets[-1]

    def _trim_to_bucket(self, wants: Dict[int, int]) -> Dict[int, int]:
        """Trim drafts, then prefill chunk tails (each youngest first, never
        a decode token, every lane keeps >= 1 token) so the live stream
        lands on a bucket edge; pad up when the edge is unreachable."""
        total = sum(wants.values())
        if total == 0 or total in self.token_buckets:
            return wants
        runs = {r.ticket: r for r in self.running}
        floor = sum(1 for t in wants if runs[t].remaining() == 1)
        below = [w for w in self.token_buckets if floor <= w <= total]
        if not below:
            return wants                              # decode-bound: pad up
        cut = total - below[-1]
        trimmable = (sum(len(d) for d in self._drafts.values())
                     + sum(q - 1 for t, q in wants.items()
                           if runs[t].remaining() > 1))
        if cut > trimmable:
            return wants                              # would starve: pad up
        for tkt in sorted(self._drafts, reverse=True):  # drafts: youngest 1st
            if cut == 0:
                break
            if tkt not in wants:
                continue
            take = min(cut, len(self._drafts[tkt]))
            self._drafts[tkt] = self._drafts[tkt][:len(self._drafts[tkt])
                                                  - take]
            if not self._drafts[tkt]:
                del self._drafts[tkt]
            wants[tkt] -= take
            cut -= take
            self.trimmed_draft_step += take
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

    def schedule_ragged(self) -> Tuple[RaggedBatch, Tuple[int, ...]]:
        """One step's plan in one call: admission and the token budget
        (``begin_step``), then ``batch_for`` → (batch, preempted), as the
        reference's ``schedule_ragged``."""
        return self.batch_for(self.begin_step())
