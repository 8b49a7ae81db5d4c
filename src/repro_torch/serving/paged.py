"""Paged KV cache: fixed-size pages, a min-heap free list and refcounts
(port of ``src/repro/serving/paged.py::PagedKVCache``).

The pool is the model's ``trunk_cache_init(num_pages + 1, page_size)``:
page ``num_pages`` is the scratch page that dead stream rows write to.
Pages are handed out lowest id first, so the physical layout is
deterministic under any release order.  Every page carries a refcount: one
per page table naming it, plus one while the prefix cache
(``serving/prefix_cache.py``) holds it; ``release`` returns a page to the
heap only when its last reference drops.  When the heap runs dry,
``alloc`` reclaims least-recently-used cached pages that no request
references, through the attached prefix cache.

Writing into a shared page goes through ``cow``: the writer gets a copy
and drops its reference on the original.  The copy is made in place, page
``dst`` of every pool leaf overwritten from page ``src`` on the current
stream: the pool's tensors are never rebound, because every captured step
graph (``serving/graphs.py``) reads them by address, and stream order puts
the copy ahead of the step that reads it.  ``obs`` (the engine's
``ServingObservability``) counts the copies.

``gather`` turns page tables into contiguous views of the pool: an
oracle for the tests, never on a serving step.

A rank of a tensor-parallel engine (``EngineCore(mesh=N)``) holds one
band of the KV heads: ``heads=Hkv/N`` makes every ``k``/``v`` leaf
(L, N+1, Hkv/N, ps, Dh) and every int8 scale (L, N+1, Hkv/N, ps) — the
rank's block of the whole pool under ``parallel/sharding.py::
pool_specs``.  Page ids and all accounting are the same on every rank.

``check_pageable`` refuses, at construction, a model whose cache the pool
cannot page: a Mamba layer's state is O(1) per sequence, with no length
axis to page, and a local layer whose window is narrower than a page
would keep a ring buffer inside the page (the reference's
``_check_pageable``).
"""
from __future__ import annotations

import heapq
import weakref
from typing import Dict, List, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.lm import trunk_cache_init
from repro_torch.serving.api import UnsupportedCacheLayout


def check_pageable(cfg: ModelConfig, page_size: int) -> None:
    """Raise ``UnsupportedCacheLayout("ssm_state")`` for the SSM families
    (the reference's probe finds their state leaves O(1) per slot) and
    ``UnsupportedCacheLayout("ring_buffer_sliding_window")`` when
    a local layer's window is narrower than what the reference's probe
    builds: its caches at ``max_len = page_size`` for an even page (so
    ``window == page_size`` pages), at twice that for an odd one (its
    probe's over-strict step past the pool)."""
    if cfg.family in ("ssm", "hybrid"):
        channels = cfg.d_inner + (2 * cfg.ssm_groups * cfg.ssm_state
                                  if cfg.ssm_variant == "mamba2" else 0)
        raise UnsupportedCacheLayout(
            "ssm_state", cfg.name,
            f"leaf conv (shape (1, {cfg.ssm_conv - 1}, {channels})) is O(1) "
            f"per slot — no length axis to page")
    probe = page_size if page_size % 2 == 0 and page_size >= 2 \
        else 2 * page_size
    if cfg.window is None or cfg.window >= probe:
        return
    kinds = cfg.layer_kinds()
    if "local" in kinds:
        raise UnsupportedCacheLayout(
            "ring_buffer_sliding_window", cfg.name,
            f"layer {kinds.index('local')} keeps ring-buffer slot positions "
            f"(window {cfg.window} narrower than page_size={page_size})")


class PagedKVCache:
    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int, *,
                 device=None, obs=None, heads: Optional[int] = None):
        check_pageable(cfg, page_size)
        self.num_pages = num_pages
        self.obs = obs                              # ServingObservability
        self.page_size = page_size
        self.scratch = num_pages                    # sink page for dead rows
        self.heads = cfg.num_kv_heads if heads is None else heads
        if self.heads < 1 or cfg.num_kv_heads % self.heads:
            raise ValueError(f"a head band of {self.heads} does not divide "
                             f"num_kv_heads={cfg.num_kv_heads}")
        # the pool's shapes read the KV head count alone
        band = cfg.replace(num_kv_heads=self.heads)
        self.pool = trunk_cache_init(band, num_pages + 1, page_size, device)
        self.free: List[int] = list(range(num_pages))   # min-heap by page id
        self.ref: List[int] = [0] * num_pages
        self.cow_copies = 0                         # lifetime CoW page copies
        self._cache = None              # weak ref to a RadixPrefixCache

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def free_pages(self) -> int:
        """Pages on the free heap: never allocated or fully released.
        Cached pages no request references are not counted (they are in
        ``available_pages``)."""
        return len(self.free)

    @property
    def available_pages(self) -> int:
        """Pages an ``alloc`` can obtain without preempting anyone: the free
        heap plus cached pages no request references."""
        cache = self._cache and self._cache()
        return len(self.free) + (cache.reclaimable_pages
                                 if cache is not None else 0)

    def attach_cache(self, cache) -> None:
        """Wire a prefix cache in as the reclaim source for ``alloc``.  The
        pool holds it weakly: the cache holds the pool, and a cycle would
        keep the pool's device memory alive after its engine is dropped,
        until the next collection."""
        self._cache = weakref.ref(cache)

    def alloc(self) -> int:
        while not self.free:
            cache = self._cache and self._cache()
            if cache is None or not cache.evict_one():
                raise RuntimeError(
                    "page pool exhausted: no free or reclaimable pages "
                    "(scheduler must check available_pages before alloc)")
        p = heapq.heappop(self.free)
        self.ref[p] = 1
        return p

    def share(self, page: int) -> None:
        """Add a reference to a resident page."""
        if self.ref[page] <= 0:
            raise ValueError(f"share of unreferenced page {page}")
        self.ref[page] += 1

    def release_one(self, page: int) -> None:
        """Drop one reference; the page returns to the heap at zero."""
        if self.ref[page] <= 0:
            raise ValueError(f"double release of page {page}")
        self.ref[page] -= 1
        if self.ref[page] == 0:
            heapq.heappush(self.free, page)

    def release(self, pages: List[int]) -> None:
        for p in pages:
            self.release_one(p)

    def uncommit(self, pages: List[int], rows: int) -> List[int]:
        """Shrink a page table to what ``rows`` committed rows need,
        releasing the surplus tail pages → the trimmed table.  Speculative
        decoding's rollback: pages that hold only rejected draft rows were
        allocated this step at the table's tail, so releasing them restores
        the heap and refcounts as if the drafts were never granted."""
        keep = self.pages_needed(rows)
        assert keep <= len(pages), (
            f"uncommit: {rows} rows need {keep} pages but table has "
            f"{len(pages)}")
        self.release(pages[keep:])
        return pages[:keep]

    def cow(self, page: int) -> int:
        """Copy-on-write: make ``page`` writable for one holder → the page
        to write.  An exclusive page (ref 1) comes back as it is; a shared
        one is copied into a freshly allocated page (the caller checked
        ``available_pages``), the caller's reference moves to the copy and
        the original stays as it was for its other holders."""
        if self.ref[page] <= 1:
            return page
        fresh = self.alloc()
        for t in self.pool.values():                # page axis is dim 1
            t[:, fresh].copy_(t[:, page])
        self.release_one(page)
        self.cow_copies += 1
        if self.obs is not None:
            self.obs.cow_copy()
        return fresh

    # ------------------------------------------------------------- pool ops
    def gather(self, pool: Dict[str, torch.Tensor],
               tbl: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Page tables (B, P) → contiguous views of ``pool``, leaf by leaf:
        ``k``/``v`` (L, N+1, Hkv, ps, Dh) → (L, B, Hkv, P·ps, Dh), the int8
        scales (L, N+1, Hkv, ps) → (L, B, Hkv, P·ps) — the contiguous
        cache's layout (``models/lm.py::trunk_cache_init``), row ``r`` of
        lane ``b`` read from page ``tbl[b, r // ps]``.

        This is the O(B·H·L·D) copy the in-place paths never make; it
        remains only as an oracle for holding the paged attention against
        the contiguous backends (tests).  No serving step calls it."""
        tbl = tbl.long()
        out = {}
        for name, leaf in pool.items():
            g = leaf[:, tbl]                    # (L, B, P, Hkv, ps, ...)
            g = g.movedim(2, 3)                 # P next to the in-page row
            s = g.shape
            out[name] = g.reshape(s[:3] + (s[3] * s[4],) + s[5:])
        return out
