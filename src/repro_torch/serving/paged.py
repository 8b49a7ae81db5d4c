"""Paged KV cache: fixed-size pages, a min-heap free list and refcounts
(port of ``src/repro/serving/paged.py::PagedKVCache``).

The pool is the model's ``trunk_cache_init(num_pages + 1, page_size)``:
page ``num_pages`` is the scratch page that dead stream rows write to.
Pages are handed out lowest id first, so the physical layout is
deterministic under any release order.  Every page carries a refcount (one
per page table naming it); ``release`` returns a page to the heap only when
its last reference drops.  Copy-on-write and prefix-cache reclaim belong to
the prefix-cache slice; ``obs`` (the engine's ``ServingObservability``) is
held for its copy-on-write counter, as the reference's pool holds it.
"""
from __future__ import annotations

import heapq
from typing import List

from repro_torch.configs import ModelConfig
from repro_torch.models.lm import trunk_cache_init


class PagedKVCache:
    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int, *,
                 device=None, obs=None):
        self.num_pages = num_pages
        self.obs = obs                              # ServingObservability
        self.page_size = page_size
        self.scratch = num_pages                    # sink page for dead rows
        self.pool = trunk_cache_init(cfg, num_pages + 1, page_size, device)
        self.free: List[int] = list(range(num_pages))   # min-heap by page id
        self.ref: List[int] = [0] * num_pages

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def available_pages(self) -> int:
        """Pages an ``alloc`` can obtain without preempting anyone."""
        return len(self.free)

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError(
                "page pool exhausted: no free pages (scheduler must check "
                "available_pages before alloc)")
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
        releasing the surplus tail pages → the trimmed table."""
        keep = self.pages_needed(rows)
        assert keep <= len(pages), (
            f"uncommit: {rows} rows need {keep} pages but table has "
            f"{len(pages)}")
        self.release(pages[keep:])
        return pages[:keep]
