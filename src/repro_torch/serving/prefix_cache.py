"""Shared-prefix KV reuse: a radix cache over page-aligned token blocks
(port of ``src/repro/serving/prefix_cache.py``; host code only).

A node at depth ``d`` is reached by the token blocks ``tokens[0:ps], …,
tokens[(d-1)·ps:d·ps]`` and owns the one physical page holding those
``ps`` KV rows given that prefix path.  KV content depends only on the
token prefix, so a path is a complete content address: two requests
reaching one node may share its page.

- ``match(tokens)`` walks full blocks, then extends into the next block by
  longest common prefix: a partial-page hit grants the deepest page too,
  with only its first ``lcp`` rows valid.  Matching stops at
  ``len(tokens) − 1``, so one known token is always left to stream (the
  step that consumes the last known token is the one that samples).
- ``grant(hit)`` takes one pool reference per granted page and stamps the
  path's LRU clock.  A granted partial page is copy-on-written by the
  scheduler before the request writes its first cold row into it.
- ``insert(tokens, pages)`` publishes a request's full pages; the first
  publisher wins on a path collision.

Cached pages whose only reference is the cache's own are reclaimable.
``evict_one`` removes the least-recently-used reclaimable leaf, so the
tree never strands descendants; since a hit grants its whole path, every
node whose page has refcount 1 is reclaimable leaf-first and
``reclaimable_pages`` is exact.  ``max_pages`` caps the cache's resident
pages; ``version`` changes on every tree mutation, so a waiting request's
probe can be memoised.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.paged import PagedKVCache

Block = Tuple[int, ...]


class _Node:
    """One cached page: reached by its block path, LRU-stamped on use."""
    __slots__ = ("block", "page", "parent", "children", "stamp")

    def __init__(self, block: Block, page: int, parent: "_Node", stamp: int):
        self.block = block
        self.page = page
        self.parent = parent
        self.children: Dict[Block, "_Node"] = {}
        self.stamp = stamp


@dataclasses.dataclass(frozen=True)
class PrefixHit:
    """A probe's result: root-ward resident ``pages`` covering ``tokens``
    KV rows; when ``partial_rows > 0`` the last page is valid only through
    that many rows.  Granting is a separate step (``grant``), so a probe
    that loses the admission check changes nothing."""
    pages: Tuple[int, ...]
    tokens: int
    partial_rows: int
    nodes: Tuple[_Node, ...] = dataclasses.field(repr=False, default=())


class RadixPrefixCache:
    """Radix tree of page-aligned token blocks → resident pool pages."""

    def __init__(self, kv: PagedKVCache,
                 max_pages: Optional[int] = None, *, obs=None):
        if max_pages is not None and max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {max_pages}")
        self.kv = kv
        self.obs = obs                          # ServingObservability
        self.page_size = kv.page_size
        self.max_pages = max_pages
        self.root = _Node((), -1, None, 0)      # type: ignore[arg-type]
        self._nodes: Dict[int, _Node] = {}      # page id → node
        self._clock = itertools.count(1)        # deterministic LRU time
        self.lookups = 0
        self.lookup_tokens = 0
        self.hits = 0
        self.hit_tokens = 0
        self.partial_hits = 0
        self.shared_page_grants = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.version = 0                        # bumped on insert / evict
        kv.attach_cache(self)

    # ------------------------------------------------------------- metrics
    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    @property
    def reclaimable_pages(self) -> int:
        """Cached pages only the cache references."""
        return sum(1 for n in self._nodes.values()
                   if self.kv.ref[n.page] == 1)

    def holds(self, page: int) -> bool:
        """True while ``page`` backs a tree node (carries a cache ref)."""
        return page in self._nodes

    @property
    def hit_rate(self) -> float:
        """Fraction of admitted known tokens served from resident pages."""
        return self.hit_tokens / max(self.lookup_tokens, 1)

    def stats(self) -> Dict[str, float]:
        return {"lookups": self.lookups, "lookup_tokens": self.lookup_tokens,
                "hits": self.hits, "hit_tokens": self.hit_tokens,
                "hit_rate": self.hit_rate, "partial_hits": self.partial_hits,
                "shared_page_grants": self.shared_page_grants,
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages,
                "cached_pages": self.cached_pages,
                "reclaimable_pages": self.reclaimable_pages,
                "cow_copies": self.kv.cow_copies}

    # -------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> PrefixHit:
        """Longest cached prefix of ``tokens``.  A pure probe: no refcount,
        stamp or statistic changes (``grant`` records the lookup)."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        limit = len(toks) - 1                   # always leave one cold token
        node = self.root
        nodes: List[_Node] = []
        d = 0
        while (d + 1) * ps <= limit:
            child = node.children.get(tuple(toks[d * ps:(d + 1) * ps]))
            if child is None:
                break
            nodes.append(child)
            node = child
            d += 1
        partial = 0
        rest = toks[d * ps:limit]
        if rest:
            best, best_lcp = None, 0
            for blk, child in node.children.items():
                lcp = 0
                for a, b in zip(rest, blk):
                    if a != b:
                        break
                    lcp += 1
                if lcp > best_lcp:
                    best, best_lcp = child, lcp
            if best is not None:
                nodes.append(best)
                partial = best_lcp
        return PrefixHit(pages=tuple(n.page for n in nodes),
                         tokens=d * ps + partial, partial_rows=partial,
                         nodes=tuple(nodes))

    def grant(self, hit: PrefixHit, total_tokens: int) -> None:
        """Commit a hit to an admitted request: one pool reference per
        granted page, an LRU touch down the path, and the admission's stats
        (``total_tokens``: the request's known tokens, hit or not)."""
        self.lookups += 1
        self.lookup_tokens += total_tokens
        if self.obs is not None:
            self.obs.prefix_lookup(total_tokens, hit.tokens, len(hit.pages))
        if not hit.tokens:
            return
        stamp = next(self._clock)
        for node in hit.nodes:
            self.kv.share(node.page)
            node.stamp = stamp
        self.hits += 1
        self.hit_tokens += hit.tokens
        self.shared_page_grants += len(hit.pages)
        self.partial_hits += int(hit.partial_rows > 0)

    # ------------------------------------------------------------- publish
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Publish a request's full pages: ``pages[i]`` holds the rows of
        ``tokens[i·ps:(i+1)·ps]``.  An existing node wins (its duplicate
        stays with the request and frees normally); a new node takes a
        cache reference → the number of pages newly cached."""
        ps = self.page_size
        node = self.root
        stamp = next(self._clock)
        new = 0
        for i in range(len(tokens) // ps):
            blk = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            child = node.children.get(blk)
            if child is None:
                child = _Node(blk, int(pages[i]), node, stamp)
                node.children[blk] = child
                self._nodes[int(pages[i])] = child
                self.kv.share(int(pages[i]))
                new += 1
            else:
                child.stamp = stamp
            node = child
        self.inserted_pages += new
        if new:
            self.version += 1
        return new

    # ------------------------------------------------------------ eviction
    def evict_one(self) -> bool:
        """Reclaim the LRU unreferenced leaf: its page to the free heap, its
        node out of the tree → False when nothing is reclaimable."""
        best = None
        for node in self._nodes.values():
            if node.children or self.kv.ref[node.page] != 1:
                continue
            if best is None or node.stamp < best.stamp:
                best = node
        if best is None:
            return False
        self._drop(best)
        self.kv.release_one(best.page)
        return True

    def release_hold(self, page: int) -> bool:
        """Drop the cache's own reference on a leaf so its one other holder
        owns it alone: the scheduler's last resort when a CoW would need a
        page the pool cannot produce.  A non-leaf refuses."""
        node = self._nodes.get(page)
        if node is None or node.children:
            return False
        self._drop(node)
        self.kv.release_one(page)         # other holders keep it resident
        return True

    def _drop(self, node: _Node) -> None:
        del node.parent.children[node.block]
        del self._nodes[node.page]
        self.evicted_pages += 1
        self.version += 1
        if self.obs is not None:
            self.obs.prefix_evicted()

    def enforce_budget(self) -> None:
        """Shrink to ``max_pages`` cached pages, LRU leaf first; pages that
        live requests pin are retried at the next publish or release."""
        if self.max_pages is None:
            return
        while self.cached_pages > self.max_pages and self.evict_one():
            pass
