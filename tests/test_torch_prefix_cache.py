"""The port's prefix cache and copy-on-write against the JAX reference.

- **radix twins**: one seeded sequence of pool and cache operations
  (publish, match, grant, release, evict, ``release_hold``,
  ``enforce_budget``, CoW, alloc through reclaim) drives the reference's
  ``PagedKVCache`` + ``RadixPrefixCache`` and the port's side by side;
  after every operation the hits, trees (page → block path, LRU stamps),
  refcounts, free heaps and ``stats()`` are equal;
- **in-place CoW**: the port's copy rewrites the new page of every pool
  leaf from the original and never rebinds a pool tensor (every captured
  step reads the pool by address);
- **twin engines** with ``prefix_cache=True`` on the reference's smallest
  traces (``tests/test_prefix_cache.py``): shared-prefix serving (f32 and
  int8), a partial hit with CoW, resume by cache hit after preemption on a
  tight pool (lanes 2, page 4), and a mid-prefill abort that publishes
  only committed pages.  After every step the harness
  (``tests/_torch_twin.py``) holds plans, streams, pools, cache trees,
  CoW counts and ``prefix_hit_tokens`` equal; the streams also equal the
  port's own cache-off run.

Bookkeeping is held bit for bit; greedy tokens are equal, int8 near-ties
excepted by the harness's margin rule.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import PagedKVCache as JPool  # noqa: E402
from repro.serving import RadixPrefixCache as JCache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import EngineCore, Request  # noqa: E402
from repro_torch.serving import PagedKVCache as TPool  # noqa: E402
from repro_torch.serving import RadixPrefixCache as TCache  # noqa: E402
from tests._torch_twin import build, cache_tree, run_twins  # noqa: E402

PS = 8


# ------------------------------------------------------------ radix twins --

def _drive(kv, cache, seed, n_ops=120):
    """A seeded walk over the pool + cache API → one observation per op.
    Every random draw is made whatever the state, so two implementations
    that agree draw the same sequence."""
    rng = np.random.default_rng(seed)
    ps = kv.page_size
    heads = [rng.integers(0, 512, 3 * ps).astype(np.int32) for _ in range(3)]
    held = []                                  # page tables of "requests"
    obs = []
    for _ in range(n_ops):
        op = int(rng.integers(0, 8))
        head = heads[int(rng.integers(0, 3))]
        cut = int(rng.integers(1, len(head) + 1))
        tail = rng.integers(0, 4, int(rng.integers(0, ps + 3)))
        toks = np.concatenate([head[:cut], tail]).astype(np.int32)
        pick = int(rng.integers(0, 1 << 30))
        if op == 0:                            # a request publishes
            n = kv.pages_needed(len(toks))
            if n > kv.available_pages:
                res = "full"
            else:
                pages = [kv.alloc() for _ in range(n)]
                res = (pages, cache.insert(toks, pages))
                held.append(pages)
        elif op in (1, 2):                     # probe; op 2 grants the hit
            hit = cache.match(toks)
            res = (hit.pages, hit.tokens, hit.partial_rows)
            if op == 2 and hit.pages:
                cache.grant(hit, len(toks))
                held.append(list(hit.pages))
        elif op == 3:                          # a request releases
            res = held.pop(pick % len(held)) if held else None
            if res is not None:
                kv.release(res)
        elif op == 4:
            res = cache.evict_one()
        elif op == 5:                          # release_hold on a cached page
            nodes = sorted(cache._nodes)
            res = (cache.release_hold(nodes[pick % len(nodes)])
                   if nodes else None)
        elif op == 6:                          # CoW a shared page, alloc
            shared = [(i, j) for i, t in enumerate(held)
                      for j, p in enumerate(t) if kv.ref[p] > 1]
            if shared and kv.available_pages >= 1:
                i, j = shared[pick % len(shared)]
                held[i][j] = res = kv.cow(held[i][j])
            elif kv.available_pages >= 1:
                held.append([kv.alloc()])      # may reclaim a cached page
                res = held[-1]
            else:
                res = None
        else:
            cache.enforce_budget()
            res = cache.cached_pages
        obs.append((op, res, list(kv.ref), list(kv.free), kv.available_pages,
                    cache_tree(cache)))
    return obs


@pytest.mark.parametrize("max_pages", [None, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_cache_twin(seed, max_pages):
    jcfg = j_get_config("deepseek-7b-smoke")
    jkv = JPool(build_model(jcfg), 24, PS)
    tkv = TPool(get_config("deepseek-7b-smoke"), 24, PS, device="cpu")
    want = _drive(jkv, JCache(jkv, max_pages=max_pages), seed)
    got = _drive(tkv, TCache(tkv, max_pages=max_pages), seed)
    ops = {o[0] for o in want}
    assert ops == set(range(8)), ops
    for i, (w, g) in enumerate(zip(want, got)):
        assert w == g, (i, w[0])
    assert tkv.cow_copies == jkv.cow_copies > 0


def test_cow_copies_in_place():
    """CoW writes the fresh page of every leaf (bf16 k/v; int8 k/v and
    their scales) from the original, leaves the original as it was and
    rebinds no pool tensor."""
    for kv_quant in (False, True):
        cfg = get_config("deepseek-7b-smoke").replace(kv_quant=kv_quant)
        kv = TPool(cfg, 6, PS, device="cpu")
        for t in kv.pool.values():
            t.copy_(torch.randint(-100, 100, t.shape).to(t.dtype))
        before = {k: (t.data_ptr(), t.clone()) for k, t in kv.pool.items()}
        cache = TCache(kv)
        page = kv.alloc()
        cache.insert(np.arange(PS, dtype=np.int32), [page])
        fresh = kv.cow(page)
        assert fresh != page and kv.cow_copies == 1
        assert kv.ref[page] == 1 and kv.ref[fresh] == 1
        assert set(kv.pool) == ({"k", "v", "ks", "vs"} if kv_quant
                                else {"k", "v"})
        for k, t in kv.pool.items():
            ptr, old = before[k]
            assert t.data_ptr() == ptr, k
            assert torch.equal(t[:, fresh], old[:, page]), k
            keep = [p for p in range(t.shape[1]) if p != fresh]
            assert torch.equal(t[:, keep], old[:, keep]), k
        assert kv.cow(fresh) == fresh                # exclusive: no copy


# ------------------------------------------------------------ twin engines --

def _cold_streams(tc, tparams, prompts, news, waves, **kw):
    """The port's own cache-off run of the same waves."""
    eng = EngineCore(tc, tparams, device="cpu", **kw)
    for wave in waves:
        for i in wave:
            eng.submit(Request(uid=i, prompt=prompts[i], max_new=news[i]))
        eng.run()
    return {r.uid: r.tokens for r in eng.finished}


def _twin(monkeypatch, *, kv_quant, prompts, news, waves, engine_kw,
          on_step=None):
    built = build("float32", kv_quant)
    out = run_twins(monkeypatch, dtype="float32", kv_quant=kv_quant,
                    prompts=prompts, max_new=news, waves=waves,
                    engine_kw=dict(engine_kw, prefix_cache=True),
                    on_step=on_step, built=built)
    cold = _cold_streams(built[1], built[3], prompts, news, waves,
                         **engine_kw)
    excused = out["forked"]
    assert {u: t for u, t in out["streams"][1].items() if u not in excused} \
        == {u: t for u, t in cold.items() if u not in excused}
    if not kv_quant:
        assert not out["forked"]
    assert len(out["forked"]) <= 1, out["near_ties"]
    return out


@pytest.mark.parametrize("kv_quant", [False, True])
def test_twin_shared_prefix_serving(monkeypatch, kv_quant):
    """``test_shared_prefix_serving_token_identical``'s trace: request 0
    fills the cache, requests 1–3 (the same 24-token system prompt, their
    own tails) each hit exactly the prefix."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 512, 3 * PS).astype(np.int32)
    prompts = [np.concatenate([shared, [i], rng.integers(0, 512, n)])
               .astype(np.int32) for i, n in enumerate((5, 9, 7, 4))]
    out = _twin(monkeypatch, kv_quant=kv_quant, prompts=prompts,
                news=(6, 4, 8, 5), waves=[[0], [1, 2, 3]],
                engine_kw=dict(lanes=2, page_size=PS, num_pages=32,
                               chunk_size=PS))
    _, te = out["engines"]
    assert te.prefix_stats["hit_tokens"] == 3 * len(shared)
    assert sum(ot.prefix_hit_tokens for _, ot in out["outs"]) == 3 * len(shared)
    assert te.pages_in_use == te.prefix_stats["cached_pages"]


def test_twin_partial_hit_with_cow(monkeypatch):
    """``test_cow_isolates_writers_from_cached_pages``: a prompt ending
    mid-way through a cached page (1 full page + a 6-row partial hit) is
    copied before its first cold row lands, and the original still serves
    an exact re-serve."""
    base = np.random.default_rng(1).integers(0, 512, 21).astype(np.int32)
    out = _twin(monkeypatch, kv_quant=False, prompts=[base, base[:14], base],
                news=(4, 4, 4), waves=[[0], [1], [2]],
                engine_kw=dict(lanes=1, page_size=PS, num_pages=32,
                               chunk_size=PS))
    je, te = out["engines"]
    assert te.kv.cow_copies == je.kv.cow_copies >= 1
    assert te.prefix_stats["partial_hits"] >= 1


def test_twin_resume_by_cache_hit(monkeypatch):
    """``test_resume_by_cache_hit``: on a tight pool (lanes 2, page 4, 11
    pages) the youngest request is evicted, its full pages published, and
    it resumes by a cache hit."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (4, 16)]
    out = _twin(monkeypatch, kv_quant=False, prompts=prompts, news=(30, 10),
                waves=[[0, 1]],
                engine_kw=dict(lanes=2, page_size=4, num_pages=11,
                               chunk_size=4))
    assert out["preempted"], "no eviction on the tight pool"
    assert sum(ot.prefix_hit_tokens for _, ot in out["outs"]) > 0


def test_twin_mid_prefill_abort(monkeypatch):
    """``test_mid_prefill_abort_publishes_only_committed_pages``: chunk 12
    over 8-row pages; the abort lands with rows 12 and a table covering
    16, only the one committed page is published, and the warm re-serve
    hits exactly it."""
    prompt = np.random.default_rng(9).integers(0, 512, 3 * PS + 4
                                               ).astype(np.int32)
    seen = {}

    def abort_after_first_step(je, te, step):
        if step == 1:
            run = te.scheduler.running[0]
            seen["rows"] = run.rows
            assert 0 < run.rows < len(prompt) and run.rows % PS
            assert len(run.pages) > run.rows // PS
            assert je.abort(0) and te.abort(0)
            seen["cached"] = (je.prefix_cache.cached_pages,
                              te.prefix_cache.cached_pages)

    out = _twin_abort(monkeypatch, prompt, abort_after_first_step)
    rows = seen["rows"]
    assert seen["cached"] == (rows // PS, rows // PS)
    assert sum(ot.prefix_hit_tokens for _, ot in out["outs"]) == \
        (rows // PS) * PS


def _twin_abort(monkeypatch, prompt, on_step):
    kw = dict(lanes=1, page_size=PS, num_pages=32, chunk_size=12)
    built = build("float32", False)
    out = run_twins(monkeypatch, dtype="float32", kv_quant=False,
                    prompts=[prompt, prompt], max_new=(4, 4),
                    waves=[[0], [1]], engine_kw=dict(kw, prefix_cache=True),
                    on_step=on_step, built=built)
    cold = _cold_streams(built[1], built[3], [prompt], (4,), [[0]], **kw)
    assert out["streams"][1] == {1: cold[0]}
    assert out["streams"][0] == out["streams"][1]
    return out


def test_dropped_cached_engine_frees_without_the_cycle_collector():
    """The pool holds its prefix cache weakly: an engine with the cache and
    speculation on, dropped after serving, frees its pool at once."""
    import gc
    import weakref
    _, tc, _, tparams = build("float32", False)
    gc.disable()
    try:
        eng = EngineCore(tc, tparams, lanes=2, page_size=PS, num_pages=16,
                         chunk_size=PS, device="cpu", prefix_cache=True,
                         speculative=True, spec_k=2)
        prompt = np.arange(3 * PS, dtype=np.int32)
        for uid in (0, 1):
            eng.submit(Request(uid=uid, prompt=prompt, max_new=3))
            eng.run()
        assert eng.prefix_stats["hit_tokens"] == len(prompt) - 1
        refs = [weakref.ref(eng), weakref.ref(eng.kv.pool["k"]),
                weakref.ref(eng.prefix_cache), weakref.ref(eng.graphs)]
        del eng
        assert [r() for r in refs] == [None] * 4
    finally:
        gc.enable()
