"""The port's speculative decoding against the JAX reference.

- **proposer twin**: the port's ``NGramProposer`` drafts exactly what the
  reference's does on seeded self-similar streams, with and without a
  history of finished streams;
- **twin engines** with ``speculative=True`` on the reference's smallest
  trace (``tests/test_spec_decode.py``: 4 prompts sharing a 16-token
  prefix, lanes 2, page 8, chunk 8, 8 new tokens each) under its scripted
  proposer, which replays the true greedy continuation and corrupts
  position ``i % (k + 1) − 1`` of its i-th proposal, so full accepts, full
  rejects and partial accepts all occur: k ∈ {1, 4} with the prefix cache
  off and on (f32), and an int8 pool at k = 4.  After every step the
  harness (``tests/_torch_twin.py``) holds plans with their drafts,
  streams, every committed token, pools, ``spec_stats`` and the capture
  count (the port's ``trace_count`` against JAX's) equal; the streams
  also equal the port's non-speculative run;
- **rollback**: a drafting port engine whose every draft is rejected
  keeps refcounts, free heap, tables and cursors equal to a never-drafting
  one after every step, through an abort too;
- **k is no key**: a speculative engine that never drafts captures as many
  step graphs as the plain engine, for k = 1 and k = 4, and a
  verify-shaped ragged step equals the reference's.

Bookkeeping is held bit for bit; greedy tokens are equal (the int8 run's
near-ties would fail it loudly: a speculative schedule depends on tokens).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.autotune import KernelConfig  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.serving import NGramProposer as JProposer  # noqa: E402
from repro_torch.kernels.autotune import (  # noqa: E402
    KernelConfig as TKernelConfig)
from repro_torch.models.lm import lm_step_ragged, trunk_cache_init  # noqa: E402
from repro_torch.serving import EngineCore, NGramProposer, Request  # noqa: E402
from tests._torch_twin import build, run_twins  # noqa: E402
from tests.test_spec_decode import ScriptedProposer  # noqa: E402
from tests.test_torch_model_step import NUM_PAGES, history_pool  # noqa: E402

LANES, PS, PAGES, CHUNK, MAX_NEW = 2, 8, 32, 8, 8
ENGINE = dict(lanes=LANES, page_size=PS, num_pages=PAGES, chunk_size=CHUNK)
#: the block shapes of the tuner's CPU row, in both packages
KERNEL_CONFIG = dict(block_q=8, block_pages=8)


def _prompts(n=4, shared=2 * PS, tail=4, seed=11):
    """The reference suite's ``_prompts``: equal-length prompts sharing a
    page-aligned prefix, distinct tails."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 512, shared).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 512, tail)
                            .astype(np.int32)]) for _ in range(n)]


def _serve(eng, prompts):
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new=MAX_NEW))
    eng.run()
    return {r.uid: r.tokens for r in eng.finished}


_BASE = {}


def _built(kv_quant):
    """(build(...), the port's non-speculative streams): the truth the
    scripted proposer replays."""
    if kv_quant not in _BASE:
        b = build("float32", kv_quant)
        eng = EngineCore(b[1], b[3], device="cpu", **ENGINE)
        _BASE[kv_quant] = b, _serve(eng, _prompts())
    return _BASE[kv_quant]


def _truth(done):
    return {tuple(int(t) for t in p): done[i]
            for i, p in enumerate(_prompts())}


# ---------------------------------------------------------- proposer twin --

@pytest.mark.parametrize("history", [0, 2])
def test_ngram_proposer_twin(history):
    rng = np.random.default_rng(history + 3)
    jp, tp = JProposer(history=history), NGramProposer(history=history)
    calls = hits = 0
    for _ in range(12):
        phrase = rng.integers(0, 40, int(rng.integers(2, 9)))
        reps = int(rng.integers(1, 4))
        stream = np.concatenate(
            [np.tile(phrase, reps), rng.integers(0, 40, int(rng.integers(0, 6)))]
        ).astype(np.int32)
        for cut in range(1, len(stream) + 1):
            k = int(rng.integers(0, 6))
            want = jp.propose(stream[:cut], k)
            assert tp.propose(stream[:cut], k) == want, (cut, k)
            calls += 1
            hits += bool(want)
        jp.observe(stream)
        tp.observe(stream)
    assert (tp.proposals, tp.proposed_tokens) == (jp.proposals,
                                                   jp.proposed_tokens)
    assert 0 < hits < calls
    assert [list(s) for s in tp._streams.values()] == \
        [list(s) for s in jp._streams.values()]


# ----------------------------------------------------------- twin engines --

def _spec_twin(monkeypatch, *, kv_quant, k, prefix_cache):
    built, want = _built(kv_quant)
    corrupt = lambda i, d: None if i % (k + 1) == 0 else i % (k + 1) - 1  # noqa: E731
    made = []

    def proposer():
        made.append(ScriptedProposer(_truth(want), 512, corrupt=corrupt))
        return made[-1]

    out = run_twins(monkeypatch, dtype="float32", kv_quant=kv_quant,
                    prompts=_prompts(), max_new=[MAX_NEW] * 4, built=built,
                    engine_kw=dict(ENGINE, speculative=True, spec_k=k,
                                   prefix_cache=prefix_cache),
                    proposer=proposer)
    je, te = out["engines"]
    assert out["streams"][1] == want, "speculation changed the greedy streams"
    assert made[0].log == made[1].log
    assert te.spec_stats == je.spec_stats and te.drafted_total > 0
    cached = te.prefix_stats.get("cached_pages", 0)
    assert te.pages_in_use == je.pages_in_use == cached
    # full accepts, full rejects and partial accepts all occurred
    kinds = set()
    for drafts, cont in made[1].log:
        n = len(drafts)
        acc = next((j for j in range(n) if drafts[j] != cont[j]), n)
        kinds.add("full" if acc == n else "none" if acc == 0 else "partial")
    assert kinds == ({"full", "none"} if k == 1
                     else {"full", "none", "partial"}), kinds
    return out


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_twin_spec_decode(monkeypatch, k, prefix_cache):
    _spec_twin(monkeypatch, kv_quant=False, k=k, prefix_cache=prefix_cache)


def test_twin_spec_decode_int8(monkeypatch):
    _spec_twin(monkeypatch, kv_quant=True, k=4, prefix_cache=False)


# ------------------------------------------------------------- rollback --

@pytest.mark.parametrize("abort", [False, True])
def test_rejected_drafts_leave_pool_as_never_drafting(abort):
    """The port's twin of the reference's two rollback tests: one lane,
    every draft rejected; after every step (and through an abort right
    after a drafting step) the pool equals a never-drafting engine's."""
    (_, tc, _, tparams), want = _built(False)
    prop = ScriptedProposer(_truth(want), 512, corrupt=lambda i, d: 0)
    plain = EngineCore(tc, tparams, device="cpu", **dict(ENGINE, lanes=1))
    spec = EngineCore(tc, tparams, device="cpu", speculative=True, spec_k=4,
                      proposer=prop, **dict(ENGINE, lanes=1))
    for i, p in enumerate(_prompts()):
        for eng in (plain, spec):
            eng.submit(Request(uid=i, prompt=p, max_new=MAX_NEW))
    drafted, aborted = 0, None
    while plain.scheduler.has_work() or spec.scheduler.has_work():
        plain.step()
        out = spec.step()
        drafted += out.drafted_tokens
        assert out.accepted_tokens == 0
        if abort and aborted is None and out.drafted_tokens:
            aborted = spec.scheduler.running[0].req.uid
            assert spec.abort(aborted) and plain.abort(aborted)
        assert spec.kv.ref == plain.kv.ref
        assert sorted(spec.kv.free) == sorted(plain.kv.free)
        assert spec.page_tables == plain.page_tables
        assert ([(r.req.uid, r.rows) for r in spec.scheduler.running]
                == [(r.req.uid, r.rows) for r in plain.scheduler.running])
    assert drafted > 0 and (aborted is not None) == abort
    got = {r.uid: r.tokens for r in spec.finished}
    assert got == {r.uid: r.tokens for r in plain.finished} == \
        {u: t for u, t in want.items() if u != aborted}
    assert spec.pages_in_use == plain.pages_in_use == 0


# ---------------------------------------------------------- k is no key --

def test_spec_k_is_no_capture_key():
    """A speculative engine that never drafts runs the plain engine's
    schedule with a (lanes, 1 + k) ``last_idx``: the same captures, for
    k = 1 and k = 4, and the same streams."""
    (_, tc, _, tparams), want = _built(False)
    plain = EngineCore(tc, tparams, device="cpu", **ENGINE)
    assert _serve(plain, _prompts()) == want
    for k in (1, 4):
        eng = EngineCore(tc, tparams, device="cpu", speculative=True,
                         spec_k=k, proposer=lambda s, n: [], **ENGINE)
        assert eng.graphs.pick_shape == (LANES, 1 + k)
        assert _serve(eng, _prompts()) == want
        assert eng.trace_count == plain.trace_count
        assert sorted(eng.graphs.keys) == sorted(plain.graphs.keys)
        assert eng.drafted_total == 0


def test_verify_shaped_step_matches_reference():
    """``lm_step_ragged`` with a (lanes, 1 + k) ``last_idx`` over a pool
    with history: lane 0 streams a 6-row chunk, lane 1 verifies a decode
    row and 4 drafts at positions 13..17.  Logits (lanes, 1 + k, V) equal
    the reference's at ``test_torch_model_step.py``'s f32 tolerance, and
    the greedy picks take ``last_idx``'s shape."""
    (jc, tc, jparams, tparams), _ = _built(False)
    pool = history_pool(jc, seed=3)
    rng = np.random.default_rng(4)
    width, k = 16, 4
    tokens = np.zeros(width, np.int32)
    tokens[:11] = rng.integers(0, 512, 11)
    pos = np.zeros(width, np.int32)
    pos[:6] = 9 + np.arange(6)
    pos[6:11] = 13 + np.arange(5)
    table = np.full((width, 4), NUM_PAGES, np.int32)
    table[:6, :2] = [1, 10]
    table[6:11, :3] = [3, 7, 0]
    cu = np.array([0, 6, 11, width], np.int32)
    last_idx = np.array([[5] * (k + 1), 6 + np.arange(k + 1)], np.int32)
    jpool = {n: jnp.asarray(v) for n, v in pool.items()}
    want, _ = jax.jit(lambda p, c: j_lm.lm_step_ragged(
        jc, p, jnp.asarray(tokens), {"periods": {"0": c}}, jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(last_idx), cu_seqlens=jnp.asarray(cu),
        kernel_config=KernelConfig(**KERNEL_CONFIG)))(jparams, jpool)
    args = [torch.from_numpy(a) for a in (tokens, table, pos, last_idx, cu)]

    def step(greedy):
        tpool = trunk_cache_init(tc, NUM_PAGES + 1, PS, "cpu")
        for n, v in pool.items():
            tpool[n].copy_(torch.from_numpy(v))
        return lm_step_ragged(tc, tparams, args[0], tpool, *args[1:],
                              TKernelConfig(**KERNEL_CONFIG), greedy=greedy)

    got = step(False)
    assert got.shape == np.shape(want) == (2, k + 1, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    picks = step(True)
    assert picks.shape == (2, k + 1) and picks.dtype == torch.int32
    assert (picks[0] == picks[0, 0]).all()
