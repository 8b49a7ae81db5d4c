"""The port's padded-block oracle beside the rest of the port, on the CPU.

- **the block step** (``lm_prefill_chunk_paged``, kernel #2's block entry
  by its plain version) against the reference's on one (lanes, C) block:
  a decode lane, a prefill chunk whose padding rows sit at negative
  positions, and an idle lane at ``kv_len`` 0 — logits, and the pool
  outside the scratch page, f32 float and int8 pools; the rows that see
  no key come out exactly zero;
- **the registry's** ``paged`` and ``paged_varlen`` backends against the
  reference's (resolution over call facts, and outputs on random pools),
  and ``PagedKVCache.gather`` against the reference's (bit for bit), with
  paged attention through the table equal to contiguous attention over
  the gathered view (the oracle it exists for);
- **the reference's padded-mode cases** on the port alone (the JAX
  engine stands behind both port engines in ``test_torch_padded.py``,
  ``test_torch_padded_families.py`` and the ragged twins): the ragged step
  token-identical to the padded one with strictly better padding
  efficiency (``test_engine_core.py:84``), O(1) block shapes over a
  stream of distinct prompt lengths (``:118``), preemption-resume
  (``:186``), the token budget (``:308``), the prefix cache in padded
  mode (``test_prefix_cache.py:330``, ``:367``), speculative decoding
  against a padded baseline (``test_spec_decode.py:165``), the in-step
  sampler against the padded oracle's host draws (``test_sampling.py:
  141``), and the deprecated ``PagedServingEngine`` shim against the slot
  engine (``test_paged_serving.py:53``).

About 15 s alone (half of it JAX's start), one intra-op thread."""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import attention_api as j_api  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.serving.paged import PagedKVCache as JPool  # noqa: E402
from repro_torch.core import attention_api as t_api  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.serving import (EngineCore, PagedServingEngine,  # noqa: E402
                                 Request, SamplingParams, ServingEngine)
from repro_torch.serving.paged import PagedKVCache as TPool  # noqa: E402
from tests._torch_twin import build, pool_leaves, prompts_for  # noqa: E402
from tests.test_spec_decode import ScriptedProposer  # noqa: E402


def by_uid(done):
    return {r.uid: r.tokens for r in done}


def serve(eng, prompts, news, sampling=None, uid0=0):
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=uid0 + i, prompt=p, max_new=news[i],
                           sampling=sampling and sampling[i]))
    outs = []
    while eng.scheduler.has_work():
        outs.append(eng.step())
    return by_uid(eng.finished), outs


_BUILT = {}


def built(dtype="float32", kv_quant=False):
    key = (dtype, kv_quant)
    if key not in _BUILT:
        _BUILT[key] = build(dtype, kv_quant)
    return _BUILT[key]


def engine(dtype="float32", kv_quant=False, **kw):
    _, tc, _, tp = built(dtype, kv_quant)
    return EngineCore(tc, tp, device="cpu", **kw)


# ------------------------------------------------------------ block step --

NUM_PAGES, PS, C = 12, 8, 8


def block_inputs(vocab):
    """Lane 0 decodes at row 11 (pages 3, 4); lane 1 prefills 5 tokens at
    rows 0..4 (page 0): its 3 padding rows sit at rows −3..−1; lane 2 is
    idle (kv_len 0: every row negative).  Pools hold random history."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, vocab, (3, C)).astype(np.int32)
    table = np.full((3, 2), NUM_PAGES, np.int32)
    table[0] = [3, 4]
    table[1, 0] = 0
    kv_len = np.array([12, 5, 0], np.int32)
    q_len = np.array([1, 5, 0], np.int32)
    return tokens, table, kv_len, q_len


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_chunk_paged_matches_reference(kv_quant):
    """Logits of the two live lanes within the model step's f32 tolerance
    (atol = rtol = 1e-4, ``tests/test_torch_model_step.py``), the idle
    lane's too; every pool leaf outside the scratch page likewise (int8:
    dequantised, within one quantisation step); the scratch page, where
    several padding rows land on one (page, offset), is left out."""
    jc, tc, jp, tp = built("float32", kv_quant)
    from tests.test_torch_model_step import history_pool
    hist = history_pool(jc, seed=2)
    tokens, table, kv_len, q_len = block_inputs(jc.vocab_size)
    jpool = {"periods": {"0": {k: jnp.asarray(v) for k, v in hist.items()}}}
    jl, jpool = jax.jit(lambda p, c, *a: j_lm.lm_prefill_chunk_paged(
        jc, p, a[0], c, *a[1:]))(jp, jpool, *map(jnp.asarray, (
            tokens, table, kv_len, q_len)))
    tpool = t_lm.trunk_cache_init(tc, NUM_PAGES + 1, PS, "cpu")
    for k, v in hist.items():
        tpool[k].copy_(torch.from_numpy(v))
    tl, tpool2 = t_lm.lm_prefill_chunk_paged(
        tc, tp, *map(torch.from_numpy, (tokens,)), tpool,
        *map(torch.from_numpy, (table, kv_len, q_len)))
    assert tpool2 is tpool                       # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    a, b = pool_leaves(jpool, NUM_PAGES), pool_leaves(tpool, NUM_PAGES)
    for k in a:
        if k in ("k", "v") and kv_quant:
            d = np.abs(a[k] * a[k + "s"][..., None]
                       - b[k] * b[k + "s"][..., None])
            assert d.max() <= a[k + "s"].max(), k
        else:
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    # the block's live rows landed where the table says; history elsewhere
    assert not np.array_equal(b["k"][:, 0, :, :5], hist["k"][:, 0, :, :5])
    np.testing.assert_array_equal(b["k"][:, 0, :, 5:], hist["k"][:, 0, :, 5:])
    np.testing.assert_array_equal(b["k"][:, 1:3], hist["k"][:, 1:3])


def test_rows_that_see_no_key_are_zero():
    """Kernel #2's block entry (its plain version here) on an idle lane
    (kv_len 0) and on a chunk's padding rows at negative positions: every
    key is masked, and the rows come out exactly zero, as the card must
    give them (``chip_smoke.py``'s padded phase)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(3, 4, C, 16)).astype(np.float32))
    pool = torch.from_numpy(rng.normal(size=(5, 2, PS, 16)).astype(np.float32))
    table = torch.tensor([[0, 1], [2, 4], [4, 4]], dtype=torch.int32)
    kv_len = torch.tensor([12, 5, 0], dtype=torch.int32)
    for kw in (dict(), dict(kv_split=1), dict(cap=30.0, window=4)):
        out = paged_attention(q, pool, pool, table, kv_len, **kw)
        assert torch.isfinite(out).all()
        assert not out[2].any()                          # idle lane
        assert not out[1, :, :C - 5].any()               # rows −3..−1
        assert out[1, :, C - 5:].abs().min() > 0
        via = t_api.attention(q, pool, pool, page_table=table, kv_len=kv_len,
                              causal=True, **{k: v for k, v in kw.items()
                                              if k != "kv_split"})
        if "kv_split" not in kw:
            assert torch.equal(via, out)


# -------------------------------------------------------------- registry --

FACTS = [dict(has_page_table=True), dict(has_page_table=True, lq=1),
         dict(has_page_table=True, is_ragged=True),
         dict(has_page_table=True, platform="tpu"),
         dict(has_page_table=True, is_ragged=True, platform="tpu"),
         dict(has_page_table=True, has_kv_pos=True),
         dict(has_page_table=True, static_lengths=False)]


@pytest.mark.parametrize("backend", ["auto", "pallas", "jnp", "naive",
                                     "naive_decode", "paged",
                                     "paged_varlen"])
@pytest.mark.parametrize("facts", FACTS)
def test_paged_resolution_matches_reference(backend, facts):
    """Calls over page pools resolve to the reference's backend, explicit
    choices falling back as there; the port reads ``cuda`` for ``tpu``."""
    base = dict(lq=16, lkv=16, platform="cpu", static_lengths=True,
                has_kv_pos=False)
    base.update(facts)
    j_call = j_api.AttentionCall(**base, inside_shard_map=False)
    t_call = t_api.AttentionCall(**dict(base, platform={
        "tpu": "cuda"}.get(base["platform"], base["platform"])))
    try:
        want = j_api.resolve_backend(backend, j_call, fallback=True).name
    except ValueError:
        with pytest.raises(ValueError):
            t_api.resolve_backend(backend, t_call, fallback=True)
        return
    assert t_api.resolve_backend(backend, t_call, fallback=True).name == want
    if backend != "auto" and not j_api.get_backend(backend).supports(j_call):
        with pytest.raises(ValueError, match="does not support"):
            t_api.resolve_backend(backend, t_call)


def _pools(rng, n=6):
    return [rng.normal(size=(n, 2, PS, 16)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("kw", [dict(), dict(cap=20.0, window=5)])
def test_paged_backends_match_reference(kw):
    """``attention(..., page_table=)`` (the ``paged`` backend) and with
    ``q_pos`` (``paged_varlen``, at the reference's block shapes) against
    the reference's, f32, within its kernel suite's atol = 2e-5,
    rtol = 1e-4."""
    from repro.kernels.autotune import KernelConfig as JKC
    from repro_torch.kernels.autotune import KernelConfig as TKC
    rng = np.random.default_rng(5)
    kp, vp = _pools(rng)
    q = rng.normal(size=(2, 4, 3, 16)).astype(np.float32)
    table = np.array([[0, 2], [5, 1]], np.int32)
    kv_len = np.array([11, 7], np.int32)
    common = dict(causal=True, exp_mode="lut", **kw)
    want = jax.jit(lambda *a: j_api.attention(
        *a[:3], backend="paged", page_table=a[3], kv_len=a[4], **common))(
        *map(jnp.asarray, (q, kp, vp, table, kv_len)))
    got = t_api.attention(*map(torch.from_numpy, (q, kp, vp)),
                          backend="paged", page_table=torch.from_numpy(table),
                          kv_len=torch.from_numpy(kv_len), **common)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    # one packed stream: lane 0's 3 rows then lane 1's 2, one dead row
    qs = rng.normal(size=(1, 4, 6, 16)).astype(np.float32)
    pos = np.array([8, 9, 10, 5, 6, 0], np.int32)
    tok_tbl = np.array([table[0]] * 3 + [table[1]] * 2 + [[6, 6]], np.int32)
    tok_tbl[5] = kp.shape[0] - 1
    cu = np.array([0, 3, 5, 6], np.int32)
    want = jax.jit(lambda *a: j_api.attention(
        *a[:3], backend="paged_varlen", page_table=a[3], q_pos=a[4],
        cu_seqlens=a[5], kernel_config=JKC(block_q=2, block_pages=1),
        **common))(*map(jnp.asarray, (qs, kp, vp, tok_tbl, pos, cu)))
    got = t_api.attention(*map(torch.from_numpy, (qs, kp, vp)),
                          backend="paged_varlen",
                          page_table=torch.from_numpy(tok_tbl),
                          q_pos=torch.from_numpy(pos),
                          cu_seqlens=torch.from_numpy(cu),
                          kernel_config=TKC(block_q=2, block_pages=1),
                          **common)
    np.testing.assert_allclose(got.numpy()[:, :, :5],
                               np.asarray(want)[:, :, :5], atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_gather_matches_reference(kv_quant):
    """``PagedKVCache.gather``: the same random pool in both packages →
    the same contiguous views, bit for bit; and attention through the
    table equals contiguous attention over the gathered view."""
    jc, tc, _, _ = built("float32", kv_quant)
    jkv, tkv = JPool(j_build_model(jc), NUM_PAGES, PS), TPool(
        tc, NUM_PAGES, PS, device="cpu")
    rng = np.random.default_rng(9)
    pool = {k: (rng.integers(-127, 128, v.shape).astype(np.int8)
                if v.dtype == torch.int8 else
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            for k, v in tkv.pool.items()}
    for k, v in pool.items():
        tkv.pool[k].copy_(torch.from_numpy(v))
    jpool = {"periods": {"0": {k: jnp.asarray(v) for k, v in pool.items()}}}
    tbl = np.array([[3, 0, 7], [11, 12, 12]], np.int32)
    want = jkv.gather(jpool, jnp.asarray(tbl))["periods"]["0"]
    got = tkv.gather(tkv.pool, torch.from_numpy(tbl))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    assert torch.equal(got["k"][:, 0, :, PS:2 * PS], tkv.pool["k"][:, 0])
    if kv_quant:
        return
    q = torch.from_numpy(rng.normal(size=(2, 4, 1, 16)).astype(np.float32))
    kv_len = torch.tensor([19, 6], dtype=torch.int32)
    paged = paged_attention(q, tkv.pool["k"][1], tkv.pool["v"][1],
                            torch.from_numpy(tbl), kv_len)
    for lane in range(2):
        n = int(kv_len[lane])
        flat = t_api.attention(q[lane:lane + 1], got["k"][1, lane:lane + 1, :, :n],
                               got["v"][1, lane:lane + 1, :, :n],
                               backend="naive", causal=False)
        np.testing.assert_allclose(paged[lane].numpy(), flat[0].numpy(),
                                   atol=2e-5, rtol=1e-4)


# ------------------------------------------- the reference's padded cases --

MIXED = dict(lanes=3, page_size=8, num_pages=24, chunk_size=8)


@pytest.mark.parametrize("dtype,kv_quant", [("float32", False),
                                            ("bfloat16", False),
                                            ("float32", True)])
def test_ragged_step_token_identical_to_padded_step(dtype, kv_quant):
    """``test_engine_core.py:84`` on the port: its ragged engine against
    its padded oracle on one mixed trace — identical streams, and the
    ragged packing's live / computed rows strictly above the block's and
    at least 0.9."""
    prompts = prompts_for(512, 31, (5, 27, 11, 18, 8, 3))
    news = (6, 4, 8, 3, 7, 5)
    want, outs_p = serve(engine(dtype, kv_quant, mode="padded", **MIXED),
                         prompts, news)
    got, outs_r = serve(engine(dtype, kv_quant, **MIXED), prompts, news)
    assert got == want, "ragged step diverged from the padded oracle"
    assert any(o.mixed for o in outs_r)

    def eff(outs):
        return (sum(o.live_rows for o in outs)
                / max(sum(o.padded_rows for o in outs), 1))
    assert eff(outs_r) > eff(outs_p), (eff(outs_r), eff(outs_p))
    assert eff(outs_r) >= 0.9


def test_distinct_prompt_lengths_trace_O1_block_shapes():
    """``test_engine_core.py:118``: the padded step's shapes are (C in {1,
    chunk}) × (power-of-two table width), never a prompt length: a first
    stream warms them (at most 3 × 2), a second of new lengths adds
    none."""
    eng = engine(mode="padded", lanes=1, page_size=8, num_pages=64,
                 chunk_size=8)

    def go(lens, seed):
        serve(eng, prompts_for(512, seed, lens), [2] * len(lens),
              uid0=seed * 100)
        eng.finished.clear()
    go(tuple(range(2, 23)) + (24, 27, 29), seed=1)
    traced = eng.trace_count
    assert traced <= 3 * 2, traced
    assert eng.obs.registry.value("step_traces_total") == traced
    go((23, 25, 26, 28, 30), seed=2)
    assert eng.trace_count == traced


def test_preempted_request_resumes_token_identical_padded():
    """``test_engine_core.py:186`` in padded mode: every stream of the
    contended run equals its solo run, and the pool drains."""
    prompts = prompts_for(512, 21, (4, 12))
    news = (26, 14)
    solo = {}
    for uid in range(2):
        eng = engine(mode="padded", lanes=2, page_size=4, num_pages=16,
                     chunk_size=4)
        solo.update(serve(eng, [prompts[uid]], [news[uid]], uid0=uid)[0])
    eng = engine(mode="padded", lanes=2, page_size=4, num_pages=8,
                 chunk_size=4)
    got, outs = serve(eng, prompts, news)
    assert any(o.preempted for o in outs)
    assert got == solo
    assert eng.pages_in_use == 0


def test_token_budget_keeps_decode_ahead_of_prefill_padded():
    """``test_engine_core.py:308`` in padded mode: with ``step_tokens=5``
    every step carries at most 5 tokens, and a mixed step always its
    decode."""
    eng = engine(mode="padded", lanes=2, page_size=8, num_pages=16,
                 chunk_size=8, step_tokens=5)
    eng.submit(Request(uid=0, prompt=prompts_for(512, 1, (4,))[0],
                       max_new=12))
    eng.step()
    eng.submit(Request(uid=1, prompt=prompts_for(512, 2, (30,))[0],
                       max_new=2))
    mixed = False
    while eng.scheduler.has_work():
        out = eng.step()
        assert out.prefill_tokens + out.decode_tokens <= 5
        if out.mixed:
            assert out.decode_tokens >= 1 and out.prefill_tokens <= 4
            mixed = True
    assert mixed
    assert len(by_uid(eng.finished)[0]) == 12


@pytest.mark.parametrize("kv_quant", [False, True])
def test_shared_prefix_serving_token_identical_padded(kv_quant):
    """``test_prefix_cache.py:330`` in padded mode: four requests over one
    page-aligned system prompt serve the cache-off streams, and each warm
    admission hits exactly the prefix."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 512, 3 * PS).astype(np.int32)
    prompts = [np.concatenate([[i], rng.integers(0, 512, n)]).astype(np.int32)
               for i, n in enumerate((5, 9, 7, 4))]
    prompts = [np.concatenate([shared, t]).astype(np.int32) for t in prompts]
    news = (6, 4, 8, 5)

    def run(prefix_cache):
        eng = engine("float32", kv_quant, mode="padded", lanes=2,
                     page_size=PS, num_pages=32, chunk_size=PS,
                     prefix_cache=prefix_cache)
        serve(eng, prompts[:1], news[:1])
        serve(eng, prompts[1:], news[1:], uid0=1)
        return by_uid(eng.finished), eng.prefix_stats.get("hit_tokens", 0)
    want, _ = run(False)
    got, hits = run(True)
    assert got == want and hits == 3 * len(shared)


def test_hit_serving_survives_preemption_resume_padded():
    """``test_prefix_cache.py:367`` in padded mode: the cache on over a
    pool too small for the load; evictions publish, resumes re-hit, and
    every stream equals its solo run."""
    prompts = prompts_for(512, 21, (4, 12))
    news = (26, 14)
    solo = {}
    for uid in range(2):
        eng = engine(mode="padded", lanes=2, page_size=4, num_pages=16,
                     chunk_size=4)
        solo.update(serve(eng, [prompts[uid]], [news[uid]], uid0=uid)[0])
    eng = engine(mode="padded", lanes=2, page_size=4, num_pages=8,
                 chunk_size=4, prefix_cache=True)
    got, outs = serve(eng, prompts, news)
    assert any(o.preempted for o in outs) and got == solo


def test_speculative_requires_the_ragged_mode():
    """The reference's ``ValueError`` (``core.py:178-182``)."""
    with pytest.raises(ValueError, match="requires mode='ragged'"):
        engine(mode="padded", speculative=True)
    with pytest.raises(ValueError, match="unknown EngineCore mode"):
        engine(mode="blocked")


@pytest.mark.parametrize("kv_quant,k,prefix_cache", [
    (False, 1, False), (False, 4, True), (True, 2, False)])
def test_spec_greedy_token_identical_to_padded_base(kv_quant, k,
                                                    prefix_cache):
    """``test_spec_decode.py:165`` with the padded baseline: speculative
    greedy decode under a proposer that mixes full accepts, partial
    accepts and full rejects emits the padded engine's streams."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 512, 2 * PS).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 512, 4)]).astype(
        np.int32) for _ in range(4)]
    news = [8] * 4
    kw = dict(lanes=2, page_size=PS, num_pages=32, chunk_size=PS)
    want, _ = serve(engine("float32", kv_quant, mode="padded", **kw),
                    prompts, news)
    truth = {tuple(int(t) for t in p): want[i] for i, p in enumerate(prompts)}
    prop = ScriptedProposer(truth, 512, corrupt=lambda i, d: None
                            if i % (k + 1) == 0 else i % (k + 1) - 1)
    eng = engine("float32", kv_quant, speculative=True, spec_k=k,
                 proposer=prop, prefix_cache=prefix_cache, **kw)
    got, _ = serve(eng, prompts, news)
    assert got == want and eng.drafted_total > 0


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("feature", ["plain", "spec", "prefix"])
def test_temperature_zero_identity_against_padded_oracle(kv_quant, feature):
    """``test_sampling.py:141``: temperature 0 through the ragged step's
    in-step sampler reproduces the padded oracle's host-greedy streams,
    with speculation or the prefix cache on."""
    prompts = prompts_for(512, 13, (3, 21, 9, 14))
    news = (7, 5, 9, 4)
    sp = [SamplingParams(temperature=0.0)] * 4
    kw = dict(lanes=4, page_size=PS, num_pages=32, chunk_size=PS)
    got, _ = serve(engine("float32", kv_quant, speculative=feature == "spec",
                          prefix_cache=feature == "prefix", **kw),
                   prompts, news, sp)
    want, _ = serve(engine("float32", kv_quant, mode="padded", **kw),
                    prompts, news, sp)
    assert got == want


def test_sampled_streams_agree_between_modes():
    """Seeded sampling in both packings: the padded oracle draws each
    sampling lane on the host through ``sample_row``, the ragged step in
    the graph; with the same per-request keys the streams are equal, and
    greedy neighbours keep their streams."""
    prompts = prompts_for(512, 7, (13, 7, 21, 5))
    news = (6, 6, 6, 6)
    sp = [None, SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                               seed=42),
          None, SamplingParams(temperature=1.0, seed=5)]
    kw = dict(lanes=4, page_size=PS, num_pages=32, chunk_size=PS)
    want, _ = serve(engine(mode="padded", **kw), prompts, news, sp)
    got, _ = serve(engine(**kw), prompts, news, sp)
    assert got == want


def test_paged_serving_engine_shim_matches_slot_engine():
    """``test_paged_serving.py:53``: the deprecated shim warns, answers like
    an engine, and serves the slot engine's greedy streams."""
    _, tc, _, tp = built()
    rng = np.random.default_rng(7)
    reqs = lambda: [Request(uid=i, prompt=rng.integers(  # noqa: E731
        0, 512, 4 + (i % 3) * 3).astype(np.int32), max_new=n)
        for i, n in enumerate((3, 9, 5, 7, 2))]
    with pytest.warns(DeprecationWarning, match="EngineCore"):
        shim = PagedServingEngine(tc, tp, slots=2, page_size=8, num_pages=16,
                                  device="cpu")
    slot = ServingEngine(tc, tp, slots=2, max_len=64, device="cpu")
    rng = np.random.default_rng(7)
    for r in reqs():
        slot.submit(r)
    rng = np.random.default_rng(7)
    for r in reqs():
        shim.submit(r)
    assert len(shim.queue) == 5 and shim.active == [None, None]
    assert shim.step() == 2 and shim.active[1] is not None
    assert len(shim.page_tables) == 2 and shim.pages_in_use > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = by_uid(shim.run())
    assert got == by_uid(slot.run())
    assert shim.pages_in_use == 0 and shim.max_len == 128
    assert shim.kv is shim.core.kv and shim.core.lanes == 2
