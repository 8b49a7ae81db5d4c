"""The port's seeded in-step sampling against the JAX reference.

- **PRNG**: ``core/prng.py`` is bit-equal to ``jax.random`` (threefry2x32,
  partitionable bits) for ``PRNGKey``, ``fold_in``, the bits and the
  uniforms, over seeds and counters that include 0 and 2^32 − 1; Gumbel
  noise within ``GUMBEL_ATOL`` (torch's ``log`` and XLA's round apart on
  ~23% of draws, by at most 4.8e-7 here);
- **sampler twin**: ``sample_rows`` against the reference's jitted
  ``sample_rows`` on shared logits.  The softmax sum and the top-p
  cumulative sum add in another order (XLA's reduce-window against
  torch's scan), so the keep sets may differ only at boundary tokens,
  whose mass before them lies within ``MASS_TOL`` of p; a pick may differ
  only at a near-tie of ``scores + g``, the reference's winner ahead of
  the port's by less than twice the largest gap between the two arms'
  ``scores + g`` (counted; none occur on these inputs);
- the reference's **edge cases**: top_k ≥ V bit-identical to no mask,
  top_p = 1 keeps the vocabulary, tiny temperatures stay finite and
  greedy, temperature 0 is the host lowest-index tie-break;
- **engine twin**: the JAX ``EngineCore`` and the port's on one short
  ``deepseek-7b-smoke`` trace of greedy and seeded requests, step by step
  (``tests/_torch_twin.py``): streams equal;
- the port's own engine: batch invariance (alone against batched, with
  and without the prefix cache), preemption replay, seed reproducibility
  and dependence, the speculative form's verify rows greedy, the eager
  arm equal to the captured one, and sampling params adding no capture
  beyond the one sampler per engine (none for greedy traffic).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.lut_softmax import lut_log_softmax as j_log_softmax  # noqa: E402
from repro.core.lut_softmax import lut_softmax as j_softmax  # noqa: E402
from repro.serving.core import greedy_tokens  # noqa: E402
from repro.serving.sampling import _request_keys as j_keys  # noqa: E402
from repro.serving.sampling import sample_rows as j_sample_rows  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.lut_softmax import lut_log_softmax  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serving import (EngineCore, Request,  # noqa: E402
                                 SamplingParams)
from repro_torch.serving.sampling import (_masked_scores,  # noqa: E402
                                          _request_keys, greedy_rows,
                                          sample_in_step, sample_rows)
from repro_torch.kernels.lut_exp import lut_exp  # noqa: E402
from tests._torch_twin import prompts_for, run_twins  # noqa: E402

GUMBEL_ATOL = 2e-6      # ~1 f32 ulp at the largest "low"-mode draw (~16.6)
MASS_TOL = 2e-6         # 32 ulps of 1.0: the order-dependent top-p mass
SEEDS = np.array([0, 1, 7, 42, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2,
                  2 ** 32 - 1], np.uint32)
COUNTERS = np.array([0, 1, 5, 31, 2 ** 16, 2 ** 31, 2 ** 32 - 2,
                     2 ** 32 - 1], np.uint32)


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ------------------------------------------------------------------- PRNG --

def test_prng_key_and_fold_in_test_vector():
    """``fold_in(PRNGKey(7), 3)`` has the key words JAX gives."""
    want = np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(7), 3)))
    got = prng.fold_in(*prng.prng_key(7), 3)
    assert [int(w) for w in got] == want.tolist() == [276534068, 1641862660]


@pytest.mark.parametrize("n", [1, 7, 512, 1031])
def test_prng_bits_uniforms_and_gumbel_match_jax(n):
    """Every (seed, counter) pair: the folded key words, the partitionable
    bits and the uniforms bit for bit; Gumbel within ``GUMBEL_ATOL``."""
    s, c = np.meshgrid(SEEDS, COUNTERS)
    s, c = s.ravel(), c.ravel()
    keys = np.asarray(jax.random.key_data(jax.jit(j_keys)(s, c)))
    tiny = np.finfo(np.float32).tiny
    draw = jax.jit(jax.vmap(lambda k: (
        jax.random.bits(k, (n,), jnp.uint32),
        jax.random.uniform(k, (n,), jnp.float32, tiny, 1.0),
        jax.random.gumbel(k, (n,), jnp.float32))))
    bits, uni, gum = (np.asarray(a) for a in draw(jax.jit(j_keys)(s, c)))
    k1, k2 = _request_keys(_i64(s), _i64(c))
    assert (k1.numpy() == keys[:, 0]).all() and (k2.numpy() == keys[:, 1]).all()
    tb = prng.random_bits(k1, k2, n)
    assert (tb.numpy() == bits.astype(np.int64)).all()
    tu = prng.uniform(tb, prng.F32_TINY, 1.0).numpy()
    assert (tu.view(np.int32) == uni.view(np.int32)).all()
    tg = prng.gumbel(k1, k2, n).numpy()
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(tg, gum, rtol=0, atol=GUMBEL_ATOL)


def test_threefry_block_matches_jax():
    """The raw hash on arbitrary key and count words."""
    from jax._src.prng import threefry_2x32
    rng = np.random.default_rng(5)
    k = rng.integers(0, 2 ** 32, (2,), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax.jit(threefry_2x32)(k, x.ravel())).reshape(2, 64)
    got = prng.threefry2x32(int(k[0]), int(k[1]), _i64(x[0]), _i64(x[1]))
    assert (torch.stack(got).numpy() == want.astype(np.int64)).all()


def test_lut_log_softmax_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(6, 300)) * 4).astype(np.float32)
    where = rng.random((6, 300)) < 0.7
    where[0] = False                                # a fully masked row
    want = np.asarray(jax.jit(lambda a, w: j_log_softmax(a, where=w))(x, where))
    got = lut_log_softmax(torch.from_numpy(x), where=torch.from_numpy(where),
                          exp=lut_exp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    got = lut_log_softmax(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(j_log_softmax)(x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# --------------------------------------------------------- sampler twin --

@jax.jit
def _ref_pipeline(logits, temperature, top_k, top_p, seed, counter):
    """The reference's ``sample_rows`` body, step by step, returning its
    intermediates (its picks are checked equal to ``sample_rows``'s)."""
    n, v = logits.shape
    t = jnp.where(temperature > 0.0, temperature, 1.0)[:, None]
    x = jnp.maximum((logits - jnp.max(logits, axis=-1, keepdims=True)) / t,
                    -1e30)
    kth = jnp.take_along_axis(
        jnp.sort(x, axis=-1),
        (v - jnp.clip(jnp.where(top_k > 0, top_k, v), 1, v))[:, None], axis=-1)
    x = jnp.where(x >= kth, x, -1e30)
    order = jnp.argsort(-x, axis=-1)
    probs = jnp.take_along_axis(j_softmax(x, axis=-1), order, axis=-1)
    csum = jnp.cumsum(probs, axis=-1)
    p = jnp.clip(top_p, 0.0, 1.0)[:, None]
    keep_sorted = ((csum - probs) < p) | (p >= 1.0)
    keep = jnp.zeros((n, v), bool).at[jnp.arange(n)[:, None], order].set(
        keep_sorted)
    scores = j_log_softmax(x, axis=-1, where=keep)
    g = jax.vmap(lambda k: jax.random.gumbel(k, (v,), jnp.float32))(
        j_keys(seed, counter))
    return x, keep, csum - probs, order, scores + g


def _rows(seed=0, n=16, v=33):
    """The reference suite's rows: random, plus exact ties, a flat row, a
    one-token-dominant row and a hard-masked head."""
    rng = np.random.default_rng(seed)
    lg = rng.normal(size=(n, v)).astype(np.float32)
    lg[0, :] = 0.0
    lg[1, 5] = lg[1, 20] = lg[1].max() + 1.0
    lg[2, 7] += 40.0
    lg[3, :10] = -1e30
    return lg


CASES = {
    "mixed": dict(temps=(0.0, 0.7, 1.0, 1.5), top_k=(0, 1, 5, 50, 600),
                  top_p=(1.0, 0.9, 0.5, 0.95)),
    "temperature only": dict(temps=(0.8, 1.0, 1.2), top_k=(0,),
                             top_p=(1.0,)),
    "chat": dict(temps=(0.8,), top_k=(50,), top_p=(0.95,)),
}


def _params(rng, n, case):
    c = CASES[case]
    return (rng.choice(c["temps"], n).astype(np.float32),
            rng.choice(c["top_k"], n).astype(np.int32),
            rng.choice(c["top_p"], n).astype(np.float32),
            rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2 ** 20, n).astype(np.int32))


def _port(lg, temp, tk, tp, seed, ctr, fn=sample_rows):
    return fn(torch.from_numpy(lg), torch.from_numpy(temp),
              torch.from_numpy(tk), torch.from_numpy(tp), _i64(seed),
              _i64(ctr))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("v", [33, 512])
def test_sample_rows_twin(case, v):
    """Picks equal the reference's jitted ``sample_rows`` save counted
    near-ties; keep sets equal save boundary tokens."""
    rng = np.random.default_rng(v + len(case))
    n = 48
    lg = (rng.normal(size=(n, v)) * 3).astype(np.float32)
    lg[:4] = _rows(v=v)[:4]
    params = _params(rng, n, case)
    want = np.asarray(jax.jit(j_sample_rows)(lg, *params))
    x_r, keep_r, before_r, order_r, z_r = (
        np.asarray(a) for a in _ref_pipeline(lg, *params))
    samples = params[0] > 0
    assert (np.argmax(z_r, -1)[samples] == want[samples]).all()

    got = _port(lg, *params).numpy()
    x, keep = _masked_scores(torch.from_numpy(lg), torch.from_numpy(params[0]),
                             torch.from_numpy(params[1]),
                             torch.from_numpy(params[2]), lut_exp)
    assert (x.numpy().view(np.int32) == x_r.view(np.int32)).all()
    diff = keep.numpy() != keep_r
    for i, j in zip(*np.nonzero(diff)):
        at = int(np.nonzero(order_r[i] == j)[0][0])
        assert abs(before_r[i, at] - params[2][i]) <= MASS_TOL, (i, j)
    z = (lut_log_softmax(x, where=keep, exp=lut_exp)
         + prng.gumbel(*_request_keys(_i64(params[3]), _i64(params[4])),
                       v)).numpy()
    near_ties = 0
    for i in np.nonzero(got != want)[0]:
        assert samples[i], f"greedy row {i} differs"
        gap = np.abs(np.where(keep_r[i] & keep.numpy()[i], z_r[i] - z[i], 0))
        lead = z_r[i, want[i]] - z_r[i, got[i]]
        assert 0 <= lead <= 2 * gap.max(), (i, lead, gap.max())
        near_ties += 1
    assert near_ties == 0, f"{near_ties} near-tie picks (allowed, but rare)"
    assert ((0 <= got) & (got < v)).all()


def test_in_step_greedy_matches_host_tie_break():
    """Temperature-0 rows are the host's lowest-index rule, crafted ties
    included, and equal the reference's in-step picks."""
    rng = np.random.default_rng(0)
    lg = rng.normal(size=(6, 33)).astype(np.float32)
    lg[0, 4] = lg[0, 19] = lg[0].max() + 1.0
    lg[1, :] = 0.0
    lg[2, 32] = lg[2].max() + 1.0
    z = np.zeros((6,), np.int32)
    params = (np.zeros((6,), np.float32), z, np.ones((6,), np.float32),
              z.astype(np.uint32), z)
    got = _port(lg, *params).numpy()
    assert (got == greedy_tokens(lg)).all()
    assert got[0] == 4 and got[1] == 0 and got[2] == 32
    assert (got == np.asarray(jax.jit(j_sample_rows)(lg, *params))).all()
    assert (greedy_rows(torch.from_numpy(lg)).numpy() == got).all()


def test_greedy_tokens_matches_reference():
    """``serving.core.greedy_tokens``: the reference's numpy pick over
    leading axes, crafted ties included, equal index for index."""
    from repro_torch.serving.core import greedy_tokens as t_greedy_tokens
    rng = np.random.default_rng(1)
    lg = rng.normal(size=(3, 4, 29)).astype(np.float32)
    lg[0, 0, [3, 17]] = lg[0, 0].max() + 1.0
    lg[1, 2, :] = -1.0
    got = t_greedy_tokens(lg)
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got, greedy_tokens(lg))
    assert got[0, 0] == 3 and got[1, 2] == 0


def _picks(lg, *, temps, top_k=0, top_p=1.0, seed=0):
    n = lg.shape[0]
    return _port(lg, np.full((n,), temps, np.float32),
                 np.full((n,), top_k, np.int32),
                 np.full((n,), top_p, np.float32),
                 np.full((n,), seed, np.uint32),
                 np.arange(n, dtype=np.int32)).numpy()


@pytest.mark.parametrize("top_k", [33, 40])      # k == V and k > V
def test_top_k_at_least_vocab_is_bit_identical_to_no_mask(top_k):
    lg = _rows()
    for seed in (0, 3, 11, 2 ** 31):
        for temps in (0.7, 1.3):
            a = _picks(lg, temps=temps, top_k=top_k, seed=seed)
            assert (a == _picks(lg, temps=temps, top_k=0, seed=seed)).all()


def test_top_p_one_keeps_the_whole_vocabulary():
    lg = _rows()
    n = lg.shape[0]
    _, keep = _masked_scores(torch.from_numpy(lg), torch.full((n,), 1.1),
                             torch.zeros((n,), dtype=torch.int32),
                             torch.ones((n,)), lut_exp)
    assert keep.all()
    for seed in (0, 7, 123):
        a = _picks(lg, temps=1.1, top_p=1.0, seed=seed)
        assert (a == _picks(lg, temps=1.1, top_p=np.float32(1.0),
                            seed=seed)).all()
        assert ((0 <= a) & (a < lg.shape[1])).all()


@pytest.mark.parametrize("tiny", [1e-30, 1e-8, 1e-4])
def test_tiny_temperature_stays_finite_and_greedy_in_the_limit(tiny):
    lg = _rows()
    n = lg.shape[0]
    x, keep = _masked_scores(torch.from_numpy(lg), torch.full((n,), tiny),
                             torch.zeros((n,), dtype=torch.int32),
                             torch.ones((n,)), lut_exp)
    assert torch.isfinite(lut_log_softmax(x, where=keep, exp=lut_exp)).all()
    want = greedy_rows(torch.from_numpy(lg)).numpy()
    assert (want[1:4] != 0).any()
    for seed in (0, 5, 99):
        got = _picks(lg, temps=tiny, seed=seed)
        assert (got[2:] == want[2:]).all(), (tiny, seed, got, want)


def test_speculative_form_samples_row_zero_only():
    """(lanes, 1 + k, V): row 0 is ``sample_rows`` of row 0 with the lane's
    params, every later row the greedy pick, as the reference's form with
    its verify rows' temperature forced to 0."""
    rng = np.random.default_rng(4)
    lanes, r, v = 5, 4, 64
    lg = (rng.normal(size=(lanes, r, v)) * 2).astype(np.float32)
    temp, tk, tp, seed, ctr = _params(rng, lanes, "mixed")
    kw = dict(temperature=torch.from_numpy(temp), top_k=torch.from_numpy(tk),
              top_p=torch.from_numpy(tp), seed=_i64(seed), counter=_i64(ctr))
    got = sample_in_step(torch.from_numpy(lg), **kw).numpy()
    assert got.shape == (lanes, r)
    assert (got[:, 0] == sample_rows(torch.from_numpy(lg[:, 0]),
                                     **kw).numpy()).all()
    assert (got[:, 1:] == greedy_tokens(lg[:, 1:])).all()
    from repro.serving.sampling import sample_in_step as j_in_step
    want = np.asarray(jax.jit(j_in_step)(
        lg, temperature=temp, top_k=tk, top_p=tp, seed=seed, counter=ctr))
    assert (got == want).all()


def test_sample_row_matches_reference():
    """The one-row helper: the reference's ``sample_row`` on the same row,
    params and generated-token count."""
    from repro.serving import SamplingParams as JSamplingParams
    from repro.serving.sampling import sample_row as j_sample_row
    from repro_torch.serving.sampling import sample_row
    lg = _rows(v=64)
    for i, kw in enumerate([dict(), dict(temperature=0.9, seed=5),
                            dict(temperature=1.3, top_k=7, top_p=0.8,
                                 seed=2 ** 32 - 1)]):
        want = j_sample_row(lg[4 + i], JSamplingParams(**kw), 3 + i)
        assert sample_row(torch.from_numpy(lg[4 + i]), SamplingParams(**kw),
                          3 + i) == want


# ---------------------------------------------------------- engine twin --

def test_engine_twin_mixed_greedy_and_seeded():
    """The JAX ``EngineCore`` and the port's, step by step, on greedy and
    seeded requests (f32): every committed token equal."""
    sp = [None, dict(temperature=0.8, top_k=50, top_p=0.95, seed=1000),
          dict(temperature=1.0, seed=7), None,
          dict(temperature=1.3, top_p=0.9, seed=2 ** 32 - 1)]
    lens, news = (3, 21, 9, 14, 6), (7, 5, 9, 4, 6)
    r = run_twins(None, dtype="float32", kv_quant=False,
                  prompts=prompts_for(512, 13, lens), max_new=news,
                  engine_kw=dict(lanes=3, page_size=8, num_pages=24,
                                 chunk_size=8), sampling=sp)
    j, t = r["streams"]
    assert j == t and all(len(t[i]) == news[i] for i in range(5))
    je, te = r["engines"]
    assert te.trace_count == je.trace_count
    assert te.graphs.sampler_captures == 1


# ------------------------------------------------------- the port alone --

@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("deepseek-7b-smoke").replace(dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _engine(smoke, **kw):
    cfg, params = smoke
    for k, v in dict(lanes=4, page_size=4, num_pages=64,
                     chunk_size=8).items():
        kw.setdefault(k, v)
    return EngineCore(cfg, params, device="cpu", **kw)


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.uid: r.tokens for r in eng.finished}


def _mine(cfg, uid=100, seed=42):
    return Request(uid=uid, prompt=prompts_for(cfg.vocab_size, 8, (5,))[0],
                   max_new=6, sampling=SamplingParams(
                       temperature=0.8, top_k=50, top_p=0.95, seed=seed))


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_sampled_stream_batch_invariant(smoke, prefix_cache):
    """A sampled request's stream alone equals its stream among greedy
    neighbours that put it on another lane; the neighbours' greedy streams
    are unperturbed."""
    cfg, _ = smoke
    others = prompts_for(cfg.vocab_size, 7, (13, 7, 21))
    alone = _serve(_engine(smoke, prefix_cache=prefix_cache),
                   [_mine(cfg)])[100]
    crowd = [Request(uid=i, prompt=p, max_new=6)
             for i, p in enumerate(others)]
    shared = _serve(_engine(smoke, prefix_cache=prefix_cache),
                    crowd + [_mine(cfg)])
    assert shared[100] == alone
    for i in range(3):
        assert shared[i] == _serve(_engine(smoke), [
            Request(uid=i, prompt=others[i], max_new=6)])[i]


def test_sampled_stream_survives_preemption_replay(smoke):
    cfg, _ = smoke

    def reqs():
        return [Request(uid=i, prompt=p, max_new=6,
                        sampling=SamplingParams(temperature=0.9, seed=5))
                for i, p in enumerate(prompts_for(cfg.vocab_size, 3,
                                                  (17, 15, 13, 11)))]

    roomy = _serve(_engine(smoke), reqs())
    tight = _engine(smoke, num_pages=14)
    for r in reqs():
        tight.submit(r)
    preempted = []
    while tight.scheduler.has_work():
        preempted += tight.step().preempted
    assert preempted, "the pool never forced a preemption"
    assert {r.uid: r.tokens for r in tight.finished} == roomy


def test_seeded_streams_reproducible_and_seed_dependent(smoke):
    cfg, _ = smoke
    p = prompts_for(cfg.vocab_size, 1, (9,))[0]

    def stream(seed):
        return _serve(_engine(smoke), [Request(
            uid=100, prompt=p, max_new=8,
            sampling=SamplingParams(temperature=1.2, seed=seed))])[100]

    assert stream(7) == stream(7)
    assert stream(7) != stream(8)


def test_speculative_engine_keeps_sampled_stream(smoke):
    """A speculative engine drafts for greedy lanes only; a sampled lane's
    row 0 draws as in the plain engine, so its stream is the plain one,
    and the picks keep the engine's (lanes, 1 + k) shape."""
    cfg, _ = smoke
    rep = lambda s, k: [int(s[-1])] * k                  # noqa: E731
    greedy = Request(uid=0, prompt=np.tile(np.arange(4, dtype=np.int32), 4),
                     max_new=8)
    eng = _engine(smoke, speculative=True, spec_k=3, proposer=rep)
    got = _serve(eng, [greedy, _mine(cfg)])
    assert eng.graphs.pick_shape == (4, 4) and eng.drafted_total > 0
    assert eng.graphs.sampler_captures == 1
    plain = _serve(_engine(smoke), [Request(uid=0, prompt=greedy.prompt,
                                            max_new=8), _mine(cfg)])
    assert got == plain


def test_eager_arm_equals_captured_arm(smoke):
    cfg, _ = smoke

    def reqs():
        return [Request(uid=i, prompt=p, max_new=5, sampling=SamplingParams(
            temperature=0.0 if i % 2 else 0.9, seed=i))
            for i, p in enumerate(prompts_for(cfg.vocab_size, 4,
                                              (6, 11, 3, 9)))]

    assert _serve(_engine(smoke, capture=False), reqs()) == \
        _serve(_engine(smoke), reqs())


def test_sampling_params_add_no_capture(smoke):
    """A second wave with all-new temperatures, seeds, top-k and top-p
    captures nothing; the sampler is captured once, and an all-greedy
    engine never runs it."""
    cfg, _ = smoke
    eng = _engine(smoke)

    def wave(seed, temps):
        _serve(eng, [Request(
            uid=seed * 100 + i, prompt=p, max_new=4, sampling=SamplingParams(
                temperature=t, top_k=None if t == 0 else 20 + seed,
                top_p=None if t == 0 else 0.8 + 0.01 * seed,
                seed=None if t == 0 else seed * 7 + i))
            for i, (p, t) in enumerate(zip(
                prompts_for(cfg.vocab_size, seed, (5, 9, 13, 7)), temps))])

    wave(1, (0.0, 0.7, 1.3, 0.0))
    traced = eng.trace_count
    assert traced > 0 and eng.graphs.sampler_captures == 1
    wave(2, (1.1, 0.0, 0.5, 2.0))
    assert eng.trace_count == traced and eng.graphs.sampler_captures == 1
    greedy = _engine(smoke)
    _serve(greedy, [Request(uid=0, prompt=np.arange(7, dtype=np.int32),
                            max_new=4)])
    assert greedy.graphs.sampler is None and greedy.graphs.sampler_captures == 0
