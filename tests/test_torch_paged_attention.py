"""PyTorch port vs JAX reference: paged attention (plain version, varlen
dataflow, q-block layout) on the CPU.  The CUDA kernel against its plain
version on the card is in ``test_torch_kernels_cuda.py``.

Float tolerance is the JAX suite's own, ``atol=2e-5, rtol=1e-4``: both
sides run the same f32 page-block scan with the LUT exponential, and only
the summation order of the dot products differs.  Integer layouts are
compared bit for bit."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro.core.streaming_attention import quantize_kv_rows as j_quant  # noqa: E402
from repro.kernels.paged_attention import ref as j_ref  # noqa: E402
from repro.kernels.paged_attention import varlen as j_varlen  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_reference, paged_attention_varlen,
    paged_attention_varlen_reference, q_block_layout, validate_cu_seqlens,
    varlen_positions)

TOL = dict(atol=2e-5, rtol=1e-4)


def make_case(seed, *, b=3, group=2, hkv=2, d=16, ps=8, p=4, lq=1,
              quant=False, dtype=np.float32):
    """Pools, shuffled per-lane tables, ragged lengths and q, as numpy."""
    rng = np.random.default_rng(seed)
    n = p * b + 1
    kp = rng.normal(size=(n, hkv, ps, d)).astype(np.float32)
    vp = rng.normal(size=(n, hkv, ps, d)).astype(np.float32)
    q = rng.normal(size=(b, hkv * group, lq, d)).astype(dtype)
    tbl = np.stack([rng.permutation(n)[:p] for _ in range(b)]).astype(np.int32)
    lens = rng.integers(lq, p * ps + 1, size=b).astype(np.int32)
    case = dict(q=q, k=kp, v=vp, tbl=tbl, lens=lens, ks=None, vs=None)
    if quant:
        for name, s in (("k", "ks"), ("v", "vs")):
            qv, sc = j_quant(jnp.asarray(case[name]).reshape(1, n * hkv, ps, d))
            case[name] = np.asarray(qv).reshape(n, hkv, ps, d)
            case[s] = np.asarray(sc).reshape(n, hkv, ps)
    return case


def run_both(case, **kw):
    """(JAX reference, port plain version) outputs for one case."""
    j = j_ref.paged_attention_reference(
        jnp.asarray(case["q"]), jnp.asarray(case["k"]), jnp.asarray(case["v"]),
        jnp.asarray(case["tbl"]), jnp.asarray(case["lens"]),
        k_scale=None if case["ks"] is None else jnp.asarray(case["ks"]),
        v_scale=None if case["vs"] is None else jnp.asarray(case["vs"]), **kw)
    t = paged_attention_reference(
        torch.from_numpy(case["q"]), torch.from_numpy(case["k"]),
        torch.from_numpy(case["v"]), torch.from_numpy(case["tbl"]),
        torch.from_numpy(case["lens"]),
        k_scale=None if case["ks"] is None else torch.from_numpy(case["ks"]),
        v_scale=None if case["vs"] is None else torch.from_numpy(case["vs"]),
        **kw)
    return np.asarray(j, np.float32), t.to(torch.float32).numpy()


# --------------------------------------------------- plain paged attention --

@pytest.mark.parametrize("group", [1, 2, 3])
@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("lq", [1, 5])
def test_plain_matches_jax_reference(group, ps, lq):
    """GQA 1–3, page sizes 4/8/16, decode rows and prefill chunks, shuffled
    tables, ragged lengths."""
    case = make_case(100 * group + 10 * ps + lq, group=group, ps=ps, lq=lq)
    want, got = run_both(case, exp_mode="lut")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw", [
    dict(window=7, cap=15.0),
    dict(exp_mode="lut0"),
    dict(exp_mode="exact"),
    dict(block_pages=1),
    dict(block_pages=3, window=5),
    dict(scale=0.3, cap=30.0),
], ids=["window+cap", "lut0", "exact", "bp1", "bp3+window", "scale+cap"])
@pytest.mark.parametrize("lq", [1, 4])
def test_plain_options_match_jax_reference(kw, lq):
    case = make_case(7 + lq, group=2, ps=8, lq=lq)
    want, got = run_both(case, **kw)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dequant", ["block", "page"])
@pytest.mark.parametrize("lq", [1, 5])
def test_plain_int8_matches_jax_reference(dequant, lq):
    case = make_case(31 + lq, group=2, d=32, ps=8, lq=lq, quant=True)
    want, got = run_both(case, dequant=dequant, block_pages=2)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_bf16_matches_jax_reference():
    """bf16 q: both sides compute in f32 and round the output once; a
    summation-order difference may move that rounding by one bf16 ulp
    (rtol 2^-7 covers one ulp of the 8-bit mantissa)."""
    case = make_case(5, group=2, ps=8, lq=3)
    jq = jnp.asarray(case["q"]).astype(jnp.bfloat16)
    j = j_ref.paged_attention_reference(
        jq, jnp.asarray(case["k"]), jnp.asarray(case["v"]),
        jnp.asarray(case["tbl"]), jnp.asarray(case["lens"]))
    t = paged_attention_reference(
        torch.from_numpy(case["q"]).bfloat16(), torch.from_numpy(case["k"]),
        torch.from_numpy(case["v"]), torch.from_numpy(case["tbl"]),
        torch.from_numpy(case["lens"]))
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_wrapper_cpu_path_is_the_plain_version():
    case = make_case(3, group=2, ps=8, lq=2)
    args = [torch.from_numpy(case[k]) for k in ("q", "k", "v", "tbl", "lens")]
    before = paged_attention.launches
    np.testing.assert_array_equal(paged_attention(*args).numpy(),
                                  paged_attention_reference(*args).numpy())
    assert paged_attention.launches == before      # no kernel on the CPU


# ------------------------------------------------------------- varlen path --

def make_stream(seed, *, lanes=4, group=2, hkv=2, d=16, ps=8, p=3, nq=None,
                dead=0):
    """A packed stream (port of the reference suite's make_stream), with
    optional dead padding rows covered by a trailing pseudo-segment."""
    rng = np.random.default_rng(seed)
    n = p * lanes + 1
    hq = hkv * group
    kp = rng.normal(size=(n, hkv, ps, d)).astype(np.float32)
    vp = rng.normal(size=(n, hkv, ps, d)).astype(np.float32)
    nq = np.asarray(nq if nq is not None else rng.integers(1, 5, size=lanes))
    lanes = len(nq)
    lens = np.array([int(rng.integers(nq[i], p * ps + 1)) for i in range(lanes)])
    cu = np.concatenate([[0], np.cumsum(nq)]).astype(np.int32)
    lane_tbl = np.stack([rng.permutation(n - 1)[:p] for _ in range(lanes)])
    q_pos = varlen_positions(cu, lens)
    tok_tbl = lane_tbl[np.repeat(np.arange(lanes), nq)].astype(np.int32)
    if dead:
        q_pos = np.concatenate([q_pos, np.zeros(dead, np.int32)])
        tok_tbl = np.concatenate([tok_tbl, np.full((dead, p), n - 1, np.int32)])
        cu = np.concatenate([cu, [cu[-1] + dead]]).astype(np.int32)
    t = len(q_pos)
    q = rng.normal(size=(t, hq, d)).astype(np.float32)
    return dict(q=q, k=kp, v=vp, tbl=tok_tbl, pos=q_pos.astype(np.int32),
                cu=cu, ks=None, vs=None)


def quantize_stream(s):
    n, hkv, ps, d = s["k"].shape
    for name, sc in (("k", "ks"), ("v", "vs")):
        qv, scale = j_quant(jnp.asarray(s[name]).reshape(1, n * hkv, ps, d))
        s[name] = np.asarray(qv).reshape(n, hkv, ps, d)
        s[sc] = np.asarray(scale).reshape(n, hkv, ps)
    return s


def varlen_both(s, **kw):
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    j = j_varlen.paged_attention_varlen_reference(
        jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
        jnp.asarray(s["tbl"]), jnp.asarray(s["pos"]),
        k_scale=opt(s["ks"], jnp.asarray), v_scale=opt(s["vs"], jnp.asarray),
        **kw)
    t = paged_attention_varlen_reference(
        torch.from_numpy(s["q"]), torch.from_numpy(s["k"]),
        torch.from_numpy(s["v"]), torch.from_numpy(s["tbl"]),
        torch.from_numpy(s["pos"]),
        k_scale=opt(s["ks"], torch.from_numpy),
        v_scale=opt(s["vs"], torch.from_numpy), **kw)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("group", [1, 2, 3])
@pytest.mark.parametrize("ps", [4, 8])
def test_varlen_untiled_matches_jax(group, ps):
    s = make_stream(11 * group + ps, group=group, ps=ps)
    want, got = varlen_both(s, exp_mode="lut")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("block_q", [2, 3, 4, 8])
@pytest.mark.parametrize("quant", [False, True])
def test_varlen_tiled_matches_jax(block_q, quant):
    """Decode lanes between prefill chunks that straddle every Bq, dead
    bucket-padding rows, window + softcap, float and int8 pools."""
    s = make_stream(block_q, nq=[1, 5, 1, 7, 3], ps=8, p=3, dead=3)
    if quant:
        s = quantize_stream(s)
    want, got = varlen_both(s, cu_seqlens=s["cu"], block_q=block_q,
                            window=5, cap=20.0)
    np.testing.assert_allclose(got, want, **TOL)


def test_varlen_wrapper_equals_reference_on_cpu():
    s = make_stream(2, nq=[1, 6, 2], dead=2)
    args = [torch.from_numpy(s[k]) for k in ("q", "k", "v", "tbl", "pos")]
    kw = dict(cu_seqlens=s["cu"], block_q=4)
    np.testing.assert_array_equal(
        paged_attention_varlen(*args, **kw).numpy(),
        paged_attention_varlen_reference(*args, **kw).numpy())


def test_dead_rows_are_isolated():
    """Bucket-padding rows (all-scratch table, position 0) change nothing
    for live tokens and emit finite values themselves."""
    s = make_stream(4, nq=[2, 3, 1])
    live = paged_attention_varlen_reference(
        *[torch.from_numpy(s[k]) for k in ("q", "k", "v", "tbl", "pos")])
    s2 = make_stream(4, nq=[2, 3, 1], dead=3)
    both = paged_attention_varlen_reference(
        *[torch.from_numpy(s2[k]) for k in ("q", "k", "v", "tbl", "pos")])
    t = live.shape[0]
    np.testing.assert_array_equal(both[:t].numpy(), live.numpy())
    assert torch.isfinite(both[t:]).all()


@pytest.mark.parametrize("cu,lens,bq", [
    ([0, 1, 6, 7, 14, 17], [9, 5, 31, 12, 3], 4),
    ([0, 1, 6, 7, 14, 17], [9, 5, 31, 12, 3], 8),
    ([0, 3, 4, 8, 8, 11], [10, 1, 6, 6, 20], 3),
    ([0, 8, 9, 10, 16], [40, 22, 9, 6], 8),
    ([0, 2], [7], 64),
])
def test_q_block_layout_bit_equal(cu, lens, bq):
    """The four arrays of q_block_layout equal the reference bit for bit
    (shapes, dtypes and values), dead blocks and zero-width lanes included."""
    cu = np.asarray(cu, np.int32)
    t = int(cu[-1])
    pos = varlen_positions(cu, lens)
    got = q_block_layout(torch.from_numpy(cu), torch.from_numpy(pos), t,
                         min(bq, t))
    want = j_varlen.q_block_layout(jnp.asarray(cu), jnp.asarray(pos), t,
                                   min(bq, t))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_varlen_positions_matches_jax():
    cu = np.array([0, 3, 4, 8], np.int32)
    lens = np.array([10, 1, 6], np.int32)
    np.testing.assert_array_equal(varlen_positions(cu, lens),
                                  j_varlen.varlen_positions(cu, lens))


def test_validate_cu_seqlens_raises_like_jax():
    for bad, t, match in (([1, 4], 4, "start at 0"),
                          ([0, 5, 3, 8], 8, "non-decreasing"),
                          ([0, 3, 6], 8, "pseudo-segment"),
                          ([0], 0, "1-D")):
        with pytest.raises(ValueError, match=match):
            validate_cu_seqlens(np.array(bad, np.int32), t)
        with pytest.raises(ValueError, match=match):
            j_varlen.validate_cu_seqlens(np.array(bad, np.int32), t)
    ok = validate_cu_seqlens(np.array([0, 3, 8], np.int32), 8)
    assert ok.dtype == torch.int32 and ok.tolist() == [0, 3, 8]
