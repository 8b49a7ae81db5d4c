"""PyTorch port vs JAX reference: split-KV paged attention, plain, on the CPU.

The port's plain version with ``kv_split`` scans each range of that many
table slots from a fresh online softmax and merges the ranges with
``combine_partials`` (the CUDA kernel's split pass and combine); the JAX
reference scans the whole table.  The two compute the same attention and
differ only in summation order, so the JAX suite's float tolerance holds,
``atol=2e-5, rtol=1e-4``.  Where the split cannot change a value (one split
covering the table, a lane with a single live split) the port is held to
its own unsplit scan bit for bit.  The CUDA kernel against this plain
version is in ``test_torch_kernels_cuda.py``.
"""
import os
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.streaming_attention import quantize_kv_rows as j_quant  # noqa: E402
from repro.kernels.paged_attention import ref as j_ref  # noqa: E402
from repro.kernels.paged_attention import varlen as j_varlen  # noqa: E402
from repro_torch.core.lut_softmax import NEG_INF, exp_fn  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_reference, paged_attention_varlen,
    paged_attention_varlen_reference, varlen_positions)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    default_kv_split, paged_combine)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    combine_partials, paged_combine_reference)

TOL = dict(atol=2e-5, rtol=1e-4)
P = 6                               # table slots per lane
SPLITS = [1, 2, 3, P, P + 3]        # pages per split: 1, 2, 3 and >= P


def make_case(seed, *, pool="float32", group=2, hkv=2, d=16, ps=4, lq=1,
              b=4):
    """numpy q, pools (bf16 pools hold bf16-exact values; int8 pools are
    quantised by the reference), shuffled tables and ragged lengths, one
    lane with every slot live."""
    rng = np.random.default_rng(seed)
    n = P * b + 1
    k = rng.normal(size=(n, hkv, ps, d)).astype(np.float32)
    v = rng.normal(size=(n, hkv, ps, d)).astype(np.float32)
    if pool == "bfloat16":
        k = np.array(jnp.asarray(k).astype(jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    q = rng.normal(size=(b, hkv * group, lq, d)).astype(np.float32)
    tbl = np.stack([rng.permutation(n)[:P] for _ in range(b)]).astype(np.int32)
    lens = rng.integers(lq, P * ps + 1, size=b).astype(np.int32)
    lens[0] = P * ps
    case = dict(q=q, k=k, v=v, tbl=tbl, lens=lens, ks=None, vs=None,
                pool=pool)
    if pool == "int8":
        for name, s in (("k", "ks"), ("v", "vs")):
            qv, sc = j_quant(jnp.asarray(case[name]).reshape(1, n * hkv, ps, d))
            case[name] = np.asarray(qv).reshape(n, hkv, ps, d)
            case[s] = np.asarray(sc).reshape(n, hkv, ps)
    return case


def jax_out(case, **kw):
    j_pool = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)
              if case["pool"] == "bfloat16" else jnp.asarray(a))
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    fn = jax.jit(partial(j_ref.paged_attention_reference, **kw))
    out = fn(jnp.asarray(case["q"]), j_pool(case["k"]), j_pool(case["v"]),
             jnp.asarray(case["tbl"]), jnp.asarray(case["lens"]),
             k_scale=opt(case["ks"]), v_scale=opt(case["vs"]))
    return np.asarray(out, np.float32)


def torch_args(case):
    pool = (lambda a: torch.from_numpy(a).bfloat16()
            if case["pool"] == "bfloat16" else torch.from_numpy(a))
    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    args = (torch.from_numpy(case["q"]), pool(case["k"]), pool(case["v"]),
            torch.from_numpy(case["tbl"]), torch.from_numpy(case["lens"]))
    return args, dict(k_scale=opt(case["ks"]), v_scale=opt(case["vs"]))


OPTS = {
    "gqa2": dict(),
    "gqa3_chunk": dict(group=3, lq=5),
    "cap_window": dict(lq=3, kw=dict(cap=15.0, window=7)),
}


@pytest.mark.parametrize("exp_mode", ["lut", "exact"])
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_split_plain_matches_jax_reference(pool, opt, exp_mode):
    """Pages per split 1, 2, 3 and >= P, over f32/bf16/int8 pools, GQA 2
    and 3, decode rows and prefill chunks, softcap + window."""
    o = dict(OPTS[opt])
    kw = dict(o.pop("kw", {}), exp_mode=exp_mode)
    case = make_case(len(opt) * 7 + len(pool), pool=pool, **o)
    want = jax_out(case, **kw)
    args, sc = torch_args(case)
    for kv_split in SPLITS:
        got = paged_attention_reference(*args, **sc, **kw, kv_split=kv_split)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"kv_split {kv_split}")


@pytest.mark.parametrize("pool", ["float32", "int8"])
@pytest.mark.parametrize("block_pages", [1, 2, None])
def test_split_covering_the_table_is_the_unsplit_scan(pool, block_pages):
    """kv_split >= P: one split, exp(0) = 1, so the merge is acc / l as the
    unsplit scan divides it, bit for bit."""
    case = make_case(3, pool=pool, lq=2)
    args, sc = torch_args(case)
    kw = dict(sc, block_pages=block_pages, window=9, cap=20.0)
    base = paged_attention_reference(*args, **kw)
    for kv_split in (P, P + 1, 4 * P):
        assert torch.equal(paged_attention_reference(*args, **kw,
                                                     kv_split=kv_split), base)


def test_window_masking_a_whole_split():
    """Decode rows at the end of 24 live rows with a window of 5: with
    one-page splits of 4 rows, every split but the last two sees no key
    (m = NEG_INF, l = 0) and must add nothing."""
    case = make_case(8, lq=1)
    case["lens"][:] = P * 4
    want = jax_out(case, window=5)
    args, sc = torch_args(case)
    for kv_split in (1, 2):
        got = paged_attention_reference(*args, **sc, window=5,
                                        kv_split=kv_split)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("exp_mode", ["lut", "lut0", "exact"])
def test_dead_q_block_equals_the_unsplit_scan(exp_mode):
    """kv_len 1 (a dead q-block of the tiled path, Lq 8): only split 0 is
    live, the rows that see no key emit zeros, and the result is the
    unsplit scan's bit for bit."""
    case = make_case(4, lq=8)
    case["lens"][:] = 1
    args, sc = torch_args(case)
    base = paged_attention_reference(*args, **sc, exp_mode=exp_mode)
    assert not base[:, :, :7].any()
    for kv_split in (1, 2, 3):
        got = paged_attention_reference(*args, **sc, exp_mode=exp_mode,
                                        kv_split=kv_split)
        assert torch.equal(got, base)


def test_lut0_split_runs_and_is_finite():
    """Under lut0 a split changes the online-softmax blocking, which moves
    the order-0 table index at boundaries, so it is held only at the
    kernel's own blocking, on the card; here it runs and stays finite."""
    case = make_case(6, lq=3)
    args, sc = torch_args(case)
    for kv_split in (1, 2, P):
        out = paged_attention_reference(*args, **sc, exp_mode="lut0",
                                        kv_split=kv_split, block_pages=1)
        assert out.shape == args[0].shape and torch.isfinite(out).all()


# ------------------------------------------------------------ the combine --

def merge_f64(m, l, acc):
    """The merge in float64 with the exact exponential."""
    m, l, acc = (np.asarray(t, np.float64) for t in (m, l, acc))
    mx = m.max(axis=0)
    w = np.exp(m - mx)
    return (w[..., None] * acc).sum(0) / np.maximum((w * l).sum(0),
                                                    1e-30)[..., None]


def partials(seed, s=5, shape=(3, 2, 4), d=8, dead=()):
    """Random partials as a split pass leaves them: l > 0, acc = l·(values
    of magnitude ~1); splits listed in ``dead`` saw no key."""
    rng = np.random.default_rng(seed)
    m = rng.normal(scale=3.0, size=(s, *shape)).astype(np.float32)
    l = rng.uniform(1.0, 40.0, size=(s, *shape)).astype(np.float32)
    acc = (rng.normal(size=(s, *shape, d)) * l[..., None]).astype(np.float32)
    for i in dead:
        m[i], l[i], acc[i] = NEG_INF, 0.0, 0.0
    return m, l, acc


@pytest.mark.parametrize("dead", [(), (0,), (1, 3)])
def test_combine_partials_matches_float64_merge(dead):
    m, l, acc = partials(11, dead=dead)
    got = combine_partials(*(torch.from_numpy(t) for t in (m, l, acc)),
                           exp_fn("exact"))
    np.testing.assert_allclose(got.numpy(), merge_f64(m, l, acc), rtol=1e-5,
                               atol=1e-6)
    lut = combine_partials(*(torch.from_numpy(t) for t in (m, l, acc)),
                           exp_fn("lut"))
    # the order-1 LUT is within ~2e-6 (relative) of e^x; the weights enter
    # numerator and denominator alike
    np.testing.assert_allclose(lut.numpy(), merge_f64(m, l, acc), rtol=1e-4,
                               atol=1e-5)


def test_combine_partials_one_split_divides_directly():
    m, l, acc = (torch.from_numpy(t) for t in partials(2, s=1))
    for mode in ("lut", "lut0", "exact"):
        got = combine_partials(m, l, acc, exp_fn(mode))
        assert torch.equal(got, acc[0] / torch.clamp(l[0], min=1e-30)[..., None])


def test_combine_of_splits_that_saw_nothing_is_zero():
    m, l, acc = (torch.from_numpy(t) for t in partials(3, s=3, dead=(0, 1, 2)))
    assert not combine_partials(m, l, acc, exp_fn("lut")).any()


def test_combine_reference_reads_only_live_splits():
    """The kernel's combine reads a lane's first ⌈⌈kv_len/ps⌉/kv_split⌉
    splits; the rest of the workspace is never written, here NaN."""
    ps, kv_split, s = 4, 2, 4
    m, l, acc = partials(5, s=s, shape=(3, 2, 4))
    kv_len = np.array([1, 9, 32], np.int32)     # 1, 2 and 4 live splits
    live = [1, 2, 4]
    to_kernel = lambda t: torch.from_numpy(np.moveaxis(t, 0, 2).copy())  # noqa: E731
    pm, pl, pa = to_kernel(m), to_kernel(l), to_kernel(acc)
    for b, n in enumerate(live):
        pm[b, :, n:], pl[b, :, n:], pa[b, :, n:] = np.nan, np.nan, np.nan
    got = paged_combine_reference(pm, pl, pa, torch.from_numpy(kv_len),
                                  page_size=ps, kv_split=kv_split,
                                  exp_mode="exact")
    assert torch.isfinite(got).all()
    for b, n in enumerate(live):
        np.testing.assert_allclose(got[b].numpy(),
                                   merge_f64(m[:n, b], l[:n, b], acc[:n, b]),
                                   rtol=1e-5, atol=1e-6)
    wrapped = paged_combine(pm, pl, pa, torch.from_numpy(kv_len), page_size=ps,
                            kv_split=kv_split, exp_mode="exact",
                            dtype=torch.bfloat16)
    assert wrapped.dtype == torch.bfloat16
    assert torch.equal(wrapped, got.bfloat16())


# ------------------------------------------------------------ varlen path --

def make_stream(seed, *, nq, group=2, hkv=2, d=16, ps=4, dead=2, quant=False):
    rng = np.random.default_rng(seed)
    lanes = len(nq)
    n = P * lanes + 1
    k = rng.normal(size=(n, hkv, ps, d)).astype(np.float32)
    v = rng.normal(size=(n, hkv, ps, d)).astype(np.float32)
    lens = np.array([int(rng.integers(m, P * ps + 1)) for m in nq])
    cu = np.concatenate([[0], np.cumsum(nq)]).astype(np.int32)
    lane_tbl = np.stack([rng.permutation(n - 1)[:P] for _ in range(lanes)])
    pos = np.concatenate([varlen_positions(cu, lens), np.zeros(dead, np.int32)])
    tbl = np.concatenate([lane_tbl[np.repeat(np.arange(lanes), nq)],
                          np.full((dead, P), n - 1)]).astype(np.int32)
    cu = np.concatenate([cu, [cu[-1] + dead]]).astype(np.int32)
    q = rng.normal(size=(len(pos), hkv * group, d)).astype(np.float32)
    s = dict(q=q, k=k, v=v, tbl=tbl, pos=pos.astype(np.int32), cu=cu, ks=None,
             vs=None)
    if quant:
        for name, sc in (("k", "ks"), ("v", "vs")):
            qv, scale = j_quant(jnp.asarray(s[name]).reshape(1, n * hkv, ps, d))
            s[name] = np.asarray(qv).reshape(n, hkv, ps, d)
            s[sc] = np.asarray(scale).reshape(n, hkv, ps)
    return s


@pytest.mark.parametrize("kv_split", [1, 2, 3, P])
@pytest.mark.parametrize("quant", [False, True])
def test_varlen_tiled_split_matches_jax(kv_split, quant):
    """The q-block-tiled path (block_q 4: decode lanes, chunks straddling
    q-blocks, dead padding rows) with split-KV, window + softcap, against
    the reference's unsplit varlen scan; the wrapper's CPU path is the plain
    version."""
    s = make_stream(kv_split, nq=[1, 6, 1, 3], quant=quant)
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    kw = dict(cu_seqlens=s["cu"], block_q=4, window=9, cap=20.0)
    want = j_varlen.paged_attention_varlen_reference(
        *(jnp.asarray(s[k]) for k in ("q", "k", "v", "tbl", "pos")),
        k_scale=opt(s["ks"], jnp.asarray), v_scale=opt(s["vs"], jnp.asarray),
        **kw)
    args = [torch.from_numpy(s[k]) for k in ("q", "k", "v", "tbl", "pos")]
    sc = dict(k_scale=opt(s["ks"], torch.from_numpy),
              v_scale=opt(s["vs"], torch.from_numpy))
    got = paged_attention_varlen_reference(*args, **sc, **kw,
                                           kv_split=kv_split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(paged_attention_varlen(*args, **sc, **kw,
                                              kv_split=kv_split), got)


def test_wrapper_cpu_path_passes_kv_split():
    case = make_case(9, lq=2)
    args, sc = torch_args(case)
    before = paged_attention.launches, paged_attention.combine_launches
    for kv_split in (None, 2):
        assert torch.equal(
            paged_attention(*args, **sc, kv_split=kv_split),
            paged_attention_reference(*args, **sc, kv_split=kv_split))
    assert (paged_attention.launches, paged_attention.combine_launches) == before


def test_default_kv_split_is_about_64_keys():
    assert [default_kv_split(ps) for ps in (1, 8, 16, 32, 64, 128)] == \
        [64, 8, 4, 2, 1, 1]
    args, sc = torch_args(make_case(1))
    with pytest.raises(ValueError, match="kv_split"):
        paged_attention_reference(*args, **sc, kv_split=0)
