"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``cuda`` and skips without a card.  This file imports
neither JAX nor the reference package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the LUT exponential is bit-exact (the kernel repeats the plain
version's operations in order, each rounded once); f32 paged attention
holds the reference suite's ``atol=2e-5, rtol=1e-4`` (the kernel walks one
page at a time, the plain version 8 pages per step, so the online-softmax
rescaling and the dot products round in another order; split-KV calls
hold it against the plain version cut into the same splits, whose merge
sums the splits in another order); f32 streaming
attention holds the reference kernel suite's ``atol=3e-5, rtol=1e-4``
(``tests/test_kernels.py``: an online softmax over 64-key tiles against
the materialised-logits plain version); bf16 outputs lie within one bf16
ulp of the plain version beyond the f32 atol (both round one f32 result);
the int8 matmul is bit-exact, accumulators and outputs, on both variants
and both weight layouts (an exact int32 sum, then the same two f32
products in the same order); the activation quantisation is bit-exact,
values and scale (the same rounded f32 operations, and an absmax that
does not depend on order); the bf16 unembed sits
within 2·K·2^-24·(|x|·|h|) of the widened f32 product (each sums exact
products in f32, in its own order); the sampler's key words, random bits
and uniforms are bit-equal on the card and the CPU (integer operations),
its picks equal save near-ties of ``scores + g`` (the card's ``log``,
sums and scan round apart from the CPU's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quant  # noqa: E402
from repro_torch.core.streaming_attention import quantize_kv_rows  # noqa: E402
from repro_torch.core.streaming_attention import (  # noqa: E402
    streaming_attention as attention_scan)
from repro_torch.kernels.int8_matmul import (  # noqa: E402
    int8_matmul, int8_matmul_2d, int8_matmul_2d_ref, int8_matmul_ref)
from repro_torch.kernels.lut_exp import lut_exp, lut_exp_ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_reference, paged_attention_varlen,
    paged_attention_varlen_reference, varlen_positions)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    default_kv_split, paged_combine)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_combine_reference)
from repro_torch.kernels.streaming_attention import (  # noqa: E402
    attention_ref, streaming_attention)
from repro_torch.kernels.streaming_attention.ops import (  # noqa: E402
    BLOCK_K, block_k, softmax_exp)

TOL = dict(atol=2e-5, rtol=1e-4)
EDGES = np.array([-1e30, -100.0, 0.0, 80.0], np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", [0, 1])
def test_lut_exp_kernel_bit_exact(cuda_device, rng, dtype, order):
    x = np.concatenate([EDGES, rng.uniform(-100, 90, 100003)]).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
    before = lut_exp.launches
    got = lut_exp(xt, order=order)
    torch.cuda.synchronize()
    assert lut_exp.launches == before + 1
    want = lut_exp_ref(xt, order=order)
    assert torch.equal(got.float(), want.float())


def nonpos_sweep(rng):
    """x <= 0 where the LUT's floors turn: each table step k/128 of ln 2
    down to −126·ln 2 with its two f32 neighbours, the smallest denormal
    (t − ⌊t⌋ rounds to 1 there), both zeros and uniform draws."""
    grid = (np.arange(-126 * 128, 1, dtype=np.float64) / 128
            * np.log(2.0)).astype(np.float32)
    return np.concatenate([
        EDGES[:3], np.float32([-0.0, -1e-45, -87.0, -86.99999]), grid,
        np.nextafter(grid, np.float32(-np.inf)),
        np.minimum(np.nextafter(grid, np.float32(np.inf)), 0),
        -rng.uniform(0, 100, 100003).astype(np.float32)])


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 1])
def test_softmax_exp_kernel_bit_exact(cuda_device, rng, order):
    """The tensor-core kernel's exponential (``lut_exp_nonpos``: floors by
    magic-constant additions, no conversion instructions) is the plain LUT
    bit for bit on x <= 0."""
    xt = torch.from_numpy(nonpos_sweep(rng)).to(cuda_device)
    got = softmax_exp(xt, order=order)
    assert torch.equal(got.view(torch.int32),
                       lut_exp_ref(xt, order=order).view(torch.int32))


def bf16_ulps(got, want, atol):
    """Largest |got − want| beyond ``atol``, in bf16 ulps of the larger
    magnitude."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float((((g - w).abs() - atol).clamp_min(0.0) / ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_paged_attention_at_a_rank_head_band(cuda_device, pool, tmp_path):
    """Kernel #2 in 2 gloo ranks on the card, each at its band of 16 of
    deepseek-7b's 32 heads (the head count ``EngineCore(mesh=2)`` launches
    it at): one split pass and one combine a rank, the gathered bands
    within the plain version's tolerance (f32: atol 2e-5, rtol 1e-4;
    bf16 and int8 pools in bf16: one ulp beyond the atol) and bit-equal to
    the kernel's launch over all 32 heads."""
    # by its bare name, from this directory: the card's machine may have
    # another package called ``tests``
    from _torch_tp_ranks import band_rank
    from repro_torch.launch.mesh import spawn
    for res in spawn(band_rank, 2, pool, root=str(tmp_path), timeout=300):
        assert res["launches"] == (1, 1)
        assert res["bits_equal_full"]
        if pool == "float32":
            assert res["close"], res["max_abs_err"]
        else:
            assert res["bf16_ulps"] <= 1.0, res["bf16_ulps"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_attention_at_a_rank_head_band(cuda_device, dtype,
                                                 tmp_path):
    """Kernel #3 and its backward in 2 gloo ranks on the card, each at its
    band of 16 of deepseek-7b's 32 heads (what ``Trainer(mesh=)``'s model
    axis launches): one forward and one backward launch a rank; the
    gathered output and gradients bit-equal to the 32-head launch's (a
    head's arithmetic does not depend on the launch's head count) and
    within the plain versions' tolerances (the largest error over the
    largest value: f32 3e-5, bf16 one bf16 ulp)."""
    from _torch_tp_ranks import attention_band_rank
    from repro_torch.launch.mesh import spawn
    rel = 3e-5 if dtype == "float32" else 2.0 ** -7
    for res in spawn(attention_band_rank, 2, dtype, root=str(tmp_path),
                     timeout=300):
        assert res["launches"] == (1, 1)
        assert res["bits_equal_full"]
        assert max(res["rel_err"]) <= rel, res["rel_err"]


def make_case(seed, dev, *, b=5, group=2, hkv=2, d=16, ps=8, p=6, lq=1,
              quant=False, exact_logits=False):
    g = torch.Generator().manual_seed(seed)
    n = p * b + 1
    k = torch.randn((n, hkv, ps, d), generator=g)
    v = torch.randn((n, hkv, ps, d), generator=g)
    q = torch.randn((b, hkv * group, lq, d), generator=g)
    if exact_logits:        # small integers: every q·k is exact in f32
        k = torch.randint(-3, 4, k.shape, generator=g).float()
        q = torch.randint(-3, 4, q.shape, generator=g).float()
        if quant:           # a ±127 per row: int8 scale exactly 1
            k = k * 42.0
            k[..., 0] = 127.0
    tbl = torch.stack([torch.randperm(n, generator=g)[:p] for _ in range(b)])
    lens = torch.randint(lq, p * ps + 1, (b,), generator=g)
    sc = dict(k_scale=None, v_scale=None)
    if quant:
        k, ks = quantize_kv_rows(k.reshape(1, n * hkv, ps, d))
        v, vs = quantize_kv_rows(v.reshape(1, n * hkv, ps, d))
        k, v = k.reshape(n, hkv, ps, d), v.reshape(n, hkv, ps, d)
        sc = dict(k_scale=ks.reshape(n, hkv, ps).to(dev),
                  v_scale=vs.reshape(n, hkv, ps).to(dev))
    args = [t.to(dev) for t in (q, k, v, tbl.int(), lens.int())]
    return args, sc


CASES = [
    dict(group=1, ps=16, lq=1, d=128),
    dict(group=4, ps=16, lq=8, d=128),
    dict(group=2, ps=4, lq=5, d=64),
    dict(group=3, ps=64, lq=2, d=256),
    dict(group=2, ps=8, lq=3, d=32, quant=True),
    # 24 int8 values per row is not a whole 16-byte vector: scalar staging;
    # a 12-row page is not a power-of-two key tile: row-serial softmax
    dict(group=1, ps=8, lq=2, d=24, quant=True),
    dict(group=2, ps=12, lq=3, d=64),
]


# The order-0 LUT steps by 0.54% at table boundaries, so its result depends
# on the online-softmax blocking and flips with a logit one rounding apart:
# it is held against the plain version scanning one page per step in the
# kernel's splits, as the kernel does (pages of up to 32 rows, which the
# kernel stages whole), over integer q and k whose logits are exact on both
# sides.
KWS = [dict(), dict(window=9, cap=20.0), dict(exp_mode="exact"),
       dict(exp_mode="lut0", block_pages=1)]
MATRIX = [(c, kw) for c in CASES for kw in KWS
          if not (kw.get("exp_mode") == "lut0" and c["ps"] > 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,kw", MATRIX)
def test_paged_attention_kernel_matches_plain(cuda_device, case, kw):
    """GQA 1–4, Lq 1–8, page sizes 4–64, head dims 16–256, int8 pools,
    window + softcap and every exp mode."""
    lut0 = kw.get("exp_mode") == "lut0"
    args, sc = make_case(17, cuda_device, exact_logits=lut0, **case)
    before = paged_attention.launches
    got = paged_attention(*args, **sc, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    # the plain version cut into the kernel's default splits (its blocking)
    want = paged_attention_reference(*args, **sc, **kw,
                                     kv_split=default_kv_split(case["ps"]))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_paged_attention_kernel_bf16_within_one_ulp(cuda_device):
    args, sc = make_case(3, cuda_device, group=2, ps=16, lq=8, d=128)
    args[0] = args[0].bfloat16()
    args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    got = paged_attention(*args)
    want = paged_attention_reference(*args, kv_split=default_kv_split(16))
    # one bf16 ulp of the larger magnitude, over the f32 atol that bounds
    # the cancellation error of outputs near zero
    assert bf16_ulps(got, want, TOL["atol"]) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", [1, 8])
def test_varlen_kernel_matches_plain(cuda_device, block_q):
    """A packed stream with decode lanes, chunks straddling q-blocks and
    dead padding rows on the scratch page."""
    g = torch.Generator().manual_seed(9)
    nq = np.array([1, 5, 1, 7, 3, 16])
    lanes, p, ps, hkv, d, dead = len(nq), 4, 16, 2, 128, 4
    n = p * lanes + 1
    lens = np.array([int(torch.randint(int(m), p * ps + 1, (1,), generator=g))
                     for m in nq])
    cu = np.concatenate([[0], np.cumsum(nq), [nq.sum() + dead]]).astype(np.int32)
    lane_tbl = torch.stack([torch.randperm(n - 1, generator=g)[:p]
                            for _ in range(lanes)]).int()
    tbl = torch.cat([lane_tbl[np.repeat(np.arange(lanes), nq)],
                     torch.full((dead, p), n - 1, dtype=torch.int32)])
    pos = np.concatenate([varlen_positions(cu[:-1], lens),
                          np.zeros(dead, np.int32)])
    q = torch.randn((len(pos), 4, d), generator=g)
    k = torch.randn((n, hkv, ps, d), generator=g)
    v = torch.randn((n, hkv, ps, d), generator=g)
    args = [t.to(cuda_device) for t in (q, k, v, tbl, torch.from_numpy(pos))]
    kw = dict(cu_seqlens=cu, block_q=block_q)
    got = paged_attention_varlen(*args, **kw)
    want = paged_attention_varlen_reference(*args, **kw)
    torch.testing.assert_close(got, want, **TOL)


# Split-KV: the split pass and the combine against the plain version cut
# into the same splits (so lut0 holds at the kernel's own blocking too):
# one page per split, three (a ragged last split), and one split covering
# the table.
@pytest.mark.cuda
@pytest.mark.parametrize("kv_split", [1, 3, 6])
@pytest.mark.parametrize("case,kw", MATRIX)
def test_paged_split_kernel_matches_split_plain(cuda_device, case, kw,
                                                kv_split):
    lut0 = kw.get("exp_mode") == "lut0"
    args, sc = make_case(23, cuda_device, exact_logits=lut0, **case)
    before = paged_attention.launches, paged_attention.combine_launches
    got = paged_attention(*args, **sc, **kw, kv_split=kv_split)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.combine_launches) == (
        before[0] + 1, before[1] + 1)
    want = paged_attention_reference(*args, **sc, **kw, kv_split=kv_split)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_split", [1, 2, None])
def test_paged_split_kernel_bf16_within_one_ulp(cuda_device, kv_split):
    """bf16 q and pools, GQA 4:1, a prefill chunk of 8 rows."""
    args, sc = make_case(5, cuda_device, group=4, ps=16, lq=8, d=128)
    args[:3] = [t.bfloat16() for t in args[:3]]
    got = paged_attention(*args, kv_split=kv_split)
    want = paged_attention_reference(
        *args, kv_split=kv_split or default_kv_split(16))
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got, want, TOL["atol"]) <= 1.0


# The served families' shapes, a q-block of 8 rows per lane: gemma2's 2:1
# GQA at head dim 256 with its softcap of 50 and a window that ends
# mid-page (37 rows at page 16), and starcoder2's 12:1 GQA at 128 (96 rows
# of a q-block: six row tiles per (lane, kv head)).
FAMILY_CASES = [dict(group=2, hkv=8, d=256, ps=16, p=8, lq=8),
                dict(group=12, hkv=2, d=128, ps=16, p=8, lq=8)]
FAMILY_KWS = [dict(cap=50.0, window=37), dict()]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_split", [None, 1])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape", [0, 1], ids=["gemma2", "starcoder2"])
def test_paged_kernel_at_the_families_shapes(cuda_device, shape, quant,
                                             kv_split):
    """bf16 q over a bf16 or an int8 pool, at the default split and at one
    page per split: within one bf16 ulp beyond the f32 atol of the plain
    version cut into the same splits."""
    args, sc = make_case(31 + shape, cuda_device, quant=quant,
                         **FAMILY_CASES[shape])
    args[0] = args[0].bfloat16()
    if not quant:
        args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    kw = FAMILY_KWS[shape]
    got = paged_attention(*args, **sc, **kw, kv_split=kv_split)
    want = paged_attention_reference(
        *args, **sc, **kw, kv_split=kv_split or default_kv_split(16))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert bf16_ulps(got, want, TOL["atol"]) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_paged_split_window_masks_whole_splits(cuda_device, quant):
    """Every lane full (6 pages of 4 rows) and a window of 5 at one page
    per split: all splits but the last two see no key."""
    args, sc = make_case(7, cuda_device, ps=4, lq=1, quant=quant)
    args[4].fill_(6 * 4)
    got = paged_attention(*args, **sc, window=5, kv_split=1)
    want = paged_attention_reference(*args, **sc, window=5)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_paged_split_dead_q_block(cuda_device):
    """kv_len 1 with Lq 8 (the tiled path's dead q-blocks): one live split,
    seven rows that see no key and emit zeros."""
    args, sc = make_case(8, cuda_device, ps=8, lq=8)
    args[4].fill_(1)
    got = paged_attention(*args, kv_split=1)
    assert not got[:, :, :7].any()
    torch.testing.assert_close(got, paged_attention_reference(*args), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("exp_mode", ["lut", "lut0", "exact"])
def test_paged_combine_kernel_matches_plain(cuda_device, exp_mode):
    """Partials as the split pass leaves them, with the never-written
    splits past each lane's live count filled with NaN: the combine reads
    only live splits."""
    g = torch.Generator().manual_seed(4)
    b, hkv, s, rows, d, ps, kv_split = 3, 2, 4, 8, 128, 16, 2
    m = torch.randn((b, hkv, s, rows), generator=g) * 3
    l = torch.rand((b, hkv, s, rows), generator=g) * 40 + 1
    acc = torch.randn((b, hkv, s, rows, d), generator=g) * l[..., None]
    kv_len = torch.tensor([1, 40, 128], dtype=torch.int32)   # 1, 2, 4 splits
    for i, n in enumerate([1, 2, 4]):
        m[i, :, n:], l[i, :, n:], acc[i, :, n:] = (float("nan"),) * 3
    part = [t.to(cuda_device) for t in (m, l, acc, kv_len)]
    before = paged_attention.combine_launches
    got = paged_combine(*part, page_size=ps, kv_split=kv_split,
                        exp_mode=exp_mode)
    torch.cuda.synchronize()
    assert paged_attention.combine_launches == before + 1
    want = paged_combine_reference(*part, page_size=ps, kv_split=kv_split,
                                   exp_mode=exp_mode)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_paged_attention_call_never_synchronises(cuda_device):
    """With every input on the card, a call (split pass and combine) reads
    no device value on the host: the step stays capturable as a graph."""
    args, sc = make_case(9, cuda_device, ps=16, lq=8, d=128, quant=True)
    want = paged_attention(*args, **sc)          # builds; places the LUT
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = paged_attention(*args, **sc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


# ------------------------------------------------------------- unembed --

def _unembed_case(cuda_device, tied, rows, d, v):
    from repro_torch.configs import get_config
    cfg = get_config("bert-large" if tied else "deepseek-7b")
    assert cfg.tie_embeddings == tied
    g = torch.Generator(device=cuda_device).manual_seed(2)
    w = torch.randn((v, d) if tied else (d, v), generator=g,
                    device=cuda_device).bfloat16()
    x = torch.randn((2, rows // 2, d), generator=g, device=cuda_device)
    return cfg, {"embed" if tied else "lm_head": w}, x.bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
def test_unembed_bf16_never_widens_the_head(cuda_device, tied):
    """deepseek-7b's 4096 × 102,400 head (and BERT's tied table, read
    transposed): the logits come from one bf16 GEMM with an f32 output,
    whose peak memory rise stays under an eighth of the f32 head's 1.68 GB
    (a widened head alone would add all of it).  Both
    it and the widened f32 product sum exact bf16 products in f32, each
    within γ_K·(|x|·|h|) of the exact sum (γ_K = K·2^-24, any order), so
    they differ by at most twice that."""
    from repro_torch.device import configure_matmul_precision
    from repro_torch.models.layers import unembed
    d, v = 4096, 102_400
    cfg, params, x = _unembed_case(cuda_device, tied, 64, d, v)
    head = params["embed"].T if tied else params["lm_head"]
    f32_head_bytes = head.numel() * 4
    configure_matmul_precision()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = unembed(cfg, params, x)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert got.dtype == torch.float32 and got.shape == (2, 32, v)
    assert rise < f32_head_bytes / 8, (rise, f32_head_bytes)
    want = x.float() @ head.float()
    bound = 2 * d * 2.0 ** -24 * (x.float().abs() @ head.float().abs())
    assert bool(((got - want).abs() <= bound).all())


# ------------------------------------------------- streaming attention --

SA_TOL = dict(atol=3e-5, rtol=1e-4)
# The reference kernel suite's cases (tests/test_kernels.py ATTN_CASES),
# then head dims 64, 128 and 256 (gemma2, gemma3: GQA 2:1, softcap 50,
# window, kv_len below Lkv) with ragged Lq/Lkv, and rows that see no key
SA_CASES = [
    dict(b=2, hq=4, hkv=4, lq=64, lkv=64, d=16, causal=True),
    dict(b=1, hq=8, hkv=2, lq=48, lkv=48, d=32, causal=True),
    dict(b=1, hq=4, hkv=4, lq=32, lkv=96, d=16, causal=True, q_offset=64),
    dict(b=2, hq=4, hkv=2, lq=64, lkv=64, d=16, causal=True, window=16),
    dict(b=1, hq=2, hkv=2, lq=40, lkv=40, d=16, causal=False, cap=30.0),
    dict(b=1, hq=2, hkv=2, lq=64, lkv=64, d=16, causal=True,
         exp_mode="exact"),
    dict(b=1, hq=2, hkv=1, lq=8, lkv=72, d=8, causal=True, q_offset=64,
         kv_len=70),
    dict(b=2, hq=8, hkv=2, lq=100, lkv=130, d=64, causal=False),
    dict(b=1, hq=4, hkv=1, lq=77, lkv=77, d=128, causal=True, window=20,
         cap=30.0),
    dict(b=2, hq=4, hkv=2, lq=150, lkv=150, d=256, causal=True, window=40,
         cap=50.0),
    dict(b=1, hq=4, hkv=2, lq=70, lkv=200, d=256, causal=True, q_offset=97,
         kv_len=151),
    dict(b=1, hq=2, hkv=2, lq=16, lkv=64, d=32, causal=True, q_offset=100,
         window=4),
]


def sa_inputs(case, dev, seed=0, integers=False):
    c = dict(case)
    g = torch.Generator().manual_seed(seed)
    b, hq, hkv = c.pop("b"), c.pop("hq"), c.pop("hkv")
    lq, lkv, d = c.pop("lq"), c.pop("lkv"), c.pop("d")
    draw = ((lambda *s: torch.randint(-3, 4, s, generator=g).float())
            if integers else (lambda *s: torch.randn(s, generator=g)))
    q, k, v = draw(b, hq, lq, d), draw(b, hkv, lkv, d), torch.randn(
        (b, hkv, lkv, d), generator=g)
    return [t.to(dev) for t in (q, k, v)], c


@pytest.mark.cuda
@pytest.mark.parametrize("case", SA_CASES)
def test_streaming_attention_kernel_matches_plain(cuda_device, case):
    (q, k, v), kw = sa_inputs(case, cuda_device)
    before = streaming_attention.launches
    got = streaming_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert streaming_attention.launches == before + 1
    torch.testing.assert_close(got, attention_ref(q, k, v, **kw), **SA_TOL)


@pytest.mark.cuda
def test_streaming_attention_rows_that_see_no_key_emit_zero(cuda_device):
    (q, k, v), kw = sa_inputs(SA_CASES[-1], cuda_device)
    assert not streaming_attention(q, k, v, **kw).any()
    assert not streaming_attention(q, k, v, kv_len=0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [SA_CASES[0], SA_CASES[7], SA_CASES[8]])
def test_streaming_attention_kernel_lut0_at_its_blocking(cuda_device, case):
    """The order-0 LUT depends on the online-softmax blocking, so it is
    held against the plain scan at the kernel's 64-key tiles, over integer
    q and k whose logits are exact on both sides (no softcap: tanh rounds
    differently on the two sides)."""
    (q, k, v), kw = sa_inputs(case, cuda_device, integers=True)
    kw = dict(kw, exp_mode="lut0", cap=None)
    got = streaming_attention(q, k, v, **kw)
    want = attention_scan(q, k, v, block_k=BLOCK_K, **kw)
    torch.testing.assert_close(got, want, **SA_TOL)


def bf16(*ts):
    return [t.bfloat16() for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SA_CASES)
def test_streaming_attention_kernel_bf16_within_one_ulp(cuda_device, case):
    """Every case in bf16, on the tensor-core kernel: head dims 8–256, GQA,
    window, softcap, q_offset/kv_len, ragged Lq/Lkv and exact exp."""
    (q, k, v), kw = sa_inputs(case, cuda_device, seed=4)
    q, k, v = bf16(q, k, v)
    before = streaming_attention.launches_by_variant["tensor_core"]
    got = streaming_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert streaming_attention.launches_by_variant["tensor_core"] == before + 1
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got, attention_ref(q, k, v, **kw), SA_TOL["atol"]) <= 1.0


# P·V on the tensor cores multiplies p_hi + p_lo (two bf16 halves of each f32
# weight) by V so that it stays the plain version's f32 product.  One bf16
# ulp does not show that (p rounded once, or p_hi alone, stays within it);
# against the f32 plain version, the rms error over the rms of rounding that
# version to bf16, and the error's signed projection on it, do (p rounded
# once reads ~1.3, p_hi alone ~2.0 and about -2^-9).
PV_LIMITS = dict(rms_ratio=1.05, bias=2.0 ** -12)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_streaming_attention_bf16_pv_keeps_f32_weights(cuda_device, causal, d):
    (q, k, v), kw = sa_inputs(dict(b=2, hq=8, hkv=8, lq=512, lkv=512, d=d,
                                   causal=causal), cuda_device, seed=5)
    q, k, v = bf16(q, k, v)
    got = streaming_attention(q, k, v, **kw).double()
    want32 = attention_ref(q.float(), k.float(), v.float(), **kw)
    w = want32.double()
    base = (want32.bfloat16().double() - w).square().mean().sqrt()
    rms_ratio = float((got - w).square().mean().sqrt() / base)
    bias = float(((got - w) * w).sum() / w.square().sum())
    assert rms_ratio <= PV_LIMITS["rms_ratio"], rms_ratio
    assert abs(bias) <= PV_LIMITS["bias"], bias


@pytest.mark.cuda
@pytest.mark.parametrize("case", [SA_CASES[0], SA_CASES[6], SA_CASES[7],
                                  SA_CASES[8], SA_CASES[9], SA_CASES[10]])
def test_streaming_attention_kernel_bf16_lut0_at_its_blocking(cuda_device,
                                                              case):
    """lut0 in bf16 over integer q and k (exact in bf16, exact logits),
    held against the plain scan at the kernel's key tiles (64 keys; 32 at
    head dim 256)."""
    (q, k, v), kw = sa_inputs(case, cuda_device, integers=True)
    q, k, v = bf16(q, k, v)
    kw = dict(kw, exp_mode="lut0", cap=None)
    got = streaming_attention(q, k, v, **kw)
    want = attention_scan(q, k, v, block_k=block_k(q.dtype, q.shape[-1]),
                          **kw)
    assert bf16_ulps(got, want, SA_TOL["atol"]) <= 1.0


@pytest.mark.cuda
def test_streaming_attention_bf16_rows_that_see_no_key_emit_zero(cuda_device):
    (q, k, v), kw = sa_inputs(SA_CASES[-1], cuda_device)
    q, k, v = bf16(q, k, v)
    assert not streaming_attention(q, k, v, **kw).any()
    assert not streaming_attention(q, k, v, kv_len=0).any()


@pytest.mark.cuda
def test_streaming_attention_variant_counts(cuda_device):
    """bf16 launches count under the tensor-core kernel, f32 under the
    CUDA-core one, and the total counts both."""
    (q, k, v), kw = sa_inputs(SA_CASES[1], cuda_device)
    by = streaming_attention.launches_by_variant
    before, tc, cc = streaming_attention.launches, by["tensor_core"], by["cuda_core"]
    streaming_attention(q, k, v, **kw)
    assert (by["tensor_core"], by["cuda_core"]) == (tc, cc + 1)
    streaming_attention(*bf16(q, k, v), **kw)
    streaming_attention(*bf16(q, k, v), **kw)
    torch.cuda.synchronize()
    assert (by["tensor_core"], by["cuda_core"]) == (tc + 2, cc + 1)
    assert streaming_attention.launches == before + 3


@pytest.mark.cuda
def test_streaming_attention_kernel_reads_strided_views(cuda_device):
    """The model's head split: q, k, v are transposed views of (B, L, H, D)
    projections (k a slice of a wider one); the output keeps q's layout
    and the values match."""
    g = torch.Generator().manual_seed(6)
    q, v = (torch.randn((2, 70, 4, 64), generator=g).to(cuda_device)
            .transpose(1, 2) for _ in range(2))
    k = torch.randn((2, 70, 8, 64), generator=g).to(cuda_device)[:, :, :4]
    k = k.transpose(1, 2)
    got = streaming_attention(q, k, v, causal=True)
    assert got.stride() == q.stride()
    torch.testing.assert_close(
        got, attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True), **SA_TOL)


@pytest.mark.cuda
def test_streaming_attention_bf16_reads_strided_views(cuda_device):
    """The same head-split views in bf16 (cp.async path: every row stride a
    multiple of 8 elements), then rows 68 elements apart (136 bytes: not
    16-byte aligned), which the tensor-core kernel stages through
    registers; the output keeps q's layout."""
    g = torch.Generator().manual_seed(6)
    q, v = (torch.randn((2, 70, 4, 64), generator=g).bfloat16()
            .to(cuda_device).transpose(1, 2) for _ in range(2))
    k = torch.randn((2, 70, 8, 64), generator=g).bfloat16().to(cuda_device)
    k = k[:, :, :4].transpose(1, 2)
    odd = [torch.randn((2, 4, 70, 68), generator=g).bfloat16().to(cuda_device)
           [..., :64] for _ in range(3)]
    assert odd[0].stride(2) % 8
    assert streaming_attention(q, k, v, causal=True).stride() == q.stride()
    for qq, kk, vv, causal in ((q, k, v, True), (*odd, False)):
        got = streaming_attention(qq, kk, vv, causal=causal)
        want = attention_ref(qq.contiguous(), kk.contiguous(), vv.contiguous(),
                             causal=causal)
        assert bf16_ulps(got, want, SA_TOL["atol"]) <= 1.0


# ------------------------------------------------------------- int8 matmul --

# (leading dims, K, N): the reference kernel suite's shapes, a batch, M = 1
# and 8 at BERT-large widths, the BERT-large projections at 8 × 512 tokens,
# and ragged edges on each side (K or N not a multiple of 16: byte staging;
# N a multiple of 4 but not of 8: scalar stores at the last columns).
INT8_SHAPES = [((64,), 256, 128), ((17,), 300, 130), ((4,), 128, 512),
               ((257,), 1024, 384), ((1,), 128, 128), ((2, 3), 256, 64),
               ((1,), 1024, 4096), ((8,), 4096, 1024), ((8, 512), 1024, 1024),
               ((8, 512), 1024, 4096), ((8, 512), 4096, 1024),
               ((33,), 200, 96), ((130,), 256, 100), ((5,), 64, 20)]


def int8_case(lead, k, n, dev, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((*lead, k), generator=g).to(dtype)
    wq = quant.quantize(torch.randn((k, n), generator=g), axis=0)
    return x.to(dev), quant.QTensor(wq.values.to(dev), wq.scale.to(dev))


def assert_bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_matmul_kernel_bit_exact(cuda_device, shape, dtype):
    x, wq = int8_case(*shape, cuda_device, dtype=getattr(torch, dtype))
    before = int8_matmul.launches
    got = int8_matmul(x, wq)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert_bits_equal(got, int8_matmul_ref(x, wq))
    xq = quant.quantize_dynamic(x)
    xv = xq.values.reshape(-1, shape[1])
    out, acc = int8_matmul_2d(xv, wq.values, xq.scale, wq.scale, with_acc=True)
    ref_out, ref_acc = int8_matmul_2d_ref(xv, wq.values, xq.scale, wq.scale,
                                          with_acc=True)
    assert torch.equal(acc, ref_acc)
    assert_bits_equal(out, ref_out)
    assert_bits_equal(out.reshape(got.shape), got)


@pytest.mark.cuda
def test_int8_matmul_kernel_accumulator_past_2_24(cuda_device):
    """All-±127 operands drive |acc| past 2^24, where int→f32 rounds."""
    k, n = 4096, 256
    g = torch.Generator().manual_seed(1)
    xv = torch.where(torch.rand((64, k), generator=g) < 0.9, 127, -127)
    wv = torch.where(torch.rand((k, n), generator=g) < torch.linspace(
        0.5, 1.0, n), 127, -127)
    xv, wv = (t.to(torch.int8).to(cuda_device) for t in (xv, wv))
    xs = torch.full((), 0.01, device=cuda_device)
    ws = torch.rand((1, n), generator=g).to(cuda_device) + 0.5
    out, acc = int8_matmul_2d(xv, wv, xs, ws, with_acc=True)
    ref_out, ref_acc = int8_matmul_2d_ref(xv, wv, xs, ws, with_acc=True)
    assert ref_acc.abs().max() > 2 ** 24 and (ref_acc % 4 != 0).any()
    assert torch.equal(acc, ref_acc)
    assert_bits_equal(out, ref_out)


@pytest.mark.cuda
def test_int8_core_entry_points_launch_the_kernel(cuda_device):
    """``core.quant.int8_matmul`` and ``dense_maybe_quant`` (QTensor and
    ``use_int8``) on CUDA tensors go through the kernel; quantisation on the
    card is bit-equal to the CPU's."""
    x, wq = int8_case((3, 40), 512, 192, cuda_device, seed=2,
                      dtype=torch.bfloat16)
    w = torch.randn((512, 192), generator=torch.Generator().manual_seed(3))
    want_q = quant.quantize(w, axis=0)
    got_q = quant.quantize(w.to(cuda_device), axis=0)
    assert torch.equal(got_q.values.cpu(), want_q.values)
    assert torch.equal(got_q.scale.cpu(), want_q.scale)
    xq_cpu = quant.quantize_dynamic(x.cpu())
    xq = quant.quantize_dynamic(x)
    assert torch.equal(xq.values.cpu(), xq_cpu.values)
    assert torch.equal(xq.scale.cpu(), xq_cpu.scale)
    before = int8_matmul.launches
    a = quant.int8_matmul(x, wq)
    b = quant.dense_maybe_quant(x, wq)
    c = quant.dense_maybe_quant(x, w.to(cuda_device), use_int8=True)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 3
    assert_bits_equal(a, int8_matmul_ref(x, wq))
    assert_bits_equal(b, a)
    assert_bits_equal(c, int8_matmul_ref(x, got_q))
    # the core order on the CPU sits within two f32 ulps of the kernel order
    core = quant.int8_matmul(x.cpu(), quant.QTensor(wq.values.cpu(),
                                                    wq.scale.cpu()))
    ulps = (a.cpu().view(torch.int32).long() - core.view(torch.int32).long())
    assert int(ulps.abs().max()) <= 2


# ------------------------------------------------- activation quantisation --

def quantize_inputs(case, dtype, dev):
    """The quantisation kernel's edge cases (phase 8 of ``chip_smoke.py``
    holds the same): ragged sizes whose bytes are not a multiple of 16, a
    start off the 16-byte grid, all zeros (the 1e-12 floor), exact .5 ties
    after the division (absmax 127 → scale 1), one outlier, and bits=4."""
    g = torch.Generator().manual_seed(5)
    bits = 8
    if case == "ragged":
        x = torch.randn((257, 131), generator=g) * 3
    elif case == "unaligned":
        x = (torch.randn(4099, generator=g) * 3)[1:]
    elif case == "zeros":
        x = torch.zeros((64, 48))
    elif case == "ties":
        x = torch.randint(-126, 126, (96, 40), generator=g).float() + 0.5
        x[0, 0] = 127.0
    elif case == "outlier":
        x = torch.randn((512, 64), generator=g)
        x[100, 7] = -3.0e4
    else:                                        # "bits4"
        x = torch.randn((33, 77), generator=g) * 2
        bits = 4
    x = x.to(dtype)
    if case == "ties":
        assert ((x.float() - 0.5) % 1 == 0).sum() > 1000   # odd halves
    return x.to(dev), bits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ragged", "unaligned", "zeros", "ties",
                                  "outlier", "bits4"])
def test_quantize_dynamic_kernel_bit_exact(cuda_device, case, dtype):
    x, bits = quantize_inputs(case, getattr(torch, dtype), cuda_device)
    before = quant.quantize_dynamic.launches
    got = quant.quantize_dynamic(x, bits=bits)
    torch.cuda.synchronize()
    assert quant.quantize_dynamic.launches == before + 1
    want = quant.quantize_dynamic(x.cpu(), bits=bits)
    assert got.values.shape == x.shape and got.scale.shape == ()
    assert torch.equal(got.values.cpu(), want.values)
    assert torch.equal(got.scale.cpu().view(torch.int32),
                       want.scale.view(torch.int32))
    if case == "zeros":
        assert float(got.scale) == np.float32(1e-12) * (np.float32(1) / np.float32(127))


# (M, K, N): one tile and one k-step, M = 1 and 8 at BERT-large widths, a
# BERT-large projection, ragged M, N and K (K a multiple of 16 but not of
# the 128-byte stage; N not a multiple of 4: scalar stores)
WGMMA_SHAPES = [(64, 128, 128), (1, 1024, 4096), (8, 4096, 1024),
                (4096, 1024, 1024), (257, 1024, 384), (130, 208, 100),
                (33, 48, 260), (5, 64, 20)]


def int8_operands(m, k, n, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    xv = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    wv = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    xs = torch.rand((), generator=g) * 0.01
    ws = torch.rand((1, n), generator=g) * 0.01
    return xv.to(dev), wv.to(dev), xs.to(dev), ws.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [128, 256])
@pytest.mark.parametrize("layout", ["k_major", "row"])
@pytest.mark.parametrize("mkn", WGMMA_SHAPES)
def test_int8_matmul_wgmma_bit_exact(cuda_device, mkn, layout, tile_n):
    """The wgmma variant, accumulators and outputs, on either weight
    layout (a row-major w is transposed once, and counted), at each tile
    width."""
    from repro_torch.kernels.int8_matmul import ops
    xv, wv, xs, ws = int8_operands(*mkn, cuda_device)
    if layout == "k_major":
        wv = wv.t().contiguous().t()
    before = dict(int8_matmul.launches_by_variant)
    transposes = int8_matmul.transposes
    assert ops.kernel_variant(xv, wv) == "wgmma"
    out, acc = int8_matmul_2d(xv, wv, xs, ws, with_acc=True, tile_n=tile_n)
    torch.cuda.synchronize()
    assert int8_matmul.launches_by_variant["wgmma"] == before["wgmma"] + 1
    assert int8_matmul.launches_by_variant["mma_sync"] == before["mma_sync"]
    assert int8_matmul.transposes == transposes + (layout == "row")
    ref_out, ref_acc = int8_matmul_2d_ref(xv, wv, xs, ws, with_acc=True)
    assert torch.equal(acc, ref_acc)
    assert_bits_equal(out, ref_out)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["k_major", "row"])
@pytest.mark.parametrize("mkn", [(64, 300, 130), (17, 200, 96), (5, 72, 20)])
def test_int8_matmul_mma_sync_variant_both_layouts(cuda_device, mkn, layout):
    """K % 16 ≠ 0 runs the mma.sync variant, on either layout in place (no
    transpose); pinned to mma.sync, an aligned call does the same."""
    from repro_torch.kernels.int8_matmul import ops
    xv, wv, xs, ws = int8_operands(*mkn, cuda_device, seed=1)
    if layout == "k_major":
        wv = wv.t().contiguous().t()
    before = dict(int8_matmul.launches_by_variant)
    transposes = int8_matmul.transposes
    assert ops.kernel_variant(xv, wv) == "mma_sync"
    out, acc = int8_matmul_2d(xv, wv, xs, ws, with_acc=True)
    torch.cuda.synchronize()
    assert int8_matmul.launches_by_variant["mma_sync"] == before["mma_sync"] + 1
    assert int8_matmul.launches_by_variant["wgmma"] == before["wgmma"]
    assert int8_matmul.transposes == transposes
    ref_out, ref_acc = int8_matmul_2d_ref(xv, wv, xs, ws, with_acc=True)
    assert torch.equal(acc, ref_acc)
    assert_bits_equal(out, ref_out)
    xv, wv, xs, ws = int8_operands(256, 512, 384, cuda_device, seed=2)
    if layout == "k_major":
        wv = wv.t().contiguous().t()
    out, acc = int8_matmul_2d(xv, wv, xs, ws, with_acc=True, variant="mma_sync")
    ref_out, ref_acc = int8_matmul_2d_ref(xv, wv, xs, ws, with_acc=True)
    assert torch.equal(acc, ref_acc)
    assert_bits_equal(out, ref_out)
    assert int8_matmul.transposes == transposes


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [128, 256])
def test_int8_matmul_wgmma_accumulator_past_2_24(cuda_device, tile_n):
    """All-±127 operands drive |acc| past 2^24 on the wgmma variant."""
    k, n = 4096, 384
    g = torch.Generator().manual_seed(4)
    xv = torch.where(torch.rand((200, k), generator=g) < 0.9, 127, -127)
    wv = torch.where(torch.rand((k, n), generator=g) < torch.linspace(
        0.5, 1.0, n), 127, -127)
    xv = xv.to(torch.int8).to(cuda_device)
    wv = wv.to(torch.int8).t().contiguous().t().to(cuda_device)
    xs = torch.full((), 0.01, device=cuda_device)
    ws = torch.rand((1, n), generator=g).to(cuda_device) + 0.5
    out, acc = int8_matmul_2d(xv, wv, xs, ws, with_acc=True, tile_n=tile_n)
    ref_out, ref_acc = int8_matmul_2d_ref(xv, wv, xs, ws, with_acc=True)
    assert ref_acc.abs().max() > 2 ** 24 and (ref_acc % 4 != 0).any()
    assert torch.equal(acc, ref_acc)
    assert_bits_equal(out, ref_out)


@pytest.mark.cuda
def test_int8_launches_never_synchronise(cuda_device):
    """Quantisation and both matmul variants read no device value on the
    host: the scale stays on the card."""
    x, wq = int8_case((4, 64), 1024, 512, cuda_device, dtype=torch.bfloat16)
    xr, wr = int8_case((9,), 200, 64, cuda_device, seed=3)
    want = (int8_matmul(x, wq), int8_matmul(xr, wr))   # builds both
    torch.cuda.synchronize()
    before = dict(int8_matmul.launches_by_variant)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (int8_matmul(x, wq), int8_matmul(xr, wr))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int8_matmul.launches_by_variant == {
        "wgmma": before["wgmma"] + 1, "mma_sync": before["mma_sync"] + 1}
    for a, b in zip(got, want):
        assert_bits_equal(a, b)


@pytest.mark.cuda
def test_int8_matmul_row_major_weight_counts_one_transpose(cuda_device):
    """A QTensor from ``quantize(w, axis=0)`` is K-major and goes to wgmma
    as it lies; the same values row-major cost one transpose a call."""
    x, wq = int8_case((16,), 512, 256, cuda_device)
    assert wq.values.stride() == (1, 512)
    row = quant.QTensor(wq.values.contiguous(), wq.scale)
    transposes = int8_matmul.transposes
    a = int8_matmul(x, wq)
    assert int8_matmul.transposes == transposes
    b = int8_matmul(x, row)
    torch.cuda.synchronize()
    assert int8_matmul.transposes == transposes + 1
    assert_bits_equal(a, b)


# ---------------------------------------------------- the captured step --
#
# The serving step captured as a CUDA graph per (T, P) (serving/graphs.py)
# against the same step dispatched op by op: same kernels on the same
# inputs, so picks and pool bytes agree bit for bit.  The scratch page
# (the pool's last) is left out: every dead stream row writes its K/V
# there, at one (page, offset), and which of those writes lands last is
# not defined.

def _smoke_engine(cuda_device, kv_quant, capture, name="deepseek-7b-smoke",
                  **kw):
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving import EngineCore
    cfg = get_config(name).replace(dtype="bfloat16", kv_quant=kv_quant)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    return EngineCore(cfg, params, lanes=3, page_size=8, num_pages=24,
                      chunk_size=8, device=cuda_device, capture=capture, **kw)


def _smoke_requests(eng, seed=13, lens=(3, 21, 9, 14, 6),
                    news=(7, 5, 9, 4, 6)):
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    for i, (lp, mn) in enumerate(zip(lens, news)):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, eng.cfg.vocab_size, lp).astype(np.int32), max_new=mn))


def _pool_bits(eng):
    out = {}
    for name, t in eng.kv.pool.items():
        live = t[:, :-1].contiguous()                # all but the scratch page
        out[name] = live.view(torch.int16 if t.dtype == torch.bfloat16
                              else torch.int8 if t.dtype == torch.int8
                              else torch.int32)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_captured_step_bit_equal_to_eager(cuda_device, kv_quant):
    """After every step of the mixed trace, the captured engine's picks and
    pool bytes equal the eager engine's; the sentinel counted one capture
    per (T, P) key and each key's graph was replayed."""
    eager = _smoke_engine(cuda_device, kv_quant, capture=False)
    graph = _smoke_engine(cuda_device, kv_quant, capture=True)
    for eng in (eager, graph):
        _smoke_requests(eng)
    steps = 0
    while eager.scheduler.has_work():
        oe, og = eager.step(), graph.step()
        assert oe.tokens == og.tokens, steps
        for name, bits in _pool_bits(eager).items():
            assert torch.equal(bits, _pool_bits(graph)[name]), (steps, name)
        steps += 1
    assert not graph.scheduler.has_work()
    assert graph.trace_count == graph.graphs.captures > 0
    assert graph.trace_count < steps                 # keys were replayed
    assert eager.trace_count == 0


@pytest.mark.cuda
def test_replay_never_synchronises_and_counts_launches(cuda_device):
    """A replayed step reads no device value on the host (staging through
    pinned memory, the replay), and N replays advance the kernel counters
    by N × the step's launches: one split pass and one combine per layer."""
    from repro_torch.kernels.paged_attention import paged_attention
    eng = _smoke_engine(cuda_device, False, capture=True)
    _smoke_requests(eng, lens=(5, 6, 7), news=(4, 4, 4))
    eng.step()
    eng.step()
    batch, _ = eng.scheduler.batch_for(eng.scheduler.begin_step())
    arrays = eng.step_arrays(batch)
    eng.graphs.run(**arrays)                         # may capture this key
    torch.cuda.synchronize()
    captures = eng.graphs.captures
    want = eng.graphs.run(**arrays).clone()
    torch.cuda.synchronize()
    n, layers = 5, eng.cfg.num_layers
    before = (paged_attention.launches, paged_attention.combine_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            got = eng.graphs.run(**arrays)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert eng.graphs.captures == captures           # replays only
    assert torch.equal(got, want)
    assert (paged_attention.launches - before[0],
            paged_attention.combine_launches - before[1]) == (n * layers,
                                                             n * layers)


@pytest.mark.cuda
def test_capture_of_a_host_read_raises(cuda_device):
    """A step function that reads a device value on the host cannot be
    captured: the capture raises, and nothing runs the step eagerly in its
    place (no key is kept, the counters are put back)."""
    from repro_torch.serving.graphs import StepGraphs, launch_counts

    def step_fn(tokens, pos, table, last_idx, cu):
        logits = torch.nn.functional.one_hot(last_idx.long(), 4).float()
        if int(tokens.sum()) < 0:                     # a host read
            return -logits
        return logits

    g = StepGraphs(step_fn, lanes=2, vocab=4, device=cuda_device)
    arrays = dict(tokens=np.ones(4, np.int32), pos=np.arange(4, dtype=np.int32),
                  table=np.zeros((4, 1), np.int32),
                  last_idx=np.zeros(2, np.int32),
                  cu=np.array([0, 4, 4, 4], np.int32))
    before = launch_counts()
    with pytest.raises(RuntimeError):
        g.run(**arrays)
    torch.cuda.synchronize()
    assert not g.keys and launch_counts() == before


# ------------------------------- prefix cache and speculation, captured --
#
# The copy-on-write of a partial prefix hit is a device copy into the pool
# in place (``PagedKVCache.cow``), and a speculative engine's steps pick at
# (lanes, 1 + spec_k) rows; both must replay through the captured step.

def _pool_ptrs(eng):
    return {name: t.data_ptr() for name, t in eng.kv.pool.items()}


def _cow_trace(eng):
    """Request 0 (21 tokens, 2⅝ pages of 8) publishes; request 1, its first
    14 tokens, hits one full page and 5 rows of the next: a partial hit
    whose page is copied before its first cold row lands."""
    from repro_torch.serving import Request
    base = np.random.default_rng(1).integers(
        0, eng.cfg.vocab_size, 21).astype(np.int32)
    return [Request(uid=0, prompt=base, max_new=8),
            Request(uid=1, prompt=base[:14], max_new=8)]


@pytest.mark.cuda
def test_cow_between_replays_keeps_the_pool_in_place(cuda_device):
    """Cached serving, captured against eager: after every step picks and
    pool bytes are equal; the step that copies a page keeps every pool
    tensor's ``data_ptr()``, leaves the original page's bits as they were,
    and is itself a replay (no new capture) that reads the copy."""
    eager = _smoke_engine(cuda_device, False, capture=False, prefix_cache=True)
    graph = _smoke_engine(cuda_device, False, capture=True, prefix_cache=True)
    ptrs = _pool_ptrs(graph)
    cow_steps = 0
    for wave in ([0], [1]):
        for eng in (eager, graph):
            eng.submit(_cow_trace(eng)[wave[0]])
        while eager.scheduler.has_work():
            copies, captures = graph.kv.cow_copies, graph.graphs.captures
            cached = {n.page: {k: t[:, n.page].clone()
                               for k, t in graph.kv.pool.items()}
                      for n in graph.prefix_cache._nodes.values()}
            oe, og = eager.step(), graph.step()
            assert oe.tokens == og.tokens
            for name, bits in _pool_bits(eager).items():
                assert torch.equal(bits, _pool_bits(graph)[name]), name
            assert _pool_ptrs(graph) == ptrs
            if graph.kv.cow_copies > copies:
                cow_steps += 1
                assert graph.graphs.captures == captures, \
                    "the copying step captured instead of replaying"
                for page, leaves in cached.items():      # originals intact
                    for k, t in graph.kv.pool.items():
                        assert torch.equal(t[:, page], leaves[k]), (page, k)
    assert cow_steps == 1 and eager.kv.cow_copies == graph.kv.cow_copies == 1
    assert graph.prefix_stats["partial_hits"] == 1


def _repeat_last(stream, k):
    """Drafts the stream's last token k times: deterministic, mostly
    rejected, sometimes accepted."""
    return [int(stream[-1])] * k


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_verify_shaped_captured_step_bit_equal_to_eager(cuda_device,
                                                       kv_quant):
    """Speculative engines (k = 4): the captured step's (lanes, 5) picks and
    the pool bytes equal the eager step's after every step, drafting steps
    replayed, and the captures stay those of the (T, P) keys."""
    kw = dict(speculative=True, spec_k=4, proposer=_repeat_last)
    eager = _smoke_engine(cuda_device, kv_quant, capture=False, **kw)
    graph = _smoke_engine(cuda_device, kv_quant, capture=True, **kw)
    for eng in (eager, graph):
        _smoke_requests(eng)
    replayed_drafts = 0
    while eager.scheduler.has_work():
        captures = graph.graphs.captures
        oe, og = eager.step(), graph.step()
        assert (oe.tokens, oe.drafted_tokens, oe.accepted_tokens) == \
            (og.tokens, og.drafted_tokens, og.accepted_tokens)
        for name, bits in _pool_bits(eager).items():
            assert torch.equal(bits, _pool_bits(graph)[name]), name
        if og.drafted_tokens and graph.graphs.captures == captures:
            replayed_drafts += 1
    assert graph.graphs.pick_shape == (3, 5)
    assert {r.uid: r.tokens for r in eager.finished} == \
        {r.uid: r.tokens for r in graph.finished}
    assert replayed_drafts > 0 and graph.drafted_total > 0
    assert graph.trace_count == graph.graphs.captures < graph.obs.registry \
        .value("steps_total")


@pytest.mark.cuda
def test_step_with_cow_and_drafts_replays_without_a_sync(cuda_device):
    """A replayed step whose schedule copies a page and carries drafts
    reads no device value on the host: the scheduler's CoW copy, the
    staging and the replay all run under ``set_sync_debug_mode("error")``;
    the streams equal an eager engine's."""
    kw = dict(prefix_cache=True, speculative=True, spec_k=4,
              proposer=_repeat_last)
    graph = _smoke_engine(cuda_device, False, capture=True, **kw)
    eager = _smoke_engine(cuda_device, False, capture=False, **kw)
    reqs = {id(e): _cow_trace(e) for e in (graph, eager)}
    for eng in (graph, eager):
        eng.submit(reqs[id(eng)][0])
        eng.run()
        eng.submit(reqs[id(eng)][1])
    s = graph.scheduler
    captures, copies = graph.graphs.captures, graph.kv.cow_copies
    wants = s.begin_step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch, pre = s.batch_for(wants)
        picks = graph.graphs.run(**graph.step_arrays(batch))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert graph.kv.cow_copies == copies + 1
    assert any(p.drafts for p in batch.plans)
    assert graph.graphs.captures == captures         # a replay
    graph._finish(batch.plans, pre, picks=picks.cpu().numpy(),
                  live=batch.live, padded=batch.width)
    graph.run()
    eager.run()
    assert {r.uid: r.tokens for r in graph.finished} == \
        {r.uid: r.tokens for r in eager.finished}


# ------------------------------------------------- sampling on the card --
#
# The in-step sampler (serving/sampling.py) on the card against the same
# code on the CPU, and its one graph per engine beside the step graphs
# (serving/graphs.py): captured on the first sampled step, replayed only on
# steps in which a lane samples, two LUT-exp launches per replay.

def _sampling_case(n, v, seed=3):
    rng = np.random.default_rng(seed)
    lg = (rng.normal(size=(n, v)) * 3).astype(np.float32)
    params = dict(
        temperature=rng.choice([0.0, 0.7, 1.0], n).astype(np.float32),
        top_k=rng.choice([0, 1, 50], n).astype(np.int32),
        top_p=rng.choice([1.0, 0.95, 0.5], n).astype(np.float32),
        seed=rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64),
        counter=rng.integers(0, 2 ** 31, n).astype(np.int64))
    return lg, params


@pytest.mark.cuda
@pytest.mark.parametrize("n, v", [(8, 102400), (40, 4099)])
def test_sampler_on_card_equals_cpu(cuda_device, n, v):
    """Key words, bits and uniforms bit for bit; picks equal save a near-tie
    of ``scores + g`` (the CPU's winner ahead of the card's by less than
    twice their largest gap); two LUT-exp launches per draw."""
    from repro_torch.core import prng
    from repro_torch.core.lut_softmax import lut_log_softmax
    from repro_torch.serving.sampling import (_masked_scores, _request_keys,
                                              sample_rows)
    lg, params = _sampling_case(n, v)
    cpu = {k: torch.from_numpy(a) for k, a in params.items()}
    dev = {k: t.to(cuda_device) for k, t in cpu.items()}
    kc = _request_keys(cpu["seed"], cpu["counter"])
    kd = _request_keys(dev["seed"], dev["counter"])
    assert all(torch.equal(a, b.cpu()) for a, b in zip(kc, kd))
    bc, bd = prng.random_bits(*kc, v), prng.random_bits(*kd, v)
    assert torch.equal(bc, bd.cpu())
    assert torch.equal(prng.uniform(bc, prng.F32_TINY).view(torch.int32),
                       prng.uniform(bd, prng.F32_TINY).cpu().view(torch.int32))
    before = lut_exp.launches
    got = sample_rows(torch.from_numpy(lg).to(cuda_device), **dev)
    torch.cuda.synchronize()
    assert lut_exp.launches == before + 2
    want = sample_rows(torch.from_numpy(lg), **cpu)

    def z(logits, p, exp):
        x, keep = _masked_scores(logits, p["temperature"], p["top_k"],
                                 p["top_p"], exp)
        return (lut_log_softmax(x, where=keep, exp=exp)
                + prng.gumbel(*_request_keys(p["seed"], p["counter"]), v))

    differ = (got.cpu() != want).nonzero().flatten().tolist()
    if differ:
        zc = z(torch.from_numpy(lg), cpu, lut_exp_ref)
        zd = z(torch.from_numpy(lg).to(cuda_device), dev, lut_exp).cpu()
        for i in differ:
            assert params["temperature"][i] > 0, f"greedy row {i} differs"
            both = torch.isfinite(zc[i]) & (zc[i] > -1e29) & (zd[i] > -1e29)
            gap = float((zc[i] - zd[i])[both].abs().max())
            lead = float(zc[i, want[i]] - zc[i, got[i]])
            assert 0 <= lead <= 2 * gap, (i, lead, gap)


def _sampled_requests(eng, seed=13, lens=(3, 21, 9, 14, 6),
                      news=(7, 5, 9, 4, 6)):
    """The mixed trace, requests 1 and 3 sampled."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(seed)
    sps = {1: SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=1),
           3: SamplingParams(temperature=1.0, seed=2)}
    for i, (lp, mn) in enumerate(zip(lens, news)):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, eng.cfg.vocab_size, lp).astype(np.int32), max_new=mn,
            sampling=sps.get(i)))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_captured_sampled_step_bit_equal_to_eager(cuda_device, kv_quant):
    """Greedy and sampled requests: the captured engine's picks equal the
    eager engine's after every step; one sampler capture, step captures
    those of the (T, P) keys."""
    eager = _smoke_engine(cuda_device, kv_quant, capture=False)
    graph = _smoke_engine(cuda_device, kv_quant, capture=True)
    for eng in (eager, graph):
        _sampled_requests(eng)
    while eager.scheduler.has_work():
        assert eager.step().tokens == graph.step().tokens
    assert graph.graphs.sampler_captures == 1
    assert graph.trace_count == graph.graphs.captures
    assert {r.uid: r.tokens for r in eager.finished} == \
        {r.uid: r.tokens for r in graph.finished}


def _sampled_arrays(eng):
    s = eng.scheduler
    batch, _ = s.batch_for(s.begin_step())
    return eng.step_arrays(batch), eng._sampling_inputs(batch.plans)


@pytest.mark.cuda
def test_sampled_replay_never_synchronises_and_counts_launches(cuda_device):
    """A replayed sampled step (the step graph, then the sampler graph)
    reads no device value on the host, and N replays add 2N LUT-exp
    launches; an all-greedy replay adds none: the sampler does not run."""
    eng = _smoke_engine(cuda_device, False, capture=True)
    _sampled_requests(eng, lens=(5, 6, 7), news=(6, 6, 6))
    eng.step()
    eng.step()
    arrays, sampling = _sampled_arrays(eng)
    assert sampling is not None
    eng.graphs.run(**arrays, sampling=sampling)      # may capture
    want = eng.graphs.run(**arrays, sampling=sampling).clone()
    torch.cuda.synchronize()
    captures = (eng.graphs.captures, eng.graphs.sampler_captures)
    n = 4
    before = lut_exp.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            got = eng.graphs.run(**arrays, sampling=sampling)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (eng.graphs.captures, eng.graphs.sampler_captures) == captures
    assert torch.equal(got, want)
    assert lut_exp.launches - before == 2 * n
    before = lut_exp.launches
    greedy = eng.graphs.run(**arrays)
    torch.cuda.synchronize()
    assert lut_exp.launches == before
    assert greedy.data_ptr() != got.data_ptr()


@pytest.mark.cuda
def test_all_greedy_steps_never_replay_the_sampler(cuda_device):
    """Serving greedy traffic only: no sampler capture and no standalone
    LUT-exp launch; then one sampled request: one capture, two launches
    per step that samples it."""
    from repro_torch.serving import Request, SamplingParams
    eng = _smoke_engine(cuda_device, False, capture=True)
    _smoke_requests(eng)
    before = lut_exp.launches
    eng.run()
    assert lut_exp.launches == before
    assert eng.graphs.sampler is None and eng.graphs.sampler_captures == 0
    req = Request(uid=9, prompt=np.arange(5, dtype=np.int32), max_new=4,
                  sampling=SamplingParams(temperature=0.9, seed=3))
    eng.submit(req)
    eng.run()
    assert eng.graphs.sampler_captures == 1
    assert lut_exp.launches - before == 2 * len(req.tokens)


@pytest.mark.cuda
def test_speculative_engine_with_a_sampled_lane(cuda_device):
    """k = 4 with a sampled lane among drafting greedy lanes: the sampler's
    picks keep the engine's (lanes, 5) shape, captured equals eager, and
    the drafting steps that sample replay both graphs."""
    kw = dict(speculative=True, spec_k=4, proposer=_repeat_last)
    eager = _smoke_engine(cuda_device, False, capture=False, **kw)
    graph = _smoke_engine(cuda_device, False, capture=True, **kw)
    for eng in (eager, graph):
        _sampled_requests(eng)
    while eager.scheduler.has_work():
        oe, og = eager.step(), graph.step()
        assert (oe.tokens, oe.drafted_tokens, oe.accepted_tokens) == \
            (og.tokens, og.drafted_tokens, og.accepted_tokens)
    assert graph.graphs.sampler.picks.shape == (3, 5)
    assert graph.graphs.sampler_captures == 1 and graph.drafted_total > 0
    assert {r.uid: r.tokens for r in eager.finished} == \
        {r.uid: r.tokens for r in graph.finished}


@pytest.mark.cuda
def test_capture_survives_a_dropped_engine_held_by_a_cycle(cuda_device):
    """An engine dropped while a reference cycle holds it keeps its graphs
    until the cyclic collector runs; that must not happen inside another
    engine's capture (destroying a graph there invalidates the capture).
    The collector is made to run at nearly every allocation."""
    import gc
    old = _smoke_engine(cuda_device, False, capture=True)
    _smoke_requests(old)
    old.run()
    old.step = old.step                  # old → its bound method → old
    del old
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng = _smoke_engine(cuda_device, False, capture=True)
        _sampled_requests(eng)
        eng.run()
    finally:
        gc.set_threshold(*threshold)
    assert eng.graphs.captures > 0 and eng.graphs.sampler_captures == 1
    assert eng.pages_in_use == 0


# The kernel-config tuner on the card (kernels/autotune.py): the measured
# path is kernel #2, an engine launches it at its resolved config, and a
# config changes only the blocking — the f32 engine's logits hold #2's
# tolerance against the default config's.

@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_measure_step_s_times_the_kernel(cuda_device, quantized):
    from repro_torch.kernels.autotune import (DEFAULT_CONFIG, KernelConfig,
                                              KernelGeom, default_workloads,
                                              measure_step_s)
    geom = KernelGeom(hq=8, hkv=2, head_dim=64, page_size=16,
                      kv_bytes=1 if quantized else 2, q_bytes=2)
    wl = default_workloads(lanes=4, chunk=32, decode_ctx=300)
    for config in (DEFAULT_CONFIG, KernelConfig(block_q=16, kv_split=2)):
        before = paged_attention.launches
        s = measure_step_s(config, geom, wl, device=cuda_device, iters=3)
        assert np.isfinite(s) and 0 < s < 1.0
        # per workload: the building call, the capture's eager warm-up and
        # the captured call, each counted as the wrapper runs; the tuner
        # keeps no counts of its own, so its replays add nothing
        assert paged_attention.launches == before + 3 * 3


@pytest.mark.cuda
def test_engine_resolves_the_cuda_row(cuda_device):
    from repro_torch.kernels.autotune import load_table, resolve_config
    eng = _smoke_engine(cuda_device, False, capture=True)
    row = load_table()["default::cuda"]
    assert eng.kernel_config == resolve_config("deepseek-7b-smoke", "cuda")
    assert eng.kernel_config.describe() == row
    _smoke_requests(eng)
    outs = []
    while eng.scheduler.has_work():
        outs.append(eng.step())
    assert all(o.kernel_config == row for o in outs if o.lanes)
    assert eng.kv.free_pages == eng.kv.num_pages


def _f32_step_logits(cuda_device, kernel_config):
    """One mixed ragged step of an f32 smoke engine at ``kernel_config``:
    its (lanes, V) logits, with the picks of the whole trace."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import lm_step_ragged
    from repro_torch.params import init_params
    from repro_torch.serving import EngineCore
    cfg = get_config("deepseek-7b-smoke").replace(dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    eng = EngineCore(cfg, params, lanes=3, page_size=8, num_pages=24,
                     chunk_size=8, device=cuda_device,
                     kernel_config=kernel_config)
    _smoke_requests(eng)
    seen, logits = [], []
    inner = eng.scheduler.batch_for

    def spy(wants):
        batch, pre = inner(wants)
        seen.append(batch)
        return batch, pre
    eng.scheduler.batch_for = spy
    while eng.scheduler.has_work():
        eng.step()
        a = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in eng.step_arrays(seen[-1]).items()}
        logits.append(lm_step_ragged(
            cfg, params, a["tokens"], eng.kv.pool, a["table"], a["pos"],
            a["last_idx"], a["cu"], eng.kernel_config)[:len(seen[-1].plans)])
    return logits, {r.uid: r.tokens for r in eng.finished}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_split", [2, 8])
def test_engine_split_config_holds_the_default(cuda_device, kv_split):
    from repro_torch.kernels.autotune import DEFAULT_CONFIG, KernelConfig
    want, want_streams = _f32_step_logits(cuda_device, DEFAULT_CONFIG)
    got, got_streams = _f32_step_logits(
        cuda_device, KernelConfig(block_q=8, kv_split=kv_split))
    assert got_streams == want_streams
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


# ------------------------------------------------------ the slot engine --
#
# The slot-contiguous engine (serving/engine.py) prefills each request at
# b = 1 through kernel #3 and decodes every slot in one captured CUDA
# graph; the same engine with capture=False dispatches the decode op by op.

def _slot_engine(cuda_device, name, kv_quant, capture):
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving import ServingEngine
    cfg = get_config(name).replace(dtype="bfloat16", kv_quant=kv_quant)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    return ServingEngine(cfg, params, slots=3, max_len=48,
                         device=cuda_device, capture=capture)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kv_quant", [("gemma2-9b-smoke", False),
                                           ("deepseek-7b-smoke", True)])
def test_slot_engine_captured_decode_bit_equal_to_eager(cuda_device, name,
                                                        kv_quant):
    """After every step the captured engine's logits, picks and cache bytes
    equal the eager engine's (gemma2: rings of 8 that a 21-token prompt
    wraps; deepseek: an int8 cache); one capture; every prompt's prefill
    runs kernel #3 once per layer whose cache is not int8 (an int8 cache
    attends through the plain quantised scan, as the reference's does)."""
    eager = _slot_engine(cuda_device, name, kv_quant, capture=False)
    graph = _slot_engine(cuda_device, name, kv_quant, capture=True)
    before = streaming_attention.launches
    for eng in (eager, graph):
        _smoke_requests(eng)
    steps = 0
    while graph.queue or any(a is not None for a in graph.active):
        eager.step()
        graph.step()
        assert torch.equal(eager.logits, graph.logits), steps
        for k, t in eager.caches.items():
            assert torch.equal(t, graph.caches[k]), (steps, k)
        steps += 1
    assert not eager.queue and all(a is None for a in eager.active)
    assert ({r.uid: r.tokens for r in eager.finished}
            == {r.uid: r.tokens for r in graph.finished})
    assert graph.captures == 1 and eager.captures == 0
    sa_layers = 0 if kv_quant else eager.cfg.num_layers
    assert streaming_attention.launches - before == 2 * 5 * sa_layers


# ------------------------------------------------------------------ MoE --
#
# The MoE layer (models/moe.py) on the card against its CPU run, and the
# MoE family's captured ragged step.  f32: the router's products run
# without TF32 on both, so the routing is the same and ``y`` holds the
# paged suite's f32 tolerance (the expert products sum in cuBLAS's order).

MOE_SMOKE = ("granite-moe-3b-a800m-smoke", "grok-1-314b-smoke")


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_SMOKE)
def test_moe_apply_on_card_equals_cpu(cuda_device, name, monkeypatch):
    """f32 at smoke width, 3 × 40 tokens (capacity overflow at factor
    0.5): equal routing (experts, slots, keep flags; the gates within 1e-6:
    the router's products sum in another order), ``y`` within ``TOL``,
    ``aux`` within 1e-6 relative; one launch of kernel #1."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.params import init_params
    cfg = get_config(name).replace(dtype="float32", moe_capacity_factor=0.5)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = {k: params[k][0] for k in ("router", "up", "gate", "down")}
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 40, cfg.d_model)).astype(np.float32))
    routes = []
    real = moe.topk_route
    monkeypatch.setattr(moe, "topk_route",
                        lambda *a: routes.append(real(*a)) or routes[-1])
    y_cpu, aux_cpu = moe.moe_apply(cfg, p, x)
    before = lut_exp.launches
    y, aux = moe.moe_apply(cfg, {k: v.to(cuda_device) for k, v in p.items()},
                           x.to(cuda_device))
    torch.cuda.synchronize()
    assert lut_exp.launches == before + 1
    want, got = routes
    for field in ("expert", "slot", "keep"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), \
            field
    torch.testing.assert_close(got.gate.cpu(), want.gate, atol=1e-6, rtol=0)
    assert not bool(want.keep.all())                 # overflow dropped some
    torch.testing.assert_close(y.cpu(), y_cpu, **TOL)
    assert abs(float(aux) - float(aux_cpu)) <= 1e-6 * float(aux_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_SMOKE)
def test_moe_captured_step_bit_equal_to_eager(cuda_device, name):
    """The MoE family's ragged step captured per (T, P) against the same
    step dispatched op by op: picks and pool bytes equal after every step
    of the mixed trace (dead rows routed on both)."""
    eager = _smoke_engine(cuda_device, False, capture=False, name=name)
    graph = _smoke_engine(cuda_device, False, capture=True, name=name)
    for eng in (eager, graph):
        _smoke_requests(eng)
    steps = 0
    while eager.scheduler.has_work():
        oe, og = eager.step(), graph.step()
        assert oe.tokens == og.tokens, steps
        for pool, bits in _pool_bits(eager).items():
            assert torch.equal(bits, _pool_bits(graph)[pool]), (steps, pool)
        steps += 1
    assert not graph.scheduler.has_work()
    assert 0 < graph.graphs.captures < steps


@pytest.mark.cuda
def test_moe_replay_counts_one_router_launch_per_layer(cuda_device):
    """A replayed MoE step reads no device value on the host, and N replays
    advance kernel #1's counter by N × layers (the router softmax) beside
    #2's split pass and combine."""
    from repro_torch.kernels.paged_attention import paged_attention
    eng = _smoke_engine(cuda_device, False, capture=True,
                        name="granite-moe-3b-a800m-smoke")
    _smoke_requests(eng, lens=(5, 6, 7), news=(4, 4, 4))
    eng.step()
    eng.step()
    batch, _ = eng.scheduler.batch_for(eng.scheduler.begin_step())
    arrays = eng.step_arrays(batch)
    eng.graphs.run(**arrays)                         # may capture this key
    torch.cuda.synchronize()
    want = eng.graphs.run(**arrays).clone()
    n, layers = 5, eng.cfg.num_layers
    before = (lut_exp.launches, paged_attention.launches,
              paged_attention.combine_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            got = eng.graphs.run(**arrays)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (lut_exp.launches - before[0], paged_attention.launches - before[1],
            paged_attention.combine_launches - before[2]) == (n * layers,) * 3


# ------------------------------------------------------------------ SSM --
#
# The Mamba-1 and Mamba-2 mixers (models/mamba.py, models/mamba2.py) on the
# card against their CPU run in f32 (the products without TF32 on both;
# cuBLAS and the CPU sum in their own orders, so within ``TOL``), kernel
# #1 at the SSM shapes bit for bit, and the slot engine's captured decode
# of an SSM and a hybrid smoke model against the eager one.

SSM_SMOKE = ("falcon-mamba-7b-smoke", "zamba2-1.2b-smoke")


def _ssm_layer(name):
    from repro_torch.configs import get_config
    from repro_torch.models import mamba, mamba2
    from repro_torch.models.lm import layer_keys
    from repro_torch.params import init_params
    cfg = get_config(name).replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = {k: params[k][0] for k in layer_keys(cfg)}
    p["conv_b"] = torch.randn(p["conv_b"].shape,
                              generator=torch.Generator().manual_seed(1))
    if cfg.ssm_variant == "mamba2":
        return cfg, p, mamba2.mamba2_apply, mamba2.mamba2_cache_init, "S"
    return cfg, p, mamba.mamba_apply, mamba.mamba_cache_init, "h"


@pytest.mark.cuda
@pytest.mark.parametrize("name", SSM_SMOKE)
def test_ssm_mixer_on_card_equals_cpu(cuda_device, name):
    """f32 at smoke width: 2 × 21 rows (2 chunks of 8 and a partial one)
    from a random carried state, then 3 decode steps: ``y``, the scan
    state and ``conv`` within ``TOL`` after each call; kernel #1 launched
    once (Mamba-1) or 4 times (Mamba-2) per chunk and once per decode
    step."""
    cfg, p, apply, init, state = _ssm_layer(name)
    g = torch.Generator().manual_seed(2)
    c_cpu = {k: torch.randn(v.shape[1:], generator=g) * 0.5
             for k, v in init(cfg, 2).items()}
    c_dev = {k: v.to(cuda_device) for k, v in c_cpu.items()}
    p_dev = {k: v.to(cuda_device) for k, v in p.items()}
    before = lut_exp.launches
    for rows in (21, 1, 1, 1):
        x = torch.randn((2, rows, cfg.d_model), generator=g)
        y = apply(cfg, p_dev, x.to(cuda_device), cache=c_dev)
        y_cpu = apply(cfg, p, x, cache=c_cpu)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.cpu(), y_cpu, **TOL)
        for k in (state, "conv"):
            torch.testing.assert_close(c_dev[k].cpu(), c_cpu[k], **TOL)
    per_chunk = 4 if cfg.ssm_variant == "mamba2" else 1
    assert lut_exp.launches - before == per_chunk * 3 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,hi", [((1, 128, 8192, 16), 16.0),
                                      ((8, 1, 8192, 16), 16.0),
                                      ((1, 64, 128, 128), 60.0)])
def test_lut_exp_bit_exact_at_the_ssm_shapes(cuda_device, shape, hi):
    """Kernel #1 at falcon-mamba's chunk and decode Ā and zamba2's
    intra-chunk decay, f32 inputs in [-hi, 0]: bit-equal to the plain
    version, orders 0 and 1."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(3)) * -hi
    xd = x.to(cuda_device)
    for order in (0, 1):
        got = lut_exp(xd, order=order)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int32),
                           lut_exp_ref(x, order=order).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SSM_SMOKE)
def test_ssm_slot_engine_captured_decode_bit_equal_to_eager(cuda_device,
                                                            name):
    """After every step the captured engine's logits, picks and every cache
    leaf (conv, scan state, the hybrid's shared K/V) equal the eager
    engine's; one capture; kernel #3 once per period per prompt (the
    hybrid's shared block; none for Mamba-1)."""
    from repro_torch.models.lm import period_layout
    eager = _slot_engine(cuda_device, name, False, capture=False)
    graph = _slot_engine(cuda_device, name, False, capture=True)
    before = streaming_attention.launches
    for eng in (eager, graph):
        _smoke_requests(eng)
    steps = 0
    while graph.queue or any(a is not None for a in graph.active):
        eager.step()
        graph.step()
        assert torch.equal(eager.logits, graph.logits), steps
        for k, t in eager.caches.items():
            assert torch.equal(t, graph.caches[k]), (steps, k)
        steps += 1
    assert ({r.uid: r.tokens for r in eager.finished}
            == {r.uid: r.tokens for r in graph.finished})
    assert graph.captures == 1 and eager.captures == 0
    cfg = graph.cfg
    nper = period_layout(cfg)[1] if cfg.family == "hybrid" else 0
    assert streaming_attention.launches - before == 2 * 5 * nper


@pytest.mark.cuda
@pytest.mark.parametrize("name", SSM_SMOKE)
def test_ssm_decode_replay_counts_one_exp_per_layer(cuda_device, name):
    """A replayed SSM decode step reads no device value on the host, and N
    replays advance kernel #1's counter by N × layers."""
    eng = _slot_engine(cuda_device, name, False, capture=True)
    _smoke_requests(eng, lens=(5, 6, 7), news=(4, 4, 4))
    eng.step()
    eng.step()                                   # the decode is captured
    want = eng._graph.replay().clone()
    torch.cuda.synchronize()
    n, before = 5, lut_exp.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            got = eng._graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert lut_exp.launches - before == n * eng.cfg.num_layers


# internvl2-1b's GQA 7:1 at head dim 64 (a decode row: 7 rows of one row
# tile; a q-block of 8 rows: 56 rows, three whole row tiles of 16 and one
# of 8), bf16 q over a bf16 or an int8 pool, at the default split and at
# one page per split.
@pytest.mark.cuda
@pytest.mark.parametrize("kv_split", [None, 1])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lq", [1, 8])
def test_paged_kernel_at_gqa_7(cuda_device, lq, quant, kv_split):
    """Within one bf16 ulp beyond the f32 atol of the plain version cut
    into the same splits."""
    args, sc = make_case(37 + lq, cuda_device, group=7, hkv=2, d=64, ps=16,
                         p=8, lq=lq, quant=quant)
    args[0] = args[0].bfloat16()
    if not quant:
        args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    before = paged_attention.launches
    got = paged_attention(*args, **sc, kv_split=kv_split)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_reference(
        *args, **sc, kv_split=kv_split or default_kv_split(16))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert bf16_ulps(got, want, TOL["atol"]) <= 1.0


# Kernel #3 at the vlm and encoder-decoder calls at their full sizes:
# internvl2-1b's multimodal prefill (8 × 384 rows over a 416-row cache,
# kv_len 384, 14 × 2 heads of 64, causal), seamless-m4t's encoder (8 × 256
# frames, 16 heads of 64, no mask), its decoder's self-attention prefill
# (16 rows over a 48-row cache, kv_len 16, causal) and its cross-attention
# (16 rows against 256 frames, no mask).
VLM_ENCDEC_CASES = [
    dict(b=8, hq=14, hkv=2, lq=384, lkv=416, d=64, causal=True, kv_len=384),
    dict(b=8, hq=16, hkv=16, lq=256, lkv=256, d=64, causal=False),
    dict(b=8, hq=16, hkv=16, lq=16, lkv=48, d=64, causal=True, kv_len=16),
    dict(b=8, hq=16, hkv=16, lq=16, lkv=256, d=64, causal=False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", VLM_ENCDEC_CASES,
                         ids=["internvl2-prefill", "seamless-encoder",
                              "seamless-self", "seamless-cross"])
def test_streaming_attention_at_the_vlm_encdec_shapes(cuda_device, case,
                                                      dtype):
    """f32 (CUDA cores) at the reference suite's atol 3e-5 / rtol 1e-4;
    bf16 (tensor cores) within one bf16 ulp beyond that atol."""
    (q, k, v), kw = sa_inputs(case, cuda_device, seed=6)
    q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
    variant = "tensor_core" if dtype == "bfloat16" else "cuda_core"
    before = streaming_attention.launches_by_variant[variant]
    got = streaming_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert streaming_attention.launches_by_variant[variant] == before + 1
    want = attention_ref(q, k, v, **kw)
    if dtype == "float32":
        torch.testing.assert_close(got, want, **SA_TOL)
    else:
        assert bf16_ulps(got, want, SA_TOL["atol"]) <= 1.0


@pytest.mark.cuda
def test_vlm_and_encdec_prefill_launch_counts(cuda_device):
    """On the smoke configs: a vlm prefill with a prefix launches #3 once
    per layer; an encoder-decoder prefill 3 times per layer pair (encoder,
    decoder self- and cross-attention); their decode steps none."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.params import init_params
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for name, per in (("internvl2-1b-smoke", 1),
                      ("seamless-m4t-large-v2-smoke", 3)):
        cfg = get_config(name)
        m = build_model(cfg)
        params = init_params(cfg, g, cuda_device)
        stub = (torch.randn((2, cfg.frontend_len, cfg.d_model), generator=g,
                            device=cuda_device) * 0.05).bfloat16()
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 6),
                                         device=cuda_device, generator=g),
                 "prefix_embed" if cfg.family == "vlm" else "frames": stub}
        lp = cfg.frontend_len if cfg.family == "vlm" else 0
        caches = m.init_cache(2, lp + 6 + 3, device=cuda_device)
        before = streaming_attention.launches
        logits, state = m.prefill(params, batch, caches)
        torch.cuda.synchronize()
        layers = cfg.num_layers or cfg.dec_layers
        assert streaming_attention.launches - before == per * layers
        before = streaming_attention.launches
        for t in range(3):
            logits, state = m.decode_step(params, logits.argmax(-1), state,
                                          lp + 6 + t)
        torch.cuda.synchronize()
        assert streaming_attention.launches == before
        assert torch.isfinite(logits).all()


# ------------------------------------------------ #3's backward kernel --

BWD_CASES = SA_CASES + [
    # the order-0 LUT: integer q and k, whose logits are exact on both
    # sides (an ulp of s on a table boundary moves p by a table step)
    dict(b=1, hq=4, hkv=2, lq=96, lkv=96, d=64, causal=True,
         exp_mode="lut0", integers=True),
    # GQA 6:1 at D 128, Lq and Lkv not multiples of 16
    dict(b=1, hq=6, hkv=1, lq=83, lkv=141, d=128, causal=False),
    # D 64 with q_offset and kv_len
    dict(b=2, hq=4, hkv=4, lq=50, lkv=180, d=64, causal=True, q_offset=110,
         kv_len=157),
    # D 256 (gemma2, gemma3; SA_CASES hold a window with cap 50 and a
    # q_offset + kv_len case): GQA 2:1 with cap 50 on ragged Lq and Lkv,
    # a causal window that bites, and the order-0 LUT on integer q and k
    dict(b=1, hq=4, hkv=2, lq=83, lkv=141, d=256, causal=False, cap=50.0),
    dict(b=2, hq=4, hkv=2, lq=200, lkv=200, d=256, causal=True, window=64),
    dict(b=1, hq=4, hkv=2, lq=96, lkv=96, d=256, causal=True,
         exp_mode="lut0", integers=True),
]


def bwd_case(case, dev, dtype, seed=3):
    case = dict(case)
    integers = case.pop("integers", False)
    (q, k, v), kw = sa_inputs(case, dev, seed=seed, integers=integers)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    g = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=g).to(dev, dtype)
    return q, k, v, dout, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_streaming_attention_backward_matches_plain(cuda_device, case, dtype):
    """Autograd through the kernel: one forward launch (with lse) and one
    backward launch, whose dq, dk, dv hold the plain backward fed the same
    out and lse — f32 within 3e-5 of the largest gradient (sums in another
    order), bf16 within one bf16 ulp of it — and the lse the plain
    forward's within 1e-4 (at ``lut0`` at the kernel's key blocking, on
    which its lse depends, as in the forward's lut0 test)."""
    from repro_torch.kernels.streaming_attention.ops import (
        attention_bwd_ref, attention_lse_ref, streaming_attention_bwd,
        streaming_attention_lse)
    q, k, v, dout, kw = bwd_case(case, cuda_device, dtype)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    f0, b0 = streaming_attention.launches, streaming_attention_bwd.launches
    out = streaming_attention(qs, ks, vs, **kw)
    got = torch.autograd.grad(out, (qs, ks, vs), dout)
    torch.cuda.synchronize()
    assert streaming_attention.launches == f0 + 1
    assert streaming_attention_bwd.launches == b0 + 1
    o, lse = streaming_attention_lse(q, k, v, **kw)
    assert torch.equal(o, out.detach())
    scale = q.shape[-1] ** -0.5
    blocking = (block_k(dtype, q.shape[-1]) if kw.get("exp_mode") == "lut0"
                else None)
    _, plain_lse = attention_lse_ref(q, k, v, scale=scale, block_k=blocking,
                                     **kw)
    torch.testing.assert_close(lse, plain_lse, atol=1e-4, rtol=0)
    want = attention_bwd_ref(q, k, v, o, lse, dout, scale=scale, **kw)
    rel = 3e-5 if dtype == torch.float32 else 2.0 ** -7
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        big = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= rel * big + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_streaming_attention_backward_is_deterministic(cuda_device, dtype, d):
    """No atomics: two backward calls give the same bits."""
    from repro_torch.kernels.streaming_attention.ops import (
        streaming_attention_bwd, streaming_attention_lse)
    case = dict(b=2, hq=8, hkv=2, lq=300, lkv=300, d=d, causal=True)
    q, k, v, dout, kw = bwd_case(case, cuda_device, dtype)
    o, lse = streaming_attention_lse(q, k, v, **kw)
    a = streaming_attention_bwd(q, k, v, o, lse, dout, scale=0.125, **kw)
    b = streaming_attention_bwd(q, k, v, o, lse, dout, scale=0.125, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tensor_core"),
                                           (torch.float32, "cuda_core")])
def test_streaming_attention_backward_counts_its_variant(cuda_device, dtype,
                                                         variant):
    """A bf16 backward launches the tensor-core kernels, an f32 one the
    CUDA-core kernels: one launch counted under its variant, none under
    the other."""
    from repro_torch.kernels.streaming_attention.ops import (
        BWD_VARIANTS, streaming_attention_bwd, streaming_attention_lse)
    case = dict(b=1, hq=4, hkv=2, lq=70, lkv=70, d=64, causal=True)
    q, k, v, dout, kw = bwd_case(case, cuda_device, dtype)
    o, lse = streaming_attention_lse(q, k, v, **kw)
    before = dict(streaming_attention_bwd.launches_by_variant)
    streaming_attention_bwd(q, k, v, o, lse, dout, scale=0.125, **kw)
    torch.cuda.synchronize()
    after = streaming_attention_bwd.launches_by_variant
    assert BWD_VARIANTS[dtype] == variant
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == variant) for n in ("tensor_core", "cuda_core")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tensor_core"),
                                           (torch.float32, "cuda_core")])
def test_streaming_attention_backward_launches_at_head_dim_256(cuda_device,
                                                              dtype, variant):
    """A gradient at head dim 256 (gemma2, gemma3) launches the backward
    kernel of its dtype, once, with finite gradients of the inputs'
    shapes."""
    from repro_torch.kernels.streaming_attention.ops import (
        streaming_attention_bwd)
    case = dict(b=1, hq=4, hkv=2, lq=40, lkv=40, d=256, causal=True)
    q, k, v, dout, kw = bwd_case(case, cuda_device, dtype)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    before = dict(streaming_attention_bwd.launches_by_variant)
    got = torch.autograd.grad(streaming_attention(qs, ks, vs, **kw),
                              (qs, ks, vs), dout)
    torch.cuda.synchronize()
    after = streaming_attention_bwd.launches_by_variant
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == variant) for n in ("tensor_core", "cuda_core")}
    for g, t in zip(got, (q, k, v)):
        assert g.shape == t.shape and bool(torch.isfinite(g).all())


# The backward's edges: the underflow cut and both sides of it, 0, a large
# input, the non-finite ones
BWD_EDGES = np.array([-1e30, -87.0, -86.99, 0.0, 88.0, np.inf, -np.inf,
                      np.nan], np.float32)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
def test_lut_exp_backward_kernel_bit_exact(cuda_device, rng, dtype, offset):
    """#1's backward kernel against its plain version (``lut_exp_bwd_ref``)
    on the card, bit for bit: the edges, a wide sweep and a run in
    [-87, -70] with small g (subnormal intermediates, which the kernel
    keeps as torch does), 16-byte vectors (offset 0) and a start off the
    grid (offset 1: one element a thread); one launch at order 1, none at
    order 0 (zeros)."""
    from repro_torch.kernels.lut_exp.ops import lut_exp_bwd
    from repro_torch.kernels.lut_exp.ref import lut_exp_bwd_ref
    x = np.concatenate([BWD_EDGES, rng.uniform(-100, 90, 100003),
                        rng.uniform(-87, -70, 4099)]).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    g[-4099:] *= np.float32(1e-3)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(cuda_device, dt)[offset:]
    gt = torch.from_numpy(g).to(cuda_device, dt)[offset:]
    before = lut_exp.bwd_launches
    got = lut_exp_bwd(xt, gt)
    zero = lut_exp_bwd(xt, gt, order=0)
    torch.cuda.synchronize()
    assert lut_exp.bwd_launches == before + 1
    assert torch.equal(_bits(got), _bits(lut_exp_bwd_ref(xt, gt)))
    assert got.dtype == dt and not zero.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lut_exp_gradient_on_the_card_launches_the_backward(cuda_device, rng,
                                                            dtype):
    """A gradient through #1 on the card: the forward kernel once, the
    backward kernel once (a (B, L, E) router-like input, its incoming
    gradient non-contiguous), equal to the plain backward; under
    ``no_grad`` no node and no backward launch."""
    from repro_torch.kernels.lut_exp.ref import lut_exp_bwd_ref
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.uniform(-20, 0, (4, 33, 40)).astype(
        np.float32)).to(cuda_device, dt).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(40, 33, 4)).astype(
        np.float32)).to(cuda_device, dt).permute(2, 1, 0)
    before = (lut_exp.launches, lut_exp.bwd_launches)
    gx, = torch.autograd.grad(lut_exp(x), x, g)
    torch.cuda.synchronize()
    assert (lut_exp.launches, lut_exp.bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert torch.equal(_bits(gx), _bits(lut_exp_bwd_ref(x.detach(), g)))
    with torch.no_grad():
        assert lut_exp(x).grad_fn is None
    assert lut_exp.bwd_launches == before[1] + 1


@pytest.mark.cuda
def test_moe_down_product_differentiates_on_the_card(cuda_device, rng):
    """The MoE down product's bf16 × bf16 → f32 bmm (``aten::bmm.dtype``,
    no derivative of its own) under autograd: ``_BmmF32Out``'s gradients
    equal autograd of the widened f32 product on the CPU within one bf16
    ulp (f32 sums in another order, each rounded once to bf16)."""
    from repro_torch.models.moe import _bmm_f32
    a = torch.from_numpy(rng.normal(size=(4, 24, 64)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(4, 64, 48)).astype(
        np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(4, 24, 48)).astype(np.float32))
    grads = []
    for dev in (cuda_device, "cpu"):
        ad, wd = (t.to(dev).requires_grad_() for t in (a, w))
        out = _bmm_f32(ad, wd)
        assert out.dtype == torch.float32
        grads.append([t.cpu().float() for t in torch.autograd.grad(
            out, (ad, wd), g.to(dev))])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.cuda
def test_trainer_on_the_card(cuda_device, tmp_path):
    """``Trainer.run()`` on deepseek-7b-smoke in bf16 on the card: #3's
    forward and backward once per layer per step, finite losses, and a
    failure at step 3 recovered bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.kernels.streaming_attention.ops import (
        streaming_attention_bwd)
    from repro_torch.runtime import FailureInjector, TrainConfig, Trainer
    cfg = get_config("deepseek-7b-smoke")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)

    def run(d, injector=None):
        tcfg = TrainConfig(steps=5, ckpt_dir=str(d), ckpt_every=2, lr=5e-3,
                           warmup=2)
        return Trainer(cfg, dcfg, tcfg, device=cuda_device).run(
            injector=injector)

    f0, b0 = streaming_attention.launches, streaming_attention_bwd.launches
    a = run(tmp_path / "a")
    assert streaming_attention.launches - f0 == cfg.num_layers * 5
    assert streaming_attention_bwd.launches - b0 == cfg.num_layers * 5
    assert all(np.isfinite(m["loss"]) for m in a)
    b = run(tmp_path / "b", FailureInjector(fail_at_steps=(3,)))
    assert {m["step"]: m["loss"] for m in a} == {m["step"]: m["loss"]
                                                 for m in b}


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16", "int8"])
def test_paged_block_rows_that_see_no_key_emit_zero(cuda_device, pool_dtype):
    """#2's block entry as the padded step calls it: an idle lane (kv_len
    0, an all-scratch table) and a chunk's padding rows at negative
    positions see no key; the kernel gives them exactly 0, finite, as the
    plain version does, and the live rows hold the plain version cut into
    the kernel's splits."""
    rng = np.random.default_rng(17)
    c, ps, n = 16, 8, 9
    q = torch.from_numpy(rng.normal(size=(3, 4, c, 32)).astype(np.float32))
    kv = [rng.normal(size=(n + 1, 2, ps, 32)).astype(np.float32)
          for _ in range(2)]
    table = torch.tensor([[0, 1, 2], [5, n, n], [n, n, n]], dtype=torch.int32)
    kv_len = torch.tensor([20, 6, 0], dtype=torch.int32)
    kw = {}
    if pool_dtype == "int8":
        (k, ks), (v, vs) = (quantize_kv_rows(torch.from_numpy(a))
                            for a in kv)
        kw = dict(k_scale=ks.to(cuda_device), v_scale=vs.to(cuda_device))
    else:
        k, v = (torch.from_numpy(a).to(getattr(torch, pool_dtype))
                for a in kv)
    q = q.to(torch.float32 if pool_dtype == "float32" else torch.bfloat16)
    dev = lambda t: t.to(cuda_device).contiguous()  # noqa: E731
    got = paged_attention(dev(q), dev(k), dev(v), dev(table), dev(kv_len),
                          **kw)
    torch.cuda.synchronize()
    want = paged_attention_reference(
        q, k, v, table, kv_len, kv_split=default_kv_split(ps),
        **{n_: t.cpu() for n_, t in kw.items()})
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert not got[2].any() and not got[1, :, :c - 6].any()
    live = got[0], got[1, :, c - 6:]
    ref = want[0], want[1, :, c - 6:]
    for a, b in zip(live, ref):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2
                                   if a.dtype == torch.bfloat16 else 2e-5,
                                   rtol=1e-2 if a.dtype == torch.bfloat16
                                   else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_padded_engine_on_the_card(cuda_device, kv_quant):
    """``EngineCore(mode="padded")`` on the card, deepseek-7b-smoke in f32:
    #2's split pass and combine each launched layers × block steps, the
    pool drained, and the greedy streams of the CPU's padded engine on the
    same weights."""
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving import EngineCore, Request
    cfg = get_config("deepseek-7b-smoke").replace(dtype="float32",
                                                  kv_quant=kv_quant)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (3, 21, 9, 14, 6)]
    streams = {}
    for dev in ("cpu", cuda_device):
        eng = EngineCore(cfg, {k: t.to(dev) for k, t in params.items()},
                         lanes=3, page_size=8, num_pages=24, chunk_size=8,
                         mode="padded", device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=5))
        n0, c0 = paged_attention.launches, paged_attention.combine_launches
        steps = 0
        while eng.scheduler.has_work():
            steps += eng.step().lanes > 0
        if dev != "cpu":
            assert paged_attention.launches - n0 == cfg.num_layers * steps
            assert (paged_attention.combine_launches - c0
                    == cfg.num_layers * steps)
        assert eng.pages_in_use == 0
        streams[str(dev)] = {r.uid: r.tokens for r in eng.finished}
    assert streams["cpu"] == streams[str(cuda_device)]
