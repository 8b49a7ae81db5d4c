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
products in f32, in its own order).
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
    BLOCK_K, softmax_exp)

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
# then head dims 64 and 128 with ragged Lq/Lkv, and rows that see no key
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
    """Every case in bf16, on the tensor-core kernel: head dims 8–128, GQA,
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
@pytest.mark.parametrize("d", [64, 128])
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
                                  SA_CASES[8]])
def test_streaming_attention_kernel_bf16_lut0_at_its_blocking(cuda_device,
                                                              case):
    """lut0 in bf16 over integer q and k (exact in bf16, exact logits),
    held against the plain scan at the kernel's 64-key tiles."""
    (q, k, v), kw = sa_inputs(case, cuda_device, integers=True)
    q, k, v = bf16(q, k, v)
    kw = dict(kw, exp_mode="lut0", cap=None)
    got = streaming_attention(q, k, v, **kw)
    want = attention_scan(q, k, v, block_k=BLOCK_K, **kw)
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


@pytest.mark.cuda
def test_streaming_attention_kernel_refuses_a_gradient(cuda_device):
    (q, k, v), kw = sa_inputs(SA_CASES[0], cuda_device)
    q.requires_grad_()
    out = streaming_attention(q, k, v, **kw)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


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

def _smoke_engine(cuda_device, kv_quant, capture, **kw):
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving import EngineCore
    cfg = get_config("deepseek-7b-smoke").replace(dtype="bfloat16",
                                                  kv_quant=kv_quant)
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
        if int(tokens.sum()) < 0:                     # a host read
            return last_idx
        return last_idx + 1

    g = StepGraphs(step_fn, lanes=2, device=cuda_device)
    arrays = dict(tokens=np.ones(4, np.int32), pos=np.arange(4, dtype=np.int32),
                  table=np.zeros((4, 1), np.int32),
                  last_idx=np.zeros(2, np.int32),
                  cu=np.array([0, 4, 4, 4], np.int32))
    before = launch_counts()
    with pytest.raises(RuntimeError):
        g.run(**arrays)
    torch.cuda.synchronize()
    assert not g.keys and launch_counts() == before
