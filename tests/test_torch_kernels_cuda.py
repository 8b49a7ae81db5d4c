"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``cuda`` and skips without a card.  This file imports
neither JAX nor the reference package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the LUT exponential is bit-exact (the kernel repeats the plain
version's operations in order, each rounded once); f32 attention outputs
hold the reference suite's ``atol=2e-5, rtol=1e-4`` (the kernel walks one
page at a time, the plain version 8 pages per step, so the online-softmax
rescaling and the dot products round in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.streaming_attention import quantize_kv_rows  # noqa: E402
from repro_torch.kernels.lut_exp import lut_exp, lut_exp_ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_reference, paged_attention_varlen,
    paged_attention_varlen_reference, varlen_positions)

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
# it is held against the plain version scanning one page per step, as the
# kernel does (pages of up to 32 rows, which the kernel stages whole), over
# integer q and k whose logits are exact on both sides.
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
    want = paged_attention_reference(*args, **sc, **kw)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_paged_attention_kernel_bf16_within_one_ulp(cuda_device):
    args, sc = make_case(3, cuda_device, group=2, ps=16, lq=8, d=128)
    args[0] = args[0].bfloat16()
    args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    got = paged_attention(*args).float()
    want = paged_attention_reference(*args).float()
    # one bf16 ulp of the larger magnitude, over the f32 atol that bounds
    # the cancellation error of outputs near zero
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    excess = ((got - want).abs() - TOL["atol"]).clamp_min(0.0)
    assert float((excess / ulp).max()) <= 1.0


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
