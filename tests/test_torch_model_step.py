"""PyTorch port vs JAX reference: one ragged serving step of
``deepseek-7b-smoke`` (``lm_step_ragged``) — logits and the updated page
pool — with the reference's weights carried over through ``flatten_tree``.

The step mixes a decode lane, a fresh prefill chunk, a mid-prompt chunk and
dead bucket-padding rows, over pools pre-filled with history, and runs the
q-block-tiled dataflow (block_q 8, block_pages 8)."""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import flatten_tree  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.autotune import KernelConfig  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.lm import KERNEL_CONFIG, lm_step_ragged, trunk_cache_init  # noqa: E402
from repro_torch.params import from_flat  # noqa: E402

NUM_PAGES, PS = 12, 8


def build(dtype, kv_quant):
    jc = j_get_config("deepseek-7b-smoke").replace(dtype=dtype,
                                                   kv_quant=kv_quant)
    tc = get_config("deepseek-7b-smoke").replace(dtype=dtype,
                                                 kv_quant=kv_quant)
    params = build_model(jc).init(jax.random.PRNGKey(0))
    return jc, tc, params, from_flat(flatten_tree(params), tc, "cpu")


def history_pool(cfg, seed):
    """Pool leaves pre-filled with random history rows, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, NUM_PAGES + 1, cfg.num_kv_heads, PS, cfg.d_head)
    if cfg.kv_quant:
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.uniform(0.005, 0.02, shape[:4]).astype(np.float32),
                "vs": rng.uniform(0.005, 0.02, shape[:4]).astype(np.float32)}
    return {"k": (rng.normal(size=shape) * 0.5).astype(np.float32),
            "v": (rng.normal(size=shape) * 0.5).astype(np.float32)}


def step_inputs(vocab):
    """Lane 0 decodes at position 13, lane 1 streams a fresh 5-token chunk,
    lane 2 a 6-token chunk at positions 9..14; 4 dead padding rows."""
    lanes = [(1, 13, [3, 7]), (5, 0, [5]), (6, 9, [1, 10])]
    width, p, scratch = 16, 4, NUM_PAGES
    rng = np.random.default_rng(1)
    tokens = np.zeros(width, np.int32)
    pos = np.zeros(width, np.int32)
    table = np.full((width, p), scratch, np.int32)
    cu = [0]
    for n, start, pages in lanes:
        t0 = cu[-1]
        tokens[t0:t0 + n] = rng.integers(0, vocab, n)
        pos[t0:t0 + n] = start + np.arange(n)
        table[t0:t0 + n, :len(pages)] = pages
        cu.append(t0 + n)
    last_idx = np.asarray(cu[1:], np.int32) - 1
    cu = np.asarray(cu + [width], np.int32)          # trailing pseudo-segment
    return tokens, pos, table, last_idx, cu


@functools.lru_cache(maxsize=None)
def run_step(dtype, kv_quant):
    jc, tc, jparams, tparams = build(dtype, kv_quant)
    pool = history_pool(jc, seed=2)
    tokens, pos, table, last_idx, cu = step_inputs(jc.vocab_size)

    jdt = getattr(jnp, dtype)
    jpool = {k: jnp.asarray(v).astype(jdt) if v.dtype == np.float32
             and k in ("k", "v") else jnp.asarray(v) for k, v in pool.items()}
    jlogits, jcaches = j_lm.lm_step_ragged(
        jc, jparams, jnp.asarray(tokens), {"periods": {"0": jpool}},
        jnp.asarray(table), jnp.asarray(pos), jnp.asarray(last_idx),
        cu_seqlens=jnp.asarray(cu),
        kernel_config=KernelConfig(**KERNEL_CONFIG))

    tpool = trunk_cache_init(tc, NUM_PAGES + 1, PS, "cpu")
    for k, v in pool.items():
        tpool[k].copy_(torch.from_numpy(v).to(tpool[k].dtype))
    tlogits = lm_step_ragged(tc, tparams, torch.from_numpy(tokens), tpool,
                             torch.from_numpy(table), torch.from_numpy(pos),
                             torch.from_numpy(last_idx), torch.from_numpy(cu),
                             KERNEL_CONFIG)
    live_pages = slice(0, NUM_PAGES)                 # the scratch page is
    jleaves = {k: np.asarray(v[:, live_pages].astype(jnp.float32))  # garbage
               for k, v in jcaches["periods"]["0"].items()}
    tleaves = {k: v[:, live_pages].to(torch.float32).numpy()
               for k, v in tpool.items()}
    return (np.asarray(jlogits), tlogits.numpy(), jleaves, tleaves)


def test_ragged_step_float32_matches_jax():
    """f32 config: logits and every updated pool leaf at atol=rtol=1e-4."""
    jl, tl, jp, tp = run_step("float32", False)
    assert tl.shape == jl.shape == (3, 512)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def bf16_gaps(kv_quant):
    """(port-vs-reference gap, the reference's own bf16-vs-f32 gap) per
    output.  Both frameworks round to bf16 after every projection, norm
    and activation, with f32 sums in different orders — and XLA keeps
    excess f32 precision inside its fusions where PyTorch rounds per op —
    so the two bf16 runs land bf16 ulps apart, and the gap travels through
    the residual stream.  The stated tolerance: the port is at least as
    close to the reference as the reference's bf16 run is to its own f32
    run on the same step."""
    jf, _, jpf, _ = run_step("float32", kv_quant)
    jb, tb, jpb, tpb = run_step("bfloat16", kv_quant)
    gaps = {"logits": (np.abs(tb - jb).max(), np.abs(jb - jf).max())}
    for k in jpb:
        gaps[k] = (np.abs(tpb[k] - jpb[k]).max(), np.abs(jpb[k] - jpf[k]).max())
    return gaps, tb, jb


def test_ragged_step_bfloat16_matches_jax():
    gaps, tb, jb = bf16_gaps(False)
    for name, (port, own) in gaps.items():
        assert port <= own, (name, port, own)
    assert np.array_equal(tb.argmax(-1), jb.argmax(-1))


def test_ragged_step_int8_pool_matches_jax():
    """int8 pools in the f32 config: quantise-on-write and per-row dequant
    inside attention.  The written int8 values equal the reference's
    (atol=0), scales match at rtol 1e-5, logits at atol=rtol=1e-4."""
    jl, tl, jp, tp = run_step("float32", True)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    for k in ("ks", "vs"):
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, err_msg=k)


def test_ragged_step_int8_pool_bfloat16_matches_jax():
    """int8 pools in the bf16 config, under the bf16 tolerance above: a
    one-ulp gap in a bf16 K/V row moves its int8 value by a quantisation
    step where it sits near a rounding boundary."""
    gaps, tb, jb = bf16_gaps(True)
    for name, (port, own) in gaps.items():
        assert port <= own, (name, port, own)
