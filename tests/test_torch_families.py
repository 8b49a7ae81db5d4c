"""PyTorch port vs JAX reference on the dense families the ragged engine
serves beside ``deepseek-7b``: ``gemma2-9b-smoke`` (alternating local
window-8 / global layers, attention softcap 50, final softcap 30,
``attn_scale``, post-block norms, embeddings · √d), ``gemma3-12b-smoke``
(five local layers with their own RoPE theta per global one, QK-norm) and
``starcoder2-3b-smoke`` (LayerNorm, biased q/k/v and MLP, GELU).

One ragged serving step (``lm_step_ragged``) — logits and the updated
page pool — and the cache-free forward (``lm_apply``), with the
reference's weights carried over through ``flatten_tree``.  Every bias
and norm scale is first perturbed from a numpy seed (``tests/
_torch_twin.py::perturbed``), since the reference draws them as
constants.  The step is ``test_torch_model_step.py``'s: a decode lane at
position 13 and a chunk at 9..14, so the window of 8 masks keys on every
local layer.  Tolerances are that file's: f32 at atol=rtol=1e-4; int8
pool scales at rtol 1e-5 and values equal save a rounding boundary
(``test_ragged_step_int8_pool_matches_jax``); bf16 within the
reference's own bf16-vs-f32 gap on the same inputs.

Also: the ``reduced`` rule for patterned configs, ``from_flat`` /
``init_params`` over every new leaf, the seeded draw unchanged for
deepseek-7b, ``attn_scale`` in the ragged branch, the final softcap in
``unembed`` and the unpageable window.  About 55 s alone, one intra-op
thread."""
import functools
import hashlib
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
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.autotune import (  # noqa: E402
    KernelConfig as TKernelConfig)
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.lm import (lm_apply, lm_step_ragged,  # noqa: E402
                                   trunk_cache_init)
from repro_torch.params import (from_flat, init_params,  # noqa: E402
                                param_paths)
from repro_torch.serving import EngineCore, UnsupportedCacheLayout  # noqa: E402
from tests._torch_twin import build  # noqa: E402
from tests.test_torch_model_step import (KERNEL_CONFIG, NUM_PAGES,  # noqa: E402
                                         history_pool, step_inputs)

FAMILIES = ["gemma2-9b-smoke", "gemma3-12b-smoke", "starcoder2-3b-smoke"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, L = 2, 24                        # the cache-free batch: L > the window


def to_periods(pool, period):
    """Port pool leaves (layers first, in layer order) → the reference's
    ``{"periods": {j: leaves of layers j, j + P, …}}``."""
    return {"periods": {str(j): {k: v[j::period] for k, v in pool.items()}
                        for j in range(period)}}


def from_periods(caches, period):
    """The reference's period caches → leaves in layer order (numpy f32)."""
    per = caches["periods"]
    out = {}
    for k in per["0"]:
        parts = [np.asarray(per[str(j)][k].astype(jnp.float32))
                 for j in range(period)]
        out[k] = np.stack(parts, 1).reshape((-1,) + parts[0].shape[1:])
    return out


@functools.lru_cache(maxsize=None)
def run_step(name, dtype, kv_quant, attn_scale=None):
    jc, tc, jparams, tparams = build(dtype, kv_quant, name, perturb=5)
    if attn_scale is not None:
        jc, tc = (c.replace(attn_scale=attn_scale) for c in (jc, tc))
    period = len(tc.pattern)
    pool = history_pool(jc, seed=2)
    tokens, pos, table, last_idx, cu = step_inputs(jc.vocab_size)

    jdt = getattr(jnp, dtype)
    jpool = {k: jnp.asarray(v).astype(jdt) if k in ("k", "v")
             and v.dtype == np.float32 else jnp.asarray(v)
             for k, v in pool.items()}
    step = (lambda p, c, *a: j_lm.lm_step_ragged(
        jc, p, a[0], c, a[1], a[2], a[3], cu_seqlens=a[4],
        kernel_config=KernelConfig(**KERNEL_CONFIG)))
    if not kv_quant:
        # under jit XLA multiplies by 1/127 where the quantiser divides, so
        # int8 scales are held against the eager reference (SKILL.md)
        step = jax.jit(step)
    jlogits, jcaches = step(jparams, to_periods(jpool, period),
                            *map(jnp.asarray, (tokens, table, pos, last_idx,
                                               cu)))

    tpool = trunk_cache_init(tc, NUM_PAGES + 1, 8, "cpu")
    for k, v in pool.items():
        tpool[k].copy_(torch.from_numpy(v).to(tpool[k].dtype))
    tlogits = lm_step_ragged(tc, tparams, torch.from_numpy(tokens), tpool,
                             torch.from_numpy(table), torch.from_numpy(pos),
                             torch.from_numpy(last_idx), torch.from_numpy(cu),
                             TKernelConfig(**KERNEL_CONFIG))
    live = slice(0, NUM_PAGES)                   # the scratch page is garbage
    jleaves = {k: v[:, live] for k, v in from_periods(jcaches, period).items()}
    tleaves = {k: v[:, live].to(torch.float32).numpy()
               for k, v in tpool.items()}
    return np.asarray(jlogits), tlogits.numpy(), jleaves, tleaves


@pytest.mark.parametrize("name", FAMILIES)
def test_ragged_step_float32_matches_jax(name):
    jl, tl, jp, tp = run_step(name, "float32", False)
    assert tl.shape == jl.shape == (3, 512)
    np.testing.assert_allclose(tl, jl, **TOL)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_ragged_step_int8_pool_matches_jax(name):
    """Quantise-on-write against the eager reference, logits at the f32
    tolerance.  The step's K/V rows come out of projections summed in
    other orders, so a row's absmax — and its scale — may sit an f32 ulp
    apart (rtol 1e-5, ``test_torch_model_step.py``'s bound); an int8 value
    moves only where its quotient sits on a rounding boundary: by one, at
    most once in 10,000 values (measured: once in 36,864, gemma3)."""
    jl, tl, jp, tp = run_step(name, "float32", True)
    np.testing.assert_allclose(tl, jl, **TOL)
    for k in ("k", "v"):
        diff = np.abs(tp[k] - jp[k])
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, k
    for k in ("ks", "vs"):
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_ragged_step_bfloat16_within_reference_gap(name):
    """The port at least as close to the reference as the reference's bf16
    run is to its own f32 run (``test_torch_model_step.bf16_gaps``)."""
    jf, _, jpf, _ = run_step(name, "float32", False)
    jb, tb, jpb, tpb = run_step(name, "bfloat16", False)
    gaps = {"logits": (np.abs(tb - jb).max(), np.abs(jb - jf).max())}
    for k in jpb:
        gaps[k] = (np.abs(tpb[k] - jpb[k]).max(),
                   np.abs(jpb[k] - jpf[k]).max())
    for what, (port, own) in gaps.items():
        assert port <= own, (what, port, own)


def test_ragged_step_reads_attn_scale():
    """A config's ``attn_scale`` reaches the ragged branch (it used the
    1/√d_head default whatever the config said)."""
    jl, tl, _, _ = run_step("deepseek-7b-smoke", "float32", False, 0.11)
    np.testing.assert_allclose(tl, jl, **TOL)
    base, _, _, _ = run_step("deepseek-7b-smoke", "float32", False)
    assert np.abs(base - jl).max() > 1e-2          # the scale matters here


@functools.lru_cache(maxsize=None)
def run_forward(name, dtype):
    """f32 logits of the cache-free forward (``lm_apply``, the ``jnp``
    backend on both sides) on one (B, L) batch: (reference, port)."""
    jc, tc, jparams, tparams = build(dtype, False, name, perturb=5)
    jc, tc = (c.replace(attn_backend="jnp") for c in (jc, tc))
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (B, L))
    tokens = tokens.astype(np.int32)
    j = jax.jit(lambda p, t: j_lm.lm_apply(jc, p, t)[0])(
        jparams, jnp.asarray(tokens))
    return np.asarray(j), lm_apply(tc, tparams, torch.from_numpy(tokens)).numpy()


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_apply_float32_matches_jax(name):
    j, t = run_forward(name, "float32")
    assert t.shape == (B, L, 512) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_apply_bfloat16_within_reference_gap(name):
    jf, _ = run_forward(name, "float32")
    jb, tb = run_forward(name, "bfloat16")
    assert np.abs(tb - jb).max() <= np.abs(jb - jf).max()


def test_final_softcap_in_unembed():
    """gemma2's final softcap: ``30 · tanh(z / 30)`` of the f32 logits, as
    the reference's ``unembed_apply``."""
    cfg = get_config("gemma2-9b-smoke").replace(dtype="float32")
    rng = np.random.default_rng(4)
    table = (rng.normal(size=(cfg.vocab_size, cfg.d_model)) * 3).astype(
        np.float32)
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32) * 4
    got = t_layers.unembed(cfg, {"embed": torch.from_numpy(table)},
                           torch.from_numpy(x)).numpy()
    want = np.asarray(j_layers.unembed_apply(
        j_get_config("gemma2-9b-smoke").replace(dtype="float32"),
        {"tokens": jnp.asarray(table)}, None, jnp.asarray(x)))
    raw = x @ table.T
    assert np.abs(raw).max() > 60 and np.abs(got).max() <= 30.0
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name,group", [("gemma2-9b", 2), ("gemma3-12b", 2),
                                        ("starcoder2-3b", 12)])
def test_tuner_reads_the_families(name, group):
    """The tuner's geometry carries each model's head dim and GQA group,
    and, with no row of its own in the table, each model resolves the
    platform's default row."""
    from repro_torch.kernels.autotune import geom_for, load_table, resolve_config
    cfg = get_config(name)
    g = geom_for(cfg, page_size=16)
    assert (g.head_dim, g.hq // g.hkv) == (cfg.d_head, group)
    assert not any(k.startswith(name) for k in load_table())
    for platform in ("cpu", "cuda"):
        got = resolve_config(name, platform)
        assert got == resolve_config("default", platform)
        assert got.source == "tuned"


@pytest.mark.parametrize("name,layers", [("gemma2-9b-smoke", 4),
                                         ("gemma3-12b-smoke", 12),
                                         ("starcoder2-3b-smoke", 2)])
def test_reduced_keeps_two_periods(name, layers):
    """The smoke rule keeps two whole periods of a ``layer_pattern``."""
    cfg = get_config(name)
    assert cfg.num_layers == layers == j_get_config(name).num_layers
    assert cfg.layer_kinds() == j_get_config(name).layer_kinds()


@pytest.mark.parametrize("name", FAMILIES)
def test_from_flat_accounts_for_every_leaf(name):
    """Every reference leaf maps onto a port leaf (period slot j's row n →
    layer n·len(pattern) + j), and ``init_params`` draws the same layout:
    norm scales 1, biases 0."""
    jc, tc = j_get_config(name), get_config(name)
    flat = flatten_tree(j_build_model(jc).init(jax.random.PRNGKey(0)))
    assert {p for ps in param_paths(tc).values() for p in ps} == set(flat)
    port = from_flat(flat, tc, "cpu")
    period = len(tc.pattern)
    for j in range(period):
        got = port["wq"][j::period].float().numpy()
        want = np.asarray(flat[f"trunk/periods/{j}/attn/wq/w"].astype(
            np.float32))
        np.testing.assert_array_equal(got, want)
    got = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in port.items()}
    for k, v in got.items():
        if k.endswith("_b"):
            assert not v.any(), k
        if k.endswith(("norm", "ln1", "ln2", "_post")):
            assert (v == 1).all(), k


@pytest.mark.parametrize("name,digest", [
    ("deepseek-7b-smoke", "c63e72bee938491487315556af38886d"),
    ("bert-base-smoke", "9d05e545e7e7f7dddf40042d8ff0ef68")])
def test_init_params_draws_as_before(name, digest):
    """A seed gives the same weights as before the new leaves came: the
    digest of every leaf, drawn with seed 0, as the port drew them when
    it served deepseek-7b and BERT alone."""
    p = init_params(get_config(name), torch.Generator().manual_seed(0), "cpu")
    h = hashlib.sha256()
    for k in sorted(p):
        h.update(k.encode())
        h.update(p[k].float().numpy().tobytes())
    assert h.hexdigest()[:32] == digest


@pytest.mark.parametrize("page_size,ok", [(4, True), (8, True), (16, False),
                                          (3, True), (5, False)])
def test_window_narrower_than_a_page_is_refused(page_size, ok):
    """gemma2-9b-smoke (window 8) pages at page sizes 4 and 8 and raises
    ``UnsupportedCacheLayout("ring_buffer_sliding_window")`` at 16, at
    construction, where the reference's ``EngineCore`` does (its probe
    takes an odd page at twice its size)."""
    from repro.serving import EngineCore as JEngine
    from repro.serving import UnsupportedCacheLayout as JUnsupported
    jc = j_get_config("gemma2-9b-smoke")
    jparams = j_build_model(jc).init(jax.random.PRNGKey(0))
    cfg = get_config("gemma2-9b-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    make = lambda: EngineCore(cfg, params, lanes=2,  # noqa: E731
                              page_size=page_size, num_pages=8, device="cpu")
    kw = dict(lanes=2, page_size=page_size, num_pages=8)
    if ok:
        assert make().kv.page_size == page_size
        assert JEngine(jc, jparams, **kw).kv.page_size == page_size
        return
    with pytest.raises(JUnsupported):
        JEngine(jc, jparams, **kw)
    with pytest.raises(UnsupportedCacheLayout, match="paged KV cache") as ei:
        make()
    assert ei.value.layout == "ring_buffer_sliding_window"
    assert "ring_buffer_sliding_window" in str(ei.value)
    assert isinstance(ei.value, ValueError)
