"""PyTorch port vs JAX reference: the dense family's cached contiguous path
(``build_model(cfg).init_cache`` / ``.prefill`` / ``.decode_step``) on the
CPU, for ``deepseek-7b-smoke``, ``gemma2-9b-smoke`` (local window 8: with
``max_len`` 32 its local layers keep ring buffers, which a 12-token prompt
and 6 decodes wrap), ``gemma3-12b-smoke`` (five ring layers per global
one) and ``starcoder2-3b-smoke``, and the int8 cache's attention
(``streaming_attention_quantized``).

The reference's weights cross over through ``flatten_tree``, every bias
and norm scale perturbed first (``tests/_torch_twin.py::perturbed``).
Both sides see the same prompt and the same decode tokens (drawn from a
numpy seed, not picked), so one step's difference cannot steer the next.

Tolerances.  f32 (both sides sum the same f32 products in other orders):
logits at atol 2e-5, rtol 1e-4; cache rows at the step twins'
atol = rtol = 1e-4 (``test_torch_model_step.py``), since a deep layer's K
and V rows carry the residual stream's drift (one element of gemma3's
eleventh layer reads 2.4e-5 apart); ring positions bit for bit.  int8 caches (``kv_quant``, against
the eager reference, whose quantiser divides where jit multiplies): row
scales at rtol 1e-5 (a row's absmax may sit an f32 ulp apart) and int8
values equal save a quotient on a rounding boundary, by one, at most once
in 10,000 values.  bf16: over the run, the port at least as close to the
reference as the reference's bf16 run is to its own f32 run on the same
inputs.  About
50 s alone, one intra-op thread."""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.streaming_attention import (  # noqa: E402
    naive_attention as j_naive,
    streaming_attention as j_scan,
    streaming_attention_quantized as j_quantized)
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro_torch.core.streaming_attention import (  # noqa: E402
    naive_attention, quantize_kv_rows, streaming_attention,
    streaming_attention_quantized)
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.lm import layer_caches  # noqa: E402
from tests._torch_twin import build  # noqa: E402

FAMILIES = ["deepseek-7b-smoke", "gemma2-9b-smoke", "gemma3-12b-smoke",
            "starcoder2-3b-smoke"]
TOL = dict(atol=2e-5, rtol=1e-4)          # logits
ROW_TOL = dict(atol=1e-4, rtol=1e-4)      # cache rows
B, PROMPT, DECODES, MAX_LEN = 2, 12, 6, 32


def ref_layers(caches, period, n_layers):
    """The reference's period caches → one dict of numpy leaves per layer,
    in layer order (layer n·period + j is ``periods/{j}`` row n)."""
    out = []
    for i in range(n_layers):
        n, j = divmod(i, period)
        out.append({k: np.asarray(v[n].astype(jnp.float32)
                                  if v.dtype == jnp.bfloat16 else v[n])
                    for k, v in caches["periods"][str(j)].items()})
    return out


def port_layers(cfg, caches):
    """The port's caches → one dict of numpy copies per layer."""
    return [{k: (v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()
             for k, v in layer.items()} for layer in layer_caches(cfg, caches)]


@functools.lru_cache(maxsize=None)
def run_cached(name, dtype, kv_quant):
    """Prefill a (B, 12) prompt, then 6 decode steps, on both sides →
    (reference, port) each with its per-step logits and its per-layer
    caches after the prefill and after the last decode."""
    jc, tc, jparams, tparams = build(dtype, kv_quant, name, perturb=5)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, jc.vocab_size, (B, PROMPT)).astype(np.int32)
    toks = rng.integers(0, jc.vocab_size, (DECODES, B)).astype(np.int32)
    period = len(tc.pattern)

    jm = j_build_model(jc)
    prefill, decode = jm.prefill, jm.decode_step
    if not kv_quant:
        prefill, decode = jax.jit(prefill), jax.jit(decode)
    jcaches = jm.init_cache(B, MAX_LEN)
    lg, jcaches = prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcaches)
    ref = dict(logits=[np.asarray(lg)],
               prefilled=ref_layers(jcaches, period, jc.num_layers))
    for t in range(DECODES):
        lg, jcaches = decode(jparams, jnp.asarray(toks[t]), jcaches,
                             jnp.int32(PROMPT + t))
        ref["logits"].append(np.asarray(lg))
    ref["decoded"] = ref_layers(jcaches, period, jc.num_layers)

    tm = build_model(tc)
    tcaches = tm.init_cache(B, MAX_LEN, device="cpu")
    lg, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(prompt)}, tcaches)
    port = dict(logits=[lg.numpy()], prefilled=port_layers(tc, tcaches))
    for t in range(DECODES):
        lg, _ = tm.decode_step(tparams, torch.from_numpy(toks[t]), tcaches,
                               PROMPT + t)
        port["logits"].append(lg.numpy())
    port["decoded"] = port_layers(tc, tcaches)
    return ref, port


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_init_cache_leaves_match_reference(name, kv_quant):
    """Every layer's leaves: the reference's names, shapes, dtypes and
    initial values: zeros, and ring positions -1, "never written", as the
    reference's ``attn_cache_init`` makes them.  (Its ``trunk_cache_init``
    stacks the layers' caches with ``jnp.zeros``, which turns them into
    0: a position every query may see.  The prompts of these twins fill
    the ring before the first decode, so the two agree here; the port
    keeps -1, and ``test_torch_slot_engine.py`` holds a prompt shorter
    than the window to the paged engine, which has no ring.)"""
    jc, tc, _, _ = build("bfloat16", kv_quant, name)
    jl = ref_layers(j_build_model(jc).init_cache(3, MAX_LEN), len(tc.pattern),
                    jc.num_layers)
    caches = build_model(tc).init_cache(3, MAX_LEN, device="cpu")
    tl = layer_caches(tc, caches)
    assert len(tl) == len(jl) == tc.num_layers
    want_ring = [k == "local" and tc.window < MAX_LEN
                 for k in tc.layer_kinds()]
    assert [("pos" in x) for x in tl] == want_ring
    assert ("ring_pos" in caches) == any(want_ring)
    dtypes = {"bfloat16": "bfloat16", "int8": "int8", "float32": "float32",
              "int32": "int32"}
    jraw = j_build_model(jc).init_cache(3, MAX_LEN)["periods"]
    for i, (j, t) in enumerate(zip(jl, tl)):
        assert sorted(j) == sorted(t), i
        for k in j:
            assert tuple(t[k].shape) == j[k].shape, (i, k)
            jdt = jraw[str(i % len(tc.pattern))][k].dtype
            assert str(t[k].dtype).split(".")[-1] == dtypes[jdt.name], (i, k)
            want = np.full(j[k].shape, -1) if k == "pos" else j[k]
            np.testing.assert_array_equal(t[k].float().numpy(), want, (i, k))
    ring = j_layers.attn_cache_init(jc, 3, MAX_LEN, kind="local")
    if any(want_ring):
        np.testing.assert_array_equal(np.asarray(ring["pos"]), -1)


def test_bert_init_cache_matches_reference():
    """bert's ``Model.init_cache`` is the stacked ``trunk_cache_init``, as
    the reference's: the same leaves, shapes, dtypes and zeros."""
    jc, tc, _, _ = build("bfloat16", False, "bert-base-smoke")
    jl = ref_layers(j_build_model(jc).init_cache(3, MAX_LEN), 1,
                    jc.num_layers)
    tl = layer_caches(tc, build_model(tc).init_cache(3, MAX_LEN,
                                                     device="cpu"))
    assert len(tl) == len(jl) == tc.num_layers
    for j, t in zip(jl, tl):
        assert sorted(j) == sorted(t) == ["k", "v"]
        for k in j:
            assert tuple(t[k].shape) == j[k].shape
            assert t[k].dtype == torch.bfloat16 and not t[k].any()


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_float32_match_reference(name):
    ref, port = run_cached(name, "float32", False)
    for t, (j, p) in enumerate(zip(ref["logits"], port["logits"])):
        assert p.shape == j.shape == (B, 512) and np.isfinite(p).all()
        np.testing.assert_allclose(p, j, err_msg=f"step {t}", **TOL)
    for stage in ("prefilled", "decoded"):
        for i, (j, p) in enumerate(zip(ref[stage], port[stage])):
            for k in j:
                if k == "pos":
                    np.testing.assert_array_equal(p[k], j[k], (stage, i))
                else:
                    np.testing.assert_allclose(p[k], j[k], err_msg=(stage, i, k),
                                               **ROW_TOL)


def test_ring_buffer_wraps():
    """gemma2's local layers after 12 prompt rows and 6 decodes: each ring
    of 8 holds positions 10..17, position p at slot p mod 8, for both
    batch rows."""
    _, port = run_cached("gemma2-9b-smoke", "float32", False)
    want = np.array([p for p in range(10, 18)])[np.argsort(
        np.arange(10, 18) % 8)]
    rings = [layer["pos"] for layer in port["decoded"] if "pos" in layer]
    assert len(rings) == 2                  # the smoke config's local layers
    for ring in rings:
        np.testing.assert_array_equal(ring, np.stack([want] * B))


@pytest.mark.parametrize("name", ["deepseek-7b-smoke", "gemma2-9b-smoke"])
def test_prefill_and_decode_int8_match_reference(name):
    ref, port = run_cached(name, "float32", True)
    for t, (j, p) in enumerate(zip(ref["logits"], port["logits"])):
        np.testing.assert_allclose(p, j, err_msg=f"step {t}", **TOL)
    for i, (j, p) in enumerate(zip(ref["decoded"], port["decoded"])):
        if "ks" not in j:                       # a ring layer: never int8
            continue
        for k in ("k", "v"):
            assert p[k].dtype == np.int8
            diff = np.abs(p[k].astype(np.int32) - j[k].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (i, k)
        for k in ("ks", "vs"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-5, err_msg=(i, k))


@pytest.mark.parametrize("name", ["deepseek-7b-smoke", "gemma2-9b-smoke"])
def test_prefill_and_decode_bfloat16_within_reference_gap(name):
    """Over the run (the prefill and 6 decodes: one sequence of logits),
    the port's largest bf16 logit gap to the reference at most the
    reference's own largest bf16-vs-f32 gap.  Step by step the two sit
    within a few tenths of each other (gemma2: 0.0175 against 0.0135 at
    one decode, 0.0098 against 0.0148 at the next)."""
    jf, _ = run_cached(name, "float32", False)
    jb, tb = run_cached(name, "bfloat16", False)
    port = max(np.abs(t - j).max() for t, j in zip(tb["logits"], jb["logits"]))
    own = max(np.abs(b - f).max() for b, f in zip(jb["logits"], jf["logits"]))
    assert port <= own, (port, own)


def test_decode_at_per_row_positions_equals_one_position():
    """A (B,) position vector holding one position decodes as that int
    does, and batch rows at different positions decode as each row alone
    (the slot engine's decode against the reference's vmap of b = 1)."""
    _, tc, _, tparams = build("float32", False, "gemma2-9b-smoke", perturb=5)
    m = build_model(tc)
    rng = np.random.default_rng(12)
    prompt = torch.from_numpy(rng.integers(0, tc.vocab_size, (B, 10))
                              .astype(np.int32))
    tok = torch.from_numpy(rng.integers(0, tc.vocab_size, B).astype(np.int32))
    runs = []
    for index in (10, torch.tensor([10, 10])):
        c = m.init_cache(B, MAX_LEN, device="cpu")
        m.prefill(tparams, {"tokens": prompt}, c)
        runs.append(m.decode_step(tparams, tok, c, index)[0])
    np.testing.assert_allclose(runs[1].numpy(), runs[0].numpy(), rtol=0,
                               atol=1e-6)
    # rows at 10 and 12: each equals its own b = 1 run
    both = m.init_cache(B, MAX_LEN, device="cpu")
    rows = [m.init_cache(1, MAX_LEN, device="cpu") for _ in range(B)]
    prompts = [prompt[0, :10], torch.cat([prompt[1], prompt[0, :2]])]
    for b, (c, p) in enumerate(zip(rows, prompts)):
        m.prefill(tparams, {"tokens": p[None]}, c)
        one = {k: v[:, b:b + 1] for k, v in both.items()}
        m.prefill(tparams, {"tokens": p[None]}, one)
    got = m.decode_step(tparams, tok, both, torch.tensor([10, 12]))[0]
    for b, (c, n) in enumerate(zip(rows, (10, 12))):
        want = m.decode_step(tparams, tok[b:b + 1], c, n)[0]
        np.testing.assert_allclose(got[b:b + 1].numpy(), want.numpy(),
                                   rtol=0, atol=1e-6)


# ------------------------------------------ streaming_attention_quantized --

def _draw(seed, b=2, hq=4, hkv=2, lq=5, lkv=23, d=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, lq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, lkv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


QUANT_CASES = [
    dict(lq=5, lkv=23, causal=True, q_offset=9, kv_len=14, block_k=4),
    dict(lq=5, lkv=23, causal=True, q_offset=9, kv_len=14, block_k=8,
         window=6, cap=30.0),
    dict(lq=7, lkv=23, causal=False, block_k=16, exp_mode="exact"),
    dict(lq=1, lkv=23, causal=True, q_offset=17, kv_len=18, window=8),
    dict(lq=1, lkv=23, causal=True, q_offset=3, kv_len=4, cap=50.0,
         exp_mode="lut0"),
]


@pytest.mark.parametrize("case", QUANT_CASES)
def test_streaming_attention_quantized_matches_reference(case):
    """The int8 scan (multi-row: blocked, dequantised per block) and its
    single-row shortcut against the reference's, on the int8 rows and
    scales of one quantisation."""
    kw = dict(case)
    q, k, v = _draw(3, lq=kw.pop("lq"), lkv=kw.pop("lkv"))
    kq, ks = quantize_kv_rows(torch.from_numpy(k))
    vq, vs = quantize_kv_rows(torch.from_numpy(v))
    got = streaming_attention_quantized(torch.from_numpy(q), kq, vq, ks, vs,
                                        **kw)
    want = j_quantized(jnp.asarray(q), jnp.asarray(kq.numpy()),
                       jnp.asarray(vq.numpy()), jnp.asarray(ks.numpy()),
                       jnp.asarray(vs.numpy()), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_streaming_attention_quantized_ring_positions():
    """Explicit slot positions (a ring's ``kv_pos``) reach the mask."""
    q, k, v = _draw(4, lq=1, lkv=8)
    kv_pos = np.array([[8, 9, 10, 3, 4, 5, 6, 7],
                       [0, 1, 2, -1, -1, -1, -1, -1]], np.int32)
    kq, ks = quantize_kv_rows(torch.from_numpy(k))
    vq, vs = quantize_kv_rows(torch.from_numpy(v))
    kw = dict(causal=True, window=6, q_offset=10)
    got = streaming_attention_quantized(torch.from_numpy(q), kq, vq, ks, vs,
                                        kv_pos=torch.from_numpy(kv_pos), **kw)
    want = j_quantized(jnp.asarray(q), jnp.asarray(kq.numpy()),
                       jnp.asarray(vq.numpy()), jnp.asarray(ks.numpy()),
                       jnp.asarray(vs.numpy()), kv_pos=jnp.asarray(kv_pos),
                       **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fn,ref", [(naive_attention, j_naive),
                                    (streaming_attention, j_scan)])
def test_per_row_positions_match_the_reference_row_by_row(fn, ref):
    """(B,) ``q_offset`` and ``kv_len``: each batch row as the reference's
    call on that row alone with its own ints."""
    q, k, v = _draw(5, lq=1, lkv=20)
    offs, lens = [7, 15], [8, 16]
    kw = dict(causal=True, window=5, exp_mode="lut")
    extra = {} if fn is naive_attention else dict(block_k=8)
    got = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             q_offset=torch.tensor(offs), kv_len=torch.tensor(lens), **kw,
             **extra).numpy()
    for b in range(2):
        want = ref(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                   jnp.asarray(v[b:b + 1]), q_offset=offs[b],
                   kv_len=lens[b], **kw, **extra)
        np.testing.assert_allclose(got[b:b + 1], np.asarray(want), **TOL)
