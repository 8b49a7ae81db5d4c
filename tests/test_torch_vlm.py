"""PyTorch port vs JAX reference: the vision-language family
(``internvl2-1b-smoke``: a Qwen2 trunk, GQA 2:1 at the smoke width, QKV
biases, RoPE θ 1e6, tied embeddings, and a stub vision frontend of 4 patch
embeddings prepended to the tokens).

The reference's weights cross over through ``flatten_tree``, every bias
and norm scale perturbed first (``tests/_torch_twin.py::perturbed``);
prefixes and tokens are drawn from numpy seeds.  Covered: ``lm_apply``
with ``prefix_embed`` over all Lp + L rows, ``Model.loss`` on both
branches (next-token, and ``labels``), ``prefill`` with a prefix then 5
``decode_step``s at Lp + L + t (the port of
``tests/test_models.py::test_decode_matches_full_forward[internvl2-1b]``),
one ragged serving step (served as text, as the reference's), the
``EngineCore`` greedy streams against the JAX ``EngineCore`` on f32 and
int8 pools, the slot ``ServingEngine``'s against the reference's, the
flat-tree round trip and the shape stand-ins.

Tolerances (``tests/_torch_twin.py``'s family twins): f32 logits at
atol 2e-5, rtol 1e-4; cache rows at atol = rtol = 1e-4; the ragged step's
logits and pool at atol = rtol = 1e-4 (``test_torch_families.py``); bf16:
over the run, the port's largest logit gap to the reference at most the
reference's own bf16-vs-f32 gap on the same inputs; engines token for
token (int8 pools: save the near-tie rule).  About 40 s alone, one
intra-op thread."""
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
from repro.models import api as j_api  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (batch_specs, build_model,  # noqa: E402
                                input_specs)
from repro_torch.models.lm import (lm_apply, period_layout)  # noqa: E402
from repro_torch.params import from_flat, to_flat  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from tests._torch_twin import build, prompts_for, run_twins  # noqa: E402
from tests.test_torch_families import run_step  # noqa: E402

NAME = "internvl2-1b-smoke"
TOL = dict(atol=2e-5, rtol=1e-4)          # logits
ROW_TOL = dict(atol=1e-4, rtol=1e-4)      # cache rows, the ragged step
B, L, EXTRA = 2, 11, 5


def inputs(cfg, seed=0):
    """Seeded tokens (B, L + EXTRA) and a prefix (B, Lp, D) f32 · 0.05."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, L + EXTRA)).astype(np.int32)
    prefix = (rng.normal(size=(B, cfg.frontend_len, cfg.d_model))
              * 0.05).astype(np.float32)
    return toks, prefix


@functools.lru_cache(maxsize=None)
def run_cached(dtype):
    """Prefill the prefix and L tokens, then EXTRA decode steps, on both
    sides → (reference, port): per-step logits, the caches after the
    prefill and after the last decode, and the full forward's logits."""
    jc, tc, jparams, tparams = build(dtype, False, NAME, perturb=5)
    toks, prefix = inputs(jc)
    lp = jc.frontend_len
    max_len = lp + L + EXTRA
    jpre = jnp.asarray(prefix).astype(jnp.dtype(dtype))
    tpre = torch.from_numpy(prefix).to(getattr(torch, dtype))

    jm = j_build_model(jc)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    lg, jcaches = prefill(jparams, {"tokens": jnp.asarray(toks[:, :L]),
                                    "prefix_embed": jpre},
                          jm.init_cache(B, max_len))
    ref = dict(logits=[np.asarray(lg)], prefilled=_ref_leaves(jcaches))
    for t in range(EXTRA):
        lg, jcaches = decode(jparams, jnp.asarray(toks[:, L + t]), jcaches,
                             jnp.int32(lp + L + t))
        ref["logits"].append(np.asarray(lg))
    ref["decoded"] = _ref_leaves(jcaches)
    ref["full"] = np.asarray(jax.jit(lambda p, t, x: j_lm.lm_apply(
        jc, p, t, prefix_embed=x)[0])(jparams, jnp.asarray(toks), jpre))

    tm = build_model(tc)
    tcaches = tm.init_cache(B, max_len, device="cpu")
    lg, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :L]),
                                 "prefix_embed": tpre}, tcaches)
    port = dict(logits=[lg.numpy()], prefilled=_port_leaves(tcaches))
    for t in range(EXTRA):
        lg, _ = tm.decode_step(tparams, torch.from_numpy(toks[:, L + t]),
                               tcaches, lp + L + t)
        port["logits"].append(lg.numpy())
    port["decoded"] = _port_leaves(tcaches)
    port["full"] = lm_apply(tc, tparams, torch.from_numpy(toks),
                            prefix_embed=tpre).numpy()
    return ref, port


def _ref_leaves(caches):
    """The reference's period caches (one slot per period) → numpy f32."""
    return {k: np.asarray(v.astype(jnp.float32))
            for k, v in caches["periods"]["0"].items()}


def _port_leaves(caches):
    return {k: v.float().numpy().copy() for k, v in caches.items()}


def test_config_and_layout_match_reference():
    """Every field the port keeps has the reference's value, full and
    smoke, and so does the period layout."""
    for name in ("internvl2-1b", NAME):
        t, j = get_config(name), j_get_config(name)
        for field in t.__dataclass_fields__:
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert period_layout(t) == j_lm.period_layout(j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_apply_with_prefix_matches_reference(dtype):
    """All Lp + L rows of the cache-free forward: f32 at ``TOL``; bf16
    within the reference's own bf16-vs-f32 gap."""
    ref, port = run_cached(dtype)
    lp = get_config(NAME).frontend_len
    assert port["full"].shape == ref["full"].shape == (B, lp + L + EXTRA, 512)
    if dtype == "float32":
        np.testing.assert_allclose(port["full"], ref["full"], **TOL)
    else:
        own = np.abs(ref["full"] - run_cached("float32")[0]["full"]).max()
        assert np.abs(port["full"] - ref["full"]).max() <= own


@pytest.mark.parametrize("labels", [False, True])
def test_loss_matches_reference(labels):
    """``Model.loss`` with a prefix, f32: next-token (its logits at the
    tokens' rows 0..L-2) and against ``labels`` of the tokens' shape; the
    prefix's rows score nothing on either side."""
    jc, tc, jparams, tparams = build("float32", False, NAME, perturb=5)
    toks, prefix = inputs(jc, seed=3)
    batch = {"tokens": toks, "prefix_embed": prefix}
    if labels:
        batch["labels"] = np.roll(toks, 1, axis=1)
    jl, jparts = jax.jit(j_build_model(jc).loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tparts = build_model(tc).loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tparts["ce"]), float(jparts["ce"]),
                               rtol=1e-5)
    assert float(tparts["aux"]) == float(jparts["aux"]) == 0.0


def test_prefill_and_decode_float32_match_reference():
    """Prefill with the prefix, then 5 decode steps at Lp + L + t: every
    step's logits at ``TOL`` and every cache leaf (the prefix's rows too)
    at ``ROW_TOL``, after the prefill and after the last decode."""
    ref, port = run_cached("float32")
    for t, (j, p) in enumerate(zip(ref["logits"], port["logits"])):
        assert p.shape == j.shape == (B, 512) and np.isfinite(p).all()
        np.testing.assert_allclose(p, j, err_msg=f"step {t}", **TOL)
    for stage in ("prefilled", "decoded"):
        assert sorted(port[stage]) == sorted(ref[stage])
        for k in ref[stage]:
            np.testing.assert_allclose(port[stage][k], ref[stage][k],
                                       err_msg=(stage, k), **ROW_TOL)


def test_decode_matches_full_forward():
    """The port of ``test_decode_matches_full_forward[internvl2-1b]``, in
    the reference's bf16 and at its bound: the 5 decode steps against the
    port's own full forward over the prefix and all the tokens; and the
    port's bf16 steps within the reference's bf16-vs-f32 gap."""
    ref, port = run_cached("bfloat16")
    lp = get_config(NAME).frontend_len
    dec = np.stack(port["logits"][1:], 1)
    want = port["full"][:, lp + L:lp + L + EXTRA]
    assert np.abs(dec - want).max() < 5e-2
    jf, _ = run_cached("float32")
    gap = max(np.abs(t - j).max() for t, j in zip(port["logits"],
                                                   ref["logits"]))
    own = max(np.abs(b - f).max() for b, f in zip(ref["logits"],
                                                   jf["logits"]))
    assert gap <= own, (gap, own)


def test_ragged_step_float32_matches_jax():
    """One ragged serving step (the vlm served as text: a decode lane and
    a chunk over a pool with history): logits and pool at ``ROW_TOL``."""
    jl, tl, jp, tp = run_step(NAME, "float32", False)
    assert tl.shape == jl.shape == (3, 512)
    np.testing.assert_allclose(tl, jl, **ROW_TOL)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], err_msg=k, **ROW_TOL)


ENGINE = dict(lanes=2, page_size=4, num_pages=16, chunk_size=4)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_streams_match_jax(monkeypatch, kv_quant):
    """``EngineCore`` against the JAX ``EngineCore``, f32 weights, f32 and
    int8 pools: equal plans, streams, page tables and refcounts on every
    step (``run_twins``); the int8 pool token for token save a genuine
    near-tie."""
    prompts = prompts_for(512, 8, [5, 13, 9])
    out = run_twins(monkeypatch, dtype="float32", kv_quant=kv_quant,
                    prompts=prompts, max_new=[6, 4, 7], engine_kw=ENGINE,
                    built=build("float32", kv_quant, NAME, perturb=5))
    assert out["pages_in_use"] == (0, 0)
    if not kv_quant:
        assert not out["forked"]
    assert len(out["forked"]) <= 1, out["near_ties"]


def test_serving_engine_streams_match_reference():
    """The slot engine serves the vlm as text: streams and finish order
    equal the reference's ``ServingEngine``'s."""
    jc, tc, jparams, tparams = build("float32", False, NAME, perturb=5)
    je = JServingEngine(jc, jparams, slots=2, max_len=32)
    te = ServingEngine(tc, tparams, slots=2, max_len=32, device="cpu")
    for i, p in enumerate(prompts_for(512, 4, (8, 6, 7))):
        je.submit(JRequest(uid=i, prompt=p, max_new=4 + i))
        te.submit(Request(uid=i, prompt=p, max_new=4 + i))
    jd, td = je.run(), te.run()
    assert [(r.uid, r.tokens) for r in td] == [(r.uid, r.tokens) for r in jd]


def test_flat_round_trip_and_biases():
    """``from_flat`` / ``to_flat`` carry every reference leaf both ways
    bit for bit; the Qwen2 layout has q/k/v biases and no ``wo`` or MLP
    bias."""
    jc, tc, jparams, tparams = build("bfloat16", False, NAME, perturb=5)
    flat = flatten_tree(jparams)
    back = to_flat(tparams, tc)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        want = np.asarray(v)
        got = back[k]
        assert tuple(got.shape) == want.shape, k
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), k)
    assert {"wq_b", "wk_b", "wv_b"} <= set(tparams)
    assert not {"wo_b", "up_b", "down_b"} & set(tparams)
    again = from_flat({k: v.float().numpy() for k, v in back.items()}, tc,
                      "cpu")
    assert sorted(again) == sorted(tparams)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    """The shape stand-ins: meta tensors of the reference's shapes and
    dtypes, ``prefix_embed`` (B, Lp, D) bf16 and a cache of seq + Lp
    rows."""
    jspec = j_api.input_specs(j_get_config(NAME), kind, 16, 3)
    tspec = input_specs(get_config(NAME), kind, 16, 3)
    if kind == "train":
        assert sorted(tspec["batch"]) == sorted(jspec["batch"])
        for k, v in tspec["batch"].items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == jspec["batch"][k].shape
            assert str(v.dtype).split(".")[-1] == jspec["batch"][k].dtype.name
        assert tuple(tspec["batch"]["prefix_embed"].shape) == (3, 4, 64)
        return
    caches = tspec["caches" if kind == "prefill" else "state"]
    jc = jspec["caches" if kind == "prefill" else "state"]["periods"]["0"]
    for k, v in caches.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == jc[k].shape, k      # one layer per period
        assert str(v.dtype).split(".")[-1] == jc[k].dtype.name
    assert caches["k"].shape[3] == 16 + 4
    if kind == "decode":
        assert tspec["token"].shape == (3,) and tspec["index"].shape == ()
    assert sorted(batch_specs(get_config(NAME), 1, 2, with_labels=False)) \
        == ["prefix_embed", "tokens"]
