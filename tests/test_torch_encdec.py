"""PyTorch port vs JAX reference: the encoder-decoder family
(``seamless-m4t-large-v2-smoke``: 2 bidirectional encoder layers over 4
stub audio frames, 2 decoder layers with cross-attention, MHA reduced to
4 heads over 2 kv heads, LayerNorm, plain GELU MLP, tied embeddings).

The reference's weights cross over through ``flatten_tree``, every bias
and norm scale perturbed first (``tests/_torch_twin.py::perturbed``);
frames and tokens are drawn from numpy seeds.  Covered, each against the
reference's function on the same inputs: ``encode``, ``cross_kvs_init``,
``decode_trunk``, ``encdec_loss`` (``ce``; ``aux`` 0), and ``prefill`` +
``decode_step`` leaf by leaf over ``self`` and ``cross`` (the port of
``tests/test_models.py::test_encdec_decode_matches_forward``); the flat
tree both ways; a count of the cross K/V projections (once per decoder
layer per prefill, none in a decode step); the refusals —
``EngineCore``'s ``UnsupportedCacheLayout("no_paged_step")`` with the
reference's words, the slot engine's ``NotImplementedError``, the serve
CLI's non-zero exit —; and the shape stand-ins (``{"self", "cross"}``).

Tolerances (``tests/_torch_twin.py``'s family twins): f32 logits at
atol 2e-5, rtol 1e-4; activations, cross K/V and cache rows at
atol = rtol = 1e-4; bf16: over the run, the port's largest logit gap to
the reference's f32 run at most 1.25× the reference's own bf16 run's
(``test_decode_matches_forward`` gives the measured share).  About 20 s
alone, one intra-op thread."""
import functools
import os
import subprocess
import sys
from pathlib import Path

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
from repro.models import encdec as j_ed  # noqa: E402
from repro.serving import EngineCore as JEngine  # noqa: E402
from repro.serving import UnsupportedCacheLayout as JUnsupported  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, cache_specs  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.params import from_flat, to_flat  # noqa: E402
from repro_torch.serving import (EngineCore, ServingEngine,  # noqa: E402
                                 UnsupportedCacheLayout)
from tests._torch_twin import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAME = "seamless-m4t-large-v2-smoke"
TOL = dict(atol=2e-5, rtol=1e-4)          # logits
ROW_TOL = dict(atol=1e-4, rtol=1e-4)      # activations, K/V, cache rows
B, L, EXTRA = 2, 9, 4


def inputs(cfg, seed=0):
    """Seeded frames (B, L_src, D) f32 · 0.05 and tokens (B, L + EXTRA)."""
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(B, cfg.frontend_len, cfg.d_model))
              * 0.05).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, L + EXTRA)).astype(np.int32)
    return frames, toks


def _np(x):
    if isinstance(x, torch.Tensor):        # a copy: caches change in place
        return x.float().numpy().copy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def run_parts(dtype):
    """The cache-free parts on both sides: encode, the cross K/V, the
    decoder trunk's logits over all tokens, and the loss."""
    jc, tc, jparams, tparams = build(dtype, False, NAME, perturb=5)
    frames, toks = inputs(jc)
    jenc = jax.jit(lambda p, f: j_ed.encode(jc, p, f))(jparams, frames)
    jkv = jax.jit(lambda p, e: j_ed.cross_kvs_init(jc, p, e))(jparams, jenc)
    jlog = jax.jit(lambda p, t, c: j_ed.decode_trunk(jc, p, t, c)[0])(
        jparams, toks, jkv)
    jloss = jax.jit(lambda p, b: j_ed.encdec_loss(jc, p, b))(
        jparams, {"frames": frames, "tokens": toks})
    tf, tt = torch.from_numpy(frames), torch.from_numpy(toks)
    tenc = ed.encode(tc, tparams, tf)
    tkv = ed.cross_kvs_init(tc, tparams, tenc)
    tlog = ed.decode_trunk(tc, tparams, tt, tkv)
    tloss = ed.encdec_loss(tc, tparams, {"frames": tf, "tokens": tt})
    ref = dict(enc=_np(jenc), k=_np(jkv["k"]), v=_np(jkv["v"]),
               logits=_np(jlog), loss=jloss)
    port = dict(enc=_np(tenc), k=_np(tkv["k"]), v=_np(tkv["v"]),
                logits=_np(tlog), loss=tloss)
    return ref, port


@functools.lru_cache(maxsize=None)
def run_cached(dtype):
    """``Model.prefill`` of the frames and L tokens, then EXTRA
    ``decode_step``s at L + t, on both sides → per-step logits and the
    state's leaves (``self`` and ``cross``) after the prefill and after the
    last decode; and the port's cache-free trunk over all the tokens."""
    jc, tc, jparams, tparams = build(dtype, False, NAME, perturb=5)
    frames, toks = inputs(jc, seed=1)
    max_len = L + EXTRA
    jm = j_build_model(jc)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    lg, state = prefill(jparams, {"frames": jnp.asarray(frames),
                                  "tokens": jnp.asarray(toks[:, :L])},
                        jm.init_cache(B, max_len))
    ref = dict(logits=[_np(lg)], prefilled=_leaves(state))
    for t in range(EXTRA):
        lg, state = decode(jparams, jnp.asarray(toks[:, L + t]), state,
                           jnp.int32(L + t))
        ref["logits"].append(_np(lg))
    ref["decoded"] = _leaves(state)

    tm = build_model(tc)
    lg, state = tm.prefill(tparams, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(toks[:, :L])},
                           tm.init_cache(B, max_len, device="cpu"))
    port = dict(logits=[_np(lg)], prefilled=_leaves(state))
    for t in range(EXTRA):
        lg, state = tm.decode_step(tparams, torch.from_numpy(toks[:, L + t]),
                                   state, L + t)
        port["logits"].append(_np(lg))
    port["decoded"] = _leaves(state)
    enc = ed.encode(tc, tparams, torch.from_numpy(frames))
    port["full"] = _np(ed.decode_trunk(tc, tparams, torch.from_numpy(toks),
                                       ed.cross_kvs_init(tc, tparams, enc)))
    return ref, port


def _leaves(state):
    return {(part, k): _np(v) for part in ("self", "cross")
            for k, v in state[part].items()}


def test_configs_match_reference():
    for name in ("seamless-m4t-large-v2", NAME):
        t, j = get_config(name), j_get_config(name)
        for field in t.__dataclass_fields__:
            assert getattr(t, field) == getattr(j, field), (name, field)
    assert (get_config(NAME).enc_layers, get_config(NAME).dec_layers,
            get_config(NAME).num_layers) == (2, 2, 0)


@pytest.mark.parametrize("part", ["enc", "k", "v"])
def test_encode_and_cross_kv_match_reference(part):
    """The encoder's output (B, 4, D) and the stacked cross K/V
    (dec_layers, B, Hkv, 4, Dh), f32."""
    ref, port = run_parts("float32")
    assert port[part].shape == ref[part].shape
    np.testing.assert_allclose(port[part], ref[part], **ROW_TOL)


def test_decode_trunk_and_loss_match_reference():
    """The decoder trunk's logits over every token at ``TOL``; the loss
    and its ``ce`` at rtol 1e-5, ``aux`` 0 on both sides."""
    ref, port = run_parts("float32")
    assert port["logits"].shape == ref["logits"].shape == (B, L + EXTRA, 512)
    np.testing.assert_allclose(port["logits"], ref["logits"], **TOL)
    (jl, jparts), (tl, tparts) = ref["loss"], port["loss"]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tparts["ce"]), float(jparts["ce"]),
                               rtol=1e-5)
    assert float(tparts["aux"]) == float(jparts["aux"]) == 0.0


def test_prefill_and_decode_match_reference_leaf_by_leaf():
    """Every step's logits at ``TOL``; after the prefill and after the
    last decode, every leaf of ``self`` (the decoder's K/V cache) and of
    ``cross`` (carried through unchanged) at ``ROW_TOL``."""
    ref, port = run_cached("float32")
    for t, (j, p) in enumerate(zip(ref["logits"], port["logits"])):
        assert p.shape == j.shape == (B, 512) and np.isfinite(p).all()
        np.testing.assert_allclose(p, j, err_msg=f"step {t}", **TOL)
    for stage in ("prefilled", "decoded"):
        assert sorted(port[stage]) == sorted(ref[stage])
        for key, want in ref[stage].items():
            assert port[stage][key].shape == want.shape, key
            np.testing.assert_allclose(port[stage][key], want,
                                       err_msg=(stage, key), **ROW_TOL)
    for k in ("k", "v"):
        np.testing.assert_array_equal(port["decoded"][("cross", k)],
                                      port["prefilled"][("cross", k)])


def test_decode_matches_forward():
    """The port of ``test_encdec_decode_matches_forward``, in the
    reference's bf16 and at its bound: the decode steps against the port's
    own cache-free trunk over all the tokens.  And the port's bf16 run
    stands as close to the reference's f32 run as the reference's own bf16
    run does, within 1.25× over the run (measured: 0.00582 against
    0.00519, 1.12×; step by step the port's bf16 sits 0.0032–0.0054 from
    the reference's bf16, whose own gap to f32 is 0.0040–0.0052)."""
    ref, port = run_cached("bfloat16")
    dec = np.stack(port["logits"][1:], 1)
    assert np.abs(dec - port["full"][:, L:L + EXTRA]).max() < 5e-2
    jf, _ = run_cached("float32")
    port_gap = max(np.abs(t - f).max() for t, f in zip(port["logits"],
                                                        jf["logits"]))
    own = max(np.abs(b - f).max() for b, f in zip(ref["logits"],
                                                   jf["logits"]))
    assert port_gap <= 1.25 * own, (port_gap, own)


def test_flat_round_trip():
    """``from_flat`` / ``to_flat`` carry every reference leaf (``encoder``,
    ``decoder`` with ``self_attn``, ``lnx`` and ``cross_attn``, both final
    norms, the tied table) both ways bit for bit."""
    jc, tc, jparams, tparams = build("bfloat16", False, NAME, perturb=5)
    flat = flatten_tree(jparams)
    back = to_flat(tparams, tc)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        want = np.asarray(v)
        assert tuple(back[k].shape) == want.shape, k
        np.testing.assert_array_equal(back[k].view(torch.int16).numpy(),
                                      want.view(np.int16), k)
    again = from_flat({k: v.float().numpy() for k, v in back.items()}, tc,
                      "cpu")
    assert sorted(again) == sorted(tparams)
    assert {"enc_wq", "cross_wk", "lnx_b", "enc_norm", "dec_norm"} \
        <= set(tparams)


def test_cross_kv_projected_once_per_prefill(monkeypatch):
    """``cross_wk`` and ``cross_wv`` project the encoder output once per
    decoder layer in a prefill and never in a decode step: every
    projection is counted by the storage of the weight it reads."""
    _, tc, _, tparams = build("float32", False, NAME)
    frames, toks = inputs(tc, seed=2)
    seen = {"cross_wk": 0, "cross_wv": 0}
    ptrs = {tparams[k].untyped_storage().data_ptr(): k for k in seen}
    inner = t_layers.dense_apply

    def counted(w, x, b=None):
        key = ptrs.get(w.untyped_storage().data_ptr())
        if key is not None:
            seen[key] += 1
        return inner(w, x, b)
    monkeypatch.setattr(t_layers, "dense_apply", counted)
    m = build_model(tc)
    _, state = m.prefill(tparams, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.from_numpy(toks[:, :L])},
                         m.init_cache(B, L + EXTRA, device="cpu"))
    assert seen == {"cross_wk": tc.dec_layers, "cross_wv": tc.dec_layers}
    for t in range(EXTRA):
        m.decode_step(tparams, torch.from_numpy(toks[:, L + t]), state, L + t)
    assert seen == {"cross_wk": tc.dec_layers, "cross_wv": tc.dec_layers}


def test_engine_core_refuses_with_the_reference_kind():
    """Both ``EngineCore``s refuse the encoder-decoder with
    ``UnsupportedCacheLayout("no_paged_step")`` and the same words."""
    jc, tc, jparams, tparams = build("float32", False, NAME)
    with pytest.raises(JUnsupported) as jerr:
        JEngine(jc, jparams)
    with pytest.raises(UnsupportedCacheLayout) as terr:
        EngineCore(tc, tparams, device="cpu")
    assert terr.value.layout == jerr.value.layout == "no_paged_step"
    # the reference's message then points at its ServingEngine, which
    # cannot serve this family either (``test_slot_engine_and_serve_cli``)
    assert str(jerr.value).startswith(str(terr.value))


def test_slot_engine_and_serve_cli_refuse():
    """The slot engine refuses at construction with a
    ``NotImplementedError`` naming the family; the serve CLI exits
    non-zero with that message (after ``EngineCore``'s refusal), never a
    ``KeyError`` mid-run."""
    _, tc, _, tparams = build("float32", False, NAME)
    with pytest.raises(NotImplementedError, match="encdec.*frames"):
        ServingEngine(tc, tparams, slots=1, max_len=16, device="cpu")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", NAME,
         "--device", "cpu", "--requests", "2", "--max-new", "3",
         "--rate", "0"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "no_paged_step" in out.stdout
    assert "encdec" in out.stderr and "KeyError" not in out.stderr


def test_cache_specs_match_reference():
    """``cache_specs``: ``self`` the decoder cache's leaves, ``cross`` the
    cross K/V (dec_layers, B, Hkv, L_src, Dh), as meta tensors of the
    reference's shapes and dtypes; ``input_specs`` carries ``frames``."""
    jspec = j_api.cache_specs(j_get_config(NAME), 3, 16)
    tspec = cache_specs(get_config(NAME), 3, 16)
    assert sorted(tspec) == sorted(jspec) == ["cross", "self"]
    for part in ("self", "cross"):
        assert sorted(tspec[part]) == sorted(jspec[part])
        for k, v in tspec[part].items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == jspec[part][k].shape, (part, k)
            assert str(v.dtype).split(".")[-1] == jspec[part][k].dtype.name
    batch = j_api.input_specs(j_get_config(NAME), "train", 16, 3)["batch"]
    from repro_torch.models import input_specs
    tbatch = input_specs(get_config(NAME), "train", 16, 3)["batch"]
    assert tuple(tbatch["frames"].shape) == batch["frames"].shape == (3, 4, 64)
