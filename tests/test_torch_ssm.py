"""PyTorch port vs JAX reference: the SSM families — the Mamba-1 mixer
(``models/mamba.py``, falcon-mamba-7b) and the Mamba-2 mixer
(``models/mamba2.py``, zamba2-1.2b's), and both smoke models whole.

- ``mamba_apply`` / ``mamba2_apply`` at the smoke widths in f32 on
  lengths that cross the 8-row chunk (5, 8, 13, 17), from a zero state
  and from a random carried one (``conv`` and ``h`` / ``S``): ``y``, the
  last state and ``conv``, then two decode steps from that state.
- ``lm_apply`` logits and ``lm_loss``, and prefill + three decode steps
  (logits and every cache leaf), for ``falcon-mamba-7b-smoke``,
  ``zamba2-1.2b-smoke`` (4 periods of 2, no tail) and a hybrid built
  with ``reduced(zamba2).replace(num_layers=5)`` on both sides: 2
  periods and a tail of 1, which runs without the shared block.
- ``from_flat`` / ``to_flat`` over every leaf (``trunk/tail/{i}`` and
  ``trunk/shared_attn`` included) and ``init_params``' layout; the
  configs' fields; kernel #1's launches per chunk and per decode step
  (``ssm_exp`` called through the wrapper: 1 per chunk for Mamba-1, 4
  for Mamba-2, 1 per decode step).

Weights are the reference's, every norm scale, bias, ``dt_bias``, ``D``
and gated-norm scale perturbed first (the reference draws them as
constants).  Tolerance ``atol=2e-5, rtol=1e-4`` throughout (measured on
the mixers: ≤ 1.9e-6 on ``y``, ≤ 3.6e-7 on the states).  About 36 s
alone, one intra-op thread."""
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
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import mamba2 as j_mamba2  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mamba as t_mamba  # noqa: E402
from repro_torch.models import mamba2 as t_mamba2  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.lm import lm_apply, period_layout  # noqa: E402
from repro_torch.params import (from_flat, init_params,  # noqa: E402
                                param_paths, to_flat)
from tests._torch_twin import perturbed  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-4)
MODELS = [("falcon-mamba-7b-smoke", None), ("zamba2-1.2b-smoke", None),
          ("zamba2-1.2b-smoke", 5)]
MIXERS = {"mamba1": (j_mamba, t_mamba.mamba_apply, "h",
                     "falcon-mamba-7b-smoke"),
          "mamba2": (j_mamba2, t_mamba2.mamba2_apply, "S",
                     "zamba2-1.2b-smoke")}
CONSTANTS = ("['conv_b']", "['dt_bias']", "['D']", "['norm_scale']")


def nudged(params, seed):
    """``perturbed`` plus the mixers' constant leaves (conv bias,
    ``dt_bias``, ``D``, the gated norm's scale), each + 0.1·N(0, 1)."""
    rng = np.random.default_rng(seed + 1)

    def bump(path, leaf):
        if jax.tree_util.keystr(path).endswith(CONSTANTS):
            noise = rng.normal(size=leaf.shape).astype(np.float32) * 0.1
            return leaf + jnp.asarray(noise).astype(leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(bump, perturbed(params, seed))


def configs(name, layers=None, dtype="float32"):
    jc = j_get_config(name).replace(dtype=dtype)
    tc = get_config(name).replace(dtype=dtype)
    if layers is not None:
        jc, tc = jc.replace(num_layers=layers), tc.replace(num_layers=layers)
    return jc, tc


@functools.lru_cache(maxsize=None)
def built(name, layers=None):
    jc, tc = configs(name, layers)
    jparams = nudged(j_build_model(jc).init(jax.random.PRNGKey(0)), 5)
    return jc, tc, jparams, from_flat(flatten_tree(jparams), tc, "cpu")


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        jnp.asarray(t, jnp.float32))


@functools.lru_cache(maxsize=None)
def mixer(variant):
    """A jitted reference mixer and one layer's weights on both sides."""
    jmod, _, _, name = MIXERS[variant]
    jc, tc = configs(name)
    init = j_mamba.mamba_init if variant == "mamba1" else j_mamba2.mamba2_init
    p = nudged(init(jax.random.PRNGKey(1), jc), 3)
    tp = {k: torch.from_numpy(np.array(v["w"] if isinstance(v, dict) else v))
          for k, v in p.items()}
    apply = jmod.mamba_apply if variant == "mamba1" else jmod.mamba2_apply
    return (jc, tc, p, tp, jax.jit(lambda p, x, c: apply(jc, p, x, cache=c)),
            jax.jit(lambda p, x: apply(jc, p, x)[0]))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("length", [5, 8, 13, 17])
@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_mixer_matches_reference(variant, length, carried):
    """One mixer over ``length`` rows (chunk 8: partial, whole, 1 + a
    partial, 2 + a partial chunks), then two decode steps."""
    jc, tc, p, tp, f, plain = mixer(variant)
    _, t_apply, state, _ = MIXERS[variant]
    init = (j_mamba.mamba_cache_init if variant == "mamba1"
            else j_mamba2.mamba2_cache_init)
    rng = np.random.default_rng(length + 100 * carried)
    c0 = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.5
                         * carried)
          for k, v in init(jc, 2).items()}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in c0.items()}
    for step, rows in enumerate((length, 1, 1)):
        x = rng.normal(size=(2, rows, jc.d_model)).astype(np.float32)
        yj, c0 = f(p, jnp.asarray(x), c0)
        yt = t_apply(tc, tp, torch.from_numpy(x), cache=cache)
        np.testing.assert_allclose(_np(yt), _np(yj), **TOL, err_msg=step)
        for k in (state, "conv"):
            np.testing.assert_allclose(_np(cache[k]), _np(c0[k]), **TOL,
                                       err_msg=(step, k))
    # without a cache nothing is carried: the first call alone
    x = rng.normal(size=(2, length, jc.d_model)).astype(np.float32)
    np.testing.assert_allclose(_np(t_apply(tc, tp, torch.from_numpy(x))),
                               _np(plain(p, jnp.asarray(x))), **TOL)


def ref_layer_order(jcaches, per, key):
    """A reference state leaf (periods' slots, then the tail) → layers
    in order, numpy f32."""
    periods = jcaches.get("periods")
    parts = []
    if periods is not None:
        slots = [_np(periods[str(j)][key]) for j in range(per)]
        parts.append(np.stack(slots, 1).reshape((-1,) + slots[0].shape[1:]))
    parts += [_np(t[key])[None] for t in jcaches.get("tail", [])]
    return np.concatenate(parts)


@pytest.mark.parametrize("name,layers", MODELS)
def test_lm_apply_and_loss_match_reference(name, layers):
    jc, tc, jparams, tparams = built(name, layers)
    tokens = np.random.default_rng(11).integers(
        0, jc.vocab_size, (2, 19)).astype(np.int32)
    want, _, _ = jax.jit(lambda p, t: j_lm.lm_apply(jc, p, t))(
        jparams, jnp.asarray(tokens))
    got = lm_apply(tc, tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jloss = j_lm.cross_entropy(want[:, :-1], jnp.asarray(tokens[:, 1:]))
    tloss, parts = build_model(tc).loss(tparams,
                                        {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert float(parts["aux"]) == 0.0


@pytest.mark.parametrize("name,layers", MODELS)
def test_prefill_and_decode_match_reference(name, layers):
    """Prefill 13 rows into a 24-row cache, then three decode steps at
    positions 13, 14, 15: logits, and every state leaf (and the hybrid's
    shared K/V per period) against the reference's caches."""
    jc, tc, jparams, tparams = built(name, layers)
    jm, tm = j_build_model(jc), build_model(tc)
    assert tm.step_ragged is None
    tokens = np.random.default_rng(12).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    jcache = jm.init_cache(2, 24)
    tcache = tm.init_cache(2, 24, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(
        tokens[:, :13])}, jcache)
    tl, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens[:, :13])},
                       tcache)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    decode = jax.jit(jm.decode_step)
    for i in range(13, 16):
        jl, jcache = decode(jparams, jnp.asarray(tokens[:, i]), jcache,
                            jnp.int32(i))
        tl, _ = tm.decode_step(tparams, torch.from_numpy(tokens[:, i]),
                               tcache, i)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL, err_msg=i)
    kinds, nper, tail = period_layout(tc)
    for key in ("conv", "S" if tc.ssm_variant == "mamba2" else "h"):
        np.testing.assert_allclose(_np(tcache[key]),
                                   ref_layer_order(jcache, len(kinds), key),
                                   **TOL, err_msg=key)
    if tc.family == "hybrid":
        assert sorted(tcache) == ["S", "conv", "k", "v"]
        for key in ("k", "v"):
            np.testing.assert_allclose(
                _np(tcache[key]), _np(jcache["periods"]["shared"][key]),
                **TOL, err_msg=key)
        assert tcache["k"].shape[0] == nper and (nper, tail) == (
            (4, 0) if layers is None else (2, 1))


@pytest.mark.parametrize("name,layers", MODELS)
def test_flat_round_trip_and_init_layout(name, layers):
    """Every reference leaf maps onto a port leaf and back; the seeded
    draw has the same keys, shapes and dtypes, and the reference's
    constants (norm scales and ``D`` 1, conv bias 0, ``dt_bias``
    log(expm1(0.01)), ``A_log``)."""
    jc, tc, jparams, tparams = built(name, layers)
    flat = flatten_tree(jparams)
    assert {p for ps in param_paths(tc).values() for p in ps} == set(flat)
    back = to_flat(tparams, tc)
    assert set(back) == set(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(_np(back[path]), _np(leaf), path)
    drawn = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in drawn.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tparams.items()}
    fresh = flatten_tree(j_build_model(jc).init(jax.random.PRNGKey(0)))
    for k in ("conv_b", "dt_bias", "D", "A_log", "norm_scale", "ln"):
        if k in drawn:
            want = _np(fresh[param_paths(tc)[k][0]])[0]     # periods/0, row 0
            np.testing.assert_allclose(_np(drawn[k][0]), want, rtol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-1.2b",
                                  "falcon-mamba-7b-smoke",
                                  "zamba2-1.2b-smoke"])
def test_configs_match_reference(name):
    """Every field the port keeps has the reference's value, and so do
    the derived widths and the period layout."""
    t, j = get_config(name), j_get_config(name)
    for field in t.__dataclass_fields__:
        assert getattr(t, field) == getattr(j, field), field
    assert (t.d_inner, t.dt_rank) == (j.d_inner, j.dt_rank)
    assert period_layout(t) == j_lm.period_layout(j)


@pytest.mark.parametrize("name,per_chunk", [("falcon-mamba-7b-smoke", 1),
                                            ("zamba2-1.2b-smoke", 4)])
def test_exponentials_go_through_kernel_1(monkeypatch, name, per_chunk):
    """Every SSM exponential is kernel #1's wrapper: per layer, one call
    per chunk (Mamba-1's Ā) or four (Mamba-2's decays) in a prefill of 13
    rows (2 chunks of 8), one per decode step; ``exp_mode="exact"`` none."""
    calls = []
    inner = t_mamba.lut_exp

    def spy(x, order=1):
        calls.append(tuple(x.shape))
        return inner(x, order=order)
    monkeypatch.setattr(t_mamba, "lut_exp", spy)
    cfg = get_config(name).replace(dtype="float32")
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    caches = m.init_cache(2, 24, device="cpu")
    m.prefill(params, {"tokens": torch.zeros((2, 13), dtype=torch.int32)},
              caches)
    assert len(calls) == cfg.num_layers * 2 * per_chunk
    calls.clear()
    m.decode_step(params, torch.zeros(2, dtype=torch.int32), caches, 13)
    assert len(calls) == cfg.num_layers
    calls.clear()
    exact = cfg.replace(exp_mode="exact")
    lm_apply(exact, params, torch.zeros((1, 9), dtype=torch.int32))
    assert not calls
