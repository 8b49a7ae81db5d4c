"""PyTorch port vs JAX reference: the MoE layer (``models/moe.py``) and the
MoE decoders ``granite-moe-3b-a800m-smoke`` (8 SiLU-gated experts, top-2)
and ``grok-1-314b-smoke`` (8 GELU-gated experts, top-2, softcap 30).

- ``moe_capacity`` and ``_group_size`` equal the reference's over
  T = 1…1100 (primes included: a prime over 512 collapses to groups of 1).
- The port's routing (``topk_route``), rebuilt as one-hot tensors, equals
  the reference's ``_topk_dispatch`` ``dispatch`` / ``combine`` bit for
  bit on f32 probabilities with planted ties, all-zero tails and capacity
  overflow.
- ``moe_apply`` in f32 at capacity factors 0.5 / 1.25 / 8 (the sweep of
  ``tests/test_models.py``): ``y`` within atol 1e-5, rtol 1e-4 and ``aux``
  within 1e-6 relative; in bf16 within the reference's own bf16-vs-f32
  gap on the same input.
- ``lm_apply`` / ``lm_loss`` (``ce``, ``aux``, the total) in f32, and one
  f32 ragged step whose 32-row bucket holds 20 dead rows: they all route
  to one expert and overflow it, so the live tokens' later choices of
  that expert drop.  The same step cut to its live rows gives other
  logits: a port that did not route the dead rows fails the twin.
- ``from_flat`` / ``to_flat`` over the ``moe/*`` leaves, the seeded draw's
  shapes and dtypes (an f32 router), and the router's exponential through
  kernel #1's wrapper, once per layer.

About 25 s alone, one intra-op thread."""
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
from repro.models import lm as j_lm  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.autotune import (  # noqa: E402
    KernelConfig as TKernelConfig)
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.lm import (lm_apply, lm_step_ragged,  # noqa: E402
                                   trunk_cache_init)
from repro_torch.params import init_params, param_paths, to_flat  # noqa: E402
from tests._torch_twin import build  # noqa: E402
from tests.test_torch_families import from_periods, to_periods  # noqa: E402
from tests.test_torch_model_step import (KERNEL_CONFIG, NUM_PAGES,  # noqa: E402
                                         history_pool)

MOE = ["granite-moe-3b-a800m-smoke", "grok-1-314b-smoke"]
Y_TOL = dict(atol=1e-5, rtol=1e-4)
TOL = dict(atol=1e-4, rtol=1e-4)        # logits: test_torch_families.py's
B, L = 2, 24


def _primes(n):
    return [p for p in range(2, n) if all(p % q for q in range(2, int(p ** 0.5) + 1))]


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "grok-1-314b",
                                  "granite-moe-3b-a800m-smoke"])
def test_capacity_and_group_size_equal_reference(name):
    for cf in (0.5, 1.25, 8.0):
        jc = j_get_config(name).replace(moe_capacity_factor=cf)
        tc = get_config(name).replace(moe_capacity_factor=cf)
        for t in range(1, 1101):
            assert t_moe.moe_capacity(tc, t) == j_moe.moe_capacity(jc, t), t
            assert t_moe._group_size(tc, t) == j_moe._group_size(jc, t), t
    big = [p for p in _primes(1101) if p > 512]
    assert big and all(t_moe._group_size(tc, p) == 1 for p in big)


def one_hot_dispatch(route, capacity, num_experts):
    """The reference's (G, t, E, C) f32 ``dispatch`` and ``combine`` (the
    gates before renormalisation) rebuilt from a port ``Route``."""
    g, k, t = route.expert.shape
    dispatch = torch.zeros((g, t, num_experts, capacity), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    for gi, r, ti in zip(*torch.nonzero(route.keep, as_tuple=True)):
        at = (gi, ti, route.expert[gi, r, ti], route.slot[gi, r, ti])
        dispatch[at] = 1.0
        combine[at] = route.gate[gi, r, ti]
    return dispatch, combine


def _planted_probs(t, e, seed):
    """Softmax rows with planted exact ties: at the top (rows 0 mod 5), at
    the second place (rows 1 mod 5), one-hot rows whose later rounds pick
    among zeros (rows 2 mod 7), and all-equal rows (rows 3 mod 11)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(t, e)).astype(np.float32) * 2
    p = np.exp(z - z.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    for i in range(t):
        order = np.argsort(-p[i])
        if i % 5 == 0:
            p[i, order[1]] = p[i, order[0]]
        elif i % 5 == 1:
            p[i, order[2]] = p[i, order[1]]
        if i % 7 == 2:
            p[i] = 0.0
            p[i, i % e] = 1.0
        if i % 11 == 3:
            p[i] = np.float32(1.0 / e)
    return p


@pytest.mark.parametrize("name,t,cf", [
    ("granite-moe-3b-a800m-smoke", 64, 0.5),     # 8 experts, top-2, overflow
    ("granite-moe-3b-a800m-smoke", 64, 1.25),
    ("granite-moe-3b-a800m", 48, 0.5),           # 40 experts, top-8
    ("grok-1-314b", 40, 1.25)])
def test_dispatch_indices_equal_reference_one_hots(name, t, cf):
    jc = j_get_config(name).replace(moe_capacity_factor=cf)
    tc = get_config(name).replace(moe_capacity_factor=cf)
    probs = _planted_probs(t, tc.num_experts, seed=t)
    cap = t_moe.moe_capacity(tc, t)
    jd, jcomb = jax.jit(lambda p: j_moe._topk_dispatch(jc, p, cap))(
        jnp.asarray(probs))
    route = t_moe.topk_route(tc, torch.from_numpy(probs)[None], cap)
    td, tcomb = one_hot_dispatch(route, cap, tc.num_experts)
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tcomb[0].numpy(), np.asarray(jcomb))
    if cf == 0.5:
        assert not bool(route.keep.all()), "no capacity overflow"


def _layer0_moe(jparams, tparams):
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["trunk"]["periods"]["0"]["moe"])
    tp = {k: tparams[k][0] for k in ("router", "up", "gate", "down")}
    return jp, tp


@functools.lru_cache(maxsize=None)
def run_moe(name, dtype, cf):
    """(reference y f32, port y f32, reference aux, port aux) of layer 0's
    experts on one seeded (B, L, D) input."""
    jc, tc, jparams, tparams = build(dtype, False, name)
    jc, tc = (c.replace(moe_capacity_factor=cf) for c in (jc, tc))
    jp, tp = _layer0_moe(jparams, tparams)
    x = np.random.default_rng(0).normal(size=(B, L, tc.d_model)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    yj, aj = jax.jit(lambda p, x: j_moe.moe_apply(jc, p, x))(jp, xj)
    yt, at = t_moe.moe_apply(tc, tp, torch.from_numpy(x).to(
        getattr(torch, dtype)))
    assert yt.dtype == getattr(torch, dtype) and yt.shape == (B, L, tc.d_model)
    return (np.asarray(yj.astype(jnp.float32)), yt.float().numpy(),
            float(aj), float(at))


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_float32_matches_reference(name, cf):
    yj, yt, aj, at = run_moe(name, "float32", cf)
    np.testing.assert_allclose(yt, yj, **Y_TOL)
    assert abs(at - aj) <= 1e-6 * abs(aj)


@pytest.mark.parametrize("name", MOE)
def test_moe_apply_bfloat16_within_reference_gap(name):
    jf, _, af, _ = run_moe(name, "float32", 1.25)
    jb, tb, ab, at = run_moe(name, "bfloat16", 1.25)
    assert np.abs(tb - jb).max() <= np.abs(jb - jf).max()
    assert abs(at - ab) <= abs(ab - af)


@functools.lru_cache(maxsize=None)
def run_forward(name):
    """f32 (logits, aux) and the loss of the cache-free forward, reference
    and port, the ``jnp`` backend on both sides."""
    jc, tc, jparams, tparams = build("float32", False, name, perturb=5)
    jc, tc = (c.replace(attn_backend="jnp") for c in (jc, tc))
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (B, L))
    tokens = tokens.astype(np.int32)
    jl, _, ja = jax.jit(lambda p, t: j_lm.lm_apply(jc, p, t))(
        jparams, jnp.asarray(tokens))
    jloss, jm = jax.jit(lambda p, t: j_lm.lm_loss(jc, p, {"tokens": t}))(
        jparams, jnp.asarray(tokens))
    tt = torch.from_numpy(tokens)
    tl, ta = lm_apply(tc, tparams, tt, with_aux=True)
    tloss, tm = build_model(tc).loss(tparams, {"tokens": tt})
    return ((np.asarray(jl), float(ja), float(jloss), float(jm["ce"]),
             float(jm["aux"])),
            (tl.numpy(), float(ta), float(tloss), float(tm["ce"]),
             float(tm["aux"])))


@pytest.mark.parametrize("name", MOE)
def test_lm_apply_and_loss_float32_match_reference(name):
    (jl, ja, jloss, jce, jaux), (tl, ta, tloss, tce, taux) = run_forward(name)
    assert tl.shape == (B, L, 512) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, **TOL)
    assert ja > 0 and abs(ta - ja) <= 1e-6 * ja
    assert abs(taux - jaux) <= 1e-6 * jaux
    np.testing.assert_allclose([tloss, tce], [jloss, jce], rtol=1e-5)
    assert tloss == pytest.approx(tce + 0.01 * taux, rel=1e-6)


WIDTH = 32                       # the stream's bucket: 12 live rows, 20 dead


def dead_row_inputs(vocab, width=WIDTH):
    """Lane 0 decodes at position 13, lane 1 streams a fresh 5-token chunk,
    lane 2 a 6-token chunk at 9..14; ``width - 12`` dead rows (token 0 at
    position 0 through the scratch page)."""
    lanes = [(1, 13, [3, 7]), (5, 0, [5]), (6, 9, [1, 10])]
    rng = np.random.default_rng(1)
    tokens = np.zeros(width, np.int32)
    pos = np.zeros(width, np.int32)
    table = np.full((width, 4), NUM_PAGES, np.int32)
    cu = [0]
    for n, start, pages in lanes:
        t0 = cu[-1]
        tokens[t0:t0 + n] = rng.integers(0, vocab, n)
        pos[t0:t0 + n] = start + np.arange(n)
        table[t0:t0 + n, :len(pages)] = pages
        cu.append(t0 + n)
    last_idx = np.asarray(cu[1:], np.int32) - 1
    cu = np.asarray(cu + [width] if cu[-1] < width else cu, np.int32)
    return tokens, pos, table, last_idx, cu


def port_step(tc, tparams, pool, inputs):
    tpool = trunk_cache_init(tc, NUM_PAGES + 1, 8, "cpu")
    for k, v in pool.items():
        tpool[k].copy_(torch.from_numpy(v).to(tpool[k].dtype))
    tokens, pos, table, last_idx, cu = map(torch.from_numpy, inputs)
    logits = lm_step_ragged(tc, tparams, tokens, tpool, table, pos, last_idx,
                            cu, TKernelConfig(**KERNEL_CONFIG))
    return logits.numpy(), tpool


def test_ragged_step_routes_dead_rows_like_reference(monkeypatch):
    name = "granite-moe-3b-a800m-smoke"
    jc, tc, jparams, tparams = build("float32", False, name, perturb=5)
    pool = history_pool(jc, seed=2)
    inputs = dead_row_inputs(jc.vocab_size)
    tokens, pos, table, last_idx, cu = inputs
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    jlogits, jcaches = jax.jit(lambda p, c, *a: j_lm.lm_step_ragged(
        jc, p, a[0], c, a[1], a[2], a[3], cu_seqlens=a[4],
        kernel_config=KernelConfig(**KERNEL_CONFIG)))(
        jparams, to_periods(jpool, 1),
        *map(jnp.asarray, (tokens, table, pos, last_idx, cu)))
    routes = []
    real = t_moe.topk_route
    monkeypatch.setattr(t_moe, "topk_route",
                        lambda *a: routes.append(real(*a)) or routes[-1])
    tlogits, tpool = port_step(tc, tparams, pool, inputs)
    np.testing.assert_allclose(tlogits, np.asarray(jlogits), **TOL)
    jleaves = from_periods(jcaches, 1)
    for k in jleaves:
        np.testing.assert_allclose(tpool[k][:, :NUM_PAGES].numpy(),
                                   jleaves[k][:, :NUM_PAGES], err_msg=k, **TOL)

    # layer 0: the 20 identical dead rows take one first expert past its
    # capacity, and live choices of that expert are dropped
    route, cap = routes[0], t_moe.moe_capacity(tc, WIDTH)
    dead = route.expert[0, 0, 12:]
    assert bool((dead == dead[0]).all()) and WIDTH - 12 > cap
    assert not bool(route.keep[0, 0, 12:].all())
    assert not bool(route.keep[0, :, :12].all()), "no live choice dropped"

    # the stream cut to its live rows routes otherwise: other logits
    cut = tuple(a[:12] for a in inputs[:3]) + (inputs[3], inputs[4][:-1])
    alone, _ = port_step(tc, tparams, pool, cut)
    assert np.abs(alone - np.asarray(jlogits)).max() > 1e-2


@pytest.mark.parametrize("name", MOE)
def test_params_round_trip_over_moe_leaves(name):
    jc, tc, jparams, tparams = build("bfloat16", False, name)
    flat = flatten_tree(jparams)
    moe_paths = sorted(p for p in flat if "/moe/" in p)
    assert moe_paths == sorted(
        f"trunk/periods/0/moe/{k}" for k in ("router/w", "up", "gate", "down"))
    back = to_flat(tparams, tc)
    assert sorted(back) == sorted(flat)
    for p, v in flat.items():
        want = np.asarray(v.astype(jnp.float32))
        np.testing.assert_array_equal(back[p].float().numpy(), want, err_msg=p)
    paths = param_paths(tc)
    assert paths["router"] == ("trunk/periods/0/moe/router/w",)
    e, d, f = tc.num_experts, tc.d_model, tc.d_ff
    assert tparams["router"].dtype == torch.float32
    assert tuple(tparams["router"].shape) == (tc.num_layers, d, e)
    assert tuple(tparams["up"].shape) == (tc.num_layers, e, d, f)
    assert tuple(tparams["down"].shape) == (tc.num_layers, e, f, d)
    drawn = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in drawn.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tparams.items()}
    assert 0.8 < float(drawn["up"].float().std() * d ** 0.5) < 1.2
    assert 0.8 < float(drawn["router"].std() * d ** 0.5) < 1.2


def test_router_exponential_is_kernel_one_once_per_layer(monkeypatch):
    """The router's softmax exponential goes through kernel #1's wrapper
    (``kernels/lut_exp/ops.lut_exp``) — its plain version on a CPU tensor
    — once per layer, at the LUT's order; ``exact`` uses ``torch.exp``."""
    calls = []
    real = t_moe.lut_exp

    def spy(x, *, order=1):
        calls.append((tuple(x.shape), x.dtype, order))
        return real(x, order=order)
    monkeypatch.setattr(t_moe, "lut_exp", spy)
    cfg = get_config("granite-moe-3b-a800m-smoke").replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((B, L), dtype=torch.int32)
    lm_apply(cfg.replace(attn_backend="jnp"), params, tokens)
    assert calls == [((1, B * L, cfg.num_experts), torch.float32, 1)] * 2
    calls.clear()
    lm_apply(cfg.replace(attn_backend="jnp", exp_mode="lut0"), params, tokens)
    assert [c[2] for c in calls] == [0, 0]
    calls.clear()
    lm_apply(cfg.replace(attn_backend="jnp", exp_mode="exact"), params, tokens)
    assert calls == []
