"""PyTorch port vs JAX reference: AdamW, clipping, the cosine schedule and
gradient accumulation on the CPU.

Same inputs (numpy, from a seed) through both packages' functions.  The
reference runs under ``jax.jit``, where XLA contracts ``a·x + b·y`` into
FMAs and computes ``pow``, ``cos`` and ``sqrt`` with its own roundings
(ROADMAP §3-B), while the port rounds once per operation.  Each leaf
agrees within 2 ulps of its largest element (f32 leaves in f32 ulps; bf16
leaves within 1 bf16 ulp, since a 2-ulp f32 difference can cross one bf16
rounding): an ulp of an input moves a result by an ulp of its largest
term, which cancellation (``b1·m + (1 − b1)·g`` of opposite signs) can
make many ulps of a small result.
One intra-op thread; ~11 s alone."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import optim as J  # noqa: E402
from repro_torch import optim as T  # noqa: E402

SHAPES = {"embed": (33, 8), "wq": (3, 8, 8), "final_norm": (8,)}


def ulps(got: torch.Tensor, want) -> float:
    """max |got − want| in ulps of the largest |want| of the leaf, in
    want's dtype (f32, or bf16: 8 bits)."""
    want = np.asarray(want).astype(np.float32)
    big = np.float32(max(np.abs(want).max(), 1e-30))
    spacing = (big * 2.0 ** -7 if got.dtype == torch.bfloat16
               else np.spacing(big))
    return float(np.max(np.abs(got.float().numpy() - want)) / spacing)


def tree(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32).astype(dtype)
            for k, s in SHAPES.items()}


def to_jax(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def to_torch(t):
    out = {}
    for k, v in t.items():
        if v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


@pytest.mark.parametrize("param_dtype,moment_dtype", [
    (np.float32, "float32"), (ml_dtypes.bfloat16, "float32"),
    (ml_dtypes.bfloat16, "bfloat16")])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_three_steps_match_reference(param_dtype, moment_dtype, clip):
    """Three steps of ``adamw_update`` from ``adamw_init`` with a cosine
    learning rate: params, moments, step and the reported grad norm; the
    clip at 1.0 binds (gradient norms ~10)."""
    cfg_kw = dict(lr=1e-2, grad_clip=clip, moment_dtype=moment_dtype)
    jp, tp = to_jax(tree(0, param_dtype)), to_torch(tree(0, param_dtype))
    js = J.adamw_init(jp, J.AdamWConfig(**cfg_kw))
    ts = T.adamw_init(tp, T.AdamWConfig(**cfg_kw))
    jsched, tsched = J.cosine_schedule(1e-2, 1, 5), T.cosine_schedule(1e-2, 1,
                                                                      5)
    j_upd = jax.jit(lambda g, s, p, lr: J.adamw_update(
        g, s, p, J.AdamWConfig(**cfg_kw), lr=lr))
    for step in range(3):
        g = tree(10 + step, param_dtype)
        jlr = jsched(jnp.asarray(step + 1, jnp.int32))
        tlr = tsched(torch.tensor(step + 1, dtype=torch.int32))
        assert ulps(tlr, jlr) <= 2
        jp, js, jm = j_upd(to_jax(g), js, jp, jlr)
        tp, ts, tm = T.adamw_update(to_torch(g), ts, tp,
                                    T.AdamWConfig(**cfg_kw), lr=tlr)
        assert ulps(tm["grad_norm"], jm["grad_norm"]) <= 2
        assert int(ts.step) == int(js.step) == step + 1
        for k in SHAPES:
            assert tp[k].dtype == (torch.float32 if param_dtype == np.float32
                                   else torch.bfloat16)
            for name, got, want in (("p", tp[k], jp[k]), ("m", ts.m[k], js.m[k]),
                                    ("v", ts.v[k], js.v[k])):
                bound = 1 if got.dtype == torch.bfloat16 else 2
                assert ulps(got, want) <= bound, (step, k, name)


def test_streamed_update_is_the_whole_leaf_update():
    """``scan_subtree``: the stacked leaves updated one slice at a time
    equal the whole-leaf update bit for bit."""
    p, g = to_torch(tree(1)), to_torch(tree(2))
    cfg = T.AdamWConfig(lr=1e-2)
    s = T.adamw_init(p, cfg)
    a = T.adamw_update(g, s, p, cfg, lr=1e-3)
    b = T.adamw_update(g, s, p, cfg, lr=1e-3, scan_subtree=("wq", "absent"))
    for x, y in zip((a[0], a[1].m, a[1].v), (b[0], b[1].m, b[1].v)):
        assert all(torch.equal(x[k], y[k]) for k in SHAPES)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_and_global_norm_match_reference(max_norm):
    g = tree(3, scale=0.1)
    jc, jn = jax.jit(lambda t: J.clip_by_global_norm(t, max_norm))(to_jax(g))
    tc, tn = T.clip_by_global_norm(to_torch(g), max_norm)
    assert ulps(tn, jn) <= 2
    assert ulps(T.global_norm(to_torch(g)), J.global_norm(to_jax(g))) <= 2
    for k in SHAPES:
        assert ulps(tc[k], jc[k]) <= 2


def test_cosine_schedule_matches_reference():
    j = jax.jit(J.cosine_schedule(3e-4, 10, 100))
    t = T.cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        assert ulps(t(torch.tensor(step, dtype=torch.int32)),
                    j(jnp.asarray(step, jnp.int32))) <= 2, step


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_accumulated_grads_match_reference(microbatches):
    """A least-squares loss over a batch of 8: the mean loss and gradients
    over ``microbatches`` parts (aux: the last part's)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)
    w0 = {"w": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}

    def j_loss(p, b):
        r = b["x"] @ p["w"] + p["b"] - b["y"]
        return jnp.mean(r * r), {"n": jnp.sum(b["x"][:, 0] ** 2)}

    def t_loss(p, b):
        r = b["x"] @ p["w"] + p["b"] - b["y"]
        return torch.mean(r * r), {"n": torch.sum(b["x"][:, 0] ** 2)}

    jl, jg, jaux = jax.jit(lambda p, b: J.accumulated_grads(
        j_loss, p, b, microbatches))(to_jax(w0), {"x": x, "y": y})
    tl, tg, taux = T.accumulated_grads(
        t_loss, to_torch(w0), {"x": torch.from_numpy(x),
                               "y": torch.from_numpy(y)}, microbatches)
    assert ulps(tl, jl) <= 2
    assert ulps(taux["n"], jaux["n"]) <= 2
    for k in w0:
        assert tg[k].dtype == torch.float32
        assert ulps(tg[k], jg[k]) <= 2, k


def test_trainer_streams_large_per_layer_leaves_with_the_same_bits(
        monkeypatch):
    """The Trainer updates a per-layer leaf over ``STREAM_LEAF_BYTES`` in
    f32 one layer slice at a time (granite-moe's expert stacks on the
    card): with the threshold at 0 every per-layer leaf of
    deepseek-7b-smoke streams, and two steps leave the same bits as the
    whole-leaf update."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models.lm import layer_keys
    from repro_torch.runtime import TrainConfig, Trainer
    from repro_torch.runtime import trainer as trainer_mod
    cfg = get_config("deepseek-7b-smoke").replace(dtype="float32")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    seen = []
    update = trainer_mod.adamw_update

    def spy(*a, scan_subtree=None, **k):
        seen.append(sorted(scan_subtree or ()))
        return update(*a, scan_subtree=scan_subtree, **k)
    monkeypatch.setattr(trainer_mod, "adamw_update", spy)
    runs = []
    for limit in (trainer_mod.STREAM_LEAF_BYTES, 0):
        monkeypatch.setattr(trainer_mod, "STREAM_LEAF_BYTES", limit)
        tr = Trainer(cfg, dcfg, TrainConfig(steps=2, lr=5e-3, warmup=1),
                     device="cpu")
        tr.run()
        runs.append(tr)
    keys = sorted(layer_keys(cfg))
    assert seen == [[], [], keys, keys]
    for k, p in runs[0].params.items():
        assert torch.equal(p, runs[1].params[k]), k
        assert torch.equal(runs[0].opt_state.v[k], runs[1].opt_state.v[k]), k
