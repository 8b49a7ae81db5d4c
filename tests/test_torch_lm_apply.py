"""PyTorch port vs JAX reference: the cache-free full-sequence forward
(``build_model(cfg).prefill`` / ``.loss`` → ``lm_apply``) on the CPU, for
``bert-base-smoke`` (the encoder: LayerNorm, learned positions, biases,
GELU, tied embeddings, bidirectional attention) and ``deepseek-7b-smoke``
(causal scoring of the dense decoder).

The reference's weights cross over through ``flatten_tree``; its zero
biases and unit LayerNorm scales are first perturbed from a numpy seed, so
every leaf shapes the result.  Each config runs with ``attn_backend``
``pallas`` (the reference's Pallas kernel in interpret mode; the port's
kernel wrapper, which takes its plain version on a CPU tensor) and
``jnp`` (the online-softmax scan on both sides).

Tolerances.  f32: logits at ``atol=rtol=1e-4`` — measured gaps are below
3e-6 — with both sides summing the same f32 products in other orders.
bf16: the reference's own bf16-vs-f32 gap on the same batch bounds the
port-vs-reference gap, as in ``test_torch_model_step.py``: both frameworks
round to bf16 after every projection, norm and activation, at different
places (XLA keeps excess f32 precision inside its fusions)."""
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.params import from_flat, init_params, param_paths  # noqa: E402


B, L = 2, 24
TOL = dict(atol=1e-4, rtol=1e-4)


def perturbed(params, seed):
    """Biases and norm scales nudged by 0.1·N(0, 1) from a numpy seed."""
    rng = np.random.default_rng(seed)

    def bump(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['b']", "['bias']", "['scale']")):
            noise = rng.normal(size=leaf.shape).astype(np.float32) * 0.1
            return leaf + jnp.asarray(noise).astype(leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(bump, params)


def batch_np(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, L)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, L)).astype(np.int32),
            "loss_mask": (rng.random((B, L)) < 0.3).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def run(name, backend, dtype):
    """Reference and port results on one batch: {output: (jax, port)}.
    ``prefill`` logits for BERT (plus its masked-LM loss), the
    next-token and the labelled loss for the dense decoder."""
    jc = j_get_config(name).replace(attn_backend=backend, dtype="float32")
    tc = get_config(name).replace(attn_backend=backend, dtype=dtype)
    jparams = perturbed(j_build_model(jc).init(jax.random.PRNGKey(0)), 5)
    if dtype != "float32":
        jc = jc.replace(dtype=dtype)
        jparams = jax.tree.map(lambda a: a.astype(dtype), jparams)
    tparams = from_flat(flatten_tree(jparams), tc, "cpu")
    jm, tm = j_build_model(jc), build_model(tc)
    nb = batch_np(jc.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    out = {}
    if jc.family == "bert":
        jl = jax.jit(jm.prefill)(jparams, jb)[0]
        out["logits"] = (np.asarray(jl), tm.prefill(tparams, tb)[0].numpy())
        out["loss"] = (float(jax.jit(jm.loss)(jparams, jb)[0]),
                       float(tm.loss(tparams, tb)[0]))
    else:
        unlabelled = {"tokens": jb["tokens"]}
        out["loss"] = (float(jax.jit(jm.loss)(jparams, unlabelled)[0]),
                       float(tm.loss(tparams, {"tokens": tb["tokens"]})[0]))
        out["labelled loss"] = (float(jax.jit(jm.loss)(jparams, jb)[0]),
                                float(tm.loss(tparams, tb)[0]))
    return out


CASES = [(n, b) for n in ("bert-base-smoke", "deepseek-7b-smoke")
         for b in ("pallas", "jnp")]


@pytest.mark.parametrize("name,backend", CASES)
def test_forward_float32_matches_jax(name, backend):
    for what, (j, t) in run(name, backend, "float32").items():
        np.testing.assert_allclose(t, j, err_msg=what, **TOL)


@pytest.mark.parametrize("name,backend", CASES)
def test_forward_bfloat16_within_reference_gap(name, backend):
    f32, bf16 = run(name, backend, "float32"), run(name, backend, "bfloat16")
    for what in bf16:
        (jb, tb), (jf, _) = bf16[what], f32[what]
        port, own = np.abs(np.asarray(tb) - jb).max(), np.abs(jb - jf).max()
        assert port <= own, (what, port, own)


def test_bert_logits_shape_and_loss_value():
    """Encoder logits cover every position over the tied vocab; the masked
    loss is a finite cross-entropy near log(vocab) for random weights."""
    out = run("bert-base-smoke", "pallas", "float32")
    logits = out["logits"][1]
    assert logits.shape == (B, L, 512) and np.isfinite(logits).all()
    assert 0.5 * np.log(512) < out["loss"][1] < 2.0 * np.log(512)


def test_from_flat_accounts_for_every_bert_leaf():
    jc = j_get_config("bert-base-smoke")
    flat = flatten_tree(j_build_model(jc).init(jax.random.PRNGKey(0)))
    tc = get_config("bert-base-smoke")
    assert set(param_paths(tc).values()) == set(flat)
    assert {"embed/positions", "final_norm/bias",
            "trunk/periods/0/attn/wq/b", "trunk/periods/0/mlp/up/b",
            "trunk/periods/0/ln1/bias"} <= set(flat)
    assert "lm_head/w" not in flat                 # tied embeddings
    with pytest.raises(ValueError, match="does not model"):
        from_flat({**flat, "extra/w": np.zeros(1)}, tc, "cpu")
    with pytest.raises(KeyError, match="lack"):
        from_flat({k: v for k, v in flat.items()
                   if k != "embed/positions"}, tc, "cpu")


@pytest.mark.parametrize("name", ["bert-base-smoke", "deepseek-7b-smoke"])
def test_init_params_has_the_reference_layout(name):
    """Seeded weights carry every leaf at the reference's shape and dtype;
    biases start at 0 and LayerNorm scales at 1, as in ``lm_init``."""
    flat = flatten_tree(j_build_model(j_get_config(name)).init(
        jax.random.PRNGKey(0)))
    want = from_flat(flat, get_config(name), "cpu")
    got = init_params(get_config(name), torch.Generator().manual_seed(0),
                      "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    for k, v in got.items():
        if k.endswith("_b"):
            assert not v.any(), k


@pytest.mark.parametrize("name", ["bert-base", "bert-large", "deepseek-7b",
                                  "bert-large-smoke", "deepseek-7b-smoke"])
def test_configs_match_reference(name):
    """Every field the port keeps has the reference's value."""
    t, j = get_config(name), j_get_config(name)
    for field in t.__dataclass_fields__:
        assert getattr(t, field) == getattr(j, field), field


def test_dense_cached_entry_points_raise():
    m = build_model(get_config("deepseek-7b-smoke"))
    for entry in (m.prefill, m.decode_step):
        with pytest.raises(NotImplementedError, match="slice"):
            entry(None, None, None)
    with pytest.raises(KeyError, match="unknown attention backend"):
        build_model(get_config("bert-base-smoke").replace(
            attn_backend="flash3"))
