"""PyTorch port vs JAX reference: contiguous streaming attention on the CPU
(the plain version of the CUDA kernel, the online-softmax scan, the
attention registry).  The CUDA kernel against its plain version on the
card is in ``test_torch_kernels_cuda.py``.

Inputs come from a numpy seed and go to both packages.  Float tolerance is
the reference kernel suite's own (``tests/test_kernels.py``): ``atol=3e-5,
rtol=1e-4`` in f32 — both sides compute the same f32 logits and LUT
softmax, in another summation order — and ``atol=3e-2`` for bf16 inputs
against the f32 oracle."""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import attention_api as j_api  # noqa: E402
from repro.core.streaming_attention import streaming_attention as j_scan  # noqa: E402
from repro.kernels import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels import streaming_attention as j_kernel  # noqa: E402
from repro_torch.core import attention_api as t_api  # noqa: E402
# ``repro_torch.core`` re-exports the function under the module's name
from repro_torch.core.streaming_attention import (  # noqa: E402
    streaming_attention as t_scan)
from repro_torch.kernels.streaming_attention import (  # noqa: E402
    attention_ref, streaming_attention)
from tests.test_kernels import ATTN_CASES  # noqa: E402


TOL = dict(atol=3e-5, rtol=1e-4)


def inputs(case, seed=0, dtype=np.float32):
    """numpy q, k, v of an ``ATTN_CASES`` entry and its remaining kwargs."""
    c = dict(case)
    rng = np.random.default_rng(seed)
    b = c.pop("b")
    q = rng.normal(size=(b, c.pop("hq"), c.pop("lq"), c["d"]))
    k = rng.normal(size=(b, c.pop("hkv"), c.pop("lkv"), c.pop("d")))
    v = rng.normal(size=k.shape)
    c.setdefault("exp_mode", "lut")
    return [a.astype(dtype) for a in (q, k, v)], c


def jitted(fn, *args, **kw):
    """A reference function under ``jax.jit`` with its keywords static: one
    compile per call instead of one per eager op (several times faster).

    Not for a soft-capped bidirectional call: under jit on the CPU, jax
    0.9.0 computes the reference's soft-capped non-causal naive attention
    0.4 away from its own eager run (which agrees with the reference's
    Pallas kernel, ``tests/test_kernels.py``), so that call runs eagerly."""
    if kw.get("cap") is not None and not kw.get("causal"):
        return fn(*args, **kw)
    return jax.jit(functools.partial(fn, **kw))(*args)


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_version_matches_jax_attention_ref(case):
    """The kernel's plain version (and the wrapper on a CPU tensor, which
    is it) against the reference's ``attention_ref``."""
    arrays, kw = inputs(case)
    (jq, jk, jv), (tq, tk, tv) = both(arrays)
    want = np.asarray(jitted(j_attention_ref, jq, jk, jv, **kw))
    got = attention_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(streaming_attention(tq, tk, tv, **kw), got)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_scan_matches_jax_scan(case):
    """The online-softmax scan at the reference's 16-row blocks against the
    reference's jnp scan, and against the materialised oracle."""
    arrays, kw = inputs(case, seed=1)
    (jq, jk, jv), (tq, tk, tv) = both(arrays)
    want = np.asarray(jitted(j_scan, jq, jk, jv, block_k=16, **kw))
    got = t_scan(tq, tk, tv, block_k=16, **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jitted(j_attention_ref, jq, jk, jv, **kw)), **TOL)


@pytest.mark.parametrize("case", [ATTN_CASES[1], ATTN_CASES[6]])
def test_plain_version_matches_pallas_interpret(case):
    """Against the reference's Pallas kernel itself, in interpret mode (GQA
    4:1; and a ragged 8-row tail with q_offset, kv_len and GQA 2:1)."""
    arrays, kw = inputs(case, seed=2)
    (jq, jk, jv), (tq, tk, tv) = both(arrays)
    want = np.asarray(j_kernel(jq, jk, jv, block_q=16, block_k=16,
                               interpret=True, **kw))
    np.testing.assert_allclose(attention_ref(tq, tk, tv, **kw).numpy(), want,
                               **TOL)


def test_bf16_matches_jax():
    """The reference's bf16 kernel case: bf16 q/k/v, causal, GQA 2:1; the
    port's output is bf16 and within 3e-2 of the f32 oracle, as the
    reference kernel's is, and the scan agrees with the reference scan."""
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((1, 4, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16))]
    (jq, jk, jv), (tq, tk, tv) = both(arrays)
    oracle = np.asarray(jitted(j_attention_ref, jq, jk, jv, causal=True))
    tb = [t.bfloat16() for t in (tq, tk, tv)]
    got = streaming_attention(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=3e-2)
    jb = [a.astype(jnp.bfloat16) for a in (jq, jk, jv)]
    want = jitted(j_scan, *jb, causal=True, block_k=16)
    got = t_scan(*tb, causal=True, block_k=16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2)


def test_plain_version_differentiates_on_cpu():
    """On the CPU the wrapper is ordinary torch: gradients flow."""
    arrays, kw = inputs(ATTN_CASES[0])
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    streaming_attention(q, k, v, **kw).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


# ------------------------------------------------------------- registry --

def test_builtin_backends_are_the_references_names():
    assert set(t_api.list_backends()) == {"naive", "naive_decode", "jnp",
                                          "pallas", "paged", "paged_varlen",
                                          "ring"}
    assert set(t_api.list_backends()) == set(j_api.list_backends())
    assert t_api._AUTO_ORDER == j_api._AUTO_ORDER


@pytest.mark.parametrize("attn_backend,attn_impl", [
    ("auto", "streaming"), ("auto", "naive"), ("auto", "pallas"),
    ("jnp", "naive"), ("pallas", "streaming")])
def test_backend_for_config_matches_reference(attn_backend, attn_impl):
    assert (t_api.backend_for_config(attn_backend, attn_impl)
            == j_api.backend_for_config(attn_backend, attn_impl))


FACTS = [dict(), dict(lq=1), dict(platform="tpu"), dict(platform="tpu", lq=1),
         dict(platform="tpu", static_lengths=False),
         dict(platform="tpu", has_kv_pos=True),
         dict(static_lengths=False), dict(has_kv_pos=True)]


@pytest.mark.parametrize("backend", ["auto", "pallas", "jnp", "naive"])
@pytest.mark.parametrize("facts", FACTS)
def test_resolution_matches_reference(backend, facts):
    """Auto and explicit (with fallback) resolution name the same backend
    as the reference's, the port reading ``cuda`` where it reads ``tpu``;
    an explicit choice that does not support the call raises in both."""
    base = dict(lq=16, lkv=16, platform="cpu", static_lengths=True,
                has_kv_pos=False)
    base.update(facts)
    j_call = j_api.AttentionCall(**base, inside_shard_map=False)
    t_call = t_api.AttentionCall(**dict(base, platform={
        "tpu": "cuda"}.get(base["platform"], base["platform"])))
    assert (t_api.resolve_backend(backend, t_call, fallback=True).name
            == j_api.resolve_backend(backend, j_call, fallback=True).name)
    j_ok = j_api.get_backend(backend).supports(j_call) if backend != "auto" \
        else True
    if not j_ok:
        with pytest.raises(ValueError, match="does not support"):
            t_api.resolve_backend(backend, t_call)


def test_describe_call_static_vs_tensor_lengths():
    q = torch.zeros((1, 2, 4, 8))
    assert t_api.describe_call(q, q, q_offset=0, kv_len=8).static_lengths
    assert t_api.describe_call(q, q).platform == "cpu"
    assert not t_api.describe_call(q, q,
                                   q_offset=torch.tensor(3)).static_lengths


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=9),
                                dict(causal=True, cap=20.0)])
def test_backends_match_reference_naive(kw):
    """Every port backend against the reference's naive backend
    (``tests/test_attention_api.py::test_backends_match_naive``)."""
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((2, 4, 24, 16), (2, 2, 24, 16), (2, 2, 24, 16))]
    (jq, jk, jv), (tq, tk, tv) = both(arrays)
    want = np.asarray(jitted(j_api.attention, jq, jk, jv, backend="naive",
                             exp_mode="lut", **kw))
    for backend in ("naive", "jnp", "pallas", "auto"):
        got = t_api.attention(tq, tk, tv, backend=backend, block_k=8,
                              exp_mode="lut", **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4,
                                   err_msg=backend)
