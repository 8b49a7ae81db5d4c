"""PyTorch port vs JAX reference: gradients of contiguous attention on the
CPU.  The reference differentiates its scan through a custom VJP (the
flash backward ``_bwd``: ``p = exp(s_c − lse)`` through the mode's
exponential, so a LUT softmax differentiates as ``exp`` does) and its
``pallas`` backend through the same backward; the port's scan is
``core.streaming_attention._StreamingAttention`` and its ``pallas``
backend the kernel wrapper's ``_Attention``, whose CPU forward and
backward are ``kernels/streaming_attention/ref.py``.

Every ``ATTN_CASES`` entry at every exp mode, f32, at the reference's
tolerance ``atol=2e-5, rtol=1e-4``: both sides compute the same f32
logits, weights and products in another summation order.  The scan runs
at the reference's 16-row blocks on both sides (the order-0 LUT depends
on the blocking of the forward's lse); the ``pallas`` backend at the
default ``block_k`` of 512, one block of every key on both sides.

One exception, stated: ``lut0``.  The order-0 LUT is a step function
(128 steps an octave, each 2^(1/128) − 1 ≈ 0.54% of e^x), so an ulp of
``s_c − lse`` on a table boundary moves p by a whole step.  The packages
differ by ulps there: XLA's f32 ``log`` differs from torch's on ~4% of
inputs (so ``lse`` on some rows), and the products sum in other orders
(measured: ``ATTN_CASES[0]``, 11 of 8,192 dq elements 4.8e-4 away; with
the reference's own residuals handed over, ``ATTN_CASES[1]``, 31 of 3,072
dv elements up to 1.5e-2 away).  At ``lut0`` at most 2% of the elements
may leave the reference's tolerance, and every element stays within one
table step (2^-7) of the largest gradient.  One intra-op thread; ~30 s alone."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import attention_api as j_api  # noqa: E402
from repro_torch.core import attention_api as t_api  # noqa: E402
from repro_torch.kernels.streaming_attention import ops as sa_ops  # noqa: E402
from tests.test_kernels import ATTN_CASES  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-4)
MODES = ("lut", "lut0", "exact")


def inputs(case, exp_mode, seed=0):
    c = dict(case)
    rng = np.random.default_rng(seed)
    b = c.pop("b")
    q = rng.normal(size=(b, c.pop("hq"), c.pop("lq"), c["d"]))
    k = rng.normal(size=(b, c.pop("hkv"), c.pop("lkv"), c.pop("d")))
    v = rng.normal(size=k.shape)
    w = rng.normal(size=q.shape)              # the output's cotangent
    c["exp_mode"] = exp_mode
    return [a.astype(np.float32) for a in (q, k, v, w)], c


def jax_grads(arrays, kw):
    """dq, dk, dv of sum(out · w) for the scan (16-row blocks) and the
    pallas backend (interpret mode forward, the flash backward), in one
    jitted call (eager for the soft-capped bidirectional case: see
    ``test_torch_streaming_attention.jitted``)."""
    def both(q, k, v, w):
        scan = lambda a, b_, c: jnp.sum(j_api.attention(  # noqa: E731
            a, b_, c, backend="jnp", block_k=16, **kw) * w)
        pallas = lambda a, b_, c: jnp.sum(j_api.attention(  # noqa: E731
            a, b_, c, backend="pallas", **kw) * w)
        return (jax.grad(scan, argnums=(0, 1, 2))(q, k, v),
                jax.grad(pallas, argnums=(0, 1, 2))(q, k, v))
    fn = both if kw.get("cap") is not None and not kw.get("causal") \
        else jax.jit(both)
    return [[np.asarray(g) for g in gs] for gs in fn(*map(jnp.asarray,
                                                          arrays))]


def torch_grads(arrays, kw, backend, **extra):
    q, k, v, w = (torch.from_numpy(a) for a in arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = t_api.attention(q, k, v, backend=backend, **kw, **extra)
    return [g.numpy() for g in torch.autograd.grad((out * w).sum(),
                                                   (q, k, v))]


def hold(got, want, exp_mode, what):
    """The reference's tolerance; at ``lut0`` the table-step rule of the
    module docstring."""
    if exp_mode != "lut0":
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        return
    off = ~np.isclose(got, want, **TOL)
    assert off.mean() <= 0.02, (what, off.sum(), off.size)
    np.testing.assert_allclose(got, want, err_msg=what, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("exp_mode", MODES)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_grads_match_jax(case, exp_mode):
    """The scan's and the ``pallas`` backend's dq, dk, dv against
    ``jax.grad`` of the reference's."""
    arrays, kw = inputs(case, exp_mode)
    want_scan, want_pallas = jax_grads(arrays, kw)
    for name, got, want in zip(
            "qkv", torch_grads(arrays, kw, "jnp", block_k=16), want_scan):
        hold(got, want, exp_mode, f"jnp d{name}")
    for name, got, want in zip(
            "qkv", torch_grads(arrays, kw, "pallas"), want_pallas):
        hold(got, want, exp_mode, f"pallas d{name}")


def test_lut0_gradient_is_not_the_lut_derivative():
    """At ``lut0`` autograd through the LUT would see its floors (a zero
    derivative of p); the custom VJP gives exp's, so the gradients are
    those of ``exact`` within the LUT's own error."""
    arrays, kw = inputs(ATTN_CASES[0], "lut0")
    got = torch_grads(arrays, kw, "jnp", block_k=16)
    exact = torch_grads(arrays, dict(kw, exp_mode="exact"), "jnp",
                        block_k=16)
    for g, e in zip(got, exact):
        assert np.abs(g).max() > 0.1
        np.testing.assert_allclose(g, e, atol=0.05 * np.abs(e).max())


def test_plain_lse_and_backward_are_the_scans():
    """The kernel's plain versions (``streaming_attention_lse`` and
    ``streaming_attention_bwd`` on CPU tensors) against the scan's custom
    VJP at one block: the same lse and the same gradients."""
    arrays, kw = inputs(ATTN_CASES[6], "lut")
    q, k, v, w = (torch.from_numpy(a) for a in arrays)
    out, lse = sa_ops.streaming_attention_lse(q, k, v, **kw)
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    assert lse.dtype == torch.float32
    assert torch.equal(out, sa_ops.attention_ref(q, k, v, **kw))
    scale = q.shape[-1] ** -0.5
    got = sa_ops.streaming_attention_bwd(q, k, v, out, lse, w, scale=scale,
                                         **kw)
    want = torch_grads(arrays, kw, "jnp", block_k=k.shape[2])
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), e, atol=1e-6, rtol=1e-6)
