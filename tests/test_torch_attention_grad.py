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
table step (2^-7) of the largest gradient.

The bf16 backward kernel has no CPU path, so its arithmetic (P and dS
split into bf16 hi + lo before the products) is emulated in torch and
held against the reference on bf16-rounded inputs
(``test_tensor_core_backward_arithmetic_holds_jax``).  One intra-op
thread; ~40 s alone."""
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
from repro_torch.kernels.lut_exp.ref import lut_exp_ref  # noqa: E402
from repro_torch.kernels.streaming_attention import ops as sa_ops  # noqa: E402
from tests.test_kernels import ATTN_CASES  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-4)
MODES = ("lut", "lut0", "exact")
# Head dim 256 (gemma2, gemma3), GQA 2:1: causal with gemma2's softcap 50,
# causal with a window that bites, and q_offset with kv_len.
D256_CASES = [
    dict(b=1, hq=4, hkv=2, lq=40, lkv=40, d=256, causal=True, cap=50.0),
    dict(b=1, hq=4, hkv=2, lq=48, lkv=48, d=256, causal=True, window=12),
    dict(b=1, hq=4, hkv=2, lq=24, lkv=64, d=256, causal=True, q_offset=33,
         kv_len=50),
]


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


@pytest.mark.parametrize("exp_mode", MODES)
@pytest.mark.parametrize("case", D256_CASES)
def test_plain_backward_at_head_dim_256_matches_jax(case, exp_mode):
    """At head dim 256 the port's plain backward (the ``pallas`` backend's
    CPU path: ``attention_lse_ref`` then ``attention_bwd_ref``, what the
    card's backward kernel is held to) against ``jax.grad`` of the
    reference's ``pallas`` backend (its custom VJP, ``_bwd``), at the
    module's tolerance and ``lut0`` rule."""
    arrays, kw = inputs(case, exp_mode)

    def pallas(q, k, v, w):
        return jax.grad(lambda a, b_, c: jnp.sum(j_api.attention(
            a, b_, c, backend="pallas", **kw) * w), argnums=(0, 1, 2))(
                q, k, v)
    want = [np.asarray(g) for g in jax.jit(pallas)(*map(jnp.asarray,
                                                         arrays))]
    for name, got, e in zip("qkv", torch_grads(arrays, kw, "pallas"), want):
        assert got.shape == e.shape, name
        hold(got, e, exp_mode, f"pallas d{name}")


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


def _hi_lo(x):
    """f32 x as the bf16 backward kernel feeds it to the tensor cores: hi,
    its upper 16 bits, plus lo = bf16(x − hi) (``repro::split_bf16``)."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi + (x - hi).to(torch.bfloat16).float()


def tensor_core_grads(q, k, v, w, kw):
    """dq, dk, dv as the bf16 backward kernel computes them from bf16 q, k,
    v and dout (held here as f32): the forward kernel's bf16 output and f32
    lse, δ = Σ dout·out, S and dP from exact products, P and dS in f32,
    then split hi + lo before the dV, dK and dQ products, and each output
    rounded once to bf16."""
    kw = dict(kw)
    mode, cap = kw.pop("exp_mode"), kw.get("cap")
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    g, scale = hq // hkv, d ** -0.5
    out, lse = sa_ops.attention_lse_ref(q, k, v, scale=scale, exp_mode=mode,
                                        **kw)
    out = out.to(torch.bfloat16).float()
    kx, vx = (t.repeat_interleave(g, dim=1) for t in (k, v))
    x = torch.einsum("bhqd,bhkd->bhqk", q, kx) * scale
    if cap:
        x = cap * torch.tanh(x / cap)
    pos = kw.get("q_offset", 0) + torch.arange(lq)[:, None]
    key = torch.arange(lkv)[None, :]
    vis = key < (lkv if kw.get("kv_len") is None else kw["kv_len"])
    if kw.get("causal"):
        vis = vis & (key <= pos)
    if kw.get("window"):
        vis = vis & (pos - key < kw["window"])
    z = torch.where(vis, x - lse[..., None], 0.0)
    p = torch.exp(z) if mode == "exact" else lut_exp_ref(
        z, order=0 if mode == "lut0" else 1)
    p = torch.where(vis, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", w, vx) - (w * out).sum(-1)[..., None]
    if cap:
        dp = dp * (1 - (x / cap) ** 2)
    ds = _hi_lo(torch.where(vis, p * dp * scale, 0.0))
    p = _hi_lo(p)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q).reshape(b, hkv, g, lkv, d)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, w).reshape(b, hkv, g, lkv, d)
    return [t.to(torch.bfloat16).float().numpy()
            for t in (dq, dk.sum(2), dv.sum(2))]


@pytest.mark.parametrize("case", ATTN_CASES + D256_CASES)
def test_tensor_core_backward_arithmetic_holds_jax(case):
    """The bf16 backward kernel's arithmetic, emulated in torch (P and dS
    split into bf16 hi + lo before their products, every output rounded
    once to bf16), against ``jax.grad`` of the reference's ``pallas``
    backend on the same bf16-rounded inputs in f32: within 2^-7 of the
    largest gradient (one bf16 ulp), the card checks' ``BWD_TOL``.  At head
    dim 256 the kernel computes dV and dK in blocks of their own; each
    recomputes Sᵀ from the same exact products in the same k-step order,
    so P is the same in both and the arithmetic is the one emulated here.
    One intra-op thread; ~8 s alone for the seven cases."""
    arrays, kw = inputs(case, case.get("exp_mode", "lut"))
    arrays = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
              for a in arrays]

    def pallas(q, k, v, w_):
        return jax.grad(lambda a, b_, c: jnp.sum(j_api.attention(
            a, b_, c, backend="pallas", **kw) * w_), argnums=(0, 1, 2))(
                q, k, v)
    fn = pallas if kw.get("cap") is not None and not kw.get("causal") \
        else jax.jit(pallas)
    want = [np.asarray(x) for x in fn(*map(jnp.asarray, arrays))]
    got = tensor_core_grads(*(torch.from_numpy(a) for a in arrays), kw)
    for name, a, e in zip("qkv", got, want):
        assert a.shape == e.shape, name
        err = np.abs(a - e).max() / np.abs(e).max()
        assert err <= 2.0 ** -7, (f"d{name}", err)
