"""The paper's multi-core softmax (HASTILY §III-B2) and the attention over
a split sequence, the port's (``repro_torch.core.multicore_softmax``,
``ring_attention``) against the reference's ``shard_map`` bodies.

One JAX subprocess with 4 host devices (the environment of
``tests/_multidevice.py``) computes every reference output at once into an
``.npz`` while 4 gloo ranks on the CPU (``repro_torch.launch.mesh.spawn``,
a ``file://`` rendezvous under ``tmp_path``) compute the port's on the
same numpy inputs.  Tolerances are
the reference tests' (``test_multicore_softmax.py``: atol 3e-6 against the
single-device softmax, 1e-6 butterfly against all-reduce;
``test_ring_attention.py``: atol 5e-5, rtol 1e-4).  The registry's
resolution with an axis is held to the reference's for every backend.
Runs in ~25 s alone (the JAX subprocess's compiles most of it).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process

from repro.core import attention_api as j_api  # noqa: E402
from repro_torch.core import attention_api as t_api  # noqa: E402
from repro_torch.core.lut_softmax import lut_softmax  # noqa: E402
from repro_torch.core.streaming_attention import naive_attention  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from tests import _torch_tp_ranks as ranks  # noqa: E402
from tests._multidevice import SRC  # noqa: E402

N = 4
RING_TOL = dict(atol=5e-5, rtol=1e-4)

_REFERENCE = """
import functools, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.parallel.compat import make_mesh, shard_map
from repro.core.multicore_softmax import (sharded_softmax,
                                          sharded_softmax_tree)
from repro.core.ring_attention import (ring_attention,
                                       distributed_decode_attention)
a = dict(np.load(sys.argv[1]))
mesh = make_mesh((4,), ("model",))
out = {}
x = jnp.asarray(a["x"])
for name, fn in (("softmax", sharded_softmax),
                 ("softmax_tree", sharded_softmax_tree)):
    f = shard_map(functools.partial(fn, axis_name="model"), mesh=mesh,
                  in_specs=P(None, "model"), out_specs=P(None, "model"))
    out[name] = np.asarray(f(x))
q, k, v = (jnp.asarray(a[n]) for n in ("q", "k", "v"))
seq = P(None, None, "model")
for i, kw in enumerate(RING_KW):
    f = shard_map(functools.partial(ring_attention, axis_name="model", **kw),
                  mesh=mesh, in_specs=(seq, seq, seq), out_specs=seq)
    out[f"ring{i}"] = np.asarray(f(q, k, v))
kv_len = int(a["kv_len"])
f = shard_map(functools.partial(distributed_decode_attention,
                                axis_name="model", kv_len=jnp.int32(kv_len)),
              mesh=mesh, in_specs=(P(), seq, seq), out_specs=P())
qd, kd, vd = (jnp.asarray(a[n]) for n in ("qd", "kd", "vd"))
out["decode"] = np.asarray(f(qd, kd, vd))
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    # the reference tests' shapes: softmax rows split on 128 columns, ring
    # (2, 4:2 heads, 64 rows, 16), decode at kv_len 100 of 128 rows
    inp = dict(x=f32(4, 128) * 5, q=f32(2, 4, 64, 16), k=f32(2, 2, 64, 16),
               v=f32(2, 2, 64, 16), qd=f32(2, 4, 1, 16),
               kd=f32(2, 4, 128, 16), vd=f32(2, 4, 128, 16),
               kv_len=np.array(100, np.int32))
    # a ragged stream over page pools, for the registry's band all-gather:
    # lanes of 3 and 5 rows at 9 and 21 live rows, 8 q heads over 4 kv
    ps, t = 8, 8
    inp.update(vq=f32(1, 8, t, 16), vk=f32(7, 4, ps, 16),
               vv=f32(7, 4, ps, 16),
               vtable=np.array([[0, 1, 6]] * 3 + [[2, 3, 4]] * 5, np.int32),
               vpos=np.array([6, 7, 8, 16, 17, 18, 19, 20], np.int32),
               vcu=np.array([0, 3, 8, 8, 8], np.int32))
    return inp


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(inputs, the reference's outputs, the port's rank 0 outputs, every
    rank's outputs)."""
    tmp = tmp_path_factory.mktemp("multicore")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}")
    jax_ref = subprocess.Popen(
        [sys.executable, "-c", f"RING_KW = {ranks.RING_KW!r}\n" + _REFERENCE,
         str(tmp / "in.npz"), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        got = spawn(ranks.multicore_rank, N, inp, threads=1, root=str(tmp),
                    timeout=300)
    finally:
        out, err = jax_ref.communicate(timeout=420)
    assert jax_ref.returncode == 0, f"reference failed:\n{err[-4000:]}"
    return inp, dict(np.load(tmp / "ref.npz")), got[0], got


def _t(inp, *names):
    return [torch.from_numpy(inp[n]) for n in names]


def test_sharded_softmax_matches_reference_and_full(outputs):
    """Against the reference's shard_map output and the port's
    single-process LUT softmax of the whole row."""
    inp, ref, got, _ = outputs
    full = lut_softmax(*_t(inp, "x")).numpy()
    np.testing.assert_allclose(got["softmax"], full, atol=3e-6)
    np.testing.assert_allclose(got["softmax"], ref["softmax"], atol=3e-6)
    np.testing.assert_allclose(got["softmax_tree"], got["softmax"], atol=1e-6)
    np.testing.assert_allclose(got["softmax_tree"], ref["softmax_tree"],
                               atol=3e-6)


def test_tree_allreduce_takes_log2_rounds(outputs):
    """log₂ 4 = 2 pairwise rounds a reduce: 4 for the tree softmax's two
    reduces, 2 for one ``tree_allreduce``, whose sum reaches every rank."""
    _, _, _, every = outputs
    for r in every:
        assert tuple(r["rounds"]) == (4, 2)
        assert float(r["tree_sum"][0]) == sum(range(N))


@pytest.mark.parametrize("i", range(len(ranks.RING_KW)))
def test_ring_attention_matches_reference(outputs, i):
    """Causal, windowed, and bidirectional with a softcap, as the
    reference's test (held, as there, to the materialised attention
    too); the registry's ``ring`` backend is the same call."""
    inp, ref, got, _ = outputs
    naive = naive_attention(*_t(inp, "q", "k", "v"), exp_mode="lut",
                            **ranks.RING_KW[i]).numpy()
    np.testing.assert_allclose(got[f"ring{i}"], ref[f"ring{i}"], **RING_TOL)
    np.testing.assert_allclose(got[f"ring{i}"], naive, **RING_TOL)
    np.testing.assert_array_equal(got[f"ring_api{i}"], got[f"ring{i}"])


def test_auto_resolves_to_ring_with_an_axis(outputs):
    _, _, got, _ = outputs
    np.testing.assert_array_equal(got["auto_ring"], got["ring0"])


def test_distributed_decode_matches_reference(outputs):
    inp, ref, _, every = outputs
    kv_len = int(inp["kv_len"])
    naive = naive_attention(*_t(inp, "qd", "kd", "vd"), causal=True,
                            q_offset=kv_len - 1, kv_len=kv_len,
                            exp_mode="lut").numpy()
    for r in every:                       # the same output on every rank
        np.testing.assert_allclose(r["decode"], ref["decode"], **RING_TOL)
        np.testing.assert_allclose(r["decode"], naive, **RING_TOL)


def test_ragged_backend_gathers_head_bands_bit_for_bit(outputs):
    """Each rank attends its band of 2 q heads over 1 kv head and the
    all-gather rebuilds the head axis: bitwise the single-process call."""
    inp, _, got, _ = outputs
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    want = t_api.attention(t["vq"], t["vk"], t["vv"], backend="paged_varlen",
                           causal=True, page_table=t["vtable"],
                           q_pos=t["vpos"], cu_seqlens=t["vcu"])
    np.testing.assert_array_equal(got["varlen"], want.numpy())


FACTS = [dict(), dict(lq=1), dict(platform="tpu"),
         dict(has_page_table=True), dict(has_page_table=True, is_ragged=True),
         dict(has_kv_pos=True), dict(static_lengths=False)]


@pytest.mark.parametrize("backend", ["auto", "ring", "pallas", "jnp",
                                     "naive", "naive_decode", "paged",
                                     "paged_varlen"])
@pytest.mark.parametrize("facts", FACTS)
def test_resolution_with_an_axis_matches_reference(backend, facts):
    """With an axis (the reference's "inside shard_map") every explicit
    and auto choice resolves, falls back or raises as the reference's."""
    base = dict(lq=16, lkv=16, platform="cpu", static_lengths=True,
                has_kv_pos=False, inside_shard_map=True)
    base.update(facts)
    j_call = j_api.AttentionCall(**base)
    t_call = t_api.AttentionCall(**dict(base, platform={
        "tpu": "cuda"}.get(base["platform"], base["platform"])))
    try:
        want = j_api.resolve_backend(backend, j_call, fallback=True).name
    except ValueError:
        with pytest.raises(ValueError):
            t_api.resolve_backend(backend, t_call, fallback=True)
        return
    assert t_api.resolve_backend(backend, t_call, fallback=True).name == want
    if backend != "auto" and not j_api.get_backend(backend).supports(j_call):
        with pytest.raises(ValueError, match="does not support"):
            t_api.resolve_backend(backend, t_call)
