"""The GPipe stage schedule (``repro_torch.parallel.pipeline``: HASTILY
§IV's inter-layer pipelining over a mesh axis) and ``compressed_psum``,
the port's against the reference's.

One JAX subprocess with 4 host devices (``tests/_multidevice.py``'s
environment) computes the reference's ``pipeline_apply``, ``jax.grad``
of its sequential stage loop (what the reference's own test,
``tests/test_parallel.py::test_pipeline_parallel_matches_sequential``,
holds the pipeline to, with respect to the stage parameters and the
input) and ``compressed_psum`` inside ``shard_map``, while
4 gloo ranks on the CPU (``repro_torch.launch.mesh.spawn``) run the
port's on the same numpy inputs: the reference test's shapes (S 4
stages, M 6 microbatches of 3 rows, d 8).  The pipeline and its gradient
at the reference test's ``atol=1e-5``; ``compressed_psum`` and
``stack_stages`` bit for bit.  One intra-op thread; ~13 s alone (the
JAX subprocess's start and compiles).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro.parallel import stack_stages as j_stack_stages  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.parallel import stack_stages  # noqa: E402
from tests import _torch_tp_ranks as ranks  # noqa: E402
from tests._multidevice import SRC  # noqa: E402

S, M, MB, D = 4, 6, 3, 8
ATOL = 1e-5

_REFERENCE = """
import functools, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.parallel import compressed_psum, pipeline_apply
from repro.parallel.compat import make_mesh, shard_map
a = dict(np.load(sys.argv[1]))
mesh = make_mesh((4,), ("pod",))
ws, bs, x, c = (jnp.asarray(a[n]) for n in ("ws", "bs", "x", "c"))
f = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
out = pipeline_apply(f, {"w": ws, "b": bs}, x, mesh, axis="pod")

def sequential(ws, bs, x):
    h = x
    for s in range(ws.shape[0]):
        h = jnp.tanh(h @ ws[s] + bs[s])
    return jnp.sum(h * c)

dw, db, dx = jax.grad(sequential, argnums=(0, 1, 2))(ws, bs, x)
g = shard_map(lambda t: compressed_psum({"a": t["a"][0], "b": t["b"][0]},
                                         "pod"),
              mesh=mesh, in_specs=({"a": P("pod"), "b": P("pod")},),
              out_specs=P())
ps = g({"a": jnp.asarray(a["g"]), "b": jnp.asarray(a["h"])})
np.savez(sys.argv[2], out=np.asarray(out), dw=np.asarray(dw),
         db=np.asarray(db), dx=np.asarray(dx), psum_a=np.asarray(ps["a"]),
         psum_b=np.asarray(ps["b"]))
print("OK")
"""


def _inputs():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    # the reference test's draws first (its seed and order), then the
    # cotangent and the per-rank gradient trees (a leaf of 3 × 5 and one
    # of 7, each rank's own, magnitudes spread over decades)
    inp = dict(ws=f32(S, D, D) * 0.3, bs=f32(S, D), x=f32(M, MB, D))
    inp.update(c=f32(M, MB, D),
               g=f32(S, 3, 5) * np.float32(10.0) ** rng.integers(
                   -3, 3, size=(S, 3, 5)).astype(np.float32),
               h=f32(S, 7) * np.float32(1e-2))
    return inp


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={S}")
    jax_ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
         str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        got = spawn(ranks.pipeline_rank, S, inp, threads=1, root=str(tmp),
                    timeout=300)
    finally:
        out, err = jax_ref.communicate(timeout=420)
    assert jax_ref.returncode == 0, f"reference failed:\n{err[-4000:]}"
    return inp, dict(np.load(tmp / "ref.npz")), got


@pytest.mark.parametrize("rank", range(S))
def test_pipeline_matches_reference(outputs, rank):
    """Every rank holds the replicated outputs, with and without autograd,
    within atol 1e-5 of the reference's pipeline."""
    _, ref, got = outputs
    np.testing.assert_allclose(got[rank]["out"], ref["out"], atol=ATOL)
    np.testing.assert_array_equal(got[rank]["plain"], got[rank]["out"])


def test_pipeline_matches_sequential_stages(outputs):
    """The microbatches go through the stages' ops in order: the port's
    pipeline against its own stage loop."""
    inp, _, got = outputs
    h = torch.from_numpy(inp["x"])
    for s in range(S):
        h = torch.tanh(h @ torch.from_numpy(inp["ws"][s])
                       + torch.from_numpy(inp["bs"][s]))
    np.testing.assert_allclose(got[0]["out"], h.numpy(), atol=ATOL)


@pytest.mark.parametrize("leaf", ["dw", "db"])
def test_pipeline_gradient_matches_sequential_grad(outputs, leaf):
    """Each stage's rank holds the gradient of its own slice (the others'
    are zero); together they are ``jax.grad`` of the reference's
    sequential stage loop."""
    _, ref, got = outputs
    for r, g in enumerate(got):
        others = np.delete(g[leaf], r, axis=0)
        assert not others.any()
        np.testing.assert_allclose(g[leaf][r], ref[leaf][r], atol=ATOL)


@pytest.mark.parametrize("rank", range(S))
def test_pipeline_input_gradient_matches_sequential_grad(outputs, rank):
    """The gradient with respect to the replicated input: stage 0's pull
    back through its stage, held by every rank, ``jax.grad`` of the
    reference's sequential stage loop."""
    _, ref, got = outputs
    np.testing.assert_allclose(got[rank]["dx"], ref["dx"], atol=ATOL)


@pytest.mark.parametrize("leaf", ["a", "b"])
def test_compressed_psum_matches_reference_bits(outputs, leaf):
    """bf16 on the wire, summed over the 4 ranks, widened to f32: the
    reference's ``compressed_psum`` inside ``shard_map`` bit for bit, on
    every rank."""
    _, ref, got = outputs
    for g in got:
        assert g["psum"][leaf].dtype == np.float32
        np.testing.assert_array_equal(g["psum"][leaf], ref[f"psum_{leaf}"])


def test_stack_stages_matches_reference_bits():
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(8, 3, 5)).astype(np.float32),
            "ln": {"scale": rng.normal(size=(8, 5)).astype(np.float32)}}
    want = j_stack_stages({"w": jnp.asarray(tree["w"]),
                           "ln": {"scale": jnp.asarray(tree["ln"]["scale"])}},
                          4)
    got = stack_stages({"w": torch.from_numpy(tree["w"]),
                        "ln": {"scale": torch.from_numpy(tree["ln"]["scale"])}},
                       4)
    assert got["w"].shape == (4, 2, 3, 5)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["ln"]["scale"].numpy(),
                                  np.asarray(want["ln"]["scale"]))
