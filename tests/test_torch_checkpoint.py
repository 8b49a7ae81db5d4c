"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's: checkpoints written by ``repro.checkpoint.store.save`` are
read by the port's ``restore_flat`` / ``restore_params`` / ``restore``
(also cut to a rank's block of a mesh, ``restore(mesh=, specs=)``),
and checkpoints the port's ``save`` / ``AsyncCheckpointer`` write are
restored by the reference's ``restore``, bit for bit, f32 and bf16 leaves
alike (npz keeps a bf16 leaf as raw ``|V2`` bytes); retention, half-written
and corrupt checkpoints behave as the reference's.  No reference model is
compiled: the parameters come from the reference's ``init``, which runs
eagerly here."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process

import jax  # noqa: E402

from repro.checkpoint import store as J  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.checkpoint import store as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.parallel import param_specs  # noqa: E402
from repro_torch.params import from_flat, to_flat  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek-7b-smoke"


def ref_params(dtype):
    return build_model(j_get_config(ARCH).replace(dtype=dtype)).init(
        jax.random.PRNGKey(0))


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def written(request, tmp_path_factory):
    """A smoke parameter tree saved by the reference at steps 3 and 12, as
    its serve CLI saves it (``{"params": params}``)."""
    d = tmp_path_factory.mktemp(request.param)
    params = ref_params(request.param)
    for step in (3, 12):
        J.save(str(d), step, {"params": params}, extra={"note": step})
    os.makedirs(d / "step_00000099")          # no manifest: never listed
    return request.param, str(d), params


def test_restore_equals_the_weight_bridge(written):
    dtype, d, params = written
    cfg = get_config(ARCH).replace(dtype=dtype)
    want = from_flat(J.flatten_tree(params), cfg, "cpu")
    got, step, extra = T.restore_params(d, cfg, "cpu")
    assert (step, extra) == (12, {"note": 12})
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == getattr(torch, dtype), k
        assert torch.equal(bits(got[k]), bits(w)), k
    flat, step, _ = T.restore_flat(d, step=3)
    assert step == 3 and all(k.startswith("params/") for k in flat)
    assert {k: v.dtype for k, v in flat.items()} == {
        "params/" + k: getattr(torch, dtype)
        for k in J.flatten_tree(params)}


def test_steps_equal_the_reference(written, tmp_path):
    _, d, _ = written
    assert T.steps(d) == J.steps(d) == [3, 12]
    assert T.latest_step(d) == J.latest_step(d) == 12
    assert T.steps(str(tmp_path / "none")) == J.steps(str(tmp_path / "none"))
    assert T.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        T.restore_flat(str(tmp_path))


def test_a_flipped_byte_raises(written, tmp_path):
    """One byte of one leaf flipped (the npz rewritten whole, so the zip's
    own checksums still hold): the manifest's sha256 catches it."""
    dtype, d, _ = written
    J.save(str(tmp_path), 5, {"params": ref_params(dtype)})
    npz = tmp_path / "step_00000005" / "arrays.npz"
    with np.load(npz) as z:
        arrays = {k: z[k].copy() for k in z.files}
    key = sorted(arrays)[0]
    raw = arrays[key].view(np.uint8).reshape(-1)
    raw[7] ^= 0x10
    np.savez(npz, **arrays)
    with pytest.raises(IOError, match="corruption"):
        T.restore_flat(str(tmp_path))
    flat, _, _ = T.restore_flat(str(tmp_path), verify=False)
    assert key in flat


def test_a_leaf_of_another_dtype_is_cast(written, tmp_path):
    """A leaf whose dtype is not the config's is cast to it, as the
    reference's ``unflatten_into`` casts to its template."""
    dtype, _, params = written
    other = "float32" if dtype == "bfloat16" else "bfloat16"
    stored = ref_params(other)
    J.save(str(tmp_path), 1, {"params": stored})
    cfg = get_config(ARCH).replace(dtype=dtype)
    got, _, _ = T.restore_params(str(tmp_path), cfg, "cpu")
    want = {k: v.to(getattr(torch, dtype)) for k, v in from_flat(
        J.flatten_tree(stored), cfg.replace(dtype=other), "cpu").items()}
    for k, w in want.items():
        assert got[k].dtype == getattr(torch, dtype), k
        assert torch.equal(bits(got[k]), bits(w)), k
    if other == "float32":
        # the reference casts f32 leaves onto a bf16 template the same way
        # (its npz bf16 leaves it can only view, not cast)
        ref = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           {"params": params})
        tree, _, _ = J.restore(str(tmp_path), ref)
        for k, w in from_flat(J.flatten_tree(tree["params"]), cfg,
                              "cpu").items():
            assert torch.equal(bits(got[k]), bits(w)), k


def test_port_writes_what_the_reference_restores(written, tmp_path):
    """The port's ``save`` of the same tree: the manifest equals the
    reference's leaf for leaf (paths, shapes, dtypes, sha256), and the
    reference's ``restore`` gives its parameters back bit for bit."""
    dtype, d, params = written
    cfg = get_config(ARCH).replace(dtype=dtype)
    port = from_flat(J.flatten_tree(params), cfg, "cpu")
    T.save(str(tmp_path), 12, {"params": to_flat(port, cfg)},
           extra={"note": 12})
    manifest = lambda root: json.loads(  # noqa: E731
        (Path(root) / "step_00000012" / "manifest.json").read_text())
    assert manifest(tmp_path) == manifest(d)
    ref = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                       {"params": params})
    tree, step, extra = J.restore(str(tmp_path), ref)
    assert (step, extra) == (12, {"note": 12})
    for path, a in J.flatten_tree(tree).items():
        want = J.flatten_tree({"params": params})[path]
        assert a.dtype == want.dtype and np.array_equal(
            a.view(np.uint8), want.view(np.uint8)), path


def test_restore_onto_a_tree_of_tensors(written):
    """``restore`` maps a reference-written step onto a port template
    (shape, dtype and device of each leaf), as ``unflatten_into`` does."""
    dtype, d, params = written
    cfg = get_config(ARCH).replace(dtype=dtype)
    port = from_flat(J.flatten_tree(params), cfg, "cpu")
    template = {"params": {k: torch.zeros_like(v)
                           for k, v in to_flat(port, cfg).items()}}
    tree, step, _ = T.restore(d, template, step=3)
    assert step == 3
    got = from_flat(tree["params"], cfg, "cpu")
    for k, w in port.items():
        assert torch.equal(bits(got[k]), bits(w)), k
    bad = {"params": dict(template["params"], extra=torch.zeros(1))}
    with pytest.raises(KeyError, match="missing leaf"):
        T.restore(d, bad)
    first = sorted(template["params"])[0]
    wrong = {"params": dict(template["params"], **{first: torch.zeros(3)})}
    with pytest.raises(ValueError, match="shape mismatch"):
        T.restore(d, wrong)
    with pytest.raises(ValueError, match="together"):
        T.restore(d, template, mesh=Mesh((2, 2), ("data", "model")))


@pytest.mark.parametrize("rank", range(4))
def test_restore_cuts_each_ranks_block(written, rank):
    """The elastic re-shard in one process (the counterpart of the
    reference's ``test_checkpoint.py::test_elastic_restore_onto_mesh``):
    ``restore(mesh=, specs=)`` onto a layout-only 2 × 2 mesh at ``rank``
    reads each leaf whole and keeps the rank's block — the block that
    numpy slicing of the reference's full leaf at the rank's coordinates
    gives, under the reference's rules — onto a shape-only template."""
    from repro.parallel.sharding import param_specs as j_param_specs
    dtype, d, params = written
    flat = {f"params/{k}": v for k, v in J.flatten_tree(params).items()}
    mesh = Mesh((2, 2), ("data", "model"), rank=rank)
    template = {"params": {k: torch.empty(v.shape, device="meta",
                                          dtype=getattr(torch, dtype))
                           for k, v in J.flatten_tree(params).items()}}
    specs = {"params": param_specs(template["params"], mesh)}
    tree, step, _ = T.restore(d, template, step=3, mesh=mesh, specs=specs)
    assert step == 3
    # the reference's rules (they read only the mesh's axis names and
    # sizes, so the layout-only mesh stands in for a 2 × 2 JAX mesh)
    coords = dict(data=rank // 2, model=rank % 2)
    split = 0
    for path, spec in specs["params"].items():
        want = flat[f"params/{path}"]
        jspec = tuple(j_param_specs({path: jax.ShapeDtypeStruct(
            want.shape, want.dtype)}, mesh)[path])
        assert jspec == spec, path
        for dim, axis in enumerate(jspec):
            if axis is None:
                continue
            n = want.shape[dim] // 2
            want = np.take(want, range(coords[axis] * n,
                                       (coords[axis] + 1) * n), axis=dim)
            split += 1
        got = tree["params"][path]
        assert got.device.type == "cpu" and got.shape == want.shape, path
        assert np.array_equal(bits(got).numpy().view(np.uint8),
                              np.ascontiguousarray(want).view(np.uint8)), path
    assert split > 0


def test_named_tuple_paths_and_scalars_round_trip(tmp_path):
    """The optimizer state's paths (``opt/.step``, ``opt/.m/...``) and a
    0-d int32 leaf, written by either package, read by the other."""
    from repro.optim import AdamWState as JState
    from repro_torch.optim import AdamWState as TState
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    jt = {"opt": JState(step=jax.numpy.asarray(7, jax.numpy.int32),
                        m={"w": w}, v={"w": w * 2})}
    tt = {"opt": TState(step=torch.tensor(7, dtype=torch.int32),
                        m={"w": torch.from_numpy(w)},
                        v={"w": torch.from_numpy(w * 2)})}
    assert sorted(T.flatten_tree(tt)) == sorted(J.flatten_tree(jt))
    J.save(str(tmp_path / "j"), 1, jt)
    T.save(str(tmp_path / "t"), 1, tt)
    got, _, _ = T.restore(str(tmp_path / "j"), tt)
    assert got["opt"].step.shape == () and int(got["opt"].step) == 7
    assert torch.equal(got["opt"].v["w"], tt["opt"].v["w"])
    ref = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jt)
    back, _, _ = J.restore(str(tmp_path / "t"), ref)
    assert int(back["opt"].step) == 7
    assert np.array_equal(np.asarray(back["opt"].m["w"]), w)


@pytest.mark.parametrize("writer", ["savez", "savez_compressed"])
def test_npz_read_equals_np_load(tmp_path, writer):
    """The restore's npz reader (each member read at its offset) gives
    ``np.load``'s arrays, dtypes and shapes: f32, bf16 as ``|V2``, a 0-d
    leaf, a Fortran-ordered leaf, an empty one; a compressed npz, which
    neither package writes, raises ``IOError``."""
    rng = np.random.default_rng(3)
    arrays = {
        "params/w": rng.normal(size=(5, 7)).astype(np.float32),
        "opt/m/w": rng.integers(-2 ** 15, 2 ** 15, size=(3, 4),
                                dtype=np.int16).view("V2"),
        "opt/.step": np.asarray(7, dtype=np.int32),
        "fortran": np.asfortranarray(rng.normal(size=(4, 6))),
        "empty": np.zeros((0, 3), dtype=np.float32),
    }
    path = str(tmp_path / "arrays.npz")
    getattr(np, writer)(path, **arrays)
    if writer == "savez_compressed":
        with pytest.raises(IOError, match="compressed"):
            T._load_npz(path)
        return
    got = T._load_npz(path)
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    assert list(got) == list(want)
    def raw(a):
        return np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(raw(got[k]), raw(w))


def test_retention_and_half_written_steps(tmp_path):
    """``AsyncCheckpointer`` keeps the newest ``keep`` steps, as the
    reference's; a ``.tmp-<pid>`` directory (a write cut short) and a step
    without a manifest are never listed or restored."""
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    for name, mk in (("t", T.AsyncCheckpointer), ("j", J.AsyncCheckpointer)):
        ck = mk(str(tmp_path / name), keep=2)
        for step in (1, 2, 3, 4):
            ck.save(step, tree if name == "t" else {"w": tree["w"].numpy()})
        ck.wait()
    assert T.steps(str(tmp_path / "t")) == J.steps(str(tmp_path / "j")) == [3, 4]
    os.makedirs(tmp_path / "t" / "step_00000009.tmp-123")
    os.makedirs(tmp_path / "t" / "step_00000008")
    assert T.latest_step(str(tmp_path / "t")) == 4
    got, step, _ = T.restore(str(tmp_path / "t"), tree)
    assert step == 4 and torch.equal(got["w"], tree["w"])


def test_async_save_copies_before_it_returns(tmp_path):
    """A CPU tensor written in place right after ``save`` returns (as an
    optimizer may) leaves the checkpoint with the values at ``save``."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    ck = T.AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    flat, _, _ = T.restore_flat(str(tmp_path))
    assert torch.equal(flat["w"], torch.arange(1 << 16, dtype=torch.float32))


def test_async_write_errors_surface_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    ck = T.AsyncCheckpointer(str(blocker / "sub"))
    ck.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                  # the error is raised once


def test_serve_cli_serves_a_reference_checkpoint(tmp_path):
    """``--ckpt-dir`` restores the latest step of a reference-written bf16
    checkpoint, says so as the reference's CLI does, and serves; the engine
    line's kernel config is the tuner table's CPU row."""
    J.save(str(tmp_path), 4, {"params": ref_params("bfloat16")})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--batch", "--requests", "2", "--max-new", "3",
         "--max-len", "48", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "restored checkpoint step 4" in out.stdout
    assert "batch driver: served 2 requests, 6 tokens" in out.stdout
    line = out.stdout.split("kernel_config: ")[1].splitlines()[0]
    kc = json.loads(line.replace("'", '"').replace("None", "null"))
    assert (kc["block_q"], kc["block_pages"], kc["source"]) == (8, 8, "tuned")
