"""The port's checkpoint read path (``repro_torch.checkpoint``) against the
reference's store: checkpoints written by ``repro.checkpoint.store.save``
are read by the port's ``restore_flat`` / ``restore_params``, bit for bit,
f32 and bf16 leaves alike (npz keeps a bf16 leaf as raw ``|V2`` bytes).
No reference model is compiled: the parameters come from the reference's
``init``, which runs eagerly here."""
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
from repro_torch.params import from_flat  # noqa: E402

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
