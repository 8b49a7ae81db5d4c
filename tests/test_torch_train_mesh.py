"""The training half of tensor parallelism on the CPU: the port's
``Trainer(mesh=)`` in gloo ranks (``repro_torch.launch.mesh.spawn``)
against one device.

Four ranks on ``Mesh((2, 2), ("data", "model"))`` train deepseek-7b-smoke
in f32 on a global batch of 4 × 16: each rank keeps its block of every
leaf (ZeRO-3), takes its 2 rows, attends its band of the heads (2 KV
heads divide the model axis) and all-gathers them.  Held at ``rtol=1e-5``
(the existing twins' tolerance: the sums run in other orders) against
the reference's single-device ``Trainer`` from its step-0 checkpoint (the
reference's own sharded loss is held to its single-device one,
``tests/test_parallel.py:101``); a failure at step 2 recovers bit for bit
against an uninterrupted mesh run; a single-device checkpoint resumes on
the mesh (``Trainer.restore(mesh=)``) and the mesh's resumes on one
device, the six losses those of one device's run; ``compress_grads`` on
the mesh equals one device's.  Two ranks on ``(2, 1)`` train
granite-moe-3b-a800m-smoke on 4 × 256 (512-token dispatch groups on both
sides) against the port's single device, which holds the load-balancing
statistics summed over the data-parallel ranks; at 4 × 16 the split
would change the groups (64 → 32 tokens) and the trainer refuses it.
One intra-op thread per rank; ~22 s alone (the reference's compiles and
the two spawns).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.runtime import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from tests import _torch_tp_ranks as ranks  # noqa: E402

DEEPSEEK, GRANITE = "deepseek-7b-smoke", "granite-moe-3b-a800m-smoke"
DATA = dict(seq_len=16, global_batch=4)
MOE_DATA = dict(seq_len=256, global_batch=4)
TRAIN = dict(steps=4, lr=5e-3, warmup=2, ckpt_every=100)
ELASTIC = dict(steps=6, lr=5e-3, warmup=2, ckpt_every=100)
RTOL = 1e-5
KEYS = ("loss", "lr", "grad_norm")


def _single(name, dkw, path=None, **tkw):
    return ranks._trainer(name, dkw, None, **dict(tkw, ckpt_dir=path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's single-device runs, and what the
    ranks of both meshes logged."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    # the reference's step-0 checkpoint and its own run from it
    jcfg = j_get_config(DEEPSEEK).replace(dtype="float32")
    jtr = JTrainer(jcfg, JDataConfig(vocab_size=jcfg.vocab_size, **DATA),
                   JTrainConfig(ckpt_dir=str(tmp / "ref"), **TRAIN))
    jtr.init()
    jtr.save()
    jtr.ckpt.wait()
    shutil.copytree(tmp / "ref", tmp / "twin")
    want = {"reference": ranks._logged(jtr.run())}
    # one device: the first two of six steps, then the rest of the run
    first = _single(DEEPSEEK, DATA, str(tmp / "elastic"), **ELASTIC)
    want["elastic first"] = ranks._logged(first.run(num_steps=2))
    want["elastic whole"] = ranks._logged(_single(DEEPSEEK, DATA,
                                                  **ELASTIC).run())
    want["compress"] = ranks._logged(_single(
        DEEPSEEK, DATA, **dict(TRAIN, compress_grads=True)).run())
    # granite: a checkpoint every step, each copied for the mesh to start
    # that step from
    moe_dirs = []
    moe = _single(GRANITE, MOE_DATA, str(tmp / "moe"),
                  **dict(TRAIN, ckpt_every=1, keep_ckpts=5))
    moe.init()
    moe.save()
    want["granite"] = ranks._logged(moe.run())
    for step in range(TRAIN["steps"]):
        name = f"step_{step:08d}"
        moe_dirs.append(str(tmp / f"moe{step}"))
        shutil.copytree(tmp / "moe" / name, tmp / f"moe{step}" / name)
    plan = dict(shape=(2, 2), elastic_steps=2, runs=[
        ("twin", "run", DEEPSEEK, DATA, TRAIN, str(tmp / "twin")),
        ("recover", "recover", DEEPSEEK, DATA, dict(TRAIN, ckpt_every=3),
         str(tmp / "recover")),
        ("uninterrupted", "run", DEEPSEEK, DATA, TRAIN, None),
        ("elastic", "elastic", DEEPSEEK, DATA, ELASTIC, str(tmp / "elastic")),
        ("compress", "blocks", DEEPSEEK, DATA,
         dict(TRAIN, compress_grads=True), None)])
    got = spawn(ranks.train_mesh_rank, 4, plan, threads=1, root=str(tmp),
                timeout=300)
    plan = dict(shape=(2, 1), runs=[
        ("granite", "stepwise", GRANITE, MOE_DATA, TRAIN, moe_dirs),
        ("refused", "refused", GRANITE, DATA, TRAIN, None)])
    got_moe = spawn(ranks.train_mesh_rank, 2, plan, threads=1, root=str(tmp),
                    timeout=300)
    # one device resumes the mesh's step-4 checkpoint
    last = _single(DEEPSEEK, DATA, str(tmp / "elastic"), **ELASTIC)
    want["elastic last"] = ranks._logged(last.run())
    return want, got, got_moe


def _close(got, want, rtol=RTOL):
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for key in KEYS:
        np.testing.assert_allclose([m[key] for m in got],
                                   [m[key] for m in want], rtol=rtol,
                                   err_msg=key)


@pytest.mark.parametrize("rank", range(4))
def test_mesh_trainer_matches_reference_single_device(runs, rank):
    """Every rank of the 2 × 2 mesh logs the reference's single-device
    losses, learning rates and gradient norms over 4 steps (the global
    batch's loss and the global norm)."""
    want, got, _ = runs
    assert [m["step"] for m in got[rank]["twin"]] == [0, 1, 2, 3]
    _close(got[rank]["twin"], want["reference"])


def test_ranks_log_the_same_bits(runs):
    """The reported loss and norm are sums over the ranks: every rank
    holds the same bits."""
    _, got, got_moe = runs
    for tag in ("twin", "recover", "elastic", "compress"):
        assert all(g[tag] == got[0][tag] for g in got), tag
    assert got_moe[1]["granite"] == got_moe[0]["granite"]


def test_blocks_follow_the_rules(runs):
    """Each rank keeps its block: a (2, 2) mesh halves the dims the rules
    split on each axis (wq (L, D, Hq·Dh) on both, the norms on none)."""
    _, got, _ = runs
    blocks = got[0]["compress blocks"]
    assert blocks["wq"] == (2, 32, 32) and blocks["wo"] == (2, 32, 32)
    assert blocks["embed"] == (256, 32) and blocks["ln1"] == (2, 64)


def test_mesh_failure_recovers_bit_for_bit(runs):
    """A failure injected at step 2 restores the step-0 checkpoint (rank 0
    wrote it from the gathered blocks) on every rank and replays: the
    losses equal the uninterrupted mesh run's bit for bit."""
    _, got, _ = runs
    for g in got:
        assert [m["step"] for m in g["recover"]] == [0, 1, 0, 1, 2, 3]
        by_step = {}
        for m in g["recover"]:           # a replayed step: the same bits
            assert by_step.setdefault(m["step"], m) == m
        assert [by_step[s]["loss"] for s in range(4)] == [
            m["loss"] for m in g["uninterrupted"]]
        assert g["recover checkpoints"] == ["step_00000000", "step_00000003",
                                            "step_00000004"]


def test_elastic_single_device_to_mesh_and_back(runs):
    """One device runs steps 0–1 and saves; the mesh restores that
    checkpoint re-cut for 2 × 2 and runs steps 2–3; one device resumes the
    mesh's checkpoint for steps 4–5: the six steps are one device's run."""
    want, got, _ = runs
    assert got[0]["elastic mesh"] == {"data": 2, "model": 2}
    whole = want["elastic whole"]
    _close(want["elastic first"], whole[:2], rtol=0)
    _close(got[0]["elastic"], whole[2:4])
    _close(want["elastic last"], whole[4:])


def test_compressed_gradients_on_the_mesh(runs):
    """bf16 + error feedback on each rank's block of the summed f32
    gradient equals one device's compressed run."""
    want, got, _ = runs
    _close(got[0]["compress"], want["compress"])


def test_moe_mesh_trainer_matches_single_device(runs):
    """granite-moe-smoke at (2, 1), each step from one device's checkpoint
    of that step (run free, MoE twins part after AdamW's first updates:
    ``tests/test_torch_runtime.py::TWINS``): the load-balancing loss
    takes the global batch's routed fractions and mean probabilities."""
    want, _, got_moe = runs
    _close(got_moe[0]["granite"], want["granite"])


def test_moe_split_that_changes_the_groups_is_refused(runs):
    _, _, got_moe = runs
    for g in got_moe:
        assert "groups of 64" in g["refused"]
        assert "groups of 32" in g["refused"]
