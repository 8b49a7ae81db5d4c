"""PyTorch port vs JAX reference: the training runtime on the CPU.

The twin: the reference's ``Trainer`` on ``deepseek-7b-smoke`` in f32
writes its step-0 state (``save()`` after ``init()``); the port's
``Trainer`` resumes from that checkpoint (the reference's file format and
leaf paths), and both run 4 steps of the same pipeline.  Losses, learning
rates and gradient norms agree within ``rtol=1e-5`` (both compute the same
f32 forward, backward and AdamW update in other summation orders and with
other ``log`` / ``exp`` roundings; measured ≤ 4.1e-7) — and the port's
step-4 checkpoint restores into the reference's ``Trainer``.

Then the reference's own contracts (``tests/test_runtime.py``) on the
port: loss decreases, bit-exact recovery after injected failures,
auto-resume, unrecoverable without a checkpoint, the straggler log,
compressed gradients learn, error feedback accumulates; the CLI; the
refusals.  One intra-op thread; ~55 s alone."""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.runtime import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.parallel import (compress_with_feedback,  # noqa: E402
                                  feedback_init)
from repro_torch.runtime import (FailureInjector, TrainConfig,  # noqa: E402
                                 Trainer)

ARCH = "deepseek-7b-smoke"


def mk_trainer(tmp_path, cfg=None, **kw):
    cfg = cfg or get_config(ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4,
                      corpus="lm")
    base = dict(steps=8, ckpt_dir=None if tmp_path is None else str(tmp_path),
                ckpt_every=3, lr=5e-3, warmup=2)
    base.update(kw)
    return Trainer(cfg, dcfg, TrainConfig(**base), device="cpu")


# The twin's configurations (overrides on both sides, whether the port runs
# free from step 0, rtol): deepseek-7b-smoke, and the two families that
# train at head dim 256 on the card — gemma2-9b-smoke widened to it
# (softcaps 50 and 30, GQA 2:1, tied embeddings, post-block norms; its
# window of 8 bites at 24 tokens) and gemma3-12b-smoke (QK-norm, two RoPE
# thetas, one whole 5 local : 1 global period twice).  gemma3-12b-smoke's
# f32 gradients are the least accurate: each package's sits a median
# 2.2e-5 (per leaf, over the leaf's largest element) from the reference's
# float64 gradient at step 0, the port's and the reference's alike, and
# step 3's gradient norms are 1.1e-5 apart from the same state; it is
# held at 2e-5, the others at 1e-5.  The families that train through
# kernel #1 (``_LutExp``, its plain backward on the CPU): granite-moe's
# router softmax, falcon-mamba's Ā and zamba2's Mamba-2 decays (with its
# shared attention block).  Each starts every step from the reference's
# checkpoint as the gemmas do: run free, they part after AdamW's first
# updates (measured: two of the three runs' step-3 gradient norms 6.8e-5
# and 2.0e-3 apart).
TWINS = {"deepseek-7b-smoke": ({}, True, 1e-5),
         "gemma2-9b-smoke": (dict(head_dim=256), False, 1e-5),
         "gemma3-12b-smoke": ({}, False, 2e-5),
         "granite-moe-3b-a800m-smoke": ({}, False, 1e-5),
         "falcon-mamba-7b-smoke": ({}, False, 1e-5),
         "zamba2-1.2b-smoke": ({}, False, 1e-5)}


@pytest.mark.parametrize("arch", list(TWINS))
def test_trainer_matches_reference_from_its_checkpoint(tmp_path, arch):
    """The port's ``Trainer`` against the reference's over 4 f32 steps
    (module docstring).  deepseek-7b-smoke: the port resumes the
    reference's step-0 checkpoint and runs free beside it.  The gemmas:
    each step starts from the reference's checkpoint of that step.  Their
    free runs part by more than 1e-5 after the second update because
    AdamW's first moves turn f32 noise into whole steps: a few gradient
    elements of ~1e-7 (the largest ~1e-2) come out with opposite signs in
    the two frameworks (the port's nearer a float64 gradient), and each
    moves its weight by about ±lr (measured, gemma3-12b-smoke: step 3's
    loss 6.8e-5 apart, its gradient norm 7.1e-3).  Alone, one intra-op
    thread: deepseek-7b-smoke ~9 s, gemma2-9b-smoke ~8 s,
    gemma3-12b-smoke ~16 s; granite-moe-3b-a800m-smoke, falcon-mamba-7b-
    smoke and zamba2-1.2b-smoke ~33 s together."""
    over, free, rtol = TWINS[arch]
    kw = dict(steps=4, ckpt_dir=str(tmp_path), ckpt_every=100, lr=5e-3,
              warmup=2)
    jcfg = j_get_config(arch).replace(dtype="float32", **over)
    jtr = JTrainer(jcfg, JDataConfig(vocab_size=jcfg.vocab_size, seq_len=24,
                                     global_batch=4),
                   JTrainConfig(**kw) if free else JTrainConfig(
                       **dict(kw, ckpt_every=1, keep_ckpts=5)))
    jtr.init()
    jtr.save()
    jtr.ckpt.wait()
    tcfg = get_config(arch).replace(dtype="float32", **over)
    tkw = {k: v for k, v in kw.items() if k != "ckpt_dir"}
    if free:
        ttr = mk_trainer(tmp_path, tcfg, **tkw)
        got = ttr.run()                          # auto-resumes step 0
        want = jtr.run()
    else:
        want = jtr.run()                         # a checkpoint every step
        jtr.ckpt.wait()
        got = []
        for step in range(4):                # each from a copy of its state
            name = f"step_{step:08d}"
            shutil.copytree(tmp_path / name, tmp_path / f"port{step}" / name)
            ttr = mk_trainer(tmp_path / f"port{step}", tcfg, **tkw)
            ttr.restore(step=step)
            got += ttr.run(num_steps=1)      # ... and writes step + 1 there
    assert [m["step"] for m in got] == [m["step"] for m in want] == [0, 1, 2, 3]
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in got],
                                   [m[key] for m in want], rtol=rtol,
                                   err_msg=key)
    # the port wrote step 4 last (after the reference's own step 4): the
    # reference restores it onto its tree
    ttr.save()
    ttr.ckpt.wait()
    if not free:
        shutil.rmtree(tmp_path / "step_00000004")
        shutil.copytree(tmp_path / "port3" / "step_00000004",
                        tmp_path / "step_00000004")
    jtr.restore(step=4)
    assert jtr.step == 4
    np.testing.assert_allclose(
        np.asarray(jtr.params["embed"]["tokens"]),
        ttr.params["embed"].numpy(), rtol=0, atol=0)


def test_loss_decreases(tmp_path):
    tr = mk_trainer(tmp_path, steps=10)
    m = tr.run()
    assert m[-1]["loss"] < m[0]["loss"]


def test_failure_recovery_bitexact(tmp_path):
    ma = mk_trainer(tmp_path / "a").run()
    mb = mk_trainer(tmp_path / "b").run(
        injector=FailureInjector(fail_at_steps=(4, 6)))
    la = {m["step"]: m["loss"] for m in ma}
    lb = {m["step"]: m["loss"] for m in mb}
    assert max(abs(la[s] - lb[s]) for s in la) == 0.0


def test_auto_resume_from_checkpoint(tmp_path):
    mk_trainer(tmp_path, steps=6).run()
    tr2 = mk_trainer(tmp_path, steps=10)
    m = tr2.run()
    assert tr2.step == 10
    assert m[0]["step"] >= 6


def test_unrecoverable_without_ckpt():
    tr = mk_trainer(None)
    with pytest.raises(Exception):
        tr.run(injector=FailureInjector(fail_at_steps=(2,)))


def test_straggler_logging(tmp_path):
    tr = mk_trainer(tmp_path, steps=4, straggler_timeout_ms=0.0001,
                    skip_straggler_steps=False)
    tr.run()
    assert len(tr.straggler_log) > 0      # every CPU step exceeds 0.1 µs


def test_straggler_steps_skipped(tmp_path):
    tr = mk_trainer(tmp_path, steps=3, straggler_timeout_ms=0.0001,
                    skip_straggler_steps=True)
    tr.run()
    assert tr.metrics == [] and tr.step == 3
    assert int(tr.opt_state.step) == 0    # no update was applied


def test_compressed_grads_still_learn(tmp_path):
    tr = mk_trainer(tmp_path, steps=10, compress_grads=True)
    m = tr.run()
    assert m[-1]["loss"] < m[0]["loss"]
    assert tr.residual is not None        # error-feedback state exists


def test_error_feedback_accumulates():
    g = {"w": torch.full((4,), 1e-4, dtype=torch.float32)}
    r = feedback_init(g)
    total = torch.zeros((4,))
    for _ in range(50):
        sent, r = compress_with_feedback(g, r)
        total = total + sent["w"].float()
    np.testing.assert_allclose(total.numpy(), 50e-4, rtol=0.05)


def test_compress_with_feedback_matches_reference_bits():
    from repro.parallel import compress_with_feedback as j_comp
    rng = np.random.default_rng(0)
    g = rng.normal(size=(5, 7)).astype(np.float32)
    r = (rng.normal(size=(5, 7)) * 1e-3).astype(np.float32)
    js, jr = j_comp({"w": jnp.asarray(g)}, {"w": jnp.asarray(r)})
    ts, tr = compress_with_feedback({"w": torch.from_numpy(g)},
                                    {"w": torch.from_numpy(r)})
    assert ts["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ts["w"].view(torch.int16).numpy(),
        np.asarray(js["w"]).view(np.int16))
    np.testing.assert_array_equal(tr["w"].numpy(), np.asarray(jr["w"]))


def test_train_cli_on_cpu(tmp_path, capsys):
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "3",
                    "--seq-len", "16", "--global-batch", "2",
                    "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "final loss" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]


@pytest.mark.parametrize("flag", ["--mesh", "--distributed"])
def test_train_cli_refuses_mesh(flag, tmp_path, capsys, monkeypatch):
    """``--mesh`` in one process trains on a 1-rank mesh, the same run as
    without it; ``--distributed`` without ``torchrun``'s environment fails
    with a message that names ``torchrun``."""
    argv = ["--arch", ARCH, "--device", "cpu", "--steps", "2",
            "--seq-len", "16", "--global-batch", "2"]
    if flag == "--distributed":
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(RuntimeError, match="torchrun"):
            train_cli.main(argv + [flag])
        return
    train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "mesh"), flag])
    meshed = capsys.readouterr().out
    train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    one = capsys.readouterr().out
    loss = [ln.split("loss")[1].split()[0] for ln in meshed.splitlines()
            if ln.startswith("step")]
    assert len(loss) == 2 and loss == [
        ln.split("loss")[1].split()[0] for ln in one.splitlines()
        if ln.startswith("step")]
    assert sorted(os.listdir(tmp_path / "mesh")) == ["step_00000002"]


def test_trainer_refuses_mesh_and_defaults_to_card(monkeypatch, tmp_path):
    """A mesh of several ranks needs a process group of that many (a
    layout-only mesh, or an int, raises ``ValueError`` naming ``spawn``);
    a 1-rank mesh trains, and ``restore(mesh=)`` re-cuts a single-device
    checkpoint onto it, bit for bit; the card is the default device."""
    from repro_torch.launch.mesh import Mesh
    cfg = get_config(ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(ValueError, match="spawn"):
        Trainer(cfg, dcfg, mesh=Mesh((1, 2), ("data", "model")),
                device="cpu")
    with pytest.raises(ValueError, match="spawn"):
        Trainer(cfg, dcfg, mesh=2, device="cpu")
    tr = mk_trainer(tmp_path, steps=2)
    tr.run()
    one = mk_trainer(tmp_path, steps=2)
    one.restore(mesh=Mesh((1, 1), ("data", "model")))
    assert one.mesh.size == 1 and one.step == 2
    for k, p in tr.params.items():
        assert torch.equal(one.params[k], p), k
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, dcfg)
