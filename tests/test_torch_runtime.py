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
refusals.  One intra-op thread; ~15 s alone."""
import os

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


def test_trainer_matches_reference_from_its_checkpoint(tmp_path):
    kw = dict(steps=4, ckpt_dir=str(tmp_path), ckpt_every=100, lr=5e-3,
              warmup=2)
    jcfg = j_get_config(ARCH).replace(dtype="float32")
    jtr = JTrainer(jcfg, JDataConfig(vocab_size=jcfg.vocab_size, seq_len=24,
                                     global_batch=4), JTrainConfig(**kw))
    jtr.init()
    jtr.save()
    jtr.ckpt.wait()
    ttr = mk_trainer(tmp_path, get_config(ARCH).replace(dtype="float32"),
                     **{k: v for k, v in kw.items() if k != "ckpt_dir"})
    got = ttr.run()                              # auto-resumes step 0
    want = jtr.run()
    assert [m["step"] for m in got] == [m["step"] for m in want] == [0, 1, 2, 3]
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in got],
                                   [m[key] for m in want], rtol=1e-5,
                                   err_msg=key)
    # the port wrote step 4 last (after the reference's own step 4): the
    # reference restores it onto its tree
    ttr.save()
    ttr.ckpt.wait()
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
def test_train_cli_refuses_mesh(flag):
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        train_cli.main(["--arch", ARCH, "--device", "cpu", flag])


def test_trainer_refuses_mesh_and_defaults_to_card(monkeypatch, tmp_path):
    cfg = get_config(ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        Trainer(cfg, dcfg, mesh=object(), device="cpu")
    tr = mk_trainer(tmp_path)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        tr.restore(mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, dcfg)
