"""Fault-tolerant training runtime (port of
``src/repro/runtime/trainer.py``).

The step loop is built from the port's layers:

  data       deterministic (seed, step, shard) batches (``data/``), the
             reference's bit for bit
  parallel   optional bf16 + error-feedback gradient compression
  optim      AdamW (+ cosine schedule, clipping, microbatch accumulation)
  checkpoint step-atomic async saves in the reference's format

The step runs eagerly on ``device`` (the card unless the caller names the
CPU): ``Model.loss`` forward, autograd backward — every attention of the
step on kernel #3 and its backward kernel on the card, every LUT
exponential outside attention (the MoE router, the SSM discretisation) on
kernel #1 and its backward kernel —, the optimizer update into new
tensors (one layer slice at a time for per-layer leaves over
``STREAM_LEAF_BYTES``).  Parameters are drawn by ``params.init_params``
with a ``torch.Generator`` seeded by ``TrainConfig.seed`` (the reference
draws from ``jax.random.PRNGKey(seed)``: other numbers; a twin starts from
the reference's checkpoint instead).

Fault-tolerance contract (the reference's, held by
``tests/test_torch_runtime.py``):
- every step is **idempotent**: (params, opt, step) → (params', opt') with
  the batch a pure function of step, so replay after a restore is exact;
- ``FailureInjector`` raises at configured steps; the loop restores the
  latest checkpoint and resumes — losses after recovery equal an
  uninterrupted run bit for bit (on the card too: no backward of the path
  sums with float atomics);
- **auto-resume**: ``run`` on a directory with a checkpoint restores it;
- **bounded staleness**: a step over ``straggler_timeout_ms`` is logged
  and, with ``skip_straggler_steps``, its update dropped.

Checkpoints hold ``{"params", "opt", "residual"}`` under the reference's
leaf paths (``params.to_flat``), so each package resumes the other's.  A
``mesh`` (the elastic re-shard) comes with the training half of
tensor parallelism (ROADMAP.md §1 item 5), after tensor-parallel serving.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ModelConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.models.lm import layer_keys
from repro_torch.optim import (AdamWConfig, AdamWState, accumulated_grads,
                               adamw_init, adamw_update, cosine_schedule)
from repro_torch.parallel import compress_with_feedback, feedback_init
from repro_torch.params import from_flat, to_flat

_MESH = ("a mesh (the elastic re-shard) comes with the training half of "
         "the tensor-parallel slice of the PyTorch port (ROADMAP.md §1 "
         "item 5)")


class SimulatedFailure(RuntimeError):
    """A stand-in for a preempted/lost node in single-process tests."""


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: Tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1
    moment_dtype: str = "float32"
    compress_grads: bool = False          # bf16 + error feedback
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    seed: int = 0
    log_every: int = 10
    straggler_timeout_ms: float = 0.0     # 0 = disabled
    skip_straggler_steps: bool = False


# A per-layer leaf (stacked on dim 0) whose f32 copy is larger than this is
# updated one layer slice at a time (``adamw_update``'s ``scan_subtree``:
# the same bits, the f32 temporaries of one slice): granite-moe's expert
# stacks, 1.0 B values each, would otherwise need ~20 GB of them at once.
STREAM_LEAF_BYTES = 1 << 30


class Trainer:
    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 train_cfg: TrainConfig = TrainConfig(), mesh=None,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(f"Trainer(mesh=): {_MESH}")
        self.device = resolve_device(device)
        self.cfg = train_cfg
        self.model_cfg = model_cfg
        self.model = build_model(model_cfg)
        self.pipeline = TokenPipeline(data_cfg)
        self.opt_cfg = AdamWConfig(
            lr=train_cfg.lr, weight_decay=train_cfg.weight_decay,
            grad_clip=train_cfg.grad_clip, moment_dtype=train_cfg.moment_dtype)
        self.schedule = cosine_schedule(train_cfg.lr, train_cfg.warmup,
                                        train_cfg.steps)
        self.ckpt = (AsyncCheckpointer(train_cfg.ckpt_dir,
                                       keep=train_cfg.keep_ckpts)
                     if train_cfg.ckpt_dir else None)
        self.step = 0
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.opt_state: Optional[AdamWState] = None
        self.residual: Optional[Dict[str, torch.Tensor]] = None
        self.metrics: list = []
        self.straggler_log: list = []

    # ------------------------------------------------------------------ init
    def init(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.params = self.model.init(gen, self.device)
        self.opt_state = adamw_init(self.params, self.opt_cfg)
        if self.cfg.compress_grads:
            self.residual = feedback_init(self.params)
        self.step = 0

    # ------------------------------------------------------------------ step
    def _train_step(self, params, opt_state, residual, batch, step):
        cfg = self.cfg
        loss, grads, _ = accumulated_grads(self.model.loss, params, batch,
                                           cfg.microbatches)
        if cfg.compress_grads:
            # bf16 on the DP wire; residual carries the rounding error.
            grads, residual = compress_with_feedback(grads, residual)
            grads = {k: g.float() for k, g in grads.items()}
        lr = self.schedule(step)
        streamed = [k for k in layer_keys(self.model_cfg)
                    if k in params and params[k].numel() * 4 > STREAM_LEAF_BYTES]
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             self.opt_cfg, lr=lr,
                                             scan_subtree=streamed)
        return params, opt_state, residual, {"loss": loss, "lr": lr, **om}

    # ------------------------------------------------------------- ckpt glue
    def _state_tree(self) -> Dict[str, Any]:
        """The state under the reference's leaf paths."""
        mc = self.model_cfg
        t = {"params": to_flat(self.params, mc),
             "opt": AdamWState(step=self.opt_state.step,
                               m=to_flat(self.opt_state.m, mc),
                               v=to_flat(self.opt_state.v, mc))}
        if self.residual is not None:
            t["residual"] = to_flat(self.residual, mc)
        return t

    def save(self) -> None:
        if self.ckpt:
            self.ckpt.save(self.step, self._state_tree(),
                           extra={"step": self.step})

    def restore(self, step: Optional[int] = None, mesh=None) -> int:
        """Restore the latest (or the given) checkpoint."""
        if mesh is not None:
            raise NotImplementedError(f"Trainer.restore(mesh=): {_MESH}")
        assert self.cfg.ckpt_dir
        if self.params is None:
            self.init()
        tree, step, _ = restore(self.cfg.ckpt_dir, self._state_tree(),
                                step=step)
        mc, dev = self.model_cfg, self.device
        self.params = from_flat(tree["params"], mc, dev)
        self.opt_state = AdamWState(step=tree["opt"].step,
                                    m=from_flat(tree["opt"].m, mc, dev),
                                    v=from_flat(tree["opt"].v, mc, dev))
        self.residual = (from_flat(tree["residual"], mc, dev)
                         if "residual" in tree else None)
        self.step = step
        return step

    # ------------------------------------------------------------------ loop
    def _device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipeline.shard_batch(step).items()}

    def run(self, num_steps: Optional[int] = None,
            injector: Optional[FailureInjector] = None,
            max_restarts: int = 8) -> list:
        """The fault-tolerant loop: on failure, restore + resume."""
        if self.params is None:
            if self.cfg.ckpt_dir and latest_step(self.cfg.ckpt_dir) is not None:
                self.restore()           # auto-resume
            else:
                self.init()
        target = self.cfg.steps if num_steps is None else self.step + num_steps
        restarts = 0
        while self.step < target:
            try:
                self._run_until(target, injector)
            except SimulatedFailure:
                restarts += 1
                if restarts > max_restarts or not self.cfg.ckpt_dir:
                    raise
                if self.ckpt:
                    self.ckpt.wait()
                self.restore()           # roll back to last durable state
        if self.ckpt:
            self.save()
            self.ckpt.wait()
        return self.metrics

    def _run_until(self, target: int, injector: Optional[FailureInjector]):
        while self.step < target:
            if injector is not None:
                injector.check(self.step)
            t0 = time.perf_counter()
            batch = self._device_batch(self.step)
            out = self._train_step(self.params, self.opt_state, self.residual,
                                   batch, torch.tensor(self.step,
                                                       dtype=torch.int32,
                                                       device=self.device))
            params, opt_state, residual, metrics = out
            m = {k: float(v) for k, v in metrics.items()}   # waits for the step
            dt_ms = (time.perf_counter() - t0) * 1e3
            if (self.cfg.straggler_timeout_ms
                    and dt_ms > self.cfg.straggler_timeout_ms):
                self.straggler_log.append((self.step, dt_ms))
                if self.cfg.skip_straggler_steps:
                    self.step += 1       # bounded staleness: drop the update
                    continue
            self.params, self.opt_state, self.residual = (params, opt_state,
                                                          residual)
            m["step"], m["ms"] = self.step, dt_ms
            self.metrics.append(m)
            self.step += 1
            if self.ckpt and self.step % self.cfg.ckpt_every == 0:
                self.save()
        return self.metrics
