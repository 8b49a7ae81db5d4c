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
leaf paths (``params.to_flat``), so each package resumes the other's.

**On a mesh** (``mesh=``: a ``launch/mesh.py::Mesh`` over every rank of
the running process group, or an int N for N ranks on the model axis)
every rank runs the same ``Trainer`` (SPMD):

- *placement*: ``init`` draws the full parameters from the seed as one
  device does, then each rank keeps its block of every leaf under the
  reference's rules (``parallel.sharding.port_param_specs``), and so do
  the moments and the residual (ZeRO-3 storage);
- *data*: each rank takes its block of the global batch, the
  ``(pod, data)`` axes' row-major index of ``num_shards`` = their
  product;
- *forward*: each split leaf is all-gathered at the start of the loss
  (``collectives.gather_grad``); each layer whose KV heads divide the
  model axis attends this rank's band of the heads, and one all-gather
  rebuilds the head axis before ``wo`` (``layers.attn_apply``); the rest
  runs whole on every rank of the model axis;
- *gradients*: the model axis' ranks compute the same loss, so each
  holds the whole gradient (the band's backward all-gathers the bands'
  gradients) and keeps its block of it; over the data-parallel axes each
  rank's loss (its rows' mean, ``cross_entropy(dp_axes=)``) is scaled by
  1/ranks, an all-gather's backward sums the ranks' gradients and keeps
  the block (a reduce-scatter), and after ``backward`` a leaf those axes
  do not split is summed over them (all-reduce), in sorted key order;
  the MoE load-balancing statistics are summed over them first;
- *clipping* sees the global norm: each leaf's block sum of squares is
  summed over the axes that split it, a replicated leaf counted once;
  AdamW and the error feedback run on the blocks (elementwise);
- *checkpoints* stay in the reference's sharding-independent format:
  every rank gathers its blocks into full leaves, rank 0 writes, and
  every rank waits on a barrier after ``AsyncCheckpointer.wait()`` so
  that ``latest_step`` agrees; ``restore(mesh=)`` re-cuts the full leaves
  for the given mesh (the elastic re-shard: a checkpoint written at one
  mesh, or on one device, resumes at another);
- *failures and stragglers*: the injector fires on every rank at the
  same step and every rank restores; the step time is the maximum over
  the ranks, so every rank makes the same straggler decision.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

import torch.distributed as dist

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ModelConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import LAUNCH_HINT, Mesh, world_size
from repro_torch.models import build_model
from repro_torch.models.lm import layer_keys
from repro_torch.models.moe import _group_size
from repro_torch.optim import (AdamWConfig, AdamWState, accumulated_grads,
                               adamw_init, adamw_update, cosine_schedule,
                               global_norm)
from repro_torch.parallel import (compress_with_feedback, feedback_init,
                                  param_specs, shard_tree)
from repro_torch.parallel.collectives import all_reduce, gather_grad
from repro_torch.parallel.sharding import (gather_tree, port_param_specs,
                                           sharding_of)
from repro_torch.params import from_flat, to_flat

# the axes whose ranks hold the batch's other rows, outermost first
_DP_AXES = ("pod", "data")


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


def resolve_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` as the trainer takes it: None (one device), an int N (a
    ("data", "model") mesh of world / N × N over the running group), or a
    ``Mesh``, which must cover every rank of the running group (a mesh
    of several ranks needs one: ``ValueError`` otherwise)."""
    if mesh is None:
        return None
    n = world_size()
    if isinstance(mesh, int):
        if mesh < 1 or n % mesh:
            raise ValueError(f"a model axis of {mesh} ranks does not split "
                             f"the {n} ranks of the running group: "
                             f"{LAUNCH_HINT}")
        return Mesh((n // mesh, mesh), ("data", "model"))
    if mesh.size != n or (mesh.size > 1 and mesh.group is None):
        raise ValueError(f"a training mesh of shape {dict(mesh.shape)} "
                         f"must cover the running group of {n} rank(s): "
                         f"{LAUNCH_HINT}")
    return mesh


class Trainer:
    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 train_cfg: TrainConfig = TrainConfig(), mesh=None,
                 device: DeviceLike = None):
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
        self.mesh: Optional[Mesh] = None
        self._set_mesh(resolve_mesh(mesh))

    # ------------------------------------------------------------------ mesh
    def _set_mesh(self, mesh: Optional[Mesh]) -> None:
        """Lay the state out on ``mesh`` (None: one device): its axes, the
        data-parallel shard of this rank, each leaf's spec."""
        self.mesh = mesh
        if mesh is None:
            return
        self.dp_axes = tuple(mesh.axis(a) for a in _DP_AXES
                             if a in mesh.axis_names)
        self.tp_axis = (mesh.axis("model") if "model" in mesh.axis_names
                        else None)
        self.n_dp, self.dp_index = 1, 0
        for a in self.dp_axes:
            self.n_dp, self.dp_index = (self.n_dp * a.size,
                                        self.dp_index * a.size + a.index)
        gb = self.pipeline.cfg.global_batch
        if gb % self.n_dp:
            raise ValueError(f"a global batch of {gb} rows does not split "
                             f"over {self.n_dp} data-parallel ranks")
        mc = self.model_cfg
        if mc.family == "moe":
            # routing over the global batch's groups, or not at all
            seq = self.pipeline.cfg.seq_len
            whole = _group_size(mc, gb * seq)
            part = _group_size(mc, gb // self.n_dp * seq)
            if whole != part:
                raise ValueError(
                    f"MoE dispatch groups: the global batch of {gb} × {seq} "
                    f"tokens routes in groups of {whole}, a rank's "
                    f"{gb // self.n_dp} × {seq} in groups of {part}; a "
                    f"data-parallel split of {self.n_dp} would route "
                    f"differently")
        self.specs = None          # per port key, set with the parameters

    def _layout(self, full: Dict[str, torch.Tensor]) -> None:
        """Each key's spec (from the full leaves' shapes, real or ``meta``)
        and the mesh axes that split it."""
        self.specs = port_param_specs(full, self.model_cfg, self.mesh)
        self.split_axes = {
            k: tuple(sorted(a for axes, _ in sharding_of(
                s, self.mesh).values() for a in axes))
            for k, s in self.specs.items()}

    def _full(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return gather_tree(tree, self.specs, self.mesh)

    # ------------------------------------------------------------------ init
    def init(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.params = self.model.init(gen, self.device)
        if self.mesh is not None:
            self._layout(self.params)
            self.params = shard_tree(self.params, self.specs, self.mesh)
        self.opt_state = adamw_init(self.params, self.opt_cfg)
        if self.cfg.compress_grads:
            self.residual = feedback_init(self.params)
        self.step = 0

    # ------------------------------------------------------------------ step
    def _mesh_loss(self, blocks, batch):
        """This rank's term of the objective: every split leaf gathered
        (the model axis keeps its block of the gradient, the data axes sum
        theirs), the loss on this rank's rows with the head band, over the
        data-parallel ranks' count."""
        full = {}
        for k in sorted(blocks):
            x = blocks[k]
            for dim, (axes, _) in sharding_of(self.specs[k],
                                              self.mesh).items():
                for a in reversed(axes):
                    x = gather_grad(x, self.mesh.axis(a), dim,
                                    sum_grads=a in _DP_AXES)
            full[k] = x
        loss, aux = self.model.loss(full, batch, tp_axis=self.tp_axis,
                                    dp_axes=self.dp_axes)
        return loss / self.n_dp, aux

    def _mesh_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of a tree of blocks: each block's sum of squares
        summed over the axes that split its leaf (one all-reduce a group
        of keys split alike), the leaves in sorted key order."""
        keys = sorted(grads)
        sq = {k: torch.sum(torch.square(grads[k].float())) for k in keys}
        for axes in sorted({self.split_axes[k] for k in keys}):
            ks = [k for k in keys if self.split_axes[k] == axes]
            if not axes:
                continue
            v = torch.stack([sq[k] for k in ks])
            for a in axes:
                v = all_reduce(v, "sum", self.mesh.axis(a))
            sq.update(zip(ks, v.unbind()))
        return torch.sqrt(torch.sum(torch.stack([sq[k] for k in keys])))

    def _train_step(self, params, opt_state, residual, batch, step):
        cfg = self.cfg
        if self.mesh is None:
            loss, grads, _ = accumulated_grads(self.model.loss, params, batch,
                                               cfg.microbatches)
            norm_fn = global_norm
        else:
            loss, grads, _ = accumulated_grads(self._mesh_loss, params, batch,
                                               cfg.microbatches)
            for k in sorted(grads):          # the axes that do not split it
                for a in self.dp_axes:
                    if a.name not in self.split_axes[k]:
                        grads[k] = all_reduce(grads[k], "sum", a)
            for a in self.dp_axes:
                loss = all_reduce(loss, "sum", a)
            norm_fn = self._mesh_norm
        if cfg.compress_grads:
            # bf16 on the DP wire; residual carries the rounding error.
            grads, residual = compress_with_feedback(grads, residual)
            grads = {k: g.float() for k, g in grads.items()}
        lr = self.schedule(step)
        streamed = [k for k in layer_keys(self.model_cfg)
                    if k in params and params[k].numel() * 4 > STREAM_LEAF_BYTES]
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             self.opt_cfg, lr=lr,
                                             scan_subtree=streamed,
                                             norm_fn=norm_fn)
        return params, opt_state, residual, {"loss": loss, "lr": lr, **om}

    # ------------------------------------------------------------- ckpt glue
    def _state_tree(self, params=None, opt=None, residual=None
                    ) -> Dict[str, Any]:
        """The state (default: this trainer's) under the reference's leaf
        paths."""
        mc = self.model_cfg
        params = self.params if params is None else params
        opt = self.opt_state if opt is None else opt
        residual = self.residual if residual is None else residual
        t = {"params": to_flat(params, mc),
             "opt": AdamWState(step=opt.step, m=to_flat(opt.m, mc),
                               v=to_flat(opt.v, mc))}
        if residual is not None:
            t["residual"] = to_flat(residual, mc)
        return t

    def save(self) -> None:
        """Write the state as a checkpoint of step ``self.step``.  On a
        mesh every rank gathers its blocks into full leaves (collectives:
        every rank calls this) and rank 0 writes."""
        if not self.ckpt:
            return
        if self.mesh is None:
            tree = self._state_tree()
        else:
            o = self.opt_state
            tree = self._state_tree(
                self._full(self.params),
                AdamWState(o.step, self._full(o.m), self._full(o.v)),
                None if self.residual is None else self._full(self.residual))
            if self.mesh.rank != 0:
                return
        self.ckpt.save(self.step, tree, extra={"step": self.step})

    def _wait(self) -> None:
        """The last checkpoint written (rank 0's writer joined, then a
        barrier), so that every rank reads the same ``latest_step``."""
        if self.ckpt:
            self.ckpt.wait()
        if self.mesh is not None and self.mesh.size > 1:
            dist.barrier(group=self.mesh.group)

    def restore(self, step: Optional[int] = None, mesh=None) -> int:
        """Restore the latest (or the given) checkpoint; with ``mesh``, cut
        for that mesh (the elastic re-shard), else for the trainer's own."""
        assert self.cfg.ckpt_dir
        if self.params is None:
            self.init()
        full_shapes = self._full_meta()
        if mesh is not None:
            self._set_mesh(resolve_mesh(mesh))
        if self.mesh is not None:
            self._layout(full_shapes[0])
        ref = self._state_tree(*full_shapes)
        specs = None
        if self.mesh is not None:
            specs = {"params": param_specs(ref["params"], self.mesh),
                     "opt": AdamWState(step=(),
                                       m=param_specs(ref["opt"].m, self.mesh),
                                       v=param_specs(ref["opt"].v, self.mesh))}
            if "residual" in ref:
                specs["residual"] = param_specs(ref["residual"], self.mesh)
        tree, step, _ = restore(self.cfg.ckpt_dir, ref, step=step,
                                mesh=self.mesh, specs=specs)
        mc, dev = self.model_cfg, self.device
        self.params = from_flat(tree["params"], mc, dev)
        self.opt_state = AdamWState(step=tree["opt"].step.to(dev),
                                    m=from_flat(tree["opt"].m, mc, dev),
                                    v=from_flat(tree["opt"].v, mc, dev))
        self.residual = (from_flat(tree["residual"], mc, dev)
                         if "residual" in tree else None)
        self.step = step
        return step

    def _full_meta(self):
        """(params, opt, residual) as shape-only (``meta``) tensors of the
        full leaves: the template a checkpoint is read onto."""
        def meta(tree):
            if tree is None:
                return None
            out = {}
            for k, x in tree.items():
                shape = list(x.shape)
                if self.mesh is not None:
                    for dim, (_, n) in sharding_of(self.specs[k],
                                                   self.mesh).items():
                        shape[dim] *= n
                out[k] = torch.empty(shape, dtype=x.dtype, device="meta")
            return out
        o = self.opt_state
        return (meta(self.params),
                AdamWState(torch.empty((), dtype=o.step.dtype, device="meta"),
                           meta(o.m), meta(o.v)),
                meta(self.residual))

    # ------------------------------------------------------------------ loop
    def _device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's batch, on a mesh this rank's data-parallel block."""
        shard = ((0, 1) if self.mesh is None
                 else (self.dp_index, self.n_dp))
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipeline.shard_batch(step, *shard).items()}

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
                self._wait()
                self.restore()           # roll back to last durable state
        if self.ckpt:
            self.save()
            self._wait()
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
            if self.mesh is not None and self.mesh.size > 1:
                # one straggler decision for every rank: the slowest's time
                dt_ms = float(all_reduce(
                    torch.tensor(dt_ms, dtype=torch.float64), "max", None))
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
