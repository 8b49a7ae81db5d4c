"""AdamW + schedules + clipping + gradient accumulation (port of
``src/repro/optim/adamw.py``).

The tree is the port's flat ``{key: tensor}`` parameter dict
(``repro_torch.params``); the optimizer state mirrors it key for key.
The casts follow the reference line by line: the moments live in
``moment_dtype``, every update is computed in f32 and cast back to the
leaf's dtype once.  The reference returns new trees; so does the port
(the trainer rebinds its dicts), so a step never writes a tensor that a
checkpoint snapshot or a caller still reads.

``moment_dtype="bfloat16"`` halves optimizer memory; the error it adds is
bounded by bf16's 8 mantissa bits on the *moments*, not the weights.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Params                # first moment (param-shaped dict)
    v: Params                # second moment


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    moment_dtype: str = "float32"        # float32 | bfloat16


def adamw_init(params: Params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype`` beside each leaf, step 0."""
    dt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=dt, device=p.device)
             for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v={k: torch.zeros_like(z)
                                  for k, z in zeros.items()})


def global_norm(tree: Params) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), each leaf's sum in f32, the leaves in
    sorted key order (as ``jax.tree.leaves`` walks a dict)."""
    leaves = [torch.sum(torch.square(tree[k].float())) for k in sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Params, max_norm: float,
                        norm_fn: Callable[[Params], torch.Tensor] = global_norm
                        ) -> Tuple[Params, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / ``norm_fn(grads)``) → (the
    scaled gradients, the norm).  ``norm_fn``: a sharded tree's global
    norm (``runtime/trainer.py`` on a mesh)."""
    norm = norm_fn(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


def _update_leaf(cfg: AdamWConfig, p, g, m, v, c1, c2, lr):
    """One leaf's (p, m, v) → (p', m', v'), the reference's ``upd_tree``."""
    gf = g.float()
    new_m = (cfg.b1 * m.float() + (1 - cfg.b1) * gf).to(m.dtype)
    new_v = (cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(gf)).to(v.dtype)
    mh = new_m.float() / c1
    vh = new_v.float() / c2
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), new_m, new_v


def adamw_update(grads: Params, state: AdamWState, params: Params,
                 cfg: AdamWConfig, lr=None,
                 scan_subtree: Optional[Iterable[str]] = None,
                 norm_fn: Callable[[Params], torch.Tensor] = global_norm
                 ) -> Tuple[Params, AdamWState, dict]:
    """One AdamW step → (params', state', {"grad_norm"}).  ``lr`` (a float
    or a 0-d f32 tensor) overrides ``cfg.lr`` (schedules).

    ``scan_subtree`` names the keys whose leaves are stacked on dim 0 (the
    port's per-layer leaves, ``models.lm.layer_keys``): their update is
    streamed one layer slice at a time into the new leaf, so the f32
    temporaries are one slice instead of the whole stack, as the
    reference's ``lax.scan`` over its ``scan_subtree``.  The update is
    elementwise, so streamed and whole-leaf results are the same bits.
    ``norm_fn`` computes the gradients' global norm (clipping and the
    reported ``grad_norm``): a mesh's trees are blocks.
    """
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, norm_fn)
    else:
        gnorm = norm_fn(grads)
    lr = cfg.lr if lr is None else lr
    step = state.step + 1
    c1 = 1.0 - cfg.b1 ** step.float()
    c2 = 1.0 - cfg.b2 ** step.float()
    stacked = set(scan_subtree or ()) & set(params)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        args = (p, grads[k], state.m[k], state.v[k])
        if k in stacked:
            outs = [torch.empty_like(a) for a in (p, state.m[k], state.v[k])]
            for i in range(p.shape[0]):
                for o, r in zip(outs, _update_leaf(
                        cfg, *(a[i] for a in args), c1, c2, lr)):
                    o[i] = r
            new_p[k], new_m[k], new_v[k] = outs
        else:
            new_p[k], new_m[k], new_v[k] = _update_leaf(cfg, *args, c1, c2,
                                                         lr)
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (a 0-d int tensor) → the f32 learning rate: linear warmup to
    ``base_lr``, then a cosine down to ``final_frac`` of it."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return sched


# --------------------------------------------------------------------------
# gradient accumulation
# --------------------------------------------------------------------------

def accumulated_grads(loss_fn: Callable, params: Params, batch: Any,
                      microbatches: int, accum_dtype: str = "float32"
                      ) -> Tuple[torch.Tensor, Params, Any]:
    """(loss, grads, aux) of ``loss_fn(params, batch) → (loss, aux)``.

    With ``microbatches`` > 1 the batch's dim 0 splits into that many
    equal parts, and the loss and the gradients are their mean: each part's
    gradient scaled by 1/microbatches in f32 and added to an
    ``accum_dtype`` accumulator in order, as the reference's scan does
    (peak activation memory drops by ~microbatches×); aux is the last
    part's.  Gradients of a single batch stay in the leaves' dtypes."""
    keys = list(params)

    def value_and_grad(b):
        leaves = [params[k].detach().requires_grad_() for k in keys]
        loss, aux = loss_fn(dict(zip(keys, leaves)), b)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(keys, grads)), aux

    if microbatches <= 1:
        return value_and_grad(batch)
    acc_dt = getattr(torch, accum_dtype)
    inv = 1.0 / microbatches

    def part(x, i):
        b = x.shape[0]
        assert b % microbatches == 0, (b, microbatches)
        n = b // microbatches
        return x[i * n:(i + 1) * n]

    dev = next(iter(params.values())).device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    acc = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
           for k, p in params.items()}
    aux = None
    for i in range(microbatches):
        loss, grads, aux = value_and_grad({k: part(x, i)
                                           for k, x in batch.items()})
        acc = {k: a + (grads[k].float() * inv).to(a.dtype)
               for k, a in acc.items()}
        loss_sum = loss_sum + loss
    return loss_sum * inv, acc, aux
