"""Collectives over one mesh axis, the port's counterparts of the
reference's ``jax.lax`` collectives inside ``shard_map``:

  ``all_gather``     ← ``lax.all_gather(x, axis, axis=dim, tiled=True)``
  ``all_reduce``     ← ``lax.pmax`` / ``lax.psum``
  ``reduce_scatter`` ← ``lax.psum_scatter(x, axis, scatter_dimension=dim,
                       tiled=True)``
  ``exchange``       ← one ``lax.ppermute`` hop (send to one rank, receive
                       from another)
  ``axis_size`` / ``axis_index`` ← ``compat.axis_size`` / ``lax.axis_index``

and the forms that autograd passes through, for a training step that
runs SPMD over the ranks (``runtime/trainer.py``):

  ``gather_grad``     all-gather; backward: the sum over the axis of every
                      rank's gradient, this rank's block kept (a
                      reduce-scatter), or with ``sum_grads=False`` this
                      rank's block of its own gradient (the axis' ranks
                      hold the same gradient: they computed the same loss)
  ``band``            this rank's block of a tensor every rank of the
                      axis holds; backward: the blocks' gradients
                      all-gathered (the conjugate of ``gather_grad(...,
                      sum_grads=False)``)
  ``all_reduce_grad`` a sum over the axis; backward: the sum over the axis
                      of the gradients (each rank's loss is a term of the
                      objective: its adjoint)

(``parallel/pipeline.py`` sends a pipeline's gradients back along the
inverse hops itself.)

An axis is a ``launch/mesh.py::MeshAxis`` (``mesh.axis("model")``) or a
``torch.distributed`` process group (``None``: the default group).

Gloo is the backend: its ``all_gather`` and ``all_reduce`` take CUDA
tensors (staged through the host inside gloo), its ``send`` / ``recv``
only CPU tensors, so :func:`exchange` stages a CUDA tensor through a host
copy itself.  :func:`reduce_scatter` is an ``all_reduce`` followed by this
rank's slice of the sums, on every device.  None of these can run inside
a CUDA graph.

``TRAFFIC`` counts what passed through each wrapper since the last
:func:`reset_traffic`: calls, and the bytes this rank *received* (an
all-gather receives every other rank's block; an all-reduce, and a
reduce-scatter (an all-reduce and a slice), is counted at the size of its
operand, a hop at the block received).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

TRAFFIC: Dict[str, int] = {}


def reset_traffic() -> None:
    for k in ("all_gather_calls", "all_gather_bytes", "all_reduce_calls",
              "all_reduce_bytes", "reduce_scatter_calls",
              "reduce_scatter_bytes", "exchange_calls", "exchange_bytes"):
        TRAFFIC[k] = 0


reset_traffic()


def _resolve(axis) -> Tuple[object, int, int, Tuple[int, ...]]:
    """axis → (process group, size, this rank's index, global ranks)."""
    if hasattr(axis, "ranks"):                      # a MeshAxis
        if axis.size > 1 and axis.group is None:
            from repro_torch.launch.mesh import LAUNCH_HINT
            raise RuntimeError(f"mesh axis {axis.name!r} has no process "
                               f"group: {LAUNCH_HINT}")
        return axis.group, axis.size, axis.index, axis.ranks
    if not (dist.is_available() and dist.is_initialized()):
        from repro_torch.launch.mesh import LAUNCH_HINT
        raise RuntimeError(f"no process group is initialised: {LAUNCH_HINT}")
    g = axis if axis is not None else dist.group.WORLD
    n = dist.get_world_size(g)
    ranks = tuple(dist.get_global_rank(g, i) for i in range(n))
    return g, n, dist.get_rank(g), ranks


def axis_size(axis) -> int:
    return _resolve(axis)[1]


def axis_index(axis) -> int:
    return _resolve(axis)[2]


def all_gather(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in axis order (tiled)."""
    g, n, _, _ = _resolve(axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=g)
    TRAFFIC["all_gather_calls"] += 1
    TRAFFIC["all_gather_bytes"] += x.numel() * x.element_size() * (n - 1)
    return torch.cat(parts, dim=dim)


_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}


def all_reduce(x: torch.Tensor, op: str, axis) -> torch.Tensor:
    """``op`` ("max" | "sum") of every rank's ``x``, on every rank (a new
    tensor; ``x`` is left as it was)."""
    g, n, _, _ = _resolve(axis)
    if n == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=_OPS[op], group=g)
    TRAFFIC["all_reduce_calls"] += 1
    TRAFFIC["all_reduce_bytes"] += y.numel() * y.element_size()
    return y


def reduce_scatter(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """The sum of every rank's ``x`` over the axis, cut into the axis'
    blocks on ``dim`` → this rank's block (``dim`` must divide)."""
    g, n, me, _ = _resolve(axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split into {n} blocks")
    blk = x.shape[dim] // n
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g)
    out = y.narrow(dim, me * blk, blk)
    TRAFFIC["reduce_scatter_calls"] += 1
    TRAFFIC["reduce_scatter_bytes"] += y.numel() * y.element_size()
    return out.contiguous()


def exchange(x: torch.Tensor, axis, send_to: int,
             recv_from: int) -> torch.Tensor:
    """One hop of a permutation: send ``x`` to axis index ``send_to`` and
    return the block received from axis index ``recv_from`` (same shape
    and dtype).  Both transfers are posted together, so a pairwise swap
    (``send_to == recv_from``) and a ring shift cannot deadlock.  A CUDA
    tensor travels through a host copy (gloo's point-to-point is CPU
    only)."""
    g, n, me, ranks = _resolve(axis)
    if n == 1 or (send_to == me and recv_from == me):
        return x
    host = x.detach().to("cpu").contiguous()
    out = torch.empty_like(host)
    ops = [dist.P2POp(dist.isend, host, ranks[send_to], group=g),
           dist.P2POp(dist.irecv, out, ranks[recv_from], group=g)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    TRAFFIC["exchange_calls"] += 1
    TRAFFIC["exchange_bytes"] += out.numel() * out.element_size()
    return out.to(x.device)


# --------------------------------------------------------------------------
# the forms autograd passes through
# --------------------------------------------------------------------------

def _block_of(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    _, n, me, _ = _resolve(axis)
    blk = x.shape[dim] // n
    return x.narrow(dim, me * blk, blk).contiguous()


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, sum_grads):
        ctx.axis, ctx.dim, ctx.sum_grads = axis, dim, sum_grads
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            return reduce_scatter(g, ctx.axis, ctx.dim), None, None, None
        return _block_of(g, ctx.axis, ctx.dim), None, None, None


class _Band(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _block_of(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim), None, None


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce(x, "sum", axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.axis), None


def gather_grad(x: torch.Tensor, axis, dim: int = 0,
                sum_grads: bool = True) -> torch.Tensor:
    """:func:`all_gather` under autograd.  Backward: with ``sum_grads``
    the gradients of every rank summed over the axis and this rank's block
    kept (:func:`reduce_scatter`); without, this rank's block of its own
    gradient."""
    if axis_size(axis) == 1:
        return x
    return _GatherGrad.apply(x, axis, dim, sum_grads)


def band(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` (held whole by every rank of the axis)
    on ``dim``; backward: the blocks' gradients all-gathered, so every
    rank holds the whole gradient."""
    if axis_size(axis) == 1:
        return x
    return _Band.apply(x, axis, dim)


def all_reduce_grad(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum over the axis under autograd; backward: the gradients summed
    over the axis."""
    if axis_size(axis) == 1:
        return x
    return _AllReduceGrad.apply(x, axis)
