"""Pipeline parallelism: the GPipe stage schedule over a mesh axis (port
of ``src/repro/parallel/pipeline.py``).

This is HASTILY §IV's *inter-layer* fine-grained pipelining in mesh form:
encoder N's first output feeds encoder N+1 at once.  On a mesh "vector"
becomes "microbatch" and "encoder" becomes "stage": each rank along
``axis`` holds one stage's layers, and microbatches flow through the ring
of stages.  For M microbatches and S stages the bubble fraction is
(S−1)/(M+S−1), the paper's (N+1)·seqLen fill cost.

The port runs the schedule SPMD over the axis' ranks: stage s (the rank
at index s) runs microbatch t − s at step t, so the loop takes M + S − 1
steps; stage 0 takes each fresh microbatch from ``x``, the others the
activation the previous stage sent one hop forward
(``collectives.exchange``); the last stage keeps the finished
microbatches, and a sum over the axis (the others hold zeros) replicates
them.  A step where a stage has no microbatch computes nothing (the
reference computes and discards it).

Under autograd the schedule runs backward in reverse: the gradient of the
replicated output passes through the sum (the loss on it counts once, as
under the reference's ``shard_map``), the last stage starts each
microbatch's gradient, and each step's activation gradient travels the
inverse hop, one stage back.  Every rank makes the same M + S − 2 inverse
hops in the same order, whether or not its hop carries a gradient that
reaches a loss (a hop whose received value no stage reads would otherwise
take no part in backward on one rank and wait forever on the other).
Each stage ends with the gradient of its own slice of the parameters,
and every rank with the gradient of ``x`` (stage 0 pulls it back through
its stage; a sum over the axis, the others holding zeros, replicates it,
as ``x`` is).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from repro_torch.parallel.collectives import all_reduce, exchange

Params = Any


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flatten(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _unflatten(paths, leaves) -> Any:
    if paths == [()]:
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


class _Schedule:
    """One pipeline call on this rank: the forward schedule, and its
    reverse for autograd."""

    def __init__(self, stage_fn, ax, paths, m: int):
        self.stage_fn, self.ax, self.paths, self.m = stage_fn, ax, paths, m
        self.s, self.stage = ax.size, ax.index
        self.nxt = (self.stage + 1) % self.s
        self.prev = (self.stage - 1) % self.s
        self.n_steps = m + self.s - 1

    def params(self, leaves):
        """This stage's slice of every leaf."""
        return _unflatten(self.paths, [a[self.stage] for a in leaves])

    def forward(self, x, leaves, keep: bool, need_dx: bool = False):
        """The schedule → the replicated (M, mb, ...) outputs.  With
        ``keep`` each step's (input, output) graph is kept for
        :meth:`backward`, stage 0's inputs in it with ``need_dx``."""
        self.need_dx = need_dx
        params = self.params(leaves)
        act, outs = torch.zeros_like(x[0]), []
        self.steps = {}
        for t in range(self.n_steps):
            mb = t - self.stage           # the microbatch this stage runs
            if 0 <= mb < self.m:
                inp = x[mb] if self.stage == 0 else act
                if keep:
                    inp = inp.detach().requires_grad_(
                        self.stage > 0 or self.need_dx)
                act = self.stage_fn(params, inp)
                if keep:
                    self.steps[t] = (inp, act)
                    act = act.detach()
                if self.stage == self.s - 1:
                    outs.append(act)      # microbatch t − (S − 1) is done
            if t < self.n_steps - 1:
                act = exchange(act, self.ax, self.nxt, self.prev)
        out = torch.stack(outs) if self.stage == self.s - 1 else torch.zeros(
            (self.m,) + tuple(act.shape), dtype=act.dtype, device=act.device)
        return all_reduce(out, "sum", self.ax)

    def backward(self, g_out, x, leaves):
        """The reverse schedule → (dx, d leaves of this rank's slices); dx
        (stage 0's, the only stage that reads ``x``) on every rank."""
        wrt = [a for a in leaves if a.requires_grad]
        grads = [None] * len(wrt)
        dx = torch.zeros_like(x) if self.need_dx else None
        g_recv = None          # gradient of the value received after step t
        for t in reversed(range(self.n_steps)):
            g = None           # gradient of this stage's value after step t
            if t < self.n_steps - 1:
                send = (g_recv if g_recv is not None
                        else torch.zeros_like(g_out[0]))
                g = exchange(send, self.ax, self.prev, self.nxt)
            done = t - (self.s - 1)
            if self.stage == self.s - 1 and 0 <= done < self.m:
                g = g_out[done] if g is None else g + g_out[done]
            if t in self.steps:
                inp, out = self.steps.pop(t)
                ins = [inp] if inp.requires_grad else []
                got = torch.autograd.grad(out, ins + wrt, g,
                                          allow_unused=True)
                for i, d in enumerate(got[len(ins):]):
                    if d is not None:
                        grads[i] = d if grads[i] is None else grads[i] + d
                if self.stage > 0:
                    g_recv = got[0]
                else:
                    if dx is not None and got[0] is not None:
                        dx[t] = got[0]       # stage 0 runs microbatch t
                    g_recv = None
            else:
                g_recv = g     # no microbatch here: the value passed through
        if dx is not None:
            # ``x`` is replicated: every rank gets stage 0's gradient
            dx = all_reduce(dx, "sum", self.ax)
        it = iter(grads)
        return dx, [next(it) if a.requires_grad else None for a in leaves]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, *leaves):
        ctx.sched = sched
        ctx.save_for_backward(x, *leaves)
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(a.requires_grad)
                      for a in leaves]
            ctx.leaves = leaves
            return sched.forward(x.detach(), leaves, keep=True,
                                 need_dx=ctx.needs_input_grad[1])

    @staticmethod
    def backward(ctx, g):
        x = ctx.saved_tensors[0]
        dx, dl = ctx.sched.backward(g, x, ctx.leaves)
        return (None, dx, *dl)


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stage_params: Params, x: torch.Tensor, mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage pipeline over the mesh axis ``axis``
    (a ``launch/mesh.py::Mesh`` whose ranks all call this).

    ``stage_params``: a dict tree (or one tensor) whose leaves have
    leading dim S (one slice per stage; this rank uses slice ``axis``
    index).  ``x``: (M, mb, ...) microbatches, the same on every rank.
    Returns the (M, mb, ...) outputs on every rank; under autograd
    each rank's gradient reaches its own slice of ``stage_params``, and
    every rank's the whole of ``x``."""
    ax = mesh.axis(axis)
    flat = _flatten(stage_params)
    paths, leaves = [p for p, _ in flat], [a for _, a in flat]
    sched = _Schedule(stage_fn, ax, paths, x.shape[0])
    if torch.is_grad_enabled() and (
            x.requires_grad or any(a.requires_grad for a in leaves)):
        return _Pipeline.apply(sched, x, *leaves)
    return sched.forward(x, leaves, keep=False)


def stack_stages(layer_params: Params, num_stages: int) -> Params:
    """Regroup each leaf's leading layers dim L into (S, L/S) stage
    slices."""
    def regroup(a):
        n = a.shape[0]
        assert n % num_stages == 0, (n, num_stages)
        return a.reshape((num_stages, n // num_stages) + tuple(a.shape[1:]))
    return _tree_map(regroup, layer_params)
