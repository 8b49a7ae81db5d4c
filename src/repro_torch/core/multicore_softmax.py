"""Multi-core softmax — HASTILY §III-B2 over the ranks of a mesh axis
(port of ``src/repro/core/multicore_softmax.py``).

The paper parallelises the softmax of one long row across CIM *cores*:
each core computes a local maximum and a partial exp-sum, then the
partials are gathered in a **binary tree** (O(log n) depth) through shared
memory.  Here the cores are ranks and the shared memory is the process
group's transport.

* ``sharded_softmax`` — local max / exp / sum, combined with
  ``all_reduce`` (MAX, then SUM).
* ``tree_allreduce`` — a literal recursive-doubling butterfly of pairwise
  exchanges, the paper's Fig. 5 gather, counting its rounds in
  ``COUNTS["tree_rounds"]`` (log₂ n per call).
* ``sharded_softmax_tree`` — ``sharded_softmax`` over the butterfly.

``axis`` is the reduced mesh axis (``mesh.axis("model")``) or a process
group; each rank passes its own slice of the row.  The exponential is
the port's ``lut_exp`` wrapper: kernel #1 on a CUDA tensor, its plain
version on a CPU one.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.lut_exp.ops import lut_exp
from repro_torch.parallel.collectives import (all_reduce, axis_index,
                                              axis_size, exchange)

COUNTS = {"tree_rounds": 0}


def tree_allreduce(x: torch.Tensor, op: Callable, axis) -> torch.Tensor:
    """Recursive-doubling all-reduce — the paper's binary-tree gather.

    log₂(n) rounds; in round i every rank swaps its partial with the rank
    whose index differs in bit i, so after round i it holds the reduction
    over its 2^(i+1)-rank group.  Needs a power-of-two axis.  Each round
    adds one to ``COUNTS["tree_rounds"]``."""
    n = axis_size(axis)
    if n & (n - 1):
        raise ValueError(f"tree_allreduce needs a power-of-two axis, got {n}")
    me = axis_index(axis)
    dist = 1
    while dist < n:
        partner = me ^ dist                      # butterfly partner exchange
        other = exchange(x, axis, send_to=partner, recv_from=partner)
        # lower index first, so both partners compute the same value
        x = op(x, other) if me < partner else op(other, x)
        COUNTS["tree_rounds"] += 1
        dist *= 2
    return x


def sharded_softmax(x_local: torch.Tensor, axis, *, exp_fn=lut_exp,
                    dim: int = -1) -> torch.Tensor:
    """Softmax over a dimension split across ``axis``: each rank's local
    max → the global max (``all_reduce`` MAX) → LUT-exp of the shifted
    slice → local sum → the global sum (``all_reduce`` SUM)."""
    m_local = torch.amax(x_local, dim=dim, keepdim=True)
    m = all_reduce(m_local, "max", axis)
    e = exp_fn((x_local - m).contiguous())
    s_local = torch.sum(e, dim=dim, keepdim=True)
    s = all_reduce(s_local, "sum", axis)
    return e / torch.clamp(s, min=1e-30)


def sharded_softmax_tree(x_local: torch.Tensor, axis, *, exp_fn=lut_exp,
                         dim: int = -1) -> torch.Tensor:
    """``sharded_softmax`` with the explicit butterfly for both reduces."""
    m_local = torch.amax(x_local, dim=dim, keepdim=True)
    m = tree_allreduce(m_local, torch.maximum, axis)
    e = exp_fn((x_local - m).contiguous())
    s_local = torch.sum(e, dim=dim, keepdim=True)
    s = tree_allreduce(s_local, torch.add, axis)
    return e / torch.clamp(s, min=1e-30)
