"""Activation-sharding context (port of ``src/repro/parallel/ctx.py``).

The reference installs a process-local mesh with ``activation_sharding``
and places GSPMD sharding constraints on two activations (the residual
stream and the logits) through ``maybe_shard``.  The port runs eager SPMD
over processes: each rank computes its own tensors, and there is no
compiler that a constraint could steer.  So ``maybe_shard`` returns ``x``
unchanged whether or not a mesh is active; the context is kept so that
code written against the reference's names runs, and ``active_mesh``
tells a caller which mesh it runs under.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

_STATE = threading.local()


def active_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def activation_sharding(mesh):
    prev = active_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def maybe_shard(x: torch.Tensor, logical: Sequence) -> torch.Tensor:
    """``x`` as it is: in eager SPMD torch a rank's tensor already is its
    placement (see the module docstring); ``logical`` is the reference's
    spec, kept at the call sites."""
    del logical
    return x
