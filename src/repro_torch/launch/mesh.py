"""Meshes over ``torch.distributed`` process groups (port of
``src/repro/launch/mesh.py``).

The reference's mesh is a grid of TPU chips that one program drives under
``shard_map``.  The port runs SPMD over processes instead: every rank of
an initialised process group runs the same program, and a :class:`Mesh`
lays those ranks out on named axes.  Production meshes:

  single-pod   (16, 16)      axes ("data", "model")         — 256 ranks
  multi-pod    (2, 16, 16)   axes ("pod", "data", "model")  — 512 ranks

"model" is innermost: tensor-parallel collectives stay between
neighbouring ranks.  :func:`make_host_mesh` lays out whatever world is
running (tests, the card's machine: several ranks on one card).

:func:`spawn` starts N ranks with the ``spawn`` start method (a parent
that has initialised CUDA cannot ``fork``) and a ``file://`` rendezvous
in a fresh temporary directory, so concurrent test workers never race for
a port.  The backend is gloo, on the CPU and on the card alike: NCCL
refuses two ranks on one device, and gloo takes CUDA tensors for
``all_gather`` / ``all_reduce`` by staging them through the host.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

LAUNCH_HINT = ("start the ranks with repro_torch.launch.mesh.spawn(fn, n, "
               "...) or call torch.distributed.init_process_group(backend="
               "'gloo', world_size=n, rank=r, init_method=...) in each of n "
               "processes")


class MeshAxis:
    """One named axis of a :class:`Mesh` as this rank sees it: the process
    group of the ranks that differ from this one only along the axis, its
    ``size``, this rank's ``index`` on it and the axis' global ``ranks`` in
    index order.  The collectives (``parallel/collectives.py``) take it
    where the reference takes an ``axis_name``."""

    def __init__(self, name: str, size: int, index: int,
                 ranks: Sequence[int], group):
        self.name = name
        self.size = size
        self.index = index
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group

    def __repr__(self) -> str:
        return (f"MeshAxis({self.name!r}, size={self.size}, "
                f"index={self.index})")


class Mesh:
    """A grid of ranks with named axes over the default process group,
    rank ``i`` at row-major position ``i``.  ``shape`` maps axis → size, as the reference's
    ``Mesh.shape`` does; ``coords`` this rank's position on each axis.

    With ``torch.distributed`` initialised the grid must cover the group
    exactly, and every rank must build the same meshes in the same order
    (a sub-axis makes its process groups collectively).  Without it the
    mesh is a layout only (``rank`` places this process, default 0): the
    sharding rules read it, a collective over an axis of size > 1 raises.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, shape))
        self.size = math.prod(shape)
        live = dist.is_available() and dist.is_initialized()
        if live:
            self.group = dist.group.WORLD
            world = dist.get_world_size(self.group)
            if world != self.size:
                raise ValueError(
                    f"a mesh of shape {dict(self.shape)} needs {self.size} "
                    f"ranks, the process group has {world}")
            self.rank = dist.get_rank(self.group)
            self.devices = [dist.get_global_rank(self.group, i)
                            for i in range(self.size)]
        else:
            self.group = None
            self.rank = 0 if rank is None else int(rank)
            self.devices = list(range(self.size))
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")
        grid = torch.arange(self.size).reshape(shape)
        pos = (grid == self.rank).nonzero()[0].tolist()
        self.coords: Dict[str, int] = dict(zip(axis_names, pos))
        self._axes: Dict[str, MeshAxis] = {
            name: self._make_axis(d, name, grid, live)
            for d, name in enumerate(axis_names)}

    def _make_axis(self, d: int, name: str, grid, live: bool) -> MeshAxis:
        """The ranks along axis ``d`` through this rank; with a live group
        and an axis that neither is the whole mesh nor has size 1, every
        line of the grid along ``d`` becomes a process group (collectively,
        in a fixed order), and this rank keeps its own line's."""
        lines = grid.movedim(d, -1).reshape(-1, grid.shape[d]).tolist()
        mine = next(line for line in lines if self.rank in line)
        ranks = [self.devices[i] for i in mine]
        group = None
        if live:
            if len(mine) == self.size:
                group = self.group
            elif len(mine) > 1:
                for line in lines:
                    g = dist.new_group([self.devices[i] for i in line],
                                       backend=dist.get_backend(self.group))
                    if line == mine:
                        group = g
        return MeshAxis(name, len(mine), mine.index(self.rank), ranks, group)

    def axis(self, name: str) -> MeshAxis:
        if name not in self._axes:
            raise KeyError(f"mesh has no axis {name!r}: {self.axis_names}")
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, rank={self.rank})"


def world_size() -> int:
    """Ranks of the default group, 1 when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layouts over the default group; raises
    ``ValueError`` unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = world_size()
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the world has {n}; "
                         f"{LAUNCH_HINT}")
    return Mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """A ("data", "model") mesh over whatever ranks exist (tests, one card
    with several ranks)."""
    n = world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model}")
    return Mesh((n // model, model), ("data", "model"))


# --------------------------------------------------------------------------
# spawning ranks
# --------------------------------------------------------------------------

def _rank_main(rank: int, n: int, init_file: str, threads: Optional[int],
               timeout: float, fn: Callable, args: tuple, results) -> None:
    """One rank: join the group, run ``fn(*args)``, report, leave."""
    ok, payload = True, None
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            payload = fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:                      # reported, then re-raised
        ok, payload = False, traceback.format_exc()
    results.put((rank, ok, payload))
    if not ok:
        raise SystemExit(1)


def spawn(fn: Callable, n: int, *args, threads: Optional[int] = None,
          root: Optional[str] = None, timeout: float = 900.0) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` fresh processes joined into one gloo
    default process group (rank ``r`` of ``n``) → the ranks' return values
    in rank order.  ``fn`` must be importable by name (a module-level function);
    ``threads`` pins each rank's intra-op threads; ``root`` holds the
    rendezvous directory (default: the system's temporary directory).

    A rank that raises makes ``spawn`` raise ``RuntimeError`` with its
    traceback, after every rank has stopped (the others, stuck in a
    collective, are terminated); so does a rank that dies silently, and a
    run past ``timeout`` seconds (also each collective's time limit)."""
    if n < 1:
        raise ValueError(f"spawn needs n >= 1, got {n}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_",
                                     dir=root) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=False,
                             args=(r, n, init_file, threads, timeout, fn,
                                   args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        failed: Dict[int, str] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(failed) < n:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    silent = [r for r, p in enumerate(procs)
                              if p.exitcode not in (None, 0)
                              and r not in got and r not in failed]
                    if silent and not failed:
                        # a rank that raised reports before it exits
                        deadline = min(deadline, time.monotonic() + 5.0)
                    if time.monotonic() > deadline:
                        break
                    continue
                if ok:
                    got[rank] = payload
                else:
                    failed[rank] = payload
                    # the others' reports (often the root cause) may follow
                    deadline = min(deadline, time.monotonic() + 5.0)
        finally:
            done = len(got) == n
            for p in procs:
                p.join(timeout=30 if done else 0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if len(got) < n:
        lines = [f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())]
        quiet = sorted(set(range(n)) - set(got) - set(failed))
        if quiet:
            lines.append(f"rank(s) {quiet} reported nothing (exit codes "
                         f"{[procs[r].exitcode for r in quiet]}; time limit "
                         f"{timeout} s)")
        raise RuntimeError("spawned ranks failed: " + "\n".join(lines))
    return [got[r] for r in range(n)]
