"""Sharding rules: map parameter / batch / cache trees to partition specs
(port of ``src/repro/parallel/sharding.py``).

Logical axes → physical mesh axes:

  ``dp``/``fsdp`` → ("pod", "data")   batch parallel / ZeRO-3 param sharding
  ``tp``          → ("model",)        tensor parallel (heads / ffn / vocab)
  ``sp``          → ("model",)        sequence parallel (activations)

A spec is a plain tuple with one entry per tensor dim, each entry what the
reference's ``PartitionSpec`` holds there: ``None`` (replicated), a mesh
axis name, or a tuple of axis names (the dim split over their product).
Every spec passes through :func:`fit_spec`, which drops a mesh axis that
does not divide its dim, so one rule set serves every architecture and
mesh (grok's 8 KV heads on a 16-way model axis fall back to replicated
heads).

Rules are keyed by leaf *path suffix*: the reference's paths, e.g.
``trunk/periods/0/attn/wq/w``.  A tree here is a dict, flat or nested
(the path joins nested keys with ``/``); the flat ``{path: leaf}`` dict of
the reference's checkpoint (``params.to_flat`` / ``from_flat``) is walked
as it is.  A leaf is anything with a ``.shape``.

The port's own parameter dict (``{"wq": (L, D, Hq·Dh), ...}``) takes its
specs from :func:`port_param_specs`: each key's reference path
(``params.param_paths``) picks the rule, at the port leaf's shape (the
rules split trailing dims only, and the port's leading layer dim is one
they leave replicated).

A mesh is anything with ``axis_names`` and a ``shape`` mapping axis →
size (the port's ``launch/mesh.py::Mesh``, or a stand-in); only
:func:`shard_tree` also reads the calling rank's coordinates, and
:func:`gather_tree` its axes' process groups.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

Spec = Tuple[Any, ...]

# --------------------------------------------------------------------------
# logical → physical
# --------------------------------------------------------------------------


def logical_axes(mesh) -> Dict[str, Tuple[str, ...]]:
    names = mesh.axis_names
    dp = tuple(n for n in ("pod", "data") if n in names)
    tp = tuple(n for n in ("model",) if n in names)
    return {"dp": dp, "fsdp": dp, "tp": tp, "sp": tp}


def fit_spec(spec: Sequence, shape: Tuple[int, ...], mesh,
             allow_uneven: bool = False) -> Spec:
    """Drop axes that don't divide their dim; resolve logical names.

    ``allow_uneven=True`` keeps an axis whenever dim ≥ axis size (the
    reference's GSPMD pads internally; legal only for internal sharding
    constraints)."""
    log = logical_axes(mesh)
    out = []
    used: set = set()
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        phys = log.get(ax, (ax,)) if isinstance(ax, str) else tuple(ax)
        phys = tuple(a for a in phys if a in mesh.axis_names and a not in used)
        # greedily keep the longest admissible prefix
        keep: Tuple[str, ...] = ()
        size = 1
        for a in phys:
            nxt = size * mesh.shape[a]
            if dim % nxt == 0 or (allow_uneven and dim >= nxt):
                keep += (a,)
                size = nxt
            else:
                break
        used.update(keep)
        out.append(keep if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(out)


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

def _map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a dict tree (flat or nested), same nesting."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def _is_record(x) -> bool:
    """A named tuple (the optimizer's ``AdamWState``): a node, not a spec."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map2(fn: Callable[[Any, Any], Any], tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over two trees (dicts and named tuples) of
    the same nesting."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if _is_record(tree):
        return type(tree)(*(_map2(fn, getattr(tree, f), getattr(other, f))
                            for f in tree._fields))
    return fn(tree, other)


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

# (path-suffix regex, logical spec for the *trailing* dims), checked in
# order; leading stacked dims are padded with None (the reference's table).
_PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # embeddings / head
    (r"embed/tokens$", ("tp", "fsdp")),
    (r"embed/positions$", (None, "tp")),
    (r"lm_head/w$", ("fsdp", "tp")),
    # attention
    (r"attn/wq/w$", ("fsdp", "tp")),
    (r"attn/wk/w$", ("fsdp", "tp")),
    (r"attn/wv/w$", ("fsdp", "tp")),
    (r"attn/wo/w$", ("tp", "fsdp")),
    (r"attn/w[qkv]/b$", ("tp",)),
    (r"attn/wo/b$", (None,)),
    (r"attn/[qk]_norm$", (None,)),
    # dense mlp
    (r"mlp/(up|gate)/w$", ("fsdp", "tp")),
    (r"mlp/down/w$", ("tp", "fsdp")),
    (r"mlp/(up|gate|down)/b$", (None,)),
    # moe (E, D, F) stacks
    (r"moe/router/w$", (None, None)),
    (r"moe/(up|gate)$", (None, "fsdp", "tp")),
    (r"moe/down$", (None, "tp", "fsdp")),
    # mamba: in_proj's out dim is a concatenation of segments
    (r"mix/in_proj/w$", ("fsdp", "tp")),
    (r"mix/x_proj/w$", ("tp", None)),
    (r"mix/dt_proj/w$", (None, "tp")),
    (r"mix/out_proj/w$", ("tp", "fsdp")),
    (r"mix/conv_w$", (None, "tp")),
    (r"mix/conv_b$", ("tp",)),
    (r"mix/A_log$", ("tp", None)),
    (r"mix/(D|dt_bias)$", ("tp",)),
    (r"mix/norm_scale$", ("tp",)),
    # norms and anything small
    (r"(ln\w*|final_norm|norm|ln)/(scale|bias)$", (None,)),
)


def _match_rule(path: str) -> Optional[Tuple]:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            return spec
    return None


def param_pspec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    spec = _match_rule(path)
    if spec is None:
        spec = (None,) * len(shape)         # replicate unknowns (safe default)
    # pad leading stacked dims (scan periods / mamba2 A_log heads etc.)
    if len(spec) < len(shape):
        spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
    elif len(spec) > len(shape):
        spec = tuple(spec[-len(shape):])
    return fit_spec(spec, shape, mesh)


def param_specs(params: Any, mesh) -> Any:
    """Tree of specs matching ``params``, keyed by the reference's paths
    (the flat dict of ``params.to_flat``, or nested)."""
    return _map_with_path(
        lambda p, x: param_pspec(p, tuple(x.shape), mesh), params)


def port_param_specs(params: Dict[str, Any], cfg, mesh) -> Dict[str, Spec]:
    """{port key: spec} for the port's flat parameter dict of ``cfg`` (or
    an optimizer moment of it): the rule of the key's first reference
    path (``params.param_paths``; a layer-stacked key's paths differ only
    in their period slot) at the port leaf's shape."""
    from repro_torch.params import param_paths   # params imports models
    paths = param_paths(cfg)
    return {k: param_pspec(paths[k][0], tuple(x.shape), mesh)
            for k, x in params.items()}


# --------------------------------------------------------------------------
# batch / cache rules
# --------------------------------------------------------------------------

def batch_pspec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """Batch inputs: dim0 = global batch → dp; rest replicated."""
    spec = ("dp",) + (None,) * (len(shape) - 1)
    return fit_spec(spec, shape, mesh)


def batch_specs(batch: Any, mesh) -> Any:
    return _map_with_path(
        lambda p, x: batch_pspec(p, tuple(x.shape), mesh), batch)


# Unstacked rank of each cache leaf kind; extra leading dims are layer
# stacks (the port's pool and contiguous cache stack layers on dim 0).
_CACHE_BASE_NDIM = {"k": 4, "v": 4, "S": 4, "h": 3, "conv": 3, "pos": 2,
                    "ks": 3, "vs": 3}


def _cache_offset(path: str, shape: Tuple[int, ...]) -> int:
    leaf = path.rsplit("/", 1)[-1]
    base = _CACHE_BASE_NDIM.get(leaf)
    if base is None:
        return 1 if "periods" in path.split("/") else 0
    return max(len(shape) - base, 0)


def cache_pspec(path: str, shape: Tuple[int, ...], mesh,
                decode: bool = False) -> Spec:
    """KV/SSM caches: batch → dp; heads/channels → tp, with the trailing
    dim (head_dim / d_inner) as the tp fallback when the head count does
    not divide the model axis.  Layer-stacked leaves are detected
    structurally: rank above the leaf kind's base rank = leading stack dims
    (replicated).  ``decode=True`` shards KV on the sequence dim instead
    (the paper's multi-core softmax gather: ``core/ring_attention.py::
    distributed_decode_attention``)."""
    leaf = path.rsplit("/", 1)[-1]
    off = _cache_offset(path, shape)
    core = len(shape) - off
    spec = [None] * len(shape)
    if core >= 1:
        spec[off] = "dp"
    if decode and leaf in ("k", "v") and core >= 4:
        spec[off + 2] = "tp"       # KV sequence dim
    elif decode and leaf in ("ks", "vs") and core >= 3:
        spec[off + 2] = "tp"       # per-row scales follow their rows
    elif core >= 3:
        spec[off + 1] = "tp"       # heads / channels
        spec[-1] = "tp"            # head-dim fallback (dup dropped by fit)
    return fit_spec(tuple(spec), shape, mesh)


def cache_specs_decode(caches: Any, mesh) -> Any:
    return _map_with_path(
        lambda p, x: cache_pspec(p, tuple(x.shape), mesh, decode=True),
        caches)


def cache_specs(caches: Any, mesh) -> Any:
    return _map_with_path(
        lambda p, x: cache_pspec(p, tuple(x.shape), mesh), caches)


def pool_pspec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """Paged KV *pool* leaves: KV heads → tp, everything else replicated.

    The pool's page axis is never sharded: the page table, free heap,
    refcounts and prefix-cache tree are host-global and name physical
    pages every rank holds (its head band of).  The port's pool leaves:

      k/v   (L, N+1, Hkv, ps, Dh) → heads on "model"
      ks/vs (L, N+1, Hkv, ps)     → heads on "model" (scales ride their heads)

    No head-dim fallback: the sharded ragged step slices q/k/v head bands
    to match the local pool, so a non-dividing head count fails engine
    validation rather than replicating one leaf."""
    leaf = path.rsplit("/", 1)[-1]
    off = _cache_offset(path, shape)
    spec = [None] * len(shape)
    if leaf in ("k", "v", "ks", "vs") and len(shape) - off >= 2:
        spec[off + 1] = "tp"                     # KV heads
    return fit_spec(tuple(spec), shape, mesh)


def pool_specs(pool: Any, mesh) -> Any:
    """Tree of specs for a ``PagedKVCache`` pool."""
    return _map_with_path(
        lambda p, x: pool_pspec(p, tuple(x.shape), mesh), pool)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not _is_record(x)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharding_of(spec: Spec, mesh) -> Dict[int, Tuple[Tuple[str, ...], int]]:
    """One leaf's sharding: {tensor dim: (mesh axes, shard count)} for each
    dim the spec splits (an empty dict: replicated)."""
    out = {}
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if axes:
            n = 1
            for a in axes:
                n *= mesh.shape[a]
            out[dim] = (axes, n)
    return out


def shardings_of(specs: Any, mesh) -> Any:
    """Tree of :func:`sharding_of` maps, the port's counterpart of the
    reference's ``NamedSharding`` tree: what :func:`shard_tree` slices."""
    if _is_spec(specs):
        return sharding_of(specs, mesh)
    if _is_record(specs):
        return type(specs)(*(shardings_of(getattr(specs, f), mesh)
                             for f in specs._fields))
    return {k: shardings_of(v, mesh) for k, v in specs.items()}


def _local_block(x, sharding: Dict[int, Tuple[Tuple[str, ...], int]], mesh):
    """This rank's block of ``x``: each split dim sliced at the rank's
    row-major index over the dim's mesh axes."""
    coords = mesh.coords
    for dim, (axes, n) in sharding.items():
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x.contiguous()


def _gather_leaf(x, sharding: Dict[int, Tuple[Tuple[str, ...], int]], mesh):
    from repro_torch.parallel.collectives import all_gather
    for dim, (axes, _) in sharding.items():
        for a in reversed(axes):              # the innermost axis first
            x = all_gather(x, mesh.axis(a), dim)
    return x


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The inverse of :func:`shard_tree`: each leaf's blocks all-gathered
    over the axes that split it, in the mesh's row-major block order →
    the full leaves, on every rank (every rank of the mesh must call it,
    the leaves in the same order)."""
    return _map2(lambda x, s: _gather_leaf(x, s, mesh), tree,
                 shardings_of(specs, mesh))


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's local block of each leaf of ``tree`` under ``specs`` —
    the port's counterpart of the reference's ``device_put`` onto the mesh:
    every rank of an SPMD program holds its own block, so the tree it keeps
    is the block, sliced on the sharded dims (a replicated leaf comes back
    as it is, made contiguous)."""
    return _map2(lambda x, s: _local_block(x, s, mesh), tree,
                 shardings_of(specs, mesh))
