"""Sharding-independent, step-atomic checkpointing (port of
``src/repro/checkpoint/store.py``), in the reference's file format, so
each package restores the other's checkpoints.

Layout (one directory per step)::

    <dir>/step_00000042/
        arrays.npz          # leaf path → full (unsharded) array
        manifest.json       # step, leaf paths, shapes, dtypes, sha256, extra

- **paths**: a tree (nested dicts, named tuples, lists of tensors or
  arrays) flattens to ``/``-joined keys as the reference's
  ``flatten_tree`` names them (a named tuple's field ``f`` is ``.f``);
- **atomic**: written into ``step_X.tmp-<pid>`` then ``os.replace``d into
  place, so a crash mid-write never leaves a step ``latest_step`` picks;
- **verified**: the manifest carries a sha256 per leaf, checked on
  restore (each leaf is read at its offset in the npz, without the zip
  layer's CRC pass);
- **bf16**: numpy has no bf16, and ``np.savez`` stores the reference's
  bf16 leaves as raw 2-byte void values (``|V2``); the port writes its
  bf16 leaves the same way, bit for bit, and reads them back by the
  manifest's (or the template's) dtype;
- **async**: ``AsyncCheckpointer.save`` copies every leaf to host memory
  before it returns (a CPU tensor is copied, never viewed: the optimizer
  may update it in place later) and writes in a background thread.

- **elastic**: the files hold full leaves whatever the mesh that wrote
  them; ``restore(mesh=, specs=)`` reads each leaf whole and keeps this
  rank's block of it (``parallel.shard_tree``), as the reference's
  ``device_put`` onto the mesh does.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import struct
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.params import from_flat

_STEP_RE = re.compile(r"^step_(\d{8})$")
#: manifest dtypes that npz stores as raw void bytes → their torch dtype
_VOID_DTYPES = {"bfloat16": torch.bfloat16}


def _sha(a: np.ndarray) -> str:
    """The reference's leaf digest: sha256 of the C-order bytes, hashed
    from the array's own buffer (no copy of it)."""
    raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return hashlib.sha256(raw.data).hexdigest()[:16]


def _shas(flat: Dict[str, np.ndarray]) -> Dict[str, str]:
    """``_sha`` of every leaf, the leaves hashed on threads (hashlib
    releases the interpreter lock over large buffers): a full-width
    training state is gigabytes."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return dict(zip(flat, ex.map(_sha, flat.values())))


# --------------------------------------------------------------------------
# tree ↔ flat dict  (paths are stable logical names)
# --------------------------------------------------------------------------

def _leaves(tree: Any, prefix: str = ""):
    """(path, leaf) pairs in the reference's order: dict keys sorted, a
    named tuple's fields as ``.name``, a list's items by index."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], join(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), join("." + f))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, join(i))
    else:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own (never a view of a tensor
    the caller may write later); bf16 as raw 2-byte void values."""
    if isinstance(leaf, np.ndarray):
        return np.array(leaf)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    # a card tensor's .cpu() is a fresh host copy; a CPU tensor is copied
    a = t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    return a.view("V2") if leaf.dtype == torch.bfloat16 else a


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def flatten_tree(tree: Any) -> Dict[str, np.ndarray]:
    """{path: host array}; bf16 leaves as void (``|V2``) arrays, as
    ``np.savez`` stores the reference's."""
    return {path: _host(leaf) for path, leaf in _leaves(tree)}


def unflatten_into(reference: Any, flat: Dict[str, Any]) -> Any:
    """Map flat path → array (or tensor) onto the structure of
    ``reference``, a tree of tensors: each leaf a tensor of the reference
    leaf's shape, dtype and device (void leaves reinterpreted by bit view,
    others cast; a ``meta`` leaf — a shape and dtype only — stays on the
    host)."""
    def build(node, prefix):
        join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
        if isinstance(node, dict):
            return {k: build(node[k], join(k)) for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f), join("." + f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x, join(i)) for i, x in enumerate(node))
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        arr = flat[prefix]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch for {prefix}: ckpt "
                             f"{tuple(arr.shape)} vs expected "
                             f"{tuple(node.shape)}")
        if isinstance(arr, np.ndarray):
            arr = _to_torch(arr, _dtype_name(node))
        dev = arr.device if node.device.type == "meta" else node.device
        return arr.to(device=dev, dtype=node.dtype)
    return build(reference, "")


def steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    s = steps(ckpt_dir)
    return s[-1] if s else None


def _to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf → a CPU tensor of the manifest's ``dtype``, exactly."""
    if arr.dtype.kind == "V":
        want = _VOID_DTYPES.get(dtype)
        if want is None or arr.dtype.itemsize != want.itemsize:
            raise TypeError(f"checkpoint leaf of dtype {dtype!r} stored as "
                            f"{arr.dtype}: no bit view to torch")
        bits = np.ascontiguousarray(arr).view(f"<i{arr.dtype.itemsize}")
        return torch.from_numpy(bits.reshape(arr.shape)).view(want)
    # ascontiguousarray makes a 0-d leaf (the optimizer's step) 1-d
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------

def _savez(path: str, flat: Dict[str, np.ndarray]) -> None:
    """``np.savez``'s layout (one ``<path>.npy`` per leaf in an
    uncompressed zip, which ``np.load`` reads), each leaf written from its
    own buffer in one piece rather than through 16 MiB copies."""
    fmt = np.lib.format
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            arr = np.require(arr, requirements="C")   # 0-d stays 0-d
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                fmt.write_array_header_1_0(f, fmt.header_data_from_array_1_0(
                    arr))
                f.write(arr.reshape(-1).view(np.uint8).data)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` as step ``step`` → the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = flatten_tree(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    _savez(os.path.join(tmp, "arrays.npz"), flat)
    shas = _shas(flat)
    manifest = {
        "step": int(step),
        "leaves": {k: {"shape": list(v.shape),
                       "dtype": ("bfloat16" if v.dtype.kind == "V"
                                 else str(v.dtype)),
                       "sha256": shas[k]} for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def restore(ckpt_dir: str, reference: Any, step: Optional[int] = None,
            mesh=None, specs: Any = None, verify: bool = True
            ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore onto the structure of ``reference`` (a tree of tensors of
    the full leaves' shapes) → (tree, step, extra).

    With ``mesh`` and ``specs`` (a tree of specs matching ``reference``,
    ``parallel.sharding``'s) each leaf is read whole and cut to this
    rank's block (``shard_tree`` at the mesh's coordinates): the elastic
    re-mesh.  The mesh may be a layout only (``Mesh(..., rank=r)``, no
    process group)."""
    if (mesh is None) != (specs is None):
        raise ValueError("restore takes mesh and specs together")
    flat, step, extra = restore_flat(ckpt_dir, step, verify)
    tree = unflatten_into(reference, flat)
    if mesh is not None:
        from repro_torch.parallel.sharding import shard_tree
        tree = shard_tree(tree, specs, mesh)
    return tree, step, extra


def retain(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for s in steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot to host synchronously, write in a background thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy every leaf to host memory, then return; the write runs in
        the background (its error surfaces at the next ``wait``)."""
        self.wait()
        flat = flatten_tree(tree)      # host copies (blocks on D2H only)

        def _write():
            try:
                save(self.ckpt_dir, step, flat, extra)
                retain(self.ckpt_dir, self.keep)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _read_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """One stored (uncompressed) ``.npy`` member of an npz, read from its
    offset in the file in one piece: ``np.load`` reads a member through
    the zip layer in 256 KiB pieces with a CRC pass, ~3× slower at a
    training state's gigabytes (the manifest's sha256 checks the bytes)."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)
        if head[:4] != b"PK\x03\x04":
            raise IOError(f"{path}: no local header for {info.filename}")
        name_len, extra_len = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if version == (1, 0)
                else fmt.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.fromfile(f, dtype=dtype, count=count)
    if arr.size != count:
        raise IOError(f"{path}: {info.filename} is truncated")
    return arr.reshape(shape, order="F" if fortran else "C")


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    """{key: array} of an uncompressed npz (``np.savez``'s, which both
    packages write), as ``np.load`` gives it: each member read at its
    offset, the members on threads."""
    with zipfile.ZipFile(path) as zf:
        infos = {i.filename[:-len(".npy")]: i for i in zf.infolist()
                 if i.filename.endswith(".npy")}
    packed = [i.filename for i in infos.values()
              if i.compress_type != zipfile.ZIP_STORED]
    if packed:
        raise IOError(f"{path}: compressed members {packed}; a checkpoint's "
                      f"npz is written uncompressed (np.savez)")
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return dict(zip(infos, ex.map(lambda i: _read_member(path, i),
                                      infos.values())))


def restore_flat(ckpt_dir: str, step: Optional[int] = None,
                 verify: bool = True
                 ) -> Tuple[Dict[str, torch.Tensor], int, Dict[str, Any]]:
    """Read one step (default: the latest) → (flat {leaf path: CPU tensor},
    step, extra).  With ``verify``, every leaf's sha256 must match the
    manifest's, else ``IOError``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    raw = _load_npz(os.path.join(d, "arrays.npz"))
    leaves = manifest["leaves"]
    if verify:
        shas = _shas({k: raw[k] for k in leaves})
        for k, meta in leaves.items():
            if shas[k] != meta["sha256"]:
                raise IOError(f"checkpoint corruption: sha mismatch at {k}")
    flat = {k: _to_torch(a, leaves[k]["dtype"]) for k, a in raw.items()}
    return flat, step, manifest.get("extra", {})


def restore_params(ckpt_dir: str, cfg: ModelConfig,
                   device: DeviceLike = None, *, step: Optional[int] = None,
                   verify: bool = True
                   ) -> Tuple[Dict[str, torch.Tensor], int, Dict[str, Any]]:
    """A model's parameters from a checkpoint → (params on ``device``
    (default: the card), step, extra).  The reference's serve CLI saves
    ``{"params": params}``, so a leading ``params/`` is stripped; a leaf
    whose dtype is not ``cfg.dtype`` is cast to it, as the reference's
    ``unflatten_into`` casts to its template's dtype."""
    flat, step, extra = restore_flat(ckpt_dir, step, verify)
    if flat and all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    dt = getattr(torch, cfg.dtype)
    params = {k: v.to(dt) for k, v in from_flat(flat, cfg, device).items()}
    return params, step, extra
