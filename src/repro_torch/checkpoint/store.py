"""The read half of the reference's checkpoint store (port of
``src/repro/checkpoint/store.py``): list a directory's steps and restore
one step's leaves, checked against the manifest's sha256.

Layout (one directory per step, written by the reference's ``save``)::

    <dir>/step_00000042/
        arrays.npz          # leaf path → full (unsharded) array
        manifest.json       # step, leaf paths, shapes, dtypes, sha256, extra

``np.savez`` stores a bf16 leaf as raw 2-byte void values (``|V2``), and
numpy alone has no bf16: ``restore_flat`` takes the leaf's dtype from the
manifest and reinterprets the bytes as ``torch.bfloat16``, bit for bit.
Saving, retention and the asynchronous writer come with the training
slice.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
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
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


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
        return torch.from_numpy(bits).view(want)
    return torch.from_numpy(np.ascontiguousarray(arr))


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
    with np.load(os.path.join(d, "arrays.npz")) as z:
        raw = {k: z[k] for k in z.files}
    leaves = manifest["leaves"]
    if verify:
        for k, meta in leaves.items():
            if _sha(raw[k]) != meta["sha256"]:
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
