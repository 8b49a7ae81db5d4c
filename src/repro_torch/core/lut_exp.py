"""LUT-based exponential (paper §III-B1), plain PyTorch.

``e^x = 2^n · 2^(d/K) · e^r`` with a K=128-entry table of ``2^(d/K)``:
``n = ⌊x·log2e⌋`` picks the exponent field, ``d`` indexes the table and the
residual ``e^r`` is approximated as ``1`` (order 0) or ``1 + r`` (order 1).

This is the port of ``src/repro/core/lut_exp.py`` and the single source of
truth for the decomposition on the PyTorch side: the plain reference of the
CUDA kernel (``kernels/lut_exp/ref.py``) and the attention reference call it,
and ``csrc/lut_exp.cuh`` repeats its operations in the same order, so the
three agree bit for bit.  Every step is one rounded f32 operation; the
constants are the reference's Python floats rounded once to f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

K = 128
LN2 = float(np.log(2.0))
LOG2E = float(1.0 / np.log(2.0))
# Below this input, e^x underflows f32 anyway; used to make exp(-inf) == 0 exact.
UNDERFLOW_X = -87.0


@functools.lru_cache(maxsize=None)
def _table_np(k: int = K) -> np.ndarray:
    return (2.0 ** (np.arange(k, dtype=np.float64) / k)).astype(np.float32)


def make_table(k: int = K, device=None) -> torch.Tensor:
    """The 128-entry ``2^(d/K)`` table, built in float64 then cast to f32."""
    return torch.from_numpy(_table_np(k).copy()).to(device)


def pow2_int(n: torch.Tensor) -> torch.Tensor:
    """Exact ``2^n`` for integer-valued f32 ``n`` via the exponent field;
    ``n <= -127`` flushes to 0."""
    n_i = torch.clamp(n, -127.0, 127.0).to(torch.int32)
    bits = torch.where(n_i <= -127, torch.zeros_like(n_i), (n_i + 127) << 23)
    return bits.view(torch.float32)


def decompose(x: torch.Tensor, k: int = K):
    """Split ``x`` into (n, d, r_scaled) with e^x = 2^n · 2^(d/k) · e^(r_scaled·ln2/k)."""
    t = x.to(torch.float32) * LOG2E
    n = torch.floor(t)
    fk = (t - n) * k
    d = torch.clamp(torch.floor(fk), 0.0, float(k - 1))
    return n, d.to(torch.int32), fk - d


def residual_correction(r_scaled: torch.Tensor, k: int = K,
                        order: int = 1) -> torch.Tensor:
    """e^r for r = r_scaled · ln2/k: order 0 → 1, order 1 → 1 + r."""
    if order == 0:
        return torch.ones_like(r_scaled)
    return 1.0 + r_scaled * (LN2 / k)


def lut_exp(x: torch.Tensor, *, k: int = K, order: int = 1,
            table: torch.Tensor | None = None) -> torch.Tensor:
    """LUT exponential of any shape; computes in f32, returns ``x.dtype``."""
    dtype = x.dtype
    if table is None:
        table = make_table(k, device=x.device)
    xf = x.to(torch.float32)
    n, d, r = decompose(xf, k)
    looked = table.to(torch.float32)[d.long()]
    out = pow2_int(n) * looked * residual_correction(r, k, order)
    out = torch.where(xf < UNDERFLOW_X, torch.zeros_like(out), out)
    return out.to(dtype)
