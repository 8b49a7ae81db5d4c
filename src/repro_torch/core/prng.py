"""JAX's threefry2x32 PRNG, bit for bit, in PyTorch (the port's copy of what
``jax.random`` computes for the reference's sampler under jax's defaults:
``threefry2x32`` keys, ``jax_threefry_partitionable=True``, the "low" mode
of ``gumbel``).

A key is a pair of uint32 words ``(k1, k2)``.  Every function takes and
returns words as int64 tensors holding values in [0, 2^32): torch's uint32
lacks most operations and int32's ``>>`` is arithmetic, so each add and
shift is followed by ``& 0xFFFFFFFF``.  The same code then runs on the CPU
and on the card, and the words broadcast like any tensor, so one call
serves a batch of keys.

- ``threefry2x32(k1, k2, x1, x2)``: Salmon et al.'s Threefry-2x32 with 20
  rounds, the reference's rotations and key-schedule constant;
- ``prng_key(seed)``: ``PRNGKey(s)`` of a uint32 seed is ``(0, s)``;
- ``fold_in(k1, k2, n)``: ``threefry2x32(key, (0, n))``;
- ``random_bits(k1, k2, n)``: element ``i`` is ``b1 ^ b2`` of
  ``threefry2x32(key, (0, i))`` (the partitionable form: a function of
  the key and ``i`` alone);
- ``uniform(bits, minval, maxval)``: the mantissa trick of
  ``jax.random.uniform`` in f32;
- ``gumbel(k1, k2, n)``: ``-log(-log(uniform(bits, tiny, 1)))``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = float(torch.finfo(torch.float32).tiny)

Words = Tuple[torch.Tensor, torch.Tensor]


def _words(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def _round(x0: torch.Tensor, x1: torch.Tensor, rot: int) -> Words:
    x0 = (x0 + x1) & MASK32
    x1 = ((x1 << rot) & MASK32) | (x1 >> (32 - rot))
    return x0, x1 ^ x0


def threefry2x32(k1, k2, x1, x2) -> Words:
    """Threefry-2x32 of the count words ``(x1, x2)`` under key ``(k1, k2)``
    (all int64 words, broadcast together) → the two output words."""
    k1, k2 = _words(k1), _words(k2)
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x0 = (_words(x1, k1.device) + ks[0]) & MASK32
    x1 = (_words(x2, k1.device) + ks[1]) & MASK32
    for i in range(5):
        for rot in ROTATIONS[i % 2]:
            x0, x1 = _round(x0, x1, rot)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed) -> Words:
    """``jax.random.PRNGKey`` of uint32 seeds: the words ``(0, seed)``."""
    s = _words(seed)
    return torch.zeros_like(s), s


def fold_in(k1, k2, n) -> Words:
    """``jax.random.fold_in(key, n)`` for uint32 ``n``."""
    n = _words(n)
    return threefry2x32(k1, k2, torch.zeros_like(n), n)


def random_bits(k1, k2, n: int) -> torch.Tensor:
    """32 random bits per element, ``(*key shape, n)``, as
    ``jax.random.bits(key, (n,))`` draws them: element ``i`` hashes the
    count ``(0, i)``."""
    k1, k2 = _words(k1)[..., None], _words(k2)[..., None]
    iota = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(iota), iota)
    return b1 ^ b2


def uniform(bits: torch.Tensor, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval) from 32-bit words: the top 23 bits
    become the mantissa of a float in [1, 2), less 1, then scaled, shifted
    and clamped at ``minval`` (``jax.random.uniform``'s operations)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds as f32 scalars (no tensor leaves the host, so the draw
    # stays capturable), their difference rounded in f32
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    lo = float(lo)
    return torch.clamp(f * span + lo, min=lo)


def gumbel(k1, k2, n: int) -> torch.Tensor:
    """Standard Gumbel noise, ``(*key shape, n)`` f32: the "low" mode of
    ``jax.random.gumbel``."""
    u = uniform(random_bits(k1, k2, n), F32_TINY, 1.0)
    return -torch.log(-torch.log(u))
