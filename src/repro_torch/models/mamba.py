"""Mamba-1 selective SSM block (port of ``src/repro/models/mamba.py``):
falcon-mamba-7b's mixer.

The recurrence ``h_t = Ā_t h_{t-1} + B̄_t x_t`` runs as the reference
runs it: chunked over the sequence (``cfg.ssm_chunk`` rows), each chunk
discretised on its own — ``Ā = exp(Δ ⊗ A)`` and ``B̄x`` are (B, chunk,
d_inner, n), never (B, L, d_inner, n): at falcon's width a 4,200-row
prompt would need 2.2 GB for each — and scanned in log depth by
``associative_scan``, the pairs ``(a, b)`` combining as ``(a₂a₁, a₂b₁ +
b₂)`` in the order of ``jax.lax.associative_scan``'s recursion.  Padded
steps of the last chunk are the identity (``aa = 1``, ``bx = 0``), so the
carried state ignores them.  A single row (L = 1, decode) takes one
recurrence step.

The exponential of the discretisation is kernel #1's wrapper
(``kernels/lut_exp``) at the config's LUT order — one launch per chunk,
one per decode step — or ``torch.exp`` for ``exp_mode="exact"``.

Parameters are one layer's views of the stacked leaves (``params.py``);
a cache is one layer's ``{"conv", "h"}`` views of the stacked SSM cache
(``models/lm.py::trunk_cache_init``), written in place.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels.lut_exp import lut_exp
from repro_torch.models.layers import dense_apply

Params = Dict[str, torch.Tensor]
Pair = List[torch.Tensor]


def ssm_exp(cfg: ModelConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """The SSM's exponential: kernel #1's wrapper at the LUT's order (the
    kernel on a CUDA tensor, which it needs contiguous; its plain version
    on the CPU), or ``torch.exp`` for ``exp_mode="exact"``."""
    if cfg.exp_mode == "exact":
        return torch.exp
    order = {"lut": 1, "lut0": 0}[cfg.exp_mode]
    return lambda z: lut_exp(z.contiguous(), order=order)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as JAX computes it: ``logaddexp(x, 0)`` =
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _combine(e1: Pair, e2: Pair) -> Pair:
    a1, b1 = e1
    a2, b2 = e2
    return [a2 * a1, a2 * b1 + b2]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows of ``even`` at 0, 2, … and of ``odd`` at 1, 3, … of dim 1."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(elems: Pair) -> Pair:
    """Inclusive scan of ``(a, b)`` pairs along dim 1 under ``_combine``,
    in the association order of ``jax.lax.associative_scan``'s recursion
    (adjacent pairs combined, the halves scanned recursively, the even
    rows filled in): 2·log2(n) levels of whole-tensor ops."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _padded(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` (B, L, …) with ``pad`` zero rows after L."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def chunked_ssm(exp_fn, a: torch.Tensor, dt_proj: torch.Tensor,
                dt_bias: torch.Tensor, dt_low: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, xf: torch.Tensor,
                h0: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selective scan with per-chunk discretisation (the
    reference's ``_chunked_ssm``).  dt_low (B, L, r) in the model dtype;
    bmat / cmat (B, L, n) and xf (B, L, di) f32; a (di, n) < 0; h0
    (B, di, n) f32 → (y (B, L, di) f32, the last state (B, di, n))."""
    b, l, _ = dt_low.shape
    pad = (-l) % chunk
    dt_low, bmat, cmat, xf = (_padded(t, pad) for t in (dt_low, bmat, cmat, xf))
    valid = (torch.arange(l + pad, device=xf.device) < l)[None, :, None, None]
    h, ys = h0, []
    for c0 in range(0, l + pad, chunk):
        rows = slice(c0, c0 + chunk)
        dt = softplus(dense_apply(dt_proj, dt_low[:, rows]).to(torch.float32)
                      + dt_bias.to(torch.float32))              # (B, ch, di)
        v = valid[:, rows]
        aa = torch.where(v, exp_fn(dt[..., None] * a), 1.0)
        bx = torch.where(v, (dt * xf[:, rows])[..., None]
                         * bmat[:, rows, None, :], 0.0)
        a_cum, b_cum = associative_scan([aa, bx])
        h_all = a_cum * h[:, None] + b_cum                      # (B, ch, di, n)
        ys.append(torch.matmul(h_all, cmat[:, rows, :, None])[..., 0])
        h = h_all[:, -1]
    return torch.cat(ys, 1)[:, :l], h


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in ``x``'s dtype (the reference's
    ``_causal_conv``).  x (B, L, C); w (K, C); ``state`` the trailing K-1
    inputs of the previous call (zeros without one) → (y, the new state:
    the trailing K-1 inputs of this one)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:x.shape[1]] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return y + b.to(x.dtype), (xp[:, -(k - 1):] if k > 1 else state)


def _write_state(cache: Optional[Params], **leaves: torch.Tensor) -> None:
    """The new state into the cache's views, in place."""
    if cache is not None:
        for name, t in leaves.items():
            cache[name].copy_(t)


def mamba_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                cache: Optional[Params] = None) -> torch.Tensor:
    """x (B, L, D) → (B, L, D) (the reference's ``mamba_apply``).  With a
    ``cache`` ({"conv" (B, K-1, di), "h" (B, di, n) f32}) the conv and the
    scan start from its state and write their last state into it."""
    exp_fn = ssm_exp(cfg)
    b, l, _ = x.shape
    di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    xz = dense_apply(p["in_proj"], x)
    xs, z = xz[..., :di], xz[..., di:]
    xs, conv_state = causal_conv(xs, p["conv_w"], p["conv_b"],
                                 None if cache is None else cache["conv"])
    xs = F.silu(xs)
    proj = dense_apply(p["x_proj"], xs).to(torch.float32)
    dt_low, bmat, cmat = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    a = -torch.exp(p["A_log"])                                  # (di, n) < 0
    xf = xs.to(torch.float32)
    h0 = (cache["h"].to(torch.float32) if cache is not None else
          torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    if l == 1:                    # decode: one recurrence step, no scan
        dt = softplus(dense_apply(p["dt_proj"], dt_low.to(x.dtype)
                                  ).to(torch.float32)
                      + p["dt_bias"].to(torch.float32))          # (B, 1, di)
        aa = exp_fn(dt[..., None] * a)
        bx = (dt * xf)[..., None] * bmat[:, :, None, :]
        h_last = aa[:, 0] * h0 + bx[:, 0]
        y = torch.matmul(h_last, cmat[:, 0, :, None])[..., 0][:, None]
    else:
        y, h_last = chunked_ssm(exp_fn, a, p["dt_proj"], p["dt_bias"],
                                dt_low.to(x.dtype), bmat, cmat, xf, h0,
                                cfg.ssm_chunk)
    y = y + p["D"] * xf
    y = y.to(x.dtype) * F.silu(z)
    _write_state(cache, conv=conv_state, h=h_last)
    return dense_apply(p["out_proj"], y)


def mamba_cache_init(cfg: ModelConfig, batch: int, layers: int = 1,
                     device=None) -> Params:
    """``layers`` Mamba-1 layers' streaming state, stacked, the batch on
    axis 1: ``conv`` (layers, B, K-1, di) in the model dtype and ``h``
    (layers, B, di, n) f32, zeros."""
    dt = getattr(torch, cfg.dtype)
    return {"conv": torch.zeros((layers, batch, cfg.ssm_conv - 1,
                                 cfg.d_inner), dtype=dt, device=device),
            "h": torch.zeros((layers, batch, cfg.d_inner, cfg.ssm_state),
                             dtype=torch.float32, device=device)}


MAMBA_KEYS: Sequence[str] = ("ln", "in_proj", "conv_w", "conv_b", "x_proj",
                             "dt_proj", "dt_bias", "A_log", "D", "out_proj")
