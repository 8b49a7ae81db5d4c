"""Mamba-2 (SSD) block (port of ``src/repro/models/mamba2.py``): the
state mixer of zamba2-1.2b.

The decay is a scalar per head, so within a chunk the recurrence is a
masked matmul ``C · (decay mask) · Bᵀ · X`` and across chunks the same
carried state as Mamba-1.  Heads H = d_inner / ``ssm_head_dim`` (P), state
N = ``ssm_state``, groups G (B and C shared by H / G heads, repeated).
All four decay exponentials of a chunk — the intra-chunk mask
``exp(min(s_i − s_j, 0))``, ``exp(s)`` of the carried state's
contribution, ``exp(s_end − s)`` and ``exp(s_end)`` of the state update —
and the decode step's one go through ``models/mamba.py::ssm_exp``
(kernel #1 on the card): 4 launches per chunk, 1 per decode step.

``_gated_rmsnorm`` is the reference's as it stands: eps 1e-6 and a
``1 + scale`` weight over a scale drawn as ones, which doubles the
output.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import dense_apply
from repro_torch.models.mamba import (_padded, _write_state, causal_conv,
                                      softplus, ssm_exp)

Params = Dict[str, torch.Tensor]


def mamba2_heads(cfg: ModelConfig) -> int:
    return cfg.d_inner // cfg.ssm_head_dim


def conv_width(cfg: ModelConfig) -> int:
    """Channels of the shared conv: x, B and C."""
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def gated_rmsnorm(scale: torch.Tensor, y: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """The reference's ``_gated_rmsnorm``: y · silu(z) in f32, RMS-normed
    (eps 1e-6), times ``1 + scale``."""
    y = y * F.silu(z.to(torch.float32))
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    return y * (1.0 + scale.to(torch.float32))


def ssd_chunked(exp_fn, log_a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, xdt: torch.Tensor, s0: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (the reference's ``_ssd_chunked``).  log_a (B, L, H)
    ≤ 0; bmat / cmat (B, L, H, N); xdt (B, L, H, P); s0 (B, H, N, P), all
    f32 → (y (B, L, H, P), the last state).  Padded rows have log-decay 0
    and zero B, C and x: the identity."""
    b, l, h = log_a.shape
    pad = (-l) % chunk
    log_a, bmat, cmat, xdt = (_padded(t, pad) for t in (log_a, bmat, cmat, xdt))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=log_a.device))
    s, ys = s0, []
    for c0 in range(0, l + pad, chunk):
        rows = slice(c0, c0 + chunk)
        la, bc, cc, xc = (t[:, rows] for t in (log_a, bmat, cmat, xdt))
        s_cum = torch.cumsum(la, dim=1)                     # (B, ch, H)
        # intra-chunk: G_ij = (C_i · B_j) · exp(s_i − s_j) for j ≤ i
        scores = torch.einsum("bihn,bjhn->bhij", cc, bc)
        s_h = s_cum.transpose(1, 2)                          # (B, H, ch)
        decay = s_h[:, :, :, None] - s_h[:, :, None, :]      # (B, H, i, j)
        gmat = torch.where(causal, scores * exp_fn(torch.clamp(decay, max=0.0)),
                           0.0)
        y_intra = torch.einsum("bhij,bjhp->bihp", gmat, xc)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bihn,bhnp->bihp",
                               cc * exp_fn(s_cum)[..., None], s)
        # S' = exp(Σ la)·S + Σ_j exp(s_end − s_j) B_j xdt_jᵀ
        tail = exp_fn(s_cum[:, -1:] - s_cum)                 # (B, ch, H)
        s = (exp_fn(s_cum[:, -1])[..., None, None] * s
             + torch.einsum("bjhn,bjhp->bhnp", bc * tail[..., None], xc))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, 1)[:, :l], s


def mamba2_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                 cache: Optional[Params] = None) -> torch.Tensor:
    """x (B, L, D) → (B, L, D) (the reference's ``mamba2_apply``).  With a
    ``cache`` ({"conv" (B, K-1, di + 2GN), "S" (B, H, N, P) f32}) the conv
    and the scan start from its state and write their last state into
    it."""
    exp_fn = ssm_exp(cfg)
    b, l, _ = x.shape
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    h, pdim = mamba2_heads(cfg), cfg.ssm_head_dim
    zxbcdt = dense_apply(p["in_proj"], x)
    z, xbc, dt_raw = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * g * n],
                      zxbcdt[..., 2 * di + 2 * g * n:])
    xbc, conv_state = causal_conv(xbc, p["conv_w"], p["conv_b"],
                                  None if cache is None else cache["conv"])
    xbc = F.silu(xbc)
    xs, bmat, cmat = xbc[..., :di], xbc[..., di:di + g * n], xbc[..., di + g * n:]
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"])      # (B, L, H)
    a = -torch.exp(p["A_log"])                                  # (H,) < 0
    log_a = dt * a                                              # (B, L, H) ≤ 0
    xh = xs.to(torch.float32).reshape(b, l, h, pdim)
    xdt = xh * dt[..., None]
    rep = h // g
    bh = torch.repeat_interleave(
        bmat.to(torch.float32).reshape(b, l, g, n), rep, dim=2)
    ch = torch.repeat_interleave(
        cmat.to(torch.float32).reshape(b, l, g, n), rep, dim=2)
    s0 = (cache["S"].to(torch.float32) if cache is not None else
          torch.zeros((b, h, n, pdim), dtype=torch.float32, device=x.device))
    if l == 1:                    # decode: one recurrence step
        a_step = exp_fn(log_a[:, 0])                            # (B, H)
        s_last = (a_step[..., None, None] * s0
                  + bh[:, 0, :, :, None] * xdt[:, 0, :, None, :])
        y = torch.matmul(ch[:, 0, :, None, :], s_last)[:, None, :, 0]
    else:
        y, s_last = ssd_chunked(exp_fn, log_a, bh, ch, xdt, s0, cfg.ssm_chunk)
    y = y + p["D"][:, None] * xh
    y = gated_rmsnorm(p["norm_scale"], y.reshape(b, l, di), z).to(x.dtype)
    _write_state(cache, conv=conv_state, S=s_last)
    return dense_apply(p["out_proj"], y)


def mamba2_cache_init(cfg: ModelConfig, batch: int, layers: int = 1,
                      device=None) -> Params:
    """``layers`` Mamba-2 layers' streaming state, stacked, the batch on
    axis 1: ``conv`` (layers, B, K-1, di + 2GN) in the model dtype and
    ``S`` (layers, B, H, N, P) f32, zeros."""
    dt = getattr(torch, cfg.dtype)
    return {"conv": torch.zeros((layers, batch, cfg.ssm_conv - 1,
                                 conv_width(cfg)), dtype=dt, device=device),
            "S": torch.zeros((layers, batch, mamba2_heads(cfg),
                              cfg.ssm_state, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device)}


MAMBA2_KEYS: Sequence[str] = ("ln", "in_proj", "conv_w", "conv_b", "dt_bias",
                              "A_log", "D", "norm_scale", "out_proj")
