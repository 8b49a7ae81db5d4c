"""Token-choice top-k Mixture-of-Experts layer (port of
``src/repro/models/moe.py``): granite-moe, grok-1.

GShard/Switch routing with per-expert capacity, as the reference computes
it: tokens split into groups of at most ``cfg.moe_group``
(``_group_size``), an f32 router whose softmax runs on the LUT
exponential (kernel #1, ``kernels/lut_exp``, one launch per layer), ``k``
rounds of top-1 over the remaining probabilities, and each (round, token)
pair given the next slot of its expert; a choice past the expert's
capacity ``C`` (``moe_capacity``) is dropped and the residual carries it.

The reference expresses dispatch and combine as one-hot (t, E, C) tensors
and einsums.  The port keeps the same routing as indices (``Route``: per
round and token the expert, the gate, the slot and the keep flag) and
moves rows instead of multiplying by one-hots:

  expert_in[e, c]  = x[token in slot c of expert e]   (a gather; exact —
                     the reference's one-hot f32 einsum of x is exact too)
  expert_out       = FFN_e(expert_in), batched over E (``device.dense``
                     for ``h``, rounded to x's dtype; the down product
                     kept in f32)
  y[t]             = Σ_rounds w[r, t] · expert_out[e_r, slot_r], summed in
                     round order in f32, then cast to x's dtype

with ``w`` the gates renormalised over the kept choices.  The slot table
is written with a plain scatter: a kept choice owns its (expert, slot)
alone, dropped ones all land in one spare slot per expert that is
thrown away, and nothing is accumulated by atomics, so a CUDA graph's
replay gives the eager call's bits.  Every shape depends only on the
token count, and nothing is read back to the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.lut_softmax import lut_softmax
from repro_torch.device import configure_matmul_precision, dense
from repro_torch.kernels.lut_exp.ops import lut_exp
from repro_torch.models.layers import _ACTS
from repro_torch.parallel.collectives import all_reduce, all_reduce_grad

Params = Dict[str, torch.Tensor]


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert capacity: cf · k · T / E, rounded up to a multiple of 8."""
    c = cfg.moe_capacity_factor * cfg.experts_per_token * n_tokens / cfg.num_experts
    return max(8, int(-(-c // 8) * 8))


def _group_size(cfg: ModelConfig, t: int) -> int:
    """Largest divisor of t not exceeding cfg.moe_group."""
    g = min(cfg.moe_group, t)
    while t % g:
        g -= 1
    return g


class Route(NamedTuple):
    """The routing of G groups of t tokens, each (G, k, t), round-major:
    the chosen expert (int64), its gate (the router probability, f32),
    its slot in that expert (int64; may pass the capacity) and whether
    the choice is kept (slot < capacity)."""
    expert: torch.Tensor
    gate: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor


def topk_route(cfg: ModelConfig, probs: torch.Tensor, capacity: int) -> Route:
    """The reference's ``_topk_dispatch`` as indices.  probs (G, t, E) f32.

    Each of the k rounds takes the maximum of the remaining probabilities
    — ties to the lowest expert index, as ``jnp.argmax`` — and zeroes it.
    A choice's slot is the number of earlier (round, token) pairs routed
    to its expert, dropped ones included: an exclusive running count over
    the choices in round-major order."""
    g, t, e = probs.shape
    remaining = probs.clone()
    experts, gates = [], []
    for _ in range(cfg.experts_per_token):
        gate, choice = torch.max(remaining, dim=-1)             # (G, t)
        remaining.scatter_(-1, choice[..., None], 0.0)
        experts.append(choice)
        gates.append(gate)
    expert = torch.stack(experts, 1)                            # (G, k, t)
    flat = expert.reshape(g, -1, 1)                             # (G, k·t, 1)
    onehot = (flat == torch.arange(e, device=probs.device)).to(torch.int32)
    before = torch.cumsum(onehot, dim=1) - onehot
    slot = torch.gather(before, 2, flat).reshape(expert.shape).to(torch.int64)
    return Route(expert, torch.stack(gates, 1), slot, slot < capacity)


def _router_exp(cfg: ModelConfig):
    """The router softmax's exponential: kernel #1's wrapper at the LUT's
    order (the kernel on a CUDA tensor, its plain version on the CPU),
    or ``torch.exp`` for ``exp_mode="exact"``."""
    if cfg.exp_mode == "exact":
        return torch.exp
    order = {"lut": 1, "lut0": 0}[cfg.exp_mode]
    return lambda z: lut_exp(z, order=order)


class _BmmF32Out(torch.autograd.Function):
    """``aten::bmm.dtype`` (bf16 × bf16 → f32), which has no derivative,
    with the reference's, as ``layers._MatmulF32Out`` for the unembed: its
    einsum's transpose takes the f32 cotangent against the widened other
    operand and casts the result to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.bmm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da = torch.bmm(g, w.transpose(1, 2).float()).to(a.dtype)
        dw = torch.bmm(a.transpose(1, 2).float(), g).to(w.dtype)
        return da, dw


def _bmm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, N, K) @ (E, K, M) summed and returned in f32, as the reference's
    down einsum (no cast after it): on the card bf16 × bf16 → f32 through
    ``aten::bmm.dtype`` (under autograd ``_BmmF32Out`` adds the backward),
    elsewhere both operands widened to f32."""
    if a.device.type == "cuda" and a.dtype == w.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            return _BmmF32Out.apply(a, w)
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), w.to(torch.float32))


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              with_aux: bool = True, dp_axes=()
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, L, D) → (y (B, L, D), the load-balancing loss, an f32 scalar,
    or None without ``with_aux``).  ``p``: ``router`` (D, E) f32, ``up`` /
    ``gate`` (E, D, F), ``down`` (E, F, D).  Every token is routed, as the
    reference routes them: a caller's padding rows take expert capacity
    too.  ``dp_axes``: the mesh axes whose ranks hold the batch's other
    rows (a training step's data-parallel split).  The loss is not linear
    in the rows, so the routed fractions and the mean probabilities are
    summed over those ranks before the product (the latter under autograd:
    each rank's loss takes the global statistics)."""
    if x.device.type == "cuda":
        configure_matmul_precision()       # the router must not run on TF32
    b, l, d = x.shape
    tg = _group_size(cfg, b * l)
    g = b * l // tg
    e, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(g, tg, d)
    logits = torch.matmul(xt.to(torch.float32), p["router"])    # (G, t, E)
    probs = lut_softmax(logits, exp=_router_exp(cfg))
    cap = moe_capacity(cfg, tg)
    route = topk_route(cfg, probs, cap)
    dev = x.device

    # slot table (G, E, C + 1): token of each slot, ``tg`` (a zero row) where
    # empty; the last slot of each expert takes the dropped choices
    tok = torch.arange(tg, device=dev).expand(g, k, tg)
    dest = route.expert * (cap + 1) + torch.where(route.keep, route.slot, cap)
    table = torch.full((g, e * (cap + 1)), tg, dtype=torch.int64, device=dev)
    table.scatter_(1, dest.reshape(g, -1), tok.reshape(g, -1))
    table = table.view(g, e, cap + 1)[:, :, :cap]
    rows = table + (torch.arange(g, device=dev) * (tg + 1))[:, None, None]
    x_pad = torch.cat([xt, xt.new_zeros((g, 1, d))], 1).reshape(-1, d)
    expert_in = x_pad[rows.transpose(0, 1).reshape(e, g * cap)]  # (E, G·C, D)

    act = _ACTS[cfg.act]
    h = dense(expert_in, p["up"])                   # (E, G·C, F), x's dtype
    if cfg.mlp_gated:
        h = act(dense(expert_in, p["gate"])) * h
    else:
        h = act(h)
    out = _bmm_f32(h, p["down"]).reshape(e * g * cap, d)

    # combine: each token's kept choices, gates renormalised over them
    kept = torch.where(route.keep, route.gate, 0.0)              # (G, k, t)
    w = kept / torch.clamp(torch.sum(kept, dim=1, keepdim=True), min=1e-9)
    at = (route.expert * (g * cap)
          + (torch.arange(g, device=dev) * cap)[:, None, None]
          + torch.clamp(route.slot, max=cap - 1))
    y = out[at[:, 0]] * w[:, 0, :, None]
    for r in range(1, k):
        y = y + out[at[:, r]] * w[:, r, :, None]
    y = y.to(x.dtype).reshape(b, l, d)
    if not with_aux:
        return y, None
    # Switch eq. 4: E · Σ_e f_e · P_e / k
    routed = ((route.expert[..., None] == torch.arange(e, device=dev))
              & route.keep[..., None]).to(torch.float32).sum(dim=(0, 1, 2))
    if dp_axes:
        prob_sum, n = torch.sum(probs, dim=(0, 1)), g * tg
        for a in dp_axes:
            routed = all_reduce(routed, "sum", a)
            prob_sum, n = all_reduce_grad(prob_sum, a), n * a.size
        frac_routed, frac_prob = routed / n, prob_sum / n
    else:
        frac_routed = routed / (g * tg)
        frac_prob = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(frac_routed * frac_prob) / k
    return y, aux
