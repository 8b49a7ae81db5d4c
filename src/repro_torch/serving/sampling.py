"""Per-request sampling: records, stop matching, the greedy pick and the
seeded in-step sampler (port of ``src/repro/serving/sampling.py``).

The sampler draws each lane's token from its ``last_idx`` logits row:

    temperature-scale → top-k mask → top-p (nucleus) mask over the
    LUT-softmax probabilities → Gumbel-max draw over the LUT log-softmax
    scores

with the reference's keys, ``fold_in(PRNGKey(seed), #generated)``
through the port's bit-exact threefry (``core/prng.py``): a request's
stream is a function of its own (seed, params, prompt) and never of the
lane it lands on, its neighbours or a preemption.  Temperature ≤ 0 rows
take ``greedy_rows``, bit for bit.  The two exponentials over the
(rows, V) scores launch the LUT-exp kernel (``kernels/lut_exp``) on the
card and run its plain version on the CPU.

Every operation is a tensor operation on the device and nothing reads a
device value on the host, so the draw can be captured in a CUDA graph.
The reference skips the draw with a ``lax.cond`` when no row samples; a
graph cannot branch on device data, so here the caller decides from the
host copy of the temperatures whether to call the sampler at all (the
result is the same: the draw's greedy rows are ``greedy_rows``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.lut_softmax import (NEG_INF, ExpFn, lut_log_softmax,
                                          lut_softmax)
from repro_torch.kernels.lut_exp.ops import lut_exp


class InvalidRequest(ValueError):
    """A request that can never be served correctly, rejected at
    construction/submit.  ``field`` names the offending parameter."""

    def __init__(self, field: str, detail: str, uid=None):
        self.field = field
        self.uid = uid
        who = f"request {uid}: " if uid is not None else ""
        super().__init__(f"{who}invalid {field}: {detail}")


def _as_stop(stop) -> Tuple[Tuple[int, ...], ...]:
    seqs = []
    for s in stop:
        if isinstance(s, (int, np.integer)):
            s = (s,)
        seq = tuple(int(t) for t in s)
        if not seq:
            raise InvalidRequest("stop", "empty stop sequence")
        if any(t < 0 for t in seq):
            raise InvalidRequest("stop", f"negative token id in {seq}")
        seqs.append(seq)
    return tuple(seqs)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling record, validated at construction.
    ``temperature <= 0`` means greedy (lowest-index tie-break); ``stop`` is a
    tuple of stop sequences (a bare int is a one-token sequence)."""
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    stop: Tuple[Tuple[int, ...], ...] = ()
    max_tokens: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0.0 and self.seed is not None:
            raise InvalidRequest(
                "temperature",
                f"negative temperature ({self.temperature}) is greedy — a "
                f"seed ({self.seed}) would never be used")
        if self.top_k is not None and self.top_k <= 0:
            raise InvalidRequest("top_k", f"must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise InvalidRequest("top_p",
                                 f"must be in (0, 1], got {self.top_p}")
        if self.seed is not None and not 0 <= self.seed < 2 ** 32:
            raise InvalidRequest("seed",
                                 f"must be a uint32, got {self.seed}")
        if self.max_tokens is not None and self.max_tokens <= 0:
            raise InvalidRequest("max_tokens",
                                 f"must be >= 1, got {self.max_tokens}")
        object.__setattr__(self, "stop", _as_stop(self.stop))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def validate_stop_tokens(params: SamplingParams, vocab_size: int,
                         uid=None) -> None:
    """Stop-token ids must lie inside the model's vocab."""
    for s in params.stop:
        bad = [t for t in s if t >= vocab_size]
        if bad:
            raise InvalidRequest(
                "stop", f"token ids {bad} outside vocab of {vocab_size}",
                uid=uid)


def stop_hit(tokens: Sequence[int], stop: Tuple[Tuple[int, ...], ...]
             ) -> Optional[int]:
    """If ``tokens`` end with a stop sequence → index of the match's first
    token (the truncation point); else None."""
    n = len(tokens)
    for s in stop:
        ls = len(s)
        if n >= ls and tuple(tokens[n - ls:]) == s:
            return n - ls
    return None


def stop_holdback(tokens: Sequence[int], stop: Tuple[Tuple[int, ...], ...]
                  ) -> int:
    """How many of ``tokens`` are safe to stream: all but the longest suffix
    that is a proper prefix of some stop sequence."""
    n = len(tokens)
    hold = 0
    for s in stop:
        for length in range(min(len(s) - 1, n), 0, -1):
            if tuple(tokens[n - length:]) == s[:length]:
                hold = max(hold, length)
                break
    return n - hold


def greedy_rows(logits: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., V) → (...,) int32 greedy picks: the *lowest* index among joint
    maxima, written out rather than left to ``argmax``'s tie behaviour;
    written into ``out`` (int32, of the picks' shape) when given."""
    v = logits.shape[-1]
    iota = torch.arange(v, dtype=torch.int32, device=logits.device)
    hit = logits == torch.amax(logits, dim=-1, keepdim=True)
    idx = torch.where(hit, iota, v)
    if out is None:
        return torch.amin(idx, dim=-1)
    return torch.amin(idx, dim=-1, out=out)


def _request_keys(seed: torch.Tensor, counter: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane PRNG key words ``fold_in(PRNGKey(seed), counter)``: the
    request's own seed and generated-token count, nothing else."""
    return prng.fold_in(*prng.prng_key(seed), counter)


def _masked_scores(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor, exp: ExpFn
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, V) f32 logits → (the temperature-scaled, max-shifted, top-k
    masked scores ``x``; the top-p ``keep`` mask), the reference's
    pipeline up to the draw.

    One stable sort of ``-x`` serves both masks.  Its k-th entry is the
    reference's k-th largest threshold; its order restricted to the kept
    tokens is the reference's ``argsort(-x)`` after the top-k mask, and
    the masked tail, ordered otherwise, carries probability 0, so the
    cumulative mass and the keep mask come out the same."""
    n, v = logits.shape
    t = torch.where(temperature > 0.0, temperature, 1.0)[:, None]
    # The max-shift goes before the divide, so t → 0+ stays finite.
    x = torch.clamp((logits - torch.amax(logits, dim=-1, keepdim=True)) / t,
                    min=NEG_INF)
    neg_sorted, order = torch.sort(-x, dim=-1, stable=True)
    k = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v).long()
    kth = -neg_sorted.gather(-1, (k - 1)[:, None])
    x = torch.where(x >= kth, x, NEG_INF)
    # top-p: a token survives while the mass strictly before it is < p (the
    # head token always does); p >= 1 keeps the vocabulary outright.
    probs = lut_softmax(x, exp=exp).gather(-1, order)
    csum = torch.cumsum(probs, dim=-1)
    p = torch.clamp(top_p.float(), 0.0, 1.0)[:, None]
    keep_sorted = ((csum - probs) < p) | (p >= 1.0)
    keep = torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return x, keep


def sample_rows(logits: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor, seed: torch.Tensor,
                counter: torch.Tensor, *, exp: ExpFn = lut_exp
                ) -> torch.Tensor:
    """(N, V) logits and (N,) per-row params → (N,) int32 tokens.

    ``temperature`` ≤ 0 rows take ``greedy_rows``; the rest are drawn by
    Gumbel-max over the masked LUT log-softmax scores with the row's own
    key.  ``top_k`` 0 and ``top_p`` 1 disable the masks.  ``seed`` and
    ``counter`` hold uint32 values in any integer dtype."""
    logits = logits.to(torch.float32)
    v = logits.shape[-1]
    x, keep = _masked_scores(logits, temperature, top_k, top_p, exp)
    scores = lut_log_softmax(x, where=keep, exp=exp)
    g = prng.gumbel(*_request_keys(seed, counter), v)
    # argmax, the first index among ties, as jnp.argmax picks it
    pick = greedy_rows(scores + g)
    return torch.where(temperature > 0.0, pick, greedy_rows(logits))


def sample_in_step(logits: torch.Tensor, *, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor,
                   seed: torch.Tensor, counter: torch.Tensor,
                   exp: ExpFn = lut_exp) -> torch.Tensor:
    """The ragged step's sampling region: ``(lanes, V)`` last-idx logits →
    ``(lanes,)`` tokens.  The speculative form ``(lanes, 1 + k, V)`` →
    ``(lanes, 1 + k)``: row 0 samples with the lane's params and rows ≥ 1,
    the verify rows, are greedy (the reference forces their temperature to
    0; rows are independent, so drawing row 0 alone gives its tokens)."""
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
              counter=counter, exp=exp)
    if logits.dim() == 2:
        return sample_rows(logits, **kw)
    head = sample_rows(logits[:, 0], **kw)
    return torch.cat([head[:, None], greedy_rows(logits[:, 1:])], dim=1)


def sample_row(logits_row: torch.Tensor, params: SamplingParams,
               n_generated: int) -> int:
    """One row drawn on its own: the in-step sampler on a (1, V) row with
    ``params`` and the request's generated-token count."""
    dev = logits_row.device
    out = sample_rows(
        logits_row.reshape(1, -1),
        torch.tensor([params.temperature], dtype=torch.float32, device=dev),
        torch.tensor([params.top_k or 0], dtype=torch.int32, device=dev),
        torch.tensor([1.0 if params.top_p is None else params.top_p],
                     dtype=torch.float32, device=dev),
        torch.tensor([params.seed or 0], dtype=torch.int64, device=dev),
        torch.tensor([n_generated], dtype=torch.int64, device=dev))
    return int(out[0])
