"""Per-request sampling records, stop matching and the greedy pick (port of
``src/repro/serving/sampling.py``).  This slice serves greedy requests;
seeded sampling (the reference's threefry keys) is a later slice."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


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


def greedy_rows(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) → (...,) int32 greedy picks: the *lowest* index among joint
    maxima, written out rather than left to ``argmax``'s tie behaviour."""
    v = logits.shape[-1]
    iota = torch.arange(v, dtype=torch.int32, device=logits.device)
    hit = logits == torch.amax(logits, dim=-1, keepdim=True)
    return torch.amin(torch.where(hit, iota, v), dim=-1).to(torch.int32)
