"""Request-level serving API (port of ``src/repro/serving/api.py``): the
types every serving layer speaks."""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.sampling import InvalidRequest, SamplingParams


class RequestState(str, enum.Enum):
    WAITING = "waiting"        # submitted, not yet holding a lane
    PREFILL = "prefill"        # resident; prompt rows still streaming in
    DECODE = "decode"          # resident; one new token per step
    PREEMPTED = "preempted"    # evicted mid-flight; will resume by replay
    FINISHED = "finished"
    ABORTED = "aborted"        # cancelled by the client; pages released


@dataclasses.dataclass
class Request:
    """One generation request.  ``tokens``/``done``/``state`` are filled by
    the engine; everything else is client input.  ``temperature`` is a
    shorthand that seeds ``sampling`` when it is omitted."""
    uid: int
    prompt: np.ndarray                 # (Lp,) int32
    max_new: int = 32
    temperature: float = 0.0           # 0 = greedy
    eos_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    state: RequestState = RequestState.WAITING

    def __post_init__(self):
        if self.sampling is None:
            self.sampling = SamplingParams(temperature=self.temperature)
        self.temperature = self.sampling.temperature
        if self.sampling.max_tokens is not None:
            self.max_new = min(self.max_new, self.sampling.max_tokens)
        if self.max_new <= 0:
            raise InvalidRequest("max_new", f"must be >= 1, got "
                                 f"{self.max_new}", uid=self.uid)

    def known_tokens(self) -> np.ndarray:
        """prompt ⊕ generated: every token whose KV row must eventually be
        resident."""
        return np.concatenate(
            [np.asarray(self.prompt, np.int64),
             np.asarray(self.tokens, np.int64)]).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class StepOutput:
    """What one ``EngineCore.step()`` did."""
    tokens: Dict[int, int]             # uid → token sampled this step
    finished: Tuple[int, ...]          # uids completed this step
    preempted: Tuple[int, ...]         # uids evicted by this step's schedule
    lanes: int                         # lanes that ran (q_len > 0)
    prefill_tokens: int                # prompt-stream chunk tokens
    decode_tokens: int                 # sampling-step lanes
    live_rows: int = 0                 # live token rows in the stream
    padded_rows: int = 0               # bucketed stream width
    prefix_hit_tokens: int = 0         # known tokens granted from the cache
    # speculative accounting (0 unless the engine drafts): drafted tokens
    # streamed this step and those the verify accepted
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    # the varlen attention's block shapes the step ran with: the engine's
    # ``KernelConfig.describe()`` (block_q, block_pages, dequant, source,
    # kv_split), recorded on every step that ran the model
    kernel_config: Optional[Dict[str, Any]] = None

    @property
    def mixed(self) -> bool:
        """True when chunked prefill and decode shared this batch."""
        return self.prefill_tokens > 0 and self.decode_tokens > 0


class UnsupportedCacheLayout(ValueError):
    """A model's cache cannot be paged (raised at construction)."""

    def __init__(self, layout: str, model: str, detail: str):
        self.layout = layout
        super().__init__(
            f"paged KV cache: {model} uses an unpageable cache layout "
            f"[{layout}]: {detail}")
