"""Draft proposers for speculative decoding: prompt-lookup n-gram drafts
(port of ``src/repro/serving/spec.py``; numpy only).

A proposer is any callable ``(stream, k) -> drafts``: ``stream`` is a
decode lane's known tokens (prompt ⊕ generated), ``k`` the most drafts
the scheduler can afford this step, and ``drafts`` up to ``k`` proposed
next tokens (empty: no proposal, which costs the step nothing).  The
engine verifies every draft in the same ragged step and commits the
longest prefix that equals its own greedy picks, so a wrong draft costs
rows of work, never a token.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np


def _match_continuation(hay: np.ndarray, pattern: np.ndarray,
                        k: int) -> Optional[np.ndarray]:
    """Most recent occurrence of ``pattern`` in ``hay`` with a non-empty
    continuation → up to ``k`` following tokens, else None."""
    n = len(pattern)
    if n == 0 or len(hay) <= n:
        return None
    # windows[i] == hay[i:i+n]; exclude the final window (no continuation)
    wins = np.lib.stride_tricks.sliding_window_view(hay, n)[:-1]
    hits = np.flatnonzero((wins == pattern[None, :]).all(axis=1))
    if len(hits) == 0:
        return None
    i = int(hits[-1])                       # most recent occurrence
    return hay[i + n:i + n + k]


class NGramProposer:
    """Prompt-lookup drafts: longest-suffix n-gram match, most recent first.

    ``propose(stream, k)`` takes the stream's trailing ``n``-gram for
    ``n = max_ngram .. min_ngram`` and returns the continuation of its most
    recent earlier occurrence: in the lane's own stream first, then (with
    ``history`` > 0) in the finished streams published through
    ``observe``.  A pure function of the streams it has seen, so greedy
    speculative decoding stays reproducible.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 history: int = 0, obs=None):
        assert max_ngram >= min_ngram >= 1
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.history = history
        self.obs = obs                      # ServingObservability
        # insertion-ordered ring of finished streams, newest last
        self._streams: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.proposals = 0                  # non-empty proposals
        self.proposed_tokens = 0

    # ------------------------------------------------------------- lookup
    def propose(self, stream: Sequence[int], k: int) -> List[int]:
        s = np.asarray(stream, np.int64)
        if k <= 0 or len(s) < self.min_ngram:
            return []
        for n in range(min(self.max_ngram, len(s)), self.min_ngram - 1, -1):
            pat = s[len(s) - n:]
            out = _match_continuation(s, pat, k)
            if out is None and self.history:
                for hist in reversed(self._streams.values()):
                    # a finished stream is all "earlier": match anywhere,
                    # including its own tail
                    wins = (np.lib.stride_tricks.sliding_window_view(hist, n)
                            if len(hist) >= n else np.zeros((0, n), np.int64))
                    hits = np.flatnonzero((wins == pat[None, :]).all(axis=1))
                    cont = None
                    for i in hits[::-1]:
                        cont = hist[int(i) + n:int(i) + n + k]
                        if len(cont):
                            break
                        cont = None
                    if cont is not None:
                        out = cont
                        break
            if out is not None and len(out):
                out = [int(t) for t in out]
                self.proposals += 1
                self.proposed_tokens += len(out)
                if self.obs is not None:
                    self.obs.spec_proposed(len(out))
                return out
        return []

    __call__ = propose

    # ------------------------------------------------------------ history
    def observe(self, stream: Sequence[int]) -> None:
        """Publish a finished request's stream into the lookup history
        (no-op unless ``history`` > 0; the oldest streams fall off)."""
        if not self.history:
            return
        key = len(self._streams) and next(reversed(self._streams)) or 0
        self._streams[key + 1] = np.asarray(stream, np.int64)
        while len(self._streams) > self.history:
            self._streams.popitem(last=False)
