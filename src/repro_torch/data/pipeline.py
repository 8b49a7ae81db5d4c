"""Deterministic, shardable, resumable synthetic token pipeline (port of
``src/repro/data/pipeline.py``, numpy only and copied as it is: the same
(seed, step, shard) gives the same batch bits in both packages).

Every batch is a *pure function of (seed, step, shard)* via a counter-based
Philox generator — the fault-tolerance keystone (DESIGN.md §4):

- **resumable**: restoring a checkpoint at step S and continuing reproduces
  the exact batch sequence — no data-iterator state to snapshot;
- **straggler/failure mitigation**: any host can recompute any shard's batch
  (a rejoining or backup host needs no state handoff);
- **elastic**: re-sharding to a different host count at step S just changes
  (shard, num_shards) — global batch content is identical because shards
  partition the *global* batch deterministically.

Two corpora:
- ``lm``   — first-order Markov tokens (structured → a model can learn it;
             used by the convergence example/tests);
- ``copy`` — random prefix + its repetition (loss on the copied half drops
             fast — a sharp learnability signal).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus: str = "lm"              # lm | copy | uniform
    markov_branch: int = 4          # lm: successors per token


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.corpus in ("lm", "copy", "uniform"), cfg.corpus
        self.cfg = cfg
        if cfg.corpus == "lm":
            # Fixed sparse Markov transition table, derived from seed only.
            root = np.random.Generator(np.random.Philox(key=cfg.seed))
            self._succ = root.integers(
                0, cfg.vocab_size,
                size=(cfg.vocab_size, cfg.markov_branch)).astype(np.int64)

    # -- deterministic RNG per step -----------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        # Philox counter-based: the 2-word key fully determines the stream.
        # One stream per STEP (not per shard): every host synthesises the
        # same global batch and slices its shard, so shards exactly tile the
        # global batch at any host count (elasticity invariant, tested).
        return np.random.Generator(np.random.Philox(
            key=(self.cfg.seed * 0x9E3779B1, 7919 * step + 1)))

    # -- batch synthesis -----------------------------------------------------
    def _tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        c = self.cfg
        if c.corpus == "uniform":
            return rng.integers(0, c.vocab_size, size=(n, c.seq_len))
        if c.corpus == "copy":
            half = c.seq_len // 2
            prefix = rng.integers(0, c.vocab_size, size=(n, half))
            return np.concatenate(
                [prefix, prefix[:, : c.seq_len - half]], axis=1)
        # lm: walk the Markov table
        toks = np.empty((n, c.seq_len), np.int64)
        toks[:, 0] = rng.integers(0, c.vocab_size, size=n)
        choices = rng.integers(0, c.markov_branch, size=(n, c.seq_len))
        for t in range(1, c.seq_len):
            toks[:, t] = self._succ[toks[:, t - 1], choices[:, t]]
        return toks

    def shard_batch(self, step: int, shard: int = 0, num_shards: int = 1
                    ) -> Dict[str, np.ndarray]:
        """The ``shard``-th contiguous slice of the global batch at ``step``."""
        c = self.cfg
        assert c.global_batch % num_shards == 0, (c.global_batch, num_shards)
        per = c.global_batch // num_shards
        toks = self._tokens(self._rng(step), c.global_batch).astype(np.int32)
        toks = toks[shard * per: (shard + 1) * per]
        batch = {"tokens": toks, "labels": toks.copy()}
        if c.corpus == "copy":
            mask = np.zeros_like(toks, np.float32)
            mask[:, c.seq_len // 2:] = 1.0       # score only the copied half
            batch["loss_mask"] = mask
        return batch

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        return self.shard_batch(step, 0, 1)


def host_shard(global_batch: int, host: int, num_hosts: int
               ) -> Tuple[int, int]:
    """(start, size) of this host's slice — pure arithmetic, no coordination."""
    per = global_batch // num_hosts
    return host * per, per
