"""PyTorch port vs JAX reference: the synthetic token pipeline (numpy only
in both packages) gives the same batches bit for bit, for every corpus,
step and shard; ``host_shard`` is the same arithmetic.  ~1 s alone."""
import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JPipeline  # noqa: E402
from repro.data import host_shard as j_host_shard  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline, host_shard  # noqa: E402


@pytest.mark.parametrize("corpus", ["lm", "copy", "uniform"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_bit_for_bit(corpus, seed):
    kw = dict(vocab_size=97, seq_len=13, global_batch=6, seed=seed,
              corpus=corpus)
    j, t = JPipeline(JDataConfig(**kw)), TokenPipeline(DataConfig(**kw))
    for step in (0, 1, 5, 1000):
        for shard, n in ((0, 1), (1, 2), (2, 3)):
            a, b = j.shard_batch(step, shard, n), t.shard_batch(step, shard, n)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert np.array_equal(a[k], b[k]), (step, shard, k)
    assert np.array_equal(j.global_batch(3)["tokens"],
                          t.global_batch(3)["tokens"])


def test_shards_tile_the_global_batch():
    t = TokenPipeline(DataConfig(vocab_size=50, seq_len=8, global_batch=8))
    whole = t.global_batch(4)["tokens"]
    parts = [t.shard_batch(4, s, 4)["tokens"] for s in range(4)]
    assert np.array_equal(np.concatenate(parts), whole)


def test_host_shard_matches_reference():
    for gb, n in ((8, 1), (8, 2), (12, 4), (7, 3)):
        for h in range(n):
            assert host_shard(gb, h, n) == j_host_shard(gb, h, n)
