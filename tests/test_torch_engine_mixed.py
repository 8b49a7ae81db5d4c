"""Twin engines, JAX ``EngineCore`` vs the PyTorch port, on the mixed
chunked-prefill + decode trace of ``test_engine_core.py:53`` (prompt
lengths straddling chunk and page boundaries, 3 lanes, page size 8,
24 pages, chunk 8).  Plans, packed streams, page tables, cursors, free
heap and refcounts are equal after every step; greedy streams are
identical for float pools in f32 and bf16 and, for int8 pools, identical
except at a genuine near-tie (see ``tests/_torch_twin.py``)."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tests._torch_twin import prompts_for, run_twins  # noqa: E402

LENS = (3, 21, 9, 14, 6)
NEWS = (7, 5, 9, 4, 6)
ENGINE = dict(lanes=3, page_size=8, num_pages=24, chunk_size=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_twin_engines_mixed_trace(monkeypatch, dtype, kv_quant):
    out = run_twins(monkeypatch, dtype=dtype, kv_quant=kv_quant,
                    prompts=prompts_for(512, 13, LENS), max_new=NEWS,
                    engine_kw=ENGINE)
    assert out["mixed"], "no step mixed prefill with decode"
    assert out["pages_in_use"] == (0, 0)
    if not kv_quant:
        assert not out["forked"]
        assert out["streams"][0] == out["streams"][1]
    assert len(out["forked"]) <= 1, out["near_ties"]
