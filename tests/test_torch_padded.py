"""Twin engines in the padded-block oracle mode, JAX ``EngineCore(mode=
"padded")`` vs the PyTorch port's ``EngineCore(mode="padded",
device="cpu")``, on the mixed chunked-prefill + decode trace of
``tests/test_engine_core.py:51`` (prompt lengths straddling chunk and page
boundaries, 3 lanes, page size 8, 24 pages, chunk 8), f32 and bf16, float
and int8 pools (``tests/_torch_twin.py::run_twins(mode="padded")``).

After every step: equal plans, equal block inputs (right-aligned tokens,
the power-of-two table, kv_len, q_len), equal page tables, cursors, free
heap and refcounts, equal trace counts (the port's distinct (C, table
width) shapes against JAX's retraces), equal live and padded rows, and the
two pools equal outside the scratch page by ``assert_pools_close``'s rule
(padding rows write there, several to one (page, offset), and which lands
is not fixed).  Greedy streams are identical on float pools; on int8
pools they are identical save a fork the near-tie margin rule explains.
About 24 s alone (the reference engine's JAX compiles), one intra-op
thread."""
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
def test_twin_padded_engines_mixed_trace(monkeypatch, dtype, kv_quant):
    out = run_twins(monkeypatch, dtype=dtype, kv_quant=kv_quant,
                    prompts=prompts_for(512, 13, LENS), max_new=NEWS,
                    engine_kw=ENGINE, mode="padded", pools=True)
    je, te = out["engines"]
    assert te.mode == je.mode == "padded"
    assert out["mixed"], "no step mixed prefill with decode"
    assert out["pages_in_use"] == (0, 0)
    assert te.trace_count == je.trace_count <= 3 * 2
    # every step ran the (lanes, C) block: C = 1 or the chunk
    assert {o.padded_rows for _, o in out["outs"] if o.lanes} <= {3, 3 * 8}
    if not kv_quant:
        assert not out["forked"]
        assert out["streams"][0] == out["streams"][1]
    assert len(out["forked"]) <= 1, out["near_ties"]
