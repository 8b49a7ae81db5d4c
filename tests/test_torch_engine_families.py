"""Twin engines, JAX ``EngineCore`` vs the PyTorch port, serving the dense
families beside deepseek-7b (``tests/_torch_twin.py``, step by step):
``gemma2-9b-smoke`` on f32 and int8 pools, ``gemma3-12b-smoke`` and
``starcoder2-3b-smoke`` on f32 pools.  Two lanes, page size 8 (= the
smoke window: the widest page the window allows), 24 pages, chunk 8;
prompts of 5, 19 and 11 tokens, 6 new each, so local layers mask keys
once a lane passes position 8.  Biases and norm scales are perturbed
from a numpy seed first.  Plans, streams, tables, cursors, free heap and
refcounts are equal after every step; greedy streams are identical on
f32 pools and, on the int8 pool, identical save a fork the near-tie
margin rule explains.  The port also serves gemma2-9b-smoke at page 4,
with the page-8 streams.  About 100 s alone (mostly the reference
engine's JAX compile), one intra-op thread."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tests._torch_twin import build, prompts_for, run_twins  # noqa: E402

LENS = (5, 19, 11)
NEWS = (6, 6, 6)
ENGINE = dict(lanes=2, page_size=8, num_pages=24, chunk_size=8)


@pytest.mark.parametrize("name,kv_quant", [
    ("gemma2-9b-smoke", False), ("gemma2-9b-smoke", True),
    ("gemma3-12b-smoke", False), ("starcoder2-3b-smoke", False)])
def test_twin_engines_serve_the_family(monkeypatch, name, kv_quant):
    built = build("float32", kv_quant, name, perturb=5)
    prompts = prompts_for(512, 13, LENS)
    assert max(LENS) > built[1].window if built[1].window else True
    out = run_twins(monkeypatch, dtype="float32", kv_quant=kv_quant,
                    prompts=prompts, max_new=NEWS, engine_kw=ENGINE,
                    built=built)
    assert out["pages_in_use"] == (0, 0)
    assert all(len(s) == 6 for s in out["streams"][1].values())
    if not kv_quant:
        assert not out["forked"]
        assert out["streams"][0] == out["streams"][1]
    assert len(out["forked"]) <= 1, out["near_ties"]
    if name == "gemma2-9b-smoke" and not kv_quant:
        from repro_torch.serving import EngineCore, Request
        eng = EngineCore(built[1], built[3], device="cpu",
                         **dict(ENGINE, page_size=4, num_pages=48))
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=NEWS[i]))
        got = {r.uid: r.tokens for r in eng.run()}
        assert got == out["streams"][1]
        assert np.all([len(t) == 6 for t in got.values()])
