"""Twin engines in the padded-block oracle mode beside deepseek-7b's mixed
trace (``test_torch_padded.py``): JAX ``EngineCore(mode="padded")`` vs
the port's ``EngineCore(mode="padded", device="cpu")`` step by step
(``tests/_torch_twin.py::run_twins(mode="padded", pools=True)``) on
gemma2-9b-smoke (local layers with a window of 8 at page size 8, attention
and final softcaps; biases and norm scales perturbed from a numpy seed),
on granite-moe-3b-a800m-smoke in f32 (every row of the block routed,
padding included, as the reference routes it), and on deepseek-7b-smoke's
preemption trace (``tests/test_engine_core.py:186``: lanes 2, page 4, a
pool of 8 pages that cannot hold both peaks).  Plans, evictions, block
inputs, tables, cursors, free heap, refcounts and trace counts are equal
after every step, the pools outside the scratch page by
``assert_pools_close``'s rule, and the greedy streams identical.  About
20 s alone (mostly the reference engine's JAX compiles), one intra-op
thread."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tests._torch_twin import build, prompts_for, run_twins  # noqa: E402

FAMILY = dict(lanes=2, page_size=8, num_pages=24, chunk_size=8)


@pytest.mark.parametrize("name,lens,news", [
    ("gemma2-9b-smoke", (5, 19, 11), (6, 6, 6)),
    ("granite-moe-3b-a800m-smoke", (5, 12, 9), (4, 4, 4))])
def test_twin_padded_engines_serve_the_family(monkeypatch, name, lens, news):
    """gemma2-9b-smoke: local layers mask keys once a lane passes the
    window of 8 (page size 8), with attention and final softcaps; biases
    and norm scales perturbed.  granite-moe-3b-a800m-smoke in f32: every
    row of the block is routed, padding rows included, as the reference
    routes them.  Streams identical, pools held every step."""
    b = build("float32", False, name, perturb=5 if "gemma" in name else None)
    out = run_twins(monkeypatch, dtype="float32", kv_quant=False,
                    prompts=prompts_for(512, 13, lens), max_new=news,
                    engine_kw=FAMILY, built=b, mode="padded", pools=True)
    assert out["mixed"] and out["pages_in_use"] == (0, 0)
    assert not out["forked"]
    assert out["streams"][0] == out["streams"][1]


def test_twin_padded_engines_preemption(monkeypatch):
    """The preemption trace (``tests/test_engine_core.py:186``): 8 pages
    of 4 cannot hold both peaks, so the youngest resident is evicted and
    resumes; plans (``Scheduler.plans_for``), evictions and block inputs
    equal the reference's on every step."""
    out = run_twins(monkeypatch, dtype="float32", kv_quant=False,
                    prompts=prompts_for(512, 21, (4, 12)), max_new=(26, 14),
                    engine_kw=dict(lanes=2, page_size=4, num_pages=8,
                                   chunk_size=4),
                    mode="padded", pools=True)
    assert out["preempted"]
    assert out["streams"][0] == out["streams"][1]
