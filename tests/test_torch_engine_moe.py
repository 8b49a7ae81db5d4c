"""Twin engines, JAX ``EngineCore`` vs the PyTorch port, serving the MoE
family (``tests/_torch_twin.py``, step by step): ``granite-moe-3b-a800m-
smoke`` on f32, bf16 and int8 pools and ``grok-1-314b-smoke`` on a bf16
pool.  Two lanes, page size 8, 24 pages, chunk 8; prompts of 5, 12 and 9
tokens, 4 new each.  Every step routes the whole bucketed stream, dead
rows included, on both sides.  Plans, streams, tables, cursors, free heap
and refcounts are equal after every step.  In f32 the greedy streams are
identical.  In bf16 the streams may fork only where the near-tie margin
rule explains it: a bf16 ulp of the residual stream moves a router
probability across a near-tie of two experts between the frameworks, and
the routing then differs in that layer (the reference's own bf16 and f32
runs part the same way); the int8 pool the same.  Then one serve-CLI run
of ``--arch granite-moe-3b-a800m-smoke --device cpu``, and the slot engine
on granite against the reference's.  About 70 s alone (mostly the
reference engines' JAX compile), one intra-op thread."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tests._torch_twin import build, prompts_for, run_twins  # noqa: E402

LENS = (5, 12, 9)
NEWS = (4, 4, 4)
ENGINE = dict(lanes=2, page_size=8, num_pages=24, chunk_size=8)


@pytest.mark.parametrize("name,dtype,kv_quant", [
    ("granite-moe-3b-a800m-smoke", "float32", False),
    ("granite-moe-3b-a800m-smoke", "bfloat16", False),
    ("granite-moe-3b-a800m-smoke", "bfloat16", True),
    ("grok-1-314b-smoke", "bfloat16", False)])
def test_twin_engines_serve_the_moe_family(monkeypatch, name, dtype,
                                           kv_quant):
    built = build(dtype, kv_quant, name)
    out = run_twins(monkeypatch, dtype=dtype, kv_quant=kv_quant,
                    prompts=prompts_for(512, 13, LENS), max_new=NEWS,
                    engine_kw=ENGINE, built=built,
                    tie_rule=dtype == "bfloat16")
    assert out["pages_in_use"] == (0, 0)
    assert out["mixed"] and out["steps"] > len(LENS)
    assert all(len(s) == 4 for s in out["streams"][1].values())
    if dtype == "float32":
        assert not out["forked"]
        assert out["streams"][0] == out["streams"][1]
    assert all(margin < gap for _, _, margin, gap in out["near_ties"])


def test_serve_cli_serves_granite_moe(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-moe-3b-a800m-smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "4", "--rate", "0"])
    out = capsys.readouterr().out
    assert "engine: EngineCore on cpu" in out
    assert "async serve loop: 3 requests / 12 tokens" in out


def test_slot_engine_serves_granite_moe_like_the_reference():
    """The slot engine on the MoE family: the reference's ``ServingEngine``
    and the port's on ``tests/test_serving.py``'s mixed trace (2 slots,
    f32): equal streams and finish order.  Each decode routes every slot's
    row, idle slots included, on both sides."""
    from tests.test_torch_slot_engine import TRACES, serve_both
    prompts, news = TRACES["mixed"]
    (jt, jo), (tt, to) = serve_both("granite-moe-3b-a800m-smoke",
                                    prompts(512), news)
    assert tt == jt and to == jo
