"""Twin engines, JAX ``EngineCore`` vs the PyTorch port, on the preemption
trace of ``test_engine_core.py:187``: a long-running request fills a
contended 8-page pool, a longer prompt is admitted, the youngest resident
is evicted mid-flight and later resumes by replay.  Every step's plan,
packed stream, page tables, cursors, free heap and refcounts are equal;
greedy streams are identical for float pools in f32 and bf16 (int8 pools:
identical except at a genuine near-tie, see ``tests/_torch_twin.py``), and
the evicted request resumes token-identically to its solo run."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tests._torch_twin import build, prompts_for, run_twins  # noqa: E402

SPECS = [(4, 26), (12, 14)]            # (prompt_len, max_new)
CONTENDED = dict(lanes=2, page_size=4, num_pages=8, chunk_size=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_twin_engines_preemption_trace(monkeypatch, dtype, kv_quant):
    prompts = prompts_for(512, 21, [lp for lp, _ in SPECS])
    out = run_twins(monkeypatch, dtype=dtype, kv_quant=kv_quant,
                    prompts=prompts, max_new=[mn for _, mn in SPECS],
                    engine_kw=CONTENDED)
    assert out["preempted"], "pool contention never triggered an eviction"
    assert out["pages_in_use"] == (0, 0)
    if not kv_quant:
        assert not out["forked"]
        assert out["streams"][0] == out["streams"][1]
    assert len(out["forked"]) <= 1, out["near_ties"]


def test_preempted_request_resumes_like_solo_run():
    """The port alone: the contended run's streams equal uncontended solo
    runs (recompute preemption replays the identical suffix)."""
    from repro_torch.serving import EngineCore, Request
    _, tc, _, tparams = build("float32", False)
    prompts = prompts_for(512, 21, [lp for lp, _ in SPECS])
    solo = {}
    for uid, (_, mn) in enumerate(SPECS):
        eng = EngineCore(tc, tparams, lanes=2, page_size=4, num_pages=16,
                         chunk_size=4, device="cpu")
        eng.submit(Request(uid=uid, prompt=prompts[uid], max_new=mn))
        solo[uid] = eng.run()[0].tokens
    eng = EngineCore(tc, tparams, device="cpu", **CONTENDED)
    for uid, (_, mn) in enumerate(SPECS):
        eng.submit(Request(uid=uid, prompt=prompts[uid], max_new=mn))
    seen = []
    while eng.scheduler.has_work():
        seen += eng.step().preempted
    assert seen
    assert {r.uid: r.tokens for r in eng.finished} == solo
    assert eng.pages_in_use == 0
