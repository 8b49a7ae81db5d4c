"""The port's slot-contiguous ``ServingEngine`` (``serving/engine.py``) on
the CPU: against the JAX reference's ``ServingEngine`` on the traces of
``tests/test_serving.py`` (2 slots, ``max_len`` 48, ``deepseek-7b-smoke``
and ``gemma2-9b-smoke``, whose window of 8 below ``max_len`` gives its
local layers ring buffers), against a hand-rolled prefill + decode loop,
against the port's paged ``EngineCore``, and through the serve CLI, which
falls back to it for ``gemma2-9b-smoke``.

Weights are the reference's, carried over through ``flatten_tree`` with
every bias and norm scale perturbed (``tests/_torch_twin.py``), in f32:
streams are compared token for token and the finish order too, so the
two sides must agree to f32 rounding, not bf16's.

The reference's stacked cache init zero-fills the ring positions
(``test_torch_cached.py``), so its ring decodes a prompt shorter than the
window against phantom rows at position 0; the port keeps -1.  The
reference twins' prompts fill the ring (8 tokens, the window), and two
tests hold shorter prompts to references without a ring: the streams of
``EngineCore`` (paged at the window's size) and, row by row, the logits
of the cache-free forward over the same tokens.  About 30 s alone, one
intra-op thread."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.lm import lm_apply  # noqa: E402
from repro_torch.serving import (EngineCore, Request,  # noqa: E402
                                 SamplingParams, ServingEngine)
from repro_torch.serving.engine import _EngineBase  # noqa: E402
from tests._torch_twin import build, prompts_for  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SLOTS, MAX_LEN = 2, 48


def built(name):
    return build("float32", False, name, perturb=5)


def serve_both(name, prompts, max_new, sampling=None, slots=SLOTS,
               eos=None):
    """Serve the same requests on the reference's engine and the port's →
    ((uid → tokens, finish order) of each)."""
    jc, tc, jparams, tparams = built(name)
    je = JServingEngine(jc, jparams, slots=slots, max_len=MAX_LEN)
    te = ServingEngine(tc, tparams, slots=slots, max_len=MAX_LEN,
                       device="cpu")
    for i, p in enumerate(prompts):
        sp = sampling[i] if sampling else None
        je.submit(JRequest(uid=i, prompt=p, max_new=max_new[i], eos_id=eos,
                           sampling=sp and JSamplingParams(**sp)))
        te.submit(Request(uid=i, prompt=p, max_new=max_new[i], eos_id=eos,
                          sampling=sp and SamplingParams(**sp)))
    out = []
    for eng in (je, te):
        done = eng.run()
        out.append(({r.uid: r.tokens for r in done}, [r.uid for r in done]))
        assert all(a is None for a in eng.active)
    return out


TRACES = {
    # test_serving.py::test_drains_all_requests: 5 prompts of 8, 5 new
    "drain": (lambda v: prompts_for(v, 0, (8,) * 5), [5] * 5),
    # test_serving.py::test_mixed_lengths_and_recycling: prompts of 6
    "mixed": (lambda v: prompts_for(v, 1, (6,) * 5), [2, 9, 3, 7, 2]),
}


@pytest.mark.parametrize("name,trace", [("deepseek-7b-smoke", "drain"),
                                        ("gemma2-9b-smoke", "drain"),
                                        ("deepseek-7b-smoke", "mixed")])
def test_streams_and_finish_order_match_reference(name, trace):
    make, max_new = TRACES[trace]
    (jt, jorder), (tt, torder) = serve_both(name, make(512), max_new)
    assert {u: len(t) for u, t in tt.items()} == dict(enumerate(max_new))
    assert tt == jt
    assert torder == jorder


@pytest.mark.parametrize("name", ["deepseek-7b-smoke", "gemma2-9b-smoke"])
def test_greedy_matches_manual_decode(name):
    """Engine greedy decode == a hand-rolled prefill + decode loop on the
    model's own cache (gemma2: a 12-token prompt and 6 new tokens wrap its
    rings of 8)."""
    _, tc, _, tparams = built(name)
    prompt = prompts_for(tc.vocab_size, 2, (12,))[0]
    eng = ServingEngine(tc, tparams, slots=1, max_len=MAX_LEN, device="cpu")
    eng.submit(Request(uid=0, prompt=prompt, max_new=6))
    got = eng.run()[0].tokens
    m = build_model(tc)
    caches = m.init_cache(1, MAX_LEN, device="cpu")
    lg, caches = m.prefill(tparams, {"tokens": torch.from_numpy(prompt)[None]},
                           caches)
    want = [int(torch.argmax(lg[0]))]
    for t in range(5):
        lg, caches = m.decode_step(tparams, torch.tensor([want[-1]]), caches,
                                   12 + t)
        want.append(int(torch.argmax(lg[0])))
    assert got == want


def test_sampling_per_request_seeds_match_reference():
    """test_serving.py's seeded trace: each sampled stream equals the
    reference's, distinct seeds diverge, the same seed repeats."""
    prompt = prompts_for(512, 3, (8,))[0]
    sampling = [dict(temperature=1.5, seed=1), dict(temperature=1.5, seed=2),
                dict(temperature=1.5, seed=1)]
    (jt, _), (tt, _) = serve_both("deepseek-7b-smoke", [prompt] * 3, [8] * 3,
                                  sampling=sampling, slots=4)
    assert tt == jt
    assert tt[0] != tt[1] and tt[0] == tt[2]


def test_eos_stops_early():
    """The greedy first token as eos: the request stops after it, on both
    engines."""
    prompt = prompts_for(512, 4, (8,))[0]
    (_, _), (first, _) = serve_both("deepseek-7b-smoke", [prompt], [6],
                                    slots=1)
    (jt, _), (tt, _) = serve_both("deepseek-7b-smoke", [prompt], [6],
                                  slots=1, eos=first[0][0])
    assert tt == jt == {0: [first[0][0]]}


def test_greedy_tie_break_lowest_index():
    assert _EngineBase.greedy_token(torch.zeros(9)) == 0
    assert _EngineBase.greedy_token(torch.tensor([0.0, 3.0, 3.0, 1.0])) == 1
    assert _EngineBase.greedy_token(jnp.asarray([-1.0, -5.0, -1.0])) == 0


def _engine_streams(eng, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new=max_new))
    return {r.uid: r.tokens for r in eng.run()}


def test_slot_engine_matches_the_paged_engine():
    """deepseek-7b-smoke in f32: the slot engine's streams equal the port's
    ``EngineCore`` ones (chunked prefill and decode through the page pool),
    on prompts of 3 to 20 tokens over 3 slots / lanes."""
    _, tc, _, tparams = built("deepseek-7b-smoke")
    prompts = prompts_for(tc.vocab_size, 5, (3, 20, 7, 11, 16))
    slot = _engine_streams(ServingEngine(tc, tparams, slots=3,
                                         max_len=MAX_LEN, device="cpu"),
                           prompts, 8)
    paged = _engine_streams(EngineCore(tc, tparams, lanes=3, page_size=8,
                                       num_pages=24, chunk_size=8,
                                       device="cpu"), prompts, 8)
    assert slot == paged


def test_short_prompt_ring_matches_the_paged_engine():
    """gemma2-9b-smoke, prompts of 3 and 5 tokens (below the window of 8):
    the ring's unwritten slots (position -1) are masked, so the slot
    engine's streams equal ``EngineCore``'s at page size 8, where the
    window pages and no ring exists."""
    _, tc, _, tparams = built("gemma2-9b-smoke")
    prompts = prompts_for(tc.vocab_size, 6, (3, 5))
    eng = ServingEngine(tc, tparams, slots=2, max_len=MAX_LEN, device="cpu")
    assert "ring_pos" in eng.caches
    slot = _engine_streams(eng, prompts, 10)
    paged = _engine_streams(EngineCore(tc, tparams, lanes=2, page_size=8,
                                       num_pages=16, chunk_size=8,
                                       device="cpu"), prompts, 10)
    assert slot == paged


def test_short_prompt_ring_logits_match_the_full_forward():
    """gemma2-9b-smoke, prompts of 3 and 5 tokens: every logits row the
    slot engine picks from (its prefill's and each decode's, through its
    rings of 8) equals the cache-free forward's row at that position over
    the same tokens, at the f32 tolerance: unwritten ring slots see no
    query, and the ring's slots hold the window's rows."""
    _, tc, _, tparams = built("gemma2-9b-smoke")
    prompts = prompts_for(tc.vocab_size, 6, (3, 5))
    eng = ServingEngine(tc, tparams, slots=2, max_len=MAX_LEN, device="cpu")
    rows = {}
    eng.tap = lambda req, row: rows.setdefault(
        (req.uid, len(req.tokens)), row.clone())
    streams = _engine_streams(eng, prompts, 12)
    for uid, prompt in enumerate(prompts):
        seq = np.concatenate([prompt, streams[uid][:-1]]).astype(np.int32)
        full = lm_apply(tc, tparams, torch.from_numpy(seq)[None])[0]
        for j in range(len(streams[uid])):
            np.testing.assert_allclose(
                rows[uid, j].numpy(), full[len(prompt) - 1 + j].numpy(),
                atol=1e-4, rtol=1e-4, err_msg=(uid, j))


def test_decode_capture_on_the_cpu_is_a_plain_run():
    """``capture=True`` counts one capture, at the first decode step, and
    serves what ``capture=False`` serves."""
    _, tc, _, tparams = built("gemma2-9b-smoke")
    prompts = prompts_for(tc.vocab_size, 7, (9, 4, 8))
    runs = []
    for capture in (True, False):
        eng = ServingEngine(tc, tparams, slots=2, max_len=MAX_LEN,
                            device="cpu", capture=capture)
        runs.append(_engine_streams(eng, prompts, 4))
        assert eng.captures == int(capture)
        assert len(eng.prefill_ms) == 3 and len(eng.decode_ms) >= 3
    assert runs[0] == runs[1]


def test_slot_engine_refuses_what_it_cannot_serve():
    _, tc, _, tparams = built("deepseek-7b-smoke")
    eng = ServingEngine(tc, tparams, slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(uid=0, prompt=np.zeros(12, np.int32), max_new=5))
    bert = build("float32", False, "bert-base-smoke")
    with pytest.raises(ValueError, match="no decode step"):
        ServingEngine(bert[1], bert[3], slots=1, max_len=16, device="cpu")
    # seamless-m4t: its prefill needs frames, which a request has not
    with pytest.raises(NotImplementedError, match="encdec"):
        ServingEngine(tc.replace(family="encdec"), tparams, slots=1,
                      max_len=16, device="cpu")
    # internvl2: served as text, as the reference's engine serves it
    vlm = ServingEngine(tc.replace(family="vlm"), tparams, slots=1,
                        max_len=16, device="cpu")
    vlm.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new=3))
    assert len(vlm.run()[0].tokens) == 3


def test_serve_cli_falls_back_to_the_slot_engine():
    """gemma2-9b-smoke's window of 8 is narrower than the default page of
    16: the CLI serves it through the slot engine (sync, no /metrics)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2-9b-smoke", "--device", "cpu", "--requests", "3",
         "--max-new", "4", "--max-len", "64", "--rate", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "engine: ServingEngine on cpu (slot-contiguous" in out.stdout
    assert "ring_buffer_sliding_window" in out.stdout
    assert "batch driver: served 3 requests, 12 tokens" in out.stdout
