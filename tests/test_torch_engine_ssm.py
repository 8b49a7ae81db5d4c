"""The slot engine on the SSM families: the port's ``ServingEngine``
beside the reference's on ``falcon-mamba-7b-smoke`` (Mamba-1) and
``zamba2-1.2b-smoke`` (Mamba-2 with the shared attention block), the
traces of ``tests/test_serving.py`` (2 slots, ``max_len`` 48).

- f32: identical greedy streams and finish order on the mixed trace
  (5 prompts of 6 tokens over 2 slots, 2–9 new each: every slot is
  recycled, its state reset on admission).
- bf16: identical streams, or a stream that forks only where the near-tie
  rule of ``tests/_torch_twin.py`` explains it: at the first differing
  token, the reference's top-2 logit margin lies below the largest gap
  between the two engines' logits rows at that token.
- A sampled request (temperature 1.5, seeded) equals the reference's.
- ``EngineCore`` raises ``UnsupportedCacheLayout("ssm_state")`` for both,
  as the reference's does, and the serve CLI falls back to the slot
  engine.

Weights are the reference's, perturbed as in ``tests/test_torch_ssm.py``.
About 29 s alone (mostly the reference's compiles), one intra-op
thread."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

from repro.checkpoint.store import flatten_tree  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import EngineCore as JEngineCore  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import UnsupportedCacheLayout as JUnsupported  # noqa: E402
from repro_torch.params import from_flat  # noqa: E402
from repro_torch.serving import (EngineCore, Request,  # noqa: E402
                                 SamplingParams, ServingEngine,
                                 UnsupportedCacheLayout)
from tests._torch_twin import prompts_for  # noqa: E402
from tests.test_torch_ssm import configs, nudged  # noqa: E402

SSM = ["falcon-mamba-7b-smoke", "zamba2-1.2b-smoke"]
SLOTS, MAX_LEN = 2, 48
# test_serving.py::test_mixed_lengths_and_recycling: prompts of 6
MIXED = (lambda v: prompts_for(v, 1, (6,) * 5), [2, 9, 3, 7, 2])


def built(name, dtype):
    jc, tc = configs(name, dtype=dtype)
    jparams = nudged(j_build_model(jc).init(jax.random.PRNGKey(0)), 5)
    return jc, tc, jparams, from_flat(flatten_tree(jparams), tc, "cpu")


def serve_both(name, dtype, prompts, max_new, sampling=None):
    """Both engines on the same requests → ((uid → tokens, finish order,
    (uid, token index) → logits row) of each)."""
    jc, tc, jparams, tparams = built(name, dtype)
    je = JServingEngine(jc, jparams, slots=SLOTS, max_len=MAX_LEN)
    te = ServingEngine(tc, tparams, slots=SLOTS, max_len=MAX_LEN,
                       device="cpu")
    rows = ({}, {})
    j_sample = je._sample

    def j_spy(logits, req):
        rows[0][req.uid, len(req.tokens)] = np.asarray(logits, np.float32)
        return j_sample(logits, req)
    je._sample = j_spy
    te.tap = lambda req, row: rows[1].__setitem__(
        (req.uid, len(req.tokens)), row.float().numpy().copy())
    for i, p in enumerate(prompts):
        sp = sampling[i] if sampling else None
        je.submit(JRequest(uid=i, prompt=p, max_new=max_new[i],
                           sampling=sp and JSamplingParams(**sp)))
        te.submit(Request(uid=i, prompt=p, max_new=max_new[i],
                          sampling=sp and SamplingParams(**sp)))
    out = []
    for eng, r in zip((je, te), rows):
        done = eng.run()
        out.append(({q.uid: q.tokens for q in done}, [q.uid for q in done], r))
        assert all(a is None for a in eng.active)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SSM)
def test_slot_engine_matches_reference(name, dtype):
    make, max_new = MIXED
    (jt, jorder, jrows), (tt, torder, trows) = serve_both(
        name, dtype, make(512), max_new)
    assert {u: len(t) for u, t in tt.items()} == dict(enumerate(max_new))
    assert torder == jorder
    if dtype == "float32":
        assert tt == jt
        return
    for uid, want in jt.items():
        got = tt[uid]
        if got == want:
            continue
        j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
        top2 = np.sort(jrows[uid, j])[-2:]
        gap = float(np.abs(jrows[uid, j] - trows[uid, j]).max())
        assert top2[1] - top2[0] < gap, (
            f"request {uid} forked at token {j} with a reference top-2 "
            f"margin {top2[1] - top2[0]} above the logits gap {gap}")


@pytest.mark.parametrize("name", SSM)
def test_sampled_request_matches_reference(name):
    """A seeded sampled request beside a greedy one (f32): the sampled
    stream equals the reference's draw for draw."""
    prompts = prompts_for(512, 3, (6, 6))
    sampling = [dict(temperature=1.5, seed=1), None]
    (jt, _, _), (tt, _, _) = serve_both(name, "float32", prompts, [6, 4],
                                        sampling=sampling)
    assert tt == jt


@pytest.mark.parametrize("name", SSM)
def test_engine_core_refuses_ssm_state(name):
    """The page pool cannot hold O(1) state: ``EngineCore`` raises the
    reference's ``UnsupportedCacheLayout("ssm_state")`` at construction."""
    jc, tc, jparams, tparams = built(name, "float32")
    with pytest.raises(JUnsupported) as je:
        JEngineCore(jc, jparams, lanes=2, page_size=8, num_pages=8)
    with pytest.raises(UnsupportedCacheLayout, match="paged KV cache") as te:
        EngineCore(tc, tparams, lanes=2, page_size=8, num_pages=8,
                   device="cpu")
    assert te.value.layout == je.value.layout == "ssm_state"
    assert isinstance(te.value, ValueError)


def test_serve_cli_falls_back_to_the_slot_engine(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "falcon-mamba-7b-smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "4", "--max-len", "64",
                "--rate", "0"])
    out = capsys.readouterr().out
    assert "engine: ServingEngine on cpu (slot-contiguous" in out
    assert "ssm_state" in out
    assert "batch driver: served 3 requests, 12 tokens" in out
