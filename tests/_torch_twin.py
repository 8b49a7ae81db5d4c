"""Twin-engine harness: the JAX ``EngineCore`` and the PyTorch port's
``EngineCore(device="cpu")`` driven step by step on one request trace.

After every step the harness asserts equal plans and packed streams, equal
page tables, cursors, free heaps and refcounts, and equal greedy tokens.
For int8 pools a token may differ only at a genuine near-tie: JAX's top-2
logit margin at that lane lies below the logit gap measured between the two
engines on that very step.  Such a request is then marked forked and its
later token values are not compared; since no request has an eos id,
scheduling never depends on token values, so every other check continues.
"""
import numpy as np

import jax

from repro.checkpoint.store import flatten_tree
from repro.configs import get_config as j_get_config
from repro.models import build_model
from repro.models import lm as j_lm
from repro.serving import EngineCore as JEngine
from repro.serving import Request as JRequest
import repro_torch.serving.core as t_core
from repro_torch.configs import get_config
from repro_torch.params import from_flat
from repro_torch.serving import EngineCore as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving.sampling import greedy_rows


def build(dtype: str, kv_quant: bool):
    jc = j_get_config("deepseek-7b-smoke").replace(dtype=dtype,
                                                   kv_quant=kv_quant)
    tc = get_config("deepseek-7b-smoke").replace(dtype=dtype,
                                                 kv_quant=kv_quant)
    params = build_model(jc).init(jax.random.PRNGKey(0))
    return jc, tc, params, from_flat(flatten_tree(params), tc, "cpu")


def prompts_for(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lp).astype(np.int32) for lp in lens]


def _spy_batches(eng, log):
    inner = eng.scheduler.batch_for

    def spy(wants):
        batch, pre = inner(wants)
        log.append(batch)
        return batch, pre
    eng.scheduler.batch_for = spy


def _state(eng):
    s = eng.scheduler
    return dict(
        running=[(r.req.uid, r.ticket, list(r.pages), r.rows)
                 for r in s.running],
        waiting=[(r.req.uid, r.ticket, r.rows) for r in s.waiting],
        free=list(eng.kv.free), ref=list(eng.kv.ref),
        finished=[r.uid for r in eng.finished])


def _spy_logits(je, jc, logits, monkeypatch):
    """Record each step's (lanes, V) logits of both engines."""
    j_logits = jax.jit(lambda p, pool, tbl, toks, pos, idx, cu:
                       j_lm.lm_step_ragged(jc, p, toks, pool, tbl, pos, idx,
                                           cu_seqlens=cu,
                                           kernel_config=je.kernel_config)[0])
    j_inner = je._ragged

    def j_spy(p, pool, tbl, toks, pos, idx, cu, *rest):
        logits["jax"] = np.asarray(j_logits(p, pool, tbl, toks, pos, idx, cu))
        return j_inner(p, pool, tbl, toks, pos, idx, cu, *rest)
    je._ragged = j_spy
    t_inner = t_core.lm_step_ragged

    def t_spy(*args, greedy=False, **kw):
        out = t_inner(*args, greedy=False, **kw)
        logits["torch"] = out.numpy()
        return greedy_rows(out) if greedy else out
    monkeypatch.setattr(t_core, "lm_step_ragged", t_spy)


def run_twins(monkeypatch, *, dtype, kv_quant, prompts, max_new, engine_kw,
              on_step=None):
    """Drive both engines to completion → dict of per-run facts.
    ``on_step(je, te, step)`` runs after every step's checks."""
    jc, tc, jparams, tparams = build(dtype, kv_quant)
    je = JEngine(jc, jparams, **engine_kw)
    te = TEngine(tc, tparams, device="cpu", **engine_kw)
    jb, tb = [], []
    _spy_batches(je, jb)
    _spy_batches(te, tb)

    # logits of every int8 step, for the near-tie test
    logits = {}
    if kv_quant:
        _spy_logits(je, jc, logits, monkeypatch)

    for i, p in enumerate(prompts):
        je.submit(JRequest(uid=i, prompt=p, max_new=max_new[i]))
        te.submit(TRequest(uid=i, prompt=p, max_new=max_new[i]))

    forked, near_ties, steps, preempted, mixed = set(), [], 0, [], False
    while je.scheduler.has_work():
        oj, ot = je.step(), te.step()
        steps += 1
        a, b = jb[-1], tb[-1]
        plan = [(p.run.req.uid, p.q_len) for p in a.plans]
        assert plan == [(p.run.req.uid, p.q_len) for p in b.plans], steps
        live = np.array([a.plans[i].run.req.uid not in forked
                         if i >= 0 else True for i in a.lane_id])
        np.testing.assert_array_equal(a.tokens[live], b.tokens[live])
        for f in ("pos", "lane_id", "table", "cu_seqlens"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert (a.live, a.width) == (b.live, b.width)
        assert _state(je) == _state(te), steps
        assert oj.preempted == ot.preempted and oj.finished == ot.finished
        preempted += list(oj.preempted)
        mixed |= oj.mixed
        for uid in set(oj.tokens) | set(ot.tokens):
            if uid in forked or oj.tokens.get(uid) == ot.tokens.get(uid):
                continue
            assert kv_quant, (f"{dtype} float pool: token of request {uid} "
                              f"differs at step {steps}: {oj.tokens[uid]} vs "
                              f"{ot.tokens[uid]}")
            lane = plan.index((uid, dict(plan)[uid]))
            lj = logits["jax"][lane]
            top2 = np.sort(lj)[-2:]
            margin = float(top2[1] - top2[0])
            gap = float(np.abs(logits["torch"][:len(plan)]
                               - logits["jax"][:len(plan)]).max())
            assert margin < gap, (f"int8 pool: request {uid} forked at step "
                                  f"{steps} with a JAX top-2 margin {margin} "
                                  f"above the measured logit gap {gap}")
            near_ties.append((uid, steps, margin, gap))
            forked.add(uid)
        if on_step is not None:
            on_step(je, te, steps)
    assert not te.scheduler.has_work()
    streams = ({r.uid: r.tokens for r in je.finished},
               {r.uid: r.tokens for r in te.finished})
    for uid in streams[0]:
        if uid not in forked:
            assert streams[0][uid] == streams[1][uid], uid
    return dict(streams=streams, forked=forked, near_ties=near_ties,
                steps=steps, preempted=preempted, mixed=mixed,
                pages_in_use=(je.pages_in_use, te.pages_in_use))
