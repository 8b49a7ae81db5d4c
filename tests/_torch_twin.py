"""Twin-engine harness: the JAX ``EngineCore`` and the PyTorch port's
``EngineCore(device="cpu")`` driven step by step on one request trace.

Both engines are built with the same non-zero ``seed=`` (each accepts and
ignores it: seeds are per request).  After every step the harness asserts
equal plans (with each lane's drafts) and packed streams, equal page
tables, cursors, free heaps and refcounts, equal prefix-cache trees (page
→ block path and LRU stamp, version, stats, CoW copies), equal
speculative statistics, equal step captures (the port's ``trace_count``
against JAX's), equal ``StepOutput.kernel_config`` (the port's without its
card-only ``kv_split``), and equal greedy tokens, every committed one;
after the drain, equal ``kv.free_pages``.
For int8 pools (and, with ``tie_rule=True``, a float pool: an MoE
model's bf16 routing flips between frameworks where two experts'
probabilities nearly tie) a token may differ only at a genuine near-tie:
JAX's top-2 logit margin at that lane (and, for a verify lane, at the
row of the first differing token) lies below the logit gap measured
between the two engines on that very step.  Such a request is then marked forked and its
later token values are not compared; since no request has an eos id,
scheduling never depends on token values, so every other check continues.
A speculative engine's schedule does depend on them (acceptance), so a
fork there fails the run.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.checkpoint.store import flatten_tree
from repro.configs import get_config as j_get_config
from repro.models import build_model
from repro.models import lm as j_lm
from repro.serving import EngineCore as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
import repro_torch.serving.core as t_core
from repro_torch.configs import get_config
from repro_torch.params import from_flat
from repro_torch.serving import EngineCore as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SamplingParams as TSamplingParams
from repro_torch.serving.sampling import greedy_rows, sample_in_step


def perturbed(params, seed):
    """Every bias and every norm scale (LayerNorm, RMSNorm, QK-norm)
    nudged by 0.1·N(0, 1) from a numpy seed: the reference initialises
    them as constants, which would hide a dropped bias or a misread
    ``1 + scale``."""
    rng = np.random.default_rng(seed)

    def bump(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['b']", "['bias']", "['scale']", "['q_norm']",
                          "['k_norm']")):
            noise = rng.normal(size=leaf.shape).astype(np.float32) * 0.1
            return leaf + jnp.asarray(noise).astype(leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(bump, params)


def build(dtype: str, kv_quant: bool, name: str = "deepseek-7b-smoke",
          perturb=None):
    """Both configs and the reference's weights (``perturb``: the numpy
    seed of ``perturbed``'s noise, None for the weights as drawn) → (JAX
    config, port config, JAX params, port params)."""
    jc = j_get_config(name).replace(dtype=dtype, kv_quant=kv_quant)
    tc = get_config(name).replace(dtype=dtype, kv_quant=kv_quant)
    params = build_model(jc).init(jax.random.PRNGKey(0))
    if perturb is not None:
        params = perturbed(params, perturb)
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


def _spy_blocks(eng, log, logits, side):
    """A padded engine's step: record each step's plans and its block
    inputs (tokens, table, kv_len, q_len as numpy) in ``log``, and its
    (lanes, V) logits in ``logits[side]``."""
    inner_plans = eng.scheduler.plans_for

    def spy_plans(wants):
        plans, pre = inner_plans(wants)
        log.append({"plans": plans})
        return plans, pre
    eng.scheduler.plans_for = spy_plans
    inner = eng._step
    if side == "jax":
        def spy(p, pool, tbl, toks, kv_len, q_len):
            out, pool = inner(p, pool, tbl, toks, kv_len, q_len)
            log[-1].update(table=np.asarray(tbl), tokens=np.asarray(toks),
                           kv_len=np.asarray(kv_len), q_len=np.asarray(q_len))
            logits[side] = np.asarray(out)
            return out, pool
    else:
        def spy(**arrays):
            out = inner(**arrays)
            log[-1].update({k: v.numpy() for k, v in arrays.items()})
            logits[side] = out.numpy()
            return out
    eng._step = spy


def pool_leaves(pool, scratch):
    """A page pool as {leaf: (layers, pages, …) f32 numpy} in layer order,
    the scratch page (``scratch``) dropped: the reference's scanned
    ``periods/{j}`` leaf ``[n]`` is layer ``n·len(pattern) + j``."""
    live = slice(0, scratch)
    if "periods" in pool:
        per = pool["periods"]
        out = {}
        for name in per["0"]:
            stack = np.stack([np.asarray(per[str(j)][name].astype(jnp.float32))
                              for j in range(len(per))], axis=1)
            out[name] = stack.reshape((-1,) + stack.shape[2:])[:, live]
        return out
    return {k: v[:, live].to(torch.float32).numpy() for k, v in pool.items()}


def assert_pools_close(je, te, cfg, step):
    """The two pools outside the scratch page: every written row at the
    (page, offset) the reference wrote it — the same rows all zero in
    both — and values within the model step's tolerance
    (``tests/test_torch_model_step.py``: f32 atol = rtol = 1e-4; an int8
    pool's dequantised rows within one quantisation step, the largest row
    scale); in bf16 within 4 bf16 steps of the leaf's scale (2^-5·max|x|:
    both round per op in different places, and a layer's rows inherit the
    ulps of the layers before it; an int8 row's scale follows its absmax).
    The scratch page is left out: several padding rows write one (page,
    offset) there and which lands is not fixed."""
    a, b = (pool_leaves(e.kv.pool, e.kv.scratch) for e in (je, te))
    assert a.keys() == b.keys(), (a.keys(), b.keys())
    step_size = 0.0
    if "ks" in a:                        # int8: the dequantised rows
        step_size = float(a["ks"].max())
        for x in (a, b):
            for k in ("k", "v"):
                x[k] = x[k] * x.pop(k + "s")[..., None]
    for k in a:
        zeros = [np.all(x == 0, axis=-1) for x in (a[k], b[k])]
        np.testing.assert_array_equal(zeros[0], zeros[1],
                                      f"step {step}: {k}'s written rows")
        if cfg.dtype == "float32":
            atol, rtol = max(1e-4, step_size), 1e-4
        else:
            atol, rtol = 2 ** -5 * float(np.abs(a[k]).max()), 2 ** -7
        np.testing.assert_allclose(b[k], a[k], atol=atol, rtol=rtol,
                                   err_msg=f"step {step}: {k}")


def cache_tree(cache):
    """A prefix cache as plain data: page → (block path, LRU stamp), its
    version and its stats; None when the cache is off."""
    if cache is None:
        return None
    tree = {}
    for page, node in cache._nodes.items():
        path, n = [], node
        while n.parent is not None:
            path.append(n.block)
            n = n.parent
        tree[page] = (tuple(reversed(path)), node.stamp)
    return tree, cache.version, cache.stats()


def _state(eng):
    s = eng.scheduler
    return dict(
        running=[(r.req.uid, r.ticket, list(r.pages), r.rows)
                 for r in s.running],
        waiting=[(r.req.uid, r.ticket, r.rows) for r in s.waiting],
        free=list(eng.kv.free), ref=list(eng.kv.ref),
        finished=[r.uid for r in eng.finished],
        cache=cache_tree(eng.prefix_cache), cow_copies=eng.kv.cow_copies,
        spec=eng.spec_stats, traces=eng.trace_count)


def _shapes(kernel_config):
    """A port step's ``kernel_config`` without the card's ``kv_split``:
    the reference's four keys."""
    if kernel_config is None:
        return None
    return {k: v for k, v in kernel_config.items() if k != "kv_split"}


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

    def t_spy(*args, greedy=False, sampling=None, **kw):
        out = t_inner(*args, **kw)
        logits["torch"] = out.numpy()
        if sampling is not None:
            return sample_in_step(out, **sampling)
        return greedy_rows(out) if greedy else out
    monkeypatch.setattr(t_core, "lm_step_ragged", t_spy)


def run_twins(monkeypatch, *, dtype, kv_quant, prompts, max_new, engine_kw,
              on_step=None, waves=None, proposer=None, built=None,
              sampling=None, tie_rule=None, mode="ragged", pools=False):
    """Drive both engines to completion → dict of per-run facts.
    ``on_step(je, te, step)`` runs after every step's checks.  ``waves``
    lists the request indices submitted together, each wave once both
    engines drained the one before (default: all at once); ``proposer()``
    makes each engine's own draft proposer; ``built`` is ``build``'s
    result when the caller already has it; ``sampling`` lists each
    request's ``SamplingParams`` keyword arguments (None: greedy);
    ``tie_rule`` applies the near-tie rule to the pool (default: to int8
    pools only).  ``mode="padded"`` runs both engines' padded-block
    oracle: each step's plans and block inputs (tokens, table, kv_len,
    q_len) are compared in place of the packed stream, and the near-tie
    rule reads each step's (lanes, V) logits.  ``pools=True`` holds the
    two page pools after every step (``assert_pools_close``) until a
    request forks (its later rows hold other tokens' K/V)."""
    tie_rule = kv_quant if tie_rule is None else tie_rule
    jc, tc, jparams, tparams = built or build(dtype, kv_quant)
    kw = dict(engine_kw, seed=7, mode=mode)
    je = JEngine(jc, jparams, **kw, **(
        {} if proposer is None else dict(proposer=proposer())))
    te = TEngine(tc, tparams, device="cpu", **kw, **(
        {} if proposer is None else dict(proposer=proposer())))
    jb, tb = [], []
    # logits of every step the near-tie rule reads
    logits = {}
    padded = mode == "padded"
    if padded:
        _spy_blocks(je, jb, logits, "jax")
        _spy_blocks(te, tb, logits, "torch")
    else:
        _spy_batches(je, jb)
        _spy_batches(te, tb)
        if tie_rule:
            _spy_logits(je, jc, logits, monkeypatch)

    reqs = {}
    forked, near_ties, steps, preempted, mixed = set(), [], 0, [], False
    outs = []
    for wave in (waves or [range(len(prompts))]):
        for i in wave:
            sp = sampling[i] if sampling else None
            reqs[i] = (JRequest(uid=i, prompt=prompts[i], max_new=max_new[i],
                                sampling=sp and JSamplingParams(**sp)),
                       TRequest(uid=i, prompt=prompts[i], max_new=max_new[i],
                                sampling=sp and TSamplingParams(**sp)))
            je.submit(reqs[i][0])
            te.submit(reqs[i][1])
        while je.scheduler.has_work() or te.scheduler.has_work():
            before = {u: len(r[0].tokens) for u, r in reqs.items()}
            oj, ot = je.step(), te.step()
            outs.append((oj, ot))
            steps += 1
            a, b = jb[-1], tb[-1]
            a_plans = a["plans"] if padded else a.plans
            plan = [(p.run.req.uid, p.q_len, tuple(p.drafts))
                    for p in a_plans]
            assert plan == [(p.run.req.uid, p.q_len, tuple(p.drafts))
                            for p in (b["plans"] if padded else b.plans)], steps
            if padded and plan:
                live = np.array([i >= len(plan) or plan[i][0] not in forked
                                 for i in range(len(a["tokens"]))])
                np.testing.assert_array_equal(a["tokens"][live],
                                              b["tokens"][live])
                for f in ("table", "kv_len", "q_len"):
                    np.testing.assert_array_equal(a[f], b[f], f)
            elif not padded:
                live = np.array([a.plans[i].run.req.uid not in forked
                                 if i >= 0 else True for i in a.lane_id])
                np.testing.assert_array_equal(a.tokens[live], b.tokens[live])
                for f in ("pos", "lane_id", "table", "cu_seqlens"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f), f)
                assert (a.live, a.width) == (b.live, b.width)
            assert _state(je) == _state(te), steps
            if pools and not forked:       # a fork writes other rows
                assert_pools_close(je, te, tc, steps)
            for f in ("preempted", "finished", "prefix_hit_tokens",
                      "drafted_tokens", "accepted_tokens"):
                assert getattr(oj, f) == getattr(ot, f), (steps, f)
            assert _shapes(ot.kernel_config) == oj.kernel_config, steps
            assert (ot.kernel_config is None) == (ot.lanes == 0
                                                  or padded), steps
            assert (ot.live_rows, ot.padded_rows) == (oj.live_rows,
                                                      oj.padded_rows), steps
            preempted += list(oj.preempted)
            mixed |= oj.mixed
            for uid, (jr, tr) in reqs.items():
                if uid in forked or jr.tokens == tr.tokens:
                    continue
                assert tie_rule, (f"{dtype} float pool: tokens of request "
                                  f"{uid} differ at step {steps}: "
                                  f"{jr.tokens} vs {tr.tokens}")
                lane = [u for u, _, _ in plan].index(uid)
                first = next(j for j, (x, y) in enumerate(
                    zip(jr.tokens + [None], tr.tokens + [None])) if x != y)
                lj = logits["jax"][lane]
                if lj.ndim == 2:                   # a verify lane's rows
                    lj = lj[first - before[uid]]
                top2 = np.sort(lj)[-2:]
                margin = float(top2[1] - top2[0])
                gap = float(np.abs(logits["torch"][:len(plan)]
                                   - logits["jax"][:len(plan)]).max())
                assert margin < gap, (f"request {uid} forked at "
                                      f"step {steps} with a JAX top-2 margin "
                                      f"{margin} above the measured logit "
                                      f"gap {gap}")
                assert not te.speculative, (
                    f"int8 near-tie fork of request {uid} at step {steps} "
                    f"(margin {margin} < gap {gap}) in a speculative run: "
                    f"the two schedules part here")
                near_ties.append((uid, steps, margin, gap))
                forked.add(uid)
            for uid in set(oj.tokens) | set(ot.tokens):
                if uid not in forked:
                    assert oj.tokens.get(uid) == ot.tokens.get(uid), steps
            if on_step is not None:
                on_step(je, te, steps)
    assert not te.scheduler.has_work()
    assert te.kv.free_pages == je.kv.free_pages
    streams = ({r.uid: r.tokens for r in je.finished},
               {r.uid: r.tokens for r in te.finished})
    for uid in streams[0]:
        if uid not in forked:
            assert streams[0][uid] == streams[1][uid], uid
    return dict(streams=streams, forked=forked, near_ties=near_ties,
                steps=steps, preempted=preempted, mixed=mixed,
                pages_in_use=(je.pages_in_use, te.pages_in_use),
                engines=(je, te), outs=outs)
