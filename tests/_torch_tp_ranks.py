"""Rank bodies of the port's tensor-parallel CPU tests, started by
``repro_torch.launch.mesh.spawn`` into a gloo group.  This module imports
neither JAX nor the reference package, so a spawned rank starts fast;
the tests compare what the ranks return against the reference.

Serving traces (``serve_trace``): a shared 16-token prefix published by
request 0, then requests 1–3 hitting it (3 ends mid-page: a partial hit
and a copy-on-write), and 4–7 of the reference test's prompt lengths, 4
and 5 sampled (seeded), the rest greedy; the prefix cache is on.  The
host pool state (refcounts, free heap, page tables) is recorded after
every step.
"""
import numpy as np
import torch

LANES, PAGE, PAGES, CHUNK, MAX_NEW = 3, 8, 48, 8, 5
BUCKETS = (8, 24)     # two stream widths: few step shapes to compile
SAMPLED = {4: dict(temperature=0.8, top_k=3, top_p=0.9, seed=42),
           5: dict(temperature=1.0, seed=7)}


def trace_prompts(vocab: int):
    """The trace's 8 prompts: requests 0–3 share a two-page prefix."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, vocab, 2 * PAGE).astype(np.int32)
    out = [np.concatenate([shared, [i], rng.integers(0, vocab, 4)])
           .astype(np.int32) for i in range(3)] + [shared[:12]]
    rng = np.random.default_rng(7)
    out += [rng.integers(0, vocab, n).astype(np.int32) for n in (5, 12, 20, 3)]
    return out


def waves():
    """Request ids per wave: 0 publishes the prefix, then the rest."""
    return [[0], list(range(1, 8))]


def serve_trace(request_cls, sampling_cls, eng) -> dict:
    """Drive ``eng`` (either package's ``EngineCore``) through the trace,
    wave by wave and step by step → streams, the pool state after every
    step, the prefix-cache statistics and the step count."""
    prompts = trace_prompts(eng.cfg.vocab_size)
    states = []
    for wave in waves():
        for u in wave:
            sp = (sampling_cls(**SAMPLED[u]) if u in SAMPLED else None)
            eng.submit(request_cls(uid=u, prompt=prompts[u],
                                   max_new=MAX_NEW, sampling=sp))
        while eng.scheduler.has_work():
            eng.step()
            states.append((list(eng.kv.ref), sorted(eng.kv.free),
                           [list(t) for t in eng.page_tables]))
    return dict(streams={r.uid: list(r.tokens) for r in eng.finished},
                states=states, prefix=dict(eng.prefix_stats),
                cow=eng.kv.cow_copies, trace_count=eng.trace_count)


def _engine(flat, name, mesh, replace=(), **kw):
    """A port engine at ``mesh`` over the reference's flat weights (cast
    to the config's dtype), the config's fields ``replace``d."""
    from repro_torch.configs import get_config
    from repro_torch.params import from_flat
    from repro_torch.serving import EngineCore
    cfg = get_config(name).replace(**dict(replace))
    dt = getattr(torch, cfg.dtype)
    params = {k: v.to(dt) if v.is_floating_point() else v
              for k, v in from_flat(flat, cfg, "cpu").items()}
    return EngineCore(cfg, params, lanes=LANES, page_size=PAGE,
                      num_pages=PAGES, chunk_size=CHUNK, prefix_cache=True,
                      token_buckets=BUCKETS, mesh=mesh, device="cpu", **kw)


def serve_cases(cases, mesh) -> list:
    """Each case (flat reference weights, config name, config fields)
    served at ``mesh`` → per case the trace's facts plus the engine's
    mesh size, head band, bytes a token and its measured bytes."""
    from repro_torch.serving import Request, SamplingParams
    out = []
    for flat, name, replace in cases:
        eng = _engine(flat, name, mesh, replace)
        facts = serve_trace(Request, SamplingParams, eng)
        width = 16
        facts.update(mesh_size=eng.mesh_size,
                     band=tuple(eng.kv.pool["k"].shape),
                     bytes_per_token=eng.collective_bytes_per_token,
                     measured=eng.measure_collective_bytes(width),
                     gauge=eng.obs.registry.value("collective_bytes_per_step"),
                     width=width,
                     itemsize=torch.empty((), dtype=getattr(
                         torch, eng.cfg.dtype)).element_size(),
                     pages_in_use=eng.pages_in_use,
                     captured=eng.graphs is not None)
        out.append(facts)
    return out


def refusals(flat, n: int) -> dict:
    """The engine's mesh refusals inside an n-rank group → message per
    case (None: no error)."""
    from repro_torch.launch.mesh import Mesh
    out = {}
    tries = {"padded": lambda: _engine(flat, "deepseek-7b-smoke", n,
                                       mode="padded")}
    if n == 4:           # 2 KV heads on 4 ranks
        tries["divide"] = lambda: _engine(flat, "deepseek-7b-smoke", n)
    tries["no_model_axis"] = lambda: _engine(
        flat, "deepseek-7b-smoke", Mesh((n,), ("data",)))
    for k, fn in tries.items():
        try:
            fn()
            out[k] = None
        except ValueError as e:
            out[k] = str(e)
    return out


def serving_rank(cases, flat_gqa):
    """One rank of an engine suite: every case at the group's size, the
    refusals, the first case's bytes measured in bf16; at 2 ranks also the
    first case through a port ``Mesh`` passed in place of the int."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    n = dist.get_world_size()
    out = dict(rank=dist.get_rank(), cases=serve_cases(cases, n),
               refusals=refusals(flat_gqa, n))
    flat, name, replace = cases[0]
    eng = _engine(flat, name, n, dict(replace, dtype="bfloat16"))
    out["bf16_measure"] = (eng.measure_collective_bytes(16),
                           eng.collective_bytes_per_token, 16)
    if n == 2:
        out["host_mesh"] = serve_cases(cases[:1], make_host_mesh(n))
        out["families"] = {name: family_streams(name, n)
                           for name in FAMILIES}
    return out


FAMILIES = ("granite-moe-3b-a800m-smoke", "internvl2-1b-smoke")


def family_streams(name: str, n: int) -> tuple:
    """A seeded f32 model of another decoder family (the MoE trunk, the
    vlm trunk served as text) through the trace at mesh ``n`` and on one
    device in this rank → (mesh streams, single-device streams)."""
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serving import EngineCore, Request, SamplingParams
    cfg = get_config(name).replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = {k: v.float() for k, v in params.items()}
    runs = []
    for mesh in (n, None):
        eng = EngineCore(cfg, params, lanes=LANES, page_size=PAGE,
                         num_pages=PAGES, chunk_size=CHUNK, prefix_cache=True,
                         token_buckets=BUCKETS, mesh=mesh, device="cpu")
        runs.append(serve_trace(Request, SamplingParams, eng)["streams"])
    return tuple(runs)


def fail_on_odd_rank():
    import torch.distributed as dist
    if dist.get_rank() % 2:
        raise ValueError("odd rank")
    return dist.get_rank()


def rank_and_size():
    import torch.distributed as dist
    return dist.get_rank(), dist.get_world_size()


# ----------------------------------------------------- multi-core softmax --

def multicore_rank(inputs):
    """One rank of the multi-core softmax / ring attention suite: each
    function on this rank's block of ``inputs`` (numpy), outputs gathered
    back whole → {name: numpy array} plus the butterfly's rounds."""
    import torch.distributed as dist
    from repro_torch.core import (attention, distributed_decode_attention,
                                  ring_attention, sharded_softmax,
                                  sharded_softmax_tree, tree_allreduce)
    from repro_torch.core import multicore_softmax
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.collectives import all_gather
    n, r = dist.get_world_size(), dist.get_rank()
    axis = Mesh((n,), ("model",)).axis("model")
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}

    def block(x, dim):
        size = x.shape[dim] // n
        return x.narrow(dim, r * size, size).contiguous()
    out = {}
    x = block(t["x"], 1)
    c0 = multicore_softmax.COUNTS["tree_rounds"]
    out["softmax"] = all_gather(sharded_softmax(x, axis), axis, dim=1)
    out["softmax_tree"] = all_gather(sharded_softmax_tree(x, axis), axis, 1)
    c1 = multicore_softmax.COUNTS["tree_rounds"]
    out["tree_sum"] = tree_allreduce(torch.arange(float(n))[r:r + 1],
                                     torch.add, axis)
    c2 = multicore_softmax.COUNTS["tree_rounds"]
    q, k, v = (block(t[name], 2) for name in ("q", "k", "v"))
    for i, kw in enumerate(RING_KW):
        out[f"ring{i}"] = all_gather(ring_attention(q, k, v, axis, **kw),
                                     axis, dim=2)
        out[f"ring_api{i}"] = all_gather(attention(
            q, k, v, backend="ring", axis_name=axis, exp_mode="lut", **kw),
            axis, dim=2)
    out["auto_ring"] = all_gather(attention(q, k, v, axis_name=axis,
                                            exp_mode="lut", causal=True),
                                  axis, dim=2)
    out["decode"] = distributed_decode_attention(
        t["qd"], block(t["kd"], 2), block(t["vd"], 2), axis,
        kv_len=int(inputs["kv_len"]))
    out["varlen"] = _varlen_band(t, axis, n, r)
    res = {k: v.numpy() for k, v in out.items()}
    res["rounds"] = (c1 - c0, c2 - c1)
    return res


RING_KW = (dict(causal=True), dict(causal=True, window=24),
           dict(causal=False, cap=25.0))


def _varlen_band(t, axis, n, r):
    """The registry's ragged backend on this rank's head band of the
    pools, the head axis all-gathered (``axis_name``)."""
    from repro_torch.core import attention
    hq, hkv = t["vq"].shape[1], t["vk"].shape[1]
    qb = t["vq"][:, r * hq // n:(r + 1) * hq // n]
    kb = t["vk"][:, r * hkv // n:(r + 1) * hkv // n].contiguous()
    vb = t["vv"][:, r * hkv // n:(r + 1) * hkv // n].contiguous()
    return attention(qb.contiguous(), kb, vb, backend="paged_varlen",
                     causal=True, page_table=t["vtable"], q_pos=t["vpos"],
                     cu_seqlens=t["vcu"], axis_name=axis)


# ------------------------------------------------------- #2 at a head band --

def band_rank(pool: str) -> dict:
    """One rank of the card test of kernel #2 at a rank's head band: a
    full-width packed stream (deepseek-7b's 32 heads of 128, page 16;
    decode lanes and a 64-row chunk) drawn whole on every rank, this
    rank's band of q and of the pools through the kernel, the bands
    all-gathered → the error against the plain version of the whole call,
    whether the gathered output equals the kernel's full-head launch bit
    for bit, and the launches the band call made."""
    import torch.distributed as dist
    from repro_torch.core.streaming_attention import quantize_kv_rows
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_varlen,
        paged_attention_varlen_reference, varlen_positions)
    from repro_torch.parallel.collectives import all_gather
    n, r = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", 0)
    hq, d, ps, pages = 32, 128, 16, 160
    spec = [(1, 37), (1, 311), (64, 520), (1, 598), (1, 870)]
    g = torch.Generator().manual_seed(5)
    need = [-(-kv // ps) for _, kv in spec]
    perm = torch.randperm(pages, generator=g).tolist()
    cu = np.concatenate([[0], np.cumsum([q for q, _ in spec])]).astype(np.int32)
    t = int(cu[-1])
    table = np.full((t, 64), pages, np.int32)
    off = 0
    for i, k in enumerate(need):
        table[cu[i]:cu[i + 1], :k] = perm[off:off + k]
        off += k
    pos = varlen_positions(cu, [kv for _, kv in spec])
    shape = (pages + 1, hq, ps, d)
    k, v = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    q = torch.randn((t, hq, d), generator=g)
    dt = torch.float32 if pool == "float32" else torch.bfloat16
    ks = vs = None
    if pool == "int8":
        kq, ks = quantize_kv_rows(k.reshape(1, -1, ps, d))
        vq, vs = quantize_kv_rows(v.reshape(1, -1, ps, d))
        k, v = kq.reshape(shape), vq.reshape(shape)
        ks, vs = ks.reshape(shape[:3]), vs.reshape(shape[:3])
    else:
        k, v = k.to(dt), v.to(dt)
    to = lambda x: None if x is None else x.to(dev)  # noqa: E731
    q, k, v, ks, vs = to(q.to(dt)), to(k), to(v), to(ks), to(vs)
    kw = dict(cu_seqlens=torch.from_numpy(cu).to(dev), block_q=8,
              block_pages=8)
    args = (torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev))
    h = hq // n
    band = lambda x: None if x is None else (  # noqa: E731
        x[:, r * h:(r + 1) * h].contiguous())
    before = (paged_attention.launches, paged_attention.combine_launches)
    got = paged_attention_varlen(band(q), band(k), band(v), *args,
                                 k_scale=band(ks), v_scale=band(vs), **kw)
    torch.cuda.synchronize()
    launches = (paged_attention.launches - before[0],
                paged_attention.combine_launches - before[1])
    whole = all_gather(got, None, dim=1)
    full = paged_attention_varlen(q, k, v, *args, k_scale=ks, v_scale=vs,
                                  **kw)
    want = paged_attention_varlen_reference(q, k, v, *args, k_scale=ks,
                                            v_scale=vs, **kw)
    gf, wf = whole.float(), want.float()
    mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return dict(launches=launches, dtype=str(whole.dtype),
                max_abs_err=float((gf - wf).abs().max()),
                close=bool(torch.allclose(gf, wf, atol=2e-5, rtol=1e-4)),
                bf16_ulps=float((((gf - wf).abs() - 2e-5).clamp_min(0.0)
                                 / ulp).max()),
                bits_equal_full=bool(torch.equal(whole, full)))


# ------------------------------------------------ tensor-parallel training --

def _trainer(name, dcfg_kw, mesh=None, **kw):
    """A port ``Trainer`` on the CPU: ``name`` in f32, the lm corpus."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.runtime import TrainConfig, Trainer
    cfg = get_config(name).replace(dtype="float32")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, **dcfg_kw)
    return Trainer(cfg, dcfg, TrainConfig(**kw), mesh=mesh, device="cpu")


def _logged(metrics) -> list:
    return [{k: m[k] for k in ("step", "loss", "lr", "grad_norm")}
            for m in metrics]


def train_mesh_rank(plan) -> dict:
    """One rank of ``tests/test_torch_train_mesh.py``'s runs at
    ``plan["shape"]`` ("data", "model"): each entry of ``plan["runs"]``
    is (tag, what, config name, data fields, train fields, directory);
    ``what`` says how the run goes ("stepwise": ``directory`` is one per
    step, each holding that step's checkpoint) → {tag: its logged
    metrics} and, for "refused", the error's text."""
    import os
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import FailureInjector
    mesh = Mesh(plan["shape"], ("data", "model"))
    out = {}
    for tag, what, name, dkw, tkw, path in plan["runs"]:
        kw = dict(tkw, ckpt_dir=path)
        if what == "refused":
            try:
                _trainer(name, dkw, mesh, **kw)
            except ValueError as e:
                out[tag] = str(e)
            continue
        if what == "stepwise":         # each step from its own checkpoint
            got = []
            for step, d in enumerate(path):
                tr = _trainer(name, dkw, mesh, **dict(tkw, ckpt_dir=d))
                tr.restore(step=step)
                got += tr.run(num_steps=1)
            out[tag] = _logged(got)
            continue
        if what == "elastic":          # a single-device checkpoint, re-cut
            tr = _trainer(name, dkw, None, **kw)
            tr.restore(mesh=mesh)
            out[tag] = _logged(tr.run(num_steps=plan["elastic_steps"]))
            out[tag + " mesh"] = dict(tr.mesh.shape)
            continue
        tr = _trainer(name, dkw, mesh, **kw)
        if what == "recover":          # a step-0 checkpoint, a failure at 2
            tr.init()
            tr.save()
            tr.ckpt.wait()
            got = tr.run(injector=FailureInjector(fail_at_steps=(2,)))
            out[tag + " checkpoints"] = sorted(os.listdir(path))
        else:
            got = tr.run()
        out[tag] = _logged(got)
        if what == "blocks":
            out[tag + " blocks"] = {k: tuple(v.shape)
                                    for k, v in tr.params.items()}
    return out


# ---------------------------------------------------------- the pipeline --

def pipeline_rank(inputs) -> dict:
    """One stage of ``tests/test_torch_pipeline.py``: the reference test's
    pipeline (``tanh(h @ w + b)`` per stage) over a ("pod",) mesh of every
    rank, its gradient for a fixed cotangent ``c`` (each rank's share of
    the stage parameters, and the input's), and ``compressed_psum`` of
    this rank's gradient tree."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import compressed_psum, pipeline_apply
    mesh = Mesh((dist.get_world_size(),), ("pod",))
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    params = {"w": t["ws"].clone().requires_grad_(),
              "b": t["bs"].clone().requires_grad_()}
    x = t["x"].clone().requires_grad_()
    f = lambda p, h: torch.tanh(h @ p["w"] + p["b"])  # noqa: E731
    out = pipeline_apply(f, params, x, mesh, axis="pod")
    dw, db, dx = torch.autograd.grad(torch.sum(out * t["c"]),
                                     (params["w"], params["b"], x))
    with torch.no_grad():
        plain = pipeline_apply(f, params, t["x"], mesh, axis="pod")
    r = dist.get_rank()
    summed = compressed_psum({"a": t["g"][r], "b": t["h"][r]},
                             mesh.axis("pod"))
    return dict(out=out.detach().numpy(), plain=plain.numpy(),
                dw=dw.numpy(), db=db.numpy(), dx=dx.numpy(),
                psum={k: v.numpy() for k, v in summed.items()})


# ------------------------------------------ #3 and #3b at a head band --

def attention_band_rank(dtype_name: str) -> dict:
    """One rank of the card test of kernel #3 and its backward at a rank's
    head band (the head count ``Trainer(mesh=)``'s model axis launches
    them at): deepseek-7b's 32 heads of 128 over 2 × 256 causal rows,
    drawn whole on every rank; this rank's band of 32 / ranks heads
    through #3 under autograd; the outputs and the gradients' bands
    all-gathered → whether they equal the 32-head launch's bit for bit,
    the errors against the plain forward and backward, and the launches
    the band made."""
    import torch.distributed as dist
    from repro_torch.kernels.streaming_attention.ops import (
        attention_bwd_ref, attention_ref, streaming_attention,
        streaming_attention_bwd, streaming_attention_lse)
    from repro_torch.parallel.collectives import all_gather
    n, r = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", 0)
    dt = getattr(torch, dtype_name)
    b, h, length, d = 2, 32, 256, 128
    g = torch.Generator().manual_seed(7)
    q, k, v, dout = (torch.randn((b, h, length, d), generator=g).to(dev, dt)
                     for _ in range(4))
    hb = h // n
    cut = lambda t: t[:, r * hb:(r + 1) * hb].contiguous()  # noqa: E731
    qb, kb, vb = (cut(t).requires_grad_() for t in (q, k, v))
    before = (streaming_attention.launches, streaming_attention_bwd.launches)
    out = streaming_attention(qb, kb, vb, causal=True)
    grads = torch.autograd.grad(out, (qb, kb, vb), cut(dout))
    torch.cuda.synchronize()
    launches = (streaming_attention.launches - before[0],
                streaming_attention_bwd.launches - before[1])
    whole = [all_gather(t.detach(), None, dim=1) for t in (out,) + grads]
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    full_out = streaming_attention(qf, kf, vf, causal=True)
    full = [full_out.detach()] + list(torch.autograd.grad(
        full_out, (qf, kf, vf), dout))
    scale = d ** -0.5
    o, lse = streaming_attention_lse(q, k, v, causal=True)
    want = [attention_ref(q, k, v, causal=True)] + list(attention_bwd_ref(
        q, k, v, o, lse, dout, scale=scale, causal=True))
    rel = [float((a.float() - w.float()).abs().max()
                 / w.float().abs().max()) for a, w in zip(whole, want)]
    return dict(launches=launches,
                bits_equal_full=all(torch.equal(a, f)
                                    for a, f in zip(whole, full)),
                rel_err=rel)
