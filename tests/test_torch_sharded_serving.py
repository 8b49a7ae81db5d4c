"""Tensor-parallel serving: the port's ``EngineCore(mesh=N)`` in N gloo
ranks on the CPU against the reference's single-device ``EngineCore``
(the contract of ``tests/test_sharded_serving.py``).

Each rank's pool holds its band of the KV heads and every layer
all-gathers the head axis, so the streams must be token-identical to the
single-device engine's — greedy and seeded, float and int8 pools, the
prefix cache on — and the host page accounting (refcounts, free heap,
page tables, after every step) equal to the reference's.  Mesh 2 serves
deepseek-7b-smoke with MHA (4 : 4 heads) and GQA (4 : 2), mesh 4 the MHA
config, each on both pools, in f32 as the port's engine twins run (in
bf16 the two frameworks' roundings part one greedy request of this trace
at a near-tie, on one device as on a mesh).  The ranks run in a background thread
(``repro_torch.launch.mesh.spawn``, a ``file://`` rendezvous under
``tmp_path``) while this process serves the same traces through the
reference.  Runs in ~45 s alone (the reference's compiles most of it).
"""
import threading

import jax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process

import torch.distributed as dist  # noqa: E402

from repro.checkpoint.store import flatten_tree  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import EngineCore as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.params import _to_torch  # noqa: E402
from repro_torch.serving import Request, SamplingParams  # noqa: E402
from tests import _torch_tp_ranks as ranks  # noqa: E402

NAME = "deepseek-7b-smoke"
F32 = dict(dtype="float32")
CASES = {"mha": dict(F32, num_heads=4, num_kv_heads=4),
         "mha_int8": dict(F32, num_heads=4, num_kv_heads=4, kv_quant=True),
         "gqa": dict(F32), "gqa_int8": dict(F32, kv_quant=True)}
MESHES = {2: ("mha", "mha_int8", "gqa", "gqa_int8"), 4: ("mha", "mha_int8")}
PAIRS = [(c, n) for n, cs in MESHES.items() for c in cs]


def _weights(case, params=None):
    """The reference's weights for a case (``params``: drawn already for
    the case's heads): (JAX config, JAX params, the flat leaves as torch
    tensors — bf16 by bit view, picklable)."""
    cfg = j_get_config(NAME).replace(**CASES[case])
    if params is None:
        params = build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, {k: _to_torch(v) for k, v in
                         flatten_tree(params).items()}


def _reference(cfg, params):
    eng = JEngine(cfg, params, lanes=ranks.LANES, page_size=ranks.PAGE,
                  num_pages=ranks.PAGES, chunk_size=ranks.CHUNK,
                  prefix_cache=True, token_buckets=ranks.BUCKETS)
    return ranks.serve_trace(JRequest, JSamplingParams, eng)


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """{"ref": {case: facts}, n: [rank 0's result, rank 1's, ...]}: the
    mesh ranks run in threads while the reference serves here."""
    tmp = tmp_path_factory.mktemp("tp_serving")
    weights = {"mha": _weights("mha"), "gqa": _weights("gqa")}
    for c in ("mha", "gqa"):              # an int8 pool: the same weights
        weights[f"{c}_int8"] = _weights(f"{c}_int8", weights[c][1])
    out, errors = {}, []

    def run(n):
        try:
            cases = [(weights[c][2], NAME, CASES[c]) for c in MESHES[n]]
            out[n] = spawn(ranks.serving_rank, n, cases, weights["gqa"][2],
                           threads=1, root=str(tmp), timeout=300)
        except BaseException as e:              # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(n,)) for n in MESHES]
    for t in threads:
        t.start()
    try:
        out["ref"] = {c: _reference(w[0], w[1]) for c, w in weights.items()}
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return out


def _case(suite, case, n):
    return [r["cases"][MESHES[n].index(case)] for r in suite[n]]


@pytest.mark.parametrize("case, n", PAIRS)
def test_mesh_streams_equal_the_reference(suite, case, n):
    """Greedy and seeded streams, with prefix hits, a partial hit and its
    copy-on-write, token-identical on every rank."""
    want = suite["ref"][case]["streams"]
    for rank in _case(suite, case, n):
        assert rank["streams"] == want


@pytest.mark.parametrize("case, n", PAIRS)
def test_mesh_page_accounting_equals_the_reference(suite, case, n):
    """Refcounts, free heap and page tables after every step, the prefix
    cache's statistics and copies, and the step traces: the pool's page
    axis is whole on every rank, so the host state is the reference's."""
    want = suite["ref"][case]
    for rank in _case(suite, case, n):
        assert rank["states"] == [
            (list(r), list(f), [list(t) for t in p])
            for r, f, p in want["states"]]
        assert rank["prefix"] == want["prefix"]
        assert rank["cow"] == want["cow"] >= 1
        assert rank["trace_count"] == want["trace_count"]


@pytest.mark.parametrize("case, n", PAIRS)
def test_mesh_pool_band_and_collective_bytes(suite, case, n):
    """Each rank holds Hkv/n heads of every page; the reference's
    per-token formula (an f32 gather, Hq·Dh·4·(n−1)/n a layer); the bytes
    measured through the all-gather on one step of width 16 — an f32
    model's — are that formula × width, and land in the gauge."""
    cfg = get_config(NAME).replace(**CASES[case])
    for rank in _case(suite, case, n):
        assert rank["mesh_size"] == n and not rank["captured"]
        assert rank["band"] == (cfg.num_layers, ranks.PAGES + 1,
                                cfg.num_kv_heads // n, ranks.PAGE,
                                cfg.d_head)
        per_layer = cfg.num_heads * cfg.d_head * 4
        assert rank["bytes_per_token"] == (cfg.num_layers * per_layer
                                           * (n - 1) // n)
        assert rank["itemsize"] == 4
        assert rank["measured"] == rank["bytes_per_token"] * rank["width"] > 0
        assert rank["gauge"] == rank["measured"]


@pytest.mark.parametrize("n", sorted(MESHES))
def test_bf16_wire_carries_half_the_f32_count(suite, n):
    """A bf16 model gathers its bf16 attention output: the measured bytes
    are half the reference's f32 formula × width."""
    for rank in suite[n]:
        measured, per_token, width = rank["bf16_measure"]
        assert measured == per_token * width // 2 > 0


@pytest.mark.parametrize("n", sorted(MESHES))
def test_mesh_refusals(suite, n):
    """Construction-time errors in every rank: the padded oracle, a mesh
    that does not divide the head counts (2 KV heads on 4 ranks), a mesh
    without a "model" axis."""
    for rank in suite[n]:
        got = rank["refusals"]
        assert "ragged" in got["padded"]
        assert "'model' axis" in got["no_model_axis"]
        if n == 4:
            assert "divide" in got["divide"]


def test_a_port_mesh_object_serves_as_the_int(suite):
    """``make_host_mesh(2)`` (a ("data", "model") mesh of 1 × 2) in place
    of ``mesh=2``: the same streams and accounting."""
    for rank in suite[2]:
        a, b = rank["host_mesh"][0], rank["cases"][0]
        assert (a["streams"], a["states"]) == (b["streams"], b["states"])


@pytest.mark.parametrize("name", ranks.FAMILIES)
def test_mesh_serves_the_moe_and_vlm_trunks(suite, name):
    """The MoE and vlm trunks take the head band too: granite-moe and
    internvl2 (f32, seeded) at mesh 2 serve the single-device streams."""
    for rank in suite[2]:
        mesh, single = rank["families"][name]
        assert mesh == single and len(mesh) == 8


def test_mesh_one_is_the_single_device_path():
    """``mesh=1`` and a one-rank ``Mesh`` are ``mesh=None``: no process
    group, the captured step, no collective, the same streams."""
    assert not dist.is_initialized()
    flat = _weights("gqa")[2]
    runs = []
    for mesh in (None, 1, Mesh((1,), ("model",))):
        eng = ranks._engine(flat, NAME, mesh, CASES["gqa"])
        assert eng.mesh is None and eng.graphs is not None
        assert eng.mesh_size == 1 and eng.collective_bytes_per_token == 0
        assert eng.tp_axis is None
        runs.append(ranks.serve_trace(Request, SamplingParams, eng))
        assert eng.measure_collective_bytes() == 0
        assert eng.obs.registry.value("collective_bytes_per_step") == 0
    assert runs[1] == runs[0] == runs[2]
    assert not dist.is_initialized()


def test_mesh_without_a_process_group_raises():
    """An int mesh needs an initialised default group of that many ranks
    (the reference: "only N visible"), and says how to start them."""
    with pytest.raises(ValueError, match="only 1 .*spawn"):
        ranks._engine(_weights("gqa")[2], NAME, 2, CASES["gqa"])
