"""The port's sharding rules (``repro_torch.parallel.sharding``), meshes
(``repro_torch.launch.mesh``) and activation context against the
reference's.

The reference's ``fit_spec`` reads only ``mesh.axis_names`` and
``mesh.shape[axis]``, so one stand-in mesh serves both packages: a
(4, 4) ("data", "model") grid for the parameter, batch and cache rules,
(1, 4) for the pool.  Parameter shapes come from ``jax.eval_shape`` of
each assigned config's init at its published widths; cache shapes from
the reference's ``input_specs``.  Every port spec must equal the
reference's ``PartitionSpec`` entry for entry.  Runs in ~10 s alone.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process

from repro.configs import ASSIGNED  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model, input_specs  # noqa: E402
from repro.parallel import sharding as j_sh  # noqa: E402
from repro.serving.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import ctx as t_ctx  # noqa: E402
from repro_torch.parallel import sharding as t_sh  # noqa: E402
from repro_torch.params import init_params, to_flat  # noqa: E402
from repro_torch.serving.paged import PagedKVCache  # noqa: E402
from tests import _torch_tp_ranks as ranks  # noqa: E402


class StandIn:
    """What both packages' rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


MESH = StandIn((4, 4), ("data", "model"))
POOL_MESH = StandIn((1, 4), ("data", "model"))


def _leaves(tree):
    """(reference path, shape) of every leaf of a JAX tree."""
    return [(j_sh.path_str(kp), tuple(x.shape))
            for kp, x in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.fixture(scope="module")
def shapes():
    """Every assigned config's parameter leaves at its published widths."""
    return {name: _leaves(jax.eval_shape(
        build_model(j_get_config(name)).init, jax.random.PRNGKey(0)))
        for name in ASSIGNED}


@pytest.mark.parametrize("name", ASSIGNED)
def test_param_specs_equal_the_reference(shapes, name):
    """Rule by rule on every path and shape, and through ``param_specs``
    over the flat {path: leaf} dict."""
    leaves = shapes[name]
    assert leaves
    flat = {p: torch.empty(s, device="meta") for p, s in leaves}
    got = t_sh.param_specs(flat, MESH)
    for path, shape in leaves:
        want = tuple(j_sh.param_pspec(path, shape, MESH))
        assert t_sh.param_pspec(path, shape, MESH) == want, (path, shape)
        assert got[path] == want


@pytest.mark.parametrize("name", ["deepseek-7b-smoke",
                                  "granite-moe-3b-a800m-smoke",
                                  "zamba2-1.2b-smoke", "gemma2-9b-smoke"])
def test_port_params_flattened_take_the_reference_specs(name):
    """The port's params, flattened to the reference's paths
    (``params.to_flat``), get the reference's spec leaf for leaf."""
    cfg = get_config(name)
    flat = to_flat(init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                   cfg)
    want = dict(_leaves(jax.eval_shape(
        build_model(j_get_config(name)).init, jax.random.PRNGKey(0))))
    assert {p: tuple(x.shape) for p, x in flat.items()} == want
    got = t_sh.param_specs(flat, MESH)
    for path, shape in want.items():
        assert got[path] == tuple(j_sh.param_pspec(path, shape, MESH)), path


@pytest.mark.parametrize("name", ASSIGNED)
def test_cache_specs_equal_the_reference(name):
    """Head / sequence rules of the reference's decode state, both
    modes (``decode=True``: the multi-core softmax's sequence split)."""
    cfg = j_get_config(name)
    state = input_specs(cfg, "decode", 1024, 16).get("state")
    if state is None:
        pytest.skip(f"{name} has no decode state in the reference")
    leaves = _leaves(state)
    flat = {p: torch.empty(s, device="meta") for p, s in leaves}
    for decode in (False, True):
        got = (t_sh.cache_specs_decode if decode else t_sh.cache_specs)(
            flat, MESH)
        for path, shape in leaves:
            want = tuple(j_sh.cache_pspec(path, shape, MESH, decode=decode))
            assert got[path] == want, (path, shape, decode)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_pool_specs_equal_the_reference(heads):
    """The reference pool's own leaves under its rule and the port's, and
    the port pool's leaves: the KV heads on "model" where 4 divides them
    (MHA), replicated where not (2 KV heads)."""
    hq, hkv = heads
    j_cfg = j_get_config("deepseek-7b-smoke").replace(num_heads=hq,
                                                      num_kv_heads=hkv)
    j_pool = JPagedKVCache(build_model(j_cfg), 8, 8).pool
    for path, shape in _leaves(j_pool):
        assert t_sh.pool_pspec(path, shape, POOL_MESH) == tuple(
            j_sh.pool_pspec(path, shape, POOL_MESH)), path
    cfg = get_config("deepseek-7b-smoke").replace(num_heads=hq,
                                                  num_kv_heads=hkv,
                                                  kv_quant=True)
    pool = PagedKVCache(cfg, 8, 8).pool
    specs = t_sh.pool_specs(pool, POOL_MESH)
    head = "model" if hkv % 4 == 0 else None
    assert specs["k"] == specs["v"] == (None, None, head, None, None)
    assert specs["ks"] == specs["vs"] == (None, None, head, None)
    for k, x in pool.items():
        assert specs[k] == tuple(j_sh.pool_pspec(k, tuple(x.shape), POOL_MESH))


def test_batch_specs_equal_the_reference():
    batch = {"tokens": (16, 512), "labels": (16, 512), "mask": (3, 7)}
    got = t_sh.batch_specs({k: torch.empty(s, device="meta")
                            for k, s in batch.items()}, MESH)
    for k, s in batch.items():
        assert got[k] == tuple(j_sh.batch_pspec(k, s, MESH))


@pytest.mark.parametrize("spec, shape, uneven", [
    (("fsdp", "tp"), (16, 32), False), (("dp", None), (3, 7), False),
    (("tp", "fsdp"), (6, 8), False), ((("data", "model"), None), (32, 4), False),
    ((("data", "model"), None), (8, 4), False), (("sp",), (6,), True),
    (("tp", "tp"), (16, 16), False), (("pod", "model"), (4, 4), False),
    ((None, "dp", "tp"), (2, 15, 17), True)])
def test_fit_spec_equals_the_reference(spec, shape, uneven):
    for mesh in (MESH, StandIn((2, 4, 2), ("pod", "data", "model"))):
        assert t_sh.fit_spec(spec, shape, mesh, allow_uneven=uneven) == tuple(
            j_sh.fit_spec(spec, shape, mesh, allow_uneven=uneven))
    assert t_sh.logical_axes(MESH) == j_sh.logical_axes(MESH)


@pytest.mark.parametrize("rank", range(8))
def test_shard_tree_gives_each_rank_its_block(rank):
    """On a (2, 4) layout, rank r's block of a pool is its model index's
    head band, of the shape ``PagedKVCache(heads=)`` allocates."""
    mesh = t_mesh.Mesh((2, 4), ("data", "model"), rank=rank)
    assert mesh.coords == {"data": rank // 4, "model": rank % 4}
    cfg = get_config("deepseek-7b-smoke").replace(num_heads=4, num_kv_heads=4,
                                                  kv_quant=True)
    pool = PagedKVCache(cfg, 6, 8).pool
    g = torch.Generator().manual_seed(0)
    pool = {k: torch.randn(v.shape, generator=g) for k, v in pool.items()}
    specs = t_sh.pool_specs(pool, mesh)
    assert t_sh.shardings_of(specs, mesh)["k"] == {2: (("model",), 4)}
    mine = t_sh.shard_tree(pool, specs, mesh)
    i = mesh.coords["model"]
    for k, x in pool.items():
        assert torch.equal(mine[k], x[:, :, i:i + 1])
    band = PagedKVCache(cfg, 6, 8, heads=1).pool
    assert {k: v.shape for k, v in band.items()} == {
        k: v.shape for k, v in mine.items()}


def test_pool_head_band_must_divide():
    cfg = get_config("deepseek-7b-smoke")          # 2 KV heads
    with pytest.raises(ValueError, match="does not divide"):
        PagedKVCache(cfg, 4, 8, heads=3)


def test_meshes_without_a_process_group():
    """A mesh is a layout until a group runs: its axes have no group and a
    collective over one raises; the production meshes need their ranks."""
    mesh = t_mesh.Mesh((2, 4), ("data", "model"), rank=6)
    ax = mesh.axis("model")
    assert (ax.size, ax.index, ax.ranks, ax.group) == (4, 2, (4, 5, 6, 7),
                                                      None)
    assert mesh.axis("data").ranks == (2, 6)
    with pytest.raises(RuntimeError, match="spawn"):
        collectives.all_gather(torch.zeros(2), ax)
    with pytest.raises(RuntimeError, match="spawn"):
        collectives.all_reduce(torch.zeros(2), "sum", None)
    for multi in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            t_mesh.make_production_mesh(multi_pod=multi)
    host = t_mesh.make_host_mesh()
    assert dict(host.shape) == {"data": 1, "model": 1}
    one = host.axis("model")
    x = torch.arange(3.0)
    assert collectives.all_gather(x, one) is x       # a size-1 axis: no-op
    with pytest.raises(ValueError):
        t_mesh.make_host_mesh(model=2)
    with pytest.raises(KeyError):
        mesh.axis("pod")


def test_maybe_shard_is_the_identity_with_or_without_a_mesh():
    mesh = t_mesh.make_host_mesh()
    x = torch.randn(2, 3, 4)
    assert t_ctx.active_mesh() is None
    assert t_ctx.maybe_shard(x, ("dp", "sp", None)) is x
    with t_ctx.activation_sharding(mesh):
        assert t_ctx.active_mesh() is mesh
        assert t_ctx.maybe_shard(x, ("dp", None, "tp")) is x
    assert t_ctx.active_mesh() is None


def test_spawn_reports_a_failing_rank(tmp_path):
    """A rank that raises fails the whole run, with its traceback, and no
    rank is left running."""
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*odd rank"):
        t_mesh.spawn(ranks.fail_on_odd_rank, 2, threads=1, root=str(tmp_path),
                     timeout=300)
    assert np.array_equal(t_mesh.spawn(ranks.rank_and_size, 2, threads=1,
                                       root=str(tmp_path), timeout=300),
                          [(0, 2), (1, 2)])
