"""The port's kernel-config tuner (``repro_torch.kernels.autotune``) and its
roofline (``repro_torch.perfmodel``) against the reference's
``repro.kernels.autotune`` and ``repro.perfmodel.model``, on the CPU.

The roofline, the candidate space, the sweep and the table are pure Python
on both sides, so they must agree exactly: equal floats, equal winners,
equal reports (the port's configs carry one more key, the card's
``kv_split``, which the comparison leaves out).  No test here builds an
engine of the reference.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process

from repro.kernels import autotune as J  # noqa: E402
from repro.perfmodel import model as JM  # noqa: E402
from repro_torch import perfmodel as TM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import autotune as T  # noqa: E402
from repro_torch.kernels.paged_attention.ops import default_kv_split  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serving import EngineCore, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GEOMS = [dict(hq=4, hkv=2, head_dim=16, page_size=8),
         dict(hq=8, hkv=2, head_dim=64, page_size=16, kv_bytes=1),
         dict(hq=32, hkv=32, head_dim=128, page_size=16)]


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """No pinned active config and no table override leak between tests."""
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_PATH", raising=False)
    T.set_active_config(None)
    yield
    T.set_active_config(None)


def four_keys(described):
    """A port ``describe()`` without the card's ``kv_split``."""
    return {k: v for k, v in described.items() if k != "kv_split"}


def random_segments(rng, n):
    out = []
    for _ in range(n):
        n_new = int(rng.integers(0, 70))
        out.append((n_new, n_new + int(rng.integers(0, 300))))
    return out


@pytest.mark.parametrize("platform", ["cpu", "tpu"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roofline_equals_the_reference(platform, seed):
    rng = np.random.default_rng(seed)
    segments = random_segments(rng, 9)
    for bq in (1, 4, 8, 32):
        for bp in (1, 3, 8):
            for kv_bytes, scaled in ((4, False), (1, True), (2, False)):
                kw = dict(block_q=bq, block_pages=bp, page_size=8, hq=8,
                          hkv=2, head_dim=32, kv_bytes=kv_bytes,
                          scaled=scaled)
                tt = TM.varlen_attention_traffic(segments, **kw)
                jt = JM.varlen_attention_traffic(segments, **kw)
                assert tt == jt
                for dq in ("block", "page"):
                    assert TM.varlen_attention_roofline(
                        TM.platform_spec(platform), tt, block_pages=bp,
                        dequant=dq) == JM.varlen_attention_roofline(
                        JM.platform_spec(platform), jt, block_pages=bp,
                        dequant=dq)
    assert (dataclasses.asdict(TM.platform_spec(platform))
            == dataclasses.asdict(JM.platform_spec(platform)))
    assert TM.platform_spec("nope") == TM.platform_spec("cpu")


def test_candidate_space_equals_the_reference_on_the_cpu():
    for ps, kw in ((8, {}), (16, dict(max_block_q=8, max_block_pages=2))):
        got = [four_keys(c.describe())
               for c in T.candidate_space(ps, platform="cpu", **kw)]
        want = [c.describe() for c in J.candidate_space(ps, **kw)]
        assert got == want
    assert four_keys(T.DEFAULT_CONFIG.describe()) == J.DEFAULT_CONFIG.describe()
    assert T.DEFAULT_CONFIG.kv_split is None


@pytest.mark.parametrize("geom", GEOMS)
def test_tune_equals_the_reference_on_the_cpu(geom):
    wl = T.default_workloads(lanes=4, chunk=16, decode_ctx=96)
    assert wl == J.default_workloads(lanes=4, chunk=16, decode_ctx=96)
    tw, trep = T.tune(T.KernelGeom(**geom), platform="cpu", workloads=wl)
    jw, jrep = J.tune(J.KernelGeom(**geom), platform="cpu", workloads=wl)
    assert four_keys(tw.describe()) == jw.describe()
    assert tw.source == "tuned" and tw.kv_split is None
    assert [dict(r, config=four_keys(r["config"])) for r in trep] == jrep


def test_geom_for_takes_the_pool_dtype():
    cfg = get_config("deepseek-7b")
    assert T.geom_for(cfg, page_size=16).kv_bytes == 2
    assert T.geom_for(cfg, page_size=16, quantized=True).kv_bytes == 1
    g = T.geom_for(cfg.replace(dtype="float32"), page_size=8)
    assert (g.hq, g.hkv, g.head_dim, g.page_size, g.kv_bytes, g.q_bytes) == (
        32, 32, 128, 8, 4, 4)
    assert T.geom_for(cfg, page_size=16, quantized=True).scaled


def test_cuda_sweep_holds_the_default_and_no_single_page_split():
    space = T.candidate_space(16, platform="cuda")
    assert {(c.block_q, c.kv_split) for c in space} == {
        (bq, n) for bq in (1, 4, 8, 16, 32) for n in (2, 4, 8, 16)}
    assert all(c.block_pages is None and c.dequant == "block" for c in space)
    geom = T.geom_for(get_config("deepseek-7b"), page_size=16)
    wl = T.default_workloads(lanes=8, chunk=256, decode_ctx=1024)
    winner, report = T.tune(geom, platform="cuda", workloads=wl)
    configs = [r["config"] for r in report]
    assert T.DEFAULT_CONFIG.describe() in configs
    assert all(c["kv_split"] != 1 for c in configs)
    assert all(np.isfinite(r["predicted_s"]) and r["predicted_s"] > 0
               for r in report)
    best = min(report, key=lambda r: r["predicted_s"])
    assert dict(best["config"], source="tuned") == winner.describe()


def test_weights_scale_each_workload():
    """A workload's weight multiplies its share of the score; unit weights
    leave the reference's score as it was, on either platform's model."""
    geom = T.geom_for(get_config("deepseek-7b"), page_size=16)
    wl = T.default_workloads(lanes=8, chunk=256, decode_ctx=1024)
    for platform in ("cpu", "cuda"):
        spec = TM.platform_spec(platform)
        for c in (T.DEFAULT_CONFIG, T.KernelConfig(block_q=16, kv_split=8)):
            each = {k: T.predict_step_s(c, geom, {k: v}, spec)
                    for k, v in wl.items()}
            assert T.predict_step_s(c, geom, wl, spec) == pytest.approx(
                sum(each.values()), rel=1e-12)
            assert T.predict_step_s(c, geom, wl, spec, {k: 1 for k in wl}) \
                == T.predict_step_s(c, geom, wl, spec)
            got = T.predict_step_s(c, geom, wl, spec, {"all_decode": 34,
                                                       "mixed": 5})
            assert got == pytest.approx(34 * each["all_decode"]
                                        + 5 * each["mixed"]
                                        + each["all_prefill"], rel=1e-12)
    # a decode-heavy mix can move the winner, and the report follows it
    w, rep = T.tune(geom, platform="cuda", workloads=wl,
                    weights={"all_decode": 1000})
    assert dict(min(rep, key=lambda r: r["predicted_s"])["config"],
                source="tuned") == w.describe()


def test_tuner_runs_on_the_card_unless_told_otherwise():
    """The platform defaults to ``cuda``: measuring there needs a card and
    raises without one (never a quiet CPU timing); the roofline alone
    needs none, and on ``cuda`` it prunes nothing."""
    geom = T.KernelGeom(hq=4, hkv=2, head_dim=16, page_size=4)
    wl = T.default_workloads(lanes=3, chunk=6, decode_ctx=20)
    assert T.resolve_config("deepseek-7b") == T.resolve_config(
        "deepseek-7b", "cuda")
    assert T.active_config() == T.resolve_config("default", "cuda")
    winner, report = T.tune(geom, workloads=wl)
    assert "measured_s" not in report[0] and winner.source == "tuned"
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the raise is for card-less hosts")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.measure_step_s(T.DEFAULT_CONFIG, geom, wl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.tune(geom, workloads=wl, measure=True,
               candidates=[T.DEFAULT_CONFIG])


def test_card_model_counts_partials_dead_rows_and_waves():
    """The card's kernel model: a decode lane at block_q 8 computes 8 rows
    and writes their partials; partials are R·(D + 2)·4 bytes per
    (q-block, kv head, live split) each way; the pool's element size."""
    kw = dict(page_size=16, hq=32, hkv=32, head_dim=128)
    seg = [(1, 1000)]                            # 63 pages
    t8 = TM.paged_kernel_traffic(seg, block_q=8, kv_split=4, **kw)
    t1 = TM.paged_kernel_traffic(seg, block_q=1, kv_split=4, **kw)
    assert t8["flops"] == 8 * t1["flops"]
    assert t8["bytes_kv"] == t1["bytes_kv"] == 32 * 63 * 16 * 2 * 128 * 2
    assert t8["bytes_partials"] == 2 * 32 * 16 * 8 * 130 * 4
    assert t8["blocks"] == 32 * 16
    t16 = TM.paged_kernel_traffic(seg, block_q=8, kv_split=16, **kw)
    assert t16["bytes_partials"] == t8["bytes_partials"] / 4
    i8 = TM.paged_kernel_traffic(seg, block_q=8, kv_split=4, kv_bytes=1,
                                 scaled=True, **kw)
    assert i8["bytes_kv"] == 32 * 63 * 16 * (2 * 128 + 8)
    spec = TM.platform_spec("cuda")
    floor = t8["bytes_total"] / (spec.mem_bw_gbs * 1e9)
    assert TM.paged_kernel_roofline(spec, t8) == pytest.approx(
        floor + -(-t8["blocks"] // TM.SMS) * spec.dispatch_ns * 1e-9)


def test_table_round_trip_and_fallback_order(tmp_path, monkeypatch):
    p = tmp_path / "table.json"
    assert T.resolve_config("m", "cpu", path=p) == T.DEFAULT_CONFIG
    T.save_config("default", "cpu", T.KernelConfig(block_q=4, block_pages=2),
                  path=p)
    got = T.resolve_config("m", "cpu", path=p)
    assert (got.block_q, got.block_pages, got.source) == (4, 2, "tuned")
    T.save_config("m", "cpu", T.KernelConfig(block_q=16, kv_split=8), path=p)
    got = T.resolve_config("m", "cpu", path=p)
    assert (got.block_q, got.kv_split, got.source) == (16, 8, "tuned")
    assert T.resolve_config("m", "cuda", path=p) == T.DEFAULT_CONFIG
    assert set(T.load_table(p)) == {"default::cpu", "m::cpu"}
    # unknown keys are dropped; the reference reads the port's row alike
    table = json.loads(p.read_text())
    table["m::cpu"]["tile_n"] = 256
    p.write_text(json.dumps(table))
    assert T.resolve_config("m", "cpu", path=p).block_q == 16
    want = J.resolve_config("m", "cpu", path=p)
    assert four_keys(T.resolve_config("m", "cpu", path=p).describe()) == \
        want.describe()
    # the override variable is the port's own, never the reference's
    monkeypatch.setenv("REPRO_AUTOTUNE_PATH", str(p))
    assert T.table_path() == ROOT / "src/repro_torch/kernels/autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_PATH", str(p))
    assert T.table_path() == p
    assert T.resolve_config("m", "cpu").block_q == 16
    (tmp_path / "bad.json").write_text("{not json")
    assert T.load_table(tmp_path / "bad.json") == {}


def test_committed_cpu_rows_equal_the_reference_rows():
    port = json.loads((ROOT / "src/repro_torch/kernels/autotune.json")
                      .read_text())
    ref = json.loads((ROOT / "src/repro/configs/autotune.json").read_text())
    assert {k: v for k, v in port.items() if k.endswith("::cpu")} == {
        k: v for k, v in ref.items() if k.endswith("::cpu")}
    assert not any(k.endswith("::tpu") for k in port)
    for model in ("deepseek-7b-smoke", "default", "bert-base"):
        got = T.resolve_config(model, "cpu")
        want = J.resolve_config(model, "cpu", path=ROOT /
                                "src/repro/configs/autotune.json")
        assert four_keys(got.describe()) == want.describe()
        assert (got.block_q, got.block_pages) == (8, 8)


def test_committed_cuda_rows_name_a_split():
    """The card's rows come from ``tune(..., measure=True)`` on the card
    (``tools/tune_kernels.py``); each names its pages per split, none 1."""
    port = json.loads((ROOT / "src/repro_torch/kernels/autotune.json")
                      .read_text())
    rows = {k: v for k, v in port.items() if k.endswith("::cuda")}
    assert set(rows) == {"deepseek-7b::cuda", "default::cuda"}
    for row in rows.values():
        assert row["source"] == "tuned" and row["kv_split"] in (2, 4, 8, 16)
        assert row["block_q"] in (1, 4, 8, 16, 32)
    got = T.resolve_config("deepseek-7b", "cuda")
    assert got.describe() == rows["deepseek-7b::cuda"]


@pytest.mark.parametrize("quantized", [False, True])
def test_measure_step_s_runs_the_plain_version(quantized):
    geom = T.KernelGeom(hq=4, hkv=2, head_dim=16, page_size=4,
                        kv_bytes=1 if quantized else 4)
    wl = T.default_workloads(lanes=3, chunk=6, decode_ctx=20)
    for config in (T.DEFAULT_CONFIG, T.KernelConfig(block_q=1, kv_split=2)):
        s = T.measure_step_s(config, geom, wl, device="cpu", iters=2)
        assert np.isfinite(s) and s > 0
    winner, report = T.tune(geom, platform="cpu", workloads=wl, measure=True,
                            top_k_measure=2, iters=1)
    timed = [r for r in report if "measured_s" in r]
    assert len(timed) == 2
    assert dict(min(timed, key=lambda r: r["measured_s"])["config"],
                source="tuned") == winner.describe()


def test_ragged_call_without_a_config_consults_the_active_one():
    from repro_torch.core.attention_api import ragged_attention
    geom = T.KernelGeom(hq=4, hkv=2, head_dim=16, page_size=4)
    args, kw = T.synthetic_step([(6, 9), (1, 13), (3, 3)], geom, "cpu")
    seen = []

    def attend(*a, **k):
        seen.append({n: k[n] for n in ("block_q", "block_pages", "kv_split")})
        return a[0]
    ragged_attention(*args, attend=attend, **kw)
    T.set_active_config(T.KernelConfig(block_q=4, block_pages=2, kv_split=3))
    ragged_attention(*args, attend=attend, **kw)
    ragged_attention(*args, attend=attend, kernel_config=T.KernelConfig(
        block_q=16), **kw)
    assert seen == [dict(block_q=8, block_pages=8, kv_split=None),
                    dict(block_q=4, block_pages=2, kv_split=3),
                    dict(block_q=16, block_pages=None, kv_split=None)]
    # a config of the same block shapes gives the same result as the default
    T.set_active_config(None)
    from repro_torch.kernels.paged_attention import paged_attention_varlen
    got = ragged_attention(*args, **kw)
    want = paged_attention_varlen(*args, block_q=8, block_pages=8, **kw)
    assert torch.equal(got, want)


def test_engine_resolves_the_table_and_records_its_config():
    """``EngineCore`` takes the reference's ``seed=`` and ``kernel_config=``:
    it resolves the CPU row when given none, and every step that runs the
    model records the config; the free heap drains back to every page."""
    cfg = get_config("deepseek-7b-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = np.arange(11, dtype=np.int32)
    streams = {}
    for kc in (None, T.KernelConfig(block_q=4, kv_split=2)):
        eng = EngineCore(cfg, params, lanes=2, page_size=8, num_pages=8,
                         device="cpu", seed=3, kernel_config=kc)
        want = kc or T.resolve_config(cfg.name, "cpu")
        assert eng.kernel_config == want
        assert want.source == ("tuned" if kc is None else "default")
        eng.submit(Request(uid=0, prompt=prompt, max_new=3))
        outs = []
        while eng.scheduler.has_work():
            outs.append(eng.step())
        assert all(o.kernel_config == want.describe() for o in outs if o.lanes)
        assert eng.kv.free_pages == 8 and eng.pages_in_use == 0
        streams[kc] = eng.finished[0].tokens
    assert len(set(map(tuple, streams.values()))) == 1
