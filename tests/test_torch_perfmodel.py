"""The port's copy of the paper's CIM model (``repro_torch.perfmodel``)
against the reference's (``repro.perfmodel``), on the CPU.

Both are arithmetic on the same constants, so every function must give
the reference's number exactly (``==``): on the inputs of
``tests/test_perfmodel.py``'s 18 checks and on a grid of ``l``, ``d`` and
``alu_width``.  Then the 18 paper checks run again on the port's copy,
each with the reference's tolerance.  Neither package reads JAX here.
About 2 s alone, one intra-op thread."""
import dataclasses
import itertools
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process

import repro.perfmodel as J  # noqa: E402
import repro.perfmodel.model as JM  # noqa: E402
import repro_torch.perfmodel as T  # noqa: E402
import repro_torch.perfmodel.model as TM  # noqa: E402

HW = T.DEFAULT_HW
H = T.headline_numbers()

SOFTMAX_MODES = ("puma", "uclm", "multicore", "hastily")
LS = (128, 512, 1000, 1024, 2048, 4096, 8192, 10 ** 6)
DS = (64, 768, 1024)
WIDTHS = (None, 16, 32, 64)


def test_constants_equal_the_reference():
    """``Hardware`` and ``GpuAnchors``, field for field, derived
    properties included, and the two BERT shapes."""
    assert dataclasses.asdict(T.DEFAULT_HW) == dataclasses.asdict(J.DEFAULT_HW)
    assert dataclasses.asdict(T.GPU) == dataclasses.asdict(J.GPU)
    for prop in ("cores", "cycle_s", "arrays_per_core", "macs_per_core_mvm",
                 "core_weight_capacity"):
        assert getattr(T.DEFAULT_HW, prop) == getattr(J.DEFAULT_HW, prop)
    assert (T.BERT_BASE, T.BERT_LARGE) == (J.BERT_BASE, J.BERT_LARGE)
    assert set(J.__all__) <= set(T.__all__)


def test_headline_numbers_equal_the_reference():
    assert T.headline_numbers() == J.headline_numbers()
    alt = dict(alu_width=16, c_comm=90.0, t_mvm_ns=150.0, e_op=0.2e-12)
    assert (T.headline_numbers(T.Hardware(**alt))
            == J.headline_numbers(J.Hardware(**alt)))


@pytest.mark.parametrize("mode", SOFTMAX_MODES)
def test_softmax_functions_equal_the_reference(mode):
    """Latency at every (l, alu_width) of the grid, energy and cores at
    every l: equal floats."""
    for l, w in itertools.product(LS, WIDTHS):
        assert (T.softmax_latency_s(HW, l, mode, w)
                == J.softmax_latency_s(J.DEFAULT_HW, l, mode, w)), (l, w)
    for l in LS:
        assert (T.softmax_energy_j(HW, l, mode)
                == J.softmax_energy_j(J.DEFAULT_HW, l, mode)), l
        assert T.softmax_cores(HW, l) == J.softmax_cores(J.DEFAULT_HW, l)
    with pytest.raises(ValueError):
        T.softmax_latency_s(HW, 512, "gpu")


@pytest.mark.parametrize("pipelined", ["none", "coarse", "fine"])
@pytest.mark.parametrize("mode", SOFTMAX_MODES)
def test_layer_and_end_to_end_functions_equal_the_reference(pipelined, mode):
    jh = J.DEFAULT_HW
    assert TM.mvm_stage_s(HW) == JM.mvm_stage_s(jh)
    for l, d in itertools.product(LS[:-1], DS):
        kw = dict(softmax_mode=mode, pipelined=pipelined)
        assert (T.encoder_layer_latency_s(HW, l, d, **kw)
                == J.encoder_layer_latency_s(jh, l, d, **kw)), (l, d)
        assert (T.encoder_layer_energy_j(HW, l, d, softmax_mode=mode)
                == J.encoder_layer_energy_j(jh, l, d, softmax_mode=mode))
        assert (T.softmax_fraction(HW, l, d, mode)
                == J.softmax_fraction(jh, l, d, mode))
        for n, batch in ((12, 1), (24, 2), (12, 4), (24, 5)):
            args = (n, l, d, 4 * d)
            kw2 = dict(pipelined=pipelined, softmax_mode=mode, batch=batch)
            assert (T.end_to_end_latency_s(HW, *args, **kw2)
                    == J.end_to_end_latency_s(jh, *args, **kw2))
            assert (T.end_to_end_tops(HW, *args, **kw2)
                    == J.end_to_end_tops(jh, *args, **kw2))
            assert T.bert_ops(*args) == J.bert_ops(*args)
            if pipelined == "fine" and mode == "hastily":
                assert (T.tops_per_watt(HW, *args, batch=batch)
                        == J.tops_per_watt(jh, *args, batch=batch))
    for tops in (0.0, 19.0, 158.0, 263.0):
        assert TM.node_power_w(HW, tops) == JM.node_power_w(jh, tops)


# ----------------------------------- the 18 paper checks, on the port --

def close(got, want, tol):
    assert abs(got / want - 1) <= tol, f"got {got:.4g}, want {want:.4g}"


def test_fig7_softmax_anchor_puma():
    close(H["softmax_puma_8192_w16_us"], 22.13, 0.01)


def test_fig7_softmax_anchor_uclm():
    close(H["softmax_uclm_8192_w16_us"], 6.0, 0.01)


def test_fig7_softmax_anchor_multicore():
    close(H["softmax_multicore_8192_w16_us"], 1.36, 0.05)


def test_fig12_tops_anchor_bert_base():
    close(H["tops_bert_base"], 158.0, 0.02)


def test_fig7_alu_width_gain():
    close(H["softmax_w64_gain_pct"], 22.0, 0.15)


def test_fig7_multicore_only_helps_when_long():
    for l in (128, 512, 1024):
        h = T.softmax_latency_s(HW, l, "hastily")
        u = T.softmax_latency_s(HW, l, "uclm")
        assert h <= u and (u - h) / u < 0.35
    assert (T.softmax_latency_s(HW, 8192, "uclm", 16)
            / T.softmax_latency_s(HW, 8192, "multicore", 16)) > 3


def test_fig8_energy_ratio():
    for l in (2048, 4096, 8192):
        r = (T.softmax_energy_j(HW, l, "puma")
             / T.softmax_energy_j(HW, l, "multicore"))
        close(r, 1.6, 0.15)


def test_fig8_multicore_energy_overhead_small():
    for l in (2048, 8192):
        r = (T.softmax_energy_j(HW, l, "multicore")
             / T.softmax_energy_j(HW, l, "uclm"))
        assert 1.0 <= r < 1.15


def test_fig10_softmax_runtime_share():
    close(T.softmax_fraction(HW, 1024, 768, "puma"), 0.38, 0.10)
    assert T.softmax_fraction(HW, 1024, 768, "hastily") < 0.20


def test_fig9_combined_speedup():
    lat = lambda m, p: T.encoder_layer_latency_s(  # noqa: E731
        HW, 1024, 768, softmax_mode=m, pipelined=p)
    puma, sm_only = lat("puma", "none"), lat("hastily", "none")
    pipe_only, both = lat("puma", "coarse"), lat("hastily", "fine")
    assert puma / both == pytest.approx(4.47, rel=0.25)
    assert 1.2 < puma / sm_only < 2.0
    assert 1.5 < puma / pipe_only < 3.0


def test_fig12_bert_large():
    close(H["tops_bert_large"], 263.0, 0.10)


def test_fig12_batch4_equals_batch2():
    t2 = T.end_to_end_tops(HW, 12, 512, 768, 3072, batch=2)
    t4 = T.end_to_end_tops(HW, 12, 512, 768, 3072, batch=4)
    close(t4, t2, 0.01)


def test_fig12_speedup_vs_gpu_in_range():
    assert 4.4 <= H["speedup_tops_vs_gpu_base"] <= 9.8


def test_fig12_speedup_vs_puma_in_range():
    assert 1.7 <= H["tops_bert_base"] / 26.0 <= 9.0
    close(H["tops_puma_bert_base"], 26.0, 0.25)


def test_fig13_tops_per_watt():
    close(T.tops_per_watt(HW, 12, 512, 768, 3072, batch=2), 8.0, 0.10)
    close(T.tops_per_watt(HW, 24, 512, 1024, 4096, batch=2), 8.0, 0.15)


def test_fig13_energy_efficiency_vs_gpu():
    assert 16 <= H["tops_w_vs_gpu_b1"] <= 36


def test_softmax_cores_mapping():
    assert T.softmax_cores(HW, 256) == 1
    assert T.softmax_cores(HW, 8192) == 16
    assert T.softmax_cores(HW, 10 ** 6) == 16


def test_pipeline_latency_is_n_plus_1():
    t = T.end_to_end_latency_s(HW, 12, 512, 768, 3072, batch=1)
    assert t == pytest.approx(13 * 512 * HW.t_mvm_ns * 1e-9, rel=1e-6)
    assert math.isclose(t, J.end_to_end_latency_s(J.DEFAULT_HW, 12, 512, 768,
                                                  3072, batch=1), rel_tol=0)
