"""The paper's Table II hardware and its calibrated cycle constants (port
of ``src/repro/perfmodel/hardware.py``, copied value for value).

The physical constants are HASTILY's Table II (32 nm-scaled, a 1 GHz
clock, PUMA's).  The cycle constants that the paper's cycle-level
simulator encodes but its text does not print were calibrated in the
reference against the paper's own anchors (Fig. 7: softmax 22.13 µs /
6 µs / 1.36 µs at l = 8192, W = 16; Fig. 12: BERT-Base 158 TOPS) and then
predict every other claim (``tests/test_perfmodel.py``).  ``GpuAnchors``
are the paper's published Nvidia A40 figures.  None of these numbers was
measured on any card by this package: they describe the paper's CIM
design and its GPU baseline, not the H100 the port runs on.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    # ---- Table II (per node) ----
    clock_hz: float = 1e9
    tiles: int = 128
    cores_per_tile: int = 8
    uclms_per_core: int = 16
    arrays_per_uclm: int = 8          # 8 crossbars hold the 8 weight bits
    array_rows: int = 64
    array_cols: int = 64
    alu_width: int = 64               # VFU lanes (Fig 7 sweeps 16/32/64)

    # power (W)
    p_tile: float = 1.14
    p_core: float = 0.1403
    p_vfu: float = 1.7e-3
    p_rf: float = 1.14e-3
    p_uclm_mm: float = 22.38e-3       # MVM mode (incl. ADC/S&A/S&H)
    p_uclm_lt: float = 0.518e-3       # lookup mode
    p_gb: float = 25.35e-3
    p_bus: float = 6e-3

    # area (mm²; 32nm)
    area_total: float = 330.0

    # ---- calibrated cycle constants (see module docstring) ----
    c_exp_sw: float = 36.2            # software MacLaurin exp, cycles/elem
    c_div: float = 4.0                # reciprocal-multiply, cycles/elem
    c_vfu_misc: float = 4.2           # n/d decompose + bit-shift (LUT path)
    c_lookup: float = 4.0             # SRAM LT op latency (paper §III-A2)
    c_comm: float = 118.0             # tree-gather level (store+load, shmem)
    t_mvm_ns: float = 184.0           # crossbar MVM pipeline-stage latency

    # energy constants — calibrated to Fig 8 (≈1.6× PUMA/HASTILY softmax
    # ratio) and Fig 13 (≈8 TOPS/W, model-size invariant)
    e_vfu_op: float = 2.66e-14        # p_vfu / (alu_width · clock), J/elem
    e_rf_word: float = 1.78e-14       # p_rf / (alu_width · clock), J/word
    e_exp_sw_extra: float = 1.7e-13   # software-exp surcharge vs LUT, J/elem
    e_comm_word: float = 1.0e-12      # shared-mem word during tree gather
    e_op: float = 0.115e-12           # J per (int8 MAC-derived) op, end2end
    p_idle: float = 2.0               # W — GB + bus + leakage floor

    # ---- derived ----
    @property
    def cores(self) -> int:
        return self.tiles * self.cores_per_tile

    @property
    def cycle_s(self) -> float:
        return 1.0 / self.clock_hz

    @property
    def arrays_per_core(self) -> int:
        return self.uclms_per_core * self.arrays_per_uclm

    @property
    def macs_per_core_mvm(self) -> int:
        """int8 MACs per crossbar op per core (8 arrays = 1 weight tile)."""
        return self.uclms_per_core * self.array_rows * self.array_cols

    @property
    def core_weight_capacity(self) -> int:
        """int8 weights resident per core."""
        return self.uclms_per_core * self.array_rows * self.array_cols


# The paper's measured GPU anchors (published inputs, not the model's):
# Nvidia A40, bitsandbytes INT8, dynamic power (idle subtracted).
@dataclasses.dataclass(frozen=True)
class GpuAnchors:
    tops_bert_base_b1: float = 19.0      # Fig 12
    tops_peak_claim: float = 0.0
    tops_w_b1: float = 0.3               # Fig 13
    tops_w_b4: float = 0.9
    die_mm2: float = 628.4


DEFAULT_HW = Hardware()
GPU = GpuAnchors()
