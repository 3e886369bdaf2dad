"""Analytical cycle / energy / area model of DIRC-RAG (paper Tables I & III).

A pure-Python copy of `repro.core.simulator`. Like the paper's own Python
system simulator (§IV-A), it models energy, cycle latency and area of the
DIRC macro, norm unit, SRAM buffer and global top-k comparator from
first-principles constants, calibrated against the published numbers:

  * 256 bit-ops per column per MAC cycle (128 NOR bit-mults + 128-input
    carry-save adder) x 128 columns x 16 macros x 250 MHz
        = 131.1 TOPS (abstract: "131 TOPS")
  * macro efficiency 1176 TOPS/W  -> e_bitop = 0.85 fJ / bit-op
  * macro area 0.34 mm^2, 16 macros + periphery = 6.18 mm^2 total,
    4 MB / 6.18 mm^2 = 5.178 Mb/mm^2 (Table I)
  * 4 MB INT8 dim-512 retrieval: 5.6 us, 0.956 uJ (Table I)
  * 1.9 MB (SciFact) retrieval: 2.77 us, 0.46 uJ (Table III)
    — the model reproduces the paper's observed LINEAR scaling in database
    size; the sense energy (12.9 fJ/cell-sense) and the per-MB top-k
    streaming overhead (17 cycles/MB) are the two calibrated constants.
"""
from __future__ import annotations

import dataclasses
import math

from . import dataflow

# --- Hardware constants (paper Table I unless noted) ---------------------
FREQ_HZ = 250e6
VOLTAGE = 0.8
BITOPS_PER_COLUMN_CYCLE = 256          # 128 bit-mult + 128-input CSA adds
E_BITOP_J = 1.0 / 1176e12              # from 1176 TOPS/W macro efficiency
E_SENSE_J = 12.9e-15                   # per-cell differential sense (calibrated)
E_FIXED_J = 11.2e-9                    # norm unit + global top-k + buffer
TOPK_STREAM_CYCLES_PER_MB = 17.0       # local-comparator drain (calibrated)
FIXED_LATENCY_CYCLES = 52              # norm + global merge (~0.21 us)
MACRO_AREA_MM2 = 0.34
PERIPHERY_AREA_MM2 = 6.18 - 16 * MACRO_AREA_MM2
SRAM_BUFFER_BYTES = 1024               # "< 1KB" (paper §IV-B)

# Published comparison point (paper Table III) — constants, not measured here.
RTX3090_LATENCY_S = 21.7e-3
RTX3090_ENERGY_J = 86.8e-3


@dataclasses.dataclass(frozen=True)
class SimReport:
    plan: dataflow.DataflowPlan
    latency_s: float
    energy_j: float
    energy_breakdown: dict
    cycles: int
    throughput_tops: float
    area_mm2: float
    density_mb_per_mm2: float
    macro_tops_per_w: float
    macro_tops_per_mm2: float

    def summary(self) -> dict:
        return {
            "db_mb": self.plan.db_bytes / 2**20,
            "latency_us": self.latency_s * 1e6,
            "energy_uj": self.energy_j * 1e6,
            "cycles": self.cycles,
            "throughput_tops": self.throughput_tops,
            "area_mm2": self.area_mm2,
            "density_mb_per_mm2": self.density_mb_per_mm2,
            "macro_tops_per_w": self.macro_tops_per_w,
            "macro_tops_per_mm2": self.macro_tops_per_mm2,
        }


def simulate_query(
    n_docs: int,
    dim: int,
    bits: int = 8,
    detect: bool = True,
) -> SimReport:
    """Latency/energy of ONE query against the full database."""
    plan = dataflow.plan_retrieval(n_docs, dim, bits=bits, detect=detect)
    db_mb = plan.db_bytes / 2**20

    # --- cycles -----------------------------------------------------------
    # Partially-filled arrays scan only occupied planes: scale by fill.
    capacity_bits = dataflow.TOTAL_BITS * plan.macro_passes
    fill = min(1.0, plan.db_bytes * 8 / capacity_bits)
    scan_cycles = math.ceil(
        (plan.sense_cycles + plan.detect_cycles + plan.mac_cycles)
        * plan.macro_passes
        * fill
    )
    topk_cycles = math.ceil(TOPK_STREAM_CYCLES_PER_MB * db_mb)
    cycles = scan_cycles + plan.drain_cycles + topk_cycles + FIXED_LATENCY_CYCLES
    latency = cycles / FREQ_HZ

    # --- energy ------------------------------------------------------------
    # Documents stripe across ALL cores (maximum parallelism), so the array
    # is globally `fill`-fraction occupied; energy scales with global fill.
    cols_active = dataflow.MACRO_COLUMNS * dataflow.N_CORES
    mac_cycles_eff = plan.mac_cycles * plan.macro_passes * fill
    det_cycles_eff = plan.detect_cycles * plan.macro_passes * fill
    sense_events = (
        plan.sense_cycles
        * plan.macro_passes
        * fill
        * dataflow.COLUMN_CELLS
        * cols_active
    )
    e_mac = mac_cycles_eff * BITOPS_PER_COLUMN_CYCLE * cols_active * E_BITOP_J
    e_det = det_cycles_eff * BITOPS_PER_COLUMN_CYCLE * cols_active * E_BITOP_J
    e_sense = sense_events * E_SENSE_J
    e_fixed = E_FIXED_J
    energy = e_mac + e_det + e_sense + e_fixed

    # --- roofline-style peak numbers ---------------------------------------
    tops = (
        BITOPS_PER_COLUMN_CYCLE
        * dataflow.MACRO_COLUMNS
        * dataflow.N_CORES
        * FREQ_HZ
        / 1e12
    )
    macro_tops = BITOPS_PER_COLUMN_CYCLE * dataflow.MACRO_COLUMNS * FREQ_HZ / 1e12
    area = 16 * MACRO_AREA_MM2 + PERIPHERY_AREA_MM2
    density = (dataflow.TOTAL_BITS / 2**20) / area

    return SimReport(
        plan=plan,
        latency_s=latency,
        energy_j=energy,
        energy_breakdown={
            "mac_uj": e_mac * 1e6,
            "detect_uj": e_det * 1e6,
            "sense_uj": e_sense * 1e6,
            "fixed_uj": e_fixed * 1e6,
        },
        cycles=cycles,
        throughput_tops=tops,
        area_mm2=area,
        density_mb_per_mm2=density,
        macro_tops_per_w=1.0 / (E_BITOP_J * 1e12),
        macro_tops_per_mm2=macro_tops / MACRO_AREA_MM2,
    )


def simulate_database_mb(db_mb: float, dim: int = 512, bits: int = 8,
                         detect: bool = True) -> SimReport:
    """Convenience: size the doc count from a database size in MB."""
    bytes_per_doc = dim * bits // 8
    n_docs = max(1, int(round(db_mb * 2**20 / bytes_per_doc)))
    return simulate_query(n_docs, dim, bits=bits, detect=detect)


def table1_spec() -> dict:
    """Reproduce paper Table I from the model."""
    rep = simulate_database_mb(4.0, dim=512, bits=8)
    return {
        "process": "TSMC40nm (modeled)",
        "area_mm2": rep.area_mm2,
        "frequency_mhz": FREQ_HZ / 1e6,
        "voltage": VOLTAGE,
        "precisions": "INT4/8",
        "embedding_dim": "128~1024",
        "macro_size_kb": dataflow.MACRO_BITS / 8 / 1024,
        "macro_area_mm2": MACRO_AREA_MM2,
        "macro_tops_per_w": rep.macro_tops_per_w,
        "macro_tops_per_mm2": rep.macro_tops_per_mm2,
        "macro_nvm_mb": dataflow.MACRO_BITS / 2**20,
        "total_nvm_mb": dataflow.TOTAL_BITS / 8 / 2**20,
        "total_density_mb_per_mm2": rep.density_mb_per_mm2,
        "retrieval_latency_us_4mb": rep.latency_s * 1e6,
        "energy_per_query_uj_4mb": rep.energy_j * 1e6,
        "throughput_tops": rep.throughput_tops,
    }
