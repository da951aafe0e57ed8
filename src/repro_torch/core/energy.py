"""Energy model — §6 methodology.

Mirrors the paper's model: total = MAC energy + on-chip buffer energy (CACTI-style,
capacity-dependent pJ/B) + DRAM energy (per-byte, LPDDR4 vs. HBM-internal) + NoC
energy + static leakage x latency.

Constants are physically grounded:
  * 8-bit MAC = 0.2 pJ/bit (paper) -> 1.6 pJ/MAC -> 0.8 pJ/FLOP.
  * LPDDR4 ~ 4 pJ/bit = 32 pJ/B (paper's refs [3,15]); HBM-internal access from the
    logic layer ~ 1.25 pJ/bit = 10 pJ/B (TETRIS/Mondrian-class numbers).
  * SRAM access energy scales ~ sqrt(capacity) (CACTI): e(B) = e0 * sqrt(cap/32KB),
    with e0 = 0.4 pJ/B at 32 KB (22 nm).
  * Leakage: 30 mW/MB SRAM + 25 uW/PE.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .accelerators import AcceleratorConfig

MB = 1024.0 * 1024.0


@dataclass(frozen=True)
class EnergyParams:
    e_flop: float = 0.8e-12              # J per FLOP (8-bit MAC = 1.6 pJ)
    e_dram_lpddr4: float = 32e-12        # J per byte
    e_dram_hbm_internal: float = 4.5e-12 # J per byte (logic-layer access: no
                                         # SoC interconnect / PHY crossing)
    e_sram_base: float = 1.6e-12        # J per byte at 32 KB (CACTI-P 22 nm,
                                         # incl. bank selection + output drive)
    sram_ref_bytes: float = 32 * 1024.0
    e_noc: float = 0.25e-12              # J per byte-hop (on-chip distribution)
    p_leak_sram_per_mb: float = 0.008    # W per MB
    p_leak_pe: float = 12e-6             # W per PE (incl. its register file)

    def e_sram(self, capacity_bytes: float) -> float:
        cap = max(capacity_bytes, 1024.0)
        return self.e_sram_base * math.sqrt(cap / self.sram_ref_bytes)

    def e_dram(self, kind: str) -> float:
        return self.e_dram_hbm_internal if kind == "hbm_internal" \
            else self.e_dram_lpddr4

    def static_power(self, acc: AcceleratorConfig) -> float:
        sram_mb = (acc.param_buf_bytes + acc.act_buf_bytes) / MB
        return self.p_leak_sram_per_mb * sram_mb + self.p_leak_pe * acc.n_pes


DEFAULT_ENERGY = EnergyParams()


@dataclass(frozen=True)
class EnergyBreakdown:
    pe: float
    buf_param_dynamic: float
    buf_act_dynamic: float
    noc: float
    dram: float
    static: float

    @property
    def total(self) -> float:
        return (self.pe + self.buf_param_dynamic + self.buf_act_dynamic
                + self.noc + self.dram + self.static)

    def __add__(self, o: "EnergyBreakdown") -> "EnergyBreakdown":
        return EnergyBreakdown(
            self.pe + o.pe,
            self.buf_param_dynamic + o.buf_param_dynamic,
            self.buf_act_dynamic + o.buf_act_dynamic,
            self.noc + o.noc,
            self.dram + o.dram,
            self.static + o.static)


ZERO_ENERGY = EnergyBreakdown(0, 0, 0, 0, 0, 0)
