"""Latency + energy cost of running one layer on one accelerator, and of a whole
schedule — the paper's in-house simulator distilled to its analytical core.

Latency (roofline with overlap, §3.1 Fig.1): compute and DRAM transfer overlap,
so  t = max(t_compute, t_mem) + t_exposed  where t_exposed is dependent-fetch
latency that cannot be hidden (recurrent layers on the baseline scheduler).

Energy: see ``energy.py``.  Static energy is charged for the *whole system's*
accelerators over total inference latency (idle accelerators still leak).
"""
from __future__ import annotations

from dataclasses import dataclass

from .accelerators import AcceleratorConfig
from .dataflow import ExecutionProfile, profile
from .energy import DEFAULT_ENERGY, EnergyBreakdown, EnergyParams
from .layerspec import LayerSpec, ModelGraph


@dataclass(frozen=True)
class LayerCost:
    accelerator: str
    latency_s: float
    compute_s: float
    mem_s: float
    energy: EnergyBreakdown      # static excluded here; added at schedule level
    attained_flops: float
    utilization: float           # attained / accelerator peak
    prof: ExecutionProfile


def layer_cost(spec: LayerSpec, acc: AcceleratorConfig,
               ep: EnergyParams = DEFAULT_ENERGY) -> LayerCost:
    p = profile(spec, acc)
    flops = spec.flops
    eff = p.eff_map * p.eff_sched
    t_comp = flops / (acc.peak_flops * eff) if flops else 0.0
    t_mem = p.offchip_bytes / (acc.dram_bw * p.bw_efficiency)
    t = max(t_comp, t_mem) + p.exposed_latency_s
    t = max(t, 1e-12)

    e_pe = flops * ep.e_flop
    e_bp = (p.buf_param_reads * ep.e_sram(acc.param_buf_bytes)
            + p.buf_param_stream * ep.e_sram(min(acc.param_buf_bytes, 256 * 1024)))
    e_ba = p.buf_act_accesses * ep.e_sram(acc.act_buf_bytes)
    e_noc = p.noc_bytes * ep.e_noc
    e_dram = p.offchip_bytes * ep.e_dram(acc.dram_kind)
    energy = EnergyBreakdown(e_pe, e_bp, e_ba, e_noc, e_dram, 0.0)

    attained = flops / t
    return LayerCost(acc.name, t, t_comp, t_mem, energy, attained,
                     attained / acc.peak_flops, p)


@dataclass(frozen=True)
class ScheduleCost:
    """Aggregate cost of running `graph` under a layer->accelerator mapping."""
    model: str
    latency_s: float
    energy: EnergyBreakdown
    flops: int
    transfer_bytes: float
    per_layer: list[LayerCost]
    stage_time_s: float = 0.0   # max per-accelerator busy time (pipeline stage)

    @property
    def throughput_flops(self) -> float:
        """Steady-state inference throughput: successive inferences pipeline
        across the heterogeneous accelerators (each accelerator processes a
        different inference), so throughput is bounded by the busiest stage —
        the reason the paper's throughput gain (3.1x) exceeds its single-
        inference latency gain (1.96x)."""
        return self.flops / max(self.stage_time_s or self.latency_s, 1e-12)

    @property
    def efficiency_flops_per_j(self) -> float:
        return self.flops / max(self.energy.total, 1e-30)


def schedule_cost(graph: ModelGraph, mapping: list[AcceleratorConfig],
                  system_accels: tuple[AcceleratorConfig, ...],
                  ep: EnergyParams = DEFAULT_ENERGY,
                  transfer_bw: float | None = None) -> ScheduleCost:
    """Cost of executing `graph` with layer i on mapping[i].

    * Layers execute sequentially in topological order (the paper does not
      pipeline across layers).
    * When consecutive layers run on different accelerators, the activation is
      synchronized through DRAM (§4.2): one write + one read of the edge bytes,
      at the slower accelerator's DRAM energy/bandwidth.
    * Static energy = sum(static power of every accelerator in the system) x
      total latency.
    """
    assert len(mapping) == len(graph.layers)
    costs = [layer_cost(spec, acc, ep) for spec, acc in zip(graph.layers, mapping)]
    latency = sum(c.latency_s for c in costs)
    energy = EnergyBreakdown(0, 0, 0, 0, 0, 0)
    for c in costs:
        energy = energy + c.energy

    transfer_bytes = 0.0
    for (s, d) in graph.edges:
        if mapping[s].name != mapping[d].name:
            bytes_moved = graph.layers[s].out_act_bytes
            transfer_bytes += bytes_moved
            bw = transfer_bw or min(mapping[s].dram_bw, mapping[d].dram_bw)
            latency += 2 * bytes_moved / bw
            e_kind_w = mapping[s].dram_kind
            e_kind_r = mapping[d].dram_kind
            energy = energy + EnergyBreakdown(
                0, 0, 0, 0,
                bytes_moved * (ep.e_dram(e_kind_w) + ep.e_dram(e_kind_r)), 0)

    static_p = sum(ep.static_power(a) for a in system_accels)
    energy = energy + EnergyBreakdown(0, 0, 0, 0, 0, static_p * latency)
    busy: dict[str, float] = {}
    for c in costs:
        busy[c.accelerator] = busy.get(c.accelerator, 0.0) + c.latency_s
    stage = max(busy.values()) if busy else latency
    return ScheduleCost(graph.name, latency, energy, graph.total_flops,
                        transfer_bytes, costs, stage_time_s=stage)


def monolithic_cost(graph: ModelGraph, acc: AcceleratorConfig,
                    ep: EnergyParams = DEFAULT_ENERGY) -> ScheduleCost:
    """Whole model on a single accelerator (Baseline / Base+HB / Eyeriss v2)."""
    return schedule_cost(graph, [acc] * len(graph.layers), (acc,), ep)
