"""Mensa system wrapper — evaluate any model zoo under the four §7 configurations
(Baseline, Base+HB, EyerissV2, Mensa) and produce the paper's comparison metrics.
"""
from __future__ import annotations

from dataclasses import dataclass

from .accelerators import (BASE_HB, EDGE_TPU, EYERISS_V2, MENSA_ACCELERATORS)
from .costmodel import ScheduleCost, monolithic_cost
from .energy import DEFAULT_ENERGY, EnergyParams
from .layerspec import ModelGraph
from .scheduler import MensaScheduler


@dataclass(frozen=True)
class ModelResult:
    model: str
    family: str
    baseline: ScheduleCost
    base_hb: ScheduleCost
    eyeriss: ScheduleCost
    mensa: ScheduleCost


def evaluate_model(graph: ModelGraph,
                   ep: EnergyParams = DEFAULT_ENERGY,
                   policy: str = "cluster") -> ModelResult:
    sched = MensaScheduler(MENSA_ACCELERATORS, energy=ep, policy=policy)
    return ModelResult(
        model=graph.name,
        family=graph.family,
        baseline=monolithic_cost(graph, EDGE_TPU, ep),
        base_hb=monolithic_cost(graph, BASE_HB, ep),
        eyeriss=monolithic_cost(graph, EYERISS_V2, ep),
        mensa=sched.evaluate(graph),
    )


def evaluate_zoo(graphs: list[ModelGraph],
                 ep: EnergyParams = DEFAULT_ENERGY,
                 policy: str = "cluster") -> list[ModelResult]:
    return [evaluate_model(g, ep, policy) for g in graphs]


def geomean(xs: list[float]) -> float:
    import math
    xs = [max(x, 1e-30) for x in xs]
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


@dataclass(frozen=True)
class ZooSummary:
    """The paper's headline aggregate claims, computed over our zoo."""
    energy_reduction_vs_baseline: float        # paper: 66.0%
    energy_eff_x_vs_baseline: float            # paper: 3.0x
    energy_eff_x_vs_eyeriss: float             # paper: 2.4x
    throughput_x_vs_baseline: float            # paper: 3.1x
    throughput_x_vs_base_hb: float             # paper: 1.3x
    throughput_x_vs_eyeriss: float             # paper: 4.3x
    latency_x_vs_baseline: float               # paper: 1.96x
    latency_x_vs_base_hb: float                # paper: 1.17x
    base_hb_energy_reduction: float            # paper: 7.5%
    base_hb_throughput_x: float                # paper: 2.5x
    baseline_mean_utilization: float           # paper: 27.3%
    lstm_transducer_throughput_x: float        # paper: 5.7x
    lstm_transducer_baseline_util: float       # paper: <1%


def summarize(results: list[ModelResult]) -> ZooSummary:
    import numpy as np

    def ratios(num, den):
        return [num(r) / max(den(r), 1e-30) for r in results]

    lstm_tr = [r for r in results if r.family in ("lstm", "transducer")]
    peak = EDGE_TPU.peak_flops
    base_util = [r.baseline.throughput_flops / peak for r in results]
    return ZooSummary(
        energy_reduction_vs_baseline=1 - geomean(
            ratios(lambda r: r.mensa.energy.total, lambda r: r.baseline.energy.total)),
        energy_eff_x_vs_baseline=geomean(
            ratios(lambda r: r.mensa.efficiency_flops_per_j,
                   lambda r: r.baseline.efficiency_flops_per_j)),
        energy_eff_x_vs_eyeriss=geomean(
            ratios(lambda r: r.mensa.efficiency_flops_per_j,
                   lambda r: r.eyeriss.efficiency_flops_per_j)),
        throughput_x_vs_baseline=geomean(
            ratios(lambda r: r.mensa.throughput_flops,
                   lambda r: r.baseline.throughput_flops)),
        throughput_x_vs_base_hb=geomean(
            ratios(lambda r: r.mensa.throughput_flops,
                   lambda r: r.base_hb.throughput_flops)),
        throughput_x_vs_eyeriss=geomean(
            ratios(lambda r: r.mensa.throughput_flops,
                   lambda r: r.eyeriss.throughput_flops)),
        latency_x_vs_baseline=geomean(
            ratios(lambda r: r.baseline.latency_s, lambda r: r.mensa.latency_s)),
        latency_x_vs_base_hb=geomean(
            ratios(lambda r: r.base_hb.latency_s, lambda r: r.mensa.latency_s)),
        base_hb_energy_reduction=1 - geomean(
            ratios(lambda r: r.base_hb.energy.total,
                   lambda r: r.baseline.energy.total)),
        base_hb_throughput_x=geomean(
            ratios(lambda r: r.base_hb.throughput_flops,
                   lambda r: r.baseline.throughput_flops)),
        baseline_mean_utilization=float(np.mean(base_util)),
        lstm_transducer_throughput_x=geomean(
            [r.mensa.throughput_flops / max(r.baseline.throughput_flops, 1e-30)
             for r in lstm_tr]) if lstm_tr else 0.0,
        lstm_transducer_baseline_util=float(np.mean(
            [r.baseline.throughput_flops / peak
             for r in lstm_tr])) if lstm_tr else 0.0,
    )
