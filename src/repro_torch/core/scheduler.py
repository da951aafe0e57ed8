"""The Mensa two-phase runtime scheduler (§4.2).

Phase 1 — isolation mapping: each layer goes to the accelerator designated for
its cluster (the runtime's configuration knowledge: cluster characteristics +
which accelerator serves which cluster).  A cost-based mode (`policy="cost"`) instead
argmins an energy-delay product per layer, which is useful for ablations.

Phase 2 — communication-aware remap: walking the DAG in topological order,
each node is priced once against the full set of its in-edges.  For every
candidate accelerator (the node's current one plus each distinct predecessor
accelerator) the cost is the node's layer cost on that candidate plus the
transfer cost (DRAM round-trip of the edge activation) of every in-edge whose
predecessor sits elsewhere; the node lands on the cheapest candidate.  Cost =
energy-delay product, the same heuristic currency as phase 1.  (Aggregating
all in-edges per node — rather than greedily per edge — keeps multi-
predecessor nodes from flipping accelerators repeatedly while ignoring the
transfer cost of their other in-edges.)
"""
from __future__ import annotations

from dataclasses import dataclass

from .accelerators import (AcceleratorConfig, CLUSTER_TO_ACCELERATOR,
                           MENSA_ACCELERATORS)
from .characterize import characterize_model
from .clustering import rule_cluster
from .costmodel import layer_cost, schedule_cost, ScheduleCost
from .energy import DEFAULT_ENERGY, EnergyParams
from .layerspec import ModelGraph


@dataclass
class MensaSchedule:
    model: str
    mapping: list[AcceleratorConfig]
    clusters: list[int]
    phase1_mapping: list[AcceleratorConfig]
    n_remapped: int = 0

    def accelerator_names(self) -> list[str]:
        return [a.name for a in self.mapping]


def _edp(latency_s: float, energy_j: float) -> float:
    return latency_s * energy_j


class MensaScheduler:
    """Schedules a ModelGraph onto a set of heterogeneous accelerators."""

    def __init__(self, accelerators: tuple[AcceleratorConfig, ...] = MENSA_ACCELERATORS,
                 cluster_map: dict[int, AcceleratorConfig] | None = None,
                 energy: EnergyParams = DEFAULT_ENERGY,
                 policy: str = "cluster"):
        self.accelerators = accelerators
        self.cluster_map = cluster_map or dict(CLUSTER_TO_ACCELERATOR)
        self.energy = energy
        if policy not in ("cluster", "cost"):
            raise ValueError(policy)
        self.policy = policy

    # ------------------------------------------------------------- phase 1
    def phase1(self, graph: ModelGraph) -> tuple[list[AcceleratorConfig], list[int]]:
        chars = characterize_model(graph)
        clusters = [rule_cluster(c).cluster for c in chars]
        mapping: list[AcceleratorConfig] = []
        for spec, cl in zip(graph.layers, clusters):
            if self.policy == "cluster":
                acc = self.cluster_map[cl]
                if acc not in self.accelerators:          # restricted systems
                    acc = self._best_by_cost(spec)
            else:
                acc = self._best_by_cost(spec)
            mapping.append(acc)
        return mapping, clusters

    def _best_by_cost(self, spec) -> AcceleratorConfig:
        best, best_c = None, float("inf")
        for acc in self.accelerators:
            c = layer_cost(spec, acc, self.energy)
            v = _edp(c.latency_s, c.energy.total)
            if v < best_c:
                best, best_c = acc, v
        assert best is not None
        return best

    # ------------------------------------------------------------- phase 2
    def phase2(self, graph: ModelGraph,
               mapping: list[AcceleratorConfig]) -> tuple[list[AcceleratorConfig], int]:
        ep = self.energy
        graph.validate()      # the walk below relies on edges having s < d
        out = list(mapping)
        n_moved = 0
        preds: dict[int, list[int]] = {}
        for (s, d) in graph.edges:
            preds.setdefault(d, []).append(s)

        def node_edp(d: int, acc: AcceleratorConfig) -> float:
            """EDP of layer d on `acc`, including every in-edge transfer."""
            c = layer_cost(graph.layers[d], acc, ep)
            t_xfer, e_xfer = 0.0, 0.0
            for p in preds[d]:
                if out[p].name == acc.name:
                    continue
                edge_bytes = graph.layers[p].out_act_bytes
                bw = min(out[p].dram_bw, acc.dram_bw)
                t_xfer += 2 * edge_bytes / bw
                e_xfer += edge_bytes * (ep.e_dram(out[p].dram_kind)
                                        + ep.e_dram(acc.dram_kind))
            return _edp(c.latency_s + t_xfer, c.energy.total + e_xfer)

        # edges are topologically ordered (s < d), so walking nodes in index
        # order always sees each predecessor's final placement first
        for d in range(len(graph.layers)):
            if d not in preds:
                continue
            keep = out[d]
            best_acc, best_v = keep, node_edp(d, keep)
            seen = {keep.name}
            for p in preds[d]:
                cand = out[p]
                if cand.name in seen:
                    continue
                seen.add(cand.name)
                v = node_edp(d, cand)
                if v < best_v:
                    best_acc, best_v = cand, v
            if best_acc.name != keep.name:
                out[d] = best_acc
                n_moved += 1
        return out, n_moved

    # ------------------------------------------------------ entry points
    def schedule(self, graph: ModelGraph) -> MensaSchedule:
        p1, clusters = self.phase1(graph)
        p2, moved = self.phase2(graph, p1)
        return MensaSchedule(graph.name, p2, clusters, p1, moved)

    def evaluate(self, graph: ModelGraph) -> ScheduleCost:
        sched = self.schedule(graph)
        return schedule_cost(graph, sched.mapping, self.accelerators, self.energy)
