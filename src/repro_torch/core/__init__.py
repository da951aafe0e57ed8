"""Mensa core: layer characterization, clustering, heterogeneous-accelerator
cost models and the two-phase scheduler (paper §3-§5) — the port's copies of
the JAX package's ``core/`` modules, which import only the standard library
and numpy.  The execution-strategy layer (``strategy.py``, ``executor.py``)
is copied too, priced on the H100 SXM (``h100.H100_SXM``) where the
reference prices a TPU v5e; import it from its modules, as the reference's
callers do."""
from .accelerators import (BASE_HB, CLUSTER_TO_ACCELERATOR, EDGE_TPU, EYERISS_V2,
                           JACQUARD, MENSA_ACCELERATORS, PASCAL, PAVLOV,
                           AcceleratorConfig, by_name)
from .characterize import (LayerCharacteristics, characterize_layer,
                           characterize_model, characterize_zoo, variation_report)
from .clustering import (ClusterAssignment, agreement, cluster_all, kmeans_cluster,
                         rule_cluster, strict_fraction)
from .costmodel import LayerCost, ScheduleCost, layer_cost, monolithic_cost, \
    schedule_cost
from .energy import DEFAULT_ENERGY, EnergyBreakdown, EnergyParams
from .layerspec import LayerKind, LayerSpec, ModelGraph
from .mensa import ModelResult, ZooSummary, evaluate_model, evaluate_zoo, summarize
from .scheduler import MensaSchedule, MensaScheduler

__all__ = [
    "AcceleratorConfig", "BASE_HB", "CLUSTER_TO_ACCELERATOR", "EDGE_TPU",
    "EYERISS_V2", "JACQUARD", "MENSA_ACCELERATORS", "PASCAL", "PAVLOV", "by_name",
    "LayerCharacteristics", "characterize_layer", "characterize_model",
    "characterize_zoo", "variation_report",
    "ClusterAssignment", "agreement", "cluster_all", "kmeans_cluster",
    "rule_cluster", "strict_fraction",
    "LayerCost", "ScheduleCost", "layer_cost", "monolithic_cost", "schedule_cost",
    "DEFAULT_ENERGY", "EnergyBreakdown", "EnergyParams",
    "LayerKind", "LayerSpec", "ModelGraph",
    "ModelResult", "ZooSummary", "evaluate_model", "evaluate_zoo", "summarize",
    "MensaSchedule", "MensaScheduler",
]
