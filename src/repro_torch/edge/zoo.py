"""The 24 Google edge models (13 CNNs + 4 LSTMs + 4 Transducers + 3 RCNNs)."""
from __future__ import annotations

from functools import lru_cache

from ..core.layerspec import ModelGraph
from .cnn import build_cnns
from .recurrent_models import build_lstms, build_rcnns, build_transducers


@lru_cache(maxsize=1)
def _zoo() -> tuple[ModelGraph, ...]:
    models = build_cnns() + build_lstms() + build_transducers() + build_rcnns()
    for m in models:
        m.validate()
    return tuple(models)


def edge_zoo() -> list[ModelGraph]:
    return list(_zoo())


def by_family(family: str) -> list[ModelGraph]:
    return [m for m in _zoo() if m.family == family]


def get_model(name: str) -> ModelGraph:
    for m in _zoo():
        if m.name == name:
            return m
    raise KeyError(name)
