"""Config registry: ``get_config(arch_id)`` for every assigned architecture,
and the assigned input shapes."""
from .archs import ARCHS, get_config, reduced_config
from .shapes import ALL_SHAPES, SHAPES, ShapeSpec, applicable

__all__ = ["ARCHS", "get_config", "reduced_config", "ALL_SHAPES", "SHAPES",
           "ShapeSpec", "applicable"]
