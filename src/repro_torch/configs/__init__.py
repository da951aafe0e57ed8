from .archs import ARCHS, get_config, reduced_config

__all__ = ["ARCHS", "get_config", "reduced_config"]
