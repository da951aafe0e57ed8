from .model_config import ArchConfig
from .transformer import Model, build_model

__all__ = ["ArchConfig", "Model", "build_model"]
