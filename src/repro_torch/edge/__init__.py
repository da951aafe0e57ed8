"""The 24 Google edge NN models the paper characterizes, reconstructed from the
paper's published per-family statistics (see recurrent_models.py / cnn.py)."""
from .zoo import by_family, edge_zoo, get_model

__all__ = ["by_family", "edge_zoo", "get_model"]
