"""The port's copy of the Mensa layer description (``layerspec.py``, a
verbatim copy of the JAX package's, which imports no framework).  The rest
of the Mensa framework (characterization, clustering, cost models, the
scheduler) is not ported yet."""
from .layerspec import LayerKind, LayerSpec, ModelGraph

__all__ = ["LayerKind", "LayerSpec", "ModelGraph"]
