from .kernel import decode_launches, launches, pavlov_rglru_raw
from .ops import pavlov_rglru
from .ref import pavlov_rglru_ref

__all__ = ["decode_launches", "launches", "pavlov_rglru", "pavlov_rglru_raw",
           "pavlov_rglru_ref"]
