from .kernel import MAX_ROWS, launches, jacquard_gemv_raw
from .ops import jacquard_gemv
from .ref import jacquard_gemv_ref

__all__ = ["MAX_ROWS", "jacquard_gemv", "jacquard_gemv_raw",
           "jacquard_gemv_ref", "launches"]
