from .kernel import launches, pascal_matmul_raw
from .ops import pascal_matmul
from .ref import pascal_matmul_ref

__all__ = ["launches", "pascal_matmul", "pascal_matmul_raw",
           "pascal_matmul_ref"]
