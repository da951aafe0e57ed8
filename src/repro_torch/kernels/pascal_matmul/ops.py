"""The Pascal matmul wrapper: a CUDA tensor launches the CUDA kernel (or
raises); a CPU tensor takes the plain version.  Nothing else chooses
between them."""
from __future__ import annotations

import torch

from ..build import refuse_autograd
from .kernel import pascal_matmul_raw
from .ref import pascal_matmul_ref


def pascal_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) -> (..., N) in ``x.dtype``, summed in float32: the
    lead dims are flattened into the kernel's M."""
    refuse_autograd("pascal_matmul", x, w)
    *lead, k = x.shape
    x2 = x.reshape(-1, k).contiguous()
    if x.is_cuda:
        out = pascal_matmul_raw(x2, w.contiguous())
    else:
        out = pascal_matmul_ref(x2, w)
    return out.reshape(*lead, w.shape[1])
