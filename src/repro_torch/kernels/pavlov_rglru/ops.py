"""The RG-LRU wrapper: a CUDA tensor launches the CUDA kernel (or raises);
a CPU tensor takes the plain version.  Nothing else chooses between them."""
from __future__ import annotations

import torch

from ..build import refuse_autograd
from .kernel import pavlov_rglru_raw
from .ref import pavlov_rglru_ref


def pavlov_rglru(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, E) -> h: (B, T, E) with h_t = a_t*h_{t-1} + b_t from
    h = 0, in ``a.dtype``."""
    refuse_autograd("pavlov_rglru", a, b)
    if a.is_cuda:
        return pavlov_rglru_raw(a, b)
    return pavlov_rglru_ref(a, b)
