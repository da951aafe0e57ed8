"""The Jacquard GEMV wrapper: a CUDA tensor launches the CUDA kernel (or
raises); a CPU tensor takes the plain version.  Nothing else chooses
between them."""
from __future__ import annotations

import torch

from ..build import refuse_autograd
from .kernel import MAX_ROWS, jacquard_gemv_raw
from .ref import jacquard_gemv_ref


def jacquard_gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) -> (..., N) in ``x.dtype`` for a small product of
    lead dims (at most 16 rows): the lead dims are flattened into M."""
    refuse_autograd("jacquard_gemv", x, w)
    *lead, k = x.shape
    x2 = x.reshape(-1, k).contiguous()
    if x2.shape[0] > MAX_ROWS:
        raise ValueError(f"x has {x2.shape[0]} rows: the GEMV takes at most "
                         f"{MAX_ROWS}")
    if x.is_cuda:
        out = jacquard_gemv_raw(x2, w.contiguous())
    else:
        out = jacquard_gemv_ref(x2, w)
    return out.reshape(*lead, w.shape[1])
