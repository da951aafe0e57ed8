"""Plain PyTorch version of the Jacquard GEMV kernel: ``x @ w`` in float32,
the output in ``x.dtype`` (the JAX package's ``jacquard_gemv_ref``).  The
CPU runs it; the card's tests compare the kernel with it."""
from __future__ import annotations

import torch


def jacquard_gemv_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) -> (M, N) in ``x.dtype``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)
