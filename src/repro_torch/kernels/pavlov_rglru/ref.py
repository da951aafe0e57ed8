"""Plain PyTorch version of the RG-LRU kernel: the recurrence as a
sequential float32 loop over T, in the kernel's order (the JAX package's
``pavlov_rglru_ref`` is an associative scan, which rounds differently).
The CPU runs it; the card's tests compare the kernel with it."""
from __future__ import annotations

import torch


def pavlov_rglru_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t, h_{-1} = 0, over a, b: (B, T, E); the
    state in float32, the output in ``a.dtype``."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    out = torch.empty_like(af)
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
