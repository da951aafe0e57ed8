"""Plain PyTorch version of the Pascal matmul kernel: ``x @ w`` in float32,
the output in ``x.dtype`` (the function of the JAX package's
``pascal_matmul_ref``), summed as a loop of rank-1 updates over k in order.

That order makes a row's result depend on its row of x and on w only: the
CPU's ``torch.matmul`` gives a row other bits when the number of rows
changes, which would break the LSTM layer's invariant that T carried
single steps equal one call over T.  The CPU runs it; the card's tests
compare the kernel with it."""
from __future__ import annotations

import torch


def pascal_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) -> (M, N) in ``x.dtype``."""
    xf, wf = x.float(), w.float()
    out = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(x.shape[1]):
        out += xf[:, k, None] * wf[k]
    return out.to(x.dtype)
