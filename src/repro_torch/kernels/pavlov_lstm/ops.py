"""The Pavlov LSTM wrappers.  ``lstm_recurrence``: a CUDA tensor launches
the CUDA kernel (or raises); a CPU tensor takes the plain version — nothing
else chooses between them.  ``pavlov_lstm``: a whole layer in the paper's
decoupled schedule, the input GEMM over all T through the Pascal matmul
wrapper, then the recurrence."""
from __future__ import annotations

import torch

from ..build import refuse_autograd
from ..pascal_matmul.ops import pascal_matmul
from .kernel import pavlov_lstm_raw
from .ref import pavlov_lstm_ref


def lstm_recurrence(xg: torch.Tensor, w_h: torch.Tensor,
                    h0: torch.Tensor | None = None,
                    c0: torch.Tensor | None = None):
    """The LSTM recurrence from ``(h0, c0)`` over precomputed gates (see
    ``pavlov_lstm_ref``) -> (h in ``xg.dtype``, h_T, c_T float32)."""
    refuse_autograd("lstm_recurrence", xg, w_h, h0, c0)
    if xg.is_cuda:
        return pavlov_lstm_raw(xg, w_h, h0, c0)
    return pavlov_lstm_ref(xg, w_h, h0, c0)


def pavlov_lstm(x: torch.Tensor, w_x: torch.Tensor, w_h: torch.Tensor,
                b: torch.Tensor, h0: torch.Tensor | None = None,
                c0: torch.Tensor | None = None):
    """x: (B, T, Din); w_x: (Din, 4H); w_h: (H, 4H); b: (4H,); h0, c0:
    (B, H) float32 -> (h (B, T, H) in ``x.dtype``, h_T, c_T float32).

    Phase 1 (decoupled input MVMs, paper §5.4): xg = x @ w_x + b over all
    timesteps, in ``x.dtype`` as the JAX package's einsum gives it.
    Phase 2: the recurrence, W_h in float32 in the product.  Where xg and
    W_h differ in dtype the recurrence runs on both in float32 (a bf16 value
    widens exactly) and h is cast back.  Under autograd the two wrappers
    it calls refuse, as every wrapper does."""
    dt = x.dtype
    xg = pascal_matmul(x, w_x.to(dt)) + b.to(dt)
    if w_h.dtype != dt:
        xg, w_h = xg.float(), w_h.float()
    h, h_t, c_t = lstm_recurrence(xg.contiguous(), w_h.contiguous(), h0, c0)
    return h.to(dt), h_t, c_t
