"""Plain PyTorch version of the Pavlov LSTM recurrence: a sequential
float32 loop over T in the TPU kernel's order (gates = xg_t + h @ W_h; i,
f (+1.0), g, o), from a carried ``(h0, c0)``, returning ``(h_T, c_T)``.
The CPU runs it; the card's tests compare the kernel with it."""
from __future__ import annotations

import torch


def pavlov_lstm_ref(xg: torch.Tensor, w_h: torch.Tensor,
                    h0: torch.Tensor | None = None,
                    c0: torch.Tensor | None = None):
    """xg: (B, T, 4H) precomputed input gates; w_h: (H, 4H); h0, c0: (B, H)
    float32 carried state (zeros when None).  Returns (h (B, T, H) in
    ``xg.dtype``, h_T float32, c_T float32)."""
    b, t_len, h4 = xg.shape
    hd = h4 // 4
    wh = w_h.float()
    zeros = torch.zeros((b, hd), dtype=torch.float32, device=xg.device)
    h = zeros if h0 is None else h0.float()
    c = zeros if c0 is None else c0.float()
    out = torch.empty((b, t_len, hd), dtype=torch.float32, device=xg.device)
    for t in range(t_len):
        gates = xg[:, t].float() + h @ wh
        i, f, g, o = gates.split(hd, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out.to(xg.dtype), h, c
