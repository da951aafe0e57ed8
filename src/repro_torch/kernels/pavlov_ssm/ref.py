"""Plain PyTorch version of the selective-scan kernel: the Mamba-1
recurrence as a sequential float32 loop over T, in the kernel's order (the
JAX package's ``pavlov_ssm_ref`` is an associative scan, which rounds
differently), with the carried state and the prefix mask of
``repro.models.recurrent.mamba_ssm``'s XLA route.  The CPU runs it; the
card's tests compare the kernel with it."""
from __future__ import annotations

import torch


def pavlov_ssm_ref(delta: torch.Tensor, x: torch.Tensor, bc: torch.Tensor,
                   cc: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None,
                   length: torch.Tensor | None = None):
    """delta, x: (B,T,D); bc, cc: (B,T,N); a: (D,N); d_skip: (D,);
    ``h0``: (B,D,N) carried state (zeros when None); ``length``: (B,)
    valid prefix lengths — a step with ``t >= length[b]`` leaves row b's h
    as it was, and its y is still read from that h.  Per step:

        h   = exp(delta_t * a) * h + (delta_t * x_t) * B_t
        y_t = sum_n h * C_t + d_skip * x_t

    Returns (y in ``delta.dtype``, h_T float32 (B,D,N))."""
    df, xf, bf, cf = (t.float() for t in (delta, x, bc, cc))
    af, ds = a.float(), d_skip.float()
    b, t_len, d = df.shape
    h = torch.zeros((b, d, af.shape[1]), dtype=torch.float32,
                    device=df.device) if h0 is None else h0.float()
    y = torch.empty_like(df)
    for t in range(t_len):
        dt = df[:, t]
        h_new = torch.exp(dt[:, :, None] * af) * h \
            + (dt * xf[:, t])[:, :, None] * bf[:, t, None, :]
        h = h_new if length is None else \
            torch.where((t < length)[:, None, None], h_new, h)
        y[:, t] = (h * cf[:, t, None, :]).sum(-1) + xf[:, t] * ds
    return y.to(delta.dtype), h
