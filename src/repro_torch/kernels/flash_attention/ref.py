"""Plain PyTorch version of the flash kernel: the same function, written as
one full softmax.  The CPU runs it; the card's tests compare the kernel
with it."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KVH,hd) -> (B,Sq,H,hd).  q positions are
    aligned to the end of the KV sequence; the 1/sqrt(hd) scale is applied
    to float32 q, as the kernel does."""
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqnGd,bknd->bnGqk", qg, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnGqk,bknd->bnGqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
