"""Plain PyTorch version of the paged decode kernel: gather each slot's
logical sequence through its table row, then one masked softmax."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Same contract as ``kernel.paged_decode_attention_raw``: q (B,H,hd),
    pools (N,bs,KVH,hd), table (B,nb) in [0,N), lengths (B,) -> (B,H,hd).
    The 1/sqrt(hd) scale is applied to float32 q, as the kernel does."""
    b, h, hd = q.shape
    _, bs, kvh, _ = k_pool.shape
    nb = block_table.shape[1]
    g = h // kvh
    idx = block_table.long()
    ks = k_pool[idx].reshape(b, nb * bs, kvh, hd).float()
    vs = v_pool[idx].reshape(b, nb * bs, kvh, hd).float()
    qg = q.reshape(b, kvh, g, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bnGd,bknd->bnGk", qg, ks)
    pos = torch.arange(nb * bs, device=q.device)[None, :]
    valid = pos <= lengths.long()[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnGk,bknd->bnGd", p, vs)
    return out.reshape(b, h, hd).to(q.dtype)
