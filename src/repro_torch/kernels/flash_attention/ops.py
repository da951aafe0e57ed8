"""The flash-attention wrapper: (B,S,H,hd) in, (B,S,H,hd) out.

A CUDA tensor launches the CUDA kernel (or raises); a CPU tensor takes the
plain version.  Nothing else chooses between them."""
from __future__ import annotations

import torch

from ..build import refuse_autograd
from .kernel import flash_attention_raw
from .ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KVH,hd) -> (B,Sq,H,hd), q aligned to the
    end of the KV sequence."""
    refuse_autograd("flash_attention", q, k, v)
    if q.is_cuda:
        return flash_attention_raw(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
