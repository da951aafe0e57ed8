"""The selective-scan wrapper: a CUDA tensor launches the CUDA kernel (or
raises); a CPU tensor takes the plain version.  Nothing else chooses
between them."""
from __future__ import annotations

import torch

from ..build import refuse_autograd
from .kernel import pavlov_ssm_raw
from .ref import pavlov_ssm_ref


def pavlov_ssm(delta: torch.Tensor, x: torch.Tensor, bc: torch.Tensor,
               cc: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
               h0: torch.Tensor | None = None,
               length: torch.Tensor | None = None):
    """The Mamba-1 selective scan from ``h0`` under the prefix mask
    ``length`` (see ``pavlov_ssm_ref``) -> (y in ``delta.dtype``, h_T
    float32)."""
    refuse_autograd("pavlov_ssm", delta, x, bc, cc, a, d_skip, h0)
    if delta.is_cuda:
        return pavlov_ssm_raw(delta, x, bc, cc, a, d_skip, h0, length)
    return pavlov_ssm_ref(delta, x, bc, cc, a, d_skip, h0, length)
