"""Feed-forward block: the gated-linear-unit MLP (SwiGLU/GeGLU) of
``repro.models.ffn`` on tensors (the plain MLP comes with the first arch
that needs it).  The weights are already in the
compute dtype (the model casts them once at load), so the products run in
the dtype the JAX package casts to per call."""
from __future__ import annotations

import torch

from .common import ACTIVATIONS


def glu_ffn(params: dict, x: torch.Tensor,
            activation: str = "silu") -> torch.Tensor:
    act = ACTIVATIONS[activation]
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    return torch.matmul(act(g) * u, params["w_down"])
