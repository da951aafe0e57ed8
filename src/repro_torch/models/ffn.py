"""Feed-forward blocks: the gated-linear-unit MLP (SwiGLU/GeGLU) and the
plain MLP with biases of ``repro.models.ffn`` on tensors.  The weights and
biases are already in the compute dtype (the model casts them once at
load), so the products and the bias adds run in the dtype the JAX package
casts to per call."""
from __future__ import annotations

import torch

from .common import ACTIVATIONS


def glu_ffn(params: dict, x: torch.Tensor,
            activation: str = "silu") -> torch.Tensor:
    act = ACTIVATIONS[activation]
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    return torch.matmul(act(g) * u, params["w_down"])


def mlp_ffn(params: dict, x: torch.Tensor,
            activation: str = "gelu") -> torch.Tensor:
    act = ACTIVATIONS[activation]
    h = act(torch.matmul(x, params["w_in"]) + params["b_in"])
    return torch.matmul(h, params["w_out"]) + params["b_out"]
