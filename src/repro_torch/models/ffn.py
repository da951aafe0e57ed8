"""Feed-forward blocks: the gated-linear-unit MLP (SwiGLU/GeGLU) and the
plain MLP with biases of ``repro.models.ffn`` on tensors.  Weights and
biases are cast to the activations' dtype per call, as the JAX package
casts them (a serving model stores them already cast, so the cast is a
no-op; a training model's float32 masters are differentiated through
it)."""
from __future__ import annotations

import torch

from .common import ACTIVATIONS


def glu_ffn(params: dict, x: torch.Tensor,
            activation: str = "silu") -> torch.Tensor:
    dt = x.dtype
    act = ACTIVATIONS[activation]
    g = torch.matmul(x, params["w_gate"].to(dt))
    u = torch.matmul(x, params["w_up"].to(dt))
    return torch.matmul(act(g) * u, params["w_down"].to(dt))


def mlp_ffn(params: dict, x: torch.Tensor,
            activation: str = "gelu") -> torch.Tensor:
    dt = x.dtype
    act = ACTIVATIONS[activation]
    h = act(torch.matmul(x, params["w_in"].to(dt)) + params["b_in"].to(dt))
    return torch.matmul(h, params["w_out"].to(dt)) + params["b_out"].to(dt)
