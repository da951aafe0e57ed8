"""Shared model building blocks: norms, rotary embeddings, embeddings.

The PyTorch counterpart of ``repro.models.common``.  Parameters live in the
model's ``nn.Module``s; these are plain functions on tensors.  Compute dtype
follows the config (bf16 by default), accumulation and normalization run in
float32 exactly where the JAX package's do.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from . import spmd

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype name ("bfloat16", ...)."""
    return _DTYPES[name]


# ------------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with the ``(1 + scale)`` gain of
    ``repro.models.common.rms_norm`` (scales initialize at zero)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics, scale and bias, cast back to the
    input's dtype (``repro.models.common.layer_norm``)."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


# ------------------------------------------------------------------------- RoPE
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.
    Split-halves rotation (not interleaved pairs), in float32.  On a mesh
    (DTensors) it runs on each rank's rows and heads (``spmd.rope``)."""
    return spmd.rope(_rope, x, positions, theta)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    head_dim = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=x.device) / head_dim))
    freqs = positions[..., :, None].float() * inv       # (..., seq, hd/2)
    cos = torch.cos(freqs)[..., :, None, :]
    sin = torch.sin(freqs)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- embeds
def embed(table: torch.Tensor, tokens: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Rows ``tokens`` of ``table``, in ``compute_dtype``.  A DTensor table
    (a mesh's, vocab-sharded) is read on each rank's rows and shard
    (``spmd.embedding``): each token's row comes from the shard that holds
    it; both copy rows."""
    if spmd.is_dtensor(table):
        return spmd.embedding(table, tokens).to(compute_dtype)
    return table[tokens].to(compute_dtype)


def embed_scaled(table: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype, d_model: int) -> torch.Tensor:
    """Embedding times ``sqrt(d_model)``, the scale taken and applied in the
    compute dtype (``repro.models.transformer.Model._embed_inputs``).  The
    scale is rounded to the compute dtype on the host and multiplied in as
    a Python number (exact in it): a tensor made on the card for it would
    be a copy that waits for the card's queue."""
    scale = torch.sqrt(torch.tensor(float(d_model),
                                    dtype=compute_dtype)).item()
    return embed(table, tokens, compute_dtype) * scale


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in float32: float32 activations times the float32 table."""
    return torch.matmul(x.float(), table.float().t())


# ---------------------------------------------------------------------- softmax
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy (``repro.models.common.cross_entropy_loss``):
    logsumexp minus the gold logit.  logits float32 (..., vocab); labels
    integer (...); with ``mask``, ``sum(nll * mask) / max(sum(mask), 1)``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return mean_nll(logz - gold, mask)


def mean_nll(nll: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """``mean(nll)``, or with ``mask`` ``sum(nll * mask) / max(sum(mask),
    1)``."""
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor | None,
                        vocab: int) -> torch.Tensor:
    """``cross_entropy_loss`` of the first ``vocab`` columns of padded
    logits (..., V_padded); on a mesh, over vocab-sharded logits without
    gathering them (``spmd.cross_entropy``)."""
    return spmd.cross_entropy(cross_entropy_loss, mean_nll, logits, labels,
                              mask, vocab)


# --------------------------------------------------------------------- activation
def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable] = {
    "gelu": gelu,
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
}


def fan_in_std(shape: tuple[int, ...]) -> float:
    """Std of the JAX package's fan-in initializer for a weight of
    ``shape``."""
    return 1.0 / math.sqrt(max(shape[0] if shape else 1, 1))


def copy_into(p: torch.Tensor, value: torch.Tensor) -> None:
    """The default sink of the weight init: ``value`` (a parameter's whole
    float32 draw) copied into ``p``, cast to its dtype."""
    p.copy_(value)
