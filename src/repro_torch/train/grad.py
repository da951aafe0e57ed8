"""Distributed-optimization tricks: int8 error-feedback gradient
compression — the port of ``repro.train.grad`` over ``torch.distributed``.

``compressed_psum``: on each rank of a mesh's data axis, gradients are
quantized to int8 with a per-tensor scale common to the axis, summed with
an all-reduce in int32 (exact), and dequantized.  The quantization error
is fed back into the next step's gradient (error feedback), which
preserves SGD convergence (Karimireddy et al., 2019).  The reference
sums in int32, so that the sum is exact; so does the port, and an int32
all-reduce moves 4 bytes an element, as a float32 one does: the int8
values are widened before they go on the wire (the reference's docstring
counts them at 1 byte).

``make_compressed_grad_fn`` wraps a per-rank loss into a function that
returns the data-axis mean of the compressed gradients and the new
error-feedback state.  As in the JAX trainer, ``make_train_step`` does not
use it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

Tree = dict


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _axis_group(mesh, axis: str):
    """(process group, size) of ``mesh``'s ``axis``."""
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def compressed_psum(grads: Tree, error: Tree, mesh,
                    axis: str = "data") -> tuple[Tree, Tree]:
    """Per-rank call on plain (local) tensors: returns (mean grads, new
    error), both float32.

    Every rank quantizes with a COMMON scale — the MAX over the axis of
    each leaf's ``max|g + e|`` (one all-reduce of all the leaves' maxima),
    ``/ 127 + 1e-12`` — so the int32 sum (one all-reduce a leaf) is
    exactly the sum of the quantized tensors; each rank's residue
    ``g + e - q * scale`` goes into its error-feedback buffer, and the
    mean is ``sum * scale / n``."""
    grp, n = _axis_group(mesh, axis)
    keys = list(grads)
    g = {k: grads[k].float() + error[k] for k in keys}
    peak = torch.stack([torch.amax(torch.abs(g[k])) for k in keys])
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=grp)
    mean, new_error = {}, {}
    for i, k in enumerate(keys):
        scale = peak[i] / 127.0 + 1e-12
        q = torch.clamp(torch.round(g[k] / scale), -127, 127).to(torch.int8)
        new_error[k] = g[k] - q.float() * scale           # error feedback
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=grp)
        mean[k] = summed.float() * scale / n
    return mean, new_error


def make_compressed_grad_fn(loss_fn: Callable, mesh,
                            data_axis: str = "data") -> Callable:
    """Returns ``grad_fn(params, error, batch) -> (loss, grads,
    new_error)``.

    ``loss_fn(params, batch) -> scalar``, computed on this rank's batch
    shard.  ``params`` are plain tensors that require their gradient, the
    same on every rank of ``data_axis`` (the reference's replicated
    parameters).  ``batch`` leaves are the global batch, plain (every rank
    cuts its rows: the axis's ``i``-th share) or DTensors already split
    over ``data_axis``.  The loss is averaged over the axis; the gradients
    are ``compressed_psum``'s mean and ``error`` its state (see
    ``init_error_state``), plain float32 tensors."""
    from torch.distributed.tensor import DTensor
    grp, n = _axis_group(mesh, data_axis)
    me = mesh.get_local_rank(data_axis)

    def local(t):
        if isinstance(t, DTensor):
            return t.to_local()
        return t.chunk(n, dim=0)[me]

    def grad_fn(params: Tree, error: Tree, batch: Tree):
        loss = loss_fn(params, {k: local(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        grads, new_error = compressed_psum(grads, error, mesh, data_axis)
        loss = loss.detach().float().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=grp)
        return loss / n, grads, new_error

    return grad_fn


def init_error_state(params: Tree) -> Tree:
    """Zero float32 error-feedback buffers, one a parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
