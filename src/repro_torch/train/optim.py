"""Optimizers and schedules: the port of ``repro.train.optim``.

AdamW with decoupled weight decay, global-norm clipping, cosine and linear
warmup schedules, and the SGD ablation, as functions on trees of tensors —
here a flat dict of name -> tensor (``dict(model.named_parameters())``),
the moments congruent with it.  Every update is computed in float32 with
the JAX functions' arithmetic, in their order.

One thing the JAX tree carries in its shapes the port's tensors do not:
``adamw_update`` decays the leaves of rank 2 or more, and the JAX tree
stacks each pattern position's blocks on axis 0, so a stacked norm scale
is a matrix there and a vector here.  ``adamw_update`` therefore takes the
set to decay as ``decay`` (``bridge.decay_mask`` reads it off the JAX
layout); without it, it decays ``p.dim() >= 2`` as the JAX function does on
its own tree.

On a (data, model) mesh the leaves are DTensors: the moments keep each
parameter's placements (so a parameter split over ``model`` has its
moments split alike, as the reference's optimizer state takes the
parameter specs), every update is elementwise on the local shards, and
``global_norm`` sums the squares over the whole mesh.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

Tree = dict


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Tree                 # first moment (float32, like the params)
    nu: Tree                 # second moment


def adamw_init(params: Tree) -> AdamWState:
    zeros = {k: torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
             for k, p in params.items()}
    device = next(iter(params.values())).device if params else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros, nu={k: z.clone() for k, z in zeros.items()})


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, leaf by leaf in
    the tree's order.  DTensor leaves (no ``Partial`` placement) are summed
    on their local shards, the leaves of one layout together, and each
    layout's sum is reduced over the mesh dims that split it: a plain 0-d
    tensor, the same on every rank, after at most one all-reduce a
    layout."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    total, parts = None, {}
    for g in tree.values():
        if isinstance(g, DTensor):
            sq = torch.sum(torch.square(g.to_local().float()))
            key = (g.device_mesh, tuple(isinstance(p, Shard)
                                        for p in g.placements))
            parts[key] = sq if key not in parts else parts[key] + sq
            continue
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    for (mesh, split), sq in parts.items():
        sq = DTensor.from_local(sq, mesh, [Partial() if s else Replicate()
                                           for s in split],
                                run_check=False).full_tensor()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree, *,
                 lr: torch.Tensor, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 decay: dict | None = None) -> tuple[Tree, AdamWState]:
    """One AdamW step: (updates, new state).  ``decay``: name -> whether
    to decay that parameter (default ``p.dim() >= 2``)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    updates, mu, nu = {}, {}, {}
    for k, g in grads.items():
        p = params[k]
        g = g.float()
        m = b1 * state.mu[k] + (1 - b1) * g
        v = b2 * state.nu[k] + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if (p.dim() >= 2) if decay is None else decay[k]:
            delta = delta + weight_decay * p.float()
        updates[k] = (-lr * delta).to(p.dtype)
        mu[k], nu[k] = m, v
    return updates, AdamWState(step=step, mu=mu, nu=nu)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: (p.float() + updates[k].float()).to(p.dtype)
            for k, p in params.items()}


# -------------------------------------------------------------------- schedules
def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup from 0 over ``warmup`` steps, then a cosine to
    ``final_frac * base_lr`` at ``total``: step tensor -> float32 lr."""
    def f(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return f


def linear_schedule(base_lr: float, warmup: int, total: int):
    def f(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        return torch.where(step < warmup, warm, base_lr * (1 - prog))
    return f


# ----------------------------------------------------------------- SGD (ablation)
class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Tree


def sgd_init(params: Tree) -> SGDState:
    device = next(iter(params.values())).device if params else None
    return SGDState(step=torch.zeros((), dtype=torch.int32, device=device),
                    momentum={k: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                              for k, p in params.items()})


@torch.no_grad()
def sgd_update(grads: Tree, state: SGDState, params: Tree, *,
               lr: torch.Tensor, momentum: float = 0.9):
    step = state.step + 1
    updates, moms = {}, {}
    for k, g in grads.items():
        m = momentum * state.momentum[k] + g.float()
        updates[k] = (-lr * m).to(params[k].dtype)
        moms[k] = m
    return updates, SGDState(step, moms)
