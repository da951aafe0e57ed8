"""The train step: the port of ``repro.train.trainer.make_train_step``.

Gradient accumulation over microbatches, global-norm clipping and AdamW,
with bf16 compute on float32 masters: the model is built with
``train=True``, and its forward takes the differentiable routes while
autograd records (``models/transformer.py``).

On a (data, model) mesh the same step takes DTensor parameters (a model
laid out by ``launch.shardings.distribute_models``) and a batch laid out by
``launch.shardings.batch_specs``: the forward runs on the shards
(``models/spmd.py``), each parameter's gradient is brought to the
parameter's own placements (a replicated one's partial sums all-reduced
over the data axes), and the optimizer works on the shards.  The JAX
package's int8 error-feedback all-reduce is ``train/grad.py``; as in the
JAX trainer, the step does not use it.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..bridge import decay_mask
from ..models import spmd
from ..models.transformer import Model
from . import optim


def _placed(grad: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (its partial sums
    reduced where the parameter is whole); a plain one as it is."""
    if spmd.is_dtensor(grad) and grad.placements != p.placements:
        return grad.redistribute(placements=p.placements)
    return grad


def make_train_step(model: Model, *, accum_steps: int = 1,
                    schedule: Callable | None = None,
                    max_grad_norm: float = 1.0,
                    weight_decay: float = 0.1) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` is ``dict(model.named_parameters())`` (float32
    masters), updated in place and returned; ``batch`` holds tensors on
    the model's device with a leading global-batch axis.  With
    ``accum_steps`` A > 1 the batch splits into A microbatches along it;
    their gradients are summed in float32 in microbatch order, then
    divided by A, and the loss is the microbatches' sum over A.  Metrics:
    ``loss``, ``grad_norm`` (before clipping) and ``lr``, 0-d tensors.
    On a mesh, ``params`` are DTensors and so is the batch (rows split over
    the data axes); the microbatches hold the meshless microbatches' rows,
    each laid out as the batch (``spmd.microbatches``), and the metrics are
    plain tensors, the same on every rank."""
    if not model.trainable:
        raise ValueError("make_train_step needs a model built with "
                         "train=True (float32 masters with gradients)")
    schedule = schedule or optim.cosine_schedule(3e-4, 100, 10_000)
    decay = decay_mask(model)

    def train_step(params: dict, opt_state: optim.AdamWState, batch: dict):
        for p in params.values():
            p.grad = None
        b = next(iter(batch.values())).shape[0]
        if b % accum_steps:
            raise ValueError(f"global batch {b} is not a multiple of "
                             f"accum_steps {accum_steps}")
        lsum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
        cuts = {k: spmd.microbatches(v, accum_steps)
                for k, v in batch.items()}
        for a in range(accum_steps):
            loss, _ = model.loss({k: v[a] for k, v in cuts.items()})
            loss.backward()          # adds this microbatch's gradients
            lsum = lsum + spmd.whole(loss.detach())
        # a parameter the batch never reached (the modality stub without a
        # modality input) has a zero gradient, as under jax.grad
        grads = {k: torch.zeros_like(p) if p.grad is None
                 else _placed(p.grad, p) if accum_steps == 1
                 else _placed(p.grad, p) / accum_steps
                 for k, p in params.items()}
        grads, gnorm = optim.clip_by_global_norm(grads, max_grad_norm)
        lr = schedule(opt_state.step)
        updates, opt_state = optim.adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay,
            decay=decay)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
                p.grad = None
        metrics = {"loss": lsum / accum_steps, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step
