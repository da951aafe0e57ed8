"""End-to-end training: data pipeline -> train loop -> checkpointing
-> fault-tolerant auto-resume -> straggler watchdog; the port of
``repro.launch.train`` with the same flags, log lines and on-disk
checkpoints, plus ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 50 --reduced --ckpt-dir /tmp/ckpt --ckpt-every 20

Runs on the card unless ``--device cpu``.  The weights are the port's
random init from seed 0 (the JAX ``train_once`` draws from
``PRNGKey(0)``; the two generators differ), or the latest checkpoint in
``--ckpt-dir``, which may be one the JAX package wrote.
"""
from __future__ import annotations

import argparse

import torch
from torch.distributed.tensor import DTensor

from ..bridge import from_jax_tree, to_jax_tree
from ..ckpt import checkpoint as ckpt_lib
from ..configs import get_config, reduced_config
from ..data.pipeline import DataConfig, SyntheticTokens
from ..device import resolve_device
from ..ft.watchdog import FailureInjector, StepWatchdog, run_with_restarts
from ..models import build_model, spmd
from ..obs.timing import Timed
from ..train import optim
from ..train.trainer import make_train_step


def state_tree(model, params: dict, opt_state: optim.AdamWState):
    """``(params, AdamWState)`` in the JAX package's tree layout: what a
    checkpoint holds.  On a mesh the leaves are DTensors (a stacked leaf
    split as its layers are, one axis on), which ``ckpt.save`` gathers
    whole."""
    return (to_jax_tree(model, params),
            optim.AdamWState(step=opt_state.step,
                             mu=to_jax_tree(model, opt_state.mu),
                             nu=to_jax_tree(model, opt_state.nu)))


def _meta(p: torch.Tensor) -> torch.Tensor:
    """A float32 ``meta`` tensor shaped as ``p``, laid out as ``p`` where
    it is a DTensor."""
    if not spmd.is_dtensor(p):
        return torch.empty(p.shape, device="meta")
    return DTensor.from_local(
        torch.empty(p.to_local().shape, device="meta"), p.device_mesh,
        p.placements, run_check=False, shape=p.shape, stride=p.stride())


def restore_state(model, ckpt_dir, step: int):
    """Load checkpoint ``step`` into the model's parameters (in place) and
    return them with the optimizer state, on the model's device (on a
    mesh, each in its parameter's placements, whatever mesh saved it:
    ``ckpt.restore(shardings=)``)."""
    params = dict(model.named_parameters())
    meta = {k: _meta(p) for k, p in params.items()}
    target = state_tree(model, meta, optim.AdamWState(
        torch.empty((), dtype=torch.int32, device="meta"), meta, meta))
    tree, st = ckpt_lib.restore(ckpt_dir, step, target,
                                shardings=ckpt_lib.shardings_of(target))
    dev = model.device
    with torch.no_grad():
        for k, t in from_jax_tree(model, tree).items():
            params[k].copy_(t)
    mu, nu = from_jax_tree(model, st.mu), from_jax_tree(model, st.nu)
    return params, optim.AdamWState(
        step=st.step.to(dev),
        mu={k: mu[k].to(dev).contiguous() for k in params},
        nu={k: nu[k].to(dev).contiguous() for k in params})


def train_once(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | None, ckpt_every: int, seed: int = 0,
               accum_steps: int = 1, fail_at: int = -1,
               injector: FailureInjector | None = None,
               log_every: int = 10, lr: float = 3e-4,
               metrics_out: list | None = None,
               device: str | torch.device = "cuda") -> dict:
    """Train ``cfg`` for ``steps`` steps from the latest checkpoint in
    ``ckpt_dir`` (or from the init), saving every ``ckpt_every`` steps and
    at the end.  Returns the final loss, the losses and grad norms by
    step, the straggler count, the parameters, optimizer state and model,
    and each step's seconds (the batch's copy to the device, the step and
    a device sync)."""
    dev = resolve_device(device)
    model = build_model(cfg, dev, train=True)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, modality_tokens=cfg.modality_tokens,
        modality_dim=cfg.modality_dim, encdec=cfg.is_encdec,
        d_model=cfg.d_model))
    schedule = optim.cosine_schedule(lr, warmup=max(steps // 20, 5),
                                     total=steps)
    step_fn = make_train_step(model, accum_steps=accum_steps,
                              schedule=schedule)
    # the injector survives restarts (fail_once semantics); pass one in to
    # exercise the checkpoint->resume path exactly once
    injector = injector or FailureInjector(fail_at_step=fail_at)
    watchdog = StepWatchdog()

    start = 0
    params = opt_state = None
    if ckpt_dir:
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            params, opt_state = restore_state(model, ckpt_dir, last)
            start = last
            print(f"[train] resumed from step {last}")
    if params is None:
        model.init(torch.Generator(device=dev).manual_seed(0))
        params = dict(model.named_parameters())
        opt_state = optim.adamw_init(params)

    losses, grad_norms, step_s = {}, {}, []
    for step in range(start, steps):
        with Timed("step", device=dev) as tm:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(step).items()}
            injector.maybe_fail(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            tm.sync()
        step_s.append(tm.dur)
        if watchdog.observe(tm.dur):
            print(f"[train] straggler event at step {step}")
        loss = float(metrics["loss"])
        losses[step] = loss
        grad_norms[step] = float(metrics["grad_norm"])
        if metrics_out is not None:
            metrics_out.append((step, loss))
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {grad_norms[step]:.2f}")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, step + 1,
                          state_tree(model, params, opt_state))
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps, state_tree(model, params, opt_state))
    return {"final_loss": losses.get(steps - 1),
            "losses": losses,
            "grad_norms": grad_norms,
            "stragglers": watchdog.stragglers_detected,
            "params": params,
            "opt_state": opt_state,
            "model": model,
            "step_s": step_s}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-size) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    injector = FailureInjector(fail_at_step=args.fail_at)

    def once():
        train_once(cfg, steps=args.steps, global_batch=args.global_batch,
                   seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, accum_steps=args.accum,
                   injector=injector, lr=args.lr, device=args.device)

    restarts = run_with_restarts(
        once, max_restarts=args.max_restarts,
        on_restart=lambda n, e: print(f"[train] restart {n} after {e!r}"))
    print(f"[train] done ({restarts} restarts)")


if __name__ == "__main__":
    main()
