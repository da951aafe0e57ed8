"""Quickstart on the PyTorch port: the Mensa pipeline end to end.

1. Characterize + cluster the layers of a Google edge model (paper §3/§5.1).
2. Schedule it across Pascal/Pavlov/Jacquard with the two-phase scheduler
   (§4.2) and compare against the Edge TPU baseline (§7).
3. Run the SAME framework at datacenter scale: plan execution strategies
   for an assigned architecture, priced on a 16 x 16 mesh of H100 SXM cards
   (an analytic model from the datasheet's constants, not a measurement),
   and train its reduced config for a few steps on ``--device``.

Level A prints what ``examples/quickstart.py`` prints; its numbers are the
paper's modeled accelerators, not a device's.  Imports no JAX.

  PYTHONPATH=src python examples/quickstart_torch.py                 # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (MensaScheduler, characterize_model,
                              evaluate_model, rule_cluster)
from repro_torch.core.strategy import plan
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.edge import get_model
from repro_torch.models import build_model
from repro_torch.train import optim
from repro_torch.train.trainer import make_train_step


def level_a() -> None:
    print("=" * 72)
    print("LEVEL A — the paper: heterogeneous edge acceleration")
    print("=" * 72)
    g = get_model("TR1_rnnt_mobile")          # mobile RNN-T transducer
    chars = characterize_model(g)
    print(f"{g.name}: {len(g.layers)} layers, "
          f"{g.total_params / 1e6:.1f}M params")
    for c in chars[:4]:
        cl = rule_cluster(c).cluster
        print(f"  {c.name:12s} kind={c.kind.value:10s} cluster={cl} "
              f"footprint={c.param_bytes / 2**20:7.1f}MB "
              f"FLOP/B={c.param_flop_per_byte:8.1f}")
    sched = MensaScheduler()
    s = sched.schedule(g)
    print(f"schedule: {dict((a, s.accelerator_names().count(a)) for a in set(s.accelerator_names()))}"
          f"  (phase-2 remapped {s.n_remapped} layers)")
    r = evaluate_model(g)
    print(f"baseline EdgeTPU : {r.baseline.latency_s * 1e3:8.1f} ms   "
          f"{r.baseline.energy.total * 1e3:7.1f} mJ")
    print(f"Mensa            : {r.mensa.latency_s * 1e3:8.1f} ms   "
          f"{r.mensa.energy.total * 1e3:7.1f} mJ   "
          f"({r.baseline.latency_s / r.mensa.latency_s:.1f}x faster, "
          f"{r.baseline.energy.total / r.mensa.energy.total:.1f}x less energy)")


def level_b(device: str) -> None:
    print()
    print("=" * 72)
    print("LEVEL B — the same idea at datacenter scale (execution strategies,")
    print("priced on 16 x 16 H100 SXM cards at 700 W: modeled, not measured)")
    print("=" * 72)
    p = plan(get_config("recurrentgemma-2b"), tokens=256 * 4096, batch=256,
             train=True, shape_name="train_4k")
    print(p.summary())

    print(f"\ntraining the reduced config for 10 steps on {device}:")
    cfg = reduced_config("recurrentgemma-2b")
    model = build_model(cfg, device, seed=0, train=True)
    params = dict(model.named_parameters())
    opt = optim.adamw_init(params)
    step_fn = make_train_step(model)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 8))
    for step in range(10):
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in data.batch(step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 3 == 0 or step == 9:
            print(f"  step {step}: loss {float(metrics['loss']):.4f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    level_a()
    level_b(args.device)
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
