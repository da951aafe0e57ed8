"""The full paper pipeline over all 24 Google edge models, on the PyTorch
port's copies of the Mensa framework (``repro_torch.core``) and the edge zoo
(``repro_torch.edge``): characterize -> cluster -> schedule -> evaluate vs
Baseline / Base+HB / Eyeriss v2, printing the §7 comparison table.  It prints
what ``examples/mensa_schedule.py`` prints, line for line, and imports no
JAX.  Every number is of the paper's modeled accelerators, not of a device.

  PYTHONPATH=src python examples/mensa_schedule_torch.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from collections import Counter

from repro_torch.core import (MensaScheduler, characterize_zoo, evaluate_zoo,
                              rule_cluster, strict_fraction, summarize)
from repro_torch.edge import edge_zoo


def main() -> None:
    zoo = edge_zoo()
    chars = characterize_zoo(zoo)
    clusters = Counter(rule_cluster(c).cluster for c in chars)
    print(f"24 models, {len(chars)} layers; cluster populations: "
          f"{dict(sorted(clusters.items()))}")
    print(f"layers inside published cluster boxes: "
          f"{strict_fraction(chars, 2.5):.1%} (paper: 97%)\n")

    sched = MensaScheduler()
    print(f"{'model':24s} {'family':10s} {'lat_x':>6s} {'E_x':>6s} "
          f"{'pascal':>7s} {'pavlov':>7s} {'jacq':>6s}")
    results = evaluate_zoo(zoo)
    for g, r in zip(zoo, results):
        s = sched.schedule(g)
        names = s.accelerator_names()
        print(f"{g.name:24s} {g.family:10s} "
              f"{r.baseline.latency_s / r.mensa.latency_s:6.2f} "
              f"{r.baseline.energy.total / r.mensa.energy.total:6.2f} "
              f"{names.count('pascal'):7d} {names.count('pavlov'):7d} "
              f"{names.count('jacquard'):6d}")

    s = summarize(results)
    print(f"\nMensa vs baseline: throughput {s.throughput_x_vs_baseline:.2f}x "
          f"(paper 3.1x), energy eff {s.energy_eff_x_vs_baseline:.2f}x "
          f"(paper 3.0x), energy -{s.energy_reduction_vs_baseline:.1%} "
          f"(paper -66%)")
    print("mensa_schedule OK")


if __name__ == "__main__":
    main()
