"""Serving example on the PyTorch port: batched requests through the
continuous-batching engine, with the Mensa view of the workload (prefill =
compute-centric Pascal phase, decode = memory-centric Jacquard/Pavlov
phase) — each phase runs its own model under its own execution profile,
over one set of parameters, and prompts are padded to power-of-two
buckets.  The per-phase plans are priced on a 16 x 16 mesh of H100 SXM
cards at 700 W: an analytic model, not a measurement.  The port's
counterpart of ``examples/serve_edge.py``; imports no JAX.

  PYTHONPATH=src python examples/serve_edge_torch.py --arch qwen3-0.6b
  PYTHONPATH=src python examples/serve_edge_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.executor import phase_profiles
from repro_torch.launch.serve import build_engine
from repro_torch.serve.engine import Request


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    # the datacenter-scale per-phase serving plans for this arch
    plan_cfg = get_config(args.arch)
    prefill_prof, decode_prof = phase_profiles(plan_cfg)
    print(prefill_prof.plan.summary())
    print(f"prefill overrides={prefill_prof.cfg_overrides} | "
          f"decode overrides={decode_prof.cfg_overrides}")

    cfg = reduced_config(args.arch)
    engine = build_engine(cfg, slots=args.slots, max_len=128,
                          device=args.device, plan_cfg=plan_cfg,
                          profiles=(prefill_prof, decode_prof))

    rng = np.random.RandomState(0)
    reqs = [Request(rid=i,
                    prompt=rng.randint(1, cfg.vocab_size, 4 + i % 5).tolist(),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    done = engine.run(reqs)
    for r in done[:3]:
        print(f"req {r.rid}: prompt {r.prompt} -> {r.generated}")
    s = engine.stats.summary()
    print(f"\nserved {s['requests_completed']} requests / "
          f"{s['tokens_generated']} tokens "
          f"({s['tokens_per_s']:.1f} tok/s on {engine.device.type} with "
          f"{args.slots} slots, ttft p50 {s['ttft_ms']['p50']:.0f}ms, "
          f"{s['prefill_calls']} prefill calls)")
    assert all(r.done for r in done)
    print("serve_edge OK")


if __name__ == "__main__":
    main()
