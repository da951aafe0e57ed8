"""End-to-end training driver example on the PyTorch port: train a language
model for a few hundred steps with checkpointing, fault injection, and
auto-resume.  The port's counterpart of ``examples/train_lm.py``; imports no
JAX.

Default runs a ~7M-param smollm-family model.  Pass --full to train the
real smollm-135m config (the assignment's ~100M-class model) at full width
— same code path, more compute.  Runs on the card; ``--device cpu`` runs on
the CPU.  Checkpoints go to a temporary directory, removed at the end.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200
  PYTHONPATH=src python examples/train_lm_torch.py --full --steps 300
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 12
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config
from repro_torch.ft.watchdog import FailureInjector, run_with_restarts
from repro_torch.launch.train import train_once


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="train the real 135M-param smollm config")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (tests auto-resume)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    if args.full:
        cfg = get_config("smollm-135m")
    else:
        # smollm topology at ~7M params: 6 layers, d_model 256
        cfg = get_config("smollm-135m").replace(
            num_layers=6, d_model=256, num_heads=8, num_kv_heads=4,
            head_dim=32, d_ff=768, vocab_size=8192, scan_chunk=64)

    with tempfile.TemporaryDirectory(prefix="mensa_train_") as ckpt_dir:
        print(f"arch: smollm-family, ~{cfg.param_count() / 1e6:.1f}M params "
              f"on {args.device}; checkpoints -> {ckpt_dir}")
        injector = FailureInjector(fail_at_step=args.fail_at)
        out = {}

        def once():
            out["result"] = train_once(
                cfg, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, ckpt_dir=ckpt_dir,
                ckpt_every=max(args.steps // 5, 10), injector=injector,
                log_every=max(args.steps // 20, 1), device=args.device)

        restarts = run_with_restarts(
            once, max_restarts=2,
            on_restart=lambda n, e: print(f"[example] restart {n}: {e!r}"))
    r = out["result"]
    first = min(r["losses"])
    print(f"\nloss {r['losses'][first]:.3f} -> {r['final_loss']:.3f} over "
          f"{args.steps} steps ({restarts} restarts)")
    assert r["final_loss"] < r["losses"][first], "loss did not improve"
    print("train_lm OK")


if __name__ == "__main__":
    main()
