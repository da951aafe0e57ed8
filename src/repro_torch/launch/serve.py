"""Serving entry point of the port: random weights from a seed -> engine -> a
batch of requests -> the stats summary as JSON.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 8 --slots 4 --max-len 1024 --kv-block-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --max-len 4096 --kv-block-size 0
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch falcon-mamba-7b --max-len 4096 --kv-block-size 0

Runs on the card; ``--device cpu`` runs the plain versions on the CPU.
``--kv-block-size 0`` keeps every KV cache dense per slot (falcon-mamba
has no KV cache: its conv and scan states are per slot either way).  The
options of ``repro.launch.serve`` that the port does not have yet are
accepted by name only to fail with that message.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..configs import get_config, reduced_config
from ..models import build_model
from ..obs import profile_trace
from ..serve.engine import Request, ServeEngine, prefill_buckets

#: options of the JAX package's serving CLI that are not ported yet
NOT_PORTED = ("--max-new", "--min-bucket", "--max-prefill-per-step",
              "--max-prefill-batch", "--long-prompts", "--warmup", "--mesh",
              "--dp", "--mp", "--roles", "--param-strategy", "--trace",
              "--metrics-json", "--metrics-prom",
              "--program-memory", "--no-program-memory", "--policy",
              "--policy-dump")


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is an option of repro.launch.serve "
                     f"that the port does not have yet")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced (test-size) config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-bucket", type=int, default=None,
                    help="cap prefill buckets below max-len; longer prompts "
                         "run the chunked path")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunk width for prompts longer than the largest "
                         "bucket (default: the largest bucket)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per paged KV block (must divide max-len); "
                         "0 keeps every KV cache dense per slot")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="physical blocks in the pool (default: "
                         "slots*max-len/block-size)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share same-prefix KV blocks across requests")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k most likely tokens (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--profile-dir", default="",
                    help="profile the served run with torch.profiler: a "
                         "Chrome trace, ops by device time and a summary "
                         "(card busy / idle, top kernels) in this directory")
    for opt in NOT_PORTED:
        ap.add_argument(opt, nargs="?", action=_NotPorted,
                        help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=args.device, seed=args.seed)
    buckets = None
    if args.max_bucket is not None:
        buckets = prefill_buckets(min(args.max_bucket, args.max_len))
    engine = ServeEngine(model, slots=args.slots, max_len=args.max_len,
                         buckets=buckets, prefill_chunk=args.prefill_chunk,
                         kv_block_size=args.kv_block_size or None,
                         kv_blocks=args.kv_blocks,
                         prefix_cache=args.prefix_cache)
    engine.warmup()
    rng = np.random.RandomState(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.randint(1, cfg.vocab_size, 4 + i % 6).tolist(),
                    max_new_tokens=16, temperature=args.temperature,
                    top_k=args.top_k, top_p=args.top_p)
            for i in range(args.requests)]
    with profile_trace(args.profile_dir, device=model.device) as prof:
        engine.run(reqs)
    summary = engine.stats.summary()
    if prof is not None:
        summary["profile"] = prof
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
