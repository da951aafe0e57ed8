"""Serving entry point of the port: a placement plan -> random weights from a
seed -> engine -> a batch of requests -> the stats summary as JSON.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 8 --slots 4 --max-len 1024 --kv-block-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --max-len 4096 --kv-block-size 0
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch falcon-mamba-7b --max-len 4096 --kv-block-size 0
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --max-len 4096 --max-bucket 256 --policy-dump

Runs on the card; ``--device cpu`` runs the plain versions on the CPU.
``--policy auto`` (the default) resolves the placement oracle's plan for the
arch's full-size config (characterize -> cluster -> cost,
``serve/placement.py``) and serves at its bucket ladder and prefill chunk;
``--policy fixed`` keeps the engine's own knobs; ``--policy-dump`` prints
the plan as JSON and exits.  ``build_disagg_engine`` builds the
disaggregated prefill/decode pair (``serve/disagg.py``): on the one
device, or with ``roles`` each role on its own submesh of ranks.  The
plan's predicted times are those of the
paper's modeled accelerators, not of the card.  Before it serves, the CLI
prints the arch's full-size Mensa prefill plan and both phases' strategy
and overrides (``core.executor.phase_profiles``, an analytic model of a
16 x 16 mesh of H100 SXM cards at 700 W from the datasheet's constants,
not a measurement), and the engine runs each phase through its
profile.  ``--max-new``,
``--min-bucket``, ``--max-prefill-per-step``, ``--max-prefill-batch``,
``--long-prompts``, ``--warmup``, ``--trace`` (the engine's Chrome trace),
``--metrics-json`` (the stats summary, its ``programs`` section included:
each warmed program's FLOPs, bytes and share of the H100's roofline),
``--metrics-prom`` (the metrics registry in Prometheus text) and
``--program-memory`` (each program's memory, measured at its warmup call)
are the JAX CLI's.  ``--kv-block-size``
defaults to paged blocks of 16 tokens (the JAX CLI's default is dense KV);
0 keeps every KV cache dense per slot (falcon-mamba has no KV cache: its
conv and scan states are per slot either way).

``--mesh`` (``off`` by default, ``auto`` for every rank data-parallel, or
``DPxMP``), ``--dp`` / ``--mp`` and ``--param-strategy {tp,dp,auto}`` serve
over a (data, model) device mesh (``launch/mesh.py``), SPMD: one process a
card under ``torch.distributed.run``, every rank serving the same requests,
rank 0 printing the summary and writing the files::

  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.serve --arch qwen3-0.6b --mesh auto

Without ``torch.distributed.run`` a mesh is a 1-rank group on the one card
(gloo ranks with ``--device cpu``).  On a mesh each rank draws only its own
shards of the seed's weights (``launch.shardings.build_distributed_model``),
so a model no card holds whole serves over several, e.g. the two MoE archs
at full depth on four cards (a quarter of 78.5 and 204.6 GiB a rank)::

  python -m torch.distributed.run --standalone --nproc-per-node=4 \\
      -m repro_torch.launch.serve --arch llama4-scout-17b-a16e --mp 4

``--roles prefill=N,decode=M`` serves through the disaggregated pair with
each role on its own (N, mp) and (M, mp) submesh of ranks
(``launch.mesh.make_role_meshes``; ``--mp`` multiplies both, ``--mesh`` and
``--dp`` are refused beside it), one process a card, the suitcase crossing
between the cards::

  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.serve --arch qwen3-0.6b --roles prefill=1,decode=1

Every rank serves its role; rank 0 prints the pair's summary (the decode
role's gathered under ``roles``) and writes ``--trace`` (both roles'
tracks), ``--metrics-json``, ``--metrics-prom`` (the decode role's
registry, as the JAX CLI writes it) and ``--tokens-json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config, reduced_config
from ..core.executor import phase_profiles
from ..models import build_model
from ..obs import profile_trace
from ..serve.disagg import DisaggEngine
from ..serve.engine import Request, ServeEngine, prefill_buckets
from ..serve.placement import ExecutionOracle, PlacementPlan, fixed_plan
from .mesh import (RoleConfig, make_role_meshes, make_serve_mesh,
                   parse_mesh_arg, parse_roles_arg, start_group)
from .shardings import build_distributed_model

#: options of the JAX package's serving CLI that are not ported yet: none
#: since ``--roles``
NOT_PORTED: tuple[str, ...] = ()


def _resolve_policy(cfg, policy, backend: str, *, slots: int, max_len: int,
                    min_bucket: int, max_bucket: int | None,
                    mesh_axes: tuple = ()) -> PlacementPlan | None:
    """The plan ``policy`` names: the oracle's for ``"auto"`` (resolved
    for ``backend`` and a mesh of ``mesh_axes``), None for ``"fixed"``, a
    ``PlacementPlan`` as it is."""
    if isinstance(policy, PlacementPlan):
        return policy
    if policy == "auto":
        return ExecutionOracle(
            cfg, slots=slots, max_len=max_len, min_bucket=min_bucket,
            max_bucket=max_bucket, mesh_axes=tuple(mesh_axes),
            backend=backend).resolve()
    if policy == "fixed":
        return None
    raise ValueError(f"policy must be 'auto', 'fixed', or a "
                     f"PlacementPlan, got {policy!r}")


def _phase_models(cfg, model, profiles) -> dict:
    """The prefill and decode models of the Mensa execution profiles
    ``profiles`` (a (prefill, decode) pair): each phase's config is its
    profile applied to ``cfg`` (runtime-safe overrides only), and a phase
    model, over ``model``'s parameter tensors, is built only where that
    config differs from ``cfg``."""
    out = {}
    for key, prof in zip(("prefill_model", "decode_model"), profiles):
        phase_cfg = prof.apply(cfg, runtime_only=True)
        out[key] = model.with_config(phase_cfg) if phase_cfg != cfg else None
    return out


def build_engine(cfg, model=None, *, slots: int = 4, max_len: int = 256,
                 min_bucket: int = 16, max_bucket: int | None = None,
                 max_prefill_per_step: int = 1, max_prefill_batch: int = 4,
                 prefill_chunk: int | None = None,
                 kv_block_size: int | None = None,
                 kv_blocks: int | None = None,
                 prefix_cache: bool = True, device: str = "cuda",
                 seed: int = 0, plan_cfg=None, profiles=None, policy="auto",
                 program_memory: bool = False, mesh=None,
                 param_strategy: str = "tp",
                 cuda_graphs: bool = True) -> ServeEngine:
    """An engine for ``cfg`` over ``model`` (default: a model with random
    weights from ``seed`` on ``device``).  ``max_bucket`` caps the prefill
    buckets below max_len so longer prompts run the chunked path;
    ``kv_block_size``/``kv_blocks``/``prefix_cache`` select the paged pool.

    ``policy``: "auto" (default) resolves a ``PlacementPlan`` through the
    ExecutionOracle (characterize -> cluster -> cost) for the model's device
    type; "fixed" keeps the engine's own knobs; a ``PlacementPlan`` is used
    as it is.  A plan picks the bucket ladder and the prefill chunk, which
    explicit ``prefill_chunk`` still beats; every geometry serves the same
    tokens.  ``program_memory``: measure each program's memory at warmup
    (``ServeEngine``).  ``mesh`` serves over a (data, model) device mesh
    (``launch.mesh.make_serve_mesh``), the weights laid out by
    ``param_strategy`` ("tp", "dp" or "auto": per cluster from the plan's
    ``sharding_axis``, ``launch.shardings.param_specs``); the auto plan is
    then resolved with the mesh's axes.  With a ``mesh`` and no ``model``
    each rank draws only its own shards of the seed's weights
    (``launch.shardings.build_distributed_model``: the values of
    ``build_model(cfg, device, seed)``, never whole on one card).

    The prefill and decode programs run through their Mensa execution
    profiles (``core.executor.phase_profiles(plan_cfg or cfg,
    policy=plan)``; pass ``profiles``, a (prefill, decode) pair, to reuse
    computed ones), as the reference routes them: runtime-safe overrides
    only, each phase model over the one set of parameters.  Plan a cut
    config at its full size with ``plan_cfg`` (a reduced MoE's 4 experts
    leave the decode shape no legal strategy on the 16-way model axis, so
    its plan raises, as the reference's does); on a mesh ``plan_cfg`` also
    decides the weights' layout (``ServeEngine``'s ``layout_cfg``: a cut
    of a >20B arch splits its dense weights over ``data`` as the full
    config does).  ``cuda_graphs``: ``ServeEngine``'s (False: every
    program eagerly on the card; the CLI has no flag for it)."""
    backend = (model.device if model is not None
               else torch.device(device)).type
    plan = _resolve_policy(cfg, policy, backend, slots=slots,
                           max_len=max_len, min_bucket=min_bucket,
                           max_bucket=max_bucket,
                           mesh_axes=mesh.mesh_dim_names
                           if mesh is not None else ())
    if profiles is None:
        profiles = phase_profiles(plan_cfg or cfg, policy=plan)
    if model is None and mesh is not None:
        # each rank draws its own shards: no card holds the whole model.
        # Laid out by the plan the engine takes (a fixed one without a
        # policy: its buckets decide no layout)
        model = build_distributed_model(
            cfg, mesh, seed, param_strategy,
            plan or fixed_plan(cfg, buckets=(), prefill_chunk=0,
                               backend=backend),
            layout_cfg=plan_cfg)
    elif model is None:
        model = build_model(cfg, device=device, seed=seed)
    phases = _phase_models(cfg, model, profiles)
    buckets = None
    if max_bucket is not None:
        buckets = prefill_buckets(min(max_bucket, max_len), min_bucket)
    return ServeEngine(
        model, slots=slots, max_len=max_len, buckets=buckets,
        min_bucket=min_bucket, max_prefill_per_step=max_prefill_per_step,
        max_prefill_batch=max_prefill_batch, prefill_chunk=prefill_chunk,
        kv_block_size=kv_block_size, kv_blocks=kv_blocks,
        prefix_cache=prefix_cache, policy=plan,
        program_memory=program_memory, mesh=mesh,
        param_strategy=param_strategy, layout_cfg=plan_cfg,
        cuda_graphs=cuda_graphs, **phases)


def build_disagg_engine(cfg, model=None, *, prefill_slots: int = 4,
                        decode_slots: int = 4, max_len: int = 256,
                        min_bucket: int = 16, max_bucket: int | None = None,
                        max_prefill_per_step: int = 1,
                        max_prefill_batch: int = 4,
                        prefill_chunk: int | None = None,
                        kv_block_size: int | None = None,
                        kv_blocks: int | None = None,
                        prefix_cache: bool = True, device: str = "cuda",
                        seed: int = 0, plan_cfg=None, profiles=None,
                        policy="auto", program_memory: bool = False,
                        roles: RoleConfig | None = None,
                        param_strategy: str = "tp") -> DisaggEngine:
    """The disaggregated counterpart of :func:`build_engine`: a prefill and
    a decode engine over ``model``, on its one device with ``roles=None``
    (the reference's functional model of the split), else each role on its
    own submesh of the ``roles`` partition (``launch.mesh.
    make_role_meshes``, over the default process group, started here if
    none is running; every rank calls this and builds its role's engine,
    the weights laid out by ``param_strategy``).  The auto plan is
    resolved at ``slots=decode_slots``, with the mesh axes ("data",
    "model") under ``roles``, as the reference resolves it; knob
    precedence is ``build_engine``'s, and the plan's ``per_role`` knobs
    give the prefill role its buckets and chunk (the decode role takes
    none).  ``plan_cfg`` and ``profiles`` as in ``build_engine``: the
    prefill role runs the prefill phase's model, the decode role the
    decode phase's."""
    backend = (model.device if model is not None
               else torch.device(device)).type
    pm = dm = None
    if roles is not None:
        pm, dm, _ = make_role_meshes(roles, device=backend)
    plan = _resolve_policy(cfg, policy, backend, slots=decode_slots,
                           max_len=max_len, min_bucket=min_bucket,
                           max_bucket=max_bucket,
                           mesh_axes=pm.mesh_dim_names if pm is not None
                           else ())
    if profiles is None:
        profiles = phase_profiles(plan_cfg or cfg, policy=plan)
    if model is None:
        model = build_model(cfg, device=device, seed=seed)
    phases = _phase_models(cfg, model, profiles)
    buckets = None
    if max_bucket is not None:
        buckets = prefill_buckets(min(max_bucket, max_len), min_bucket)
    return DisaggEngine(
        model, prefill_slots=prefill_slots, decode_slots=decode_slots,
        max_len=max_len, min_bucket=min_bucket, buckets=buckets,
        max_prefill_per_step=max_prefill_per_step,
        max_prefill_batch=max_prefill_batch, prefill_chunk=prefill_chunk,
        kv_block_size=kv_block_size, kv_blocks=kv_blocks,
        prefix_cache=prefix_cache, policy=plan,
        program_memory=program_memory, prefill_mesh=pm, decode_mesh=dm,
        param_strategy=param_strategy, layout_cfg=plan_cfg, **phases)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced (test-size) config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--min-bucket", type=int, default=16)
    ap.add_argument("--max-bucket", type=int, default=None,
                    help="cap prefill buckets below max-len; longer prompts "
                         "run the chunked path")
    ap.add_argument("--max-prefill-per-step", type=int, default=1,
                    help="admissions per engine tick")
    ap.add_argument("--max-prefill-batch", type=int, default=4,
                    help="same-bucket admissions stacked into one batched "
                         "prefill call")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunk width for prompts longer than the largest "
                         "bucket (default: the largest bucket)")
    ap.add_argument("--long-prompts", type=int, default=0,
                    help="also submit this many prompts longer than the "
                         "largest bucket (chunked prefill)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every engine shape once before serving")
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
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event JSON of the run here "
                         "(view at ui.perfetto.dev); tracing is on either "
                         "way — this just saves the buffer")
    ap.add_argument("--metrics-json", default="",
                    help="write the final stats summary (including the "
                         "versioned obs metrics section) as JSON here")
    ap.add_argument("--metrics-prom", default="",
                    help="write the metrics registry in Prometheus/"
                         "OpenMetrics text exposition format here (a "
                         "node_exporter textfile-collector drop-in)")
    ap.add_argument("--tokens-json", default="",
                    help="write each request's generated tokens as JSON "
                         "here ({rid: [tokens]}): two runs' outputs compare "
                         "token for token (a mesh run against --mesh off)")
    ap.add_argument("--program-memory",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="measure each warmed program's memory at its "
                         "warmup call: argument and output bytes, and on "
                         "the card the caching allocator's temp and peak "
                         "watermarks around the call (the programs section "
                         "always carries static FLOPs/bytes; pass --warmup, "
                         "which registers the programs)")
    ap.add_argument("--profile-dir", default="",
                    help="profile the served run with torch.profiler: a "
                         "Chrome trace, ops by device time and a summary "
                         "(card busy / idle, top kernels) in this directory")
    ap.add_argument("--policy", default="auto", choices=("auto", "fixed"),
                    help="'auto': the placement oracle characterizes and "
                         "clusters the served layers and picks chunk / "
                         "buckets per cluster; 'fixed': the engine's own "
                         "knobs only")
    ap.add_argument("--policy-dump", action="store_true",
                    help="print the resolved PlacementPlan as JSON and exit "
                         "without building the engine")
    ap.add_argument("--mesh", default="off",
                    help="device mesh for sharded serving: 'off' (default), "
                         "'auto' (every rank, data-parallel), or 'DPxMP' "
                         "(e.g. '4x2'); one process a card under "
                         "torch.distributed.run, gloo ranks with --device "
                         "cpu")
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel mesh axis (overrides --mesh; shards "
                         "slots and the paged block pool)")
    ap.add_argument("--mp", type=int, default=None,
                    help="model-parallel mesh axis (overrides --mesh; Mensa "
                         "cluster tensor parallelism)")
    ap.add_argument("--roles", default="off",
                    help="disaggregated prefill/decode serving: "
                         "'prefill=N,decode=M' puts each role on its own "
                         "submesh of N (resp. M) x mp ranks, one process a "
                         "card under torch.distributed.run, with the KV "
                         "suitcase crossing between them; 'off' (default) "
                         "keeps the single interleaved engine; mutually "
                         "exclusive with --mesh/--dp (tensor parallelism "
                         "inside each role comes from --mp)")
    ap.add_argument("--param-strategy", default="tp",
                    choices=("tp", "dp", "auto"),
                    help="weight sharding template on a mesh: Mensa cluster "
                         "TP, replicated-dp, or 'auto' — per cluster from "
                         "the placement plan's sharding_axis (memory-centric "
                         "clusters replicate, compute-centric ones take TP)")
    return ap


def mesh_from_args(args):
    """Resolve --mesh / --dp / --mp into a DeviceMesh (or None for
    unsharded) on ``args.device``."""
    if args.dp is not None or args.mp is not None:
        return make_serve_mesh(args.dp, args.mp or 1, device=args.device)
    return parse_mesh_arg(args.mesh, device=args.device)


def main(argv=None) -> dict | None:
    args = build_parser().parse_args(argv)
    started = dist.is_initialized()
    try:
        return _serve(args)
    finally:
        if dist.is_initialized() and not started:
            dist.destroy_process_group()


def _serve(args) -> dict | None:
    roles = parse_roles_arg(args.roles)
    if roles is not None and (args.mesh != "off" or args.dp is not None):
        raise SystemExit("--roles is mutually exclusive with --mesh/--dp: "
                         "each role gets its own (N, mp) submesh")
    if roles is not None and args.mp is not None:
        roles = RoleConfig(prefill=roles.prefill, decode=roles.decode,
                           mp=args.mp)
    mesh = None if roles is not None else mesh_from_args(args)
    if roles is not None:
        # the roles' ranks; build_disagg_engine partitions them
        start_group(args.device)
    # on a mesh every rank serves; rank 0 alone prints and writes
    lead = (mesh is None and roles is None) or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    # planned at the arch's full size, as the JAX CLI plans
    plan_cfg = get_config(args.arch)
    plan = None
    if args.policy == "auto" or args.policy_dump:
        plan = ExecutionOracle(
            plan_cfg, slots=args.slots, max_len=args.max_len,
            min_bucket=args.min_bucket, max_bucket=args.max_bucket,
            mesh_axes=("data", "model") if roles is not None
            else mesh.mesh_dim_names if mesh is not None else (),
            backend=args.device).resolve()
    if args.policy_dump:
        say(plan.dumps())
        return None
    if plan is not None:
        say(f"[serve] placement plan ({plan.source}, backend "
              f"{plan.backend}): clusters {list(plan.layer_clusters)} "
              f"chunk={plan.prefill_chunk} buckets={list(plan.buckets)}")
    prefill_prof, decode_prof = phase_profiles(plan_cfg, policy=plan)
    say(f"[serve] Mensa prefill plan for {args.arch}:")
    say(prefill_prof.plan.summary())
    say(f"[serve] prefill strategy={prefill_prof.strategy} "
          f"overrides={prefill_prof.cfg_overrides}")
    say(f"[serve] decode  strategy={decode_prof.strategy} "
          f"overrides={decode_prof.cfg_overrides}")
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if mesh is not None:
        say(f"[serve] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"over {mesh.size()} devices (param strategy "
              f"{args.param_strategy})")
    knobs = dict(
        max_len=args.max_len, min_bucket=args.min_bucket,
        max_bucket=args.max_bucket,
        max_prefill_per_step=args.max_prefill_per_step,
        max_prefill_batch=args.max_prefill_batch,
        prefill_chunk=args.prefill_chunk,
        kv_block_size=args.kv_block_size or None, kv_blocks=args.kv_blocks,
        prefix_cache=args.prefix_cache, device=args.device, seed=args.seed,
        plan_cfg=plan_cfg, profiles=(prefill_prof, decode_prof),
        policy=plan if plan is not None else "fixed",
        program_memory=args.program_memory,
        param_strategy=args.param_strategy)
    if roles is not None:
        say(f"[serve] disaggregated roles: prefill {roles.prefill}x"
            f"{roles.mp} devices, decode {roles.decode}x{roles.mp} devices "
            f"(param strategy {args.param_strategy})")
        engine = build_disagg_engine(cfg, roles=roles,
                                     prefill_slots=args.slots,
                                     decode_slots=args.slots, **knobs)
    else:
        engine = build_engine(cfg, slots=args.slots, mesh=mesh, **knobs)
    if args.warmup:
        engine.warmup()
    rng = np.random.RandomState(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.randint(1, cfg.vocab_size, 4 + i % 6).tolist(),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p)
            for i in range(args.requests)]
    if args.long_prompts:
        long_len = min(engine.buckets[-1] + engine.prefill_chunk,
                       args.max_len - 1)
        if long_len <= engine.buckets[-1]:
            raise SystemExit(
                f"--long-prompts needs prompts longer than the largest "
                f"bucket ({engine.buckets[-1]}), but max_len {args.max_len} "
                f"leaves no admissible length above it — pass --max-bucket "
                f"below max_len (e.g. --max-bucket {args.max_len // 4})")
        reqs += [Request(rid=args.requests + i,
                         prompt=rng.randint(1, cfg.vocab_size,
                                            long_len).tolist(),
                         max_new_tokens=args.max_new,
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p)
                 for i in range(args.long_prompts)]
    with profile_trace(args.profile_dir, device=engine.device) as prof:
        if prof is not None:
            # without --warmup the window also holds first-call costs (lazy
            # library loads, each bucket's first call)
            prof["warmed_up"] = bool(args.warmup)
        engine.run(reqs)
    pair = isinstance(engine, DisaggEngine)
    # the pair's summary, trace and registry are collective on role meshes
    summary = engine.summary() if pair else engine.stats.summary()
    if prof is not None:
        summary["profile"] = prof
    say(json.dumps(summary, indent=1))
    if pair and args.trace:
        written = engine.save_trace(args.trace)
    prom = engine.metrics_prometheus() if pair and args.metrics_prom \
        else None
    if not lead:
        return summary
    if args.trace:
        if not pair:
            engine.save_trace(args.trace)
            written = len(engine.tracer), engine.tracer.dropped
        say(f"[serve] trace written to {args.trace} ({written[0]} events, "
            f"{written[1]} dropped) — load at ui.perfetto.dev")
    if args.metrics_json:
        Path(args.metrics_json).write_text(json.dumps(summary, indent=1)
                                           + "\n")
    if args.tokens_json:
        Path(args.tokens_json).write_text(json.dumps(
            {r.rid: r.generated for r in reqs}) + "\n")
    if args.metrics_prom:
        Path(args.metrics_prom).write_text(
            prom if pair else engine.stats.metrics.to_prometheus())
        say(f"[serve] Prometheus metrics written to {args.metrics_prom}"
            + (" (decode role's registry; the prefill role keeps its own)"
               if pair else ""))
    return summary


if __name__ == "__main__":
    main()
