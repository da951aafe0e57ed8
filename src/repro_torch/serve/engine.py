"""Batched serving engine: continuous batching over a fixed slot pool, with
the KV cache either in a paged block pool with a radix-tree prefix cache or
dense per slot.

The PyTorch counterpart of ``repro.serve.engine.ServeEngine`` for one
device.  The host-side logic is the JAX engine's, line for line: requests
are admitted into free slots; prompts up to the largest bucket are
right-padded to a power-of-two bucket and same-bucket admissions run as one
``(N, bucket)`` prefill (N bucketed too); longer prompts, and every prompt
that hits the prefix cache, run chunk by chunk, one chunk per tick,
resuming at ``offset``; a partial-block prefix hit clones one block
(copy-on-write); every tick ends with one lockstep decode step whose
``active`` mask freezes dead and mid-prefill slots bit for bit.

Where the JAX engine compiles one program for each shape of its inventory
(``jax.jit``, the pool state donated), the port keeps a program table
(``serve/graphs.py``): an entry for each (program name, the call's
shapes), prepared by the call that first meets it — ``warmup()`` meets
them all.  On a card with no mesh an entry is a CUDA graph, captured once
over static input buffers and replayed at every later call, all of an
engine's graphs in one memory pool; on the CPU, on a mesh, and with
``cuda_graphs=False`` (the counterpart of ``jax.disable_jit``) it is the
eager call.  ``prefill_compiles`` counts the entries of prefill, chunk,
copy and export, ``decode_compiles`` those of decode and import, as the
reference's jit caches count them.  Every program writes the engine's
state tensors in place and never rebinds them: a state leaf that a model
call returns anew is copied back as the program's last step, and
``warmup()`` zeroes the states in place.  Sampling stays outside the
programs: its per-row generators are seeded on the host, and its count of
nonfinite rows and its token list are the tick's one sync.

The state design is the JAX engine's: a batched prefill runs on fresh
batch-N states (zeroed inside the program; paged layers adopt the live
pool, whose writes from padding rows drop through all-sentinel table
rows) and only the real rows are spliced into their slots; a chunk runs
on a batch-1 copy of its slot's states and is spliced back.  Decode
updates the slot pool in place; rows frozen by ``active`` keep every bit.
A fresh prefill state starts at zero, and a chunk at offset 0 zeroes the
carried recurrent state, so a recycled slot never sees its last request.

Every engine carries a placement plan (``serve/placement.py``): the
placement oracle's (``policy=``), whose bucket ladder and prefill chunk it
adopts unless the constructor is given its own, or a "fixed" record of the
constructor's knobs.  ``EngineStats.summary()`` reports the plan beside the
measured phase times and their drift from its predictions.

The engine is observable as the reference is (``obs/``): every request's
lifecycle (submit, admit, prefill or chunks, decode, stall, finish or
abort) lands in a ring-buffered ``Tracer`` — a track for the queue, one per
slot, one for engine-wide spans, and per-tick counter tracks — saved as
Chrome trace-event JSON by ``save_trace``.  Every stamp comes from the
tracer's clock through ``Timed``, which synchronizes the card before its
closing stamp.  Aggregates (TTFT, decode tick and time-between-tokens
histograms, tokens per tick, prefill padding waste, memory gauges) go to
``EngineStats.metrics`` and come out as the ``obs`` section of
``summary()``, the reference's schema but for ``NOT_PORTED_STATS``.

Every program of the warmed inventory — ``prefill[{nb}x{b}]``, ``chunk``,
``copy``, ``decode``, and ``export``/``import`` on role engines — registers
in ``self.programs`` (``obs/programs.ProgramRegistry``) right before the
warmup call that prepares its table entry, with an analytic count of its
FLOPs and bytes at that shape (``program_memory=True`` adds the call's
memory); each timed section then
feeds its duration back under that name.  ``summary()`` reports the
``programs`` section (live FLOP/s, bytes/s and shares of the H100's
roofline) and, under a plan with clusters, ``placement.drift.clusters``.

Serving is optionally disaggregated (``role=``), as the reference's: a
``role="prefill"`` engine runs bucketed and chunked prefill only and parks
each finished prefill on ``ready``; a ``role="decode"`` engine never admits
from the queue and takes sequences through ``adopt``, which maps fresh
blocks in its own pool and scatters the visiting suitcase (the slot's
batch-1 state row plus copies of its KV blocks) into them.
``serve.disagg.DisaggEngine`` couples the pair on the one device, or each
role on its own submesh of ranks, where the coordinator carries the
suitcase across and each role engine runs only its half.

Serving is optionally sharded (``mesh=``, a ``launch.mesh.make_serve_mesh``
``DeviceMesh`` with (data, model) axes), SPMD as the reference's: every rank
runs this host logic on the same requests, and only the tensors are
DTensors.  The parameters are distributed by ``launch.shardings.
param_specs`` (``param_strategy``), or come laid out so (a model built
shard by shard on each rank), the slot states placed by
``serve_state_specs`` (slots, and a paged pool's blocks, over ``data``
where they split evenly; heads and widths over ``model`` where they do),
and each call's host inputs (tokens, positions, masks, block tables) are
DTensors every rank builds alike: split over ``data`` when the call's batch
splits evenly, replicated otherwise.  The model runs on them
(``models/spmd.py``: kernels on each rank's shard); the logits are gathered
to every rank before sampling, so every rank samples the same tokens and
the host state stays identical.  State surgery (splicing rows, gathering a
slot, cloning a block) acts on the local shards (``serve/sharded.py``).
On a pure data-parallel mesh per-slot math never crosses a shard.  The
pool's accounting is split into the same stripes (``kv.shards``), and
the program registry counts each rank's local shapes.
"""
from __future__ import annotations

import warnings
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.h100 import for_dtype
from ..launch import shardings as shard_lib
from ..models import spmd
from ..models.attention import KVCache, PagedKVCache
from ..models.transformer import BlockState, Model
from ..obs import MetricsRegistry, ProgramRegistry, Timed, Tracer, \
    drift_report, plan_predictions, program_cost
from ..obs.programs import measure_call
from . import sharded
from .graphs import EagerProgram, GraphProgram, shapes
from .kvpool import PagedKVManager
from .placement import PlacementPlan, fixed_plan
from .sampling import sample_tokens


# ------------------------------------------------------------------- buckets
def prefill_buckets(max_len: int, min_bucket: int = 16) -> tuple[int, ...]:
    """Power-of-two prompt buckets up to max_len.  When max_len is not
    itself a power of two, a final max_len-sized bucket covers the gap so no
    prompt below the cache size is rejected."""
    out = []
    b = min_bucket
    while b <= max_len:
        out.append(b)
        b *= 2
    if not out:
        raise ValueError(f"max_len {max_len} < min_bucket {min_bucket}")
    if out[-1] < max_len:
        out.append(max_len)
    return tuple(out)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket that fits an n-token prompt."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


# --------------------------------------------------------------------- stats
#: keys of the reference's ``EngineStats.summary()`` that the port leaves
#: out, each with the slice that brings it (ROADMAP A): none since the
#: mesh brought the pool's per-shard keys
NOT_PORTED_STATS: dict[str, str] = {}

#: each program kind's phase in the ``programs`` section, as the reference
#: registers it; its ``program`` string is the reference's jit attribute,
#: ``"_" + kind``, and names the eager section that stands for it
PROGRAM_PHASES = {"prefill": "prefill", "chunk": "prefill", "copy": "kv",
                  "decode": "decode", "export": "handoff",
                  "import": "handoff"}
#: the program kinds ``decode_compiles`` counts; every other kind counts in
#: ``prefill_compiles`` (the reference's ``_sync_compile_stats``)
DECODE_PROGRAMS = ("decode", "import")

#: tracer track of the queue-level request events; slot ``i`` is on
#: ``1 + i``, engine-wide spans (decode ticks, warmup, block copies) on
#: ``1 + slots``, all offset by the engine's ``track_base``
TRACK_REQUESTS = 0


@dataclass
class EngineStats:
    """Engine-side serving metrics, accumulated across ticks."""
    requests_completed: int = 0
    requests_aborted: int = 0           # unfinished when run() hit max_steps
    tokens_generated: int = 0
    prefills: int = 0                   # requests prefilled (all paths)
    prefills_chunked: int = 0           # ... via the chunked path
    prefill_calls: int = 0              # batched-prefill invocations
    prefill_chunks: int = 0             # chunk-continuation invocations
    prefill_prompt_tokens: int = 0
    prefill_tokens_computed: int = 0    # prefix hits skip the shared part
    prefill_padded_tokens: int = 0
    prefill_time_s: float = 0.0
    decode_steps: int = 0
    decode_time_s: float = 0.0
    # TTFT: count/sum/max are exact streaming aggregates; the median comes
    # from the fixed-size log2 histogram in ``metrics``, as the reference's
    ttft_count: int = 0
    ttft_sum: float = 0.0
    ttft_max: float = 0.0
    # counters, gauges and log2 histograms: the ``obs`` section of summary()
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    occupancy_sum: float = 0.0          # sum over ticks of busy/slots
    ticks: int = 0
    bucket_counts: dict = field(default_factory=dict)
    batch_counts: dict = field(default_factory=dict)   # rows per prefill call
    # entries of the engine's program table (CUDA graphs on a card)
    prefill_compiles: int = 0
    decode_compiles: int = 0
    wall_time_s: float = 0.0
    nonfinite_logits: int = 0           # sampled rows with a NaN/inf logit
    # ---- paged KV pool (all zero on dense engines) ----
    kv_pool_blocks: int = 0
    kv_block_size: int = 0
    kv_blocks_in_use: int = 0           # referenced blocks, end of last tick
    kv_blocks_peak: int = 0
    kv_blocks_cached: int = 0           # evictable prefix-cache blocks
    kv_occupancy_sum: float = 0.0       # sum over ticks of in_use/pool
    prefix_queries: int = 0
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    blocks_copied: int = 0              # copy-on-write clones
    blocks_evicted: int = 0             # LRU evictions of cached blocks
    decode_stalls: int = 0              # slot-ticks frozen waiting for blocks
    # ---- sharded pool (mesh engines; kv_shards == 1 otherwise) ----
    kv_shards: int = 1
    kv_in_use_per_shard: list = field(default_factory=list)
    kv_peak_per_shard: list = field(default_factory=list)   # sums to peak
    # ---- disaggregated handoff (role engines; all zero interleaved) ----
    handoffs: int = 0                   # slots exported (prefill role) or
    #                                     adopted (decode role)
    handoff_time_s: float = 0.0         # export / import time
    handoff_stalls: int = 0             # adoptions deferred: no free slot or
    #                                     no blocks on the decode pool
    # ---- placement (the plan's summary; set by the engine) ----
    placement: dict = field(default_factory=dict)
    # ---- program cost registry (obs/programs.py; set by the engine) ----
    programs: ProgramRegistry | None = None

    def record_ttft(self, v: float) -> None:
        self.ttft_count += 1
        self.ttft_sum += v
        if v > self.ttft_max:
            self.ttft_max = v
        self.metrics.histogram("ttft_s").record(v)

    def summary(self) -> dict:
        out = {
            "requests_completed": self.requests_completed,
            "requests_aborted": self.requests_aborted,
            "tokens_generated": self.tokens_generated,
            "tokens_per_s": self.tokens_generated / self.wall_time_s
            if self.wall_time_s else 0.0,
            "ttft_ms": {
                "mean": 1e3 * self.ttft_sum / self.ttft_count
                if self.ttft_count else 0.0,           # exact
                "p50": 1e3 * self.metrics.histogram("ttft_s").quantile(0.5),
                "max": 1e3 * self.ttft_max,            # exact
            },
            "decode_step_ms": 1e3 * self.decode_time_s
            / max(self.decode_steps, 1),
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "prefills_chunked": self.prefills_chunked,
            "prefill_calls": self.prefill_calls,
            "prefill_chunks": self.prefill_chunks,
            "prefill_prompt_tokens": self.prefill_prompt_tokens,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_time_s": self.prefill_time_s,
            "prefill_padding_overhead": (
                self.prefill_padded_tokens / self.prefill_prompt_tokens - 1.0
                if self.prefill_prompt_tokens else 0.0),
            "bucket_counts": dict(self.bucket_counts),
            "prefill_batch_counts": dict(self.batch_counts),
            "slot_occupancy": self.occupancy_sum / max(self.ticks, 1),
            "prefill_compiles": self.prefill_compiles,
            "decode_compiles": self.decode_compiles,
            "wall_time_s": self.wall_time_s,
            "nonfinite_logits": self.nonfinite_logits,
        }
        if self.handoffs or self.handoff_stalls:
            out["handoff"] = {
                "handoffs": self.handoffs,
                "handoff_time_s": self.handoff_time_s,
                "handoff_stalls": self.handoff_stalls,
            }
        if self.kv_pool_blocks:
            out["kv"] = {
                "pool_blocks": self.kv_pool_blocks,
                "block_size": self.kv_block_size,
                "blocks_in_use": self.kv_blocks_in_use,
                "blocks_peak": self.kv_blocks_peak,
                "blocks_cached": self.kv_blocks_cached,
                "occupancy": self.kv_occupancy_sum / max(self.ticks, 1),
                "prefix_queries": self.prefix_queries,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_rate": self.prefix_hits / self.prefix_queries
                if self.prefix_queries else 0.0,
                "prefix_tokens_reused": self.prefix_tokens_reused,
                "blocks_copied": self.blocks_copied,
                "blocks_evicted": self.blocks_evicted,
                "decode_stalls": self.decode_stalls,
            }
            if self.kv_shards > 1:
                out["kv"]["shards"] = self.kv_shards
                out["kv"]["in_use_per_shard"] = list(self.kv_in_use_per_shard)
                out["kv"]["peak_per_shard"] = list(self.kv_peak_per_shard)
        if self.placement:
            # the plan (predicted) + measured + drift, side by side
            p = dict(self.placement)
            p["measured"] = {
                "prefill_call_s": self.prefill_time_s
                / max(self.prefill_calls + self.prefill_chunks, 1),
                "prefill_token_s": self.prefill_time_s
                / max(self.prefill_tokens_computed, 1),
                "decode_step_s": self.decode_time_s
                / max(self.decode_steps, 1),
            }
            p["drift"] = drift_report(plan_predictions(p), p["measured"])
            if p["drift"] and self.programs is not None:
                # per-cluster measured-vs-predicted: the registry's phase
                # totals attributed over the plan's clusters
                clusters = self.programs.cluster_rollup()
                if clusters:
                    p["drift"]["clusters"] = clusters
            out["placement"] = p
        if self.programs is not None:
            out["programs"] = self.programs.summary()
        out["obs"] = self.metrics.to_dict()
        return out


def check_request(req, max_len: int) -> None:
    """Refuse a request no engine of cache size ``max_len`` can serve
    (``ServeEngine.submit``'s checks, which every rank of a role pair makes
    alike)."""
    if not req.prompt:
        raise ValueError("empty prompt: nothing to condition on")
    if req.max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1 (prefill always "
                         "samples the first token)")
    if len(req.prompt) > max_len - 1:
        raise ValueError(f"prompt length {len(req.prompt)} leaves no "
                         f"cache room to decode (max_len {max_len})")
    if req.temperature < 0:
        raise ValueError("temperature must be >= 0 (0 = greedy)")
    if not 0 < req.top_p <= 1:
        raise ValueError("top_p must be in (0, 1]")
    if req.top_k < 0:
        raise ValueError("top_k must be >= 0 (0 = no top-k filter)")


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int = -1
    # sampling: temperature <= 0 is exact greedy argmax (the default);
    # seed None derives a per-request stream from rid
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None
    generated: list[int] = field(default_factory=list)
    done: bool = False
    aborted: bool = False               # unfinished when run() gave up
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


class ServeEngine:
    def __init__(self, model: Model, *, slots: int = 4, max_len: int = 512,
                 buckets: tuple[int, ...] | None = None,
                 min_bucket: int = 16,
                 max_prefill_per_step: int = 1,
                 max_prefill_batch: int = 4,
                 prefill_chunk: int | None = None,
                 kv_block_size: int | None = None,
                 kv_blocks: int | None = None,
                 prefix_cache: bool = True,
                 policy: PlacementPlan | None = None,
                 role: str = "both",
                 track_base: int = 0,
                 tracer: Tracer | None = None,
                 program_memory: bool = False,
                 prefill_model: Model | None = None,
                 decode_model: Model | None = None,
                 mesh=None, param_strategy: str = "tp",
                 layout_cfg=None, cuda_graphs: bool = True):
        """``min_bucket``: the smallest prompt bucket of the default ladder.
        ``max_prefill_per_step``: queued requests admitted per tick.
        ``max_prefill_batch``: rows of one batched prefill (capped at
        ``slots``).

        ``kv_block_size``: tokens per KV block of the paged pool that
        ``attn`` layers keep their KV in; None keeps every cache dense per
        slot.  ``kv_blocks``: physical blocks in the pool (default: the
        dense equivalent, slots * max_len / block_size).  ``prefix_cache``:
        share same-prefix KV blocks across requests through the radix tree
        (paged, and only when every layer is ``attn``: window rings and
        recurrent states are not block-addressable).

        ``policy``: a ``serve.placement.PlacementPlan`` from the
        ExecutionOracle.  It supplies the bucket ladder and the prefill
        chunk (explicit ``buckets``/``prefill_chunk`` still win) and is
        recorded in ``EngineStats.placement``; without one the engine
        records a "fixed" plan of its own knobs.

        ``role``: "both" (default, the interleaved engine), "prefill" (runs
        bucketed and chunked prefill only; finished prefills wait on
        ``ready`` for :meth:`export_slot` and :meth:`release_handoff`) or
        "decode" (never admits from the queue; sequences arrive through
        :meth:`adopt`).  A role engine warms only its own shapes and its
        half of the handoff.  ``track_base`` offsets the engine's tracer
        tracks so two role engines share one timeline; role engines also
        prefix their track and counter names with ``"{role}/"``.

        ``tracer``: an ``obs.Tracer``; default a fresh enabled one (pass
        ``Tracer(enabled=False)`` to opt out; the tokens are the same).

        ``program_memory``: measure each program's memory at its warmup call
        (``obs.programs.measure_call``: argument and output bytes, and on
        the card the allocator's temp and peak watermarks); the
        ``programs`` section carries the static FLOPs and bytes either
        way.

        ``prefill_model`` / ``decode_model``: the models bucketed and
        chunked prefill and the decode step run (default ``model``), each
        ``model`` under its phase's execution profile
        (``Model.with_config``, over ``model``'s parameter tensors; built by
        ``launch.serve.build_engine``).

        ``mesh``: a (data, model) ``DeviceMesh`` (``launch.mesh.
        make_serve_mesh``) to serve over, SPMD (see the module's
        docstring); the engine then serves copies of ``model`` and its
        phase models whose parameters are DTensors, ``model`` itself keeps
        its tensors — or ``model`` as it is where its parameters are
        already DTensors on ``mesh`` in that layout
        (``launch.shardings.build_distributed_model``; another layout
        raises).  ``param_strategy``: the weights' layout on it — "tp"
        (the Mensa cluster templates), "dp" (replicated blocks) or "auto"
        (each block family by its cluster's ``sharding_axis`` in the
        plan); see ``launch.shardings.param_specs``.  ``layout_cfg``: the
        config whose flags decide that layout (default ``model.cfg``; the
        full config of a cut model, whose size turns on the 2-D split of
        the dense weights).

        ``cuda_graphs``: on a card and with no mesh, each program of the
        inventory runs as a CUDA graph captured at its first call (see the
        module's docstring); False runs each as its eager call, the
        counterpart of ``jax.disable_jit``, which the card's tests and
        ``chip_smoke.py`` hold the graphs to.  The CPU and a mesh always
        run the eager calls."""
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role {role!r} not in "
                             f"('both', 'prefill', 'decode')")
        if model.cfg.is_encdec:
            raise NotImplementedError(
                f"{model.cfg.name}: the engine serves decoder-only models "
                f"(the JAX engine serves no encoder-decoder either); drive "
                f"Model.encode, prefill(memory=) and decode_step(memory=)")
        if param_strategy not in ("tp", "dp", "auto"):
            raise ValueError(f"param_strategy {param_strategy!r} not in "
                             f"('tp', 'dp', 'auto')")
        self.role = role
        self.track_base = track_base
        self.tracer = tracer if tracer is not None else Tracer()
        self.device = model.device
        # per-phase models (Mensa: compute-centric prefill, memory-centric
        # decode), each over model's parameter tensors
        prefill_model = prefill_model or model
        decode_model = decode_model or model
        own = [id(p) for p in model.parameters()]
        for phase in (prefill_model, decode_model):
            if [id(p) for p in phase.parameters()] != own:
                raise ValueError("a phase model must share the engine "
                                 "model's parameter tensors "
                                 "(Model.with_config)")
        self.mesh = mesh
        self._nd = 1 if mesh is None else shard_lib.data_shards(mesh)
        self.slots = slots
        self.max_len = max_len
        if not buckets and policy is not None and policy.buckets:
            buckets = policy.buckets
        self.buckets = tuple(sorted(buckets)) if buckets \
            else prefill_buckets(max_len, min_bucket)
        if self.buckets[-1] > max_len:
            raise ValueError(f"bucket {self.buckets[-1]} > max_len {max_len}")
        self.max_prefill_per_step = max(1, max_prefill_per_step)
        # batch-bucket the admission group size, so a prefill runs at one of
        # a few batch shapes
        self.max_prefill_batch = max(1, min(max_prefill_batch, slots))
        self.batch_buckets = prefill_buckets(self.max_prefill_batch,
                                             min_bucket=1)
        if not prefill_chunk and policy is not None and policy.prefill_chunk:
            prefill_chunk = policy.prefill_chunk
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk \
            else self.buckets[-1]
        if not 1 <= self.prefill_chunk <= max_len:
            raise ValueError(f"prefill_chunk {self.prefill_chunk} outside "
                             f"[1, max_len {max_len}]")
        if policy is None:
            policy = fixed_plan(model.cfg, buckets=self.buckets,
                                prefill_chunk=self.prefill_chunk,
                                backend=self.device.type)
        self.policy = policy
        # a model built shard by shard (``build_distributed_model``) is
        # laid out already; any other layout raises
        if mesh is not None and not shard_lib.laid_out(
                model, mesh, param_strategy, plan=policy,
                layout_cfg=layout_cfg):
            model, prefill_model, decode_model = shard_lib.distribute_models(
                [model, prefill_model, decode_model], mesh, param_strategy,
                plan=policy, layout_cfg=layout_cfg)
        self.model = model
        self.prefill_model = prefill_model
        self.decode_model = decode_model
        self._param_strategy = param_strategy
        # utilization divides by the card's peak for the products' dtype
        self.programs = ProgramRegistry(
            chip=for_dtype(model.cfg.compute_dtype),
            plan_summary=self.policy.summary())
        self._program_memory = program_memory
        self.kv: PagedKVManager | None = None
        self._state_kw: dict = {}
        if kv_block_size is not None:
            blocks_per_slot = -(-max_len // kv_block_size)
            if kv_blocks is None:
                kv_blocks = slots * blocks_per_slot
            if kv_blocks < blocks_per_slot:
                # a pool smaller than one request's worst case could never
                # admit a long prompt: admission would requeue it forever
                raise ValueError(
                    f"kv_blocks {kv_blocks} < max_len/kv_block_size "
                    f"{blocks_per_slot}: the pool must cover at least one "
                    f"request's worst case")
            prefix_ok = all(kind == "attn" for kind in model.kinds)
            # the pool splits its blocks over the data axis only when the
            # stripes come out equal: the accounting mirrors that layout
            shards = self._nd if self._nd > 1 \
                and kv_blocks % self._nd == 0 else 1
            self.kv = PagedKVManager(slots=slots, max_len=max_len,
                                     block_size=kv_block_size,
                                     num_blocks=kv_blocks,
                                     prefix_cache=prefix_cache and prefix_ok,
                                     shards=shards)
            self._state_kw = dict(kv_block_size=kv_block_size,
                                  kv_blocks=kv_blocks)
        self.states = self._init_states()
        # the program table: (name, input shapes) -> entry (serve/graphs.py)
        self._table: dict[tuple, EagerProgram | GraphProgram] = {}
        self._graphed = cuda_graphs and mesh is None \
            and self.device.type == "cuda"
        # one memory pool for all of the engine's graphs (a new one only
        # after a refused capture) and one capture stream
        self._graph_pools: list = []
        self._graph_stream = None
        self.requests: list[Request | None] = [None] * slots
        self.positions = np.zeros(slots, np.int32)
        self.samp_temp = np.zeros(slots, np.float32)
        self.samp_topk = np.zeros(slots, np.int32)
        self.samp_topp = np.ones(slots, np.float32)
        self.samp_seed = np.zeros(slots, np.int64)
        self._queue: deque[Request] = deque()
        self._prefilling: dict[int, int] = {}   # slot -> prompt tokens consumed
        # prefill role: slots whose prefill finished, waiting for export by
        # the coordinator (their blocks stay pinned until release_handoff)
        self.ready: deque[int] = deque()
        self._bt_cache: torch.Tensor | None = None
        self._bt_version = -1
        pfx = "" if role == "both" else f"{role}/"
        self._ctr_prefix = pfx
        self._trk_req = track_base + TRACK_REQUESTS
        self.tracer.set_track(self._trk_req, f"{pfx}requests")
        for s in range(slots):
            self.tracer.set_track(self._slot_track(s), f"{pfx}slot {s}")
        self._trk_engine = track_base + 1 + slots
        self.tracer.set_track(self._trk_engine, f"{pfx}engine")
        # the state list's byte sizes are the per-slot footprint: paged K/V
        # belongs to the pool, everything else to the slots
        pool_bytes, state_bytes = _state_byte_stats(self.states)
        self._slot_state_bytes = state_bytes // slots
        if self.kv is not None:
            self.kv.set_block_bytes(pool_bytes // self.kv.pool.num_blocks)
        self.stats = EngineStats()
        self._init_kv_stats()

    # ------------------------------------------------------------- plumbing
    def _timed(self, name: str) -> Timed:
        """A Timed section on the tracer's clock (one shared timeline)."""
        return Timed(name, device=self.device, clock=self.tracer.clock)

    def _slot_track(self, slot: int) -> int:
        return self.track_base + 1 + slot

    # -------------------------------------------------------- program table
    def _program(self, name: str, body, *host, fresh: bool = False):
        """Program ``name`` on the host inputs ``host`` (numpy arrays, device
        tensors, or trees of them; None where the program takes none)
        through its table entry, keyed by (``name``, the inputs' shapes).
        A call whose key has no entry prepares one first — the JAX
        engine's compile: a CUDA graph of ``body`` on a card without a
        mesh, else its eager call.  ``body`` computes only from the tensors
        it is given (a graph replays what it did at the capture); on a
        mesh it takes the host inputs as they are.  ``fresh``: a graph's
        outputs are returned as copies (a suitcase outlives the next
        replay)."""
        key = (name, shapes(host))
        entry = self._table.get(key)
        if entry is None:
            if self._graphed and self._capturable(name):
                if not self._graph_pools:
                    self._graph_pools.append(torch.cuda.graph_pool_handle())
                    self._graph_stream = torch.cuda.Stream(self.device)
                try:
                    entry = GraphProgram(body, host, device=self.device,
                                         pool=self._graph_pools[-1],
                                         stream=self._graph_stream)
                except Exception:
                    # a refused capture leaves its pool marked as recording
                    # (torch's allocator): later captures take a new pool
                    self._graph_pools.append(torch.cuda.graph_pool_handle())
                    raise
            else:
                entry = self._eager_entry()
            self._table[key] = entry
        return entry(body, host, fresh)

    def _capturable(self, name: str) -> bool:
        """Whether program ``name`` can be one CUDA graph: not where its
        model takes the MoE's ``ragged`` route, whose group sizes cross to
        the host (``models/moe.py``).  No serving profile picks that route
        (``core/executor.py``); a model given it keeps the program eager on
        the card, as declared here, never as a fallback."""
        kind = name.split("[")[0]
        model = {"prefill": self.prefill_model, "chunk": self.prefill_model,
                 "decode": self.decode_model}.get(kind)
        return model is None or model.cfg.ffn_kind != "moe" \
            or model.cfg.moe_impl != "ragged"

    def _body(self, kind: str):
        """Program ``kind``'s body: ``_{kind}_program``, which takes device
        tensors (and which a graph captures), or on a mesh ``_{kind}_mesh``,
        the eager DTensor route, which takes the host inputs."""
        return getattr(self, f"_{kind}_"
                       + ("mesh" if self.mesh is not None else "program"))

    def _eager_entry(self) -> EagerProgram:
        """A program's eager call: on a mesh its body takes the host
        inputs, else their device copies."""
        return EagerProgram(self._device_input if self.mesh is None
                            else None)

    def _sync_compile_stats(self) -> None:
        """The table's entries as the reference's jit caches count them."""
        kinds = [name.split("[")[0] for name, _ in self._table]
        decode = sum(k in DECODE_PROGRAMS for k in kinds)
        self.stats.prefill_compiles = len(kinds) - decode
        self.stats.decode_compiles = decode

    def graph_report(self) -> dict:
        """The engine's CUDA graphs: how many, the seconds their first
        calls and captures took, and the bytes of their memory pool (the
        caching allocator's segments of that pool; None without a
        graph)."""
        entries = [e for e in self._table.values()
                   if isinstance(e, GraphProgram)]
        pool = None
        if self._graph_pools:
            pools = {tuple(p) for p in self._graph_pools}
            pool = sum(seg["total_size"]
                       for seg in torch.cuda.memory_snapshot()
                       if tuple(seg.get("segment_pool_id", ())) in pools)
        return {"graphs": len(entries),
                "capture_s": sum(e.capture_s for e in entries),
                "pool_bytes": pool}

    def _zero_states(self) -> None:
        """Every state tensor zeroed in place: the tensors a graph holds
        stay the engine's."""
        for st in self.states:
            for a in (st.kv if st.kv is not None else st.rec.values()):
                a.zero_()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)      # a copy, never a view

    def _device_input(self, a):
        """An eager program's input: a host array copied to the device, a
        device tensor as it is."""
        return self._tensor(a) if isinstance(a, np.ndarray) else a

    def _host_rows(self, a: np.ndarray | None) -> torch.Tensor | None:
        return None if a is None else self._rows(a)

    def _rows(self, a: np.ndarray) -> torch.Tensor:
        """A batch-major host input of a model call: on a mesh a DTensor
        every rank builds alike, its rows split over ``data`` when they
        split evenly (``shardings.batch_axis``), replicated otherwise."""
        t = self._tensor(a)
        if self.mesh is None:
            return t
        spec = (shard_lib.batch_axis(self.mesh, a.shape[0]),) \
            + (None,) * (a.ndim - 1)
        return shard_lib.local_part(t, self.mesh,
                                    shard_lib.to_placements(spec, self.mesh))

    @staticmethod
    def _full(t: torch.Tensor) -> torch.Tensor:
        """``t`` whole on every rank (a DTensor's ``full_tensor()``)."""
        return t.full_tensor() if spmd.is_dtensor(t) else t

    def _state_specs(self, batch: int) -> list[BlockState]:
        return shard_lib.serve_state_specs(self.model, self.mesh, batch,
                                           self.max_len, **self._state_kw)

    def _init_states(self) -> list[BlockState]:
        """Zeroed slot states (``Model.init_states``), on a mesh placed by
        ``serve_state_specs``."""
        states = self.model.init_states(self.slots, self.max_len,
                                        **self._state_kw)
        if self.mesh is None:
            return states
        return shard_lib.place_states(states, self._state_specs(self.slots),
                                      self.mesh)

    def _init_kv_stats(self) -> None:
        st = self.stats
        if self.kv is not None:
            st.kv_pool_blocks = self.kv.pool.num_blocks
            st.kv_block_size = self.kv.block_size
            st.kv_shards = self.kv.shards
        st.placement = self.policy.summary()
        st.programs = self.programs
        # static memory gauges (the per-tick ones update in _tick_counters)
        st.metrics.gauge("slot_state_bytes", "bytes").set(
            self._slot_state_bytes)
        if self.kv is not None:
            st.metrics.gauge("kv_pool_capacity_bytes", "bytes").set(
                self.kv.pool.num_blocks * self.kv.block_bytes)
        tmp = self.programs.temp_bytes_peak()
        if tmp:
            st.metrics.gauge("program_temp_bytes_peak", "bytes").set(tmp)

    def reset_stats(self) -> None:
        self.stats = EngineStats()
        if self.kv is not None:
            self.kv.reset_stats()
        self.programs.reset_observed()
        self._init_kv_stats()
        self._sync_compile_stats()
        self._sync_kv_stats()

    def _sync_kv_stats(self) -> None:
        st, mgr = self.stats, self.kv
        if mgr is None:
            return
        st.kv_blocks_in_use = mgr.in_use
        st.kv_in_use_per_shard = mgr.in_use_by_shard
        # the pool keeps its high-water mark at alloc/retain time, so the
        # peak sees blocks allocated and released within one tick; the
        # per-shard snapshot is the split AT that peak, so it sums to it
        if mgr.pool.peak_in_use >= st.kv_blocks_peak:
            st.kv_peak_per_shard = mgr.peak_by_shard
        st.kv_blocks_peak = max(st.kv_blocks_peak, mgr.pool.peak_in_use)
        st.kv_blocks_cached = mgr.cached
        st.prefix_queries = mgr.stats.prefix_queries
        st.prefix_hits = mgr.stats.prefix_hits
        st.prefix_tokens_reused = mgr.stats.prefix_tokens_reused
        st.blocks_copied = mgr.stats.blocks_copied
        st.blocks_evicted = mgr.blocks_evicted

    def _tick_counters(self, ts: float, busy: int) -> None:
        """Per-tick counter-track samples (queue depth, slot occupancy,
        paged pool in use / cached, state bytes) and the memory gauges,
        which update untraced too."""
        m = self.stats.metrics
        state_bytes = busy * self._slot_state_bytes
        m.gauge("active_state_bytes", "bytes").set(state_bytes)
        if self.kv is not None:
            m.gauge("kv_pool_bytes", "bytes").set(self.kv.bytes_in_use)
            m.gauge("kv_pool_bytes_peak", "bytes").set(self.kv.bytes_peak)
        tr, p = self.tracer, self._ctr_prefix
        if not tr.enabled:
            return
        tr.counter(p + "queue_depth", ts, (("queued", len(self._queue)),))
        tr.counter(p + "slots", ts, (("busy", busy),
                                     ("free", self.slots - busy)))
        series = [("slot_state", state_bytes)]
        if self.kv is not None:
            tr.counter(p + "kv_blocks", ts, (("in_use", self.kv.in_use),
                                             ("cached", self.kv.cached)))
            if self.kv.shards > 1:
                tr.counter(p + "kv_in_use_by_shard", ts, tuple(
                    (f"shard{i}", v)
                    for i, v in enumerate(self.kv.in_use_by_shard)))
            series.append(("kv_pool", self.kv.bytes_in_use))
        tr.counter(p + "device_memory_bytes", ts, tuple(series))

    def save_trace(self, path) -> None:
        """Write the Chrome trace-event JSON of everything traced so far,
        with the summary's placement section (plan, measured, drift), the
        metrics registry and the programs section under ``otherData``."""
        summary = self.stats.summary()
        other = {"obs": summary["obs"]}
        if "placement" in summary:
            other["placement"] = summary["placement"]
        if "programs" in summary:
            other["programs"] = summary["programs"]
        self.tracer.save(path, other_data=other)

    def _sample(self, logits: torch.Tensor, slot_ids: list[int],
                positions) -> list[int]:
        """Sample one token per row of ``logits`` (R,V), whole on every
        rank, with the sampling knobs of ``slot_ids`` (one per row) at
        ``positions``."""
        self.stats.nonfinite_logits += int(
            (~torch.isfinite(logits)).any(dim=-1).sum())
        toks = sample_tokens(logits, self.samp_temp[slot_ids],
                             self.samp_topk[slot_ids],
                             self.samp_topp[slot_ids],
                             self.samp_seed[slot_ids], positions)
        return toks.tolist()

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        check_request(req, self.max_len)
        req.t_submit = self.tracer.now()
        self.tracer.instant("submit", self._trk_req, req.t_submit,
                            (("rid", req.rid),
                             ("prompt_tokens", len(req.prompt))))
        self._queue.append(req)

    def _set_sampling(self, slot: int, req: Request) -> None:
        self.samp_temp[slot] = req.temperature
        self.samp_topk[slot] = req.top_k
        self.samp_topp[slot] = req.top_p
        self.samp_seed[slot] = req.seed if req.seed is not None \
            else req.rid & 0x7FFFFFFF

    def _admit(self, budget: int) -> int:
        free = [s for s in range(self.slots) if self.requests[s] is None]
        take = min(budget, len(free), len(self._queue))
        if take <= 0:
            return 0
        groups: dict[int, list[tuple[int, Request]]] = {}
        admitted = 0
        while admitted < take:
            req = self._queue[0]
            slot = free[0]
            matched = 0
            copy = None
            if self.kv is not None:
                plan = self.kv.admit(slot, req.prompt)
                if plan is None:
                    # pool can't cover the prompt yet: keep FIFO order and
                    # retry next tick (decode frees blocks as requests end)
                    break
                matched = plan.matched_tokens
                copy = plan.copy
            self._queue.popleft()
            free.pop(0)
            self.requests[slot] = req
            self._set_sampling(slot, req)
            now = self.tracer.now()
            self.tracer.begin(f"req {req.rid}", self._slot_track(slot), now,
                              (("rid", req.rid),
                               ("prompt_tokens", len(req.prompt)),
                               ("prefix_hit_tokens", matched),
                               ("queue_wait_s", round(now - req.t_submit, 6))))
            if copy is not None:
                self.tracer.instant("cow_copy", self._slot_track(slot), now,
                                    (("rid", req.rid), ("src", copy[0]),
                                     ("dst", copy[1])))
                self._run_copy(*copy)
            admitted += 1
            if matched > 0 or len(req.prompt) > self.buckets[-1]:
                # chunked path: long prompts, and prefix-cache hits of any
                # length (the hit resumes prefill at offset=matched)
                self._prefilling[slot] = matched
                self._advance_chunk(slot)
            else:
                b = bucket_for(len(req.prompt), self.buckets)
                groups.setdefault(b, []).append((slot, req))
        for b in sorted(groups):
            members = groups[b]
            for i in range(0, len(members), self.max_prefill_batch):
                self._prefill_group(b, members[i:i + self.max_prefill_batch])
        self._sync_kv_stats()
        return admitted

    def _copy_program(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """The ``copy`` program: clone physical block ``src`` (1,) into
        ``dst`` (1,) in every layer's pool — the copy-on-write step of a
        partial-block prefix hit."""
        for st in self.states:
            if isinstance(st.kv, PagedKVCache):
                for pool in (st.kv.k, st.kv.v):
                    pool.index_copy_(0, dst, pool.index_select(0, src))

    def _copy_mesh(self, src: np.ndarray, dst: np.ndarray) -> None:
        for st in self.states:
            if isinstance(st.kv, PagedKVCache):
                for pool in (st.kv.k, st.kv.v):
                    sharded.copy_block(pool, int(src[0]), int(dst[0]))

    def _run_copy(self, src: int, dst: int) -> None:
        with self._timed("kv_copy") as tm:
            self._program("copy", self._body("copy"),
                          np.asarray([src], np.int64),
                          np.asarray([dst], np.int64))
            tm.sync()
        self.programs.observe("copy", tm.dur, phase="kv", program="_copy")
        self.tracer.span("kv_copy", self._trk_engine, tm.t0, tm.t1,
                         (("src", src), ("dst", dst)))

    def _tables_for(self, slot_ids: list[int],
                    rows: int) -> np.ndarray | None:
        """(rows, blocks_per_slot) block-table rows for the given slots;
        rows beyond ``slot_ids`` are all-sentinel, so their writes drop.
        None without a paged pool."""
        if self.kv is None:
            return None
        bt = np.full((rows, self.kv.blocks_per_slot), self.kv.sentinel,
                     np.int32)
        for i, s in enumerate(slot_ids):
            bt[i] = self.kv.table[s]
        return bt

    # ------------------------------------------------- fresh prefill states
    def _fresh_states(self, n: int) -> list[BlockState]:
        """Zeroed batch-``n`` states for a prefill group; paged layers adopt
        the live pool (global blocks) with zero lengths
        (``repro.serve.engine._adopt_pool_kv``).  Inside a graph these are
        buffers of its pool that each replay zeroes first."""
        out = []
        for i, st in enumerate(self.states):
            if isinstance(st.kv, PagedKVCache):
                length = torch.zeros((n,), dtype=torch.int32,
                                     device=self.device) \
                    if self.mesh is None \
                    else self._rows(np.zeros((n,), np.int32))
                out.append(BlockState(kv=PagedKVCache(st.kv.k, st.kv.v,
                                                      length)))
            else:
                out.append(self.prefill_model.init_block_state(
                    i, n, self.max_len))
        if self.mesh is None:
            return out
        specs = self._state_specs(n)
        return [st if isinstance(st.kv, PagedKVCache)
                else shard_lib.place_states([st], [sp], self.mesh)[0]
                for st, sp in zip(out, specs)]

    # -------------------------------------------------------------- prefill
    def _prefill_program(self, toks, lens, slot_ids, keep, table):
        """The ``prefill[{nb}x{b}]`` program: the padded (nb, b) prefill
        on fresh states, each kept row spliced into its slot
        (``slot_ids``: nb distinct slots); returns the logits (nb, 1, V)."""
        logits, rows = self.prefill_model.prefill(
            toks, self._fresh_states(toks.shape[0]), length=lens,
            block_table=table)
        _splice_rows(self.states, rows, slot_ids, keep)
        return logits

    def _prefill_mesh(self, toks, lens, slot_ids, keep, table):
        logits, rows = self.prefill_model.prefill(
            self._rows(toks), self._fresh_states(toks.shape[0]),
            length=self._rows(lens), block_table=self._host_rows(table))
        if keep.any():
            _splice_states(self.states, rows, slot_ids[keep].tolist())
        return self._full(logits)

    def _prefill_group(self, bucket: int, members: list) -> None:
        n = len(members)
        nb = bucket_for(n, self.batch_buckets)
        toks = np.zeros((nb, bucket), np.int64)
        lens = np.ones((nb,), np.int32)
        for i, (_, req) in enumerate(members):
            toks[i, :len(req.prompt)] = req.prompt
            lens[i] = len(req.prompt)
        slots_real = [slot for slot, _ in members]
        # padding rows name slots outside the group, which the splice
        # rewrites with their own bits: the nb slots of a splice are distinct
        others = [s for s in range(self.slots) if s not in slots_real]
        slot_ids = np.asarray(slots_real + others[:nb - n], np.int64)
        keep = np.arange(nb) < n
        with self._timed("prefill") as tm:
            logits = self._program(
                f"prefill[{nb}x{bucket}]", self._body("prefill"), toks, lens,
                slot_ids, keep, self._tables_for(slots_real, nb))
            first = self._sample(logits[:n, 0], slots_real, lens[:n])
            tm.sync()
        now = tm.t1
        st = self.stats
        st.prefill_calls += 1
        st.prefill_time_s += tm.dur
        self.programs.observe(f"prefill[{nb}x{bucket}]", tm.dur,
                              phase="prefill", program="_prefill")
        st.batch_counts[n] = st.batch_counts.get(n, 0) + 1
        waste = st.metrics.counter("prefill_waste_tokens", "tokens")
        for i, (slot, req) in enumerate(members):
            tok = first[i]
            self.positions[slot] = len(req.prompt)
            req.generated.append(tok)
            req.t_first_token = now
            st.prefills += 1
            st.prefill_prompt_tokens += len(req.prompt)
            st.prefill_tokens_computed += len(req.prompt)
            st.prefill_padded_tokens += bucket
            waste.inc(bucket - len(req.prompt))
            self.tracer.span("prefill", self._slot_track(slot), tm.t0, tm.t1,
                             (("rid", req.rid), ("bucket", bucket),
                              ("rows", n)))
            st.record_ttft(now - req.t_submit)
            st.bucket_counts[bucket] = st.bucket_counts.get(bucket, 0) + 1
            if self.kv is not None:
                self.kv.publish(slot, req.prompt)
            if len(req.generated) >= req.max_new_tokens or tok == req.eos_id:
                self._finish(slot, now)
            elif self.role == "prefill":
                self._stage_ready(slot, now)

    def _chunk_program(self, toks, lens, offs, slot, keep, table):
        """The ``chunk`` program: the (1, C) chunk resumed at ``offs`` on a
        batch-1 copy of slot ``slot`` (1,), spliced back where ``keep``;
        returns the logits (1, 1, V)."""
        logits, row = self.prefill_model.prefill(
            toks, _gather_rows(self.states, slot), length=lens, offset=offs,
            block_table=table)
        _splice_rows(self.states, row, slot, keep)
        return logits

    def _chunk_mesh(self, toks, lens, offs, slot, keep, table):
        logits, row = self.prefill_model.prefill(
            self._rows(toks), _gather_slot(self.states, int(slot[0])),
            length=self._rows(lens), offset=self._rows(offs),
            block_table=self._host_rows(table))
        if keep[0]:
            _splice_states(self.states, row, [int(slot[0])])
        return self._full(logits)

    def _advance_chunk(self, slot: int) -> None:
        req = self.requests[slot]
        off = self._prefilling[slot]
        c = self.prefill_chunk
        piece = req.prompt[off:off + c]
        n = len(piece)
        toks = np.zeros((1, c), np.int64)
        toks[0, :n] = piece
        with self._timed("prefill_chunk") as tm:
            logits = self._program(
                "chunk", self._body("chunk"), toks, np.asarray([n], np.int32),
                np.asarray([off], np.int32), np.asarray([slot], np.int64),
                np.ones((1,), bool), self._tables_for([slot], 1))
            done = off + n >= len(req.prompt)
            # only the final chunk's sampled token is used
            tok = self._sample(logits[:, -1], [slot], [off + n])[0] \
                if done else None
            tm.sync()
        st = self.stats
        st.prefill_chunks += 1
        st.prefill_padded_tokens += c
        st.prefill_tokens_computed += n
        st.prefill_time_s += tm.dur
        self.programs.observe("chunk", tm.dur, phase="prefill",
                              program="_chunk")
        st.metrics.counter("prefill_waste_tokens", "tokens").inc(c - n)
        self.tracer.span("prefill_chunk", self._slot_track(slot),
                         tm.t0, tm.t1,
                         (("rid", req.rid), ("offset", off), ("n", n)))
        if not done:
            self._prefilling[slot] = off + n
            return
        now = tm.t1
        del self._prefilling[slot]
        self.positions[slot] = len(req.prompt)
        req.generated.append(tok)
        req.t_first_token = now
        st.prefills += 1
        st.prefills_chunked += 1
        st.prefill_prompt_tokens += len(req.prompt)
        st.record_ttft(now - req.t_submit)
        if self.kv is not None:
            self.kv.publish(slot, req.prompt)
        if len(req.generated) >= req.max_new_tokens or tok == req.eos_id:
            self._finish(slot, now)
        elif self.role == "prefill":
            self._stage_ready(slot, now)

    def _finish(self, slot: int, now: float) -> None:
        req = self.requests[slot]
        req.done = True
        req.aborted = False
        req.t_done = now
        self.tracer.end(f"req {req.rid}", self._slot_track(slot), now,
                        (("rid", req.rid), ("tokens", len(req.generated))))
        self.requests[slot] = None
        if self.kv is not None:
            # publish only the written prefix: the last sampled token was
            # never fed back through decode, so its KV was never written
            self.kv.finish(slot, req.prompt + req.generated[:-1])
        self.stats.requests_completed += 1
        self.stats.tokens_generated += len(req.generated)

    # --------------------------------------------------------------- handoff
    def _export_program(self, slot, idx) -> list[BlockState]:
        """The ``export`` program: slot ``slot`` (1,) packed into a
        self-contained suitcase (``repro.serve.engine._export_slot``): its
        batch-1 state row and, for each paged layer, copies of the blocks
        ``idx`` names (its table row clipped to the pool: a sentinel entry
        copies some block, whose contents the import drops).  The
        suitcase's shape depends on blocks-per-slot only, so it travels
        between pools of any size; it holds no view of this pool, which may
        hand the blocks to another prompt while the suitcase waits."""
        row = _gather_rows(self.states, slot)
        if idx is None:
            return row
        return [BlockState(kv=PagedKVCache(st.kv.k.index_select(0, idx),
                                           st.kv.v.index_select(0, idx),
                                           st.kv.length))
                if isinstance(st.kv, PagedKVCache) else st for st in row]

    def _export_mesh(self, slot, table_row) -> list[BlockState]:
        row = _gather_slot(self.states, int(slot[0]))
        if table_row is None:
            return row
        ids = table_row.tolist()
        return [BlockState(kv=PagedKVCache(
            sharded.read_blocks(st.kv.k, ids),
            sharded.read_blocks(st.kv.v, ids), st.kv.length))
            if isinstance(st.kv, PagedKVCache) else st for st in row]

    def _export_call(self, slot: int, table_row: list[int] | None):
        """(body, host inputs) of the export program for ``slot``."""
        trow = None if table_row is None else np.asarray(table_row, np.int64)
        if self.mesh is not None:
            return self._export_mesh, (np.asarray([slot], np.int64), trow)
        if trow is not None:
            trow = np.clip(trow, 0, self.kv.pool.num_blocks - 1)
        return self._export_program, (np.asarray([slot], np.int64), trow)

    def _export_slot(self, slot: int,
                     table_row: list[int] | None) -> list[BlockState]:
        """Slot ``slot``'s suitcase through ``table_row``, made eagerly
        outside the program table (the decode role's own warm suitcase, as
        the reference makes it)."""
        body, host = self._export_call(slot, table_row)
        return self._eager_entry()(body, host)

    def _import_program(self, suitcase, slot, src, dst, blocks, keep):
        """The ``import`` program: a visiting suitcase unpacked into slot
        ``slot`` (1,) (``repro.serve.engine._import_slot``), IN PLACE — its
        blocks ``src`` into the pool rows ``dst`` where ``blocks``, then
        its batch-1 row spliced where ``keep``.  ``_import_call`` aims
        every sentinel entry at the first kept one's pair (or, with none,
        every entry at block 0, rewritten with its own bits), so duplicate
        writes carry identical bits and the suitcase's padded tail changes
        no pool row, where the reference drops the write
        (``mode="drop"``)."""
        if src is not None:
            for st, new in zip(self.states, suitcase):
                if isinstance(st.kv, PagedKVCache):
                    for pool, got in ((st.kv.k, new.kv.k),
                                      (st.kv.v, new.kv.v)):
                        mask = blocks.view(-1, *[1] * (pool.dim() - 1))
                        pool.index_copy_(0, dst, torch.where(
                            mask, got.index_select(0, src).to(pool.dtype),
                            pool.index_select(0, dst)))
        _splice_rows(self.states, suitcase, slot, keep)

    def _import_mesh(self, suitcase, slot, table_row):
        if table_row is not None:
            ids = table_row.tolist()
            for st, new in zip(self.states, suitcase):
                if isinstance(st.kv, PagedKVCache):
                    sharded.write_blocks(st.kv.k, ids, new.kv.k)
                    sharded.write_blocks(st.kv.v, ids, new.kv.v)
        _splice_states(self.states, suitcase, [int(slot[0])])

    def _import_call(self, suitcase, slot: int,
                     table_row: list[int] | None):
        """(body, host inputs) of the import program into ``slot``."""
        one = np.asarray([slot], np.int64)
        if self.mesh is not None:
            trow = None if table_row is None \
                else np.asarray(table_row, np.int64)
            return self._import_mesh, (suitcase, one, trow)
        src = dst = blocks = None
        if self.kv is not None:
            trow = np.asarray(table_row, np.int64)
            kept = np.flatnonzero(trow < self.kv.pool.num_blocks)
            first = kept[0] if kept.size else 0
            src = np.where(trow < self.kv.pool.num_blocks,
                           np.arange(trow.size), first)
            dst = np.where(trow < self.kv.pool.num_blocks, trow,
                           trow[first] if kept.size else 0)
            blocks = np.asarray([kept.size > 0])
        return self._import_program, (suitcase, one, src, dst, blocks,
                                      np.ones((1,), bool))

    def _import_slot(self, suitcase: list[BlockState], slot: int,
                     table_row: list[int] | None) -> None:
        """Unpack ``suitcase`` into slot ``slot`` through ``table_row``,
        eagerly, outside the program table."""
        body, host = self._import_call(suitcase, slot, table_row)
        self._eager_entry()(body, host)

    def _stage_ready(self, slot: int, now: float) -> None:
        """Prefill role: the slot's prompt is prefilled and its first token
        sampled — park it on ``ready`` for the coordinator.  The slot keeps
        its blocks until :meth:`release_handoff`; the prompt is already
        published, so later same-prefix admissions hit it."""
        self.ready.append(slot)
        self.tracer.instant("prefill_done", self._slot_track(slot), now,
                            (("rid", self.requests[slot].rid),))

    def export_slot(self, slot: int) -> list[BlockState]:
        """Prefill role: the suitcase of a ready slot."""
        req = self.requests[slot]
        trow = list(self.kv.table[slot]) if self.kv is not None else None
        body, host = self._export_call(slot, trow)
        with self._timed("handoff_export") as tm:
            out = self._program("export", body, *host, fresh=True)
            tm.sync()
        st = self.stats
        st.handoffs += 1
        st.handoff_time_s += tm.dur
        self.programs.observe("export", tm.dur, phase="handoff",
                              program="_export")
        self.tracer.span("handoff_export", self._slot_track(slot),
                         tm.t0, tm.t1, (("rid", req.rid),))
        return out

    def release_handoff(self, slot: int) -> None:
        """Prefill role: the suitcase left — free the slot and its block
        references (the prefix tree keeps the published blocks cached)."""
        req = self.requests[slot]
        now = self.tracer.now()
        self.tracer.end(f"req {req.rid}", self._slot_track(slot), now,
                        (("rid", req.rid), ("handoff", 1)))
        self.requests[slot] = None
        if self.kv is not None:
            self.kv.release(slot)
        self._sync_kv_stats()

    def stage_in(self, suitcase: list[BlockState]) -> list[BlockState]:
        """Decode role: land a visiting suitcase on this engine's device.
        Both roles share the one device, so it passes through (a suitcase
        from another role's ranks lands in ``DisaggEngine``'s handoff)."""
        return suitcase

    def adopt(self, req: Request, suitcase: list[BlockState],
              n_tokens: int) -> int | None:
        """Decode role: admit a finished prefill from the peer engine — take
        a free slot, map fresh blocks for its ``n_tokens`` written positions
        (``PagedKVManager.adopt``), import the suitcase into them, and decode
        on from ``req.generated[-1]``.  Returns the slot, or None — having
        touched nothing but the stall counter — when no slot or no blocks
        are free (the coordinator retries next tick)."""
        free = [s for s in range(self.slots) if self.requests[s] is None]
        if not free:
            self.stats.handoff_stalls += 1
            return None
        slot = free[0]
        if self.kv is not None and not self.kv.adopt(slot, n_tokens):
            self.stats.handoff_stalls += 1
            return None
        trow = list(self.kv.table[slot]) if self.kv is not None else None
        body, host = self._import_call(suitcase, slot, trow)
        with self._timed("handoff_import") as tm:
            self._program("import", body, *host)
            tm.sync()
        st = self.stats
        st.handoffs += 1
        st.handoff_time_s += tm.dur
        self.programs.observe("import", tm.dur, phase="handoff",
                              program="_import")
        self.requests[slot] = req
        self.positions[slot] = n_tokens
        self._set_sampling(slot, req)
        now = tm.t1
        self.tracer.begin(f"req {req.rid}", self._slot_track(slot), now,
                          (("rid", req.rid),
                           ("prompt_tokens", len(req.prompt))))
        self.tracer.instant(
            "handoff", self._slot_track(slot), now,
            (("rid", req.rid), ("tokens", n_tokens),
             ("blocks", self.kv.owned[slot] if self.kv is not None else 0)))
        self._sync_kv_stats()
        return slot

    # ---------------------------------------------------------------- warmup
    def _warm_table(self, rows: int) -> np.ndarray | None:
        """All-sentinel block tables: warmup calls drop every paged write."""
        if self.kv is None:
            return None
        return np.full((rows, self.kv.blocks_per_slot), self.kv.sentinel,
                       np.int32)

    def _warm_program(self, name: str, geometry: dict, body, *host,
                      fresh: bool = False):
        """Register program ``name`` with the static cost of its kind (the
        name up to ``[``) at ``geometry``, under the reference's phase and
        ``program`` string, then make its warmup call through the program
        table (``_program(name, body, *host)``, which prepares its entry)
        — measured with ``program_memory`` — and return what the call
        returns."""
        kind = name.split("[")[0]
        if self.kv is not None:
            geometry = dict(geometry, kv_block_size=self.kv.block_size)
        cfg = {"prefill": self.prefill_model, "chunk": self.prefill_model,
               "decode": self.decode_model}.get(kind, self.model).cfg
        if self.mesh is not None:
            # the work of this rank's card: its rows and its widths
            if "batch" in geometry \
                    and shard_lib.batch_axis(self.mesh, geometry["batch"]):
                geometry = dict(geometry,
                                batch=geometry["batch"] // self._nd)
            cfg = shard_lib.local_config(cfg, self.mesh,
                                         self._param_strategy, self.policy)
        e = self.programs.register(
            name, program_cost(cfg, kind, max_len=self.max_len,
                               **geometry),
            phase=PROGRAM_PHASES[kind], program="_" + kind)
        if not self._program_memory:
            return self._program(name, body, *host, fresh=fresh)
        out, e.memory = measure_call(self._program, (name, body, *host),
                                     dict(fresh=fresh),
                                     params=self.model.parameters())
        return out

    def warmup(self, suitcase: list[BlockState] | None = None):
        """Run every shape the engine can serve once — each (batch-bucket,
        bucket) prefill on fresh states, the chunk continuation on a copy of
        slot 0, the block clone (paged) and the decode step with every row
        frozen — then reset the states.  Builds the kernels and warms the
        allocator so the first request is not charged for them.  A role
        engine runs only its own half: the prefill role no decode step, the
        decode role neither prefill nor block clone; each then its half of
        the handoff (``_warm_handoff``, which takes ``suitcase`` and gives
        what this method returns).  Each program registers in
        ``self.programs`` right before its call, at the call's shape."""
        if self._queue or self._prefilling \
                or any(r is not None for r in self.requests):
            raise RuntimeError("warmup() requires an idle engine")
        zeros = lambda rows, dt=np.int32: np.zeros(   # noqa: E731
            (rows,), dt)
        tokens = lambda rows, n: np.zeros(             # noqa: E731
            (rows, n), np.int64)
        ones = lambda rows: np.ones((rows,), np.int32)  # noqa: E731
        warm = self._warm_program
        with self._timed("warmup") as tm:
            if self.role != "decode":
                for b in self.buckets:
                    for nb in self.batch_buckets:
                        warm(f"prefill[{nb}x{b}]", dict(batch=nb, seq=b),
                             self._body("prefill"), tokens(nb, b),
                             ones(nb), np.arange(nb, dtype=np.int64),
                             zeros(nb, bool), self._warm_table(nb))
                if self.max_len - 1 > self.buckets[-1] \
                        or (self.kv is not None and self.kv.prefix_enabled):
                    warm("chunk", dict(seq=self.prefill_chunk),
                         self._body("chunk"), tokens(1, self.prefill_chunk),
                         ones(1), zeros(1), zeros(1, np.int64),
                         zeros(1, bool), self._warm_table(1))
                if self.kv is not None:
                    warm("copy", {}, self._body("copy"), zeros(1, np.int64),
                         zeros(1, np.int64))
            if self.role != "prefill":
                warm("decode", dict(batch=self.slots), self._body("decode"),
                     tokens(self.slots, 1), zeros(self.slots),
                     zeros(self.slots, bool),
                     self._host_rows(self._warm_table(self.slots)))
            exported = self._warm_handoff(suitcase)
            self._zero_states()
            tm.sync()
        self.tracer.span("warmup", self._trk_engine, tm.t0, tm.t1)
        if self.kv is not None:
            # the pool was just re-zeroed: drop every prefix that described it
            self.kv.clear()
        self.positions[:] = 0
        self._sync_compile_stats()
        tmp = self.programs.temp_bytes_peak()
        if tmp:
            self.stats.metrics.gauge("program_temp_bytes_peak",
                                     "bytes").set(tmp)
            if self.tracer.enabled:
                self.tracer.counter(self._ctr_prefix + "program_temp_bytes",
                                    tm.t1, (("peak", tmp),))
        return exported

    def _warm_handoff(self, suitcase: list[BlockState] | None = None):
        """A role engine's half of the handoff
        (``repro.serve.engine._warm_handoff``): the prefill role exports slot
        0 through an all-sentinel table row and returns the suitcase; the
        decode role imports ``suitcase`` (by default one made from its own
        idle states; ``DisaggEngine`` passes the prefill role's warm export
        when the roles are on ranks of their own) into slot 0 through an
        all-sentinel row, so every block write drops.  ``warmup``
        zeroes the states right after."""
        if self.role == "both":
            return None
        trow = [self.kv.sentinel] * self.kv.blocks_per_slot \
            if self.kv is not None else None
        if self.role == "prefill":
            body, host = self._export_call(0, trow)
            return self._warm_program("export", {}, body, *host, fresh=True)
        if suitcase is None:
            suitcase = self.stage_in(self._export_slot(0, trow))
        body, host = self._import_call(suitcase, 0, trow)
        self._warm_program("import", {}, body, *host)
        return None

    # ---------------------------------------------------------------- decode
    def _decode_table(self) -> torch.Tensor | None:
        """The device copy of the full block table (a DTensor on a mesh),
        rebuilt only when admission, extension or retirement changed it
        (None when dense).  A graph copies it into its own buffer on the
        card at each replay."""
        if self.kv is None:
            return None
        if self._bt_cache is None or self._bt_version != self.kv.version:
            self._bt_cache = self._rows(np.asarray(self.kv.table, np.int32))
            self._bt_version = self.kv.version
        return self._bt_cache

    def _decode_program(self, toks, positions, active, table):
        """The ``decode`` program: one lockstep step over the slot pool,
        every state leaf the model returns anew copied back into the
        engine's; returns the logits (slots, 1, V)."""
        logits, states = self.decode_model.decode_step(
            toks, self.states, positions, active=active, block_table=table)
        _write_back(self.states, states)
        return logits

    def _decode_mesh(self, toks, positions, active, table):
        logits, self.states = self.decode_model.decode_step(
            self._rows(toks), self.states, self._rows(positions),
            active=self._rows(active), block_table=table)
        return self._full(logits)

    def step(self) -> None:
        """One engine tick: advance each in-flight chunked prefill by one
        chunk, admit up to ``max_prefill_per_step`` queued requests, then one
        lockstep decode step over the decoding slots.  With a paged pool each
        slot's table is extended before its write; a slot the pool cannot
        extend stalls.  The decode role neither advances chunks nor admits;
        the prefill role never decodes (its ready slots wait for export)."""
        t_tick = self.tracer.now()
        if self.role != "decode":
            for slot in list(self._prefilling):
                self._advance_chunk(slot)
            self._admit(self.max_prefill_per_step)
        busy = [i for i, r in enumerate(self.requests) if r is not None]
        active = [] if self.role == "prefill" \
            else [i for i in busy if i not in self._prefilling]
        if self.kv is not None and active:
            ok = []
            for i in active:
                # the write this tick lands at position[i]: the table must
                # cover position[i] + 1 tokens
                if self.kv.extend(i, int(self.positions[i]) + 1):
                    ok.append(i)
                else:
                    self.stats.decode_stalls += 1
                    self.tracer.instant(
                        "stall", self._slot_track(i), self.tracer.now(),
                        (("rid", self.requests[i].rid),))
            if not ok and not self._prefilling:
                raise RuntimeError(
                    f"KV pool exhausted: {self.kv.in_use} of "
                    f"{self.kv.pool.num_blocks} blocks referenced, every "
                    f"active slot stalled and nothing can retire — size the "
                    f"pool for at least one request's worst case "
                    f"(kv_blocks >= max_len / kv_block_size)")
            active = ok
        self.stats.ticks += 1
        self.stats.occupancy_sum += len(busy) / self.slots
        if not active:
            self._sync_compile_stats()
            self._sync_kv_stats()
            self.stats.kv_occupancy_sum += self._kv_occupancy()
            now = self.tracer.now()
            self._tick_counters(now, len(busy))
            self.stats.wall_time_s += now - t_tick
            return
        toks = np.zeros((self.slots, 1), np.int64)
        mask = np.zeros((self.slots,), bool)
        for i in active:
            mask[i] = True
            req = self.requests[i]
            toks[i, 0] = req.generated[-1] if req.generated \
                else req.prompt[-1]
        with self._timed("decode") as tm:
            logits = self._program(
                "decode", self._body("decode"), toks, self.positions, mask,
                self._decode_table())
            rows = self._tensor(np.asarray(active, np.int64))
            nxt = self._sample(logits[:, 0].index_select(0, rows), active,
                               self.positions[active] + 1)
            tm.sync()
        now = tm.t1
        m = self.stats.metrics
        self.stats.decode_steps += 1
        self.stats.decode_time_s += tm.dur
        self.programs.observe("decode", tm.dur, phase="decode",
                              program="_decode")
        m.histogram("decode_tick_s").record(tm.dur)
        m.histogram("tokens_per_tick", base=1.0,
                    unit="tokens").record(len(active))
        self.tracer.span("decode", self._trk_engine, tm.t0, tm.t1,
                         (("active", len(active)),))
        for i, tok in zip(active, nxt):
            req = self.requests[i]
            self.positions[i] += 1
            req.generated.append(tok)
            if (len(req.generated) >= req.max_new_tokens
                    or tok == req.eos_id
                    or self.positions[i] >= self.max_len - 1):
                self._finish(i, now)
        self._sync_compile_stats()
        self._sync_kv_stats()
        self.stats.kv_occupancy_sum += self._kv_occupancy()
        end = self.tracer.now()
        # time between tokens as a running slot sees it: the whole tick,
        # chunks and admissions included
        m.histogram("decode_tbt_s").record(end - t_tick)
        self._tick_counters(end, sum(r is not None for r in self.requests))
        self.stats.wall_time_s += end - t_tick

    def _kv_occupancy(self) -> float:
        return self.kv.in_use / self.kv.pool.num_blocks \
            if self.kv is not None else 0.0

    def run(self, requests: list[Request], max_steps: int = 10_000,
            on_truncate: str = "warn") -> list[Request]:
        """Serve ``requests`` to completion (or ``max_steps`` ticks).
        ``on_truncate``: "warn" (default), "raise" or "ignore" when work is
        still in flight at ``max_steps``; survivors are marked aborted."""
        if on_truncate not in ("warn", "raise", "ignore"):
            raise ValueError(f"on_truncate {on_truncate!r} not in "
                             f"('warn', 'raise', 'ignore')")
        for r in requests:
            self.submit(r)
        steps = 0
        while (self._queue or any(r is not None for r in self.requests)) \
                and steps < max_steps:
            self.step()
            steps += 1
        leftovers = [r for r in self.requests if r is not None] \
            + list(self._queue)
        if leftovers:
            self.stats.requests_aborted += sum(
                1 for r in leftovers if not r.aborted)
            t_abort = self.tracer.now()
            for r in leftovers:
                if not r.aborted:
                    self.tracer.instant("abort", self._trk_req, t_abort,
                                        (("rid", r.rid),))
                r.aborted = True
            msg = (f"run() exhausted max_steps={max_steps} with "
                   f"{len(leftovers)} unfinished requests "
                   f"(rids {[r.rid for r in leftovers][:8]}...) — they remain "
                   f"queued/in-slot and are marked aborted")
            if on_truncate == "raise":
                raise RuntimeError(msg)
            if on_truncate == "warn":
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return requests


# --------------------------------------------------------- state pool surgery
def _state_pairs(st: BlockState, row: BlockState) -> list:
    """(pooled leaf, row leaf) of one layer, a paged layer's length only:
    its blocks are the pool's own."""
    if isinstance(st.kv, PagedKVCache):
        return [(st.kv.length, row.kv.length)]
    if st.kv is not None:
        return list(zip(st.kv, row.kv))
    return [(a, row.rec[k]) for k, a in st.rec.items()]


def _gather_rows(states: list[BlockState],
                 idx: torch.Tensor) -> list[BlockState]:
    """Copies of the rows ``idx`` (a device tensor) of the pooled states;
    paged layers keep the global pool and copy only the rows' lengths."""
    out = []
    for st in states:
        if isinstance(st.kv, PagedKVCache):
            out.append(BlockState(kv=st.kv._replace(
                length=st.kv.length.index_select(0, idx))))
        elif st.kv is not None:
            out.append(BlockState(kv=KVCache(*(a.index_select(0, idx)
                                               for a in st.kv))))
        else:
            out.append(BlockState(rec={k: a.index_select(0, idx)
                                       for k, a in st.rec.items()}))
    return out


def _splice_rows(states: list[BlockState], rows: list[BlockState],
                 idx: torch.Tensor, keep: torch.Tensor) -> None:
    """Write row ``i`` of the batch-N ``rows`` into slot ``idx[i]`` (N
    distinct slots, a device tensor) of the pooled ``states`` where
    ``keep[i]``, IN PLACE; every other listed slot is rewritten with its
    own bits, so the call needs no count of the kept rows on the host."""
    for st, row in zip(states, rows):
        for dst, src in _state_pairs(st, row):
            mask = keep.view(-1, *[1] * (dst.dim() - 1))
            dst.index_copy_(0, idx, torch.where(
                mask, src.to(dst.dtype), dst.index_select(0, idx)))


def _write_back(states: list[BlockState], new: list[BlockState]) -> None:
    """Copy every leaf of ``new`` that a model call made anew into the
    engine's tensor it replaces, IN PLACE (leaves written in place are the
    same tensors)."""
    for st, row in zip(states, new):
        if isinstance(st.kv, PagedKVCache):
            pairs = zip(st.kv, row.kv)
        else:
            pairs = _state_pairs(st, row)
        for dst, src in pairs:
            if src is not dst:
                dst.copy_(src)

def _state_byte_stats(states: list[BlockState]) -> tuple[int, int]:
    """(paged pool K/V bytes, per-slot state bytes) of the state list, as
    the reference counts them: a paged layer's K and V (its lengths are not
    counted), every other tensor in full."""
    pool_b = state_b = 0
    for st in states:
        if isinstance(st.kv, PagedKVCache):
            pool_b += st.kv.k.nbytes + st.kv.v.nbytes
        else:
            parts = st.kv if st.kv is not None else st.rec.values()
            state_b += sum(a.nbytes for a in parts)
    return pool_b, state_b


def _any_leaf(st: BlockState) -> torch.Tensor:
    return st.kv.length if st.kv is not None else st.rec["h"]


def _gather_slot(states: list[BlockState], slot: int) -> list[BlockState]:
    """A batch-1 copy of slot ``slot`` of the pooled states
    (``repro.serve.engine._gather_slot``); paged layers keep the global pool
    and copy only the slot's length."""
    one = slice(slot, slot + 1)
    if spmd.is_dtensor(_any_leaf(states[0])):
        row = sharded.slot_row
        return [BlockState(kv=st.kv._replace(length=row(st.kv.length, slot)))
                if isinstance(st.kv, PagedKVCache)
                else BlockState(kv=KVCache(*(row(a, slot) for a in st.kv)))
                if st.kv is not None
                else BlockState(rec={k: row(a, slot)
                                     for k, a in st.rec.items()})
                for st in states]
    out = []
    for st in states:
        if isinstance(st.kv, PagedKVCache):
            out.append(BlockState(kv=st.kv._replace(
                length=st.kv.length[one].clone())))
        elif st.kv is not None:
            out.append(BlockState(kv=KVCache(*(a[one].clone()
                                               for a in st.kv))))
        else:
            out.append(BlockState(rec={k: a[one].clone()
                                       for k, a in st.rec.items()}))
    return out


def _splice_states(states: list[BlockState], rows: list[BlockState],
                   slot_ids: list[int]) -> None:
    """Write rows ``0..len(slot_ids)-1`` of the batch-N ``rows`` into the
    (distinct) slots ``slot_ids`` of the pooled ``states``, IN PLACE
    (``repro.serve.engine._splice_states``; rows past the real group are
    never written, which is where the JAX engine's reverse-order splice
    leaves them).  Paged layers take only the lengths: their blocks are the
    pool's own."""
    n = len(slot_ids)
    st0 = states[0]
    if spmd.is_dtensor(_any_leaf(st0)):
        for st, row in zip(states, rows):
            pairs = [(st.kv.length, row.kv.length)] \
                if isinstance(st.kv, PagedKVCache) \
                else zip(st.kv, row.kv) if st.kv is not None \
                else ((a, row.rec[k]) for k, a in st.rec.items())
            for dst, src in pairs:
                sharded.splice_rows(dst, src, slot_ids)
        return
    dev = _any_leaf(st0).device
    idx = torch.tensor(slot_ids, dtype=torch.long, device=dev)
    for st, row in zip(states, rows):
        if isinstance(st.kv, PagedKVCache):
            st.kv.length[idx] = row.kv.length[:n]
        elif st.kv is not None:
            for dst, src in zip(st.kv, row.kv):
                dst[idx] = src[:n]
        else:
            for key, dst in st.rec.items():
                dst[idx] = row.rec[key][:n]
