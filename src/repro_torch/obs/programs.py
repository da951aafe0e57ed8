"""Program-level cost observatory: the warmed inventory, measured live.

The PyTorch counterpart of ``repro.obs.programs``.  The source paper's
method is per-layer characterization — FLOP/B intensity, MAC utilization,
memory footprint — against each accelerator's roofline.
:class:`ProgramRegistry` is that table for the serving unit of execution:
every program of ``ServeEngine``'s warmed inventory (``prefill[{nb}x{b}]``,
``chunk``, ``copy``, ``decode``, and ``export``/``import`` on role engines)
registers here with its static cost and accumulates what the engine
measured through its device-synchronized ``Timed`` sections — invocation
counts and seconds.  The quotient is live per-program FLOP/s, bytes/s, and
utilization against the H100's roofline (``core/h100.py``) at the model's
compute dtype, surfaced as the versioned ``programs`` section of
``EngineStats.summary()`` (the reference's schema, version 1).

The reference reads its static costs from XLA's cost analysis of each
lowered program.  The port runs its programs eagerly, so the cost is an
analytic count from the config and the program's static shape
(:func:`program_cost`), which depends on the model's shapes only, not on
which kernel runs:

* ``flops`` is 2·M·N·K summed over every matrix product the program's
  plain versions compute at that shape — exactly what
  ``torch.utils.flop_counter.FlopCounterMode`` counts over the program's
  CPU call.  Elementwise work, norms, softmax, the scans and sampling are
  not counted; the peak it divides by is the product peak.
* ``bytes_accessed`` is the least HBM traffic: each parameter tensor the
  program reads, once, at its stored dtype; the KV it writes or reads
  across its slots' tables; each recurrent state read and written; token
  ids in and logits out.  Like XLA's, the count is static: a paged kernel
  that skips blocks past a row's length still counts its shape's blocks.

:meth:`ProgramRegistry.cluster_rollup` maps the measured phase totals back
onto the owning placement plan's clusters, as the reference's does: a
phase's measured seconds are attributed to clusters by their *predicted*
share of that phase, and each cluster's FLOP/s divides by its designated
Mensa accelerator's peak (``core/accelerators.by_name``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor

from ..core.accelerators import by_name
from ..core.h100 import for_dtype
from ..models.moe import capacity

#: version of the ``programs`` section of ``EngineStats.summary()``; bump
#: on any shape change
PROGRAMS_SCHEMA_VERSION = 1

#: phases the cluster rollup attributes (the copy/KV-maintenance programs
#: carry no plan prediction and stay out of the rollup)
ROLLUP_PHASES = ("prefill", "decode")

#: the programs :func:`program_cost` counts
PROGRAMS = ("prefill", "chunk", "copy", "decode", "export", "import")

_ITEMSIZE = {"bfloat16": 2, "float32": 4}
_F32 = 4
_TOKEN = 8                         # the engine's token ids are int64


@dataclass
class ProgramEntry:
    """One program: static cost + accumulated measurements."""
    name: str
    phase: str = ""                    # "prefill" | "decode" | "kv" | ...
    program: str = ""                  # the reference's jit attribute name
    flops: float = 0.0                 # per invocation, analytic
    bytes_accessed: float = 0.0        # per invocation
    memory: dict = field(default_factory=dict)   # see measure_call
    analyzed: bool = False             # a static cost was registered
    invocations: int = 0
    measured_s: float = 0.0            # device-synchronized (Timed.dur) total

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_accessed if self.bytes_accessed else 0.0


class ProgramRegistry:
    """Registry of an engine's programs with live roofline rates.

    ``chip`` is the roofline the utilization figures divide by (default the
    H100's at bf16, ``core.h100.for_dtype``); ``plan_summary`` is the owning
    ``PlacementPlan.summary()`` dict the cluster rollup attributes against
    (optional)."""

    def __init__(self, chip=None, plan_summary: dict | None = None):
        self.chip = chip if chip is not None else for_dtype("bfloat16")
        self.plan = plan_summary or {}
        self._entries: dict[str, ProgramEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def entry(self, name: str) -> ProgramEntry | None:
        return self._entries.get(name)

    def register(self, name: str, cost: tuple[float, float], *, phase: str,
                 program: str, memory: dict | None = None) -> ProgramEntry:
        """Register one program with its static ``cost``, the
        ``(flops, bytes_accessed)`` of :func:`program_cost`, and optionally
        its ``memory`` (:func:`measure_call`).  The cost is the port's own
        arithmetic, so unlike the reference's XLA analyses it is never
        missing: the engine counts it at warmup, and a count that fails
        raises there; only :meth:`observe` must never raise."""
        flops, nbytes = cost
        e = self._entries.setdefault(name, ProgramEntry(name))
        e.phase, e.program = phase, program
        e.flops, e.bytes_accessed = float(flops), float(nbytes)
        e.analyzed = True
        if memory is not None:
            e.memory = dict(memory)
        return e

    def observe(self, name: str, dur: float, *, phase: str = "",
                program: str = "") -> None:
        """Accumulate one device-synchronized invocation (``Timed.dur``)."""
        e = self._entries.get(name)
        if e is None:
            e = self._entries[name] = ProgramEntry(name, phase=phase,
                                                   program=program)
        e.invocations += 1
        e.measured_s += dur

    def reset_observed(self) -> None:
        """Zero the dynamic accumulators; static registration survives
        (mirrors ``ServeEngine.reset_stats``)."""
        for e in self._entries.values():
            e.invocations = 0
            e.measured_s = 0.0

    def temp_bytes_peak(self) -> int:
        """High-water temp memory across the inventory (0 until a program
        was registered with a measured ``temp_size_in_bytes``)."""
        return max((int(e.memory.get("temp_size_in_bytes", 0))
                    for e in self._entries.values()), default=0)

    def phase_totals(self) -> dict:
        """Per-phase sums over the inventory: measured seconds and total
        executed FLOPs/bytes (static cost x invocations)."""
        out: dict = {}
        for e in self._entries.values():
            t = out.setdefault(e.phase or "?", {"measured_s": 0.0,
                                                "flops": 0.0, "bytes": 0.0,
                                                "invocations": 0})
            t["measured_s"] += e.measured_s
            t["flops"] += e.flops * e.invocations
            t["bytes"] += e.bytes_accessed * e.invocations
            t["invocations"] += e.invocations
        return out

    def cluster_rollup(self) -> dict:
        """Measured phase time attributed to the plan's clusters.

        Each cluster's policy predicted its share of a phase
        (``predicted_prefill_s`` / ``predicted_decode_s``); the measured
        phase total splits by those shares, and the cluster's attributed
        FLOP/s divides by its designated Mensa accelerator's peak — the
        paper's per-cluster characterization, live.  Empty without a plan's
        policies (fixed engines) or before anything ran."""
        policies = self.plan.get("policies") or []
        if not policies:
            return {}
        totals = self.phase_totals()
        pred_key = {"prefill": "predicted_prefill_s",
                    "decode": "predicted_decode_s"}
        out: dict = {}
        for ph in ROLLUP_PHASES:
            meas = totals.get(ph)
            total_pred = sum(p.get(pred_key[ph]) or 0.0 for p in policies)
            if not meas or not meas["measured_s"] or total_pred <= 0:
                continue
            for pol in policies:
                pred = pol.get(pred_key[ph]) or 0.0
                if pred <= 0:
                    continue
                share = pred / total_pred
                measured = share * meas["measured_s"]
                flops = share * meas["flops"]
                try:
                    peak = by_name(pol["accelerator"]).peak_flops
                except (KeyError, TypeError):
                    peak = 0.0
                c = out.setdefault(str(pol["cluster"]), {
                    "accelerator": pol.get("accelerator"),
                    "kinds": list(pol.get("kinds") or ()),
                })
                c[ph] = {
                    "share": share,
                    "predicted_s": pred,
                    "measured_s": measured,
                    "ratio": measured / pred,
                    "flops": flops,
                    "flops_per_s": flops / measured if measured else 0.0,
                    "utilization": (flops / measured / peak)
                    if measured and peak else 0.0,
                }
        return out

    def summary(self) -> dict:
        """The versioned ``programs`` section of ``EngineStats.summary()``."""
        programs = {}
        for name in sorted(self._entries):
            e = self._entries[name]
            total_flops = e.flops * e.invocations
            total_bytes = e.bytes_accessed * e.invocations
            fps = total_flops / e.measured_s if e.measured_s else 0.0
            bps = total_bytes / e.measured_s if e.measured_s else 0.0
            rec = {
                "phase": e.phase,
                "program": e.program,
                "analyzed": e.analyzed,
                "flops": e.flops,
                "bytes_accessed": e.bytes_accessed,
                "arithmetic_intensity": e.arithmetic_intensity,
                "invocations": e.invocations,
                "measured_s": e.measured_s,
                "flops_per_s": fps,
                "bytes_per_s": bps,
                "utilization": fps / self.chip.peak_flops,
                "bandwidth_utilization": bps / self.chip.hbm_bw,
            }
            if e.memory:
                rec["memory"] = dict(e.memory)
            programs[name] = rec
        out = {
            "version": PROGRAMS_SCHEMA_VERSION,
            "chip": {"name": self.chip.name,
                     "peak_flops": self.chip.peak_flops,
                     "hbm_bw": self.chip.hbm_bw},
            "programs": programs,
        }
        peak_tmp = self.temp_bytes_peak()
        if peak_tmp:
            out["temp_bytes_peak"] = peak_tmp
        clusters = self.cluster_rollup()
        if clusters:
            out["clusters"] = clusters
        return out


# ------------------------------------------------------------ static costs
def _attn_context(cfg, kind: str, program: str, seq: int, max_len: int,
                  table: int | None) -> tuple[int, int, int]:
    """One batch row of one attention layer: (keys each query attends over
    in the plain version, KV tokens written, KV tokens read).  ``table``:
    the tokens a paged layer's table row spans (None for a dense cache)."""
    window = cfg.window if kind == "local" else 0
    ring = min(max_len, window) if window else max_len
    cache = table if table is not None else ring
    if program == "prefill":
        # models/transformer.AttnBlock._self_attention: local_attention over
        # the chunk and the previous one, else flash over the bucket
        keys = 2 * window if window and seq % window == 0 else seq
        return keys, min(seq, ring), 0
    if program == "chunk":
        # a window's ring attends over (prior ring ++ chunk)
        return cache + (seq if window else 0), min(seq, ring), cache
    return cache, 0, cache          # decode: the new K/V lies in the span


def _ffn_cost(cfg, n: int, isz: int) -> tuple[int, int]:
    """(flops, parameter bytes) of one layer's feed-forward over ``n``
    tokens."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_kind == "glu":
        return 3 * 2 * n * d * f, 3 * d * f * isz
    if cfg.ffn_kind == "mlp":
        return 2 * 2 * n * d * f, (2 * d * f + f + d) * isz
    if cfg.ffn_kind != "moe":
        return 0, 0
    e, k = cfg.num_experts, cfg.top_k
    flops, nbytes = 2 * n * d * e, d * e * _F32          # the float32 router
    if cfg.moe_impl == "ragged":
        # its groups always sum to n*k rows; the banks it reads depend on
        # the routing: count the most the call can touch
        rows, banks = n * k, min(e, n * k)
    else:
        # the capacity routes multiply every bank at capacity C
        rows, banks = e * capacity(cfg.moe_capacity, n, k, e), e
    flops += 3 * 2 * rows * d * f
    nbytes += banks * 3 * d * f * isz
    if cfg.moe_shared_expert:
        flops += 3 * 2 * n * d * f
        nbytes += 3 * d * f * isz
    return flops, nbytes


def _norm_bytes(cfg) -> int:
    return cfg.d_model * _F32 * (2 if cfg.norm == "layer" else 1)


def _layer_cost(cfg, kind: str, program: str, batch: int, seq: int,
                max_len: int, kv_block_size: int | None) -> dict:
    """One decoder layer's terms (see :func:`cost_terms`)."""
    isz = _ITEMSIZE[cfg.compute_dtype]
    d, n = cfg.d_model, batch * seq
    out = dict(flops=0, params=0, kv=0, state=0)
    if kind in ("attn", "local"):
        hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        table = None
        if kind == "attn" and kv_block_size is not None:
            table = -(-max_len // kv_block_size) * kv_block_size
        keys, written, read = _attn_context(cfg, kind, program, seq,
                                            max_len, table)
        ffn_flops, ffn_bytes = _ffn_cost(cfg, n, isz)
        out["flops"] = (2 * n * d * (2 * hq + 2 * hkv)          # q, k, v, o
                        + 2 * 2 * batch * seq * keys * hq       # QK, PV
                        + ffn_flops)
        out["params"] = (d * (2 * hq + 2 * hkv) * isz + ffn_bytes
                         + 2 * _norm_bytes(cfg))
        if cfg.qkv_bias:
            out["params"] += (hq + 2 * hkv) * isz
        if cfg.qk_norm:
            out["params"] += 2 * cfg.head_dim * _F32
        out["kv"] = batch * (written + read) * 2 * hkv * isz
        return out
    if kind == "rec":
        r, g = cfg.d_rnn, cfg.rglru_gate_blocks
        gate_flops = 2 * 2 * n * r * r // (g or 1)
        gate_bytes = 2 * r * r // g * _F32 if g else 2 * r * r * isz
        ffn_flops, ffn_bytes = _ffn_cost(cfg, n, isz)
        out["flops"] = 2 * n * d * r * 3 + gate_flops + ffn_flops
        out["params"] = ((3 * d * r + cfg.d_conv * r) * isz + gate_bytes
                         + r * _F32 + ffn_bytes + 2 * _norm_bytes(cfg))
        row = (cfg.d_conv - 1) * r * isz + r * _F32
    else:                                                # ssm
        di, ns = cfg.d_inner, cfg.d_state
        rank = cfg.dt_rank or max(1, d // 16)
        out["flops"] = 2 * n * (3 * d * di + di * (rank + 2 * ns)
                                + rank * di)
        out["params"] = ((3 * d * di + cfg.d_conv * di) * isz
                         + (di * (rank + 2 * ns) + rank * di + 2 * di
                            + di * ns) * _F32 + _norm_bytes(cfg))
        row = (cfg.d_conv - 1) * di * isz + di * ns * _F32
    out["state"] = 2 * batch * row                       # read and written
    return out


def cost_terms(cfg, program: str, *, max_len: int, batch: int = 1,
               seq: int = 1, kv_block_size: int | None = None) -> dict:
    """The terms of one program's static cost for the decoder ``cfg``
    served with caches of ``max_len`` tokens (``kv_block_size``: the paged
    pool's block, which ``attn`` layers then keep their KV in):

    ``flops``; and the bytes of ``params`` (parameters read), ``kv`` (KV
    written and read), ``state`` (recurrent state read and written) and
    ``io`` (token ids in, logits out).

    ``program``: "prefill" (``batch`` rows of ``seq`` tokens on fresh
    states), "chunk" (one row of ``seq`` tokens resuming from its slot),
    "decode" (one token on each of ``batch`` slots), "copy" (one block
    cloned in every paged layer), "export" / "import" (one slot's suitcase
    packed from / unpacked into the states)."""
    if program not in PROGRAMS:
        raise ValueError(f"program {program!r} not in {PROGRAMS}")
    isz = _ITEMSIZE[cfg.compute_dtype]
    kinds = cfg.layer_kinds
    terms = dict(flops=0, params=0, kv=0, state=0, io=0)
    if program == "copy":
        if kv_block_size is not None:
            per_layer = kv_block_size * 2 * cfg.num_kv_heads * cfg.head_dim \
                * isz
            terms["kv"] = 2 * per_layer * kinds.count("attn")
        return terms
    if program in ("export", "import"):
        # one slot's suitcase, read and written: the KV row a decode tick
        # reads for one slot, and its state (already counted twice there)
        for kind in kinds:
            row = _layer_cost(cfg, kind, "decode", 1, 1, max_len,
                              kv_block_size)
            terms["kv"] += 2 * row["kv"]
            terms["state"] += row["state"]
        return terms
    if program == "chunk":
        batch = 1
    if program == "decode":
        seq = 1
    for kind in kinds:
        for key, v in _layer_cost(cfg, kind, program, batch, seq, max_len,
                                  kv_block_size).items():
            terms[key] += v
    d, vp = cfg.d_model, cfg.vocab_padded
    # the head at each row's last position; a tied table is read once,
    # an untied embedding only at the rows the tokens look up
    terms["flops"] += 2 * batch * d * vp
    terms["params"] += vp * d * _F32 + _norm_bytes(cfg)
    if not cfg.tie_embeddings:
        terms["params"] += batch * seq * d * _F32
    terms["io"] = batch * seq * _TOKEN + batch * cfg.vocab_size * _F32
    return terms


def program_cost(cfg, program: str, **geometry) -> tuple[int, int]:
    """``(flops, bytes_accessed)`` of one program at its static shape: a
    function of the config and ``geometry`` (:func:`cost_terms`'s keywords)
    only."""
    t = cost_terms(cfg, program, **geometry)
    return t["flops"], t["params"] + t["kv"] + t["state"] + t["io"]


# ------------------------------------------------------------------ memory
def _tensors(obj):
    """Every tensor in a nest of lists, tuples (named ones too) and dicts;
    a DTensor's local shard (the bytes on this rank's card)."""
    if isinstance(obj, DTensor):
        yield obj.to_local()
    elif isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _distinct(tensors) -> list:
    seen, out = set(), []
    for t in tensors:
        key = (t.data_ptr(), t.nbytes)
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def measure_call(fn, args=(), kwargs=None, *, params=()):
    """Run ``fn(*args, **kwargs)`` once and return ``(its result, memory)``.

    ``memory`` holds a subset of the reference's memory fields
    (``repro.utils.hlo.MEMORY_FIELDS``): ``argument_size_in_bytes`` (the
    distinct tensors of ``params`` and the arguments) and
    ``output_size_in_bytes`` (the result's tensors that alias no argument).
    On the card it adds the caching allocator's watermarks around the call:
    ``temp_size_in_bytes``, the high-water mark over the memory allocated
    before, less the outputs, and ``peak_memory_in_bytes``, the high-water
    mark itself (everything on the card included).  The CPU has no
    watermark: those two are omitted, never invented as zeros."""
    kwargs = kwargs or {}
    inputs = _distinct([*_tensors(list(params)), *_tensors((args, kwargs))])
    cuda = any(t.is_cuda for t in inputs)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    out = fn(*args, **kwargs)
    owned = {t.untyped_storage().data_ptr() for t in inputs}
    out_bytes = sum(t.nbytes for t in _distinct(_tensors(out))
                    if t.untyped_storage().data_ptr() not in owned)
    mem = {"argument_size_in_bytes": sum(t.nbytes for t in inputs),
           "output_size_in_bytes": out_bytes}
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        mem["temp_size_in_bytes"] = max(0, peak - before - out_bytes)
        mem["peak_memory_in_bytes"] = peak
    return out, mem
