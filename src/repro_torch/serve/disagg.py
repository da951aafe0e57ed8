"""Disaggregated serving: prefill and decode as cooperating role engines.

The PyTorch counterpart of ``repro.serve.disagg``.  Prefill ticks are
compute-centric bursts and decode ticks memory-centric and latency-bound;
:class:`DisaggEngine` couples a ``role="prefill"`` and a ``role="decode"``
:class:`~repro_torch.serve.engine.ServeEngine`, so prefill capacity and
decode capacity are provisioned independently (the interference DistServe,
OSDI'24, removes).

Per tick the coordinator advances the prefill engine, drains its ``ready``
slots — export the slot into a self-contained *suitcase* (batch-1 state row
plus copies of the slot's KV blocks), stage it on the decode side, release
the prefill slot — then offers pending suitcases to the decode engine's
:meth:`~repro_torch.serve.engine.ServeEngine.adopt` (a block-table remap
into the decode pool plus one scatter), and finally advances the decode
engine.  Adoption is FIFO and backpressured: a suitcase that finds no free
slot or no free blocks waits, with the stall counted.

Token identity with the interleaved engine is structural: the same prefill
produces the same first token, the suitcase moves KV blocks and recurrent
rows bit for bit, and decode math is per-slot independent.

The port runs both roles on one device, or both on one mesh (``mesh=``,
``param_strategy=``: each role engine serves over it, the suitcase a slot
row and blocks replicated over its data axis); the reference's disjoint
submeshes (``prefill_mesh``/``decode_mesh``) are the next slice of the
port's multi-device path.  Each role registers its own programs (its
shapes and its half of the handoff), so each role's summary under
``roles`` carries its own ``programs`` section.
"""
from __future__ import annotations

import warnings

from ..models.transformer import Model
from ..obs import Tracer
from .engine import Request, ServeEngine
from .placement import PlacementPlan


class DisaggEngine:
    """A prefill engine and a decode engine coupled by KV-suitcase handoff.

    Both engines share one tracer timeline; the decode engine's tracks start
    after the prefill engine's (``track_base``).  The decode engine never
    prefills, so its pool runs with the prefix cache off: suitcase contents
    arrive by block copy, and prefix reuse already happened on the prefill
    side where prompts are admitted.

    ``policy`` (a ``serve.placement.PlacementPlan``) supplies per-role
    bucket/chunk knobs through ``plan.per_role``; explicit constructor
    arguments still win, as in ``ServeEngine``.  ``program_memory`` goes to
    both role engines (``ServeEngine``); ``prefill_model`` to the prefill
    role and ``decode_model`` to the decode role, as the reference wires
    them; ``mesh`` and ``param_strategy`` to both (``ServeEngine``).
    """

    def __init__(self, model: Model, *, prefill_slots: int = 4,
                 decode_slots: int = 4, max_len: int = 256,
                 buckets: tuple[int, ...] | None = None,
                 min_bucket: int = 16,
                 max_prefill_per_step: int = 1,
                 max_prefill_batch: int = 4,
                 prefill_chunk: int | None = None,
                 kv_block_size: int | None = None,
                 kv_blocks: int | None = None,
                 prefix_cache: bool = True,
                 prefill_model: Model | None = None,
                 decode_model: Model | None = None,
                 policy: PlacementPlan | None = None,
                 tracer: Tracer | None = None,
                 program_memory: bool = False,
                 mesh=None, param_strategy: str = "tp"):
        self.tracer = tracer if tracer is not None else Tracer()
        per_role = policy.per_role if policy is not None else {}
        pre_kn = per_role.get("prefill", {})
        dec_kn = per_role.get("decode", {})

        def knob(explicit, knobs, key):
            if explicit is not None:
                return explicit
            return knobs.get(key)

        pre_buckets = knob(buckets, pre_kn, "buckets")
        dec_buckets = knob(buckets, dec_kn, "buckets")
        common = dict(max_len=max_len, min_bucket=min_bucket,
                      kv_block_size=kv_block_size, kv_blocks=kv_blocks,
                      policy=policy, tracer=self.tracer,
                      program_memory=program_memory, mesh=mesh,
                      param_strategy=param_strategy)
        self.prefill = ServeEngine(
            model, role="prefill", slots=prefill_slots,
            buckets=tuple(pre_buckets) if pre_buckets else None,
            prefill_chunk=knob(prefill_chunk, pre_kn, "prefill_chunk"),
            max_prefill_per_step=max_prefill_per_step,
            max_prefill_batch=max_prefill_batch,
            prefix_cache=prefix_cache, prefill_model=prefill_model,
            track_base=0, **common)
        self.decode = ServeEngine(
            model, role="decode", slots=decode_slots,
            buckets=tuple(dec_buckets) if dec_buckets else None,
            prefill_chunk=knob(prefill_chunk, dec_kn, "prefill_chunk"),
            prefix_cache=False, decode_model=decode_model,
            track_base=self.prefill._trk_engine + 1, **common)
        # suitcases exported but not yet adopted (FIFO; self-contained
        # copies, so the prefill slot is already free while these wait)
        self._pending: list = []
        self.wall_time_s = 0.0
        self.ticks = 0

    @property
    def buckets(self):
        """Admission buckets live on the prefill role (where prompts enter)."""
        return self.prefill.buckets

    @property
    def prefill_chunk(self):
        return self.prefill.prefill_chunk

    # ------------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        self.prefill.submit(req)

    def warmup(self) -> None:
        """Warm both roles, each its own shapes and its half of the
        handoff."""
        self.prefill.warmup()
        self.decode.warmup()

    def step(self) -> None:
        """One coordinator tick: advance prefill, export every ready slot,
        offer pending suitcases to decode (FIFO, backpressured), advance
        decode one lockstep step."""
        t0 = self.tracer.now()
        self.prefill.step()
        self._drain_ready()
        self._adopt_pending()
        self.decode.step()
        self.ticks += 1
        self.wall_time_s += self.tracer.now() - t0

    def _drain_ready(self) -> None:
        pre = self.prefill
        while pre.ready:
            slot = pre.ready.popleft()
            req = pre.requests[slot]
            suitcase = self.decode.stage_in(pre.export_slot(slot))
            pre.release_handoff(slot)
            self._pending.append((req, suitcase, len(req.prompt)))

    def _adopt_pending(self) -> None:
        while self._pending:
            req, suitcase, n = self._pending[0]
            if self.decode.adopt(req, suitcase, n) is None:
                break                    # no slot/blocks free: retry next tick
            self._pending.pop(0)

    def _busy(self) -> bool:
        return bool(self.prefill._queue or self.prefill._prefilling
                    or self._pending
                    or any(r is not None for r in self.prefill.requests)
                    or any(r is not None for r in self.decode.requests))

    def run(self, requests: list[Request], max_steps: int = 10_000,
            on_truncate: str = "warn") -> list[Request]:
        """Serve ``requests`` to completion (or ``max_steps`` coordinator
        ticks); the contract of ``ServeEngine.run``."""
        if on_truncate not in ("warn", "raise", "ignore"):
            raise ValueError(f"on_truncate {on_truncate!r} not in "
                             f"('warn', 'raise', 'ignore')")
        for r in requests:
            self.submit(r)
        steps = 0
        while self._busy() and steps < max_steps:
            self.step()
            steps += 1
        leftovers = ([r for r in self.prefill.requests if r is not None]
                     + [r for r in self.decode.requests if r is not None]
                     + [r for r, _, _ in self._pending]
                     + list(self.prefill._queue))
        if leftovers:
            self.decode.stats.requests_aborted += sum(
                1 for r in leftovers if not r.aborted)
            t_abort = self.tracer.now()
            for r in leftovers:
                if not r.aborted:
                    self.tracer.instant("abort", self.prefill._trk_req,
                                        t_abort, (("rid", r.rid),))
                r.aborted = True
            msg = (f"run() exhausted max_steps={max_steps} with "
                   f"{len(leftovers)} unfinished requests "
                   f"(rids {[r.rid for r in leftovers][:8]}...) — they "
                   f"remain queued/in-slot/pending and are marked aborted")
            if on_truncate == "raise":
                raise RuntimeError(msg)
            if on_truncate == "warn":
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return requests

    # ----------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        self.prefill.reset_stats()
        self.decode.reset_stats()
        self.wall_time_s = 0.0
        self.ticks = 0

    def recompiles_since(self, warm: dict) -> int:
        """Growth of either role's compiled programs since a ``summary()``
        taken right after warmup — the zero-recompile gate.  The port runs
        eagerly, so both counts stay 0 until its steps become CUDA graphs."""
        cur = self.summary()
        rec = 0
        for role in ("prefill", "decode"):
            w, c = warm["roles"][role], cur["roles"][role]
            rec += (c["prefill_compiles"] - w["prefill_compiles"]) \
                + (c["decode_compiles"] - w["decode_compiles"])
        return rec

    def summary(self) -> dict:
        """Aggregate view: per-role summaries side by side, handoff totals,
        coordinator-wall throughput, per-role tokens/s, and the decode
        time-between-tokens quantiles."""
        pre = self.prefill.stats.summary()
        dec = self.decode.stats.summary()
        tokens = (self.prefill.stats.tokens_generated
                  + self.decode.stats.tokens_generated)
        wall = self.wall_time_s
        tbt = self.decode.stats.metrics.histogram("decode_tbt_s")
        return {
            "roles": {"prefill": pre, "decode": dec},
            "requests_completed": (pre["requests_completed"]
                                   + dec["requests_completed"]),
            "requests_aborted": dec["requests_aborted"],
            "tokens_generated": tokens,
            "tokens_per_s": tokens / wall if wall else 0.0,
            "per_role_tokens_per_s": {
                # prefill: prompt tokens computed; decode: tokens generated
                # — each over the shared coordinator wall
                "prefill": (self.prefill.stats.prefill_tokens_computed
                            / wall if wall else 0.0),
                "decode": (self.decode.stats.tokens_generated
                           / wall if wall else 0.0),
            },
            "handoffs": self.decode.stats.handoffs,
            "handoffs_pending": len(self._pending),
            "handoff_stalls": self.decode.stats.handoff_stalls,
            "handoff_time_s": (self.prefill.stats.handoff_time_s
                               + self.decode.stats.handoff_time_s),
            "decode_tbt_ms": {"p50": 1e3 * tbt.quantile(0.5),
                              "p99": 1e3 * tbt.quantile(0.99)},
            "ticks": self.ticks,
            "wall_time_s": wall,
        }

    def save_trace(self, path) -> None:
        """One Chrome trace for both roles (shared tracer: prefill tracks
        first, then decode's, offset by ``track_base``)."""
        self.tracer.save(path, other_data={"disagg": {
            "handoffs": self.decode.stats.handoffs,
            "handoff_stalls": self.decode.stats.handoff_stalls}})
