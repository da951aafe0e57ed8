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

The pair runs on one device, or as the reference deploys it, each role on
its own disjoint submesh of ranks (``prefill_mesh``/``decode_mesh`` from
``launch.mesh.make_role_meshes``, ``param_strategy=``; a rank is a card),
so a prefill burst cannot take decode's cycles.  There each rank builds
only its role's engine, and every rank runs the same tick in lockstep over
a :class:`RoleLink`: the prefill ranks step and export; global rank 0
broadcasts a header (each handed-off request's fields, each suitcase
leaf's shape and dtype) over a gloo group for host objects; the suitcases'
bytes cross by ``isend``/``irecv`` on the default group (NCCL between
cards) and land on the decode submesh (the suitcase a slot row and blocks
replicated over its data axis); the decode ranks adopt and step; an
all-reduce agrees whether the loop goes on.  Warmup pairs the same way:
the prefill role's warm export is the decode role's warm import.  ``run``
returns the completed requests on every rank, and ``summary``/
``save_trace`` give rank 0 the reference's whole view.  Each
role registers its own programs (its shapes and its half of the
handoff), so each role's summary under ``roles`` carries its own
``programs`` section.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist

from ..models.transformer import Model
from ..obs import Timed, Tracer
from . import sharded
from .engine import Request, ServeEngine, check_request
from .placement import PlacementPlan

ROLES = ("prefill", "decode")


class RoleLink:
    """The disaggregated pair's link between its two submeshes of ranks
    (``prefill_mesh``/``decode_mesh``, disjoint, one model axis size):
    a gloo group over the pair's ranks for host objects (even when the
    default group is NCCL), and the peers this rank's suitcase bytes go
    to or come from — model shard j of the prefill side's data rank 0
    feeds model shard j of every decode data rank.  Built on every rank of
    the default group, in the same order (``new_group`` is collective)."""

    def __init__(self, prefill_mesh, decode_mesh, device):
        meshes = {"prefill": prefill_mesh, "decode": decode_mesh}
        ranks = {r: m.mesh.flatten().tolist() for r, m in meshes.items()}
        if set(ranks["prefill"]) & set(ranks["decode"]):
            raise ValueError(f"the role meshes share ranks: {ranks}")
        if prefill_mesh.mesh.shape[1] != decode_mesh.mesh.shape[1]:
            raise ValueError("the role meshes' model axes differ: a model "
                             "shard crosses to the shard of its index")
        me = dist.get_rank()
        self.role = "prefill" if me in ranks["prefill"] else "decode"
        if me not in ranks[self.role]:
            raise ValueError(f"rank {me} is in neither role mesh: {ranks}")
        #: each role's leader: its global rank at (data 0, model 0)
        self.leaders = {r: rs[0] for r, rs in ranks.items()}
        self.is_leader = me == self.leaders[self.role]
        self.host = dist.new_group(sorted(ranks["prefill"] + ranks["decode"]),
                                   backend="gloo")
        self.mesh = meshes[self.role]
        self.device = device
        data, model = self.mesh.get_coordinate()
        if self.role == "prefill":
            self.peers = decode_mesh.mesh[:, model].tolist() if data == 0 \
                else []
        else:
            self.peers = [int(prefill_mesh.mesh[0, model])]

    def share(self, obj, role: str):
        """``obj`` as ``role``'s leader passed it, on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.leaders[role],
                                   group=self.host)
        return box[0]

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on some rank (a MAX all-reduce)."""
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host)
        return bool(t.item())

    def exchange(self, outgoing: list) -> list:
        """One handoff, collective over the pair's ranks: the prefill ranks
        pass the ``(request fields, suitcase)`` pairs they exported (alike
        on every prefill rank; fields None in warmup), the decode ranks [].
        Global rank 0 broadcasts the header — each request's fields and
        each suitcase's layout and leaf shapes, dtypes and placements —
        and each suitcase's bytes (``sharded.pack``: the bits, never a
        sum) cross from the sending ranks to their peers.  Returns on the
        decode ranks the ``(fields, sharded.Parcel)`` pairs, in order; []
        on the prefill ranks."""
        parcels = [sharded.pack(sc) for _, sc in outgoing] \
            if self.peers and self.role == "prefill" else []
        header = self.share([(fields, p.tree, p.metas) for (fields, _), p
                             in zip(outgoing, parcels)], "prefill")
        if self.role == "decode":
            parcels = [sharded.Parcel(tree, metas, torch.empty(
                sharded.wire_bytes(metas, self.mesh), dtype=torch.uint8,
                device=self.device)) for _, tree, metas in header]
        move = dist.isend if self.role == "prefill" else dist.irecv
        for work in [move(p.data, peer) for p in parcels
                     for peer in self.peers]:
            work.wait()
        if self.role == "prefill":
            return []
        return [(fields, p) for (fields, _, _), p in zip(header, parcels)]


class DisaggEngine:
    """A prefill engine and a decode engine coupled by KV-suitcase handoff.

    ``prefill_mesh`` / ``decode_mesh`` must be both set (disjoint submeshes
    from ``launch.mesh.make_role_meshes``: each rank then builds only its
    role's engine, on its submesh) or both None (one device).  The
    engines' tracks share one timeline; the decode engine's start after
    the prefill engine's (``track_base``).  The decode
    engine never prefills, so its pool runs with the prefix cache off:
    suitcase contents arrive by block copy, and prefix reuse already
    happened on the prefill side where prompts are admitted.

    ``policy`` (a ``serve.placement.PlacementPlan``) supplies per-role
    bucket/chunk knobs through ``plan.per_role``; explicit constructor
    arguments still win, as in ``ServeEngine``.  ``program_memory`` goes to
    both role engines (``ServeEngine``); ``prefill_model`` to the prefill
    role and ``decode_model`` to the decode role, as the reference wires
    them; ``param_strategy`` (the weights' layout on a role mesh) and
    ``layout_cfg`` (the config deciding it) to both.
    """

    def __init__(self, model: Model, *, prefill_mesh=None, decode_mesh=None,
                 prefill_slots: int = 4,
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
                 param_strategy: str = "tp", layout_cfg=None):
        if (prefill_mesh is None) != (decode_mesh is None):
            raise ValueError("prefill_mesh and decode_mesh must be both set "
                             "(disjoint submeshes) or both None")
        self.tracer = tracer if tracer is not None else Tracer()
        self.max_len = max_len
        self.link = None if prefill_mesh is None \
            else RoleLink(prefill_mesh, decode_mesh, model.device)
        here = ROLES if self.link is None else (self.link.role,)
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
                      program_memory=program_memory,
                      param_strategy=param_strategy, layout_cfg=layout_cfg)
        self.prefill = self.decode = None
        if "prefill" in here:
            self.prefill = ServeEngine(
                model, role="prefill", slots=prefill_slots,
                buckets=tuple(pre_buckets) if pre_buckets else None,
                prefill_chunk=knob(prefill_chunk, pre_kn, "prefill_chunk"),
                max_prefill_per_step=max_prefill_per_step,
                max_prefill_batch=max_prefill_batch,
                prefix_cache=prefix_cache, prefill_model=prefill_model,
                mesh=prefill_mesh, track_base=0, **common)
        if "decode" in here:
            # after the prefill engine's tracks: requests, a slot each,
            # engine-wide
            self.decode = ServeEngine(
                model, role="decode", slots=decode_slots,
                buckets=tuple(dec_buckets) if dec_buckets else None,
                prefill_chunk=knob(prefill_chunk, dec_kn, "prefill_chunk"),
                prefix_cache=False, decode_model=decode_model,
                mesh=decode_mesh, track_base=prefill_slots + 2, **common)
        # admission lives on the prefill role (where prompts enter)
        pre = self.prefill
        self._admission = (pre.buckets, pre.prefill_chunk) \
            if pre is not None else None
        if self.link is not None:
            self._admission = self.link.share(self._admission, "prefill")
        # suitcases exported but not yet adopted (FIFO; self-contained
        # copies, so the prefill slot is already free while these wait)
        self._pending: list = []
        # role ranks: the requests submitted here and not yet settled, by
        # rid (a decode rank meets each again in the handoff's header)
        self._submitted: dict[int, Request] = {}
        self.wall_time_s = 0.0
        self.ticks = 0

    @property
    def buckets(self):
        """Admission buckets live on the prefill role (where prompts enter)."""
        return self._admission[0]

    @property
    def prefill_chunk(self):
        return self._admission[1]

    @property
    def device(self) -> torch.device:
        return self._engines()[0].device

    def _engines(self) -> list[ServeEngine]:
        """The role engines this rank runs: both, or its role's."""
        return [e for e in (self.prefill, self.decode) if e is not None]

    # ------------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        if self.link is None:
            self.prefill.submit(req)
            return
        # every rank checks alike: a refusal on the prefill ranks alone
        # would leave the decode ranks waiting in the next collective
        check_request(req, self.max_len)
        self._submitted[req.rid] = req
        if self.prefill is not None:
            self.prefill.submit(req)
        else:
            req.t_submit = self.tracer.now()

    def warmup(self) -> None:
        """Warm both roles, each its own shapes and its half of the
        handoff.  On role meshes the two halves pair up across the link,
        as every tick's handoff does: the prefill role's warm export
        crosses, and the decode role's warmup imports it."""
        if self.link is None:
            for engine in self._engines():
                engine.warmup()
        elif self.prefill is not None:
            self.link.exchange([(None, self.prefill.warmup())])
        else:
            [(_, parcel)] = self.link.exchange([])
            self.decode.warmup(sharded.unpack(parcel, self.decode.mesh))

    def step(self) -> None:
        """One coordinator tick: advance prefill, export every ready slot,
        offer pending suitcases to decode (FIFO, backpressured), advance
        decode one lockstep step.  On role meshes every rank ticks: each
        its role's parts, the handoff together."""
        t0 = self.tracer.now()
        if self.prefill is not None:
            self.prefill.step()
        self._drain_ready()
        if self.decode is not None:
            self._adopt_pending()
            self.decode.step()
        self.ticks += 1
        self.wall_time_s += self.tracer.now() - t0

    def _drain_ready(self) -> None:
        pre = self.prefill
        out = []
        while pre is not None and pre.ready:
            slot = pre.ready.popleft()
            req = pre.requests[slot]
            suitcase = pre.export_slot(slot)
            if self.link is None:
                suitcase = self.decode.stage_in(suitcase)
            pre.release_handoff(slot)
            out.append((req, suitcase))
        if self.link is not None:
            out = self._cross(out)
        self._pending += [(req, sc, len(req.prompt)) for req, sc in out]

    def _cross(self, exported: list) -> list:
        """Role meshes: the exported suitcases cross to the decode ranks
        (``RoleLink.exchange``).  On a decode rank each arrives as its
        request (the one submitted here, brought up to the prefill side's
        fields: its first token and stamps) and its suitcase landed on the
        decode submesh (``sharded.unpack``: each leaf a DTensor of its
        sender's placements, replicated over ``data``, as the reference's
        ``stage_in`` lands it); [] on a prefill rank.  A ``handoff_wire``
        span on this rank's engine track times it."""
        engine = self._engines()[0]
        with Timed("handoff_wire", device=self.device,
                   clock=self.tracer.clock) as tm:
            got = self.link.exchange([(dataclasses.asdict(r), sc)
                                      for r, sc in exported])
            out = []
            for fields, parcel in got:
                req = self._submitted.setdefault(fields["rid"],
                                                 Request(**fields))
                for key, value in fields.items():
                    setattr(req, key, value)
                out.append((req, sharded.unpack(parcel, engine.mesh)))
            tm.sync()
        if exported or got:
            self.tracer.span("handoff_wire", engine._trk_engine, tm.t0,
                             tm.t1, (("suitcases", len(exported or got)),))
        return out

    def _adopt_pending(self) -> None:
        while self._pending:
            req, suitcase, n = self._pending[0]
            if self.decode.adopt(req, suitcase, n) is None:
                break                    # no slot/blocks free: retry next tick
            self._pending.pop(0)

    def _busy(self) -> bool:
        """Whether work is left (on role meshes: on some rank)."""
        pre, dec = self.prefill, self.decode
        busy = bool(self._pending
                    or pre is not None and (
                        pre._queue or pre._prefilling
                        or any(r is not None for r in pre.requests))
                    or dec is not None
                    and any(r is not None for r in dec.requests))
        return busy if self.link is None else self.link.any(busy)

    def _leftovers(self) -> list[Request]:
        """This rank's unfinished requests: in a slot of either role,
        pending, queued."""
        pre, dec = self.prefill, self.decode
        out = [r for r in pre.requests if r is not None] \
            if pre is not None else []
        if dec is not None:
            out += [r for r in dec.requests if r is not None]
        out += [r for r, _, _ in self._pending]
        return out + (list(pre._queue) if pre is not None else [])

    def _settle(self, leftovers: list[Request]) -> list[Request]:
        """Role meshes, after a run: each role's leader shares the fields of
        the requests its role finished or left unfinished, and every rank
        brings its own ``Request`` objects up to them — the decode role's
        tokens reach the prefill ranks.  Returns the unfinished requests,
        alike on every rank."""
        records = {}
        for role in ROLES:
            mine = None
            if self.link.role == role:
                mine = {r.rid: dataclasses.asdict(r) for r in
                        [r for r in self._submitted.values() if r.done]
                        + leftovers}
            records.update(self.link.share(mine, role))
        unfinished = []
        for rid, fields in records.items():
            req = self._submitted.pop(rid)
            for key, value in fields.items():
                setattr(req, key, value)
            if not req.done:
                unfinished.append(req)
        return unfinished

    def run(self, requests: list[Request], max_steps: int = 10_000,
            on_truncate: str = "warn") -> list[Request]:
        """Serve ``requests`` to completion (or ``max_steps`` coordinator
        ticks); the contract of ``ServeEngine.run``.  On role meshes every
        rank passes the same requests and gets them back completed."""
        if on_truncate not in ("warn", "raise", "ignore"):
            raise ValueError(f"on_truncate {on_truncate!r} not in "
                             f"('warn', 'raise', 'ignore')")
        for r in requests:
            self.submit(r)
        steps = 0
        while self._busy() and steps < max_steps:
            self.step()
            steps += 1
        leftovers = self._leftovers()
        if self.link is not None:
            leftovers = self._settle(leftovers)
        if leftovers:
            fresh = [r for r in leftovers if not r.aborted]
            if self.decode is not None:
                self.decode.stats.requests_aborted += len(fresh)
            if self.prefill is not None:
                t_abort = self.tracer.now()
                for r in fresh:
                    self.tracer.instant("abort", self.prefill._trk_req,
                                        t_abort, (("rid", r.rid),))
            for r in leftovers:
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
        for engine in self._engines():
            engine.reset_stats()
        self.wall_time_s = 0.0
        self.ticks = 0

    def recompiles_since(self, warm: dict) -> int:
        """Growth of either role's compiled programs since a ``summary()``
        taken right after warmup — the zero-recompile gate."""
        cur = self.summary()
        rec = 0
        for role in ROLES:
            w, c = warm["roles"][role], cur["roles"][role]
            rec += (c["prefill_compiles"] - w["prefill_compiles"]) \
                + (c["decode_compiles"] - w["decode_compiles"])
        return rec

    def _part(self, engine: ServeEngine | None) -> dict | None:
        """What the summary takes from one role engine (None: not here)."""
        if engine is None:
            return None
        st = engine.stats
        out = {"summary": st.summary(), "tokens": st.tokens_generated,
               "computed": st.prefill_tokens_computed,
               "handoffs": st.handoffs, "stalls": st.handoff_stalls,
               "handoff_s": st.handoff_time_s,
               "pending": len(self._pending), "wall": self.wall_time_s,
               "ticks": self.ticks}
        if engine.role == "decode":
            # the decode role's ticks only (asking the prefill role's
            # registry would add the histogram to it)
            tbt = st.metrics.histogram("decode_tbt_s")
            out["tbt"] = (tbt.quantile(0.5), tbt.quantile(0.99))
        return out

    def summary(self) -> dict:
        """Aggregate view: per-role summaries side by side, handoff totals,
        coordinator-wall throughput, per-role tokens/s, and the decode
        time-between-tokens quantiles.  On role meshes every rank calls it
        and gets the same view, each role's from its leader.  Each rank's
        lockstep tick waits for the other role, the decode ranks inside
        ``step`` (for the header) and the prefill ranks after it (in the
        all-reduce), so the coordinator wall is the larger of the two
        leaders' walls."""
        pre, dec = self._part(self.prefill), self._part(self.decode)
        if self.link is not None:
            pre, dec = (self.link.share(part, role)
                        for part, role in ((pre, "prefill"), (dec, "decode")))
        wall = max(pre["wall"], dec["wall"])
        return {
            "roles": {"prefill": pre["summary"], "decode": dec["summary"]},
            "requests_completed": (pre["summary"]["requests_completed"]
                                   + dec["summary"]["requests_completed"]),
            "requests_aborted": dec["summary"]["requests_aborted"],
            "tokens_generated": pre["tokens"] + dec["tokens"],
            "tokens_per_s": (pre["tokens"] + dec["tokens"]) / wall
            if wall else 0.0,
            "per_role_tokens_per_s": {
                # prefill: prompt tokens computed; decode: tokens generated
                # — each over the shared coordinator wall
                "prefill": pre["computed"] / wall if wall else 0.0,
                "decode": dec["tokens"] / wall if wall else 0.0,
            },
            "handoffs": dec["handoffs"],
            "handoffs_pending": dec["pending"],
            "handoff_stalls": dec["stalls"],
            "handoff_time_s": pre["handoff_s"] + dec["handoff_s"],
            "decode_tbt_ms": {"p50": 1e3 * dec["tbt"][0],
                              "p99": 1e3 * dec["tbt"][1]},
            "ticks": pre["ticks"],
            "wall_time_s": wall,
        }

    def metrics_prometheus(self) -> str:
        """The decode role's metrics registry in Prometheus text, as the
        reference's CLI writes it (the prefill role keeps its own); on role
        meshes every rank calls it and gets it."""
        text = self.decode.stats.metrics.to_prometheus() \
            if self.decode is not None else None
        return text if self.link is None else self.link.share(text, "decode")

    def save_trace(self, path) -> tuple[int, int] | None:
        """One Chrome trace for both roles (prefill tracks first, then
        decode's, offset by ``track_base``); returns the events written and
        the events the rings dropped.  On role meshes every rank calls it
        and global rank 0 writes it — its own events and the decode
        leader's, on the one clock of the machine's processes — and gets
        the counts (None elsewhere)."""
        dec = self.decode
        peer = None if dec is None else (
            self.tracer.tracks, self.tracer.events(), self.tracer.dropped,
            dec.stats.handoffs, dec.stats.handoff_stalls)
        if self.link is None:
            self.tracer.save(path, other_data={"disagg": {
                "handoffs": dec.stats.handoffs,
                "handoff_stalls": dec.stats.handoff_stalls}})
            return len(self.tracer), self.tracer.dropped
        tracks, events, dropped, handoffs, stalls = self.link.share(
            peer, "decode")
        if dist.get_rank() != self.link.leaders["prefill"]:
            return None
        merged = self.tracer.merged(tracks, events)
        dropped += self.tracer.dropped
        merged.save(path, other_data={
            "dropped_events": dropped,
            "disagg": {"handoffs": handoffs, "handoff_stalls": stalls}})
        return len(merged), dropped
