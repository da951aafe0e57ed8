"""Cost-model-driven serving placement — the online Mensa oracle.

The port's copy of the JAX package's ``serve/placement.py``.  It closes the
loop between the paper's characterization machinery (``core/characterize``,
``core/clustering``, ``core/costmodel``, the accelerator configs in
``core/accelerators``) and the serving engine.  The ``ExecutionOracle``:

  1. builds one ``LayerSpec`` per served layer at the engine's actual
     geometry (prefill chunks at batch 1, lockstep decode at ``slots`` x 1
     token against ``max_len`` of KV) and characterizes each via
     ``characterize_layer``;
  2. clusters the layers with the paper's ``rule_cluster`` boxes and verifies
     the grouping against a seeded ``kmeans_cluster`` run (the agreement
     score is recorded on the plan);
  3. prices every layer on its cluster's designated Mensa accelerator with
     ``layer_cost`` and emits one ``ExecutionPolicy`` per cluster — prefill
     chunk, bucket ladder, the kernels that run it —
     rolled up into a whole-engine ``PlacementPlan`` with predicted
     per-phase latency.

The plan decides geometry (buckets and the prefill chunk), never what the
engine computes: it is resolved before the engine serves and is immutable
afterwards, and the chunked-prefill-equals-one-shot invariant makes every
geometry token-identical.  Its predictions are of the paper's modeled
accelerators, not of the device the port runs on.

One difference from the JAX package, in ``_kernel_for``: the plan's backend
is the device type the engine runs on.  On ``"cuda"`` every cluster's
kernel is ``"cuda"``, with the port's hand-written kernels that its layers
launch as variants; on ``"cpu"`` it is ``"plain"``.  This is display
metadata only: the port has no kernel-variant knobs, so the per-phase
override tuples stay empty, and each kernel wrapper picks the kernel or its
plain version from the device of the tensors it gets.  ``mesh_axes``
(the serving mesh's, ``launch/mesh.py``) sets each cluster's
``sharding_axis`` as the JAX package's does: ``"model"`` for a
compute-centric cluster, ``"data"`` for a memory-centric one, else the
first axis; with no mesh axes every ``sharding_axis`` is ``None``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..core.accelerators import CLUSTER_TO_ACCELERATOR
from ..core.characterize import LayerCharacteristics, characterize_layer
from ..core.clustering import agreement, kmeans_cluster, rule_cluster
from ..core.costmodel import layer_cost
from ..core.layerspec import LayerKind, LayerSpec
from ..models.model_config import ArchConfig

BYTES = 2.0  # serving runs bf16 activations/params

# The port's hand-written kernels that each block kind's layers launch on the
# card — display metadata for stats, --policy-dump and docs; the wrappers
# route on the tensors' device themselves.  Paged decode runs only for
# full-attention layers over a paged KV pool; a sliding-window ring (and a
# dense cache) decodes in plain PyTorch.  The port serves no "dec"/"enc"
# layers yet.
_CUDA_VARIANTS = {
    "attn": ("cuda_flash", "cuda_paged"),
    "local": ("cuda_flash",),
    "rec": ("cuda_rglru",),
    "ssm": ("cuda_ssm",),
}


def _bucket_ladder(max_len: int, min_bucket: int = 16,
                   max_bucket: int | None = None) -> tuple[int, ...]:
    top = min(max_bucket, max_len) if max_bucket else max_len
    # engine.prefill_buckets is the single source of truth for the ladder
    # shape; imported lazily because serve/engine.py consumes this module.
    from .engine import prefill_buckets
    return prefill_buckets(top, min_bucket)


# ------------------------------------------------------------------ policies
@dataclass(frozen=True)
class ExecutionPolicy:
    """Per-cluster execution decision: how one group of layers should run."""

    cluster: int                      # Mensa cluster id (1..5)
    kinds: tuple[str, ...]            # block kinds governed by this policy
    accelerator: str                  # designated Mensa accelerator (paper map)
    kernel: str                       # "cuda" | "plain"
    variants: tuple[str, ...]         # concrete kernels, e.g. "cuda_flash"
    prefill_chunk: int                # chunk width this cluster wants per tick
    buckets: tuple[int, ...]          # prompt bucket ladder
    sharding_axis: str | None         # preferred mesh axis; None: no mesh
    predicted_prefill_s: float        # summed layer_cost, one prefill chunk
    predicted_decode_s: float         # summed layer_cost, one decode step
    note: str = ""                    # why a kernel was (not) selected

    def summary(self) -> dict:
        out = {
            "cluster": self.cluster,
            "kinds": list(self.kinds),
            "accelerator": self.accelerator,
            "kernel": self.kernel,
            "variants": list(self.variants),
            "prefill_chunk": self.prefill_chunk,
            "sharding_axis": self.sharding_axis,
            "predicted_prefill_s": self.predicted_prefill_s,
            "predicted_decode_s": self.predicted_decode_s,
        }
        if self.note:
            out["note"] = self.note
        return out


@dataclass(frozen=True)
class PlacementPlan:
    """Whole-engine resolution of per-cluster policies.

    Frozen and tuple-valued on purpose: a plan is resolved once, before the
    engine serves anything, and two plans for the same (arch, geometry,
    backend) compare equal — the determinism the tests pin down.
    """

    arch: str
    source: str                       # "auto" (oracle) | "fixed" (constructor knobs)
    backend: str                      # backend kernels were resolved against
    policies: tuple[ExecutionPolicy, ...] = ()
    layer_kinds: tuple[str, ...] = ()
    layer_clusters: tuple[int, ...] = ()   # cluster id per model layer
    buckets: tuple[int, ...] = ()
    prefill_chunk: int = 0
    sharding_axis: str | None = None
    # ArchConfig override items ({knob: impl}), per phase — all RUNTIME_SAFE
    prefill_overrides: tuple[tuple[str, str], ...] = ()
    decode_overrides: tuple[tuple[str, str], ...] = ()
    predicted_prefill_s: float = 0.0  # whole model, one full prefill chunk
    predicted_decode_s: float = 0.0   # whole model, one lockstep decode step
    rule_kmeans_agreement: float = 0.0
    # per-role engine knobs for disaggregated serving (serve/disagg.py):
    # (("prefill", (("buckets", (...)), ("prefill_chunk", n))), ("decode", ()))
    # — a dedicated prefill submesh has no decoders to protect, so its chunk
    # is freed from the decode-latency bound the interleaved chunk obeys
    role_knobs: tuple = ()

    @property
    def per_role(self) -> dict:
        """``{"prefill": {...}, "decode": {...}}`` view of ``role_knobs``."""
        return {role: dict(kv) for role, kv in self.role_knobs}

    @property
    def prefill_cfg_overrides(self) -> dict:
        return dict(self.prefill_overrides)

    @property
    def decode_cfg_overrides(self) -> dict:
        return dict(self.decode_overrides)

    def policy_for(self, kind: str) -> ExecutionPolicy | None:
        for p in self.policies:
            if kind in p.kinds:
                return p
        return None

    def summary(self) -> dict:
        """JSON-able view — EngineStats `placement` section / --policy-dump."""
        return {
            "arch": self.arch,
            "source": self.source,
            "backend": self.backend,
            "buckets": list(self.buckets),
            "prefill_chunk": self.prefill_chunk,
            "sharding_axis": self.sharding_axis,
            "layer_clusters": list(self.layer_clusters),
            "layer_kinds": list(self.layer_kinds),
            "policies": [p.summary() for p in self.policies],
            "prefill_overrides": dict(self.prefill_overrides),
            "decode_overrides": dict(self.decode_overrides),
            "predicted": {
                "prefill_chunk_s": self.predicted_prefill_s,
                "decode_step_s": self.predicted_decode_s,
            },
            "rule_kmeans_agreement": self.rule_kmeans_agreement,
            "role_knobs": {role: dict(kv) for role, kv in self.role_knobs},
        }

    def dumps(self, indent: int = 2) -> str:
        return json.dumps(self.summary(), indent=indent, sort_keys=True)


def fixed_plan(cfg: ArchConfig, *, buckets: tuple[int, ...],
               prefill_chunk: int, backend: str = "") -> PlacementPlan:
    """The no-oracle plan: records the constructor-global knobs so EngineStats
    always has a placement section, but decides nothing."""
    return PlacementPlan(
        arch=cfg.name, source="fixed", backend=backend,
        layer_kinds=tuple(cfg.layer_kinds),
        buckets=tuple(buckets), prefill_chunk=int(prefill_chunk))


# -------------------------------------------------------------------- oracle
@dataclass
class ExecutionOracle:
    """Characterize -> cluster -> cost -> per-cluster `ExecutionPolicy`.

    Pure given its inputs: the same (cfg, geometry, backend, seed) always
    resolves to the same `PlacementPlan` — `resolve()` touches no global
    state and no clocks, so its decisions are reproducible.
    """

    cfg: ArchConfig
    slots: int = 4
    max_len: int = 512
    min_bucket: int = 16
    max_bucket: int | None = None
    mesh_axes: tuple[str, ...] = ()   # e.g. ("data", "model"); () = no mesh
    backend: str = "cuda"             # the engine's device type: cuda | cpu
    seed: int = 0                     # k-means verification seed
    _chars: list = field(default_factory=list, repr=False)

    # ---------------------------------------------------------- layer specs
    def _spec(self, kind: str, *, seq: int, batch: int,
              kv_len: int = 0) -> LayerSpec:
        """One LayerSpec for one block class at an explicit serving geometry
        (mirrors the JAX package's core/strategy._block_specs, but
        phase-aware: decode runs seq=1 against kv_len of context)."""
        cfg = self.cfg
        B = dict(bytes_per_param=BYTES, bytes_per_act=BYTES, batch=batch)
        if kind in ("attn", "local", "dec", "enc"):
            return LayerSpec(
                name=kind, kind=LayerKind.ATTENTION, hidden=cfg.d_model,
                heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, seq_len=seq, kv_len=kv_len,
                window=cfg.window if kind == "local" else 0,
                in_features=cfg.d_model, **B)
        if kind == "rec":
            return LayerSpec(name="rec", kind=LayerKind.RGLRU,
                             in_features=cfg.d_model, hidden=cfg.d_rnn,
                             seq_len=seq, **B)
        if kind == "ssm":
            return LayerSpec(name="ssm", kind=LayerKind.SSM,
                             in_features=cfg.d_model, hidden=cfg.d_inner,
                             state=cfg.d_state, seq_len=seq, **B)
        if kind == "ffn":
            if cfg.ffn_kind == "moe":
                return LayerSpec(name="moe", kind=LayerKind.MOE,
                                 in_features=cfg.d_model, hidden=cfg.d_ff,
                                 experts=cfg.num_experts, top_k=cfg.top_k,
                                 seq_len=seq, **B)
            width = 3 * cfg.d_ff if cfg.ffn_kind == "glu" else 2 * cfg.d_ff
            return LayerSpec(name="ffn", kind=LayerKind.FC,
                             in_features=cfg.d_model, out_features=width,
                             **{**B, "batch": batch * seq})
        if kind == "embed":
            return LayerSpec(name="embed", kind=LayerKind.EMBEDDING,
                             vocab=cfg.vocab_padded, out_features=cfg.d_model,
                             seq_len=seq, **B)
        raise ValueError(f"unknown block kind {kind!r}")

    def _phase_specs(self, *, seq: int, batch: int,
                     kv_len: int = 0) -> list[tuple[int, str, LayerSpec]]:
        """(layer index, block kind, spec) for every schedulable unit: one
        primary block per layer, the FFN that follows every non-SSM layer,
        plus the embedding table."""
        cfg = self.cfg
        out: list[tuple[int, str, LayerSpec]] = []
        for i, kind in enumerate(cfg.layer_kinds):
            out.append((i, kind, self._spec(kind, seq=seq, batch=batch,
                                            kv_len=kv_len)))
            if kind != "ssm" and cfg.ffn_kind != "none":
                out.append((i, "ffn", self._spec("ffn", seq=seq, batch=batch)))
        out.append((-1, "embed", self._spec("embed", seq=seq, batch=batch)))
        return out

    # ------------------------------------------------------------ resolution
    def _characterize(self) -> list[tuple[int, str, LayerCharacteristics]]:
        """Characterize at full-context geometry (one request, max_len tokens)
        — the per-inference view the paper clusters on."""
        if not self._chars:
            for i, kind, spec in self._phase_specs(seq=self.max_len, batch=1):
                self._chars.append(
                    (i, kind, characterize_layer(self.cfg.name, i, spec)))
        return self._chars

    def _kernel_for(self, kinds: tuple[str, ...]) -> tuple[str, list, str]:
        if self.backend not in ("cuda", "cpu"):
            raise ValueError(f"backend {self.backend!r}: the port runs on "
                             f"'cuda' or 'cpu'")
        variants = sorted({v for k in kinds for v in _CUDA_VARIANTS.get(k, ())})
        if self.backend == "cpu":
            return "plain", [], ("backend 'cpu' runs the kernels' plain "
                                 "PyTorch versions" if variants else "")
        return "cuda", variants, ""

    def _sharding_axis(self, compute_centric: bool) -> str | None:
        if not self.mesh_axes:
            return None
        # compute-centric clusters want their GEMMs split on the model axis;
        # memory-centric clusters scale by replicating over data (slots)
        want = "model" if compute_centric else "data"
        if want in self.mesh_axes:
            return want
        return self.mesh_axes[0]

    def _chunk_for(self, cluster_kinds: tuple[str, ...],
                   ladder_top: int) -> int:
        """Recurrent clusters bound the per-tick scan length (decode latency
        for running slots is gated on one chunk's scan); everything else
        takes the widest chunk (fewest chunk program invocations)."""
        if any(k in ("rec", "ssm") for k in cluster_kinds):
            return max(self.min_bucket, min(ladder_top, self.cfg.scan_chunk))
        return ladder_top

    def resolve(self) -> PlacementPlan:
        cfg = self.cfg
        buckets = _bucket_ladder(self.max_len, self.min_bucket, self.max_bucket)
        chars = self._characterize()

        # rule clustering, verified against the seeded k-means run
        assignments = {}
        for i, kind, c in chars:
            assignments[(i, kind)] = rule_cluster(c).cluster
        km_agreement = agreement([c for _, _, c in chars]) if len(chars) >= 2 \
            else 1.0
        layer_clusters = tuple(assignments[(i, kind)]
                               for i, kind in enumerate(cfg.layer_kinds))

        # group block kinds by cluster id
        by_cluster: dict[int, list[str]] = {}
        for (_, kind), cid in assignments.items():
            by_cluster.setdefault(cid, [])
            if kind not in by_cluster[cid]:
                by_cluster[cid].append(kind)

        # phase geometries: one prefill chunk at batch 1; one lockstep decode
        # step over every slot against the full KV context.  The engine chunk
        # is the tightest recommendation across clusters (recurrent clusters
        # bound the per-tick scan; everything else accepts the widest chunk).
        chunk = self._chunk_for(tuple(set(cfg.layer_kinds)), buckets[-1])
        prefill_specs = self._phase_specs(seq=chunk, batch=1)
        decode_specs = self._phase_specs(seq=1, batch=self.slots,
                                         kv_len=self.max_len)

        def _phase_cost(specs, kinds) -> float:
            total = 0.0
            for i, kind, spec in specs:
                if kind not in kinds:
                    continue
                acc = CLUSTER_TO_ACCELERATOR[assignments[(i, kind)]]
                total += layer_cost(spec, acc).latency_s
            return total

        policies = []
        for cid in sorted(by_cluster):
            kinds = tuple(sorted(by_cluster[cid]))
            kernel, variants, note = self._kernel_for(kinds)
            compute_centric = any(c.compute_centric for (_, k, c) in chars
                                  if k in kinds)
            policies.append(ExecutionPolicy(
                cluster=cid, kinds=kinds,
                accelerator=CLUSTER_TO_ACCELERATOR[cid].name,
                kernel=kernel, variants=tuple(variants),
                prefill_chunk=self._chunk_for(kinds, buckets[-1]),
                buckets=buckets,
                sharding_axis=self._sharding_axis(compute_centric),
                predicted_prefill_s=_phase_cost(prefill_specs, set(kinds)),
                predicted_decode_s=_phase_cost(decode_specs, set(kinds)),
                note=note))

        all_kinds = {k for _, k, _ in chars}
        plan_axis = None
        if self.mesh_axes:
            axes = [p.sharding_axis for p in policies if p.sharding_axis]
            plan_axis = ("model" if "model" in axes else
                         (axes[0] if axes else self.mesh_axes[0]))
        # per-role knobs for the disaggregated pair: the interleaved chunk
        # above is bounded by the recurrent scan so a long prompt can't
        # freeze running decoders — a dedicated prefill submesh has none, so
        # its chunk widens to the full ladder top (fewest chunk invocations;
        # token-identical by the chunked==unchunked prefill invariant).  The
        # decode role takes no prefill knobs at all.
        role_knobs = (("prefill", (("buckets", buckets),
                                   ("prefill_chunk", buckets[-1]))),
                      ("decode", ()))
        return PlacementPlan(
            arch=cfg.name, source="auto", backend=self.backend,
            policies=tuple(policies),
            layer_kinds=tuple(cfg.layer_kinds),
            layer_clusters=layer_clusters,
            buckets=buckets, prefill_chunk=chunk,
            sharding_axis=plan_axis,
            predicted_prefill_s=_phase_cost(prefill_specs, all_kinds),
            predicted_decode_s=_phase_cost(decode_specs, all_kinds),
            rule_kmeans_agreement=km_agreement,
            role_knobs=role_knobs)


def resolve_policy(cfg: ArchConfig, **kw) -> PlacementPlan:
    """Convenience wrapper: one-shot oracle resolution (the reference's
    entry point, kept for the parity tests; the CLI builds its oracle in
    ``launch.serve``)."""
    return ExecutionOracle(cfg, **kw).resolve()


def verify_kmeans_agreement(cfg: ArchConfig, *, max_len: int = 512,
                            seed: int = 0, min_agreement: float = 0.5) -> float:
    """Assert the rule clusters are recoverable by the seeded k-means run for
    a served arch — the reproducibility check the tests pin per arch."""
    oracle = ExecutionOracle(cfg, max_len=max_len, seed=seed, backend="cpu")
    chars = [c for _, _, c in oracle._characterize()]
    labels_a, _ = kmeans_cluster(chars, seed=seed)
    labels_b, _ = kmeans_cluster(chars, seed=seed)
    if list(labels_a) != list(labels_b):
        raise AssertionError("kmeans_cluster is not deterministic under a seed")
    score = agreement(chars)
    if score < min_agreement:
        raise AssertionError(
            f"rule-vs-kmeans agreement {score:.2f} < {min_agreement} "
            f"for {cfg.name}")
    return score
