"""Level-B Mensa: the two-phase scheduler operating on datacenter execution
strategies instead of physical accelerators — a copy of
``repro.core.strategy``, priced on the H100 (``core/h100.H100_SXM``) where
the reference prices a TPU v5e.

Every block class of an architecture is characterized with the SAME
machinery as the edge models (LayerSpec -> cluster), then assigned an
execution strategy template:

  * ``pascal_tp``  — Megatron tensor parallelism on the `model` axis
    (compute-centric clusters 1/2: big matmuls, high reuse).
  * ``pascal_dp``  — pure data parallelism, params replicated, batch sharded
    over every mesh axis (when the layer's parallel dims don't divide the
    model axis — e.g. 9 attention heads on a 16-way axis — TP replicates
    compute and DP is strictly better).
  * ``jacquard_shard`` — weight-stationary sharding for huge low-reuse tables
    (vocab embeddings, MoE expert banks): weights sharded on `model`, never
    gathered; tokens move instead.
  * ``pavlov_seq`` — recurrent layers: width on `model`, sequence local,
    weights resident across the scan.

Phase 1 picks per block class by an analytic cost model (compute / memory /
collective terms).  Phase 2 walks adjacent block classes and merges
strategies when the resharding (layout-change) collective cost exceeds the
in-place efficiency loss — the paper's §4.2 algorithm with "activation
transfer through DRAM" replaced by "resharding collective on the link".

The plan prices a mesh of H100 SXM cards (``MeshShape``, 16 x 16 by default:
256 cards, the largest NVLink domain of NVIDIA's NVLink Switch System) with
the datasheet's constants: bf16 dense peak, HBM bandwidth, NVLink one way,
and a usable HBM budget.  It is a model: none of its seconds is a time
measured on a card, and the port runs on one card.  The arithmetic is the
reference's, term for term; at the reference's constants it returns the
reference's plan, and where the reference cannot plan a cell (``min()`` of
an empty candidate dict, e.g. 4 experts on a 16-way model axis with too
little batch for data parallelism) neither can this copy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..models.model_config import ArchConfig
from .characterize import characterize_layer
from .clustering import rule_cluster
from .h100 import H100_SXM
from .layerspec import LayerKind, LayerSpec

# H100 SXM constants (per card) — magnitudes live in core/h100.py
PEAK_FLOPS = H100_SXM.peak_flops
HBM_BW = H100_SXM.hbm_bw
LINK_BW = H100_SXM.link_bw
BYTES = 2.0  # bf16


@dataclass(frozen=True)
class MeshShape:
    data: int = 16
    model: int = 16

    @property
    def devices(self) -> int:
        return self.data * self.model


@dataclass
class BlockClassPlan:
    name: str                  # "attn", "ffn", "moe", "rec", "ssm", "embed"
    cluster: int               # Mensa cluster id (1..5)
    strategy: str              # chosen strategy template
    candidates: dict = field(default_factory=dict)   # strategy -> est. seconds
    reason: str = ""


@dataclass
class MensaPlan:
    arch: str
    shape: str
    blocks: list[BlockClassPlan]
    phase2_merges: list[str] = field(default_factory=list)

    def strategy_for(self, name: str) -> str:
        for b in self.blocks:
            if b.name == name:
                return b.strategy
        return "pascal_tp"

    def summary(self) -> str:
        lines = [f"MensaPlan[{self.arch} x {self.shape}]"]
        for b in self.blocks:
            cand = ", ".join(f"{k}={v*1e3:.2f}ms" for k, v in
                             sorted(b.candidates.items(), key=lambda kv: kv[1]))
            lines.append(f"  {b.name:8s} cluster={b.cluster} -> {b.strategy}"
                         f"  ({cand})  {b.reason}")
        for m in self.phase2_merges:
            lines.append(f"  phase2: {m}")
        return "\n".join(lines)


def _block_specs(cfg: ArchConfig, tokens: int, batch: int) -> list[tuple[str, LayerSpec]]:
    """One LayerSpec per distinct block class (per-layer granularity, bf16)."""
    B = dict(bytes_per_param=BYTES, bytes_per_act=BYTES, batch=batch)
    seq = max(tokens // max(batch, 1), 1)
    out: list[tuple[str, LayerSpec]] = []
    kinds = set(cfg.layer_kinds)
    if kinds & {"attn", "local", "dec", "enc"}:
        out.append(("attn", LayerSpec(
            name="attn", kind=LayerKind.ATTENTION, hidden=cfg.d_model,
            heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, seq_len=seq,
            window=cfg.window, in_features=cfg.d_model, **B)))
    if cfg.ffn_kind in ("glu", "mlp"):
        out.append(("ffn", LayerSpec(
            name="ffn", kind=LayerKind.FC, in_features=cfg.d_model,
            out_features=3 * cfg.d_ff if cfg.ffn_kind == "glu" else 2 * cfg.d_ff,
            **{**B, "batch": tokens})))
    if cfg.ffn_kind == "moe":
        out.append(("moe", LayerSpec(
            name="moe", kind=LayerKind.MOE, in_features=cfg.d_model,
            hidden=cfg.d_ff, experts=cfg.num_experts, top_k=cfg.top_k,
            seq_len=seq, **B)))
    if "rec" in kinds:
        out.append(("rec", LayerSpec(
            name="rec", kind=LayerKind.RGLRU, in_features=cfg.d_model,
            hidden=cfg.d_rnn, seq_len=seq, **B)))
    if "ssm" in kinds:
        out.append(("ssm", LayerSpec(
            name="ssm", kind=LayerKind.SSM, in_features=cfg.d_model,
            hidden=cfg.d_inner, state=cfg.d_state, seq_len=seq, **B)))
    out.append(("embed", LayerSpec(
        name="embed", kind=LayerKind.EMBEDDING, vocab=cfg.vocab_padded,
        out_features=cfg.d_model, seq_len=seq, **B)))
    return out


HBM_BUDGET = H100_SXM.hbm_budget   # usable bytes/card for params+optimizer


def _ring_allreduce_wire(bytes_per_participant: float, group: int) -> float:
    """Per-device wire bytes of a ring all-reduce (RS + AG)."""
    return 2.0 * bytes_per_participant * (group - 1) / max(group, 1)


def _est_strategy_cost(name: str, spec: LayerSpec, strat: str,
                       mesh: MeshShape, train: bool,
                       layers_of_class: int = 1) -> float | None:
    """Per-layer step-time estimate (seconds) under a strategy. None = illegal
    (indivisible dims or out of HBM budget)."""
    flops = spec.flops * (3.0 if train else 1.0)      # bwd ~ 2x fwd
    n = mesh.devices
    tokens = spec.batch * max(spec.seq_len, 1)
    # block OUTPUT activation (d_model wide) — what inter-block collectives move
    block_out = tokens * max(spec.in_features, 1) * BYTES
    # per-parameter HBM bytes: bf16 weights; training adds fp32 master+m+v
    pmem_mult = 6.0 if train else 1.0

    def t(compute_shards, comm_bytes_per_dev, param_shards):
        tc = flops / compute_shards / PEAK_FLOPS
        tm = (spec.param_bytes / param_shards
              + (spec.in_act_bytes + spec.out_act_bytes) / n) / HBM_BW
        tx = comm_bytes_per_dev / LINK_BW
        return max(tc, tm) + tx

    if strat == "pascal_tp":
        if spec.kind is LayerKind.ATTENTION and spec.heads % mesh.model:
            # heads don't divide: the attention core is replicated over
            # `model`; only projections shard. Model as compute over data only.
            shards = mesh.data
        else:
            shards = n
        # megatron pair: 2 output all-reduces per layer fwd (x2 with bwd),
        # over the model axis, on data-sharded activations
        ar = _ring_allreduce_wire(block_out / mesh.data, mesh.model)
        comm = (4 if train else 2) * ar
        return t(shards, comm, param_shards=n)
    if strat == "pascal_dp":
        if tokens < n:
            return None                       # not enough batch to shard
        if spec.param_bytes * pmem_mult * layers_of_class > HBM_BUDGET:
            return None                       # replicated params do not fit
        comm = _ring_allreduce_wire(2 * spec.param_bytes, n) if train else 0.0
        return t(n, comm, param_shards=1)
    if strat == "jacquard_shard":
        if spec.kind is LayerKind.MOE:
            if spec.experts % mesh.model:
                return None
            # all-to-all token dispatch on the model axis, in + combine
            comm = 2 * (block_out / n) * spec.top_k
            if train:
                comm *= 2
            return t(n, comm, param_shards=n)
        if spec.kind is LayerKind.EMBEDDING:
            # vocab-sharded: masked local lookup + all-reduce of outputs
            comm = _ring_allreduce_wire(block_out / mesh.data, mesh.model)
            return t(n, comm, param_shards=n)
        return None
    if strat == "pavlov_seq":
        if spec.kind not in (LayerKind.RGLRU, LayerKind.SSM, LayerKind.LSTM):
            return None
        if spec.hidden % mesh.model:
            return None
        # width on model, batch on data; one gate psum per layer
        ar = _ring_allreduce_wire(block_out / mesh.data, mesh.model)
        comm = (2 if train else 1) * ar
        return t(n, comm, param_shards=n)
    return None


_CANDIDATES = {
    "attn": ("pascal_tp", "pascal_dp"),
    "ffn": ("pascal_tp", "pascal_dp"),
    "moe": ("jacquard_shard", "pascal_dp"),
    "rec": ("pavlov_seq", "pascal_dp"),
    "ssm": ("pavlov_seq", "pascal_dp"),
    "embed": ("jacquard_shard", "pascal_dp"),
}


def plan(cfg: ArchConfig, *, tokens: int, batch: int, train: bool,
         mesh: MeshShape = MeshShape(), shape_name: str = "") -> MensaPlan:
    blocks = []
    n_layers = max(cfg.num_layers, 1)
    for name, spec in _block_specs(cfg, tokens, batch):
        chars = characterize_layer(cfg.name, 0, spec)
        cluster = rule_cluster(chars).cluster
        cands = {}
        for strat in _CANDIDATES[name]:
            c = _est_strategy_cost(name, spec, strat, mesh, train,
                                   layers_of_class=n_layers
                                   if name != "embed" else 1)
            if c is not None:
                cands[strat] = c
        best = min(cands, key=cands.get)
        reason = ""
        if name == "attn" and cfg.num_heads % mesh.model:
            reason = (f"{cfg.num_heads} heads do not divide model={mesh.model}"
                      f" -> TP replicates attention compute")
        blocks.append(BlockClassPlan(name, cluster, best, cands, reason))

    plan_ = MensaPlan(cfg.name, shape_name, blocks)
    # ---- phase 2: unify adjacent strategies when resharding dominates
    # adjacent pairs execute once per layer; a layout change moves the whole
    # activation (all-to-all ~ act_bytes/devices per device).
    act_bytes = tokens * cfg.d_model * BYTES
    reshard_s = (act_bytes / mesh.devices) / LINK_BW
    by_name = {b.name: b for b in blocks}
    order = [k for k in ("attn", "ffn", "moe", "rec", "ssm") if k in by_name]
    for a, b in zip(order, order[1:]):
        pa, pb = by_name[a], by_name[b]
        if (pa.strategy == "pascal_dp") != (pb.strategy == "pascal_dp"):
            # batch-layout change between blocks: price it
            keep = pb.candidates[pb.strategy] + 2 * reshard_s
            move = pb.candidates.get(pa.strategy)
            if move is not None and move < keep:
                plan_.phase2_merges.append(
                    f"{b}: {pb.strategy} -> {pa.strategy} "
                    f"(reshard {2 * reshard_s * 1e3:.2f}ms dominates)")
                pb.strategy = pa.strategy
    return plan_
