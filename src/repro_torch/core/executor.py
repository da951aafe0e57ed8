"""Executor — applies a MensaPlan to the concrete launch configuration; a
copy of ``repro.core.executor`` over the port's H100-priced planner
(``core/strategy.py``).

``plan_for_cell`` derives the Mensa strategy plan for an (arch x shape) cell;
``execution_profile`` turns it into the knobs the launcher understands:

  * ``strategy``      — the global sharding profile ("tp" | "dp"): phase-2 of
    the datacenter-level scheduler collapses to one batch layout per program
    when every compute-heavy block class agrees (mixing batch layouts inside
    one step would reshard the residual stream every block — exactly the
    case the paper's phase 2 exists to veto).
  * ``cfg_overrides`` — per-cluster execution options, the reference's dict
    key for key: remat off under DP, scatter MoE dispatch for training,
    block-diagonal RG-LRU gates.

``phase_profiles`` gives the serving engines their per-phase profiles
(``launch/serve.build_engine``).  The port's ``ArchConfig`` leaves some of
the reference's knobs out (``models.model_config.LEFT_OUT_KNOBS``);
``ExecutionProfile.apply`` skips those and applies the rest.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

from ..configs.shapes import ShapeSpec
from ..models.model_config import LEFT_OUT_KNOBS, ArchConfig
from .strategy import MensaPlan, MeshShape, plan


# overrides that change only how a program runs, never parameter shapes —
# the serving engine shares one set of parameters across its prefill/decode
# models, so per-phase profiles may apply only these
RUNTIME_SAFE_KEYS = frozenset({
    "remat", "moe_impl", "unroll_scans", "scan_chunk", "attn_block_kv",
    "attn_f32", "attn_impl", "rglru_impl", "ssm_impl",
})


@dataclass(frozen=True)
class ExecutionProfile:
    arch: str
    shape: str
    strategy: str                    # "tp" | "dp"
    cfg_overrides: dict = field(default_factory=dict)
    plan: MensaPlan | None = None

    def apply(self, cfg: ArchConfig, *, runtime_only: bool = False
              ) -> ArchConfig:
        """``cfg`` with the overrides applied (``runtime_only``: only the
        ``RUNTIME_SAFE_KEYS``).  A knob the port leaves out by design
        (``LEFT_OUT_KNOBS``, e.g. ``remat``: the port never recomputes
        activations) is skipped; any other key ``cfg`` lacks raises."""
        ov = self.cfg_overrides
        if runtime_only:
            ov = {k: v for k, v in ov.items() if k in RUNTIME_SAFE_KEYS}
        have = {f.name for f in fields(cfg)}
        unknown = sorted(set(ov) - have - set(LEFT_OUT_KNOBS))
        if unknown:
            raise ValueError(f"{self.arch} x {self.shape}: overrides "
                             f"{unknown} are no ArchConfig field")
        ov = {k: v for k, v in ov.items() if k in have}
        return cfg.replace(**ov) if ov else cfg


def plan_for_cell(cfg: ArchConfig, shape: ShapeSpec,
                  mesh: MeshShape = MeshShape()) -> MensaPlan:
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return plan(cfg, tokens=tokens, batch=shape.global_batch,
                train=(shape.kind == "train"), mesh=mesh,
                shape_name=shape.name)


def execution_profile(cfg: ArchConfig, shape: ShapeSpec,
                      mesh: MeshShape = MeshShape()) -> ExecutionProfile:
    p = plan_for_cell(cfg, shape, mesh)
    # phase-2 collapse: one batch layout per program.  DP only when every
    # compute-heavy block class independently picked pascal_dp.
    heavy = [b for b in p.blocks if b.name in ("attn", "ffn", "moe", "rec",
                                               "ssm")]
    all_dp = heavy and all(b.strategy == "pascal_dp" for b in heavy)
    strategy = "dp" if all_dp else "tp"

    overrides: dict = {}
    if strategy == "dp" and shape.kind == "train":
        # the reference's measurement: DP activations fit; drop remat
        overrides["remat"] = False
    if cfg.ffn_kind == "moe" and shape.kind == "train":
        # the reference's measurement: scatter dispatch cuts the compute term
        overrides["moe_impl"] = "scatter"
    if cfg.d_rnn and cfg.d_rnn % (mesh.model or 1) == 0:
        # the reference's measurement: same collectives, fewer gate params,
        # faithful to Griffin's block-diagonal design
        overrides["rglru_gate_blocks"] = mesh.model
    return ExecutionProfile(cfg.name, shape.name, strategy, overrides, p)


def phase_profiles(cfg: ArchConfig,
                   prefill_shape: ShapeSpec | None = None,
                   decode_shape: ShapeSpec | None = None,
                   mesh: MeshShape = MeshShape(),
                   policy=None,
                   ) -> tuple[ExecutionProfile, ExecutionProfile]:
    """Per-phase serving profiles: prefill runs compute-centric (Pascal
    cluster), decode memory-centric (Jacquard/Pavlov clusters).  The serving
    engine builds one model per phase from these, over one set of
    parameters.

    ``policy`` (a ``serve.placement.PlacementPlan``, duck-typed so core stays
    import-independent of serve) merges the oracle's per-phase overrides
    into each profile; every merged key must be runtime-safe."""
    from ..configs.shapes import SHAPES
    pre = execution_profile(cfg, prefill_shape or SHAPES["prefill_32k"], mesh)
    dec = execution_profile(cfg, decode_shape or SHAPES["decode_32k"], mesh)
    if policy is not None:
        for extra in (policy.prefill_cfg_overrides, policy.decode_cfg_overrides):
            bad = set(extra) - RUNTIME_SAFE_KEYS
            if bad:
                raise ValueError(f"policy overrides {sorted(bad)} are not "
                                 "runtime-safe")
        pre = ExecutionProfile(
            pre.arch, pre.shape, pre.strategy,
            {**pre.cfg_overrides, **policy.prefill_cfg_overrides}, pre.plan)
        dec = ExecutionProfile(
            dec.arch, dec.shape, dec.strategy,
            {**dec.cfg_overrides, **policy.decode_cfg_overrides}, dec.plan)
    return pre, dec
