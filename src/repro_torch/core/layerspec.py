"""Typed per-layer DAG used by the Mensa characterization/scheduling pipeline.

A ``LayerSpec`` describes one schedulable unit of work (one NN layer) exactly the
way the paper characterizes it: its kind, its tensor shapes, and enough structure
to derive MACs, parameter/activation footprints, and reuse.  A ``ModelGraph`` is a
DAG of layers (edges carry the activation bytes that flow between layers — the
quantity the phase-2 scheduler prices).

All byte quantities honor ``bytes_per_param`` / ``bytes_per_act`` so the same specs
serve the paper's int8 edge models (1 B) and the TPU-level bf16 models (2 B).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class LayerKind(enum.Enum):
    CONV2D = "conv2d"            # standard convolution
    DWCONV2D = "dwconv2d"        # depthwise convolution
    PWCONV2D = "pwconv2d"        # pointwise (1x1) convolution
    FC = "fc"                    # fully connected / dense
    LSTM = "lstm"                # full LSTM layer (4 gates, T steps)
    EMBEDDING = "embedding"      # table lookup
    POOL = "pool"                # pooling (negligible params)
    ATTENTION = "attention"      # (self/cross) attention core
    RGLRU = "rglru"              # gated linear recurrence (Griffin/RecurrentGemma)
    SSM = "ssm"                  # Mamba-style selective scan
    MOE = "moe"                  # mixture-of-experts FFN
    NORM = "norm"                # layernorm/rmsnorm
    ELEMENTWISE = "elementwise"  # residual add / activation glue


@dataclass(frozen=True)
class LayerSpec:
    """One layer, with everything the characterizer needs.

    Shapes use the conventions:
      CONV2D/DWCONV2D/PWCONV2D: in_hw, in_ch, out_ch, kernel, stride
      FC: in_features, out_features
      LSTM: in_features (x_t dim), hidden (h dim), seq_len
      EMBEDDING: vocab (rows), out_features (dim), seq_len tokens looked up
      ATTENTION: hidden=d_model, heads, kv_heads, head_dim, seq_len, kv_len, window
      RGLRU/SSM: in_features=d_model, hidden=d_inner, seq_len, state (SSM state dim)
      MOE: in_features=d_model, hidden=d_ff, experts, top_k
    """

    name: str
    kind: LayerKind
    # generic dims (0 when unused)
    in_hw: int = 0
    in_ch: int = 0
    out_ch: int = 0
    kernel: int = 1
    stride: int = 1
    in_features: int = 0
    out_features: int = 0
    hidden: int = 0
    seq_len: int = 1
    kv_len: int = 0
    heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0
    window: int = 0
    vocab: int = 0
    experts: int = 0
    top_k: int = 0
    state: int = 0
    batch: int = 1
    bytes_per_param: float = 1.0   # int8 edge models: 1 byte
    bytes_per_act: float = 1.0

    # ------------------------------------------------------------------ shapes
    @property
    def out_hw(self) -> int:
        if self.kind in (LayerKind.CONV2D, LayerKind.DWCONV2D, LayerKind.PWCONV2D,
                         LayerKind.POOL):
            return max(1, self.in_hw // self.stride)
        return 0

    # ------------------------------------------------------------------ params
    @property
    def param_count(self) -> int:
        k = self.kind
        if k is LayerKind.CONV2D:
            return self.kernel * self.kernel * self.in_ch * self.out_ch
        if k is LayerKind.DWCONV2D:
            return self.kernel * self.kernel * self.in_ch
        if k is LayerKind.PWCONV2D:
            return self.in_ch * self.out_ch
        if k is LayerKind.FC:
            return self.in_features * self.out_features
        if k is LayerKind.LSTM:
            # 4 gates x (W_x: in->hidden, W_h: hidden->hidden)
            return 4 * (self.in_features * self.hidden + self.hidden * self.hidden)
        if k is LayerKind.EMBEDDING:
            return self.vocab * self.out_features
        if k is LayerKind.ATTENTION:
            d = self.hidden
            q = self.heads * self.head_dim
            kv = self.kv_heads * self.head_dim
            return d * q + 2 * d * kv + q * d  # Wq, Wk, Wv, Wo
        if k is LayerKind.RGLRU:
            # input/gate projections + recurrent gates (diagonal recurrence)
            return 2 * self.in_features * self.hidden + 3 * self.hidden
        if k is LayerKind.SSM:
            d_in, d_state = self.hidden, self.state
            # in_proj (x2 branches) + dt/B/C proj + out_proj + conv
            return (2 * self.in_features * d_in + d_in * (2 * d_state + 1)
                    + d_in * self.in_features + 4 * d_in)
        if k is LayerKind.MOE:
            return self.experts * 3 * self.in_features * self.hidden \
                + self.in_features * self.experts  # router
        if k is LayerKind.NORM:
            return self.in_features
        return 0

    @property
    def param_bytes(self) -> float:
        return self.param_count * self.bytes_per_param

    # -------------------------------------------------------------------- MACs
    @property
    def macs(self) -> int:
        """Multiply-accumulate count for one inference pass (batch included)."""
        b, k = self.batch, self.kind
        if k is LayerKind.CONV2D:
            return b * self.out_hw * self.out_hw * self.out_ch \
                * self.kernel * self.kernel * self.in_ch
        if k is LayerKind.DWCONV2D:
            return b * self.out_hw * self.out_hw * self.in_ch * self.kernel * self.kernel
        if k is LayerKind.PWCONV2D:
            return b * self.out_hw * self.out_hw * self.in_ch * self.out_ch
        if k is LayerKind.FC:
            return b * self.in_features * self.out_features
        if k is LayerKind.LSTM:
            return b * self.seq_len * 4 * (self.in_features * self.hidden
                                           + self.hidden * self.hidden)
        if k is LayerKind.EMBEDDING:
            return 0
        if k is LayerKind.ATTENTION:
            d = self.hidden
            q = self.heads * self.head_dim
            kv = self.kv_heads * self.head_dim
            proj = b * self.seq_len * (d * q + 2 * d * kv + q * d)
            ctx = self.kv_len if self.kv_len else self.seq_len
            if self.window:
                ctx = min(ctx, self.window)
            score = b * self.heads * self.seq_len * ctx * self.head_dim * 2
            return proj + score
        if k is LayerKind.RGLRU:
            return b * self.seq_len * (2 * self.in_features * self.hidden
                                       + 4 * self.hidden)
        if k is LayerKind.SSM:
            d_in, d_state = self.hidden, self.state
            per_tok = (2 * self.in_features * d_in + d_in * (2 * d_state + 1)
                       + d_in * self.in_features + 2 * d_in * d_state + 4 * d_in)
            return b * self.seq_len * per_tok
        if k is LayerKind.MOE:
            return b * self.seq_len * (self.top_k * 3 * self.in_features * self.hidden
                                       + self.in_features * self.experts)
        if k is LayerKind.POOL:
            return b * self.out_hw * self.out_hw * self.in_ch * self.kernel * self.kernel
        if k is LayerKind.NORM:
            return b * self.seq_len * self.in_features * 2
        return 0

    @property
    def flops(self) -> int:
        return 2 * self.macs

    # -------------------------------------------------------------- activations
    @property
    def in_act_elems(self) -> int:
        b, k = self.batch, self.kind
        if k in (LayerKind.CONV2D, LayerKind.PWCONV2D):
            return b * self.in_hw * self.in_hw * self.in_ch
        if k in (LayerKind.DWCONV2D, LayerKind.POOL):
            return b * self.in_hw * self.in_hw * self.in_ch
        if k is LayerKind.FC:
            return b * self.in_features
        if k is LayerKind.LSTM:
            return b * self.seq_len * self.in_features
        if k is LayerKind.EMBEDDING:
            return b * self.seq_len
        if k in (LayerKind.ATTENTION, LayerKind.RGLRU, LayerKind.SSM, LayerKind.MOE,
                 LayerKind.NORM, LayerKind.ELEMENTWISE):
            return b * self.seq_len * self.in_features if self.in_features else 0
        return 0

    @property
    def out_act_elems(self) -> int:
        b, k = self.batch, self.kind
        if k in (LayerKind.CONV2D, LayerKind.PWCONV2D):
            return b * self.out_hw * self.out_hw * self.out_ch
        if k in (LayerKind.DWCONV2D, LayerKind.POOL):
            return b * self.out_hw * self.out_hw * self.in_ch
        if k is LayerKind.FC:
            return b * self.out_features
        if k is LayerKind.LSTM:
            return b * self.seq_len * self.hidden
        if k is LayerKind.EMBEDDING:
            return b * self.seq_len * self.out_features
        if k in (LayerKind.ATTENTION, LayerKind.MOE, LayerKind.NORM,
                 LayerKind.ELEMENTWISE):
            return b * self.seq_len * (self.in_features or self.hidden)
        if k in (LayerKind.RGLRU, LayerKind.SSM):
            return b * self.seq_len * self.in_features
        return 0

    @property
    def in_act_bytes(self) -> float:
        return self.in_act_elems * self.bytes_per_act

    @property
    def out_act_bytes(self) -> float:
        return self.out_act_elems * self.bytes_per_act


@dataclass
class ModelGraph:
    """A model = named DAG of LayerSpecs. ``edges`` are (src_idx, dst_idx)."""

    name: str
    family: str                      # "cnn" | "lstm" | "transducer" | "rcnn" | ...
    layers: list[LayerSpec]
    edges: list[tuple[int, int]] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.edges and len(self.layers) > 1:
            # default: simple chain
            self.edges = [(i, i + 1) for i in range(len(self.layers) - 1)]

    # convenience aggregates ---------------------------------------------------
    @property
    def total_params(self) -> int:
        return sum(l.param_count for l in self.layers)

    @property
    def total_param_bytes(self) -> float:
        return sum(l.param_bytes for l in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def total_flops(self) -> int:
        return 2 * self.total_macs

    def successors(self, idx: int) -> list[int]:
        return [d for (s, d) in self.edges if s == idx]

    def predecessors(self, idx: int) -> list[int]:
        return [s for (s, d) in self.edges if d == idx]

    def validate(self) -> None:
        n = len(self.layers)
        for s, d in self.edges:
            if not (0 <= s < n and 0 <= d < n):
                raise ValueError(f"{self.name}: edge ({s},{d}) out of range 0..{n-1}")
            if s >= d:
                raise ValueError(f"{self.name}: edge ({s},{d}) not topologically ordered")
