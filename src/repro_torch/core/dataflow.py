"""Dataflow performance model — maps (layer, accelerator) to an execution profile.

This is the analytic model the paper builds for §6 ("we develop an analytical cost
model to determine the performance of each of our proposed dataflows").  For every
layer we abstract the compute as a (possibly per-timestep) GEMM of logical dims
  M (independent output positions) x K (reduction depth) x N (output channels)
and derive, per dataflow:

  * eff_map   — spatial mapping efficiency of the PE array (quantization losses,
                M=1 MVM degeneracy, depthwise's missing reduction dim, ...)
  * eff_sched — scheduling efficiency (baseline's sequential LSTM-gate scheduling
                vs. Pavlov's decoupled/parallel schedule — §3.2.1)
  * offchip_param_bytes / offchip_act_bytes — DRAM traffic after buffer filtering
  * buf_param_reads / buf_act_accesses      — on-chip buffer traffic (bytes)
  * noc_bytes — on-chip distribution traffic after multicast filtering
  * exposed_latency_s — per-dependent-fetch DRAM latency that cannot overlap
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .accelerators import AcceleratorConfig
from .layerspec import LayerKind, LayerSpec


@dataclass(frozen=True)
class GemmShape:
    m: int          # independent output positions
    k: int          # reduction depth
    n: int          # output channels
    steps: int = 1  # sequential repetitions (recurrent timesteps)
    parallel_mvms: int = 1  # independent MVMs per step (e.g. 4 LSTM gates x 2)


def gemm_shape(spec: LayerSpec) -> GemmShape:
    k = spec.kind
    if k is LayerKind.CONV2D:
        return GemmShape(m=spec.batch * spec.out_hw * spec.out_hw,
                         k=spec.kernel * spec.kernel * spec.in_ch, n=spec.out_ch)
    if k is LayerKind.PWCONV2D:
        return GemmShape(m=spec.batch * spec.out_hw * spec.out_hw,
                         k=spec.in_ch, n=spec.out_ch)
    if k is LayerKind.DWCONV2D:
        # no cross-channel reduction: N=channels but K only kernel^2
        return GemmShape(m=spec.batch * spec.out_hw * spec.out_hw,
                         k=spec.kernel * spec.kernel, n=spec.in_ch)
    if k is LayerKind.FC:
        return GemmShape(m=spec.batch, k=spec.in_features, n=spec.out_features)
    if k is LayerKind.LSTM:
        # per timestep: 4 gates x (input MVM + hidden MVM)
        return GemmShape(m=spec.batch, k=(spec.in_features + spec.hidden) // 2,
                         n=spec.hidden, steps=spec.seq_len, parallel_mvms=8)
    if k is LayerKind.RGLRU:
        return GemmShape(m=spec.batch, k=spec.in_features, n=spec.hidden,
                         steps=spec.seq_len, parallel_mvms=2)
    if k is LayerKind.SSM:
        return GemmShape(m=spec.batch, k=spec.in_features, n=spec.hidden,
                         steps=spec.seq_len, parallel_mvms=2)
    if k is LayerKind.ATTENTION:
        d = max(spec.hidden, 1)
        return GemmShape(m=spec.batch * spec.seq_len, k=d,
                         n=spec.heads * spec.head_dim or d)
    if k is LayerKind.MOE:
        return GemmShape(m=spec.batch * spec.seq_len, k=spec.in_features,
                         n=spec.hidden, parallel_mvms=spec.top_k)
    if k is LayerKind.EMBEDDING:
        return GemmShape(m=spec.batch * spec.seq_len, k=1, n=spec.out_features)
    # pool/norm/elementwise glue
    return GemmShape(m=max(spec.out_act_elems, 1), k=1, n=1)


def _quant_eff(dim: int, size: int) -> float:
    """Utilization of a hardware dimension of `size` by a logical dim `dim`."""
    if dim <= 0:
        return 1.0
    return dim / (math.ceil(dim / size) * size)


@dataclass(frozen=True)
class ExecutionProfile:
    eff_map: float
    eff_sched: float
    offchip_param_bytes: float
    offchip_act_bytes: float
    buf_param_reads: float
    buf_act_accesses: float
    noc_bytes: float
    exposed_latency_s: float
    bw_efficiency: float = 1.0   # attained fraction of DRAM peak (§5.4: access
                                 # pattern determines usable bandwidth)
    buf_param_stream: float = 0.0  # bytes staged at bank granularity (streaming)

    @property
    def offchip_bytes(self) -> float:
        return self.offchip_param_bytes + self.offchip_act_bytes


# Fraction of peak DRAM bandwidth each dataflow's access pattern attains (§5.4:
# "we cannot [use the bandwidth] simply by issuing many outstanding requests...
# if we can design our dataflow to issue *sequential* accesses, we can exploit
# this pattern to use the bandwidth... at much lower cost").  Monolithic
# buffer-tile fetch patterns are scattered; Pavlov/Jacquard stream sequentially.
BW_EFFICIENCY = {
    "output_stationary": 0.30,
    "pascal": 0.60,
    "row_stationary": 0.45,   # flexible NoC feeds the array well
    "pavlov": 0.95,
    "jacquard": 0.90,
}

# Per-scheduled-unit dispatch overhead: the baseline graph scheduler issues each
# LSTM gate MVM as a standalone FC layer (§3.2.1), paying DMA/descriptor setup
# per unit.  Mensa's dataflow-sequenced accelerators do not.
DISPATCH_OVERHEAD_S = {
    "output_stationary": 25e-6,
    "pascal": 25e-6,
    "row_stationary": 30e-6,  # incl. online NoC reconfiguration (§8 critique)
    "pavlov": 0.0,
    "jacquard": 0.0,
}


def _recurrent_param_traffic(spec: LayerSpec, acc: AcceleratorConfig,
                             decouple_input: bool) -> float:
    """Off-chip parameter traffic of a recurrent layer.

    Weights are consumed once per timestep.  Whatever fraction fits on-chip is
    fetched once; the remainder streams from DRAM every step.  Pavlov's decoupled
    schedule (§5.4) batches all input MVMs so W_x is fetched exactly once; the
    hidden-MVM weights W_h still stream per step (sequentially, which is what the
    near-data placement makes cheap).
    """
    pb = spec.param_bytes
    if spec.kind is LayerKind.LSTM:
        wx = 4 * spec.in_features * spec.hidden * spec.bytes_per_param
        wh = 4 * spec.hidden * spec.hidden * spec.bytes_per_param
    elif spec.kind in (LayerKind.RGLRU, LayerKind.SSM):
        wx, wh = pb, 0.0  # recurrence is diagonal/elementwise: no big W_h
    else:
        wx, wh = pb, 0.0
    steps = max(spec.seq_len, 1)
    if decouple_input:
        # W_x once; W_h per step unless it fits on-chip
        wh_fit = min(wh, acc.param_buf_bytes)
        return wx + wh_fit + (wh - wh_fit) * steps
    fit = min(pb, acc.param_buf_bytes)
    return fit + (pb - fit) * steps


def profile(spec: LayerSpec, acc: AcceleratorConfig) -> ExecutionProfile:
    g = gemm_shape(spec)
    rows, cols = acc.pe_rows, acc.pe_cols
    pb, df = spec.param_bytes, acc.dataflow
    in_b, out_b = spec.in_act_bytes, spec.out_act_bytes
    recurrent = spec.kind in (LayerKind.LSTM, LayerKind.RGLRU, LayerKind.SSM)
    eff_sched = 1.0
    exposed = 0.0
    noc_mult = 1.0          # on-chip distribution amplification (1 = perfect multicast)
    buf_read_mult = 1.0     # param-buffer read amplification

    # Systolic pipeline-fill efficiency: short reduction dims cannot keep a
    # dot-product spine busy (K-deep accumulation amortizes the fill bubbles).
    fill = g.k / (g.k + rows / 4)

    def _os_mapping_eff() -> float:
        """Monolithic systolic array mapping efficiency: the compiler picks the
        better of (a) output-stationary M x N spatial tiling and (b) a
        weight-streaming mapping (K on rows, N on cols, M temporal) that keeps
        the array full for skinny GEMMs but is only legal when the weights
        stream once (m small — MVM-like)."""
        eff_os = _quant_eff(g.m, rows) * _quant_eff(g.n, cols) * fill
        if g.m <= rows:
            eff_ws = _quant_eff(g.k, rows) * _quant_eff(g.n, cols)
            return max(eff_os, eff_ws)
        return eff_os

    if df in ("output_stationary",):
        eff_map = _os_mapping_eff()
        if spec.kind is LayerKind.DWCONV2D:
            # depthwise has no cross-channel reduction to fill the spine
            eff_map *= 0.5
        if recurrent:
            # gates scheduled sequentially as independent FC layers (§3.2.1)
            eff_sched = 0.5
            exposed = g.steps * g.parallel_mvms * DISPATCH_OVERHEAD_S[df]
        m_tiles = math.ceil(g.m / rows)
        buf_read_mult = float(m_tiles) if pb <= acc.param_buf_bytes else 1.0
        noc_mult = 2.0   # no multicast-optimized distribution
        if recurrent:
            off_p = _recurrent_param_traffic(spec, acc, decouple_input=False)
        else:
            off_p = pb
    elif df == "pascal":
        eff_map = _os_mapping_eff()
        if spec.kind is LayerKind.DWCONV2D:
            eff_map *= 0.7
        if recurrent:
            eff_sched = 0.6
            exposed = g.steps * g.parallel_mvms * DISPATCH_OVERHEAD_S[df]
            off_p = _recurrent_param_traffic(spec, acc, decouple_input=False)
        else:
            off_p = pb
        m_tiles = math.ceil(g.m / rows)
        # spatial multicast: one buffer read feeds all PEs in a column
        buf_read_mult = float(m_tiles) / cols if pb <= acc.param_buf_bytes else 1.0
        buf_read_mult = max(buf_read_mult, 1.0 / cols)
        noc_mult = 1.0   # multicast, no partial-sum traffic (temporal reduction)
    elif df == "pavlov":
        # each PE owns output elements; N across all PEs
        n_pes = rows * cols
        eff_map = _quant_eff(g.n, n_pes)
        eff_sched = 1.0  # decoupled input/hidden MVMs + K concurrent cell psums
        if recurrent:
            off_p = _recurrent_param_traffic(spec, acc, decouple_input=True)
            exposed = 0.0  # sequential streaming hides DRAM latency
        else:
            off_p = pb
        buf_read_mult = 0.0   # params stream DRAM->PE RF directly (512 B/PE)
        noc_mult = 1.0
    elif df == "jacquard":
        # params spatially distributed + pinned in PE RFs; reuse factor WxH
        n_pes = rows * cols
        eff_map = _quant_eff(g.k, n_pes) if g.k >= n_pes else \
            _quant_eff(g.k * min(g.n, max(1, n_pes // max(g.k, 1))), n_pes)
        if spec.kind is LayerKind.DWCONV2D:
            # §7.2: depthwise runs "less optimally" on Jacquard — its dataflow
            # targets parameter reuse, but depthwise activations have none
            eff_map = min(eff_map, 0.45)
        if recurrent:
            off_p = _recurrent_param_traffic(spec, acc, decouple_input=True)
        else:
            off_p = pb
        buf_read_mult = 1.0   # each param passes the buffer once on its way to RF
        noc_mult = 1.0
        eff_sched = 1.0
    elif df == "row_stationary":
        # Eyeriss v2: flexible mapping, good spatial efficiency even for
        # depthwise/MVM, but small array and tiny buffers
        n_pes = rows * cols
        eff_map = min(1.0, (g.m * min(g.n, 32)) / n_pes) if g.m * g.n < n_pes \
            else 0.9
        if recurrent:
            eff_sched = 0.7
            exposed = g.steps * g.parallel_mvms * DISPATCH_OVERHEAD_S[df]
            off_p = _recurrent_param_traffic(spec, acc, decouple_input=False)
        else:
            off_p = pb
        buf_read_mult = 1.0
        noc_mult = 2.0   # flexible (reconfigurable) NoC costs energy per byte
    else:
        raise ValueError(f"unknown dataflow {df}")

    # activation traffic: spill to DRAM only what the act buffer cannot hold
    act_ws = in_b + out_b
    if act_ws <= acc.act_buf_bytes:
        off_a = 0.0
    else:
        off_a = act_ws - acc.act_buf_bytes
    # paper: Mensa synchronizes cross-accelerator activations via DRAM; the
    # scheduler adds that transfer separately (phase 2), so `off_a` here is
    # intra-layer spill only.

    # Resident parameters are re-read from the (full, expensive) buffer per
    # M-tile per the dataflow's read amplification; streamed parameters are
    # staged at bank granularity on their way to the array (cheap sequential
    # bursts).  Pavlov streams DRAM->PE-RF directly and bypasses the buffer.
    if buf_read_mult <= 0.0:
        buf_param_reads, buf_stream = 0.0, 0.0
    elif pb <= acc.param_buf_bytes:
        buf_param_reads, buf_stream = pb * buf_read_mult, max(off_p - pb, 0.0)
    else:
        buf_param_reads, buf_stream = 0.0, off_p
    # OS-style dataflows re-read the input activations once per output-channel
    # tile (each N-tile sweeps the full input); Pavlov/Jacquard stream acts once.
    if df in ("output_stationary", "pascal", "row_stationary"):
        n_tiles = math.ceil(g.n / cols) if g.n else 1
        buf_act = in_b * n_tiles + out_b
    else:
        buf_act = act_ws
    noc = (buf_param_reads + buf_stream + buf_act) * noc_mult

    return ExecutionProfile(
        eff_map=max(min(eff_map, 1.0), 1e-4),
        eff_sched=eff_sched,
        offchip_param_bytes=off_p,
        offchip_act_bytes=off_a,
        buf_param_reads=buf_param_reads,
        buf_act_accesses=buf_act,
        noc_bytes=noc,
        exposed_latency_s=exposed,
        bw_efficiency=BW_EFFICIENCY[df],
        buf_param_stream=buf_stream,
    )
