"""Per-layer characterization — the paper's §3.2 analysis machinery.

For every layer we derive the characteristics the paper clusters on:
  * parameter footprint (bytes)
  * parameter FLOP/B (arithmetic intensity w.r.t. parameters — "parameter reuse")
  * MAC count
  * activation footprint (bytes, in+out)
  * activation FLOP/B ("activation reuse")
plus bookkeeping (kind, model, index) used by the scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass

from .layerspec import LayerKind, LayerSpec, ModelGraph


@dataclass(frozen=True)
class LayerCharacteristics:
    model: str
    index: int
    name: str
    kind: LayerKind
    macs: int
    flops: int
    param_bytes: float
    act_bytes: float                # in + out activations
    out_act_bytes: float
    param_flop_per_byte: float      # parameter reuse
    act_flop_per_byte: float        # activation reuse
    recurrent: bool                 # sequential inter-step dependency (LSTM/RGLRU/SSM)
    # Scheduling-unit granularity (paper §3.2.1: the accelerator schedules each
    # LSTM *gate MVM* as an FC layer; cluster boxes in §5.1 are stated at that
    # granularity — e.g. "each gate has an average of 2.1M parameters").
    sched_macs: float = 0.0
    sched_param_bytes: float = 0.0
    sched_flop_per_byte: float = 0.0

    @property
    def compute_centric(self) -> bool:
        return self.sched_flop_per_byte >= 81.0 and self.sched_macs >= 20e6


def characterize_layer(model: str, index: int, spec: LayerSpec) -> LayerCharacteristics:
    param_b = max(spec.param_bytes, 1e-9)
    act_b = max(spec.in_act_bytes + spec.out_act_bytes, 1e-9)
    flops = spec.flops
    recurrent = spec.kind in (LayerKind.LSTM, LayerKind.RGLRU, LayerKind.SSM)
    # scheduling-unit: one gate (LSTM) / one step (other recurrences) / the
    # whole layer (feed-forward kinds)
    if spec.kind is LayerKind.LSTM:
        units_space = 4.0                      # 4 gates share the footprint
        units_time = 4.0 * max(spec.seq_len, 1)
    elif recurrent:
        units_space = 1.0
        units_time = float(max(spec.seq_len, 1))
    else:
        units_space = units_time = 1.0
    s_macs = spec.macs / units_time
    s_pb = max(spec.param_bytes / units_space, 1e-9)
    return LayerCharacteristics(
        model=model,
        index=index,
        name=spec.name,
        kind=spec.kind,
        macs=spec.macs,
        flops=flops,
        param_bytes=spec.param_bytes,
        act_bytes=spec.in_act_bytes + spec.out_act_bytes,
        out_act_bytes=spec.out_act_bytes,
        param_flop_per_byte=flops / param_b,
        act_flop_per_byte=flops / act_b,
        recurrent=recurrent,
        sched_macs=s_macs,
        sched_param_bytes=spec.param_bytes / units_space,
        sched_flop_per_byte=2.0 * s_macs / s_pb,
    )


def characterize_model(graph: ModelGraph) -> list[LayerCharacteristics]:
    return [characterize_layer(graph.name, i, l) for i, l in enumerate(graph.layers)]


def characterize_zoo(graphs: list[ModelGraph]) -> list[LayerCharacteristics]:
    out: list[LayerCharacteristics] = []
    for g in graphs:
        out.extend(characterize_model(g))
    return out


# ---------------------------------------------------------------- summaries
def variation_report(chars: list[LayerCharacteristics]) -> dict:
    """Quantify intra-model variation (paper: up to 200x MACs, 244x FLOP/B)."""
    import collections
    by_model: dict[str, list[LayerCharacteristics]] = collections.defaultdict(list)
    for c in chars:
        if c.macs > 0 and c.param_bytes > 1:     # skip norm/pool glue
            by_model[c.model].append(c)
    rep = {}
    for m, cs in by_model.items():
        macs = [c.macs for c in cs]
        fpb = [c.param_flop_per_byte for c in cs]
        foot = [c.param_bytes for c in cs]
        rep[m] = {
            "n_layers": len(cs),
            "mac_variation_x": max(macs) / max(min(macs), 1),
            "flopb_variation_x": max(fpb) / max(min(fpb), 1e-9),
            "footprint_variation_x": max(foot) / max(min(foot), 1e-9),
        }
    return rep
