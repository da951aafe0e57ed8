"""The assigned input-shape sets (LM-family: seq_len x global_batch) — a
copy of ``repro.configs.shapes``.

``train_4k`` is a train step; ``prefill_32k`` a full-sequence prefill;
``decode_32k`` / ``long_500k`` a decode step (one new token against a KV
cache / recurrent state of the given length).  The execution-strategy
planner (``core/executor.py``) prices each (arch x shape) cell.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def applicable(arch_cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs; decode only
    for archs with a decoder (all of ours have one)."""
    if shape.name == "long_500k" and not arch_cfg.sub_quadratic:
        return False, "SKIP(full-attention): 512k dense KV cache is quadratic-cost"
    return True, ""
