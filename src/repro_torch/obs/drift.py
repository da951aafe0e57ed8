"""Placement drift: measured phase latency vs the frozen plan's predictions.

A copy of the JAX package's ``obs/drift.py`` (pure Python).  The port's
``serve.placement.ExecutionOracle`` freezes a ``PlacementPlan`` with
predicted per-phase costs before the engine serves; this module is the
*runtime* side of that loop — the arithmetic that compares what the engine
measured (``obs.Timed`` sections, which synchronize with the device before
they stamp) against what the plan promised.  The predictions are those of
the paper's modeled accelerators (``core/accelerators.py``), not of the
device the port runs on, so a ratio far from 1 is expected until a
calibration fits a platform scale with the same :func:`geomean` /
:func:`residual_factor` (the JAX package's ``benchmarks/calibrate.py``).

Both sides are normalized to comparable units before the ratio:
``prefill_token_s`` (the plan predicts one full chunk; divide by the chunk
width) and ``decode_step_s`` (one lockstep tick, already per step).  A ratio
of 1.0 means the cost model nailed it on this platform; the residual factor
``exp(|log ratio|) >= 1`` is the symmetric multiplicative miss.
"""
from __future__ import annotations

import math

#: phases the drift monitor tracks (plan prediction keys normalized per unit)
PHASES = ("prefill_token_s", "decode_step_s")


def geomean(xs) -> float:
    """Geometric mean of positive values (the log-space fit center)."""
    xs = list(xs)
    if not xs:
        raise ValueError("geomean of an empty sequence")
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def residual_factor(ratio: float, scale: float = 1.0) -> float:
    """Symmetric multiplicative residual ``exp(|log(ratio / scale)|) >= 1``:
    2x-too-fast and 2x-too-slow both score 2.0."""
    return math.exp(abs(math.log(ratio / scale)))


def plan_predictions(placement: dict) -> dict:
    """Per-unit predicted phase times from a plan ``summary()`` dict: the
    plan predicts one full prefill chunk, so prefill normalizes per token.
    Phases without a positive prediction (fixed plans) are omitted."""
    pred = placement.get("predicted") or {}
    chunk = placement.get("prefill_chunk") or 0
    out = {}
    if pred.get("prefill_chunk_s") and chunk:
        out["prefill_token_s"] = pred["prefill_chunk_s"] / chunk
    if pred.get("decode_step_s"):
        out["decode_step_s"] = pred["decode_step_s"]
    return out


def drift_report(predicted: dict, measured: dict) -> dict:
    """Per-phase predicted/measured/ratio/residual, for every phase both
    sides have a positive value for.  Empty dict when nothing is comparable
    (fixed plans, engines that have not run yet)."""
    phases = {}
    worst = 1.0
    for ph in PHASES:
        pv, mv = predicted.get(ph), measured.get(ph)
        if not pv or not mv or pv <= 0 or mv <= 0:
            continue
        ratio = mv / pv
        rf = residual_factor(ratio)
        worst = max(worst, rf)
        phases[ph] = {"predicted": pv, "measured": mv, "ratio": ratio,
                      "residual_factor": rf}
    if not phases:
        return {}
    return {"phases": phases, "max_residual_factor": worst}
