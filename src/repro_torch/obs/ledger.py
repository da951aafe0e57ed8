"""Persistent perf ledger: append-only run history + rolling-median trend.

The port's copy of ``repro.obs.ledger``: the same functions, constants and
``python -m repro_torch.obs.ledger`` CLI, with the same output on the same
inputs.  The port's runs go to their own file,
``results/perf_ledger_torch.jsonl``: ``results/perf_ledger.jsonl`` is the
JAX package's history, and a record measured on an H100 never goes there.

``results/`` is single-point snapshots — a committed baseline and the last
CI run — so the bench trajectory between refreshes is invisible.  The ledger
keeps it: a bench appends one schema-versioned JSON line per run
(tokens/s, TTFT p50, prefix hit rate, trace overhead, per-program
utilization, the programs compiled after warmup — the port's CUDA graphs
captured after it —, git sha), and :func:`trend_check` gates the newest
record against the rolling median of its predecessors — a history-aware
band instead of a single committed point.

Stdlib-only on purpose (no torch, no numpy): the trend check must be
runnable as a standalone blocking CI step (``python -m
repro_torch.obs.ledger``) without pulling the serving stack in.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time
from pathlib import Path

#: version of one ledger record; bump on any shape change
LEDGER_SCHEMA_VERSION = 1

#: trended metrics: (record key, "higher" | "lower" is better).  Gate-style
#: absolutes (recompiles, overhead budget) stay with the bench's own
#: assertions — the ledger trends the two throughput/latency numbers a
#: slow regression could walk past a fixed baseline.
TREND_METRICS = (("tokens_per_s", "higher"), ("ttft_p50_ms", "lower"))

#: default regression band (fraction of the rolling median) and window —
#: generous on purpose: CI-runner variance must not flag, a real regression
#: (2x latency, half throughput) must
DEFAULT_BAND = 0.5
DEFAULT_WINDOW = 8
#: records required before the trend binds (the first runs always pass)
MIN_HISTORY = 2


def git_sha(root: Path | str | None = None) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except OSError:
        pass
    return "unknown"


def make_record(*, arch: str, tokens_per_s: float, ttft_p50_ms: float,
                prefix_hit_rate: float | None = None,
                trace_overhead_frac: float | None = None,
                recompiles_after_warmup: int | None = None,
                program_utilization: dict | None = None,
                sha: str | None = None, extra: dict | None = None) -> dict:
    """One ledger line.  ``time.time()`` is the run's wall-clock identity —
    host-side file bookkeeping, nothing here touches a device."""
    rec = {
        "version": LEDGER_SCHEMA_VERSION,
        "ts": time.time(),
        "git_sha": sha if sha is not None else git_sha(),
        "arch": arch,
        "tokens_per_s": float(tokens_per_s),
        "ttft_p50_ms": float(ttft_p50_ms),
    }
    if prefix_hit_rate is not None:
        rec["prefix_hit_rate"] = float(prefix_hit_rate)
    if trace_overhead_frac is not None:
        rec["trace_overhead_frac"] = float(trace_overhead_frac)
    if recompiles_after_warmup is not None:
        rec["recompiles_after_warmup"] = int(recompiles_after_warmup)
    if program_utilization:
        rec["program_utilization"] = dict(program_utilization)
    if extra:
        rec.update(extra)
    return rec


def record_from_report(report: dict, *, sha: str | None = None,
                       extra: dict | None = None) -> dict:
    """A ledger record from a ``serve_bench`` report dict.  ``extra`` merges
    additional fields into the record (e.g. the disaggregated run's per-role
    tokens/s) without widening the schema for runs that lack them."""
    m = report["measure"]
    kv = report.get("paged_prefix", {}).get("kv") or {}
    overhead = report.get("trace_overhead") or {}
    progs = (m.get("programs") or {}).get("programs") or {}
    return make_record(
        arch=report.get("arch", "?"),
        tokens_per_s=m["tokens_per_s"],
        ttft_p50_ms=m["ttft_ms"]["p50"],
        prefix_hit_rate=kv.get("prefix_hit_rate"),
        trace_overhead_frac=overhead.get("overhead_frac"),
        recompiles_after_warmup=report.get("recompiles_after_warmup"),
        program_utilization={name: p["utilization"]
                             for name, p in sorted(progs.items())},
        sha=sha, extra=extra)


def append_record(path: Path | str, record: dict) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def read_ledger(path: Path | str) -> list[dict]:
    """All records, oldest first.  Blank lines are skipped; a malformed line
    raises — an append-only file that stopped parsing is corruption worth
    failing on, not skipping past."""
    p = Path(path)
    if not p.exists():
        return []
    out = []
    for i, line in enumerate(p.read_text().splitlines(), start=1):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            raise ValueError(f"{p}:{i}: malformed ledger line: {e}") from e
    return out


def trend_check(records: list[dict], *, band: float = DEFAULT_BAND,
                window: int = DEFAULT_WINDOW,
                min_history: int = MIN_HISTORY,
                metrics=TREND_METRICS) -> dict:
    """Gate the newest record against the rolling median of its history.

    For each ``(key, direction)`` in ``metrics``, takes the last ``window``
    prior records carrying the key; with fewer than ``min_history`` the
    check passes vacuously (the band has to have a history to be relative
    to).  "higher"-is-better fails when the latest value falls below
    ``(1 - band) * median``; "lower"-is-better when it rises above
    ``(1 + band) * median``."""
    if not 0.0 < band:
        raise ValueError(f"band must be positive, got {band}")
    if not records:
        return {"ok": True, "band": band, "runs": 0, "checks": []}
    latest = records[-1]
    checks = []
    for key, direction in metrics:
        history = [r[key] for r in records[:-1] if key in r][-window:]
        cur = latest.get(key)
        c = {"metric": key, "direction": direction, "current": cur,
             "history": len(history)}
        if cur is None or len(history) < min_history:
            c.update(ok=True, median=None, bound=None)
        else:
            med = statistics.median(history)
            if direction == "higher":
                bound = (1.0 - band) * med
                ok = cur >= bound
            else:
                bound = (1.0 + band) * med
                ok = cur <= bound
            c.update(ok=ok, median=med, bound=bound)
        checks.append(c)
    return {"ok": all(c["ok"] for c in checks), "band": band,
            "runs": len(records), "checks": checks}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="perf-ledger trend check (blocking CI step)")
    ap.add_argument("path", help="perf_ledger_torch.jsonl")
    ap.add_argument("--band", type=float, default=DEFAULT_BAND,
                    help="allowed fraction off the rolling median")
    ap.add_argument("--window", type=int, default=DEFAULT_WINDOW)
    args = ap.parse_args(argv)
    records = read_ledger(args.path)
    check = trend_check(records, band=args.band, window=args.window)
    print(json.dumps(check, indent=1))
    return 0 if check["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
