"""Serving metrics registry: counters, gauges + fixed-bucket log2 histograms.

The registry replaces ad-hoc windowed sample lists in ``EngineStats``.  Each
histogram keeps a preallocated array of log2 buckets (bucket ``i`` covers
``[base * 2**(i-1), base * 2**i)``; bucket 0 is everything below ``base``)
next to exact streaming aggregates (count / sum / min / max), so recording a
sample is O(1) with no growth, percentiles stay available forever on a
long-lived engine, and serialization is a fixed-size dict however much
traffic flowed through.  Quantiles interpolate inside the landing bucket and
are clamped to the exact [min, max] envelope — within one bucket width
(a factor of 2 at ``base=1e-6``-grained latencies) of the true value.

``MetricsRegistry.to_dict()`` is the versioned ``obs`` section of
``EngineStats.summary()``; bump ``OBS_SCHEMA_VERSION`` on any shape change.
``to_prometheus()`` renders the same registry in the Prometheus text
exposition format (one scrape-able snapshot, counters as ``_total``,
histograms as cumulative ``le`` buckets) for ``--metrics-prom``.
"""
from __future__ import annotations

import math
import re

#: version of the serialized ``obs`` stats section (see docs/observability.md)
#: v2: added the ``gauges`` section (device-memory telemetry)
OBS_SCHEMA_VERSION = 2

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(prefix: str, name: str) -> str:
    n = _PROM_NAME_RE.sub("_", f"{prefix}_{name}" if prefix else name)
    return n if not n[:1].isdigit() else f"_{n}"


def _prom_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2 ** 53 else repr(f)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_dict(self) -> dict:
        return {"unit": self.unit, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (pool bytes, watermarks)."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> dict:
        return {"unit": self.unit, "value": self.value}


class Histogram:
    """Fixed-size log2 histogram with exact streaming aggregates.

    ``base`` is the resolution floor: bucket 0 counts samples below it,
    bucket ``i >= 1`` counts ``[base * 2**(i-1), base * 2**i)``, and the last
    bucket absorbs everything above the range.  64 buckets at ``base=1e-6``
    span microseconds to ~290 years of latency.
    """

    __slots__ = ("name", "unit", "base", "nbuckets", "counts",
                 "count", "sum", "min", "max")

    def __init__(self, name: str, *, base: float = 1e-6, nbuckets: int = 64,
                 unit: str = "s"):
        if base <= 0 or nbuckets < 2:
            raise ValueError(f"need base > 0 and >= 2 buckets, got "
                             f"{base} x {nbuckets}")
        self.name = name
        self.unit = unit
        self.base = base
        self.nbuckets = nbuckets
        self.counts = [0] * nbuckets
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def bucket_of(self, v: float) -> int:
        if v < self.base:
            return 0
        # frexp: v/base = m * 2**e with m in [0.5, 1) -> floor(log2) == e - 1,
        # so values in [base * 2**(i-1), base * 2**i) land in bucket i
        e = math.frexp(v / self.base)[1]
        return min(self.nbuckets - 1, max(0, e))

    def record(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.counts[self.bucket_of(v)] += 1

    def bucket_lo(self, i: int) -> float:
        return 0.0 if i == 0 else self.base * 2.0 ** (i - 1)

    def bucket_hi(self, i: int) -> float:
        return self.base * 2.0 ** i

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile: linear interpolation inside the landing
        bucket, clamped to the exact [min, max] envelope."""
        if not self.count:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        rank = q * self.count
        seen = 0.0
        for i, n in enumerate(self.counts):
            if not n:
                continue
            if seen + n >= rank:
                frac = min(1.0, max(0.0, (rank - seen) / n))
                lo, hi = self.bucket_lo(i), self.bucket_hi(i)
                return min(self.max, max(self.min, lo + (hi - lo) * frac))
            seen += n
        return self.max

    def to_dict(self) -> dict:
        return {
            "unit": self.unit,
            "base": self.base,
            "nbuckets": self.nbuckets,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            # sparse: only occupied buckets, keyed by bucket index
            "buckets": {str(i): n for i, n in enumerate(self.counts) if n},
        }


class MetricsRegistry:
    """Get-or-create registry of named counters and histograms."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, unit: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, unit)
        return c

    def gauge(self, name: str, unit: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, unit)
        return g

    def histogram(self, name: str, **kw) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, **kw)
        return h

    def to_dict(self) -> dict:
        return {
            "version": OBS_SCHEMA_VERSION,
            "counters": {k: c.to_dict()
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.to_dict()
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self._histograms.items())},
        }

    def to_prometheus(self, prefix: str = "repro_serve") -> str:
        """The registry in Prometheus/OpenMetrics text exposition format.

        Counters get the conventional ``_total`` suffix; histograms render
        their log2 buckets as the cumulative ``le``-labelled series (upper
        bound = ``bucket_hi``), truncated after the last occupied bucket —
        the mandatory ``+Inf`` bucket carries the total count either way.
        ``#`` HELP lines carry the unit (scrapers ignore them)."""
        lines: list[str] = []
        for key, c in sorted(self._counters.items()):
            n = _prom_name(prefix, key) + "_total"
            if c.unit:
                lines.append(f"# HELP {n} ({c.unit})")
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {_prom_num(c.value)}")
        for key, g in sorted(self._gauges.items()):
            n = _prom_name(prefix, key)
            if g.unit:
                lines.append(f"# HELP {n} ({g.unit})")
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_prom_num(g.value)}")
        for key, h in sorted(self._histograms.items()):
            n = _prom_name(prefix, key)
            if h.unit:
                lines.append(f"# HELP {n} ({h.unit})")
            lines.append(f"# TYPE {n} histogram")
            last = max((i for i, c in enumerate(h.counts) if c), default=-1)
            cum = 0
            for i in range(last + 1):
                cum += h.counts[i]
                lines.append(f'{n}_bucket{{le="{_prom_num(h.bucket_hi(i))}"}}'
                             f" {cum}")
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {_prom_num(h.sum)}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"
