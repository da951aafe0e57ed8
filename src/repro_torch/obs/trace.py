"""Allocation-light event tracer with Chrome trace-event JSON export.

The tracer is ON by default in the serving engine, so the hot path must cost
near nothing: events land in a preallocated ring buffer as plain tuples
``(ph, name, tid, ts, dur, args)`` — no dicts, no growth, no I/O — and the
Chrome-format dicts are only materialized at export time.  When the ring
wraps, the oldest events drop and :attr:`Tracer.dropped` says how many (the
export records it too, so a truncated trace is never mistaken for a quiet
engine).

Event vocabulary (Chrome trace-event ``ph`` codes; see docs/observability.md):

  * ``X`` complete span   — a timed section (prefill call, chunk, decode tick)
  * ``B`` / ``E``         — a request's residency on its slot (admit → finish)
  * ``i`` instant         — submit, stall, copy-on-write, abort
  * ``C`` counter         — per-tick series (queue depth, slot occupancy,
                            KV-pool in-use/cached, per shard)

Tracks are integer ``tid``s named via :meth:`Tracer.set_track` (exported as
``thread_name`` metadata): the engine uses track 0 for queue-level request
events, one track per slot, and one for engine-wide spans.  Timestamps are
``time.perf_counter()`` seconds, exported as microseconds relative to the
tracer's epoch; the export is stably sorted by timestamp so every track is
monotonic and ``B``/``E`` pairs nest.  Load the file at ``ui.perfetto.dev``
or ``chrome://tracing``.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

#: default ring capacity — ~4 MB of tuples, tens of thousands of ticks
DEFAULT_CAPACITY = 65536


class Tracer:
    """Ring-buffered structured-event recorder.

    ``enabled`` may be toggled at runtime (the overhead gate in
    benchmarks/serve_bench.py measures exactly this switch); a disabled
    tracer's emit methods return immediately.  ``clock`` is the shared
    monotonic clock — the engine stamps *all* its times through
    :meth:`now` so spans, stats, and TTFTs live on one timeline.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 enabled: bool = True, clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self.clock = clock
        self._buf: list = [None] * capacity
        self._n = 0
        self._epoch = clock()
        self._tracks: dict[int, str] = {}

    # ------------------------------------------------------------------ clock
    def now(self) -> float:
        return self.clock()

    # ----------------------------------------------------------------- tracks
    def set_track(self, tid: int, name: str) -> None:
        self._tracks[tid] = name

    # ------------------------------------------------------------------- emit
    def emit(self, ph: str, name: str, tid: int, ts: float,
             dur: float = 0.0, args: tuple = ()) -> None:
        """Append one raw event; ``args`` is a tuple of (key, value) pairs
        (dicts are built only at export)."""
        if not self.enabled:
            return
        self._buf[self._n % self.capacity] = (ph, name, tid, ts, dur, args)
        self._n += 1

    def span(self, name: str, tid: int, t0: float, t1: float,
             args: tuple = ()) -> None:
        self.emit("X", name, tid, t0, t1 - t0, args)

    def begin(self, name: str, tid: int, ts: float, args: tuple = ()) -> None:
        self.emit("B", name, tid, ts, 0.0, args)

    def end(self, name: str, tid: int, ts: float, args: tuple = ()) -> None:
        self.emit("E", name, tid, ts, 0.0, args)

    def instant(self, name: str, tid: int, ts: float,
                args: tuple = ()) -> None:
        self.emit("i", name, tid, ts, 0.0, args)

    def counter(self, name: str, ts: float, series: tuple) -> None:
        """One multi-series counter sample; ``series`` is (name, value) pairs
        rendered as stacked counter tracks by the viewer."""
        self.emit("C", name, 0, ts, 0.0, series)

    # ------------------------------------------------------------------ state
    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def dropped(self) -> int:
        """Events lost to ring wrap-around since the last :meth:`clear`."""
        return max(0, self._n - self.capacity)

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._n = 0
        self._epoch = self.clock()

    def events(self) -> list:
        """Retained raw events, stably sorted by timestamp (emission order
        breaks ties), oldest first."""
        if self._n <= self.capacity:
            raw = self._buf[:self._n]
        else:
            cut = self._n % self.capacity
            raw = self._buf[cut:] + self._buf[:cut]
        return sorted(raw, key=lambda e: e[3])

    @property
    def tracks(self) -> dict[int, str]:
        """The named tracks, ``{tid: name}``."""
        return dict(self._tracks)

    def merged(self, tracks: dict[int, str], events: list) -> "Tracer":
        """A new tracer on this one's clock and epoch that holds this one's
        retained events and tracks, then ``events`` (another tracer's raw
        ``events()``) and its ``tracks`` — the view of two processes whose
        clocks are one (``perf_counter`` is CLOCK_MONOTONIC, shared by
        every process of a machine).  Losses to either ring are not
        counted in its ``dropped``."""
        own = self.events()
        out = Tracer(max(1, len(own) + len(events)), clock=self.clock)
        out._epoch = self._epoch
        out._tracks = {**self._tracks, **tracks}
        for e in own + list(events):
            out.emit(*e)
        return out

    # ----------------------------------------------------------------- export
    def _us(self, ts: float) -> float:
        return round((ts - self._epoch) * 1e6, 3)

    def chrome_events(self, pid: int = 0) -> list[dict]:
        """The ``traceEvents`` array: track-name metadata first, then every
        retained event in Chrome trace-event form."""
        out = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": "serve_engine"}}]
        for tid in sorted(self._tracks):
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": self._tracks[tid]}})
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid}})
        for ph, name, tid, ts, dur, args in self.events():
            e = {"ph": ph, "pid": pid, "tid": tid, "name": name,
                 "cat": "serve", "ts": self._us(ts)}
            if ph == "X":
                e["dur"] = round(dur * 1e6, 3)
            if ph == "i":
                e["s"] = "t"                 # thread-scoped instant
            if args:
                e["args"] = dict(args)
            out.append(e)
        return out

    def to_chrome(self, other_data: dict | None = None) -> dict:
        doc = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }
        if other_data:
            doc["otherData"].update(other_data)
        return doc

    def dumps(self, other_data: dict | None = None) -> str:
        return json.dumps(self.to_chrome(other_data))

    def save(self, path, other_data: dict | None = None) -> None:
        Path(path).write_text(self.dumps(other_data) + "\n")
