"""Device-synchronized timing sections.

PyTorch enqueues CUDA work and returns: ``t1 - t0`` around a call measures
the enqueue, not the computation.  ``Timed`` (the counterpart of
``repro.obs.timing.Timed``) closes its section only after ``sync`` has
waited for the device, so every duration the engine reports covers the
work itself:

    with Timed("decode", device=dev) as tm:
        out = model.decode_step(...)
        out = tm.sync(out)          # torch.cuda.synchronize BEFORE the stamp
    stats.decode_time_s += tm.dur

``profile_trace`` (the counterpart of ``repro.obs.timing.profile_trace``)
runs a section under ``torch.profiler`` and writes what the card did.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path

import torch


class Timed:
    """Context manager timing one device-synchronized section.

    Attributes after the block: ``t0`` / ``t1`` (stamps of ``clock``) and
    ``dur`` (seconds).  The engine passes its tracer's clock, so spans,
    stats and TTFTs share one timeline."""

    __slots__ = ("name", "device", "t0", "t1", "dur", "_clock")

    def __init__(self, name: str = "", *, device: torch.device,
                 clock=time.perf_counter):
        self.name = name
        self.device = torch.device(device)
        self._clock = clock
        self.t0 = self.t1 = self.dur = 0.0

    def __enter__(self) -> "Timed":
        self.t0 = self._clock()
        return self

    def sync(self, out=None):
        """Wait for the device's queued work; return ``out``.  Call before
        the block closes."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def __exit__(self, *exc) -> bool:
        self.t1 = self._clock()
        self.dur = self.t1 - self.t0
        return False


def _busy_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (µs)."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


@contextmanager
def profile_trace(profile_dir, *, device: torch.device,
                  top: int | None = 25):
    """Run the body under ``torch.profiler`` when ``profile_dir`` is truthy
    (yielding None otherwise).  Writes ``trace.json`` (Chrome trace),
    ``ops.txt`` (ops by self device time) and ``summary.json`` into the
    directory, and fills the yielded dict with the summary: the section's
    wall ms, the card's busy ms (the union of its kernels' intervals) and
    idle share, and the ``top`` kernels by total device time (None: every
    kernel, each with its name and launches).  On the CPU
    the card's numbers are None: nothing ran there."""
    if not profile_dir:
        yield None
        return
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    summary: dict = {"device": str(device)}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield summary
        if on_card:
            torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(str(out / "trace.json"))
    sort = "self_cuda_time_total" if on_card else "self_cpu_time_total"
    (out / "ops.txt").write_text(
        prof.key_averages().table(sort_by=sort, row_limit=60))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels]) / 1e3 if kernels else None
    summary.update(
        wall_ms=wall_ms, device_busy_ms=busy,
        device_idle_share=None if busy is None else 1.0 - busy / wall_ms,
        kernel_launches=len(kernels),
        top_kernels=[{"name": n, "ms": us / 1e3, "launches": c}
                     for n, (us, c) in sorted(by_name.items(),
                                              key=lambda kv: -kv[1][0])[:top]])
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
