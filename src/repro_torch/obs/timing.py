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
"""
from __future__ import annotations

import time

import torch


class Timed:
    """Context manager timing one device-synchronized section.

    Attributes after the block: ``t0`` / ``t1`` (clock stamps) and ``dur``
    (seconds)."""

    __slots__ = ("name", "device", "t0", "t1", "dur")

    def __init__(self, name: str = "", *, device: torch.device):
        self.name = name
        self.device = torch.device(device)
        self.t0 = self.t1 = self.dur = 0.0

    def __enter__(self) -> "Timed":
        self.t0 = time.perf_counter()
        return self

    def sync(self, out=None):
        """Wait for the device's queued work; return ``out``.  Call before
        the block closes."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        self.dur = self.t1 - self.t0
        return False
