"""Deterministic, exactly-resumable synthetic token pipeline.

``batch(step)`` is a pure function of (seed, step, topology), so a restarted
job consumes exactly the same sample stream with no replay and no skips —
the data-side half of fault tolerance.  Each host materializes only its own
shard (host_id/num_hosts split along the batch axis), and an async prefetch
thread keeps `prefetch` batches ahead of the training loop.

The token distribution is a Zipf-like categorical with a deterministic
per-(step, position) hash — cheap, seed-stable across processes, and enough
structure (skewed unigram + local repetition) for the loss to fall visibly
during the example runs.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    modality_tokens: int = 0
    modality_dim: int = 0
    encdec: bool = False
    d_model: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _philox(seed: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cheap counter-based hash -> uint64 (deterministic across platforms)."""
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         ^ b.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
         ^ np.uint64(seed) * np.uint64(0x94D049BB133111EB))
    x ^= x >> np.uint64(31)
    x *= np.uint64(0x7FB5D329728EA185)
    x ^= x >> np.uint64(27)
    return x


class SyntheticTokens:
    """tokens[b, t] = Zipf(hash(seed, global_sample_index, t))."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf CDF over the vocab (s = 1.1), precomputed once
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = 1.0 / ranks ** 1.1
        self._cdf = np.cumsum(w) / np.sum(w)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        base = step * cfg.global_batch + cfg.host_id * b
        sample_idx = (base + np.arange(b, dtype=np.int64))[:, None]
        pos = np.arange(s + 1, dtype=np.int64)[None, :]
        u = _philox(cfg.seed, sample_idx * (s + 1) + pos, pos + 1)
        uf = (u >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        toks = np.searchsorted(self._cdf, uf).astype(np.int32)
        # local repetition: every 7th position repeats 3 back (learnable)
        rep = (pos % 7 == 0) & (pos >= 3)
        toks = np.where(rep, np.roll(toks, 3, axis=1), toks)
        out = {"tokens": toks[:, :s], "labels": toks[:, 1:s + 1]}
        if cfg.modality_tokens:
            m = _philox(cfg.seed + 1, sample_idx + pos[:, :1], sample_idx)
            rng = np.random.RandomState((int(m[0, 0]) & 0x7FFFFFFF))
            out["modality"] = rng.randn(
                b, cfg.modality_tokens, cfg.modality_dim).astype(np.float32)
        if cfg.encdec:
            rng = np.random.RandomState((step * 1000003 + cfg.host_id)
                                        & 0x7FFFFFFF)
            out["src_embeds"] = rng.randn(b, s, cfg.d_model).astype(np.float32)
        return out


class PrefetchingLoader:
    """Async prefetch wrapper with exact-step resume."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0,
                 prefetch: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            try:
                self._q.put((step, self.source.batch(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
