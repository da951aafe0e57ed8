"""The serving engine's program table: one entry for each program of its
inventory at one shape (``ServeEngine._program``), the port's counterpart
of the JAX engine's ``jax.jit`` cache.

On a card with no mesh an entry is a :class:`GraphProgram`: a
``torch.cuda.CUDAGraph`` captured once over static input buffers, which
every later call fills with its host inputs (one host-to-device copy
each) and replays.  On the CPU, on a mesh, and on the card with
``cuda_graphs=False`` an entry is an :class:`EagerProgram`, the program's
eager call.  Either way an entry counts once, as a JAX program compiles
once for each shape.

A program body reads and writes the engine's persistent state tensors in
place (the counterpart of the JAX programs' donated state), computes only
from the tensors it is given, and returns its result: the logits, a
suitcase, or None.  Its bool inputs (decode's active rows, the rows a
splice keeps, the blocks an import writes) say which state it may change.
With all of them False a call changes nothing but the paged KV blocks it
writes, which the call after it writes again with the same bits.  That is
how a graph's first call, made eagerly before the capture so that the
kernels load and the libraries set up what a capture cannot, leaves the
engine as it found it.

The kernel wrappers count their launches on the host
(``kernels.build.LaunchCounter``), so a capture counts one replay's
launches and a replay none.  A graph entry records what its capture
counted and adds it at each replay; the first eager call and the capture
count nothing.  The counts are then the eager engine's, call for call.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..kernels.build import COUNTERS


def tree_map(fn, tree):
    """``fn`` over the array leaves (numpy or torch) of a tree of lists,
    tuples, named tuples and dicts; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"not a program input: {type(tree).__name__}")


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def shapes(tree) -> tuple:
    """The shapes of a tree's leaves: with the program's name, its key."""
    return tuple(tuple(a.shape) for a in tree_leaves(tree))


def _quiet(a):
    """A bool input all False (the call then changes no state); any other
    input as it is."""
    if isinstance(a, np.ndarray):
        return np.zeros_like(a) if a.dtype == np.bool_ else a
    return torch.zeros_like(a) if a.dtype == torch.bool else a


def _fill(static, host) -> None:
    """Copy each host input into its static buffer."""
    for buf, a in zip(tree_leaves(static), tree_leaves(host)):
        buf.copy_(torch.from_numpy(a) if isinstance(a, np.ndarray) else a)


class EagerProgram:
    """A program run as its eager call: ``convert`` turns each host input
    into what the body takes (a device tensor, or the input as it is)."""

    def __init__(self, convert=None):
        self._convert = convert

    def __call__(self, body, host, fresh: bool = False):
        args = host if self._convert is None \
            else tree_map(self._convert, host)
        return body(*args)


class GraphProgram:
    """A program captured as one CUDA graph on ``stream`` into the engine's
    memory ``pool``: the body's first call runs eagerly on that stream with
    its bool inputs all False, then the capture.  A capture the card
    refuses (a host sync in the body, a kernel launched off the capture
    stream) raises; nothing falls back to the eager call.  The outputs live
    in the pool until the next replay of this graph; ``fresh`` calls
    return copies of them instead."""

    def __init__(self, body, host, *, device: torch.device, pool, stream):
        t0 = time.perf_counter()
        self.inputs = tree_map(
            lambda a: (torch.from_numpy(a) if isinstance(a, np.ndarray)
                       else a).to(device, copy=True), host)
        before = {c: c.n for c in COUNTERS}
        _fill(self.inputs, tree_map(_quiet, host))
        main = torch.cuda.current_stream(device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            body(*self.inputs)
        main.wait_stream(stream)
        self._restore(before)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.outputs = body(*self.inputs)
            self.launches = [(c, c.n - before.get(c, 0)) for c in COUNTERS
                             if c.n != before.get(c, 0)]
        finally:
            self._restore(before)
        self.capture_s = time.perf_counter() - t0

    @staticmethod
    def _restore(before: dict) -> None:
        for c in COUNTERS:
            c.n = before.get(c, 0)

    def __call__(self, body, host, fresh: bool = False):
        _fill(self.inputs, host)
        self.graph.replay()
        for c, n in self.launches:
            c.n += n
        if fresh:
            return tree_map(torch.clone, self.outputs)
        return self.outputs
