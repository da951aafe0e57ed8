"""Building and loading the hand-written CUDA kernels (``csrc/*.cu``).

The counterpart of ``repro.kernels.common``: where the JAX package picks
Pallas interpret mode off the TPU, the port compiles each source with
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface and loads it with ``ctypes``.  Nothing here runs at import: a
library is built on first use (or ahead of time by :func:`build`), into
``build/kernels/`` at the root of the checkout, named by the hash of its
source and of the headers beside it (``csrc/*.cuh``), so an edited kernel
never loads a stale binary.

Every C entry takes its pointers and the stream as ``void*`` and returns the
``cudaError_t`` of ``cudaGetLastError()`` after the launch; :func:`check`
turns a nonzero code into an exception, so a refused launch (too many
threads, too much shared memory) is never silent.  No kernel has a
backward: :func:`refuse_autograd` stops every wrapper, on either device,
where autograd would record it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}

#: every kernel's launch counter, in the order the wrappers made them (a
#: CUDA graph of the serving engine adds what its capture counted at each
#: replay: ``serve/graphs.py``)
COUNTERS: list["LaunchCounter"] = []


class LaunchCounter:
    """Launches of one kernel, counted by its wrapper at the launch."""
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0
        COUNTERS.append(self)

    def reset(self) -> None:
        self.n = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); "
                           "the port's kernels build only where the CUDA "
                           "toolkit is installed")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha1()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile the named sources, all ``nvcc`` processes at once; return
    each one's ``-Xptxas -v`` report (registers, shared memory, spills).
    Sources already built at their current hash are not rebuilt."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        tmp.replace(so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: _target(n).with_suffix(".log").read_text() for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_autograd(what: str, *tensors) -> None:
    """Raise where autograd records and an input requires its gradient.
    The kernels (and the wrappers' plain versions, which stand in for them
    on the CPU) have no backward: a result without a ``grad_fn`` would
    train silently without those gradients.  A differentiable caller takes
    the JAX package's training routes instead (``flash_attention_xla``,
    ``chunked_linear_scan``)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward and autograd is recording an input "
            f"that requires its gradient: run it under torch.no_grad(), or "
            f"take the differentiable route (flash_attention_xla, "
            f"chunked_linear_scan)")
