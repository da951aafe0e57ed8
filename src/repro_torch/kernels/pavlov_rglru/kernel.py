"""Launch of the CUDA RG-LRU scan kernel (``csrc/pavlov_rglru.cu``).

Replaces ``repro/kernels/pavlov_rglru/kernel.py::_rglru_kernel``.  What
bounds it on the card: it reads a and b once and writes h once,
3·B·T·E elements, for two operations per element — bound by bytes (at the
serving prefill shape B=4, T=256, E=2560 in float32, 31.5 MB, about
9.4 µs at 3.35 TB/s).  One lane walks one (b, e) channel through T with
h in a register; a warp's strip of 32 channels streams its a and b through
a ring of TMA boxes in shared memory, so enough bytes are in flight.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import LaunchCounter, check, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()
#: the launches with T == 1: one per ``rec`` layer per decode step
decode_launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]


def _lib():
    fn = load("pavlov_rglru").pavlov_rglru_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_rglru_args(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on what the kernel does not take: dtypes, shapes, empty or
    non-contiguous inputs.  The C entry picks the route (a TMA ring, or
    element loads at T = 1 and for unaligned rows)."""
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}/{b.dtype}: need one of float32, "
                        f"bfloat16 for a and b")
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape) or a.numel() == 0:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}: "
                         f"need two equal non-empty (B, T, E)")
    if a.shape[0] > 65535:
        raise ValueError(f"batch {a.shape[0]} > 65535")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("pavlov_rglru_raw needs contiguous inputs")


def pavlov_rglru_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: contiguous (B, T, E) CUDA tensors of one dtype (float32 or
    bfloat16) -> h: (B, T, E) in that dtype."""
    check_rglru_args(a, b)
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("pavlov_rglru_raw takes CUDA tensors")
    bb, t, e = a.shape
    h = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib()(a.data_ptr(), b.data_ptr(), h.data_ptr(), _DTYPES[a.dtype],
                 bb, t, e, stream)
    check(err, "pavlov_rglru_fwd")
    launches.n += 1
    if t == 1:
        decode_launches.n += 1
    return h
