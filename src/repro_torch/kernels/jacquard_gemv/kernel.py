"""Launch of the CUDA Jacquard GEMV kernel (``csrc/jacquard_gemv.cu``).

Replaces ``repro/kernels/jacquard_gemv/kernel.py::_gemv_kernel``.  What
bounds it on the card: the bytes of w, each read once (at M = 1, K = 1280,
N = 8192 in float32, 42 MB, 12.5 µs at 3.35 TB/s).  A block owns a slab of
N columns and all of K: 8 lanes across the slab with a 16-byte load a row
each, 32 groups of lanes over the rows, two batches of 8 rows a thread in
flight and no barrier inside the stream; the groups' float32 sums are added
in group order (no atomics: the same bits on every call).
"""
from __future__ import annotations

import ctypes

import torch

from ..build import LaunchCounter, check, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most rows of x the kernel takes
MAX_ROWS = 16

launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]


def _lib():
    fn = load("jacquard_gemv").jacquard_gemv_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_gemv_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the kernel does not take: dtypes, shapes, more than
    :data:`MAX_ROWS` rows of x, layouts other than contiguous."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}/{w.dtype}: need one of float32, "
                        f"bfloat16 for x and w")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         f"need non-empty (M, K) and (K, N)")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"x has {x.shape[0]} rows: the GEMV takes at most "
                         f"{MAX_ROWS}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("jacquard_gemv_raw needs contiguous inputs")


def jacquard_gemv_raw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) with M <= 16, w: (K, N), contiguous CUDA tensors of one
    dtype (float32 or bfloat16) -> (M, N) in that dtype, summed in
    float32."""
    check_gemv_args(x, w)
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("jacquard_gemv_raw takes CUDA tensors")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], m, n, k, stream)
    check(err, "jacquard_gemv_fwd")
    launches.n += 1
    return out
