"""Launch of the CUDA Pascal matmul kernel (``csrc/pascal_matmul.cu``).

Replaces ``repro/kernels/pascal_matmul/kernel.py::_matmul_kernel``.  Two
routes, chosen in the C entry by dtype, K, N and alignment (never by M):
bf16 with K and N multiples of 8 and 16-byte aligned operands runs on the
tensor cores (``wgmma`` from a 4-stage TMA ring, a 128 x 128 output tile a
CTA); everything else, float32 above all, on SIMT FMAs (a 128 x 128 tile,
an 8 x 8 register micro-tile a thread, K through a 2-stage ``cp.async``
ring).  What bounds it on the card at the LSTM stack's hoisted input GEMM
(200 x 2048 @ 2048 x 8192): in float32 its 6.7 GFLOP on the float32 units
(100 µs at 67 TFLOP/s; 75 MB take 22 µs at 3.35 TB/s); in bf16 its 37.6 MB
(11 µs).  Both routes sum a row in k order whatever M is, so a row's bits
do not depend on the other rows.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import LaunchCounter, check, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]


def _lib():
    fn = load("pascal_matmul").pascal_matmul_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_pascal_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the kernel does not take: dtypes, shapes, layouts
    other than contiguous."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}/{w.dtype}: need one of float32, "
                        f"bfloat16 for x and w")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         f"need non-empty (M, K) and (K, N)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("pascal_matmul_raw needs contiguous inputs")


def pascal_matmul_raw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K), w: (K, N), contiguous CUDA tensors of one dtype (float32
    or bfloat16) -> (M, N) in that dtype, summed in float32."""
    check_pascal_args(x, w)
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("pascal_matmul_raw takes CUDA tensors")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], m, n, k, stream)
    check(err, "pascal_matmul_fwd")
    launches.n += 1
    return out
