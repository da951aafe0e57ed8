"""Launch of the CUDA selective-scan kernel (``csrc/pavlov_ssm.cu``).

Replaces ``repro/kernels/pavlov_ssm/kernel.py::_ssm_kernel``, and adds what
serving needs from ``mamba_ssm``'s XLA route: a carried ``h0``, a prefix
``length`` mask and ``h_T``.  What bounds it on the card: it reads delta
and x and writes y once (3·B·T·D values) plus B, C, a and the state — at
the serving prefill shape B=4, T=256, D=8192, N=16 in float32 about
105 MB, 31.5 µs at 3.35 TB/s — and takes one exponential per (b, t, d, n),
134 M there, a little longer on the SFU.  Two lanes walk one (b, d) channel
through T at N = 16, each with 8 of its N states in registers; a producer
warp streams delta, x, B and C through an mbarrier ring in shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import LaunchCounter, check, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32

launches = LaunchCounter()
#: the launches with T == 1: one per ``ssm`` layer per decode step
decode_launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 5 + [_P]


def _lib():
    fn = load("pavlov_ssm").pavlov_ssm_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"pavlov_ssm_raw: {what}")


def check_ssm_args(delta: torch.Tensor, x: torch.Tensor, bc: torch.Tensor,
                   cc: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None,
                   length: torch.Tensor | None = None) -> None:
    """Raise on what the kernel does not take: dtypes, shapes, N outside
    1..32, empty or non-contiguous inputs.  The C entry picks the route (a
    TMA / bulk-copy ring, or loads from global memory at T = 1 and for
    other N or unaligned rows)."""
    opt = [t for t in (h0, length) if t is not None]
    if delta.dtype not in _DTYPES or any(t.dtype != delta.dtype
                                         for t in (x, bc, cc)):
        raise TypeError(f"dtypes {[str(t.dtype) for t in (delta, x, bc, cc)]}"
                        f": need one of float32, bfloat16 for delta, x, "
                        f"bc, cc")
    if any(t.dtype != torch.float32 for t in (a, d_skip)) \
            or (h0 is not None and h0.dtype != torch.float32) \
            or (length is not None and length.dtype != torch.int32):
        raise TypeError("a, d_skip and h0 must be float32, length int32")
    _need(delta.dim() == 3 and delta.numel() > 0,
          f"delta {tuple(delta.shape)}: need a non-empty (B, T, D)")
    b, t, d = delta.shape
    n = a.shape[-1]
    _need(tuple(x.shape) == (b, t, d), f"x {tuple(x.shape)} vs delta")
    _need(tuple(bc.shape) == (b, t, n) and tuple(cc.shape) == (b, t, n),
          f"bc {tuple(bc.shape)}, cc {tuple(cc.shape)}: need ({b}, {t}, N)")
    _need(tuple(a.shape) == (d, n) and 0 < n <= MAX_STATE,
          f"a {tuple(a.shape)}: need ({d}, N) with 0 < N <= {MAX_STATE}")
    _need(tuple(d_skip.shape) == (d,), f"d_skip {tuple(d_skip.shape)}")
    _need(h0 is None or tuple(h0.shape) == (b, d, n),
          f"h0 {None if h0 is None else tuple(h0.shape)}: need ({b}, {d}, "
          f"{n})")
    _need(length is None or tuple(length.shape) == (b,),
          f"length {None if length is None else tuple(length.shape)}")
    _need(b <= 65535, f"batch {b} > 65535")
    _need(all(t.is_contiguous() for t in (delta, x, bc, cc, a, d_skip, *opt)),
          "needs contiguous inputs")


def pavlov_ssm_raw(delta: torch.Tensor, x: torch.Tensor, bc: torch.Tensor,
                   cc: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   h0: torch.Tensor | None = None,
                   length: torch.Tensor | None = None):
    """delta, x: (B,T,D) and bc, cc: (B,T,N), contiguous CUDA tensors of
    one dtype (float32 or bfloat16); a: (D,N), d_skip: (D,), h0: (B,D,N)
    float32; length: (B,) int32; N <= 32 -> (y (B,T,D) in delta's dtype,
    h_T (B,D,N) float32)."""
    check_ssm_args(delta, x, bc, cc, a, d_skip, h0, length)
    if not all(t.is_cuda for t in (delta, x, bc, cc, a, d_skip, h0, length)
               if t is not None):
        raise ValueError("pavlov_ssm_raw takes CUDA tensors")
    b, t, d = delta.shape
    n = a.shape[-1]
    y = torch.empty_like(delta)
    h_t = torch.empty((b, d, n), dtype=torch.float32, device=delta.device)
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    err = _lib()(delta.data_ptr(), x.data_ptr(), bc.data_ptr(),
                 cc.data_ptr(), a.data_ptr(), d_skip.data_ptr(),
                 None if h0 is None else h0.data_ptr(),
                 None if length is None else length.data_ptr(),
                 y.data_ptr(), h_t.data_ptr(), _DTYPES[delta.dtype], b, t, d,
                 n, stream)
    check(err, "pavlov_ssm_fwd")
    launches.n += 1
    if t == 1:
        decode_launches.n += 1
    return y, h_t
