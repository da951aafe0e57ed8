"""Launch of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py::_flash_kernel``.  What
bounds it on the card: a causal prefill does 2·B·H·hd·S·(S+1) operations on
2·B·S·hd·(H+KVH) input and output elements, so its intensity grows with S —
for qwen3-0.6b in bf16 about (S+1)/3 operations per byte, against the
H100's ~295: bound by bytes below S≈900 and by operations above.  The
kernel takes the ``(B, S, H, hd)`` layout through strides, so no transpose
to ``(B·H, S, hd)`` is materialized.

Two routes, by dtype, each dtype exactly one: bfloat16 runs on the tensor
cores (``wgmma``; K/V tiles by TMA from a producer warp through a 3-stage
ring; the q heads of a kv head packed into one tile's 64 rows); float32
runs the SIMT kernel, since ``wgmma`` has no full-float32 mode.  Each
route's launch geometry lives in the C entry; the wrapper passes shapes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..build import LaunchCounter, check, load

#: head dims the kernel is instantiated for (``configs/archs.py`` and the
#: tests use these)
HEAD_DIMS = (16, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
             _I, _I, _F, _P]


def _lib():
    lib = load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_flash_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int) -> None:
    """Raise on what the kernel does not take: dtypes, shapes, head dims,
    layouts (head_dim contiguous, 16-byte aligned rows for the bf16
    route's 16-byte copies) and a negative window."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        f"float32, bfloat16 for q, k and v")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, S, H, hd) and two "
                         f"(B, S, KVH, hd)")
    b, _, h, hd = q.shape
    bk, _, kvh, hdk = k.shape
    if bk != b or hdk != hd or kvh == 0 or h % kvh or 0 in q.shape \
            or 0 in k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit GQA attention")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("head_dim must be the contiguous axis")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
                raise ValueError(
                    f"{name}: the bf16 route copies 16 bytes at a time: "
                    f"need a 16-byte aligned base and strides that are "
                    f"multiples of 8 elements, got {tuple(x.stride())}")
    if window < 0:
        raise ValueError(f"window {window} < 0")


def flash_attention_raw(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) CUDA tensors of one dtype
    with a unit head_dim stride -> (B, Sq, H, hd).  bfloat16 launches the
    tensor-core kernel, float32 the SIMT kernel."""
    check_flash_args(q, k, v, window)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_raw takes CUDA tensors")
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, h, kvh, sq, skv, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], int(causal), int(window),
                 1.0 / math.sqrt(hd), stream)
    check(err, "flash_attention_fwd")
    launches.n += 1
    return out
