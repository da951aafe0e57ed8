"""Launch of the CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``).

Replaces ``repro/kernels/paged_attention/kernel.py::_paged_decode_kernel``.
On the card a decode tick is bound by the bytes it reads: K and V of every
live token (2·Σ(lengths+1)·KVH·hd elements), once; the operations are a
few per byte.  The kernel reads each slot's block table and length itself
and stops at the slot's last live block.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..build import LaunchCounter, check, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]


def _lib():
    fn = load("paged_attention").paged_decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention_raw(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, block_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k_pool/v_pool: (N, bs, KVH, hd); block_table: (B, nb)
    int32 with every entry in [0, N); lengths: (B,) int32 — the highest
    visible position per slot.  All contiguous CUDA tensors.  Returns
    (B, H, hd)."""
    b, h, hd = q.shape
    n, bs, kvh, hdk = k_pool.shape
    tensors = (q, k_pool, v_pool, block_table, lengths)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention_raw takes CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention_raw needs contiguous inputs")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k_pool.dtype}/{v_pool.dtype}: "
                        f"need one of float32, bfloat16 for q and the pools")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    if hdk != hd or tuple(v_pool.shape) != tuple(k_pool.shape) \
            or kvh == 0 or h % kvh or block_table.dim() != 2 \
            or block_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"shapes q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(block_table.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not fit")
    nb = block_table.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, h, kvh, hd, bs, nb,
                 1.0 / math.sqrt(hd), stream)
    check(err, "paged_decode_attention_fwd")
    launches.n += 1
    return out
