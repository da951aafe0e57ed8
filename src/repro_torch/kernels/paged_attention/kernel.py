"""Launch of the CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``).

Replaces ``repro/kernels/paged_attention/kernel.py::_paged_decode_kernel``.
On the card a decode tick is bound by the bytes it reads: K and V of every
live token (2·Σ(lengths+1)·KVH·hd elements), once; the operations are a
few per byte.  A call is two launches (``launches`` counts calls): the
first splits each slot's blocks across CTAs (flash decoding; each CTA reads
its table entries and streams whole blocks by bulk copy), the second merges
the splits' float32 partials in split order from a scratch this wrapper
allocates.  The split length, the head chunks and the scratch size come
from the C entry (from the table's width and the card's SM count, never
from ``lengths``); nothing here chooses a geometry.
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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 7 + [_F, _P]
_SCRATCH_ARGTYPES = [_I] * 7 + [ctypes.POINTER(ctypes.c_int64)]


def _lib(name: str, argtypes: list):
    fn = getattr(load("paged_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_paged_args(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor) -> None:
    """Raise on what the kernel does not take: dtypes, shapes, head dims,
    non-contiguous inputs, and pools not 16-byte aligned (blocks are bulk
    copies)."""
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k_pool.dtype}/{v_pool.dtype}: "
                        f"need one of float32, bfloat16 for q and the pools")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 \
            or tuple(v_pool.shape) != tuple(k_pool.shape) \
            or block_table.dim() != 2 \
            or block_table.shape[0] != q.shape[0] \
            or tuple(lengths.shape) != (q.shape[0],) \
            or k_pool.shape[3] != q.shape[2] or k_pool.shape[2] == 0 \
            or q.shape[1] % k_pool.shape[2] or 0 in q.shape \
            or 0 in k_pool.shape or 0 in block_table.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"table {tuple(block_table.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not fit")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[2]} not in {HEAD_DIMS}")
    tensors = (q, k_pool, v_pool, block_table, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention_raw needs contiguous inputs")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools are read by bulk copies of 16 bytes: "
                         "need 16-byte aligned pools")


def paged_decode_attention_raw(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, block_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k_pool/v_pool: (N, bs, KVH, hd); block_table: (B, nb)
    int32 with every entry in [0, N); lengths: (B,) int32 — the highest
    visible position per slot.  All contiguous CUDA tensors.  Returns
    (B, H, hd)."""
    check_paged_args(q, k_pool, v_pool, block_table, lengths)
    if not all(t.is_cuda for t in (q, k_pool, v_pool, block_table, lengths)):
        raise ValueError("paged_decode_attention_raw takes CUDA tensors")
    b, h, hd = q.shape
    _, bs, kvh, _ = k_pool.shape
    nb = block_table.shape[1]
    code = _DTYPES[q.dtype]
    nbytes = ctypes.c_int64(0)
    check(_lib("paged_decode_attention_scratch", _SCRATCH_ARGTYPES)(
        code, b, h, kvh, hd, bs, nb, ctypes.byref(nbytes)),
        "paged_decode_attention_scratch")
    scratch = torch.empty(nbytes.value // 4, dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib("paged_decode_attention_fwd", _ARGTYPES)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), code, b, h, kvh, hd, bs, nb,
        1.0 / math.sqrt(hd), stream)
    check(err, "paged_decode_attention_fwd")
    launches.n += 1
    return out
