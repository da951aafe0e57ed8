"""Attention on the serving path of a dense GQA decoder: projections
(+ optional bias / qk-norm), RoPE, the flash core, and the paged KV pool —
the parts of ``repro.models.attention`` that qwen3-0.6b's serving path runs.

Layouts match the JAX package at every public function: activations
``(B, S, H, hd)``, the block pool ``(N, bs, KVH, hd)``.  Unlike JAX's
immutable arrays, the paged ops write the pool IN PLACE and hand back the
same tensors in the returned ``PagedKVCache`` (one pool per layer, never a
copy of it per call).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.flash_attention.ops import flash_attention  # noqa: F401
from ..kernels.paged_attention import ops as paged_ops
from ..kernels.paged_attention.ops import scatter_paged, table_lookup
from .common import apply_rope, rms_norm

NEG_INF = -1e30


def qkv_project(params: dict, x: torch.Tensor, num_heads: int,
                num_kv_heads: int, head_dim: int, positions: torch.Tensor, *,
                rope_theta: float, use_rope: bool = True):
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,KVH,hd); qk-norm before RoPE."""
    b, s, _ = x.shape
    q = torch.matmul(x, params["wq"])
    k = torch.matmul(x, params["wk"])
    v = torch.matmul(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, num_heads, head_dim)
    k = k.reshape(b, s, num_kv_heads, head_dim)
    v = v.reshape(b, s, num_kv_heads, head_dim)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


# ------------------------------------------------------------------ paged KV
class PagedKVCache(NamedTuple):
    """One layer's KV as a pool of fixed-size blocks shared by all slots.

    ``k``/``v`` have no batch axis; a per-slot block table ``(B, nb)`` maps
    logical position ``p`` of slot ``b`` to ``k[table[b, p // bs], p % bs]``.
    Table entries >= N mean "no block": writes through them drop and reads
    are masked.  ``length``: (B,) int32 tokens cached per slot."""
    k: torch.Tensor        # (N, bs, KVH, hd)
    v: torch.Tensor
    length: torch.Tensor   # (B,) int32


def gather_paged_kv(cache: PagedKVCache, block_table: torch.Tensor):
    """Each slot's logical KV sequence through its table row:
    (B, nb*bs, KVH, hd).  Sentinel entries clamp to the last block; callers
    mask those positions."""
    b, nb = block_table.shape
    bs = cache.k.shape[1]
    idx = block_table.clamp(max=cache.k.shape[0] - 1).long()
    ks = cache.k[idx].reshape(b, nb * bs, *cache.k.shape[2:])
    vs = cache.v[idx].reshape(b, nb * bs, *cache.v.shape[2:])
    return ks, vs


def paged_decode_attention(q: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, cache: PagedKVCache,
                           block_table: torch.Tensor, *,
                           write_mask: torch.Tensor | None = None):
    """One-token attention against the paged pool, through
    ``kernels.paged_attention.ops.paged_decode_attention``.

    q/new_k/new_v: (B,1,H|KVH,hd).  Writes the new K/V at logical position
    ``length[b]`` and attends over positions 0..length[b].  Rows with
    ``write_mask`` False get an all-sentinel table row, so their write drops
    and their length stays; their output is meaningless (every caller
    discards it).  Returns (out (B,1,H,hd), cache)."""
    if write_mask is not None:
        block_table = torch.where(write_mask[:, None], block_table,
                                  cache.k.shape[0])
    out, _, _ = paged_ops.paged_decode_attention(
        q, new_k, new_v, cache.k, cache.v, block_table, cache.length)
    inc = 1 if write_mask is None else write_mask.to(torch.int32)
    return out, cache._replace(length=cache.length + inc)


def paged_fill_cache(cache: PagedKVCache, k: torch.Tensor, v: torch.Tensor,
                     block_table: torch.Tensor, *,
                     length: torch.Tensor | None = None) -> PagedKVCache:
    """Write prefill K/V through the block table.  k/v: (B,S,KVH,hd)
    right-padded; only rows < ``length`` are written.  Rows whose table row
    is all sentinel (batch padding) drop every write."""
    b, s = k.shape[0], k.shape[1]
    n, bs = cache.k.shape[0], cache.k.shape[1]
    j = torch.arange(s, device=k.device)
    blk = table_lookup(block_table, (j // bs).expand(b, s), n)
    off = (j % bs).expand(b, s)
    if length is not None:
        valid = j[None, :] < length[:, None]
        blk = torch.where(valid, blk, torch.full_like(blk, n))
    scatter_paged(cache.k, blk, off, k)
    scatter_paged(cache.v, blk, off, v)
    new_len = cache.length + (s if length is None else length)
    return PagedKVCache(cache.k, cache.v, new_len.to(torch.int32))


def paged_chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache: PagedKVCache, block_table: torch.Tensor, *,
                          offset: torch.Tensor, length: torch.Tensor):
    """Chunked-prefill continuation against the paged pool (full causal
    attention; plain PyTorch, as the JAX package computes it outside any
    kernel).  q/k/v: (B,C,H|KVH,hd) at positions ``offset + i``; the real
    rows are written, then every q row attends to its causal horizon over
    the gathered sequence.  Returns (out, cache with length offset+length).
    """
    b, c, h, hd = q.shape
    _, _, kvh, _ = k.shape
    g = h // kvh
    n, bs = cache.k.shape[0], cache.k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    q_pos = offset[:, None].long() + torch.arange(c, device=q.device)[None]
    blk = table_lookup(block_table, q_pos // bs, n)
    valid = torch.arange(c, device=q.device)[None, :] < length[:, None]
    blk = torch.where(valid, blk, torch.full_like(blk, n))
    scatter_paged(cache.k, blk, q_pos % bs, k)
    scatter_paged(cache.v, blk, q_pos % bs, v)
    ks, vs = gather_paged_kv(cache, block_table)               # (B,Smax,..)
    smax = ks.shape[1]
    qg = (q.reshape(b, c, kvh, g, hd) * scale).float()
    s = torch.einsum("bqnGd,bknd->bnGqk", qg, ks.float())
    mask = torch.arange(smax, device=q.device)[None, None, :] \
        <= q_pos[:, :, None]                                    # (B,C,Smax)
    s = torch.where(mask[:, None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnGqk,bknd->bnGqd", p, vs.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, c, h, hd)
    return out.to(q.dtype), cache._replace(
        length=(offset + length).to(torch.int32))
