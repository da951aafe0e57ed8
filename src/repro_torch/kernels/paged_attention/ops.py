"""Paged decode attention: the kernel wrapper, the drop-on-sentinel
scatter, and the scatter-then-attend op of
``repro.kernels.paged_attention.ops``.

``paged_attention`` launches the CUDA kernel for a CUDA tensor (or raises)
and takes the plain version for a CPU tensor; nothing else chooses.
"""
from __future__ import annotations

import torch

from ..build import refuse_autograd
from .kernel import paged_decode_attention_raw
from .ref import paged_attention_ref


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd) against the pools through ``block_table`` (entries in
    [0,N)), positions 0..lengths[b] visible -> (B,H,hd)."""
    refuse_autograd("paged_attention", q, k_pool, v_pool)
    if q.is_cuda:
        return paged_decode_attention_raw(q, k_pool, v_pool, block_table,
                                          lengths)
    return paged_attention_ref(q, k_pool, v_pool, block_table, lengths)


def table_lookup(block_table: torch.Tensor, logical: torch.Tensor,
                 sentinel: int) -> torch.Tensor:
    """Physical block ids ``block_table[b, logical[b, ...]]`` (int64);
    logical blocks past the table's end give ``sentinel``, so writes through
    them drop (an out-of-range gather would stop the card)."""
    nb = block_table.shape[1]
    flat = logical.reshape(logical.shape[0], -1).long()
    blk = block_table.long().gather(1, flat.clamp(0, nb - 1))
    blk = torch.where(flat < nb, blk, torch.full_like(blk, sentinel))
    return blk.reshape(logical.shape)


def scatter_paged(pool: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Write ``vals`` (*blk.shape, ...) into ``pool`` (N,bs,...) at
    ``[blk, off]``, IN PLACE, and return the pool.  Rows whose block id is
    outside [0, N) drop their write, as JAX's ``.at[].set(mode="drop")``.

    ``index_put_`` would raise (or wrap a negative id) on those rows, and
    boolean indexing would stop the host until the card has counted the
    rows.  Instead every dropped row is aimed at the first kept row's target
    with that row's value: duplicates then write identical bits, so the
    unspecified order of duplicate writes cannot matter.  With no kept row
    they rewrite row 0 of the pool with its own contents."""
    n, bs = pool.shape[0], pool.shape[1]
    flat = pool.view(n * bs, *pool.shape[2:])
    blk = blk.reshape(-1).long()
    off = off.reshape(-1).long()
    vals = vals.reshape(blk.shape[0], *pool.shape[2:]).to(pool.dtype)
    keep = (blk >= 0) & (blk < n)
    target = blk.clamp(0, n - 1) * bs + off
    first = torch.argmax(keep.to(torch.int32)).view(1)   # 0 when none kept
    any_kept = keep.any()
    anchor = torch.where(any_kept, target.index_select(0, first),
                         torch.zeros_like(first))
    anchor_val = torch.where(any_kept, vals.index_select(0, first),
                             flat.index_select(0, anchor))
    target = torch.where(keep, target, anchor)
    vals = torch.where(keep.view(-1, *[1] * (vals.dim() - 1)), vals,
                       anchor_val)
    flat.index_put_((target,), vals)
    return pool


def paged_decode_attention(q: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor,
                           write_mask: torch.Tensor | None = None):
    """One-token paged attention (``repro.kernels.paged_attention.ops``).

    q/new_k/new_v: (B,1,H|KVH,hd); pools (N,bs,KVH,hd); block_table (B,nb)
    — entries >= N mean "no block": writes through them drop, reads clamp
    and are masked by ``lengths``; lengths (B,) tokens already cached.
    Writes each slot's new K/V at position ``lengths[b]`` (in place), attends
    over positions 0..lengths[b], returns (out (B,1,H,hd), k_pool, v_pool).
    ``write_mask`` (B,) bool: rows with False drop their write and still
    attend through their table, as the JAX package's masked rows do."""
    refuse_autograd("paged_decode_attention", q, new_k, new_v, k_pool,
                    v_pool)
    n, bs = k_pool.shape[0], k_pool.shape[1]
    lengths = lengths.long()
    blk = table_lookup(block_table, lengths // bs, n)
    if write_mask is not None:
        blk = torch.where(write_mask, blk, torch.full_like(blk, n))
    off = lengths % bs
    scatter_paged(k_pool, blk, off, new_k[:, 0])
    scatter_paged(v_pool, blk, off, new_v[:, 0])
    table = block_table.clamp(max=n - 1).to(torch.int32)
    out = paged_attention(q[:, 0].contiguous(), k_pool, v_pool, table,
                          lengths.to(torch.int32))
    return out[:, None], k_pool, v_pool
