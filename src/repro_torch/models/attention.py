"""Attention on the serving path: projections (+ optional bias / qk-norm),
RoPE, the flash core, the dense per-slot KV cache (a ring for sliding-window
layers) and the paged KV pool — the parts of ``repro.models.attention``
that the port's served archs run.

Layouts match the JAX package at every public function: activations
``(B, S, H, hd)``, dense caches ``(B, S_max, KVH, hd)``, the block pool
``(N, bs, KVH, hd)``.  Unlike JAX's immutable arrays, the cache ops write
the cache IN PLACE and hand back the same tensors in the returned
``KVCache`` / ``PagedKVCache`` (one cache per layer, never a copy of it per
call).  Only the flash core is a kernel in the JAX package; the dense
cache ops (``decode_attention``, ``chunk_attention``, ``local_attention``)
run outside any Pallas kernel there, so plain PyTorch is their port, and so
is ``flash_attention_xla``, the flash core's XLA branch: the route the JAX
package trains through and runs every cross-attention on.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.flash_attention.ops import flash_attention  # noqa: F401
from ..kernels.paged_attention import ops as paged_ops
from ..kernels.paged_attention.ops import scatter_paged, table_lookup
from . import spmd
from .common import apply_rope, rms_norm

NEG_INF = -1e30


def qkv_project(params: dict, x: torch.Tensor, num_heads: int,
                num_kv_heads: int, head_dim: int, positions: torch.Tensor, *,
                rope_theta: float, use_rope: bool = True):
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,KVH,hd); qk-norm before RoPE.
    The projections and biases are cast to x's dtype per call."""
    dt = x.dtype
    q = torch.matmul(x, params["wq"].to(dt))
    k = torch.matmul(x, params["wk"].to(dt))
    v = torch.matmul(x, params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = spmd.split_heads(q, num_heads, head_dim)
    k = spmd.split_heads(k, num_kv_heads, head_dim)
    v = spmd.split_heads(v, num_kv_heads, head_dim)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


# ------------------------------------------------- blockwise (XLA) flash core
def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_kv: int = 512) -> torch.Tensor:
    """Online-softmax attention over ``block_kv`` KV blocks: the XLA branch
    of ``repro.models.attention.flash_attention``, in plain differentiable
    PyTorch.  It is the route of every attention the JAX package trains
    through (and of its decoder's cross-attention, always), so the port
    takes it under autograd, where no kernel wrapper has a backward.

    q: (B,Sq,H,hd); k, v: (B,Skv,KVH,hd) with H % KVH == 0 -> (B,Sq,H,hd).
    q row i sits at position i (aligned to the START of the KV sequence,
    the JAX function's ``q_offset=0``, which every caller passes).  q is
    scaled in its own dtype, then scores, probabilities and the
    accumulator run in float32 (the JAX function's ``f32_probs=True``, the
    only value its configs set); masked scores take the finite
    ``NEG_INF`` and the output is ``acc / max(l, 1e-30)``."""
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    blocks = max(1, -(-skv // block_kv))
    pad = blocks * block_kv - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = (q.reshape(b, sq, kvh, g, hd) * scale).float()
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, kvh, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, g, sq), device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), device=q.device)
    for i in range(blocks):
        kblk = k[:, i * block_kv:(i + 1) * block_kv]
        vblk = v[:, i * block_kv:(i + 1) * block_kv]
        s = torch.einsum("bqnGd,bknd->bnGqk", qg, kblk.float())
        kv_pos = i * block_kv + torch.arange(block_kv, device=q.device)
        mask = (kv_pos[None, :] <= skv - 1).expand(sq, block_kv)  # padding
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bnGqk,bknd->bnGqd", p, vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


# ------------------------------------------------------- local (sliding) core
def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """Exact causal sliding-window attention by chunks of ``window``: each
    chunk attends to itself and the previous chunk under (causal AND
    distance < window).  q,k,v: (B,S,H|KVH,hd) with S % window == 0.
    q is scaled in its own dtype before the float32 scores, as the JAX
    package's XLA path does."""
    b, s, h, hd = q.shape
    _, _, kvh, _ = k.shape
    g = h // kvh
    if s % window:
        raise ValueError(f"S {s} is not a multiple of window {window}")
    c = s // window
    scale = 1.0 / math.sqrt(hd)
    qc = (q.reshape(b, c, window, kvh, g, hd) * scale).float()
    kc = k.reshape(b, c, window, kvh, hd).float()
    vc = v.reshape(b, c, window, kvh, hd).float()
    # previous chunk (zeros before the first)
    kp = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kk = torch.cat([kp, kc], dim=2)                        # (B,c,2w,KVH,hd)
    vv = torch.cat([vp, vc], dim=2)
    scores = torch.einsum("bcqnGd,bcknd->bcnGqk", qc, kk)  # (B,c,KVH,G,w,2w)
    qpos = torch.arange(window, device=q.device)[:, None]
    kpos = torch.arange(2 * window, device=q.device)[None, :] - window
    mask = (kpos <= qpos) & (kpos > qpos - window)
    scores = torch.where(mask, scores, NEG_INF)
    # the first chunk has no previous chunk: its phantom keys are masked
    scores[:, 0] = torch.where(mask & (kpos >= 0), scores[:, 0], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcnGqk,bcknd->bcqnGd", p, vv)
    return out.reshape(b, s, h, hd).to(q.dtype)


# ------------------------------------------------------------------ dense KV
class KVCache(NamedTuple):
    """One layer's KV for every slot: ``k``/``v`` (B, S_max, KVH, hd) —
    left-aligned for full attention, a ring of S_max = window slots for
    sliding-window layers (position p lives in slot p % S_max) — and
    ``length``: (B,) int32 tokens cached per slot."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def init_kv_cache(batch: int, max_len: int, kv_heads: int, head_dim: int,
                  dtype: torch.dtype, device: torch.device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                      device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def _attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Float32 scores of ``qg`` (B,C,KVH,G,hd) against k/v (B,L,KVH,hd)
    under ``mask`` (B,C,L) -> (B,C,KVH*G,hd) float32."""
    b, c, kvh, g, hd = qg.shape
    s = torch.einsum("bqnGd,bknd->bnGqk", qg, k.float())
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnGqk,bknd->bnGqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, kvh * g, hd)


def decode_attention(q: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, cache: KVCache, *, window: int = 0,
                     write_mask: torch.Tensor | None = None):
    """One-token attention against a dense cache.

    q/new_k/new_v: (B,1,H|KVH,hd).  Writes the new K/V at position
    ``length[b]`` (``length % S_max`` in a window's ring), IN PLACE, and
    attends to every cached position (a ring: the last ``window``).  Rows
    with ``write_mask`` False rewrite the entry they point at with its own
    bits and keep their length, so their cache is bit-for-bit unchanged
    (their output is meaningless).  Returns (out (B,1,H,hd), cache)."""
    b, _, h, hd = q.shape
    kvh = new_k.shape[2]
    g = h // kvh
    smax = cache.k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    idx = cache.length.long()
    if window:
        idx = idx % smax
    # a write at or past S_max drops, as the reference's one-hot write does
    keep = idx < smax
    if write_mask is not None:
        keep = keep & write_mask
    idx = idx.clamp(max=smax - 1)
    rows = torch.arange(b, device=q.device)
    k_new = torch.where(keep[:, None, None], new_k[:, 0].to(cache.k.dtype),
                        cache.k[rows, idx])
    v_new = torch.where(keep[:, None, None], new_v[:, 0].to(cache.v.dtype),
                        cache.v[rows, idx])
    cache.k[rows, idx] = k_new
    cache.v[rows, idx] = v_new
    qg = (q.reshape(b, 1, kvh, g, hd) * scale).float()
    pos = torch.arange(smax, device=q.device)[None, :]
    length = cache.length.long()[:, None]
    valid = pos <= length                                  # incl. the new one
    if window:
        valid = pos < torch.clamp(length + 1, max=window)
    out = _attend(qg, cache.k, cache.v, valid[:, None, :])
    inc = 1 if write_mask is None else write_mask.to(torch.int32)
    return out.to(q.dtype), cache._replace(
        length=(cache.length + inc).to(torch.int32))


# ------------------------------------- a dense cache split along its sequence
def shard_fill(k_shard: torch.Tensor, v_shard: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, cached: torch.Tensor, *, start: int,
               smax: int, window: int = 0,
               length: torch.Tensor | None = None) -> torch.Tensor:
    """``_fill_cache`` on the slots ``[start, start + L)`` of a dense cache
    of ``smax`` slots that one rank holds (``k_shard``/``v_shard``:
    (B,L,KVH,hd)), IN PLACE: each slot gets what ``_fill_cache`` writes
    there — the prompt's K/V left-aligned, or the window's ring formula's
    position — and a slot ``_fill_cache`` leaves keeps its bits.  k/v:
    (B,S,KVH,hd), the whole prompt; ``cached``: the (B,) lengths before.
    Returns the new lengths."""
    b, s = k.shape[0], k.shape[1]
    n = k_shard.shape[1]
    if length is not None and window:
        last = length.long()[:, None] - 1
        j = start + torch.arange(n, device=k.device)[None, :]
        p = (last - ((last - j) % smax)).clamp(0, s - 1)
        idx = p[:, :, None, None].expand(-1, -1, *k.shape[2:])
        k_shard.copy_(torch.gather(k, 1, idx))
        v_shard.copy_(torch.gather(v, 1, idx))
        return (cached + length).to(torch.int32)
    first = 0
    if window and s > smax:
        first, s = s - smax, smax
    m = max(0, min(n, s - start))           # slots of this shard below s
    if m:
        k_shard[:, :m] = k[:, first + start:first + start + m]
        v_shard[:, :m] = v[:, first + start:first + start + m]
    return (cached + (s if length is None else length)).to(torch.int32)


def shard_decode_write(k_shard: torch.Tensor, v_shard: torch.Tensor,
                       new_k: torch.Tensor, new_v: torch.Tensor,
                       cached: torch.Tensor, *, start: int, smax: int,
                       window: int = 0,
                       write_mask: torch.Tensor | None = None) -> None:
    """``decode_attention``'s write on the slots ``[start, start + L)`` of
    a dense cache of ``smax`` slots, IN PLACE: row b's new K/V (B,1,KVH,hd)
    go to slot ``cached[b]`` (``% smax`` in a window's ring) when this
    shard holds it; a row whose ``write_mask`` is False, or whose slot is
    elsewhere or past ``smax``, leaves the shard's bits as they were."""
    n = k_shard.shape[1]
    if n == 0:
        return
    idx = cached.long()
    if window:
        idx = idx % smax
    keep = (idx >= start) & (idx < min(start + n, smax))
    if write_mask is not None:
        keep = keep & write_mask
    rows = torch.arange(idx.shape[0], device=idx.device)
    i = (idx - start).clamp(0, n - 1)
    k_shard[rows, i] = torch.where(keep[:, None, None],
                                   new_k[:, 0].to(k_shard.dtype),
                                   k_shard[rows, i])
    v_shard[rows, i] = torch.where(keep[:, None, None],
                                   new_v[:, 0].to(v_shard.dtype),
                                   v_shard[rows, i])


def decode_partial(q: torch.Tensor, k_shard: torch.Tensor,
                   v_shard: torch.Tensor, cached: torch.Tensor, *,
                   start: int, window: int = 0):
    """One-token queries q (B,1,H,hd) against the slots ``[start, start +
    L)`` of a dense cache (``k_shard``/``v_shard``: (B,L,KVH,hd), the new
    token already written), under ``decode_attention``'s mask at the
    global slot indices (``cached``: the (B,) lengths before this step):
    ``pos <= cached`` for a full cache, ``pos < min(cached + 1, window)``
    for a window's ring.  Returns the pieces of a partial softmax, float32,
    as flash decoding splits it: the row max ``m`` (B,H) (the finite
    ``NEG_INF`` where the shard holds no valid slot), the row sum ``l``
    (B,H) of ``exp(s - m)`` over the valid slots (0 where none is) and
    ``acc`` (B,H,hd), the same weights times V.  Combined over the shards
    (``M = max m``, sums of ``l·exp(m - M)`` and ``acc·exp(m - M)``), ``acc
    / max(l, 1e-30)`` is ``decode_attention``'s output."""
    b, _, h, hd = q.shape
    kvh = k_shard.shape[2]
    g = h // kvh
    n = k_shard.shape[1]
    qg = (q.reshape(b, 1, kvh, g, hd) * (1.0 / math.sqrt(hd))).float()
    pos = start + torch.arange(n, device=q.device)[None, :]
    last = cached.long()[:, None]
    valid = pos <= last
    if window:
        valid = pos < torch.clamp(last + 1, max=window)
    s = torch.einsum("bqnGd,bknd->bnGqk", qg, k_shard.float())
    mask = valid[:, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1) if n else s.new_full(s.shape[:-1], NEG_INF)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bnGqk,bknd->bnGqd", p, v_shard.float())
    return m.reshape(b, h), p.sum(dim=-1).reshape(b, h), \
        acc.reshape(b, h, hd)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache: KVCache, *, offset: torch.Tensor,
                    length: torch.Tensor, window: int = 0):
    """Attention for one prefill chunk resuming from a dense cache at
    ``offset`` (``repro.models.attention.chunk_attention``).

    q/k/v: (B,C,H|KVH,hd) at positions ``offset + i``; ``length``: (B,) real
    tokens in the right-padded chunk.  The chunk's real K/V are written IN
    PLACE — left-aligned at ``offset`` for full attention, into ring slots
    for a window — and every real q row attends to its causal (and window)
    horizon, as if the whole prompt had been prefilled at once.  Rows past
    ``length`` give garbage.  Returns (out, cache with length
    offset + length)."""
    b, c, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    smax = cache.k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    offset, length = offset.long(), length.long()
    q_pos = offset[:, None] + torch.arange(c, device=dev)[None, :]   # (B,C)
    qg = (q.reshape(b, c, kvh, g, hd) * scale).float()
    new_len = offset + length

    def gather_chunk(src: torch.Tensor, arr: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
        i = src.clamp(0, c - 1)[:, :, None, None].expand(-1, -1, kvh, hd)
        return torch.gather(arr.to(dtype), 1, i)

    def write(m: torch.Tensor, src: torch.Tensor) -> None:
        m4 = m[:, :, None, None]
        cache.k.copy_(torch.where(m4, gather_chunk(src, k, cache.k.dtype),
                                  cache.k))
        cache.v.copy_(torch.where(m4, gather_chunk(src, v, cache.v.dtype),
                                  cache.v))

    j = torch.arange(smax, device=dev)[None, :]                      # (1,S)
    if not window:
        # chunk rows < length land at offset..offset+length-1; stale
        # entries past new_len stay, masked until decode overwrites them
        src = j - offset[:, None]
        write((src >= 0) & (src < length[:, None]), src)
        mask = j[:, None, :] <= q_pos[:, :, None]                    # (B,C,S)
        out = _attend(qg, cache.k, cache.v, mask)
        return out.to(q.dtype), cache._replace(length=new_len.to(torch.int32))

    # a ring of W slots: attend over (prior ring ++ chunk) BEFORE writing,
    # since the chunk overwrites slots whose old occupants are still inside
    # the early q rows' windows.  Slot j holds the last p < offset with
    # p % W == j.
    p_prior = (offset[:, None] - 1) - ((offset[:, None] - 1 - j) % smax)
    chunk_valid = torch.arange(c, device=dev)[None, :] < length[:, None]
    kv_pos = torch.cat([p_prior, q_pos], dim=1)                      # (B,W+C)
    kv_valid = torch.cat([p_prior >= 0, chunk_valid], dim=1)
    mask = (kv_valid[:, None, :]
            & (kv_pos[:, None, :] <= q_pos[:, :, None])
            & (kv_pos[:, None, :] > q_pos[:, :, None] - window))
    out = _attend(qg, torch.cat([cache.k.float(), k.float()], dim=1),
                  torch.cat([cache.v.float(), v.float()], dim=1), mask)
    # ring write: slot j's new occupant is the last real position < new_len
    # congruent to j — from the chunk if >= offset, else the old entry
    last = new_len[:, None] - 1
    src = last - ((last - j) % smax) - offset[:, None]
    write(src >= 0, src)
    return out.to(q.dtype), cache._replace(length=new_len.to(torch.int32))


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
    ``write_mask`` False drop their write and keep their length, and attend
    through their table row as the JAX package's do: their output is
    discarded, but an MoE feed-forward routes it beside the live rows, so
    it must be the reference's.  Returns (out (B,1,H,hd), cache)."""
    out, _, _ = paged_ops.paged_decode_attention(
        q, new_k, new_v, cache.k, cache.v, block_table, cache.length,
        write_mask=write_mask)
    inc = 1 if write_mask is None else write_mask.to(torch.int32)
    return out, cache._replace(length=cache.length + inc)


def paged_write(pool_k: torch.Tensor, pool_v: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, block_table: torch.Tensor,
                pos: torch.Tensor, valid: torch.Tensor | None = None) -> None:
    """Write k/v (B,S,KVH,hd) at logical positions ``pos`` (B,S) through
    the block table into the pools (N,bs,KVH,hd), IN PLACE.  Rows where
    ``valid`` (B,S) is False drop their write, as do table entries >= N
    and positions past the table's end."""
    n, bs = pool_k.shape[0], pool_k.shape[1]
    blk = table_lookup(block_table, pos // bs, n)
    if valid is not None:
        blk = torch.where(valid, blk, torch.full_like(blk, n))
    scatter_paged(pool_k, blk, pos % bs, k)
    scatter_paged(pool_v, blk, pos % bs, v)


def paged_fill_cache(cache: PagedKVCache, k: torch.Tensor, v: torch.Tensor,
                     block_table: torch.Tensor, *,
                     length: torch.Tensor | None = None) -> PagedKVCache:
    """Write prefill K/V through the block table.  k/v: (B,S,KVH,hd)
    right-padded; only rows < ``length`` are written.  Rows whose table row
    is all sentinel (batch padding) drop every write."""
    b, s = k.shape[0], k.shape[1]
    j = torch.arange(s, device=k.device)
    paged_write(cache.k, cache.v, k, v, block_table, j.expand(b, s),
                None if length is None else j[None, :] < length[:, None])
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
    scale = 1.0 / math.sqrt(hd)
    q_pos = offset[:, None].long() + torch.arange(c, device=q.device)[None]
    paged_write(cache.k, cache.v, k, v, block_table, q_pos,
                torch.arange(c, device=q.device)[None, :] < length[:, None])
    ks, vs = gather_paged_kv(cache, block_table)               # (B,Smax,..)
    smax = ks.shape[1]
    qg = (q.reshape(b, c, kvh, g, hd) * scale).float()
    mask = torch.arange(smax, device=q.device)[None, None, :] \
        <= q_pos[:, :, None]                                    # (B,C,Smax)
    out = _attend(qg, ks, vs, mask)
    return out.to(q.dtype), cache._replace(
        length=(offset + length).to(torch.int32))
