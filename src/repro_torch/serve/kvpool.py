"""Paged KV-cache bookkeeping: block pool, radix prefix cache, and the
engine-facing manager.

The Mensa reading of the paper's third Edge TPU pitfall is that one-size
memory provisioning wastes capacity because working sets are heterogeneous.
The serving equivalent: a dense ``slots x max_len`` KV allocation charges
every request for the engine's worst case.  This module is the host-side
half of the fix — KV memory becomes a pool of fixed-size blocks:

* ``KVBlockPool``     — refcounted block allocator with a free list and LRU
  eviction of cached-but-unreferenced blocks.  Blocks are *indices*; the
  actual K/V tensors live in the model state tree (one
  ``models.attention.PagedKVCache`` per attention layer, all layers indexed
  by the same block ids).
* ``RadixPrefixCache`` — a radix tree over token-id keys at block
  granularity.  Finished (and freshly prefilled) prompts publish their full
  blocks; an incoming prompt walks the tree and maps every matched block to
  a shared read-only block, skipping prefill for the shared prefix.  A
  partial-block match is served copy-on-write: the block is cloned and only
  the divergent tail is computed.
* ``PagedKVManager``  — the facade ``ServeEngine`` talks to: per-slot block
  tables, admission planning (match + ref + alloc + COW), decode-time
  extension, and same-tick release when a request retires.

Everything here is plain Python over numpy block tables — device work (the
actual scatter/gather through the tables) lives in ``models/attention.py``
and ``kernels/paged_attention``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass


def blocks_for(tokens: int, block_size: int) -> int:
    """Number of blocks needed to hold ``tokens`` tokens."""
    return -(-tokens // block_size)


# ------------------------------------------------------------------ radix tree
class _RadixNode:
    """One cached block: ``key`` is the exact block_size-token tuple, ``block``
    the pool block holding its KV.  Children extend the token path."""
    __slots__ = ("key", "block", "children", "parent", "last_use")

    def __init__(self, key: tuple, block: int, parent: "_RadixNode | None"):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict[tuple, _RadixNode] = {}
        self.last_use = 0


@dataclass
class PrefixMatch:
    """Result of a prefix-cache lookup."""
    blocks: list[int]                    # full shared blocks, in prefix order
    partial_block: int | None = None     # block sharing only a head of tokens
    partial_tokens: int = 0              # how many of its tokens match


class RadixPrefixCache:
    """Radix tree over token ids at block granularity.

    Nodes are created when a prompt's full blocks are *published* (after
    prefill, and again — now including generated tokens — when the request
    finishes).  A published block may still be referenced by running slots;
    the pool's refcounts decide when it becomes evictable.  Eviction removes
    leaf nodes only, so every cached block's prefix path stays intact.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = _RadixNode((), -1, None)
        self.by_block: dict[int, _RadixNode] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self.by_block)

    def _touch(self, node: _RadixNode) -> None:
        self._clock += 1
        node.last_use = self._clock

    def match(self, tokens: list[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens``: full blocks, plus at most one
        partially-matching block (the copy-on-write candidate) whose first
        ``partial_tokens`` ids agree with the remaining tokens."""
        bs = self.block_size
        node = self.root
        blocks: list[int] = []
        i = 0
        while i + bs <= len(tokens):
            key = tuple(tokens[i:i + bs])
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            blocks.append(child.block)
            node = child
            i += bs
        # partial tail: the child sharing the longest strict head of the
        # remaining tokens — its block is cloned (COW) by the caller
        rest = tokens[i:]
        best, best_t = None, 0
        if rest:
            for child in node.children.values():
                t = 0
                for a, b in zip(child.key, rest):
                    if a != b:
                        break
                    t += 1
                if t > best_t:
                    best, best_t = child, t
        if best is not None:
            self._touch(best)
            return PrefixMatch(blocks, best.block, best_t)
        return PrefixMatch(blocks)

    def insert(self, tokens: list[int], block_ids: list[int]) -> int:
        """Publish the full blocks of ``tokens`` (backed by ``block_ids``,
        one per block) into the tree.  Where a path node already exists the
        existing block wins (the caller's duplicate stays owned by its slot
        and is freed on release).  Returns how many NEW blocks the tree now
        references."""
        bs = self.block_size
        node = self.root
        added = 0
        for bi in range(len(tokens) // bs):
            key = tuple(tokens[bi * bs:(bi + 1) * bs])
            child = node.children.get(key)
            if child is None:
                block = block_ids[bi]
                if block in self.by_block:       # block already published
                    break                        # (shared path diverged)
                child = _RadixNode(key, block, node)
                node.children[key] = child
                self.by_block[block] = child
                added += 1
            self._touch(child)
            node = child
        return added

    def reclaimable(self, unreferenced) -> int:
        """How many cached blocks cascading leaf-first eviction could
        actually free: a node counts only if its ENTIRE subtree is
        unreferenced — an unreferenced ancestor of a block some slot still
        maps can never become a leaf while that reference lives."""
        def walk(node):
            clean = True
            cnt = 0
            for child in node.children.values():
                c_clean, c_cnt = walk(child)
                cnt += c_cnt
                clean = clean and c_clean
            if node is self.root:
                return clean, cnt
            if clean and unreferenced(node.block):
                return True, cnt + 1
            return False, cnt
        return walk(self.root)[1]

    def evict_lru(self, evictable) -> int | None:
        """Remove and return the least-recently-used *leaf* block for which
        ``evictable(block_id)`` holds (i.e. refcount 0).  None if nothing
        qualifies."""
        best: _RadixNode | None = None
        for node in self.by_block.values():
            if node.children or not evictable(node.block):
                continue
            if best is None or node.last_use < best.last_use:
                best = node
        if best is None:
            return None
        del best.parent.children[best.key]
        del self.by_block[best.block]
        return best.block

    def contains(self, block: int) -> bool:
        return block in self.by_block


# ------------------------------------------------------------------ block pool
class KVBlockPool:
    """Fixed population of KV blocks with refcounts and a free list.

    A block is in exactly one of three states:
      * free      — on the free list, contents meaningless;
      * in use    — refcount > 0 (one ref per slot whose table maps it);
      * cached    — refcount 0 but published in the radix tree (evictable,
                    contents preserved for future prefix hits).
    """

    def __init__(self, num_blocks: int, block_size: int, shards: int = 1):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"need >= 1 blocks of >= 1 tokens, got "
                             f"{num_blocks} x {block_size}")
        if shards < 1 or num_blocks % shards:
            raise ValueError(f"num_blocks {num_blocks} must divide into "
                             f"{shards} equal shards (the device pool is "
                             f"sharded in contiguous stripes)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.ref = [0] * num_blocks
        self.free = deque(range(num_blocks))
        self.blocks_evicted = 0
        self.in_use = 0                      # blocks with ref > 0
        self.peak_in_use = 0                 # high-water mark at alloc/retain
                                             # time, before same-tick releases
        # per-shard mirror of the device layout: when the pool's block axis is
        # sharded over a mesh, shard i owns the contiguous stripe
        # [i*N/shards, (i+1)*N/shards) — NamedSharding's split of axis 0.
        # ``peak_by_shard`` is the per-shard distribution AT the global peak,
        # so it always sums exactly to ``peak_in_use``.
        self.shards = shards
        self.in_use_by_shard = [0] * shards
        self.peak_by_shard = [0] * shards

    def shard_of(self, block: int) -> int:
        return block // (self.num_blocks // self.shards)

    def _count(self, block: int, delta: int) -> None:
        self.in_use += delta
        self.in_use_by_shard[self.shard_of(block)] += delta
        if delta > 0 and self.in_use > self.peak_in_use:
            self.peak_in_use = self.in_use
            self.peak_by_shard = list(self.in_use_by_shard)

    def available(self, tree: RadixPrefixCache) -> int:
        """Blocks allocatable right now: free + cached blocks that cascading
        leaf-first eviction can actually reach (an unreferenced block whose
        subtree holds another slot's referenced block is NOT supply)."""
        return len(self.free) + tree.reclaimable(lambda b: self.ref[b] == 0)

    def alloc(self, tree: RadixPrefixCache) -> int | None:
        """Pop a free block, evicting the LRU cached block if none is free.
        Returns None when every block is referenced."""
        if not self.free:
            victim = tree.evict_lru(lambda b: self.ref[b] == 0)
            if victim is None:
                return None
            self.blocks_evicted += 1
            self.free.append(victim)
        block = self.free.popleft()
        assert self.ref[block] == 0
        self.ref[block] = 1
        self._count(block, +1)
        return block

    def retain(self, block: int) -> None:
        if self.ref[block] == 0:             # cached -> referenced again
            self._count(block, +1)
        self.ref[block] += 1

    def release(self, block: int, tree: RadixPrefixCache) -> None:
        """Drop one reference; unpublished blocks go back to the free list
        the moment they hit refcount 0, published ones stay cached."""
        assert self.ref[block] > 0, f"double release of block {block}"
        self.ref[block] -= 1
        if self.ref[block] == 0:
            self._count(block, -1)
            if not tree.contains(block):
                self.free.append(block)


# -------------------------------------------------------------------- manager
@dataclass
class AdmitPlan:
    """What the engine must do to start a prompt on a slot."""
    matched_tokens: int = 0              # prefix tokens served from the cache
    copy: tuple[int, int] | None = None  # (src, dst) block clone (COW), if any


@dataclass
class KVPoolStats:
    prefix_queries: int = 0
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    blocks_copied: int = 0


class PagedKVManager:
    """Per-slot block tables + admission/extension/release over the pool.

    The engine asks for an :class:`AdmitPlan` at admission (prefix match,
    refs on shared blocks, fresh blocks covering the prompt, an optional COW
    clone), calls :meth:`extend` before each decode write, and
    :meth:`finish` the same tick a request retires — which both publishes
    the finished sequence's full blocks for future prefix hits and releases
    the slot's references immediately.
    """

    #: table entries >= num_blocks mean "no block": device code drops writes
    #: through them and masks reads (see models/attention.py).
    def __init__(self, *, slots: int, max_len: int, block_size: int,
                 num_blocks: int, prefix_cache: bool = True,
                 shards: int = 1):
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"kv_block_size {block_size} (the gathered "
                             f"sequence must tile exactly for the paged path "
                             f"to stay bitwise-identical to dense)")
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_slot = max_len // block_size
        self.pool = KVBlockPool(num_blocks, block_size, shards)
        self.tree = RadixPrefixCache(block_size)
        self.prefix_enabled = prefix_cache
        self.sentinel = num_blocks
        # host block table; rows are padded with the sentinel
        self.table = [[self.sentinel] * self.blocks_per_slot
                      for _ in range(slots)]
        self.owned = [0] * slots             # blocks mapped per slot
        self.stats = KVPoolStats()
        # bumped on every table mutation so the engine can cache the
        # device-side copy across decode ticks
        self.version = 0
        # device bytes per physical block, set by the engine once the pool's
        # K/V arrays exist (layer count x 2 x heads x head_dim x itemsize is
        # the model's business, not the allocator's) — 0 until then, and the
        # byte telemetry below reads 0 rather than guessing
        self.block_bytes = 0

    def set_block_bytes(self, n: int) -> None:
        self.block_bytes = int(n)

    # ------------------------------------------------------------------ stats
    @property
    def in_use(self) -> int:
        return self.pool.in_use

    @property
    def bytes_in_use(self) -> int:
        """Device bytes referenced by live block mappings."""
        return self.pool.in_use * self.block_bytes

    @property
    def bytes_peak(self) -> int:
        return self.pool.peak_in_use * self.block_bytes

    @property
    def cached(self) -> int:
        return sum(1 for b in self.tree.by_block if self.pool.ref[b] == 0)

    @property
    def blocks_evicted(self) -> int:
        return self.pool.blocks_evicted

    @property
    def shards(self) -> int:
        return self.pool.shards

    @property
    def in_use_by_shard(self) -> list[int]:
        """Referenced blocks per device shard (sums to :attr:`in_use`)."""
        return list(self.pool.in_use_by_shard)

    @property
    def peak_by_shard(self) -> list[int]:
        """Per-shard distribution at the pool's high-water mark (sums to
        ``pool.peak_in_use`` exactly)."""
        return list(self.pool.peak_by_shard)

    def reset_stats(self) -> None:
        self.stats = KVPoolStats()
        self.pool.blocks_evicted = 0
        self.pool.peak_in_use = self.pool.in_use
        self.pool.peak_by_shard = list(self.pool.in_use_by_shard)

    def clear(self) -> None:
        """Forget every block and cached prefix (counters survive): the
        engine calls this when it re-initializes the device pool, whose
        contents the tree's nodes describe."""
        assert all(o == 0 for o in self.owned), \
            "clear() with slots still holding blocks"
        evicted = self.pool.blocks_evicted
        self.pool = KVBlockPool(self.pool.num_blocks, self.block_size,
                                self.pool.shards)
        self.pool.blocks_evicted = evicted
        self.tree = RadixPrefixCache(self.block_size)
        self.table = [[self.sentinel] * self.blocks_per_slot
                      for _ in range(self.slots)]
        self.version += 1

    # -------------------------------------------------------------- admission
    def admit(self, slot: int, prompt: list[int]) -> AdmitPlan | None:
        """Plan serving ``prompt`` on ``slot``: match the prefix cache, take
        references on shared blocks, allocate fresh blocks to cover the rest
        of the prompt, and clone the partially-matched block if any.  Returns
        None — with no side effects — when the pool cannot cover the prompt
        (the engine requeues the request)."""
        assert self.owned[slot] == 0, f"slot {slot} still holds blocks"
        need_total = blocks_for(len(prompt), self.block_size)
        if need_total > self.blocks_per_slot:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds "
                             f"max_len {self.max_len}")
        st = self.stats
        st.prefix_queries += 1
        # never match the full prompt: at least one token must run through
        # prefill to produce the first sampled token's logits
        match = (self.tree.match(prompt[:len(prompt) - 1])
                 if self.prefix_enabled else PrefixMatch([]))
        n_shared = len(match.blocks)
        n_cow = 1 if match.partial_tokens else 0
        n_fresh = need_total - n_shared      # includes the COW clone
        # blocks the plan is about to pin (cached shared matches + the COW
        # source) stop being evictable the moment we retain them — they must
        # not count toward the supply the fresh allocations draw from
        pinned = [b for b in match.blocks if self.pool.ref[b] == 0]
        if match.partial_tokens and self.pool.ref[match.partial_block] == 0:
            pinned.append(match.partial_block)
        if self.pool.available(self.tree) - len(pinned) < n_fresh:
            return None                      # no side effects: requeue
        row = self.table[slot]
        for i, b in enumerate(match.blocks):
            self.pool.retain(b)
            row[i] = b
        self.owned[slot] = n_shared
        copy = None
        matched = n_shared * self.block_size
        if n_cow:
            # pin the source so allocating the clone can't evict it
            self.pool.retain(match.partial_block)
            dst = self.pool.alloc(self.tree)
            self.pool.release(match.partial_block, self.tree)
            if dst is None:
                self.release(slot)           # roll back: requeue, not crash
                return None
            row[n_shared] = dst
            self.owned[slot] = n_shared + 1
            copy = (match.partial_block, dst)
            matched += match.partial_tokens
        for i in range(n_shared + n_cow, need_total):
            b = self.pool.alloc(self.tree)
            if b is None:
                self.release(slot)           # roll back: requeue, not crash
                return None
            row[i] = b
            self.owned[slot] = i + 1
        if n_cow:
            st.blocks_copied += 1
        if matched:
            st.prefix_hits += 1
            st.prefix_tokens_reused += matched
        self.version += 1
        return AdmitPlan(matched_tokens=matched, copy=copy)

    # -------------------------------------------------------------- handoff
    def adopt(self, slot: int, length: int) -> bool:
        """Map fresh blocks for a sequence of ``length`` tokens arriving from
        another engine's pool (disaggregated handoff).  Pure table remap: the
        block *contents* land via the engine's import program, which scatters
        the visiting suitcase into exactly the rows mapped here.  False — with
        no side effects — when the pool cannot cover the sequence (the
        coordinator retries next tick)."""
        assert self.owned[slot] == 0, f"slot {slot} still holds blocks"
        if not self.extend(slot, length):
            self.release(slot)               # roll back partial allocation
            return False
        return True

    # ------------------------------------------------------------- decode path
    def extend(self, slot: int, length: int) -> bool:
        """Make the slot's table cover ``length`` tokens, allocating blocks
        as decode crosses block boundaries.  False when the pool is out of
        blocks (the engine stalls the slot this tick)."""
        need = blocks_for(length, self.block_size)
        if need > self.blocks_per_slot:
            return False
        row = self.table[slot]
        while self.owned[slot] < need:
            b = self.pool.alloc(self.tree)
            if b is None:
                return False
            row[self.owned[slot]] = b
            self.owned[slot] += 1
            self.version += 1
        return True

    # ---------------------------------------------------------------- publish
    def publish(self, slot: int, tokens: list[int]) -> None:
        """Insert the slot's full blocks for ``tokens`` into the prefix tree
        so concurrent and future same-prefix requests hit them."""
        if not self.prefix_enabled:
            return
        n_full = len(tokens) // self.block_size
        if n_full == 0:
            return
        row = self.table[slot]
        self.tree.insert(tokens[:n_full * self.block_size], row[:n_full])

    def finish(self, slot: int, tokens: list[int]) -> None:
        """Same-tick retirement: publish the finished sequence's full blocks
        (``tokens`` must cover only positions whose KV was actually written —
        future prompts extending it hit them), then release every reference
        the slot holds and clear its table row."""
        self.publish(slot, tokens)
        self.release(slot)

    def release(self, slot: int) -> None:
        """Drop a slot's blocks without publishing (aborted requests, and
        the release half of :meth:`finish`)."""
        row = self.table[slot]
        for i in range(self.owned[slot]):
            self.pool.release(row[i], self.tree)
            row[i] = self.sentinel
        self.owned[slot] = 0
        self.version += 1
