"""The serving engine's state surgery on a mesh: slot rows and pool blocks
moved between DTensor shards, on each rank's local tensors.

A state leaf's slot axis is split over the mesh's ``data`` axis when the
slots split evenly (``launch.shardings.serve_state_specs``): slot ``s``
then lives on data rank ``s // (slots / n)``, at local row ``s % (slots /
n)``.  A paged pool's block axis is split the same way into stripes, so
block ``b`` lives on data rank ``b // (blocks / n)``
(``serve.kvpool.KVBlockPool.shard_of``).  Every helper moves exactly the
bits the meshless engine's indexing would (copies, broadcasts and
all-gathers; no arithmetic), and every rank calls it with the same
arguments, as SPMD host logic does.

A suitcase that crosses from one role's submesh to the other's ranks
travels in wire form (``pack``, ``Parcel``, ``unpack``): each rank's local
parts of its leaves as one byte buffer, beside each leaf's global shape,
dtype and placements, so the receiving ranks rebuild the DTensors on their
own mesh with the same bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.attention import KVCache, PagedKVCache
from ..models.transformer import BlockState

#: each leaf's bytes start at a multiple of this in a packed suitcase, so
#: every leaf's part is a view of the buffer at its own dtype
WIRE_ALIGN = 16


def _data(t: DTensor):
    """(data mesh dim, its size, this rank's index on it, whether ``t``'s
    axis 0 is split over it)."""
    mesh = t.device_mesh
    dd = mesh.mesh_dim_names.index("data")
    p = t.placements[dd]
    return dd, mesh.size(dd), mesh.get_local_rank(dd), \
        isinstance(p, Shard) and p.dim == 0


def _with_data(t: DTensor, placement) -> tuple:
    dd = t.device_mesh.mesh_dim_names.index("data")
    return tuple(placement if i == dd else p
                 for i, p in enumerate(t.placements))


def _broadcast(buf: torch.Tensor, t: DTensor, owner: int) -> torch.Tensor:
    """``buf`` from data rank ``owner`` to every rank of this rank's data
    group."""
    grp = t.device_mesh.get_group("data")
    dist.broadcast(buf, src=dist.get_global_rank(grp, owner), group=grp)
    return buf


def slot_row(t: DTensor, slot: int) -> DTensor:
    """A batch-1 copy of row ``slot`` of ``t``, replicated over ``data``:
    the owner's row, broadcast."""
    dd, n, me, split = _data(t)
    local = t.to_local()
    if not split:
        row = local[slot:slot + 1].clone()
    else:
        per = t.shape[0] // n
        owner = slot // per
        row = local[slot - owner * per:slot - owner * per + 1].clone() \
            if me == owner else local.new_empty((1,) + local.shape[1:])
        if n > 1:
            _broadcast(row, t, owner)
    return DTensor.from_local(row, t.device_mesh,
                              _with_data(t, Replicate()), run_check=False)


def splice_rows(dst: DTensor, rows: DTensor, slot_ids: list[int]) -> None:
    """Rows ``0..len(slot_ids)-1`` of ``rows`` into slots ``slot_ids`` of
    ``dst``, IN PLACE: ``rows`` is gathered over ``data`` where it is split,
    and each slot's owner writes it."""
    dd, n, me, split = _data(dst)
    rows = rows.redistribute(placements=_with_data(dst, Replicate()))
    src = rows.to_local()
    per = dst.shape[0] // n if split else dst.shape[0]
    lo = me * per if split else 0
    mine = [(i, s - lo) for i, s in enumerate(slot_ids) if lo <= s < lo + per]
    if not mine:
        return
    dev = src.device
    idx = torch.tensor([j for _, j in mine], dtype=torch.long, device=dev)
    sel = torch.tensor([i for i, _ in mine], dtype=torch.long, device=dev)
    dst.to_local()[idx] = src.index_select(0, sel)


def copy_block(pool: DTensor, src: int, dst: int) -> None:
    """Clone block ``src`` of ``pool`` into block ``dst``, IN PLACE: the
    source stripe's owner broadcasts it where the two live apart."""
    dd, n, me, split = _data(pool)
    local = pool.to_local()
    if not split:
        local[dst] = local[src]
        return
    per = pool.shape[0] // n
    so, do = src // per, dst // per
    if so == do:
        if me == so:
            local[dst - me * per] = local[src - me * per]
        return
    buf = local[src - so * per].clone() if me == so \
        else local.new_empty(local.shape[1:])
    _broadcast(buf, pool, so)
    if me == do:
        local[dst - do * per] = buf


def read_blocks(pool: DTensor, ids: list[int]) -> DTensor:
    """Copies of blocks ``ids`` of ``pool`` (each clipped to the pool),
    replicated over ``data``: each stripe's owner fills its blocks and the
    pieces are all-gathered."""
    dd, n, me, split = _data(pool)
    local = pool.to_local()
    nblk = pool.shape[0]
    ids = [min(max(b, 0), nblk - 1) for b in ids]
    dev = local.device
    if not split:
        out = local.index_select(0, torch.tensor(ids, dtype=torch.long,
                                                 device=dev))
    else:
        per = nblk // n
        mine = [i for i, b in enumerate(ids) if b // per == me]
        part = local.new_zeros((len(ids),) + local.shape[1:])
        if mine:
            part[torch.tensor(mine, device=dev)] = local.index_select(
                0, torch.tensor([ids[i] - me * per for i in mine],
                                device=dev))
        every = local.new_empty((n * part.shape[0],) + part.shape[1:])
        dist.all_gather_into_tensor(every, part,
                                    group=pool.device_mesh.get_group("data"))
        every = every.view((n,) + part.shape)
        owner = torch.tensor([b // per for b in ids], device=dev)
        out = every[owner, torch.arange(len(ids), device=dev)]
    return DTensor.from_local(out, pool.device_mesh,
                              _with_data(pool, Replicate()), run_check=False)


def write_blocks(pool: DTensor, ids: list[int], blocks: DTensor) -> None:
    """Blocks ``blocks`` (replicated over ``data``) into blocks ``ids`` of
    ``pool``, IN PLACE; each stripe's owner writes its own, and an id past
    the pool (a sentinel) writes nothing."""
    dd, n, me, split = _data(pool)
    local = pool.to_local()
    src = blocks.redistribute(
        placements=_with_data(pool, Replicate())).to_local()
    per = pool.shape[0] // n if split else pool.shape[0]
    lo = me * per if split else 0
    mine = [(i, b - lo) for i, b in enumerate(ids) if lo <= b < lo + per]
    if mine:
        dev = local.device
        local.index_copy_(
            0, torch.tensor([j for _, j in mine], device=dev),
            src.index_select(0, torch.tensor([i for i, _ in mine],
                                             device=dev)))


# ------------------------------------------------------------------- wire
class Parcel(NamedTuple):
    """A suitcase in wire form: its layers' layout (``tree``: per layer
    ``("paged" | "kv" | "rec", rec keys)``), each leaf's ``(global shape,
    dtype name, placements)`` (``metas``: a placement is ``("S", dim)`` or
    ``("R",)`` per mesh dim) and this rank's local parts of the leaves,
    packed into one ``uint8`` buffer (``data``)."""
    tree: list
    metas: list
    data: torch.Tensor


def _placement_meta(p) -> tuple:
    if isinstance(p, Shard):
        return ("S", p.dim)
    if isinstance(p, Replicate):
        return ("R",)
    raise ValueError(f"a suitcase leaf holds a {p} placement: only "
                     f"whole or split state crosses between meshes")


def _local_shape(meta: tuple, mesh) -> tuple:
    """This rank's part of a leaf of ``meta`` on ``mesh`` (even splits:
    the serving specs split only axes that divide)."""
    shape = list(meta[0])
    for m, p in enumerate(meta[2]):
        if p[0] == "S":
            n = mesh.size(m)
            if meta[0][p[1]] % n:
                raise ValueError(f"axis {p[1]} of {meta[0]} does not split "
                                 f"{n} ways")
            shape[p[1]] //= n
    return tuple(shape)


def _wire_sizes(metas: list, mesh) -> list[tuple[int, int]]:
    """(byte offset, byte count) of each leaf's part in the buffer."""
    out, off = [], 0
    for meta in metas:
        n = math.prod(_local_shape(meta, mesh)) \
            * getattr(torch, meta[1]).itemsize
        out.append((off, n))
        off += -(-n // WIRE_ALIGN) * WIRE_ALIGN
    return out


def wire_bytes(metas: list, mesh) -> int:
    """The byte length of a packed suitcase of ``metas`` on ``mesh``."""
    off, n = _wire_sizes(metas, mesh)[-1]
    return -(-(off + n) // WIRE_ALIGN) * WIRE_ALIGN


def pack(suitcase: list[BlockState]) -> Parcel:
    """The wire form of a suitcase of DTensors, each replicated over
    ``data`` (``slot_row``, ``read_blocks``): this rank's local parts,
    their bits copied into one byte buffer (no arithmetic)."""
    tree, leaves = [], []
    for st in suitcase:
        if st.kv is not None:
            tree.append(("paged" if isinstance(st.kv, PagedKVCache)
                         else "kv", ()))
            leaves += list(st.kv)
        else:
            tree.append(("rec", tuple(st.rec)))
            leaves += list(st.rec.values())
    dd = leaves[0].device_mesh.mesh_dim_names.index("data")
    metas = []
    for t in leaves:
        if not isinstance(t.placements[dd], Replicate):
            raise ValueError("a suitcase leaf must be replicated over data")
        metas.append((tuple(t.shape), str(t.dtype).removeprefix("torch."),
                      tuple(_placement_meta(p) for p in t.placements)))
    mesh = leaves[0].device_mesh
    data = torch.zeros(wire_bytes(metas, mesh), dtype=torch.uint8,
                       device=leaves[0].to_local().device)
    for t, (off, n) in zip(leaves, _wire_sizes(metas, mesh)):
        data[off:off + n] = t.to_local().contiguous().view(-1) \
            .view(torch.uint8)
    return Parcel(tree, metas, data)


def unpack(parcel: Parcel, mesh) -> list[BlockState]:
    """A received ``Parcel`` as a suitcase on ``mesh``: each leaf a DTensor
    of its sender's placements whose local part is a view of the buffer
    (the sender's bits)."""
    leaves = []
    for meta, (off, n) in zip(parcel.metas, _wire_sizes(parcel.metas,
                                                        mesh)):
        shape, dtype = meta[0], getattr(torch, meta[1])
        part = parcel.data[off:off + n].view(dtype).view(
            _local_shape(meta, mesh))
        placements = tuple(Shard(p[1]) if p[0] == "S" else Replicate()
                           for p in meta[2])
        leaves.append(DTensor.from_local(
            part, mesh, placements, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride()))
    out, i = [], 0
    for kind, keys in parcel.tree:
        if kind == "rec":
            out.append(BlockState(rec=dict(zip(keys,
                                               leaves[i:i + len(keys)]))))
            i += len(keys)
        else:
            cls = PagedKVCache if kind == "paged" else KVCache
            n = len(cls._fields)
            out.append(BlockState(kv=cls(*leaves[i:i + n])))
            i += n
    return out
