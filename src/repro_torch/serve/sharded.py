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
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard


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
