"""The model over a (data, model) device mesh: where DTensor propagation
hands over to code that runs on each rank's local shard.

A served model on a mesh (``serve.engine.ServeEngine(mesh=...)``) holds
DTensor parameters and DTensor states, and its inputs are DTensors.  The
projections, norms, GLU, gates and unembedding run on DTensors through
DTensor's own sharding propagation (a column-parallel then row-parallel
pair ends in a ``Partial`` that reduces where it is consumed).  The rest
runs per shard through ``local_map``, on plain tensors, because slot and
head (or width) work never crosses a shard:

  * ``rope``: the rotary embedding of a (B,S,H,hd) activation at its rows'
    positions;
  * ``attention``: a layer's whole cache op — the dense cache's or the
    paged pool's write, and the flash, paged-decode or plain attention
    that reads it — so each rank launches its kernel on its shard;
  * ``conv``, ``rglru_scan``, ``ssm_scan``: the causal conv with its
    carried context, and the two scans (the RG-LRU and selective-scan
    kernels) with their carried states;
  * ``rows`` / ``positions`` / ``last_rows``: row-wise index arithmetic on
    batch-major tensors.

Each of them computes the same function as its meshless code, which it
calls unchanged on the local shards.  The inputs are first redistributed
to the placements of the state they meet (a state's slot axis is on
``data`` when the slots split evenly, its heads or width on ``model`` when
they do), so a kernel never sees a DTensor.

A paged pool striped over ``data`` (each data rank holds a contiguous
stripe of every layer's blocks) is read whole: the layer's stripes are
all-gathered before the attention, which writes this rank's rows into the
gathered copy and reads from it; the rows' writes are then all-gathered
too and each rank scatters into its own stripe the ones that land there.
This is correct and simple, not fast (ROADMAP: a later ``perf_opt``); on
one card every collective is a copy of one.

Without a DTensor argument every helper calls its function as it is: the
meshless path runs the same operations as before.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from . import attention as _attention


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _placements(mesh, data: int | None = None,
                model: int | None = None) -> tuple:
    """Placements on ``mesh``: ``Shard(data)`` on its data axis and
    ``Shard(model)`` on its model axis where given, ``Replicate()``
    elsewhere."""
    want = {"data": data, "model": model}
    return tuple(Replicate() if want.get(name) is None else Shard(want[name])
                 for name in mesh.mesh_dim_names)


def _dim_on(t: DTensor, axis: str) -> int | None:
    """The tensor dim ``t`` is split on over mesh ``axis``, or None."""
    p = t.placements[t.device_mesh.mesh_dim_names.index(axis)]
    return p.dim if isinstance(p, Shard) else None


def _batch(t: DTensor) -> int | None:
    """0 when ``t``'s leading (slot) axis is split over ``data``."""
    return 0 if _dim_on(t, "data") == 0 else None


def _to(t, placements):
    """``t`` redistributed to ``placements`` (None and plain tensors pass)."""
    if t is None or not is_dtensor(t) or t.placements == placements:
        return t
    return t.redistribute(placements=placements)


def _on_shards(fn, mesh, out_placements, *args):
    """``local_map`` of ``fn`` over ``args``; ``out_placements``: one
    output's placements, or a tuple of them, one per output."""
    if isinstance(out_placements[0], Placement):
        out_placements = list(out_placements)     # a single output
    return local_map(fn, out_placements=out_placements,
                     device_mesh=mesh)(*args)


# ---------------------------------------------------------------- row maths
def settle(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The residual stream ``x`` (B,...) in its one layout: rows split over
    ``data`` as ``like``'s are, whole on ``model`` — a row-parallel
    product's ``Partial`` sum reduced here, so that no later product picks
    a layout of its own for it."""
    if not is_dtensor(x):
        return x
    return _to(x, _placements(x.device_mesh, data=_batch(like)))


def rows(fn, like: torch.Tensor, *args):
    """``fn(*args)`` on each rank's rows, for batch-major ``args`` whose
    result is batch-major too: split over ``data`` as ``like``'s leading
    axis is, replicated on ``model``."""
    if not is_dtensor(like):
        return fn(*args)
    mesh = like.device_mesh
    pl = _placements(mesh, data=_batch(like))
    return _on_shards(fn, mesh, pl, *(_to(a, pl) for a in args))


def positions(tokens: torch.Tensor, offset: torch.Tensor | None,
              n: int) -> torch.Tensor:
    """(B, n) positions of a prefill of ``n`` tokens a row: ``offset + i``
    (or ``i``)."""
    def local(t, o):
        base = torch.arange(n, device=t.device)[None]
        return base.expand(t.shape[0], n) if o is None \
            else o[:, None].long() + base
    return rows(local, tokens, tokens, offset)


def last_rows(x: torch.Tensor, length: torch.Tensor | None) -> torch.Tensor:
    """x (B,S,D) at each row's position ``length - 1`` (or the last):
    (B,1,D)."""
    def local(xs, ln):
        if ln is None:
            return xs[:, -1:]
        r = torch.arange(xs.shape[0], device=xs.device)
        return xs[r, (ln.long() - 1).clamp(min=0)][:, None]
    return rows(local, x, x, length)


def split_heads(x: torch.Tensor, heads: int,
                head_dim: int) -> torch.Tensor:
    """x (B,S,heads*head_dim) as (B,S,heads,head_dim).  A projection split
    over ``model`` whose heads do not split evenly is gathered whole first:
    its heads are then replicated, as the serving specs lay out a cache
    whose heads do not divide the axis."""
    b, s = x.shape[:2]
    if is_dtensor(x) and _dim_on(x, "model") is not None:
        mp = x.device_mesh.size(x.device_mesh.mesh_dim_names.index("model"))
        if heads % mp:
            x = _to(x, _placements(x.device_mesh, data=_batch(x)))
    return x.reshape(b, s, heads, head_dim)


# ------------------------------------------------------------------- rotary
def rope(fn, x: torch.Tensor, pos: torch.Tensor, theta: float):
    """``fn(x, pos, theta)`` (the rotary embedding of x (B,S,H,hd)) on each
    rank's rows and heads."""
    if not is_dtensor(x):
        return fn(x, pos, theta)
    mesh = x.device_mesh
    pl = _placements(mesh, data=_batch(x), model=_dim_on(x, "model"))
    return _on_shards(lambda a, p: fn(a, p, theta), mesh, pl, _to(x, pl),
                      _to(pos, _placements(mesh, data=_batch(x))))


# ---------------------------------------------------------------- attention
def attention(attend, mode: str, q, k, v, kv, length, offset, table):
    """``attend(q, k, v, kv, length, offset, table) -> (out, kv)`` — one
    layer's cache op and attention — on each rank's slots and heads, laid
    out as the layer's cache ``kv`` is.  ``mode`` ("decode", or "prefill"
    with or without ``offset``) says which positions a paged write
    covers."""
    if not is_dtensor(kv.k):
        return attend(q, k, v, kv, length, offset, table)
    mesh = kv.k.device_mesh
    paged = table is not None
    b = _batch(kv.length)
    heads = 2 if _dim_on(kv.k, "model") == 2 else None
    act = _placements(mesh, data=b, model=heads)
    row = _placements(mesh, data=b)
    striped = paged and _dim_on(kv.k, "data") == 0
    spread = paged and b is not None
    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    grp = mesh.get_group("data") if n_data > 1 else None
    me = mesh.get_local_rank("data")

    def local(q, k, v, ck, cv, cl, length, offset, table):
        cache = type(kv)(ck, cv, cl)
        # a striped pool is read whole: attend writes this rank's rows
        # into the gathered copy and reads from it
        seen = type(kv)(_gather(ck, grp, n_data), _gather(cv, grp, n_data),
                        cl) if striped else cache
        out, new = attend(q, k, v, seen, length, offset, table)
        if (striped or spread) and n_data > 1:
            # every row's write, into the stripe that owns its block
            g = (lambda t: _gather(t, grp, n_data)) if spread \
                else (lambda t: t)
            _paged_write(ck, cv, mode, g(k), g(v), g(table), g(length),
                         g(offset), g(cl),
                         lo=me * ck.shape[0] if striped else 0)
        return out, cache._replace(length=new.length)

    out_pl = (act, kv.k.placements, kv.v.placements, row)
    return _on_shards(local, mesh, out_pl, _to(q, act), _to(k, act),
                      _to(v, act), kv.k, kv.v, kv.length, _to(length, row),
                      _to(offset, row), _to(table, row))


def _gather(t: torch.Tensor, grp, n: int) -> torch.Tensor:
    """``t``'s shards over the data group, concatenated on axis 0 (None
    and a 1-wide group pass)."""
    if grp is None or t is None:
        return t
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=grp)
    return out


def _paged_write(pool_k, pool_v, mode: str, k, v, table, length, offset,
                 old_len, *, lo: int) -> None:
    """Every row's new K/V written into this rank's stripe ``[lo, lo+N)``
    of the pool, at the positions the mode's own write covers: the cached
    length ``old_len`` in decode (rows whose 0/1 ``length`` is 0 drop),
    ``offset + i`` for a chunk's first ``length`` rows, ``i < length`` for
    a prefill.  Table entries outside the stripe become the sentinel."""
    n = pool_k.shape[0]
    t = table.long() - lo
    t = torch.where((t >= 0) & (t < n), t, torch.full_like(t, n))
    if mode == "decode":
        pos = old_len.long()[:, None]
        valid = None if length is None else (length > 0)[:, None]
    else:
        j = torch.arange(k.shape[1], device=k.device)[None]
        pos = j.expand(k.shape[0], -1) if offset is None \
            else offset[:, None].long() + j
        valid = None if length is None else j < length[:, None]
    _attention.paged_write(pool_k, pool_v, k, v, t, pos, valid)


# ---------------------------------------------------------------- recurrent
def conv(fn, x, w, state, length):
    """``fn(x, w, state, length) -> (y, new_state)`` (the causal conv over
    x (B,S,C) with its (B,K-1,C) carried context) on each rank's slots and
    channels, laid out as ``state``."""
    if not is_dtensor(state):
        return fn(x, w, state, length)
    mesh = state.device_mesh
    c = 2 if _dim_on(state, "model") == 2 else None
    act = _placements(mesh, data=_batch(state), model=c)
    return _on_shards(fn, mesh, (act, state.placements), _to(x, act),
                      _to(w, _placements(mesh, model=1 if c else None)),
                      state, _to(length, _placements(mesh,
                                                     data=_batch(state))))


def rglru_scan(fn, a, b, h0):
    """``fn(a, b, h0) -> (h, h_last)`` (the RG-LRU over a, b (B,S,W) from
    h0 (B,W)) on each rank's slots and width, laid out as ``h0``."""
    if not is_dtensor(h0):
        return fn(a, b, h0)
    mesh = h0.device_mesh
    act = _placements(mesh, data=_batch(h0),
                      model=2 if _dim_on(h0, "model") == 1 else None)
    return _on_shards(fn, mesh, (act, h0.placements), _to(a, act),
                      _to(b, act), h0)


def ssm_scan(fn, delta, x, b, c, a, d_skip, h0, length):
    """``fn(delta, x, b, c, a, d_skip, h0, length) -> (y, h_last)`` (the
    selective scan over delta, x (B,S,di) and b, c (B,S,N) from h0
    (B,di,N)) on each rank's slots and channels, laid out as ``h0``."""
    if not is_dtensor(h0):
        return fn(delta, x, b, c, a, d_skip, h0, length)
    mesh = h0.device_mesh
    ch = _dim_on(h0, "model") == 1
    bd = _batch(h0)
    act = _placements(mesh, data=bd, model=2 if ch else None)
    row = _placements(mesh, data=bd)
    wt = _placements(mesh, model=0 if ch else None)

    def dense(*ts):
        # the kernel reads dense arrays; a redistributed shard may be a view
        return fn(*(t if t is None else t.contiguous() for t in ts))

    return _on_shards(dense, mesh, (act, h0.placements), _to(delta, act),
                      _to(x, act), _to(b, row), _to(c, row), _to(a, wt),
                      _to(d_skip, wt), h0, _to(length, row))
