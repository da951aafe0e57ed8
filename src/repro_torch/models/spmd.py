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

A model trained on a mesh (``train/trainer.make_train_step`` over DTensor
parameters and a batch laid out by ``launch.shardings.batch_specs``) runs
under autograd through the same boundaries, which carry the gradient
(``local_map`` converts with ``to_local``/``from_local``, both
differentiable), and these:

  * ``self_attention``: a whole-sequence attention with no cache (train,
    the encoder, a decoder's cross-attention) on each rank's rows and
    heads, and ``merge_heads`` after it;
  * ``linear_scan``: the chunked scan of the recurrences' differentiable
    route on each rank's rows and width;
  * ``moe_shards``: a routed feed-forward on each rank's rows and
    experts, with the meshless queue positions;
  * ``cross_entropy``: the loss over vocab-sharded logits, each ``model``
    rank's max and sum of exponentials combined over the ``model`` group
    and the gold logit taken from the shard that holds it, so the logits
    are never gathered whole.

A weight whole on the data axes meets each rank's own rows in a
``local_map``: its gradient there is that rank's share, declared
``Partial`` (``_on_shards(grads=...)``).  ``microbatches`` cuts a
batch's microbatches from its whole rows, as the meshless step does, and
``whole`` reads a value as a plain tensor.  A production mesh's ``pod``
axis carries rows as ``data`` does: every helper splits rows over both.

Without a DTensor argument every helper calls its function as it is: the
meshless path runs the same operations as before.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from . import attention as _attention


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


#: the mesh axes that carry rows (a production mesh's ``pod`` too)
ROW_AXES = ("pod", "data")


def _placements(mesh, data: int | None = None,
                model: int | None = None) -> tuple:
    """Placements on ``mesh``: ``Shard(data)`` on its data axes and
    ``Shard(model)`` on its model axis where given, ``Replicate()``
    elsewhere."""
    want = {"model": model, **{a: data for a in ROW_AXES}}
    return tuple(Replicate() if want.get(name) is None else Shard(want[name])
                 for name in mesh.mesh_dim_names)


def _size(mesh, axis: str) -> int:
    """How many ranks ``mesh``'s ``axis`` spans."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _whole_placements(mesh) -> tuple:
    return (Replicate(),) * mesh.ndim


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


def _on_shards(fn, mesh, out_placements, *args, grads=None):
    """``local_map`` of ``fn`` over ``args``; ``out_placements``: one
    output's placements, or a tuple of them, one per output.  ``grads``:
    the placements of each DTensor argument's gradient (None: its own) —
    a weight whole on a data axis whose rows are split there gets a
    partial sum from each rank."""
    if isinstance(out_placements[0], Placement):
        out_placements = list(out_placements)     # a single output
    if grads is not None:
        grads = tuple(g if g is not None or not is_dtensor(a)
                      else a.placements for g, a in zip(grads, args))
    return local_map(fn, out_placements=out_placements,
                     in_grad_placements=grads, device_mesh=mesh)(*args)


def _summed_over_rows(placements: tuple, mesh, rows: int | None) -> tuple:
    """``placements`` of a weight with ``Partial()`` on the row axes where
    the rows it meets are split (``rows`` not None): its gradient's."""
    return tuple(Partial() if rows is not None and name in ROW_AXES else p
                 for name, p in zip(mesh.mesh_dim_names, placements))


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


def whole(t):
    """``t`` as a plain tensor holding its whole value: gathered (or
    reduced) from the ranks where it is a DTensor."""
    return t.full_tensor() if is_dtensor(t) else t


def microbatches(t: torch.Tensor, accum: int) -> list:
    """The ``accum`` microbatches of the batch-major ``t``: rows ``[a * mb,
    (a + 1) * mb)``, as the reference cuts them.  On a mesh the batch (its
    token ids, labels and masks: a few bytes a row) is gathered whole once
    and each microbatch laid out as ``t`` is, each rank keeping its share
    of it: a microbatch holds the meshless microbatch's rows, on which an
    MoE layer's capacity and load balance and a masked loss's mean
    depend."""
    mb = t.shape[0] // accum
    if not is_dtensor(t):
        return [t[a * mb:(a + 1) * mb] for a in range(accum)]
    if accum == 1:
        return [t]
    if t.to_local().shape[0] % accum:
        raise ValueError(f"a microbatch's {mb} rows do not split as the "
                         f"batch's {t.shape[0]} do")
    rows = t.full_tensor()
    return [distribute_tensor(rows[a * mb:(a + 1) * mb], t.device_mesh,
                              t.placements, src_data_rank=None)
            for a in range(accum)]


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,hd) as (B,S,H*hd).  Heads whole on ``model`` are merged on
    each rank's rows: left to DTensor's view rule, the merge's backward
    would split a gradient sharded over ``model`` back into heads that do
    not divide the axis."""
    b, s, h, hd = x.shape
    if not is_dtensor(x) or _dim_on(x, "model") == 2:
        return x.reshape(b, s, h * hd)
    return _on_shards(lambda t: t.reshape(t.shape[0], s, h * hd),
                      x.device_mesh, x.placements, x)


def embedding(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """Rows ``tokens`` (B,S) of ``table`` (V,D), split by vocab over
    ``model`` or whole: each rank looks its rows' tokens up in its own
    shard, zero where another shard holds the token, and the rows are
    summed over ``model`` (one term is not zero, so the sum is the row
    bit for bit).  Returns (B,S,D), rows on ``data`` as ``tokens``'s,
    whole on ``model``.  (DTensor's own embedding rule leaves a
    ``MaskPartial`` whose gradient some torch releases cannot add to the
    tied unembedding's ``Partial`` one.)"""
    mesh = table.device_mesh
    rb = _batch(tokens) if is_dtensor(tokens) else None
    row = _placements(mesh, data=rb)
    split = _dim_on(table, "model") == 0
    tpl = _placements(mesh, model=0 if split else None)
    mp = _size(mesh, "model") if split else 1
    width = -(-table.shape[0] // mp)       # DTensor's chunk of the vocab

    def local(t, tok):
        lo = mesh.get_local_rank("model") * width if split else 0
        idx = tok.long() - lo
        here = (idx >= 0) & (idx < t.shape[0])
        rows = t[idx.clamp(0, t.shape[0] - 1)]
        return torch.where(here[..., None], rows, torch.zeros_like(rows))

    out = tuple(Partial() if split and name == "model" else p
                for name, p in zip(mesh.mesh_dim_names, row))
    return _to(_on_shards(local, mesh, out, _to(table, tpl),
                          _to(tokens, row),
                          grads=(_summed_over_rows(tpl, mesh, rb), None)),
               row)


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
def self_attention(fn, q, k, v):
    """``fn(q, k, v) -> out`` (B,Sq,H,hd) — a whole-sequence attention with
    no cache: a train step's, the encoder's, a cross-attention — on each
    rank's rows and heads.  Where q's heads are split over ``model`` and
    K/V's are whole there (their KVH heads do not split), each rank takes
    the K/V heads its own q heads read, when its q heads and the GQA
    groups nest (one holds a whole number of the other); otherwise q is
    gathered whole too, and every ``model`` rank computes every head."""
    if not is_dtensor(q):
        return fn(q, k, v)
    mesh = q.device_mesh
    rb = _batch(q)
    if _dim_on(q, "model") == 2 and _dim_on(k, "model") == 2:
        act = _placements(mesh, data=rb, model=2)
        return _on_shards(fn, mesh, act, _to(q, act), _to(k, act),
                          _to(v, act))
    row = _placements(mesh, data=rb)
    h, g = q.shape[2], q.shape[2] // k.shape[2]
    mp = _size(mesh, "model") if "model" in mesh.mesh_dim_names else 1
    hl = h // mp
    if _dim_on(q, "model") != 2 or h % mp or (hl % g and g % hl):
        return _on_shards(fn, mesh, row, _to(q, row), _to(k, row),
                          _to(v, row))

    def local(q, k, v):
        lo = mesh.get_local_rank("model") * hl
        k0, k1 = lo // g, (lo + hl - 1) // g + 1
        return fn(q, k[:, :, k0:k1].contiguous(), v[:, :, k0:k1].contiguous())

    act = _placements(mesh, data=rb, model=2)
    used = tuple(Partial() if name == "model" else p
                 for name, p in zip(mesh.mesh_dim_names, row))
    return _on_shards(local, mesh, act, _to(q, act), _to(k, row),
                      _to(v, row), grads=(None, used, used))


def attention(attend, mode: str, q, k, v, kv, length, offset, table, *,
              prompt=None, window: int = 0):
    """``attend(q, k, v, kv, length, offset, table) -> (out, kv)`` — one
    layer's cache op and attention — on each rank's slots and heads, laid
    out as the layer's cache ``kv`` is.  ``mode`` ("decode", or "prefill"
    with or without ``offset``) says which positions a paged write
    covers.  A dense cache whose sequence is split over ``model``
    (``launch.shardings.state_specs``) takes ``context_attention``:
    ``prompt(q, k, v) -> out`` is then the layer's whole-prompt attention
    and ``window`` its ring's window (0: a full cache)."""
    if not is_dtensor(kv.k):
        return attend(q, k, v, kv, length, offset, table)
    if _dim_on(kv.k, "model") == 1:
        if table is not None or offset is not None:
            raise NotImplementedError(
                "a KV cache split along its sequence (state_specs) takes "
                "one-shot prefill and decode only: no chunked prefill "
                "(offset) and no paged pool, which the JAX package's "
                "state_specs does not lay out either")
        return context_attention(prompt, mode, q, k, v, kv, length,
                                 window=window)
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


def context_attention(prompt, mode: str, q, k, v, kv, length, *,
                      window: int = 0):
    """A layer's cache op and attention on a dense cache (B, S_max, KVH,
    hd) whose slots are split over ``model`` (context parallelism; the
    batch on the data axes or whole), each rank holding the slots
    ``[start, start + L)`` of DTensor's own chunking (the last rank may
    hold fewer, or none).

      * prefill: ``prompt(q, k, v)`` attends over the whole prompt as a
        cacheless layer does (``self_attention``: each rank's rows and q
        heads); K/V are gathered whole over ``model`` and each rank copies
        the positions its slots hold (``attention.shard_fill``: left-
        aligned, or the window's ring).  An all-to-all of each rank's
        slots would move less.
      * decode: q and the new K/V are gathered whole over ``model`` (one
        token a row); the rank that holds row b's slot writes it
        (``attention.shard_decode_write``); every rank takes the partial
        softmax of all q heads over its slots (``attention.decode_partial``)
        and the partials are combined over the ``model`` group: ``M = max
        m`` (a MAX all-reduce), then one SUM all-reduce of ``l·exp(m-M)``
        and ``acc·exp(m-M)``; ``out = acc / max(l, 1e-30)`` in q's dtype,
        laid out as q is.  A row whose 0/1 ``length`` is 0 writes nowhere
        and keeps its length.

    Returns (out, kv), the caches' shards written in place."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = kv.k.device_mesh
    row = _placements(mesh, data=_batch(kv.length))
    start = compute_local_shape_and_global_offset(
        tuple(kv.k.shape), mesh, kv.k.placements)[1][1]
    smax = kv.k.shape[1]
    if mode == "prefill":
        out = prompt(q, k, v)

        def fill(k, v, ck, cv, cl, length):
            return _attention.shard_fill(ck, cv, k, v, cl, start=start,
                                         smax=smax, window=window,
                                         length=length)

        new_len = _on_shards(fill, mesh, row, _to(k, row), _to(v, row),
                             kv.k, kv.v, kv.length, _to(length, row))
        return out, type(kv)(kv.k, kv.v, new_len)
    grp = mesh.get_group("model")

    def decode(q, k, v, ck, cv, cl, length):
        wm = None if length is None else length > 0
        _attention.shard_decode_write(ck, cv, k, v, cl, start=start,
                                      smax=smax, window=window,
                                      write_mask=wm)
        m, l, acc = _attention.decode_partial(q, ck, cv, cl, start=start,
                                              window=window)
        top = m.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=grp)
        w = torch.exp(m - top)
        sums = torch.cat([acc * w[..., None], (l * w)[..., None]], dim=-1)
        dist.all_reduce(sums, group=grp)
        out = sums[..., :-1] / torch.clamp_min(sums[..., -1:], 1e-30)
        inc = 1 if wm is None else wm.to(torch.int32)
        return out[:, None].to(q.dtype), (cl + inc).to(torch.int32)

    out, new_len = _on_shards(decode, mesh, (row, row), _to(q, row),
                              _to(k, row), _to(v, row), kv.k, kv.v,
                              kv.length, _to(length, row))
    return _to(out, q.placements), type(kv)(kv.k, kv.v, new_len)


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
    channels, laid out as ``state`` — or as ``x`` without one (train)."""
    like = x if state is None else state
    if not is_dtensor(like):
        return fn(x, w, state, length)
    mesh = like.device_mesh
    c = 2 if _dim_on(like, "model") == 2 else None
    act = _placements(mesh, data=_batch(like), model=c)
    wpl = _placements(mesh, model=1 if c else None)
    return _on_shards(fn, mesh,
                      (act, act if state is None else state.placements),
                      _to(x, act), _to(w, wpl), state,
                      _to(length, _placements(mesh, data=_batch(like))),
                      grads=(None, _summed_over_rows(wpl, mesh, _batch(like)),
                             None, None))


def linear_scan(fn, a, b, h0, chunk: int):
    """``fn(a, b, h0, chunk) -> (h, h_last)`` — the chunked scan
    ``h_t = a_t * h_{t-1} + b_t`` along axis 1, the recurrences'
    differentiable route — from ``h0`` (zeros when None), on each rank's
    rows and width: a, b (B,S,W,...) with their rows on ``data`` as ``a``'s
    are and their width (axis 2) on ``model`` where it splits evenly, the
    time axis whole (DTensor may have left a reduced product split along
    it)."""
    def run(a, b, h0):
        if h0 is None:
            h0 = torch.zeros_like(a[:, 0])
        return fn(a, b, h0, chunk)

    if not is_dtensor(a):
        return run(a, b, h0)
    mesh = a.device_mesh
    mp = _size(mesh, "model")
    pl = _placements(mesh, data=_batch(a),
                     model=2 if a.shape[2] % mp == 0 else None)
    state = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                  else p for p in pl)
    return _on_shards(run, mesh, (pl, state), _to(a, pl), _to(b, pl),
                      _to(h0, state))


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


# ------------------------------------------------------------------- loss
def cross_entropy(fn, reduce, logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None, vocab: int) -> torch.Tensor:
    """The mean token cross-entropy of ``logits`` (..., V_padded) float32
    over their first ``vocab`` columns: ``fn(logits[..., :vocab], labels,
    mask)``.  On a mesh the logits stay where they are — rows on
    ``data``, the vocab on ``model`` when the table is split there: each
    rank takes the max of its valid columns, the maxima are combined over
    the ``model`` group (MAX, outside the gradient: it only steadies the
    exponentials), each rank sums its ``exp(x - max)`` and picks the gold
    logit where it holds the label's column, and both are summed over the
    ``model`` group; ``reduce(nll, mask)`` then averages the rows'
    ``max + log(sum) - gold``.  Returns a replicated 0-d DTensor."""
    if not is_dtensor(logits):
        return fn(logits[..., :vocab], labels, mask)
    mesh = logits.device_mesh
    last = logits.dim() - 1
    split = _dim_on(logits, "model") == last
    row = _placements(mesh, data=_batch(logits))
    logits = _to(logits, _placements(mesh, data=_batch(logits),
                                     model=last if split else None))
    mp = _size(mesh, "model") if split else 1
    width = -(-logits.shape[-1] // mp)     # DTensor's chunk of the vocab

    def combined(op: str) -> tuple:
        return tuple(Partial(op) if split and name == "model" else p
                     for name, p in zip(mesh.mesh_dim_names, row))

    def columns(x: torch.Tensor):
        lo = mesh.get_local_rank("model") * width if split else 0
        return lo, lo + torch.arange(x.shape[-1], device=x.device)

    def local_max(x):
        _, cols = columns(x)
        return torch.where(cols < vocab, x, float("-inf")).amax(dim=-1)

    def local_terms(x, m, lab):
        lo, cols = columns(x)
        e = torch.where(cols < vocab, torch.exp(x - m[..., None]),
                        0.0).sum(dim=-1)
        idx = lab.long() - lo
        here = (idx >= 0) & (idx < x.shape[-1])
        gold = torch.gather(x, -1, idx.clamp(0, x.shape[-1] - 1)[..., None])
        return e, torch.where(here, gold[..., 0], 0.0)

    m = _to(_on_shards(local_max, mesh, combined("max"), logits.detach()),
            row)
    e, gold = _on_shards(local_terms, mesh, (combined("sum"),
                                             combined("sum")),
                         logits, m, _to(labels, row))
    nll = m + torch.log(_to(e, row)) - _to(gold, row)
    loss = reduce(nll, None if mask is None else _to(mask, row))
    return _to(loss, _whole_placements(mesh))


# -------------------------------------------------------------------- MoE
def row_shards(t: DTensor) -> int:
    """How many ways ``t``'s rows (axis 0) are split over the data axes."""
    if _batch(t) is None:
        return 1
    mesh = t.device_mesh
    n = 1
    for i, name in enumerate(mesh.mesh_dim_names):
        n *= mesh.size(i) if name in ROW_AXES else 1
    return n


def moe_shards(decide, experts, terms, xt, probs, wg, wu, wd):
    """A routed feed-forward over DTensor tokens ``xt`` (N,D) with router
    probabilities ``probs`` (N,E) and expert banks (E,D,F), (E,D,F),
    (E,F,D) split by expert over ``model`` (``models/moe._moe_on_mesh``),
    on each rank's rows and experts:

      * ``decide(p, offset) -> (gate_vals, gate_idx, pos, keep)`` on each
        rank's rows, ``offset(counts)`` the counts (E,) of the row ranks
        before this one, summed (all-gathers over the data axes);
      * ``experts(xt, gate_vals, gate_idx, pos, keep, wg, wu, wd, lo)``:
        this rank's experts ``[lo, lo + E_l)`` on its rows, the banks
        gathered whole over the data axes; the ``model`` ranks' partial
        outputs summed;
      * ``terms(p, gate_idx, keep)``: per-rank means, averaged over the
        data axes (each divided by the row shards and summed: a
        ``Partial("avg")`` output of ``local_map`` would take the whole
        gradient back on every rank).

    Returns (y (N,D) rows on data, the averaged ``terms``)."""
    mesh = xt.device_mesh
    rb = _batch(xt)
    row = _placements(mesh, data=rb)
    xt, probs = _to(xt, row), _to(probs, row)
    split = _dim_on(wg, "model") == 0
    wpl = _placements(mesh, model=0 if split else None)
    banks = [_to(w, wpl) for w in (wg, wu, wd)]
    groups = [(mesh.get_group(name), mesh.get_local_rank(name), mesh.size(i))
              for i, name in enumerate(mesh.mesh_dim_names)
              if rb is not None and name in ROW_AXES and mesh.size(i) > 1]

    def offset(counts: torch.Tensor) -> torch.Tensor:
        total, before = counts, torch.zeros_like(counts)
        for grp, me, n in reversed(groups):        # minor axis first
            seen = total.new_empty((n * total.numel(),))
            dist.all_gather_into_tensor(seen, total.contiguous(), group=grp)
            seen = seen.view((n,) + tuple(total.shape))
            before = before + seen[:me].sum(dim=0)
            total = seen.sum(dim=0)
        return before

    gate_vals, gate_idx, pos, keep = _on_shards(
        lambda p: decide(p, offset), mesh, (row,) * 4, probs)
    over_model = tuple(Partial() if split and name == "model" else p
                       for name, p in zip(mesh.mesh_dim_names, row))
    e_l = wg.shape[0] // (_size(mesh, "model") if split else 1)

    def local(x, gv, gi, ps, kp, a, b, c):
        lo = mesh.get_local_rank("model") * e_l if split else 0
        return experts(x, gv, gi, ps, kp, a, b, c, lo)

    bank_grad = _summed_over_rows(wpl, mesh, rb)
    y = _on_shards(local, mesh, over_model, xt, gate_vals, gate_idx, pos,
                   keep, *banks,
                   grads=(over_model, over_model, None, None, None,
                          bank_grad, bank_grad, bank_grad))
    mean = tuple(Partial() if rb is not None and name in ROW_AXES
                 else Replicate() for name in mesh.mesh_dim_names)
    n_rows = row_shards(xt)
    shares = _on_shards(lambda *a: tuple(t / n_rows for t in terms(*a)),
                        mesh, (mean,) * 3, probs, gate_idx, keep)
    return _to(y, row), tuple(_to(t, _whole_placements(mesh))
                              for t in shares)
