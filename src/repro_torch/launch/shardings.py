"""Sharding strategies — the Mensa clusters mapped to mesh layouts: the
port of ``repro.launch.shardings`` over ``torch.distributed`` DTensors,
for serving (``serve_state_specs``, the engine's parameters) and training
(``batch_specs``, ``state_specs``, a trained model's parameters, and
``abstract_with_sharding`` for the dry run).

Each parameter gets a spec from its Mensa strategy cluster:

* Pascal (compute-centric attn/FFN matmuls): Megatron column->row pairing —
  only one collective per block on the forward pass.
* Jacquard (huge-footprint, low-reuse): vocab/embedding tables and MoE expert
  banks sharded on `model` and never gathered; compute moves to the shard.
* Pavlov (recurrent): recurrence width (d_rnn / d_inner) sharded on `model`,
  sequence kept local so the time scan has no cross-device dependency;
  weights stay resident across the whole scan.

A spec is a plain tuple with one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension split
over those mesh axes, major first) — the reference's ``PartitionSpec``
entries.  ``to_placements`` turns one into DTensor placements.  The port's
layers are not stacked, so a spec has no stack axis: it is the reference's
with that leading ``None`` dropped.

A served model comes onto a mesh two ways.  ``build_distributed_model``
builds it shard by shard: the model is constructed on ``meta`` and every
rank draws each parameter whole from the seed, in ``Model.init``'s order,
and keeps only its part (``local_parts``, cut by the plain ``local_cut``),
so no rank ever holds the whole model — the route for a model no card
holds (phi3.5-moe and llama4-scout at full depth).  ``distribute_models``
scatters a model the caller already holds whole (rank 0's values).

Batch is sharded on (pod, data).  KV caches for decode shard the
*sequence* axis on ``model`` (context parallelism) in ``state_specs``:
``models/spmd.context_attention`` writes each rank's slots and combines
the ranks' partial softmaxes over ``model``.  ``abstract_states`` lays
meta stand-ins of those states out for the dry run, ``place_states``
real ones.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ..bridge import layout
from ..core.h100 import GIGA
from ..models.attention import KVCache, PagedKVCache
from ..models.model_config import ArchConfig
from ..models.spmd import is_dtensor
from ..models.transformer import BlockState, Model
from .mesh import data_axes

Spec = tuple


# ------------------------------------------------------------------ parameters
def _base_spec(names: list[str], rank: int, is_moe: bool,
               blockdiag_gates: bool = False,
               dense_2d: bool = False) -> tuple:
    """Spec entries for the *unstacked* rank of this parameter."""
    name = names[-1]
    in_moe = is_moe and "ffn" in names and "shared" not in names
    # --- Jacquard cluster: big tables / expert banks, sharded & stationary
    if name in ("embed", "lm_head"):
        return ("model", None)
    if in_moe and name in ("w_gate", "w_up"):
        # experts on `model` (EP) + d_ff on `data` (FSDP-style 2D sharding):
        # pure EP leaves the expert bank replicated across `data`
        return ("model", None, "data")
    if in_moe and name == "w_down":
        return ("model", "data", None)
    # --- Pascal cluster: Megatron column->row pairs.  For >20B-param archs
    # the second mesh axis also shards the non-contracted weight dim
    # (FSDP-style 2D) so replicated dense weights never exceed HBM.
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in"):
        return ("data" if dense_2d else None, "model")
    if name in ("wo", "w_down", "w_out", "out_proj", "x_proj"):
        return ("model", "data" if dense_2d else None)
    if name in ("bq", "bk", "bv", "b_in"):
        return ("model",)
    if name in ("b_out",):
        return (None,)
    # --- Pavlov cluster: recurrence width on `model`
    if name in ("w_x", "w_y", "in_proj", "dt_proj"):
        return (None, "model")
    if name in ("w_a", "w_i"):
        # dense (rank 2): row-parallel (psum).  block-diagonal (rank 3,
        # flagged): blocks on `model` -> fully local gate matmuls
        if blockdiag_gates:
            return ("model", None, None)
        return ("model", None)
    if name == "conv_w":
        return (None, "model")
    if name in ("lambda", "dt_bias", "d_skip"):
        return ("model",)
    if name == "a_log":
        return ("model", None)
    if name == "b":                        # lstm bias (4H,)
        return ("model",)
    if name == "w_h":
        return (None, "model")
    # --- small/replicated
    return (None,) * rank


# parameter-name families, used to route each leaf to the block kinds whose
# ExecutionPolicy governs it under strategy="auto" (plan-aware sharding)
_ATTN_PARAMS = frozenset(
    {"wq", "wk", "wv", "wo", "bq", "bk", "bv"})
_REC_PARAMS = frozenset(
    {"w_x", "w_y", "in_proj", "dt_proj", "w_a", "w_i", "conv_w", "lambda",
     "dt_bias", "d_skip", "a_log", "w_h", "b", "out_proj", "x_proj"})
_FAMILY_KINDS = {
    "attn": ("attn", "local", "dec", "enc"),
    "rec": ("rec", "ssm"),
    "ffn": ("ffn",),
}


def _family_of(names: list[str]) -> str | None:
    name = names[-1]
    if name in _ATTN_PARAMS:
        return "attn"
    if name in _REC_PARAMS:
        return "rec"
    if "ffn" in names or name in ("w_gate", "w_up", "w_down", "w_in",
                                  "w_out", "b_in", "b_out"):
        return "ffn"
    return None


def _plan_family_axes(plan) -> dict:
    """family -> preferred mesh axis from the plan's per-cluster policies
    (``ExecutionPolicy.sharding_axis``).  "model" wins when a family spans
    clusters that disagree; families the plan says nothing about map to
    None (the TP templates decide)."""
    out = {}
    for family, kinds in _FAMILY_KINDS.items():
        axes = []
        for k in kinds:
            pol = plan.policy_for(k)
            if pol is not None and pol.sharding_axis:
                axes.append(pol.sharding_axis)
        out[family] = ("model" if "model" in axes
                       else (axes[0] if axes else None))
    return out


def param_specs(cfg: ArchConfig, model: Model, strategy: str = "tp",
                plan=None) -> dict[str, Spec]:
    """One spec per parameter of ``model`` (by its ``named_parameters``
    name), from the reference's leaf name (``bridge.layout``) and the
    tensor's rank; ``cfg`` decides the MoE, block-diagonal and 2-D flags
    (it may be the full config of a reduced ``model``: a spec depends only
    on the leaf's name and rank and on those flags).

    strategy:
      "tp"   — the Mensa cluster templates (Pascal-TP / Jacquard / Pavlov).
      "dp"   — pascal_dp plan: every block parameter replicated; embeddings
               stay Jacquard vocab-sharded.
      "auto" — per-cluster, from ``plan`` (a
               ``serve.placement.PlacementPlan``): families whose policy
               prefers the "data" axis (memory-centric
               clusters — they scale by replication over slots) drop to
               replicated specs, families preferring "model" keep the TP
               templates.  Embeddings always stay Jacquard vocab-sharded.
               A plan with no policies (``fixed_plan``) degrades to "tp".
    """
    if strategy == "auto" and plan is None:
        raise ValueError('param_specs(strategy="auto") needs a PlacementPlan '
                         "(build the engine with a policy, or pass plan=...)")
    family_axes = _plan_family_axes(plan) if strategy == "auto" else {}
    is_moe = cfg.ffn_kind == "moe"
    blockdiag = getattr(cfg, "rglru_gate_blocks", 0) > 0
    dense_2d = cfg.param_count() > 20 * GIGA
    params = dict(model.named_parameters())

    def spec(names: list[str], rank: int) -> Spec:
        if names[-1] not in ("embed", "lm_head"):
            if strategy == "dp":
                return (None,) * rank
            if strategy == "auto":
                fam = _family_of(names)
                if fam is not None and family_axes.get(fam) == "data":
                    return (None,) * rank
        base = _base_spec(names, rank, is_moe, blockdiag, dense_2d)
        pad = rank - len(base)
        if pad < 0:       # scalar-ish leaf with generic base
            base = base[-rank:] if rank else ()
            pad = 0
        return (None,) * pad + tuple(base)

    return {leaf.name: spec([str(p) for p in leaf.path],
                            params[leaf.name].dim())
            for leaf in layout(model)}


def local_config(cfg: ArchConfig, mesh, strategy: str = "tp",
                 plan=None) -> ArchConfig:
    """``cfg`` at the widths one rank of ``mesh`` computes with: the heads,
    feed-forward width and recurrence width each divided by the ``model``
    axis where ``strategy`` (``param_specs``'s) splits that family's
    weights over it and the width splits evenly.  The program registry
    counts a mesh engine's work at it (``obs/programs.py``)."""
    mp = mesh_sizes(mesh).get("model", 1)
    if mp == 1 or strategy == "dp":
        return cfg
    family_axes = _plan_family_axes(plan) if strategy == "auto" else {}

    def split(family: str, *widths: int) -> bool:
        return family_axes.get(family) != "data" \
            and all(w and w % mp == 0 for w in widths)

    kw = {}
    if cfg.num_heads and split("attn", cfg.num_heads, cfg.num_kv_heads):
        kw.update(num_heads=cfg.num_heads // mp,
                  num_kv_heads=cfg.num_kv_heads // mp)
    if cfg.ffn_kind in ("glu", "mlp") and split("ffn", cfg.d_ff):
        kw["d_ff"] = cfg.d_ff // mp
    for name in ("d_rnn", "d_inner"):
        width = getattr(cfg, name)
        if width and split("rec", width):
            kw[name] = width // mp
    return cfg.replace(**kw) if kw else cfg


# ----------------------------------------------------------------- serve state
def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or of anything with a
    ``shape`` mapping, as the reference's meshes have)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def data_shards(mesh) -> int:
    """How many ways the data axes split a batch."""
    sizes = mesh_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def batch_axis(mesh, batch: int):
    """The spec entry of a batch (slot) axis of ``batch`` rows: the data
    axes when they split it evenly, else replicated (None)."""
    nd = data_shards(mesh)
    return data_axes(mesh) if batch % nd == 0 and batch >= nd else None


# ----------------------------------------------------------------- batch/state
def batch_specs(cfg: ArchConfig, mesh, global_batch: int,
                strategy: str = "tp") -> dict[str, Spec]:
    """Specs for the training batch dict: rows on the data axes ("dp": on
    every mesh axis) when they split the batch evenly, else replicated."""
    d = data_axes(mesh)
    if strategy == "dp":
        d = d + ("model",)                  # batch over every mesh axis
    sizes = mesh_sizes(mesh)
    nd = 1
    for a in d:
        nd *= sizes[a]
    bspec = d if global_batch % nd == 0 and global_batch >= nd else None
    out = {"tokens": (bspec, None), "labels": (bspec, None)}
    if cfg.modality_tokens:
        out["modality"] = (bspec, None, None)
    if cfg.is_encdec:
        out["src_embeds"] = (bspec, None, None)
    return out


def state_specs(model: Model, mesh, batch: int,
                max_len: int) -> list[BlockState]:
    """Specs mirroring ``Model.init_states`` (dense caches), one
    ``BlockState`` a layer: KV caches (an ``attn`` or ``dec`` layer's, a
    window's ring) shard their sequence on ``model`` (context parallelism)
    and their batch on data; recurrent states shard their width on
    ``model``, evenly or not (DTensor's chunks)."""
    b = batch_axis(mesh, batch)

    def one(kind: str) -> BlockState:
        if kind in ("attn", "dec", "local"):
            cache = (b, "model", None, None)
            return BlockState(kv=KVCache(k=cache, v=cache, length=(b,)))
        if kind in ("rec", "ssm"):
            return BlockState(rec={
                "conv": (b, None, "model"),
                "h": (b, "model", None) if kind == "ssm" else (b, "model")})
        raise ValueError(kind)

    return [one(kind) for kind in model.kinds]


def serve_state_specs(model: Model, mesh, slots: int, max_len: int, *,
                      kv_block_size: int | None = None,
                      kv_blocks: int | None = None) -> list[BlockState]:
    """Specs mirroring ``Model.init_states`` for the SERVING path: one
    ``BlockState`` of specs a layer.

    The slot (batch) axis goes on the data axes — per-slot decode math
    then never crosses a shard, which keeps a pure-dp mesh's tokens the
    single-device engine's — and per-head / recurrence-width axes go on
    ``model`` only when they divide the axis size.  A paged KV pool has no
    batch axis; its BLOCK axis is sharded over the data axes instead (each
    shard owns a contiguous stripe of physical blocks — the layout
    serve/kvpool.py's per-shard accounting mirrors), falling back to
    replicated when ``kv_blocks`` does not divide evenly."""
    cfg = model.cfg
    nd = data_shards(mesh)
    mp = mesh_sizes(mesh).get("model", 1)
    b = batch_axis(mesh, slots)
    d = data_axes(mesh)
    if kv_block_size is not None and kv_blocks is None:
        kv_blocks = slots * (-(-max_len // kv_block_size))
    blk = d if kv_blocks is not None and kv_blocks % nd == 0 \
        and kv_blocks >= nd else None

    def wax(n: int):
        """`model` for a width/head axis only when it splits evenly."""
        return "model" if mp > 1 and n and n % mp == 0 else None

    def one(kind: str) -> BlockState:
        if kind == "attn" and kv_block_size is not None:
            pool = (blk, None, wax(cfg.num_kv_heads), None)
            return BlockState(kv=PagedKVCache(k=pool, v=pool, length=(b,)))
        if kind in ("attn", "local"):
            cache = (b, None, wax(cfg.num_kv_heads), None)
            return BlockState(kv=KVCache(k=cache, v=cache, length=(b,)))
        if kind == "rec":
            return BlockState(rec={"conv": (b, None, wax(cfg.d_rnn)),
                                   "h": (b, wax(cfg.d_rnn))})
        if kind == "ssm":
            return BlockState(rec={"conv": (b, None, wax(cfg.d_inner)),
                                   "h": (b, wax(cfg.d_inner), None)})
        raise ValueError(kind)

    return [one(kind) for kind in model.kinds]


# ------------------------------------------------------------------ DTensors
def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dim that entry ``i`` names, ``Replicate()`` on the rest — and on a mesh
    dim of size 1, which splits nothing (DTensor's view rules would treat
    a split length-1 axis as one to redistribute)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for m, name in enumerate(mesh.mesh_dim_names):
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names mesh axis {name!r} twice")
        out.append(Shard(dims[0]) if dims and mesh.size(m) > 1
                   else Replicate())
    return tuple(out)


def local_part(tensor: torch.Tensor, mesh, placements):
    """``tensor`` as a DTensor of ``placements`` when every rank holds the
    same whole ``tensor`` (zeros, a host input): each rank keeps its own
    chunk, contiguous (a kernel reads it as a dense array), with no
    collective.  An axis that does not split evenly is cut as DTensor
    chunks it (the last ranks hold fewer, or none)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        tuple(tensor.shape), mesh, placements)
    local = tensor
    for dim, (n, lo) in enumerate(zip(shape, offset)):
        if n != tensor.shape[dim]:
            local = local.narrow(dim, lo, n)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=tensor.shape,
                              stride=tensor.stride())


def place_states(states: list[BlockState], specs: list[BlockState],
                 mesh) -> list[BlockState]:
    """``states`` (each rank's whole copy) as DTensors of ``specs``."""
    def place(t, s):
        return local_part(t, mesh, to_placements(s, mesh))

    out = []
    for st, sp in zip(states, specs):
        if st.kv is not None:
            out.append(BlockState(kv=type(st.kv)(
                *(place(t, s) for t, s in zip(st.kv, sp.kv)))))
        else:
            out.append(BlockState(rec={k: place(a, sp.rec[k])
                                       for k, a in st.rec.items()}))
    return out


def abstract_states(model: Model, mesh, batch: int,
                    max_len: int) -> list[BlockState]:
    """Meta DTensor states of ``model`` (built on ``meta``) for ``batch``
    slots of ``max_len`` tokens, laid out by ``state_specs``: the dry
    run's counterpart of ``place_states`` (the reference's
    ``abstract_with_sharding`` of ``init_states``' shapes).  Nothing is
    allocated."""
    shapes = model.init_states(batch, max_len)
    specs = state_specs(model, mesh, batch, max_len)

    def one(t, s):
        return _abstract(t.shape, t.dtype, mesh, to_placements(s, mesh))

    return [BlockState(kv=type(st.kv)(*map(one, st.kv, sp.kv)))
            if st.kv is not None else
            BlockState(rec={k: one(a, sp.rec[k]) for k, a in st.rec.items()})
            for st, sp in zip(shapes, specs)]


def distribute_models(models: list[Model], mesh, strategy: str = "tp",
                      plan=None, layout_cfg=None) -> list[Model]:
    """Copies of ``models`` (a model and its phase models, which share its
    parameter tensors) whose parameters are DTensors on ``mesh``, laid out
    by ``param_specs(layout_cfg or models[0].cfg, ..., strategy, plan)``
    (``distribute_tensor``: rank 0's values, scattered), each requiring
    its gradient as the original does (a model built with ``train=True``
    trains on the mesh).  The copies share the distributed parameters as
    the originals share theirs; the originals stay plain tensors (a
    replicated parameter's DTensor holds the original's storage: no copy
    on one card)."""
    from torch.distributed.tensor import distribute_tensor
    base = models[0]
    specs = param_specs(layout_cfg or base.cfg, base, strategy, plan)
    return _swap_parameters(models, lambda name, p: distribute_tensor(
        p.detach(), mesh, to_placements(specs[name], mesh)))


def local_cut(whole: torch.Tensor, placements, sizes, coords):
    """The part of ``whole`` that the rank at mesh coordinates ``coords``
    holds under ``placements`` on a mesh of dims ``sizes`` (one entry a
    mesh dim each): on each mesh dim that shards tensor dim ``d``, in mesh
    order, DTensor's chunk of the part so far — ``ceil(n / size)`` rows a
    rank, the last ranks fewer or none.  A view of ``whole``; a plain
    function of its arguments, so it needs no process group."""
    from torch.distributed.tensor import Shard
    part = whole
    for pl, size, at in zip(placements, sizes, coords):
        if isinstance(pl, Shard) and size > 1:
            n = part.shape[pl.dim]
            step = -(-n // size)
            lo = min(at * step, n)
            part = part.narrow(pl.dim, lo, min(n, lo + step) - lo)
    return part


def local_parts(model: Model, seed: int, placements: dict, sizes, coords,
                device) -> dict[str, torch.Tensor]:
    """Each parameter of ``model`` (name -> its local part, in the
    parameter's dtype, dense and of its own storage) as the rank at mesh
    coordinates ``coords`` holds it under ``placements`` (name -> DTensor
    placements) on a mesh of dims ``sizes``: ``model.init`` draws every
    parameter whole in float32 on ``device`` from a generator seeded with
    ``seed`` — the stream ``build_model(cfg, device, seed)`` draws — and
    each draw is cut at once (``local_cut``), so a part equals the matching
    slice of ``build_model``'s tensor bit for bit and the peak is the parts
    plus one whole draw.  ``model`` may be on ``meta``."""
    names = {id(p): name for name, p in model.named_parameters()}
    parts: dict[str, torch.Tensor] = {}

    def keep(p: torch.Tensor, value: torch.Tensor) -> None:
        name = names[id(p)]
        if name in parts:
            raise RuntimeError(f"init drew {name} twice")
        cut = local_cut(value, placements[name], sizes, coords)
        parts[name] = torch.empty(cut.shape, dtype=p.dtype,
                                  device=value.device).copy_(cut)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model.init(gen, sink=keep)
    missing = sorted(set(names.values()) - set(parts))
    if missing:
        raise RuntimeError(f"init drew no value for {missing}")
    return parts


def build_distributed_model(cfg: ArchConfig, mesh, seed: int,
                            strategy: str = "tp", plan=None,
                            layout_cfg=None) -> Model:
    """A model of ``cfg`` with random weights from ``seed`` whose
    parameters are DTensors on ``mesh``, laid out by ``param_specs(
    layout_cfg or cfg, ..., strategy, plan)`` (``layout_cfg``: the full
    config of a cut ``cfg``), built shard by shard: the model is constructed
    on ``meta``, and each rank draws every parameter whole on its own
    device and keeps its part (``local_parts``); every rank draws the same
    stream, so nothing is scattered and no rank holds the whole model.
    Its values are ``build_model(cfg, device, seed)``'s bit for bit, so it
    serves that model's tokens; ``ServeEngine(mesh=mesh)`` takes it as it
    is.  A phase model over it is ``Model.with_config``."""
    from torch.distributed.tensor import DTensor
    model = Model(cfg, "meta")
    specs = param_specs(layout_cfg or cfg, model, strategy, plan)
    placements = {name: to_placements(spec, mesh)
                  for name, spec in specs.items()}
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    parts = local_parts(model, seed, placements, tuple(mesh.shape),
                        mesh.get_coordinate(), device)
    built = _swap_parameters([model], lambda name, p: DTensor.from_local(
        parts.pop(name), mesh, placements[name], run_check=False,
        shape=p.shape, stride=p.stride()))[0]
    built.device = device
    return built


def laid_out(model: Model, mesh, strategy: str = "tp", plan=None,
             layout_cfg=None) -> bool:
    """Whether ``model``'s parameters are already DTensors on ``mesh``
    laid out by ``param_specs(layout_cfg or model.cfg, ..., strategy,
    plan)`` (a ``build_distributed_model``): True if every one is, False
    if none is a DTensor (a model to distribute); any other layout
    raises."""
    specs = param_specs(layout_cfg or model.cfg, model, strategy, plan)
    params = dict(model.named_parameters())
    if not any(is_dtensor(p) for p in params.values()):
        return False
    for name, p in params.items():
        want = to_placements(specs[name], mesh)
        if not is_dtensor(p) or p.device_mesh != mesh \
                or tuple(p.placements) != want:
            raise ValueError(
                f"parameter {name} is laid out as "
                f"{getattr(p, 'placements', 'a plain tensor')}, not as "
                f"{strategy!r} lays it out on this mesh ({want}): pass the "
                f"model whole, or build it with build_distributed_model on "
                f"this mesh with the engine's strategy")
    return True


def _swap_parameters(models: list[Model], make) -> list[Model]:
    """Copies of ``models`` whose every parameter ``p`` (named as in
    ``models[0]``) is ``make(name, p)``, shared across the copies."""
    memo = {}
    for name, p in models[0].named_parameters():
        memo[id(p)] = nn.Parameter(make(name, p),
                                   requires_grad=p.requires_grad)
    return [copy.deepcopy(m, memo) for m in models]


def abstract_with_sharding(shapes: dict, specs: dict, mesh) -> dict:
    """Meta DTensors of ``shapes`` (name -> a tensor whose shape and dtype
    it takes; on any device) laid out by ``specs`` (name -> spec): each
    rank's local shard a ``meta`` tensor, so nothing is allocated — the
    dry run's stand-ins for parameters and inputs (the reference's
    ``ShapeDtypeStruct``s with a sharding)."""
    return {k: _abstract(t.shape, t.dtype, mesh,
                         to_placements(specs[k], mesh))
            for k, t in shapes.items()}


def _abstract(shape, dtype, mesh, placements):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                     placements)
    whole = torch.empty(tuple(shape), dtype=dtype, device="meta")
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def abstract_model(model: Model, mesh, strategy: str = "tp") -> Model:
    """A copy of ``model`` (built on ``meta``) whose parameters are meta
    DTensors laid out by ``param_specs(model.cfg, model, strategy)``."""
    specs = param_specs(model.cfg, model, strategy)
    return _swap_parameters([model], lambda name, p: _abstract(
        p.shape, p.dtype, mesh, to_placements(specs[name], mesh)))[0]
