"""The dry run: one whole train step, prefill or decode step of every arch
at production scale on a fake process group of 256 or 512 ranks, with no
card and no memory — the port of ``repro.launch.dryrun``.

The reference lowers and compiles each (arch x shape x mesh) cell with
``ShapeDtypeStruct`` inputs on 512 forced host devices and reads XLA's
memory, cost and collective analyses.  The port has no compiler to ask, so
it runs the cell's step: the parameters, optimizer moments, serving states
and inputs are ``meta`` DTensors (shapes, no storage) laid out by
``launch/shardings.py`` on a production mesh
(``launch.mesh.make_production_mesh``) over a fake group, whose
collectives return at once and move nothing.  One call runs under
``StepCounter``: ``CommDebugMode``'s count of the collectives DTensor and
the model emit, by kind, with their wire bytes, and ``FlopCounterMode``'s
FLOPs of the operations one rank runs on its own shards.  A record keeps
the reference's keys where the port can fill them, ``trace_s`` in place of
``lower_s``/``compile_s``.

Every cell runs, as the reference's: ``train_4k`` a train step
(``make_train_step``), ``prefill_32k`` a one-shot prefill, ``decode_32k``
and ``long_500k`` one decode step against caches of the shape's length,
each on the serving build (weights in the compute dtype) with states laid
out by ``shardings.state_specs``: KV caches split along their sequence
over ``model`` (``models/spmd.context_attention`` combines the ranks'
partial softmaxes), recurrent states along their width.  An
encoder-decoder's prefill encodes its source frames first; its decode
step reads a memory input.  ``long_500k`` is skipped for the archs that
are not sub-quadratic (``configs.applicable``), as the reference skips it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from collections import defaultdict
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, SHAPES, ShapeSpec, applicable, get_config
from ..models.transformer import Model
from ..train import optim
from ..train.trainer import make_train_step
from . import shardings as sh
from .mesh import data_axes, make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# grad-accumulation per cell: keeps per-microbatch activations within HBM
ACCUM = {
    "default": 8,
    "smollm-135m": 2, "qwen3-0.6b": 4, "qwen2-0.5b": 4,
    "falcon-mamba-7b": 16, "llama4-scout-17b-a16e": 32,
    "starcoder2-7b": 8, "phi3.5-moe-42b-a6.6b": 16,
}

def start_fake_group(world: int) -> None:
    """A default group of ``world`` ranks of the ``fake`` backend, this
    process rank 0: its collectives return at once and move nothing.
    ``FakeStore`` lives in ``torch.testing._internal``, PyTorch's own
    test helpers (an internal module, present in the torch of the card's
    machine too)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape: ShapeSpec, mesh, strategy: str = "tp") -> dict:
    """Meta DTensor stand-ins for a cell's inputs (no allocation), the
    reference's: a train step's ``tokens`` and ``labels``, a prefill's
    ``tokens`` (each with ``modality``, or an encoder-decoder's
    ``src_embeds`` of S/2 frames beside S/2 tokens), laid out by
    ``batch_specs``; a decode step's ``token`` (B, 1) and ``position``
    (B,), and an encoder-decoder's bf16 ``memory`` (B, S/2, d_model), on
    the data axes when they split the batch."""
    b, s = shape.global_batch, shape.seq_len
    s_text = s // 2 if cfg.is_encdec else s - cfg.modality_tokens
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "decode":
        bs = sh.batch_axis(mesh, b)
        out = {"token": _meta((b, 1), i32), "position": _meta((b,), i32)}
        specs = {"token": (bs, None), "position": (bs,)}
        if cfg.is_encdec:
            out["memory"] = _meta((b, s // 2, cfg.d_model), torch.bfloat16)
            specs["memory"] = (bs, None, None)
        return sh.abstract_with_sharding(out, specs, mesh)
    out = {"tokens": _meta((b, s_text), i32)}
    if shape.kind == "train":
        out["labels"] = _meta((b, s_text), i32)
    if cfg.modality_tokens:
        out["modality"] = _meta((b, cfg.modality_tokens, cfg.modality_dim),
                                f32)
    if cfg.is_encdec:
        out["src_embeds"] = _meta((b, s // 2, cfg.d_model), f32)
    return sh.abstract_with_sharding(
        out, sh.batch_specs(cfg, mesh, b, strategy), mesh)


def accum_steps(cfg, shape: ShapeSpec, mesh) -> int:
    """``ACCUM``'s microbatches for the arch (1 where the global batch does
    not divide, as the reference), capped to the largest count that
    divides a data rank's rows: each microbatch's rows split over the data
    ranks as the batch's do (``models.spmd.microbatches``)."""
    accum = ACCUM.get(cfg.name, ACCUM["default"])
    if shape.global_batch % accum or shape.global_batch // accum < 1:
        accum = 1
    rows = shape.global_batch // sh.data_shards(mesh)
    while rows % accum:
        accum -= 1
    return accum


def param_bytes(cfg) -> float:
    """Bytes of the float32 training parameters of ``cfg`` (the reference's
    ``meta["param_bytes"]``), counted on a model built on ``meta``."""
    return float(sum(p.numel() * p.element_size() for p in
                     Model(cfg, "meta", train=True).parameters()))


def build_lowerable(cfg, shape: ShapeSpec, mesh, strategy: str = "tp"):
    """Returns (fn, args, meta): the cell's step and its meta DTensor
    arguments — a train cell's parameters, AdamW state and inputs; a
    serving cell's parameters (which the model holds: ``fn`` reads them
    there), states (``shardings.abstract_states``) and inputs.
    ``meta["param_bytes"]`` is the reference's float32 count;
    ``meta["serving_param_bytes"]`` what the serving build holds (its
    matmul weights in the compute dtype)."""
    inputs = input_specs(cfg, shape, mesh, strategy)
    meta = {"param_bytes": param_bytes(cfg)}
    if shape.kind == "train":
        model = sh.abstract_model(Model(cfg, "meta", train=True), mesh,
                                  strategy)
        params = dict(model.named_parameters())
        accum = accum_steps(cfg, shape, mesh)
        meta.update(accum_steps=accum, accum_steps_reference=ACCUM.get(
            cfg.name, ACCUM["default"]))
        return make_train_step(model, accum_steps=accum), \
            (params, optim.adamw_init(params), inputs), meta
    model = sh.abstract_model(Model(cfg, "meta"), mesh, strategy)
    params = dict(model.named_parameters())
    meta["serving_param_bytes"] = float(sum(
        p.numel() * p.element_size() for p in params.values()))
    states = sh.abstract_states(model, mesh, shape.global_batch,
                                shape.seq_len)

    @torch.no_grad()
    def prefill(params, states, inputs):
        memory = model.encode(inputs["src_embeds"]) if cfg.is_encdec \
            else None
        return model.prefill(inputs["tokens"], states,
                             modality=inputs.get("modality"), memory=memory)

    @torch.no_grad()
    def decode(params, states, inputs):
        return model.decode_step(inputs["token"], states, inputs["position"],
                                 memory=inputs.get("memory"))

    return prefill if shape.kind == "prefill" else decode, \
        (params, states, inputs), meta


def _local_bytes(tensors) -> int:
    """Bytes of the rank's own shards of ``tensors`` (DTensors or plain)."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tensors)


#: collective op name -> the reference's kind (``utils/hlo.py``)
_KINDS = {"all_reduce": "all-reduce", "allreduce_": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "_allgather_base_": "all-gather", "allgather_": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
          "broadcast": "broadcast", "broadcast_": "broadcast"}

#: metadata queries ``FlopCounterMode`` leaves alone
_QUERIES = frozenset(getattr(torch.ops.aten, n).default for n in (
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
    "is_non_overlapping_and_dense", "size", "sym_size", "stride",
    "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim") if hasattr(torch.ops.aten, n))


class StepCounter(TorchDispatchMode):
    """What one rank of a step runs: the FLOPs of its operations on plain
    tensors (``FlopCounterMode``'s formulas, and its decomposition of an
    operation that has none) and the collectives, by the reference's
    kind, with their result bytes and wire bytes per participant by its
    rules (all-reduce 2 * out * (n-1)/n, all-gather and all-to-all out *
    (n-1)/n, reduce-scatter out * (n-1), else out; a 1-rank collective
    moves nothing).

    An operation on DTensors falls through to DTensor, whose local
    operations and collectives on the rank's shards then come back here:
    ``CommDebugMode``'s rule.  Operations on fake tensors are DTensor's
    sharding propagation (its shape inference, at the global shapes, the
    first time it meets an operation's schema) and are not counted.  One
    mode counts both because the two modes do not add up:
    ``FlopCounterMode`` over DTensors counts the local operations and
    also that shape inference, so its count depends on what DTensor has
    cached; nested with ``CommDebugMode``, which returns DTensor
    operations to DTensor, it no longer sees the local operations at all.
    (``CommDebugMode``'s per-module tracker also loses its place when a
    backward runs between two forwards inside it: a step's
    microbatches.)"""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.wire = defaultdict(float)
        self.result = defaultdict(float)
        self.counts = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator) \
                or func in _QUERIES \
                or any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.registry \
                and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs,
                                                out_val=out)
        kind = _KINDS.get(packet.__name__)
        if kind is not None:
            self._add(kind, out, list(args) + list(kwargs.values()))
        return out

    def _add(self, kind: str, out, args) -> None:
        from torch.utils._pytree import tree_leaves
        n = 1
        for a in args:
            if isinstance(a, str):
                try:
                    n = dist.distributed_c10d._resolve_process_group(
                        a).size()
                except (KeyError, ValueError, RuntimeError):
                    continue
                break
            if not isinstance(a, torch.Tensor) and callable(
                    getattr(a, "size", None)):
                n = a.size()
                break
        tensors = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        nbytes = float(tensors[0].numel() * tensors[0].element_size()) \
            if tensors else 0.0
        ring = (n - 1) / n if n > 1 else 0.0
        self.counts[kind] += 1
        self.result[kind] += nbytes
        self.wire[kind] += {"all-reduce": 2 * nbytes * ring,
                            "all-gather": nbytes * ring,
                            "all-to-all": nbytes * ring,
                            "reduce-scatter": nbytes * (n - 1)}.get(kind,
                                                                    nbytes)


#: what a cell's FLOPs count, by the shape's kind
FLOPS_COUNT = {
    "train": ("per device: the operations one rank runs on its own shards, "
              "one train step with its microbatches (StepCounter: "
              "FlopCounterMode's formulas)"),
    "prefill": ("per device: the operations one rank runs on its own "
                "shards, one one-shot prefill (StepCounter: "
                "FlopCounterMode's formulas) — the causal square counted "
                "whole (the flash kernel's plain version: dense scores), a "
                "window's layer by its chunked local attention, the scans "
                "by their chunked route"),
    "decode": ("per device: the operations one rank runs on its own "
               "shards, one decode step (StepCounter: FlopCounterMode's "
               "formulas) — the plain dense decode attention over every "
               "S_max slot of the rank's cache shard, the scans by their "
               "chunked route"),
}


def _tensors(states) -> list:
    """Every tensor of a list of ``BlockState``s."""
    return [t for st in states
            for t in (st.kv if st.kv is not None else st.rec.values())]


def measure(cfg, shape: ShapeSpec, mesh) -> dict:
    """One step of ``cfg`` at ``shape`` on ``mesh`` (of a running group,
    the fake one in ``run_cell``), measured: a record's fields."""
    t0 = time.perf_counter()
    fn, args, meta = build_lowerable(cfg, shape, mesh)
    params, held, inputs = args
    param_local = _local_bytes(params.values())
    if shape.kind == "train":
        held = list(held.mu.values()) + list(held.nu.values()) + [held.step]
        counts = ("one rank's float32 parameters, AdamW moments and step, "
                  "and its inputs, from the local shapes")
        state_local = None
    else:
        held = _tensors(held)
        state_local = _local_bytes(held)
        counts = ("one rank's serving parameters (compute-dtype matmul "
                  "weights), its inputs and its KV and recurrent states, "
                  "from the local shapes")
    arg_bytes = _local_bytes(list(params.values()) + held
                             + list(inputs.values()))
    with StepCounter() as count:
        fn(*args)
    # the step ran on meta tensors on the host: the wall is host work
    trace_s = time.perf_counter() - t0
    memory = {"argument_size_in_bytes": arg_bytes,
              "parameter_size_in_bytes": param_local,
              "argument_counts": counts}
    if state_local is not None:
        memory["state_size_in_bytes"] = state_local
    return dict(
        status="ok", meta=meta, trace_s=round(trace_s, 1),
        n_devices=mesh.size(),
        mesh_shape=dict(zip(mesh.mesh_dim_names, mesh.shape)),
        data_axes=list(data_axes(mesh)),
        flops=float(count.flops),
        flops_counts=FLOPS_COUNT[shape.kind],
        memory=memory,
        collectives={"counts": dict(count.counts),
                     "wire_bytes": dict(count.wire),
                     "result_bytes": dict(count.result),
                     "total_wire_bytes": sum(count.wire.values())})


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Path = RESULTS_DIR) -> dict:
    """One cell: its record, also written to
    ``out_dir/ARCH__SHAPE__MESH.json``.  A failure is recorded as
    ``status: "error"`` with its exception; the fake group and its meshes
    are destroyed before it returns."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    if not ok:
        rec.update(status="skip", reason=why)
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: SKIP ({why})")
        return rec
    start_fake_group(512 if mesh_kind == "multi" else 256)
    try:
        rec.update(measure(cfg, shape, make_production_mesh(
            multi_pod=mesh_kind == "multi", device="cpu")))
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
              f"(trace {rec['trace_s']:.1f}s, flops/dev {rec['flops']:.3g}, "
              f"coll wire {rec['collectives']['total_wire_bytes']:.3g}B, "
              f"args/dev "
              f"{rec['memory']['argument_size_in_bytes'] / 2 ** 30:.2f} GiB)")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: "
              f"ERROR {type(e).__name__}: {e}")
    finally:
        dist.destroy_process_group()
    out_path.write_text(json.dumps(rec, indent=1, default=float))
    return rec


def all_cells() -> list[tuple[str, str, str]]:
    """Every (arch x shape x mesh) cell, as the reference's: ``run_cell``
    records the inapplicable ones as skips."""
    return [(arch, shape, mesh) for arch in ARCHS for shape in SHAPES
            for mesh in ("single", "multi")]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    if args.all:
        for arch, shape, mesh in all_cells():
            p = out_dir / f"{arch}__{shape}__{mesh}.json"
            if args.skip_done and p.exists() \
                    and json.loads(p.read_text()).get("status") in ("ok",
                                                                    "skip"):
                continue
            run_cell(arch, shape, mesh, out_dir)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        run_cell(args.arch, args.shape, args.mesh, out_dir)


if __name__ == "__main__":
    main()
