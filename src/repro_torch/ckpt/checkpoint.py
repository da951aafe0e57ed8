"""Checkpoints in the JAX package's on-disk layout (``repro.ckpt.checkpoint``),
so a checkpoint either package writes restores in the other.

Layout (one directory per step):
    ckpt_dir/step_00000100.tmp/      <- written first
        shard_00000.npz              <- ``leaf_i`` arrays, one per leaf
        tree.json                    <- step, each leaf's path / shape / dtype
    ckpt_dir/step_00000100/          <- atomic rename == commit
    ckpt_dir/LATEST                  <- text file, updated last

A tree is nested dicts, lists, tuples and NamedTuples of tensors or arrays,
flattened as ``jax.tree_util.tree_flatten_with_path`` flattens it (dict keys
sorted, NamedTuple fields in order, ``None`` holding no leaf) and each path
written as ``jax.tree_util.keystr`` writes it (``[0]['embed']``,
``[1].mu['groups']['0']['attn']['wq']``).  A bf16 leaf is stored as its raw
16-bit view, its dtype in ``tree.json``, as the JAX package stores
``ml_dtypes``.  The contract is the JAX package's: a crash mid-write leaves
only ``*.tmp``, which ``latest_step`` ignores and a later save overwrites.

Elastic restore: a tree of DTensors (a model trained on a mesh) is saved
whole — each leaf's ``full_tensor()``, a collective every rank takes part
in, in the same leaf order — and only rank 0 writes and commits it, as the
reference's process 0 does; ``restore(..., shardings=)`` lays each leaf
out on a mesh of any shape (``launch.shardings.local_part``: every rank
reads the whole array and keeps its shard), so a job saved on one mesh
resumes on another.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

#: dtypes npz round-trips as they are (the JAX package's list)
_NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16",
           "int8", "uint8", "uint16", "uint32", "uint64", "bool")


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(keystr path, leaf) pairs in the JAX package's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in flatten_with_path(getattr(tree, f),
                                            f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in flatten_with_path(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array npz stores and the dtype name ``tree.json``
    records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def save(ckpt_dir: str | Path, step: int, tree) -> Path:
    """Write the tree's leaves and manifest, then commit the directory.
    DTensor leaves are gathered whole on every rank first (collective);
    then only process 0 (this rank of the default group, else 0) writes
    ``shard_00000.npz`` and commits, and in a group of more than one rank
    every rank then waits at a barrier, so that each returns after the
    commit."""
    from torch.distributed.tensor import DTensor
    ckpt_dir = Path(ckpt_dir)
    pidx = _process_index()
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    flat = [(name, leaf.full_tensor() if isinstance(leaf, DTensor) else leaf)
            for name, leaf in flatten_with_path(tree)]
    if pidx != 0:
        _barrier()
        return final
    tmp.mkdir(parents=True, exist_ok=True)
    arrays, meta = {}, []
    for i, (name, leaf) in enumerate(flat):
        arr, dtype_name = _to_numpy(leaf)
        if str(arr.dtype) not in _NATIVE:
            raise TypeError(f"{name}: dtype {dtype_name} has no npz form")
        arrays[f"leaf_{i}"] = arr
        meta.append({"path": name, "shape": list(arr.shape),
                     "dtype": dtype_name})
    np.savez(tmp / "shard_00000.npz", **arrays)
    (tmp / "tree.json").write_text(json.dumps(
        {"step": step, "leaves": meta, "num_processes": 1}))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                         # atomic commit
    (ckpt_dir / "LATEST").write_text(str(step))
    _barrier()
    return final


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def latest_step(ckpt_dir: str | Path) -> int | None:
    """The step in ``LATEST`` if its directory is committed, else the
    newest committed step directory (None if there is none)."""
    ckpt_dir = Path(ckpt_dir)
    marker = ckpt_dir / "LATEST"
    if marker.exists():
        step = int(marker.read_text().strip())
        if (ckpt_dir / f"step_{step:08d}" / "tree.json").exists():
            return step
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp")
                   and (p / "tree.json").exists())
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, step: int, target, shardings=None):
    """The checkpoint of ``step`` in the structure of ``target``, whose
    leaves give each leaf's shape and torch dtype (tensors, also on the
    ``meta`` device): CPU tensors of those dtypes.  Refuses a checkpoint
    whose leaves differ from the target's in number, path or shape.

    ``shardings``: ``target``'s structure with a ``(mesh, placements)``
    pair (or None) where ``target`` has each leaf: that leaf comes back as
    a DTensor of those placements on that mesh's device (each rank keeps
    its shard of the whole array it read), whatever mesh it was saved
    from."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((d / "tree.json").read_text())
    shard_files = sorted(d.glob("shard_*.npz"))
    if not shard_files:
        raise FileNotFoundError(f"no shards in {d}")
    data = np.load(shard_files[0])
    flat = flatten_with_path(target)
    if len(flat) != len(meta["leaves"]):
        raise ValueError(f"checkpoint has {len(meta['leaves'])} leaves, "
                         f"target {len(flat)}")
    out = []
    for i, ((path, tgt), m) in enumerate(zip(flat, meta["leaves"])):
        if path != m["path"] or tuple(m["shape"]) != tuple(tgt.shape):
            raise ValueError(f"leaf {i}: checkpoint {m['path']} shape "
                             f"{m['shape']}, target {path} shape "
                             f"{list(tgt.shape)}")
        arr = data[f"leaf_{i}"]
        t = torch.from_numpy(np.array(arr))      # a 0-d leaf stays 0-d
        if m["dtype"] == "bfloat16":         # stored as a raw 16-bit view
            t = t.view(torch.int16).view(torch.bfloat16)
        elif str(arr.dtype) != m["dtype"]:
            raise ValueError(f"{path}: stored {arr.dtype}, manifest "
                             f"{m['dtype']}")
        out.append(t.to(tgt.dtype))
    if shardings is not None:
        out = [t if sh is None else _placed(t, *sh)
               for t, sh in zip(out, _leaves_like(target, shardings))]
    return _unflatten(target, iter(out))


def shardings_of(target):
    """``target``'s structure with each DTensor leaf's ``(mesh,
    placements)`` and None at every other leaf: the ``shardings`` that lay
    a checkpoint out as ``target`` is laid out."""
    from torch.distributed.tensor import DTensor
    return _unflatten(target, iter(
        (leaf.device_mesh, leaf.placements) if isinstance(leaf, DTensor)
        else None for _, leaf in flatten_with_path(target)))


def _placed(t: torch.Tensor, mesh, placements):
    from ..launch.shardings import local_part
    return local_part(t.to(mesh.device_type), mesh, tuple(placements))


def _leaves_like(target, tree) -> list:
    """``tree``'s sub-trees where ``target`` (flattened as
    ``flatten_with_path``) has its leaves, in that order."""
    if target is None:
        return []
    if isinstance(target, dict):
        return [x for k in sorted(target)
                for x in _leaves_like(target[k], tree[k])]
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return [x for f in target._fields
                for x in _leaves_like(getattr(target, f), getattr(tree, f))]
    if isinstance(target, (list, tuple)):
        return [x for t, s in zip(target, tree)
                for x in _leaves_like(t, s)]
    return [tree]
