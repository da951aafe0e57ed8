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


def save(ckpt_dir: str | Path, step: int, tree) -> Path:
    """Write the tree's leaves and manifest, then commit the directory
    (one process: its shard is ``shard_00000.npz``)."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)
    arrays, meta = {}, []
    for i, (name, leaf) in enumerate(flatten_with_path(tree)):
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
    return final


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


def restore(ckpt_dir: str | Path, step: int, target):
    """The checkpoint of ``step`` in the structure of ``target``, whose
    leaves give each leaf's shape and torch dtype (tensors, also on the
    ``meta`` device): CPU tensors of those dtypes.  Refuses a checkpoint
    whose leaves differ from the target's in number, path or shape."""
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
    return _unflatten(target, iter(out))
