"""Weight bridge: the JAX package's parameter pytree, handed over as numpy
arrays, into the port's ``Model``.

The tree (``repro.models.transformer.Model.init``) holds ``embed``,
``final_norm``, ``groups[str(j)]`` — the blocks at pattern position ``j``,
stacked on axis 0 over the scanned groups — and ``tail``, the blocks past the
last whole group, and, where the config has them, an untied ``lm_head`` and
the modality stub ``mm_proj`` (``w1``, ``w2``).  Layer ``g * len(pattern) +
j`` is ``groups[str(j)][g]``.  A norm is ``{"scale"}`` (RMSNorm) or
``{"scale", "bias"}`` (LayerNorm).  The block type of a layer follows its
pattern position, and each block type declares the norms (``NORMS``) and
parameter groups (``PARTS``) it holds: ``attn`` / ``local`` blocks hold
``ln1``, ``attn``, ``ln2``, ``ffn`` (``w_gate, w_up, w_down`` for a GLU,
``w_in, b_in, w_out, b_out`` for a plain MLP; ``router`` (D, E), the expert
banks ``w_gate, w_up`` (E, D, F) and ``w_down`` (E, F, D) for an MoE, with
a nested ``shared`` GLU dict where the config has a shared expert); ``rec`` blocks ``ln1``,
``rec`` (``w_x, w_y, conv_w, w_a, w_i, lambda, w_out``), ``ln2``, ``ffn``;
``ssm`` blocks ``ln1`` and ``ssm`` (``in_proj, conv_w, x_proj, dt_proj,
dt_bias, a_log, d_skip, out_proj``) only; an encoder-decoder's ``dec``
blocks hold ``ln1``, ``attn``, ``ln_x``, ``xattn`` (``wq, wk, wv, wo``),
``ln2``, ``ffn``, and its tree adds ``encoder`` — the ``enc`` blocks
(``ln1``, ``attn``, ``ln2``, ``ffn``) stacked on axis 0 over
``enc_layers`` — and ``enc_norm``.  Every leaf of the tree is
consumed, nested dicts too: a tree holding anything the port's model does
not, or lacking anything it does, is refused.  Each leaf is copied into the
port's tensor, which casts matmul weights and biases to the compute dtype
once (the JAX package casts them per call); the leaves the port reads in
float32 (``lambda``, Mamba's ``x_proj, dt_proj, dt_bias, a_log, d_skip``,
an MoE's ``router``, the norm scales and biases, the embedding and
``lm_head``) stay float32.

A model built with ``train=True`` keeps every leaf float32, as the JAX
package's masters.  The way back: ``to_jax_params`` rebuilds the JAX tree
of the weights in numpy, ``to_jax_tree`` puts any tensors kept per
parameter (gradients, the optimizer's moments) in that layout, and
``from_jax_tree`` takes them out again; ``layout`` says where each port
parameter sits in it, and ``decay_mask`` what the JAX package's AdamW
decays there (a leaf of rank 2 or more — so every stacked 1-D norm scale,
bias and vector, but not a tail layer's; every expert bank and router).

An LSTM layer (``repro.models.recurrent.init_lstm_layer``) is a tree of its
own, ``w_x`` (Din, 4H), ``w_h`` (H, 4H) and ``b`` (4H,): ``lstm_from_jax``
carries it into the dict ``repro_torch.models.recurrent.lstm_layer``
reads.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models.model_config import ArchConfig
from .models.transformer import Model


def _layer_trees(tree: dict, cfg: ArchConfig) -> list[dict]:
    pattern = cfg.block_pattern
    n_groups = cfg.num_layers // len(pattern)
    for j in range(len(pattern) if n_groups else 0):
        depth = np.shape(tree["groups"][str(j)]["ln1"]["scale"])[0]
        if depth != n_groups:
            raise ValueError(f"tree stacks {depth} groups at pattern "
                             f"position {j}, config {cfg.name} has "
                             f"{n_groups}")
    layers = []
    for g in range(n_groups):
        for j in range(len(pattern)):
            layers.append(_index(tree["groups"][str(j)], g))
    layers.extend(tree["tail"])
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} blocks, config "
                         f"{cfg.name} has {cfg.num_layers}")
    return layers


def _index(node, g: int):
    if isinstance(node, dict):
        return {k: _index(v, g) for k, v in node.items()}
    return node[g]


@torch.no_grad()
def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX leaf {src.shape} vs port "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src, np.float32)))


def _keys(node: dict, want, where: str) -> None:
    if set(node) != set(want):
        raise ValueError(f"{where}: JAX tree holds {sorted(node)}, port "
                         f"expects {sorted(want)}")


def _copy_norm(mod, name: str, node: dict, where: str) -> None:
    """The norm ``name`` of ``mod``: its scale, and its bias for LayerNorm."""
    bias = getattr(mod, name + "_bias")
    _keys(node, ("scale",) if bias is None else ("scale", "bias"), where)
    _copy(getattr(mod, name), node["scale"], f"{where} scale")
    if bias is not None:
        _copy(bias, node["bias"], f"{where} bias")


def _copy_dict(mod, node: dict, where: str) -> None:
    """A ``ParameterDict`` from a dict of leaves, a nested one (an MoE's
    ``shared`` expert) from the nested dict."""
    _keys(node, mod.keys(), where)
    for name, p in mod.items():
        if isinstance(p, torch.nn.ParameterDict):
            if not isinstance(node[name], dict):
                raise ValueError(f"{where}.{name}: JAX leaf where the port "
                                 f"expects a dict")
            _copy_dict(p, node[name], f"{where}.{name}")
        else:
            _copy(p, node[name], f"{where}.{name}")


def _copy_block(blk, lt: dict, where: str) -> None:
    want = (*blk.NORMS, *blk.PARTS)
    if set(lt) != set(want):
        raise ValueError(f"{where} ({blk.kind}): JAX block holds "
                         f"{sorted(lt)}, port expects {', '.join(want)}")
    for norm in blk.NORMS:
        _copy_norm(blk, norm, lt[norm], f"{where} {norm}")
    for part in blk.PARTS:
        _copy_dict(getattr(blk, part), lt[part], f"{where} {part}")


def from_jax_params(tree: dict, cfg: ArchConfig,
                    device: str | torch.device = "cuda", *,
                    train: bool = False) -> Model:
    """A ``Model`` on ``device`` holding the weights of ``tree``
    (``train``: as float32 masters that require their gradients)."""
    model = Model(cfg, device, train=train)
    top = ["embed", "final_norm", "groups", "tail"]
    if model.lm_head is not None:
        top.append("lm_head")
    if model.mm_proj is not None:
        top.append("mm_proj")
    if cfg.is_encdec:
        top += ["encoder", "enc_norm"]
    _keys(tree, top, "model")
    _copy(model.embed, tree["embed"], "embed")
    _copy_norm(model, "final_norm", tree["final_norm"], "final_norm")
    if model.lm_head is not None:
        _copy(model.lm_head, tree["lm_head"], "lm_head")
    if model.mm_proj is not None:
        _copy_dict(model.mm_proj, tree["mm_proj"], "mm_proj")
    for i, (blk, lt) in enumerate(zip(model.layers, _layer_trees(tree, cfg))):
        _copy_block(blk, lt, f"layer {i}")
    if cfg.is_encdec:
        depth = np.shape(tree["encoder"]["ln1"]["scale"])[0]
        if depth != cfg.enc_layers:
            raise ValueError(f"tree stacks {depth} encoder layers, config "
                             f"{cfg.name} has {cfg.enc_layers}")
        for i, blk in enumerate(model.encoder):
            _copy_block(blk, _index(tree["encoder"], i), f"encoder layer {i}")
        _copy_norm(model, "enc_norm", tree["enc_norm"], "enc_norm")
    return model


# ------------------------------------------------------------- the way back
class Leaf(NamedTuple):
    """Where one port parameter sits in the JAX tree: ``path`` from the
    root, and ``index``, its row of a leaf stacked on axis 0 (None where
    the leaf is not stacked)."""
    name: str
    path: tuple
    index: int | None


def _norm_leaves(mod, name: str, prefix: str, path: tuple,
                 index: int | None) -> list[Leaf]:
    out = [Leaf(prefix + name, path + (name, "scale"), index)]
    if getattr(mod, name + "_bias") is not None:
        out.append(Leaf(prefix + name + "_bias", path + (name, "bias"),
                        index))
    return out


def _block_leaves(blk, prefix: str, path: tuple,
                  index: int | None) -> list[Leaf]:
    out = []
    for norm in blk.NORMS:
        out += _norm_leaves(blk, norm, prefix, path, index)
    for part in blk.PARTS:
        out += _dict_leaves(getattr(blk, part), f"{prefix}{part}.",
                            path + (part,), index)
    return out


def _dict_leaves(mod, prefix: str, path: tuple,
                 index: int | None) -> list[Leaf]:
    out = []
    for key, p in mod.items():
        if isinstance(p, torch.nn.ParameterDict):
            out += _dict_leaves(p, f"{prefix}{key}.", path + (key,), index)
        else:
            out.append(Leaf(prefix + key, path + (key,), index))
    return out


def layout(model: Model) -> list[Leaf]:
    """Every parameter of ``model`` (by its ``named_parameters`` name) and
    its place in the JAX package's tree: layer ``g * len(pattern) + j`` is
    row g of ``groups[str(j)]``, a layer past the last whole group is a
    ``tail`` entry, encoder layer i is row i of ``encoder``."""
    cfg = model.cfg
    pat = len(cfg.block_pattern)
    grouped = cfg.num_layers // pat * pat
    out = [Leaf("embed", ("embed",), None)]
    out += _norm_leaves(model, "final_norm", "", (), None)
    if model.lm_head is not None:
        out.append(Leaf("lm_head", ("lm_head",), None))
    if model.mm_proj is not None:
        out += _dict_leaves(model.mm_proj, "mm_proj.", ("mm_proj",), None)
    for i, blk in enumerate(model.layers):
        if i < grouped:
            path, index = ("groups", str(i % pat)), i // pat
        else:
            path, index = ("tail", i - grouped), None
        out += _block_leaves(blk, f"layers.{i}.", path, index)
    for i, blk in enumerate(model.encoder):
        out += _block_leaves(blk, f"encoder.{i}.", ("encoder",), i)
    if model.enc_norm is not None:
        out += _norm_leaves(model, "enc_norm", "", (), None)
    return out


def decay_mask(model: Model) -> dict[str, bool]:
    """Which parameters the JAX package's AdamW decays: those whose JAX
    leaf has rank 2 or more (``optim.adamw_update``'s ``p.ndim >= 2``) —
    a port tensor's rank plus one where the leaf is stacked."""
    params = dict(model.named_parameters())
    return {leaf.name: params[leaf.name].dim()
            + (leaf.index is not None) >= 2 for leaf in layout(model)}


def to_jax_tree(model: Model, tensors: dict) -> dict:
    """``tensors`` (one per parameter of ``model``, by name: the weights,
    their gradients, the optimizer's moments; detached) in the JAX tree's
    layout: groups stacked on axis 0, then the tail."""
    cfg = model.cfg
    tail = cfg.num_layers - cfg.num_layers // len(cfg.block_pattern) \
        * len(cfg.block_pattern)
    tree: dict = {"groups": {}, "tail": [{} for _ in range(tail)]}
    stacks: dict = {}
    for leaf in layout(model):
        t = tensors[leaf.name].detach()
        if leaf.index is None:
            _put(tree, leaf.path, t)
        else:
            stacks.setdefault(leaf.path, {})[leaf.index] = t
    for path, rows in stacks.items():
        _put(tree, path, torch.stack([rows[i] for i in range(len(rows))]))
    return tree


def _put(tree, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node[key] if isinstance(node, list) else \
            node.setdefault(key, {})
    node[path[-1]] = value


def from_jax_tree(model: Model, tree: dict) -> dict:
    """The inverse of ``to_jax_tree``: each parameter's leaf (or its row
    of a stacked leaf) out of a tree in the JAX layout, by port name."""
    out = {}
    for leaf in layout(model):
        node = tree
        for key in leaf.path:
            node = node[key]
        out[leaf.name] = node if leaf.index is None else node[leaf.index]
    return out


def _numpy(node):
    if isinstance(node, dict):
        return {k: _numpy(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_numpy(v) for v in node]
    return node.float().cpu().numpy() if node.dtype == torch.bfloat16 \
        else node.cpu().numpy()


def to_jax_params(model: Model) -> dict:
    """The model's weights as the JAX package's parameter tree, in numpy
    (bf16 widened to float32)."""
    return _numpy(to_jax_tree(model, dict(model.named_parameters())))


def lstm_from_jax(tree: dict, device: str | torch.device = "cuda") -> dict:
    """The port's LSTM layer parameters (float32, on ``device``) from the
    numpy leaves of the JAX package's ``init_lstm_layer`` tree."""
    if set(tree) != {"w_x", "w_h", "b"}:
        raise ValueError(f"LSTM tree holds {sorted(tree)}, expected b, w_h, "
                         f"w_x")
    h4 = np.shape(tree["w_h"])[1]
    want = {"w_x": (np.shape(tree["w_x"])[0], h4), "w_h": (h4 // 4, h4),
            "b": (h4,)}
    params = {}
    for name, shape in want.items():
        params[name] = torch.empty(shape, dtype=torch.float32, device=device)
        _copy(params[name], tree[name], f"lstm {name}")
    return params
