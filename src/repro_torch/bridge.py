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
``w_in, b_in, w_out, b_out`` for a plain MLP); ``rec`` blocks ``ln1``,
``rec`` (``w_x, w_y, conv_w, w_a, w_i, lambda, w_out``), ``ln2``, ``ffn``;
``ssm`` blocks ``ln1`` and ``ssm`` (``in_proj, conv_w, x_proj, dt_proj,
dt_bias, a_log, d_skip, out_proj``) only.  Every leaf of the tree is
consumed: a tree holding anything the port's model does not, or lacking
anything it does, is refused.  Each leaf is copied into the port's tensor,
which casts matmul weights and biases to the compute dtype once (the JAX
package casts them per call); the leaves the port reads in float32
(``lambda``, Mamba's ``x_proj, dt_proj, dt_bias, a_log, d_skip``, the norm
scales and biases, the embedding and ``lm_head``) stay float32.

An LSTM layer (``repro.models.recurrent.init_lstm_layer``) is a tree of its
own, ``w_x`` (Din, 4H), ``w_h`` (H, 4H) and ``b`` (4H,): ``lstm_from_jax``
carries it into the dict ``repro_torch.models.recurrent.lstm_layer``
reads.
"""
from __future__ import annotations

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
    _keys(node, mod.keys(), where)
    for name, p in mod.items():
        _copy(p, node[name], f"{where}.{name}")


def from_jax_params(tree: dict, cfg: ArchConfig,
                    device: str | torch.device = "cuda") -> Model:
    """A ``Model`` on ``device`` holding the weights of ``tree``."""
    model = Model(cfg, device)
    top = ["embed", "final_norm", "groups", "tail"]
    if model.lm_head is not None:
        top.append("lm_head")
    if model.mm_proj is not None:
        top.append("mm_proj")
    _keys(tree, top, "model")
    _copy(model.embed, tree["embed"], "embed")
    _copy_norm(model, "final_norm", tree["final_norm"], "final_norm")
    if model.lm_head is not None:
        _copy(model.lm_head, tree["lm_head"], "lm_head")
    if model.mm_proj is not None:
        _copy_dict(model.mm_proj, tree["mm_proj"], "mm_proj")
    for i, (blk, lt) in enumerate(zip(model.layers, _layer_trees(tree, cfg))):
        want = (*blk.NORMS, *blk.PARTS)
        if set(lt) != set(want):
            raise ValueError(f"layer {i} ({blk.kind}): JAX block holds "
                             f"{sorted(lt)}, port expects {', '.join(want)}")
        for norm in blk.NORMS:
            _copy_norm(blk, norm, lt[norm], f"layer {i} {norm}")
        for part in blk.PARTS:
            _copy_dict(getattr(blk, part), lt[part], f"layer {i} {part}")
    return model


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
