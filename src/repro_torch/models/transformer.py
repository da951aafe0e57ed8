"""Model assembly for the port: decoder stacks of ``attn`` (full causal
attention), ``local`` (sliding-window attention) and ``rec`` (Griffin
recurrent) blocks with a GLU or a plain-MLP feed-forward — qwen3-0.6b,
qwen2-0.5b, smollm-135m, starcoder2-7b, internvl2-2b and recurrentgemma-2b
and their families — or of ``ssm`` (Mamba-1) blocks with no feed-forward —
falcon-mamba-7b; and encoder-decoders, an encoder of ``enc`` blocks
(non-causal self-attention, no RoPE) whose normed output is the memory the
decoder's ``dec`` blocks cross-attend to — seamless-m4t-medium.  Norms are
RMSNorm or LayerNorm (``cfg.norm``); the unembedding is tied to the
embedding or an untied ``lm_head``; a model with ``modality_tokens``
carries the ``mm_proj`` stub that projects precomputed patch embeddings
into tokens prepended to the text.  Stacks of ``attn`` and ``local``
blocks may take a top-k routed mixture-of-experts feed-forward instead
(``models/moe.py``) — phi3.5-moe-42b-a6.6b and llama4-scout-17b-a16e — whose
load-balance term ``loss`` adds as the JAX package's does.

The PyTorch counterpart of ``repro.models.transformer.Model``, with the
weights held by the module instead of passed as a pytree, and the layers in
the JAX package's order (the pattern's groups, then the tail):

  * ``train_forward`` / ``loss`` — full-sequence logits and the next-token
    cross-entropy, under whatever autograd mode the caller runs them in;
    ``forward`` — the same logits with autograd off.
  * ``init_states``  — one ``BlockState`` per layer: a paged KV pool for
    ``attn`` when ``kv_block_size`` is set, else a dense cache; a ring of
    ``min(max_len, window)`` for ``local``; ``{"conv", "h"}`` for ``rec``
    and ``ssm``.
  * ``encode`` — an encoder-decoder's memory of its source embeddings.
  * ``prefill`` / ``decode_step`` — the serving path; an encoder-decoder's
    ``dec`` layers cross-attend to ``memory=`` (``encode``'s output) in
    both, as the JAX package's ``prefill``/``decode_step`` do.  No engine
    serves an encoder-decoder (``serve.engine.ServeEngine`` refuses one,
    as the JAX engine serves none): its callers drive the model.

Attention and the two scans have two routes each.  With autograd off they
go through the kernel wrappers (the CUDA kernels on the card).  In train
mode while autograd records — where no wrapper has a backward — they take
the JAX package's own training route: ``flash_attention_xla`` and
``chunked_linear_scan`` in chunks of ``cfg.scan_chunk``; the scans take the
chunked route on ``meta`` activations too (the dry run).  A decoder's
cross-attention always takes ``flash_attention_xla``, as the JAX package's
does.

A serving model (``train=False``) stores parameters the way the JAX package
computes with them: matmul weights in the compute dtype (JAX casts its
float32 masters per call, which gives the same values), norm scales and
biases, ``lambda``, Mamba's ``x_proj``, ``dt_proj``, ``dt_bias``, ``a_log``
and ``d_skip``, and the embedding table and ``lm_head`` in float32
(``rms_norm``, ``layer_norm``, ``rglru_core``, ``mamba_ssm`` and
``unembed`` read them in float32).  A model built with ``train=True``
holds every parameter in float32 (the JAX package's ``param_dtype``) with
``requires_grad``, and each use casts it where the JAX package does, so
autograd differentiates through the cast.  ``H·hd`` need not equal
``d_model``: ``wo`` is ``(H·hd, d_model)``.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from . import attention as attn_lib
from . import moe as moe_lib
from . import recurrent as rec_lib
from . import spmd
from .common import (copy_into, embed_scaled, fan_in_std, gelu, layer_norm,
                     rms_norm, torch_dtype, unembed, vocab_cross_entropy)
from .ffn import glu_ffn, mlp_ffn
from .model_config import ArchConfig


#: decoder block kinds (``enc`` blocks make up the encoder only)
SUPPORTED_KINDS = ("attn", "local", "rec", "ssm", "dec")
FFNS = {"glu": glu_ffn, "mlp": mlp_ffn}


def _check_supported(cfg: ArchConfig) -> None:
    """Stacks of attn/local/rec/dec blocks take a GLU or plain-MLP
    feed-forward, and decoder-only stacks of attn/local blocks also an MoE
    one; a stack of ``ssm`` blocks has none (``ffn_kind == "none"``), and
    only it.  ``dec`` blocks cross-attend to an encoder's memory, so they
    need ``enc_layers``; an encoder's ``enc`` blocks take the (GLU or MLP)
    feed-forward too.  Either norm, tied or untied heads and the modality
    stub go with any of them."""
    kinds = set(cfg.layer_kinds)
    stack_ok = kinds == {"ssm"} and cfg.ffn_kind == "none" \
        or "ssm" not in kinds and cfg.ffn_kind in FFNS \
        or cfg.ffn_kind == "moe" and kinds <= {"attn", "local"}
    enc_ok = cfg.ffn_kind in FFNS if cfg.is_encdec else "dec" not in kinds
    if not kinds <= set(SUPPORTED_KINDS) or not stack_ok or not enc_ok \
            or cfg.norm not in ("rms", "layer"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs stacks of attn, local, rec and dec "
            f"blocks with a GLU or MLP feed-forward (dec blocks behind an "
            f"encoder), decoder-only stacks of attn and local blocks with an "
            f"MoE one, or of ssm blocks with none; block kinds "
            f"{sorted(kinds)}, ffn {cfg.ffn_kind!r}, norm {cfg.norm!r} and "
            f"{cfg.enc_layers} encoder layers are not ported")


def _weight(*shape, dtype, device, train: bool = False) -> nn.Parameter:
    """A parameter of ``shape``: in ``dtype`` for serving, or, with
    ``train``, a float32 master that requires its gradient."""
    if train:
        dtype = torch.float32
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=train)


def _norm_params(cfg: ArchConfig, device: torch.device, train: bool):
    """A norm's float32 scale, and its float32 bias for LayerNorm (None for
    RMSNorm)."""
    f32, d = torch.float32, cfg.d_model
    bias = _weight(d, dtype=f32, device=device, train=train) \
        if cfg.norm == "layer" else None
    return _weight(d, dtype=f32, device=device, train=train), bias


def _differentiable(mode: str) -> bool:
    """Whether a block takes the JAX package's training route: train mode
    while autograd records (the kernel wrappers have no backward)."""
    return mode == "train" and torch.is_grad_enabled()


def _scan_chunk(cfg: ArchConfig, mode: str, x: torch.Tensor) -> int | None:
    """The chunk of ``chunked_linear_scan`` for a recurrent block, or None
    for the scan's kernel wrapper: the training route under autograd, and
    on ``meta`` activations (the dry run), where the wrappers' plain
    versions would loop over every step — the JAX dry run lowers the
    chunked XLA scan too (its configs' ``rglru_impl``/``ssm_impl`` are
    "xla")."""
    if _differentiable(mode) or x.device.type == "meta":
        return cfg.scan_chunk
    return None


def _norm(cfg: ArchConfig, x: torch.Tensor, scale: torch.Tensor,
          bias: torch.Tensor | None) -> torch.Tensor:
    """``repro.models.transformer._norm``: RMSNorm or LayerNorm."""
    if cfg.norm == "rms":
        return rms_norm(x, scale)
    return layer_norm(x, scale, bias)


@torch.no_grad()
def _init_norm(put, scale: torch.Tensor, bias: torch.Tensor | None,
               device) -> None:
    """The JAX init, each value made whole in float32 on ``device`` and
    handed to ``put``: an RMSNorm scale at zero (its gain is 1 + scale), a
    LayerNorm's scale at one and its bias at zero."""
    if bias is None:
        put(scale, torch.zeros(scale.shape, device=device))
    else:
        put(scale, torch.ones(scale.shape, device=device))
        put(bias, torch.zeros(bias.shape, device=device))


class _Block(nn.Module):
    """What every block shares: its norms, each a scale ``name`` and, for
    LayerNorm, a bias ``name + "_bias"``."""
    NORMS: tuple[str, ...] = ()

    def _normed(self, cfg: ArchConfig, name: str,
                x: torch.Tensor) -> torch.Tensor:
        return _norm(cfg, x, getattr(self, name),
                     getattr(self, name + "_bias"))


class BlockState(NamedTuple):
    """One layer's serving state: ``kv`` for an attention layer (a dense
    ``KVCache``, a window's ring, or a ``PagedKVCache``), ``rec`` for a
    recurrent one (``rec``: ``{"conv": (B,K-1,d_rnn), "h": (B,d_rnn)
    float32}``; ``ssm``: ``{"conv": (B,K-1,d_inner), "h":
    (B,d_inner,d_state) float32}``)."""
    kv: attn_lib.KVCache | attn_lib.PagedKVCache | None = None
    rec: dict | None = None


def _ffn_params(cfg: ArchConfig, cd: torch.dtype, device: torch.device,
                train: bool) -> nn.ParameterDict:
    """The GLU's three matrices, or the plain MLP's two with their biases,
    all in the compute dtype; or the MoE's float32 ``router`` (D, E), its
    expert banks ``w_gate`` / ``w_up`` (E, D, F) and ``w_down`` (E, F, D)
    in the compute dtype, and, with ``moe_shared_expert``, the ``shared``
    GLU nested inside."""
    d, f = cfg.d_model, cfg.d_ff
    glu = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}

    def weights(shapes: dict) -> nn.ParameterDict:
        return nn.ParameterDict({
            name: _weight(*shape, dtype=cd, device=device, train=train)
            for name, shape in shapes.items()})

    if cfg.ffn_kind == "glu":
        return weights(glu)
    if cfg.ffn_kind == "mlp":
        return weights({"w_in": (d, f), "b_in": (f,), "w_out": (f, d),
                        "b_out": (d,)})
    e = cfg.num_experts
    params = nn.ParameterDict({"router": _weight(
        d, e, dtype=torch.float32, device=device, train=train)})
    params.update(weights({"w_gate": (e, d, f), "w_up": (e, d, f),
                           "w_down": (e, f, d)}))
    if cfg.moe_shared_expert:
        params["shared"] = weights(glu)
    return params


def _attn_params(cfg: ArchConfig, cd: torch.dtype, device: torch.device,
                 train: bool, *, bias: bool,
                 qk_norm: bool) -> nn.ParameterDict:
    """GQA projections in the compute dtype (``wo``: (H·hd, d_model)), with
    the qkv biases and the float32 qk-norm scales where asked."""
    d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    shapes = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d)}
    if bias:
        shapes.update(bq=(hq,), bk=(hkv,), bv=(hkv,))
    params = nn.ParameterDict({
        name: _weight(*shape, dtype=cd, device=device, train=train)
        for name, shape in shapes.items()})
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            params[name] = _weight(cfg.head_dim, dtype=torch.float32,
                                   device=device, train=train)
    return params


def _ffn(cfg: ArchConfig, params: nn.ParameterDict, x: torch.Tensor,
         mode: str):
    """The feed-forward's output and, for an MoE in train mode, its
    load-balance term (None otherwise: serving has no use for it)."""
    if cfg.ffn_kind != "moe":
        return FFNS[cfg.ffn_kind](params, x, cfg.activation), None
    out = moe_lib.moe_ffn(params, x, top_k=cfg.top_k,
                          capacity_factor=cfg.moe_capacity,
                          activation=cfg.activation,
                          return_aux=mode == "train", impl=cfg.moe_impl)
    if mode != "train":
        return out, None
    return out[0], out[1]["load_balance"]


class AttnBlock(_Block):
    """Pre-norm residual block: GQA self-attention — full causal for
    ``attn``, sliding-window over a ring cache for ``local``, non-causal
    without RoPE for an encoder's ``enc`` — then the feed-forward."""
    NORMS = ("ln1", "ln2")
    PARTS = ("attn", "ffn")

    def __init__(self, cfg: ArchConfig, kind: str, device: torch.device,
                 train: bool = False):
        super().__init__()
        self.kind = kind
        cd = torch_dtype(cfg.compute_dtype)
        self.ln1, self.ln1_bias = _norm_params(cfg, device, train)
        self.attn = _attn_params(cfg, cd, device, train, bias=cfg.qkv_bias,
                                 qk_norm=cfg.qk_norm)
        self.ln2, self.ln2_bias = _norm_params(cfg, device, train)
        self.ffn = _ffn_params(cfg, cd, device, train)

    def _self_attention(self, cfg: ArchConfig, q, k, v, mode: str):
        """Full-sequence self-attention (train mode or a one-shot
        prefill): ``local_attention`` for a ``local`` layer whose S is a
        multiple of the window, as the JAX package's; else the flash
        wrapper, or ``flash_attention_xla`` under autograd."""
        window = cfg.window if self.kind == "local" else 0
        causal = self.kind != "enc"
        if window and q.shape[1] % window == 0:
            fn = functools.partial(attn_lib.local_attention, window=window)
        elif _differentiable(mode):
            fn = functools.partial(attn_lib.flash_attention_xla,
                                   causal=causal, window=window)
        else:
            fn = functools.partial(attn_lib.flash_attention, causal=causal,
                                   window=window)
        return spmd.self_attention(fn, q, k, v)

    def _attend(self, q, k, v, kv, length, offset, block_table, *,
                cfg: ArchConfig, mode: str):
        """One layer's cache op and attention on plain tensors: the new K/V
        written into ``kv`` (a dense cache, a window's ring or the paged
        pool) and read back, as ``mode`` and ``offset`` say.  In decode a
        0/1 ``length`` is the activity mask.  Returns (out, kv); on a mesh
        it runs on each rank's shard (``spmd.attention``)."""
        window = cfg.window if self.kind == "local" else 0
        paged = isinstance(kv, attn_lib.PagedKVCache)
        if mode == "decode":
            wm = None if length is None else length > 0
            if paged:
                return attn_lib.paged_decode_attention(
                    q, k, v, kv, block_table, write_mask=wm)
            return attn_lib.decode_attention(q, k, v, kv, window=window,
                                             write_mask=wm)
        if mode == "prefill" and offset is not None:
            if paged:
                return attn_lib.paged_chunk_attention(
                    q, k, v, kv, block_table, offset=offset, length=length)
            return attn_lib.chunk_attention(
                q, k, v, kv, offset=offset, length=length, window=window)
        out = self._self_attention(cfg, q, k, v, mode)
        if mode == "prefill":
            kv = attn_lib.paged_fill_cache(kv, k, v, block_table,
                                           length=length) if paged \
                else _fill_cache(kv, k, v, window=window, length=length)
        return out, kv

    def _cross(self, cfg: ArchConfig, x: torch.Tensor,
               memory) -> torch.Tensor:
        """What comes between the self-attention and the feed-forward:
        nothing here, a ``dec`` block's cross-attention there."""
        return x

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, mode: str = "train",
                state: BlockState | None = None,
                length: torch.Tensor | None = None,
                offset: torch.Tensor | None = None,
                block_table: torch.Tensor | None = None,
                memory: torch.Tensor | None = None):
        """One block (``repro.models.transformer.apply_block`` for
        ``kind`` in attn/local/enc/dec).  mode: train|prefill|decode.  In
        decode a 0/1 ``length`` is the activity mask.  ``memory``: the
        encoder's output, which a ``dec`` block attends to.  Returns (x,
        new_state, load_balance): the last an MoE's float32 term in train
        mode, else None."""
        h = self._normed(cfg, "ln1", x)
        q, k, v = attn_lib.qkv_project(
            self.attn, h, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            positions, rope_theta=cfg.rope_theta,
            use_rope=self.kind != "enc")
        if state is None:
            out = self._self_attention(cfg, q, k, v, mode)
            kv = None
        else:
            out, kv = spmd.attention(
                functools.partial(self._attend, cfg=cfg, mode=mode), mode,
                q, k, v, state.kv, length, offset, block_table,
                prompt=lambda q, k, v: self._self_attention(cfg, q, k, v,
                                                            mode),
                window=cfg.window if self.kind == "local" else 0)
        o = spmd.merge_heads(out)
        x = spmd.settle(x + torch.matmul(o, self.attn["wo"].to(x.dtype)),
                        positions)
        x = self._cross(cfg, x, memory)
        y, lb = _ffn(cfg, self.ffn, self._normed(cfg, "ln2", x), mode)
        return spmd.settle(x + y, positions), \
            None if state is None else state._replace(kv=kv), lb


class DecBlock(AttnBlock):
    """An encoder-decoder's decoder block: causal self-attention with
    RoPE, then ``ln_x`` and cross-attention (``xattn``: projections
    without biases or qk-norm) over the encoder's memory, then the
    feed-forward.  It runs in every mode: in prefill and decode its
    self-attention keeps a dense KV cache as an ``attn`` block's, and the
    cross-attention reads the memory passed in."""
    NORMS = ("ln1", "ln_x", "ln2")
    PARTS = ("attn", "xattn", "ffn")

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 train: bool = False):
        super().__init__(cfg, "dec", device, train)
        self.ln_x, self.ln_x_bias = _norm_params(cfg, device, train)
        self.xattn = _attn_params(cfg, torch_dtype(cfg.compute_dtype),
                                  device, train, bias=False, qk_norm=False)

    def _cross(self, cfg: ArchConfig, x: torch.Tensor,
               memory) -> torch.Tensor:
        """Cross-attention over ``memory`` (B,Sm,D) in every mode, always
        through ``flash_attention_xla``, non-causal: the JAX package calls
        it with no ``impl``, so it takes the XLA route on every backend.
        K/V are projected from ``memory`` on every call (the reference
        keeps no cross-K/V cache: its ``state.cross_kv`` is None)."""
        hx = self._normed(cfg, "ln_x", x)
        qx, _, _ = attn_lib.qkv_project(
            self.xattn, hx, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            None, rope_theta=cfg.rope_theta, use_rope=False)
        _, ck, cv = attn_lib.qkv_project(
            self.xattn, memory, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, None, rope_theta=cfg.rope_theta, use_rope=False)
        xo = spmd.self_attention(functools.partial(
            attn_lib.flash_attention_xla, causal=False), qx, ck, cv)
        xo = spmd.merge_heads(xo)
        return x + torch.matmul(xo, self.xattn["wo"].to(x.dtype))


class RecBlock(_Block):
    """Pre-norm residual block: the Griffin recurrent block (conv + RG-LRU),
    then the feed-forward.  The gate matrices are stored in the dtype
    ``rglru_core`` multiplies in (compute dtype when dense, float32 when
    block-diagonal); ``lambda`` stays float32."""
    NORMS = ("ln1", "ln2")
    PARTS = ("rec", "ffn")

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 train: bool = False):
        super().__init__()
        self.kind = "rec"
        cd = torch_dtype(cfg.compute_dtype)
        f32 = torch.float32
        gate_dt = f32 if cfg.rglru_gate_blocks else cd
        shapes = rec_lib.rglru_param_shapes(cfg.d_model, cfg.d_rnn,
                                            cfg.d_conv, cfg.rglru_gate_blocks)
        dtypes = {"w_a": gate_dt, "w_i": gate_dt, "lambda": f32}
        self.ln1, self.ln1_bias = _norm_params(cfg, device, train)
        self.rec = nn.ParameterDict({
            name: _weight(*shape, dtype=dtypes.get(name, cd), device=device,
                          train=train)
            for name, shape in shapes.items()})
        self.ln2, self.ln2_bias = _norm_params(cfg, device, train)
        self.ffn = _ffn_params(cfg, cd, device, train)

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, mode: str = "train",
                state: BlockState | None = None,
                length: torch.Tensor | None = None,
                offset: torch.Tensor | None = None,
                block_table: torch.Tensor | None = None,
                memory: torch.Tensor | None = None):
        """``apply_block`` for ``kind == "rec"``: in prefill the state
        resumes from the carry (zeroed where offset == 0); in decode a 0/1
        ``length`` freezes conv and h of rows with 0.  Returns (x,
        new_state, None)."""
        h = self._normed(cfg, "ln1", x)
        chunk = _scan_chunk(cfg, mode, h)
        if mode == "train":
            y, _ = rec_lib.rglru_block(self.rec, h, scan_chunk=chunk)
        else:
            y, rec = rec_lib.rglru_block(
                self.rec, h, state=_resume_rec(state.rec, offset),
                length=length, scan_chunk=chunk)
            state = state._replace(rec=rec)
        x = spmd.settle(x + y, positions)
        y, _ = _ffn(cfg, self.ffn, self._normed(cfg, "ln2", x), mode)
        return spmd.settle(x + y, positions), state, None


class SsmBlock(_Block):
    """Pre-norm residual Mamba-1 block (``ln1`` only, no FFN).
    ``in_proj``, ``conv_w`` and ``out_proj`` are stored in the compute
    dtype, the parameters ``mamba_ssm`` reads in float32 in float32."""
    NORMS = ("ln1",)
    PARTS = ("ssm",)

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 train: bool = False):
        super().__init__()
        self.kind = "ssm"
        cd = torch_dtype(cfg.compute_dtype)
        self.dt_rank = cfg.dt_rank or max(1, cfg.d_model // 16)
        shapes = rec_lib.mamba_param_shapes(cfg.d_model, cfg.d_inner,
                                            cfg.d_state, cfg.d_conv,
                                            self.dt_rank)
        self.ln1, self.ln1_bias = _norm_params(cfg, device, train)
        self.ssm = nn.ParameterDict({
            name: _weight(*shape, device=device, train=train,
                          dtype=torch.float32 if name in rec_lib.MAMBA_F32
                          else cd)
            for name, shape in shapes.items()})

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, mode: str = "train",
                state: BlockState | None = None,
                length: torch.Tensor | None = None,
                offset: torch.Tensor | None = None,
                block_table: torch.Tensor | None = None,
                memory: torch.Tensor | None = None):
        """``apply_block`` for ``kind == "ssm"``: in prefill the state
        resumes from the carry (zeroed where offset == 0); in decode a 0/1
        ``length`` freezes conv and h of rows with 0.  Returns (x,
        new_state, None)."""
        h = self._normed(cfg, "ln1", x)
        kw = dict(d_state=cfg.d_state, dt_rank=self.dt_rank,
                  scan_chunk=_scan_chunk(cfg, mode, h))
        if mode == "train":
            y, _ = rec_lib.mamba_block(self.ssm, h, **kw)
        else:
            y, rec = rec_lib.mamba_block(
                self.ssm, h, state=_resume_rec(state.rec, offset),
                length=length, **kw)
            state = state._replace(rec=rec)
        return spmd.settle(x + y, positions), state, None


def _resume_rec(rec: dict | None,
                offset: torch.Tensor | None) -> dict | None:
    """The carried conv/h state for a (possibly resumed) prefill chunk: a
    slot prefilled from scratch (offset == 0) may hold a previous request's
    residue, so it is zeroed per row; rows with offset > 0 keep theirs."""
    if rec is None or offset is None:
        return rec
    live = offset > 0
    return {k: torch.where(live.reshape((-1,) + (1,) * (a.dim() - 1)), a,
                           torch.zeros_like(a))
            for k, a in rec.items()}


def _fill_cache(cache: attn_lib.KVCache, k: torch.Tensor, v: torch.Tensor,
                window: int = 0,
                length: torch.Tensor | None = None) -> attn_lib.KVCache:
    """Write prefill K/V into a dense cache, IN PLACE: left-aligned, or the
    window's ring.  ``length``: (B,) valid prefix lengths of right-padded
    k/v.  Entries past ``length`` may hold padding garbage: they sit where
    decode writes before its validity mask admits them."""
    b, s = k.shape[0], k.shape[1]
    smax = cache.k.shape[1]
    if length is not None and window:
        # ring layout: slot j holds the last real position p < length with
        # p % smax == j (garbage slots are masked or overwritten downstream)
        last = length.long()[:, None] - 1
        j = torch.arange(smax, device=k.device)[None, :]
        p = (last - ((last - j) % smax)).clamp(0, s - 1)
        idx = p[:, :, None, None].expand(-1, -1, *k.shape[2:])
        cache.k.copy_(torch.gather(k, 1, idx))
        cache.v.copy_(torch.gather(v, 1, idx))
        return cache._replace(length=(cache.length + length).to(torch.int32))
    if window and s > smax:
        k, v = k[:, -smax:], v[:, -smax:]
        s = smax
    cache.k[:, :s] = k
    cache.v[:, :s] = v
    new_len = cache.length + (s if length is None else length)
    return cache._replace(length=new_len.to(torch.int32))


def _init_tree(tree: nn.ParameterDict, normal, zero) -> None:
    """A block part's leaves as the JAX package draws them: the matrices
    (``w*``) and an MoE's ``router`` normal with std 1/sqrt(shape[0]) — an
    (E, D, F) expert bank draws 1/sqrt(E), as the reference's
    ``fan_in_init`` — biases zero, a nested tree (the shared expert)
    alike."""
    for name, p in tree.items():
        if isinstance(p, nn.ParameterDict):
            _init_tree(p, normal, zero)
        elif name.startswith("w") or name == "router":
            normal(p, fan_in_std(tuple(p.shape)))
        else:
            zero(p)


class Model(nn.Module):
    """A decoder (behind an encoder where ``cfg.enc_layers``) for one
    ``ArchConfig`` on one device.  ``train``: hold float32 masters that
    require their gradients (see the module's docstring)."""

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda",
                 *, train: bool = False):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.kinds = cfg.layer_kinds
        self.device = resolve_device(device, build=True)
        self.trainable = train
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        f32, dev = torch.float32, self.device
        self.embed = _weight(cfg.vocab_padded, cfg.d_model, dtype=f32,
                             device=dev, train=train)
        self.final_norm, self.final_norm_bias = _norm_params(cfg, dev, train)
        self.lm_head = None if cfg.tie_embeddings else _weight(
            cfg.vocab_padded, cfg.d_model, dtype=f32, device=dev, train=train)
        self.mm_proj = None if not cfg.modality_tokens else nn.ParameterDict({
            "w1": _weight(cfg.modality_dim, cfg.d_model,
                          dtype=self.compute_dtype, device=dev, train=train),
            "w2": _weight(cfg.d_model, cfg.d_model,
                          dtype=self.compute_dtype, device=dev, train=train)})
        self.layers = nn.ModuleList(
            RecBlock(cfg, dev, train) if kind == "rec"
            else SsmBlock(cfg, dev, train) if kind == "ssm"
            else DecBlock(cfg, dev, train) if kind == "dec"
            else AttnBlock(cfg, kind, dev, train) for kind in self.kinds)
        self.encoder = nn.ModuleList(
            AttnBlock(cfg, "enc", dev, train) for _ in range(cfg.enc_layers))
        self.enc_norm, self.enc_norm_bias = \
            _norm_params(cfg, dev, train) if cfg.is_encdec else (None, None)

    def with_config(self, cfg: ArchConfig) -> "Model":
        """This model under ``cfg``, over the same parameter tensors (no
        copy): a serving phase's model (``launch.serve.build_engine``).
        ``cfg`` may differ from ``self.cfg`` only in the runtime-safe knobs
        (``core.executor.RUNTIME_SAFE_KEYS``), which leave every
        parameter's shape as it is; ``self`` when nothing differs."""
        from ..core.executor import RUNTIME_SAFE_KEYS
        if cfg == self.cfg:
            return self
        changed = {f.name for f in dataclasses.fields(cfg)
                   if getattr(cfg, f.name) != getattr(self.cfg, f.name)}
        unsafe = sorted(changed - RUNTIME_SAFE_KEYS)
        if unsafe:
            raise ValueError(f"{cfg.name}: a phase model shares the "
                             f"parameters, so it may change only runtime-"
                             f"safe knobs, not {unsafe}")
        phase = copy.copy(self)         # the same submodules and parameters
        phase.cfg = cfg
        return phase

    # ------------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, generator: torch.Generator, sink=copy_into) -> "Model":
        """Random weights with the JAX package's distributions (normal,
        std 1/sqrt(fan_in), the embedding and ``lm_head`` 1/sqrt(d_model);
        RMSNorm scales 0, LayerNorm scales 1, biases 0; the RG-LRU's
        ``init_rglru_block``, Mamba's ``init_mamba_block``), drawn from
        ``generator``.  Every parameter is drawn whole, in float32, on the
        generator's device, in one fixed order, and handed to ``sink(p,
        value)`` once; the default copies it into ``p``.  A model built on
        ``meta`` is filled by a sink that keeps each rank's part
        (``launch.shardings.build_distributed_model``)."""
        dev = generator.device

        def normal(p: torch.Tensor, std: float) -> None:
            w = torch.empty(p.shape, dtype=torch.float32, device=dev)
            w.normal_(0.0, std, generator=generator)
            sink(p, w)

        def zero(p: torch.Tensor) -> None:
            sink(p, torch.zeros(p.shape, device=dev))

        normal(self.embed, 1.0 / self.cfg.d_model ** 0.5)
        if self.lm_head is not None:
            normal(self.lm_head, 1.0 / self.cfg.d_model ** 0.5)
        if self.mm_proj is not None:
            for p in self.mm_proj.values():
                normal(p, fan_in_std(tuple(p.shape)))
        _init_norm(sink, self.final_norm, self.final_norm_bias, dev)
        if self.enc_norm is not None:
            _init_norm(sink, self.enc_norm, self.enc_norm_bias, dev)
        for blk in [*self.layers, *self.encoder]:
            for norm in blk.NORMS:
                _init_norm(sink, getattr(blk, norm),
                           getattr(blk, norm + "_bias"), dev)
            if isinstance(blk, SsmBlock):
                rec_lib.init_mamba_block(blk.ssm, generator, sink)
                trees = ()
            elif isinstance(blk, RecBlock):
                rec_lib.init_rglru_block(blk.rec, generator, sink)
                trees = (blk.ffn,)
            else:
                trees = [getattr(blk, part) for part in blk.PARTS]
            for tree in trees:
                _init_tree(tree, normal, zero)
        return self

    # -------------------------------------------------------------- backbone
    def _embed(self, tokens: torch.Tensor,
               modality: torch.Tensor | None = None) -> torch.Tensor:
        """The scaled token embeddings; with ``modality`` (B,M,
        modality_dim) on a model with the stub, the projected modality
        tokens (``mm_proj``: w1, tanh GELU, w2, in the compute dtype)
        first (``repro.models.transformer.Model._embed_inputs``)."""
        cd = self.compute_dtype
        x = spmd.settle(embed_scaled(self.embed, tokens, cd, self.cfg.d_model),
                        tokens)
        if modality is not None and self.mm_proj is not None:
            m = torch.matmul(modality.to(cd), self.mm_proj["w1"].to(cd))
            m = torch.matmul(gelu(m), self.mm_proj["w2"].to(cd))
            x = torch.cat([m, x], dim=1)
        return x

    def _logits(self, x: torch.Tensor, *,
                padded: bool = False) -> torch.Tensor:
        """Float32 logits: (..., vocab_size), or with ``padded`` all
        ``vocab_padded`` columns (a vocab-sharded table's, uncut)."""
        x = _norm(self.cfg, x, self.final_norm, self.final_norm_bias)
        table = self.embed if self.lm_head is None else self.lm_head
        logits = unembed(x, table)
        return logits if padded else logits[..., :self.cfg.vocab_size]

    def encode(self, src_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder's memory (B,Sm,D) in the compute dtype:
        ``src_embeds`` (B,Sm,D) through the ``enc`` blocks (non-causal
        self-attention, through the flash wrapper with autograd off), then
        ``enc_norm`` (``repro.models.transformer.Model._encode``).  Serving
        passes it to ``prefill`` and ``decode_step`` as ``memory=``."""
        x = src_embeds.to(self.compute_dtype)
        positions = spmd.positions(x, None, x.shape[1])
        for blk in self.encoder:
            x, _, _ = blk(self.cfg, x, positions)
        return _norm(self.cfg, x, self.enc_norm, self.enc_norm_bias)

    def _forward(self, tokens: torch.Tensor,
                 modality: torch.Tensor | None = None,
                 src_embeds: torch.Tensor | None = None, *,
                 padded: bool = False):
        """``train_forward``'s logits (``padded``: see ``_logits``) and the
        load-balance terms summed over the layers (None without an MoE
        feed-forward)."""
        memory = None
        if self.cfg.is_encdec:
            if src_embeds is None:
                raise ValueError(f"{self.cfg.name}: an encoder-decoder "
                                 f"needs src_embeds")
            memory = self.encode(src_embeds)
        x = self._embed(tokens, modality)
        positions = spmd.positions(tokens, None, x.shape[1])
        lb_total = None
        for blk in self.layers:
            x, _, lb = blk(self.cfg, x, positions, memory=memory)
            if lb is not None:
                lb_total = lb if lb_total is None else lb_total + lb
        logits = self._logits(x, padded=padded)
        if modality is not None and self.mm_proj is not None:
            logits = logits[:, modality.shape[1]:]
        return logits, lb_total

    def train_forward(self, tokens: torch.Tensor,
                      modality: torch.Tensor | None = None,
                      src_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Full-sequence logits: (B,S) -> (B,S,V) float32, through the
        differentiable routes while autograd records.  With ``modality``
        the projected modality tokens go first and their logits are
        dropped; an encoder-decoder needs ``src_embeds`` (B,Sm,D)."""
        return self._forward(tokens, modality, src_embeds)[0]

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                modality: torch.Tensor | None = None,
                src_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """``train_forward`` with autograd off: every attention and scan
        goes through its kernel wrapper (the cross-attention excepted)."""
        return self.train_forward(tokens, modality, src_embeds)

    def loss(self, batch: dict):
        """Next-token cross-entropy of ``batch`` (``tokens``, ``labels``
        and optional ``mask``, ``modality``, ``src_embeds``), as
        ``repro.models.transformer.Model.loss``: returns (loss, {"ce_loss",
        "loss"}), under the caller's autograd mode.  An MoE model adds
        ``0.01`` times its load-balance term, averaged over the layers,
        and reports that average as ``load_balance``.  On a mesh (DTensor
        parameters and batch) the loss is a replicated 0-d DTensor, and
        vocab-sharded logits are never gathered whole
        (``spmd.cross_entropy``)."""
        logits, lb = self._forward(batch["tokens"], batch.get("modality"),
                                   batch.get("src_embeds"), padded=True)
        loss = vocab_cross_entropy(logits, batch["labels"], batch.get("mask"),
                                   self.cfg.vocab_size)
        metrics = {"ce_loss": loss}
        if lb is not None:
            lb = lb / max(self.cfg.num_layers, 1)
            loss = loss + 0.01 * lb
            metrics["load_balance"] = lb
        metrics["loss"] = loss
        return loss, metrics

    # ----------------------------------------------------------- serving path
    def init_block_state(self, i: int, batch: int,
                         max_len: int) -> BlockState:
        """Zeroed dense state of layer ``i`` for ``batch`` slots: a
        ``max_len`` cache (``attn``, and a ``dec`` layer's
        self-attention), a ``min(max_len, window)`` ring
        (``local``), or the conv context and float32 h (``rec``: (B, d_rnn);
        ``ssm``: (B, d_inner, d_state))."""
        cfg = self.cfg
        kind = self.kinds[i]
        if kind in ("rec", "ssm"):
            width = cfg.d_rnn if kind == "rec" else cfg.d_inner
            h = (batch, width) if kind == "rec" \
                else (batch, width, cfg.d_state)
            return BlockState(rec={
                "conv": torch.zeros((batch, cfg.d_conv - 1, width),
                                    dtype=self.compute_dtype,
                                    device=self.device),
                "h": torch.zeros(h, dtype=torch.float32,
                                 device=self.device)})
        smax = min(max_len, cfg.window) if kind == "local" else max_len
        return BlockState(kv=attn_lib.init_kv_cache(
            batch, smax, cfg.num_kv_heads, cfg.head_dim, self.compute_dtype,
            self.device))

    def init_states(self, batch: int, max_len: int, *,
                    kv_block_size: int | None = None,
                    kv_blocks: int | None = None) -> list[BlockState]:
        """One ``BlockState`` per layer.  With ``kv_block_size``, every
        ``attn`` layer keeps its KV in a ``PagedKVCache`` of ``kv_blocks``
        blocks of ``kv_block_size`` tokens (default: the dense equivalent,
        batch * max_len / kv_block_size) and zero lengths — the layers'
        pools are views into one allocation; window rings and recurrent
        states stay dense (``init_block_state``).  An encoder-decoder's
        ``dec`` layers keep a dense ``max_len`` cache each, as the JAX
        package's ``init_states`` lays one out; the memory they
        cross-attend to is no state (it is passed to each call)."""
        cfg = self.cfg
        if cfg.is_encdec and kv_block_size is not None:
            raise NotImplementedError(
                f"{cfg.name}: the port keeps an encoder-decoder's KV dense "
                f"(no engine serves one, so none pages it)")
        paged = [i for i, kind in enumerate(self.kinds) if kind == "attn"] \
            if kv_block_size is not None else []
        pools = {}
        if paged:
            if kv_blocks is None:
                kv_blocks = batch * (-(-max_len // kv_block_size))
            shape = (len(paged), kv_blocks, kv_block_size, cfg.num_kv_heads,
                     cfg.head_dim)
            k = torch.zeros(shape, dtype=self.compute_dtype,
                            device=self.device)
            v = torch.zeros(shape, dtype=self.compute_dtype,
                            device=self.device)
            length = torch.zeros((batch,), dtype=torch.int32,
                                 device=self.device)
            pools = {i: BlockState(kv=attn_lib.PagedKVCache(
                k[j], v[j], length.clone())) for j, i in enumerate(paged)}
        return [pools[i] if i in pools
                else self.init_block_state(i, batch, max_len)
                for i in range(cfg.num_layers)]

    def _run(self, states, x, positions, mode, length=None, offset=None,
             block_table=None, memory=None):
        if self.cfg.is_encdec and memory is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder's prefill "
                             f"and decode steps need memory= (encode's "
                             f"output)")
        new_states = []
        for blk, st in zip(self.layers, states):
            x, st, _ = blk(self.cfg, x, positions, mode=mode, state=st,
                           length=length, offset=offset,
                           block_table=block_table, memory=memory)
            new_states.append(st)
        return x, new_states

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, states, *,
                modality: torch.Tensor | None = None,
                length: torch.Tensor | None = None,
                offset: torch.Tensor | None = None,
                block_table: torch.Tensor | None = None,
                memory: torch.Tensor | None = None):
        """Process a right-padded prompt batch; fill its states; return the
        logits at position ``length - 1`` (B,1,V) and the new states.

        ``modality``: (B,M,modality_dim) patch embeddings projected into M
        tokens ahead of ``tokens`` (the positions, the caches and
        ``length`` then count them too).
        ``offset``: (B,) tokens already in ``states`` when ``tokens`` is one
        chunk of a longer prompt (requires ``length``; decoder-only token
        models only, as the JAX package's); recurrent states resume from
        their carry (zeroed where offset == 0).
        ``block_table``: (B, max_len/bs), required for paged states.
        ``memory``: an encoder-decoder's memory (B,Sm,D), ``encode``'s
        output, which every ``dec`` layer cross-attends to.  The JAX
        ``prefill`` encodes ``src_embeds`` itself and returns the memory
        as a third output; here the caller encodes once and passes the
        memory to ``prefill`` and each ``decode_step``, and ``prefill``
        keeps its two outputs."""
        if offset is not None:
            if length is None:
                raise ValueError("chunked prefill (offset=...) needs length")
            if self.cfg.modality_tokens or self.cfg.is_encdec:
                raise NotImplementedError(
                    "chunked prefill supports decoder-only token models")
        x = self._embed(tokens, modality)
        positions = spmd.positions(tokens, offset, x.shape[1])
        x, states = self._run(states, x, positions, "prefill", length,
                              offset, block_table, memory)
        return self._logits(spmd.last_rows(x, length)), states

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, states,
                    position: torch.Tensor, *,
                    active: torch.Tensor | None = None,
                    block_table: torch.Tensor | None = None,
                    memory: torch.Tensor | None = None):
        """token: (B,1) at ``position`` (B,) -> logits (B,1,V), states.
        Rows with ``active`` False leave every piece of their state (KV and
        length, conv context, recurrent h) bit-for-bit unchanged (their
        logits are garbage).  ``memory``: an encoder-decoder's memory, as
        in ``prefill``; the cross-attention's K/V are projected from it
        every step, as the JAX package's are."""
        x = self._embed(token)
        positions = position[:, None].long().expand(token.shape)
        length = None if active is None else active.to(torch.int32)
        x, states = self._run(states, x, positions, "decode", length,
                              block_table=block_table, memory=memory)
        return self._logits(x), states


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda",
                seed: int | None = None, *, train: bool = False) -> Model:
    """A model on ``device`` (``train``: float32 masters with gradients);
    with ``seed``, random weights drawn from a generator on that device
    seeded with it."""
    model = Model(cfg, device, train=train)
    if seed is not None:
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        model.init(gen)
    return model
