"""Model assembly for the port: decoder-only stacks of ``attn`` blocks with a
GLU feed-forward (qwen3-0.6b and its family).  Every other block or
feed-forward kind raises ``NotImplementedError`` until its slice lands.

The PyTorch counterpart of ``repro.models.transformer.Model``, with the
weights held by the module instead of passed as a pytree:

  * ``forward``      — full-sequence logits.
  * ``init_states``  — one paged KV pool per layer.
  * ``prefill`` / ``decode_step`` — the serving path, through block tables.

Parameters are stored the way the JAX package computes with them: matmul
weights in the compute dtype (JAX casts its float32 masters per call, which
gives the same values), norm scales and the tied embedding table in float32
(``rms_norm`` and ``unembed`` read them in float32).  ``H·hd`` need not equal
``d_model``: ``wo`` is ``(H·hd, d_model)``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import attention as attn_lib
from .common import embed_scaled, fan_in_std, rms_norm, torch_dtype, unembed
from .ffn import glu_ffn
from .model_config import ArchConfig


def _check_supported(cfg: ArchConfig) -> None:
    kinds = set(cfg.layer_kinds)
    if kinds != {"attn"} or cfg.ffn_kind != "glu" or cfg.norm != "rms" \
            or cfg.is_encdec or cfg.modality_tokens or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: the port serves decoder-only 'attn' stacks with a "
            f"GLU feed-forward, RMSNorm and tied embeddings; block kinds "
            f"{sorted(kinds)}, ffn {cfg.ffn_kind!r}, norm {cfg.norm!r} come "
            f"in a later slice")


def _weight(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class AttnBlock(nn.Module):
    """Pre-norm residual block: GQA self-attention, then the GLU FFN."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
        hkv = cfg.num_kv_heads * cfg.head_dim
        cd = torch_dtype(cfg.compute_dtype)
        f32 = torch.float32
        self.ln1 = _weight(d, dtype=f32, device=device)
        self.attn = nn.ParameterDict({
            "wq": _weight(d, hq, dtype=cd, device=device),
            "wk": _weight(d, hkv, dtype=cd, device=device),
            "wv": _weight(d, hkv, dtype=cd, device=device),
            "wo": _weight(hq, d, dtype=cd, device=device),
        })
        if cfg.qkv_bias:
            self.attn.update({
                "bq": _weight(hq, dtype=cd, device=device),
                "bk": _weight(hkv, dtype=cd, device=device),
                "bv": _weight(hkv, dtype=cd, device=device)})
        if cfg.qk_norm:
            self.attn.update({
                "q_norm": _weight(cfg.head_dim, dtype=f32, device=device),
                "k_norm": _weight(cfg.head_dim, dtype=f32, device=device)})
        self.ln2 = _weight(d, dtype=f32, device=device)
        self.ffn = nn.ParameterDict({
            "w_gate": _weight(d, cfg.d_ff, dtype=cd, device=device),
            "w_up": _weight(d, cfg.d_ff, dtype=cd, device=device),
            "w_down": _weight(cfg.d_ff, d, dtype=cd, device=device),
        })

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, mode: str = "train",
                state: attn_lib.PagedKVCache | None = None,
                length: torch.Tensor | None = None,
                offset: torch.Tensor | None = None,
                block_table: torch.Tensor | None = None):
        """One block (``repro.models.transformer.apply_block`` for
        ``kind == "attn"``).  mode: train|prefill|decode.  In decode a 0/1
        ``length`` is the activity mask.  Returns (x, new_state)."""
        h = rms_norm(x, self.ln1)
        q, k, v = attn_lib.qkv_project(
            self.attn, h, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            positions, rope_theta=cfg.rope_theta)
        new_state = state
        if mode == "decode":
            wm = None if length is None else length > 0
            out, new_state = attn_lib.paged_decode_attention(
                q, k, v, state, block_table, write_mask=wm)
        elif mode == "prefill" and offset is not None:
            out, new_state = attn_lib.paged_chunk_attention(
                q, k, v, state, block_table, offset=offset, length=length)
        else:
            out = attn_lib.flash_attention(q, k, v, causal=True)
            if mode == "prefill":
                new_state = attn_lib.paged_fill_cache(
                    state, k, v, block_table, length=length)
        b, s = out.shape[:2]
        o = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
        x = x + torch.matmul(o, self.attn["wo"])
        x = x + glu_ffn(self.ffn, rms_norm(x, self.ln2), cfg.activation)
        return x, new_state


class Model(nn.Module):
    """Decoder-only LM for one ``ArchConfig`` on one device."""

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda"):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        f32 = torch.float32
        self.embed = _weight(cfg.vocab_padded, cfg.d_model, dtype=f32,
                             device=self.device)
        self.final_norm = _weight(cfg.d_model, dtype=f32, device=self.device)
        self.layers = nn.ModuleList(AttnBlock(cfg, self.device)
                                    for _ in range(cfg.num_layers))

    # ------------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights with the JAX package's distributions (normal,
        std 1/sqrt(fan_in); norm scales 0, biases 0), drawn from
        ``generator`` — which lives on the model's device."""
        def normal(p: torch.Tensor, std: float) -> None:
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            w.normal_(0.0, std, generator=generator)
            p.copy_(w)

        normal(self.embed, 1.0 / self.cfg.d_model ** 0.5)
        self.final_norm.zero_()
        for blk in self.layers:
            blk.ln1.zero_()
            blk.ln2.zero_()
            for tree in (blk.attn, blk.ffn):
                for name, p in tree.items():
                    if name.startswith("w"):
                        normal(p, fan_in_std(tuple(p.shape)))
                    else:
                        p.zero_()
        return self

    # -------------------------------------------------------------- backbone
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_scaled(self.embed, tokens, self.compute_dtype,
                            self.cfg.d_model)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm)
        return unembed(x, self.embed)[..., :self.cfg.vocab_size]

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits: (B,S) -> (B,S,V) float32."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[:2])
        for blk in self.layers:
            x, _ = blk(self.cfg, x, positions)
        return self._logits(x)

    # ----------------------------------------------------------- serving path
    def init_states(self, batch: int, max_len: int, *,
                    kv_block_size: int | None = None,
                    kv_blocks: int | None = None
                    ) -> list[attn_lib.PagedKVCache]:
        """One ``PagedKVCache`` per layer: ``kv_blocks`` blocks of
        ``kv_block_size`` tokens (default: the dense equivalent,
        batch * max_len / kv_block_size) and zero lengths.  The layers'
        pools are views into one allocation."""
        if kv_block_size is None:
            raise NotImplementedError(
                "the port keeps KV in the paged pool only; pass "
                "kv_block_size (dense per-slot caches come in a later slice)")
        cfg = self.cfg
        if kv_blocks is None:
            kv_blocks = batch * (-(-max_len // kv_block_size))
        shape = (cfg.num_layers, kv_blocks, kv_block_size, cfg.num_kv_heads,
                 cfg.head_dim)
        k = torch.zeros(shape, dtype=self.compute_dtype, device=self.device)
        v = torch.zeros(shape, dtype=self.compute_dtype, device=self.device)
        length = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        return [attn_lib.PagedKVCache(k[i], v[i], length.clone())
                for i in range(cfg.num_layers)]

    def _run(self, states, x, positions, mode, length=None, offset=None,
             block_table=None):
        new_states = []
        for blk, st in zip(self.layers, states):
            x, st = blk(self.cfg, x, positions, mode=mode, state=st,
                              length=length, offset=offset,
                              block_table=block_table)
            new_states.append(st)
        return x, new_states

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, states, *,
                length: torch.Tensor | None = None,
                offset: torch.Tensor | None = None,
                block_table: torch.Tensor):
        """Process a right-padded prompt batch; write its K/V; return the
        logits at position ``length - 1`` (B,1,V) and the new states.

        ``offset``: (B,) tokens already cached when ``tokens`` is one chunk
        of a longer prompt (requires ``length``)."""
        if offset is not None and length is None:
            raise ValueError("chunked prefill (offset=...) needs length")
        x = self._embed(tokens)
        base = torch.arange(x.shape[1], device=x.device)[None]
        positions = base.expand(x.shape[:2]) if offset is None \
            else offset[:, None].long() + base
        x, states = self._run(states, x, positions, "prefill", length,
                              offset, block_table)
        if length is None:
            x_last = x[:, -1:]
        else:
            rows = torch.arange(x.shape[0], device=x.device)
            x_last = x[rows, (length.long() - 1).clamp(min=0)][:, None]
        return self._logits(x_last), states

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, states,
                    position: torch.Tensor, *,
                    active: torch.Tensor | None = None,
                    block_table: torch.Tensor):
        """token: (B,1) at ``position`` (B,) -> logits (B,1,V), states.
        Rows with ``active`` False leave their KV and length bit-for-bit
        unchanged (their logits are garbage)."""
        x = self._embed(token)
        positions = position[:, None].long().expand(token.shape)
        length = None if active is None else active.to(torch.int32)
        x, states = self._run(states, x, positions, "decode", length,
                              block_table=block_table)
        return self._logits(x), states


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda",
                seed: int | None = None) -> Model:
    """A model on ``device``; with ``seed``, random weights drawn from a
    generator on that device seeded with it."""
    model = Model(cfg, device)
    if seed is not None:
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        model.init(gen)
    return model
