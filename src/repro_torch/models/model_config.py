"""Architecture configuration — every assigned arch is an ``ArchConfig``.

A copy of ``repro.models.model_config.ArchConfig`` (the port imports nothing
from the JAX package).  The JAX package's execution knobs (remat, scan
unrolling, flash block size, and the ``*_impl`` kernel-variant switches) are
left out: the port has no tracer to unroll for, and its kernel wrappers pick
the kernel or the plain version from the device of the tensors they get.
``moe_impl`` stays: it picks a function, not a kernel variant — the
``ragged`` route never drops a token, the two capacity routes do
(``models/moe.py``).
``scan_chunk`` stays: it bounds a recurrent cluster's prefill chunk in the
placement oracle (``serve/placement.py``), and it is the chunk of
``chunked_linear_scan``, the recurrences' differentiable route in training
(as ``_chunked_linear_scan``'s in the JAX package).
``LEFT_OUT_KNOBS`` names the knobs left out; an execution profile
(``core/executor.py``) that sets one of them changes nothing here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

#: the JAX package's ``ArchConfig`` fields that this copy leaves out by
#: design: ``remat`` (the port never recomputes activations), ``unroll_scans``
#: (no tracer to unroll for), ``attn_block_kv`` and ``attn_f32`` (the flash
#: kernel's own tiling and float32 accumulators), and the kernel-variant
#: switches ``attn_impl``, ``rglru_impl`` and ``ssm_impl`` (the wrappers pick
#: the kernel or the plain version by the tensor's device)
LEFT_OUT_KNOBS = ("remat", "unroll_scans", "attn_block_kv", "attn_f32",
                  "attn_impl", "rglru_impl", "ssm_impl")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # block structure: per-layer kind cycles through this pattern
    block_pattern: tuple[str, ...] = ("attn",)   # attn|local|rec|ssm|dec
    ffn_kind: str = "glu"             # glu|mlp|moe|none
    activation: str = "silu"
    norm: str = "rms"                 # rms|layer
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0                   # sliding-window size for "local" blocks
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_shared_expert: bool = False
    moe_capacity: float = 1.25
    moe_impl: str = "einsum"          # einsum | scatter | ragged (see moe.py)
    # recurrent dims
    rglru_gate_blocks: int = 0        # 0 = dense gates; >0 = block-diagonal
    d_rnn: int = 0                    # RG-LRU width
    d_inner: int = 0                  # Mamba inner width
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0
    # encoder-decoder
    enc_layers: int = 0               # >0 => encoder-decoder (dec uses num_layers)
    # modality frontend stub (assignment: precomputed frame/patch embeddings)
    modality_tokens: int = 0
    modality_dim: int = 0
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_chunk: int = 512             # recurrence chunk (train, placement)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        return tuple(self.block_pattern[i % len(self.block_pattern)]
                     for i in range(self.num_layers))

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a multiple of 16, as the JAX package
        pads them (its weights bridge over row for row)."""
        return -(-self.vocab_size // 16) * 16

    @property
    def sub_quadratic(self) -> bool:
        """True when no block needs a full-length dense KV cache — the
        assignment's criterion for running long_500k."""
        return all(k in ("rec", "ssm", "local") for k in set(self.layer_kinds))

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameters of the dense/hybrid/ssm stacks (MoE counts every
        expert)."""
        d, h = self.d_model, self.num_heads * self.head_dim
        kv = self.num_kv_heads * self.head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_kind = {}
        per_kind["attn"] = per_kind["local"] = d * h + 2 * d * kv + h * d
        per_kind["dec"] = 2 * per_kind["attn"]
        per_kind["rec"] = (2 * self.d_rnn * self.d_rnn
                           + 2 * self.d_model * self.d_rnn
                           + self.d_rnn * self.d_model + 5 * self.d_rnn)
        dtr = self.dt_rank or max(1, d // 16)
        per_kind["ssm"] = (2 * d * self.d_inner
                           + self.d_inner * (dtr + 2 * self.d_state)
                           + dtr * self.d_inner + self.d_inner * d
                           + (self.d_conv + self.d_state + 2) * self.d_inner)
        if self.ffn_kind == "glu":
            ffn = 3 * d * self.d_ff
        elif self.ffn_kind == "mlp":
            ffn = 2 * d * self.d_ff
        elif self.ffn_kind == "moe":
            ffn = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
            if self.moe_shared_expert:
                ffn += 3 * d * self.d_ff
        else:
            ffn = 0
        for k in self.layer_kinds:
            n += per_kind[k] + (ffn if k != "ssm" else 0)
        if self.is_encdec:
            n += self.enc_layers * (per_kind["attn"] + ffn)
        if self.modality_tokens:
            n += self.modality_dim * d + d * d   # 2-layer projector
        return n
