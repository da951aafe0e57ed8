"""The 10 assigned architecture configs (exact dims from the assignment table)
plus ``reduced_config`` for CPU tests — a copy of ``repro.configs.archs``
without the JAX package's execution knobs (``scan_chunk`` aside, which the
placement oracle reads).

Sources ([source; verified-tier] per assignment):
  recurrentgemma-2b   [arXiv:2402.19427; hf]   hybrid RG-LRU + local attn, 1:2
  qwen3-0.6b          [hf:Qwen/Qwen3-8B; hf]   qk_norm, GQA
  starcoder2-7b       [arXiv:2402.19173; hf]   GQA, RoPE, layernorm+MLP
  smollm-135m         [hf:HuggingFaceTB/SmolLM-135M; hf]  llama-arch small
  qwen2-0.5b          [arXiv:2407.10671; hf]   GQA, QKV bias
  internvl2-2b        [arXiv:2404.16821; hf]   InternViT stub + InternLM2
  phi3.5-moe-42b      [hf:microsoft/Phi-3.5-MoE-instruct; hf]  16e top-2
  llama4-scout-17b    [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 16e top-1
  seamless-m4t-medium [arXiv:2308.11596; hf]   enc-dec, audio-frontend stub
  falcon-mamba-7b     [arXiv:2410.05355; unverified]  mamba1, attn-free
"""
from __future__ import annotations

from ..models.model_config import ArchConfig

RECURRENTGEMMA_2B = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    block_pattern=("rec", "rec", "local"),   # 1 attn : 2 recurrent
    ffn_kind="glu", activation="gelu", norm="rms",
    window=2048, d_rnn=2560, d_conv=4,
    rope_theta=10000.0, tie_embeddings=True)

QWEN3_0_6B = ArchConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    ffn_kind="glu", activation="silu", norm="rms", qk_norm=True,
    rope_theta=1000000.0, tie_embeddings=True)

STARCODER2_7B = ArchConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4, head_dim=128,
    d_ff=18432, vocab_size=49152,
    ffn_kind="mlp", activation="gelu", norm="layer", qkv_bias=True,
    rope_theta=100000.0, tie_embeddings=True)

SMOLLM_135M = ArchConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3, head_dim=64,
    d_ff=1536, vocab_size=49152,
    ffn_kind="glu", activation="silu", norm="rms",
    rope_theta=10000.0, tie_embeddings=True)

QWEN2_0_5B = ArchConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    ffn_kind="glu", activation="silu", norm="rms", qkv_bias=True,
    rope_theta=1000000.0, tie_embeddings=True)

INTERNVL2_2B = ArchConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553,
    ffn_kind="glu", activation="silu", norm="rms",
    rope_theta=1000000.0, tie_embeddings=False,
    modality_tokens=256, modality_dim=1024)   # InternViT patch embeds (stub)

PHI35_MOE = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    ffn_kind="moe", num_experts=16, top_k=2, activation="silu", norm="layer",
    rope_theta=10000.0, tie_embeddings=False)

LLAMA4_SCOUT = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    ffn_kind="moe", num_experts=16, top_k=1, moe_shared_expert=True,
    activation="silu", norm="rms",
    rope_theta=500000.0, tie_embeddings=False)

SEAMLESS_M4T_MEDIUM = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    block_pattern=("dec",), enc_layers=12,
    ffn_kind="mlp", activation="relu", norm="layer",
    rope_theta=10000.0, tie_embeddings=True,
    modality_tokens=0, modality_dim=1024)     # encoder takes frame embeds

FALCON_MAMBA_7B = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    block_pattern=("ssm",), ffn_kind="none",
    d_inner=8192, d_state=16, d_conv=4, dt_rank=256,
    tie_embeddings=True)

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    RECURRENTGEMMA_2B, QWEN3_0_6B, STARCODER2_7B, SMOLLM_135M, QWEN2_0_5B,
    INTERNVL2_2B, PHI35_MOE, LLAMA4_SCOUT, SEAMLESS_M4T_MEDIUM,
    FALCON_MAMBA_7B]}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ArchConfig:
    """Same family/topology, tiny dims — for CPU tests.  Keeps every
    structural feature (pattern, GQA ratio, qk-norm, biases, MoE top-k,
    shared expert, enc-dec, modality stub) while shrinking width/depth;
    the widths equal ``repro.configs.reduced_config``'s, so one set of
    weights serves both packages."""
    c = get_config(name)
    pat = len(c.block_pattern)
    layers = max(pat + (1 if c.num_layers % pat else 0), 2 * pat) \
        if pat > 1 else 2
    if c.num_layers % pat:
        layers = pat + (c.num_layers % pat)      # exercise the tail path
    kw = dict(
        num_layers=layers,
        d_model=64,
        d_ff=128 if c.d_ff else 0,
        vocab_size=512,
        scan_chunk=16,
        window=16 if c.window else 0,
    )
    if c.num_heads:
        # keep the GQA ratio
        ratio = max(1, c.num_heads // max(c.num_kv_heads, 1))
        kw["num_kv_heads"] = 2 if c.num_kv_heads > 1 else 1
        kw["num_heads"] = kw["num_kv_heads"] * ratio
        kw["head_dim"] = 16
    if c.d_rnn:
        kw["d_rnn"] = 64
    if c.d_inner:
        kw["d_inner"] = 128
        kw["d_state"] = 4
        kw["dt_rank"] = 8
    if c.num_experts:
        kw["num_experts"] = 4
        kw["top_k"] = min(c.top_k, 2)
        # capacity >= all tokens: no drops, so decode == forward exactly
        kw["moe_capacity"] = 4.0 / kw["top_k"]
    if c.enc_layers:
        kw["enc_layers"] = 2
    if c.modality_tokens:
        kw["modality_tokens"] = 8
        kw["modality_dim"] = 32
    if c.is_encdec:
        kw["modality_dim"] = 64                   # frame embeds at d_model
    return c.replace(**kw)
