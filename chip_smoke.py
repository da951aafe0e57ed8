#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--parent DIR]

Phases, one line or block of output each; any failure exits non-zero:

1. device — the card's name, count, and ``nvidia-smi`` name / power limit;
2. build  — the seven CUDA kernels from ``src/repro_torch/csrc``, in
   parallel, with ``nvcc -Xptxas -v``'s registers / shared memory / spills;
3. kernels — each kernel against its plain PyTorch version on the card at
   the paths' shapes, bf16 and float32, with the stated tolerance (flash
   also at recurrentgemma's hd=256, 10 q heads over 1 kv head, and with a
   window that binds, and flash and paged decode at the heads of
   qwen2-0.5b, smollm-135m, starcoder2-7b and internvl2-2b: GQA groups of
   7, 3, 9 and 2 at hd 64 and 128, flash at serving's buckets 16-256, and
   at the heads of phi3.5-moe and llama4-scout, groups of 4 and 5 at hd
   128, and at the heads one rank of a (1, 4) mesh computes for them,
   8 q over 2 kv and 10 q over 2 kv at hd 128 in bf16; the
   selective scan with a carried state and ragged lengths that include a
   frozen row; the Pascal matmul at the edge zoo's TR1 hoisted input GEMMs,
   in bf16 on its tensor-core route and at a ragged shape on its SIMT
   route, the Jacquard GEMV at its FC widths, the LSTM recurrence (one
   cooperative launch a call) at H=2048 and the ragged H=2900, with and
   without a carried state); then times (CUDA events, L2 flushed before
   each launch, the median of 21 calls, min and max on the line before the
   row): kernel, plain version, a PyTorch call as a yardstick
   (``scaled_dot_product_attention`` for flash, ``torch.matmul`` for the
   GEMM and GEMV, cuDNN's ``torch.nn.LSTM`` for a whole LSTM layer), and
   the least time the card could take (bytes and operations against the
   published H100 SXM peaks); flash in bf16 (its tensor-core route) at
   S=64, 256 and 1024 and at recurrentgemma's local layer and at each new
   arch's heads (S=256, and S=64 at hd 64 and for the MoE archs and their
   (1, 4) ranks' heads), and in float32 (its SIMT
   route); paged decode at 8 slots of up to 1024 tokens (qwen3's heads,
   each new arch's and the MoE archs' (1, 4) ranks') and at 16 slots of up to 8192 (a byte bound clear of
   the timing floor); the RG-LRU and the selective scan at their prefill
   shapes (B=4 and B=1, T=256) and decode shape (B=4, T=1, also with the L2
   left warm); the GEMV at M=1 1280 -> 8192 and M=4 640 -> 4096 in both
   dtypes.  With ``--parent DIR`` (an unpacked checkout of an earlier
   commit) phase 2 also builds that tree's two scan kernels and phase 3
   times them beside these, in the same run;
4. layer parity — full-width qwen3-0.6b cut to 2 layers, full-width
   recurrentgemma-2b cut to 3 (rec, rec, local), full-width falcon-mamba-7b
   cut to 2, and full-width qwen2-0.5b, smollm-135m, starcoder2-7b and
   internvl2-2b cut to 2 (paged KV), and full-width phi3.5-moe cut to 2
   and llama4-scout cut to 1 (paged KV; ~11.5 and ~17 GB a side), float32:
   prefill and 4 decode steps on the CPU (plain versions) and on the card
   (kernels) from the same weights, logits held within a stated
   tolerance; an MoE's routing (top-k indices and keep mask) compared
   call by call, a flip allowed only at a near-tie and printed;
5. edge LSTM stack — the LSTM layers of the edge zoo's mobile RNN-T
   (``TR1_rnnt_mobile``) at full width, float32, random weights from the
   seed: its encoder cut to 2 layers on the CPU (plain versions) and on the
   card (kernels), held within a stated tolerance; then on the card, with
   the launch counters set to 0 just before, the whole 8-layer encoder over
   T=200 and the 2-layer prediction network over U=20, once as one call and
   once as 20 single steps carrying (h, c), which must agree bit for bit;
6. placement and serve — first the paper's Mensa pipeline on the port's
   copies (``repro_torch.core``): the 24 edge models characterized,
   clustered, scheduled and evaluated (every number of the paper's modeled
   accelerators, none of the card), and each served arch's rule clusters
   held against a seeded k-means; then the execution-strategy layer
   (``core/{strategy,executor}.py``): every arch x shape of ``configs``,
   full and reduced, priced on a 16 x 16 mesh of H100 SXM cards (a model
   from the datasheet, not the card), one ``[strategy]`` line a cell, each
   block's template legal and the least of its candidates before phase 2,
   and exactly the reduced MoE decode cells raising the reference's
   ``ValueError``; then nine paths through
   ``launch.serve.build_engine`` with ``policy="auto"`` (the placement
   oracle's plan: characterize -> cluster -> cost; its buckets and chunk)
   and ``plan_cfg=get_config(arch)``, random weights from the seed.  Each
   build (and each pair's) must go through
   ``phase_profiles(get_config(arch))`` once, with no runtime-safe
   override in either phase, so that its prefill and decode models are
   its model; each prints the profiles.  Each run's launch counters are set to 0
   just before it and read just after, and must be the path's own (flash
   168 and paged 924; flash 32 and RG-LRU 1350, 1116 of them decode; SSM
   4480, 3968 of them decode; for every paged attention stack one flash
   launch a layer and prefill call and one paged launch a layer and decode
   step).  Each prints its plan, the predicted (modeled) and measured (the
   card's) phase times and their drift, and its whole stats summary; each
   model is released before the next is built.  a.-c. then serve the same
   requests again, on the same model, through a disaggregated
   prefill/decode pair (``launch.serve.build_disagg_engine``, 2 prefill
   slots, 4 decode slots, both roles on the card, suitcase handoff): the
   tokens must be the interleaved run's, one handoff a request with none
   pending, its launches (counted from 0 just before it) the interleaved
   run's, and, on qwen3, the prefix hit rate the interleaved run's, a
   block copied and the decode pool drained; each prints its handoff time,
   stalls, per-role tokens/s and both runs' decode TBT p50 / p99.  After
   each serve, and for each role of each pair, one ``[programs]`` line a
   program that ran (the summary's ``programs`` section: its analytic
   FLOPs and bytes, invocations, mean ms, and shares of the H100's
   FLOP/s and bytes/s at the compute dtype), which must hold: every
   warmed program registered; ``decode`` invocations = decode steps, the
   ``prefill[...]`` ones summing to the prefill calls, ``chunk`` = chunks,
   ``copy`` = copied blocks, ``export`` / ``import`` = handoffs; every
   nonzero share in (0, 1.05].  Every meshless serve and pair runs its
   programs as CUDA graphs captured at warmup (``ServeEngine``'s
   ``cuda_graphs``, the default): every program of the engine's table must
   be a graph and none may be compiled after warmup, and a ``[graphs]``
   line gives the graphs, their capture seconds, the pool's bytes and the
   decode ticks' median.  qwen3-0.6b, recurrentgemma-2b, falcon-mamba-7b
   and the phi3.5-moe cut then serve the same requests once more with
   ``cuda_graphs=False``, outside the paths' launch totals: every token
   (greedy and sampled) and the launches must be the graphed run's, and a
   ``[graphs]`` line sets the two decode medians side by side; qwen3's
   decode window is profiled on both routes (the card's idle share), and
   falcon-mamba's graphed: each profiled window must show the card running
   every port kernel as often as its launch counter moved
   (``PROFILED_KERNELS``).
   qwen3-0.6b serves (all runs) with
   ``program_memory=True``: its largest temp (the allocator's watermark
   around each warmup call) must be above 0, printed beside
   ``torch.cuda.max_memory_allocated()``:
   a. full-width qwen3-0.6b, all 28 layers: paged KV, prefix cache,
      bucketed and chunked prefill, greedy and sampled decode;
   b. full-width recurrentgemma-2b, all 26 layers: dense KV (2048-token
      window rings), a 2300-token prompt chunked across the window, decode
      past it, a recycled slot, greedy and sampled decode;
   c. full-width falcon-mamba-7b, all 64 ssm layers: conv and scan states
      per slot, a 1000-token prompt in 4 chunks, a recycled slot, greedy
      and sampled decode;
   d. full-width qwen2-0.5b, smollm-135m and starcoder2-7b (7.17 B
      parameters), all layers, as a.; and internvl2-2b, all 24 layers,
      text only through its untied head, with a bucket ladder up to
      max_len and no prefix cache: like the JAX package's, its model
      cannot chunk a prompt;
   e. full-width phi3.5-moe-42b-a6.6b cut to 16 of 32 layers and
      llama4-scout-17b-a16e cut to 8 of 48 (neither fits the card whole),
      as a.: the einsum route multiplies every expert's bank each tick;
      each prints its decode step, tokens/s, TTFT, peak memory and the
      expert-bank bytes a tick reads beside their time at 3.35 TB/s, and
      the decode capacity (1 per expert at 4 slots: a tick drops every
      second assignment to an expert, as the reference does);
6b. mesh serve — a.-c. again (qwen3-0.6b, recurrentgemma-2b,
   falcon-mamba-7b), at full width from the same seed with the same
   requests, on ``launch.mesh.make_serve_mesh()`` (one card: a 1-rank
   NCCL group, data 1 x model 1) through ``build_engine(mesh=...,
   param_strategy=...)``, "tp" then "auto": the parameters and states
   DTensors, each kernel on its shard under ``local_map``.  Each run must
   give phase 6's meshless tokens and launches (flash 168 and paged 924;
   flash 32 and RG-LRU 1350; SSM 4480) and every check ``serve_auto``
   makes, and prints its decode step beside the meshless one's.  Then the
   serving CLI at full width (qwen3-0.6b, 8 requests) with ``--mesh off``
   and with ``--mesh auto`` under ``torch.distributed.run --standalone``,
   one process a card; on a machine of n >= 2 cards also qwen3-0.6b at
   (n/2)x2 and 1xn and falcon-mamba-7b at 1xn (``mesh_cli_cases``): every
   run must exit 0 and each mesh's tokens equal ``--mesh off``'s;
6c. roles — the disaggregated pair with each role on its own cards
   (``--roles``).  On one card the pair cannot run (one NCCL rank a card):
   the CLI with ``--roles prefill=1,decode=1`` must exit non-zero with the
   reference's "need 2 devices, have 1".  On n >= 2 cards the CLI at full
   width (8 requests of 16 tokens, warmed up) serves qwen3-0.6b (paged, prefix
   cache), recurrentgemma-2b (dense KV) and falcon-mamba-7b at
   ``--roles prefill=1,decode=1`` under ``torch.distributed.run``, one
   process a card (this script's ``--serve-worker`` mode: the CLI's
   ``main`` with the launch counters set to 0 just before it, then each
   rank's counts), and with four cards qwen3-0.6b also at
   ``prefill=2,decode=2`` and at ``prefill=1,decode=1 --mp 2``
   (``role_cli_cases``): each run must exit 0 with ``--roles off``'s
   tokens, one handoff a request and none pending, and disjoint launches —
   the prefill ranks no paged decode and no T = 1 scan, the decode ranks
   no flash and only T = 1 scans;
6d. context-parallel serve — a. full-width qwen3-0.6b (28 layers),
   recurrentgemma-2b (26) and falcon-mamba-7b (64), bf16, weights from the
   seed: 4 right-padded prompts of 3,000-3,100 tokens (past
   recurrentgemma's 2048-slot rings, which wrap) in one-shot ``prefill``
   calls with ``length`` into 8192-slot states, then 32 greedy
   ``decode_step`` calls with one row frozen (``active`` False) for one
   step; once meshless and once on a 1-rank NCCL mesh
   (``make_host_mesh((1, 1))``) with states laid out by
   ``shardings.state_specs`` (each KV cache's sequence on ``model``) and
   placed by ``place_states``: the tokens equal, the logits within the
   bf16 flash tolerance, the frozen row's state bit for bit unchanged, the
   launches equal and the path's own (one flash launch a self-attention
   layer, one scan a recurrent layer a call; the dense decode attention
   is plain PyTorch, as the reference's), the decode step's median
   printed beside the meshless one's (``[cp]`` lines); b. full-width
   seamless-m4t-medium (12 + 12 layers, vocab 256,206), in bf16 and once
   in float32: ``encode`` of 512 source frames, ``prefill(memory=)`` of
   2 x 64 tokens and 16 greedy ``decode_step(memory=)`` calls, every
   call's logits held to the same model's no-grad ``forward`` over the
   same tokens (teacher-forced) within ``tests/test_models_smoke.py``'s
   5e-2, the prefill's flash
   launches 12 non-causal (the encoder) and 12 causal (the decoder); then
   a 2 + 2-layer float32 cut, encode, prefill and 4 decode steps, CPU
   against card within the parity tolerance; c. on n >= 2 cards the three
   paths of a. cut to 2 layers (recurrentgemma 3), float32, on (1, n) and,
   with four cards, (n/2, 2) meshes, each a launch of its own under
   ``torch.distributed.run`` (this script's ``--cp-worker DPxMP`` mode):
   every rank's tokens equal its card's meshless run's, the sequence
   really split (a rank's KV shard holds fewer slots than the cache, and
   ``models/spmd.context_attention`` ran); d. the dry run's serving cells
   (qwen3-0.6b ``prefill_32k`` and ``decode_32k`` on the single-pod mesh,
   recurrentgemma-2b ``long_500k``), each in a process of its own started
   after the timed runs (``[dryrun]`` lines: FLOPs a device, collectives
   by kind, wire bytes, a rank's argument and state bytes against the
   card's memory);
6f. MoE on a mesh — a. each MoE cut of 6e (phi3.5-moe 16 layers,
   llama4-scout 8) served again, 6e's model released first, through
   ``build_engine(mesh=make_serve_mesh())`` on a 1-rank NCCL group: its
   weights drawn shard by shard from the seed
   (``launch.shardings.build_distributed_model``: each parameter drawn
   whole on the card, its part kept), 6e's requests; its tokens and
   launches must be 6e's; each MoE call's routing is then recorded
   (``record_moe_routes``) in a second drive of the same requests on a
   second engine, never in a timed one (the recorder gathers and routes
   again at every MoE call), whose tokens must be the timed run's.  On
   n >= 4 cards, each run under
   ``torch.distributed.run`` over four cards, one process a card: b. the
   same cuts on (1, 4) (this script's ``--moe-cut-worker`` mode, 6e's
   requests and build): every rank's launches 6e's, its tokens 6e's
   one-card tokens or, where bf16 sums in another order flip a routing
   decision, parted exactly where the routings first part at a near-tie
   (``BF16_ROUTE_MARGIN``, phase 4's rule, printed with the first
   divergent token); c. both archs at full depth (32 and 48 layers) on
   (1, 4) through the serving CLI (``--mp 4``; ``--moe-cli-worker``), and
   phi3.5-moe also on (2, 2) (``--mesh 2x2``), each rank drawing only
   its own shards: each run exits 0 with each rank's launches the path's
   own (one flash launch a layer and prefill call, one paged launch a
   layer and decode step), phi3.5's (2, 2) tokens its (1, 4) tokens or
   parted at a near-tie.  Every four-card run prints a ``[moe full]``
   line a rank: its parameter GiB beside the specs' count (which it must
   equal), ``torch.cuda.max_memory_allocated()``, the decode step median,
   tokens/s, TTFT and the expert-bank bytes a tick reads on a rank beside
   their time at 3.35 TB/s; the checks are made once every run has ended;
7. train — full-width qwen3-0.6b (28 layers, 3 steps) and
   seamless-m4t-medium (12 encoder + 12 decoder layers, vocab 256,206, 2
   steps) through ``launch.train.train_once`` on the card: bf16 compute on
   float32 masters, global batch 8 of 128 tokens in 2 microbatches; each
   step's loss, lr and grad norm, the median step, the peak memory and the
   parameter tensors that moved; the steps run under autograd (the
   differentiable routes) and launch no kernel, then a no-grad evaluation
   forward launches flash once a self-attention layer, the encoder's
   non-causal ones included.  Then reduced smollm-135m trains 12 steps
   twice, once failing at step 9 and auto-resuming from a checkpoint; the
   losses agree within a stated tolerance;
7b. train mesh — qwen3-0.6b's phase-7 run again (the same init, data,
   schedule and geometry) through ``make_train_step`` on DTensor
   parameters on a 1-rank NCCL mesh (``launch.mesh.make_host_mesh``,
   ``shardings.distribute_models``, a batch laid out by
   ``batch_specs``): its losses and grad norms within a stated tolerance
   of phase 7's, no launch under autograd; ``train.grad.compressed_psum``
   on the card's NCCL group equal to the host's gloo group bit for bit;
   the dry runs of qwen3-0.6b's ``train_4k`` cell on the reference's
   single- and multi-pod meshes (``launch/dryrun.py`` on a fake group of
   256 and 512 ranks, meta tensors, in processes of their own started
   after the timed mesh run): FLOPs a device, collectives and wire bytes,
   a rank's argument bytes against the card's memory.  On n >= 2 cards
   also 2-layer float32 qwen3-0.6b at full width on (n, 1) and (1, n)
   meshes, each a session under ``torch.distributed.run`` (this script's
   ``--train-worker`` mode), held to the same model's meshless
   ``make_train_step`` run on one card;
   ``compressed_psum`` over n NCCL ranks against gloo; a checkpoint saved
   on (n, 1) restored on (1, n) bit for bit;
8. examples — ``examples/quickstart_torch.py``,
   ``serve_edge_torch.py --arch qwen3-0.6b`` and ``train_lm_torch.py
   --full --steps 20 --fail-at 7`` (smollm-135m at full width), each in a
   process of its own on the card, its output printed: each must exit 0
   with its ``OK`` line, and train_lm must restart exactly once.

Phase 3 also checks flash non-causal (the encoder's self-attention) at
seamless-m4t-medium's heads, Sq == Skv and Sq != Skv, and times it; phase 4
also holds a 2 + 2-layer cut of seamless-m4t-medium's no-grad forward, CPU
against card, and one train step (accum 2, float32) of 3-layer
recurrentgemma-2b and 2-layer falcon-mamba-7b cuts at full width, batch 2
of 64 tokens, CPU against card: under autograd the scans run
``chunked_linear_scan`` on the card.

The last three lines: ``nvidia-smi``'s name and power limit, one JSON
object with a row per kernel, and ``{"ok": true, "device": {...}}``.  A
row's launches add every path's run in this process (phases 5, 6, 6b,
6d, 6f(a), 7 and 7b), each counted from 0 just before it; the
multi-card runs (6b's CLI, 6c, 6d(c), 6f(b, c), 7b) are processes of
their own, outside it.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: the dense decoders served beside qwen3: their GQA groups of 7, 3 and
#: 9 do not divide flash's 64 packed rows a tile, and hd 64 runs its
#: tensor-core route; internvl2-2b has qwen3's heads
NEW_ARCHS = ("qwen2-0.5b", "smollm-135m", "starcoder2-7b", "internvl2-2b")
#: the mixture-of-experts decoders: flash and paged decode at GQA groups
#: of 4 and 5, hd 128 (their expert products are torch.bmm: the reference
#: computes them in XLA, outside any Pallas kernel)
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
#: the encoder-decoder: its encoder runs flash non-causal
ENCDEC = "seamless-m4t-medium"
PAGED_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the RG-LRU kernel rounds a*h, then +b, as its plain loop does: float32
# agrees to the bit (checked with torch.equal as well); a bf16 output may
# differ by one ulp of |h| < 8
RGLRU_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -4}
# the selective scan takes ex2.approx of a pre-scaled a and one FMA for the
# decay and the add, where its plain loop takes the accurate exp and rounds
# them apart; the recurrence contracts, so h_T agrees to a few float32
# roundings.  y is a 17-term sum taken in another order: it agrees to a few
# float32 ulps of the output's scale (|y| reaches ~80 here), so SSM_Y_ULPS
# of max|y|; a bf16 y is one more rounding of that (one bf16 ulp, 2^-7 of
# |y|)
SSM_TOL = 1e-5
SSM_Y_ULPS = 8 * 2.0 ** -23
SSM_BF16_ULP = 2.0 ** -7
# float32 logits of a cut full-width model: the kernels and cuBLAS sum in
# other orders than the CPU, over d_model 1024 / 2560 / 4096 and vocab
# 151,936 / 256,000 / 65,024
LOGIT_TOL = 2e-3
# float32 routing of a full-width MoE cut, the CPU against the card: the
# router's probabilities part by ~1e-7 (a 4096-5120 long float32 dot over
# a normed input), so a top-k may flip only between experts whose CPU
# probabilities lie within this margin.  Its logits are held to LOGIT_TOL
# too: the residual stream grows to ~1e3-1e4 (the banks' fan-in init draws
# 1/sqrt(E), as the reference's), but the final norm rescales it, and its
# float32 error stays a relative one
ROUTE_MARGIN = 1e-5
# a float32 product summed over K in another order than its plain version
# (FMA chains against a multiply and an add): the rounding differences
# walk like sqrt(K) float32 ulps of the output's scale, so sqrt(K) ulps of
# max|y|; a bf16 output is one more rounding (one bf16 ulp, 2^-7 of |y|)
F32_ULP = 2.0 ** -23
BF16_ULP = 2.0 ** -7
# the LSTM recurrence vs its plain loop, float32: the cell update rounds
# alike, the dot products over H sum in another order each step; |h| < 1
# and |c| a few units over T=200
LSTM_TOL = 1e-4


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


class Laps:
    """The wall time of each stretch of ``main``, printed as it ends (and
    the whole so far), so that two runs can be compared phase by phase."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        say(f"[time] {name}: {now - self.t:.1f} s wall ({now - self.t0:.1f} "
            f"s since the device phase)")
        self.t = now


# --------------------------------------------------------------- 1. device
def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say(f"[device] {name}, {count} device(s); nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, count, smi


# ---------------------------------------------------------------- 2. build
#: the kernels whose earlier versions ``--parent`` times beside these
PARENT_KERNELS = ("pavlov_rglru", "pavlov_ssm")


def phase_build(parent: Path | None) -> dict:
    """Build the seven kernels (and, with ``parent``, that tree's two scans,
    compiled at the same time into ``build/kernels/parent/``); return the
    parent's loaded libraries by kernel name."""
    import ctypes
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    procs = {}
    try:
        if parent is not None:
            csrc = parent / "src" / "repro_torch" / "csrc"
            out = build.BUILD_DIR / "parent"
            out.mkdir(parents=True, exist_ok=True)
            for name in PARENT_KERNELS:
                so = out / f"{name}.so"
                cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
                       str(so), str(csrc / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), so)
        logs = build.build(["flash_attention", "paged_attention",
                            "pavlov_rglru", "pavlov_ssm", "pascal_matmul",
                            "jacquard_gemv", "pavlov_lstm"])
        parent_libs = {}
        for name, (proc, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                fail(f"the parent's {name} did not build:\n{log[-3000:]}")
            logs[f"parent {name}"] = log
            parent_libs[name] = ctypes.CDLL(str(so))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    say(f"[build] {len(logs)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s (sm_90a, into {build.BUILD_DIR})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line:
                say(f"[build] {name}: {line.strip()}")
    return parent_libs


# -------------------------------------------------------------- 3. kernels
#: GPU clock cycles the card spins before each timed call (about 1 ms):
#: the host enqueues the call meanwhile, so the events time the card's work
#: and not the host's launch path (a ctypes launch takes tens of µs, as long
#: as a small kernel runs)
SPIN_CYCLES = 2_000_000


#: calls timed for each number: their median, so one stall does not move it
TIMED_CALLS = 21


def time_ms(what: str, fn, flush) -> float:
    """Median ms per call over :data:`TIMED_CALLS` calls, CUDA events around
    each call, the L2 cache flushed before each one; after 3 warm calls.
    Prints the median, min and max on a line of its own."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_CALLS):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    med = times[len(times) // 2]
    say(f"[time] {what}: median {med:.4f} ms of {TIMED_CALLS} calls (min "
        f"{times[0]:.4f}, max {times[-1]:.4f})")
    return med


def time_parent(what: str, module, lib, fn, flush) -> float:
    """``fn`` timed with ``module``'s kernel library swapped for the parent
    tree's ``lib`` (the same C entry), then the module's own restored."""
    own = module.load
    module.load = lambda name: lib
    try:
        return time_ms(f"{what}, parent kernel", fn, flush)
    finally:
        module.load = own


def bound_ms(nbytes: float, flops: float, dtype: str):
    """The least time of the work on the card: bytes over the HBM rate or
    operations over the peak for ``dtype`` (``repro_torch.core.h100``: the
    published H100 SXM peaks, dense, at a 700 W limit), whichever is
    larger, in ms, and which of the two it is."""
    from repro_torch.core.h100 import for_dtype
    chip = for_dtype(dtype)
    t_bytes = nbytes / chip.hbm_bw
    t_ops = flops / chip.peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_case(b, s, h, kvh, hd, window, dtype, gen, causal=True, skv=None):
    """One flash call against its plain version (``skv`` KV positions, S by
    default): the inputs and max|kernel - plain|."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_raw,
                                                     flash_attention_ref)
    dt = getattr(torch, dtype)
    skv = s if skv is None else skv
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, skv, kvh, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, skv, kvh, hd), generator=gen, device="cuda").to(dt)
    out = flash_attention_raw(q, k, v, causal=causal, window=window)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    return (q, k, v), err


def phase_kernels(seed: int, card: str, parent: dict):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_raw,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_attention import (
        paged_attention_ref, paged_decode_attention, paged_decode_attention_raw)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    rows = {}
    # what one launch of a 1-element kernel reads on these events: the
    # floor under every time below
    tiny = torch.zeros(1, device="cuda")
    floor = time_ms("timing floor", tiny.zero_, flush)
    say(f"[kernel] on {card}: timing floor (a 1-element kernel): "
        f"{floor:.4f} ms")

    def flash_times(b, s, h, kvh, hd, window, dtype, causal=True) -> dict:
        """One flash call at these shapes (causal, or every query over
        every key): its error against the plain version, and the
        kernel's, the plain version's and
        ``scaled_dot_product_attention``'s times beside the bound."""
        assert window == 0 or window >= s   # SDPA's causal mask is the same
        (q, k, v), err = flash_case(b, s, h, kvh, hd, window, dtype, gen,
                                    causal=causal)
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4.0 * b * h * hd * pairs
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        what = (f"flash {dtype} B={b} S={s} H={h} KVH={kvh} hd={hd}"
                + (f" window={window}" if window else ""))
        ms = time_ms(f"{what}, kernel", lambda: flash_attention_raw(
            q, k, v, causal=causal, window=window), flush)
        plain = time_ms(f"{what}, plain", lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), flush)
        # the yardstick gets K/V already repeated to H heads (not timed)
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
                  for x in (k, v))
        lib = time_ms(f"{what}, sdpa", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), flush)
        bnd, by = bound_ms(nbytes, flops, dtype)
        say(f"[kernel] on {card}: {what} "
            f"{'causal' if causal else 'non-causal'}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms "
            f"({by}); max|kernel-plain|={err:.3e}")
        if not err <= FLASH_TOL[dtype]:
            fail(f"flash kernel disagrees with its plain version ({err})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                    bound_ms=bnd, bound_by=by)

    # ---- flash: B=4, H=16, KVH=8, hd=128, causal; serving's prefill
    # buckets, a window and a ragged S
    b, h, kvh, hd = 4, 16, 8, 128
    for dtype in ("bfloat16", "float32"):
        for s, window in ((16, 0), (32, 0), (64, 0), (128, 0), (256, 0),
                          (1024, 0), (256, 64), (100, 0)):
            _, err = flash_case(b, s, h, kvh, hd, window, dtype, gen)
            tol = FLASH_TOL[dtype]
            say(f"[kernel] flash {dtype} B={b} S={s} H={h} KVH={kvh} "
                f"hd={hd} window={window}: max|kernel-plain|={err:.3e} "
                f"(tol {tol})")
            if not err <= tol:
                fail(f"flash kernel disagrees with its plain version "
                     f"({err} > {tol})")
    # timed: bf16 (the tensor-core route) at qwen3's heads for S=256 (the
    # row), S=1024 and a small bucket (S=64), and at recurrentgemma's local
    # layer; float32 (the SIMT route) at S=256
    rows["flash"] = flash_times(b, 256, h, kvh, hd, 0, "bfloat16")
    rows["flash"]["routes"] = {
        "bfloat16": "tensor cores: wgmma, TMA K/V ring, packed GQA heads",
        "float32": "SIMT: register-tiled float32 FMAs (4 x 4 S micro-tiles, "
                   "packed GQA heads), cp.async K/V ring"}
    rows["flash"]["more_bfloat16"] = {
        "S=1024": flash_times(b, 1024, h, kvh, hd, 0, "bfloat16"),
        "S=64": flash_times(b, 64, h, kvh, hd, 0, "bfloat16"),
        "recurrentgemma local S=256": flash_times(4, 256, 10, 1, 256, 2048,
                                                  "bfloat16")}
    rows["flash"]["float32"] = flash_times(b, 256, h, kvh, hd, 0, "float32")

    # ---- paged: 8 slots, bs=16, lengths over 0..1023, sentinel entries
    slots, bs, nb = 8, 16, 1024 // 16
    n_blocks = slots * nb
    lengths = torch.linspace(0, 1023, slots, device="cuda").round().int()
    lengths[1] = 15                     # a write at the end of a block
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    table = torch.full((slots, nb), n_blocks, dtype=torch.int32,
                       device="cuda")
    used = 0
    for i, ln in enumerate(lengths.tolist()):
        own = ln // bs + 1
        table[i, :own] = perm[used:used + own].int()
        used += own
    write = torch.ones(slots, dtype=torch.bool, device="cuda")
    write[3] = False                    # a dropped write: sentinel row entry
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q = torch.randn((slots, 1, h, hd), generator=gen,
                        device="cuda").to(dt)
        nk = torch.randn((slots, 1, kvh, hd), generator=gen,
                         device="cuda").to(dt)
        nv = torch.randn((slots, 1, kvh, hd), generator=gen,
                         device="cuda").to(dt)
        kp = torch.randn((n_blocks, bs, kvh, hd), generator=gen,
                         device="cuda").to(dt)
        vp = torch.randn((n_blocks, bs, kvh, hd), generator=gen,
                         device="cuda").to(dt)
        wtable = torch.where(write[:, None], table,
                             torch.full_like(table, n_blocks))
        kp_cpu, vp_cpu = kp.cpu(), vp.cpu()
        out, kp, vp = paged_decode_attention(q, nk, nv, kp, vp, wtable,
                                             lengths)
        out_c, kp_cpu, vp_cpu = paged_decode_attention(
            q.cpu(), nk.cpu(), nv.cpu(), kp_cpu, vp_cpu, wtable.cpu(),
            lengths.cpu())
        if not (torch.equal(kp.cpu(), kp_cpu)
                and torch.equal(vp.cpu(), vp_cpu)):
            fail("paged scatter on the card differs from the CPU's")
        clamped = table.clamp(max=n_blocks - 1)
        q0 = q[:, 0].contiguous()
        got = paged_decode_attention_raw(q0, kp, vp, clamped, lengths)
        ref = paged_attention_ref(q0, kp, vp, clamped, lengths)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        err_cpu = (out.cpu().float() - out_c.float()).abs().max().item()
        tol = PAGED_TOL[dtype]
        say(f"[kernel] paged {dtype} slots={slots} bs={bs} H={h} KVH={kvh} "
            f"hd={hd} lengths={lengths.tolist()}: max|kernel-plain|="
            f"{err:.3e}, vs CPU plain {err_cpu:.3e} (tol {tol})")
        if not (err <= tol and err_cpu <= tol):
            fail(f"paged kernel disagrees with its plain version "
                 f"({err}, {err_cpu} > {tol})")
        if dtype == "bfloat16":
            live = int((lengths.long() + 1).sum())
            item = 2
            nbytes = (2.0 * live * kvh * hd * item + 2 * q0.numel() * item
                      + 4 * (table.numel() + slots))
            flops = 4.0 * h * hd * live
            what = f"paged bf16 ({live} live tokens)"
            ms = time_ms(f"{what}, kernel", lambda: paged_decode_attention_raw(
                q0, kp, vp, clamped, lengths), flush)
            plain = time_ms(f"{what}, plain", lambda: paged_attention_ref(
                q0, kp, vp, clamped, lengths), flush)
            bnd, by = bound_ms(nbytes, flops, "bfloat16")
            say(f"[kernel] on {card}: paged bf16 ({live} live tokens): kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms "
                f"({by}), timing floor {floor:.4f} ms")
            rows["paged"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 library_ms=None, bound_ms=bnd, bound_by=by)
    rows["paged"]["long"] = paged_long(gen, flush, card, floor)

    # ---- flash at recurrentgemma's local layers: hd=256, 10 q heads over 1
    # kv head; the serving window of 2048 (not binding at S=256) and one of
    # 128 that binds
    b, h, kvh, hd = 4, 10, 1, 256
    for dtype in ("bfloat16", "float32"):
        for s, window in ((256, 2048), (512, 128)):
            _, err = flash_case(b, s, h, kvh, hd, window, dtype, gen)
            tol = FLASH_TOL[dtype]
            say(f"[kernel] flash {dtype} B={b} S={s} H={h} KVH={kvh} "
                f"hd={hd} window={window}: max|kernel-plain|={err:.3e} "
                f"(tol {tol})")
            if not err <= tol:
                fail(f"flash kernel disagrees with its plain version at "
                     f"hd={hd} ({err} > {tol})")

    # ---- flash at the heads of slice 6's archs and the MoE archs:
    # serving's buckets 16-256 and a ragged S, both routes; then timed in
    # bf16 at S=256 (and S=64 at hd 64 and for the MoE archs)
    b = 4
    for arch in (*NEW_ARCHS, *MOE_ARCHS):
        h, kvh, hd = arch_heads(arch)
        for dtype in ("bfloat16", "float32"):
            errs = {}
            for s in (16, 32, 64, 128, 256, 100):
                _, errs[s] = flash_case(b, s, h, kvh, hd, 0, dtype, gen)
            tol = FLASH_TOL[dtype]
            say(f"[kernel] flash {dtype} {arch} heads B={b} H={h} KVH={kvh} "
                f"hd={hd}: max|kernel-plain| by S "
                + ", ".join(f"{s}: {e:.3e}" for s, e in errs.items())
                + f" (tol {tol})")
            if not max(errs.values()) <= tol:
                fail(f"flash kernel disagrees with its plain version at "
                     f"{arch}'s heads ({errs} > {tol})")
    rows["flash"]["archs"] = {}
    for arch in (*NEW_ARCHS, *MOE_ARCHS):
        h, kvh, hd = arch_heads(arch)
        rows["flash"]["archs"][f"{arch} S=256"] = flash_times(
            b, 256, h, kvh, hd, 0, "bfloat16")
        if hd == 64 or arch in MOE_ARCHS:
            rows["flash"]["archs"][f"{arch} S=64"] = flash_times(
                b, 64, h, kvh, hd, 0, "bfloat16")
    rows["paged"]["archs"] = {arch: paged_arch(gen, flush, card, floor, arch)
                              for arch in (*NEW_ARCHS, *MOE_ARCHS)}
    # ---- flash and paged decode at the heads one rank of a (1, 4) mesh
    # computes for the MoE archs at full depth (phase 6f): 8 q over 2 kv
    # and 10 q over 2 kv, hd 128, bf16
    for arch in MOE_ARCHS:
        h, kvh, hd = arch_heads(arch, MOE_MP)
        errs = {}
        for s in (16, 32, 64, 128, 256, 100):
            _, errs[s] = flash_case(b, s, h, kvh, hd, 0, "bfloat16", gen)
        tol = FLASH_TOL["bfloat16"]
        say(f"[kernel] flash bfloat16 {arch} heads of a rank of 1x{MOE_MP} "
            f"B={b} H={h} KVH={kvh} hd={hd}: max|kernel-plain| by S "
            + ", ".join(f"{s}: {e:.3e}" for s, e in errs.items())
            + f" (tol {tol})")
        if not max(errs.values()) <= tol:
            fail(f"flash kernel disagrees with its plain version at a "
                 f"rank's heads of {arch} ({errs} > {tol})")
        for s in (256, 64):
            rows["flash"]["archs"][f"{arch} 1x{MOE_MP} rank S={s}"] = \
                flash_times(b, s, h, kvh, hd, 0, "bfloat16")
        rows["paged"]["archs"][f"{arch} 1x{MOE_MP} rank"] = paged_arch(
            gen, flush, card, floor, arch, mp=MOE_MP)

    # ---- non-causal flash, as seamless-m4t-medium's encoder calls it (16
    # q heads over 16 kv heads of 64): Sq == Skv at the train phase's 128,
    # a ragged S, and Sq != Skv both ways; timed in bf16 at S=128 and 256
    h, kvh, hd = arch_heads(ENCDEC)
    for dtype in ("bfloat16", "float32"):
        errs = {}
        for sq, skv in ((128, 128), (256, 256), (100, 100), (37, 128),
                        (128, 40)):
            _, errs[(sq, skv)] = flash_case(b, sq, h, kvh, hd, 0, dtype, gen,
                                            causal=False, skv=skv)
        tol = FLASH_TOL[dtype]
        say(f"[kernel] flash {dtype} non-causal {ENCDEC} heads B={b} H={h} "
            f"KVH={kvh} hd={hd}: max|kernel-plain| by (Sq, Skv) "
            + ", ".join(f"{k}: {e:.3e}" for k, e in errs.items())
            + f" (tol {tol})")
        if not max(errs.values()) <= tol:
            fail(f"non-causal flash disagrees with its plain version "
                 f"({errs} > {tol})")
    rows["flash"]["noncausal"] = {
        f"{ENCDEC} encoder S={s}": flash_times(b, s, h, kvh, hd, 0,
                                               "bfloat16", causal=False)
        for s in (128, 256)}

    # ---- RG-LRU: B=4 slots, E = d_rnn = 2560; T=256 (a prefill bucket or
    # chunk), T=1 (decode) and a ragged T=100.  a in [0.9, 0.999] and
    # b ~ N(0, 1 - a^2), the ranges rglru_core gives them
    from repro_torch.kernels.pavlov_rglru import (kernel as rglru_kernel,
                                                  pavlov_rglru_raw,
                                                  pavlov_rglru_ref)
    b, e = 4, 2560

    def rglru_inputs(t, dtype, bb=b):
        a = torch.empty((bb, t, e), device="cuda").uniform_(
            0.9, 0.999, generator=gen)
        drive = torch.randn((bb, t, e), generator=gen, device="cuda") \
            * torch.sqrt(1.0 - a * a)
        return a.to(getattr(torch, dtype)), drive.to(getattr(torch, dtype))

    for dtype in ("float32", "bfloat16"):
        for t in (1, 256, 100):
            a, drive = rglru_inputs(t, dtype)
            out = pavlov_rglru_raw(a, drive)
            ref = pavlov_rglru_ref(a, drive)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = RGLRU_TOL[dtype]
            same = torch.equal(out, ref)
            say(f"[kernel] rglru {dtype} B={b} T={t} E={e}: "
                f"max|kernel-plain|={err:.3e} (tol {tol}), bit for bit: "
                f"{same}")
            if not err <= tol or (dtype == "float32" and not same):
                fail(f"RG-LRU kernel disagrees with its plain version "
                     f"({err} > {tol}, or float32 not bit for bit)")
            if dtype == "float32" and t == 256:
                rows["rglru"] = {"max_abs_err": err}
    # float32 (rglru_core builds a and b in f32): serving's prefill bucket,
    # a decode step and one row's prefill chunk
    for bb, t in ((4, 256), (4, 1), (1, 256)):
        a, drive = rglru_inputs(t, "float32", bb)
        what = f"rglru float32 B={bb} T={t} E={e}"
        run = lambda: pavlov_rglru_raw(a, drive)  # noqa: E731
        times = dict(ms=time_ms(f"{what}, kernel", run, flush))
        if "pavlov_rglru" in parent:
            times["parent_ms"] = time_parent(
                what, rglru_kernel, parent["pavlov_rglru"], run, flush)
        times["plain_ms"] = time_ms(f"{what}, plain",
                                    lambda: pavlov_rglru_ref(a, drive), flush)
        if t == 1:
            times["warm_l2_ms"] = time_ms(f"{what}, kernel, L2 not flushed",
                                          run, lambda: None)
        bnd, by = bound_ms(3.0 * bb * t * e * 4, 2.0 * bb * t * e, "float32")
        times.update(bound_ms=bnd, bound_by=by)
        say(f"[kernel] on {card}: {what}: {scan_times(times)}, bound "
            f"{bnd:.5f} ms ({by}), timing floor {floor:.4f} ms")
        if (bb, t) == (4, 256):
            rows["rglru"].update(library_ms=None, **times)
        elif t == 1:        # the decode launches' shape
            rows["rglru"]["decode_T1"] = times
        else:               # recurrentgemma's prefill chunks of one row
            rows["rglru"]["prefill_B1"] = times
    rows["ssm"] = ssm_kernel(gen, flush, card, floor, parent)
    rows["pascal"] = pascal_kernel(gen, flush, card)
    rows["jacquard"] = jacquard_kernel(gen, flush, card)
    rows["lstm"] = lstm_kernel(gen, flush, card)
    return rows


def arch_heads(arch: str, mp: int = 1) -> tuple:
    """(H, KVH, hd) of ``arch``, read from its config: at one rank of a
    ``model`` axis of ``mp`` (the heads split over it) with ``mp``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.num_heads // mp, cfg.num_kv_heads // mp, cfg.head_dim


def paged_arch(gen, flush, card: str, floor: float, arch: str,
               mp: int = 1) -> dict:
    """Paged decode at ``arch``'s heads (``arch_heads``; with ``mp``, one
    rank's of a ``model`` axis of ``mp``): 8 slots, blocks of 16, lengths
    over 0..1023 with one at a block's last position, scattered blocks;
    checked against the plain version in both dtypes, timed in bf16."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention_ref, paged_decode_attention_raw)
    h, kvh, hd = arch_heads(arch, mp)
    arch = arch if mp == 1 else f"{arch} 1x{mp} rank"
    slots, bs, nb = 8, 16, 1024 // 16
    n_blocks = slots * nb
    lengths = torch.linspace(0, 1023, slots, device="cuda").round().int()
    lengths[1] = 15
    table = torch.randperm(n_blocks, generator=gen, device="cuda").int() \
        .reshape(slots, nb)
    row = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q = torch.randn((slots, h, hd), generator=gen, device="cuda").to(dt)
        kp = torch.randn((n_blocks, bs, kvh, hd), generator=gen,
                         device="cuda").to(dt)
        vp = torch.randn((n_blocks, bs, kvh, hd), generator=gen,
                         device="cuda").to(dt)
        got = paged_decode_attention_raw(q, kp, vp, table, lengths)
        ref = paged_attention_ref(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = PAGED_TOL[dtype]
        say(f"[kernel] paged {dtype} {arch} heads slots={slots} bs={bs} "
            f"H={h} KVH={kvh} hd={hd}: max|kernel-plain|={err:.3e} (tol "
            f"{tol})")
        if not err <= tol:
            fail(f"paged kernel disagrees with its plain version at {arch}'s "
                 f"heads ({err} > {tol})")
        if dtype == "bfloat16":
            live = int((lengths.long() + 1).sum())
            nbytes = (2.0 * live * kvh * hd * 2 + 2 * q.numel() * 2
                      + 4 * (table.numel() + slots))
            what = f"paged bf16 {arch} heads ({live} live tokens)"
            ms = time_ms(f"{what}, kernel", lambda: paged_decode_attention_raw(
                q, kp, vp, table, lengths), flush)
            plain = time_ms(f"{what}, plain", lambda: paged_attention_ref(
                q, kp, vp, table, lengths), flush)
            bnd, by = bound_ms(nbytes, 4.0 * h * hd * live, "bfloat16")
            say(f"[kernel] on {card}: {what}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}), timing floor "
                f"{floor:.4f} ms")
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                       bound_ms=bnd, bound_by=by)
        else:
            row["max_abs_err_float32"] = err
    return row


def paged_long(gen, flush, card: str, floor: float) -> dict:
    """Paged decode, bf16, at a shape whose byte bound stands clear of the
    timing floor: 16 slots, H=16, KVH=8, hd=128 (qwen3's heads), blocks of
    16, lengths spread over 0..8191 (the pool holds 16 x 512 blocks, about
    0.54 GB); checked against the plain version, then timed."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention_ref, paged_decode_attention_raw)
    slots, h, kvh, hd, bs, nb = 16, 16, 8, 128, 16, 8192 // 16
    n_blocks = slots * nb
    lengths = torch.linspace(0, 8191, slots, device="cuda").round().int()
    table = torch.randperm(n_blocks, generator=gen, device="cuda").int() \
        .reshape(slots, nb)
    dt = torch.bfloat16
    q = torch.randn((slots, h, hd), generator=gen, device="cuda").to(dt)
    kp = torch.randn((n_blocks, bs, kvh, hd), generator=gen,
                     device="cuda").to(dt)
    vp = torch.randn((n_blocks, bs, kvh, hd), generator=gen,
                     device="cuda").to(dt)
    got = paged_decode_attention_raw(q, kp, vp, table, lengths)
    ref = paged_attention_ref(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    del ref
    live = int((lengths.long() + 1).sum())
    nbytes = (2.0 * live * kvh * hd * 2 + 2 * q.numel() * 2
              + 4 * (slots * nb + slots))
    what = f"paged bf16 long ({slots} slots, {live} live tokens)"
    ms = time_ms(f"{what}, kernel", lambda: paged_decode_attention_raw(
        q, kp, vp, table, lengths), flush)
    plain = time_ms(f"{what}, plain", lambda: paged_attention_ref(
        q, kp, vp, table, lengths), flush)
    bnd, by = bound_ms(nbytes, 4.0 * h * hd * live, "bfloat16")
    say(f"[kernel] on {card}: {what}, lengths 0..{int(lengths.max())}: "
        f"kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e9 / 3.35:.1%} of 3.35 TB/s), plain {plain:.4f} "
        f"ms, bound {bnd:.4f} ms ({by}), timing floor {floor:.4f} ms; "
        f"max|kernel-plain|={err:.3e} (tol {PAGED_TOL['bfloat16']})")
    if not err <= PAGED_TOL["bfloat16"]:
        fail(f"paged kernel disagrees with its plain version at the long "
             f"shape ({err})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, live_tokens=live)


def scan_times(t: dict) -> str:
    """A scan's times for its ``[kernel]`` line."""
    out = f"kernel {t['ms']:.4f} ms"
    if "parent_ms" in t:
        out += f" (parent's kernel {t['parent_ms']:.4f})"
    if "warm_l2_ms" in t:
        out += f", {t['warm_l2_ms']:.4f} with the L2 not flushed"
    return out + f", plain {t['plain_ms']:.4f} ms"


def ssm_kernel(gen, flush, card: str, floor: float, parent: dict) -> dict:
    """The selective scan at falcon-mamba's d_inner 8192 and d_state 16, in
    float32 as ``mamba_ssm`` builds its inputs (and once in bf16): B=4
    slots at T=256 (a prefill bucket), 1 (decode) and a ragged 100, B=1 at
    T=256 (a prefill chunk); with a carried h0 and ragged lengths that
    include a 0, whose h_T must be h0 to the bit.  Inputs in the ranges
    ``mamba_ssm`` gives them: delta = softplus(.) around 0.05, a = -(1..16)
    scaled by U[0.5, 1.5]."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.pavlov_ssm import (kernel as ssm_module,
                                                pavlov_ssm_raw, pavlov_ssm_ref)
    d, n = 8192, 16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(b, t, carry, dtype=torch.float32):
        scale = torch.empty((d, n), device="cuda").uniform_(
            0.5, 1.5, generator=gen)
        a = -torch.arange(1, n + 1, device="cuda").float() * scale
        length = torch.full((b,), t, dtype=torch.int32, device="cuda")
        if carry and b > 1:
            length = torch.randint(1, t + 1, (b,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            length[1] = 0
        streams = [F.softplus(randn(b, t, d) - 3.0), randn(b, t, d),
                   randn(b, t, n), randn(b, t, n)]
        return ([z.to(dtype) for z in streams]
                + [a, 1.0 + 0.1 * randn(d), 0.5 * randn(b, d, n), length])

    row = {"max_abs_err": 0.0}
    for b, t, carry, dtype in ((4, 256, False, torch.float32),
                               (4, 256, True, torch.float32),
                               (4, 100, True, torch.float32),
                               (4, 1, True, torch.float32),
                               (1, 256, True, torch.float32),
                               (4, 100, True, torch.bfloat16)):
        args = inputs(b, t, carry, dtype)
        if not carry:
            args[-2:] = [None, None]
        y, h_t = pavlov_ssm_raw(*args)
        y_ref, h_ref = pavlov_ssm_ref(*args)
        torch.cuda.synchronize()
        dy = (y.float() - y_ref.float()).abs()
        err_h = (h_t - h_ref).abs().max().item()
        err_y = dy.max().item()
        scale = SSM_Y_ULPS * y_ref.float().abs().max().item()
        if dtype == torch.float32:
            ok = err_y <= scale and err_h <= SSM_TOL
            row["max_abs_err"] = max(row["max_abs_err"], err_y, err_h)
            tol = f"tol y {scale:.2e} (8 ulps of max|y|), h_T {SSM_TOL}"
        else:
            ok = err_h <= SSM_TOL and bool(
                (dy <= y_ref.float().abs() * SSM_BF16_ULP + scale).all())
            tol = f"tol y one bf16 ulp + {scale:.2e}, h_T {SSM_TOL}"
        frozen = ""
        if carry and b > 1:
            kept = torch.equal(h_t[1], args[6][1])
            frozen = f", 0-length row h_T == h0 bitwise: {kept}"
            ok = ok and kept
        say(f"[kernel] ssm {str(dtype)[6:]} B={b} T={t} D={d} N={n} "
            f"{'h0 + lengths ' + str(args[7].tolist()) if carry else 'h0=0'}"
            f": max|kernel-plain| y {err_y:.3e}, h_T {err_h:.3e} ({tol})"
            f"{frozen}")
        if not ok:
            fail("selective-scan kernel disagrees with its plain version")
    # timed as serving calls it: h0 and lengths in, every step valid
    for b, t in ((4, 256), (4, 1), (1, 256)):
        args = inputs(b, t, False)
        nbytes = 4.0 * (3 * b * t * d + 2 * b * t * n + d * n + d
                        + 2 * b * d * n + b)
        what = f"ssm float32 B={b} T={t} D={d} N={n}"
        run = lambda: pavlov_ssm_raw(*args)  # noqa: E731
        times = dict(ms=time_ms(f"{what}, kernel", run, flush))
        if "pavlov_ssm" in parent:
            times["parent_ms"] = time_parent(
                what, ssm_module, parent["pavlov_ssm"], run, flush)
        times["plain_ms"] = time_ms(f"{what}, plain",
                                    lambda: pavlov_ssm_ref(*args), flush)
        if t == 1:
            times["warm_l2_ms"] = time_ms(f"{what}, kernel, L2 not flushed",
                                          run, lambda: None)
        bnd, by = bound_ms(nbytes, 7.0 * b * t * d * n, "float32")
        times.update(bound_ms=bnd, bound_by=by)
        say(f"[kernel] on {card}: {what}: {scan_times(times)}, bound "
            f"{bnd:.5f} ms ({by}; {b * t * d * n / 1e6:.1f} M exponentials),"
            f" timing floor {floor:.4f} ms")
        if (b, t) == (4, 256):
            row.update(library_ms=None, **times)
        elif t == 1:        # the decode launches' shape
            row["decode_T1"] = times
        else:               # a prefill chunk of one row
            row["prefill_B1"] = times
    return row


def sum_check(out, ref, k: int, dtype) -> tuple[float, bool, str]:
    """Max |out - ref| and whether it is within the tolerance of a product
    over ``k`` terms: sqrt(k) float32 ulps of max|ref|, one bf16 ulp more
    in bf16."""
    import torch
    err = (out.float() - ref.float()).abs()
    scale = math.sqrt(k) * F32_ULP * ref.float().abs().max().item()
    if dtype == torch.float32:
        return err.max().item(), err.max().item() <= scale, \
            f"tol {scale:.2e} (sqrt(K) ulps of max|y|)"
    ok = bool((err <= ref.float().abs() * BF16_ULP + scale).all())
    return err.max().item(), ok, f"tol one bf16 ulp + {scale:.2e}"


def gemm_inputs(gen, m: int, k: int, n: int, dtype):
    """x ~ N(0, 1) (m rows) and w with the fan-in init's std 1/sqrt(K)."""
    import torch
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    return x.to(dtype), w.to(dtype)


def pascal_kernel(gen, flush, card: str) -> dict:
    """The Pascal matmul at the edge zoo's TR1 hoisted input GEMMs (the
    encoder's M = B·T = 200 rows: enc1..7's 2048 -> 8192 and enc0's
    512 -> 8192; the prediction network's M = 20 in one call and M = 1 a
    single step, pred0's 640 -> 8192 and pred1's 2048 -> 8192) and at a
    ragged shape with lead dims, bf16 and float32; timed in float32 (the
    LSTM stack's dtype) and bf16 beside ``torch.matmul``."""
    import torch
    from repro_torch.kernels.pascal_matmul import (pascal_matmul,
                                                   pascal_matmul_raw,
                                                   pascal_matmul_ref)
    row = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for lead, k, n in (((200,), 2048, 8192), ((200,), 512, 8192),
                           ((20,), 640, 8192), ((20,), 2048, 8192),
                           ((1,), 640, 8192), ((1,), 2048, 8192),
                           ((3, 37), 300, 1000)):
            m = math.prod(lead)
            x, w = gemm_inputs(gen, m, k, n, dtype)
            out = pascal_matmul(x.reshape(*lead, k), w)
            ref = pascal_matmul_ref(x, w)
            torch.cuda.synchronize()
            err, ok, tol = sum_check(out.reshape(m, n), ref, k, dtype)
            say(f"[kernel] pascal {str(dtype)[6:]} {lead} x {k} @ {k} x {n}:"
                f" max|kernel-plain|={err:.3e} ({tol})")
            if not ok:
                fail("Pascal matmul kernel disagrees with its plain version")
            if dtype == torch.float32:
                row["max_abs_err"] = max(row["max_abs_err"], err)
    m, k, n = 200, 2048, 8192
    for dtype in (torch.float32, torch.bfloat16):
        x, w = gemm_inputs(gen, m, k, n, dtype)
        item = x.element_size()
        what = f"pascal {str(dtype)[6:]} {m} x {k} @ {k} x {n}"
        ms = time_ms(f"{what}, kernel", lambda: pascal_matmul_raw(x, w),
                     flush)
        plain = time_ms(f"{what}, plain", lambda: pascal_matmul_ref(x, w),
                        flush)
        lib = time_ms(f"{what}, torch.matmul", lambda: torch.matmul(x, w),
                      flush)
        bnd, by = bound_ms(item * (m * k + k * n + m * n), 2.0 * m * k * n,
                           str(dtype)[6:])
        say(f"[kernel] on {card}: pascal {str(dtype)[6:]} {m} x {k} @ {k} x "
            f"{n}: kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.matmul "
            f"{lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        times = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                     bound_by=by)
        if dtype == torch.float32:
            row.update(times)
        else:
            row["bfloat16"] = times
    row["routes"] = {
        "bfloat16": "tensor cores: wgmma from a TMA ring (K, N multiples of "
                    "8, 16-byte aligned), else SIMT",
        "float32": "SIMT: 8 x 8 float32 FMA micro-tiles, cp.async ring"}
    return row


def jacquard_kernel(gen, flush, card: str) -> dict:
    """The Jacquard GEMV at M = 1 and 4 at the edge zoo's FC widths (LSTM1's
    output 1280 -> 8192, TR1's joint_out 640 -> 4096, LSTM4's output
    2900 -> 8192) and at (4, 1024, 300), bf16 and float32; timed at M = 1,
    1280 -> 8192 beside ``torch.matmul``.  No path of the port calls the
    GEMV (none of the JAX package does): its launches are these checks'."""
    import torch
    from repro_torch.kernels import jacquard_gemv as jg
    row = {"max_abs_err": 0.0}
    jg.launches.reset()
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in ((1, 1280, 8192), (4, 1280, 8192), (1, 640, 4096),
                        (4, 640, 4096), (1, 2900, 8192), (4, 2900, 8192),
                        (4, 1024, 300)):
            x, w = gemm_inputs(gen, m, k, n, dtype)
            out = jg.jacquard_gemv(x, w)
            ref = jg.jacquard_gemv_ref(x, w)
            torch.cuda.synchronize()
            err, ok, tol = sum_check(out, ref, k, dtype)
            say(f"[kernel] jacquard {str(dtype)[6:]} M={m} K={k} N={n}: "
                f"max|kernel-plain|={err:.3e} ({tol})")
            if not ok:
                fail("Jacquard GEMV kernel disagrees with its plain version")
            if dtype == torch.float32:
                row["max_abs_err"] = max(row["max_abs_err"], err)
    row["launches"] = jg.launches.n
    # timed at the three FC widths at M=1 (LSTM1's output FC is the row) and
    # TR1's joint_out at M=4, float32 and bf16, beside the bound and
    # torch.matmul; each with the rate it reaches against 3.35 TB/s
    more = {}
    for m, k, n in ((1, 1280, 8192), (1, 640, 4096), (1, 2900, 8192),
                    (4, 640, 4096)):
        for dtype in (torch.float32, torch.bfloat16):
            x, w = gemm_inputs(gen, m, k, n, dtype)
            nbytes = x.element_size() * (m * k + k * n + m * n)
            what = f"jacquard {str(dtype)[6:]} M={m} K={k} N={n}"
            ms = time_ms(f"{what}, kernel", lambda: jg.jacquard_gemv_raw(x, w),
                         flush)
            plain = time_ms(f"{what}, plain",
                            lambda: jg.jacquard_gemv_ref(x, w), flush)
            lib = time_ms(f"{what}, torch.matmul", lambda: torch.matmul(x, w),
                          flush)
            bnd, by = bound_ms(nbytes, 2.0 * m * k * n, str(dtype)[6:])
            say(f"[kernel] on {card}: {what}: kernel {ms:.4f} ms "
                f"({nbytes / ms / 1e9 / 3.35:.1%} of 3.35 TB/s), plain "
                f"{plain:.4f} ms, torch.matmul {lib:.4f} ms, bound "
                f"{bnd:.4f} ms ({by})")
            times = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                         bound_by=by)
            if (m, k, n, dtype) == (1, 1280, 8192, torch.float32):
                row.update(times)
            else:
                more[f"{str(dtype)[6:]} M={m} {k}->{n}"] = times
    row["more"] = more
    return row


def lstm_inputs(gen, b: int, t: int, hd: int, dtype):
    """Gates xg ~ N(0, 1), W_h with the fan-in init's std 1/sqrt(H), and a
    carried state in an LSTM's ranges (|h| < 1)."""
    import torch
    xg = torch.randn((b, t, 4 * hd), generator=gen, device="cuda")
    wh = torch.randn((hd, 4 * hd), generator=gen, device="cuda") \
        / math.sqrt(hd)
    h0 = torch.empty((b, hd), device="cuda").uniform_(-0.9, 0.9,
                                                      generator=gen)
    c0 = torch.randn((b, hd), generator=gen, device="cuda")
    return xg.to(dtype), wh.to(dtype), h0, c0


def cudnn_lstm(params: dict):
    """``torch.nn.LSTM`` (cuDNN) computing ``lstm_layer``'s function: the
    same gate order, weight_ih = w_x^T, weight_hh = w_h^T, the forget
    gate's +1 in bias_ih.  A yardstick only: the port never calls it."""
    import torch
    d_in, h4 = params["w_x"].shape
    hd = h4 // 4
    lstm = torch.nn.LSTM(d_in, hd, batch_first=True).to("cuda")
    forget = torch.zeros(h4, device="cuda")
    forget[hd:2 * hd] = 1.0
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(params["w_x"].T)
        lstm.weight_hh_l0.copy_(params["w_h"].T)
        lstm.bias_ih_l0.copy_(params["b"] + forget)
        lstm.bias_hh_l0.zero_()
    return lstm


def lstm_kernel(gen, flush, card: str) -> dict:
    """The LSTM recurrence at TR1's width (H=2048, T=200) and LSTM4's
    ragged one (H=2900, T=80), B=1 and 4, zero and carried state, bf16 and
    float32; timed at B=1, T=200, H=2048 in float32 (the stack's dtype) and
    bf16, and the whole layer (Pascal GEMM + bias + recurrence, 2048 ->
    2048) beside cuDNN's ``torch.nn.LSTM`` on the same weights."""
    import torch
    from repro_torch.core.h100 import HBM_BW
    from repro_torch.kernels.pavlov_lstm import (pavlov_lstm_raw,
                                                 pavlov_lstm_ref)
    from repro_torch.models.recurrent import init_lstm_layer, lstm_layer
    row = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, hd in ((1, 200, 2048), (4, 200, 2048), (1, 80, 2900),
                         (4, 80, 2900)):
            for carry in (False, True):
                xg, wh, h0, c0 = lstm_inputs(gen, b, t, hd, dtype)
                state = (h0, c0) if carry else (None, None)
                y, h_t, c_t = pavlov_lstm_raw(xg, wh, *state)
                y_ref, h_ref, c_ref = pavlov_lstm_ref(xg, wh, *state)
                torch.cuda.synchronize()
                dy = (y.float() - y_ref.float()).abs()
                err_s = max((h_t - h_ref).abs().max().item(),
                            (c_t - c_ref).abs().max().item())
                if dtype == torch.float32:
                    ok = max(dy.max().item(), err_s) <= LSTM_TOL
                    row["max_abs_err"] = max(row["max_abs_err"],
                                             dy.max().item(), err_s)
                    tol = f"tol {LSTM_TOL}"
                else:
                    ok = err_s <= LSTM_TOL and bool(
                        (dy <= y_ref.float().abs() * BF16_ULP
                         + LSTM_TOL).all())
                    tol = f"tol h one bf16 ulp + {LSTM_TOL}, state {LSTM_TOL}"
                say(f"[kernel] lstm {str(dtype)[6:]} B={b} T={t} H={hd} "
                    f"{'carried (h0, c0)' if carry else 'zero state'}: "
                    f"max|kernel-plain| h {dy.max().item():.3e}, (h_T, c_T) "
                    f"{err_s:.3e} ({tol})")
                if not ok:
                    fail("LSTM kernel disagrees with its plain version")
    b, t, hd = 1, 200, 2048
    for dtype in (torch.float32, torch.bfloat16):
        xg, wh, _, _ = lstm_inputs(gen, b, t, hd, dtype)
        item = xg.element_size()
        what = f"lstm {str(dtype)[6:]} B={b} T={t} H={hd}"
        ms = time_ms(f"{what}, kernel", lambda: pavlov_lstm_raw(xg, wh),
                     flush)
        plain = time_ms(f"{what}, plain", lambda: pavlov_lstm_ref(xg, wh),
                        flush)
        # W_h read once (the table's convention) and W_h read every step
        nbytes = item * (b * t * 4 * hd + hd * 4 * hd + b * t * hd) \
            + 4.0 * 2 * b * hd
        bnd, by = bound_ms(nbytes, 2.0 * b * t * hd * 4 * hd, str(dtype)[6:])
        every = 1e3 * item * t * hd * 4 * hd / HBM_BW
        say(f"[kernel] on {card}: lstm {str(dtype)[6:]} B={b} T={t} H={hd}: "
            f"kernel {ms:.4f} ms (one launch), plain {plain:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}; W_h read once), {every:.4f} ms with "
            f"W_h read from device memory every step")
        times = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                     bound_every_step_ms=every)
        if dtype == torch.float32:
            row.update(times)
        else:
            row["bfloat16"] = times
    # the whole layer, 2048 -> 2048 at T=200, float32: the port's route and
    # cuDNN's on the same weights (a random bias so the +1 placement shows)
    params = init_lstm_layer(hd, hd, gen)
    params["b"].normal_(0.0, 0.1, generator=gen)
    x = torch.randn((b, t, hd), generator=gen, device="cuda")
    lib_lstm = cudnn_lstm(params)
    with torch.no_grad():
        y_lib, _ = lib_lstm(x)
    y_port, _ = lstm_layer(params, x)
    torch.cuda.synchronize()
    gap = (y_lib - y_port).abs().max().item()
    what = f"lstm layer float32 B={b} T={t} {hd} -> {hd}"
    layer = time_ms(f"{what}, port", lambda: lstm_layer(params, x), flush)
    with torch.no_grad():
        lib = time_ms(f"{what}, cuDNN", lambda: lib_lstm(x), flush)
    say(f"[kernel] on {card}: lstm layer float32 B={b} T={t} {hd} -> {hd}: "
        f"port (Pascal GEMM + bias + recurrence) {layer:.4f} ms, cuDNN "
        f"torch.nn.LSTM {lib:.4f} ms; max|port-cuDNN| h {gap:.3e}")
    row.update(library_ms=lib, layer_ms=layer,
               library_of="torch.nn.LSTM (cuDNN): the whole layer, beside "
                          "layer_ms")
    return row


# --------------------------------------------------------- 4. layer parity
def record_routing(routes: dict, side: list):
    """Keep every MoE call's routing (``models.moe.routing``'s decisions,
    copied to the host) in ``routes[side[0]]``; returns the undo."""
    from repro_torch.models import moe
    orig = moe.routing

    def recorded(*args, **kw):
        r = orig(*args, **kw)
        routes[side[0]].append({k: v.cpu() if hasattr(v, "cpu") else v
                                for k, v in r.items()})
        return r

    moe.routing = recorded
    return lambda: setattr(moe, "routing", orig)


def routing_agreement(arch: str, routes: dict, layers: int, calls: int):
    """The CPU's and the card's routings, call by call (``layers`` MoE
    calls a model call): fails on a flip no near-tie explains; prints each
    flip; returns how many leading model calls routed alike (their logits
    are held), and each side's drops."""
    from repro_torch.models import moe
    if not len(routes["cpu"]) == len(routes["card"]) == layers * calls:
        fail(f"{arch}: {len(routes['cpu'])} CPU and {len(routes['card'])} "
             f"card MoE calls, expected {layers * calls}")
    alike, drops = calls, {"cpu": 0, "card": 0}
    for i, (want, got) in enumerate(zip(routes["cpu"], routes["card"])):
        flips = moe.routing_flips(want, got, ROUTE_MARGIN)
        for side, r in (("cpu", want), ("card", got)):
            drops[side] += int((~r["keep"]).sum())
        if flips["unexplained"]:
            fail(f"{arch}: MoE call {i} (model call {i // layers}, layer "
                 f"{i % layers}) routes differently on the card, not at a "
                 f"near-tie (margin {ROUTE_MARGIN}): {flips}")
        if flips["gate"] or flips["keep"]:
            say(f"[parity] {arch}: routing flip at MoE call {i} (model "
                f"call {i // layers}, layer {i % layers}), every one at a "
                f"near-tie within {ROUTE_MARGIN}: top-k {flips['gate']}, "
                f"keep {flips['keep']}")
            alike = min(alike, i // layers)
    return alike, drops


def phase_parity(seed: int, arch: str, num_layers: int,
                 kv_block_size: int | None):
    """The arch at full width cut to ``num_layers`` layers, float32: the
    same weights on the CPU and on the card, prefill of two right-padded
    rows and 4 greedy decode steps, logits compared.  An MoE's routing is
    compared too, call by call (``routing_agreement``): where it agrees,
    the logits are held to the tolerance; a flip is allowed only at a
    near-tie, and the logits from that call on are printed, not held."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Model
    cfg = get_config(arch).replace(num_layers=num_layers,
                                   compute_dtype="float32")
    moe = cfg.ffn_kind == "moe"
    if moe:
        # 11-17 GB of float32 weights: drawn on the card, copied to the host
        gpu = build_model(cfg, device="cuda", seed=seed)
        cpu = Model(cfg, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
    else:
        cpu = build_model(cfg, device="cpu", seed=seed)
        gpu = Model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
    max_len, s = 512, 256
    lens = [37, 200]
    rng = torch.Generator().manual_seed(seed)
    toks = torch.randint(1, cfg.vocab_size, (2, s), generator=rng)
    table = None if kv_block_size is None else torch.arange(
        2 * max_len // kv_block_size, dtype=torch.int32).reshape(2, -1)
    length = torch.tensor(lens, dtype=torch.int32)
    models = {"cpu": cpu, "card": gpu}
    states, logits = {}, {}
    routes, side_now = {"cpu": [], "card": []}, ["cpu"]
    undo = record_routing(routes, side_now) if moe else (lambda: None)

    def on(x, side):
        return None if x is None else x.to(models[side].device)

    try:
        for side, model in models.items():
            side_now[0] = side
            st = model.init_states(2, max_len, kv_block_size=kv_block_size)
            lg, states[side] = model.prefill(on(toks, side), st,
                                             length=on(length, side),
                                             block_table=on(table, side))
            logits[side] = [lg.cpu()]
        pos = length.clone()
        for _ in range(4):
            # both sides decode the CPU's greedy token, so they never
            # diverge
            nxt = logits["cpu"][-1][:, 0].argmax(-1)[:, None]
            for side, model in models.items():
                side_now[0] = side
                lg, states[side] = model.decode_step(
                    on(nxt, side), states[side], on(pos, side),
                    block_table=on(table, side))
                logits[side].append(lg.cpu())
            pos = pos + 1
    finally:
        undo()
    if not all(torch.isfinite(lg).all() for lg in logits["card"]):
        fail(f"{arch}: non-finite logits on the card")
    held, note = len(logits["cpu"]), ""
    if moe:
        held, drops = routing_agreement(arch, routes, num_layers, held)
        note = (f"; routing of {len(routes['card'])} MoE calls "
                f"({cfg.num_experts} experts, top-{cfg.top_k}, capacity "
                f"factor {cfg.moe_capacity}) alike in the first {held} of "
                f"{len(logits['cpu'])} model calls, dropped assignments "
                f"CPU {drops['cpu']} card {drops['card']}")
    worst = max([(a - b).abs().max().item() for a, b in
                 zip(logits["cpu"][:held], logits["card"][:held])],
                default=0.0)
    scale = max(lg.abs().max().item() for lg in logits["cpu"])
    kv = "no KV" if set(cfg.layer_kinds) == {"ssm"} \
        else "dense KV" if kv_block_size is None \
        else f"paged KV (blocks of {kv_block_size})"
    say(f"[parity] {arch} full width, {num_layers} layers "
        f"({', '.join(cfg.layer_kinds)}), float32, {kv}, prefill lengths "
        f"{lens} + 4 decode steps: max|cuda-cpu| logits {worst:.3e} "
        f"(tol {LOGIT_TOL}; max|logits| {scale:.3f}){note}")
    if not worst <= LOGIT_TOL:
        fail(f"{arch} layer parity {worst} > {LOGIT_TOL}")
    del cpu, gpu, models, states
    release()


def phase_parity_encdec(seed: int, enc_layers: int = 2, num_layers: int = 2):
    """seamless-m4t-medium at full width cut to ``enc_layers`` + ``num_layers``
    layers, float32: the same weights on the CPU and on the card, one
    no-grad forward of two rows of 128 tokens over 96 source frames, logits
    compared.  The encoder's self-attention launches the flash kernel
    non-causal on the card; the cross-attention (128 queries over 96 keys)
    takes ``flash_attention_xla`` on both, as the JAX package's does."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Model
    cfg = get_config(ENCDEC).replace(num_layers=num_layers,
                                     enc_layers=enc_layers,
                                     compute_dtype="float32")
    cpu = build_model(cfg, device="cpu", seed=seed)
    gpu = Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = torch.Generator().manual_seed(seed)
    toks = torch.randint(1, cfg.vocab_size, (2, 128), generator=rng)
    src = torch.randn((2, 96, cfg.d_model), generator=rng)
    want = cpu(toks, src_embeds=src)
    before = flash_attention.launches.n
    got = gpu(toks.cuda(), src_embeds=src.cuda()).cpu()
    launched = flash_attention.launches.n - before
    worst = (got - want).abs().max().item()
    say(f"[parity] {ENCDEC} full width, {enc_layers} enc + {num_layers} dec "
        f"layers, float32, no-grad forward of 2 x 128 tokens over 96 source "
        f"frames: max|cuda-cpu| logits {worst:.3e} (tol {LOGIT_TOL}); flash "
        f"launches {launched} (one a self-attention layer)")
    check_all(f"{ENCDEC} parity", {
        "finite logits on the card": bool(torch.isfinite(got).all()),
        f"logits within {LOGIT_TOL}": worst <= LOGIT_TOL,
        "one flash launch a self-attention layer":
            launched == enc_layers + num_layers,
    })


#: a full-width cut's train step, the card against the CPU, float32: the
#: loss and grad norm are sums over the vocab (256,000 / 65,024) and every
#: weight in other orders; mu is (1 - b1) g, so it carries the gradients'
#: own differences, held as a share of each leaf's largest entry
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_MU_SHARE = 1e-3


def phase_train_parity(seed: int, arch: str, num_layers: int, batch: int,
                       seq_len: int):
    """One ``make_train_step`` step (accum 2, lr 1e-4 from step 0) of
    ``arch`` at full width cut to ``num_layers`` layers, float32, the same
    weights and batch on the CPU and on the card: under autograd the scans
    take ``chunked_linear_scan`` and attention ``flash_attention_xla``, so
    no kernel may launch.  Loss, grad norm, lr, each leaf's mu and the
    parameters after the step (within 3 lr: the first AdamW update is
    about lr * sign(g)) compared."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step, optim
    cfg = get_config(arch).replace(num_layers=num_layers,
                                   compute_dtype="float32")
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch,
        seed=seed))
    host = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    # drawn on the card (the CPU's generator takes seconds at this size)
    weights = {k: v.cpu() for k, v in build_model(
        cfg, "cuda", seed=seed, train=True).state_dict().items()}
    release()
    lr = 1e-4
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev, train=True)
        model.load_state_dict(weights)
        params = dict(model.named_parameters())
        step = make_train_step(model, accum_steps=2,
                               schedule=optim.cosine_schedule(lr, 0, 10))
        t0 = time.perf_counter()
        reset_counts()
        _, st, met = step(params, optim.adamw_init(params),
                          {k: v.to(dev) for k, v in host.items()})
        counts = read_counts()
        out[dev] = dict(met={k: float(v) for k, v in met.items()},
                        mu={k: m.cpu() for k, m in st.mu.items()},
                        params={k: p.detach().cpu()
                                for k, p in params.items()},
                        counts=counts, s=time.perf_counter() - t0)
        del model, params, st, step
        release()
    cpu, card = out["cpu"], out["cuda"]
    loss_rel = abs(card["met"]["loss"] / cpu["met"]["loss"] - 1)
    gnorm_rel = abs(card["met"]["grad_norm"] / cpu["met"]["grad_norm"] - 1)
    mu_share = max((card["mu"][k] - m).abs().max().item()
                   / max(m.abs().max().item(), 1e-30)
                   for k, m in cpu["mu"].items())
    moved = max((card["params"][k] - p).abs().max().item()
                for k, p in cpu["params"].items())
    n = sum(p.numel() for p in cpu["params"].values())
    say(f"[train-parity] {arch} full width, {num_layers} layers "
        f"({', '.join(cfg.layer_kinds)}), {n / 1e6:.1f} M parameters, "
        f"float32, batch {batch} x {seq_len} tokens in 2 microbatches: loss "
        f"cpu {cpu['met']['loss']:.6f} card {card['met']['loss']:.6f} (rel "
        f"{loss_rel:.2e}, tol {TRAIN_LOSS_RTOL}), grad norm rel "
        f"{gnorm_rel:.2e} (tol {TRAIN_GNORM_RTOL}), mu share {mu_share:.2e} "
        f"(tol {TRAIN_MU_SHARE}), max|param card-cpu| after the step "
        f"{moved:.3e} (tol {3 * lr:.1e}); kernel launches on the card "
        f"{ {k: v for k, v in card['counts'].items() if v} }; step "
        f"{card['s']:.2f} s on the card, {cpu['s']:.2f} s on the CPU")
    check_all(f"{arch} train parity", {
        "loss and grad norm finite": all(math.isfinite(v) for v in
                                         card["met"].values()),
        f"loss within {TRAIN_LOSS_RTOL}": loss_rel <= TRAIN_LOSS_RTOL,
        f"grad norm within {TRAIN_GNORM_RTOL}":
            gnorm_rel <= TRAIN_GNORM_RTOL,
        "lr within a float32 ulp": abs(card["met"]["lr"]
                                       / cpu["met"]["lr"] - 1) <= 2e-7,
        f"mu within {TRAIN_MU_SHARE} of each leaf's max":
            mu_share <= TRAIN_MU_SHARE,
        f"params within {3 * lr}": moved <= 3 * lr,
        "no kernel launched under autograd":
            not any(card["counts"].values()),
    })


# ------------------------------------------------------- 5. edge LSTM stack
def run_stack(params: list, x, states=None):
    """x through ``lstm_layer`` after ``lstm_layer``; returns the last
    layer's h and each layer's (h_T, c_T)."""
    from repro_torch.models.recurrent import lstm_layer
    out = []
    for i, p in enumerate(params):
        x, st = lstm_layer(p, x, None if states is None else states[i])
        out.append(st)
    return x, out


def run_steps(params: list, x):
    """x through the stack one timestep a call, carrying each layer's
    (h, c); returns the last layer's h over all steps and the states."""
    import torch
    states, ys = None, []
    for u in range(x.shape[1]):
        y, states = run_stack(params, x[:, u:u + 1], states)
        ys.append(y)
    return torch.cat(ys, dim=1), states


def max_diff(card: list, cpu: list) -> float:
    """Max |card - cpu| over pairs of tensors."""
    return max((a.cpu() - c).abs().max().item() for a, c in zip(card, cpu))


def flat(h, states) -> list:
    """h and each layer's (h_T, c_T), as one list of tensors."""
    return [h] + [s for st in states for s in st]


def phase_edge_lstm(seed: int, card: str) -> dict:
    """The LSTM layers of the edge zoo's mobile RNN-T at full width, float32
    (``init_lstm_layer``'s dtype, what the JAX package computes), batch 1:
    the widths come from the port's copy of the zoo."""
    import torch
    from repro_torch.core import LayerKind
    from repro_torch.edge import get_model
    from repro_torch.models.recurrent import init_lstm_layer
    graph = get_model("TR1_rnnt_mobile")
    lstms = [l for l in graph.layers if l.kind is LayerKind.LSTM]
    enc = [l for l in lstms if l.name.startswith("enc")]
    pred = [l for l in lstms if l.name.startswith("pred")]
    b, t_len, u_len = enc[0].batch, enc[0].seq_len, pred[0].seq_len

    # parity: the encoder cut to 2 layers and the 2-layer prediction
    # network (one call over U and U carried single steps), the same
    # weights and inputs on the CPU (plain versions) and on the card
    # (kernels)
    gen = torch.Generator().manual_seed(seed)
    cut = [init_lstm_layer(l.in_features, l.hidden, gen) for l in enc[:2]]
    pcut = [init_lstm_layer(l.in_features, l.hidden, gen) for l in pred]
    x = torch.randn((b, t_len, enc[0].in_features), generator=gen)
    lab = torch.randn((b, u_len, pred[0].in_features), generator=gen)
    t0 = time.perf_counter()
    enc_cpu = flat(*run_stack(cut, x))
    one_cpu = flat(*run_stack(pcut, lab))
    steps_cpu = flat(*run_steps(pcut, lab))
    cpu_s = time.perf_counter() - t0
    on_card = [[{k: v.to("cuda") for k, v in p.items()} for p in ps]
               for ps in (cut, pcut)]
    enc_err = max_diff(flat(*run_stack(on_card[0], x.to("cuda"))), enc_cpu)
    one_err = max_diff(flat(*run_stack(on_card[1], lab.to("cuda"))), one_cpu)
    steps_err = max_diff(flat(*run_steps(on_card[1], lab.to("cuda"))),
                         steps_cpu)
    say(f"[edge] TR1_rnnt_mobile encoder cut to 2 layers "
        f"({enc[0].in_features} -> {enc[0].hidden} -> {enc[1].hidden}, "
        f"T={t_len}, B={b}), float32: max|cuda-cpu| over h and each layer's "
        f"(h_T, c_T) {enc_err:.3e}; prediction network "
        f"({pred[0].in_features} -> {pred[0].hidden} -> {pred[1].hidden}, "
        f"U={u_len}) in one call {one_err:.3e}, as {u_len} carried single "
        f"steps {steps_err:.3e} (tol {LSTM_TOL}; CPU plain route "
        f"{cpu_s:.1f} s)")
    cpu_same = all(torch.equal(a, c) for a, c in zip(steps_cpu, one_cpu))
    say(f"[edge] prediction network on the CPU: {u_len} carried single "
        f"steps == one call, bit for bit: {cpu_same}")
    check_all("edge LSTM parity cut", {
        f"encoder cut within {LSTM_TOL}": enc_err <= LSTM_TOL,
        f"prediction network, one call, within {LSTM_TOL}":
            one_err <= LSTM_TOL,
        f"prediction network, single steps, within {LSTM_TOL}":
            steps_err <= LSTM_TOL,
        "CPU carried single steps equal one call bit for bit": cpu_same,
    })
    del cut, pcut, on_card

    # the whole stack on the card, counted from 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    enc_p = [init_lstm_layer(l.in_features, l.hidden, gen) for l in enc]
    pred_p = [init_lstm_layer(l.in_features, l.hidden, gen) for l in pred]
    n_params = sum(v.numel() for p in enc_p + pred_p for v in p.values())
    feats = torch.randn((b, t_len, enc[0].in_features), generator=gen,
                        device="cuda")
    # the prediction network's input: the embedded labels (pred_embed's
    # output width)
    labels = torch.randn((b, u_len, pred[0].in_features), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(enc) + 3)]
    t0 = time.perf_counter()
    marks[0].record()
    h = feats
    for i, p in enumerate(enc_p):
        h, _ = run_stack([p], h)
        marks[i + 1].record()
    g_one, st_one = run_stack(pred_p, labels)
    marks[len(enc) + 1].record()
    g_steps, states = run_steps(pred_p, labels)
    marks[len(enc) + 2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    layer_ms = [a.elapsed_time(z) for a, z in zip(marks, marks[1:])]
    enc_ms = sum(layer_ms[:len(enc)])
    same = torch.equal(g_steps, g_one) and all(
        torch.equal(a, c) for sa, sc in zip(states, st_one)
        for a, c in zip(sa, sc))
    calls = len(enc) + len(pred) + len(pred) * u_len
    finite = all(bool(torch.isfinite(z).all())
                 for z in (h, g_one, g_steps, *(s for st in states
                                                 for s in st)))
    say(f"[edge] TR1_rnnt_mobile LSTM stack on {card}, full width "
        f"({n_params / 1e6:.1f} M parameters, float32, B={b}): encoder "
        f"{len(enc)} layers over T={t_len} "
        f"{' + '.join(f'{v:.2f}' for v in layer_ms[:len(enc)])} = "
        f"{enc_ms:.2f} ms; prediction network {len(pred)} layers over "
        f"U={u_len} in one call {layer_ms[len(enc)]:.2f} ms, as {u_len} "
        f"carried single steps {layer_ms[len(enc) + 1]:.2f} ms; stack "
        f"{sum(layer_ms):.2f} ms on the card's clock, {1e3 * wall:.2f} ms "
        f"wall; launches {counts}")
    say(f"[edge] prediction network: {u_len} carried single steps == one "
        f"call over U={u_len}, bit for bit: {same}")
    check_all("edge LSTM stack", {
        "carried single steps equal one call bit for bit": same,
        f"Pascal launches == lstm_layer calls ({calls})":
            counts["pascal"] == calls,
        f"LSTM launches == lstm_layer calls ({calls})": counts["lstm"] == calls,
        "all outputs finite": finite,
    })
    return counts


# ---------------------------------------------------------------- 6. serve
def launch_counters():
    """Every kernel's launch counter, by the name the kernels line uses."""
    from repro_torch.kernels import (flash_attention, jacquard_gemv,
                                     paged_attention, pascal_matmul,
                                     pavlov_lstm, pavlov_rglru, pavlov_ssm)
    return {"flash": flash_attention.launches,
            "paged": paged_attention.launches,
            "rglru": pavlov_rglru.launches,
            "rglru_decode": pavlov_rglru.decode_launches,
            "ssm": pavlov_ssm.launches,
            "ssm_decode": pavlov_ssm.decode_launches,
            "pascal": pascal_matmul.launches,
            "jacquard": jacquard_gemv.launches,
            "lstm": pavlov_lstm.launches}


def release() -> None:
    """Give the card's memory back before the next model is built: the
    last phase's model and engine are unreachable once it returns."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def reset_counts() -> None:
    for c in launch_counters().values():
        c.reset()


def read_counts() -> dict:
    return {name: c.n for name, c in launch_counters().items()}


def serve_line(s: dict, card: str) -> str:
    return (f"on {card}: {s['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{s['ttft_ms']['p50']:.2f} ms (mean {s['ttft_ms']['mean']:.2f}, "
            f"max {s['ttft_ms']['max']:.2f}), decode step "
            f"{s['decode_step_ms']:.2f} ms over {s['decode_steps']} steps")


def check_all(what: str, checks: dict) -> None:
    for claim, ok in checks.items():
        if not ok:
            fail(f"{what}: {claim} does not hold")


def warmed_programs(engine) -> set:
    """The names of the programs ``engine.warmup()`` runs (its inventory):
    every (batch-bucket, bucket) prefill, the chunk where it is reachable
    and the block copy (paged) but on the decode role, the decode step but
    on the prefill role, and a role's half of the handoff."""
    names = set()
    if engine.role != "decode":
        names |= {f"prefill[{nb}x{b}]" for b in engine.buckets
                  for nb in engine.batch_buckets}
        if engine.max_len - 1 > engine.buckets[-1] \
                or (engine.kv is not None and engine.kv.prefix_enabled):
            names.add("chunk")
        if engine.kv is not None:
            names.add("copy")
    if engine.role != "prefill":
        names.add("decode")
    names |= {"prefill": {"export"}, "decode": {"import"}}.get(engine.role,
                                                              set())
    return names


#: the most of a peak a program's measured rate may read: above it, its
#: static count of FLOPs or bytes is at fault
SHARE_CAP = 1.05


def programs_report(what: str, s: dict, engine, card: str) -> None:
    """One ``[programs]`` line for each program of ``engine``'s summary
    ``s`` that ran: its static FLOPs and bytes, invocations, mean time and
    shares of the H100's peaks.  Fails unless every warmed program is
    registered (and nothing else), the invocations add up to the engine's
    counters (``decode`` its decode steps, ``prefill[...]`` its prefill
    calls, ``chunk`` its chunks, ``copy`` its copied blocks, ``export`` /
    ``import`` its handoffs), and every nonzero share of a program that
    ran lies in (0, SHARE_CAP]."""
    sec = s["programs"]
    progs, chip = sec["programs"], sec["chip"]
    ran = {k: p for k, p in sorted(progs.items()) if p["invocations"]}
    for name, p in ran.items():
        say(f"[programs] {what} {name}: {p['flops']:.6g} FLOPs, "
            f"{p['bytes_accessed']:.6g} bytes, {p['invocations']} calls, "
            f"mean {1e3 * p['measured_s'] / p['invocations']:.4f} ms; "
            f"{100 * p['utilization']:.4g}% of {chip['peak_flops']:.4g} "
            f"FLOP/s, {100 * p['bandwidth_utilization']:.4g}% of "
            f"{chip['hbm_bw']:.4g} B/s ({chip['name']}; on {card})")
    for phase in sorted({p["phase"] for p in ran.values()}):
        of = [p for p in ran.values() if p["phase"] == phase]
        secs = sum(p["measured_s"] for p in of)
        flops = sum(p["flops"] * p["invocations"] for p in of)
        nbytes = sum(p["bytes_accessed"] * p["invocations"] for p in of)
        say(f"[programs] {what} phase {phase}: "
            f"{sum(p['invocations'] for p in of)} calls in {secs:.6g} s, "
            f"{flops:.6g} FLOPs and {nbytes:.6g} bytes; "
            f"{100 * flops / secs / chip['peak_flops']:.4g}% of the FLOP/s "
            f"peak, {100 * nbytes / secs / chip['hbm_bw']:.4g}% of the "
            f"bytes/s peak (on {card})")
    calls = lambda k: progs.get(k, {}).get("invocations", 0)  # noqa: E731
    shares = [p[key] for p in ran.values()
              for key, base in (("utilization", "flops"),
                                ("bandwidth_utilization", "bytes_accessed"))
              if p[base]]
    check_all(f"programs {what}", {
        "every warmed program registered, nothing else":
            set(progs) == warmed_programs(engine)
            and all(p["analyzed"] for p in progs.values()),
        "decode invocations == decode_steps":
            calls("decode") == s["decode_steps"],
        "prefill[...] invocations sum to prefill_calls":
            sum(p["invocations"] for k, p in progs.items()
                if k.startswith("prefill[")) == s["prefill_calls"],
        "chunk invocations == prefill_chunks":
            calls("chunk") == s["prefill_chunks"],
        "copy invocations == blocks_copied":
            calls("copy") == s.get("kv", {}).get("blocks_copied", 0),
        "export + import invocations == handoffs":
            calls("export") + calls("import")
            == s.get("handoff", {}).get("handoffs", 0),
        f"every share in (0, {SHARE_CAP}]":
            bool(shares) and all(0 < v <= SHARE_CAP for v in shares),
    })


#: each serving path's launches, counted from 0 just before its run: fixed
#: by its requests and geometry (flash: layers x prefill calls; paged
#: decode: layers x decode steps; the scans: layers x (prefill calls +
#: chunks + decode steps))
SERVE_LAUNCHES = {
    "qwen3-0.6b": {"flash": 168, "paged": 924},
    "qwen2-0.5b": {"flash": 144, "paged": 792},
    "smollm-135m": {"flash": 180, "paged": 990},
    "starcoder2-7b": {"flash": 192, "paged": 1056},
    "internvl2-2b": {"flash": 192, "paged": 792},
    "recurrentgemma-2b": {"flash": 32, "rglru": 1350, "rglru_decode": 1116},
    "falcon-mamba-7b": {"ssm": 4480, "ssm_decode": 3968},
    "phi3.5-moe-42b-a6.6b": {"flash": 96, "paged": 528},
    "llama4-scout-17b-a16e": {"flash": 48, "paged": 264},
}
#: the MoE archs' depth: in phase 4, float32 on both sides (phi3.5-moe
#: 2 layers, ~11.5 GB a side; llama4-scout 1, ~17 GB, 8.3 GB of it the
#: two vocab tables); in phase 6, bf16, cut because neither fits one 80 GB
#: card whole (78.5 and 204.6 GiB of weights): ~39.7 and ~40.5 GiB
MOE_PARITY_LAYERS = {"phi3.5-moe-42b-a6.6b": 2, "llama4-scout-17b-a16e": 1}
MOE_SERVE_LAYERS = {"phi3.5-moe-42b-a6.6b": 16, "llama4-scout-17b-a16e": 8}
#: each disaggregated pair run's launches (``serve_disagg``), counted from
#: 0 just before it: the prefill role makes the interleaved run's prefill
#: calls and chunks and the decode role its decode steps, so each equals
#: the path's ``SERVE_LAUNCHES``
DISAGG_LAUNCHES = {
    "qwen3-0.6b": {"flash": 168, "paged": 924},
    "recurrentgemma-2b": {"flash": 32, "rglru": 1350, "rglru_decode": 1116},
    "falcon-mamba-7b": {"ssm": 4480, "ssm_decode": 3968},
}
#: phase_serve's options where an arch departs from qwen3's: a modality
#: model serves text only and cannot chunk, as the JAX package's cannot, so
#: its ladder runs to max_len, every prompt fits a bucket, and its prefix
#: cache is off (a hit resumes through a chunk)
SERVE_OPTIONS = {"internvl2-2b": dict(engine_kw=dict(prefix_cache=False),
                                      min_chunks=0, min_prefix_hits=0)}
#: the path served with ``program_memory=True`` (both its runs)
MEMORY_ARCH = "qwen3-0.6b"
#: phase 6's meshless serves, by arch (``serve_auto``): each run with its
#: config, engine options, requests' factory and drive function, for 6b
SERVED: dict = {}
#: phase 6b: phase 6's first three paths again, on a mesh of every rank
#: (one card: a 1-rank NCCL group), under each weight layout
MESH_ARCHS = ("qwen3-0.6b", "recurrentgemma-2b", "falcon-mamba-7b")
MESH_STRATEGIES = ("tp", "auto")
#: phase 6b's CLI runs, ``--mesh off`` and ``--mesh auto`` under
#: ``torch.distributed.run`` over every card, each in processes of its own
MESH_CLI = ("--requests", "8", "--max-new", "16", "--max-len", "256")
MESH_CLI_TIMEOUT_S = 300
#: what the plan's predicted times are of: never the card
MODELED = "modeled: the paper's Mensa accelerators, not the card"
#: what the execution-strategy planner's seconds are of: never the card
PLANNED = ("modeled: a 16 x 16 mesh of H100 SXM cards at 700 W from the "
           "datasheet's constants, not measured")


def phase_mensa() -> None:
    """The paper's pipeline on the port's copies: the 24 edge models
    characterized, clustered, scheduled and evaluated against the Baseline,
    Base+HB and Eyeriss v2, and each served arch's rule clusters held
    against a seeded k-means at its serving geometry."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import (agreement, characterize_zoo, evaluate_zoo,
                                  summarize)
    from repro_torch.edge import edge_zoo
    from repro_torch.serve.placement import verify_kmeans_agreement
    t0 = time.perf_counter()
    zoo = edge_zoo()
    results = evaluate_zoo(zoo)
    summary = summarize(results)
    costs = [c for r in results
             for c in (r.baseline, r.base_hb, r.eyeriss, r.mensa)]
    check_all("mensa", {
        "24 models evaluated": len(zoo) == len(results) == 24,
        "latency, energy and throughput finite and positive": all(
            math.isfinite(v) and v > 0 for c in costs
            for v in (c.latency_s, c.energy.total, c.throughput_flops)),
        "summary finite": all(math.isfinite(v)
                              for v in dataclasses.astuple(summary)),
    })
    scores = {}
    for arch, max_len, floor in (("qwen3-0.6b", 1024, 0.9),
                                 ("recurrentgemma-2b", 4096, 0.6),
                                 ("falcon-mamba-7b", 4096, 0.9),
                                 *((a, 1024, 0.9) for a in NEW_ARCHS)):
        try:
            scores[arch] = verify_kmeans_agreement(
                get_config(arch), max_len=max_len, min_agreement=floor)
        except AssertionError as e:
            fail(f"mensa: {e}")
    zoo_agreement = agreement(characterize_zoo(zoo))
    say(f"[mensa] 24 edge models, {sum(len(g.layers) for g in zoo)} layers "
        f"({MODELED}), {time.perf_counter() - t0:.1f} s on the host: "
        + ", ".join(f"{f.name} {getattr(summary, f.name):.4f}"
                    for f in dataclasses.fields(summary)))
    say(f"[mensa] rule-vs-k-means agreement (seed 0): the zoo "
        f"{zoo_agreement:.4f}; served archs at their serving max_len "
        + ", ".join(f"{a} {v:.4f}" for a, v in scores.items()))


def phase_strategy() -> None:
    """The execution-strategy layer (``core/{strategy,executor}.py``),
    priced on the H100: every arch of ``configs.ARCHS`` x every shape of
    ``configs.SHAPES``, full size and reduced, one line a cell — its
    profile's strategy and overrides and each block's template.  Fails
    unless every block's template is a legal one of its class, in its
    candidates, and their minimum before phase 2 (or a phase-2 merge names
    it), and unless exactly the reduced MoE configs' decode cells raise
    the reference's ``ValueError`` (4 experts do not divide model=16, and
    128 or 1 decode tokens leave data parallelism no batch)."""
    from repro_torch.configs import ARCHS, SHAPES, get_config, reduced_config
    from repro_torch.core.executor import execution_profile
    from repro_torch.core.strategy import _CANDIDATES, MeshShape
    mesh = MeshShape()
    say(f"[strategy] execution profiles of {len(ARCHS)} archs x "
        f"{len(SHAPES)} shapes, full and reduced ({PLANNED})")
    checks = {}
    for size, get in (("full", get_config), ("reduced", reduced_config)):
        for arch in ARCHS:
            cfg = get(arch)
            for shape in SHAPES.values():
                cell = f"{arch} x {shape.name} ({size})"
                trap = size == "reduced" and cfg.ffn_kind == "moe" \
                    and shape.kind == "decode"
                try:
                    prof = execution_profile(cfg, shape, mesh)
                except ValueError as e:
                    say(f"[strategy] {cell}: ValueError({e})"
                        + (f", expected: {cfg.num_experts} experts do not "
                           f"divide model={mesh.model}, {shape.global_batch}"
                           f" tokens give data parallelism no batch"
                           if trap else ", NOT expected"))
                    checks[f"{cell} raises only where expected"] = trap
                    continue
                checks[f"{cell} plans"] = not trap
                merged = {m.split(":")[0] for m in prof.plan.phase2_merges}
                for b in prof.plan.blocks:
                    checks[f"{cell} {b.name}: {b.strategy} legal, the "
                           f"least of {sorted(b.candidates)} before phase "
                           f"2"] = (
                        set(b.candidates) <= set(_CANDIDATES[b.name])
                        and b.strategy in b.candidates
                        and (b.name in merged or b.candidates[b.strategy]
                             == min(b.candidates.values())))
                say(f"[strategy] {cell}: strategy={prof.strategy} "
                    f"overrides={prof.cfg_overrides} blocks "
                    + ", ".join(f"{b.name} {b.strategy} ("
                                + ", ".join(f"{k} {1e3 * v:.4g} ms" for k, v
                                            in b.candidates.items()) + ")"
                                for b in prof.plan.blocks)
                    + "".join(f"; phase2 {m}"
                              for m in prof.plan.phase2_merges))
    check_all("strategy", checks)


class recorded_profiles:
    """Within it, every ``phase_profiles`` call that ``launch.serve``
    makes is recorded: the config it planned and the (prefill, decode)
    profiles it returned."""

    def __enter__(self) -> list:
        from repro_torch.launch import serve as serve_mod
        self.mod, self.inner, self.calls = serve_mod, \
            serve_mod.phase_profiles, []

        def recording(cfg, *args, **kwargs):
            out = self.inner(cfg, *args, **kwargs)
            self.calls.append((cfg, out))
            return out
        serve_mod.phase_profiles = recording
        return self.calls

    def __exit__(self, *exc) -> None:
        self.mod.phase_profiles = self.inner


def profile_checks(what: str, arch: str, calls: list, engines) -> dict:
    """Prints the profiles a build recorded; the claims that it planned
    ``get_config(arch)`` once, that the serving profiles' runtime-safe
    overrides are empty, and so that every engine's phase models are its
    model."""
    from repro_torch.configs import get_config
    from repro_torch.core.executor import RUNTIME_SAFE_KEYS
    for cfg, (pre, dec) in calls:
        say(f"[serve] {what} Mensa profiles of {cfg.name} ({cfg.num_layers} "
            f"layers; {PLANNED}): prefill strategy={pre.strategy} "
            f"overrides={pre.cfg_overrides}, decode strategy={dec.strategy} "
            f"overrides={dec.cfg_overrides}")
    return {
        "built through phase_profiles(get_config(arch)) once":
            len(calls) == 1 and calls[0][0] == get_config(arch),
        "no runtime-safe override in either phase": all(
            not set(p.cfg_overrides) & RUNTIME_SAFE_KEYS
            for _, profs in calls for p in profs),
        "prefill_model is decode_model is model": all(
            e.prefill_model is e.decode_model is e.model for e in engines),
    }


def serve_auto(what: str, cfg, model, card: str, engine_kw: dict,
               make_requests, drive, label: str = "") -> dict:
    """Serve ``make_requests()`` through ``drive`` on an engine built by
    ``build_engine(policy="auto")`` over ``model``, warmed up first; the
    launch counters set to 0 just before the run and read just after.
    Prints the plan, the run, the placement drift and the whole
    ``summary()``; fails unless the plan is the card's, the launches are
    ``SERVE_LAUNCHES[what]``, and, for paged attention layers, the engine's
    own counts agree with them: one flash launch a layer and prefill call,
    one paged launch a layer and decode step; unless the engine was built
    through ``phase_profiles(get_config(arch))`` with no runtime-safe
    override, so that its phase models are its model; unless no program
    was compiled after warmup; and, without a mesh and with
    ``cuda_graphs`` (the default), unless every program of its table is a
    CUDA graph, whose count, capture seconds and pool bytes a ``[graphs]``
    line gives beside the decode ticks' median.  ``label`` follows
    ``what`` on the printed lines.  A graphed run without a mesh is kept in
    ``SERVED`` with its requests' factory for phase 6b."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    t0 = time.perf_counter()
    with recorded_profiles() as calls:
        engine = build_engine(cfg, model, policy="auto",
                              plan_cfg=get_config(cfg.name), **engine_kw)
    engine.warmup()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    compiled = (engine.stats.prefill_compiles, engine.stats.decode_compiles)
    reqs = make_requests()
    ticks = record_decode_ticks(engine)
    reset_counts()
    drive(engine, reqs)
    counts = read_counts()
    plan, s = engine.policy, engine.stats.summary()
    graphed = "mesh" not in engine_kw and engine_kw.get("cuda_graphs", True)
    run = dict(reqs=reqs, counts=counts, plan=plan, s=s,
               tbt_ms=tbt_ms(engine.stats), decode_ms=ticks,
               graphs=engine.graph_report(), programs=len(engine._table))
    if graphed:
        SERVED[what] = dict(run, cfg=cfg, engine_kw=engine_kw,
                            make_requests=make_requests, drive=drive)
    name = what + label
    say(f"[serve] {name} plan (auto, backend {plan.backend}): clusters "
        f"{sorted(set(plan.layer_clusters))} over {len(plan.layer_clusters)}"
        f" layers, chunk {plan.prefill_chunk}, buckets {list(plan.buckets)}, "
        f"rule-vs-k-means {plan.rule_kmeans_agreement:.4f}; policies "
        + "; ".join(f"cluster {p.cluster} {list(p.kinds)} -> {p.accelerator}"
                    f", kernel {p.kernel} {list(p.variants)}"
                    for p in plan.policies))
    say(f"[serve] {name} --policy auto: engine + warmup {warm:.1f} s; "
        f"buckets {list(engine.buckets)}, chunk {engine.prefill_chunk}; "
        f"completed {s['requests_completed']}, tokens "
        f"{s['tokens_generated']}, prefill calls {s['prefill_calls']}, "
        f"chunks {s['prefill_chunks']}, non-finite logit rows "
        f"{s['nonfinite_logits']}, launches {counts}")
    say(f"[serve] {name} {serve_line(s, card)}")
    pl = s["placement"]
    meas = pl["measured"]
    say(f"[serve] {name} placement, predicted ({MODELED}): prefill chunk "
        f"{pl['predicted']['prefill_chunk_s']:.6g} s, decode step "
        f"{pl['predicted']['decode_step_s']:.6g} s; measured on {card}: "
        f"prefill call {meas['prefill_call_s']:.6g} s, prefill token "
        f"{meas['prefill_token_s']:.6g} s, decode step "
        f"{meas['decode_step_s']:.6g} s; drift (measured / predicted) "
        + ", ".join(f"{ph} {d['ratio']:.4g}"
                    for ph, d in pl["drift"].get("phases", {}).items()))
    say(f"[serve] {name} summary {json.dumps(s)}")
    programs_report(name, s, engine, card)
    g = run["graphs"]
    if graphed:
        say(f"[graphs] {name} on {card}: {g['graphs']} CUDA graphs of "
            f"{run['programs']} programs, captured (first call and capture) "
            f"in {g['capture_s']:.3f} s, one pool of {g['pool_bytes']} bytes "
            f"({g['pool_bytes'] / 2 ** 20:.1f} MiB); decode step median "
            f"{median(ticks):.3f} ms over {len(ticks)} steps (min "
            f"{min(ticks):.3f}, max {max(ticks):.3f})")
    want = SERVE_LAUNCHES[what]
    paged = cfg.layer_kinds.count("attn") if "kv" in s else 0
    check_all(f"serve {name}", {
        f"launches are {want}": {k: n for k, n in counts.items() if n}
            == want,
        "flash = attn layers x prefill calls, paged = attn layers x decode "
        "steps": not paged or (
            counts["flash"] == paged * s["prefill_calls"]
            and counts["paged"] == paged * s["decode_steps"]),
        "the plan is the card's": plan.source == "auto"
            and plan.backend == "cuda"
            and all(p.kernel == "cuda" for p in plan.policies),
        "the placement drift is reported": bool(pl["drift"]),
        "no program compiled after warmup":
            (s["prefill_compiles"], s["decode_compiles"]) == compiled,
        "every program a CUDA graph, or none without them":
            g["graphs"] == (run["programs"] if graphed else 0),
        **profile_checks(name, cfg.name, calls, [engine]),
    })
    del engine
    release()
    return run


def record_decode_ticks(engine) -> list:
    """The duration of each decode tick ``engine`` times from now on, in
    ms (the ``decode`` program's observations)."""
    ticks = []
    observe = engine.programs.observe

    def recorded(name, dur, **kw):
        if name == "decode":
            ticks.append(1e3 * dur)
        return observe(name, dur, **kw)

    engine.programs.observe = recorded
    return ticks


#: the meshless paths phase 6 serves again with ``cuda_graphs=False``:
#: their tokens and launches must be the graphed run's
EAGER_ARCHS = ("qwen3-0.6b", "recurrentgemma-2b", "falcon-mamba-7b",
               "phi3.5-moe-42b-a6.6b")


def serve_eager(what: str, cfg, model, card: str, engine_kw: dict,
                make_requests, drive, run: dict) -> None:
    """``run``'s requests again through ``serve_auto`` with
    ``cuda_graphs=False``, outside the paths' launch totals: fails unless
    every request's tokens (greedy and sampled) and the launches are the
    graphed run's; prints the two runs' decode step medians on a
    ``[graphs]`` line."""
    eager = serve_auto(what, cfg, model, card,
                       dict(engine_kw, cuda_graphs=False), make_requests,
                       drive, label=" eager")
    got = [r.generated for r in run["reqs"]]
    want = [r.generated for r in eager["reqs"]]
    g, e = median(run["decode_ms"]), median(eager["decode_ms"])
    say(f"[graphs] {what} graphed against eager on {card}: decode step "
        f"median {g:.3f} ms graphed, {e:.3f} ms eager ({e / g:.2f}x) over "
        f"{len(run['decode_ms'])} and {len(eager['decode_ms'])} steps; "
        f"tokens/s {run['s']['tokens_per_s']:.1f} and "
        f"{eager['s']['tokens_per_s']:.1f}; TTFT p50 "
        f"{run['s']['ttft_ms']['p50']:.2f} and "
        f"{eager['s']['ttft_ms']['p50']:.2f} ms; first divergent token "
        f"{first_divergence(got, want)}")
    check_all(f"graphs {what}", {
        "the graphed run's tokens are the eager run's": got == want,
        "the graphed run's launches are the eager run's":
            run["counts"] == eager["counts"],
    })


def tbt_ms(stats) -> dict:
    """The decode time-between-tokens p50 and p99 of an engine's stats."""
    h = stats.metrics.histogram("decode_tbt_s")
    return {"p50": 1e3 * h.quantile(0.5), "p99": 1e3 * h.quantile(0.99)}


def first_divergence(got: list, want: list) -> str:
    for i, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                return f"request {i} token {j}: {a} against {b}"
        if len(g) != len(w):
            return f"request {i}: {len(g)} tokens against {len(w)}"
    return "none"


def serve_disagg(what: str, cfg, model, card: str, engine_kw: dict,
                 make_requests, drive, run: dict) -> dict:
    """The interleaved run's requests again, through the same ``drive``,
    on a disaggregated pair over the same ``model``
    (``build_disagg_engine(policy="auto")``: 2 prefill slots, the
    interleaved run's slots for decode, its max_len, buckets and KV knobs),
    warmed up, its stats reset and the launch counters set to 0 just
    before.  Prints the handoffs, per-role tokens/s and both runs' decode
    TBT; fails unless every request's tokens are the interleaved run's,
    one handoff a request with none pending and no recompile, the launches
    are ``DISAGG_LAUNCHES[what]`` and the engines' own counts agree with
    them, and, where the interleaved run hit the prefix cache, the prefill
    role hits it as often, copies a block, and the decode pool drains."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_disagg_engine
    kw = {k: v for k, v in engine_kw.items() if k != "slots"}
    t0 = time.perf_counter()
    with recorded_profiles() as calls:
        dis = build_disagg_engine(cfg, model, prefill_slots=2,
                                  decode_slots=engine_kw["slots"],
                                  policy="auto",
                                  plan_cfg=get_config(cfg.name), **kw)
    dis.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = dis.summary()
    dis.reset_stats()
    reqs = make_requests()
    reset_counts()
    drive(dis, reqs)
    counts = read_counts()
    s = dis.summary()
    pre, dec = s["roles"]["prefill"], s["roles"]["decode"]
    got = [r.generated for r in reqs]
    want = [r.generated for r in run["reqs"]]
    say(f"[disagg] {what} pair (2 prefill + {engine_kw['slots']} decode "
        f"slots, one card): engine + warmup {warm_s:.1f} s; prefill role "
        f"buckets {list(dis.prefill.buckets)}, chunk "
        f"{dis.prefill.prefill_chunk}; prefill calls "
        f"{pre['prefill_calls']}, chunks {pre['prefill_chunks']}, decode "
        f"steps {dec['decode_steps']}, launches {counts}")
    say(f"[disagg] {what} on {card}: {s['handoffs']} handoffs "
        f"({s['handoffs_pending']} pending, {s['handoff_stalls']} stalls) in "
        f"{1e3 * s['handoff_time_s']:.3f} ms; {s['tokens_per_s']:.1f} "
        f"tokens/s over {s['ticks']} ticks, per role prefill "
        f"{s['per_role_tokens_per_s']['prefill']:.1f} and decode "
        f"{s['per_role_tokens_per_s']['decode']:.1f} tokens/s; decode TBT "
        f"p50 / p99 {s['decode_tbt_ms']['p50']:.2f} / "
        f"{s['decode_tbt_ms']['p99']:.2f} ms paired, "
        f"{run['tbt_ms']['p50']:.2f} / {run['tbt_ms']['p99']:.2f} ms "
        f"interleaved (no claim: one card runs both roles in turn)")
    say(f"[disagg] {what} summary {json.dumps(s)}")
    for role, eng in (("prefill", dis.prefill), ("decode", dis.decode)):
        programs_report(f"{what} pair {role} role", s["roles"][role], eng,
                        card)
    if got != want:
        say(f"[disagg] {what} first divergent token: "
            f"{first_divergence(got, want)}")
    want_launches = DISAGG_LAUNCHES[what]
    attn = sum(k in ("attn", "local") for k in cfg.layer_kinds)
    rec = sum(k in ("rec", "ssm") for k in cfg.layer_kinds)
    scan = "rglru_decode" if "rec" in cfg.layer_kinds else "ssm_decode"
    checks = {
        "tokens equal the interleaved run's": got == want,
        f"{len(reqs)} handoffs, none pending": s["handoffs"] == len(reqs)
            and s["handoffs_pending"] == 0,
        "no recompile after warmup": dis.recompiles_since(warm) == 0,
        "every request finished": s["requests_completed"] == len(reqs)
            and s["requests_aborted"] == 0,
        "the prefill role never decodes, the decode role never prefills":
            pre["decode_steps"] == 0 and dec["prefill_calls"]
            + dec["prefill_chunks"] == 0,
        f"launches are {want_launches}":
            {k: n for k, n in counts.items() if n} == want_launches,
        "flash = attention layers x the prefill role's prefill calls":
            counts["flash"] == attn * pre["prefill_calls"],
        **profile_checks(f"{what} pair", cfg.name, calls,
                         [dis.prefill, dis.decode]),
    }
    if "kv" in dec:
        checks["paged = attn layers x the decode role's decode steps"] = \
            counts["paged"] == attn * dec["decode_steps"]
        checks["the decode pool drains"] = dec["kv"]["blocks_in_use"] == 0
    if rec:
        checks[f"{scan} >= {rec} layers x the decode role's steps"] = \
            counts[scan] >= rec * dec["decode_steps"] > 0
    if run["s"].get("kv", {}).get("prefix_hits"):
        checks["the prefill role's prefix hit rate is the interleaved "
               "run's"] = pre["kv"]["prefix_hit_rate"] \
            == run["s"]["kv"]["prefix_hit_rate"]
        checks["the prefill role copies a block"] = \
            pre["kv"]["blocks_copied"] >= 1
    check_all(f"disagg {what}", checks)
    del dis
    release()
    return counts


def serve_pair(what: str, cfg, model, card: str, engine_kw: dict,
               make_requests, drive) -> tuple[dict, dict]:
    """The interleaved ``serve_auto`` run, then the pair on the same model;
    returns that run and the two runs' launches added."""
    run = serve_auto(what, cfg, model, card, engine_kw, make_requests, drive)
    pair = serve_disagg(what, cfg, model, card, engine_kw, make_requests,
                        drive, run)
    return run, {k: run["counts"][k] + pair[k] for k in pair}


def serve_checks(what: str, cfg, run: dict, new: int, checks: dict) -> None:
    s = run["s"]
    check_all(f"serve {what}", {
        "every request finished": all(r.done and len(r.generated) == new
                                      for r in run["reqs"]),
        "all logits finite": s["nonfinite_logits"] == 0,
        "tokens in vocab": all(0 <= t < cfg.vocab_size
                               for r in run["reqs"] for t in r.generated),
        **checks,
    })


def serve_requests(cfg, seed: int) -> list:
    """Phase 6's requests: prompts of 5-180 tokens and one of 600 (chunked
    past the largest bucket), a sampled request and a greedy one that share
    a 70-token prefix, 16 new tokens each."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.RandomState(seed)
    prompt = lambda n: rng.randint(1, cfg.vocab_size, n).tolist()  # noqa
    shared = prompt(70)
    reqs = [Request(rid=i, prompt=prompt(n), max_new_tokens=16)
            for i, n in enumerate((5, 17, 40, 90, 180))]
    reqs.append(Request(rid=5, prompt=prompt(600), max_new_tokens=16))
    reqs.append(Request(rid=6, prompt=shared
                        + prompt(10), max_new_tokens=16,
                        temperature=0.8, top_k=50, top_p=0.9, seed=seed))
    reqs.append(Request(rid=7, prompt=shared + prompt(12),
                        max_new_tokens=16))
    return reqs


def serve_drive(engine, reqs) -> None:
    """Phase 6's drive: the first seven requests, then the last once the
    shared prefix is published (at the first sharer's prefill)."""
    for r in reqs[:7]:
        engine.submit(r)
    while not reqs[6].generated:
        engine.step()
    engine.submit(reqs[7])
    engine.run([])


def phase_serve(seed: int, card: str, arch: str = "qwen3-0.6b",
                engine_kw: dict | None = None, min_chunks: int = 3,
                min_prefix_hits: int = 1, num_layers: int | None = None):
    """A full-width decoder through the paged engine (blocks of 16,
    max_len 1024, 4 slots, and ``engine_kw``, by default buckets up to
    256): bucketed and chunked prefill, a prefix hit with a copy-on-write
    clone, a sampled request.  Fails unless the run made at least
    ``min_chunks`` prefill chunks and ``min_prefix_hits`` prefix hits, and
    none of either where the minimum is 0.  ``num_layers`` cuts the depth
    (an MoE that does not fit the card whole); an MoE's run also prints
    the peak memory and the expert-bank bytes a decode tick reads."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    cut = "" if num_layers is None \
        else f" of {get_config(arch).num_layers}"
    say(f"[serve] {arch} full width ({cfg.num_layers}{cut} layers, "
        f"{cfg.num_heads} q heads over {cfg.num_kv_heads} kv heads of "
        f"{cfg.head_dim}, {cfg.norm} norm, {cfg.ffn_kind} FFN, "
        f"{'tied' if cfg.tie_embeddings else 'untied'} head; "
        f"{cfg.param_count() / 1e6:.0f} M parameters, bf16 compute, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card), "
        f"model {time.perf_counter() - t0:.1f} s")

    def make_requests():
        return serve_requests(cfg, seed)

    kw = dict(slots=4, max_len=1024, kv_block_size=16,
              **(engine_kw or dict(max_bucket=256)))
    drive = serve_drive
    if arch == MEMORY_ARCH:
        kw["program_memory"] = True
    if arch in DISAGG_LAUNCHES:
        run, counts = serve_pair(arch, cfg, model, card, kw, make_requests,
                                 drive)
    else:
        run = serve_auto(arch, cfg, model, card, kw, make_requests, drive)
        counts = run["counts"]
    if arch in EAGER_ARCHS:
        serve_eager(arch, cfg, model, card, kw, make_requests, drive, run)
    s = run["s"]
    if arch == MEMORY_ARCH:
        program_memory_line(arch, s, card)
    if arch == PROFILED_ARCH:
        for graphs in (True, False):
            decode_profile(arch, cfg, model, card, cuda_graphs=graphs)
    if cfg.ffn_kind == "moe":
        moe_serve_line(arch, cfg, s, kw["slots"], card)
        decode_profile(arch, cfg, model, card)
    say(f"[serve] {arch} prefix hits {s['kv']['prefix_hits']} "
        f"({s['kv']['prefix_tokens_reused']} tokens, "
        f"{s['kv']['blocks_copied']} COW), blocks peak "
        f"{s['kv']['blocks_peak']}, decode stalls {s['kv']['decode_stalls']}")
    serve_checks(arch, cfg, run, 16, {
        f"prefill_chunks >= {min_chunks}, none if 0":
            s["prefill_chunks"] >= min_chunks
            and bool(s["prefill_chunks"]) == bool(min_chunks),
        f"prefix_hits >= {min_prefix_hits}, none if 0":
            s["kv"]["prefix_hits"] >= min_prefix_hits
            and bool(s["kv"]["prefix_hits"]) == bool(min_prefix_hits),
        "decode_stalls == 0": s["kv"]["decode_stalls"] == 0,
    })
    return counts


def program_memory_line(arch: str, s: dict, card: str) -> None:
    """The interleaved serve's program memory (``program_memory=True``:
    the caching allocator's watermarks around each warmup call): the
    largest temp, its program, that program's peak, and the allocator's
    high-water mark since the last call's reset; fails unless the largest
    temp is above 0."""
    import torch
    progs = s["programs"]["programs"]
    name = max(progs, key=lambda k: progs[k]["memory"].get(
        "temp_size_in_bytes", 0))
    mem = progs[name]["memory"]
    peak = s["programs"].get("temp_bytes_peak", 0)
    say(f"[programs] {arch} program memory on {card}: temp peak {peak} "
        f"bytes ({peak / 2 ** 20:.1f} MiB, {name}: arguments "
        f"{mem['argument_size_in_bytes'] / 2 ** 30:.3f} GiB, outputs "
        f"{mem['output_size_in_bytes'] / 2 ** 20:.1f} MiB, peak "
        f"{mem['peak_memory_in_bytes'] / 2 ** 30:.3f} GiB); "
        f"torch.cuda.max_memory_allocated() "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    check_all(f"programs {arch}", {
        "temp_bytes_peak > 0": peak > 0,
        "the obs gauge carries it":
            s["obs"]["gauges"]["program_temp_bytes_peak"]["value"] == peak,
    })


def moe_serve_line(arch: str, cfg, s: dict, slots: int, card: str) -> None:
    """An MoE serve's decode step beside the expert-bank bytes one tick
    reads (the einsum route multiplies every expert's bank each tick) at
    the card's 3.35 TB/s, its peak memory, and the decode capacity: the
    reference's max(1, int(capacity_factor * slots * top_k / E))."""
    import torch
    from repro_torch.models.moe import capacity
    cap = capacity(cfg.moe_capacity, slots, cfg.top_k, cfg.num_experts)
    say(f"[serve] {arch} MoE on {card}: decode step "
        f"{s['decode_step_ms']:.2f} ms, {s['tokens_per_s']:.1f} tokens/s, "
        f"TTFT p50 {s['ttft_ms']['p50']:.2f} ms (mean "
        f"{s['ttft_ms']['mean']:.2f}); {moe_bank_line(cfg, 1)}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"decode capacity {cap} per expert at {slots} slots "
        f"(max(1, int({cfg.moe_capacity} x {slots} x {cfg.top_k} / "
        f"{cfg.num_experts}))): a tick keeps an expert's first {cap} "
        f"assignment(s) and drops the rest, the reference's function, not "
        f"a fault")


#: the profiled decode window: ticks, once every slot decodes
PROFILED_TICKS = 8
#: the dense path whose decode window is profiled on both routes (the MoE
#: paths' on the graphed one)
PROFILED_ARCH = "qwen3-0.6b"


#: the device functions each launch counter stands for, by the counter's
#: name in ``launch_counters``: one launch counted is one launch of each
#: group here (a paged call is its split and its combine kernel)
PROFILED_KERNELS = {
    "flash": (("flash_tc_kernel", "flash_f32_kernel"),),
    "paged": (("paged_split_kernel",), ("paged_combine_kernel",)),
    "rglru": (("rglru_ring_kernel", "rglru_scan_kernel"),),
    "ssm": (("ssm_ring_kernel", "ssm_direct_kernel"),),
}


def profiled_launches(kernels: list[dict]) -> dict:
    """The profiler's device launches of each group of ``PROFILED_KERNELS``
    (its names matched in the kernels' device names)."""
    return {f"{name} {'/'.join(group)}": sum(
        k["launches"] for k in kernels if any(g in k["name"] for g in group))
        for name, groups in PROFILED_KERNELS.items() for group in groups}


def decode_profile(arch: str, cfg, model, card: str,
                   cuda_graphs: bool = True,
                   kv_block_size: int | None = 16) -> None:
    """``PROFILED_TICKS`` decode ticks of 4 busy slots under
    ``torch.profiler`` (``obs.profile_trace``, into a temporary
    directory), on the graphed or the eager route, after the measured
    serve and outside its launch count: the wall time a tick, the card's
    busy share, and the kernels that took most of the card's time.  Fails
    unless the card ran each port kernel as many times in the window as
    its launch counter moved (``PROFILED_KERNELS``): on the graphed route
    the counters add what each capture counted, so only the profiler sees
    whether the kernels were nodes of the replayed graphs."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch.serve import build_engine
    from repro_torch.obs import profile_trace
    from repro_torch.serve.engine import Request
    from repro_torch.configs import get_config
    engine = build_engine(cfg, model, policy="auto", slots=4, max_len=1024,
                          kv_block_size=kv_block_size, max_bucket=256,
                          plan_cfg=get_config(cfg.name),
                          cuda_graphs=cuda_graphs)
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size,
                                              24).tolist(),
                    max_new_tokens=PROFILED_TICKS + 8) for i in range(4)]
    for r in reqs:
        engine.submit(r)
    while not all(r.generated for r in reqs):     # all admitted, decoding
        engine.step()
    torch.cuda.synchronize()
    before = read_counts()
    with tempfile.TemporaryDirectory() as tmp, \
            profile_trace(tmp, device=torch.device("cuda"), top=None) as prof:
        for _ in range(PROFILED_TICKS):
            engine.step()
    after = read_counts()
    if prof["device_busy_ms"] is None:
        fail(f"{arch}: the profiler saw no device time")
    top = prof["top_kernels"][:5]
    busy = prof["device_busy_ms"]
    route = "graphed" if cuda_graphs else "eager"
    seen = profiled_launches(prof["top_kernels"])
    counted = {key: after[key.split()[0]] - before[key.split()[0]]
               for key in seen}
    say(f"[serve] {arch} decode profiled, {route}: the card's launches of "
        f"the port's kernels in the window {seen}, the counters' "
        f"{counted}")
    check_all(f"{arch} decode profile ({route})", {
        "a port kernel ran in the window": any(seen.values()),
        **{f"the card ran {key} as often as its counter moved":
           seen[key] == counted[key] for key in seen}})
    say(f"[serve] {arch} decode profiled, {route}, on {card}: "
        f"{PROFILED_TICKS} "
        f"ticks of 4 slots, {prof['wall_ms'] / PROFILED_TICKS:.2f} ms a "
        f"tick, the card busy {busy / PROFILED_TICKS:.2f} ms a tick (idle "
        f"{100 * prof['device_idle_share']:.2f}%), "
        f"{prof['kernel_launches'] / PROFILED_TICKS:.0f} launches a tick; "
        f"top kernels by device time: "
        + "; ".join(f"{k['name'][:60]} {k['ms'] / PROFILED_TICKS:.3f} ms a "
                    f"tick ({100 * k['ms'] / busy:.1f}% of busy)"
                    for k in top))
    del engine
    release()


def run_all(engine, reqs) -> None:
    engine.run(reqs, on_truncate="raise")


def phase_serve_recurrent(seed: int, card: str):
    """Full-width recurrentgemma-2b through the dense-KV engine: short
    prompts, one that chunks across the 2048-token window, a sampled
    request that waits for a recycled slot, decode past the window."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request
    cfg = get_config("recurrentgemma-2b")
    n_rec = cfg.layer_kinds.count("rec")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    say(f"[serve] recurrentgemma-2b full width ({cfg.num_layers} layers: "
        f"{n_rec} rec, {cfg.num_layers - n_rec} local, window "
        f"{cfg.window}; {cfg.param_count() / 1e9:.2f} B parameters, bf16 "
        f"compute, dense KV), model {time.perf_counter() - t0:.1f} s")
    new = 32

    def make_requests():
        rng = np.random.RandomState(seed + 1)
        prompt = lambda n: rng.randint(1, cfg.vocab_size, n).tolist()  # noqa
        reqs = [Request(rid=i, prompt=prompt(n), max_new_tokens=new)
                for i, n in enumerate((5, 40, 180, 2300))]
        reqs.append(Request(rid=4, prompt=prompt(60), max_new_tokens=new,
                            temperature=0.8, top_k=50, top_p=0.9, seed=seed))
        return reqs

    kw = dict(slots=4, max_len=4096, max_bucket=256)
    run, counts = serve_pair("recurrentgemma-2b", cfg, model, card, kw,
                             make_requests, run_all)
    serve_eager("recurrentgemma-2b", cfg, model, card, kw, make_requests,
                run_all, run)
    s = run["s"]
    serve_checks("recurrentgemma-2b", cfg, run, new, {
        "prefill_chunks >= 9": s["prefill_chunks"] >= 9,
        f"decode steps x {n_rec} <= RG-LRU decode launches":
            s["decode_steps"] * n_rec <= run["counts"]["rglru_decode"],
    })
    return counts


def phase_serve_mamba(seed: int, card: str):
    """Full-width falcon-mamba-7b through the engine: no KV cache, the conv
    and scan states per slot; short prompts, one of 1000 tokens in 4
    chunks, a sampled request that waits for a recycled slot."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request
    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    say(f"[serve] falcon-mamba-7b full width ({cfg.num_layers} ssm layers, "
        f"d_inner {cfg.d_inner}, d_state {cfg.d_state}; "
        f"{cfg.param_count() / 1e9:.2f} B parameters, bf16 compute, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card), "
        f"model {time.perf_counter() - t0:.1f} s")
    new = 32

    def make_requests():
        rng = np.random.RandomState(seed + 2)
        prompt = lambda n: rng.randint(1, cfg.vocab_size, n).tolist()  # noqa
        reqs = [Request(rid=i, prompt=prompt(n), max_new_tokens=new)
                for i, n in enumerate((5, 40, 180, 1000))]
        reqs.append(Request(rid=4, prompt=prompt(60), max_new_tokens=new,
                            temperature=0.8, top_k=50, top_p=0.9, seed=seed))
        return reqs

    kw = dict(slots=4, max_len=4096, max_bucket=256)
    run, counts = serve_pair("falcon-mamba-7b", cfg, model, card, kw,
                             make_requests, run_all)
    serve_eager("falcon-mamba-7b", cfg, model, card, kw, make_requests,
                run_all, run)
    decode_profile("falcon-mamba-7b", cfg, model, card, kv_block_size=None)
    s = run["s"]
    serve_checks("falcon-mamba-7b", cfg, run, new, {
        "prefill_chunks >= 4": s["prefill_chunks"] >= 4,
        f"decode steps x {cfg.num_layers} <= SSM decode launches":
            s["decode_steps"] * cfg.num_layers <= run["counts"]["ssm_decode"],
    })
    return counts


# ---------------------------------------------------------- 6b. mesh serve
def phase_serve_mesh(seed: int, card: str) -> dict:
    """Phase 6's qwen3-0.6b, recurrentgemma-2b and falcon-mamba-7b paths
    again, at full width from the same seed and with the same requests,
    through ``build_engine(mesh=make_serve_mesh(), param_strategy=...)``
    under each of ``MESH_STRATEGIES`` (``serve_auto``, launch counters set
    to 0 just before each run).  Fails unless each run's tokens and
    launches are phase 6's meshless run's (so the kernels, not their plain
    versions, ran inside ``local_map``) and its plan gives every cluster a
    mesh axis; prints each run's decode step beside the meshless one's.
    Returns the runs' launches, added."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import build_model
    mesh = make_serve_mesh()
    say(f"[mesh] {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
        f"{mesh.size()} rank(s) of a {dist.get_backend()} group on {card}")
    total: dict = {}
    for arch in MESH_ARCHS:
        base = SERVED[arch]
        cfg = base["cfg"]
        model = build_model(cfg, device="cuda", seed=seed)
        want = [r.generated for r in base["reqs"]]
        for strategy in MESH_STRATEGIES:
            run = serve_auto(arch, cfg, model, card,
                             dict(base["engine_kw"], mesh=mesh,
                                  param_strategy=strategy),
                             base["make_requests"], base["drive"],
                             label=f" mesh {strategy}")
            got = [r.generated for r in run["reqs"]]
            s, s0 = run["s"], base["s"]
            say(f"[mesh] {arch} {strategy} on {card}: decode step "
                f"{s['decode_step_ms']:.3f} ms ({s0['decode_step_ms']:.3f} "
                f"ms without the mesh), {s['tokens_per_s']:.1f} tokens/s "
                f"({s0['tokens_per_s']:.1f}), TTFT p50 "
                f"{s['ttft_ms']['p50']:.2f} ms ({s0['ttft_ms']['p50']:.2f}),"
                f" over {s['decode_steps']} decode steps; sharding axes "
                + ", ".join(f"cluster {p.cluster} {p.sharding_axis}"
                            for p in run["plan"].policies)
                + f"; first divergent token {first_divergence(got, want)}")
            check_all(f"mesh {arch} {strategy}", {
                "tokens equal phase 6's meshless run's": got == want,
                "launches equal phase 6's meshless run's":
                    run["counts"] == base["counts"],
                "every cluster has a mesh axis": all(
                    p.sharding_axis in mesh.mesh_dim_names
                    for p in run["plan"].policies),
            })
            for k, n in run["counts"].items():
                total[k] = total.get(k, 0) + n
        del model
        release()
    dist.destroy_process_group()
    return total


def role_cli_cases(n: int) -> list:
    """(arch, extra CLI options, [(--roles spec, more options)]) for ``n``
    cards: none on one card; qwen3-0.6b (paged), recurrentgemma-2b and
    falcon-mamba-7b (dense) at prefill=1,decode=1, and with four cards
    qwen3-0.6b also at prefill=2,decode=2 and at prefill=1,decode=1 with
    ``--mp 2``."""
    if n < 2:
        return []
    pair = [("prefill=1,decode=1", ())]
    wide = [("prefill=2,decode=2", ()), ("prefill=1,decode=1", ("--mp", "2"))]
    return [("qwen3-0.6b", (), pair + (wide if n >= 4 else [])),
            ("recurrentgemma-2b", ("--kv-block-size", "0"), pair),
            ("falcon-mamba-7b", ("--kv-block-size", "0"), pair)]


#: phase 6c's CLI options: phase 6b's, warmed up, so that the runs time
#: serving and not first calls (the kernels' builds among them)
ROLES_CLI = MESH_CLI + ("--warmup",)

#: the reference's refusal of a role pair on one device
ROLE_REFUSAL = "roles 1+1 (mp=1) need 2 devices, have 1"

#: where phase 6c's runs write their files: each ``--serve-worker`` rank
#: its launch counts as ``launches_{rank}.json``
ROLES_DIR = ROOT / "build" / "roles_cli"


def role_launch_checks(arch: str, launches: list, n_pre: int) -> dict:
    """Each rank's launches (rank order): the prefill ranks launch some
    kernel, never paged decode and never a T = 1 scan; the decode ranks
    some kernel, never flash, and every scan at T = 1."""
    out = {}
    for c in launches:
        rank = c["rank"]
        if rank < n_pre:
            out[f"{arch}: prefill rank {rank} launches, none of them "
                f"paged decode or a T = 1 scan"] = (
                c["flash"] + c["rglru"] + c["ssm"] > 0 and c["paged"] == 0
                and c["rglru_decode"] == c["ssm_decode"] == 0)
        else:
            out[f"{arch}: decode rank {rank} launches, no flash and only "
                f"T = 1 scans"] = (
                c["paged"] + c["rglru"] + c["ssm"] > 0 and c["flash"] == 0
                and c["rglru"] == c["rglru_decode"]
                and c["ssm"] == c["ssm_decode"])
    if arch == "qwen3-0.6b":
        out["qwen3-0.6b: the prefill ranks launch flash, the decode ranks "
            "paged decode"] = all(
            (c["flash"] > 0) == (c["rank"] < n_pre)
            and (c["paged"] > 0) == (c["rank"] >= n_pre) for c in launches)
    return out


def phase_serve_roles(card: str) -> None:
    """The serving CLI's ``--roles`` at full width (``ROLES_CLI``): on one
    card, the refusal; on n >= 2 cards each of ``role_cli_cases`` under
    ``torch.distributed.run --standalone``, one process a role card, in
    this script's ``--serve-worker`` mode, against one plain process with
    ``--roles off`` (tokens and summaries under the ignored ``build/``).
    Fails unless every run exits 0 with ``--roles off``'s tokens, one
    handoff a request and none pending, and its ranks' launches disjoint
    (``role_launch_checks``).  Prints each run's decode step, tokens/s,
    decode TBT and TTFT beside ``--roles off``'s."""
    import torch
    from repro_torch.launch.mesh import parse_roles_arg
    n = torch.cuda.device_count()
    serve = [sys.executable, "-m", "repro_torch.launch.serve"]
    if n < 2:
        rc, out, err = run_bounded(
            serve + ["--arch", "qwen3-0.6b", *ROLES_CLI, "--roles",
                     "prefill=1,decode=1"], MESH_CLI_TIMEOUT_S)
        said = [line for line in err.splitlines() if "need" in line]
        say(f"[roles] one card ({card}): --roles prefill=1,decode=1 exits "
            f"{rc}: {said[-1] if said else err.splitlines()[-1:]}; the "
            f"role pair needs a card a role (NCCL takes one rank a card), "
            f"so it is not served here")
        check_all("roles on one card", {
            "--roles prefill=1,decode=1 exits non-zero": rc != 0,
            "with the reference's message": ROLE_REFUSAL in err})
        return
    where = ROLES_DIR
    where.mkdir(parents=True, exist_ok=True)
    checks = {}
    for arch, extra, runs in role_cli_cases(n):
        results = {}
        for spec, more in [("off", ())] + runs:
            label = " ".join(("--roles", spec) + more)
            files = {k: where / f"{k}_{arch}_{label.replace(' ', '_')}.json"
                     for k in ("tokens", "metrics")}
            for f in [*files.values(), *where.glob("launches_*.json")]:
                f.unlink(missing_ok=True)
            cli = ["--arch", arch, *extra, *ROLES_CLI, "--roles", spec, *more,
                   "--tokens-json", str(files["tokens"]),
                   "--metrics-json", str(files["metrics"])]
            roles = parse_roles_arg(spec)
            if roles is None:
                cmd, ranks = serve + cli, 1
            else:
                mp = int(more[1]) if more else 1
                ranks = (roles.prefill + roles.decode) * mp
                cmd = [sys.executable, "-m", "torch.distributed.run",
                       "--standalone", f"--nproc-per-node={ranks}",
                       str(ROOT / "chip_smoke.py"), "--serve-worker", *cli]
            t0 = time.perf_counter()
            rc, out, err = run_bounded(cmd, MESH_CLI_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if rc:
                for line in err.splitlines()[-20:]:
                    say(f"[roles] CLI {label} stderr| {line}")
                fail(f"the CLI for {arch} with {label} exited {rc}")
            s = json.loads(files["metrics"].read_text())
            launches = sorted((json.loads(f.read_text())
                               for f in where.glob("launches_*.json")),
                              key=lambda c: c["rank"])
            results[spec + "".join(more)] = got = {
                "tokens": json.loads(files["tokens"].read_text()), "s": s}
            if roles is None:
                say(f"[roles] CLI {arch} {label}: exit 0 in {wall:.1f} s "
                    f"wall on {card}; decode step {s['decode_step_ms']:.3f} "
                    f"ms, {s['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                    f"{s['ttft_ms']['p50']:.2f} ms")
                continue
            base = results["off"]
            dec, pre = s["roles"]["decode"], s["roles"]["prefill"]
            say(f"[roles] CLI {arch} {label} on {ranks} cards under "
                f"torch.distributed.run: exit 0 in {wall:.1f} s wall on "
                f"{card}; decode step {dec['decode_step_ms']:.3f} ms "
                f"({base['s']['decode_step_ms']:.3f} with --roles off), "
                f"{s['tokens_per_s']:.1f} tokens/s "
                f"({base['s']['tokens_per_s']:.1f}), decode TBT p50 "
                f"{s['decode_tbt_ms']['p50']:.2f} ms / p99 "
                f"{s['decode_tbt_ms']['p99']:.2f} ms, TTFT p50 "
                f"{pre['ttft_ms']['p50']:.2f} ms, {s['handoffs']} handoffs "
                f"in {1e3 * s['handoff_time_s']:.2f} ms, {s['ticks']} ticks;"
                f" launches by rank "
                + json.dumps({c["rank"]: {k: v for k, v in c.items()
                                          if v and k != "rank"}
                              for c in launches})
                + "; first divergent token " + first_divergence(
                    list(got["tokens"].values()),
                    list(base["tokens"].values())))
            n_pre = roles.prefill * (int(more[1]) if more else 1)
            checks.update({
                f"{arch} {label}: --roles off's tokens":
                    got["tokens"] == base["tokens"],
                f"{arch} {label}: a handoff a request, none pending":
                    s["handoffs"] == len(base["tokens"]) == 8
                    and s["handoffs_pending"] == 0,
                f"{arch} {label}: every rank's launches read":
                    [c["rank"] for c in launches] == list(range(ranks)),
                **role_launch_checks(f"{arch} {label}", launches, n_pre)})
    check_all("roles CLI", checks)


def serve_worker(cli: list) -> None:
    """One rank of a ``phase_serve_roles`` run, under
    ``torch.distributed.run``: the serving CLI's ``main(cli)`` with every
    launch counter set to 0 just before it, then this rank's counts, in
    ``ROLES_DIR``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.serve import main as serve_main
    reset_counts()
    serve_main(cli)
    rank = int(os.environ["RANK"])
    (ROLES_DIR / f"launches_{rank}.json").write_text(json.dumps(
        {"rank": rank, **read_counts()}))


def run_bounded(cmd: list, timeout: float):
    """``cmd`` in a process group of its own, its output captured; at
    ``timeout`` the whole group is killed (a launcher's workers too)."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"{' '.join(cmd[:6])}... did not end within {timeout} s")
    return proc.returncode, out, err


def mesh_cli_cases(n: int) -> list:
    """(arch, extra CLI options, meshes) for ``n`` cards: qwen3-0.6b
    (paged) at ``auto`` (data-parallel over every card); with two cards or
    more also the tensor-parallel meshes ``(n/2)x2`` and ``1xn`` (the
    striped pool and head-split caches, the Partial sums over NCCL), and
    falcon-mamba-7b (its width split) at ``1xn``.  Each is held against
    ``--mesh off``."""
    if n < 2:
        return [("qwen3-0.6b", (), ("auto",))]
    tp = list(dict.fromkeys(f"{n // k}x{k}" for k in (2, n) if n % k == 0))
    return [("qwen3-0.6b", (), ("auto", *tp)),
            ("falcon-mamba-7b", ("--kv-block-size", "0"), (f"1x{n}",))]


def phase_serve_mesh_cli(card: str) -> None:
    """The serving CLI at full width (``MESH_CLI``) for each of
    ``mesh_cli_cases``: once with ``--mesh off`` in a plain process and
    once for each mesh under ``torch.distributed.run --standalone`` with
    one process a card, each writing its tokens (``--tokens-json``, under
    the ignored ``build/``).  Fails unless every run exits 0 and each mesh
    run's tokens are the meshless run's."""
    import torch
    n = torch.cuda.device_count()
    where = ROOT / "build" / "mesh_cli"
    where.mkdir(parents=True, exist_ok=True)
    dist_run = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", f"--nproc-per-node={n}"]
    checks = {}
    for arch, extra, meshes in mesh_cli_cases(n):
        runs = {}
        for mode in ("off", *meshes):
            path = where / f"tokens_{arch}_{mode}.json"
            path.unlink(missing_ok=True)
            launcher = [sys.executable] if mode == "off" else dist_run
            t0 = time.perf_counter()
            rc, out, err = run_bounded(
                launcher + ["-m", "repro_torch.launch.serve", "--arch", arch,
                            *extra, *MESH_CLI, "--mesh", mode,
                            "--tokens-json", str(path)],
                MESH_CLI_TIMEOUT_S)
            wall = time.perf_counter() - t0
            lines = [line.strip() for line in out.splitlines()
                     if line.startswith("[serve] mesh")
                     or line.lstrip().startswith(('"tokens_per_s"',
                                                  '"decode_step_ms"'))]
            say(f"[mesh] CLI {arch} --mesh {mode}"
                + (f" on {n} card(s) under torch.distributed.run"
                   if mode != "off" else "")
                + f": exit {rc} in {wall:.1f} s wall on {card} (processes' "
                f"start, kernel builds, full width); " + " ".join(lines))
            if rc:
                for line in err.splitlines()[-20:]:
                    say(f"[mesh] CLI --mesh {mode} stderr| {line}")
                fail(f"the CLI for {arch} with --mesh {mode} exited {rc}")
            runs[mode] = json.loads(path.read_text())
        off = runs["off"]
        checks[f"{arch}: every request generated"] = len(off) == 8 and all(
            len(t) == 16 for t in off.values())
        for mode in meshes:
            checks[f"{arch}: --mesh {mode}'s tokens equal --mesh off's"] = \
                runs[mode] == off
    check_all("mesh CLI", checks)


# ------------------------------------------------ 6d. context-parallel serve
#: phase 6d's paths: full width and depth, bf16, weights from the seed
CP_ARCHS = ("qwen3-0.6b", "recurrentgemma-2b", "falcon-mamba-7b")
#: its geometry: rows, cache slots, the right-padded prompts' lengths (past
#: recurrentgemma's 2048-slot rings, which wrap), greedy decode steps, and
#: the row frozen (``active`` False) for one step and that step
CP_ROWS, CP_MAX_LEN, CP_LENS, CP_STEPS = 4, 8192, (3000, 3100, 3047, 3013), 32
CP_FROZEN, CP_FROZEN_STEP = 2, 5
#: seamless-m4t-medium's serve: source frames, prompt tokens, decode steps
#: and the tolerance of ``tests/test_models_smoke.py``'s decode against a
#: teacher-forced forward (absolute and relative)
ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_STEPS, ENCDEC_TOL = 512, 64, 16, 5e-2
#: the multi-card launches' runs write here (``--cp-worker``)
CP_CARDS_DIR = ROOT / "build" / "cp_cards"
CP_CARDS_TIMEOUT_S = 300
#: the dry run's serving cells phase 6d prints, each in a process of its own
CP_DRYRUN_CELLS = (("qwen3-0.6b", "prefill_32k", "single"),
                   ("qwen3-0.6b", "decode_32k", "single"),
                   ("recurrentgemma-2b", "long_500k", "single"))


def cp_serve(model, mesh=None, *, max_len: int = CP_MAX_LEN,
             steps: int = CP_STEPS, seed: int = 0) -> dict:
    """One right-padded one-shot ``prefill`` of ``CP_ROWS`` prompts of
    ``CP_LENS`` tokens and ``steps`` greedy ``decode_step`` calls of
    ``model`` on the card, row ``CP_FROZEN`` frozen at step
    ``CP_FROZEN_STEP``; on ``mesh`` the model's DTensor copy
    (``distribute_models``) with states laid out by ``state_specs`` and
    placed by ``place_states``, else meshless.  The launch counters are
    set to 0 just before the prefill and read after the last step.
    Returns the tokens, the logits of each call (float32, on the host),
    each decode step's ms (synchronized), the counts, whether the frozen
    row's state kept its bits through its step, whether every logit was
    finite, and the states."""
    import torch
    from repro_torch.launch import shardings as sh
    cfg = model.cfg
    b, s = CP_ROWS, max(CP_LENS)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                         dtype=torch.int32)
    lens = torch.tensor(CP_LENS, dtype=torch.int32)
    states = model.init_states(b, max_len)
    bax = None
    if mesh is not None:
        bax = sh.batch_axis(mesh, b)
        model = sh.distribute_models([model], mesh)[0]
        states = sh.place_states(states, sh.state_specs(model, mesh, b,
                                                        max_len), mesh)

    def put(t, spec):
        t = t.cuda()
        return t if mesh is None else sh.local_part(
            t, mesh, sh.to_placements(spec, mesh))

    def whole(t):
        return t if mesh is None else t.full_tensor()

    def frozen_bits(states) -> list:
        """The frozen row of every state tensor this rank holds it in."""
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        out = []
        for st in states:
            for t in (st.kv if st.kv is not None else st.rec.values()):
                if mesh is None:
                    out.append(t[CP_FROZEN].clone())
                    continue
                shape, offset = compute_local_shape_and_global_offset(
                    tuple(t.shape), mesh, t.placements)
                if 0 <= CP_FROZEN - offset[0] < shape[0]:
                    out.append(t.to_local()[CP_FROZEN - offset[0]].clone())
        return out

    finite, kept, step_ms, seen = True, True, [], []
    with torch.no_grad():
        reset_counts()
        logits, states = model.prefill(put(toks, (bax, None)), states,
                                       length=put(lens, (bax,)))
        tok = whole(logits).argmax(-1).to(torch.int32)
        finite &= bool(torch.isfinite(whole(logits)).all())
        seen.append(whole(logits)[:, 0].float().cpu())
        pos = lens.cuda()
        out = [tok[:, 0].tolist()]
        for step in range(steps):
            active = torch.tensor([not (r == CP_FROZEN
                                        and step == CP_FROZEN_STEP)
                                   for r in range(b)], device="cuda")
            before = frozen_bits(states) if not active.all() else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, states = model.decode_step(
                put(tok, (bax, None)), states, put(pos, (bax,)),
                active=put(active, (bax,)))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if before is not None:
                kept &= all(torch.equal(x, y) for x, y in
                            zip(before, frozen_bits(states)))
            lg = whole(logits)
            finite &= bool(torch.isfinite(lg).all())
            seen.append(lg[:, 0].float().cpu())
            tok = torch.where(active[:, None], lg.argmax(-1).to(torch.int32),
                              tok)
            pos = pos + active.to(torch.int32)
            out.append(tok[:, 0].tolist())
        counts = read_counts()
    return {"tokens": out, "logits": seen, "step_ms": step_ms,
            "counts": counts, "frozen_kept": kept, "finite": finite,
            "states": states}


def median(values: list) -> float:
    return sorted(values)[len(values) // 2]


def cp_launches(cfg, steps: int) -> dict:
    """The launches one ``cp_serve`` run of ``cfg`` makes: one flash launch
    a self-attention layer in the prefill (the decode steps read a dense
    cache in plain PyTorch, as the reference's ``decode_attention``), one
    scan a recurrent layer a call, ``steps`` of them decode (T = 1)."""
    kinds = cfg.layer_kinds
    attn = sum(k in ("attn", "local", "dec") for k in kinds)
    rec, ssm = kinds.count("rec"), kinds.count("ssm")
    want = {name: 0 for name in launch_counters()}
    want.update(flash=attn, rglru=rec * (1 + steps), rglru_decode=rec * steps,
                ssm=ssm * (1 + steps), ssm_decode=ssm * steps)
    return want


def phase_cp_serve(seed: int, card: str) -> dict:
    """6d: (a) full-width qwen3-0.6b, recurrentgemma-2b and falcon-mamba-7b
    at full depth, bf16, served by ``cp_serve`` meshless and then on a
    1-rank NCCL mesh (``make_host_mesh((1, 1))``) with states from
    ``state_specs`` + ``place_states``: the tokens equal, the frozen row's
    state bit for bit unchanged, the launches equal and the path's own,
    each decode step's median printed beside the meshless one's; (b)
    seamless-m4t-medium (``phase_cp_encdec``); then the dry run's serving
    cells start, each in a process of its own; (c) on n >= 2 cards the
    ``--cp-worker`` launches (``cp_cards``) while they run; (d) the dry
    runs' records (``dryrun_lines``).  Returns the launches of the runs,
    added."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    train_mesh_group()
    mesh = make_host_mesh((1, 1), MESH_AXES, device="cuda")
    total: dict = {}
    checks = {}
    for arch in CP_ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg, device="cuda", seed=seed)
        base = cp_serve(model, seed=seed)
        del base["states"]
        run = cp_serve(model, mesh, seed=seed)
        kv = [st.kv.k for st in run.pop("states") if st.kv is not None]
        want = cp_launches(cfg, CP_STEPS)
        say(f"[cp] {arch} full width, {cfg.num_layers} layers, bf16, "
            f"{CP_ROWS} rows of {CP_LENS} prompt tokens, {CP_MAX_LEN} cache "
            f"slots, {CP_STEPS} greedy decode steps (row {CP_FROZEN} frozen "
            f"at step {CP_FROZEN_STEP}) on {card}: on a 1-rank "
            f"{dist.get_backend()} mesh with state_specs' layouts "
            + (f"(KV {tuple(kv[0].placements)}, local "
               f"{tuple(kv[0].to_local().shape)}) " if kv else "")
            + f"decode step median {median(run['step_ms']):.3f} ms (min "
            f"{min(run['step_ms']):.3f}, max {max(run['step_ms']):.3f}); "
            f"meshless {median(base['step_ms']):.3f} ms (min "
            f"{min(base['step_ms']):.3f}, max {max(base['step_ms']):.3f}); "
            f"first divergent token "
            f"{first_divergence(run['tokens'], base['tokens'])}, max "
            f"|logits - meshless| "
            + str(max((a - b).abs().max().item() for a, b in
                      zip(run["logits"], base["logits"])))
            + f", distinct tokens a row "
            f"{[len(set(col)) for col in zip(*base['tokens'])]}; launches "
            f"{ {k: v for k, v in run['counts'].items() if v} }")
        checks.update({
            f"{arch}: the mesh run's tokens equal the meshless run's":
                run["tokens"] == base["tokens"],
            f"{arch}: the logits within {FLASH_TOL['bfloat16']} of the "
            f"meshless run's": max(
                (a - b).abs().max().item() for a, b in
                zip(run["logits"], base["logits"])) <= FLASH_TOL["bfloat16"],
            f"{arch}: every logit finite": run["finite"] and base["finite"],
            f"{arch}: the frozen row's state kept its bits":
                run["frozen_kept"] and base["frozen_kept"],
            f"{arch}: the mesh run's launches equal the meshless run's":
                run["counts"] == base["counts"],
            f"{arch}: the launches are the path's own":
                base["counts"] == want})
        for k, n in run["counts"].items():
            total[k] = total.get(k, 0) + n + base["counts"][k]
        del model, run, base
        release()
    check_all("context-parallel serve", checks)
    dist.destroy_process_group()
    for k, n in phase_cp_encdec(seed, card).items():
        total[k] = total.get(k, 0) + n
    release()
    dryruns = start_dryruns(CP_DRYRUN_CELLS)
    n = torch.cuda.device_count()
    if n >= 2:
        cp_cards(seed, card, n)
    else:
        say(f"[cp] one card ({card}): the (1, n) and (n/2, 2) meshes, whose "
            f"sequence is split over model, need two cards or more")
    dryrun_lines(dryruns, card)
    return total


def encdec_against_forward(seed: int, cfg, card: str, src, prompt) -> dict:
    """Full-width seamless-m4t-medium in ``cfg.compute_dtype``: ``encode``
    of the source frames ``src``, a ``prefill(memory=)`` of ``prompt``
    and ``ENCDEC_STEPS`` greedy ``decode_step(memory=)`` calls, the launch
    counters set to 0 just before; the prefill's and every step's logits
    held to the same model's no-grad ``forward`` over the same tokens
    (teacher-forced) within ``ENCDEC_TOL`` (absolute plus relative, as
    ``tests/test_models_smoke.py``); the prefill launches flash once an
    encoder layer, non-causal, and once a decoder layer, causal (the
    cross-attention takes ``flash_attention_xla``; a decode step launches
    nothing).  Returns the run's launches."""
    import torch
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import build_model
    model = build_model(cfg, device="cuda", seed=seed)
    b = prompt.shape[0]
    causal = []
    flash = attn_lib.flash_attention

    def recorded(*args, **kw):
        causal.append(kw.get("causal", True))
        return flash(*args, **kw)

    attn_lib.flash_attention = recorded
    try:
        with torch.no_grad():
            reset_counts()
            t0 = time.perf_counter()
            memory = model.encode(src)
            logits, states = model.prefill(
                prompt, model.init_states(b, ENCDEC_PROMPT + ENCDEC_STEPS),
                memory=memory)
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            calls = list(causal)
            got, toks, step_ms = [logits[:, 0].float()], [prompt], []
            pos = torch.full((b,), ENCDEC_PROMPT, dtype=torch.int32,
                             device="cuda")
            for _ in range(ENCDEC_STEPS):
                tok = logits.argmax(-1).to(torch.int32)
                toks.append(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, states = model.decode_step(tok, states, pos,
                                                   memory=memory)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                got.append(logits[:, 0].float())
                pos = pos + 1
            counts = read_counts()
            full = model(torch.cat(toks, dim=1), src_embeds=src)
    finally:
        attn_lib.flash_attention = flash
    want = full[:, ENCDEC_PROMPT - 1:].float()
    worst = max(((g - want[:, i]).abs()
                 - ENCDEC_TOL * want[:, i].abs()).max().item()
                for i, g in enumerate(got))
    raw = max((g - want[:, i]).abs().max().item() for i, g in enumerate(got))
    scale = want.abs().max().item()
    say(f"[cp] {ENCDEC} full width ({cfg.enc_layers} + {cfg.num_layers} "
        f"layers, vocab {cfg.vocab_size}), {cfg.compute_dtype}, on {card}: "
        f"encode of "
        f"{ENCDEC_FRAMES} frames and prefill of {b} x {ENCDEC_PROMPT} tokens "
        f"{prefill_ms:.2f} ms, {ENCDEC_STEPS} decode steps median "
        f"{median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}); against the teacher-forced forward: max "
        f"|decode - forward| {raw:.3e} (max|logits| {scale:.3f}; tol "
        f"{ENCDEC_TOL} + {ENCDEC_TOL} x |forward|); prefill flash launches "
        f"{len(calls)}: {calls.count(False)} non-causal, "
        f"{calls.count(True)} causal; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    check_all(f"{ENCDEC} serve {cfg.compute_dtype}", {
        "finite logits": all(bool(torch.isfinite(g).all()) for g in got),
        "decode logits within the teacher-forced forward's tolerance":
            worst <= ENCDEC_TOL,
        "one non-causal flash launch an encoder layer":
            calls.count(False) == cfg.enc_layers,
        "one causal flash launch a decoder layer":
            calls.count(True) == cfg.num_layers,
        "the prefill's launches are flash only":
            counts["flash"] == cfg.enc_layers + cfg.num_layers
            and sum(counts.values()) == counts["flash"],
    })
    del model, states, memory, full
    release()
    return counts


def phase_cp_encdec(seed: int, card: str) -> dict:
    """6d (b): full-width seamless-m4t-medium (12 + 12 layers, vocab
    256,206), weights from the seed, against its teacher-forced forward
    (``encdec_against_forward``) in bf16, as it serves, and once in
    float32, which tells the bf16 routes' share of the gap from the decode
    path's.  Then a 2 + 2-layer float32 cut, CPU against card: encode,
    prefill and 4 decode steps, logits within ``LOGIT_TOL``.  Returns the
    bf16 run's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Model
    cfg = get_config(ENCDEC)
    gen = torch.Generator().manual_seed(seed)
    b = 2
    src = torch.randn((b, ENCDEC_FRAMES, cfg.d_model), generator=gen).cuda()
    prompt = torch.randint(1, cfg.vocab_size, (b, ENCDEC_PROMPT),
                           generator=gen, dtype=torch.int32).cuda()
    counts = encdec_against_forward(seed, cfg, card, src, prompt)
    encdec_against_forward(seed, cfg.replace(compute_dtype="float32"), card,
                           src, prompt)
    cut = cfg.replace(num_layers=2, enc_layers=2, compute_dtype="float32")
    cpu = build_model(cut, device="cpu", seed=seed)
    gpu = Model(cut, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    src, prompt = src[:, :96].cpu(), prompt.cpu()
    logits = {}
    with torch.no_grad():
        side = {}
        for name, m in (("cpu", cpu), ("card", gpu)):
            dev = m.device
            memory = m.encode(src.to(dev))
            lg, st = m.prefill(prompt.to(dev), m.init_states(b, 80),
                               memory=memory)
            side[name] = (st, memory)
            logits[name] = [lg.cpu()]
        pos = torch.full((b,), ENCDEC_PROMPT, dtype=torch.int32)
        for _ in range(4):
            nxt = logits["cpu"][-1].argmax(-1).to(torch.int32)
            for name, m in (("cpu", cpu), ("card", gpu)):
                st, memory = side[name]
                lg, st = m.decode_step(nxt.to(m.device), st,
                                       pos.to(m.device), memory=memory)
                side[name] = (st, memory)
                logits[name].append(lg.cpu())
            pos = pos + 1
    worst = max((a - c).abs().max().item()
                for a, c in zip(logits["cpu"], logits["card"]))
    say(f"[parity] {ENCDEC} full width, 2 enc + 2 dec layers, float32, "
        f"encode of 96 frames, prefill of {b} x {ENCDEC_PROMPT} tokens and 4 "
        f"decode steps with the memory: max|cuda-cpu| logits {worst:.3e} "
        f"(tol {LOGIT_TOL})")
    check_all(f"{ENCDEC} serve parity", {
        "finite logits on the card": all(bool(torch.isfinite(lg).all())
                                         for lg in logits["card"]),
        f"logits within {LOGIT_TOL}": worst <= LOGIT_TOL})
    del cpu, gpu, side
    return counts


def cp_cut(arch: str):
    """The multi-card launches' model: full-width ``arch`` cut to
    ``max(2, len(block_pattern))`` layers (recurrentgemma's rec, rec,
    local), float32."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.replace(num_layers=max(2, len(cfg.block_pattern)),
                       compute_dtype="float32")


def cp_meshes(n: int) -> list:
    """The ``--cp-worker`` meshes on ``n`` cards: (1, n), and (n/2, 2)
    with four cards or more."""
    return [(1, n)] + ([(n // 2, 2)] if n >= 4 and n % 2 == 0 else [])


def cp_cards(seed: int, card: str, n: int) -> None:
    """6d (c): on ``n`` cards, ``CP_ARCHS`` at ``cp_cut``'s depth on each
    of ``cp_meshes(n)``, a launch of its own under
    ``torch.distributed.run`` (one process a card, this script's
    ``--cp-worker DPxMP`` mode).  Fails unless each rank's tokens equal
    the meshless run's on its card and the sequence was really split
    (each rank's KV shard holds fewer than ``CP_MAX_LEN`` slots and the
    context-parallel route ran)."""
    CP_CARDS_DIR.mkdir(parents=True, exist_ok=True)
    checks = {}
    for dp, mp in cp_meshes(n):
        label = f"{dp}x{mp}"
        out = CP_CARDS_DIR / f"{label}.json"
        out.unlink(missing_ok=True)
        t0 = time.perf_counter()
        rc, _, err = run_bounded(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={n}", str(ROOT / "chip_smoke.py"),
             "--seed", str(seed), "--cp-worker", label], CP_CARDS_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if rc or not out.exists():
            # the ranks' own tracebacks, before the launcher's summary
            lines = err.splitlines()
            ranked = [line for line in lines if line.startswith("[rank")]
            for line in (ranked or lines)[-40:]:
                say(f"[cp] {label} stderr| {line}")
            fail(f"the {label} context-parallel launch on {n} cards exited "
                 f"{rc}")
        got = json.loads(out.read_text())
        for arch, res in got.items():
            say(f"[cp] {arch} ({cp_cut(arch).num_layers} layers, float32) on "
                f"a {label} mesh of {n} cards under torch.distributed.run "
                f"(exit 0 in {wall:.1f} s wall, {card}): decode step median "
                f"{res['step_ms']:.3f} ms (meshless on one card "
                f"{res['base_step_ms']:.3f}); " + "; ".join(
                    f"{k} {v}" for k, v in res["checks"].items()))
            checks.update({f"{arch} {label}: {k}": v
                           for k, v in res["checks"].items()})
    check_all("context-parallel serve on cards", checks)


def cp_worker(seed: int, label: str) -> None:
    """One rank of a ``cp_cards`` launch under ``torch.distributed.run``:
    each of ``CP_ARCHS`` at ``cp_cut``'s depth served by ``cp_serve``
    meshless on this rank's card and on a ``label`` ("DPxMP") mesh of the
    cards, the context-parallel route's calls counted.  Rank 0 writes
    ``build/cp_cards/LABEL.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, spmd
    dp, mp = (int(v) for v in label.split("x"))
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:nccl")
    mesh = make_host_mesh((dp, mp), MESH_AXES, device="cuda")
    routed = [0]
    context = spmd.context_attention

    def counted(*args, **kw):
        routed[0] += 1
        return context(*args, **kw)

    spmd.context_attention = counted
    out = {}
    for arch in CP_ARCHS:
        cfg = cp_cut(arch)
        model = build_model(cfg, device="cuda", seed=seed)
        base = cp_serve(model, steps=8, seed=seed)
        routed[0] = 0
        run = cp_serve(model, mesh, steps=8, seed=seed)
        kv = [st.kv.k for st in run["states"] if st.kv is not None]
        split = all(t.to_local().shape[1] < t.shape[1] for t in kv)
        mine = {"tokens equal the meshless run's":
                run["tokens"] == base["tokens"],
                "finite logits": run["finite"],
                "the frozen row's state kept its bits": run["frozen_kept"]}
        if kv:
            mine["the sequence split over model"] = split and routed[0] > 0
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, mine)
        out[arch] = {"step_ms": median(run["step_ms"]),
                     "base_step_ms": median(base["step_ms"]),
                     "checks": {k: all(e[k] for e in everyone)
                                for k in mine}}
        del model, run, base
        release()
    if dist.get_rank() == 0:
        CP_CARDS_DIR.mkdir(parents=True, exist_ok=True)
        (CP_CARDS_DIR / f"{label}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------ 6f. MoE on a mesh
#: the ``model`` axis of phase 6f's four-card meshes, and the cards they
#: take
MOE_MP = 4
#: 6f(c): the full-depth serves through the CLI, (arch, mesh); phi3.5's
#: (2, 2) run is held to its (1, 4) run
MOE_FULL_CASES = (("phi3.5-moe-42b-a6.6b", "1x4", ("--mp", "4")),
                  ("llama4-scout-17b-a16e", "1x4", ("--mp", "4")),
                  ("phi3.5-moe-42b-a6.6b", "2x2", ("--mesh", "2x2")))
MOE_FULL_CLI = ("--requests", "8", "--max-new", "16", "--max-len", "256")
#: the 6f(c) runs whose tokens are compared (phi3.5's two layouts): their
#: routes are recorded, in a replay
ROUTED = tuple(f"full_{arch}_{label}" for arch, label, _ in MOE_FULL_CASES
               if arch == MOE_FULL_CASES[0][0])
#: where 6f's four-card runs write each rank's report and rank 0's routes
MOE_DIR = ROOT / "build" / "moe_mesh"
MOE_TIMEOUT_S = 900
#: the bf16 near-tie rule of 6f's token comparisons across layouts: two
#: layouts round a bf16 residual stream's sums in other orders, which
#: moves the router's float32 probabilities by about a bf16 rounding of
#: the logits (2^-9 relative, ~1e-3 of a probability after the softmax),
#: growing layer by layer; a top-k may flip only between experts whose
#: probabilities lie within one bf16 ulp of 1 of each other
BF16_ROUTE_MARGIN = 2.0 ** -7
#: 6f(a)'s routes, by arch: what each MoE call of its 1-rank mesh run
#: decided (equal to phase 6e's, whose tokens and launches it gives)
MOE_ROUTES: dict = {}


def record_moe_routes(routes: list):
    """Keep what the router decides at every MoE call in ``routes``
    (``models.moe.routing`` on the call's tokens, gathered whole on a
    mesh; kept on the device until read): the same decisions on any
    layout, so two runs compare call by call.  Returns the undo."""
    from repro_torch.models import moe, spmd
    orig = moe.moe_ffn

    def recorded(params, x, **kw):
        xt = spmd.whole(x).reshape(-1, x.shape[-1])
        r = moe.routing({"router": spmd.whole(params["router"])}, xt,
                        kw["top_k"], kw["capacity_factor"])
        routes.append({k: r[k] for k in ("probs", "gate_idx", "keep")})
        return orig(params, x, **kw)

    moe.moe_ffn = recorded
    return lambda: setattr(moe, "moe_ffn", orig)


def on_host(routes: list) -> list:
    return [{k: v.cpu() for k, v in r.items()} for r in routes]


def replayed_routes(engine, reqs: list, drive, tokens: dict) -> list:
    """The routes (``record_moe_routes``, on the host) of ``reqs`` — fresh
    copies of a timed run's requests — driven through ``drive`` on
    ``engine``, a second engine over the timed run's weights: the
    recorder is never on a timed drive.  Fails unless the replay gives
    the timed run's ``tokens`` (rid -> tokens), so its routes are that
    run's."""
    routes: list = []
    undo = record_moe_routes(routes)
    try:
        drive(engine, reqs)
    finally:
        undo()
    if {r.rid: r.generated for r in reqs} != tokens:
        fail("the recorded replay's tokens are not the timed run's")
    return on_host(routes)


def route_parting(want: list, got: list, layers: int) -> tuple[str, bool]:
    """Where two runs' routings (``record_moe_routes``, the same calls in
    the same order) first part: the MoE call, its flips and how far the
    two runs' probabilities lie apart there, and whether that first
    parting is at near-ties (``BF16_ROUTE_MARGIN``, phase 4's rule:
    ``moe.routing_flips``); every later call follows from it.  Says so
    where the routings never part (then False: the tokens parted on
    their own)."""
    from repro_torch.models import moe
    for i, (w, g) in enumerate(zip(want, got)):
        if w["probs"].shape != g["probs"].shape:
            return (f"MoE call {i}: {tuple(w['probs'].shape)} against "
                    f"{tuple(g['probs'].shape)} tokens: the runs' calls do "
                    f"not line up", False)
        flips = moe.routing_flips(w, g, BF16_ROUTE_MARGIN)
        if not (flips["gate"] or flips["keep"]):
            continue
        wi, gi, probs = w["gate_idx"], g["gate_idx"], w["probs"]
        gaps = [abs(float(probs[n, wi[n, k]] - probs[n, gi[n, k]]))
                for n, k in flips["gate"]]
        drift = float((w["probs"] - g["probs"]).abs().max())
        near = not flips["unexplained"]
        return (f"routings first part at MoE call {i} (model call "
                f"{i // layers}, layer {i % layers}): top-k flips "
                f"{flips['gate'][:6]} at probability gaps "
                f"{[float(f'{x:.3e}') for x in gaps[:6]]}, keep flips "
                f"{flips['keep'][:6]}, the runs' probabilities "
                f"{drift:.3e} apart there at most; "
                + (f"near-ties within {BF16_ROUTE_MARGIN}" if near else
                   f"NOT near-ties within {BF16_ROUTE_MARGIN}: "
                   f"{flips['unexplained'][:6]}"), near)
    return (f"routings never part over {min(len(want), len(got))} MoE "
            f"calls", False)


def tokens_or_near_tie(what: str, got: dict, want: dict, routes) -> bool:
    """Whether ``got`` and ``want`` (rid -> tokens) are equal, or part
    where the routings first part at near-ties (``routes``: the two runs'
    routes and the layers a model call); a parting is printed."""
    if got == want:
        return True
    first = first_divergence([got[k] for k in sorted(want)],
                             [want[k] for k in sorted(want)])
    line, near = route_parting(*routes)
    say(f"[moe mesh] {what}: tokens differ, first divergent {first}; "
        + line)
    return near


def moe_bank_line(cfg, mp: int) -> str:
    """The expert-bank bytes a decode tick reads (on a rank of a ``model``
    axis of ``mp``: its ``num_experts / mp`` experts' three bf16 banks,
    each layer; the einsum route multiplies every bank it holds) beside
    their time at 3.35 TB/s."""
    from repro_torch.core.h100 import HBM_BW
    banks = 3.0 * cfg.num_experts // mp * cfg.d_model * cfg.d_ff * 2 \
        * cfg.num_layers
    return (f"a tick reads {banks / 1e9:.2f} GB of bf16 expert banks"
            + (" a rank" if mp > 1 else "")
            + f" ({cfg.num_experts // mp} experts x {cfg.num_layers} layers),"
            f" {1e3 * banks / HBM_BW:.2f} ms at 3.35 TB/s")


def param_gib(model) -> float:
    """The GiB of ``model``'s parameters this rank holds (a DTensor's local
    shard)."""
    from repro_torch.models import spmd
    return sum((p.to_local() if spmd.is_dtensor(p) else p).numel()
               * p.element_size() for p in model.parameters()) / 2 ** 30


def expected_gib(cfg, label: str, strategy: str = "tp") -> list:
    """The parameter GiB each rank of a ``label`` ("DPxMP") mesh holds
    under ``param_specs``, counted on a ``meta`` model: rank order."""
    import itertools
    from types import SimpleNamespace
    from repro_torch.launch import shardings as sh
    from repro_torch.models.transformer import Model
    shape = tuple(int(v) for v in label.split("x"))
    mesh = SimpleNamespace(mesh_dim_names=MESH_AXES,
                           size=lambda m: shape[m])
    model = Model(cfg, "meta")
    specs = sh.param_specs(cfg, model, strategy)
    params = dict(model.named_parameters())
    return [sum(sh.local_cut(p, sh.to_placements(specs[n], mesh), shape,
                             at).numel() * p.element_size()
                for n, p in params.items()) / 2 ** 30
            for at in itertools.product(*map(range, shape))]


def timed_steps(engine, times: list) -> None:
    """Time every ``engine.step()`` that only decodes (no prefill call or
    chunk in it) into ``times`` (ms): the decode step's distribution."""
    step, st = engine.step, engine.stats

    def timed(*args, **kw):
        before = (st.decode_steps, st.prefill_calls, st.prefill_chunks)
        t0 = time.perf_counter()
        out = step(*args, **kw)
        ms = 1e3 * (time.perf_counter() - t0)
        if st.decode_steps > before[0] \
                and (st.prefill_calls, st.prefill_chunks) == before[1:]:
            times.append(ms)
        return out

    engine.step = timed


def moe_rank_report(label: str, engine, tokens: dict, counts: dict,
                    steps: list) -> None:
    """One rank's report of a 6f four-card run in ``MOE_DIR``, made just
    after the timed drive: its tokens, launches, parameter GiB, peak
    memory and decode steps."""
    import torch
    rank = int(os.environ["RANK"])
    s = engine.stats.summary()
    MOE_DIR.mkdir(parents=True, exist_ok=True)
    (MOE_DIR / f"{label}_{rank}.json").write_text(json.dumps({
        "rank": rank, "tokens": tokens, "counts": counts,
        "param_gib": param_gib(engine.model),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "decode_ms": median(steps) if steps else float("nan"),
        "decode_steps": s["decode_steps"],
        "prefill_calls": s["prefill_calls"],
        "tokens_per_s": s["tokens_per_s"], "ttft_ms": s["ttft_ms"]}))


def save_routes(label: str, routes: list) -> None:
    """Rank 0 keeps a 6f four-card run's replayed routes in ``MOE_DIR``."""
    import torch
    if int(os.environ["RANK"]) == 0:
        torch.save(routes, MOE_DIR / f"routes_{label}.pt")


def moe_cut_worker(seed: int) -> None:
    """One rank of 6f(b) under ``torch.distributed.run``: each MoE arch at
    phase 6e's depth (``MOE_SERVE_LAYERS``) built shard by shard on a (1,
    ``MOE_MP``) mesh through ``build_engine(mesh=)`` and served as 6e
    serves it (``serve_auto``'s build and warmup, phase 6's requests and
    drive), the launches counted from 0 just before the timed drive; each
    rank reports (``moe_rank_report``), then records the routes in a
    replay on a second engine over the same weights
    (``replayed_routes``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.serve import build_engine
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    mesh = make_serve_mesh(1, MOE_MP)
    for arch in MOE_ARCHS:
        cfg = get_config(arch).replace(num_layers=MOE_SERVE_LAYERS[arch])
        torch.cuda.reset_peak_memory_stats()
        kw = dict(policy="auto", plan_cfg=get_config(arch), slots=4,
                  max_len=1024, kv_block_size=16, max_bucket=256, mesh=mesh)
        engine = build_engine(cfg, seed=seed, **kw)
        engine.warmup()
        reqs = serve_requests(cfg, seed)
        steps: list = []
        timed_steps(engine, steps)
        reset_counts()
        serve_drive(engine, reqs)
        counts = read_counts()
        tokens = {r.rid: r.generated for r in reqs}
        moe_rank_report(f"cut_{arch}", engine, tokens, counts, steps)
        save_routes(f"cut_{arch}", replayed_routes(
            build_engine(cfg, engine.model, **kw), serve_requests(cfg, seed),
            serve_drive, tokens))
        del engine
        release()
    dist.barrier()
    dist.destroy_process_group()


def moe_cli_worker(label: str, cli: list) -> None:
    """One rank of a 6f(c) run under ``torch.distributed.run``: the serving
    CLI's ``main(cli)`` (its ``build_engine`` watched to read the engine,
    its decode steps timed), the launch counters set to 0 just before
    it; each rank reports (``moe_rank_report``) as the CLI's run returns.
    Where the run's tokens are compared (``ROUTED``), the CLI's requests
    are then replayed on a second engine over the same weights with the
    routes recorded (``replayed_routes``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import serve
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.cuda.reset_peak_memory_stats()
    steps: list = []
    build = serve.build_engine

    def watched(*args, **kw):
        engine = build(*args, **kw)
        timed_steps(engine, steps)
        run = engine.run

        def kept(reqs, *a, **k):
            fresh = copy.deepcopy(reqs)
            out = run(reqs, *a, **k)
            tokens = {r.rid: r.generated for r in reqs}
            moe_rank_report(label, engine, tokens, read_counts(), steps)
            # before the CLI ends its process group
            if label in ROUTED:
                save_routes(label, replayed_routes(
                    build(*args, model=engine.model, **kw), fresh,
                    lambda e, rs: e.run(rs), tokens))
            return out

        engine.run = kept
        return engine

    serve.build_engine = watched
    reset_counts()
    serve.main(cli)


def moe_torchrun(what: str, worker: list) -> float:
    """``worker`` (this script's options) under ``torch.distributed.run``
    over ``MOE_MP`` cards; fails unless it exits 0.  Returns its wall."""
    t0 = time.perf_counter()
    rc, out, err = run_bounded(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={MOE_MP}", str(Path(__file__).resolve()),
         *worker], MOE_TIMEOUT_S)
    if rc:
        for line in (out.splitlines() + err.splitlines())[-40:]:
            say(f"[moe mesh] {what} | {line}")
        fail(f"{what} exited {rc}")
    return time.perf_counter() - t0


def moe_reports(label: str) -> list:
    """Every rank's report of a 6f run, rank order."""
    return [json.loads((MOE_DIR / f"{label}_{r}.json").read_text())
            for r in range(MOE_MP)]


def path_launches(cfg, rep: dict) -> bool:
    """A rank's launches are the paged path's own: one flash launch a
    layer and prefill call, one paged launch a layer and decode step,
    nothing else."""
    n = cfg.layer_kinds.count("attn")
    return {k: v for k, v in rep["counts"].items() if v} == {
        "flash": n * rep["prefill_calls"], "paged": n * rep["decode_steps"]}


def phase_moe_mesh(seed: int, card: str) -> dict:
    """6f(a): each MoE cut of phase 6e served again through
    ``build_engine(mesh=make_serve_mesh())`` — a 1-rank NCCL group, so
    its weights are drawn shard by shard (``launch.shardings.
    build_distributed_model``) — with 6e's requests: its tokens and
    launches must be 6e's.  Its routes are recorded afterwards in a
    replay on an engine built again from the seed (``replayed_routes``).
    Returns the launches, added."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.serve import build_engine
    mesh = make_serve_mesh()
    total: dict = {}
    for arch in MOE_ARCHS:
        base = SERVED[arch]
        kw = dict(base["engine_kw"], mesh=mesh, seed=seed)
        run = serve_auto(arch, base["cfg"], None, card, kw,
                         base["make_requests"], base["drive"],
                         label=" mesh 1x1 sharded build")
        MOE_ROUTES[arch] = replayed_routes(
            build_engine(base["cfg"], policy="auto",
                         plan_cfg=get_config(arch), **kw),
            base["make_requests"](), base["drive"],
            {r.rid: r.generated for r in run["reqs"]})
        release()
        s, s0 = run["s"], base["s"]
        say(f"[moe mesh] {arch} ({base['cfg'].num_layers} layers) built "
            f"shard by shard on a 1-rank mesh on {card}: decode step "
            f"{s['decode_step_ms']:.3f} ms ({s0['decode_step_ms']:.3f} ms "
            f"without the mesh), {s['tokens_per_s']:.1f} tokens/s "
            f"({s0['tokens_per_s']:.1f}), launches {run['counts']}")
        check_all(f"moe mesh {arch}", {
            "tokens equal phase 6e's meshless run's":
                [r.generated for r in run["reqs"]]
                == [r.generated for r in base["reqs"]],
            "launches equal phase 6e's meshless run's":
                run["counts"] == base["counts"]})
        for k, n in run["counts"].items():
            total[k] = total.get(k, 0) + n
        release()
    dist.destroy_process_group()
    return total


def moe_mesh_cards(seed: int, card: str, n: int) -> None:
    """6f(b) and (c) on ``n`` >= ``MOE_MP`` cards, each run under
    ``torch.distributed.run`` over ``MOE_MP`` of them, one process a card.
    (b): the cuts of 6e on (1, 4) (``moe_cut_worker``): every rank's
    launches 6e's and its tokens 6e's one-card meshless tokens, or parted
    where the routing first parts at a near-tie (printed: bf16 sums in
    another order).  (c): both archs at full depth on (1, 4) through the
    CLI and phi3.5-moe also on (2, 2) (``MOE_FULL_CASES``,
    ``moe_cli_worker``): each exits 0, each rank's launches are the path's
    own, phi3.5's (2, 2) tokens its (1, 4) tokens or parted at a near-tie.
    Every rank holds its specs' parameter GiB.  Each run prints a ``[moe
    full]`` line a rank; the checks are made once every run has ended."""
    import torch
    from repro_torch.configs import get_config
    if n < MOE_MP:
        say(f"[moe mesh] {n} card(s): 6f(b) and (c) need {MOE_MP}")
        return
    checks = {}
    wall = moe_torchrun("6f(b) cuts on 1x4",
                        ["--seed", str(seed), "--moe-cut-worker"])
    say(f"[moe mesh] 6f(b): {wall:.1f} s wall, processes' start and kernel "
        f"builds included")
    for arch in MOE_ARCHS:
        base = SERVED[arch]
        cfg = base["cfg"]
        reps = moe_reports(f"cut_{arch}")
        gib = expected_gib(cfg, f"1x{MOE_MP}")
        for rep in reps:
            moe_full_line(f"{arch} cut to {cfg.num_layers} layers, 1x"
                          f"{MOE_MP}", cfg, rep, gib, card, MOE_MP)
        what = f"{arch} cut on 1x{MOE_MP}"
        checks.update({
            f"{what}: 6e's tokens, or parted at a near-tie":
                tokens_or_near_tie(
                    f"{what} against 6e", reps[0]["tokens"],
                    {str(r.rid): r.generated for r in base["reqs"]},
                    (MOE_ROUTES[arch],
                     torch.load(MOE_DIR / f"routes_cut_{arch}.pt"),
                     cfg.num_layers)),
            f"{what}: every rank's launches are 6e's": all(
                rep["counts"] == base["counts"] for rep in reps),
            **rank_checks(what, reps, gib)})
    full = {}
    for arch, label, mesh in MOE_FULL_CASES:
        cfg = get_config(arch)
        tag = f"full_{arch}_{label}"
        wall = moe_torchrun(f"6f(c) {arch} {label}", [
            "--moe-cli-worker", tag, "--arch", arch, "--seed", str(seed),
            *MOE_FULL_CLI, *mesh])
        reps = full[label, arch] = moe_reports(tag)
        gib = expected_gib(cfg, label)
        mp = int(label.split("x")[1])
        for rep in reps:
            moe_full_line(f"{arch} full depth, {label}", cfg, rep, gib, card,
                          mp)
        say(f"[moe full] {arch} {label}: {wall:.1f} s wall for the run "
            f"(processes' start, kernel builds and the sharded build "
            f"included)")
        what = f"{arch} full depth on {label}"
        checks.update({
            f"{what}: every rank's launches are the path's own": all(
                path_launches(cfg, rep) for rep in reps),
            f"{what}: every request generated its 16 tokens":
                len(reps[0]["tokens"]) == 8 and all(
                    len(t) == 16 for t in reps[0]["tokens"].values()),
            **rank_checks(what, reps, gib)})
    arch = MOE_FULL_CASES[0][0]
    checks[f"{arch} full depth: 2x2's tokens 1x{MOE_MP}'s, or parted at a "
           f"near-tie"] = tokens_or_near_tie(
        f"{arch} full depth, 2x2 against 1x{MOE_MP}",
        full["2x2", arch][0]["tokens"], full["1x4", arch][0]["tokens"],
        (torch.load(MOE_DIR / f"routes_full_{arch}_1x4.pt"),
         torch.load(MOE_DIR / f"routes_full_{arch}_2x2.pt"),
         get_config(arch).num_layers))
    check_all("moe mesh cards", checks)


def rank_checks(what: str, reps: list, gib: list) -> dict:
    """Every rank of a 6f run served the same tokens and holds its specs'
    parameter GiB (``expected_gib``)."""
    return {
        f"{what}: every rank's tokens alike": all(
            rep["tokens"] == reps[0]["tokens"] for rep in reps),
        f"{what}: every rank holds its specs' parameter GiB": all(
            abs(rep["param_gib"] - g) <= 1e-6 * g
            for rep, g in zip(reps, gib))}


def moe_full_line(what: str, cfg, rep: dict, gib: list, card: str,
                  mp: int) -> None:
    """A rank's ``[moe full]`` line: its parameter GiB beside the specs'
    count, its peak memory, the decode step median, tokens/s, TTFT and
    the expert-bank bytes a tick reads on a rank of a ``model`` axis of
    ``mp``."""
    say(f"[moe full] {what} rank {rep['rank']} on {card}: parameters "
        f"{rep['param_gib']:.3f} GiB (specs' count "
        f"{gib[rep['rank']]:.3f}), torch.cuda.max_memory_allocated() "
        f"{rep['peak_gib']:.2f} GiB, decode step median "
        f"{rep['decode_ms']:.2f} ms over {rep['decode_steps']} steps, "
        f"{rep['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{rep['ttft_ms']['p50']:.2f} ms (mean {rep['ttft_ms']['mean']:.2f}"
        f"), launches {({k: v for k, v in rep['counts'].items() if v})}; "
        + moe_bank_line(cfg, mp))


# ---------------------------------------------------------------- 7. train
#: the train phase's geometry: global batch 8 of 128 tokens in 2
#: microbatches, bf16 compute on float32 masters
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 8, 128, 2


def phase_train(seed: int, card: str, arch: str, steps: int) -> dict:
    """``arch`` at full width through ``launch.train.train_once`` on the
    card for ``steps`` steps (the reference's cosine schedule, lr 3e-4,
    warmup 5 steps from 0: step 0 moves nothing), then one no-grad
    forward of the next batch (an evaluation: the kernels' route).  The
    launch counters are set to 0 just before and read just after: the train
    steps run under autograd and launch no kernel; the evaluation launches
    flash once a self-attention layer (the encoder's too).  Prints each
    step's loss, lr and grad norm, the median step, the peak memory and the
    share of parameter tensors that moved from the init; then one more
    step of the same trainer under ``torch.profiler`` (after the counts
    are read): the card's busy and idle share and its top kernels."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import train_once
    from repro_torch.models import build_model
    from repro_torch.obs.timing import profile_trace
    from repro_torch.train import make_train_step, optim
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics: list = []
    reset_counts()
    run = train_once(cfg, steps=steps, global_batch=TRAIN_BATCH,
                     seq_len=TRAIN_SEQ, ckpt_dir=None, ckpt_every=0,
                     seed=seed, accum_steps=TRAIN_ACCUM, log_every=1,
                     metrics_out=metrics, device="cuda")
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t0
    model = run["model"]
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=seed, encdec=cfg.is_encdec,
        d_model=cfg.d_model))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch(steps).items()}
    with torch.no_grad():
        eval_loss, _ = model.loss(batch)
    eval_loss = float(eval_loss)
    counts = read_counts()
    init = build_model(cfg, "cuda", seed=0, train=True)
    moved = sum(not torch.equal(p, q) for p, q in
                zip(run["params"].values(), init.parameters()))
    n_tensors = len(run["params"])
    del init
    step_ms = sorted(1e3 * t for t in run["step_s"])
    losses = [run["losses"][i] for i in range(steps)]
    n_params = sum(p.numel() for p in run["params"].values())
    attn = cfg.enc_layers + sum(k in ("attn", "dec")
                                for k in cfg.layer_kinds)
    say(f"[train] {arch} full width on {card}: {cfg.num_layers} layers"
        f"{f' + {cfg.enc_layers} encoder layers' if cfg.is_encdec else ''}"
        f", {n_params / 1e6:.1f} M parameters (float32 masters, bf16 "
        f"compute), global batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{TRAIN_ACCUM} microbatches, {steps} steps of train_once: losses "
        f"{[round(v, 4) for v in losses]}, step ms {[round(v, 1) for v in step_ms]} "
        f"(median {step_ms[len(step_ms) // 2]:.1f}), peak memory "
        f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated), "
        f"{wall:.1f} s with the model's init; {moved} of {n_tensors} "
        f"parameter tensors moved; evaluation loss {eval_loss:.4f}; "
        f"launches in training {train_counts}, with the evaluation "
        f"{counts}")
    TRAINED[arch] = {"losses": losses,
                     "grad_norms": [run["grad_norms"][i] for i in range(steps)],
                     "step_ms": step_ms, "peak": peak}
    check_all(f"train {arch}", {
        "every loss finite": all(math.isfinite(v) for v in losses),
        "evaluation loss finite": math.isfinite(eval_loss),
        "every parameter tensor moved": moved == n_tensors,
        "no kernel launched under autograd": not any(train_counts.values()),
        f"the evaluation launched flash {attn} times and nothing else":
            {k: v for k, v in counts.items() if v} == {"flash": attn},
    })
    # where a step's time goes: one more step (step `steps`) profiled
    step = make_train_step(model, accum_steps=TRAIN_ACCUM,
                           schedule=optim.cosine_schedule(
                               3e-4, warmup=max(steps // 20, 5),
                               total=steps))
    with profile_trace(ROOT / "build" / "train_profile" / arch,
                       device=torch.device("cuda"), top=8) as prof:
        step(run["params"], run["opt_state"], batch)
    busy = "not measured (no device events)" \
        if prof["device_busy_ms"] is None else \
        f"{prof['device_busy_ms']:.1f} ms (idle " \
        f"{prof['device_idle_share']:.1%})"
    say(f"[train] {arch} one step under torch.profiler on {card}: wall "
        f"{prof['wall_ms']:.1f} ms, the card busy {busy}, "
        f"{prof['kernel_launches']} kernel launches; top kernels by device "
        f"time: " + "; ".join(f"{k['name'][:60]} {k['ms']:.2f} ms x "
                              f"{k['launches']}" for k in prof["top_kernels"]))
    del model, run, batch, step
    release()
    return counts


#: a resumed run's losses against the uninterrupted run's on the card:
#: restore is exact, but autograd on CUDA is not bit-reproducible (the
#: embedding's backward adds with atomics), float32 compute
RESUME_TOL = 1e-4


def phase_train_resume(seed: int) -> None:
    """Reduced smollm-135m (float32 compute) through ``train_once`` on the
    card with checkpoints every 4 steps: an uninterrupted 12-step run, and
    one that fails at step 9 and auto-resumes from step 8's checkpoint
    under ``run_with_restarts``; losses compared step by step."""
    import shutil
    from repro_torch.configs import reduced_config
    from repro_torch.ft.watchdog import FailureInjector, run_with_restarts
    from repro_torch.launch.train import train_once
    cfg = reduced_config("smollm-135m").replace(compute_dtype="float32")
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=12, global_batch=4, seq_len=32, ckpt_every=4,
              log_every=100, seed=seed, device="cuda")
    ref = train_once(cfg, ckpt_dir=str(root / "ref"), **kw)["losses"]
    injector = FailureInjector(fail_at_step=9)
    metrics: list = []
    restarts = run_with_restarts(
        lambda: train_once(cfg, ckpt_dir=str(root / "ft"), injector=injector,
                           metrics_out=metrics, **kw), max_restarts=2)
    got = dict(metrics)
    worst = max(abs(got[s] - ref[s]) for s in range(12))
    say(f"[train] resume on the card (reduced smollm-135m, float32, 12 steps,"
        f" checkpoints every 4, a failure injected at step 9): {restarts} "
        f"restart, steps run {sorted(got)}; max|resumed - uninterrupted| "
        f"loss {worst:.3e} (tol {RESUME_TOL}); steps 0-8 bit for bit: "
        f"{all(got[s] == ref[s] for s in range(9))}")
    check_all("train resume", {
        "one restart": restarts == 1,
        "every step logged": sorted(got) == list(range(12)),
        f"losses within {RESUME_TOL}": worst <= RESUME_TOL,
    })
    shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------------------- 7b. train mesh
#: phase 7's meshless runs: losses, grad norms, step ms and peak by arch
TRAINED: dict = {}

#: phase 7b's 1-rank mesh against phase 7's meshless run of qwen3-0.6b
#: (bf16 compute, relative): the same operations but the loss's (a max,
#: a sum of exponentials and the gold logit in place of logsumexp), and
#: CUDA's atomic adds (the embedding's backward) in both
TRAIN_MESH_RTOL = {"loss": 1e-3, "grad_norm": 1e-2}

#: the multi-card meshes (float32 compute) against the one-card meshless
#: run: partial sums over the cards in other orders
TRAIN_MESH_N_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}

#: the multi-card runs' depth: full-width qwen3-0.6b cut to 2 layers
TRAIN_MESH_LAYERS = 2
TRAIN_MESH_DIR = ROOT / "build" / "train_mesh"
TRAIN_MESH_TIMEOUT_S = 300
MESH_AXES = ("data", "model")

#: the dry runs phase 7b prints: qwen3-0.6b's train_4k cell on the
#: reference's single- and multi-pod meshes, on a fake group on the host
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", "single"),
                ("qwen3-0.6b", "train_4k", "multi"))
DRYRUN_DIR = ROOT / "build" / "dryrun_torch"
DRYRUN_TIMEOUT_S = 900


def start_dryruns(cells=DRYRUN_CELLS) -> list:
    """``cells`` in processes of their own on the host (each a CPU process
    on ``meta`` tensors, seconds to half a minute), started after a
    phase's timed runs so that they load the host during no timed phase;
    ``dryrun_lines`` waits for them.  Each is killed when this script
    exits."""
    import atexit
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for arch, shape, mesh in cells:
        (DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json").unlink(missing_ok=True)
        procs.append(((arch, shape, mesh), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out",
             str(DRYRUN_DIR)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     OMP_NUM_THREADS="1"))))

    def stop():
        for _, proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    atexit.register(stop)
    return procs


def train_mesh_group() -> None:
    """A 1-rank default group on the card that also takes host tensors
    (NCCL for the card's, gloo for the host's), on an in-process store."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)


def train_steps(model, mesh, data, steps: int, accum: int) -> dict:
    """``steps`` train steps of ``model`` (phase 7's schedule): on
    ``mesh`` a DTensor model, each batch laid out by ``batch_specs``;
    with ``mesh`` None the plain model, meshless.  Losses, grad norms,
    step ms (the batch's copy, the step and a sync), params and state."""
    import torch
    from repro_torch.launch import shardings as sh
    from repro_torch.obs.timing import Timed
    from repro_torch.train import make_train_step, optim
    step_fn = make_train_step(model, accum_steps=accum,
                              schedule=optim.cosine_schedule(
                                  3e-4, warmup=max(steps // 20, 5),
                                  total=steps))
    params = dict(model.named_parameters())
    state = optim.adamw_init(params)
    specs = None if mesh is None else sh.batch_specs(model.cfg, mesh,
                                                     TRAIN_BATCH)
    out = {"losses": [], "grad_norms": [], "step_ms": []}
    for step in range(steps):
        with Timed("step", device=torch.device("cuda")) as tm:
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in data.batch(step).items()}
            if mesh is not None:
                batch = {k: sh.local_part(v, mesh,
                                          sh.to_placements(specs[k], mesh))
                         for k, v in batch.items()}
            params, state, m = step_fn(params, state, batch)
            tm.sync()
        out["step_ms"].append(1e3 * tm.dur)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out.update(params=params, state=state)
    return out


def synthetic(cfg, seed: int):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=seed))


def seeded_train_model(cfg):
    """``cfg``'s train model on the card with ``train_once``'s init (a
    generator on the card seeded with 0)."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg, "cuda", train=True)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    return model


def worst_rel(got: dict, want: dict) -> dict:
    """The largest relative difference of ``got``'s losses and grad norms
    from ``want``'s, step by step."""
    return {k: max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(got[series], want[series]))
            for k, series in (("loss", "losses"),
                              ("grad_norm", "grad_norms"))}


def psum_bits(seed: int, cuda_mesh, cpu_mesh) -> tuple[bool, str]:
    """``train.grad.compressed_psum`` of the same inputs on the card's
    NCCL group and the host's gloo group: (bit for bit, what was held)."""
    import torch
    from repro_torch.train import grad
    gen = torch.Generator().manual_seed(seed)
    g = {"w": torch.randn(1024, 1024, generator=gen),
         "b": 3 * torch.randn(4096, generator=gen)}
    e = {k: 1e-2 * torch.randn(v.shape, generator=gen) for k, v in g.items()}
    mc, ec = grad.compressed_psum(g, e, cpu_mesh)
    mg, eg = grad.compressed_psum({k: v.cuda() for k, v in g.items()},
                                  {k: v.cuda() for k, v in e.items()},
                                  cuda_mesh)
    same = all(torch.equal(mc[k], mg[k].cpu()) and torch.equal(
        ec[k], eg[k].cpu()) for k in g)
    return same, (f"{sum(v.numel() for v in g.values())} values in "
                  f"{len(g)} leaves")


def dryrun_lines(procs: list, card: str) -> None:
    """Wait for ``start_dryruns``'s cells and print each record: FLOPs a
    device, collectives, one rank's argument bytes against the card's
    memory.  Fails unless each is ``ok``."""
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    checks = {}
    for (arch, shape, mesh), proc in procs:
        try:
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            fail(f"the dry run of {arch} {shape} {mesh} did not end within "
                 f"{DRYRUN_TIMEOUT_S} s")
        path = DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json"
        if proc.returncode or not path.exists():
            for line in err.splitlines()[-20:]:
                say(f"[dryrun] stderr| {line}")
            fail(f"the dry run of {arch} {shape} {mesh} exited "
                 f"{proc.returncode}")
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            fail(f"dry run {arch} {shape} {mesh}: {rec.get('error')}")
        c, mem = rec["collectives"], rec["memory"]
        args = mem["argument_size_in_bytes"]
        step = f"one train step in {rec['trace_s']} s, " \
            f"{rec['meta']['accum_steps']} microbatches" \
            if "accum_steps" in rec["meta"] else \
            f"one {shape} step in {rec['trace_s']} s, states " \
            f"{mem['state_size_in_bytes'] / 2 ** 30:.3f} GiB a device " \
            f"({mem['state_size_in_bytes'] / total:.2%} of the card)"
        say(f"[dryrun] {arch} {shape} {mesh} on a fake group of "
            f"{rec['n_devices']} ranks {rec['mesh_shape']} (host, meta "
            f"tensors, torch {torch.__version__}): {step};"
            f" {rec['flops']:.4g} FLOPs a device ({rec['flops_counts']}); "
            f"collectives {c['counts']}, wire bytes a device "
            f"{c['total_wire_bytes']:.4g} "
            f"({ {k: f'{v:.4g}' for k, v in c['wire_bytes'].items()} }); "
            f"arguments {args / 2 ** 30:.3f} GiB a device "
            f"({args / total:.2%} of {card}'s {total / 2 ** 30:.1f} GiB); "
            f"parameters {rec['meta']['param_bytes'] / 2 ** 30:.3f} GiB in "
            f"all (float32)"
            + (f", {rec['meta']['serving_param_bytes'] / 2 ** 30:.3f} GiB "
               f"as the serving build holds them"
               if "serving_param_bytes" in rec["meta"] else ""))
        checks[f"{arch} {shape} {mesh}: a rank's arguments fit the card"] = \
            args < total
    check_all("dry run", checks)


def phase_train_mesh(seed: int, card: str) -> dict:
    """Phase 7's qwen3-0.6b run again on a 1-rank NCCL mesh: the same
    init, data, schedule and geometry through ``make_train_step`` on
    DTensor parameters (``shardings.distribute_models``) and a batch laid
    out by ``batch_specs``; launch counters set to 0 just before and read
    just after (autograd: none).  Losses and grad norms held to phase 7's
    within ``TRAIN_MESH_RTOL``; prints the step ms and peak memory beside
    phase 7's.  Then the dry runs start (``start_dryruns``), and while they
    run ``compressed_psum`` on the card's NCCL group is held to the host's
    gloo group, bit for bit; then the dry runs' records
    (``dryrun_lines``); then, on two cards or more, ``train_mesh_cards``.
    Returns the launches of the mesh run."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh
    arch = "qwen3-0.6b"
    cfg, base = get_config(arch), TRAINED[arch]
    steps = len(base["losses"])
    train_mesh_group()
    mesh = make_host_mesh((1, 1), MESH_AXES, device="cuda")
    model = sh.distribute_models([seeded_train_model(cfg)], mesh)[0]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_steps(model, mesh, synthetic(cfg, seed), steps,
                      TRAIN_ACCUM)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    worst = worst_rel(run, base)
    med = sorted(run["step_ms"])[len(run["step_ms"]) // 2]
    say(f"[train mesh] {arch} full width on a 1-rank "
        f"{dist.get_backend()} mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
        f"on {card}: DTensor parameters, {steps} steps of make_train_step "
        f"(global batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_ACCUM} "
        f"microbatches, phase 7's init, data and schedule): losses "
        f"{[round(v, 5) for v in run['losses']]} (phase 7 "
        f"{[round(v, 5) for v in base['losses']]}), grad norms "
        f"{[round(v, 4) for v in run['grad_norms']]} (phase 7 "
        f"{[round(v, 4) for v in base['grad_norms']]}); worst relative "
        f"difference loss {worst['loss']:.3e} (tol "
        f"{TRAIN_MESH_RTOL['loss']}), grad norm {worst['grad_norm']:.3e} "
        f"(tol {TRAIN_MESH_RTOL['grad_norm']}); step ms "
        f"{[round(v, 1) for v in sorted(run['step_ms'])]} (median {med:.1f}"
        f"; phase 7 median "
        f"{base['step_ms'][len(base['step_ms']) // 2]:.1f}), peak memory "
        f"{peak / 2 ** 30:.2f} GiB (phase 7 {base['peak'] / 2 ** 30:.2f} "
        f"GiB); launches {counts}")
    check_all(f"train mesh {arch}", {
        "no kernel launched under autograd": not any(counts.values()),
        "losses within tolerance of phase 7's":
            worst["loss"] <= TRAIN_MESH_RTOL["loss"],
        "grad norms within tolerance of phase 7's":
            worst["grad_norm"] <= TRAIN_MESH_RTOL["grad_norm"],
        "moments laid out as their parameters": all(
            run["state"].mu[k].placements == p.placements
            for k, p in run["params"].items()),
    })
    del model, run
    release()
    dryruns = start_dryruns()
    same, what = psum_bits(seed, mesh, make_host_mesh(
        (1, 1), MESH_AXES, device="cpu"))
    say(f"[train mesh] compressed_psum (int8 error feedback) of {what} on "
        f"the card's NCCL group against the host's gloo group: bit for bit "
        f"{same}")
    check_all("compressed_psum on the card", {"bit for bit": same})
    dist.destroy_process_group()
    dryrun_lines(dryruns, card)
    n = torch.cuda.device_count()
    if n >= 2:
        train_mesh_cards(seed, card, n)
    else:
        say(f"[train mesh] one card ({card}): the (n,1) and (1,n) meshes "
            f"and the checkpoint across them need two cards or more")
    return counts


def mesh_train_config():
    """The multi-card runs' model: full-width qwen3-0.6b cut to
    ``TRAIN_MESH_LAYERS`` layers, float32 compute."""
    from repro_torch.configs import get_config
    return get_config("qwen3-0.6b").replace(num_layers=TRAIN_MESH_LAYERS,
                                            compute_dtype="float32")


def train_mesh_cards(seed: int, card: str, n: int) -> None:
    """On ``n`` cards: ``mesh_train_config``'s model trains 3 steps
    meshless on one card in this process (``make_train_step`` on the plain
    model's parameters, as phase 7), then on an (n, 1) and a (1, n)
    mesh, each a session of its own under ``torch.distributed.run`` (one
    process a card, this script's ``--train-worker`` mode).  The (n, 1)
    run also holds ``compressed_psum`` over its n NCCL ranks against the
    same on gloo, bit for bit, and saves a checkpoint that the (1, n) run
    restores bit for bit.  Each run's losses and grad norms are held to
    the meshless run's within ``TRAIN_MESH_N_RTOL``, with no launch."""
    cfg = mesh_train_config()
    base = train_steps(seeded_train_model(cfg), None, synthetic(cfg, seed),
                       3, TRAIN_ACCUM)
    release()
    TRAIN_MESH_DIR.mkdir(parents=True, exist_ok=True)
    checks = {}
    for dp, mp in ((n, 1), (1, n)):
        label = f"{dp}x{mp}"
        out = TRAIN_MESH_DIR / f"{label}.json"
        out.unlink(missing_ok=True)
        t0 = time.perf_counter()
        rc, _, err = run_bounded(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={n}", str(ROOT / "chip_smoke.py"),
             "--seed", str(seed), "--train-worker", label],
            TRAIN_MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if rc or not out.exists():
            for line in err.splitlines()[-20:]:
                say(f"[train mesh] {label} stderr| {line}")
            fail(f"the {label} train session on {n} cards exited {rc}")
        got = json.loads(out.read_text())
        worst = worst_rel(got, base)
        say(f"[train mesh] {mesh_train_config().name} "
            f"({TRAIN_MESH_LAYERS} layers, float32) on a {label} mesh of "
            f"{n} cards under torch.distributed.run: exit 0 in {wall:.1f} s"
            f" wall on {card}; losses {got['losses']} (one card meshless "
            f"{base['losses']}), grad norms {got['grad_norms']} "
            f"({base['grad_norms']}); worst relative difference loss "
            f"{worst['loss']:.3e}, grad norm {worst['grad_norm']:.3e}; step "
            f"ms {[round(v, 1) for v in got['step_ms']]} (meshless "
            f"{[round(v, 1) for v in base['step_ms']]}); launches by rank "
            f"{got['launches']}; " + "; ".join(
                f"{k} {v}" for k, v in got["checks"].items()))
        checks.update({
            f"{label}: losses within {TRAIN_MESH_N_RTOL['loss']}":
                worst["loss"] <= TRAIN_MESH_N_RTOL["loss"],
            f"{label}: grad norms within {TRAIN_MESH_N_RTOL['grad_norm']}":
                worst["grad_norm"] <= TRAIN_MESH_N_RTOL["grad_norm"],
            f"{label}: no kernel launched under autograd":
                not any(any(c.values()) for c in got["launches"]),
            **{f"{label}: {k}": v for k, v in got["checks"].items()}})
    check_all("train mesh on cards", checks)


def train_worker(seed: int, label: str) -> None:
    """One rank of a ``train_mesh_cards`` session under
    ``torch.distributed.run``: ``mesh_train_config``'s model on a
    ``label`` ("DPxMP") mesh of the cards, 3 steps with the launch
    counters set to 0 just before; on (n, 1) also ``compressed_psum``
    over NCCL against gloo and a checkpoint saved (with the whole final
    parameters beside it); on (1, n) that checkpoint restored and held
    bit for bit.  Rank 0 writes ``build/train_mesh/LABEL.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import distribute_models, local_part
    from repro_torch.launch.train import restore_state, state_tree
    from repro_torch.models import spmd
    dp, mp = (int(v) for v in label.split("x"))
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:nccl")
    rank = dist.get_rank()
    mesh = make_host_mesh((dp, mp), MESH_AXES, device="cuda")
    cfg = mesh_train_config()
    model = distribute_models([seeded_train_model(cfg)], mesh)[0]
    reset_counts()
    run = train_steps(model, mesh, synthetic(cfg, seed), 3, TRAIN_ACCUM)
    counts = read_counts()
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, {k: v for k, v in counts.items() if v})
    checks = {}
    whole_path = TRAIN_MESH_DIR / "final_params.npz"
    if mp == 1:
        ckpt.save(TRAIN_MESH_DIR / "ckpt", 3,
                  state_tree(model, run["params"], run["state"]))
        whole = {k: spmd.whole(p).detach().cpu().numpy()
                 for k, p in run["params"].items()}
        if rank == 0:
            np.savez(whole_path, **whole)
        same, what = psum_bits(seed + rank, mesh, make_host_mesh(
            (dp, mp), MESH_AXES, device="cpu"))
        checks[f"compressed_psum over {dp} NCCL ranks equals gloo's bit for "
               f"bit ({what})"] = same
        checks["checkpoint saved"] = ckpt.latest_step(
            TRAIN_MESH_DIR / "ckpt") == 3
    else:
        fresh = distribute_models([seeded_train_model(cfg)], mesh)[0]
        params, state = restore_state(fresh, TRAIN_MESH_DIR / "ckpt", 3)
        saved = np.load(whole_path)
        checks[f"the {mp}x1 checkpoint restores on {label} bit for "
               f"bit"] = all(
            torch.equal(p.to_local(), local_part(
                torch.from_numpy(saved[k]).cuda(), mesh,
                p.placements).to_local()) for k, p in params.items())
        checks["the step restored"] = int(state.step) == 3
    if rank == 0:
        (TRAIN_MESH_DIR / f"{label}.json").write_text(json.dumps(
            {"losses": run["losses"], "grad_norms": run["grad_norms"],
             "step_ms": run["step_ms"], "launches": everyone,
             "checks": checks}))
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------- 8. examples
#: the port's examples as a user runs them, on the card, and the line each
#: ends with
EXAMPLES = (
    (("quickstart_torch.py",), "quickstart OK"),
    (("serve_edge_torch.py", "--arch", "qwen3-0.6b"), "serve_edge OK"),
    (("train_lm_torch.py", "--full", "--steps", "20", "--fail-at", "7"),
     "train_lm OK"),
)
EXAMPLE_TIMEOUT_S = 300


def phase_examples(card: str) -> None:
    """Each of ``EXAMPLES`` in a process of its own on the card (its
    default ``--device cuda``), its output printed line by line: it must
    exit 0 and end with its ``OK`` line, and ``train_lm_torch.py`` (full
    width smollm-135m, a failure injected at step 7) must restart exactly
    once."""
    for (script, *args), ok in EXAMPLES:
        cmd = " ".join([script, *args])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                               *args], cwd=ROOT, capture_output=True,
                              text=True, timeout=EXAMPLE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        out = proc.stdout.splitlines()
        for line in out:
            say(f"[example] {script}| {line}")
        if proc.returncode:
            for line in proc.stderr.splitlines()[-20:]:
                say(f"[example] {script} stderr| {line}")
        restarts = sum(line.startswith("[example] restart") for line in out)
        say(f"[example] {cmd}: exit {proc.returncode} in {wall:.1f} s wall "
            f"on {card} (the process's start, its kernel builds and its "
            f"run)" + (f"; {restarts} restart" if "train_lm" in script
                       else ""))
        check_all(f"example {cmd}", {
            "exit 0": proc.returncode == 0,
            f"ends with {ok!r}": bool(out) and out[-1] == ok,
            **({"exactly one restart": restarts == 1}
               if "--fail-at" in args else {}),
        })


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked checkout of an earlier commit: time "
                         "its two scan kernels beside these in phase 3")
    ap.add_argument("--serve-worker", nargs=argparse.REMAINDER,
                    help="one rank of phase 6c under torch.distributed.run: "
                         "the serving CLI with these options, then the "
                         "rank's launch counts")
    ap.add_argument("--train-worker", metavar="DPxMP",
                    help="one rank of phase 7b's multi-card sessions under "
                         "torch.distributed.run")
    ap.add_argument("--cp-worker", metavar="DPxMP",
                    help="one rank of phase 6d's multi-card launches under "
                         "torch.distributed.run")
    ap.add_argument("--moe-cut-worker", action="store_true",
                    help="one rank of phase 6f(b) under "
                         "torch.distributed.run")
    ap.add_argument("--moe-cli-worker", nargs=argparse.REMAINDER,
                    help="one rank of a phase 6f(c) run under "
                         "torch.distributed.run: its report's tag, then "
                         "the serving CLI's options")
    args = ap.parse_args()
    if args.serve_worker is not None:
        serve_worker(args.serve_worker)
        return
    if args.train_worker is not None:
        train_worker(args.seed, args.train_worker)
        return
    if args.cp_worker is not None:
        cp_worker(args.seed, args.cp_worker)
        return
    if args.moe_cut_worker:
        moe_cut_worker(args.seed)
        return
    if args.moe_cli_worker is not None:
        moe_cli_worker(args.moe_cli_worker[0], args.moe_cli_worker[1:])
        return
    lap = Laps()
    name, count, smi = phase_device()
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(src))
    parent = None if args.parent is None else args.parent.resolve()
    if parent is not None and not (parent / "src" / "repro_torch"
                                   / "csrc").is_dir():
        fail(f"--parent {parent}: no src/repro_torch/csrc there")
    built = phase_build(parent)
    lap("1-2 device and build")
    rows = phase_kernels(args.seed, smi, built)
    lap("3 kernels")
    phase_parity(args.seed, "qwen3-0.6b", 2, kv_block_size=16)
    phase_parity(args.seed, "recurrentgemma-2b", 3, kv_block_size=None)
    phase_parity(args.seed, "falcon-mamba-7b", 2, kv_block_size=None)
    for arch in NEW_ARCHS:
        phase_parity(args.seed, arch, 2, kv_block_size=16)
    for arch in MOE_ARCHS:
        phase_parity(args.seed, arch, MOE_PARITY_LAYERS[arch],
                     kv_block_size=16)
    phase_parity_encdec(args.seed)
    release()
    lap("4 parity")
    phase_train_parity(args.seed, "recurrentgemma-2b", 3, batch=2, seq_len=64)
    phase_train_parity(args.seed, "falcon-mamba-7b", 2, batch=2, seq_len=64)
    lap("4b train parity")
    paths = [phase_edge_lstm(args.seed, smi)]
    release()
    lap("5 edge LSTM")
    phase_mensa()
    phase_strategy()
    lap("5b Mensa and strategy")
    for serve in (phase_serve, phase_serve_recurrent, phase_serve_mamba):
        paths.append(serve(args.seed, smi))
        release()
    for arch in NEW_ARCHS:
        paths.append(phase_serve(args.seed, smi, arch,
                                 **SERVE_OPTIONS.get(arch, {})))
        release()
    for arch in MOE_ARCHS:
        paths.append(phase_serve(args.seed, smi, arch,
                                 num_layers=MOE_SERVE_LAYERS[arch]))
        release()
    lap("6 serve")
    paths.append(phase_serve_mesh(args.seed, smi))
    lap("6b mesh engine")
    phase_serve_mesh_cli(smi)
    lap("6b mesh CLI")
    phase_serve_roles(smi)
    lap("6c roles")
    paths.append(phase_cp_serve(args.seed, smi))
    release()
    lap("6d context-parallel serve")
    paths.append(phase_moe_mesh(args.seed, smi))
    moe_mesh_cards(args.seed, smi, count)
    lap("6f MoE on a mesh")
    paths.append(phase_train(args.seed, smi, "qwen3-0.6b", steps=3))
    paths.append(phase_train(args.seed, smi, ENCDEC, steps=2))
    phase_train_resume(args.seed)
    release()
    lap("7 train")
    paths.append(phase_train_mesh(args.seed, smi))
    release()
    lap("7b train mesh")
    phase_examples(smi)
    lap("8 examples")
    # launches: each path's run, counted from 0 just before it
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:22",
         "launches": launches["flash"], **rows["flash"]},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:31",
         "launches": launches["paged"], **rows["paged"]},
        {"name": "pavlov_rglru", "route": "cuda",
         "source": "src/repro_torch/csrc/pavlov_rglru.cu",
         "replaces": "src/repro/kernels/pavlov_rglru/kernel.py:24",
         "launches": launches["rglru"], **rows["rglru"]},
        {"name": "pavlov_ssm", "route": "cuda",
         "source": "src/repro_torch/csrc/pavlov_ssm.cu",
         "replaces": "src/repro/kernels/pavlov_ssm/kernel.py:24",
         "launches": launches["ssm"], **rows["ssm"]},
        {"name": "pascal_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/pascal_matmul.cu",
         "replaces": "src/repro/kernels/pascal_matmul/kernel.py:22",
         "launches": launches["pascal"], **rows["pascal"]},
        {"name": "jacquard_gemv", "route": "cuda",
         "source": "src/repro_torch/csrc/jacquard_gemv.cu",
         "replaces": "src/repro/kernels/jacquard_gemv/kernel.py:26",
         "launches_from": "phase 3's checks: no path calls the GEMV",
         **rows["jacquard"]},
        {"name": "pavlov_lstm", "route": "cuda",
         "source": "src/repro_torch/csrc/pavlov_lstm.cu",
         "replaces": "src/repro/kernels/pavlov_lstm/kernel.py:26",
         "launches": launches["lstm"], **rows["lstm"]},
    ]
    for row in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(row[key]):
                fail(f"{row['name']}: {key} is not finite")
        if row["library_ms"] is not None \
                and not math.isfinite(row["library_ms"]):
            fail(f"{row['name']}: library_ms is not finite")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
