#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line or block of output each; any failure exits non-zero:

1. device — the card's name, count, and ``nvidia-smi`` name / power limit;
2. build  — the seven CUDA kernels from ``src/repro_torch/csrc``, in
   parallel, with ``nvcc -Xptxas -v``'s registers / shared memory / spills;
3. kernels — each kernel against its plain PyTorch version on the card at
   the paths' shapes, bf16 and float32, with the stated tolerance (flash
   also at recurrentgemma's hd=256, 10 q heads over 1 kv head, and with a
   window that binds; the selective scan with a carried state and ragged
   lengths that include a frozen row; the Pascal matmul at the edge zoo's
   TR1 hoisted input GEMMs, the Jacquard GEMV at its FC widths, the LSTM
   recurrence at H=2048 and the ragged H=2900, with and without a carried
   state); then times (CUDA events, L2 flushed before each launch, the
   median of 21 calls, min and max on the line before the row): kernel,
   plain version, a PyTorch call as a yardstick (``scaled_dot_product_
   attention`` for flash, ``torch.matmul`` for the GEMM and GEMV, cuDNN's
   ``torch.nn.LSTM`` for a whole LSTM layer), and the least time the card
   could take (bytes and operations against the published H100 SXM peaks);
   flash in bf16 (its tensor-core route) at S=64, 256 and 1024 and at
   recurrentgemma's local layer, and in float32 (its SIMT route); the
   GEMV at M=1 1280 -> 8192 and M=4 640 -> 4096 in both dtypes;
4. layer parity — full-width qwen3-0.6b cut to 2 layers, full-width
   recurrentgemma-2b cut to 3 (rec, rec, local) and full-width
   falcon-mamba-7b cut to 2, float32: prefill and 4 decode steps on the CPU
   (plain versions) and on the card (kernels) from the same weights, logits
   held within a stated tolerance;
5. edge LSTM stack — the LSTM layers of the edge zoo's mobile RNN-T
   (``TR1_rnnt_mobile``) at full width, float32, random weights from the
   seed: its encoder cut to 2 layers on the CPU (plain versions) and on the
   card (kernels), held within a stated tolerance; then on the card, with
   the launch counters set to 0 just before, the whole 8-layer encoder over
   T=200 and the 2-layer prediction network over U=20, once as one call and
   once as 20 single steps carrying (h, c), which must agree bit for bit;
6. serve — three paths through ``ServeEngine``, random weights from the
   seed, each run with every kernel's launch counter set to 0 just before
   it and read just after, each model released before the next is built:
   a. full-width qwen3-0.6b, all 28 layers: paged KV, prefix cache,
      bucketed and chunked prefill, greedy and sampled decode;
   b. full-width recurrentgemma-2b, all 26 layers: dense KV (2048-token
      window rings), a 2300-token prompt chunked across the window, decode
      past it, a recycled slot, greedy and sampled decode;
   c. full-width falcon-mamba-7b, all 64 ssm layers: conv and scan states
      per slot, a 1000-token prompt in 4 chunks, a recycled slot, greedy
      and sampled decode.

The last three lines: ``nvidia-smi``'s name and power limit, one JSON
object with a row per kernel, and ``{"ok": true, "device": {...}}``.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, dense), at a 700 W limit
TERA = 1e12
PEAK_BYTES_S = 3.35 * TERA
PEAK_FLOPS = {"bfloat16": 989.4 * TERA, "float32": 67.0 * TERA}

FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PAGED_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the RG-LRU kernel rounds a*h, then +b, as its plain loop does: float32
# agrees to the bit; a bf16 output may differ by one ulp of |h| < 8
RGLRU_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -4}
# the selective scan rounds its update where its plain loop does (h_T
# agrees to float32 rounding, to the bit in practice), but y is a 17-term
# sum taken in another order: it agrees to a few float32 ulps of the
# output's scale (|y| reaches ~80 here), so SSM_Y_ULPS of max|y|; a bf16 y
# is one more rounding of that (one bf16 ulp, 2^-7 of |y|)
SSM_TOL = 1e-5
SSM_Y_ULPS = 8 * 2.0 ** -23
SSM_BF16_ULP = 2.0 ** -7
# float32 logits of a cut full-width model: the kernels and cuBLAS sum in
# other orders than the CPU, over d_model 1024 / 2560 / 4096 and vocab
# 151,936 / 256,000 / 65,024
LOGIT_TOL = 2e-3
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
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(["flash_attention", "paged_attention", "pavlov_rglru",
                        "pavlov_ssm", "pascal_matmul", "jacquard_gemv",
                        "pavlov_lstm"])
    say(f"[build] {len(logs)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s (sm_90a, into {build.BUILD_DIR})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line:
                say(f"[build] {name}: {line.strip()}")


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


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_case(b, s, h, kvh, hd, window, dtype, gen):
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_raw,
                                                     flash_attention_ref)
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dt)
    out = flash_attention_raw(q, k, v, causal=True, window=window)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    return (q, k, v), err


def phase_kernels(seed: int, card: str):
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

    def flash_times(b, s, h, kvh, hd, window, dtype) -> dict:
        """One causal flash call at these shapes: its error against the
        plain version, and the kernel's, the plain version's and
        ``scaled_dot_product_attention``'s times beside the bound."""
        assert window == 0 or window >= s   # SDPA's causal mask is the same
        (q, k, v), err = flash_case(b, s, h, kvh, hd, window, dtype, gen)
        pairs = s * (s + 1) // 2
        flops = 4.0 * b * h * hd * pairs
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        what = (f"flash {dtype} B={b} S={s} H={h} KVH={kvh} hd={hd}"
                + (f" window={window}" if window else ""))
        ms = time_ms(f"{what}, kernel", lambda: flash_attention_raw(
            q, k, v, causal=True, window=window), flush)
        plain = time_ms(f"{what}, plain", lambda: flash_attention_ref(
            q, k, v, causal=True, window=window), flush)
        # the yardstick gets K/V already repeated to H heads (not timed)
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
                  for x in (k, v))
        lib = time_ms(f"{what}, sdpa", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush)
        bnd, by = bound_ms(nbytes, flops, dtype)
        say(f"[kernel] on {card}: {what} causal: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}); "
            f"max|kernel-plain|={err:.3e}")
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
        "float32": "SIMT: scalar float32 FMAs"}
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
                f"({by})")
            rows["paged"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 library_ms=None, bound_ms=bnd, bound_by=by)

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

    # ---- RG-LRU: B=4 slots, E = d_rnn = 2560; T=256 (a prefill bucket or
    # chunk), T=1 (decode) and a ragged T=100.  a in [0.9, 0.999] and
    # b ~ N(0, 1 - a^2), the ranges rglru_core gives them
    from repro_torch.kernels.pavlov_rglru import (pavlov_rglru_raw,
                                                  pavlov_rglru_ref)
    b, e = 4, 2560

    def rglru_inputs(t, dtype):
        a = torch.empty((b, t, e), device="cuda").uniform_(
            0.9, 0.999, generator=gen)
        drive = torch.randn((b, t, e), generator=gen, device="cuda") \
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
            say(f"[kernel] rglru {dtype} B={b} T={t} E={e}: "
                f"max|kernel-plain|={err:.3e} (tol {tol})")
            if not err <= tol:
                fail(f"RG-LRU kernel disagrees with its plain version "
                     f"({err} > {tol})")
            if dtype == "float32" and t == 256:
                rows["rglru"] = {"max_abs_err": err}
    for t in (256, 1):          # float32: rglru_core builds a and b in f32
        a, drive = rglru_inputs(t, "float32")
        what = f"rglru float32 B={b} T={t} E={e}"
        ms = time_ms(f"{what}, kernel", lambda: pavlov_rglru_raw(a, drive),
                     flush)
        plain = time_ms(f"{what}, plain", lambda: pavlov_rglru_ref(a, drive),
                        flush)
        bnd, by = bound_ms(3.0 * b * t * e * 4, 2.0 * b * t * e, "float32")
        say(f"[kernel] on {card}: rglru float32 B={b} T={t} E={e}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        if t == 256:
            rows["rglru"].update(ms=ms, plain_ms=plain, library_ms=None,
                                 bound_ms=bnd, bound_by=by)
    rows["ssm"] = ssm_kernel(gen, flush, card)
    rows["pascal"] = pascal_kernel(gen, flush, card)
    rows["jacquard"] = jacquard_kernel(gen, flush, card)
    rows["lstm"] = lstm_kernel(gen, flush, card)
    return rows


def ssm_kernel(gen, flush, card: str) -> dict:
    """The selective scan at falcon-mamba's d_inner 8192 and d_state 16, in
    float32 as ``mamba_ssm`` builds its inputs (and once in bf16): B=4
    slots at T=256 (a prefill bucket), 1 (decode) and a ragged 100, B=1 at
    T=256 (a prefill chunk); with a carried h0 and ragged lengths that
    include a 0, whose h_T must be h0 to the bit.  Inputs in the ranges
    ``mamba_ssm`` gives them: delta = softplus(.) around 0.05, a = -(1..16)
    scaled by U[0.5, 1.5]."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.pavlov_ssm import pavlov_ssm_raw, pavlov_ssm_ref
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
        ms = time_ms(f"{what}, kernel", lambda: pavlov_ssm_raw(*args), flush)
        plain = time_ms(f"{what}, plain", lambda: pavlov_ssm_ref(*args),
                        flush)
        bnd, by = bound_ms(nbytes, 7.0 * b * t * d * n, "float32")
        say(f"[kernel] on {card}: ssm float32 B={b} T={t} D={d} N={n}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms "
            f"({by}; {b * t * d * n / 1e6:.1f} M expf)")
        if (b, t) == (4, 256):
            row.update(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                       bound_by=by)
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
        if dtype == torch.float32:
            row.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by)
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
        every = 1e3 * item * t * hd * 4 * hd / PEAK_BYTES_S
        say(f"[kernel] on {card}: lstm {str(dtype)[6:]} B={b} T={t} H={hd}: "
            f"kernel {ms:.4f} ms ({t} step launches), plain {plain:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}; W_h read once), {every:.4f} ms with "
            f"W_h read from device memory every step")
        if dtype == torch.float32:
            row.update(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                       bound_every_step_ms=every)
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
def phase_parity(seed: int, arch: str, num_layers: int,
                 kv_block_size: int | None):
    """The arch at full width cut to ``num_layers`` layers, float32: the
    same weights on the CPU and on the card, prefill of two right-padded
    rows and 4 greedy decode steps, logits compared."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Model
    cfg = get_config(arch).replace(num_layers=num_layers,
                                   compute_dtype="float32")
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

    def on(x, side):
        return None if x is None else x.to(models[side].device)

    for side, model in models.items():
        st = model.init_states(2, max_len, kv_block_size=kv_block_size)
        lg, states[side] = model.prefill(on(toks, side), st,
                                         length=on(length, side),
                                         block_table=on(table, side))
        logits[side] = [lg.cpu()]
    pos = length.clone()
    for _ in range(4):
        # both sides decode the CPU's greedy token, so they never diverge
        nxt = logits["cpu"][-1][:, 0].argmax(-1)[:, None]
        for side, model in models.items():
            lg, states[side] = model.decode_step(
                on(nxt, side), states[side], on(pos, side),
                block_table=on(table, side))
            logits[side].append(lg.cpu())
        pos = pos + 1
    if not all(torch.isfinite(lg).all() for lg in logits["card"]):
        fail(f"{arch}: non-finite logits on the card")
    worst = max((a - b).abs().max().item()
                for a, b in zip(logits["cpu"], logits["card"]))
    kv = "no KV" if set(cfg.layer_kinds) == {"ssm"} \
        else "dense KV" if kv_block_size is None \
        else f"paged KV (blocks of {kv_block_size})"
    say(f"[parity] {arch} full width, {num_layers} layers "
        f"({', '.join(cfg.layer_kinds)}), float32, {kv}, prefill lengths "
        f"{lens} + 4 decode steps: max|cuda-cpu| logits {worst:.3e} "
        f"(tol {LOGIT_TOL})")
    if not worst <= LOGIT_TOL:
        fail(f"{arch} layer parity {worst} > {LOGIT_TOL}")


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
            "lstm": pavlov_lstm.launches,
            "lstm_steps": pavlov_lstm.step_launches}


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


def phase_serve(seed: int, card: str):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine, prefill_buckets
    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    engine = ServeEngine(model, slots=4, max_len=1024, kv_block_size=16,
                         buckets=prefill_buckets(256), prefill_chunk=256)
    engine.warmup()
    torch.cuda.synchronize()
    say(f"[serve] qwen3-0.6b full width ({cfg.num_layers} layers, "
        f"{cfg.param_count() / 1e6:.0f} M parameters, bf16 compute), "
        f"model + warmup {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed)
    prompt = lambda n: rng.randint(1, cfg.vocab_size, n).tolist()  # noqa
    shared = prompt(70)
    reqs = [Request(rid=i, prompt=prompt(n), max_new_tokens=16)
            for i, n in enumerate((5, 17, 40, 90, 180))]
    reqs.append(Request(rid=5, prompt=prompt(600), max_new_tokens=16))
    reqs.append(Request(rid=6, prompt=shared + prompt(10), max_new_tokens=16,
                        temperature=0.8, top_k=50, top_p=0.9, seed=seed))
    late = Request(rid=7, prompt=shared + prompt(12), max_new_tokens=16)

    reset_counts()
    for r in reqs:
        engine.submit(r)
    while not reqs[6].generated:        # the shared prefix is published at
        engine.step()                   # the first request's prefill
    engine.submit(late)
    engine.run([])
    counts = read_counts()

    s = engine.stats.summary()
    reqs.append(late)
    say(f"[serve] {len(reqs)} requests: completed "
        f"{s['requests_completed']}, tokens {s['tokens_generated']}, "
        f"prefill calls {s['prefill_calls']}, chunks {s['prefill_chunks']}, "
        f"prefix hits {s['kv']['prefix_hits']} "
        f"({s['kv']['prefix_tokens_reused']} tokens, "
        f"{s['kv']['blocks_copied']} COW), blocks peak "
        f"{s['kv']['blocks_peak']}, decode stalls "
        f"{s['kv']['decode_stalls']}, non-finite logit rows "
        f"{s['nonfinite_logits']}, launches {counts}")
    say(f"[serve] qwen3-0.6b {serve_line(s, card)}")
    check_all("serve qwen3-0.6b", {
        "every request finished": all(r.done and len(r.generated) == 16
                                      for r in reqs),
        "prefill_chunks >= 3": s["prefill_chunks"] >= 3,
        "prefix_hits >= 1": s["kv"]["prefix_hits"] >= 1,
        "decode_stalls == 0": s["kv"]["decode_stalls"] == 0,
        "flash kernel launched": counts["flash"] > 0,
        "paged kernel launched": counts["paged"] > 0,
        "all logits finite": s["nonfinite_logits"] == 0,
        "tokens in vocab": all(0 <= t < cfg.vocab_size
                               for r in reqs for t in r.generated),
    })
    return counts


def phase_serve_recurrent(seed: int, card: str):
    """Full-width recurrentgemma-2b through the dense-KV engine: short
    prompts, one that chunks across the 2048-token window, a sampled
    request that waits for a recycled slot, decode past the window."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine, prefill_buckets
    cfg = get_config("recurrentgemma-2b")
    n_rec = cfg.layer_kinds.count("rec")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    engine = ServeEngine(model, slots=4, max_len=4096,
                         buckets=prefill_buckets(256), prefill_chunk=256)
    engine.warmup()
    torch.cuda.synchronize()
    say(f"[serve] recurrentgemma-2b full width ({cfg.num_layers} layers: "
        f"{n_rec} rec, {cfg.num_layers - n_rec} local, window "
        f"{cfg.window}; {cfg.param_count() / 1e9:.2f} B parameters, bf16 "
        f"compute, dense KV), model + warmup "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed + 1)
    prompt = lambda n: rng.randint(1, cfg.vocab_size, n).tolist()  # noqa
    new = 32
    reqs = [Request(rid=i, prompt=prompt(n), max_new_tokens=new)
            for i, n in enumerate((5, 40, 180, 2300))]
    reqs.append(Request(rid=4, prompt=prompt(60), max_new_tokens=new,
                        temperature=0.8, top_k=50, top_p=0.9, seed=seed))
    reset_counts()
    engine.run(reqs, on_truncate="raise")
    counts = read_counts()
    s = engine.stats.summary()
    say(f"[serve] {len(reqs)} requests over {engine.slots} slots "
        f"(prompts {[len(r.prompt) for r in reqs]}): completed "
        f"{s['requests_completed']}, tokens {s['tokens_generated']}, "
        f"prefill calls {s['prefill_calls']}, chunks {s['prefill_chunks']}, "
        f"non-finite logit rows {s['nonfinite_logits']}, launches {counts}")
    say(f"[serve] recurrentgemma-2b {serve_line(s, card)}")
    check_all("serve recurrentgemma-2b", {
        "every request finished": all(r.done and len(r.generated) == new
                                      for r in reqs),
        "prefill_chunks >= 9": s["prefill_chunks"] >= 9,
        "RG-LRU kernel launched": counts["rglru"] > 0,
        "flash kernel launched": counts["flash"] > 0,
        f"decode steps x {n_rec} <= RG-LRU decode launches":
            s["decode_steps"] * n_rec <= counts["rglru_decode"],
        "all logits finite": s["nonfinite_logits"] == 0,
        "tokens in vocab": all(0 <= t < cfg.vocab_size
                               for r in reqs for t in r.generated),
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
    from repro_torch.serve.engine import Request, ServeEngine, prefill_buckets
    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    engine = ServeEngine(model, slots=4, max_len=4096,
                         buckets=prefill_buckets(256), prefill_chunk=256)
    engine.warmup()
    torch.cuda.synchronize()
    say(f"[serve] falcon-mamba-7b full width ({cfg.num_layers} ssm layers, "
        f"d_inner {cfg.d_inner}, d_state {cfg.d_state}; "
        f"{cfg.param_count() / 1e9:.2f} B parameters, bf16 compute, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card), "
        f"model + warmup {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed + 2)
    prompt = lambda n: rng.randint(1, cfg.vocab_size, n).tolist()  # noqa
    new = 32
    reqs = [Request(rid=i, prompt=prompt(n), max_new_tokens=new)
            for i, n in enumerate((5, 40, 180, 1000))]
    reqs.append(Request(rid=4, prompt=prompt(60), max_new_tokens=new,
                        temperature=0.8, top_k=50, top_p=0.9, seed=seed))
    reset_counts()
    engine.run(reqs, on_truncate="raise")
    counts = read_counts()
    s = engine.stats.summary()
    say(f"[serve] {len(reqs)} requests over {engine.slots} slots "
        f"(prompts {[len(r.prompt) for r in reqs]}): completed "
        f"{s['requests_completed']}, tokens {s['tokens_generated']}, "
        f"prefill calls {s['prefill_calls']}, chunks {s['prefill_chunks']}, "
        f"non-finite logit rows {s['nonfinite_logits']}, launches {counts}")
    say(f"[serve] falcon-mamba-7b {serve_line(s, card)}")
    check_all("serve falcon-mamba-7b", {
        "every request finished": all(r.done and len(r.generated) == new
                                      for r in reqs),
        "prefill_chunks >= 4": s["prefill_chunks"] >= 4,
        "SSM kernel launched": counts["ssm"] > 0,
        f"decode steps x {cfg.num_layers} <= SSM decode launches":
            s["decode_steps"] * cfg.num_layers <= counts["ssm_decode"],
        "all logits finite": s["nonfinite_logits"] == 0,
        "tokens in vocab": all(0 <= t < cfg.vocab_size
                               for r in reqs for t in r.generated),
    })
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    name, count, smi = phase_device()
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(src))
    phase_build()
    rows = phase_kernels(args.seed, smi)
    phase_parity(args.seed, "qwen3-0.6b", 2, kv_block_size=16)
    phase_parity(args.seed, "recurrentgemma-2b", 3, kv_block_size=None)
    phase_parity(args.seed, "falcon-mamba-7b", 2, kv_block_size=None)
    release()
    paths = [phase_edge_lstm(args.seed, smi)]
    release()
    for serve in (phase_serve, phase_serve_recurrent, phase_serve_mamba):
        paths.append(serve(args.seed, smi))
        release()
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
         "launches": launches["lstm"],
         "step_launches": launches["lstm_steps"], **rows["lstm"]},
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
