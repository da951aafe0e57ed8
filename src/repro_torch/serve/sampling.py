"""Per-request token sampling: temperature / top-k / top-p, greedy as the
exact ``argmax``.  The PyTorch counterpart of ``repro.serve.sampling``.

Greedy rows (temperature <= 0) take ``argmax`` of the raw logits, and a
batch with no stochastic row skips the sort and cumsum entirely.  A
stochastic row draws from its own ``torch.Generator`` seeded from
``(seed, position)``, so a request's token stream is a function of its seed
and positions — reproducible across engines, restarts and slot assignments
(JAX's ``fold_in`` stream is not reproducible in torch; the keep-sets are).
"""
from __future__ import annotations

import torch

#: filler for masked-out logits; finite so (masked - max) never yields NaN
_MASKED = -1e30


def keep_mask(scaled: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Tokens a row may sample from, for temperature-scaled logits (V,):
    top-k keeps logits >= the k-th largest (k <= 0 keeps all; ties at the
    threshold stay), then top-p keeps the smallest set, in descending
    probability, whose mass before each token is < top_p (the top token
    always survives)."""
    v = scaled.shape[-1]
    keep = torch.ones(v, dtype=torch.bool, device=scaled.device)
    if top_k > 0:
        kth = torch.sort(scaled, descending=True).values[min(top_k, v) - 1]
        keep = scaled >= kth
    if top_p >= 1.0:
        # keeps everything (float rounding of the cumsum near 1 must not
        # drop a tail token)
        return keep
    scaled = torch.where(keep, scaled, torch.full_like(scaled, _MASKED))
    sorted_desc, order = torch.sort(scaled, descending=True, stable=True)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = cum_before < max(top_p, 1e-6)
    keep_p = torch.zeros(v, dtype=torch.bool, device=scaled.device)
    keep_p[order] = keep_sorted
    return keep & keep_p


def _row_generator(seed: int, position: int,
                   device: torch.device) -> torch.Generator:
    # splitmix64 of (seed, position): the CPU generator keeps only the low
    # 32 bits of its seed, so both halves must reach them
    m = (1 << 64) - 1
    x = ((seed & 0xFFFFFFFF) << 32) | (position & 0xFFFFFFFF)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    gen = torch.Generator(device=device)
    gen.manual_seed(x ^ (x >> 31))
    return gen


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seed,
                  position) -> torch.Tensor:
    """Batched sampling: logits (B,V); per-row temperature, top_k, top_p,
    seed and position as sequences of B numbers -> (B,) int64 token ids.
    Rows with temperature <= 0 are exactly ``argmax(logits, -1)``."""
    logits = logits.float()
    out = torch.argmax(logits, dim=-1)
    rows = [i for i, t in enumerate(temperature) if t > 0]
    for i in rows:
        scaled = logits[i] / max(float(temperature[i]), 1e-6)
        keep = keep_mask(scaled, int(top_k[i]), float(top_p[i]))
        probs = torch.softmax(
            torch.where(keep, scaled, torch.full_like(scaled, _MASKED)), -1)
        gen = _row_generator(int(seed[i]), int(position[i]), logits.device)
        out[i] = torch.multinomial(probs, 1, generator=gen)[0]
    return out
