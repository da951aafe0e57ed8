"""The roofline of the card the port runs on: one NVIDIA H100 SXM5 80 GB.

Source: NVIDIA's H100 Tensor Core GPU datasheet, the SXM5 part at its 700 W
limit, dense rates (no sparsity): 989.4 TFLOP/s on the tensor cores in
bf16, 67 TFLOP/s in float32 outside them, and 3.35 TB/s of HBM3.  A card
set below 700 W runs slower under load, so a share of these peaks is
stated beside the card's power limit.

``H100_SXM`` is the same card as the execution-strategy planner
(``core/strategy.py``) sees it, the counterpart of the JAX package's
``HostChipConfig`` record of a TPU v5e:
  * bf16 dense peak and HBM bandwidth: the two numbers above;
  * the link between cards: NVLink 4, 900 GB/s a card in the same
    datasheet, both directions together, so 450 GB/s each way;
  * the usable HBM for parameters and optimizer state: 60 GB of the card's
    80 GB.  A modeling choice, not a datasheet number: the reference keeps
    12 of v5e's 16 GB (75%), and the same share here leaves 20 GB for
    activations, KV caches, the CUDA context and the caching allocator's
    slack, so a plan's replicate-or-shard threshold means what it means
    on the reference's chip.
The planner's seconds are a model's output from these constants, not
times measured on the card.

These are no rates of the paper's modeled edge accelerators
(``core/accelerators.py`` keeps those, for Mensa).  The program registry
(``obs/programs.py``) divides by them, and ``chip_smoke.py`` bounds each
kernel's time with them.
"""
from __future__ import annotations

from dataclasses import dataclass

GIGA = 1e9
TERA = 1e12

#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35 * TERA
#: dense peak FLOP/s by compute dtype: bf16 on the tensor cores; float32 on
#: the FMA units, since TF32 stays off (PyTorch's default for matmul)
PEAK_FLOPS = {"bfloat16": 989.4 * TERA, "float32": 67.0 * TERA}
#: NVLink 4 between two cards, bytes/s one way (900 GB/s a card, both ways)
NVLINK_BW = 450.0 * GIGA
#: usable HBM a card for parameters + optimizer state, bytes: 75% of 80 GB
HBM_BUDGET = 60.0 * GIGA


@dataclass(frozen=True)
class Roofline:
    """A chip's two ceilings, as the program registry reads them."""
    name: str
    peak_flops: float              # FLOP/s of matrix products
    hbm_bw: float                  # bytes/s


@dataclass(frozen=True)
class HostChip:
    """A datacenter card as the execution-strategy planner's analytic cost
    model sees it (``repro.core.accelerators.HostChipConfig``'s
    counterpart; ``link_bw`` stands where the reference has ``ici_bw``)."""
    name: str
    peak_flops: float              # bf16 dense FLOP/s a card
    hbm_bw: float                  # bytes/s a card
    link_bw: float                 # bytes/s one way between two cards
    hbm_budget: float              # usable bytes a card for params + optimizer


H100_SXM = HostChip(name="h100_sxm", peak_flops=PEAK_FLOPS["bfloat16"],
                    hbm_bw=HBM_BW, link_bw=NVLINK_BW, hbm_budget=HBM_BUDGET)


def for_dtype(dtype: str) -> Roofline:
    """The H100's roofline for products in ``dtype`` ("bfloat16" or
    "float32", a config's ``compute_dtype``)."""
    if dtype not in PEAK_FLOPS:
        raise ValueError(f"no H100 peak for dtype {dtype!r}: one of "
                         f"{sorted(PEAK_FLOPS)}")
    return Roofline(f"h100_sxm_{dtype}", PEAK_FLOPS[dtype], HBM_BW)
