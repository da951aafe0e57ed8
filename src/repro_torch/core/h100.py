"""The roofline of the card the port runs on: one NVIDIA H100 SXM5 80 GB.

Source: NVIDIA's H100 Tensor Core GPU datasheet, the SXM5 part at its 700 W
limit, dense rates (no sparsity): 989.4 TFLOP/s on the tensor cores in
bf16, 67 TFLOP/s in float32 outside them, and 3.35 TB/s of HBM3.  A card
set below 700 W runs slower under load, so a share of these peaks is
stated beside the card's power limit.

These are no rates of the paper's modeled edge accelerators
(``core/accelerators.py`` keeps those, for Mensa).  The program registry
(``obs/programs.py``) divides by them, and ``chip_smoke.py`` bounds each
kernel's time with them.
"""
from __future__ import annotations

from dataclasses import dataclass

TERA = 1e12

#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35 * TERA
#: dense peak FLOP/s by compute dtype: bf16 on the tensor cores; float32 on
#: the FMA units, since TF32 stays off (PyTorch's default for matmul)
PEAK_FLOPS = {"bfloat16": 989.4 * TERA, "float32": 67.0 * TERA}


@dataclass(frozen=True)
class Roofline:
    """A chip's two ceilings, as the program registry reads them."""
    name: str
    peak_flops: float              # FLOP/s of matrix products
    hbm_bw: float                  # bytes/s


def for_dtype(dtype: str) -> Roofline:
    """The H100's roofline for products in ``dtype`` ("bfloat16" or
    "float32", a config's ``compute_dtype``)."""
    if dtype not in PEAK_FLOPS:
        raise ValueError(f"no H100 peak for dtype {dtype!r}: one of "
                         f"{sorted(PEAK_FLOPS)}")
    return Roofline(f"h100_sxm_{dtype}", PEAK_FLOPS[dtype], HBM_BW)
