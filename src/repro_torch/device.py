"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``; the CPU runs only when a caller
asks for it (the tests do).  A missing card is an error, never a silent
move to the CPU: a number taken on the CPU must not pass for the card's.
``meta`` (shapes without storage) is admitted only to build a model for
the dry run (``launch/dryrun.py``), never to run one.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda", *,
                   build: bool = False) -> torch.device:
    """``device`` checked: "cuda" (a card must be there) or "cpu"; with
    ``build``, also "meta"."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    if d.type not in ("cuda", "cpu") and not (build and d.type == "meta"):
        raise ValueError(f"device {device!r}: the port runs on 'cuda' or "
                         f"'cpu'" + (" (and builds on 'meta')" if build
                                     else ""))
    return d
