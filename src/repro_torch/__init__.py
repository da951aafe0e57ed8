"""PyTorch/CUDA port of the ``repro`` serving and train paths for an
NVIDIA H100.

A package beside the JAX reference (``src/repro``), module for module under
the same names.  It imports ``torch`` and numpy only — never JAX, never
``repro`` — and keeps its own copy of what it needs.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU; the
seven kernels, one for each Pallas kernel of the reference, are
hand-written CUDA in ``csrc/``.
"""
