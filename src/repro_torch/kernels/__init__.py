"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of
``repro.kernels`` (``kernel.py`` launches it, ``ref.py`` is its plain
PyTorch version, ``ops.py`` the wrapper that picks by the tensor's
device), built from ``../csrc`` by ``build.py``."""
