"""Shared pytest configuration.

Offline reproducibility note: the tier-1 command is
``PYTHONPATH=src python -m pytest -q`` and must collect and pass with
**stdlib + jax + numpy + pytest only**.  In particular ``hypothesis`` is an
optional dev dependency (see requirements-dev.txt): the randomized sweeps in
test_core_scheduler.py, test_kernels.py, and test_models_attention.py run as
seeded ``pytest.mark.parametrize`` cases, so nothing here may hard-import
hypothesis.  Keep new randomized tests seeded the same way (derive shapes
from ``random.Random(seed)``) so failures reproduce from the parametrize id
alone.
"""
import os
import sys
from pathlib import Path

# allow running `pytest` without PYTHONPATH=src already exported
_SRC = str(Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

# keep CPU test runs deterministic and quiet
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's hand-written kernels); "
        "skips, with its reason, where there is none")
