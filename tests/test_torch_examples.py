"""The port's examples print what the JAX package's print:
``examples/mensa_schedule_torch.py`` (the paper's pipeline on the port's
copies of the Mensa framework and the edge zoo) prints the stdout of
``examples/mensa_schedule.py`` line for line.  ``quickstart_torch.py``,
``serve_edge_torch.py`` and ``train_lm_torch.py`` run on the CPU
(``--device cpu``, reduced sizes) to their ``OK`` line; quickstart's Level
A prints the reference example's Level A, computed here through
``repro.core`` (the JAX examples are not spawned: their JIT time would
dominate)."""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _stdout(script: str, *args: str) -> list[str]:
    # one thread an example: the suite's workers share the cores, and a
    # process that starts a thread on every core of the machine for small
    # tensors spends its time waiting for them
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args],
                          capture_output=True, text=True, timeout=300,
                          check=True, cwd=ROOT,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    return proc.stdout.splitlines()


def test_mensa_schedule_example_matches_reference():
    got = _stdout("mensa_schedule_torch.py")
    want = _stdout("mensa_schedule.py")
    assert got == want
    assert len(got) == 31 and got[-1] == "mensa_schedule OK"


def _reference_level_a() -> list[str]:
    """``examples/quickstart.py``'s Level A, run in this process."""
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.level_a()
    return buf.getvalue().splitlines()


def test_quickstart_example_runs_and_level_a_matches_reference():
    got = _stdout("quickstart_torch.py", "--device", "cpu")
    want = _reference_level_a()
    assert len(want) == 11
    assert got[:len(want)] == want
    assert got[-1] == "quickstart OK"
    plan = got.index("MensaPlan[recurrentgemma-2b x train_4k]")
    assert any("pascal_dp" in line for line in got[plan:plan + 5])
    losses = [float(line.split()[-1]) for line in got
              if line.startswith("  step ")]
    assert len(losses) == 4 and all(0 < x < 10 for x in losses)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b"])
def test_serve_edge_example_runs(arch):
    """phi3.5-moe serves its reduced config planned at full size."""
    got = _stdout("serve_edge_torch.py", "--device", "cpu", "--arch", arch,
                  "--requests", "4", "--max-new", "6")
    assert got[0] == f"MensaPlan[{get_config(arch).name} x prefill_32k]"
    assert "prefill overrides={} | decode overrides={}" in got
    assert got[-1] == "serve_edge OK"
    assert got[-2].startswith("served 4 requests / 24 tokens")
    assert "tok/s on cpu with 3 slots" in got[-2]


def test_train_lm_example_resumes_once():
    got = _stdout("train_lm_torch.py", "--device", "cpu", "--steps", "12",
                  "--fail-at", "7")
    assert got[-1] == "train_lm OK"
    restarts = [line for line in got if line.startswith("[example] restart")]
    assert len(restarts) == 1 and "step 7" in restarts[0]
    assert got[-2].endswith("over 12 steps (1 restarts)")
