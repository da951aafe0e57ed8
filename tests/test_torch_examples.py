"""The port's examples print what the JAX package's print:
``examples/mensa_schedule_torch.py`` (the paper's pipeline on the port's
copies of the Mensa framework and the edge zoo) prints the stdout of
``examples/mensa_schedule.py`` line for line."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


def _stdout(script: str) -> list[str]:
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script)],
                          capture_output=True, text=True, timeout=300,
                          check=True, cwd=ROOT)
    return proc.stdout.splitlines()


def test_mensa_schedule_example_matches_reference():
    got = _stdout("mensa_schedule_torch.py")
    want = _stdout("mensa_schedule.py")
    assert got == want
    assert len(got) == 31 and got[-1] == "mensa_schedule OK"
