"""The port stands alone: no module of ``src/repro_torch``, no port example
(``examples/*_torch.py``) and not ``chip_smoke.py`` imports JAX or the JAX
package (``repro``)."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value))
    return names


def _files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + sorted((ROOT / "examples").glob("*_torch.py")) \
        + [ROOT / "chip_smoke.py"]


def test_port_has_files():
    files = _files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    examples = {p.name for p in files if p.parent.name == "examples"}
    assert {"mensa_schedule_torch.py", "quickstart_torch.py",
            "serve_edge_torch.py", "train_lm_torch.py"} <= examples


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = sorted(n for n in _imported(path)
                 if n.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.serve import engine\n"
                 "import importlib\nimportlib.import_module('jax')\n")
    assert {"jax.numpy", "repro.serve", "jax"} <= _imported(f)
