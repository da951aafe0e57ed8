"""The port's dry run (``repro_torch.launch.dryrun``) in a subprocess: a
fake default group in the pytest process would make
``launch.mesh.start_group`` skip its own start for every later test on the
same worker.  The subprocess runs reduced qwen3-0.6b, recurrentgemma-2b and
falcon-mamba-7b train cells (at the depth of one pattern) on a fake
(4, 2) group and on a fake (1, 1) one, and refuses a decode cell through ``run_cell`` (its fake group of 256
ranks and production mesh built first); this process checks the records
against the JAX package's parameter bytes and against each other."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("qwen3-0.6b", "recurrentgemma-2b", "falcon-mamba-7b")
#: a train cell at reduced size and depth: global batch 4 of 32 tokens, a
#: row a data rank
B, S = 4, 32

SCRIPT = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec, reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    shape = ShapeSpec("train_small", {s}, {b}, "train")
    out = {{}}
    for arch in {archs!r}:
        for dp, mp in ((4, 2), (1, 1)):
            dryrun.start_fake_group(8)
            try:
                mesh = make_host_mesh((dp, mp), ("data", "model"),
                                      device="cpu")
                cfg = reduced_config(arch)
                cfg = cfg.replace(num_layers=max(2, len(cfg.block_pattern)))
                out[f"{{arch}} {{dp}}x{{mp}}"] = dryrun.measure(cfg, shape,
                                                              mesh)
            finally:
                dist.destroy_process_group()
    out["decode"] = dryrun.run_cell("qwen3-0.6b", "decode_32k", "single",
                                    Path(sys.argv[1]))
    out["group_left"] = dist.is_initialized()
    out["cells"] = dryrun.all_cells()
    out["results_dir"] = str(dryrun.RESULTS_DIR)
    print(json.dumps(out))
""").format(s=S, b=B, archs=ARCHS)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out_dir)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1]), out_dir


def _ref_param_bytes(arch: str) -> float:
    cfg = ref_reduced(arch)
    model = ref_build(cfg.replace(num_layers=max(2, len(cfg.block_pattern))))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return float(sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                     for leaf in jax.tree.leaves(shapes)))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_record(records, arch):
    """The reference's keys where the port fills them; ``param_bytes`` the
    JAX ``build_lowerable``'s; one rank's arguments are its float32
    parameters, two moments, the step and its rows of tokens and labels;
    the mesh moves gradients (an all-reduce at least), one rank moves
    nothing."""
    got, _ = records
    rec, one = got[f"{arch} 4x2"], got[f"{arch} 1x1"]
    assert rec["status"] == one["status"] == "ok"
    assert rec["n_devices"] == 8 and one["n_devices"] == 1
    assert rec["mesh_shape"] == {"data": 4, "model": 2}
    assert rec["meta"]["param_bytes"] == one["meta"]["param_bytes"] \
        == _ref_param_bytes(arch)
    assert 1 <= rec["meta"]["accum_steps"] <= \
        rec["meta"]["accum_steps_reference"]
    assert (B // 4) % rec["meta"]["accum_steps"] == 0
    mem = rec["memory"]
    rows = B // 4 * S * 4 * 2                  # int32 tokens and labels
    assert mem["argument_size_in_bytes"] \
        == 3 * mem["parameter_size_in_bytes"] + 4 + rows
    assert mem["parameter_size_in_bytes"] < rec["meta"]["param_bytes"]
    assert one["memory"]["parameter_size_in_bytes"] \
        == one["meta"]["param_bytes"]
    assert rec["collectives"]["counts"].get("all-reduce", 0) > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert one["collectives"]["total_wire_bytes"] == 0
    assert rec["trace_s"] > 0 and "per device" in rec["flops_counts"]


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_are_one_ranks_share(records, arch):
    """A rank of the (4, 2) mesh counts at least an eighth of the 1-rank
    step's FLOPs (the shards cover the program; what is computed whole on
    several ranks adds) and under a quarter: DTensor's shape inference,
    which runs each new operation once at its global shapes on fake
    tensors, is not counted."""
    got, _ = records
    ratio = got[f"{arch} 4x2"]["flops"] / got[f"{arch} 1x1"]["flops"]
    assert 1 / 8 <= ratio < 1 / 4, ratio


def test_a_decode_cell_is_refused_not_skipped(records):
    got, out_dir = records
    rec = got["decode"]
    assert rec["status"] == "error" and "A7.3" in rec["error"]
    assert json.loads((out_dir / "qwen3-0.6b__decode_32k__single.json")
                      .read_text())["status"] == "error"
    assert not got["group_left"]
    assert Path(got["results_dir"]) == ROOT / "results" / "dryrun_torch"


def test_all_cells_are_the_train_cells(records):
    from repro_torch.configs import ARCHS as ALL
    got, _ = records
    assert sorted(map(tuple, got["cells"])) == sorted(
        (a, "train_4k", m) for a in ALL for m in ("single", "multi"))
