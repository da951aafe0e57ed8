"""The port's dry run (``repro_torch.launch.dryrun``) in a subprocess: a
fake default group in the pytest process would make
``launch.mesh.start_group`` skip its own start for every later test on the
same worker.  The subprocess runs reduced qwen3-0.6b, recurrentgemma-2b and
falcon-mamba-7b train cells (at the depth of one pattern), and reduced
prefill and decode cells of those three and seamless-m4t-medium, on a
fake (4, 2) group and on a fake (1, 1) one, a reduced recurrentgemma-2b
``long_500k`` cell, and one full-size decode cell through ``run_cell``
(its fake group of 256 ranks and production mesh built first); this
process checks the records against the JAX package's parameter bytes, the
states' and inputs' local shapes, and each other."""
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
#: the serving cells' families (seamless-m4t-medium with its encoder)
SERVE_ARCHS = ARCHS + ("seamless-m4t-medium",)
#: a reduced serving cell: 8 rows, two a data rank, of 32 tokens (32 cache
#: slots, 16 a model rank)
SB, SS = 8, 32
#: a reduced long cell: one row against 1024 slots
LONG = ("recurrentgemma-2b", 1024)

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
    for arch in {serve!r}:
        for kind in ("prefill", "decode"):
            shape = ShapeSpec(kind + "_small", {ss}, {sb}, kind)
            for dp, mp in ((4, 2), (1, 1)):
                dryrun.start_fake_group(8)
                try:
                    mesh = make_host_mesh((dp, mp), ("data", "model"),
                                          device="cpu")
                    cfg = reduced_config(arch)
                    cfg = cfg.replace(
                        num_layers=max(2, len(cfg.block_pattern)))
                    out[f"{{arch}} {{kind}} {{dp}}x{{mp}}"] = dryrun.measure(
                        cfg, shape, mesh)
                finally:
                    dist.destroy_process_group()
    dryrun.start_fake_group(8)
    try:
        cfg = reduced_config({long[0]!r})
        cfg = cfg.replace(num_layers=len(cfg.block_pattern))
        out["long"] = dryrun.measure(
            cfg, ShapeSpec("long_small", {long[1]}, 1, "decode"),
            make_host_mesh((4, 2), ("data", "model"), device="cpu"))
    finally:
        dist.destroy_process_group()
    out["decode"] = dryrun.run_cell("qwen3-0.6b", "decode_32k", "single",
                                    Path(sys.argv[1]))
    out["group_left"] = dist.is_initialized()
    out["cells"] = dryrun.all_cells()
    out["results_dir"] = str(dryrun.RESULTS_DIR)
    print(json.dumps(out))
""").format(s=S, b=B, archs=ARCHS, serve=SERVE_ARCHS, ss=SS, sb=SB,
           long=LONG)


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
    """The full-size qwen3-0.6b ``decode_32k`` cell on the single-pod mesh
    runs ``ok`` through ``run_cell`` (it was refused before the port's
    context-parallel caches), its record written, the fake group gone:
    one rank holds 1/256 of the 28 layers' bf16 caches of 128 x 32,768
    slots, and its decode step combines partial softmaxes over
    ``model``."""
    got, out_dir = records
    rec = got["decode"]
    assert rec["status"] == "ok", rec.get("error")
    assert json.loads((out_dir / "qwen3-0.6b__decode_32k__single.json")
                      .read_text())["status"] == "ok"
    assert not got["group_left"]
    assert Path(got["results_dir"]) == ROOT / "results" / "dryrun_torch"
    kv = 28 * 2 * 128 * 32768 * 8 * 128 * 2                 # k and v, bf16
    assert rec["memory"]["state_size_in_bytes"] == kv // 256 + 28 * 8 * 4
    assert rec["collectives"]["counts"]["all-reduce"] >= 2 * 28


def test_all_cells_are_the_train_cells(records):
    """``all_cells`` is the reference's: every arch x shape x mesh, 80."""
    from repro.launch.dryrun import all_cells as ref_cells
    got, _ = records
    assert len(got["cells"]) == 80
    assert list(map(tuple, got["cells"])) == ref_cells()


def _cached_layers(arch: str) -> int:
    """How many layers of the reduced ``arch`` (at the cells' depth) keep
    a KV cache."""
    from repro_torch.configs import reduced_config
    cfg = reduced_config(arch)
    cfg = cfg.replace(num_layers=max(2, len(cfg.block_pattern)))
    return sum(k in ("attn", "local", "dec") for k in cfg.layer_kinds)


def _input_bytes(arch: str, kind: str, rows: int) -> int:
    """One rank's inputs of ``rows`` rows: int32 tokens (S/2 beside an
    encoder-decoder's float32 frames) or a decode step's token and
    position (and the bf16 memory)."""
    from repro_torch.configs import reduced_config
    d = reduced_config(arch).d_model
    encdec = arch == "seamless-m4t-medium"
    if kind == "prefill":
        return rows * (SS // 2 * (4 + 4 * d) if encdec else SS * 4)
    return rows * (8 + (SS // 2 * d * 2 if encdec else 0))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_cell_record(records, arch, kind):
    """A serving cell's arguments are its parameters, states and inputs
    from the local shapes; a (4, 2) rank holds an eighth of the 1-rank
    KV (two rows of eight, half the slots); a (4, 2) decode step
    combines partial softmaxes — at least two all-reduces a cached
    attention layer — and the 1-rank cell moves nothing; the parameter
    bytes are the JAX ``build_lowerable``'s, the serving build's the
    same leaves in the compute dtype where they are matmul weights."""
    got, _ = records
    rec, one = got[f"{arch} {kind} 4x2"], got[f"{arch} {kind} 1x1"]
    assert rec["status"] == one["status"] == "ok"
    assert rec["meta"]["param_bytes"] == one["meta"]["param_bytes"] \
        == _ref_param_bytes(arch)
    assert rec["meta"]["serving_param_bytes"] \
        < rec["meta"]["param_bytes"]
    for r, rows in ((rec, SB // 4), (one, SB)):
        mem = r["memory"]
        assert mem["argument_size_in_bytes"] == \
            mem["parameter_size_in_bytes"] + mem["state_size_in_bytes"] \
            + _input_bytes(arch, kind, rows)
    # every cache and recurrent state splits 8 ways (rows over data, slots
    # or width over model); a cache's (B,) int32 lengths over data only
    lengths = 4 * _cached_layers(arch)
    assert (rec["memory"]["state_size_in_bytes"] - SB // 4 * lengths) * 8 \
        == one["memory"]["state_size_in_bytes"] - SB * lengths > 0
    assert one["collectives"]["total_wire_bytes"] == 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    if kind == "decode":
        assert rec["collectives"]["counts"].get("all-reduce", 0) \
            >= 2 * _cached_layers(arch)
    assert 1 / 8 <= rec["flops"] / one["flops"] < 1 / 4
    assert "per device" in rec["flops_counts"]


def test_a_long_cell_runs_on_a_window_ring(records):
    """recurrentgemma-2b's ``long_500k`` at reduced size: one row against
    1024 slots on (4, 2), its local layer's ring of ``window`` slots split
    over ``model``, no row split (one row on four data ranks)."""
    from repro_torch.configs import reduced_config
    got, _ = records
    rec = got["long"]
    assert rec["status"] == "ok" and rec["flops"] > 0
    cfg = reduced_config(LONG[0])
    half = cfg.d_rnn // 2
    rec_state = (cfg.d_conv - 1) * half * 2 + half * 4   # bf16 conv, f32 h
    ring = cfg.window // 2 * cfg.num_kv_heads * cfg.head_dim * 2 * 2
    assert rec["memory"]["state_size_in_bytes"] == 2 * rec_state + ring + 4
