"""The port's mesh helpers (``repro_torch.launch.mesh``) against the JAX
package's (``repro.launch.mesh``): ``parse_roles_arg`` and ``RoleConfig``
string for string, ``parse_mesh_arg``'s parsing with mesh construction
recorded on both sides, and ``make_serve_mesh``'s shapes and errors on a
1-rank gloo group started in a subprocess (no process group may leak into
the test worker)."""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.launch import mesh as ref_mesh  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

ROLE_SPECS = ("off", "none", "", " OFF ", "prefill=1,decode=2",
              "Prefill=3, decode=1", "prefill=2", "decode=1,prefill=4",
              "prefill=1,decode=1,extra=2", "prefill=x,decode=1",
              "prefill=0,decode=1", "banana", "prefill=1;decode=1")
MESH_SPECS = ("off", "none", "", "auto", "AUTO", "1x1", "4x2", "8",
              " 2x1 ", "banana", "2xq", "x2")


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:      # noqa: BLE001 - the type is what is held
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("spec", ROLE_SPECS)
def test_parse_roles_arg_matches_reference(spec):
    got, want = _outcome(mesh.parse_roles_arg, spec), \
        _outcome(ref_mesh.parse_roles_arg, spec)
    assert got[0] == want[0], (spec, got, want)
    if got[0] == "raises":
        assert got[1] == want[1]
    elif got[1] is None:
        assert want[1] is None
    else:
        assert (got[1].prefill, got[1].decode, got[1].mp, got[1].devices) \
            == (want[1].prefill, want[1].decode, want[1].mp,
                want[1].devices)


@pytest.mark.parametrize("counts", [(1, 1, 1), (2, 3, 2), (0, 1, 1),
                                    (1, 0, 1), (1, 1, 0)])
def test_role_config_matches_reference(counts):
    got = _outcome(lambda: mesh.RoleConfig(*counts).devices)
    want = _outcome(lambda: ref_mesh.RoleConfig(*counts).devices)
    assert got == want


@pytest.mark.parametrize("spec", MESH_SPECS)
def test_parse_mesh_arg_matches_reference(spec, monkeypatch):
    """The same strings are off, auto, a DPxMP grid or an error on both
    sides; the mesh each would build is recorded instead of built."""
    built = {"port": [], "ref": []}

    def recorder(side):
        def make(dp=None, mp=1, **kw):
            built[side].append((dp, mp))
            return (dp, mp)
        return make

    monkeypatch.setattr(mesh, "make_serve_mesh", recorder("port"))
    monkeypatch.setattr(ref_mesh, "make_serve_mesh", recorder("ref"))
    got = _outcome(mesh.parse_mesh_arg, spec)
    want = _outcome(ref_mesh.parse_mesh_arg, spec)
    assert got == want and built["port"] == built["ref"], spec


def test_data_axes():
    class M:
        mesh_dim_names = ("data", "model")

    class Pod:
        mesh_dim_names = ("pod", "data", "model")
    assert mesh.data_axes(M()) == ("data",)
    assert mesh.data_axes(Pod()) == ("pod", "data")


def test_make_serve_mesh_on_one_gloo_rank():
    """In a fresh process with no group: the mesh starts a 1-rank gloo
    group itself; (data=1, model=1) by default, DPxMP as asked; the
    reference's errors (RuntimeError naming the ranks, ValueError for a
    non-positive axis); ``parse_mesh_arg`` builds through it."""
    code = textwrap.dedent("""
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_serve_mesh, parse_mesh_arg
        assert not dist.is_initialized()
        m = make_serve_mesh(device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (1, 1)
        assert tuple(make_serve_mesh(1, 1, device="cpu").shape) == (1, 1)
        assert tuple(parse_mesh_arg("auto", device="cpu").shape) == (1, 1)
        assert tuple(parse_mesh_arg("1x1", device="cpu").shape) == (1, 1)
        assert parse_mesh_arg("off", device="cpu") is None
        for args, err, text in (((64, 64), RuntimeError,
                                 "mesh 64x64 needs 4096 ranks, have 1"),
                                ((1, 0), ValueError, "mp must be >= 1"),
                                ((0, 1), ValueError, "dp must be >= 1"),
                                ((2, 1), RuntimeError, "needs 2 ranks")):
            try:
                make_serve_mesh(*args, device="cpu")
            except err as e:
                assert text in str(e), e
            else:
                raise AssertionError(args)
        dist.destroy_process_group()
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-3000:]
