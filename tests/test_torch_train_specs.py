"""The training half of the port's shardings and the dry run's arithmetic
against the JAX package, with no process group (a spec needs a mesh only
for its axis sizes):

- ``batch_specs`` ("tp" and "dp") and ``state_specs`` equal the
  reference's for every arch of ``configs.ARCHS`` on (1, 1), (4, 2),
  (2, 4) and a (pod, data, model) mesh, the stack axis of a stacked
  reference leaf dropped;
- the dry run's ``param_bytes`` of every arch at full size equals the
  reference's (its ``build_lowerable``'s ``_tree_bytes`` of the abstract
  init), and its microbatch count divides a data rank's rows;
- ``quantize_int8``/``dequantize_int8`` equal the reference's.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.launch import shardings as ref_sh  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.train import grad as ref_grad  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import grad  # noqa: E402

#: abstract meshes: (axis names, sizes)
MESHES = {"1x1": (("data", "model"), (1, 1)),
          "4x2": (("data", "model"), (4, 2)),
          "2x4": (("data", "model"), (2, 4)),
          "pod2x4x2": (("pod", "data", "model"), (2, 4, 2))}


def _mesh(name: str):
    axes, sizes = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))


def _norm(spec) -> tuple:
    """A spec's entries with a one-axis tuple read as its bare name (jax
    0.9's ``PartitionSpec`` keeps ``("data",)`` as ``'data'``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    cfg, ref_cfg = reduced_config(arch), ref_reduced(arch)
    return cfg, ref_cfg, build_model(cfg, device="meta"), ref_build(ref_cfg)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_state_specs_match_reference(arch, mesh):
    """The training batch's specs under "tp" and "dp" for a batch that
    splits over the data axes (8) and one that does not (3), and one spec
    a state leaf, each the reference's."""
    cfg, ref_cfg, model, ref_model = _models(arch)
    m = _mesh(mesh)
    for strategy in ("tp", "dp"):
        for batch in (8, 3):
            got = sh.batch_specs(cfg, m, batch, strategy)
            want = ref_sh.batch_specs(ref_cfg, m, batch, strategy)
            assert set(got) == set(want)
            for k in want:
                assert _norm(got[k]) == _norm(tuple(want[k])), (k, strategy)
    if cfg.is_encdec:
        return                  # neither package has a decoder state for it
    for batch in (8, 3):
        got = sh.state_specs(model, m, batch, 64)
        want = ref_sh.state_specs(ref_model, m, batch, 64)
        pat = len(ref_cfg.block_pattern)
        grouped = ref_cfg.num_layers // pat * pat
        assert len(got) == ref_cfg.num_layers
        for i, st in enumerate(got):
            ref = want["groups"][str(i % pat)] if i < grouped \
                else want["tail"][i - grouped]
            drop = 1 if i < grouped else 0
            if st.kv is not None:
                assert ref.kv is not None and ref.rec is None
                for a, b in zip(st.kv, ref.kv):
                    assert _norm(a) == _norm(tuple(b)[drop:]), (i, a, b)
            else:
                assert set(st.rec) == set(ref.rec)
                for k in st.rec:
                    assert _norm(st.rec[k]) \
                        == _norm(tuple(ref.rec[k])[drop:]), (i, k)


def _ref_param_bytes(ref_cfg) -> float:
    """The reference ``build_lowerable``'s ``meta["param_bytes"]``:
    ``_tree_bytes`` of the abstract init."""
    model = ref_build(ref_cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return float(sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                     for leaf in jax.tree.leaves(shapes)))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_bytes_equal_the_reference_dry_run(arch):
    assert dryrun.param_bytes(get_config(arch)) \
        == _ref_param_bytes(ref_get_config(arch))


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_accum_steps_split_a_data_ranks_rows(arch, mesh):
    """The reference's ``ACCUM`` where a data rank's rows take it, else
    the largest count below it that divides them."""
    shape = SHAPES["train_4k"]
    m = SimpleNamespace(
        axis_names=("pod", "data", "model") if mesh == "multi"
        else ("data", "model"),
        shape={"pod": 2, "data": 16, "model": 16} if mesh == "multi"
        else {"data": 16, "model": 16})
    rows = shape.global_batch // (32 if mesh == "multi" else 16)
    want = dryrun.ACCUM.get(arch, dryrun.ACCUM["default"])
    got = dryrun.accum_steps(get_config(arch), shape, m)
    assert rows % got == 0 and 1 <= got <= want
    assert got == want or rows < want


def test_quantize_int8_matches_reference():
    x = np.random.RandomState(0).standard_normal((7, 33)).astype(np.float32)
    x[2, 5] = 40.0
    q, scale = grad.quantize_int8(torch.from_numpy(x))
    rq, rscale = ref_grad.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)
    np.testing.assert_array_equal(
        grad.dequantize_int8(q, scale).numpy(),
        np.asarray(ref_grad.dequantize_int8(rq, rscale)))
