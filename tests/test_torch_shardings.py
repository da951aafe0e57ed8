"""The port's serving shardings (``repro_torch.launch.shardings``) against
the JAX package's (``repro.launch.shardings``): each parameter's spec, leaf
by leaf through ``bridge.layout`` (the JAX stack axis dropped), for every
arch under "tp", "dp" and "auto", at reduced size and with the full config
deciding the flags; the serving state's specs for the three state
families, dense and paged, on abstract meshes of every shape the multi-rank
tests use; and the specs' DTensor placements.  No process group: a spec
needs a mesh only for its axis sizes."""
import functools
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.launch import shardings as ref_sh  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.serve import placement as ref_placement  # noqa: E402
from repro_torch.bridge import layout  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.core.h100 import GIGA  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.placement import resolve_policy  # noqa: E402

FAMILIES = ("qwen3-0.6b", "recurrentgemma-2b", "falcon-mamba-7b")
MESHES = ((1, 1), (2, 1), (4, 2), (8, 1))
AXES = ("data", "model")


def _norm(spec) -> tuple:
    """A spec's entries with a one-axis tuple read as its bare name: jax
    0.9's ``PartitionSpec`` keeps ``("data",)`` as ``'data'``."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _mesh(dp: int, mp: int):
    """An abstract (data, model) mesh: the axis names and sizes are all a
    spec reads, on either side."""
    return SimpleNamespace(axis_names=AXES,
                           shape={"data": dp, "model": mp})


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    """The reduced port model (empty tensors on the CPU) and the JAX
    model's parameter shapes."""
    cfg = reduced_config(arch)
    ref_cfg = ref_reduced(arch)
    model = ref_build(ref_cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return build_model(cfg, device="cpu"), shapes


@functools.lru_cache(maxsize=None)
def _plans(arch: str):
    geo = dict(slots=4, max_len=256, mesh_axes=AXES)
    return (resolve_policy(get_config(arch), backend="cpu", **geo),
            ref_placement.resolve_policy(ref_get_config(arch),
                                         backend="cpu", **geo))


def _at(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("strategy", ["tp", "dp", "auto"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, strategy):
    """Every parameter's spec is the reference's leaf's, the stack axis of
    a stacked leaf dropped — with the reduced config and with the full one
    passed as ``cfg`` (the 2-D layout of phi3.5-moe and llama4-scout), the
    auto plans both packages' oracles resolve on a (data, model) mesh."""
    model, shapes = _models(arch)
    plan, ref_plan = _plans(arch) if strategy == "auto" else (None, None)
    for cfg, ref_cfg in ((reduced_config(arch), ref_reduced(arch)),
                         (get_config(arch), ref_get_config(arch))):
        got = sh.param_specs(cfg, model, strategy, plan=plan)
        want = ref_sh.param_specs(ref_cfg, shapes, strategy, plan=ref_plan)
        leaves = layout(model)
        assert set(got) == {leaf.name for leaf in leaves}
        for leaf in leaves:
            ref = tuple(_at(want, leaf.path))
            if leaf.index is not None:
                ref = ref[1:]
            assert _norm(got[leaf.name]) == _norm(ref), (cfg.name, leaf)
        if ref_cfg.param_count() > 20 * GIGA and strategy == "tp":
            assert got["layers.0.attn.wq"] == ("data", "model")


def test_param_specs_auto_follows_the_plan():
    """falcon-mamba's SSM cluster prefers "data": "auto" replicates exactly
    the SSM family that "tp" slices over ``model``; the embedding stays
    vocab-sharded; on qwen3 (every cluster "model") "auto" is "tp"; and
    "auto" without a plan is a usage error."""
    model, _ = _models("falcon-mamba-7b")
    cfg = reduced_config("falcon-mamba-7b")
    plan, _ = _plans("falcon-mamba-7b")
    tp = sh.param_specs(cfg, model, "tp")
    auto = sh.param_specs(cfg, model, "auto", plan=plan)
    changed = {k for k in tp if tp[k] != auto[k]}
    assert changed and all(".ssm." in k for k in changed)
    assert all("model" in tp[k] and set(auto[k]) == {None} for k in changed)
    assert auto["embed"] == tp["embed"] == ("model", None)
    qwen, _ = _models("qwen3-0.6b")
    qplan, _ = _plans("qwen3-0.6b")
    qcfg = reduced_config("qwen3-0.6b")
    assert sh.param_specs(qcfg, qwen, "auto", plan=qplan) \
        == sh.param_specs(qcfg, qwen, "tp")
    with pytest.raises(ValueError):
        sh.param_specs(cfg, model, "auto")


def _state_cases():
    for arch in FAMILIES:
        for paged in (False, True):
            if paged and arch != "qwen3-0.6b":
                continue        # paged KV covers full-attention stacks
            for slots, blocks in ((8, 32), (3, 9)):
                yield arch, paged, slots, blocks


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,paged,slots,blocks", list(_state_cases()))
def test_serve_state_specs_match_reference(arch, paged, slots, blocks, mesh):
    """One spec a state leaf, each the reference's: slots on ``data`` when
    they divide it, heads and widths on ``model`` when they divide it, a
    paged pool's blocks on ``data`` when the stripes come out equal —
    divisible and non-divisible slots and pools alike."""
    cfg = reduced_config(arch)
    cfg = cfg.replace(num_layers=max(2, len(cfg.block_pattern)))
    ref_cfg = ref_reduced(arch)
    ref_cfg = ref_cfg.replace(num_layers=max(2, len(ref_cfg.block_pattern)))
    kw = dict(kv_block_size=16, kv_blocks=blocks) if paged else {}
    m = _mesh(*mesh)
    got = sh.serve_state_specs(build_model(cfg, device="cpu"), m, slots, 64,
                               **kw)
    ref_model = ref_build(ref_cfg)
    want = ref_sh.serve_state_specs(ref_model, m, slots, 64, **kw)
    pat = len(ref_cfg.block_pattern)
    grouped = ref_cfg.num_layers // pat * pat
    assert len(got) == ref_cfg.num_layers
    for i, st in enumerate(got):
        ref = want["groups"][str(i % pat)] if i < grouped \
            else want["tail"][i - grouped]
        drop = 1 if i < grouped else 0
        if st.kv is not None:
            assert type(st.kv).__name__ == type(ref.kv).__name__
            for a, b in zip(st.kv, ref.kv):
                assert _norm(a) == _norm(tuple(b)[drop:]), (i, a, b)
        else:
            assert set(st.rec) == set(ref.rec)
            for k in st.rec:
                assert _norm(st.rec[k]) == _norm(tuple(ref.rec[k])[drop:])


class _DeviceMesh:
    """The two things ``to_placements`` reads of a DeviceMesh."""

    def __init__(self, dp: int, mp: int):
        self.mesh_dim_names = AXES
        self.shape = (dp, mp)

    def size(self, dim: int) -> int:
        return self.shape[dim]


def test_to_placements():
    """``Shard(i)`` on each mesh dim entry ``i`` names (a tuple names
    several), ``Replicate()`` elsewhere and on a dim of size 1; a spec
    naming one axis twice is refused."""
    from torch.distributed.tensor import Replicate, Shard
    m = _DeviceMesh(2, 4)
    assert sh.to_placements(("model", None), m) == (Replicate(), Shard(0))
    assert sh.to_placements((("data",), None, "model", None), m) \
        == (Shard(0), Shard(2))
    assert sh.to_placements((("data", "model"), None), m) \
        == (Shard(0), Shard(0))
    assert sh.to_placements((None, None), m) == (Replicate(), Replicate())
    assert sh.to_placements(("data", "model"), _DeviceMesh(1, 4)) \
        == (Replicate(), Shard(1))
    with pytest.raises(ValueError):
        sh.to_placements(("model", "model"), m)


def test_local_config_divides_the_sharded_widths():
    """A rank's widths under "tp" on a (1, 2) mesh: heads, d_ff, d_rnn /
    d_inner halved where they split; "dp" and a 1-wide model axis keep the
    config; "auto" keeps falcon-mamba's replicated SSM width."""
    cfg = reduced_config("qwen3-0.6b")
    local = sh.local_config(cfg, _mesh(1, 2), "tp")
    assert (local.num_heads, local.num_kv_heads, local.d_ff) \
        == (cfg.num_heads // 2, cfg.num_kv_heads // 2, cfg.d_ff // 2)
    assert sh.local_config(cfg, _mesh(1, 2), "dp") is cfg
    assert sh.local_config(cfg, _mesh(4, 1), "tp") is cfg
    mamba = reduced_config("falcon-mamba-7b")
    assert sh.local_config(mamba, _mesh(1, 2), "tp").d_inner \
        == mamba.d_inner // 2
    plan, _ = _plans("falcon-mamba-7b")
    assert sh.local_config(mamba, _mesh(1, 2), "auto", plan) is mamba
