"""The port's execution-strategy planner (``repro_torch.core.strategy``,
``configs/shapes.py``) against the JAX package's on the CPU.

- At the reference's constants (the port's module constants patched to
  ``repro.core.accelerators.TPU_V5E``'s, read here), every arch of
  ``ARCHS``, full and reduced, x every shape x the meshes 16 x 16, 4 x 4
  and 2 x 8: each block's cluster, strategy and candidates (exactly: the
  same arithmetic), the phase-2 merges and ``summary()`` equal the
  reference's plan; where the reference raises, the port raises the same
  exception type.
- Unpatched, the port prices on ``core/h100.H100_SXM``: every block's
  strategy is a legal template of its class, in its candidates, and their
  minimum before phase 2 (or a phase-2 merge names it); the cells whose
  decisions differ from the v5e-priced plan are exactly the ones pinned
  below.
- ``configs/shapes.py`` is the reference's, and ``sub_quadratic`` agrees.
"""
import pytest

pytest.importorskip("torch")

from repro.configs import ALL_SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import applicable as ref_applicable  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.core import strategy as ref_strategy  # noqa: E402
from repro.core.accelerators import TPU_V5E  # noqa: E402
from repro.core.executor import plan_for_cell as ref_plan_for_cell  # noqa: E402
from repro_torch.configs import (ALL_SHAPES, ARCHS, SHAPES,  # noqa: E402
                                 applicable, get_config, reduced_config)
from repro_torch.core import h100, strategy  # noqa: E402
from repro_torch.core.executor import execution_profile, plan_for_cell  # noqa: E402

MESHES = [(16, 16), (4, 4), (2, 8)]


def _patch_v5e(mp) -> None:
    """The port's planner at the reference's chip constants."""
    mp.setattr(strategy, "PEAK_FLOPS", TPU_V5E.peak_flops)
    mp.setattr(strategy, "HBM_BW", TPU_V5E.hbm_bw)
    mp.setattr(strategy, "LINK_BW", TPU_V5E.ici_bw)
    mp.setattr(strategy, "HBM_BUDGET", TPU_V5E.hbm_budget)


@pytest.fixture
def v5e(monkeypatch):
    _patch_v5e(monkeypatch)


def _configs(arch: str, reduced: bool):
    if reduced:
        return reduced_config(arch), ref_reduced(arch)
    return get_config(arch), ref_get_config(arch)


def _plans(fn, cfg, shapes, mesh):
    """Each shape's plan, or the type of what planning it raised."""
    out = {}
    for shape in shapes:
        try:
            out[shape.name] = fn(cfg, shape, mesh)
        except Exception as e:          # noqa: BLE001 — compared by type
            out[shape.name] = type(e)
    return out


def _blocks(p):
    return [(b.name, b.cluster, b.strategy, b.candidates, b.reason)
            for b in p.blocks]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_plan_matches_reference_at_its_constants(v5e, arch, mesh, reduced):
    cfg, ref_cfg = _configs(arch, reduced)
    got = _plans(plan_for_cell, cfg, ALL_SHAPES, strategy.MeshShape(*mesh))
    want = _plans(ref_plan_for_cell, ref_cfg, REF_SHAPES,
                  ref_strategy.MeshShape(*mesh))
    assert set(got) == set(want) == set(SHAPES)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, type):
            assert g is w, f"{arch} x {name}: the reference raises {w}"
            continue
        assert not isinstance(g, type), f"{arch} x {name}: port raised {g}"
        assert _blocks(g) == _blocks(w)
        assert g.phase2_merges == w.phase2_merges
        assert (g.arch, g.shape) == (w.arch, w.shape)
        assert g.summary() == w.summary()


def test_reference_constants_raise_where_the_reference_raises(v5e):
    """The reduced MoE configs' 4 experts do not divide model=16, and the
    decode shapes' 128 and 1 tokens leave data parallelism no batch: both
    packages fail in ``min()`` of an empty candidate dict."""
    for arch in ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"):
        for shape in ("decode_32k", "long_500k"):
            with pytest.raises(ValueError, match="empty"):
                plan_for_cell(reduced_config(arch), SHAPES[shape])
            with pytest.raises(ValueError, match="empty"):
                ref_plan_for_cell(ref_reduced(arch), SHAPES[shape])


# ------------------------------------------------------- the H100 plan
def test_planner_prices_the_h100():
    assert strategy.PEAK_FLOPS == h100.PEAK_FLOPS["bfloat16"]
    assert strategy.HBM_BW == h100.HBM_BW
    assert strategy.LINK_BW == h100.NVLINK_BW == h100.H100_SXM.link_bw
    assert strategy.HBM_BUDGET == h100.H100_SXM.hbm_budget
    # 75% of 80 GB, the share the reference keeps of v5e's 16 GB
    assert h100.HBM_BUDGET / 80e9 == TPU_V5E.hbm_budget / 16e9 == 0.75
    assert strategy.MeshShape().devices == 256
    assert strategy.PEAK_FLOPS != TPU_V5E.peak_flops


def _min_before_phase2(p) -> None:
    merged = {m.split(":")[0] for m in p.phase2_merges}
    for b in p.blocks:
        assert set(b.candidates) <= set(strategy._CANDIDATES[b.name])
        assert b.strategy in b.candidates
        if b.name not in merged:
            assert b.candidates[b.strategy] \
                == min(b.candidates.values()), (p.arch, b.name)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_h100_plan_invariants(arch, mesh, reduced):
    cfg = reduced_config(arch) if reduced else get_config(arch)
    plans = _plans(plan_for_cell, cfg, ALL_SHAPES, strategy.MeshShape(*mesh))
    for name, p in plans.items():
        if isinstance(p, type):
            # only a reduced MoE fails, as at the reference's constants
            assert p is ValueError and reduced and cfg.ffn_kind == "moe"
            continue
        _min_before_phase2(p)
        assert [b.name for b in p.blocks][-1] == "embed"


#: the cells of ARCHS x SHAPES (full size, 16 x 16) whose decisions on the
#: H100 differ from the v5e-priced plan's: (profile strategy, overrides,
#: {block: strategy}) on the H100
H100_CHANGED = {
    ("recurrentgemma-2b", "train_4k"): (
        "dp", {"remat": False, "rglru_gate_blocks": 16},
        {"attn": "pascal_dp", "ffn": "pascal_dp", "rec": "pascal_dp"}),
    ("internvl2-2b", "train_4k"): (
        "dp", {"remat": False}, {"attn": "pascal_dp", "ffn": "pascal_dp"}),
    ("starcoder2-7b", "train_4k"): (
        "tp", {}, {"attn": "pascal_dp", "ffn": "pascal_tp"}),
    ("phi3.5-moe-42b-a6.6b", "train_4k"): (
        "tp", {"moe_impl": "scatter"},
        {"attn": "pascal_dp", "moe": "jacquard_shard"}),
    ("llama4-scout-17b-a16e", "train_4k"): (
        "tp", {"moe_impl": "scatter"},
        {"attn": "pascal_dp", "moe": "jacquard_shard"}),
    ("falcon-mamba-7b", "prefill_32k"): ("dp", {}, {"ssm": "pascal_dp"}),
}


def _decisions():
    out = {}
    for arch in ARCHS:
        for shape in ALL_SHAPES:
            p = execution_profile(get_config(arch), shape)
            out[(arch, shape.name)] = (
                p.strategy, p.cfg_overrides,
                {b.name: b.strategy for b in p.plan.blocks})
    return out


def test_h100_decisions_differ_from_v5e_where_pinned(monkeypatch):
    h = _decisions()
    for key, (strat, ov, blocks) in H100_CHANGED.items():
        assert h[key][:2] == (strat, ov), key
        assert {k: h[key][2][k] for k in blocks} == blocks, key
    with monkeypatch.context() as m:
        _patch_v5e(m)
        v = _decisions()
    assert len(h) == 40
    assert {k for k in h if h[k] != v[k]} == set(H100_CHANGED)
    # every serving profile's runtime-safe overrides stay empty, H100 or v5e
    for (arch, shape), (_, ov, _) in h.items():
        if shape in ("prefill_32k", "decode_32k"):
            assert not set(ov) - {"rglru_gate_blocks"}, (arch, shape)


# ------------------------------------------------------------- the shapes
def test_shapes_are_the_reference_shapes():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in ALL_SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in REF_SHAPES]
    assert list(SHAPES) == [s.name for s in ALL_SHAPES]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_applicable_and_sub_quadratic_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert cfg.sub_quadratic == ref_cfg.sub_quadratic
    assert reduced_config(arch).sub_quadratic \
        == ref_reduced(arch).sub_quadratic
    for shape, ref_shape in zip(ALL_SHAPES, REF_SHAPES):
        assert applicable(cfg, shape) == ref_applicable(ref_cfg, ref_shape)
