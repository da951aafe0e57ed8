"""The port's executor (``repro_torch.core.executor``) and the engines'
phase models against the JAX package on the CPU.

- At the reference's constants (``test_torch_strategy``'s patch),
  ``execution_profile``'s strategy and ``cfg_overrides`` equal the
  reference's for every arch of ``ARCHS`` (full and reduced) x every shape,
  and it raises where the reference raises.
- ``phase_profiles`` merges a placement plan's per-phase overrides and
  rejects one that is not runtime-safe (``tests/test_placement.py``'s
  cases); ``apply(runtime_only=True)`` keeps only ``RUNTIME_SAFE_KEYS``;
  ``apply`` skips the knobs the port's config leaves out and raises on any
  other unknown key.
- The phase models: reduced phi3.5-moe, float32, planned at full size
  (``plan_cfg``), with a decode profile that carries ``moe_impl="ragged"``,
  through both packages' ``build_engine``: the greedy tokens are the same,
  and the port's decode model shares every parameter with its prefill
  model.
- The serving CLI prints the Mensa prefill plan and both phases' strategy
  lines, the strategies ``phase_profiles(get_config(arch))``'s.
"""
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.core import executor as ref_executor  # noqa: E402
from repro.launch.serve import build_engine as ref_build_engine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.placement import PlacementPlan as RefPlan  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import (ALL_SHAPES, ARCHS, SHAPES,  # noqa: E402
                                 get_config, reduced_config)
from repro_torch.core.executor import (RUNTIME_SAFE_KEYS,  # noqa: E402
                                       ExecutionProfile, execution_profile,
                                       phase_profiles)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.models.model_config import LEFT_OUT_KNOBS  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.serve.placement import PlacementPlan  # noqa: E402

from test_torch_archs import _serve, _trace  # noqa: E402
from test_torch_model import lively_params  # noqa: E402
from test_torch_strategy import v5e  # noqa: E402,F401  (fixture)

MOE = "phi3.5-moe-42b-a6.6b"


def _profile(fn, cfg, shape):
    try:
        p = fn(cfg, shape)
    except Exception as e:              # noqa: BLE001 — compared by type
        return type(e)
    return p.arch, p.shape, p.strategy, p.cfg_overrides


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_execution_profile_matches_reference(v5e, arch, reduced):  # noqa: F811
    cfg = reduced_config(arch) if reduced else get_config(arch)
    ref_cfg = ref_reduced(arch) if reduced else ref_get_config(arch)
    for shape in ALL_SHAPES:
        got = _profile(execution_profile, cfg, shape)
        want = _profile(ref_executor.execution_profile, ref_cfg, shape)
        assert got == want, (arch, shape.name)


def test_runtime_safe_keys_are_the_reference_set():
    assert RUNTIME_SAFE_KEYS == ref_executor.RUNTIME_SAFE_KEYS
    # every left-out knob is one the reference's profiles may set
    assert set(LEFT_OUT_KNOBS) <= RUNTIME_SAFE_KEYS
    fields = set(ref_get_config("qwen3-0.6b").__dataclass_fields__)
    assert set(LEFT_OUT_KNOBS) <= fields
    assert not set(LEFT_OUT_KNOBS) & set(get_config("qwen3-0.6b")
                                         .__dataclass_fields__)


def test_phase_profiles_merge_policy_overrides():
    cfg = get_config("qwen3-0.6b")
    plan = PlacementPlan(arch=cfg.name, source="auto", backend="cuda",
                         prefill_overrides=(("scan_chunk", 64),),
                         decode_overrides=(("moe_impl", "ragged"),))
    pre, dec = phase_profiles(cfg, policy=plan)
    assert pre.cfg_overrides == {"scan_chunk": 64}
    assert dec.cfg_overrides == {"moe_impl": "ragged"}
    assert pre.apply(cfg, runtime_only=True).scan_chunk == 64
    assert dec.apply(cfg, runtime_only=True).moe_impl == "ragged"
    ref_pre, ref_dec = ref_executor.phase_profiles(
        ref_get_config("qwen3-0.6b"), policy=RefPlan(
            arch=cfg.name, source="auto", backend="cpu",
            prefill_overrides=(("scan_chunk", 64),),
            decode_overrides=(("moe_impl", "ragged"),)))
    assert (ref_pre.cfg_overrides, ref_dec.cfg_overrides) \
        == (pre.cfg_overrides, dec.cfg_overrides)


def test_phase_profiles_reject_unsafe_policy_keys():
    cfg = get_config("qwen3-0.6b")
    bad = PlacementPlan(arch=cfg.name, source="auto", backend="cpu",
                        decode_overrides=(("d_model", "128"),))
    with pytest.raises(ValueError, match="not runtime-safe"):
        phase_profiles(cfg, policy=bad)


def test_apply_runtime_only_keeps_the_runtime_safe_keys():
    cfg = get_config("recurrentgemma-2b")
    prof = execution_profile(cfg, SHAPES["train_4k"])
    assert prof.cfg_overrides == {"remat": False, "rglru_gate_blocks": 16}
    full = prof.apply(cfg)
    assert full.rglru_gate_blocks == 16            # remat: left out
    assert prof.apply(cfg, runtime_only=True) is cfg
    moe = get_config(MOE)
    p = ExecutionProfile(moe.name, "x", "tp", {"moe_impl": "scatter",
                                               "rglru_gate_blocks": 4,
                                               "scan_chunk": 32})
    got = p.apply(moe, runtime_only=True)
    assert (got.moe_impl, got.scan_chunk, got.rglru_gate_blocks) \
        == ("scatter", 32, 0)


def test_apply_skips_left_out_knobs_and_raises_on_unknown_keys():
    cfg = get_config("qwen3-0.6b")
    skip = ExecutionProfile(cfg.name, "x", "dp",
                            {k: False for k in LEFT_OUT_KNOBS})
    assert skip.apply(cfg) is cfg
    assert skip.apply(cfg, runtime_only=True) is cfg
    bad = ExecutionProfile(cfg.name, "x", "dp", {"remat": False,
                                                 "no_such_knob": 1})
    with pytest.raises(ValueError, match="no_such_knob"):
        bad.apply(cfg)


def test_reduced_moe_plans_only_at_full_size():
    """The reference's trap, kept: a reduced MoE's 4 experts leave the
    decode shape no legal strategy on model=16, so both packages'
    ``phase_profiles`` raise, and ``build_engine`` too unless given
    ``plan_cfg``."""
    with pytest.raises(ValueError, match="empty"):
        phase_profiles(reduced_config(MOE))
    with pytest.raises(ValueError, match="empty"):
        ref_executor.phase_profiles(ref_reduced(MOE))
    with pytest.raises(ValueError, match="empty"):
        build_engine(reduced_config(MOE), slots=2, max_len=64,
                     device="cpu", policy="fixed")
    eng = build_engine(reduced_config(MOE), slots=2, max_len=64,
                       device="cpu", policy="fixed",
                       plan_cfg=get_config(MOE))
    assert eng.prefill_model is eng.decode_model is eng.model


def _ragged_decode(pre, dec):
    return pre, type(dec)(dec.arch, dec.shape, dec.strategy,
                          {**dec.cfg_overrides, "moe_impl": "ragged"},
                          dec.plan)


def test_phase_models_serve_the_jax_engines_tokens():
    jm, jp, tree = lively_params("float32", arch=MOE, gain=3.0)
    cfg = reduced_config(MOE).replace(compute_dtype="float32")
    tm = from_jax_params(tree, cfg, "cpu")
    kw = dict(slots=3, max_len=128, max_bucket=32, prefill_chunk=32,
              kv_block_size=8, policy="fixed")
    ref_profiles = _ragged_decode(
        *ref_executor.phase_profiles(ref_get_config(MOE)))
    profiles = _ragged_decode(*phase_profiles(get_config(MOE)))
    ref_eng = ref_build_engine(jm.cfg, jp, plan_cfg=ref_get_config(MOE),
                               profiles=ref_profiles, **kw)
    eng = build_engine(cfg, tm, plan_cfg=get_config(MOE),
                       profiles=profiles, **kw)
    assert ref_eng.decode_model.cfg.moe_impl == "ragged"
    assert eng.decode_model.cfg.moe_impl == "ragged"
    assert eng.prefill_model is eng.model and eng.model.cfg.moe_impl \
        == "einsum"
    ptrs = [p.data_ptr() for p in eng.prefill_model.parameters()]
    assert ptrs == [p.data_ptr() for p in eng.decode_model.parameters()]
    prompts = _trace(MOE)
    want = _serve(ref_eng, JaxRequest, prompts)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert len({tuple(g) for g in got}) == len(got)
    assert eng.stats.summary()["nonfinite_logits"] == 0


def test_serve_cli_prints_the_phase_plans(capsys):
    arch = "recurrentgemma-2b"
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--requests", "2", "--max-new", "2", "--max-len", "64",
                    "--kv-block-size", "0"])
    out = capsys.readouterr().out.splitlines()
    pre, dec = phase_profiles(get_config(arch))
    i = out.index(f"[serve] Mensa prefill plan for {arch}:")
    assert out[i + 1:i + 1 + len(pre.plan.summary().splitlines())] \
        == pre.plan.summary().splitlines()
    assert f"[serve] prefill strategy={pre.strategy} " \
        f"overrides={pre.cfg_overrides}" in out
    assert f"[serve] decode  strategy={dec.strategy} " \
        f"overrides={dec.cfg_overrides}" in out
    assert (pre.strategy, dec.strategy) == ("dp", "tp")
