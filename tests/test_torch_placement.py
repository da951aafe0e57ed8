"""The port's placement oracle, engine wiring and serving CLI against the
JAX package's, on the CPU.

- The plan: for every arch of the port's table, reduced and full size, at
  two geometries, the port's ``ExecutionOracle(backend="cpu")`` resolves
  the JAX one's plan field for field (``==``: the same float64 cost
  arithmetic), all but the kernel labels, which are the port's own.
- The engine: constructor knobs beat the plan; ``policy="auto"`` and
  ``"fixed"`` serve identical greedy and sampled tokens on the four reduced
  paths, at a geometry where the recurrent archs' auto chunk (their
  ``scan_chunk``, 16) is narrower than the fixed one; the port's auto engine
  serves the JAX auto engine's tokens in float32.
- The CLI: ``--policy-dump`` prints the JAX dump but for the kernel labels;
  ``--long-prompts``, ``--max-new`` and ``--warmup`` run; the refused
  options are exactly ``NOT_PORTED``, none."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.obs import drift as ref_drift  # noqa: E402
from repro.serve import placement as ref_placement  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.launch.serve import (NOT_PORTED, build_engine,  # noqa: E402
                                      build_parser, main)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import drift_report, plan_predictions  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.placement import (ExecutionOracle,  # noqa: E402
                                         PlacementPlan, fixed_plan,
                                         verify_kmeans_agreement)

GEOMETRIES = {"serving": dict(slots=4, max_len=1024, max_bucket=256),
              "default": {}}
#: the plan's fields the port computes as the reference does
PLAN_FIELDS = ("arch", "source", "layer_kinds", "layer_clusters", "buckets",
               "prefill_chunk", "sharding_axis", "predicted_prefill_s",
               "predicted_decode_s", "rule_kmeans_agreement", "role_knobs")
POLICY_FIELDS = ("cluster", "kinds", "accelerator", "prefill_chunk",
                 "buckets", "sharding_axis", "predicted_prefill_s",
                 "predicted_decode_s")
#: the kernel labels, which are the port's own
KERNEL_KEYS = ("backend", "kernel", "variants", "note")


def _cfgs(arch, reduced):
    if reduced:
        return reduced_config(arch), ref_reduced(arch)
    return get_config(arch), ref_get_config(arch)


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_plan_matches_reference(arch, reduced, geometry):
    cfg, ref_cfg = _cfgs(arch, reduced)
    geo = GEOMETRIES[geometry]
    got = ExecutionOracle(cfg, backend="cpu", **geo).resolve()
    want = ref_placement.ExecutionOracle(ref_cfg, backend="cpu",
                                         **geo).resolve()
    for f in PLAN_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.policies) == len(want.policies)
    for p, q in zip(got.policies, want.policies):
        for f in POLICY_FIELDS:
            assert getattr(p, f) == getattr(q, f), (p.cluster, f)
    assert got.prefill_overrides == got.decode_overrides == ()
    assert got == ExecutionOracle(cfg, backend="cpu", **geo).resolve()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_plan_on_mesh_axes_matches_reference(arch, reduced):
    """With a (data, model) mesh's axes the port's plan is the reference's,
    each cluster's ``sharding_axis`` included: "model" for a
    compute-centric cluster, "data" for a memory-centric one — at full
    size falcon-mamba's SSM cluster "data" and every qwen3 cluster
    "model", as the reference's auto-strategy test pins."""
    cfg, ref_cfg = _cfgs(arch, reduced)
    geo = dict(GEOMETRIES["serving"], mesh_axes=("data", "model"))
    got = ExecutionOracle(cfg, backend="cpu", **geo).resolve()
    want = ref_placement.ExecutionOracle(ref_cfg, backend="cpu",
                                         **geo).resolve()
    for f in PLAN_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert [(p.kinds, p.sharding_axis) for p in got.policies] \
        == [(p.kinds, p.sharding_axis) for p in want.policies]
    assert got.sharding_axis in ("data", "model")
    if arch == "falcon-mamba-7b" and not reduced:
        assert got.policy_for("ssm").sharding_axis == "data"
    if arch == "qwen3-0.6b" and not reduced:
        assert {p.sharding_axis for p in got.policies} == {"model"}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "falcon-mamba-7b"])
def test_plan_kernels_follow_the_device(arch):
    """On "cuda" every policy's kernel is "cuda", its variants the port's
    kernels that the cluster's layers launch; on "cpu" it is "plain".
    The geometry and predictions do not depend on the backend."""
    cfg = get_config(arch)
    card = ExecutionOracle(cfg, slots=4, max_len=1024,
                           max_bucket=256).resolve()
    cpu = ExecutionOracle(cfg, slots=4, max_len=1024, max_bucket=256,
                          backend="cpu").resolve()
    assert card.backend == "cuda" and cpu.backend == "cpu"
    assert all(p.kernel == "cuda" for p in card.policies)
    assert all(p.kernel == "plain" and not p.variants for p in cpu.policies)
    variants = {k: p.variants for p in card.policies for k in p.kinds}
    want = {"qwen3-0.6b": {"attn": ("cuda_flash", "cuda_paged")},
            "recurrentgemma-2b": {"local": ("cuda_flash",),
                                  "rec": ("cuda_rglru",)},
            "falcon-mamba-7b": {"ssm": ("cuda_ssm",)}}[arch]
    for kind, names in want.items():
        assert variants[kind] == names
    assert card.prefill_overrides == card.decode_overrides == ()
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k not in ("backend", "policies")}
    assert strip(card.summary()) == strip(cpu.summary())
    with pytest.raises(ValueError, match="backend"):
        ExecutionOracle(cfg, backend="tpu").resolve()


@pytest.mark.parametrize("arch,floor", [("qwen3-0.6b", 0.9),
                                        ("recurrentgemma-2b", 0.6),
                                        ("falcon-mamba-7b", 0.9)])
def test_kmeans_agreement_matches_reference(arch, floor):
    got = verify_kmeans_agreement(get_config(arch), max_len=256,
                                  min_agreement=floor)
    want = ref_placement.verify_kmeans_agreement(
        ref_get_config(arch), max_len=256, min_agreement=floor)
    assert got == want >= floor


def test_fixed_plan_matches_reference():
    got = fixed_plan(get_config("qwen3-0.6b"), buckets=(16, 32),
                     prefill_chunk=32, backend="cpu")
    want = ref_placement.fixed_plan(ref_get_config("qwen3-0.6b"),
                                    buckets=(16, 32), prefill_chunk=32,
                                    backend="cpu")
    assert got.summary() == want.summary()
    assert got.dumps() == want.dumps()
    assert got.source == "fixed" and got.policies == ()
    assert got.policy_for("attn") is None


def test_drift_matches_reference():
    """The same plan summary and measured times give the same predictions
    and drift report; a fixed plan has nothing to compare."""
    plan = ExecutionOracle(get_config("recurrentgemma-2b"), slots=4,
                           max_len=4096, max_bucket=256).resolve().summary()
    measured = {"prefill_token_s": 3.5e-4, "decode_step_s": 0.036}
    assert plan_predictions(plan) == ref_drift.plan_predictions(plan)
    got = drift_report(plan_predictions(plan), measured)
    assert got == ref_drift.drift_report(plan_predictions(plan), measured)
    assert set(got["phases"]) == {"prefill_token_s", "decode_step_s"}
    fixed = fixed_plan(get_config("qwen3-0.6b"), buckets=(16,),
                       prefill_chunk=16).summary()
    assert plan_predictions(fixed) == {}
    assert drift_report({}, measured) == {}


# ---------------------------------------------------------------- the engine
def _tiny(arch="qwen3-0.6b"):
    return reduced_config(arch).replace(compute_dtype="float32")


def test_engine_constructor_knobs_beat_policy():
    cfg = _tiny()
    model = build_model(cfg, device="cpu", seed=0)
    plan = ExecutionOracle(cfg, slots=2, max_len=64, max_bucket=32,
                           backend="cpu").resolve()
    # explicit constructor geometry wins over the plan's
    eng = ServeEngine(model, slots=2, max_len=64, buckets=(16,),
                      prefill_chunk=16, policy=plan)
    assert eng.buckets == (16,) and eng.prefill_chunk == 16
    assert eng.stats.placement["source"] == "auto"
    # without explicit knobs the plan's geometry is adopted
    eng = ServeEngine(model, slots=2, max_len=64, policy=plan)
    assert eng.buckets == plan.buckets
    assert eng.prefill_chunk == plan.prefill_chunk
    # with no plan the engine records a fixed one of its own knobs
    eng = ServeEngine(model, slots=2, max_len=64, min_bucket=8,
                      max_prefill_batch=8, max_prefill_per_step=3)
    assert eng.buckets == (8, 16, 32, 64) and eng.prefill_chunk == 64
    assert eng.max_prefill_batch == 2 and eng.max_prefill_per_step == 3
    assert eng.policy.source == "fixed" and eng.policy.backend == "cpu"
    assert eng.stats.summary()["placement"]["prefill_chunk"] == 64


def _trace(cfg):
    rng = np.random.RandomState(5)
    samp = dict(temperature=0.8, top_k=20, top_p=0.9, seed=9)
    return [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size, n).tolist(),
                    max_new_tokens=6, **(samp if i == 2 else {}))
            for i, n in enumerate((6, 45, 15, 70))]


@pytest.mark.parametrize("arch,kv_block_size", [
    ("qwen3-0.6b", 8), ("qwen3-0.6b", None), ("recurrentgemma-2b", None),
    ("falcon-mamba-7b", None)], ids=["qwen3-paged", "qwen3-dense",
                                     "recurrentgemma", "falcon-mamba"])
def test_policy_auto_token_identity_and_stats(arch, kv_block_size):
    cfg = _tiny(arch)
    model = build_model(cfg, device="cpu", seed=0)

    def run(policy):
        eng = build_engine(cfg, model, slots=2, max_len=128, max_bucket=32,
                           kv_block_size=kv_block_size, policy=policy)
        done = eng.run(_trace(cfg), on_truncate="raise")
        return eng, [r.generated for r in done], eng.stats.summary()

    auto, auto_toks, auto_s = run("auto")
    fixed, fixed_toks, fixed_s = run("fixed")
    assert auto_toks == fixed_toks
    assert len({tuple(t) for t in auto_toks}) > 1          # tokens vary
    # the recurrent clusters bound the chunk at scan_chunk: other chunks
    want_chunk = 32 if arch == "qwen3-0.6b" else cfg.scan_chunk
    assert auto.prefill_chunk == want_chunk and fixed.prefill_chunk == 32
    assert auto_s["prefills_chunked"] >= 1
    assert auto_s["prefill_chunks"] >= fixed_s["prefill_chunks"]
    p = auto_s["placement"]
    assert p["source"] == "auto" and p["backend"] == "cpu" and p["policies"]
    assert p["measured"]["decode_step_s"] > 0
    assert p["predicted"]["decode_step_s"] > 0
    assert set(p["drift"]["phases"]) == {"prefill_token_s", "decode_step_s"}
    assert fixed_s["placement"]["source"] == "fixed"
    assert fixed_s["placement"]["drift"] == {}


def test_auto_engine_matches_jax_auto_engine():
    """Reduced qwen3, float32, paged, the same weights through the bridge:
    the port's and the JAX package's ``build_engine(policy="auto")`` resolve
    one geometry and serve the same greedy tokens (sampled ones come from
    each framework's own generator)."""
    from repro.launch.serve import build_engine as ref_build_engine
    from repro.serve.engine import Request as RefRequest
    from test_torch_model import ARCH, lively_params
    _, params, tree = lively_params("float32")
    ref_cfg = ref_reduced(ARCH).replace(compute_dtype="float32")
    cfg = reduced_config(ARCH).replace(compute_dtype="float32")
    model = from_jax_params(tree, cfg, "cpu")
    kw = dict(slots=2, max_len=128, max_bucket=32, kv_block_size=8)
    ref_eng = ref_build_engine(ref_cfg, params, policy="auto", **kw)
    eng = build_engine(cfg, model, policy="auto", **kw)
    assert (eng.buckets, eng.prefill_chunk) \
        == (ref_eng.buckets, ref_eng.prefill_chunk)

    def trace(cls):
        rng = np.random.RandomState(5)
        return [cls(rid=i, prompt=rng.randint(1, 512, n).tolist(),
                    max_new_tokens=6) for i, n in enumerate((6, 45, 15))]

    want = [r.generated for r in ref_eng.run(trace(RefRequest))]
    got = [r.generated for r in eng.run(trace(Request))]
    assert got == want
    assert len({tuple(t) for t in got}) == len(got)
    assert eng.stats.prefill_chunks == ref_eng.stats.prefill_chunks >= 1


def test_build_engine_rejects_unknown_policy():
    cfg = _tiny()
    with pytest.raises(ValueError, match="policy"):
        build_engine(cfg, slots=2, max_len=64, policy="oracle", device="cpu")
    plan = fixed_plan(cfg, buckets=(16,), prefill_chunk=16)
    eng = build_engine(cfg, slots=2, max_len=64, policy=plan, device="cpu")
    assert isinstance(eng.policy, PlacementPlan) and eng.policy is plan
    assert eng.buckets == (16,) and eng.prefill_chunk == 16


# ------------------------------------------------------------------- the CLI
def _strip_kernels(dump: dict) -> dict:
    out = {k: v for k, v in dump.items() if k not in KERNEL_KEYS}
    out["policies"] = [{k: v for k, v in p.items() if k not in KERNEL_KEYS}
                       for p in dump["policies"]]
    return out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "falcon-mamba-7b"])
def test_cli_policy_dump_matches_reference(arch, capsys):
    from repro.launch.serve import main as ref_main
    argv = ["--policy-dump", "--arch", arch, "--max-len", "1024",
            "--max-bucket", "256", "--slots", "4"]
    ref_main(argv)
    want = json.loads(capsys.readouterr().out)
    assert main(argv) is None
    got = json.loads(capsys.readouterr().out)
    assert got["backend"] == "cuda"
    assert all(p["kernel"] == "cuda" for p in got["policies"])
    assert _strip_kernels(got) == _strip_kernels(want)


def test_cli_long_prompts_max_new_and_warmup_run_on_cpu(capsys):
    s = main(["--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
              "--kv-block-size", "0", "--max-len", "64", "--max-bucket", "16",
              "--requests", "3", "--long-prompts", "1", "--max-new", "5",
              "--warmup", "--min-bucket", "8", "--max-prefill-per-step", "2",
              "--max-prefill-batch", "2"])
    out = capsys.readouterr().out
    assert "[serve] placement plan (auto, backend cpu)" in out
    assert s["requests_completed"] == 4 and s["tokens_generated"] == 20
    assert s["prefills_chunked"] == 1 and s["prefill_chunks"] >= 2
    assert s["placement"]["buckets"] == [8, 16]
    s = main(["--reduced", "--device", "cpu", "--max-len", "64",
              "--kv-block-size", "8", "--requests", "2", "--policy", "fixed",
              "--max-new", "3"])
    assert s["tokens_generated"] == 6
    assert s["placement"]["source"] == "fixed"
    with pytest.raises(SystemExit, match="--long-prompts needs prompts"):
        main(["--reduced", "--device", "cpu", "--max-len", "64",
              "--kv-block-size", "8", "--long-prompts", "1"])


def test_cli_refuses_exactly_the_options_not_ported():
    """No option is refused (the roles' and the meshes' are served); the
    program memory is accepted both ways and measures each warmed program
    on the CPU: its argument and output bytes, no watermark."""
    assert set(NOT_PORTED) == set()
    assert not build_parser().parse_args(
        ["--no-program-memory"]).program_memory
    s = main(["--reduced", "--device", "cpu", "--max-len", "64",
              "--kv-block-size", "8", "--requests", "2", "--max-new", "3",
              "--warmup", "--program-memory"])
    progs = s["programs"]["programs"]
    assert {"prefill[1x16]", "chunk", "copy", "decode"} <= set(progs)
    for rec in progs.values():
        assert set(rec["memory"]) == {"argument_size_in_bytes",
                                      "output_size_in_bytes"}
    assert "temp_bytes_peak" not in s["programs"]
