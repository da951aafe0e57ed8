"""The port's observability against the reference's, on the CPU: the copied
``obs.metrics`` / ``obs.trace`` modules, ``EngineStats.summary()``'s
schema and TTFT median, ``reset_stats()``, the engine's trace, and the
CLI's ``--trace`` / ``--metrics-json`` / ``--metrics-prom``."""
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro.serve.engine import EngineStats as JaxStats  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402
from repro_torch.serve.engine import (NOT_PORTED_STATS,  # noqa: E402
                                      EngineStats, Request, ServeEngine)

from test_torch_engine import KW, _prompts  # noqa: E402
from test_torch_model import ARCH, lively_params  # noqa: E402

#: the port's key beyond the reference's schema: a difference by design
PORT_ONLY = {"nonfinite_logits"}
#: values a histogram records: below its base, at bucket edges, far above
SAMPLES = [3e-7, 1e-6, 2.5e-3, 0.0123, 0.0124, 0.5, 0.51, 7.0, 1e4, 0.0]


# ------------------------------------------------------- the copied modules
def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("prefill_waste_tokens", "tokens").inc(33)
    reg.counter("plain").inc()
    reg.gauge("kv_pool_bytes", "bytes").set(18432)
    reg.gauge("2nd gauge").set(1.5)
    h = reg.histogram("ttft_s")
    t = reg.histogram("tokens_per_tick", base=1.0, unit="tokens")
    for v in SAMPLES:
        h.record(v)
        t.record(int(v * 10))
    return reg


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_metrics_copy_gives_the_reference_output(q):
    ours, ref = _fill(metrics), _fill(ref_metrics)
    assert ours.to_dict() == ref.to_dict()
    assert ours.to_prometheus() == ref.to_prometheus()
    assert ours.to_prometheus("x") == ref.to_prometheus("x")
    for name in ("ttft_s", "tokens_per_tick"):
        assert ours.histogram(name).quantile(q) \
            == ref.histogram(name).quantile(q)
    assert metrics.OBS_SCHEMA_VERSION == ref_metrics.OBS_SCHEMA_VERSION
    with pytest.raises(ValueError):
        metrics.Histogram("h", base=0.0)


def _traced(mod, capacity):
    ticks = iter(range(1000))
    tr = mod.Tracer(capacity, clock=lambda: 0.25 * next(ticks))
    tr.set_track(0, "requests")
    tr.set_track(2, "slot 1")
    tr.instant("submit", 0, tr.now(), (("rid", 1), ("prompt_tokens", 5)))
    t0 = tr.now()
    tr.begin("req 1", 2, t0, (("rid", 1),))
    tr.span("prefill", 2, t0, tr.now(), (("bucket", 16),))
    tr.counter("slots", tr.now(), (("busy", 1), ("free", 3)))
    tr.end("req 1", 2, tr.now())
    return tr


@pytest.mark.parametrize("capacity", [3, 64])     # wrapped and not
def test_trace_copy_gives_the_reference_output(capacity, tmp_path):
    ours, ref = _traced(trace, capacity), _traced(ref_trace, capacity)
    assert len(ours) == len(ref) and ours.dropped == ref.dropped
    assert ours.events() == ref.events()
    assert ours.to_chrome({"x": 1}) == ref.to_chrome({"x": 1})
    ours.save(tmp_path / "a.json", {"x": 1})
    ref.save(tmp_path / "b.json", {"x": 1})
    assert (tmp_path / "a.json").read_text() \
        == (tmp_path / "b.json").read_text()


# ---------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def models():
    jm, jp, tree = lively_params("float32")
    tm = from_jax_params(tree, reduced_config(ARCH).replace(
        compute_dtype="float32"), "cpu")
    return jm, jp, tm


def _run(engine, request_cls):
    prompts, late = _prompts()
    first = engine.run([request_cls(rid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(prompts)])
    second = engine.run([request_cls(rid=5, prompt=late, max_new_tokens=8)])
    return [r.generated for r in first + second]


def _paths(d: dict, prefix="") -> set:
    """Every key path of a nested summary, the ``obs`` registry's names
    included; a histogram's occupied buckets, which depend on the times,
    are one path."""
    out = set()
    for k, v in d.items():
        out.add(prefix + str(k))
        if isinstance(v, dict) and k != "buckets":
            out |= _paths(v, f"{prefix}{k}.")
    return out


def _excluded(path: str) -> bool:
    return any(path == k or path.startswith(k + ".")
               for k in NOT_PORTED_STATS)


def _plans(kw: dict):
    """The JAX oracle's and the port's auto plans for reduced qwen3 at the
    engines' geometry (the engines' own buckets and chunk still win)."""
    from repro.configs import reduced_config as ref_reduced
    from repro.serve import placement as ref_placement
    from repro_torch.serve.placement import ExecutionOracle
    geo = dict(slots=kw["slots"], max_len=kw["max_len"])
    return (ref_placement.ExecutionOracle(ref_reduced(ARCH), **geo).resolve(),
            ExecutionOracle(reduced_config(ARCH), backend="cpu",
                            **geo).resolve())


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_summary_has_the_reference_schema(models, paged):
    """On the same trace the port's summary holds the JAX engine's key
    paths, the ``obs`` section's names and every observed program of the
    ``programs`` section included, but for the named exclusions; counters
    and gauges agree; ``kv`` only with a pool."""
    _check_schema(models, paged, "fixed")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_summary_has_the_reference_schema_under_auto_policy(models, paged):
    """The same under the oracle's plans (``--policy auto``), whose
    clusters add ``placement.drift.clusters``, the per-cluster rollup of
    the programs' phase totals."""
    _check_schema(models, paged, "auto")


def _check_schema(models, paged, policy):
    jm, jp, tm = models
    kw = dict(KW) if paged else {k: v for k, v in KW.items()
                                 if k != "kv_block_size"}
    jax_kw, port_kw = {}, {}
    if policy == "auto":
        jax_plan, plan = _plans(kw)
        jax_kw, port_kw = dict(policy=jax_plan), dict(policy=plan)
    jax_engine = JaxEngine(jm, jp, **kw, **jax_kw)
    engine = ServeEngine(tm, **kw, **port_kw)
    assert _run(engine, Request) == _run(jax_engine, JaxRequest)
    got, want = engine.stats.summary(), jax_engine.stats.summary()
    assert _paths(got) - PORT_ONLY == {p for p in _paths(want)
                                       if not _excluded(p)}
    assert ("kv" in got) == paged
    assert ("clusters" in got["placement"]["drift"]) == (policy == "auto")
    assert {"programs.programs.decode", "programs.chip.peak_flops"} \
        <= _paths(got)
    assert set(NOT_PORTED_STATS) == set()
    assert "handoff" not in NOT_PORTED_STATS
    for key in ("requests_completed", "tokens_generated", "prefills",
                "prefill_calls", "prefill_chunks", "prefill_prompt_tokens",
                "prefill_tokens_computed", "prefill_padding_overhead",
                "bucket_counts", "prefill_batch_counts", "slot_occupancy",
                "decode_steps"):
        assert got[key] == want[key], key
    if paged:
        assert got["kv"] == want["kv"]
    g, w = got["obs"], want["obs"]
    assert g["counters"] == w["counters"] and g["gauges"] == w["gauges"]
    for name in ("tokens_per_tick",):
        assert g["histograms"][name] == w["histograms"][name]
    for name in ("ttft_s", "decode_tick_s", "decode_tbt_s"):
        assert g["histograms"][name]["count"] \
            == w["histograms"][name]["count"] > 0
    # served without warmup: each program counts the first time it is met,
    # as the JAX engine's jit caches count it
    for key in ("prefill_compiles", "decode_compiles"):
        assert got[key] == want[key] > 0, key


def test_ttft_p50_is_the_reference_statistic():
    """The same recorded TTFTs give the reference's mean, p50 (the log2
    histogram's interpolated median, not the exact one) and max."""
    ours, ref = EngineStats(), JaxStats()
    for v in (0.012, 0.013, 0.4, 0.0105, 0.75, 0.0131, 2.0):
        ours.record_ttft(v)
        ref.record_ttft(v)
    got, want = ours.summary()["ttft_ms"], ref.summary()["ttft_ms"]
    assert got == want
    assert got["p50"] != 1e3 * 0.0131              # not the exact median
    assert EngineStats().summary()["ttft_ms"] == JaxStats().summary()[
        "ttft_ms"] == {"mean": 0.0, "p50": 0.0, "max": 0.0}


def test_reset_stats_clears_as_the_reference(models):
    jm, jp, tm = models
    jax_engine, engine = JaxEngine(jm, jp, **KW), ServeEngine(tm, **KW)
    _run(jax_engine, JaxRequest)
    _run(engine, Request)
    jax_engine.reset_stats()
    engine.reset_stats()
    got, want = engine.stats.summary(), jax_engine.stats.summary()
    assert got["requests_completed"] == got["decode_steps"] == 0
    assert got["ttft_ms"] == want["ttft_ms"]
    assert got["kv"] == want["kv"]
    assert got["obs"] == want["obs"]
    assert got["placement"]["measured"] == want["placement"]["measured"]
    # the pool's cached prefixes survive a reset, as the reference's
    assert got["kv"]["blocks_cached"] > 0


def _events(tracer):
    """The retained events without their stamps, in emission order, with
    the args that depend on the clock dropped."""
    raw = tracer._buf[:len(tracer)]
    return [(ph, name, tid, tuple((k, v) for k, v in args
                                  if k != "queue_wait_s"))
            for ph, name, tid, _, _, args in raw]


def test_trace_has_the_reference_events_and_tracks(models, tmp_path):
    """The port's engine emits the JAX engine's events (names, phases,
    tracks, args) in the same order on the same trace; its Chrome trace
    names the same tracks; a disabled tracer serves the same tokens and
    records nothing."""
    from repro.obs import Tracer as JaxTracer
    from repro_torch.obs import Tracer
    jm, jp, tm = models
    jax_engine = JaxEngine(jm, jp, **KW, tracer=JaxTracer())
    engine = ServeEngine(tm, **KW)
    want_tokens = _run(jax_engine, JaxRequest)
    assert _run(engine, Request) == want_tokens
    got, want = _events(engine.tracer), _events(jax_engine.tracer)
    assert got == want
    names = {e[1] for e in got}
    assert {"submit", "prefill", "prefill_chunk", "decode", "cow_copy",
            "kv_copy", "req 0", "queue_depth", "slots", "kv_blocks",
            "device_memory_bytes"} <= names
    engine.save_trace(tmp_path / "port.json")
    jax_engine.save_trace(tmp_path / "jax.json")
    doc = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    meta = lambda d: [e for e in d["traceEvents"]  # noqa: E731
                      if e["ph"] == "M"]
    assert meta(doc) == meta(ref)
    assert set(doc["otherData"]) == set(ref["otherData"])
    assert doc["otherData"]["programs"] \
        == engine.stats.summary()["programs"]
    assert doc["otherData"]["obs"] == engine.stats.summary()["obs"]
    ts = [e["ts"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts) and len(ts) == len(engine.tracer)

    quiet = ServeEngine(tm, **KW, tracer=Tracer(enabled=False))
    assert _run(quiet, Request) == want_tokens
    assert len(quiet.tracer) == 0
    quiet.warmup()
    assert len(quiet.tracer) == 0


def test_every_stamp_comes_from_the_tracer_clock(models):
    """With a clock that counts its calls, every time the engine reports
    is a difference of its stamps: whole numbers of ticks."""
    from repro_torch.obs import Tracer
    _, _, tm = models
    calls = iter(range(1, 10 ** 6))
    engine = ServeEngine(tm, **KW, tracer=Tracer(clock=lambda: next(calls)))
    engine.warmup()
    _run(engine, Request)
    s = engine.stats
    for v in (s.prefill_time_s, s.decode_time_s, s.wall_time_s, s.ttft_sum,
              s.ttft_max):
        assert v > 0 and v == int(v)
    spans = [e for e in engine.tracer.events() if e[0] == "X"]
    assert {e[1] for e in spans} >= {"warmup", "prefill", "decode"}
    assert all(e[4] == int(e[4]) for e in spans)
    assert math.isclose(s.summary()["ttft_ms"]["max"], 1e3 * s.ttft_max)


# ---------------------------------------------------------------------- CLI
def test_cli_writes_the_trace_and_the_metrics(tmp_path, capsys):
    from repro_torch.launch.serve import main
    paths = {o: tmp_path / f"out.{o}" for o in ("trace", "json", "prom")}
    s = main(["--reduced", "--device", "cpu", "--max-len", "64",
              "--kv-block-size", "8", "--requests", "3",
              "--trace", str(paths["trace"]),
              "--metrics-json", str(paths["json"]),
              "--metrics-prom", str(paths["prom"])])
    out = capsys.readouterr().out
    assert "trace written" in out and "Prometheus metrics written" in out
    doc = json.loads(paths["trace"].read_text())
    assert {e["name"] for e in doc["traceEvents"]} >= {
        "submit", "prefill", "decode", "req 0", "thread_name"}
    assert json.loads(paths["json"].read_text()) == json.loads(
        json.dumps(s))
    prom = paths["prom"].read_text()
    assert "# TYPE repro_serve_ttft_s histogram" in prom
    assert "repro_serve_prefill_waste_tokens_total" in prom
    assert f'repro_serve_ttft_s_count {s["requests_completed"]}' in prom
