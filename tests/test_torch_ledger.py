"""The port's perf ledger (``repro_torch.obs.ledger``) against the
reference's ``repro.obs.ledger`` on the same inputs: records, the
report's record, reading (a malformed line too), the trend check and the
CLI's exit codes and output.  Both modules are stdlib only."""
import json
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.obs import ledger as ref  # noqa: E402
from repro_torch.obs import ledger  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SHA = "0123abcd"


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    """Both modules stamp ``time.time()``: one fixed value for both."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


def test_constants_are_the_reference_ones():
    for name in ("LEDGER_SCHEMA_VERSION", "TREND_METRICS", "DEFAULT_BAND",
                 "DEFAULT_WINDOW", "MIN_HISTORY"):
        assert getattr(ledger, name) == getattr(ref, name), name


RECORDS = {
    "minimal": dict(arch="qwen3-0.6b", tokens_per_s=812.5,
                    ttft_p50_ms=41.0),
    "full": dict(arch="falcon-mamba-7b", tokens_per_s=97,
                 ttft_p50_ms=12, prefix_hit_rate=0.25,
                 trace_overhead_frac=0.01, recompiles_after_warmup=0,
                 program_utilization={"decode": 0.5, "chunk": 0.125},
                 extra={"per_role_tokens_per_s": {"decode": 50.0}}),
    "recompiled": dict(arch="recurrentgemma-2b", tokens_per_s=1e3,
                       ttft_p50_ms=3.5, recompiles_after_warmup=2,
                       program_utilization={}),
}


@pytest.mark.parametrize("case", sorted(RECORDS))
def test_make_record_gives_the_reference_record(case):
    kw = RECORDS[case]
    assert ledger.make_record(**kw, sha=SHA) == ref.make_record(**kw,
                                                               sha=SHA)


def _report(recompiles=0, kv=True):
    rep = {"arch": "qwen3-0.6b",
           "measure": {"tokens_per_s": 431.0, "ttft_ms": {"p50": 17.5},
                       "programs": {"programs": {
                           "decode": {"utilization": 0.03},
                           "prefill[1x16]": {"utilization": 0.2}}}},
           "trace_overhead": {"overhead_frac": 0.02},
           "recompiles_after_warmup": recompiles}
    if kv:
        rep["paged_prefix"] = {"kv": {"prefix_hit_rate": 0.5}}
    return rep


@pytest.mark.parametrize("recompiles,kv", [(0, True), (3, False)])
def test_record_from_report_gives_the_reference_record(recompiles, kv):
    rep = _report(recompiles, kv)
    extra = {"roles": 2}
    assert ledger.record_from_report(rep, sha=SHA, extra=extra) \
        == ref.record_from_report(rep, sha=SHA, extra=extra)


def _history(values):
    return [dict(ref.make_record(arch="a", tokens_per_s=t, ttft_p50_ms=m,
                                 sha=SHA)) for t, m in values]


TRENDS = {
    "empty": [],
    "one run": [(100.0, 10.0)],
    "steady": [(100.0, 10.0), (98.0, 11.0), (101.0, 10.5)],
    "throughput halves": [(100.0, 10.0), (104.0, 10.0), (40.0, 10.0)],
    "latency doubles": [(100.0, 10.0), (100.0, 10.0), (100.0, 31.0)],
    "long history": [(100.0 + i, 10.0) for i in range(12)] + [(55.0, 9.0)],
}


@pytest.mark.parametrize("case", sorted(TRENDS))
@pytest.mark.parametrize("band,window", [(0.5, 8), (0.05, 3)])
def test_trend_check_gives_the_reference_verdict(case, band, window):
    records = _history(TRENDS[case])
    assert ledger.trend_check(records, band=band, window=window) \
        == ref.trend_check(records, band=band, window=window)


def test_trend_check_refuses_a_band_as_the_reference():
    for mod in (ledger, ref):
        with pytest.raises(ValueError, match="band must be positive"):
            mod.trend_check([], band=0.0)


def test_append_then_read_is_the_reference_file(tmp_path):
    recs = _history(TRENDS["steady"])
    for mod, name in ((ledger, "port.jsonl"), (ref, "ref.jsonl")):
        for r in recs:
            mod.append_record(tmp_path / "sub" / name, r)
    port, want = (tmp_path / "sub" / name
                  for name in ("port.jsonl", "ref.jsonl"))
    assert port.read_text() == want.read_text()
    assert ledger.read_ledger(port) == ref.read_ledger(want) == recs
    assert ledger.read_ledger(tmp_path / "none.jsonl") == []


def test_a_malformed_line_raises_as_the_reference(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text(json.dumps({"tokens_per_s": 1.0}) + "\n\n{oops\n")
    errors = []
    for mod in (ledger, ref):
        with pytest.raises(ValueError, match="malformed ledger line") as e:
            mod.read_ledger(path)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and f"{path}:3:" in errors[0]


@pytest.mark.parametrize("case,rc", [("steady", 0), ("throughput halves", 1),
                                     ("latency doubles", 1)])
def test_main_exits_where_the_reference_does(tmp_path, capsys, case, rc):
    path = tmp_path / "perf_ledger_torch.jsonl"
    for r in _history(TRENDS[case]):
        ledger.append_record(path, r)
    outs = []
    for mod in (ledger, ref):
        assert mod.main([str(path), "--band", "0.5"]) == rc
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


def test_the_jax_history_is_left_alone(tmp_path):
    """The port writes only the file it is given; the JAX package's
    ``results/perf_ledger.jsonl`` keeps its bytes."""
    jax_file = ROOT / "results" / "perf_ledger.jsonl"
    before = jax_file.read_bytes() if jax_file.exists() else None
    path = tmp_path / "perf_ledger_torch.jsonl"
    ledger.append_record(path, ledger.make_record(
        arch="qwen3-0.6b", tokens_per_s=1.0, ttft_p50_ms=1.0, sha=SHA))
    ledger.main([str(path)])
    assert (jax_file.read_bytes() if jax_file.exists() else None) == before
    assert "perf_ledger_torch.jsonl" in ledger.__doc__
