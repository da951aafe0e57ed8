"""The port's ServeEngine against the JAX ServeEngine on one seeded trace:
paged KV, the prefix cache on (a mid-block hit with a copy-on-write
clone), one prompt long enough for the chunked path, float32.  Greedy
tokens must be identical and the engines' counters equal."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

from test_torch_model import ARCH, lively_params  # noqa: E402

KW = dict(slots=3, max_len=128, buckets=(16, 32), prefill_chunk=32,
          kv_block_size=8)


def _prompts():
    rng = np.random.RandomState(1)
    shared = rng.randint(1, 512, 20).tolist()
    prompts = [rng.randint(1, 512, n).tolist() for n in (5, 9, 14, 70)]
    prompts.append(shared + rng.randint(1, 512, 6).tolist())
    late = shared + rng.randint(1, 512, 9).tolist()
    return prompts, late


def _serve(engine, request_cls, **samp):
    prompts, late = _prompts()
    first = engine.run([request_cls(rid=i, prompt=p, max_new_tokens=8,
                                    **samp)
                        for i, p in enumerate(prompts)])
    # the shared prefix is published once request 4 has prefilled
    second = engine.run([request_cls(rid=5, prompt=late, max_new_tokens=8,
                                     **samp)])
    return [r.generated for r in first + second]


@pytest.fixture(scope="module")
def engines():
    jm, jp, tree = lively_params("float32")
    tm = from_jax_params(tree, reduced_config(ARCH).replace(
        compute_dtype="float32"), "cpu")
    return JaxEngine(jm, jp, **KW), ServeEngine(tm, **KW), tm


def test_engine_matches_jax_engine(engines):
    jax_engine, engine, _ = engines
    want = _serve(jax_engine, JaxRequest)
    got = _serve(engine, Request)
    assert got == want
    assert len({tuple(g) for g in got}) == len(got)    # tokens vary
    js, ts = jax_engine.stats, engine.stats
    assert ts.prefill_chunks == js.prefill_chunks >= 4
    assert ts.prefix_hits == js.prefix_hits == 1
    assert ts.blocks_copied == js.blocks_copied == 1
    assert ts.kv_blocks_peak == js.kv_blocks_peak
    assert ts.decode_stalls == js.decode_stalls == 0
    assert ts.prefill_calls == js.prefill_calls
    s = engine.stats.summary()
    assert s["requests_completed"] == 6 and s["nonfinite_logits"] == 0
    assert s["kv"]["blocks_in_use"] == 0


def test_sampled_requests_reproduce_and_warmup_resets(engines):
    _, _, tm = engines
    samp = dict(temperature=0.9, top_k=40, top_p=0.9, seed=11)
    a = ServeEngine(tm, **KW)
    a.warmup()
    b = ServeEngine(tm, **KW)
    ga, gb = _serve(a, Request, **samp), _serve(b, Request, **samp)
    assert ga == gb
    greedy = _serve(ServeEngine(tm, **KW), Request)
    assert ga != greedy


def test_engine_refuses_what_this_slice_leaves_out(engines):
    _, _, tm = engines
    # the placement policy (tests/test_torch_placement.py), the tracer
    # (tests/test_torch_obs.py), the roles (tests/test_torch_disagg.py) and
    # the mesh (tests/test_torch_distributed*.py) are in; a weight layout
    # it does not know is refused
    with pytest.raises(ValueError, match="param_strategy"):
        ServeEngine(tm, kv_block_size=8, max_len=64, param_strategy="fsdp")
    with pytest.raises(ValueError, match="kv_blocks"):
        ServeEngine(tm, kv_block_size=8, max_len=64, kv_blocks=4)


def test_qwen3_dense_and_paged_engines_agree(engines):
    """The dense-KV engine (no ``kv_block_size``, warmed up first) serves
    the trace with the same greedy tokens as the paged one."""
    _, _, tm = engines
    dense_kw = {k: v for k, v in KW.items() if k != "kv_block_size"}
    dense = ServeEngine(tm, **dense_kw)
    assert dense.kv is None
    dense.warmup()
    got = _serve(dense, Request)
    assert got == _serve(ServeEngine(tm, **KW), Request)
    s = dense.stats.summary()
    assert s["requests_completed"] == 6 and s["prefill_chunks"] >= 3
    assert "kv" not in s                 # the reference's: paged pools only


# ----------------------------------------------- recurrentgemma, dense KV
RG = "recurrentgemma-2b"
# 2 slots for 5 requests (slots are recycled mid-run); the 40-token prompt
# is longer than the largest bucket, so it runs as chunks of 16 across the
# window of 16; 24 new tokens carry every request's decode past the window
RG_KW = dict(slots=2, max_len=96, buckets=(16, 32), prefill_chunk=16)


def _serve_rg(engine, request_cls):
    rng = np.random.RandomState(3)
    reqs = [request_cls(rid=i, prompt=rng.randint(1, 512, n).tolist(),
                        max_new_tokens=24)
            for i, n in enumerate((5, 40, 12, 9, 20))]
    engine.run(reqs)
    return [r.generated for r in reqs]


@pytest.fixture(scope="module")
def rg_models():
    from test_torch_model import RG_GAIN
    jm, jp, tree = lively_params("float32", arch=RG, gain=RG_GAIN)
    tm = from_jax_params(tree, reduced_config(RG).replace(
        compute_dtype="float32"), "cpu")
    return jm, jp, tm


def test_recurrentgemma_engine_matches_jax_engine(rg_models):
    jm, jp, tm = rg_models
    jax_engine = JaxEngine(jm, jp, **RG_KW)
    want = _serve_rg(jax_engine, JaxRequest)
    engine = ServeEngine(tm, **RG_KW)
    got = _serve_rg(engine, Request)
    assert got == want
    assert len({tuple(g) for g in got}) == len(got)    # tokens vary
    js, ts = jax_engine.stats, engine.stats
    assert (ts.prefill_calls, ts.prefill_chunks, ts.decode_steps) \
        == (js.prefill_calls, js.prefill_chunks, js.decode_steps)
    s = engine.stats.summary()
    assert s["requests_completed"] == 5 and s["nonfinite_logits"] == 0
    assert s["prefill_chunks"] == 3 and s["prefills_chunked"] == 1
    assert "kv" not in s


def test_recurrentgemma_chunked_prefill_equals_one_shot(rg_models):
    """Inside the port: with a 64-token bucket the 40-token prompt prefills
    in one shot; the greedy tokens are those of the chunked run.  A paged
    engine for this arch (no full-attention layer, so nothing is paged and
    the prefix cache stays off) serves the same tokens."""
    _, _, tm = rg_models
    chunked = ServeEngine(tm, **RG_KW)
    chunked.warmup()
    want = _serve_rg(chunked, Request)
    one_shot = ServeEngine(tm, **{**RG_KW, "buckets": (16, 32, 64)})
    assert _serve_rg(one_shot, Request) == want
    assert one_shot.stats.prefill_chunks == 0
    paged = ServeEngine(tm, kv_block_size=8, **RG_KW)
    assert not paged.kv.prefix_enabled
    assert _serve_rg(paged, Request) == want


# ---------------------------------------------------------------------- CLI
def _options(parser):
    return {o for a in parser._actions for o in a.option_strings
            if o.startswith("--") and o != "--help"}


def test_cli_serves_recurrentgemma_with_dense_kv(capsys):
    from repro_torch.launch.serve import main
    s = main(["--arch", RG, "--reduced", "--device", "cpu",
              "--kv-block-size", "0", "--max-len", "64", "--requests", "3"])
    assert s["requests_completed"] == 3 and s["nonfinite_logits"] == 0
    assert "kv" not in s
    assert '"requests_completed": 3' in capsys.readouterr().out


def test_cli_fails_loudly_on_every_option_it_lacks(capsys):
    """Every option of the JAX package's CLI is served by the port's: none
    is left to refuse by name (``NOT_PORTED`` is empty since ``--roles``),
    and the port's parser hides none.  ``--roles`` takes the JAX CLI's
    spelling and default."""
    from repro.launch.serve import build_parser as jax_parser
    from repro_torch.launch.serve import NOT_PORTED, build_parser
    port = build_parser()
    refused = {o for a in port._actions for o in a.option_strings
               if a.help == "==SUPPRESS=="}
    assert refused == set(NOT_PORTED) == set()
    assert _options(jax_parser()) <= _options(port)
    assert port.parse_args([]).roles == jax_parser().parse_args([]).roles
    assert port.parse_args(["--roles", "prefill=1,decode=2"]).roles \
        == "prefill=1,decode=2"
    assert capsys.readouterr().err == ""


def test_cli_profile_dir_writes_a_trace_and_a_summary(tmp_path, capsys):
    """On the CPU the profile holds the run's wall time and no card
    numbers: nothing ran on a card."""
    from repro_torch.launch.serve import main
    s = main(["--reduced", "--device", "cpu", "--max-len", "64",
              "--kv-block-size", "8", "--requests", "2",
              "--profile-dir", str(tmp_path)])
    capsys.readouterr()
    prof = s["profile"]
    assert prof["device"] == "cpu" and prof["wall_ms"] > 0
    assert prof["device_busy_ms"] is None and prof["kernel_launches"] == 0
    assert prof["warmed_up"] is False
    assert json.loads((tmp_path / "summary.json").read_text())[
        "warmed_up"] is False
    for name in ("trace.json", "ops.txt", "summary.json"):
        assert (tmp_path / name).stat().st_size > 0
