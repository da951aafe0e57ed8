"""The port's ServeEngine against the JAX ServeEngine on one seeded trace:
paged KV, the prefix cache on (a mid-block hit with a copy-on-write
clone), one prompt long enough for the chunked path, float32.  Greedy
tokens must be identical and the engines' counters equal."""
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
    with pytest.raises(TypeError):
        ServeEngine(tm, slots=2, max_len=64)             # no kv_block_size
    for kw in ({"mesh": None}, {"role": "decode"}, {"policy": None},
               {"tracer": None}):
        with pytest.raises(TypeError):
            ServeEngine(tm, kv_block_size=8, max_len=64, **kw)
    with pytest.raises(ValueError, match="kv_blocks"):
        ServeEngine(tm, kv_block_size=8, max_len=64, kv_blocks=4)
