"""The serving engine's program table (``serve/graphs.py``) against the JAX
engine's jit caches, on the CPU, where every entry is the eager call:
reduced qwen3-0.6b paged with the prefix cache and chunks, and reduced
recurrentgemma-2b dense, float32, the JAX weights bridged.  After
``warmup()`` the port's ``prefill_compiles`` and ``decode_compiles`` are
the JAX engine's; serving a trace of the reference bench's baseline form
leaves them as they were and gives the JAX engine's greedy tokens; an
engine served cold counts each program the first time it meets it, as the
JAX engine's jit caches do; and a 1 + 1 disaggregated pair compiles
nothing after its warmup.  The card's side — graphs against the eager
route bit for bit, launches counted by replay — is in
``tests/test_torch_gpu.py``."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.serve.disagg import DisaggEngine  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.graphs import EagerProgram  # noqa: E402

from test_torch_disagg import family  # noqa: E402

#: (arch, gain, engine knobs): qwen3 paged, its prompts past the one
#: 16-token bucket chunked, prefills batched up to 4 rows; recurrentgemma
#: dense with one-row prefills (at gain 1 its greedy tokens repeat).  One
#: bucket keeps the JAX engines' compiles few
CASES = {
    "qwen3-paged": ("qwen3-0.6b", 3.0,
                    dict(slots=4, max_len=128, buckets=(16,),
                         prefill_chunk=32, max_prefill_batch=4,
                         max_prefill_per_step=4, kv_block_size=8)),
    "recurrentgemma-dense": ("recurrentgemma-2b", 2.0,
                             dict(slots=2, max_len=64, buckets=(16,),
                                  max_prefill_batch=1)),
}
#: the case whose engines serve the cold trace before their warmup
COLD_CASE = "qwen3-paged"
#: the reference bench's baseline trace: its short lengths, jittered
#: within the bucket, seed 0, 8 new tokens (built here, as
#: ``benchmarks/serve_bench.py::make_trace`` builds it)
LENGTHS = (5, 14, 20, 30, 40, 60)


def baseline_trace(request_cls, vocab: int = 512, n: int = 6):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        ln = max(1, LENGTHS[i % len(LENGTHS)] + int(rng.randint(-2, 3)))
        out.append(request_cls(rid=i, prompt=rng.randint(1, vocab,
                                                         ln).tolist(),
                               max_new_tokens=8))
    return out


def compiles(stats) -> tuple[int, int]:
    return stats.prefill_compiles, stats.decode_compiles


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The small engines on one thread, restored after: beside the suite's
    other workers a thread pool an op only contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_FAMILIES: dict = {}


def models(case: str):
    """(JAX model, JAX params, port model) of ``case``, built once."""
    if case not in _FAMILIES:
        arch, gain, _ = CASES[case]
        _FAMILIES[case] = family(arch, gain=gain)
    return _FAMILIES[case]


def cold_trace(engines) -> tuple[list, list, list]:
    """Requests 0-3 of a cold trace through each of the cold ``engines``
    (port, JAX), then request 4: request 0 decodes in slot 0 while the next
    three prompts are admitted together into a 4-row prefill, whose
    padding row names the one slot outside the group, slot 0, mid-decode;
    the 40-token prompt chunks.  Returns each engine's tokens, compile
    counts and prefill batch sizes."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 512, n).tolist() for n in (9, 5, 7, 11, 40)]
    tokens, counts, batches = [], [], []
    for eng, cls in zip(engines, (Request, JaxRequest)):
        assert compiles(eng.stats) == (0, 0)
        reqs = [cls(rid=i, prompt=p, max_new_tokens=10)
                for i, p in enumerate(prompts)]
        eng.submit(reqs[0])
        eng.step()
        eng.step()                     # request 0 decodes in slot 0
        eng.run(reqs[1:4], on_truncate="raise")
        batches.append(dict(eng.stats.batch_counts))
        eng.run(reqs[4:], on_truncate="raise")      # 40 tokens: chunks
        tokens.append([r.generated for r in reqs])
        counts.append(compiles(eng.stats))
    return tokens, counts, batches


@pytest.fixture(scope="module")
def cold_served():
    """The cold case's engines (port, JAX) built and served
    ``cold_trace`` before any warmup, and what that returned."""
    _, _, kw = CASES[COLD_CASE]
    jm, jp, tm = models(COLD_CASE)
    engines = ServeEngine(tm, **kw), JaxEngine(jm, jp, **kw)
    return engines, cold_trace(engines)


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    """Both engines of a case (the cold case's from ``cold_served``),
    warmed up, their counts after warmup, then the trace served: a
    namespace of the case, the port and JAX engines, ``warm`` (counts
    after warmup: port, JAX), ``tokens`` (port, JAX) and the case's
    models."""
    _, _, kw = CASES[request.param]
    jm, jp, tm = models(request.param)
    if request.param == COLD_CASE:
        (engine, jax_engine), _ = request.getfixturevalue("cold_served")
    else:
        engine, jax_engine = ServeEngine(tm, **kw), JaxEngine(jm, jp, **kw)
    warm = []
    for eng in (engine, jax_engine):
        eng.warmup()
        warm.append(compiles(eng.stats))
    tokens = [[r.generated for r in eng.run(baseline_trace(cls),
                                            on_truncate="raise")]
              for eng, cls in ((engine, Request), (jax_engine, JaxRequest))]
    return SimpleNamespace(case=request.param, engine=engine,
                           jax_engine=jax_engine, warm=warm, tokens=tokens,
                           models=(jm, jp, tm))


def test_warmup_counts_the_jax_engines_programs(served):
    engine, (port, ref) = served.engine, served.warm
    assert port == ref and port[0] > 0 and port[1] == 1
    # one entry a program of the warmed inventory, each an eager call here
    names = {name for name, _ in engine._table}
    assert names == set(engine.programs._entries)
    assert len(engine._table) == sum(port)
    assert all(isinstance(e, EagerProgram) for e in engine._table.values())
    assert engine.graph_report() == {"graphs": 0, "capture_s": 0,
                                     "pool_bytes": None}


def test_serving_after_warmup_compiles_nothing(served):
    engine, jax_engine, (port, _) = served.engine, served.jax_engine, \
        served.warm
    assert compiles(engine.stats) == compiles(jax_engine.stats) == port
    s = engine.stats.summary()
    assert (s["prefill_compiles"], s["decode_compiles"]) == port
    assert s["prefill_chunks"] >= 1
    engine.reset_stats()
    assert compiles(engine.stats) == port         # the table outlives stats


def test_greedy_tokens_are_the_jax_engines(served):
    got, want = served.tokens
    assert got == want
    assert len({t for g in got for t in g}) > len(got)     # tokens vary


def test_warmup_zeroes_the_states_in_place(served):
    """The tensors the programs hold stay the engine's: a second warmup
    zeroes them where they are."""
    engine = served.engine
    before = [a for st in engine.states
              for a in (st.kv if st.kv is not None else st.rec.values())]
    assert any(bool(a.any()) for a in before)
    engine.warmup()
    after = [a for st in engine.states
             for a in (st.kv if st.kv is not None else st.rec.values())]
    assert all(a is b for a, b in zip(before, after))
    assert not any(bool(a.any()) for a in after)


def test_the_pair_compiles_nothing_after_its_warmup(served):
    """The 1 + 1 disaggregated pair on one process: each role counts its
    half of the inventory (the prefill role its export, the decode role
    its import), and serving adds nothing."""
    tm = served.models[2]
    _, _, kw = CASES[served.case]
    kw = {k: v for k, v in kw.items() if k != "slots"}
    pair = DisaggEngine(tm, prefill_slots=1, decode_slots=1, **kw)
    pair.warmup()
    warm = pair.summary()
    pair.reset_stats()
    done = pair.run(baseline_trace(Request), on_truncate="raise")
    assert all(r.done for r in done)
    assert pair.recompiles_since(warm) == 0
    roles = warm["roles"]
    assert roles["prefill"]["prefill_compiles"] > 0 \
        and roles["prefill"]["decode_compiles"] == 0
    assert roles["decode"]["prefill_compiles"] == 0 \
        and roles["decode"]["decode_compiles"] == 2
    assert {n for n, _ in pair.prefill._table} >= {"export"}
    assert {n for n, _ in pair.decode._table} == {"decode", "import"}


def test_a_cold_engine_counts_what_it_meets_and_pads_quietly(cold_served):
    """Served without warmup (``cold_trace``), qwen3 paged, beside a cold
    JAX engine: each program counts when the trace first calls it, as the
    JAX engine's jit caches count it.  The 4-row prefill's padding row
    names slot 0, mid-decode: the splice's ``keep`` mask rewrites that
    slot with its own bits, so its request decodes on as the JAX engine's
    (whose padding rows splice into the group's first slot instead)."""
    _, (tokens, counts, batches) = cold_served
    assert batches[0] == batches[1] == {1: 1, 3: 1}
    assert tokens[0] == tokens[1]
    assert all(len(g) == 10 for g in tokens[0])
    assert counts[0] == counts[1] == (3, 1)      # two prefills, the chunk
