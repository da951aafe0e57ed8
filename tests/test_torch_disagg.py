"""The port's disaggregated prefill/decode serving against the JAX package's
meshless ``DisaggEngine``, on reduced qwen3-0.6b in float32: the pair
serves the interleaved engine's tokens (paged with the prefix cache, and
dense), hands off one suitcase a request, drains the decode pool, stalls as
the JAX pair stalls, and reports the JAX pair's summary keys and trace
events; the suitcase moves a slot's blocks and row bit for bit and holds
no view of the prefill pool.  The recurrent families are in
``tests/test_torch_disagg_recurrent.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.serve.disagg import DisaggEngine as JaxDisagg  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.attention import PagedKVCache  # noqa: E402
from repro_torch.serve.disagg import DisaggEngine  # noqa: E402
from repro_torch.serve.engine import (NOT_PORTED_STATS,  # noqa: E402
                                      Request, ServeEngine)

from test_torch_model import lively_params  # noqa: E402
from test_torch_obs import PORT_ONLY, _events, _paths  # noqa: E402

ARCH = "qwen3-0.6b"


def family(arch: str, gain: float = 3.0):
    """(JAX model, JAX params, port model) at ``num_layers = max(2,
    len(block_pattern))``, float32, the JAX weights bridged."""
    cfg = reduced_config(arch)
    layers = max(2, len(cfg.block_pattern))
    jm, jp, tree = lively_params("float32", arch=arch, gain=gain,
                                 num_layers=layers)
    tm = from_jax_params(tree, cfg.replace(compute_dtype="float32",
                                           num_layers=layers), "cpu")
    return jm, jp, tm


def identity_trace(request_cls, vocab: int):
    """``tests/test_distributed.py::test_disagg_engine_token_identity``'s
    trace: the 40-token prompt exceeds the 16-token bucket and chunks."""
    rng = np.random.RandomState(7)
    return [request_cls(rid=i, prompt=rng.randint(1, vocab, n).tolist(),
                        max_new_tokens=4)
            for i, n in enumerate([3, 7, 12, 15, 9, 40])]


#: that test's geometry: 8 interleaved slots, a pair of 4 + 8
IDENTITY_KW = dict(max_len=64, buckets=(16,), max_prefill_per_step=4,
                   max_prefill_batch=2)


def serve_four_ways(models, trace, *, slots, prefill_slots, decode_slots,
                    **kw):
    """The trace through the JAX interleaved engine and pair and the
    port's, each on fresh requests; returns (port pair, JAX pair, port
    interleaved, JAX interleaved, their tokens), asserting the four token
    lists equal and no recompile after the pairs' warmup."""
    jm, jp, tm = models
    jax_ref = JaxEngine(jm, jp, slots=slots, **kw)
    ref = ServeEngine(tm, slots=slots, **kw)
    jax_dis = JaxDisagg(jm, jp, prefill_slots=prefill_slots,
                        decode_slots=decode_slots, **kw)
    dis = DisaggEngine(tm, prefill_slots=prefill_slots,
                       decode_slots=decode_slots, **kw)
    tokens = []
    for eng, cls in ((dis, Request), (jax_dis, JaxRequest),
                     (ref, Request), (jax_ref, JaxRequest)):
        pair = isinstance(eng, (DisaggEngine, JaxDisagg))
        if pair:
            eng.warmup()
            w = eng.summary()
            eng.reset_stats()
        done = eng.run(trace(cls), on_truncate="raise")
        if pair:
            assert eng.recompiles_since(w) == 0
        tokens.append([r.generated for r in done])
    assert tokens[0] == tokens[1] == tokens[2] == tokens[3]
    assert len({tuple(g) for g in tokens[0]}) > 1       # tokens vary
    return dis, jax_dis, ref, jax_ref, tokens[0]


def check_pair(dis, jax_dis, n_requests: int) -> dict:
    """One handoff a request, none pending, the JAX pair's stall count;
    returns the port pair's summary."""
    s, js = dis.summary(), jax_dis.summary()
    assert s["handoffs"] == js["handoffs"] == n_requests
    assert s["handoffs_pending"] == js["handoffs_pending"] == 0
    assert s["handoff_stalls"] == js["handoff_stalls"]
    for role in ("prefill", "decode"):
        got, want = s["roles"][role], js["roles"][role]
        for key in ("requests_completed", "tokens_generated", "prefills",
                    "prefill_calls", "prefill_chunks", "decode_steps",
                    "prefill_tokens_computed", "bucket_counts"):
            assert got[key] == want[key], (role, key)
        assert got["handoff"]["handoffs"] == want["handoff"]["handoffs"]
    assert s["roles"]["decode"]["nonfinite_logits"] == 0
    return s


@pytest.fixture(scope="module")
def qwen3():
    return family(ARCH)


# ------------------------------------------------- (a) the identity gate
@pytest.mark.parametrize("kv_block_size", [8, None], ids=["paged", "dense"])
def test_disagg_engine_token_identity(qwen3, kv_block_size):
    dis, jax_dis, *_ = serve_four_ways(
        qwen3, lambda cls: identity_trace(cls, 512), slots=8,
        prefill_slots=4, decode_slots=8, kv_block_size=kv_block_size,
        **IDENTITY_KW)
    s = check_pair(dis, jax_dis, 6)
    assert s["ticks"] == jax_dis.summary()["ticks"]
    assert s["roles"]["prefill"]["prefill_chunks"] >= 2
    assert ("kv" in s["roles"]["decode"]) == bool(kv_block_size)


# ----------------------------------- (b) the serve_bench gate's qwen3 case
def gate_trace(request_cls, vocab: int = 512, max_new: int = 6):
    """``benchmarks/serve_bench.py::disagg_identity_gate``'s trace: four
    prompts (70 tokens chunk) and a pair sharing a 20-token prefix."""
    rng = np.random.RandomState(23)
    shared = rng.randint(1, vocab, 20).tolist()
    reqs = [request_cls(rid=i, prompt=rng.randint(1, vocab, n).tolist(),
                        max_new_tokens=max_new)
            for i, n in enumerate([4, 11, 30, 70])]
    reqs += [request_cls(rid=10 + i, prompt=shared + rng.randint(
                 1, vocab, 3 + i).tolist(), max_new_tokens=max_new)
             for i in range(2)]
    return reqs


GATE_KW = dict(max_len=128, buckets=(16, 32), prefill_chunk=32,
               kv_block_size=16, kv_blocks=56)


def test_disagg_identity_gate_paged_prefix(qwen3):
    dis, jax_dis, ref, _, _ = serve_four_ways(
        qwen3, gate_trace, slots=4, prefill_slots=2, decode_slots=4,
        **GATE_KW)
    s = check_pair(dis, jax_dis, 6)
    pre_kv, ref_kv = s["roles"]["prefill"]["kv"], ref.stats.summary()["kv"]
    assert pre_kv["prefix_hit_rate"] == ref_kv["prefix_hit_rate"] > 0
    assert pre_kv["blocks_copied"] == ref_kv["blocks_copied"]
    assert pre_kv == jax_dis.summary()["roles"]["prefill"]["kv"]
    assert s["roles"]["decode"]["kv"]["blocks_in_use"] == 0


# ---------------------------------- (c) the paged prefix handoff, meshless
def prefix_trace(request_cls, vocab: int = 512):
    """``tests/test_distributed.py::test_disagg_paged_prefix_handoff``'s
    trace: five prompts on a 40-token (2.5-block) prefix, four others (90
    tokens chunk)."""
    rng = np.random.RandomState(13)
    shared = rng.randint(1, vocab, 40).tolist()
    out = [request_cls(rid=i, prompt=shared + rng.randint(
               1, vocab, 2 + i).tolist(), max_new_tokens=4)
           for i in range(5)]
    out += [request_cls(rid=100 + i, prompt=rng.randint(
                1, vocab, n).tolist(), max_new_tokens=4)
            for i, n in enumerate([4, 11, 30, 90])]
    return out


def test_disagg_paged_prefix_handoff(qwen3):
    dis, jax_dis, ref, _, _ = serve_four_ways(
        qwen3, prefix_trace, slots=8, prefill_slots=4, decode_slots=8,
        max_len=128, buckets=(16, 32), max_prefill_per_step=4,
        kv_block_size=16, kv_blocks=56)
    s = check_pair(dis, jax_dis, 9)
    pre_kv = s["roles"]["prefill"]["kv"]
    assert pre_kv["prefix_hit_rate"] \
        == ref.stats.summary()["kv"]["prefix_hit_rate"] \
        == jax_dis.summary()["roles"]["prefill"]["kv"]["prefix_hit_rate"] > 0
    assert s["roles"]["decode"]["kv"]["blocks_in_use"] == 0
    assert s["roles"]["decode"]["kv"]["prefix_queries"] == 0


# ------------------------------------------------------ (d) the suitcase
def _snapshot(engine) -> list:
    """Every tensor of the engine's states, cloned, layer by layer."""
    out = []
    for st in engine.states:
        parts = st.kv if st.kv is not None else tuple(st.rec.values())
        out.append([a.clone() for a in parts])
    return out


def _rows(st) -> list:
    """A layer's per-slot tensors (a paged layer: its lengths only)."""
    if isinstance(st.kv, PagedKVCache):
        return [st.kv.length]
    return list(st.kv) if st.kv is not None else list(st.rec.values())


def check_suitcase(model, *, kv_block_size=None, max_len=64):
    """A prefill role and a decode role with pools of different sizes: one
    prompt is prefilled and exported; the prefill pool is then overwritten
    (as a reused block would be), the suitcase stays as it was; adopted
    into decode slot 1 (slot 0 holds an earlier sequence), the decode
    engine's rows and blocks equal the exported ones bit for bit and no
    other row or block changes."""
    kv = dict(kv_block_size=kv_block_size)
    pre = ServeEngine(model, role="prefill", slots=2, max_len=max_len,
                      buckets=(16,), prefill_chunk=16,
                      kv_blocks=None if kv_block_size is None else 20, **kv)
    dec = ServeEngine(model, role="decode", slots=3, max_len=max_len,
                      prefix_cache=False,
                      kv_blocks=None if kv_block_size is None else 30, **kv)
    rng = np.random.RandomState(5)
    reqs = [Request(rid=i, prompt=rng.randint(1, 512, n).tolist(),
                    max_new_tokens=4) for i, n in enumerate((9, 27))]
    for req in reqs:
        pre.submit(req)
    while len(pre.ready) < 2:
        pre.step()
    first = pre.ready.popleft()
    assert dec.adopt(reqs[0], pre.export_slot(first), 9) == 0
    pre.release_handoff(first)
    slot = pre.ready.popleft()
    src_row = list(pre.kv.table[slot]) if pre.kv is not None else None
    exported = _snapshot(pre)
    suitcase = pre.export_slot(slot)
    kept = [[a.clone() for a in (st.kv if st.kv is not None
                                 else st.rec.values())] for st in suitcase]
    for st in pre.states:                     # the source changes under it
        for a in (st.kv if st.kv is not None else st.rec.values()):
            a.fill_(7)
    for st, want in zip(suitcase, kept):
        for a, b in zip(st.kv if st.kv is not None else st.rec.values(),
                        want):
            assert torch.equal(a, b)
    before = _snapshot(dec)
    if dec.kv is not None:
        table0, in_use0 = [list(r) for r in dec.kv.table], dec.kv.in_use
    assert dec.adopt(reqs[1], pre.stage_in(suitcase), 27) == 1
    assert dec.positions[1] == 27 and dec.requests[1] is reqs[1]
    for i, (st, old, src) in enumerate(zip(dec.states, before, exported)):
        if isinstance(st.kv, PagedKVCache):
            dst_row = dec.kv.table[1]
            owned = dec.kv.owned[1]
            assert owned == -(-27 // kv_block_size)
            assert table0[1] == [dec.kv.sentinel] * dec.kv.blocks_per_slot
            assert dec.kv.in_use == in_use0 + owned
            for now, was, pool in ((st.kv.k, old[0], src[0]),
                                   (st.kv.v, old[1], src[1])):
                moved = dst_row[:owned]
                assert torch.equal(now[moved], pool[src_row[:owned]])
                rest = [b for b in range(now.shape[0]) if b not in moved]
                assert torch.equal(now[rest], was[rest]), f"layer {i}"
            assert int(st.kv.length[1]) == 27
            others = [0, 2]
            assert torch.equal(st.kv.length[others], old[2][others])
        else:
            for now, was, srcr in zip(_rows(st), old, src):
                assert torch.equal(now[1], srcr[slot]), f"layer {i}"
                assert torch.equal(now[[0, 2]], was[[0, 2]]), f"layer {i}"
    return pre, dec


def test_suitcase_moves_blocks_bit_for_bit(qwen3):
    check_suitcase(qwen3[2], kv_block_size=8)


def test_suitcase_moves_a_dense_row_bit_for_bit(qwen3):
    check_suitcase(qwen3[2])


def test_import_drops_the_suitcase_tail_and_sentinel_rows(qwen3):
    """An all-sentinel destination row (the decode role's warmup) writes no
    block; a padded suitcase tail (clipped sentinel entries of the source
    row) lands nowhere."""
    tm = qwen3[2]
    dec = ServeEngine(tm, role="decode", slots=2, max_len=64,
                      kv_block_size=8, kv_blocks=9, prefix_cache=False)
    for st in dec.states:
        st.kv.k.normal_()
    before = _snapshot(dec)
    sent = [dec.kv.sentinel] * dec.kv.blocks_per_slot
    dec._import_slot(dec._export_slot(1, sent), 0, sent)
    for st, old in zip(dec.states, before):
        assert torch.equal(st.kv.k, old[0]) and torch.equal(st.kv.v, old[1])
    row = [3, 5] + [dec.kv.sentinel] * (dec.kv.blocks_per_slot - 2)
    suitcase = dec._export_slot(1, row)
    assert suitcase[0].kv.k.shape[0] == dec.kv.blocks_per_slot
    dec._import_slot(suitcase, 0, [0, 1] + row[2:])
    for st, old in zip(dec.states, before):
        assert torch.equal(st.kv.k[:2], old[0][[3, 5]])
        assert torch.equal(st.kv.k[2:], old[0][2:])


# ------------------------------------------------------ (e) backpressure
def test_backpressure_stalls_as_the_jax_pair(qwen3):
    """One decode slot over the smallest pool: suitcases queue, adoption
    stalls as often as the JAX pair's, and the tokens stay the interleaved
    engine's while the small prefill pool hands released blocks to new
    prompts (checked: a waiting suitcase's source block is remapped)."""
    kw = dict(max_len=64, buckets=(16, 32), prefill_chunk=16,
              kv_block_size=8)
    jm, jp, tm = qwen3
    dis = DisaggEngine(tm, prefill_slots=2, decode_slots=1, kv_blocks=8,
                       **kw)
    pre, reused = dis.prefill, []
    export = pre.export_slot

    def spying_export(slot):
        src = list(pre.kv.table[slot][:pre.kv.owned[slot]])
        out = export(slot)
        out.append(src)
        return out

    def step():
        DisaggEngine.step(dis)
        live = {b for s in range(pre.slots) for b in
                pre.kv.table[s][:pre.kv.owned[s]]}
        reused.extend(b for _, suit, _ in dis._pending for b in suit[-1]
                      if b in live)

    pre.export_slot = spying_export
    dis.step = step
    dec = dis.decode
    adopt = dec.adopt
    dec.adopt = lambda req, suit, n: adopt(req, suit[:-1], n)

    def trace(cls):
        rng = np.random.RandomState(11)
        return [cls(rid=i, prompt=rng.randint(1, 512, n).tolist(),
                    max_new_tokens=5)
                for i, n in enumerate((30, 22, 9, 40, 17, 25, 12))]

    got = [r.generated for r in dis.run(trace(Request), on_truncate="raise")]
    jax_dis = JaxDisagg(jm, jp, prefill_slots=2, decode_slots=1,
                        kv_blocks=8, **kw)
    want = [r.generated for r in jax_dis.run(trace(JaxRequest),
                                             on_truncate="raise")]
    # the interleaved engine at the decode role's slot count: every call
    # of the three engines has the same shape
    ref = [r.generated for r in ServeEngine(tm, slots=1, **kw).run(
        trace(Request), on_truncate="raise")]
    assert got == want == ref
    s = check_pair(dis, jax_dis, 7)
    assert s["handoff_stalls"] > 0 and reused
    assert s["roles"]["decode"]["kv"]["blocks_in_use"] == 0


def test_adopt_without_a_slot_or_blocks_touches_nothing(qwen3):
    """``adopt`` returns None, counts one stall and changes no table entry,
    block count, slot or state when the pool cannot cover the sequence or
    no slot is free."""
    dec = ServeEngine(qwen3[2], role="decode", slots=2, max_len=64,
                      kv_block_size=8, kv_blocks=10, prefix_cache=False)
    suitcase = dec._export_slot(0, [dec.kv.sentinel] * dec.kv.blocks_per_slot)
    rng = np.random.RandomState(2)
    reqs = [Request(rid=i, prompt=rng.randint(1, 512, 40).tolist(),
                    generated=[1]) for i in range(3)]
    assert dec.adopt(reqs[0], suitcase, 40) == 0
    assert dec.kv.extend(0, 56)                  # 7 of the 10 blocks held
    table, in_use = [list(r) for r in dec.kv.table], dec.kv.in_use
    states = _snapshot(dec)
    assert dec.adopt(reqs[1], suitcase, 40) is None       # 5 blocks: no
    assert dec.stats.handoff_stalls == 1 and dec.stats.handoffs == 1
    assert dec.kv.table == table and dec.kv.in_use == in_use
    assert dec.requests[1] is None
    for st, old in zip(dec.states, states):
        assert all(torch.equal(a, b) for a, b in zip(st.kv, old))
    assert dec.adopt(reqs[1], suitcase, 8) == 1
    assert dec.adopt(reqs[2], suitcase, 8) is None        # no slot
    assert dec.stats.handoff_stalls == 2 and dec.stats.handoffs == 2


# ------------------------------------------- (f) the summary and the trace
def _excluded_role(path: str) -> bool:
    for role in ("roles.prefill.", "roles.decode."):
        if path.startswith(role):
            rest = path[len(role):]
            return any(rest == k or rest.startswith(k + ".")
                       for k in NOT_PORTED_STATS)
    return False


def test_summary_and_trace_are_the_jax_pairs(qwen3, tmp_path):
    from repro.obs import Tracer as JaxTracer
    import json
    jm, jp, tm = qwen3
    jax_dis = JaxDisagg(jm, jp, prefill_slots=2, decode_slots=4,
                        tracer=JaxTracer(), **GATE_KW)
    dis = DisaggEngine(tm, prefill_slots=2, decode_slots=4, **GATE_KW)
    want = [r.generated for r in jax_dis.run(gate_trace(JaxRequest))]
    assert [r.generated for r in dis.run(gate_trace(Request))] == want
    got, ref = dis.summary(), jax_dis.summary()
    port_only = {f"roles.{r}.{k}" for r in ("prefill", "decode")
                 for k in PORT_ONLY}
    assert _paths(got) - port_only == {p for p in _paths(ref)
                                       if not _excluded_role(p)}
    assert "handoff" in got["roles"]["prefill"]
    assert _events(dis.tracer) == _events(jax_dis.tracer)
    names = {e[1] for e in _events(dis.tracer)}
    assert {"prefill_done", "handoff_export", "handoff",
            "prefill/queue_depth", "decode/slots"} <= names
    assert dis.decode.track_base == dis.prefill._trk_engine + 1
    dis.save_trace(tmp_path / "port.json")
    jax_dis.save_trace(tmp_path / "jax.json")
    doc = json.loads((tmp_path / "port.json").read_text())
    jdoc = json.loads((tmp_path / "jax.json").read_text())
    meta = lambda d: [e for e in d["traceEvents"]  # noqa: E731
                      if e["ph"] == "M"]
    assert meta(doc) == meta(jdoc)
    assert doc["otherData"] == jdoc["otherData"]
    assert doc["otherData"]["disagg"] == {
        "handoffs": 6, "handoff_stalls": got["handoff_stalls"]}


# -------------------------------------------- (g) roles, (h) the builder
def test_engine_refuses_an_unknown_role(qwen3):
    with pytest.raises(ValueError, match="role 'x'"):
        ServeEngine(qwen3[2], role="x")


def test_build_disagg_engine_takes_the_plans_per_role_knobs(qwen3):
    from repro.serve.placement import ExecutionOracle as JaxOracle
    from repro_torch.launch.serve import build_disagg_engine, build_engine
    tm = qwen3[2]
    cfg = tm.cfg
    geo = dict(max_len=128, min_bucket=16, max_bucket=64)
    dis = build_disagg_engine(cfg, tm, prefill_slots=2, decode_slots=3,
                              kv_block_size=16, policy="auto", **geo)
    plan = dis.prefill.policy
    assert plan.source == "auto" and plan is dis.decode.policy
    jax_plan = JaxOracle(cfg, slots=3, **geo).resolve()
    assert plan.per_role == jax_plan.per_role
    assert plan.buckets == jax_plan.buckets
    knobs = plan.per_role["prefill"]
    assert dis.prefill.prefill_chunk == knobs["prefill_chunk"] == 64
    assert dis.prefill.buckets == tuple(knobs["buckets"]) == (16, 32, 64)
    assert plan.per_role["decode"] == {}
    assert dis.decode.buckets == (16, 32, 64)     # max_bucket's ladder
    assert dis.decode.prefill_chunk == 64
    assert dis.decode.kv is not None and not dis.decode.kv.prefix_enabled
    assert dis.prefill.kv.prefix_enabled
    fixed = build_disagg_engine(cfg, tm, policy="fixed", max_len=128,
                                prefill_chunk=24)
    assert fixed.prefill.policy.source == "fixed"
    assert fixed.prefill.prefill_chunk == 24 == fixed.decode.prefill_chunk
    # the pair serves build_engine's tokens
    one = build_engine(cfg, tm, slots=3, kv_block_size=16, **geo)
    want = [r.generated for r in one.run(gate_trace(Request))]
    assert [r.generated for r in dis.run(gate_trace(Request))] == want
    with pytest.raises(ValueError, match="policy"):
        build_disagg_engine(cfg, tm, policy="bogus")
