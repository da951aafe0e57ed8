"""The program cost observatory (``repro_torch/obs/programs.py``) against
the JAX package's ``repro.obs.programs`` on the CPU:

- the registry's arithmetic (``summary``, ``phase_totals``,
  ``cluster_rollup``) equals the reference's on the same costs and
  observations;
- the engine's registered inventory (names, phases, ``program`` strings)
  and each program's invocations equal the JAX engine's, the
  disaggregated role pair's included;
- each program's analytic ``flops`` equals ``FlopCounterMode``'s count over
  its CPU call exactly, and its bytes equal the bytes of the tensors it
  reads and writes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.obs.programs import ProgramRegistry as JaxRegistry  # noqa: E402
from repro.serve.disagg import DisaggEngine as JaxDisagg  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.h100 import HBM_BW, PEAK_FLOPS, for_dtype  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import PagedKVCache  # noqa: E402
from repro_torch.obs.programs import (PROGRAMS_SCHEMA_VERSION,  # noqa: E402
                                      ProgramRegistry, cost_terms,
                                      measure_call, program_cost)
from repro_torch.serve.disagg import DisaggEngine  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.placement import ExecutionOracle, fixed_plan  # noqa: E402

from test_torch_model import lively_params  # noqa: E402

QWEN3 = "qwen3-0.6b"


# ------------------------------------------------------------ the roofline
def test_h100_roofline_by_dtype():
    bf16, f32 = for_dtype("bfloat16"), for_dtype("float32")
    assert (bf16.peak_flops, f32.peak_flops) \
        == (PEAK_FLOPS["bfloat16"], PEAK_FLOPS["float32"])
    assert bf16.hbm_bw == f32.hbm_bw == HBM_BW
    assert bf16.peak_flops / f32.peak_flops == pytest.approx(989.4 / 67.0)
    assert HBM_BW == pytest.approx(3.35e12)
    with pytest.raises(ValueError, match="no H100 peak"):
        for_dtype("float16")


# ----------------------------------------------------- the registry's sums
class _Lowered:
    """What the reference's ``register`` reads off a lowered program."""

    def __init__(self, flops, nbytes, memory):
        self._cost = {"flops": flops, "bytes accessed": nbytes}
        self._memory = memory

    def cost_analysis(self):
        return self._cost

    def compile(self):
        return self

    def memory_analysis(self):
        return self._memory


class _Program:
    """Stands in for a jitted program: ``lower`` gives its costs."""

    def __init__(self, flops, nbytes, memory):
        self._lowered = _Lowered(flops, nbytes, memory)

    def lower(self, *args):
        return self._lowered


#: name: (phase, program, flops, bytes, memory)
INVENTORY = {
    "prefill[1x16]": ("prefill", "_prefill", 2_555_904, 437_888,
                      {"argument_size_in_bytes": 903_424,
                       "output_size_in_bytes": 2048,
                       "temp_size_in_bytes": 81_920}),
    "prefill[2x16]": ("prefill", "_prefill", 5_111_808, 448_256,
                      {"argument_size_in_bytes": 904_000,
                       "output_size_in_bytes": 4096,
                       "temp_size_in_bytes": 163_840}),
    "chunk": ("prefill", "_chunk", 11_599_872, 495_616,
              {"argument_size_in_bytes": 905_000,
               "output_size_in_bytes": 2048, "temp_size_in_bytes": 1}),
    "copy": ("kv", "_copy", 0, 8192, {"argument_size_in_bytes": 65_536,
                                      "output_size_in_bytes": 0}),
    "decode": ("decode", "_decode", 491_520, 497_168,
               {"argument_size_in_bytes": 906_000,
                "output_size_in_bytes": 4096,
                "temp_size_in_bytes": 20_480}),
}
#: (name, seconds, phase of an unregistered name)
OBSERVED = [("prefill[1x16]", 3.5e-3, ""), ("decode", 1.25e-3, ""),
            ("prefill[2x16]", 6.0e-3, ""), ("decode", 1.5e-3, ""),
            ("chunk", 2.25e-3, ""), ("copy", 1e-4, ""),
            ("decode", 1.0e-3, ""), ("late", 7e-4, "decode")]


def _plan_summary(kind: str):
    cfg = reduced_config(QWEN3)
    if kind == "auto":
        return ExecutionOracle(cfg, slots=2, max_len=64,
                               backend="cpu").resolve().summary()
    if kind == "fixed":
        return fixed_plan(cfg, buckets=(16,), prefill_chunk=16).summary()
    return None


def _registries(plan_kind: str):
    chip, plan = for_dtype("bfloat16"), _plan_summary(plan_kind)
    ours = ProgramRegistry(chip=chip, plan_summary=plan)
    ref = JaxRegistry(chip=chip, plan_summary=plan)
    for name, (phase, program, flops, nbytes, mem) in INVENTORY.items():
        ours.register(name, (flops, nbytes), phase=phase, program=program,
                      memory=mem)
        ref.register(name, _Program(flops, nbytes, mem), (), phase=phase,
                     program=program, memory=True)
    return ours, ref


def _observe(regs) -> None:
    for name, dur, phase in OBSERVED:
        for reg in regs:
            reg.observe(name, dur, phase=phase, program="_" + name)


@pytest.mark.parametrize("plan_kind", ["auto", "fixed", "none"])
def test_registry_arithmetic_is_the_reference(plan_kind):
    """The same costs, memory and observations (an unregistered name
    among them) give the reference's summary, phase totals and cluster
    rollup, before and after ``reset_observed``; a plan without policies
    gives no ``clusters``."""
    ours, ref = _registries(plan_kind)
    assert ours.summary() == ref.summary()       # registered, not observed
    _observe((ours, ref))
    got, want = ours.summary(), ref.summary()
    assert got == want
    assert ours.phase_totals() == ref.phase_totals()
    assert ours.cluster_rollup() == ref.cluster_rollup()
    assert ("clusters" in got) == (plan_kind == "auto")
    assert got["version"] == PROGRAMS_SCHEMA_VERSION == 1
    assert got["temp_bytes_peak"] == 163_840
    assert got["programs"]["late"]["analyzed"] is False
    assert got["programs"]["decode"]["invocations"] == 3
    ours.reset_observed()
    ref.reset_observed()
    assert ours.summary() == ref.summary()
    assert all(p["invocations"] == 0 and p["measured_s"] == 0.0
               for p in ours.summary()["programs"].values())
    _observe((ours, ref))
    assert ours.summary() == ref.summary()


def test_register_keeps_the_static_cost_and_observe_never_raises():
    reg = ProgramRegistry()
    assert reg.chip == for_dtype("bfloat16")
    reg.observe("never-registered", 0.5)
    e = reg.register("decode", (10, 4), phase="decode", program="_decode")
    assert (e.flops, e.bytes_accessed, e.analyzed) == (10.0, 4.0, True)
    assert e.arithmetic_intensity == 2.5 and reg.temp_bytes_peak() == 0
    assert len(reg) == 2 and reg.entry("missing") is None
    with pytest.raises(ValueError, match="program"):
        program_cost(reduced_config(QWEN3), "sample", max_len=64)


# ------------------------------------------- inventory and invocations
#: each engine configuration: (arch, engine kwargs); "pair" builds the
#: disaggregated role pair on qwen3's paged pool
INVENTORY_KW = dict(slots=2, max_len=48, buckets=(16,), prefill_chunk=16,
                    max_prefill_batch=2)
ENGINES = {
    "qwen3-paged": (QWEN3, dict(kv_block_size=8)),
    "qwen3-dense": (QWEN3, {}),
    "recurrentgemma": ("recurrentgemma-2b", {}),
    "falcon-mamba": ("falcon-mamba-7b", {}),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", dict(kv_block_size=8)),
    "pair": (QWEN3, dict(kv_block_size=8)),
}


def _trace(request_cls):
    """Short prompts (two admitted in one tick: a batch of 2), one longer
    than the bucket (chunked) and two sharing a 20-token prefix (a
    mid-block prefix hit and a copy-on-write clone, paged)."""
    rng = np.random.RandomState(3)
    shared = rng.randint(1, 512, 20).tolist()
    lens = (5, 9, 30, 12)
    first = [request_cls(rid=i, prompt=rng.randint(1, 512, n).tolist(),
                         max_new_tokens=4) for i, n in enumerate(lens)]
    first.append(request_cls(rid=4, prompt=shared
                             + rng.randint(1, 512, 4).tolist(),
                             max_new_tokens=4))
    late = request_cls(rid=5, prompt=shared + rng.randint(1, 512, 7).tolist(),
                       max_new_tokens=4)
    return first, late


def _inventory(programs) -> dict:
    return {name: (e.phase, e.program)
            for name, e in programs._entries.items()}


def _invocations(programs) -> dict:
    return {name: e.invocations for name, e in programs._entries.items()}


def _role_engines(engine):
    if isinstance(engine, (DisaggEngine, JaxDisagg)):
        return {"prefill": engine.prefill, "decode": engine.decode}
    return {"both": engine}


@pytest.fixture(scope="module", params=sorted(ENGINES))
def served(request):
    """The configuration's JAX and port engines (the same weights through
    the bridge), each warmed up, then serving ``_trace``: their registered
    inventories per role, and their invocations and counters after it."""
    arch, kw = ENGINES[request.param]
    jm, jp, tree = lively_params("float32", arch=arch, gain=1.0)
    tm = from_jax_params(tree, reduced_config(arch).replace(
        compute_dtype="float32"), "cpu")
    kw = dict(INVENTORY_KW, max_prefill_per_step=2, **kw)
    if request.param == "pair":
        slots = kw.pop("slots")
        pair = dict(prefill_slots=slots, decode_slots=slots)
        jax_engine, engine = JaxDisagg(jm, jp, **pair, **kw), \
            DisaggEngine(tm, **pair, **kw)
    else:
        jax_engine, engine = JaxEngine(jm, jp, **kw), ServeEngine(tm, **kw)
    out = {}
    for side, eng, cls in (("jax", jax_engine, JaxRequest),
                           ("port", engine, Request)):
        eng.warmup()
        roles = _role_engines(eng)
        inventory = {r: _inventory(e.programs) for r, e in roles.items()}
        first, late = _trace(cls)
        eng.run(first, on_truncate="raise")
        eng.run([late], on_truncate="raise")
        out[side] = dict(
            inventory=inventory,
            invocations={r: _invocations(e.programs)
                         for r, e in roles.items()},
            stats={r: e.stats for r, e in roles.items()},
            summary=eng.summary() if request.param == "pair"
            else eng.stats.summary())
    return request.param, out


def test_inventory_matches_jax_engine(served):
    """Every program the JAX engine's warmup registers, the port's
    registers, under the same name, phase and ``program`` string, and
    nothing else; a role engine only its own shapes and its half of the
    handoff."""
    which, out = served
    got, want = out["port"]["inventory"], out["jax"]["inventory"]
    assert got == want
    names = set().union(*got.values())
    assert "decode" in names and any(n.startswith("prefill[") for n in names)
    if which == "pair":
        assert "export" in got["prefill"] and "import" in got["decode"]
        assert "decode" not in got["prefill"]
    if which in ("qwen3-paged", "phi3.5-moe", "pair"):
        assert "copy" in names


def test_invocations_match_jax_engine(served):
    """After the same requests each program's invocations are the JAX
    engine's, and add up to the engine's own counters: ``decode`` its
    decode steps, the ``prefill[...]`` programs its prefill calls,
    ``chunk`` its chunks, ``copy`` its copied blocks, ``export`` and
    ``import`` its handoffs; each role's summary carries its own
    ``programs`` section."""
    which, out = served
    got, want = out["port"]["invocations"], out["jax"]["invocations"]
    assert got == want
    for role, inv in got.items():
        st = out["port"]["stats"][role]
        assert inv.get("decode", 0) == st.decode_steps
        assert sum(n for k, n in inv.items() if k.startswith("prefill[")) \
            == st.prefill_calls
        assert inv.get("chunk", 0) == st.prefill_chunks
        assert inv.get("copy", 0) == st.blocks_copied
        assert inv.get("export", 0) + inv.get("import", 0) == st.handoffs
    total = {}
    for inv in got.values():
        for k, n in inv.items():
            total[k] = total.get(k, 0) + n
    assert total["decode"] > 0 and total["chunk"] > 0
    if which in ("qwen3-paged", "phi3.5-moe", "pair"):
        assert total["copy"] >= 1
    if which == "pair":
        assert total["export"] == total["import"] == 6
        for role in ("prefill", "decode"):
            s, js = (out[side]["summary"]["roles"][role]
                     for side in ("port", "jax"))
            assert set(s["programs"]["programs"]) \
                == set(js["programs"]["programs"])


# ----------------------------------------------- FLOPs and bytes, exactly
#: (arch, config changes, engine kwargs) of the engines whose every program
#: is held to FlopCounterMode and to its tensors' bytes
COST_KW = dict(slots=2, max_len=64)
COSTS = {
    "qwen3-paged": (QWEN3, {}, dict(kv_block_size=8)),
    "qwen3-dense": (QWEN3, {}, {}),
    "recurrentgemma-w16": ("recurrentgemma-2b", {}, {}),
    "recurrentgemma-w24": ("recurrentgemma-2b", dict(window=24), {}),
    "falcon-mamba": ("falcon-mamba-7b", {}, {}),
    "starcoder2": ("starcoder2-7b", {}, dict(kv_block_size=8)),
    "internvl2": ("internvl2-2b", {},
                  dict(kv_block_size=8, prefix_cache=False, max_len=32)),
    "phi3.5-moe-einsum": ("phi3.5-moe-42b-a6.6b", {},
                          dict(kv_block_size=8)),
    "phi3.5-moe-ragged": ("phi3.5-moe-42b-a6.6b", dict(moe_impl="ragged"),
                          dict(kv_block_size=8)),
    "llama4-scout": ("llama4-scout-17b-a16e", {}, dict(kv_block_size=8)),
    "pair": (QWEN3, {}, dict(kv_block_size=8)),
}


def _record_warmup(engine) -> dict:
    """Warm ``engine`` up with every program's call recorded: name ->
    (FlopCounterMode's total, the call's arguments, its result)."""
    calls = {}
    own = engine._warm_program

    def counted(name, geometry, fn, *args, **kwargs):
        with FlopCounterMode(display=False) as fc:
            out = own(name, geometry, fn, *args, **kwargs)
        calls[name] = (fc.get_total_flops(), args, out)
        return out

    engine._warm_program = counted
    try:
        engine.warmup()
    finally:
        del engine._warm_program
    return calls


@pytest.fixture(scope="module", params=sorted(COSTS))
def warmed(request):
    arch, cfg_kw, kw = COSTS[request.param]
    cfg = reduced_config(arch).replace(compute_dtype="float32", **cfg_kw)
    model = build_model(cfg, device="cpu", seed=0)
    kw = dict(COST_KW, **kw)
    if request.param == "pair":
        slots = kw.pop("slots")
        pair = DisaggEngine(model, prefill_slots=slots, decode_slots=slots,
                            **kw)
        engines = [pair.prefill, pair.decode]
    else:
        engines = [ServeEngine(model, **kw)]
    return request.param, cfg, model, [(e, _record_warmup(e))
                                       for e in engines]


def test_flops_equal_flop_counter_over_each_call(warmed):
    """Every registered program's ``flops`` is exactly what
    ``FlopCounterMode`` counts over its warmup call on the CPU."""
    _, _, _, engines = warmed
    for engine, calls in engines:
        assert set(calls) == set(engine.programs._entries)
        for name, (flops, _, _) in calls.items():
            assert engine.programs.entry(name).flops == flops, name


def test_flops_sum_over_the_warmup():
    """Reduced qwen3, float32, 2 slots, max_len 64, paged blocks of 8: the
    whole warmup's count is the inventory's sum; the one-row 16-token
    prefill is 2 x (16 tokens x 2 layers x 36,864 MACs + 2 layers x 32,768
    MACs of QK and PV + 32,768 MACs of the tied head)."""
    cfg = reduced_config(QWEN3).replace(compute_dtype="float32")
    engine = ServeEngine(build_model(cfg, device="cpu", seed=0),
                         **COST_KW, kv_block_size=8)
    with FlopCounterMode(display=False) as fc:
        engine.warmup()
    progs = engine.stats.summary()["programs"]["programs"]
    assert fc.get_total_flops() == 70_483_968 \
        == sum(p["flops"] for p in progs.values())
    assert progs["prefill[1x16]"]["flops"] == 2_555_904 \
        == 2 * (16 * 2 * 36_864 + 2 * 32_768 + 32_768)


def _param_bytes(cfg, model, name: str, engine) -> int:
    """The bytes of the model's tensors program ``name`` reads: every
    parameter but the modality stub (the engine embeds text only); an
    untied embedding only at the rows the call looks up."""
    if name in ("copy", "export", "import"):
        return 0
    batch, seq = _geometry(name, engine)
    total = 0
    for pname, p in model.named_parameters():
        if pname.startswith("mm_proj"):
            continue
        if pname == "embed" and not cfg.tie_embeddings:
            total += batch * seq * cfg.d_model * p.element_size()
            continue
        total += p.nbytes
    return total


def _geometry(name: str, engine) -> tuple[int, int]:
    """(rows, tokens a row) of program ``name``'s call."""
    if name.startswith("prefill["):
        nb, b = name[len("prefill["):-1].split("x")
        return int(nb), int(b)
    if name == "chunk":
        return 1, engine.prefill_chunk
    return engine.slots, 1


def _layer_tensors(engine):
    """Per layer of the engine's states: (KV bytes, KV tokens a slot holds
    or None for the paged pool, recurrent state bytes)."""
    out = []
    for st in engine.states:
        if st.kv is not None:
            per_row = None if isinstance(st.kv, PagedKVCache) \
                else st.kv.k.shape[1]
            out.append((st.kv.k.nbytes + st.kv.v.nbytes, per_row, 0))
        else:
            out.append((0, None, sum(a.nbytes for a in st.rec.values())))
    return out


def _kv_state_bytes(name: str, engine) -> tuple[int, int]:
    """The KV and recurrent-state bytes program ``name`` moves, from the
    engine's own tensors at its geometry: a paged pool of the default size
    holds ``slots`` rows of a full table; KV is written per token and read
    across each slot's row; a recurrent state is read and written."""
    slots, layers = engine.slots, _layer_tensors(engine)
    kv = state = 0
    if name == "copy":
        return 2 * engine.kv.block_bytes, 0
    batch, seq = _geometry(name, engine)
    for nbytes, per_row, rec in layers:
        state += 2 * rec * batch // slots
        if not nbytes:
            continue
        row = nbytes // slots                     # one slot's KV row
        tokens = per_row if per_row is not None \
            else engine.kv.blocks_per_slot * engine.kv.block_size
        per_token = row // tokens
        if name in ("export", "import"):
            kv += 2 * row
            continue
        written = batch * min(seq, tokens) * per_token
        read = 0 if name.startswith("prefill[") else batch * row
        if name == "decode":
            written = 0
        kv += written + read
    if name in ("export", "import"):
        state = 2 * sum(rec for _, _, rec in layers) // slots
    return kv, state


def test_bytes_equal_the_tensors_each_program_moves(warmed):
    """Each program's parameter term is the bytes of the model's tensors
    it reads; its KV and state terms the bytes of the engine's pool,
    caches and states at that geometry; its I/O the call's token ids and
    logits; ``bytes_accessed`` their sum.  The ``ragged`` route reads only
    the banks it routes to, a count that depends on the data: its
    parameter term is bounded by the capacity route's."""
    which, cfg, model, engines = warmed
    for engine, calls in engines:
        kv_block = engine.kv.block_size if engine.kv is not None else None
        for name, (_, args, out) in calls.items():
            kind = name.split("[")[0]
            batch, seq = _geometry(name, engine)
            terms = cost_terms(cfg, kind, max_len=engine.max_len,
                               batch=batch, seq=seq, kv_block_size=kv_block)
            params = _param_bytes(cfg, model, name, engine)
            if which == "phi3.5-moe-ragged" and kind not in (
                    "copy", "export", "import"):
                assert terms["params"] <= params, name
            else:
                assert terms["params"] == params, name
            assert (terms["kv"], terms["state"]) \
                == _kv_state_bytes(name, engine), name
            io = 0
            if kind in ("prefill", "chunk", "decode"):
                io = args[0].nbytes + out.nbytes      # tokens, logits
            assert terms["io"] == io, name
            e = engine.programs.entry(name)
            assert e.bytes_accessed == sum(terms[k] for k in (
                "params", "kv", "state", "io")), name


def test_ragged_route_counts_the_banks_it_can_touch():
    """The ``ragged`` route's FLOPs are static (its groups sum to N x
    top_k rows); its banks are the most a call can touch, min(E, N x
    top_k): every bank at prefill, top_k banks a decoded token."""
    cfg = reduced_config("phi3.5-moe-42b-a6.6b").replace(moe_impl="ragged")
    capacity_cfg = cfg.replace(moe_impl="einsum")
    bank = 3 * cfg.d_model * cfg.d_ff * 2
    geo = dict(max_len=64, kv_block_size=8)
    dec = cost_terms(cfg, "decode", batch=1, **geo)
    cap = cost_terms(capacity_cfg, "decode", batch=1, **geo)
    assert cap["params"] - dec["params"] \
        == cfg.num_layers * (cfg.num_experts - cfg.top_k) * bank
    pre = cost_terms(cfg, "prefill", batch=1, seq=16, **geo)
    assert pre["params"] \
        == cost_terms(capacity_cfg, "prefill", batch=1, seq=16,
                      **geo)["params"]


def test_engine_divides_by_the_h100_at_its_compute_dtype():
    for dt in ("float32", "bfloat16"):
        cfg = reduced_config(QWEN3).replace(compute_dtype=dt)
        engine = ServeEngine(build_model(cfg, device="cpu", seed=0),
                             slots=2, max_len=32)
        chip = engine.stats.summary()["programs"]["chip"]
        assert chip == {"name": f"h100_sxm_{dt}",
                        "peak_flops": PEAK_FLOPS[dt], "hbm_bw": HBM_BW}


def test_program_memory_on_the_cpu_has_no_watermark():
    """``program_memory=True`` measures each warmup call's argument bytes
    (at least the parameters) and output bytes (each program's logits: it
    writes the engine's states in place); the CPU has no
    allocator watermark, so temp and peak are omitted and so is the
    gauge."""
    cfg = reduced_config("recurrentgemma-2b").replace(
        compute_dtype="float32")
    model = build_model(cfg, device="cpu", seed=0)
    engine = ServeEngine(model, slots=2, max_len=64, program_memory=True)
    engine.warmup()
    params = sum(p.nbytes for p in model.parameters())
    s = engine.stats.summary()
    for name, rec in s["programs"]["programs"].items():
        mem = rec["memory"]
        assert set(mem) == {"argument_size_in_bytes",
                            "output_size_in_bytes"}, name
        assert mem["argument_size_in_bytes"] >= params, name
        assert mem["output_size_in_bytes"] > 0, name
    assert "temp_bytes_peak" not in s["programs"]
    assert "program_temp_bytes_peak" not in s["obs"]["gauges"]
    x = torch.ones((3, 4))
    out, mem = measure_call(torch.add, (x, x), {"alpha": 2})
    assert torch.equal(out, torch.full((3, 4), 3.0))
    assert mem == {"argument_size_in_bytes": 48,
                   "output_size_in_bytes": 48}
    _, mem = measure_call(torch.Tensor.mul_, (x, 2.0))
    assert mem["output_size_in_bytes"] == 0            # in place: an alias
