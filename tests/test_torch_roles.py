"""The disaggregated pair with each role on its own ranks — the
counterpart of the reference's ``test_disagg_engine_token_identity[2, 8]``
and ``test_disagg_paged_prefix_handoff[2, 8]``
(``tests/test_distributed.py``), which pin the roles to disjoint submeshes
of forced host devices: here gloo ranks (``run_ranks`` of
``tests/test_torch_distributed.py``), each rank building only its role's
engine on its submesh (``launch.mesh.make_role_meshes``), the suitcase
crossing ranks by send/recv.

Two worlds: two ranks serve prefill=1,decode=1 (and the CLI's
``--roles``); four ranks serve prefill=2,decode=2 and then
prefill=1,decode=1 at mp=2, in turn.  Every role pair serves the three
state families (the reference's identity trace: a chunked prompt among
bucketed ones) and paged qwen3 with a shared prefix, on the lively
weights of the mesh tests; the JAX package's one-device ``DisaggEngine``
and interleaved ``ServeEngine`` serve the same traces on the same weights
once, in worker processes of this test process while the ranks run, and
the pair's tokens must equal both."""
import contextlib
import io
import json
import multiprocessing
import re
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import (FAMILIES,  # noqa: E402
                                    RANKS_TIMEOUT_S, identity_trace,
                                    jax_run, lively_model, start_ranks,
                                    tokens, varied)

from repro_torch.launch.mesh import RoleConfig, make_role_meshes  # noqa: E402
from repro_torch.launch.serve import main  # noqa: E402
from repro_torch.serve.disagg import DisaggEngine  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402

#: the reference's identity pair and its interleaved engine: the decode
#: role's slots, and the same prefill batching (a GEMM's bits may depend
#: on its rows)
PAIR_KW = dict(prefill_slots=4, decode_slots=8, max_len=64, buckets=(16,),
               max_prefill_per_step=4, max_prefill_batch=2)
INTERLEAVED_KW = dict(slots=8, max_len=64, buckets=(16,),
                      max_prefill_per_step=4, max_prefill_batch=2)

#: the reference's paged prefix pair: blocks of 16 in a 56-block pool
PAGED = dict(max_len=128, buckets=(16, 32), max_prefill_per_step=4,
             kv_block_size=16, kv_blocks=56)

#: the role partitions of each world, by the name the tests take
WORLDS = {"1+1": (2, RoleConfig(1, 1)), "2+2": (4, RoleConfig(2, 2)),
          "1+1,mp=2": (4, RoleConfig(1, 1, mp=2))}

CLI = ["--device", "cpu", "--reduced", "--max-len", "64", "--requests", "4",
       "--max-new", "4"]


def paged_trace(cls, vocab: int) -> list:
    """The reference's paged prefix trace: five prompts on a 40-token
    (2.5-block) shared prefix and four others, one chunked."""
    rng = np.random.RandomState(13)
    shared = rng.randint(1, vocab, 40).tolist()
    out = [cls(rid=i, prompt=shared + rng.randint(1, vocab, 2 + i).tolist(),
               max_new_tokens=4) for i in range(5)]
    out += [cls(rid=100 + i, prompt=rng.randint(1, vocab, n).tolist(),
                max_new_tokens=4) for i, n in enumerate([4, 11, 30, 90])]
    return out


CASES = {arch: (identity_trace, PAIR_KW) for arch in FAMILIES}
CASES["paged"] = (paged_trace, dict(PAGED, prefill_slots=4, decode_slots=8))


# ------------------------------------------------------------------- jobs
def _programs(s: dict) -> dict:
    return {role: sorted(r["programs"]["programs"])
            for role, r in s["roles"].items()}


def _pair(pm, dm, case: str) -> dict:
    """One case through the pair on the role meshes: warm, reset, run."""
    trace, kw = CASES[case]
    model = lively_model("qwen3-0.6b" if case == "paged" else case)
    dis = DisaggEngine(model, prefill_mesh=pm, decode_mesh=dm, **kw)
    dis.warmup()
    warm = dis.summary()
    dis.reset_stats()
    done = dis.run(trace(Request, model.cfg.vocab_size), on_truncate="raise")
    s = dis.summary()
    kv = {role: r.get("kv", {}) for role, r in s["roles"].items()}
    return {"tokens": tokens(done), "handoffs": s["handoffs"],
            "pending": s["handoffs_pending"],
            "completed": s["requests_completed"],
            "programs": _programs(s), "warm_programs": _programs(warm),
            "recompiles": dis.recompiles_since(warm),
            "prefix_hit_rate": kv["prefill"].get("prefix_hit_rate"),
            "decode_blocks_in_use": kv["decode"].get("blocks_in_use"),
            "walls": [s["wall_time_s"]] + [s["roles"][role]["wall_time_s"]
                                           for role in ("prefill", "decode")]}


def _roles(roles: RoleConfig) -> dict:
    pm, dm, role = make_role_meshes(roles, device="cpu")
    out = {"role": role,
           "meshes": [pm.mesh.tolist(), dm.mesh.tolist()]}
    for case in CASES:
        out[case] = _pair(pm, dm, case)
    return out


def _refusal(roles: RoleConfig) -> str | None:
    """``make_role_meshes``' message for ``roles`` (None: no refusal)."""
    try:
        make_role_meshes(roles, device="cpu")
    except RuntimeError as e:
        return str(e)
    return None


def _two(rank: int, where: str) -> dict:
    """prefill=1,decode=1; too many roles for the world; the CLI."""
    out = {"refused": _refusal(RoleConfig(2, 1)),
           "1+1": _roles(RoleConfig(1, 1))}
    files = {k: Path(where, f"{k}_{rank}.json")
             for k in ("tokens", "metrics", "trace")}
    with contextlib.redirect_stdout(io.StringIO()) as said:
        main(CLI + ["--roles", "prefill=1,decode=1", "--warmup",
                    "--tokens-json", str(files["tokens"]), "--metrics-json",
                    str(files["metrics"]), "--trace", str(files["trace"])])
    out["cli"] = {k: json.loads(f.read_text()) if f.exists() else None
                  for k, f in files.items()}
    written = re.search(r"trace written to .* \((\d+) events, (\d+) "
                        r"dropped\)", said.getvalue())
    out["cli"]["trace_line"] = [int(n) for n in written.groups()] \
        if written else None
    return out


def _four(rank: int) -> dict:
    out = {name: _roles(roles) for name, (world, roles) in WORLDS.items()
           if world == 4}
    out["refused"] = _refusal(RoleConfig(1, 1))
    return out


def _jax_oracle(case: str, pair: bool) -> dict:
    """A case served by the JAX package's pair (``pair``) or interleaved
    engine, meshless: its tokens and its ``kv`` summary."""
    trace, kw = CASES[case]
    if not pair:
        kw = dict(INTERLEAVED_KW) if case != "paged" else dict(PAGED, slots=8)
    model = lively_model("qwen3-0.6b" if case == "paged" else case)
    eng, got = jax_run(model, trace, pair=pair, **kw)
    return {"tokens": got,
            "kv": None if pair else eng.stats.summary().get("kv")}


# ------------------------------------------------------------------ tests
#: processes that serve the JAX oracles beside the ranks
JAX_WORKERS = 4


@pytest.fixture(scope="module")
def worlds(tmp_path_factory) -> dict:
    """Both worlds' results by role partition, and the JAX oracles, served
    in ``JAX_WORKERS`` processes while the ranks run: each case's pair and
    interleaved tokens and the interleaved engine's ``kv`` summary."""
    four = start_ranks(tmp_path_factory.mktemp("ranks4"), 4, _four)
    where = tmp_path_factory.mktemp("ranks2")
    two = start_ranks(where, 2, _two, str(where))
    # the workers fork from the ranks' forkserver (torch imported once, no
    # threads started), and import JAX themselves
    with ProcessPoolExecutor(
            JAX_WORKERS,
            mp_context=multiprocessing.get_context("forkserver")) as pool:
        runs = {(case, pair): pool.submit(_jax_oracle, case, pair)
                for case in CASES for pair in (True, False)}
        got = {k: run.result(timeout=RANKS_TIMEOUT_S)
               for k, run in runs.items()}
    oracles = {case: {"pair": got[case, True]["tokens"],
                      "interleaved": got[case, False]["tokens"],
                      "kv": got[case, False]["kv"]} for case in CASES}
    results = {"oracles": oracles, "two": two(), "four": four()}
    results["1+1"] = [res["1+1"] for res in results["two"]]
    for res in results["four"]:
        for name in ("2+2", "1+1,mp=2"):
            results.setdefault(name, []).append(res[name])
    return results


def _check_pair(worlds: dict, name: str, case: str) -> list[dict]:
    """Each rank's case: the JAX pair's and the JAX interleaved engine's
    tokens, one handoff a request and none left, the same on every rank,
    no program registered after warmup; returns the ranks' results."""
    world, roles = WORLDS[name]
    want = worlds["oracles"][case]
    assert varied(want["interleaved"]), f"{case}: tokens do not vary"
    assert want["pair"] == want["interleaved"]
    ranks = worlds[name]
    assert len(ranks) == world
    assert [r["role"] for r in ranks] == \
        ["prefill"] * (roles.prefill * roles.mp) \
        + ["decode"] * (roles.decode * roles.mp)
    for res in ranks:
        got = res[case]
        assert got == ranks[0][case]
        assert got["tokens"] == want["interleaved"], f"{case} diverged"
        n = len(want["interleaved"])
        assert got["handoffs"] == got["completed"] == n
        assert got["pending"] == 0 and got["recompiles"] == 0
        assert got["programs"] == got["warm_programs"]
        assert got["programs"]["prefill"] and got["programs"]["decode"]
        # the coordinator's wall holds each role's ticks: the lockstep
        # tick waits for the other role
        wall, *roles_walls = got["walls"]
        assert wall >= max(roles_walls) > 0
    return ranks


@pytest.mark.parametrize("name", list(WORLDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_disagg_engine_token_identity(worlds, name, arch):
    """The causal (qwen3, dense KV), RG-LRU and Mamba SSM families through
    the pair on disjoint role meshes: the JAX engines' tokens, the 40-token
    prompt's chunked prefill among them."""
    _check_pair(worlds, name, arch)


@pytest.mark.parametrize("name", list(WORLDS))
def test_disagg_paged_prefix_handoff(worlds, name):
    """A copy-on-write shared prefix admitted on the prefill ranks crosses
    in the suitcase's blocks: the JAX engines' tokens, the prefill role's
    prefix hit rate the interleaved engine's (above 0), and the decode
    pool drained to 0 blocks."""
    ranks = _check_pair(worlds, name, "paged")
    want = worlds["oracles"]["paged"]["kv"]["prefix_hit_rate"]
    assert want > 0
    for res in ranks:
        assert res["paged"]["prefix_hit_rate"] == want
        assert res["paged"]["decode_blocks_in_use"] == 0


@pytest.mark.parametrize("name", list(WORLDS))
def test_make_role_meshes_partitions_the_ranks(worlds, name):
    """Prefill takes the first prefill*mp ranks as (prefill, mp), decode
    the next decode*mp as (decode, mp): disjoint, on every rank alike."""
    world, roles = WORLDS[name]
    n_pre = roles.prefill * roles.mp
    ranks = list(range(world))
    want = [np.reshape(ranks[:n_pre], (roles.prefill, roles.mp)).tolist(),
            np.reshape(ranks[n_pre:], (roles.decode, roles.mp)).tolist()]
    for res in worlds[name]:
        assert res["meshes"] == want


def test_make_role_meshes_refuses_too_few_ranks(worlds):
    """The reference's message, on every rank, before any collective."""
    for res in worlds["two"]:
        assert res["refused"] == "roles 2+1 (mp=1) need 3 devices, have 2"


def test_make_role_meshes_refuses_a_larger_world(worlds):
    """A world with ranks outside both roles is refused on every rank (a
    rank is a card, and a card in neither role would serve nothing),
    where the reference takes the first devices."""
    for res in worlds["four"]:
        assert res["refused"] == ("roles 1+1 (mp=1) use 2 devices, have 4: "
                                  "start 2 processes")


def test_disagg_engine_takes_both_role_meshes_or_neither():
    """The reference's refusal of one role mesh without the other; the
    pair takes no shared mesh, only the two role meshes."""
    model = lively_model("qwen3-0.6b")
    with pytest.raises(ValueError, match="both set"):
        DisaggEngine(model, prefill_mesh=object())
    with pytest.raises(ValueError, match="both set"):
        DisaggEngine(model, decode_mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        DisaggEngine(model, mesh=object())


def test_cli_roles_refuses_a_mesh():
    """``--roles`` with ``--mesh`` or ``--dp`` exits with the reference's
    message, before it starts a process group."""
    for extra in (["--mesh", "2x1"], ["--dp", "2"]):
        with pytest.raises(SystemExit, match="mutually exclusive with "
                           "--mesh/--dp"):
            main(CLI + ["--roles", "prefill=1,decode=1"] + extra)


def test_cli_roles_on_two_ranks_serves_roles_off_tokens(worlds, tmp_path,
                                                       capsys):
    """``--roles prefill=1,decode=1`` on two ranks serves ``--roles off``'s
    tokens; rank 0 alone writes, its summary the pair's (one handoff a
    request, the decode role's summary under ``roles``) and its trace
    both roles' tracks, with the events and drops it printed."""
    path = tmp_path / "off.json"
    main(CLI + ["--roles", "off", "--tokens-json", str(path)])
    capsys.readouterr()
    zero, one = (res["cli"] for res in worlds["two"])
    assert set(one.values()) == {None}
    assert zero["tokens"] == json.loads(path.read_text())
    s = zero["metrics"]
    assert s["handoffs"] == s["requests_completed"] == 4
    assert s["roles"]["decode"]["decode_steps"] > 0
    events = zero["trace"]["traceEvents"]
    assert zero["trace_line"] == [
        sum(e["ph"] != "M" for e in events),
        zero["trace"]["otherData"]["dropped_events"]]
    names = {e["args"]["name"] for e in events
             if e["name"] == "thread_name"}
    assert {"prefill/engine", "decode/engine"} <= names
    assert any(e["name"] == "handoff_wire" for e in zero["trace"]
               ["traceEvents"])
