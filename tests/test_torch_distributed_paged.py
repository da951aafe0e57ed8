"""The port's sharded serving on gloo ranks, continued (see
``tests/test_torch_distributed.py`` for how the ranks run): the paged pool
striped over the data axis with the prefix cache (the reference's
``test_sharded_paged_prefix_engine``), ``param_strategy="auto"`` against
``"tp"`` on a (1, 2) mesh (``tests/test_serve_sharding.py``) and the
serving CLI on two ranks.  One set of two ranks serves every 2-rank case,
one set of eight the 8-rank one.  The paged and uneven-heads traces also
go through the port's and the JAX package's meshless engines in this test
process (``oracles``), and the mesh's tokens must equal both.  The
disaggregated pair, each role on ranks of its own, is in
``tests/test_torch_roles.py``."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import (float32_config,  # noqa: E402
                                    lively_model, oracles, run_ranks,
                                    tokens, varied)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.launch.serve import build_engine, main  # noqa: E402
from repro_torch.obs import program_cost  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402


# ------------------------------------------------------------------- jobs
def paged_trace(cls, vocab: int) -> list:
    rng = np.random.RandomState(13)
    shared = rng.randint(1, vocab, 20).tolist()
    out = [cls(rid=i, prompt=shared + rng.randint(1, vocab, 2 + i).tolist(),
               max_new_tokens=4) for i in range(5)]
    out += [cls(rid=100 + i, prompt=rng.randint(1, vocab, n).tolist(),
                max_new_tokens=4) for i, n in enumerate([4, 11, 30])]
    return out


#: the reference's ``test_sharded_paged_prefix_engine`` engine: a 24-block
#: pool with the prefix cache
PAGED_KW = dict(slots=8, max_len=64, buckets=(16, 32),
                max_prefill_per_step=4, kv_block_size=16, kv_blocks=24)


def _paged(nd: int) -> dict:
    """Reduced qwen3 through the paged engine with the prefix cache
    (the pool striped nd ways), on a (nd, 1) mesh."""
    model = lively_model("qwen3-0.6b")
    vocab = model.cfg.vocab_size
    eng = ServeEngine(model, mesh=make_serve_mesh(nd, 1, device="cpu"),
                      **PAGED_KW)
    shards = eng.kv.shards
    eng.warmup()
    eng.reset_stats()
    done = tokens(eng.run(paged_trace(Request, vocab)))
    s = eng.stats.summary()
    return {"mesh": done, "shards": shards, "kv": s["kv"],
            "decode_flops": s["programs"]["programs"]["decode"]["flops"],
            "rank_decode_flops": program_cost(
                model.cfg, "decode", max_len=64, batch=8 // nd,
                kv_block_size=16)[0]}


def _auto_and_tp() -> dict:
    """Reduced falcon-mamba through ``build_engine`` on a (1, 2) mesh with
    the "auto" weight layout (its SSM family replicated) and with "tp"
    (sliced over ``model``), and without a mesh."""
    model = lively_model("falcon-mamba-7b")
    cfg = model.cfg

    def run(mesh, strategy):
        eng = build_engine(cfg, model, slots=2, max_len=64, max_bucket=32,
                           mesh=mesh, param_strategy=strategy,
                           plan_cfg=get_config("falcon-mamba-7b"))
        rng = np.random.RandomState(11)
        return tokens(eng.run(
            [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size,
                                               4 + 6 * i).tolist(),
                     max_new_tokens=4) for i in range(3)]))

    mesh = make_serve_mesh(1, 2, device="cpu")
    return {"auto": run(mesh, "auto"), "tp": run(mesh, "tp"),
            "ref": run(None, "tp")}


def _cli(rank: int, where: str) -> dict:
    """The serving CLI on the two ranks with ``--mesh 2x1`` and with
    ``--mesh off``: each run's tokens (rank 0 writes a mesh run's files)."""
    out = {}
    for mesh in ("2x1", "off"):
        path = Path(where, f"tokens_{mesh}_{rank}.json")
        main(["--device", "cpu", "--reduced", "--mesh", mesh, "--max-len",
              "64", "--requests", "4", "--max-new", "4", "--warmup",
              "--program-memory", "--tokens-json",
              str(path)])
        out[mesh] = json.loads(path.read_text()) if path.exists() else None
    return out


def uneven_config():
    """Reduced smollm at its full head counts, 9 over 3 KV heads."""
    return float32_config("smollm-135m").replace(num_heads=9,
                                                 num_kv_heads=3)


def uneven_trace(cls, vocab: int) -> list:
    rng = np.random.RandomState(2)
    return [cls(rid=i, prompt=rng.randint(1, vocab, n).tolist(),
                max_new_tokens=4) for i, n in enumerate((5, 12, 30))]


UNEVEN_KW = dict(slots=2, max_len=64, buckets=(16,), kv_block_size=16)


def _uneven() -> dict:
    """Reduced smollm with heads that split no even way over two ranks,
    paged, on a (1, 2) mesh."""
    model = lively_model("smollm-135m", uneven_config())
    eng = ServeEngine(model, mesh=make_serve_mesh(1, 2, device="cpu"),
                      **UNEVEN_KW)
    return {"mesh": tokens(eng.run(uneven_trace(Request,
                                                model.cfg.vocab_size)))}


def _two(rank: int, where: str) -> dict:
    return {"paged": _paged(2), "auto_tp": _auto_and_tp(),
            "cli": _cli(rank, where), "uneven": _uneven()}


def _eight(rank: int) -> dict:
    return {"paged": _paged(8)}


# ------------------------------------------------------------------ tests
@pytest.fixture(scope="module")
def two(tmp_path_factory) -> list[dict]:
    where = tmp_path_factory.mktemp("ranks2")
    return run_ranks(where, 2, _two, str(where))


@pytest.fixture(scope="module")
def eight(tmp_path_factory) -> list[dict]:
    return run_ranks(tmp_path_factory.mktemp("ranks8"), 8, _eight)


@pytest.fixture(scope="module")
def paged_oracles() -> dict:
    """The paged trace without a mesh, port and JAX."""
    return oracles(lively_model("qwen3-0.6b"), paged_trace, **PAGED_KW)


@pytest.mark.parametrize("nd", [2, 8])
def test_sharded_paged_prefix_engine(nd, request, paged_oracles):
    """The paged + prefix-cache engine on a pool striped nd ways: the
    meshless engine's tokens and the JAX engine's, its prefix hit rate
    (above 0) and block peak, ``kv.shards == nd``, per-shard counts that
    sum to the totals, and a decode program counted at a rank's 8 / nd
    slots."""
    want = paged_oracles
    assert varied(want["ref"])
    ref_kv = want["engine"].stats.summary()["kv"]
    for res in request.getfixturevalue({2: "two", 8: "eight"}[nd]):
        assert res["ranks_agree"]["paged"]
        case = res["paged"]
        assert case["shards"] == nd
        assert case["mesh"] == want["ref"]
        assert case["mesh"] == want["jax"]
        kv = case["kv"]
        assert kv["prefix_hit_rate"] > 0
        assert kv["prefix_hit_rate"] == ref_kv["prefix_hit_rate"]
        assert kv["shards"] == nd
        assert sum(kv["in_use_per_shard"]) == kv["blocks_in_use"]
        assert sum(kv["peak_per_shard"]) == kv["blocks_peak"]
        assert kv["blocks_peak"] == ref_kv["blocks_peak"]
        assert case["decode_flops"] == case["rank_decode_flops"]


def test_sharded_kv_keys_match_reference(two, paged_oracles):
    """A striped pool's ``kv`` section has the reference's keys: its
    ``EngineStats.summary()`` with the same pool split two ways."""
    pytest.importorskip("jax")
    from repro.serve.engine import EngineStats
    want = EngineStats(kv_pool_blocks=24, kv_block_size=16,
                       kv_shards=2).summary()["kv"]
    for res in two:
        assert set(res["paged"]["kv"]) == set(want)
    assert "shards" not in paged_oracles["engine"].stats.summary()["kv"]


def test_param_strategy_auto_matches_tp(two):
    """On a (1, 2) mesh the "auto" layout (falcon-mamba's SSM family
    replicated, as its plan's memory-centric cluster asks) serves the
    tokens the "tp" layout does, and both the meshless engine's."""
    for res in two:
        assert res["ranks_agree"]["auto_tp"]
        case = res["auto_tp"]
        assert case["auto"] == case["tp"] == case["ref"]


def test_cli_on_two_ranks_matches_meshless(two):
    """``python -m repro_torch.launch.serve --mesh 2x1`` on two gloo ranks
    serves the ``--mesh off`` run's tokens; rank 0 alone writes."""
    zero, one = two
    assert zero["cli"]["2x1"] is not None and one["cli"]["2x1"] is None
    assert zero["cli"]["2x1"] == zero["cli"]["off"] == one["cli"]["off"]


def test_heads_that_do_not_split_are_gathered(two):
    """A model axis of 2 under 9 query and 3 KV heads: the projections are
    gathered whole before the heads are split, the cache keeps every head
    on each rank, and the meshless engine's tokens and the JAX engine's
    come out."""
    want = oracles(lively_model("smollm-135m", uneven_config()),
                   uneven_trace, **UNEVEN_KW)
    assert varied(want["ref"])
    for res in two:
        assert res["ranks_agree"]["uneven"]
        assert res["uneven"]["mesh"] == want["ref"] == want["jax"]
