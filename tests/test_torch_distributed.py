"""The port's sharded serving engine on gloo ranks on the CPU — the
counterpart of the reference's ``tests/test_distributed.py`` engine tests,
which force 8 host devices: here 1, 2 or 8 processes, each a rank of one
``torch.distributed`` group (a file store under the test's directory, so
concurrent test workers never share a port), each serving the same
requests (SPMD).  The ranks run the port only and serve each trace on a
mesh; this test process serves the same trace on the same weights once
through the port's meshless engine and once through the JAX package's,
and the mesh's tokens must equal both.  The weights are the seed-0 init
made lively as the other JAX comparisons make theirs (random norm
scales, scaled weights), so that greedy tokens vary within a request: at
the bare init each step repeats the prompt's last token.  Each test
starts one set of ranks that serves every family; the 8-rank set serves
both the data-parallel (8, 1) and the tensor-parallel (4, 2) cases.

``tests/test_torch_distributed_paged.py`` holds the paged pool's cases, so
that xdist's ``loadfile`` runs the two files side by side."""
import json
import multiprocessing
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp_mp  # noqa: E402

from repro_torch.bridge import layout, to_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.disagg import DisaggEngine  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

FAMILIES = ("qwen3-0.6b", "recurrentgemma-2b", "falcon-mamba-7b")

#: how far each family's weights are scaled off the init: far enough that
#: greedy tokens vary within a request (falcon-mamba's repeat at 1.0),
#: and recurrentgemma's kept at 1.0, where tripled its float32 rounding
#: grows past what keeps the JAX and the port's tokens equal
#: (tests/test_torch_model.py)
GAINS = {"qwen3-0.6b": 3.0, "recurrentgemma-2b": 1.0,
         "falcon-mamba-7b": 2.0, "smollm-135m": 3.0,
         "phi3.5-moe-42b-a6.6b": 3.0, "llama4-scout-17b-a16e": 3.0}


# ------------------------------------------------------------------ ranks
#: how long a rank waits in one collective before it raises (gloo's own
#: default is 30 minutes): a rank that fails or hangs mid-protocol then
#: fails its test instead of holding the suite to its time limit
COLLECTIVE_TIMEOUT = timedelta(minutes=3)

#: how long a set of ranks may take in all before it is killed
RANKS_TIMEOUT_S = 600


def _rank_main(rank: int, world: int, where: str, job, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{where}/pg",
                            rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        out = job(rank, *args)
        # every rank's results, gathered: SPMD host logic keeps each case
        # equal across the ranks
        everyone = [None] * world
        dist.all_gather_object(everyone, out)
        out["ranks_agree"] = {k: all(o[k] == out[k] for o in everyone)
                              for k in out}
        Path(where, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def start_ranks(where: Path, world: int, job, *args):
    """Start ``job(rank, *args)`` (a module-level function returning a
    JSON-able dict) on ``world`` gloo ranks; returns the function that
    waits for them (at most ``RANKS_TIMEOUT_S`` in all, then kills them
    and raises) and gives each rank's result, rank 0 first, so that this
    process can work while the ranks run.  The ranks fork from one server
    process that imported torch and the jobs' module once
    (``forkserver``), not from this worker, whose threads a fork would
    copy mid-flight."""
    where.mkdir(parents=True, exist_ok=True)
    multiprocessing.set_forkserver_preload(
        ["torch", "torch.distributed.tensor", job.__module__])
    ctx = tmp_mp.start_processes(_rank_main,
                                 args=(world, str(where), job, args),
                                 nprocs=world, start_method="forkserver",
                                 join=False)
    deadline = time.monotonic() + RANKS_TIMEOUT_S

    def results() -> list[dict]:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"{world} ranks of {job.__name__} did "
                                   f"not end within {RANKS_TIMEOUT_S} s")
        return [json.loads((where / f"rank{r}.json").read_text())
                for r in range(world)]

    return results


def run_ranks(where: Path, world: int, job, *args) -> list[dict]:
    """``job(rank, *args)`` on ``world`` gloo ranks (``start_ranks``),
    waited for; each rank's result, rank 0 first."""
    return start_ranks(where, world, job, *args)()


def float32_config(arch: str):
    """The reduced config at the reference tests' depth, in float32."""
    cfg = reduced_config(arch)
    return cfg.replace(num_layers=max(2, len(cfg.block_pattern)),
                       compute_dtype="float32")


def lively_model(arch: str, cfg=None):
    """The seed-0 float32 model of ``arch`` (``cfg``: its config, else
    ``float32_config(arch)``) with random norm scales and the other
    weights times ``GAINS[arch]`` (the RG-LRU's ``lambda`` kept), from a
    numpy seed: the same weights on every rank and in the test process."""
    model = build_model(cfg or float32_config(arch), device="cpu", seed=0)
    params = dict(model.named_parameters())
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for leaf in layout(model):
            p, where = params[leaf.name], "/".join(map(str, leaf.path))
            if "scale" in where or "norm" in where:
                p.copy_(torch.from_numpy(
                    rng.normal(0, 0.5, tuple(p.shape)).astype(np.float32)))
            elif "lambda" not in where:
                p.mul_(GAINS[arch])
    return model


def tokens(done: list) -> list:
    return [r.generated for r in done]


def varied(toks: list) -> bool:
    """Some request's greedy tokens are not one token repeated."""
    return any(len(set(t)) > 1 for t in toks)


def jax_run(model, trace, *, pair: bool = False, **kw) -> tuple:
    """``trace(JAX Request class, vocab)`` served by the JAX package's
    meshless ``ServeEngine`` (``pair``: its ``DisaggEngine``) with engine
    arguments ``kw``, on ``model``'s weights; the engine and the greedy
    tokens.  JAX is imported here, in the test process, never in a rank."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config as jax_reduced
    from repro.models import build_model as jax_build
    from repro.serve.disagg import DisaggEngine as JaxDisagg
    from repro.serve.engine import Request as JaxRequest
    from repro.serve.engine import ServeEngine as JaxEngine

    cfg = model.cfg
    jcfg = jax_reduced(cfg.name).replace(
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, moe_capacity=cfg.moe_capacity,
        compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, to_jax_params(model))
    eng = (JaxDisagg if pair else JaxEngine)(jax_build(jcfg), params, **kw)
    return eng, tokens(eng.run(trace(JaxRequest, cfg.vocab_size)))


def jax_tokens(model, trace, *, pair: bool = False, **kw) -> list:
    """The greedy tokens of ``jax_run``."""
    return jax_run(model, trace, pair=pair, **kw)[1]


def oracles(model, trace, *, pair: bool = False, **kw) -> dict:
    """The oracles of a mesh run, served in the test process: ``trace``
    through the port's meshless engine (``pair``: its ``DisaggEngine``;
    ``"engine"``, for its stats) and ``"ref"``, its tokens, and ``"jax"``,
    the JAX package's tokens (``jax_tokens``)."""
    eng = (DisaggEngine if pair else ServeEngine)(model, **kw)
    return {"engine": eng,
            "ref": tokens(eng.run(trace(Request, model.cfg.vocab_size))),
            "jax": jax_tokens(model, trace, pair=pair, **kw)}


# ------------------------------------------------------------------- jobs
def identity_trace(cls, vocab: int) -> list:
    rng = np.random.RandomState(7)
    # short bucketed prompts + one beyond the largest bucket (the chunked
    # path)
    return [cls(rid=i, prompt=rng.randint(1, vocab, n).tolist(),
                max_new_tokens=4)
            for i, n in enumerate([3, 7, 12, 15, 9, 40])]


#: the reference's ``test_sharded_engine_token_identity`` engine
IDENTITY_KW = dict(slots=8, max_len=64, buckets=(16,),
                   max_prefill_per_step=4, max_prefill_batch=2)


def _identity(nd: int) -> dict:
    """The reference's ``test_sharded_engine_token_identity`` serve: each
    family's tokens on a (nd, 1) mesh."""
    out = {}
    for arch in FAMILIES:
        model = lively_model(arch)
        eng = ServeEngine(model, mesh=make_serve_mesh(nd, 1, device="cpu"),
                          **IDENTITY_KW)
        eng.warmup()
        eng.reset_stats()
        out[arch] = tokens(eng.run(identity_trace(Request,
                                                  model.cfg.vocab_size)))
    return out


def tp_trace(cls, vocab: int) -> list:
    rng = np.random.RandomState(3)
    return [cls(rid=i, prompt=rng.randint(1, vocab, n).tolist(),
                max_new_tokens=4)
            for i, n in enumerate([5, 9, 14, 30])]


#: the reference's ``test_sharded_engine_tensor_parallel_mesh`` engine
TP_KW = dict(slots=4, max_len=64, buckets=(16,))


def _tensor_parallel() -> dict:
    """The reference's ``test_sharded_engine_tensor_parallel_mesh`` serve:
    qwen3 (dense KV) on a (4, 2) mesh, with the logits of one prefill of
    each prompt on it and without a mesh."""
    model = lively_model("qwen3-0.6b")
    vocab = model.cfg.vocab_size
    eng = ServeEngine(model, mesh=make_serve_mesh(4, 2, device="cpu"),
                      **TP_KW)
    eng.warmup()
    eng.reset_stats()
    got = tokens(eng.run(tp_trace(Request, vocab)))
    # each rank's shard of a head-split cache is a dense array of its own,
    # as the card's kernels read it
    dense = all(a.to_local().is_contiguous() for st in eng.states
                for a in st.kv)
    # the first step's logits of each prompt, sharded and not: how far a
    # row-parallel sum in another order moves them
    diff = 0.0
    for r in tp_trace(Request, vocab):
        t = torch.tensor([r.prompt])
        one = model.prefill(t, model.init_states(1, 64))[0]
        sharded = eng.model.prefill(eng._rows(np.asarray([r.prompt])),
                                    eng._fresh_states(1))[0].full_tensor()
        diff = max(diff, float((one - sharded).abs().max()))
    return {"mesh": got, "logits_max_diff": diff, "contiguous": dense}


def _one(rank: int, nd: int) -> dict:
    return {"identity": _identity(nd)}


def _eight(rank: int) -> dict:
    return {"identity": _identity(8), "tp": _tensor_parallel()}


# ------------------------------------------------------------------ tests
@pytest.fixture(scope="module")
def eight(tmp_path_factory) -> list[dict]:
    """The 8-rank set, once for the file: (8, 1) identity and (4, 2) TP."""
    return run_ranks(tmp_path_factory.mktemp("ranks8"), 8, _eight)


@pytest.fixture(scope="module")
def identity_oracles() -> dict:
    """Each family's identity trace without a mesh, port and JAX."""
    return {arch: oracles(lively_model(arch), identity_trace, **IDENTITY_KW)
            for arch in FAMILIES}


@pytest.mark.parametrize("nd", [1, 2, 8])
def test_sharded_engine_token_identity(nd, tmp_path, request,
                                       identity_oracles):
    """On a (nd, 1) data-parallel mesh every family serves exactly the
    meshless engine's greedy tokens and the JAX engine's — the causal
    (qwen3), sliding-window + RG-LRU (recurrentgemma) and Mamba SSM
    (falcon-mamba) states — and every rank the same ones (eight ranks:
    one slot a rank)."""
    results = request.getfixturevalue("eight") if nd == 8 \
        else run_ranks(tmp_path, nd, _one, nd)
    for res in results:
        assert res["ranks_agree"]["identity"]
        for arch in FAMILIES:
            got, want = res["identity"][arch], identity_oracles[arch]
            assert varied(want["ref"]), f"{arch}: tokens do not vary"
            assert got == want["ref"], f"{arch} diverged on mesh"
            assert got == want["jax"], \
                f"{arch}: mesh tokens differ from the JAX engine's"


#: how far the (4, 2) mesh's float32 logits may sit from the meshless
#: ones: a row-parallel sum over two halves rounds differently
TP_LOGIT_TOL = 1e-4


def test_sharded_engine_tensor_parallel_mesh(eight):
    """A (4, 2) data x model mesh (the Mensa cluster TP templates on the
    weights, KV heads split) serves the meshless engine's tokens and the
    JAX engine's on the pure-attention stack; its logits sit within
    ``TP_LOGIT_TOL``; each rank's cache shards are contiguous."""
    want = oracles(lively_model("qwen3-0.6b"), tp_trace, **TP_KW)
    assert varied(want["ref"])
    for res in eight:
        assert res["ranks_agree"]["tp"]
        tp = res["tp"]
        assert tp["logits_max_diff"] <= TP_LOGIT_TOL, tp["logits_max_diff"]
        assert tp["mesh"] == want["ref"], "TP mesh tokens diverged"
        assert tp["mesh"] == want["jax"], "TP mesh tokens differ from JAX's"
        assert tp["contiguous"]
