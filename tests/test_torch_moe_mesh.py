"""The two MoE archs served on a (data, model) mesh, and the sharded build
that lets a mesh hold them at full depth.

* ``launch.shardings.local_parts`` — each rank's part of every parameter,
  drawn whole and cut at once — for every arch at reduced size, with the
  full config deciding the layout (the 2-D split of phi3.5-moe and
  llama4-scout), at every rank coordinate of (1, 4) and (2, 2): each part
  is the slice of ``build_model``'s tensor that DTensor's chunking gives
  that rank, bit for bit, and the parts tile the whole.  No process group.
* One set of 4 gloo ranks (``test_torch_distributed.start_ranks``) serves
  reduced phi3.5-moe and llama4-scout, float32, on lively weights, at the
  full configs' capacity factor (a decode tick drops assignments), with
  paged KV, the prefix cache and a chunked long prompt, on (1, 4) and
  (2, 2) through ``build_engine(model, mesh=, plan_cfg=get_config(arch))``,
  laid out as the full config lays the weights out (on (2, 2) every dense
  weight split over ``data`` too, as on the cards at full depth); this
  process serves the same trace on the same weights through the port's
  meshless engine and the JAX package's, and the greedy tokens of all
  three must agree.  The same ranks build reduced phi3.5-moe through
  ``build_engine(mesh=)`` from a seed (each rank drawing its own shards):
  its parameters are ``build_model``'s bit for bit and its tokens a
  meshless ``build_engine``'s with the same seed; an engine refuses a model
  laid out by other specs.
"""
import itertools
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset  # noqa: E402

from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402

from test_torch_distributed import (float32_config, jax_run,  # noqa: E402
                                    lively_model, start_ranks, tokens,
                                    varied)

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
MESHES = ((1, 4), (2, 2))
AXES = ("data", "model")
SEED = 3
WORLD = 4
#: the dense weights a >20B arch's layout splits over both mesh axes
DENSE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _mesh(dp: int, mp: int):
    """The axis names and sizes ``to_placements`` reads of a mesh."""
    sizes = (dp, mp)
    return SimpleNamespace(mesh_dim_names=AXES, size=lambda m: sizes[m])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_local_parts_are_build_models_slices(arch):
    """Every rank's part of every parameter is the slice DTensor's own
    chunking gives it (``_compute_local_shape_and_global_offset``) of
    ``build_model(cfg, "cpu", seed)``'s tensor, bit for bit, in its dtype,
    dense; and over the mesh the parts cover each element once a replica
    (the product of the mesh dims that do not split it)."""
    cfg = reduced_config(arch)
    whole = {n: p.detach() for n, p in
             build_model(cfg, device="cpu", seed=SEED).named_parameters()}
    meta = Model(cfg, "meta")
    specs = sh.param_specs(get_config(arch), meta, "tp")
    split_2d = 0
    for shape in MESHES:
        mesh = _mesh(*shape)
        placements = {n: sh.to_placements(s, mesh) for n, s in specs.items()}
        seen = {n: torch.zeros(w.shape, dtype=torch.int32)
                for n, w in whole.items()}
        for coords in itertools.product(*map(range, shape)):
            parts = sh.local_parts(meta, SEED, placements, shape, coords,
                                   "cpu")
            assert parts.keys() == whole.keys()
            for name, part in parts.items():
                local, offset = _compute_local_shape_and_global_offset(
                    whole[name].shape, shape, list(coords), placements[name])
                at = tuple(slice(o, o + n) for o, n in zip(offset, local))
                assert part.shape == local, name
                assert part.dtype == whole[name].dtype, name
                assert part.is_contiguous(), name
                assert torch.equal(_bits(part), _bits(whole[name][at])), \
                    f"{name} at {coords} of {shape}"
                seen[name][at] += 1
        for name, count in seen.items():
            replicas = int(np.prod([n for n, p in zip(shape,
                                                      placements[name])
                                    if isinstance(p, Replicate)]))
            assert bool((count == replicas).all()), f"{name} on {shape}"
            split_2d += all(not isinstance(p, Replicate)
                            for p in placements[name])
    if get_config(arch).param_count() > 20e9:
        assert split_2d, "the 2-D layout splits some parameter on both axes"


def test_local_parts_refuse_a_parameter_init_leaves_out():
    """A parameter the init never hands to the sink would stay on ``meta``
    in a sharded build: ``local_parts`` raises."""
    cfg = reduced_config("qwen3-0.6b")
    meta = Model(cfg, "meta")
    meta.extra = torch.nn.Parameter(torch.empty(3, device="meta"))
    specs = sh.param_specs(cfg, meta, "tp")
    placements = {n: sh.to_placements(s, _mesh(1, 1))
                  for n, s in specs.items()}
    with pytest.raises(RuntimeError, match="extra"):
        sh.local_parts(meta, SEED, placements, (1, 1), (0, 0), "cpu")


# ------------------------------------------------------------------- ranks
#: the serve: 4 slots, one bucket of 32, chunks of 32, blocks of 8
SERVE_KW = dict(slots=4, max_len=128, min_bucket=32, max_bucket=32,
                prefill_chunk=32, kv_block_size=8)
#: the same geometry as the engines take it
ENGINE_KW = dict(slots=4, max_len=128, buckets=(32,), prefill_chunk=32,
                 kv_block_size=8)


def moe_config(arch: str):
    """The reduced float32 config at the full config's capacity factor:
    at 4 slots a decode tick keeps only an expert's first assignments."""
    return float32_config(arch).replace(
        moe_capacity=get_config(arch).moe_capacity)


def trace(cls, vocab: int) -> list:
    """Short prompts, one past the largest bucket (chunked), and two that
    share a 20-token prefix (a prefix hit, paged)."""
    rng = np.random.RandomState(11)
    shared = rng.randint(1, vocab, 20).tolist()
    reqs = [cls(rid=i, prompt=rng.randint(1, vocab, n).tolist(),
                max_new_tokens=6) for i, n in enumerate((5, 13, 70))]
    return reqs + [cls(rid=3 + i, prompt=shared
                       + rng.randint(1, vocab, n).tolist(), max_new_tokens=6)
                   for i, n in enumerate((4, 9))]


def serve(engine, cls, vocab: int) -> list:
    """The trace in two runs, so the shared prefix is published before
    the last request arrives."""
    reqs = trace(cls, vocab)
    return tokens(engine.run(reqs[:-1]) + engine.run(reqs[-1:]))


def layout(engine, arch: str, mesh) -> dict:
    """How ``engine`` lays its weights out: whether as the full config's
    specs (``laid_out(layout_cfg=get_config(arch))``), the dense (rank-2)
    weights, and those it splits over both mesh axes."""
    from repro_torch.launch.shardings import laid_out
    params = dict(engine.model.named_parameters())
    try:
        full = laid_out(engine.model, mesh, "tp",
                        layout_cfg=get_config(arch))
    except ValueError as err:
        full = str(err)
    return {"full": full,
            "dense": sorted(n for n, p in params.items() if p.dim() == 2
                            and n.rsplit(".", 1)[-1] in DENSE),
            "split_2d": sorted(n for n, p in params.items() if p.dim() == 2
                               and all(isinstance(pl, Shard)
                                       for pl in p.placements))}


def _job(rank: int) -> dict:
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve.engine import ServeEngine
    out: dict = {"serve": {}, "hits": {}, "layout": {}}
    meshes = {f"{dp}x{mp}": make_serve_mesh(dp, mp, device="cpu")
              for dp, mp in MESHES}
    for label, mesh in meshes.items():
        for arch in MOE_ARCHS:
            cfg = moe_config(arch)
            engine = build_engine(cfg, lively_model(arch, cfg), mesh=mesh,
                                  device="cpu", policy="fixed",
                                  plan_cfg=get_config(arch), **SERVE_KW)
            out["serve"][f"{arch} {label}"] = serve(engine, Request,
                                                    cfg.vocab_size)
            out["hits"][f"{arch} {label}"] = (engine.stats.prefix_hits,
                                              engine.stats.prefill_chunks)
            out["layout"][f"{arch} {label}"] = layout(engine, arch, mesh)
    # a seeded build on the mesh, each rank drawing its own shards
    arch = MOE_ARCHS[0]
    cfg = moe_config(arch)
    mesh = meshes["2x2"]
    engine = build_engine(cfg, mesh=mesh, device="cpu", seed=SEED,
                          policy="fixed", plan_cfg=get_config(arch),
                          **SERVE_KW)
    ref = dict(build_model(cfg, device="cpu", seed=SEED).named_parameters())
    out["seeded_bits"] = all(
        torch.equal(_bits(p.full_tensor()), _bits(ref[n].detach()))
        for n, p in engine.model.named_parameters())
    out["seeded_whole_on_no_rank"] = all(
        p.to_local().numel() < p.numel()
        for n, p in engine.model.named_parameters()
        if n.endswith(("w_gate", "w_up", "w_down")) and p.dim() == 3)
    out["seeded"] = serve(engine, Request, cfg.vocab_size)
    out["seeded_layout"] = layout(engine, arch, mesh)
    try:
        ServeEngine(engine.model, mesh=mesh, param_strategy="dp",
                    **ENGINE_KW)
        out["refused"] = ""
    except ValueError as err:
        out["refused"] = str(err)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank set, started first; the oracles are served in this
    process while it runs."""
    wait = start_ranks(Path(tmp_path_factory.mktemp("moe4")), WORLD, _job)
    return wait


@pytest.fixture(scope="module")
def oracles(ranks) -> dict:
    """Each arch's trace without a mesh, on the ranks' weights: the
    port's meshless engine and the JAX engine."""
    from repro.serve.engine import Request as JaxRequest

    from repro_torch.launch.serve import build_engine
    out = {}
    for arch in MOE_ARCHS:
        cfg = moe_config(arch)
        model = lively_model(arch, cfg)
        engine = build_engine(cfg, model, device="cpu", policy="fixed",
                              plan_cfg=get_config(arch), **SERVE_KW)
        ref, first = jax_run(model, lambda c, v: trace(c, v)[:-1],
                             **ENGINE_KW)
        last = tokens(ref.run(trace(JaxRequest, cfg.vocab_size)[-1:]))
        out[arch] = {"port": serve(engine, Request, cfg.vocab_size),
                     "hits": [engine.stats.prefix_hits,
                              engine.stats.prefill_chunks],
                     "jax": first + last}
    # the seeded build's oracle: a meshless build_engine from the seed
    cfg = moe_config(MOE_ARCHS[0])
    out["seeded"] = serve(build_engine(cfg, device="cpu", seed=SEED,
                                       policy="fixed",
                                       plan_cfg=get_config(cfg.name),
                                       **SERVE_KW), Request, cfg.vocab_size)
    return out


@pytest.fixture(scope="module")
def results(ranks, oracles) -> list[dict]:
    return ranks()


@pytest.mark.parametrize("mesh", [f"{dp}x{mp}" for dp, mp in MESHES])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mesh_serves_the_meshless_and_jax_tokens(arch, mesh, results,
                                                     oracles):
    want = oracles[arch]
    assert varied(want["port"]), f"{arch}: tokens do not vary"
    assert want["port"] == want["jax"], \
        f"{arch}: the meshless port parts from the JAX engine"
    for res in results:
        assert res["ranks_agree"]["serve"]
        got = res["serve"][f"{arch} {mesh}"]
        assert got == want["port"], f"{arch} on {mesh}"
        hits, chunks = res["hits"][f"{arch} {mesh}"]
        assert [hits, chunks] == want["hits"]
        assert hits >= 1 and chunks >= 1
        assert_full_layout(res["layout"][f"{arch} {mesh}"], mesh)


def assert_full_layout(got: dict, mesh: str) -> None:
    """Laid out as the full config lays the weights out; on (2, 2) that
    splits every dense weight over both axes (``dense_2d``)."""
    assert got["full"] is True, got["full"]
    assert got["dense"], "no dense weight"
    if mesh == "2x2":
        one_axis = sorted(set(got["dense"]) - set(got["split_2d"]))
        assert got["split_2d"] == got["dense"], \
            f"dense weights split over one axis only: {one_axis}"


def test_seeded_mesh_build_is_build_models(results, oracles):
    """``build_engine(mesh=)`` with a seed: each rank holds a part of
    every expert bank, the parameters are ``build_model``'s bit for bit,
    and the tokens a meshless ``build_engine``'s with the same seed."""
    for res in results:
        assert res["seeded_bits"]
        assert res["seeded_whole_on_no_rank"]
        assert res["seeded"] == oracles["seeded"]
        assert_full_layout(res["seeded_layout"], "2x2")


def test_engine_refuses_a_model_laid_out_otherwise(results):
    for res in results:
        assert "laid out as" in res["refused"]
