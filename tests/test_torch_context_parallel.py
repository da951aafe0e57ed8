"""Context parallelism on gloo ranks on the CPU: ``Model.prefill`` and
``decode_step`` on states laid out by ``launch.shardings.state_specs`` —
each KV cache's sequence split over ``model`` (the window's rings too),
the recurrent states' width over ``model``, the batch over ``data`` —
against the meshless port on the same rank and the JAX model in this
process.

One set of 4 ranks (``test_torch_distributed.start_ranks``) runs every
case: reduced qwen3-0.6b, recurrentgemma-2b (3 layers: rec, rec, local;
prompts past its 16-token window and decode past them),
falcon-mamba-7b and seamless-m4t-medium (with its encoder's memory), in
float32, on (1, 4), (2, 2) and (4, 1) meshes.  A cache of ``MAX_LEN`` =
46 slots splits unevenly 4 ways (12, 12, 12, 10), and the prompts' lengths
end inside a shard and exactly at a boundary (12, 24).  Each run is a
right-padded one-shot prefill and 8 greedy decode steps with row
``FROZEN`` frozen (``active`` False) at step ``FROZEN_STEP``:

- greedy tokens equal to the meshless port's and the JAX model's;
- float32 logits within ``CP_LOGIT_TOL`` of the meshless port's (a share
  of their largest magnitude);
- each rank's shard of every cache and recurrent state, after the prefill
  and after the last step, within ``CP_LOGIT_TOL`` of the meshless
  state's slice (DTensor's own chunking), and the frozen row's shards bit
  for bit unchanged by its frozen step;
- the sequence-split route (``spmd.context_attention``) and its ``model``
  all-reduces run where ``model`` spans 2 or more ranks, two all-reduces
  an attention layer a decode step; on (4, 1) neither runs: a ``model``
  axis of 1 takes the meshless attention functions.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import layout, to_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

from test_torch_distributed import start_ranks  # noqa: E402

ARCHS = ("qwen3-0.6b", "recurrentgemma-2b", "falcon-mamba-7b",
         "seamless-m4t-medium")
#: how far each arch's weights are scaled off the init, so that every
#: row's greedy tokens vary over these prompts (recurrentgemma's repeat
#: one token a row at 1.0) while the port's stay the JAX model's
GAINS = {"qwen3-0.6b": 3.0, "recurrentgemma-2b": 2.0,
         "falcon-mamba-7b": 2.0, "seamless-m4t-medium": 2.0}
MESHES = ((1, 4), (2, 2), (4, 1))
AXES = ("data", "model")
WORLD = 4
B, S, SM, MAX_LEN = 4, 24, 10, 46
LENS = (12, 7, 24, 17)
STEPS, FROZEN, FROZEN_STEP = 8, 1, 3
#: a mesh run's float32 logits and states against the meshless run's, as a
#: share of the meshless tensor's largest magnitude: the same sums split
#: over the ranks (row-parallel products, the partial softmaxes) in other
#: orders.  The attention archs part by at most 1.3e-6; falcon-mamba, whose
#: width-split products take no context-parallel route, by 1.2e-5 on (1, 4)
CP_LOGIT_TOL = 3e-5


def _config(arch: str):
    cfg = reduced_config(arch)
    return cfg.replace(num_layers=max(2, len(cfg.block_pattern)),
                       compute_dtype="float32")


def _model(arch: str):
    """The seed-0 float32 model with random norm scales and the other
    weights times ``GAINS[arch]`` (the RG-LRU's ``lambda`` kept): the same
    weights on every rank and in this process."""
    model = build_model(_config(arch), device="cpu", seed=0)
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


def _inputs(cfg) -> dict:
    """Right-padded prompts (B, S) and, for an encoder-decoder, source
    embeddings (B, SM, D), from a numpy seed."""
    rng = np.random.RandomState(11)
    toks = rng.randint(1, cfg.vocab_size, (B, S)).astype(np.int32)
    for r, n in enumerate(LENS):
        toks[r, n:] = 0
    out = {"tokens": toks, "length": np.asarray(LENS, np.int32)}
    if cfg.is_encdec:
        out["src"] = rng.normal(0, 1, (B, SM, cfg.d_model)) \
            .astype(np.float32)
    return out


def _active(step: int) -> np.ndarray:
    return np.asarray([not (r == FROZEN and step == FROZEN_STEP)
                       for r in range(B)])


# --------------------------------------------------------------- the ranks
def _state_tensors(states) -> list:
    """Every tensor of the states, layer by layer, in a fixed order."""
    out = []
    for st in states:
        out += list(st.kv) if st.kv is not None \
            else [st.rec[k] for k in sorted(st.rec)]
    return out


def _shard_of(t, like) -> torch.Tensor:
    """The slice of the whole ``t`` that ``like`` (a DTensor) holds on
    this rank."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        tuple(like.shape), like.device_mesh, like.placements)
    for dim, (n, lo) in enumerate(zip(shape, offset)):
        t = t.narrow(dim, lo, n)
    return t


def _serve(model, mesh=None) -> dict:
    """Prefill and ``STEPS`` greedy decode steps of ``_inputs``: the
    tokens, the logits, the states after the prefill and at the end, and
    (on a mesh) whether the frozen row's shards kept their bits."""
    import torch.distributed as dist

    from repro_torch.launch import shardings as sh
    cfg = model.cfg
    inp = _inputs(cfg)

    def put(a: np.ndarray, spec: tuple):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t if mesh is None else sh.local_part(
            t, mesh, sh.to_placements(spec, mesh))

    def whole(t):
        return t.full_tensor() if mesh is not None else t

    bax = None if mesh is None else sh.batch_axis(mesh, B)
    states = model.init_states(B, MAX_LEN)
    if mesh is not None:
        model = sh.distribute_models([model], mesh)[0]
        states = sh.place_states(
            states, sh.state_specs(model, mesh, B, MAX_LEN), mesh)
    memory = None if "src" not in inp \
        else model.encode(put(inp["src"], (bax, None, None)))
    logits, states = model.prefill(put(inp["tokens"], (bax, None)), states,
                                   length=put(inp["length"], (bax,)),
                                   memory=memory)
    out = {"logits": [whole(logits)[:, 0].clone()],
           "prefilled": [t.clone() for t in _state_tensors(states)]}
    tok = whole(logits).argmax(-1).to(torch.int32)          # (B, 1)
    pos = torch.as_tensor(inp["length"], dtype=torch.int32)
    toks, frozen_kept = [tok[:, 0].tolist()], True
    for step in range(STEPS):
        active = torch.from_numpy(_active(step))
        before = [t.to_local().clone() if mesh is not None else t.clone()
                  for t in _state_tensors(states)]
        logits, states = model.decode_step(
            put(tok.numpy(), (bax, None)), states, put(pos.numpy(), (bax,)),
            active=put(active.numpy(), (bax,)), memory=memory)
        if not active.all() and mesh is not None:
            rows = _frozen_rows(states, mesh)
            frozen_kept &= all(
                torch.equal(a[r], t.to_local()[r])
                for a, t, r in zip(before, _state_tensors(states), rows)
                if r is not None)
        nxt = whole(logits).argmax(-1).to(torch.int32)
        out["logits"].append(whole(logits)[:, 0].clone())
        tok = torch.where(active[:, None], nxt, tok)
        pos = pos + active.to(torch.int32)
        toks.append(tok[:, 0].tolist())
    out.update(tokens=toks, final=_state_tensors(states),
               frozen_kept=frozen_kept)
    if mesh is not None:
        dist.barrier()
    return out


def _frozen_rows(states, mesh) -> list:
    """For each state tensor, the local row of ``FROZEN`` on this rank, or
    None where this rank does not hold it."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    rows = []
    for t in _state_tensors(states):
        shape, offset = compute_local_shape_and_global_offset(
            tuple(t.shape), mesh, t.placements)
        r = FROZEN - offset[0]
        rows.append(r if 0 <= r < shape[0] else None)
    return rows


def _refuses_a_chunk(model, mesh) -> bool:
    """A chunked prefill (``offset``) on a sequence-split cache raises
    ``NotImplementedError``: the reference's serving specs lay out no such
    resume."""
    from repro_torch.launch import shardings as sh
    model = sh.distribute_models([model], mesh)[0]
    states = sh.place_states(model.init_states(B, MAX_LEN),
                             sh.state_specs(model, mesh, B, MAX_LEN), mesh)
    bax = sh.batch_axis(mesh, B)

    def put(t, spec):
        return sh.local_part(t, mesh, sh.to_placements(spec, mesh))

    ones = put(torch.ones(B, dtype=torch.int32), (bax,))
    try:
        model.prefill(put(torch.ones(B, 4, dtype=torch.int32), (bax, None)),
                      states, length=ones, offset=ones)
    except NotImplementedError as e:
        return "chunked prefill" in str(e)
    return False


def _max_diff(a, b) -> float:
    """The largest difference of ``a`` from ``b`` as a share of ``b``'s
    largest magnitude (0 for an empty shard)."""
    if not a.numel():
        return 0.0
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _job(rank: int) -> dict:
    """Every arch on every mesh against the meshless run on this rank:
    (tokens, worst logit difference, worst state difference, frozen row
    kept, context-parallel calls and ``model`` all-reduces a run)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import spmd
    calls = {"cp": 0, "model_all_reduce": 0}
    cp, all_reduce = spmd.context_attention, dist.all_reduce
    groups = set()

    def counted_cp(*args, **kw):
        calls["cp"] += 1
        return cp(*args, **kw)

    def counted_all_reduce(t, *args, group=None, **kw):
        if group is not None and group in groups:
            calls["model_all_reduce"] += 1
        return all_reduce(t, *args, group=group, **kw)

    spmd.context_attention = counted_cp
    dist.all_reduce = counted_all_reduce
    out = {}
    with torch.no_grad():
        for arch in ARCHS:
            model = _model(arch)
            want = _serve(model)
            out[f"{arch} meshless"] = {"tokens": want["tokens"]}
            for dp, mp in MESHES:
                mesh = make_host_mesh((dp, mp), AXES, device="cpu")
                groups.add(mesh.get_group("model"))
                for k in calls:
                    calls[k] = 0
                got = _serve(model, mesh)
                states = max(
                    _max_diff(g.to_local(), _shard_of(w, g))
                    for when in ("prefilled", "final")
                    for g, w in zip(got[when], want[when]))
                dense = all(t.to_local().is_contiguous()
                            for t in got["final"])
                out[f"{arch} {dp}x{mp}"] = {
                    "tokens": got["tokens"],
                    "logits": max(_max_diff(g, w) for g, w in
                                  zip(got["logits"], want["logits"])),
                    "states": states, "frozen_kept": got["frozen_kept"],
                    "contiguous": dense, **calls}
            if arch == "qwen3-0.6b":
                out["refuses a chunk"] = _refuses_a_chunk(
                    model, make_host_mesh((1, 4), AXES, device="cpu"))
    return out


# --------------------------------------------------------------- this side
def _jax_tokens(arch: str) -> list:
    """The JAX model's greedy tokens of the same run on the same weights."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config as jax_reduced
    from repro.models import build_model as jax_build
    model = _model(arch)
    cfg = model.cfg
    jm = jax_build(jax_reduced(arch).replace(num_layers=cfg.num_layers,
                                             compute_dtype="float32"))
    jp = jax.tree.map(jnp.asarray, to_jax_params(model))
    inp = _inputs(cfg)
    js = jm.init_states(B, MAX_LEN)
    src = jnp.asarray(inp["src"]) if "src" in inp else None
    logits, js, memory = jm.prefill(jp, jnp.asarray(inp["tokens"]), js,
                                    src_embeds=src,
                                    length=jnp.asarray(inp["length"]))
    tok = np.asarray(logits.argmax(-1), np.int32)
    pos = np.asarray(inp["length"], np.int32)
    toks = [tok[:, 0].tolist()]
    for step in range(STEPS):
        active = _active(step)
        logits, js = jm.decode_step(jp, jnp.asarray(tok), js,
                                    jnp.asarray(pos), memory,
                                    active=jnp.asarray(active))
        nxt = np.asarray(logits.argmax(-1), np.int32)
        tok = np.where(active[:, None], nxt, tok)
        pos = pos + active.astype(np.int32)
        toks.append(tok[:, 0].tolist())
    return toks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list[dict]:
    """The 4-rank set, started first; while it runs this process computes
    the JAX tokens."""
    pytest.importorskip("jax")
    wait = start_ranks(Path(tmp_path_factory.mktemp("cp4")), WORLD, _job)
    jax_toks = {arch: _jax_tokens(arch) for arch in ARCHS}
    return wait(), jax_toks


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_context_parallel_serve(ranks, arch, mesh):
    results, jax_toks = ranks
    dp, mp = mesh
    attn_layers = sum(k in ("attn", "local", "dec")
                      for k in _config(arch).layer_kinds)
    for res in results:
        want = res[f"{arch} meshless"]["tokens"]
        got = res[f"{arch} {dp}x{mp}"]
        assert any(len(set(row)) > 1 for row in zip(*want)), \
            f"{arch}: greedy tokens do not vary"
        assert want == jax_toks[arch], "meshless port differs from JAX"
        assert got["tokens"] == want, f"{arch} {dp}x{mp} tokens diverged"
        assert got["logits"] <= CP_LOGIT_TOL, got["logits"]
        assert got["states"] <= CP_LOGIT_TOL, got["states"]
        assert got["frozen_kept"]
        assert got["contiguous"]
        if mp == 1 or not attn_layers:
            assert got["cp"] == 0 and got["model_all_reduce"] == 0
        else:
            # one prefill and STEPS decode calls a cached attention layer;
            # a decode call combines with a MAX and a SUM all-reduce
            assert got["cp"] == attn_layers * (1 + STEPS)
            assert got["model_all_reduce"] == 2 * attn_layers * STEPS


def test_a_chunk_on_a_sequence_split_cache_is_refused(ranks):
    """``prefill(offset=)`` on ``state_specs``' layouts raises a plain
    ``NotImplementedError`` that says so, on every rank."""
    results, _ = ranks
    assert all(res["refuses a chunk"] for res in results)
