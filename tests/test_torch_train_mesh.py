"""The port's train step over a (data, model) mesh on gloo ranks on the
CPU, against the meshless port and the JAX package's single-device step
(the reference's own sharded step fails under jax 0.9.0, so it is no
oracle).  One set of 8 ranks runs every case of this file
(``test_torch_distributed.start_ranks``: a file store under the test's
directory, a bound on each collective and on the set), in float32 at
reduced size, batch 8 x 32, while this process computes the meshless port's
and the JAX package's steps from the same weights:

- three train steps of qwen3-0.6b on (4, 2), (8, 1) and (2, 4), and of
  recurrentgemma-2b, falcon-mamba-7b and phi3.5-moe on (4, 2) — the last
  by its capacity route at a capacity that drops tokens, by its dropless
  ``ragged`` route, and by the capacity route in 2 microbatches: loss and
  grad norm within 1e-5 of the meshless step, moments and parameters by
  ``tests/test_torch_trainer.py``'s rule, and qwen3's and phi3.5-moe's
  also against the JAX step (the meshless steps of the other two are held
  to JAX's by ``tests/test_torch_trainer.py`` and
  ``tests/test_torch_train.py``); the moments keep the parameters'
  placements;
- a checkpoint saved on (4, 2) restores on (2, 4) bit for bit, in the new
  placements (``restore_state`` of the JAX layout, and ``restore(...,
  shardings=)`` of a flat tree);
- ``compressed_psum`` on the (8, 1) mesh against the JAX ``compressed_psum``
  under ``jax.vmap(axis_name="data")`` over the same 8 shards, and
  ``make_compressed_grad_fn`` against per-shard JAX ``value_and_grad``
  and that psum;
- the vocab-sharded cross-entropy moves row sums, never the logits.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.train import grad as ref_grad  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro_torch.bridge import to_jax_params, to_jax_tree  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import optim  # noqa: E402

from test_torch_distributed import start_ranks  # noqa: E402
from test_torch_train import (LOSS_RTOL, _assert_trees, _batch,  # noqa: E402
                              _cfgs, _torch)

MOE = "phi3.5-moe-42b-a6.6b"
#: what each run trains: (arch, config overrides, microbatches).  The
#: capacity runs take 0.5 (an expert keeps 64 of a call's 512 assignments,
#: 32 of a microbatch's 256), so the queue positions' offsets across the
#: data ranks decide which assignments drop
RUNS = {"qwen3-0.6b": ("qwen3-0.6b", {}, 1),
        "recurrentgemma-2b": ("recurrentgemma-2b", {}, 1),
        "falcon-mamba-7b": ("falcon-mamba-7b", {}, 1),
        "moe-capacity": (MOE, {"moe_capacity": 0.5}, 1),
        "moe-ragged": (MOE, {"moe_impl": "ragged"}, 1),
        "moe-capacity-accum2": (MOE, {"moe_capacity": 0.5}, 2)}
CASES = (("qwen3-0.6b", (4, 2)), ("qwen3-0.6b", (8, 1)),
         ("qwen3-0.6b", (2, 4)), ("recurrentgemma-2b", (4, 2)),
         ("falcon-mamba-7b", (4, 2)), ("moe-capacity", (4, 2)),
         ("moe-ragged", (4, 2)), ("moe-capacity-accum2", (4, 2)))
#: the runs whose mesh steps are also held to the JAX step here
JAX_RUNS = ("qwen3-0.6b", "moe-capacity", "moe-ragged",
            "moe-capacity-accum2")
AXES = ("data", "model")
B, S, STEPS = 8, 32, 3
#: ``test_torch_trainer._step_pair``'s schedule
SCHEDULE = dict(base_lr=1e-2, warmup=1, total=10)
#: a mesh step's loss and grad norm against the meshless step's: the same
#: sums over other shards, in float32 (they part by ~1e-7 relative)
MESH_RTOL = 1e-5
WORLD = 8


def _depth(arch: str) -> dict:
    """Each arch at the depth of its block pattern, at least 2 layers
    (recurrentgemma: rec, rec, local)."""
    return {"num_layers": max(2, len(_cfgs(arch)[1].block_pattern))}


def _case_id(case) -> str:
    run, (dp, mp) = case
    return f"{run}-{dp}x{mp}"


# --------------------------------------------------------------- the ranks
def _model(arch: str, where: Path, **overrides):
    """The reduced float32 train model of ``arch`` (with ``overrides``)
    with the weights this process saved."""
    cfg = _cfgs(arch, **_depth(arch), **overrides)[1]
    model = build_model(cfg, device="cpu", train=True)
    init = np.load(where / f"init_{arch}.npz")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[k]))
    return model


def _placed_batch(cfg, mesh, step: int) -> dict:
    from repro_torch.launch import shardings as sh
    specs = sh.batch_specs(cfg, mesh, B)
    return {k: sh.local_part(v, mesh, sh.to_placements(specs[k], mesh))
            for k, v in _torch(_batch(cfg, step=step, b=B, s=S)).items()}


def _train(model, mesh, steps: int, accum: int = 1):
    """``steps`` steps of the mesh model: (params, opt state, metrics)."""
    from repro_torch.train import make_train_step
    params = dict(model.named_parameters())
    state = optim.adamw_init(params)
    step = make_train_step(model, accum_steps=accum,
                           schedule=optim.cosine_schedule(**SCHEDULE))
    metrics = []
    for i in range(steps):
        params, state, m = step(params, state,
                                _placed_batch(model.cfg, mesh, i))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, state, metrics


def _train_case(rank: int, where: Path, run: str, shape) -> dict:
    from torch.distributed.tensor import Shard

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import distribute_models
    from repro_torch.models import spmd
    arch, overrides, accum = RUNS[run]
    mesh = make_host_mesh(shape, AXES, device="cpu")
    model = distribute_models([_model(arch, where, **overrides)], mesh)[0]
    params, state, metrics = _train(model, mesh, STEPS, accum)
    whole = {}
    for kind, tree in (("param", params), ("mu", state.mu),
                       ("nu", state.nu)):
        for k, t in tree.items():
            whole[f"{kind}/{k}"] = spmd.whole(t).detach().numpy()
    if rank == 0:
        np.savez(where / f"out_{run}_{shape[0]}x{shape[1]}.npz", **whole)
    return {"metrics": metrics,
            "placements_kept": all(
                state.mu[k].placements == p.placements
                == state.nu[k].placements for k, p in params.items()),
            "split_on_model": sum(
                isinstance(p.placements[1], Shard) for p in params.values())}


def _ckpt_case(rank: int, where: Path) -> dict:
    """One step on (4, 2), saved; restored on (2, 4) into a model laid
    out there, through the train CLI's ``state_tree``/``restore_state``
    (the JAX layout) and through ``restore(..., shardings=)``."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import distribute_models, local_part
    from repro_torch.launch.train import restore_state, state_tree
    from repro_torch.models import spmd
    arch = "qwen3-0.6b"
    m42 = make_host_mesh((4, 2), AXES, device="cpu")
    m24 = make_host_mesh((2, 4), AXES, device="cpu")
    model = distribute_models([_model(arch, where)], m42)[0]
    params, state, _ = _train(model, m42, 1)
    ckpt.save(where / "ckpt", 1, state_tree(model, params, state))
    ckpt.save(where / "flat", 1, {"params": params, "mu": state.mu})
    saved = {k: spmd.whole(p).detach() for k, p in params.items()}
    saved_mu = {k: spmd.whole(m) for k, m in state.mu.items()}

    other = distribute_models([_model(arch, where)], m24)[0]
    got, got_state = restore_state(other, where / "ckpt", 1)
    want = dict(other.named_parameters())

    def exact(t, whole, like) -> bool:
        return t.placements == like.placements and torch.equal(
            t.to_local(), local_part(whole, m24, like.placements).to_local())

    meta = {k: torch.empty(p.shape, device="meta") for k, p in saved.items()}
    flat = ckpt.restore(where / "flat", 1, {"params": meta, "mu": meta},
                        shardings={"params": {k: (m24, p.placements)
                                              for k, p in want.items()},
                                   "mu": {k: (m24, p.placements)
                                          for k, p in want.items()}})
    return {
        "params_exact": all(exact(got[k], saved[k], want[k])
                            for k in saved),
        "moments_exact": all(exact(got_state.mu[k], saved_mu[k], want[k])
                             for k in saved),
        "step": int(got_state.step),
        "shards_changed": got["embed"].device_mesh == m24 and any(
            params[k].to_local().shape != got[k].to_local().shape
            for k in saved),
        "shardings_exact": all(
            exact(flat["params"][k], saved[k], want[k])
            and exact(flat["mu"][k], saved_mu[k], want[k]) for k in saved),
    }


def _psum_inputs():
    """Eight shards of two gradient leaves and their error buffers."""
    rng = np.random.RandomState(0)
    g = {"w": rng.standard_normal((WORLD, 5, 7)).astype(np.float32),
         "b": (3 * rng.standard_normal((WORLD, 3))).astype(np.float32)}
    e = {k: (1e-2 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in g.items()}
    return g, e


def _psum_case(rank: int, where: Path) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import grad
    mesh = make_host_mesh((WORLD, 1), AXES, device="cpu")
    g, e = _psum_inputs()
    mean, err = grad.compressed_psum(
        {k: torch.from_numpy(v[rank]) for k, v in g.items()},
        {k: torch.from_numpy(v[rank]) for k, v in e.items()}, mesh)
    np.savez(where / f"psum_{rank}.npz",
             **{f"mean/{k}": v.numpy() for k, v in mean.items()},
             **{f"err/{k}": v.numpy() for k, v in err.items()})
    return {"dtypes": sorted({str(v.dtype) for v in [*mean.values(),
                                                     *err.values()]})}


def _grad_fn_case(rank: int, where: Path) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import grad
    mesh = make_host_mesh((WORLD, 1), AXES, device="cpu")
    model = _model("qwen3-0.6b", where)
    params = dict(model.named_parameters())
    fn = grad.make_compressed_grad_fn(lambda p, b: model.loss(b)[0], mesh)
    loss, grads, err = fn(params, grad.init_error_state(params),
                          _torch(_batch(model.cfg, step=0, b=B, s=S)))
    np.savez(where / f"gradfn_{rank}.npz",
             **{f"grad/{k}": v.numpy() for k, v in grads.items()},
             **{f"err/{k}": v.numpy() for k, v in err.items()})
    return {"loss": float(loss)}


def _ce_case(rank: int, where: Path) -> dict:
    """The vocab-sharded loss of random logits on (4, 2), under the dry
    run's collective counter."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import local_part
    from repro_torch.models.common import vocab_cross_entropy
    mesh = make_host_mesh((4, 2), AXES, device="cpu")
    rng = np.random.RandomState(1)
    logits = torch.from_numpy((3 * rng.standard_normal((B, S, 64)))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 60, (B, S)).astype(np.int32))
    x = local_part(logits, mesh, (Shard(0), Shard(2)))
    lab = local_part(labels, mesh, (Shard(0), Replicate()))
    with StepCounter() as comm:
        loss = vocab_cross_entropy(x, lab, None, 60)
    return {"loss": float(loss.full_tensor()),
            "kinds": sorted(comm.counts),
            "moved": sum(comm.result.values()),
            "logits_bytes": logits.numel() * 4}


def _too_few_ranks() -> str:
    from repro_torch.launch.mesh import make_host_mesh
    try:
        make_host_mesh((4, 4), AXES, device="cpu")
    except RuntimeError as e:
        return str(e)
    return ""


def _mesh_job(rank: int, where: str) -> dict:
    where = Path(where)
    out = {_case_id(c): _train_case(rank, where, *c) for c in CASES}
    out["ckpt"] = _ckpt_case(rank, where)
    out["psum"] = _psum_case(rank, where)
    out["grad_fn"] = _grad_fn_case(rank, where)
    out["ce"] = _ce_case(rank, where)
    out["too_few"] = _too_few_ranks()
    return out


# ------------------------------------------------------------ this process
def _pair(run: str):
    """The port's seed-0 train model of ``run`` at ``_depth`` and its
    step, the same weights as the JAX package's tree
    (``bridge.to_jax_params``), its model, and for ``JAX_RUNS`` the jitted
    JAX step (``test_torch_trainer._step_pair``'s, from the port's
    weights)."""
    from repro.models import build_model as jax_build
    from repro.train.trainer import make_train_step as ref_train_step

    from repro_torch.train import make_train_step
    arch, overrides, accum = RUNS[run]
    jcfg, tcfg = _cfgs(arch, **_depth(arch), **overrides)
    tm = build_model(tcfg, device="cpu", seed=0, train=True)
    tree = jax.tree.map(np.array, to_jax_params(tm))  # a copy: tm steps
    jm = jax_build(jcfg)
    jstep = jax.jit(ref_train_step(
        jm, accum_steps=accum, schedule=ref_optim.cosine_schedule(
            **SCHEDULE))) if run in JAX_RUNS else None
    tstep = make_train_step(tm, accum_steps=accum,
                            schedule=optim.cosine_schedule(**SCHEDULE))
    return jm, tree, tcfg, jstep, tm, tstep


def _meshless_and_jax(pair) -> dict:
    """Three steps of the meshless port and, for ``JAX_RUNS``, of the JAX
    step, from the same weights, and the port model for the JAX layout.
    (recurrentgemma-2b's and falcon-mamba-7b's meshless steps are held to
    JAX's by ``test_torch_trainer.py`` and ``test_torch_train.py``.)"""
    jm, tree, tcfg, jstep, tm, tstep = pair
    jp, js = jax.tree.map(jnp.asarray, tree), ref_optim.adamw_init(tree)
    tp = dict(tm.named_parameters())
    ts = optim.adamw_init(tp)
    port, ref = [], []
    for step in range(STEPS):
        batch = _batch(tcfg, step=step, b=B, s=S)
        tp, ts, tmet = tstep(tp, ts, _torch(batch))
        port.append({k: float(v) for k, v in tmet.items()})
        if jstep is not None:
            jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
            ref.append({k: float(v) for k, v in jmet.items()})
    return {"model": tm, "tree": tree, "port": port, "jax": ref,
            "port_state": (to_jax_params(tm), to_jax_tree(tm, ts.mu),
                           to_jax_tree(tm, ts.nu)),
            "jax_state": (jp, js.mu, js.nu), "jm": jm, "cfg": tcfg}


def _jax_grad_fn(arch: str, run: dict):
    """JAX ``value_and_grad`` of the loss on each rank's row of the batch,
    and the vmapped ``compressed_psum`` of those gradients from zero
    error: (losses, stacked gradients, means, errors)."""
    jm, tree, tcfg = run["jm"], run["tree"], run["cfg"]
    batch = _batch(tcfg, step=0, b=B, s=S)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b)[0]))
    params = jax.tree.map(jnp.asarray, tree)
    shards = [vg(params, {k: jnp.asarray(v[i:i + 1])
                          for k, v in batch.items()}) for i in range(WORLD)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *[s[1] for s in shards])
    psum = jax.jit(jax.vmap(
        lambda a, b: ref_grad.compressed_psum(a, b, "data"),
        axis_name="data"))
    w_mean, w_err = psum(stacked, jax.tree.map(jnp.zeros_like, stacked))
    return np.array([float(s[0]) for s in shards]), stacked, w_mean, w_err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    where = tmp_path_factory.mktemp("train_mesh")
    pairs = {run: _pair(run) for run in dict.fromkeys(r for r, _ in CASES)}
    for run, pair in pairs.items():   # an arch's runs start alike
        np.savez(where / f"init_{RUNS[run][0]}.npz", **{
            k: p.detach().numpy() for k, p in pair[4].named_parameters()})
    wait = start_ranks(where / "ranks", WORLD, _mesh_job, str(where))
    local = {run: _meshless_and_jax(pair) for run, pair in pairs.items()}
    local["grad_fn"] = _jax_grad_fn("qwen3-0.6b", local["qwen3-0.6b"])
    ranks = wait()
    return where, ranks, local


def _mesh_state(where: Path, case, model):
    run, (dp, mp) = case
    out = np.load(where / f"out_{run}_{dp}x{mp}.npz")

    def tree(kind):
        return to_jax_tree(model, {k: torch.from_numpy(out[f"{kind}/{k}"])
                                   for k, _ in model.named_parameters()})
    return tree("param"), tree("mu"), tree("nu")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_mesh_step_matches_the_meshless_step(runs, case):
    """Loss, grad norm and lr within 1e-5 of the meshless port's at every
    step; the moments within 1e-4 of each leaf's largest entry and the
    parameters within 3 lr a step (``test_three_train_steps_match_jax``'s
    rule: where a gradient lies within float32 noise of 0, AdamW's first
    step, about lr * sign(g), may go either way when a mesh sums it in
    another order)."""
    where, ranks, local = runs
    got = ranks[0][_case_id(case)]["metrics"]
    want = local[case[0]]["port"]
    lr_sum = 0.0
    for step, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=MESH_RTOL,
                                       err_msg=f"step {step} {k}")
        lr_sum += w["lr"]
    params, mu, nu = _mesh_state(where, case, local[case[0]]["model"])
    w_params, w_mu, w_nu = local[case[0]]["port_state"]
    _assert_trees(mu, w_mu, share=1e-4, what="mu")
    _assert_trees(nu, w_nu, share=1e-4, what="nu")
    _assert_trees(params, w_params, share=0.0, floor=3.0 * lr_sum + 1e-7,
                  what="param")


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in JAX_RUNS],
                         ids=_case_id)
def test_mesh_step_matches_the_jax_step(runs, case):
    """The same steps against ``jax.jit(make_train_step(model))`` on one
    device, within ``test_three_train_steps_match_jax``'s tolerances."""
    where, ranks, local = runs
    got = ranks[0][_case_id(case)]["metrics"]
    want = local[case[0]]["jax"]
    lr_sum = 0.0
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"],
                                   rtol=LOSS_RTOL * (step + 1))
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=2e-7)
        lr_sum += w["lr"]
    params, mu, nu = _mesh_state(where, case, local[case[0]]["model"])
    w_params, w_mu, w_nu = local[case[0]]["jax_state"]
    _assert_trees(mu, w_mu, share=1e-4, what="mu")
    _assert_trees(nu, w_nu, share=1e-4, what="nu")
    _assert_trees(params, w_params, share=0.0, floor=3.0 * lr_sum + 1e-7,
                  what="param")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_moments_keep_the_parameters_placements(runs, case):
    """Every rank agrees, the moments are laid out as their parameters,
    and a model axis of 2 or 4 does split parameters (1: none)."""
    _, ranks, _ = runs
    got = ranks[0][_case_id(case)]
    assert ranks[0]["ranks_agree"][_case_id(case)]
    assert got["placements_kept"]
    assert (got["split_on_model"] > 0) == (case[1][1] > 1)


def test_checkpoint_saved_on_one_mesh_restores_on_another(runs):
    """Saved on (4, 2), restored on (2, 4): every parameter and moment
    bit for bit, in the (2, 4) model's placements on its mesh (other
    shards than the saved ones'), the step kept; ``restore(...,
    shardings=)`` of a flat tree alike."""
    _, ranks, _ = runs
    for r in ranks:
        got = r["ckpt"]
        assert got["params_exact"] and got["moments_exact"]
        assert got["shardings_exact"] and got["shards_changed"]
        assert got["step"] == 1


def test_compressed_psum_matches_the_jax_psum(runs):
    """The port's ``compressed_psum`` on 8 gloo ranks against the JAX one
    vmapped over the same 8 shards: equal int8 values (recovered from
    each rank's error, ``round((g + e - e') / scale)``), the mean and
    every rank's error within one float32 ulp of the leaf's largest
    entry; the reference test's bounds (mean within 5% of the exact mean,
    0 < max|e'| <= 1.01 scale)."""
    where, ranks, _ = runs
    g, e = _psum_inputs()
    vm = jax.vmap(lambda a, b: ref_grad.compressed_psum(a, b, "data"),
                  axis_name="data")
    w_mean, w_err = vm({k: jnp.asarray(v) for k, v in g.items()},
                       {k: jnp.asarray(v) for k, v in e.items()})
    assert ranks[0]["psum"]["dtypes"] == ["torch.float32"]
    for r in range(WORLD):
        got = np.load(where / f"psum_{r}.npz")
        for k in g:
            gk = g[k][r] + e[k][r]
            scale = np.abs(g[k] + e[k]).max() / np.float32(127) \
                + np.float32(1e-12)
            mean, err = got[f"mean/{k}"], got[f"err/{k}"]
            ulp = np.spacing(np.float32(np.abs(gk).max()))
            np.testing.assert_allclose(mean, np.asarray(w_mean[k][r]),
                                       rtol=0, atol=ulp)
            np.testing.assert_allclose(err, np.asarray(w_err[k][r]),
                                       rtol=0, atol=ulp)
            np.testing.assert_array_equal(
                np.round((gk - err) / scale),
                np.round((gk - np.asarray(w_err[k][r])) / scale))
            exact = (g[k] + e[k]).mean(axis=0)
            assert np.abs(mean - exact).max() \
                < 0.05 * np.abs(exact).max() + 2 * scale
            assert 0 < np.abs(err).max() <= 1.01 * scale


def test_compressed_grad_fn_matches_jax_per_shard(runs):
    """``make_compressed_grad_fn`` on (8, 1): each rank's row of the batch,
    the loss averaged over the ranks, the compressed mean gradient and
    each rank's error — against JAX ``value_and_grad`` on each shard and
    the vmapped ``compressed_psum``.  The two frameworks' gradients part
    by float32 rounding, which may move each rank's value across one
    quantization step: the mean within one step of the scale (all 8
    ranks' values moved), each error within one step; and the reference
    test's bounds (the mean within 5% of the exact mean, 0 < max|e| <=
    1.01 scale)."""
    where, ranks, local = runs
    tm = local["qwen3-0.6b"]["model"]
    losses, stacked, w_mean, w_err = local["grad_fn"]
    np.testing.assert_allclose(ranks[0]["grad_fn"]["loss"], losses.mean(),
                               rtol=1e-5)
    flat_w = jax.tree_util.tree_flatten_with_path(w_mean)[0]
    for r in range(WORLD):
        got = np.load(where / f"gradfn_{r}.npz")
        g_tree = to_jax_tree(tm, {k: torch.from_numpy(got[f"grad/{k}"])
                                  for k, _ in tm.named_parameters()})
        e_tree = to_jax_tree(tm, {k: torch.from_numpy(got[f"err/{k}"])
                                  for k, _ in tm.named_parameters()})
        gl = dict((jax.tree_util.keystr(p), np.asarray(v)) for p, v in
                  jax.tree_util.tree_flatten_with_path(g_tree)[0])
        el = dict((jax.tree_util.keystr(p), np.asarray(v)) for p, v in
                  jax.tree_util.tree_flatten_with_path(e_tree)[0])
        werr = dict((jax.tree_util.keystr(p), np.asarray(v)) for p, v in
                    jax.tree_util.tree_flatten_with_path(w_err)[0])
        raw = dict((jax.tree_util.keystr(p), np.asarray(v)) for p, v in
                   jax.tree_util.tree_flatten_with_path(stacked)[0])
        for path, want in flat_w:
            key = jax.tree_util.keystr(path)
            want = np.asarray(want[r])
            scale = np.abs(raw[key]).max() / 127 + 1e-12
            np.testing.assert_allclose(gl[key], want, rtol=0,
                                       atol=1.01 * scale, err_msg=key)
            np.testing.assert_allclose(el[key], werr[key][r], rtol=0,
                                       atol=1.01 * scale, err_msg=key)
            exact = raw[key].mean(axis=0)
            assert np.abs(gl[key] - exact).max() \
                <= 0.05 * np.abs(exact).max() + scale, key
            assert np.abs(el[key]).max() <= 1.01 * scale, key


def test_cross_entropy_moves_row_sums_not_logits(runs):
    """The loss of vocab-sharded logits equals the meshless loss, and all
    its collectives together move less than a tenth of the logits (the
    rows' maxima, sums and gold logits), none of them an all-gather."""
    from repro_torch.models.common import cross_entropy_loss
    _, ranks, _ = runs
    rng = np.random.RandomState(1)
    logits = (3 * rng.standard_normal((B, S, 64))).astype(np.float32)
    labels = rng.randint(0, 60, (B, S)).astype(np.int32)
    want = float(cross_entropy_loss(torch.from_numpy(logits[..., :60]),
                                    torch.from_numpy(labels)))
    got = ranks[0]["ce"]
    np.testing.assert_allclose(got["loss"], want, rtol=1e-6)
    assert "all-gather" not in got["kinds"] and "all-reduce" in got["kinds"]
    assert got["moved"] < got["logits_bytes"] / 10


def test_make_host_mesh_refuses_too_few_ranks(runs):
    _, ranks, _ = runs
    assert ranks[0]["too_few"] == "need 16 devices, have 8"
