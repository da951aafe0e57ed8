"""The port's optimizer, train step, pipeline, checkpoints and entry point
against the JAX package on the CPU, at reduced size in float32 (the
functions, the loss and the gradients are in ``tests/test_torch_train.py``,
whose helpers this file shares):

- the optimizer's functions and schedules, the weight-decay mask on the
  JAX layout (stacked and tail leaves of reduced recurrentgemma; the MoE
  archs' routers, banks and nested shared expert), and three
  ``make_train_step`` steps with accum 1 and 2 against the JAX step;
- the copied pipeline and watchdog, checkpoints in both directions (qwen3
  and the two MoE archs), and
  ``train_once``: resume after an injected failure is bit for bit, and its
  losses follow the JAX ``train_once``'s from the same weights; the CLI
  runs, on the card unless told otherwise.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.ckpt import checkpoint as ref_ckpt  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro.train.trainer import make_train_step as ref_train_step  # noqa: E402
from repro_torch.bridge import (decay_mask, from_jax_params,  # noqa: E402
                                to_jax_params, to_jax_tree)
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data.pipeline import (DataConfig,  # noqa: E402
                                       PrefetchingLoader, SyntheticTokens)
from repro_torch.ft.watchdog import (FailureInjector,  # noqa: E402
                                     StepWatchdog, run_with_restarts)
from repro_torch.launch.train import state_tree, train_once  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

from test_torch_train import (LOSS_RTOL, MOE_ARCHS,  # noqa: E402
                              _assert_trees, _batch, _cfgs, _flat, _init,
                              _np, _torch)

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- optimizer
def _rand_tree(seed: int, shapes: dict) -> dict:
    rng = np.random.RandomState(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (4, 3), "v": (5,), "s": ()}


def test_adamw_clip_and_apply_match_jax():
    params = _rand_tree(0, SHAPES)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = ref_optim.adamw_init(jp), optim.adamw_init(tp)
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    for i in range(4):
        g = _rand_tree(10 + i, SHAPES)
        jg, jn = ref_optim.clip_by_global_norm(
            jax.tree.map(jnp.asarray, g), 1.0)
        tg, tn = optim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(
            float(optim.global_norm(tg)), float(ref_optim.global_norm(jg)),
            rtol=1e-6)
        lr = np.float32(0.05)
        ju, js = ref_optim.adamw_update(jg, js, jp, lr=jnp.float32(lr))
        tu, ts = optim.adamw_update(tg, ts, tp, lr=torch.tensor(lr))
        jp = ref_optim.apply_updates(jp, ju)
        tp = optim.apply_updates(tp, tu)
        assert int(ts.step) == int(js.step) == i + 1
        for k in SHAPES:
            for got, want in ((tu[k], ju[k]), (ts.mu[k], js.mu[k]),
                              (ts.nu[k], js.nu[k]), (tp[k], jp[k])):
                np.testing.assert_allclose(_np(got), np.asarray(want),
                                           rtol=2e-6, atol=1e-8)


def test_adamw_decays_what_the_mask_says():
    params = _rand_tree(0, SHAPES)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    zero = {k: torch.zeros_like(v) for k, v in tp.items()}
    lr = torch.tensor(0.5)
    u, _ = optim.adamw_update(zero, optim.adamw_init(tp), tp, lr=lr)
    assert torch.equal(u["w"], -0.5 * 0.1 * tp["w"])      # rank 2: decayed
    assert not u["v"].any() and not u["s"].any()
    u, _ = optim.adamw_update(zero, optim.adamw_init(tp), tp, lr=lr,
                              decay={"w": False, "v": True, "s": False})
    assert not u["w"].any() and torch.equal(u["v"], -0.5 * 0.1 * tp["v"])


def test_sgd_matches_jax():
    params = _rand_tree(1, SHAPES)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = ref_optim.sgd_init(jp), optim.sgd_init(tp)
    for i in range(3):
        g = _rand_tree(20 + i, SHAPES)
        ju, js = ref_optim.sgd_update(jax.tree.map(jnp.asarray, g), js, jp,
                                      lr=jnp.float32(0.1))
        tu, ts = optim.sgd_update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, ts, tp,
                                  lr=torch.tensor(0.1))
        for k in SHAPES:
            np.testing.assert_allclose(_np(tu[k]), np.asarray(ju[k]),
                                       rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(_np(ts.momentum[k]),
                                       np.asarray(js.momentum[k]),
                                       rtol=1e-6, atol=1e-8)
    assert int(ts.step) == int(js.step) == 3


@pytest.mark.parametrize("kind", ["cosine", "linear"])
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 7), (5, 5)])
def test_schedules_match_jax(kind, warmup, total):
    f = getattr(optim, f"{kind}_schedule")(3e-3, warmup, total)
    g = getattr(ref_optim, f"{kind}_schedule")(3e-3, warmup, total)
    for step in range(0, total + 3):
        got = f(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(g(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)


def test_decay_mask_follows_the_jax_leaf_rank():
    """Reduced recurrentgemma (5 layers over a pattern of 3: one stacked
    group and a 2-layer tail): the group's per-layer vectors (norm scales,
    ``lambda``) are matrices in the JAX tree and decay; the tail's and
    ``final_norm``'s stay vectors and do not."""
    want = _decay_mask_and_update("recurrentgemma-2b")
    assert want["['groups']['0']['rec']['lambda']"]
    assert not want["['tail'][0]['rec']['lambda']"]
    assert not want["['final_norm']['scale']"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decay_mask_follows_the_jax_leaf_rank(arch):
    """The MoE trees: the router, the expert banks and the nested shared
    expert decay (rank 3 and 4 stacked), the stacked norm scales too."""
    want = _decay_mask_and_update(arch)
    ffn = "['groups']['0']['ffn']"
    assert want[f"{ffn}['router']"] and want[f"{ffn}['w_down']"]
    if "shared" in _init(arch)[1]["groups"]["0"]["ffn"]:
        assert want[f"{ffn}['shared']['w_gate']"]
    assert not want["['final_norm']['scale']"]


def _decay_mask_and_update(arch: str) -> dict:
    """The port's decay mask on the JAX layout equals the JAX AdamW's rule
    (rank >= 2), and one update of the whole tree equals the JAX update;
    returns the rule's mask by keystr."""
    jm, tree, tcfg = _init(arch)
    tm = from_jax_params(tree, tcfg, "cpu", train=True)
    mask = decay_mask(tm)
    got = _flat(to_jax_tree(tm, {n: torch.full(p.shape, float(mask[n]))
                                 for n, p in tm.named_parameters()}))
    want = {k: np.ndim(v) >= 2 for k, v in _flat(tree).items()}
    assert set(got) == set(want)
    for k, v in got.items():
        assert bool(v.all()) == want[k] and bool(v.any()) == want[k], k
    # and the update on the whole tree is the JAX update
    grads = jax.tree.map(
        lambda a: np.random.RandomState(a.size % 97).standard_normal(
            a.shape).astype(np.float32), tree)
    lr = jnp.float32(0.01)
    ju, _ = ref_optim.adamw_update(jax.tree.map(jnp.asarray, grads),
                                   ref_optim.adamw_init(tree),
                                   jax.tree.map(jnp.asarray, tree), lr=lr)
    params = dict(tm.named_parameters())
    from repro_torch.bridge import from_jax_tree
    tg = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in from_jax_tree(tm, grads).items()}
    tu, _ = optim.adamw_update(tg, optim.adamw_init(params), params,
                               lr=torch.tensor(0.01), decay=mask)
    _assert_trees(to_jax_tree(tm, tu), ju, share=1e-6, what="update")
    return want


# ---------------------------------------------------------------- the step
def _step_pair(arch: str, accum: int):
    jm, tree, tcfg = _init(arch)
    schedule = dict(base_lr=1e-2, warmup=1, total=10)
    jstep = jax.jit(ref_train_step(jm, accum_steps=accum,
                                   schedule=ref_optim.cosine_schedule(
                                       **schedule)))
    tm = from_jax_params(tree, tcfg, "cpu", train=True)
    tstep = make_train_step(tm, accum_steps=accum,
                            schedule=optim.cosine_schedule(**schedule))
    return jm, tree, tcfg, jstep, tm, tstep


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "seamless-m4t-medium"])
def test_three_train_steps_match_jax(arch, accum):
    """Loss, grad norm and lr tight; ``mu`` and ``nu`` within a few float32
    ulps of each leaf's largest entry; the parameters within 3 lr a step
    (the first update is about lr * sign(g), and where g lies within
    float32 noise of 0 the two frameworks may step opposite ways)."""
    jm, tree, tcfg, jstep, tm, tstep = _step_pair(arch, accum)
    jp, js = jax.tree.map(jnp.asarray, tree), ref_optim.adamw_init(tree)
    tp = dict(tm.named_parameters())
    ts = optim.adamw_init(tp)
    lr_sum = 0.0
    for step in range(3):
        batch = _batch(tcfg, step=step, b=4)
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tmet = tstep(tp, ts, _torch(batch))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=LOSS_RTOL * (step + 1))
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        # the cosine of two libraries: a float32 ulp apart at most
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=2e-7)
        lr_sum += float(jmet["lr"])
        _assert_trees(to_jax_tree(tm, ts.mu), js.mu, share=1e-4, what="mu")
        _assert_trees(to_jax_tree(tm, ts.nu), js.nu, share=1e-4, what="nu")
        _assert_trees(to_jax_params(tm), jp, share=0.0,
                      floor=3.0 * lr_sum + 1e-7, what="param")
    assert lr_sum > 0
    assert int(ts.step) == int(js.step) == 3
    moved = _flat(to_jax_params(tm))
    assert any(not np.array_equal(moved[k], v) for k, v in _flat(tree).items())


def test_step_zero_moves_nothing():
    """The cosine schedule warms up from lr 0: the first step only fills
    the moments."""
    _, tree, tcfg = _init("qwen3-0.6b")
    tm = from_jax_params(tree, tcfg, "cpu", train=True)
    step = make_train_step(tm, schedule=optim.cosine_schedule(1e-2, 5, 10))
    params = dict(tm.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    params, st, met = step(params, optim.adamw_init(params),
                           _torch(_batch(tcfg)))
    assert float(met["lr"]) == 0.0 and float(met["grad_norm"]) > 0
    assert all(torch.equal(before[k], p) for k, p in params.items())
    assert any(bool(m.any()) for m in st.mu.values())


# ------------------------------------------------------- pipeline and ft
@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=32, global_batch=8),
    dict(vocab_size=512, seq_len=16, global_batch=8, num_hosts=2, host_id=1,
         seed=3),
    dict(vocab_size=512, seq_len=16, global_batch=4, modality_tokens=8,
         modality_dim=32),
    dict(vocab_size=512, seq_len=16, global_batch=4, encdec=True,
         d_model=64)])
def test_synthetic_tokens_equal_the_jax_pipeline(kw):
    got = SyntheticTokens(DataConfig(**kw))
    want = ref_pipeline.SyntheticTokens(ref_pipeline.DataConfig(**kw))
    for step in (0, 1, 5, 123):
        a, b = got.batch(step), want.batch(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_prefetch_loader_resumes_at_its_step():
    src = SyntheticTokens(DataConfig(1000, 16, 4))
    loader = PrefetchingLoader(src, start_step=5, prefetch=2)
    try:
        for want in (5, 6):
            step, batch = next(loader)
            assert step == want
            assert np.array_equal(batch["tokens"], src.batch(want)["tokens"])
    finally:
        loader.close()


def test_watchdog_and_injector_behave_as_the_reference():
    wd = StepWatchdog(consecutive=3)
    for _ in range(20):
        wd.observe(1.0)
    assert not wd.observe(8.0)                      # one blip
    for _ in range(5):
        wd.observe(1.0)
    assert wd.stragglers_detected == 0
    assert any([wd.observe(10.0) for _ in range(4)])
    assert wd.stragglers_detected >= 1
    inj = FailureInjector(fail_at_step=2)
    inj.maybe_fail(1)
    calls = []

    def once():
        calls.append(1)
        inj.maybe_fail(2)

    assert run_with_restarts(once, max_restarts=2) == 1 and len(calls) == 2


# ------------------------------------------------------------- checkpoints
def _ckpt_tree():
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.ones((4,), np.float32), np.zeros((), np.int32)]}


def test_checkpoint_roundtrip_latest_partial_and_scan(tmp_path):
    tree = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else
            [torch.from_numpy(x) for x in v] for k, v in _ckpt_tree().items()}
    tree["c"] = torch.ones((3,), dtype=torch.bfloat16) * 1.5
    ckpt.save(tmp_path, 10, tree)
    ckpt.save(tmp_path, 20, {**tree, "a": tree["a"] + 1})
    assert ckpt.latest_step(tmp_path) == 20
    meta = {"a": torch.empty((2, 3), device="meta"),
            "b": [torch.empty((4,), device="meta"),
                  torch.empty((), dtype=torch.int32, device="meta")],
            "c": torch.empty((3,), dtype=torch.bfloat16, device="meta")}
    got = ckpt.restore(tmp_path, 10, meta)
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["c"],
                                                            tree["c"])
    assert got["b"][1].dtype == torch.int32
    # a crash mid-write at step 30 leaves only a .tmp: ignored
    (tmp_path / "step_00000030.tmp").mkdir()
    (tmp_path / "step_00000030.tmp" / "junk").write_text("partial")
    assert ckpt.latest_step(tmp_path) == 20
    (tmp_path / "LATEST").unlink()
    assert ckpt.latest_step(tmp_path) == 20
    (tmp_path / "LATEST").write_text("40")          # points at nothing
    assert ckpt.latest_step(tmp_path) == 20
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, 10, {**meta, "a": torch.empty(
            (3, 2), device="meta")})


def test_paths_equal_the_jax_keystr():
    _, tree, tcfg = _init("recurrentgemma-2b")
    tm = from_jax_params(tree, tcfg, "cpu", train=True)
    params = dict(tm.named_parameters())
    ours = [p for p, _ in ckpt.flatten_with_path(
        state_tree(tm, params, optim.adamw_init(params)))]
    theirs = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(
                  (tree, ref_optim.adamw_init(tree)))[0]]
    assert ours == theirs


def test_a_jax_checkpoint_resumes_in_the_port_and_back(tmp_path):
    """JAX trains a step and saves; the port restores it and takes the
    next step, which equals the JAX step; the port saves, JAX restores
    the port's checkpoint leaf for leaf (bf16 included)."""
    _resume_across(tmp_path, "qwen3-0.6b")
    # a bf16 leaf written by the port reads back in JAX as bf16
    ckpt.save(tmp_path / "bf16", 1, {"x": torch.arange(
        4, dtype=torch.bfloat16) / 3})
    got = ref_ckpt.restore(tmp_path / "bf16", 1, {"x": jax.ShapeDtypeStruct(
        (4,), jnp.bfloat16)})
    assert got["x"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["x"], np.float32),
                                  (torch.arange(4, dtype=torch.bfloat16)
                                   / 3).float().numpy())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_a_jax_checkpoint_of_an_moe_resumes_in_the_port_and_back(tmp_path,
                                                                 arch):
    """The same round trip through the MoE trees (the router, the stacked
    banks and the nested shared expert, with their moments); the steps
    add the load-balance term on both sides."""
    _resume_across(tmp_path, arch)


def _resume_across(tmp_path, arch: str) -> None:
    jm, tree, tcfg, jstep, tm, tstep = _step_pair(arch, 1)
    jp, js = jax.tree.map(jnp.asarray, tree), ref_optim.adamw_init(tree)
    for step in range(2):
        jp, js, _ = jstep(jp, js, jax.tree.map(jnp.asarray,
                                               _batch(tcfg, step)))
    ref_ckpt.save(tmp_path / "jax", 2, (jp, js))
    from repro_torch.launch.train import restore_state
    params, ts = restore_state(tm, tmp_path / "jax", 2)
    _assert_trees(to_jax_params(tm), jp, share=0.0, what="restored param")
    _assert_trees(to_jax_tree(tm, ts.mu), js.mu, share=0.0, what="mu")
    assert int(ts.step) == 2
    batch = _batch(tcfg, 2)
    jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
    params, ts, tmet = tstep(params, ts, _torch(batch))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                               rtol=2e-7)
    _assert_trees(to_jax_params(tm), jp, share=0.0,
                  floor=3.0 * float(jmet["lr"]), what="param")
    _assert_trees(to_jax_tree(tm, ts.nu), js.nu, share=1e-4, what="nu")

    ckpt.save(tmp_path / "port", 3, state_tree(tm, params, ts))
    shapes = jax.eval_shape(lambda: (jp, js))
    back, bst = ref_ckpt.restore(tmp_path / "port", 3, shapes)
    _assert_trees(back, to_jax_params(tm), share=0.0, floor=0.0,
                  what="JAX-restored param")
    _assert_trees(bst.nu, to_jax_tree(tm, ts.nu), share=0.0, floor=0.0,
                  what="JAX-restored nu")
    assert int(bst.step) == 3


# ------------------------------------------------------------ the entry point
RESUME_KW = dict(steps=12, global_batch=4, seq_len=32, ckpt_every=4,
                 log_every=100, device="cpu")


def test_resume_after_an_injected_failure_is_bit_for_bit(tmp_path):
    cfg = reduced_config("smollm-135m").replace(num_layers=2)
    ref = train_once(cfg, ckpt_dir=str(tmp_path / "ref"), **RESUME_KW)
    injector = FailureInjector(fail_at_step=9)
    metrics: list = []

    def once():
        train_once(cfg, ckpt_dir=str(tmp_path / "ft"), injector=injector,
                   metrics_out=metrics, **RESUME_KW)

    assert run_with_restarts(once, max_restarts=2) == 1
    got = dict(metrics)
    assert sorted(got) == list(range(12))
    assert all(got[s] == ref["losses"][s] for s in range(12))
    for (k, a), b in zip(ref["params"].items(), got_params(tmp_path / "ft",
                                                           cfg)):
        assert torch.equal(a, b), k


def got_params(ckpt_dir, cfg):
    """The parameters of the latest checkpoint in ``ckpt_dir``, in the
    model's parameter order."""
    from repro_torch.launch.train import restore_state
    from repro_torch.models import build_model
    model = build_model(cfg, "cpu", train=True)
    params, _ = restore_state(model, ckpt_dir, ckpt.latest_step(ckpt_dir))
    return list(params.values())


def test_train_once_follows_the_jax_train_once(tmp_path):
    """Reduced smollm-135m in float32 from the same weights: JAX's init
    written as a step-0 checkpoint, which both resume from."""
    from repro.launch.train import train_once as jax_train_once
    jcfg, tcfg = _cfgs("smollm-135m")
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(7))
    for d in ("jax", "port"):
        ref_ckpt.save(tmp_path / d, 0, (params, ref_optim.adamw_init(params)))
    kw = dict(steps=8, global_batch=4, seq_len=32, ckpt_every=0,
              log_every=100, lr=1e-3)
    want = jax_train_once(jcfg, ckpt_dir=str(tmp_path / "jax"), **kw)
    got = train_once(tcfg, ckpt_dir=str(tmp_path / "port"), device="cpu",
                     **kw)
    assert sorted(got["losses"]) == list(range(8))
    for s in range(8):
        np.testing.assert_allclose(got["losses"][s], want["losses"][s],
                                   rtol=1e-5, err_msg=f"step {s}")


def test_the_cli_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "3"], capture_output=True, text=True,
        timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] step     0 loss" in out.stdout
    assert "[train] step     2 loss" in out.stdout
    assert "[train] done (0 restarts)" in out.stdout


def test_the_cli_targets_the_card_by_default():
    """Without ``--device`` the CLI asks for ``cuda``: with no card it
    fails (after its restarts) instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "1", "--max-restarts", "0"], capture_output=True,
        text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
