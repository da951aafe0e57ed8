"""The port's mixture-of-experts feed-forward against the JAX package on the
CPU: ``repro_torch.models.moe`` against ``repro.models.moe``, and reduced
phi3.5-moe-42b-a6.6b (top-2 of 4 experts, LayerNorm) and
llama4-scout-17b-a16e (top-1 of 4 and a shared expert, RMSNorm) against the
JAX model and engine.

- ``moe_ffn`` for each route (``einsum``, ``scatter``, ``ragged``), float32
  and bf16, top-1 and top-2, with and without a shared expert, at capacity
  factors that drop (1.25, 0.5) and one that does not (4.0): the gate
  indices equal the JAX router's and the keep mask the reference's queue,
  both exactly; the outputs within ``ATOL_F32`` (float32) or
  ``BF16_SHARE`` of their scale (bf16); ``load_balance`` within
  ``LB_RTOL`` and ``dropped_frac`` equal;
- the top-k keeps the lower expert first on an exact tie, as ``lax.top_k``;
- the bridge carries the nested ``shared`` dict both ways and refuses a
  tree without it;
- forward logits, and right-padded prefill then decode steps with a dead
  row, against the JAX model;
- greedy tokens of the port's engine equal the JAX engine's, paged (with
  the prefix cache) and dense, at the reduced configs' capacity (nothing
  drops) and at ``moe_capacity=1.25``, where the dead decode slots and the
  bucket's padding rows take expert places.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as ref_moe  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import (from_jax_params, layout,  # noqa: E402
                                to_jax_params)
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

from test_torch_archs import BF16_SHARE, GAIN, KW, _serve, _trace  # noqa: E402
from test_torch_model import ATOL_F32, lively_params  # noqa: E402

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
MAX_LEN, BS = 64, 8
D, F, E = 32, 48, 4
#: the load-balance term: a mean of float32 probabilities summed in
#: another order (they part by a few ulps)
LB_RTOL = 1e-6


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _params(shared: bool, seed: int = 0) -> dict:
    """Numpy MoE leaves at scales that keep the output near 1."""
    rng = np.random.RandomState(seed)
    p = {"router": rng.normal(0, 1 / np.sqrt(D), (D, E)),
         "w_gate": rng.normal(0, 0.2, (E, D, F)),
         "w_up": rng.normal(0, 0.2, (E, D, F)),
         "w_down": rng.normal(0, 0.2, (E, F, D))}
    if shared:
        p["shared"] = {"w_gate": rng.normal(0, 0.2, (D, F)),
                       "w_up": rng.normal(0, 0.2, (D, F)),
                       "w_down": rng.normal(0, 0.2, (F, D))}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _ref_keep(gate_idx, cap: int):
    """The reference's queue (``repro.models.moe``'s capacity routes)."""
    n, k = gate_idx.shape
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(n * k, E)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(n, k)
    return np.asarray(pos < cap)


# ---------------------------------------------------------------- moe_ffn
@pytest.mark.parametrize("cf", [1.25, 0.5, 4.0])
@pytest.mark.parametrize("shared", [False, True], ids=["plain", "shared"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", moe.IMPLS)
def test_moe_ffn_matches_jax(impl, dtype, top_k, shared, cf):
    p = _params(shared)
    x = np.random.RandomState(1).standard_normal((2, 9, D)).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    jx = jnp.asarray(x, dtype)
    want, want_aux = ref_moe.moe_ffn(jp, jx, top_k=top_k, capacity_factor=cf,
                                     return_aux=True, impl=impl)
    dt = getattr(torch, dtype)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(dt), p)
    tp["router"] = torch.from_numpy(p["router"])
    tx = torch.from_numpy(x).to(dt)
    got, aux = moe.moe_ffn(tp, tx, top_k=top_k, capacity_factor=cf,
                           return_aux=True, impl=impl)
    assert got.dtype == dt and got.shape == x.shape
    # the routing, exactly
    xt = tx.reshape(-1, D)
    _, _, want_idx = ref_moe._route(jp, jx.reshape(-1, D), top_k)
    r = moe.routing(tp, xt, top_k, None if impl == "ragged" else cf)
    np.testing.assert_array_equal(r["gate_idx"].numpy(),
                                  np.asarray(want_idx))
    n = xt.shape[0]
    if impl != "ragged":
        cap = max(1, int(cf * n * top_k / E))
        assert r["capacity"] == cap
        np.testing.assert_array_equal(r["keep"].numpy(),
                                      _ref_keep(want_idx, cap))
    # the output
    scale = float(np.abs(_np(want)).max())
    atol = ATOL_F32 if dtype == "float32" else BF16_SHARE * scale
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(want_aux["load_balance"]), rtol=LB_RTOL)
    assert float(aux["dropped_frac"]) == float(want_aux["dropped_frac"])
    if impl != "ragged" and cf < 1:
        assert float(aux["dropped_frac"]) > 0          # drops happen
    if cf == 4.0 or impl == "ragged":
        assert float(aux["dropped_frac"]) == 0


def test_top_k_keeps_the_lower_expert_first_on_a_tie():
    """A zero router makes every probability 1/E: both frameworks pick
    experts 0, 1 for every token."""
    p = _params(False)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.RandomState(2).standard_normal((5, D)).astype(np.float32)
    _, _, want = ref_moe._route(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), 2)
    _, vals, got = moe.route({"router": torch.from_numpy(p["router"])},
                             torch.from_numpy(x), 2)
    assert got.tolist() == np.asarray(want).tolist() == [[0, 1]] * 5
    np.testing.assert_array_equal(vals.numpy(), 0.5)


def test_the_queue_is_token_major_then_k():
    """A token's second choice is queued before the next token's first."""
    idx = torch.tensor([[0, 1], [1, 0], [1, 2]])
    pos, keep = moe.queue_positions(idx, 3, 1)
    assert pos.tolist() == [[0, 0], [1, 1], [2, 0]]
    assert keep.tolist() == [[True, True], [False, False], [False, True]]
    assert moe.capacity(1.25, 4, 2, 16) == 1           # int(0.625) -> 1


def test_an_unknown_impl_raises():
    p = jax.tree.map(torch.from_numpy, _params(False))
    with pytest.raises(ValueError, match="moe impl"):
        moe.moe_ffn(p, torch.zeros((1, 2, D)), top_k=1, impl="dense")


# ----------------------------------------------------------------- bridge
def _pair(arch: str, dt: str = "float32", **cfg_kw):
    jm, jp, tree = lively_params(dt, arch=arch, gain=GAIN[dt], **cfg_kw)
    cfg = reduced_config(arch).replace(compute_dtype=dt, **cfg_kw)
    return jm, jp, tree, from_jax_params(tree, cfg, "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_carries_the_moe_tree_both_ways(arch):
    _, _, tree, tm = _pair(arch)
    back = to_jax_params(tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    ffn = tm.layers[0].ffn
    assert ffn["router"].dtype == torch.float32
    names = {leaf.name for leaf in layout(tm)}
    assert names == set(dict(tm.named_parameters()))
    has_shared = reduced_config(arch).moe_shared_expert
    assert ("layers.0.ffn.shared.w_gate" in names) == has_shared
    assert ("shared" in tree["groups"]["0"]["ffn"]) == has_shared
    # a tree without the shared expert (or with one too many) is refused
    group = dict(tree["groups"]["0"])
    group["ffn"] = dict(group["ffn"])
    if has_shared:
        group["ffn"].pop("shared")
    else:
        group["ffn"]["shared"] = {"w_gate": np.zeros((2, 64, 128))}
    with pytest.raises(ValueError, match="ffn"):
        from_jax_params(dict(tree, groups={"0": group}), tm.cfg, "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serving_build_stores_banks_in_the_compute_dtype(arch):
    _, _, _, tm = _pair(arch, "bfloat16")
    ffn = tm.layers[0].ffn
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_gate"].dtype == torch.bfloat16
    assert tuple(ffn["w_down"].shape) == (4, 128, 64)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_jax(arch, dt):
    jm, jp, _, tm = _pair(arch, dt)
    toks = np.random.RandomState(1).randint(0, 512, (2, 12))
    lj, aux = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    assert "load_balance" in aux
    lt = tm(torch.from_numpy(toks))
    atol = ATOL_F32 if dt == "float32" \
        else BF16_SHARE * float(np.abs(_np(lj)).max())
    np.testing.assert_allclose(_np(lt), _np(lj), atol=atol, rtol=0)


@pytest.mark.parametrize("cap", [None, 1.25], ids=["nodrop", "cap1.25"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch, cap):
    """Three right-padded rows through a paged prefill, then 4 decode
    steps with row 1 dead from the second on: logits (of the live rows)
    and pools within ``ATOL_F32``.  At capacity 1.25 the padding positions
    and the dead row take expert places on both sides."""
    kw = {} if cap is None else dict(moe_capacity=cap)
    jm, jp, _, tm = _pair(arch, **kw)
    nb = MAX_LEN // BS
    toks = np.random.RandomState(3).randint(1, 512, (3, 16))
    lens = np.array([16, 9, 4], np.int32)
    table = np.arange(3 * nb, dtype=np.int32).reshape(3, nb)
    js = jm.init_states(3, MAX_LEN, kv_block_size=BS, kv_blocks=3 * nb)
    ts = tm.init_states(3, MAX_LEN, kv_block_size=BS, kv_blocks=3 * nb)
    lj, js, _ = jm.prefill(jp, jnp.asarray(toks, jnp.int32), js,
                           length=jnp.asarray(lens),
                           block_table=jnp.asarray(table))
    lt, ts = tm.prefill(torch.from_numpy(toks), ts,
                        length=torch.from_numpy(lens),
                        block_table=torch.from_numpy(table))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=ATOL_F32, rtol=0)
    pos = lens.copy()
    for step in range(4):
        nxt = _np(lj)[:, 0].argmax(-1)[:, None].astype(np.int32)
        active = np.array([True, step == 0, True])
        lj, js = jm.decode_step(jp, jnp.asarray(nxt), js, jnp.asarray(pos),
                                active=jnp.asarray(active),
                                block_table=jnp.asarray(table))
        lt, ts = tm.decode_step(torch.from_numpy(nxt).long(), ts,
                                torch.from_numpy(pos),
                                active=torch.from_numpy(active),
                                block_table=torch.from_numpy(table))
        live = np.flatnonzero(active)
        np.testing.assert_allclose(_np(lt)[live], _np(lj)[live],
                                   atol=ATOL_F32, rtol=0)
        pos = pos + active
    kv = js["groups"]["0"].kv
    for i, st in enumerate(ts):
        np.testing.assert_allclose(_np(st.kv.k), _np(kv.k[i]),
                                   atol=ATOL_F32, rtol=0)
        np.testing.assert_array_equal(st.kv.length.numpy(),
                                      np.asarray(kv.length[i]))


# ----------------------------------------------------------------- engine
@pytest.mark.parametrize("cap", [None, 1.25], ids=["nodrop", "cap1.25"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_matches_jax_engine(arch, paged, cap):
    """Both engines built directly (``build_engine`` of the reference fails
    to plan a reduced MoE: its 4 experts do not divide the model axis).
    At capacity 1.25 a decode tick of 3 slots gives each expert
    ``max(1, int(1.25 * 3 * k / 4))`` places, and the dead slots (token 0)
    take theirs first when they sit lower."""
    kw = {} if cap is None else dict(moe_capacity=cap)
    jm, jp, _, tm = _pair(arch, **kw)
    ekw = dict(KW, kv_block_size=8) if paged else dict(KW)
    jax_engine, engine = JaxEngine(jm, jp, **ekw), ServeEngine(tm, **ekw)
    prompts = _trace(arch)
    want = _serve(jax_engine, JaxRequest, prompts)
    got = _serve(engine, Request, prompts)
    assert got == want
    assert len({tuple(g) for g in got}) == len(got)    # tokens vary
    js, ts = jax_engine.stats, engine.stats
    assert (ts.prefill_calls, ts.prefill_chunks, ts.decode_steps) \
        == (js.prefill_calls, js.prefill_chunks, js.decode_steps)
    assert (ts.prefix_hits, ts.blocks_copied) \
        == (js.prefix_hits, js.blocks_copied)
    assert ts.prefix_hits == (1 if paged else 0)
    assert engine.stats.summary()["nonfinite_logits"] == 0
