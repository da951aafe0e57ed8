"""The port's encoder-decoder serving path against the JAX ``Model`` on
reduced seamless-m4t-medium in float32: ``encode`` against the JAX
``_encode``'s memory, a right-padded ``prefill(memory=)``'s logits and
``dec`` KV caches against the JAX ``prefill`` (which encodes and returns
the memory itself), and four ``decode_step(memory=)`` calls, one with a
frozen row, against the JAX ``decode_step``; ``init_states`` against the
JAX ``init_states``' shapes and dtypes; and the refusals: no paged pool,
no chunked prefill, no engine, no step without the memory."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

from test_torch_model import ATOL_F32, lively_params  # noqa: E402

ARCH = "seamless-m4t-medium"
B, S, SM, MAX_LEN = 2, 12, 10, 32
LENS = np.asarray([7, 12], np.int32)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.fixture(scope="module")
def pair():
    jm, jp, tree = lively_params("float32", arch=ARCH, gain=2.0)
    tm = from_jax_params(tree, reduced_config(ARCH).replace(
        compute_dtype="float32"), "cpu")
    rng = np.random.RandomState(5)
    src = rng.normal(0, 1, (B, SM, tm.cfg.d_model)).astype(np.float32)
    toks = rng.randint(1, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    return jm, jp, tm, src, toks


def _jax_layer_kv(js, i: int):
    """Layer ``i``'s dense cache of the JAX states (one ``dec`` group)."""
    kv = js["groups"]["0"].kv
    return kv.k[i], kv.v[i], kv.length[i]


def _compare_caches(js, ts):
    for i, st in enumerate(ts):
        k, v, n = _jax_layer_kv(js, i)
        np.testing.assert_allclose(_np(st.kv.k), _np(k), atol=ATOL_F32,
                                   rtol=0, err_msg=f"layer {i} k")
        np.testing.assert_allclose(_np(st.kv.v), _np(v), atol=ATOL_F32,
                                   rtol=0, err_msg=f"layer {i} v")
        np.testing.assert_array_equal(st.kv.length.numpy(), np.asarray(n))


def test_encode_matches_jax(pair):
    jm, jp, tm, src, _ = pair
    want = jm._encode(jp, jnp.asarray(src))
    got = tm.encode(torch.from_numpy(src))
    assert got.shape == (B, SM, tm.cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_F32, rtol=0)


def test_prefill_and_decode_match_jax(pair):
    """Right-padded prefill with the memory, then four decode steps (row 0
    frozen at the second): logits of the live rows, the ``dec`` caches
    and their lengths, and the frozen row's cache bit for bit."""
    jm, jp, tm, src, toks = pair
    js = jm.init_states(B, MAX_LEN)
    lj, js, jmem = jm.prefill(jp, jnp.asarray(toks), js,
                              src_embeds=jnp.asarray(src),
                              length=jnp.asarray(LENS))
    memory = tm.encode(torch.from_numpy(src))
    np.testing.assert_allclose(_np(memory), _np(jmem), atol=ATOL_F32, rtol=0)
    ts = tm.init_states(B, MAX_LEN)
    lt, ts = tm.prefill(torch.from_numpy(toks), ts, memory=memory,
                        length=torch.from_numpy(LENS))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=ATOL_F32, rtol=0)
    _compare_caches(js, ts)
    pos = LENS.copy()
    tok = np.asarray(lt.argmax(-1), np.int32)
    assert np.array_equal(tok, np.asarray(lj.argmax(-1)))
    for step in range(4):
        active = np.asarray([step != 1, True])
        before = [(st.kv.k[0].clone(), st.kv.v[0].clone()) for st in ts]
        lj, js = jm.decode_step(jp, jnp.asarray(tok), js, jnp.asarray(pos),
                                jmem, active=jnp.asarray(active))
        lt, ts = tm.decode_step(torch.from_numpy(tok), ts,
                                torch.from_numpy(pos),
                                active=torch.from_numpy(active),
                                memory=memory)
        live = np.flatnonzero(active)
        np.testing.assert_allclose(_np(lt)[live], _np(lj)[live],
                                   atol=ATOL_F32, rtol=0,
                                   err_msg=f"decode step {step}")
        _compare_caches(js, ts)
        if not active[0]:
            for (k0, v0), st in zip(before, ts):
                assert torch.equal(st.kv.k[0], k0)
                assert torch.equal(st.kv.v[0], v0)
        nxt = np.asarray(lt.argmax(-1), np.int32)
        assert np.array_equal(nxt[live], np.asarray(lj.argmax(-1))[live])
        tok = np.where(active[:, None], nxt, tok)
        pos = pos + active.astype(np.int32)


def test_decode_needs_the_memory(pair):
    _, _, tm, _, toks = pair
    ts = tm.init_states(B, MAX_LEN)
    with pytest.raises(ValueError, match="memory"):
        tm.prefill(torch.from_numpy(toks), ts)
    with pytest.raises(ValueError, match="memory"):
        tm.decode_step(torch.from_numpy(toks[:, :1]), ts,
                       torch.zeros(B, dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_states_mirror_jax(dtype):
    """One dense cache a ``dec`` layer, with the JAX ``init_states``'
    shapes and dtypes, zeroed."""
    from repro.configs import reduced_config as jax_reduced
    from repro.models import build_model as jax_build
    cfg = reduced_config(ARCH).replace(compute_dtype=dtype)
    js = jax_build(jax_reduced(ARCH).replace(compute_dtype=dtype)) \
        .init_states(3, MAX_LEN)
    ts = build_model(cfg, "cpu").init_states(3, MAX_LEN)
    assert len(ts) == cfg.num_layers
    kv = js["groups"]["0"].kv
    for st in ts:
        assert st.rec is None
        for got, want in zip(st.kv, kv):
            assert tuple(got.shape) == tuple(want.shape[1:])
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            assert not got.any()


def test_what_an_encoder_decoder_does_not_serve():
    """No paged pool, no chunked prefill (the JAX model refuses it too)
    and no engine."""
    model = build_model(reduced_config(ARCH), "cpu", seed=0)
    with pytest.raises(NotImplementedError, match="dense"):
        model.init_states(1, MAX_LEN, kv_block_size=8)
    states = model.init_states(1, MAX_LEN)
    memory = model.encode(torch.zeros(1, 4, model.cfg.d_model))
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        model.prefill(torch.ones(1, 4, dtype=torch.int32), states,
                      memory=memory, length=one, offset=one)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(model, slots=1, max_len=MAX_LEN)
