"""The port's Mensa-dataflow pieces against the JAX package on the CPU, from
seeded numpy inputs at small sizes: the edge zoo's copy; the plain versions
of the Pascal matmul, the Jacquard GEMV and the Pavlov LSTM recurrence
against the Pallas kernels (interpret mode) and the jnp oracles; the whole
Pavlov layer and ``lstm_layer`` (with and without a carried state, through
the weight bridge) against the JAX ones; and the port's own invariant that
T carried single steps equal one call over T, bit for bit.  The CUDA
kernels' own tests are in test_torch_gpu.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.edge import edge_zoo as jax_zoo  # noqa: E402
from repro.kernels.jacquard_gemv import jacquard_gemv as jax_gemv  # noqa: E402
from repro.kernels.jacquard_gemv import jacquard_gemv_ref as jax_gemv_ref  # noqa: E402
from repro.kernels.pascal_matmul import pascal_matmul as jax_matmul  # noqa: E402
from repro.kernels.pascal_matmul import pascal_matmul_ref as jax_matmul_ref  # noqa: E402
from repro.kernels.pavlov_lstm import pavlov_lstm as jax_pavlov_lstm  # noqa: E402
from repro.kernels.pavlov_lstm import pavlov_lstm_raw as jax_lstm_raw  # noqa: E402
from repro.kernels.pavlov_lstm import pavlov_lstm_ref as jax_lstm_ref  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.bridge import lstm_from_jax  # noqa: E402
from repro_torch.edge import edge_zoo, get_model  # noqa: E402
from repro_torch.kernels import jacquard_gemv as jg  # noqa: E402
from repro_torch.kernels import pascal_matmul as pm  # noqa: E402
from repro_torch.kernels import pavlov_lstm as pl  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402

# float32 on both sides, summed in other orders: ATOL, and RTOL of the
# output where products of N(0, 1) values reach |y| ~ 20
ATOL = 1e-5
RTOL = 1e-5
# a product summed over K terms in two orders: ATOL or 8 float32 ulps of
# the output's scale, whichever is larger (|y| reaches ~70 at K = 1024 with
# N(0, 1) inputs, where 1e-5 is 1.2 ulps of it)
SUM_ULPS = 8 * 2.0 ** -23
# a bf16 output is one rounding of float32 values ATOL apart: at most one
# bf16 ulp, 2^-7 of |ref|
BF16_RTOL = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    v = jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32))
    v = v.astype(jdt)
    return v, torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)


def _close_sum(port, ref, dtype):
    """Within the tolerance of a product summed in another order."""
    scale = float(np.abs(np.asarray(ref, np.float32)).max())
    _close(port, ref, dtype, atol=max(ATOL, SUM_ULPS * scale))


def _close(port, ref, dtype="float32", atol=ATOL):
    np.testing.assert_allclose(
        port.float().numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(ref, np.float32), atol=atol,
        rtol=BF16_RTOL if dtype == "bfloat16" else RTOL)


# ------------------------------------------------------------------- edge zoo
def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("idx", range(24))
def test_zoo_copy_matches_jax_zoo(idx):
    """The port's copy of the 24 edge models, field by field."""
    ref, got = jax_zoo()[idx], edge_zoo()[idx]
    assert len(edge_zoo()) == len(jax_zoo()) == 24
    assert (got.name, got.family, got.edges) == (ref.name, ref.family,
                                                 ref.edges)
    assert len(got.layers) == len(ref.layers)
    for lg, lr in zip(got.layers, ref.layers):
        fg, fr = _fields(lg), _fields(lr)
        assert fg.pop("kind").value == fr.pop("kind").value
        assert fg == fr
        assert (lg.param_count, lg.macs) == (lr.param_count, lr.macs)


def test_tr1_lstm_stack_widths():
    """The widths the slice runs: TR1's 8-layer encoder 512 -> 2048 over
    T = 200 and its 2-layer prediction network 640 -> 2048 over U = 20,
    batch 1, about 311 M LSTM parameters."""
    lstms = [l for l in get_model("TR1_rnnt_mobile").layers
             if l.kind.value == "lstm"]
    assert [(l.in_features, l.hidden, l.seq_len, l.batch) for l in lstms] \
        == [(512, 2048, 200, 1)] + [(2048, 2048, 200, 1)] * 7 \
        + [(640, 2048, 20, 1), (2048, 2048, 20, 1)]
    assert sum(l.param_count for l in lstms) == 311_427_072


# -------------------------------------------------------------- pascal_matmul
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (64, 128, 64, 32, 32, 64),
    (100, 96, 50, 64, 32, 32),      # the Pallas route pads here
    (8, 256, 512, 8, 128, 128),
    (1, 64, 33, 8, 16, 64),
])
def test_pascal_plain_matches_pallas_and_oracle(dtype, m, k, n, bm, bn, bk):
    rng = np.random.RandomState(m + k + n)
    xj, xt = _pair(rng, (m, k), dtype)
    wj, wt = _pair(rng, (k, n), dtype)
    out = pm.pascal_matmul(xt, wt)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (m, n)
    _close_sum(out, jax_matmul(xj, wj, block_m=bm, block_n=bn, block_k=bk),
               dtype)
    _close_sum(out, jax_matmul_ref(xj, wj), dtype)


def test_pascal_flattens_lead_dims():
    rng = np.random.RandomState(1)
    xj, xt = _pair(rng, (2, 3, 32, 64), "float32")
    wj, wt = _pair(rng, (64, 48), "float32")
    out = pm.pascal_matmul(xt, wt)
    assert out.shape == (2, 3, 32, 48)
    _close_sum(out, jax_matmul(xj, wj, block_m=16, block_n=16, block_k=32),
               "float32")


def test_pascal_plain_rows_do_not_depend_on_m():
    """A row of one product equals that row of a product of many rows, bit
    for bit (``torch.matmul`` on the CPU does not promise it)."""
    rng = np.random.RandomState(2)
    _, x = _pair(rng, (20, 96), "float32")
    _, w = _pair(rng, (96, 40), "float32")
    full = pm.pascal_matmul_ref(x, w)
    assert all(torch.equal(full[i:i + 1], pm.pascal_matmul_ref(x[i:i + 1], w))
               for i in range(20))


# -------------------------------------------------------------- jacquard_gemv
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 256, 512), (4, 1024, 300), (8, 96, 64)])
def test_jacquard_plain_matches_oracle(dtype, m, k, n):
    """Held to ``jacquard_gemv_ref``: the Pallas GEMV itself misses it at
    (4, 1024, 300) in float32."""
    rng = np.random.RandomState(m * k + n)
    xj, xt = _pair(rng, (m, k), dtype)
    wj, wt = _pair(rng, (k, n), dtype)
    out = jg.jacquard_gemv(xt, wt)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (m, n)
    _close_sum(out, jax_gemv_ref(xj, wj), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 256, 512), (8, 96, 64)])
def test_jacquard_plain_matches_pallas(dtype, m, k, n):
    rng = np.random.RandomState(m * k + n)
    xj, xt = _pair(rng, (m, k), dtype)
    wj, wt = _pair(rng, (k, n), dtype)
    _close_sum(jg.jacquard_gemv(xt, wt),
               jax_gemv(xj, wj, block_n=128, block_k=256), dtype)


def test_jacquard_refuses_more_than_16_rows():
    with pytest.raises(ValueError, match="at most 16"):
        jg.jacquard_gemv(torch.zeros(17, 8), torch.zeros(8, 4))
    assert jg.jacquard_gemv(torch.zeros(2, 8, 8), torch.zeros(8, 4)).shape \
        == (2, 8, 4)


@pytest.mark.parametrize("fn", [pm.pascal_matmul_raw, jg.jacquard_gemv_raw])
def test_gemm_launchers_take_cuda_tensors_only(fn):
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(torch.zeros(2, 8), torch.zeros(8, 4))


# ---------------------------------------------------------------- pavlov_lstm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h", [(2, 8, 16), (1, 20, 32), (4, 5, 64)])
def test_lstm_plain_matches_pallas_and_oracle(dtype, b, t, h):
    """The plain recurrence from zero state against the Pallas kernel in
    interpret mode and the jnp oracle (a ``lax.scan``)."""
    rng = np.random.RandomState(b * t + h)
    xgj, xgt = _pair(rng, (b, t, 4 * h), dtype, 0.5)
    whj, wht = _pair(rng, (h, 4 * h), dtype, 0.3)
    out, h_t, c_t = pl.lstm_recurrence(xgt, wht)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (b, t, h)
    assert h_t.dtype == c_t.dtype == torch.float32
    assert torch.equal(out[:, -1], h_t.to(out.dtype))
    _close(out, jax_lstm_raw(xgj, whj, interpret=True), dtype)
    _close(out, jax_lstm_ref(xgj, whj), dtype)


def test_lstm_launcher_checks_before_it_launches():
    xg, wh = torch.zeros(1, 2, 8), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pl.pavlov_lstm_raw(xg, wh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pavlov_layer_matches_jax_ops(dtype):
    """The decoupled schedule (input GEMM on the Pascal wrapper, then the
    recurrence) against the JAX ``ops.pavlov_lstm``."""
    rng = np.random.RandomState(7)
    xj, xt = _pair(rng, (2, 10, 24), dtype, 0.5)
    p = jrec.init_lstm_layer(jax.random.PRNGKey(4), 24, 16)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["b"] = (0.1 * rng.standard_normal(p["b"].shape)).astype(np.float32)
    pt = lstm_from_jax(p, device="cpu")
    ref = jax_pavlov_lstm(xj, *(jnp.asarray(p[k]) for k in ("w_x", "w_h",
                                                             "b")))
    out, _, _ = pl.pavlov_lstm(xt, pt["w_x"], pt["w_h"], pt["b"])
    assert out.dtype == DTYPES[dtype][1]
    _close(out, ref, dtype)


def _lstm_case(seed, b=2, s=12, d_in=24, hd=16):
    """A JAX LSTM layer (random bias), its port through the bridge, an
    input and a carried state, from one seed."""
    rng = np.random.RandomState(seed)
    tree = jrec.init_lstm_layer(jax.random.PRNGKey(seed), d_in, hd)
    tree = {k: np.asarray(v) for k, v in tree.items()}
    tree["b"] = (0.1 * rng.standard_normal(tree["b"].shape)).astype(
        np.float32)
    x = (0.5 * rng.standard_normal((b, s, d_in))).astype(np.float32)
    state = tuple((0.5 * rng.standard_normal((b, hd))).astype(np.float32)
                  for _ in range(2))
    return tree, lstm_from_jax(tree, device="cpu"), x, state


@pytest.mark.parametrize("carry", [False, True])
def test_lstm_layer_matches_jax(carry):
    tree, params, x, state = _lstm_case(11)
    jstate = tuple(jnp.asarray(s) for s in state) if carry else None
    tstate = tuple(torch.from_numpy(s) for s in state) if carry else None
    ref, (h_ref, c_ref) = jrec.lstm_layer(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x), jstate)
    y, (h, c) = trec.lstm_layer(params, torch.from_numpy(x), tstate)
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert h.dtype == c.dtype == torch.float32
    _close(y, ref)
    _close(h, h_ref)
    _close(c, c_ref)


def test_lstm_layer_bf16_input_keeps_float32_recurrence():
    """bf16 x with float32 weights: the input GEMM in bf16 (the JAX einsum's
    cast), W_h and the state in float32, y cast back to bf16."""
    tree, params, x, state = _lstm_case(12)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref, (h_ref, _) = jrec.lstm_layer(
        {k: jnp.asarray(v) for k, v in tree.items()}, xb)
    y, (h, _) = trec.lstm_layer(
        params, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
            torch.bfloat16))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(y, ref, "bfloat16")
    _close(h, h_ref)


@pytest.mark.parametrize("carry", [False, True])
def test_lstm_carried_single_steps_equal_one_call(carry):
    """The port's own invariant: T calls of one step each, carrying (h, c),
    give the bits of one call over T (the prediction network's way)."""
    _, params, x, state = _lstm_case(13, s=20)
    xt = torch.from_numpy(x)
    st = tuple(torch.from_numpy(s) for s in state) if carry else None
    y, (h, c) = trec.lstm_layer(params, xt, st)
    ys = []
    for t in range(x.shape[1]):
        yt, st = trec.lstm_layer(params, xt[:, t:t + 1], st)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, dim=1), y)
    assert torch.equal(st[0], h) and torch.equal(st[1], c)


def test_init_lstm_layer_distributions():
    """The JAX init's shapes and scales: w_x, w_h normal with std
    1/sqrt(fan-in), b zeros."""
    g = torch.Generator().manual_seed(0)
    p = trec.init_lstm_layer(256, 64, g)
    ref = jrec.init_lstm_layer(jax.random.PRNGKey(0), 256, 64)
    for name in ("w_x", "w_h", "b"):
        assert tuple(p[name].shape) == ref[name].shape
        assert p[name].dtype == torch.float32
    assert float(p["w_x"].std()) == pytest.approx(1 / 16, rel=0.02)
    assert float(p["w_h"].std()) == pytest.approx(1 / 8, rel=0.02)
    assert not p["b"].any()


def test_lstm_bridge_refuses_other_trees():
    tree, _, _, _ = _lstm_case(14)
    with pytest.raises(ValueError, match="LSTM tree"):
        lstm_from_jax({**tree, "w_y": tree["w_x"]}, device="cpu")
    with pytest.raises(ValueError, match="w_x"):
        lstm_from_jax({**tree, "w_x": tree["w_x"][:, :8]}, device="cpu")
