"""The port's recurrentgemma pieces against the JAX package on the CPU,
float32, from seeded numpy inputs: the RG-LRU kernel's plain version
against the Pallas kernel (interpret mode) and the jnp oracle; the conv,
``rglru_core`` and ``rglru_block`` against both JAX routes (``impl`` pallas
and xla); the dense KV ops (decode with a ring and a write mask, both arms
of chunked prefill, the prefill fill, chunked local attention); and the
weight bridge for ``rec`` and ``local`` blocks.  The CUDA kernel's own
tests are in test_torch_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.pavlov_rglru import pavlov_rglru as jax_rglru  # noqa: E402
from repro.kernels.pavlov_rglru import pavlov_rglru_ref as jax_rglru_scan  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models.transformer import _fill_cache as jax_fill_cache  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import pavlov_rglru as pr  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models.transformer import _fill_cache  # noqa: E402

from test_torch_gpu import _rglru_inputs  # noqa: E402
from test_torch_model import lively_params  # noqa: E402

# the plain loop and the Pallas kernel run the same float32 recurrence in
# the same order; only a fused multiply-add on one side may differ
ATOL_SCAN = 1e-6
# against the associative scan, which multiplies the a's in another order
ATOL_ASSOC = 1e-5
# whole blocks: XLA and PyTorch also sum the gate and output products in
# other orders
ATOL_BLOCK = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _close(port, ref, atol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), atol=atol, rtol=0)


# ------------------------------------------------------------------ the scan
@pytest.mark.parametrize("t", [1, 7, 100, 256])
def test_plain_rglru_matches_pallas_and_oracle(t):
    a, b = _rglru_inputs(np.random.RandomState(t), 2, t, 64)
    port = pr.pavlov_rglru(_t(a), _t(b))
    assert port.dtype == torch.float32 and port.shape == (2, t, 64)
    _close(port, jax_rglru(_j(a), _j(b)), ATOL_SCAN)
    _close(port, jax_rglru_scan(_j(a), _j(b)), ATOL_ASSOC)


def test_plain_rglru_bf16_keeps_a_float32_state():
    """bf16 in and out, the state carried in float32 between steps (as the
    kernel keeps it in a register): within one bf16 ulp of the Pallas
    kernel's output (a float32 h a rounding apart may round the other way
    to bf16)."""
    a, b = _rglru_inputs(np.random.RandomState(9), 2, 40, 64)
    a16, b16 = _t(a).bfloat16(), _t(b).bfloat16()
    port = pr.pavlov_rglru(a16, b16)
    assert port.dtype == torch.bfloat16
    want = np.asarray(jax_rglru(_j(a16.float()).astype(jnp.bfloat16),
                                _j(b16.float()).astype(jnp.bfloat16)),
                      np.float32)
    got = port.float().numpy()
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - want) <= ulp)


# ------------------------------------------------------------------ the conv
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("lengths", [None, (5, 12, 0)])
def test_causal_conv1d_matches_jax(with_state, lengths):
    rng = np.random.RandomState(3)
    x = rng.standard_normal((3, 12, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    st = rng.standard_normal((3, 3, 8)).astype(np.float32) \
        if with_state else None
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    yj, sj = jrec.causal_conv1d(_j(x), _j(w), None if st is None else _j(st),
                                length=None if ln is None else _j(ln))
    yt, stt = trec.causal_conv1d(_t(x), _t(w),
                                 None if st is None else _t(st),
                                 length=None if ln is None else _t(ln))
    _close(yt, yj, 1e-6)
    np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))
    if with_state and ln is not None:        # a length-0 row keeps its state
        np.testing.assert_array_equal(stt[2].numpy(), st[2])


# ------------------------------------------------------------ core and block
def _rec_params(gate_blocks: int, seed: int = 0):
    p = jrec.init_rglru_block(jax.random.PRNGKey(seed), 32, 64,
                              gate_blocks=gate_blocks)
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("gate_blocks", [0, 4])
def test_rglru_core_matches_jax(impl, gate_blocks):
    """A carried h0 and a ragged mask (row 1 stops at 9 of 20)."""
    jp, tp = _rec_params(gate_blocks)
    rng = np.random.RandomState(gate_blocks)
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    mask = np.arange(20)[None] < np.asarray([20, 9])[:, None]
    yj, hj = jrec.rglru_core(jp, _j(x), _j(h0), seq_mask=_j(mask),
                             impl=impl)
    yt, ht = trec.rglru_core(tp, _t(x), _t(h0), seq_mask=_t(mask))
    _close(yt, yj, ATOL_BLOCK)
    _close(ht, hj, ATOL_BLOCK)
    assert ht.dtype == torch.float32
    # the masked tail passes the state through: h_last is h at step 8
    _close(ht[1], yt[1, 8], 0.0)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_rglru_block_matches_jax(impl):
    """Prefill with lengths, then a resumed segment from the returned
    state."""
    jp, tp = _rec_params(0, seed=1)
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ln = np.asarray([16, 6], np.int32)
    oj, sj = jrec.rglru_block(jp, _j(x), return_state=True, length=_j(ln),
                              impl=impl)
    ot, st = trec.rglru_block(tp, _t(x), length=_t(ln))
    _close(ot, oj, ATOL_BLOCK)
    for k in ("conv", "h"):
        _close(st[k], sj[k], ATOL_BLOCK)
    x2 = rng.standard_normal((2, 5, 32)).astype(np.float32)
    oj, sj = jrec.rglru_block(jp, _j(x2), state=sj, return_state=True,
                              impl=impl)
    ot, st = trec.rglru_block(tp, _t(x2), state=st)
    _close(ot, oj, ATOL_BLOCK)
    for k in ("conv", "h"):
        _close(st[k], sj[k], ATOL_BLOCK)


def test_init_rglru_block_draws_jax_distributions():
    shapes = trec.rglru_param_shapes(32, 64, 4, gate_blocks=4)
    assert shapes["w_a"] == (4, 16, 16) and shapes["lambda"] == (64,)
    params = {k: torch.empty(s) for k, s in shapes.items()}
    trec.init_rglru_block(params, torch.Generator().manual_seed(0))
    lam = params["lambda"]
    a = torch.sigmoid(lam) ** trec.C_RGLRU
    assert bool(((a >= 0.9 - 1e-6) & (a <= 0.999 + 1e-6)).all())
    assert abs(params["w_a"].std().item() - 16 ** -0.5) < 0.03
    assert abs(params["w_x"].std().item() - 32 ** -0.5) < 0.03
    with pytest.raises(ValueError):
        trec.rglru_param_shapes(32, 64, 4, gate_blocks=5)


# ---------------------------------------------------------------- dense KV
def _kv(rng, b, s, kvh=1, hd=16):
    return (rng.standard_normal((b, s, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, s, kvh, hd)).astype(np.float32))


def _cache_pair(k, v, length):
    return (jattn.KVCache(_j(k), _j(v), _j(np.asarray(length, np.int32))),
            tattn.KVCache(_t(k), _t(v),
                          _t(np.asarray(length, np.int32))))


def _same_cache(ct, cj, atol=0.0):
    _close(ct.k, cj.k, atol)
    _close(ct.v, cj.v, atol)
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))


@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_ring_and_write_mask(window):
    """Lengths before, at and past the ring's wrap (16), one frozen row."""
    rng = np.random.RandomState(window + 1)
    b, h = 4, 4
    k, v = _kv(rng, b, 16 if window else 40)
    length = [3, 15, 16, 37] if window else [0, 15, 16, 38]
    q = rng.standard_normal((b, 1, h, 16)).astype(np.float32)
    nk, nv = _kv(rng, b, 1)
    wm = np.asarray([True, True, False, True])
    cj, ct = _cache_pair(k, v, length)
    oj, cj = jattn.decode_attention(_j(q), _j(nk), _j(nv), cj, window=window,
                                    write_mask=_j(wm))
    ot, ct = tattn.decode_attention(_t(q), _t(nk), _t(nv), ct, window=window,
                                    write_mask=_t(wm))
    _close(ot.numpy()[wm], np.asarray(oj)[wm], ATOL_BLOCK)
    _same_cache(ct, cj)
    np.testing.assert_array_equal(ct.k[2].numpy(), k[2])   # frozen row


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("offset,length", [(0, 12), (9, 12), (20, 5),
                                           (30, 12)])
def test_chunk_attention_matches_jax(window, offset, length):
    """A chunk of 12 rows (``length`` real) resuming at ``offset``: the
    full-attention arm writes at offset, the ring arm attends over the prior
    ring and the chunk before it overwrites slots."""
    rng = np.random.RandomState(offset + length + window)
    b, c, h = 2, 12, 4
    k0, v0 = _kv(rng, b, 16 if window else 48)
    q = rng.standard_normal((b, c, h, 16)).astype(np.float32)
    k, v = _kv(rng, b, c)
    off = np.asarray([offset, max(offset - 3, 0)], np.int32)
    ln = np.asarray([length, max(length - 4, 1)], np.int32)
    cj, ct = _cache_pair(k0, v0, off)
    oj, cj = jattn.chunk_attention(_j(q), _j(k), _j(v), cj, offset=_j(off),
                                   length=_j(ln), window=window)
    ot, ct = tattn.chunk_attention(_t(q), _t(k), _t(v), ct, offset=_t(off),
                                   length=_t(ln), window=window)
    real = np.arange(c)[None] < ln[:, None]
    _close(ot.numpy()[real], np.asarray(oj)[real], ATOL_BLOCK)
    _same_cache(ct, cj)


@pytest.mark.parametrize("window,smax,s,lengths", [
    (16, 16, 24, (24, 7, 16)),      # ring, wrapped and not
    (0, 32, 24, (24, 7, 16)),       # left-aligned with lengths
    (16, 16, 24, None),             # longer than the ring: keep the tail
    (0, 32, 24, None)])
def test_fill_cache_matches_jax(window, smax, s, lengths):
    rng = np.random.RandomState(s + smax)
    k, v = _kv(rng, 3, s)
    k0, v0 = _kv(rng, 3, smax)
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    cj, ct = _cache_pair(k0, v0, [0, 0, 0])
    cj = jax_fill_cache(cj, _j(k), _j(v), window=window,
                        length=None if ln is None else _j(ln))
    ct = _fill_cache(ct, _t(k), _t(v), window=window,
                     length=None if ln is None else _t(ln))
    _same_cache(ct, cj)


def test_local_attention_matches_jax_and_flash():
    rng = np.random.RandomState(4)
    q = rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
    k, v = _kv(rng, 2, 48)
    oj = jattn.local_attention(_j(q), _j(k), _j(v), window=16)
    ot = tattn.local_attention(_t(q), _t(k), _t(v), window=16)
    _close(ot, oj, ATOL_BLOCK)
    # the same function as flash with a window mask
    _close(ot, tattn.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                     window=16), ATOL_BLOCK)
    with pytest.raises(ValueError):
        tattn.local_attention(_t(q)[:, :40], _t(k)[:, :40], _t(v)[:, :40],
                              window=16)


# ------------------------------------------------------------------ bridge
def test_bridge_copies_rec_and_local_leaves_exactly():
    _, _, tree = lively_params("float32", arch="recurrentgemma-2b")
    tm = from_jax_params(tree, reduced_config("recurrentgemma-2b").replace(
        compute_dtype="float32"), "cpu")
    assert [b.kind for b in tm.layers] == ["rec", "rec", "local", "rec",
                                           "rec"]
    layers = [(tree["groups"][str(j)], 0) for j in range(3)] \
        + [(t, None) for t in tree["tail"]]
    for blk, (lt, g) in zip(tm.layers, layers):
        def leaf(a):
            return a if g is None else a[g]
        np.testing.assert_array_equal(blk.ln1.numpy(),
                                      leaf(lt["ln1"]["scale"]))
        for part in blk.PARTS:
            for name, p in getattr(blk, part).items():
                np.testing.assert_array_equal(p.numpy(),
                                              leaf(lt[part][name]))
    assert tm.layers[0].rec["lambda"].dtype == torch.float32


def test_bridge_keeps_lambda_float32_under_bf16():
    _, _, tree = lively_params("bfloat16", arch="recurrentgemma-2b")
    tm = from_jax_params(tree, reduced_config("recurrentgemma-2b"), "cpu")
    rec = tm.layers[0].rec
    assert rec["lambda"].dtype == torch.float32
    assert rec["w_a"].dtype == rec["w_x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(rec["lambda"].numpy(),
                                  tree["groups"]["0"]["rec"]["lambda"][0])


def test_bridge_rejects_a_block_of_another_kind():
    _, _, tree = lively_params("float32", arch="recurrentgemma-2b")
    cfg = reduced_config("recurrentgemma-2b").replace(
        compute_dtype="float32", block_pattern=("rec", "local", "local"))
    with pytest.raises(ValueError, match="JAX block holds"):
        from_jax_params(tree, cfg, "cpu")
