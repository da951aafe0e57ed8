"""The port's falcon-mamba pieces against the JAX package on the CPU,
float32, from seeded numpy inputs, on reduced falcon-mamba-7b (d_model 64,
d_inner 128, d_state 4, dt_rank 8, 2 ssm layers): the selective scan's plain
version against the Pallas kernel (interpret mode) and the jnp oracle, and
against ``mamba_ssm``'s XLA route with a carried state and ragged lengths;
``mamba_block``; ``init_mamba_block``; the weight bridge for ``ssm``
blocks; the model's forward, prefill (right-padded and chunked) and decode
step; and ``ServeEngine`` against the JAX engine.  The CUDA kernel's own
tests are in test_torch_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.pavlov_ssm import pavlov_ssm_raw as jax_ssm_raw  # noqa: E402
from repro.kernels.pavlov_ssm import pavlov_ssm_ref as jax_ssm_scan  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import pavlov_ssm as ps  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

from test_torch_gpu import _ssm_inputs  # noqa: E402
from test_torch_model import _compare_states, lively_params  # noqa: E402

FM = "falcon-mamba-7b"
D_MODEL, D_INNER, D_STATE, DT_RANK = 64, 128, 4, 8
MAX_LEN = 64
# float32 on both sides: the scans multiply and add in the same order, the
# sums over N and the projections in other orders
ATOL = 1e-5
# the weights of the served model: the init's, beside random norm scales
# (the qwen3 tests triple theirs so greedy tokens vary; the ssm stack's
# tokens vary at its init)
FM_GAIN = 1.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), atol=atol, rtol=0)


def _mask(length, s):
    return np.arange(s)[None] < np.asarray(length)[:, None]


# ------------------------------------------------------------------ the scan
@pytest.mark.parametrize("b,t,d,n,bt,bd", [
    (2, 16, 32, 4, 8, 16), (1, 32, 64, 8, 16, 64), (2, 8, 16, 16, 8, 16),
    (2, 12, D_INNER, D_STATE, 4, 64)])
def test_plain_ssm_matches_pallas_and_oracle(b, t, d, n, bt, bd):
    """From h0 = 0 and with no mask, the TPU kernel's function."""
    c = _ssm_inputs(np.random.RandomState(t + d), b, t, d, n)
    args = [c[k] for k in ("delta", "x", "bc", "cc", "a", "d_skip")]
    y, h_t = ps.pavlov_ssm(*map(_t, args))
    assert y.dtype == torch.float32 and y.shape == (b, t, d)
    assert h_t.dtype == torch.float32 and h_t.shape == (b, d, n)
    _close(y, jax_ssm_raw(*map(_j, args), block_t=bt, block_d=bd,
                          interpret=True))
    _close(y, jax_ssm_scan(*map(_j, args)))


def _mamba_params(seed=0):
    p = jrec.init_mamba_block(jax.random.PRNGKey(seed), D_MODEL, D_INNER,
                              D_STATE, 4, DT_RANK)
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("s", [1, 20])
def test_plain_ssm_matches_mamba_ssm_with_state_and_lengths(s):
    """A random h0 and ragged lengths with a 0 against the masked XLA
    route: y at every position (padded ones too) and h_T; the 0-length row
    keeps h0 bit for bit."""
    jp, tp = _mamba_params(1)
    rng = np.random.RandomState(s)
    x = rng.standard_normal((3, s, D_INNER)).astype(np.float32)
    h0 = (rng.standard_normal((3, D_INNER, D_STATE)) * 0.5).astype(
        np.float32)
    length = np.asarray([s, max(s - 9, 1), 0], np.int32)
    yj, hj = jrec.mamba_ssm(jp, _j(x), DT_RANK, D_STATE, _j(h0), chunk=8,
                            seq_mask=_j(_mask(length, s)), impl="xla")
    yt, ht = trec.mamba_ssm(tp, _t(x), DT_RANK, D_STATE, _t(h0), _t(length))
    _close(yt, yj)
    _close(ht, hj)
    np.testing.assert_array_equal(ht[2].numpy(), h0[2])


def test_plain_ssm_keeps_bf16_outputs_and_a_float32_state():
    c = _ssm_inputs(np.random.RandomState(3), 2, 10, 32, 4)
    ins = [_t(c[k]).bfloat16() for k in ("delta", "x", "bc", "cc")]
    y, h_t = ps.pavlov_ssm(*ins, _t(c["a"]), _t(c["d_skip"]), _t(c["h0"]),
                           _t(c["length"]))
    assert y.dtype == torch.bfloat16 and h_t.dtype == torch.float32
    yf, hf = ps.pavlov_ssm(*(v.float() for v in ins), _t(c["a"]),
                           _t(c["d_skip"]), _t(c["h0"]), _t(c["length"]))
    assert torch.equal(h_t, hf) and torch.equal(y, yf.bfloat16())


# ---------------------------------------------------------------- the block
def test_mamba_block_matches_jax():
    """Prefill from a carried state with lengths (one row 0), then a
    resumed segment from the returned state: outputs, conv and h."""
    jp, tp = _mamba_params(2)
    rng = np.random.RandomState(2)
    x = rng.standard_normal((3, 16, D_MODEL)).astype(np.float32)
    state = {"conv": rng.standard_normal((3, 3, D_INNER)).astype(np.float32),
             "h": (rng.standard_normal((3, D_INNER, D_STATE)) * 0.5).astype(
                 np.float32)}
    ln = np.asarray([16, 6, 0], np.int32)
    kw = dict(d_state=D_STATE, dt_rank=DT_RANK)
    oj, sj = jrec.mamba_block(jp, _j(x), chunk=8, return_state=True,
                              state={k: _j(v) for k, v in state.items()},
                              length=_j(ln), **kw)
    ot, st = trec.mamba_block(tp, _t(x),
                              state={k: _t(v) for k, v in state.items()},
                              length=_t(ln), **kw)
    _close(ot, oj)
    for k in ("conv", "h"):
        _close(st[k], sj[k])
        np.testing.assert_array_equal(st[k][2].numpy(), state[k][2])
    x2 = rng.standard_normal((3, 5, D_MODEL)).astype(np.float32)
    oj, sj = jrec.mamba_block(jp, _j(x2), state=sj, return_state=True, **kw)
    ot, st = trec.mamba_block(tp, _t(x2), state=st, **kw)
    _close(ot, oj)
    for k in ("conv", "h"):
        _close(st[k], sj[k])


def test_init_mamba_block_draws_jax_distributions():
    jp, _ = _mamba_params()
    shapes = trec.mamba_param_shapes(D_MODEL, D_INNER, D_STATE, 4, DT_RANK)
    assert shapes == {k: tuple(v.shape) for k, v in jp.items()}
    params = {k: torch.empty(s) for k, s in shapes.items()}
    trec.init_mamba_block(params, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(params["a_log"].numpy(),
                                  np.asarray(jp["a_log"]))
    assert torch.equal(params["d_skip"], torch.ones(D_INNER))
    dt = torch.nn.functional.softplus(params["dt_bias"])
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 1e-1 * (1 + 1e-5)))
                .all())
    assert dt.std() > 0.02          # spread over the range, not one value
    for name, std in (("in_proj", D_MODEL ** -0.5), ("conv_w", 0.5),
                      ("x_proj", D_INNER ** -0.5), ("dt_proj", DT_RANK ** -0.5),
                      ("out_proj", D_INNER ** -0.5)):
        assert abs(params[name].std().item() - std) < 0.1 * std, name
        assert abs(params[name].mean().item()) < 0.1 * std, name


# ------------------------------------------------------------------ bridge
def _fm_port(compute_dtype="float32"):
    jm, jp, tree = lively_params(compute_dtype, arch=FM, gain=FM_GAIN)
    return jm, jp, tree, from_jax_params(
        tree, reduced_config(FM).replace(compute_dtype=compute_dtype), "cpu")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_bridge_copies_every_ssm_leaf_exactly(compute_dtype):
    """Every leaf, in float32 where ``mamba_ssm`` reads it so, the matmul
    weights in the compute dtype."""
    _, _, tree, tm = _fm_port(compute_dtype)
    assert [b.kind for b in tm.layers] == ["ssm", "ssm"]
    g = tree["groups"]["0"]
    for i, blk in enumerate(tm.layers):
        np.testing.assert_array_equal(blk.ln1.numpy(), g["ln1"]["scale"][i])
        assert not hasattr(blk, "ln2")
        assert set(blk.ssm.keys()) == set(g["ssm"])
        for name, p in blk.ssm.items():
            want = np.asarray(g["ssm"][name][i])
            f32 = name in trec.MAMBA_F32 or compute_dtype == "float32"
            assert p.dtype == (torch.float32 if f32 else torch.bfloat16)
            np.testing.assert_array_equal(
                p.float().numpy(),
                want if f32 else _t(want).bfloat16().float().numpy())


@pytest.mark.parametrize("tree_arch,cfg_arch", [(FM, "qwen3-0.6b"),
                                                ("qwen3-0.6b", FM)])
def test_bridge_refuses_a_block_of_another_kind(tree_arch, cfg_arch):
    """Both reduced stacks have 2 layers of width 64 over a 512 vocab, so
    only the block kind tells them apart."""
    _, _, tree = lively_params("float32", arch=tree_arch)
    with pytest.raises(ValueError, match="JAX block holds"):
        from_jax_params(tree, reduced_config(cfg_arch).replace(
            compute_dtype="float32"), "cpu")


def test_bridge_refuses_an_ssm_block_with_a_second_norm():
    _, _, tree = lively_params("float32", arch=FM)
    g = tree["groups"]["0"]
    g["ln2"] = g["ln1"]
    with pytest.raises(ValueError, match="port expects ln1, ssm"):
        from_jax_params(tree, reduced_config(FM).replace(
            compute_dtype="float32"), "cpu")


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def fm_pair():
    jm, jp, _, tm = _fm_port()
    return jm, jp, tm


@pytest.mark.parametrize("s", [1, 12, 33])
def test_forward_matches_jax(fm_pair, s):
    jm, jp, tm = fm_pair
    toks = np.random.RandomState(s).randint(0, 512, (2, s))
    lj, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    _close(tm(torch.from_numpy(toks)), lj, 1e-4)


def test_prefill_chunk_and_decode_match_jax(fm_pair):
    """Right-padded prefill (lengths 5 and 20), a 14-token chunk of row 1
    resuming at offset 20, then 12 decode steps with a frozen row now and
    then — logits, conv and h against JAX."""
    from repro.serve.engine import _gather_slot as jax_gather
    from repro.serve.engine import _splice_states as jax_splice
    from repro_torch.serve.engine import _gather_slot, _splice_states
    jm, jp, tm = fm_pair
    rng = np.random.RandomState(5)
    toks = rng.randint(1, 512, (2, 20))
    lens = np.asarray([5, 20], np.int32)
    js = jm.init_states(2, MAX_LEN)
    ts = tm.init_states(2, MAX_LEN)
    assert ts[0].rec["h"].shape == (2, D_INNER, D_STATE)
    assert ts[0].rec["conv"].shape == (2, 3, D_INNER)
    lj, js, _ = jm.prefill(jp, jnp.asarray(toks, jnp.int32), js,
                           length=jnp.asarray(lens))
    lt, ts = tm.prefill(torch.from_numpy(toks), ts,
                        length=torch.from_numpy(lens))
    _close(lt, lj, 1e-4)
    _compare_states(js, jm, ts, slice(None), 1e-4)

    chunk = rng.randint(1, 512, (1, 16))
    off, n = np.asarray([20], np.int32), np.asarray([14], np.int32)
    row_j = jax_gather(js, jnp.asarray(1, jnp.int32))
    lj, row_j, _ = jm.prefill(jp, jnp.asarray(chunk, jnp.int32), row_j,
                              length=jnp.asarray(n), offset=jnp.asarray(off))
    js = jax_splice(js, row_j, jnp.asarray(1, jnp.int32))
    lt, row_t = tm.prefill(torch.from_numpy(chunk), _gather_slot(ts, 1),
                           length=torch.from_numpy(n),
                           offset=torch.from_numpy(off))
    _splice_states(ts, row_t, [1])
    _close(lt, lj, 1e-4)
    _compare_states(js, jm, ts, slice(None), 1e-4)

    pos = np.asarray([5, 34], np.int32)
    tok = rng.randint(1, 512, (2, 1))
    jdecode = jax.jit(jm.decode_step)
    for step in range(12):
        act = np.asarray([step % 5 != 2, step % 7 != 3])
        lj, js = jdecode(jp, jnp.asarray(tok, jnp.int32), js,
                         jnp.asarray(pos), active=jnp.asarray(act))
        lt, ts = tm.decode_step(torch.from_numpy(tok), ts,
                                torch.from_numpy(pos),
                                active=torch.from_numpy(act))
        _close(lt.numpy()[act], np.asarray(lj)[act], 1e-4)
        _compare_states(js, jm, ts, slice(None), 1e-4)
        pos = pos + act
        tok = np.asarray(lj).argmax(-1).astype(np.int64)


def test_chunked_prefill_equals_one_shot(fm_pair):
    """Inside the port: a 40-token prompt prefilled in chunks of 16 leaves
    the last logits, conv and h where one-shot prefill leaves them."""
    _, _, tm = fm_pair
    prompt = np.random.RandomState(6).randint(1, 512, (1, 40))
    one = tm.init_states(1, MAX_LEN)
    lo, one = tm.prefill(torch.from_numpy(prompt), one,
                         length=torch.tensor([40], dtype=torch.int32))
    chunked = tm.init_states(1, MAX_LEN)
    for off in (0, 16, 32):
        piece = np.zeros((1, 16), np.int64)
        n = min(16, 40 - off)
        piece[0, :n] = prompt[0, off:off + n]
        lc, chunked = tm.prefill(
            torch.from_numpy(piece), chunked,
            length=torch.tensor([n], dtype=torch.int32),
            offset=torch.tensor([off], dtype=torch.int32))
    torch.testing.assert_close(lc, lo, atol=1e-5, rtol=0)
    assert int(lc.argmax()) == int(lo.argmax())
    for a, b in zip(one, chunked):
        for k in ("conv", "h"):
            torch.testing.assert_close(a.rec[k], b.rec[k], atol=1e-5, rtol=0)


def test_inactive_rows_keep_every_bit(fm_pair):
    _, _, tm = fm_pair
    st = tm.init_states(2, MAX_LEN)
    toks = torch.from_numpy(np.random.RandomState(7).randint(1, 512, (2, 9)))
    _, st = tm.prefill(toks, st, length=torch.tensor([9, 6],
                                                     dtype=torch.int32))
    before = [{k: v.clone() for k, v in s.rec.items()} for s in st]
    _, st = tm.decode_step(torch.tensor([[3], [4]]), st, torch.tensor([9, 6]),
                           active=torch.tensor([False, True]))
    for old, s in zip(before, st):
        for k in ("conv", "h"):
            assert torch.equal(old[k][0], s.rec[k][0])     # row 0 frozen
            assert not torch.equal(old[k][1], s.rec[k][1])  # row 1 moved


# ------------------------------------------------------------------ engine
# 2 slots for 5 requests (slots are recycled mid-run); the 40-token prompt
# is longer than the largest bucket, so it runs as chunks of 16
FM_KW = dict(slots=2, max_len=96, buckets=(16, 32), prefill_chunk=16)


def _serve(engine, request_cls):
    rng = np.random.RandomState(3)
    reqs = [request_cls(rid=i, prompt=rng.randint(1, 512, n).tolist(),
                        max_new_tokens=16)
            for i, n in enumerate((5, 40, 12, 9, 20))]
    engine.run(reqs)
    return [r.generated for r in reqs]


def test_engine_matches_jax_engine(fm_pair):
    jm, jp, tm = fm_pair
    jax_engine = JaxEngine(jm, jp, **FM_KW)
    want = _serve(jax_engine, JaxRequest)
    engine = ServeEngine(tm, **FM_KW)
    engine.warmup()
    got = _serve(engine, Request)
    assert got == want
    assert len({tuple(g) for g in got}) == len(got)    # tokens vary
    js, ts = jax_engine.stats, engine.stats
    assert (ts.prefill_calls, ts.prefill_chunks, ts.decode_steps) \
        == (js.prefill_calls, js.prefill_chunks, js.decode_steps)
    s = engine.stats.summary()
    assert s["requests_completed"] == 5 and s["nonfinite_logits"] == 0
    assert s["prefill_chunks"] == 3 and s["prefills_chunked"] == 1
    assert "kv" not in s


def test_cli_serves_falcon_mamba(capsys):
    from repro_torch.launch.serve import main
    s = main(["--arch", FM, "--reduced", "--device", "cpu",
              "--kv-block-size", "0", "--max-len", "64", "--requests", "3"])
    assert s["requests_completed"] == 3 and s["nonfinite_logits"] == 0
    assert s["tokens_generated"] == 48 and "kv" not in s
    assert '"requests_completed": 3' in capsys.readouterr().out


# ------------------------------------------------------------- the wrapper
def test_cpu_tensors_never_launch_and_raw_refuses_them():
    c = _ssm_inputs(np.random.RandomState(0), 2, 4, 8, 4)
    args = [_t(c[k]) for k in ("delta", "x", "bc", "cc", "a", "d_skip")]
    before = (ps.launches.n, ps.decode_launches.n)
    ps.pavlov_ssm(*args)
    assert (ps.launches.n, ps.decode_launches.n) == before
    with pytest.raises(ValueError, match="CUDA"):
        ps.pavlov_ssm_raw(*args)
