"""The port's qwen3 model against the JAX ``Model`` on reduced qwen3-0.6b:
the weight bridge, ``forward``, right-padded ``prefill``, chunked
``prefill(offset=)`` and ``decode_step(active=)`` logits and paged pools —
float32 at a tight tolerance, bf16 at a looser one — plus the port's own
invariants (chunked equals one-shot; inactive rows freeze the pool)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "qwen3-0.6b"
MAX_LEN, BS = 64, 8
NB = MAX_LEN // BS
# float32: XLA and PyTorch take sums, pow and cos in other orders/ulps
ATOL_F32 = 1e-4
# bf16: both round every activation to 8 bits, at different places; the
# bound is a fraction of the logits' scale (|logits| reaches ~20 here)
ATOL_BF16 = 0.25


def lively_params(compute_dtype: str, seed: int = 0, arch: str = ARCH,
                  gain: float = 3.0, **cfg_kw):
    """JAX model + params with non-trivial norms and ``gain`` x weights, so
    greedy tokens vary (qwen3's default init decodes one token over and
    over).  The RG-LRU's ``lambda`` keeps its init, so ``a`` stays in
    [0.9, 0.999]."""
    cfg = jax_reduced(arch).replace(compute_dtype=compute_dtype, **cfg_kw)
    model = jax_build(cfg)
    rng = np.random.RandomState(seed)

    def lively(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "scale" in name or "norm" in name:
            return rng.normal(0, 0.5, a.shape).astype(np.float32)
        if "lambda" in name:
            return a.astype(np.float32)
        return (a * gain).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(
        lively, model.init(jax.random.PRNGKey(seed)))
    return model, jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dt = request.param
    jm, jp, tree = lively_params(dt)
    tm = from_jax_params(tree, reduced_config(ARCH).replace(compute_dtype=dt),
                         "cpu")
    return dt, jm, jp, tree, tm


def _atol(dt):
    return ATOL_F32 if dt == "float32" else ATOL_BF16


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def test_bridge_copies_every_leaf_exactly():
    _, _, tree = lively_params("float32")
    tm = from_jax_params(tree, reduced_config(ARCH).replace(
        compute_dtype="float32"), "cpu")
    np.testing.assert_array_equal(tm.embed.numpy(), tree["embed"])
    np.testing.assert_array_equal(tm.final_norm.numpy(),
                                  tree["final_norm"]["scale"])
    g = tree["groups"]["0"]
    for i, blk in enumerate(tm.layers):
        np.testing.assert_array_equal(blk.ln1.numpy(), g["ln1"]["scale"][i])
        np.testing.assert_array_equal(blk.ln2.numpy(), g["ln2"]["scale"][i])
        for part in ("attn", "ffn"):
            for name, p in getattr(blk, part).items():
                np.testing.assert_array_equal(p.numpy(), g[part][name][i])


def test_bridge_rejects_a_mismatched_tree():
    _, _, tree = lively_params("float32")
    with pytest.raises(ValueError):
        from_jax_params(tree, reduced_config(ARCH).replace(num_layers=3),
                        "cpu")


def test_forward_matches_jax(pair):
    dt, jm, jp, _, tm = pair
    toks = np.random.RandomState(1).randint(0, 512, (2, 12))
    lj, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    lt = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=_atol(dt), rtol=0)


def _states(jm, tm, batch):
    js = jm.init_states(batch, MAX_LEN, kv_block_size=BS,
                        kv_blocks=batch * NB)
    ts = tm.init_states(batch, MAX_LEN, kv_block_size=BS,
                        kv_blocks=batch * NB)
    return js, ts


def _compare_pools(dt, js, ts):
    kv = js["groups"]["0"].kv
    for i, st in enumerate(ts):
        c = st.kv
        np.testing.assert_allclose(_np(c.k), _np(kv.k[i]), atol=_atol(dt),
                                   rtol=0)
        np.testing.assert_allclose(_np(c.v), _np(kv.v[i]), atol=_atol(dt),
                                   rtol=0)
        np.testing.assert_array_equal(c.length.numpy(),
                                      np.asarray(kv.length[i]))


def test_prefill_chunk_and_decode_match_jax(pair):
    """Right-padded prefill, a chunk continuation of one row, then decode
    steps with an inactive row — logits, pools and lengths."""
    dt, jm, jp, _, tm = pair
    rng = np.random.RandomState(2)
    toks = rng.randint(1, 512, (2, 16))
    lens = np.asarray([5, 16], np.int32)
    table = np.arange(2 * NB, dtype=np.int32).reshape(2, NB)
    table[0, 4:] = 2 * NB                       # sentinel tail
    js, ts = _states(jm, tm, 2)
    lj, js, _ = jm.prefill(jp, jnp.asarray(toks, jnp.int32), js,
                           length=jnp.asarray(lens),
                           block_table=jnp.asarray(table))
    lt, ts = tm.prefill(torch.from_numpy(toks), ts,
                        length=torch.from_numpy(lens),
                        block_table=torch.from_numpy(table))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=_atol(dt), rtol=0)
    _compare_pools(dt, js, ts)

    # chunk continuation: row 1 continues at offset 16 with 7 more tokens
    chunk = rng.randint(1, 512, (1, 8))
    off, n = np.asarray([16], np.int32), np.asarray([7], np.int32)
    row_j = jax.tree.map(lambda a: a, js)
    row_j["groups"]["0"] = row_j["groups"]["0"]._replace(
        kv=row_j["groups"]["0"].kv._replace(
            length=row_j["groups"]["0"].kv.length[:, 1:2]))
    lj, row_j, _ = jm.prefill(jp, jnp.asarray(chunk, jnp.int32), row_j,
                              length=jnp.asarray(n), offset=jnp.asarray(off),
                              block_table=jnp.asarray(table[1:2]))
    row_t = [st._replace(kv=st.kv._replace(length=st.kv.length[1:2]))
             for st in ts]
    lt, row_t = tm.prefill(torch.from_numpy(chunk), row_t,
                           length=torch.from_numpy(n),
                           offset=torch.from_numpy(off),
                           block_table=torch.from_numpy(table[1:2]))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=_atol(dt), rtol=0)
    kvj = row_j["groups"]["0"].kv
    js["groups"]["0"] = js["groups"]["0"]._replace(kv=kvj._replace(
        length=js["groups"]["0"].kv.length.at[:, 1].set(kvj.length[:, 0])))
    for c, r in zip(ts, row_t):
        c.kv.length[1] = r.kv.length[0]
    _compare_pools(dt, js, ts)

    pos = np.asarray([5, 23], np.int32)
    tok = rng.randint(1, 512, (2, 1))
    for active in ([True, True], [False, True], [True, False]):
        act = np.asarray(active)
        lj, js = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), js,
                                jnp.asarray(pos), active=jnp.asarray(act),
                                block_table=jnp.asarray(table))
        lt, ts = tm.decode_step(torch.from_numpy(tok), ts,
                                torch.from_numpy(pos),
                                active=torch.from_numpy(act),
                                block_table=torch.from_numpy(table))
        np.testing.assert_allclose(_np(lt)[act], _np(lj)[act],
                                   atol=_atol(dt), rtol=0)
        _compare_pools(dt, js, ts)
        pos = pos + act
        tok = np.asarray(lj).argmax(-1).astype(np.int64)


def test_chunked_prefill_equals_one_shot():
    """Inside the port: a prompt prefilled in three chunks leaves the pool
    and the last logits where one-shot prefill leaves them."""
    _, _, tree = lively_params("float32")
    tm = from_jax_params(tree, reduced_config(ARCH).replace(
        compute_dtype="float32"), "cpu")
    prompt = np.random.RandomState(3).randint(1, 512, (1, 21))
    table = torch.arange(NB, dtype=torch.int32)[None]
    one = tm.init_states(1, MAX_LEN, kv_block_size=BS)
    lo, one = tm.prefill(torch.from_numpy(prompt), one,
                         length=torch.tensor([21], dtype=torch.int32),
                         block_table=table)
    chunked = tm.init_states(1, MAX_LEN, kv_block_size=BS)
    for off in (0, 8, 16):
        piece = np.zeros((1, 8), np.int64)
        n = min(8, 21 - off)
        piece[0, :n] = prompt[0, off:off + n]
        lc, chunked = tm.prefill(
            torch.from_numpy(piece), chunked,
            length=torch.tensor([n], dtype=torch.int32),
            offset=torch.tensor([off], dtype=torch.int32), block_table=table)
    torch.testing.assert_close(lc, lo, atol=1e-5, rtol=0)
    assert int(lc.argmax()) == int(lo.argmax())
    for a, b in zip(one, chunked):
        torch.testing.assert_close(a.kv.k, b.kv.k, atol=1e-5, rtol=0)
        torch.testing.assert_close(a.kv.v, b.kv.v, atol=1e-5, rtol=0)
        assert torch.equal(a.kv.length, b.kv.length)


def test_inactive_rows_leave_the_pool_bit_for_bit():
    _, _, tree = lively_params("float32")
    tm = from_jax_params(tree, reduced_config(ARCH).replace(
        compute_dtype="float32"), "cpu")
    table = torch.arange(2 * NB, dtype=torch.int32).reshape(2, NB)
    st = tm.init_states(2, MAX_LEN, kv_block_size=BS)
    toks = torch.from_numpy(np.random.RandomState(4).randint(1, 512, (2, 9)))
    _, st = tm.prefill(toks, st, length=torch.tensor([9, 6],
                                                     dtype=torch.int32),
                       block_table=table)
    before = [(c.kv.k.clone(), c.kv.v.clone(), c.kv.length.clone())
              for c in st]
    _, st = tm.decode_step(torch.tensor([[3], [4]]), st,
                           torch.tensor([9, 6]),
                           active=torch.tensor([False, True]),
                           block_table=table)
    for (k, v, length), c in zip(before, (s.kv for s in st)):
        assert torch.equal(c.k[:NB], k[:NB])       # slot 0's blocks
        assert torch.equal(c.v[:NB], v[:NB])
        assert not torch.equal(c.k[NB:], k[NB:])   # slot 1 wrote
        assert c.length.tolist() == [length[0].item(), length[1].item() + 1]


def test_model_defaults_to_the_card_and_never_falls_back():
    cfg = reduced_config(ARCH)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "falcon-mamba-7b",
                                  "starcoder2-7b", "phi3.5-moe-42b-a6.6b"])
def test_other_block_kinds_raise(arch):
    cfg = reduced_config(arch)
    bad = [cfg]
    if arch == "recurrentgemma-2b":
        # its rec and local blocks are ported: a hybrid that mixes in a
        # block kind still to port must raise
        bad = [cfg.replace(block_pattern=("rec", "ssm", "local"))]
    if arch == "falcon-mamba-7b":
        # its ssm stack is ported: ssm blocks beside a GLU feed-forward,
        # and an attn block in a stack without one, must raise
        bad = [cfg.replace(ffn_kind="glu", d_ff=128),
               cfg.replace(block_pattern=("ssm", "attn"))]
    if arch == "starcoder2-7b":
        # its LayerNorm and MLP are ported, an encoder in front of it
        # builds (tests/test_torch_train.py), and so does an MoE
        # feed-forward on its attn stack: an MoE behind an encoder, an enc
        # block inside the decoder stack and a dec block with no encoder
        # to attend to must raise
        build_model(cfg.replace(ffn_kind="moe", num_experts=4, top_k=2),
                    device="cpu")
        bad = [cfg.replace(ffn_kind="moe", num_experts=4, top_k=2,
                           block_pattern=("dec",), enc_layers=2),
               cfg.replace(block_pattern=("attn", "enc")),
               cfg.replace(block_pattern=("attn", "dec"))]
    if arch == "phi3.5-moe-42b-a6.6b":
        # its MoE feed-forward is ported on attn stacks: an MoE on a stack
        # with ssm (or rec) blocks, and in an encoder-decoder, must raise
        build_model(cfg, device="cpu")
        bad = [cfg.replace(block_pattern=("ssm",), d_inner=128, d_state=4,
                           dt_rank=8),
               cfg.replace(block_pattern=("attn", "ssm"), d_inner=128,
                           d_state=4, dt_rank=8),
               cfg.replace(block_pattern=("rec", "attn"), d_rnn=64),
               cfg.replace(block_pattern=("dec",), enc_layers=2)]
    for c in bad:
        with pytest.raises(NotImplementedError):
            build_model(c, device="cpu")


def test_init_draws_from_the_generator():
    cfg = reduced_config(ARCH)
    a = build_model(cfg, device="cpu", seed=7)
    b = build_model(cfg, device="cpu", seed=7)
    c = build_model(cfg, device="cpu", seed=8)
    assert torch.equal(a.layers[0].attn["wq"], b.layers[0].attn["wq"])
    assert not torch.equal(a.layers[0].attn["wq"], c.layers[0].attn["wq"])
    assert torch.all(a.layers[0].ln1 == 0)
    tok = torch.tensor([[1, 2, 3]])
    assert torch.isfinite(a(tok)).all()


# ----------------------------------------------- recurrentgemma (rec + local)
RG = "recurrentgemma-2b"        # reduced: 5 layers (rec, rec, local, rec,
RG_MAX_LEN = 64                 # rec), window 16, 10 q heads / 1 kv head
# recurrentgemma keeps its init's weights (gain 1) beside random norms:
# tripled, its residual stream reaches ~300 and float32 rounding in the
# gates and the recurrence grows past ATOL_F32 on the logits
RG_GAIN = 1.0


def _jax_layers(jm, js):
    """The JAX state tree as one state per layer, in layer order."""
    out = [jax.tree.map(lambda a, g=g: a[g], js["groups"][str(j)])
           for g in range(jm.n_groups) for j in range(len(jm.pattern))]
    return out + list(js["tail"])


def _compare_states(js, jm, ts, rows, atol):
    """Per layer: ring/cache K, V and length, or conv and h, on ``rows``."""
    for i, (sj, st) in enumerate(zip(_jax_layers(jm, js), ts)):
        if st.kv is not None:
            for a, b in ((st.kv.k, sj.kv.k), (st.kv.v, sj.kv.v)):
                np.testing.assert_allclose(_np(a)[rows], _np(b)[rows],
                                           atol=atol, rtol=0,
                                           err_msg=f"layer {i}")
            np.testing.assert_array_equal(st.kv.length.numpy(),
                                          np.asarray(sj.kv.length))
        else:
            for key in ("conv", "h"):
                np.testing.assert_allclose(
                    _np(st.rec[key])[rows], _np(sj.rec[key])[rows],
                    atol=atol, rtol=0, err_msg=f"layer {i} {key}")


@pytest.fixture(scope="module", params=["pallas", "xla"])
def rg_pair(request):
    """Reduced recurrentgemma in float32: the JAX model with the RG-LRU
    through the Pallas kernel (interpret mode) or the XLA scan, and the port
    from the same weights."""
    jm, jp, tree = lively_params("float32", arch=RG, gain=RG_GAIN,
                                 rglru_impl=request.param)
    tm = from_jax_params(tree, reduced_config(RG).replace(
        compute_dtype="float32"), "cpu")
    return jm, jp, tm


@pytest.mark.parametrize("s", [12, 32])     # flash with a window; by chunks
def test_recurrentgemma_forward_matches_jax(rg_pair, s):
    jm, jp, tm = rg_pair
    toks = np.random.RandomState(s).randint(0, 512, (2, s))
    lj, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    lt = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=ATOL_F32, rtol=0)


def test_recurrentgemma_prefill_chunk_and_decode_match_jax(rg_pair):
    """Right-padded prefill (lengths 5 and 20), a 14-token chunk of row 1
    across the window, then 20 decode steps past the ring's wrap with a
    frozen row now and then — logits, rings, conv and h against JAX."""
    from repro.serve.engine import _gather_slot as jax_gather
    from repro.serve.engine import _splice_states as jax_splice
    from repro_torch.serve.engine import _gather_slot, _splice_states
    jm, jp, tm = rg_pair
    rng = np.random.RandomState(5)
    toks = rng.randint(1, 512, (2, 20))
    lens = np.asarray([5, 20], np.int32)
    js = jm.init_states(2, RG_MAX_LEN)
    ts = tm.init_states(2, RG_MAX_LEN)
    lj, js, _ = jm.prefill(jp, jnp.asarray(toks, jnp.int32), js,
                           length=jnp.asarray(lens))
    lt, ts = tm.prefill(torch.from_numpy(toks), ts,
                        length=torch.from_numpy(lens))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=ATOL_F32, rtol=0)
    _compare_states(js, jm, ts, slice(None), ATOL_F32)

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
    np.testing.assert_allclose(_np(lt), _np(lj), atol=ATOL_F32, rtol=0)
    _compare_states(js, jm, ts, slice(None), ATOL_F32)

    pos = np.asarray([5, 34], np.int32)
    tok = rng.randint(1, 512, (2, 1))
    jdecode = jax.jit(jm.decode_step)
    for step in range(20):
        act = np.asarray([step % 5 != 2, step % 7 != 3])
        lj, js = jdecode(jp, jnp.asarray(tok, jnp.int32), js,
                         jnp.asarray(pos), active=jnp.asarray(act))
        lt, ts = tm.decode_step(torch.from_numpy(tok), ts,
                                torch.from_numpy(pos),
                                active=torch.from_numpy(act))
        np.testing.assert_allclose(_np(lt)[act], _np(lj)[act],
                                   atol=ATOL_F32, rtol=0)
        _compare_states(js, jm, ts, slice(None), ATOL_F32)
        pos = pos + act
        tok = np.asarray(lj).argmax(-1).astype(np.int64)


def _rg_port(compute_dtype="float32"):
    _, _, tree = lively_params(compute_dtype, arch=RG, gain=RG_GAIN)
    return from_jax_params(tree, reduced_config(RG).replace(
        compute_dtype=compute_dtype), "cpu")


def test_recurrentgemma_chunked_prefill_equals_one_shot():
    """Inside the port: a 40-token prompt (2.5 windows) prefilled in chunks
    of 16 leaves the last logits, the ring, conv and h where one-shot
    prefill leaves them; the RG-LRU carry is bit for bit the same."""
    tm = _rg_port()
    prompt = np.random.RandomState(6).randint(1, 512, (1, 40))
    one = tm.init_states(1, RG_MAX_LEN)
    lo, one = tm.prefill(torch.from_numpy(prompt), one,
                         length=torch.tensor([40], dtype=torch.int32))
    chunked = tm.init_states(1, RG_MAX_LEN)
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
        for x, y in zip(a.kv or a.rec.values(), b.kv or b.rec.values()):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


def test_recurrentgemma_inactive_rows_keep_every_bit():
    """A frozen row keeps its ring (mid-wrap), conv context and h bit for
    bit; the active row's all move."""
    tm = _rg_port()
    st = tm.init_states(2, RG_MAX_LEN)
    toks = torch.from_numpy(np.random.RandomState(7).randint(1, 512, (2, 24)))
    _, st = tm.prefill(toks, st, length=torch.tensor([24, 19],
                                                     dtype=torch.int32))
    before = [[t.clone() for t in (s.kv or s.rec.values())] for s in st]
    _, st = tm.decode_step(torch.tensor([[3], [4]]), st,
                           torch.tensor([24, 19]),
                           active=torch.tensor([False, True]))
    for old, s in zip(before, st):
        new = list(s.kv or s.rec.values())
        for a, b in zip(old, new):
            assert torch.equal(a[0], b[0])               # row 0 frozen
        assert not torch.equal(old[0][1], new[0][1])     # row 1 moved
    assert st[2].kv.length.tolist() == [24, 20]
