"""Marked ``gpu``: each CUDA kernel of the port against its plain version
on the card.  They skip, with the reason, where there is no card.  This
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import jacquard_gemv as jg  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import pascal_matmul as pm  # noqa: E402
from repro_torch.kernels import pavlov_lstm as pl  # noqa: E402
from repro_torch.kernels import pavlov_rglru as pr  # noqa: E402
from repro_torch.kernels import pavlov_ssm as ps  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402


def _randn(rng, *shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _paged_case(rng, B, h, kvh, hd, n, bs, nb):
    """Scattered pools, ragged lengths, sentinel (= n) table entries, and a
    slot whose write block is the sentinel (its write must drop)."""
    perm = rng.permutation(n)
    table = np.full((B, nb), n, np.int32)
    lengths = np.zeros((B,), np.int32)
    off = 0
    for b in range(B):
        owned = min(rng.randint(1, nb + 1), n - off)
        table[b, :owned] = perm[off:off + owned]
        off += owned
        lengths[b] = rng.randint(0, owned * bs)
    # the last slot writes one block past what it owns: a sentinel entry
    owned_last = int((table[-1] < n).sum())
    if owned_last < nb:
        lengths[-1] = owned_last * bs
    return dict(q=_randn(rng, B, 1, h, hd), nk=_randn(rng, B, 1, kvh, hd),
                nv=_randn(rng, B, 1, kvh, hd), kp=_randn(rng, n, bs, kvh, hd),
                vp=_randn(rng, n, bs, kvh, hd), table=table, lengths=lengths)


def _rglru_inputs(rng, b, t, e):
    """float32 decays a in [0.9, 0.999] (the RG-LRU init's range) and
    driving terms scaled by sqrt(1 - a^2), as ``rglru_core`` builds them."""
    a = rng.uniform(0.9, 0.999, (b, t, e))
    drive = rng.standard_normal((b, t, e)) * np.sqrt(1.0 - a * a)
    return a.astype(np.float32), drive.astype(np.float32)


def _ssm_inputs(rng, b, t, d, n):
    """float32 selective-scan inputs in the ranges ``mamba_ssm`` gives them:
    delta = softplus(.) around 0.05, a = -(1..N) per channel (the init's
    ``-exp(a_log)``) scaled by U[0.5, 1.5], x, B, C ~ N(0, 1), d_skip around
    1; a carried h0 and ragged lengths, row 1's 0 (a frozen row)."""
    delta = np.log1p(np.exp(rng.normal(-3.0, 1.0, (b, t, d))))
    a = -np.arange(1, n + 1)[None] * rng.uniform(0.5, 1.5, (d, n))
    length = rng.randint(1, t + 1, b)
    if b > 1:
        length[1] = 0
    return dict(delta=delta.astype(np.float32),
                x=_randn(rng, b, t, d), bc=_randn(rng, b, t, n),
                cc=_randn(rng, b, t, n), a=a.astype(np.float32),
                d_skip=rng.normal(1.0, 0.1, d).astype(np.float32),
                h0=_randn(rng, b, d, n) * 0.5,
                length=length.astype(np.int32))


# ----------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kvh,hd,window", [
    (4, 256, 16, 8, 128, 0), (2, 100, 4, 2, 64, 0), (2, 64, 4, 1, 256, 16),
    (1, 48, 2, 2, 16, 0),
    (2, 256, 10, 1, 256, 2048),     # recurrentgemma's local layers: MQA
    (1, 512, 10, 1, 256, 128),      # ... with a window that binds
    # serving's prefill buckets at qwen3's heads (2 q heads a kv head)
    (4, 16, 16, 8, 128, 0), (4, 32, 16, 8, 128, 0), (2, 64, 16, 8, 128, 0),
    (1, 128, 16, 8, 128, 0),
    (2, 40, 10, 1, 256, 2048)])     # MQA, ragged within a packed tile
def test_flash_kernel_matches_plain_on_card(cuda, dtype, tol, b, s, h, kvh,
                                            hd, window):
    gen = torch.Generator(device=cuda).manual_seed(s + hd)
    q = torch.randn(b, s, h, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, s, kvh, hd, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, s, kvh, hd, generator=gen, device=cuda).to(dtype)
    before = fa.launches.n
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    assert fa.launches.n == before + 1
    ref = fa.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,kvh,hd", [(16, 8, 128), (10, 1, 256)])
def test_flash_kernel_takes_projection_views_on_card(cuda, dtype, tol, h,
                                                     kvh, hd):
    """q, k and v as the model could hand them over: views of one fused
    (B, S, (H + 2 KVH) hd) projection, with its row stride, not copies."""
    b, s = 2, 80
    gen = torch.Generator(device=cuda).manual_seed(h + hd)
    qkv = torch.randn(b, s, (h + 2 * kvh) * hd, generator=gen,
                      device=cuda).to(dtype)
    q = qkv[..., :h * hd].unflatten(-1, (h, hd))
    k = qkv[..., h * hd:(h + kvh) * hd].unflatten(-1, (kvh, hd))
    v = qkv[..., (h + kvh) * hd:].unflatten(-1, (kvh, hd))
    assert not q.is_contiguous() and q.stride(1) == (h + 2 * kvh) * hd
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_matches_plain_on_card(cuda, dtype, tol):
    c = _paged_case(np.random.RandomState(5), 8, 16, 8, 128, 80, 16, 10)
    t = {x: torch.from_numpy(c[x]).to(cuda) for x in c}
    for x in ("q", "nk", "nv", "kp", "vp"):
        t[x] = t[x].to(dtype)
    cpu = {x: v.cpu() for x, v in t.items()}
    before = pa.launches.n
    out, kp, vp = pa.paged_decode_attention(
        *(t[x] for x in ("q", "nk", "nv", "kp", "vp", "table", "lengths")))
    assert pa.launches.n == before + 1
    outc, kpc, vpc = pa.paged_decode_attention(
        *(cpu[x] for x in ("q", "nk", "nv", "kp", "vp", "table", "lengths")))
    assert torch.equal(kp.cpu(), kpc) and torch.equal(vp.cpu(), vpc)
    assert (out.cpu().float() - outc.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t", [1, 100, 256])
def test_rglru_kernel_matches_plain_on_card(cuda, dtype, tol, t):
    """The kernel rounds a*h and then +b, as the plain loop does, so float32
    agrees to the bit in practice; bf16 outputs are a rounding of those."""
    a, b = _rglru_inputs(np.random.RandomState(t), 4, t, 2560)
    a = torch.from_numpy(a).to(cuda).to(dtype)
    b = torch.from_numpy(b).to(cuda).to(dtype)
    before, dec = pr.launches.n, pr.decode_launches.n
    out = pr.pavlov_rglru(a, b)
    assert pr.launches.n == before + 1
    assert pr.decode_launches.n == dec + (t == 1)
    ref = pr.pavlov_rglru_ref(a, b)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == a.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


#: the selective scan's y tolerance, in float32 ulps (2^-23) of max|y|
Y_ULPS = 8 * 2.0 ** -23


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,n,carry", [
    (4, 256, 8192, 16, False),      # falcon-mamba's prefill bucket, h0 = 0
    (4, 100, 8192, 16, True),       # ragged T, h0 and lengths with a 0
    (4, 1, 8192, 16, True),         # a decode step
    (1, 256, 8192, 16, True),       # a prefill chunk
    (3, 37, 200, 4, True),          # N < 16, D not a multiple of a block
    (2, 40, 96, 32, True)])         # the largest N
def test_ssm_kernel_matches_plain_on_card(cuda, dtype, b, t, d, n, carry):
    """The update rounds where the plain loop rounds (no FMA, accurate
    expf), so h_T agrees to float32 rounding (to the bit in practice).  y
    is a 17-term sum taken in another order: it agrees to a few float32
    ulps of the output's scale (|y| reaches ~80 at T=256; both sides are
    ~1e-5 from a float64 loop there), hence ``Y_ULPS`` of max|y|.  A
    0-length row keeps h0 bit for bit.  bf16 inputs are widened to float32
    on both sides; y is one bf16 rounding of that."""
    c = _ssm_inputs(np.random.RandomState(t + n), b, t, d, n)
    g = {k: torch.from_numpy(v).to(cuda) for k, v in c.items()}
    ins = [g[k].to(dtype) for k in ("delta", "x", "bc", "cc")]
    h0, length = (g["h0"], g["length"]) if carry else (None, None)
    before, dec = ps.launches.n, ps.decode_launches.n
    y, h_t = ps.pavlov_ssm(*ins, g["a"], g["d_skip"], h0, length)
    assert ps.launches.n == before + 1
    assert ps.decode_launches.n == dec + (t == 1)
    y_ref, h_ref = ps.pavlov_ssm_ref(*ins, g["a"], g["d_skip"], h0, length)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (b, t, d)
    assert h_t.dtype == torch.float32 and h_t.shape == (b, d, n)
    assert (h_t - h_ref).abs().max().item() <= 1e-5
    err = (y.float() - y_ref.float()).abs()
    scale = Y_ULPS * y_ref.float().abs().max().item()
    if dtype == torch.float32:
        assert err.max().item() <= scale
    else:       # one bf16 rounding of values a float32 rounding apart
        assert bool((err <= y_ref.float().abs() * 2.0 ** -7 + scale).all())
    if carry and b > 1:
        assert torch.equal(h_t[1], h0[1])               # the 0-length row


# ------------------------------------------------------ the Mensa dataflows
def _sum_close(out, ref, k, dtype):
    """A float32 product over ``k`` terms summed in another order (FMA
    chains against a multiply and an add): the rounding differences walk
    like sqrt(k) ulps (2^-23) of the output's scale, so sqrt(k) ulps of
    max|y|; a bf16 output is one more rounding (one bf16 ulp, 2^-7 of
    |y|)."""
    err = (out.float() - ref.float()).abs()
    scale = np.sqrt(k) * 2.0 ** -23 * ref.float().abs().max().item()
    if dtype == torch.float32:
        return err.max().item() <= scale
    return bool((err <= ref.float().abs() * 2.0 ** -7 + scale).all())


def _gemm_inputs(rng, lead, k, n, dtype, device):
    """x ~ N(0, 1) and w with the fan-in init's std 1/sqrt(K)."""
    x = torch.from_numpy(_randn(rng, *lead, k)).to(device).to(dtype)
    w = torch.from_numpy(_randn(rng, k, n) / np.sqrt(k)).to(device)
    return x, w.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,k,n", [
    ((200,), 2048, 8192),           # TR1 enc1..7's hoisted input GEMM
    ((200,), 512, 8192),            # TR1 enc0's
    ((3, 37), 300, 1000),           # lead dims; no dim a tile multiple
    ((1,), 64, 33)])
def test_pascal_kernel_matches_plain_on_card(cuda, dtype, lead, k, n):
    x, w = _gemm_inputs(np.random.RandomState(k + n), lead, k, n, dtype,
                        cuda)
    before = pm.launches.n
    out = pm.pascal_matmul(x, w)
    assert pm.launches.n == before + 1
    ref = pm.pascal_matmul_ref(x.reshape(-1, k), w).reshape(*lead, n)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (*lead, n)
    assert _sum_close(out, ref, k, dtype)


@pytest.mark.gpu
def test_pascal_kernel_rows_do_not_depend_on_m(cuda):
    """One row's product is that row of the many-row product, bit for bit:
    the LSTM layer's carried single steps rely on it."""
    x, w = _gemm_inputs(np.random.RandomState(3), (20,), 640, 8192,
                        torch.float32, cuda)
    full = pm.pascal_matmul(x, w)
    assert all(torch.equal(full[i:i + 1], pm.pascal_matmul(x[i:i + 1], w))
               for i in range(20))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (1, 1280, 8192),                # LSTM1's output FC
    (4, 640, 4096),                 # TR1's joint_out
    (1, 2900, 8192),                # LSTM4's output FC: ragged K
    (4, 1024, 300),
    (16, 96, 64),                   # the most rows
    (3, 100, 37)])                  # N ragged in both dtypes
def test_jacquard_kernel_matches_plain_on_card(cuda, dtype, m, k, n):
    x, w = _gemm_inputs(np.random.RandomState(m + k + n), (m,), k, n, dtype,
                        cuda)
    before = jg.launches.n
    out = jg.jacquard_gemv(x, w)
    assert jg.launches.n == before + 1
    ref = jg.jacquard_gemv_ref(x, w)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    assert _sum_close(out, ref, k, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,m,k,n", [
    (torch.bfloat16, 1, 1280, 8192),     # LSTM1's output FC: 128 slabs
    (torch.bfloat16, 1, 640, 4096),      # TR1's joint_out: 64 slabs
    (torch.bfloat16, 4, 640, 4096),
    (torch.float32, 4, 1024, 300),       # ragged N
    (torch.float32, 16, 20000, 64)])     # the most rows: x in chunks
def test_jacquard_gemv_is_deterministic_on_card(cuda, dtype, m, k, n):
    """The groups' sums are added in a fixed order, with no atomics:
    within the sum's tolerance, and the same bits on every call."""
    x, w = _gemm_inputs(np.random.RandomState(m + k), (m,), k, n, dtype,
                        cuda)
    out = jg.jacquard_gemv(x, w)
    again = jg.jacquard_gemv(x, w)
    ref = jg.jacquard_gemv_ref(x, w)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert _sum_close(out, ref, k, dtype)


def _lstm_inputs(rng, b, t, hd):
    """Gates xg ~ N(0, 1), W_h with the fan-in init's std, a carried state
    in the ranges an LSTM gives it (|h| < 1)."""
    return dict(xg=_randn(rng, b, t, 4 * hd),
                wh=_randn(rng, hd, 4 * hd) / np.float32(np.sqrt(hd)),
                h0=rng.uniform(-0.9, 0.9, (b, hd)).astype(np.float32),
                c0=_randn(rng, b, hd))


#: the recurrence on the card vs its plain loop, float32: dot products in
#: another order each step, |h| < 1, |c| a few units
LSTM_TOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,hd,carry", [
    (1, 200, 2048, False),          # TR1's encoder layer, zero state
    (4, 80, 2900, True),            # LSTM4's width: no multiple of 16 units
    (5, 7, 100, True),              # a batch past one group of 4
    (2, 9, 37, False)])             # odd H: scalar loads in both dtypes
def test_lstm_kernel_matches_plain_on_card(cuda, dtype, b, t, hd, carry):
    """The cell update rounds as the plain loop does and the dot products
    are float32 FMA chains in another order: h, h_T and c_T within
    ``LSTM_TOL``; a bf16 h is one rounding of that."""
    c = {k: torch.from_numpy(v).to(cuda)
         for k, v in _lstm_inputs(np.random.RandomState(t + hd), b, t,
                                  hd).items()}
    xg, wh = c["xg"].to(dtype), c["wh"].to(dtype)
    h0, c0 = (c["h0"], c["c0"]) if carry else (None, None)
    before, steps = pl.launches.n, pl.step_launches.n
    y, h_t, c_t = pl.lstm_recurrence(xg, wh, h0, c0)
    assert pl.launches.n == before + 1
    assert pl.step_launches.n == steps + t
    y_ref, h_ref, c_ref = pl.pavlov_lstm_ref(xg, wh, h0, c0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (b, t, hd)
    assert h_t.dtype == c_t.dtype == torch.float32
    assert (h_t - h_ref).abs().max().item() <= LSTM_TOL
    assert (c_t - c_ref).abs().max().item() <= LSTM_TOL
    err = (y.float() - y_ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= LSTM_TOL
    else:
        assert bool((err <= y_ref.float().abs() * 2.0 ** -7
                     + LSTM_TOL).all())


@pytest.mark.gpu
def test_lstm_layer_carried_steps_equal_one_call_on_card(cuda):
    """TR1's prediction network's first layer (640 -> 2048, U = 20): 20
    single-step calls carrying (h, c) give the bits of one call."""
    g = torch.Generator(device=cuda).manual_seed(0)
    params = trec.init_lstm_layer(640, 2048, g)
    x = torch.randn(1, 20, 640, generator=g, device=cuda)
    y, (h, c) = trec.lstm_layer(params, x)
    st, ys = None, []
    for t in range(20):
        yt, st = trec.lstm_layer(params, x[:, t:t + 1], st)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, dim=1), y)
    assert torch.equal(st[0], h) and torch.equal(st[1], c)
