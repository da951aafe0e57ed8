"""Marked ``gpu``: each CUDA kernel of the port against its plain version
on the card.  They skip, with the reason, where there is no card.  This
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import pavlov_rglru as pr  # noqa: E402
from repro_torch.kernels import pavlov_ssm as ps  # noqa: E402


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
    (1, 512, 10, 1, 256, 128)])     # ... with a window that binds
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
