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
    (2, 40, 10, 1, 256, 2048),      # MQA, ragged within a packed tile
    # serving's prefill buckets at the heads of qwen2-0.5b (group 7),
    # smollm-135m (group 3) and starcoder2-7b (group 9): groups that do not
    # divide a tile's 64 packed rows, so a position straddles two tiles
    (4, 16, 14, 2, 64, 0), (2, 64, 14, 2, 64, 0), (1, 256, 14, 2, 64, 0),
    (4, 16, 9, 3, 64, 0), (2, 128, 9, 3, 64, 0), (1, 256, 9, 3, 64, 0),
    (4, 32, 36, 4, 128, 0), (1, 256, 36, 4, 128, 0),
    (2, 100, 14, 2, 64, 0), (2, 100, 36, 4, 128, 0),    # ragged
    # phi3.5-moe (group 4) and llama4-scout (group 5) at hd 128
    (4, 16, 32, 8, 128, 0), (2, 64, 32, 8, 128, 0), (1, 256, 32, 8, 128, 0),
    (2, 100, 32, 8, 128, 0), (2, 64, 40, 8, 128, 0), (1, 256, 40, 8, 128, 0)])
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
@pytest.mark.parametrize("h,kvh,hd", [(16, 8, 128), (10, 1, 256),
                                      (14, 2, 64), (9, 3, 64), (36, 4, 128)])
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
@pytest.mark.parametrize("h,kvh,hd,window", [(16, 8, 128, 0),
                                             (10, 1, 256, 128)])
def test_flash_float32_is_deterministic_on_card(cuda, h, kvh, hd, window):
    """Each output is one thread's fixed-order sum: two calls give the
    same bits."""
    gen = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn(2, 300, h, hd, generator=gen, device=cuda)
    k = torch.randn(2, 300, kvh, hd, generator=gen, device=cuda)
    v = torch.randn(2, 300, kvh, hd, generator=gen, device=cuda)
    first = fa.flash_attention(q, k, v, causal=True, window=window)
    again = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 128])
def test_flash_float32_takes_unaligned_strides_on_card(cuda, hd):
    """Rows hd + 1 floats apart allow no 16-byte copy: the float32 route
    loads element by element there, to the same tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(hd + 1)
    wide = [torch.randn(2, 70, heads, hd + 1, generator=gen,
                        device=cuda)[..., :hd] for heads in (4, 2, 2)]
    q, k, v = wide
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4


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


#: paged decode's tolerance against its plain version, by dtype
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _paged_raw_case(rng, lengths, h, kvh, hd, bs, nb, dtype, device):
    """q, pools and a table that gives each slot its own scattered blocks
    for positions 0..lengths[b] (the rest of its row points anywhere in
    the pool, as the ops' clamp leaves it), on the card in ``dtype``."""
    b = len(lengths)
    own = [ln // bs + 1 for ln in lengths]
    n = sum(own)
    perm = rng.permutation(n)
    table = rng.randint(0, n, (b, nb)).astype(np.int32)
    at = 0
    for i, k in enumerate(own):
        table[i, :k] = perm[at:at + k]
        at += k
    t = dict(q=_randn(rng, b, h, hd), kp=_randn(rng, n, bs, kvh, hd),
             vp=_randn(rng, n, bs, kvh, hd))
    t = {x: torch.from_numpy(v).to(device).to(dtype) for x, v in t.items()}
    t["table"] = torch.from_numpy(table).to(device)
    t["lengths"] = torch.tensor(lengths, dtype=torch.int32, device=device)
    return t


def _paged_raw(t, rows=slice(None)):
    return pa.paged_decode_attention_raw(
        t["q"][rows].contiguous(), t["kp"], t["vp"],
        t["table"][rows].contiguous(), t["lengths"][rows].contiguous())


def _paged_err(t):
    out = _paged_raw(t)
    ref = pa.paged_attention_ref(t["q"], t["kp"], t["vp"], t["table"],
                                 t["lengths"])
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("h,kvh", [(8, 8), (16, 8), (14, 2),   # groups 1 2 7
                                   (9, 3), (36, 4)])            # 3 9
def test_paged_kernel_matches_plain_at_every_width_on_card(cuda, dtype, hd,
                                                           h, kvh):
    rng = np.random.RandomState(hd + h)
    lengths = [int(x) for x in rng.randint(0, 16 * 12, 8)]
    t = _paged_raw_case(rng, lengths, h, kvh, hd, 16, 12, dtype, cuda)
    assert _paged_err(t) <= PAGED_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,bs", [
    (10, 1, 16),        # recurrentgemma's MQA: group 10
    (18, 2, 16),        # group 9: a CTA spans one of two kv heads
    (40, 8, 16),        # llama4-scout: group 5, three kv heads a CTA
    (32, 8, 16),        # phi3.5-moe: group 4
    (32, 1, 16),        # a group wider than a CTA's q heads
    (16, 8, 8),         # the reduced configs' block size
    (16, 8, 48)])       # a block larger than a stage, not a power of two
def test_paged_kernel_matches_plain_at_every_group_on_card(cuda, dtype, h,
                                                           kvh, bs):
    rng = np.random.RandomState(h + bs)
    lengths = [int(x) for x in rng.randint(0, bs * 9, 6)]
    t = _paged_raw_case(rng, lengths, h, kvh, 128, bs, 9, dtype, cuda)
    assert _paged_err(t) <= PAGED_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_block_edges_and_many_splits_on_card(cuda, dtype):
    """Lengths of 0 (one visible position), at a block's end (15) and
    start (16), and long enough (>= 4000 of 4096) to span many splits."""
    t = _paged_raw_case(np.random.RandomState(1), [0, 15, 16, 17, 4000, 4095],
                        16, 8, 128, 16, 256, dtype, cuda)
    assert _paged_err(t) <= PAGED_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_drops_the_sentinel_write_on_card(cuda, dtype):
    """A slot whose write block is the sentinel (= N) writes nothing, and
    every slot attends as the CPU's plain version does."""
    c = _paged_case(np.random.RandomState(8), 6, 16, 8, 128, 80, 16, 10)
    n, bs = c["kp"].shape[0], c["kp"].shape[1]
    c["table"][2, c["lengths"][2] // bs] = n        # slot 2: a dropped write
    kept = sum(int(c["table"][b, c["lengths"][b] // bs] < n)
               for b in range(6))
    t = {x: torch.from_numpy(v).to(cuda) for x, v in c.items()}
    for x in ("q", "nk", "nv", "kp", "vp"):
        t[x] = t[x].to(dtype)
    cpu = {x: v.cpu() for x, v in t.items()}
    kp0 = t["kp"].clone()
    names = ("q", "nk", "nv", "kp", "vp", "table", "lengths")
    out, kp, vp = pa.paged_decode_attention(*(t[x] for x in names))
    outc, kpc, vpc = pa.paged_decode_attention(*(cpu[x] for x in names))
    written = (kp != kp0).flatten(1).any(1).sum().item()
    assert written == kept < 6           # one block for each kept write
    assert torch.equal(kp.cpu(), kpc) and torch.equal(vp.cpu(), vpc)
    assert (out.cpu().float() - outc.float()).abs().max().item() \
        <= PAGED_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_is_deterministic_on_card(cuda, dtype):
    """The splits merge in a fixed order, with no atomics: two calls give
    the same bits."""
    t = _paged_raw_case(np.random.RandomState(2),
                        [3, 600, 1023, 40, 2047, 0, 16, 900], 16, 8, 128, 16,
                        128, dtype, cuda)
    first, again = _paged_raw(t), _paged_raw(t)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_slot_bits_do_not_depend_on_the_batch_on_card(cuda, dtype):
    """A slot's output is the same bits alone (B = 1, its own table row)
    as inside a batch of 8: its splits depend on its length, the table's
    width and the card only."""
    t = _paged_raw_case(np.random.RandomState(3),
                        [0, 15, 16, 300, 1023, 2000, 2047, 77], 16, 8, 128,
                        16, 128, dtype, cuda)
    batch = _paged_raw(t)
    alone = [_paged_raw(t, slice(i, i + 1)) for i in range(8)]
    torch.cuda.synchronize()
    assert all(torch.equal(batch[i:i + 1], a) for i, a in enumerate(alone))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t", [1, 100, 256])
def test_rglru_kernel_matches_plain_on_card(cuda, dtype, tol, t):
    """The kernel rounds a*h and then +b, as the plain loop does, so float32
    agrees to the bit (asserted by the test below); bf16 outputs are a
    rounding of those."""
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
    """The plain loop takes the accurate exp and rounds the decay and the
    add apart; the kernel takes ex2.approx of a pre-scaled a (2 ulp) and
    one FMA for the decay and the add.  The recurrence contracts, so h_T
    agrees to a few float32 roundings, within 1e-5.  y is a 17-term sum
    taken in another order: it agrees to a few float32 ulps of the output's
    scale (|y| reaches ~80 at T=256; both sides are ~1e-5 from a float64
    loop there), hence ``Y_ULPS`` of max|y|.  A 0-length row keeps h0 bit
    for bit.  bf16 inputs are widened to float32 on both sides; y is one
    bf16 rounding of that."""
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


def _rglru_on_card(seed, b, t, e, device):
    a, drive = _rglru_inputs(np.random.RandomState(seed), b, t, e)
    return torch.from_numpy(a).to(device), torch.from_numpy(drive).to(device)


def _unaligned(x):
    """A copy of x whose data starts one element past a 16-byte boundary:
    no TMA box or bulk copy can take it, so the kernels take their element
    / direct routes."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    out = flat[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,e", [
    (4, 1, 2560),       # a decode step (the element route)
    (4, 100, 2560),     # a ragged chunk count (the ring)
    (4, 256, 2560),     # recurrentgemma's prefill bucket
    (1, 256, 2560),     # a prefill chunk of one row
    (4, 256, 2600),     # E past the last 32-channel strip
    (3, 50, 37)])       # rows no TMA box takes (the element route)
def test_rglru_kernel_equals_plain_bitwise_on_card(cuda, b, t, e):
    """float32: the same two roundings a step as the plain loop, in t
    order, on either route: the same bits."""
    a, drive = _rglru_on_card(t + e, b, t, e, cuda)
    out = pr.pavlov_rglru(a, drive)
    ref = pr.pavlov_rglru_ref(a, drive)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.gpu
def test_rglru_chunks_carry_bitwise_on_card(cuda):
    """One call over T=256 equals a call over the first 100 steps and one
    over the other 156 whose b[:, 0] carries the state as the caller folds
    it (``b[:, 0] += a[:, 0] * h``), bit for bit."""
    a, drive = _rglru_on_card(5, 4, 256, 2560, cuda)
    whole = pr.pavlov_rglru(a, drive)
    first = pr.pavlov_rglru(a[:, :100].contiguous(),
                            drive[:, :100].contiguous())
    rest = drive[:, 100:].contiguous()
    rest[:, 0] += a[:, 100] * first[:, -1]
    second = pr.pavlov_rglru(a[:, 100:].contiguous(), rest)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([first, second], dim=1), whole)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_routes_and_calls_agree_bitwise_on_card(cuda, dtype):
    """The ring (aligned rows) and the element route (an input one element
    off 16 bytes) give the same bits, and two calls the same bits."""
    a, drive = _rglru_on_card(6, 4, 256, 2560, cuda)
    a, drive = a.to(dtype), drive.to(dtype)
    ring, again = pr.pavlov_rglru(a, drive), pr.pavlov_rglru(a, drive)
    element = pr.pavlov_rglru(_unaligned(a), drive)
    torch.cuda.synchronize()
    assert torch.equal(ring, again) and torch.equal(ring, element)


def _ssm_on_card(seed, b, t, d, n, device, lengths=None):
    """float32 inputs on the card as (delta, x, bc, cc, a, d_skip, h0,
    length), ``lengths`` in place of the random ones when given."""
    c = _ssm_inputs(np.random.RandomState(seed), b, t, d, n)
    if lengths is not None:
        c["length"] = np.asarray(lengths, np.int32)
    return [torch.from_numpy(c[k]).to(device) for k in
            ("delta", "x", "bc", "cc", "a", "d_skip", "h0", "length")]


def _steps(args, lo, hi):
    """The inputs of steps lo..hi-1, lengths counted from lo, with h0."""
    delta, x, bc, cc, a, d_skip, h0, length = args
    part = [z[:, lo:hi].contiguous() for z in (delta, x, bc, cc)]
    return part + [a, d_skip, h0, (length - lo).clamp(0, hi - lo).int()]


@pytest.mark.gpu
def test_ssm_chunks_carry_bitwise_on_card(cuda):
    """One call over T=256 equals a call over the first 100 steps and one
    over the other 156 from its h_T, bit for bit in y and h_T, with
    lengths that end in either chunk, at one of them, and at 0."""
    args = _ssm_on_card(7, 4, 256, 8192, 16, cuda, [256, 0, 100, 180])
    y, h_t = ps.pavlov_ssm(*args)
    y1, h1 = ps.pavlov_ssm(*_steps(args, 0, 100))
    part = _steps(args, 100, 256)
    part[6] = h1
    y2, h2 = ps.pavlov_ssm(*part)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h_t)
    assert torch.equal(h_t[1], args[6][1])


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 256])
def test_ssm_row_bits_do_not_depend_on_the_batch_on_card(cuda, t):
    """Each row's y and h_T are the same bits alone (B=1) as inside B=4:
    a channel's lanes and sum order come from N only."""
    args = _ssm_on_card(8 + t, 4, t, 8192, 16, cuda,
                        [t, 0, max(1, t // 3), t])
    y, h_t = ps.pavlov_ssm(*args)
    delta, x, bc, cc, a, d_skip, h0, length = args
    for i in range(4):
        row = [z[i:i + 1].contiguous() for z in (delta, x, bc, cc)]
        y_i, h_i = ps.pavlov_ssm(*row, a, d_skip, h0[i:i + 1].contiguous(),
                                 length[i:i + 1].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(y_i, y[i:i + 1]) and torch.equal(h_i, h_t[i:i + 1])


@pytest.mark.gpu
def test_ssm_decode_step_equals_first_step_bitwise_on_card(cuda):
    """A T=1 call (the direct route) equals the first step of a T=256
    call (the ring): y[:, 0] unmasked, and h_T where the long call's
    lengths stop its state after that step."""
    args = _ssm_on_card(9, 4, 256, 8192, 16, cuda, [256] * 4)
    y_long, _ = ps.pavlov_ssm(*args[:6], args[6], None)
    _, h_one_step = ps.pavlov_ssm(*args[:7], torch.ones_like(args[7]))
    y_1, h_1 = ps.pavlov_ssm(*_steps(args, 0, 1)[:7], None)
    torch.cuda.synchronize()
    assert torch.equal(y_1[:, 0], y_long[:, 0])
    assert torch.equal(h_1, h_one_step)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_routes_and_calls_agree_bitwise_on_card(cuda, dtype):
    """The ring (aligned rows) and the direct route (delta one element off
    16 bytes) give the same bits in y and h_T, and two calls the same
    bits."""
    args = _ssm_on_card(10, 4, 100, 8192, 16, cuda)
    args[:4] = [z.to(dtype) for z in args[:4]]
    ring, again = ps.pavlov_ssm(*args), ps.pavlov_ssm(*args)
    direct = ps.pavlov_ssm(_unaligned(args[0]), *args[1:])
    torch.cuda.synchronize()
    for got in (again, direct):
        assert torch.equal(got[0], ring[0]) and torch.equal(got[1], ring[1])


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


#: Pascal shapes by route: K and N multiples of 8 take the tensor cores in
#: bf16 (16-byte copies in float32); K = 300 the SIMT route in bf16; K = 37
#: and N = 33 element loads in both dtypes
PASCAL_ROUTES = [(640, 8192), (300, 1000), (37, 33)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", PASCAL_ROUTES)
def test_pascal_kernel_rows_do_not_depend_on_m(cuda, dtype, k, n):
    """One row's product is that row of the many-row product, bit for bit,
    on every route: the LSTM layer's carried single steps rely on it."""
    x, w = _gemm_inputs(np.random.RandomState(3), (20,), k, n, dtype, cuda)
    full = pm.pascal_matmul(x, w)
    assert all(torch.equal(full[i:i + 1], pm.pascal_matmul(x[i:i + 1], w))
               for i in range(20))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(200, 2048, 8192), (130, 300, 1000),
                                   (7, 37, 33)])
def test_pascal_kernel_is_deterministic_on_card(cuda, dtype, m, k, n):
    """No split of K and no atomics: two calls give the same bits, within
    the sum's tolerance of the plain version."""
    x, w = _gemm_inputs(np.random.RandomState(m + k), (m,), k, n, dtype,
                        cuda)
    out = pm.pascal_matmul(x, w)
    again = pm.pascal_matmul(x, w)
    ref = pm.pascal_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert _sum_close(out, ref, k, dtype)


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


def _lstm_on_card(dtype, b, t, hd, device, seed):
    """``_lstm_inputs`` on the card: xg and W_h in ``dtype``, the state in
    float32."""
    c = {k: torch.from_numpy(v).to(device)
         for k, v in _lstm_inputs(np.random.RandomState(seed), b, t,
                                  hd).items()}
    return c["xg"].to(dtype), c["wh"].to(dtype), c["h0"], c["c0"]


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
    xg, wh, h0, c0 = _lstm_on_card(dtype, b, t, hd, cuda, t + hd)
    if not carry:
        h0 = c0 = None
    before = pl.launches.n
    y, h_t, c_t = pl.lstm_recurrence(xg, wh, h0, c0)
    assert pl.launches.n == before + 1
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_kernel_carried_steps_equal_one_call_on_card(cuda, dtype):
    """At TR1's H = 2048: 20 calls at T = 1 that carry (h, c) give the bits
    of one call over T = 20 (a sum's order never depends on T)."""
    xg, wh, h0, c0 = _lstm_on_card(dtype, 1, 20, 2048, cuda, 0)
    y, h_t, c_t = pl.pavlov_lstm_raw(xg, wh, h0, c0)
    state, ys = (h0, c0), []
    for t in range(20):
        yt, h, c = pl.pavlov_lstm_raw(xg[:, t:t + 1].contiguous(), wh, *state)
        state = (h, c)
        ys.append(yt)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(ys, dim=1), y)
    assert torch.equal(state[0], h_t) and torch.equal(state[1], c_t)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,hd", [
    (1, 200, 2048),                 # float32 re-reads part of W_h from L2
    (4, 80, 2900),                  # a batch group of 4, off-chip rows
    (5, 7, 100)])                   # two batch groups
def test_lstm_kernel_is_deterministic_on_card(cuda, dtype, b, t, hd):
    """The grid barrier between steps leaves no race: two calls give the
    same bits."""
    xg, wh, h0, c0 = _lstm_on_card(dtype, b, t, hd, cuda, b + t + hd)
    first = pl.pavlov_lstm_raw(xg, wh, h0, c0)
    again = pl.pavlov_lstm_raw(xg, wh, h0, c0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, z) for a, z in zip(first, again))


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


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv_block_size", [("qwen3-0.6b", 8),
                                                ("recurrentgemma-2b", None),
                                                ("falcon-mamba-7b", None)])
def test_policy_auto_serves_the_fixed_tokens_on_card(cuda, arch,
                                                     kv_block_size):
    """Reduced size, float32: the auto plan is the card's (every policy's
    kernel "cuda"), and it serves the fixed engine's greedy and sampled
    tokens.  The recurrent archs' auto chunk (``scan_chunk`` 16) is
    narrower than the fixed one (the 32-token top bucket), so their
    70-token prompt runs in other chunks."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request
    cfg = reduced_config(arch).replace(compute_dtype="float32")
    model = build_model(cfg, device=cuda, seed=0)
    samp = dict(temperature=0.8, top_k=20, top_p=0.9, seed=5)

    def serve(policy):
        eng = build_engine(cfg, model, slots=2, max_len=128, max_bucket=32,
                           kv_block_size=kv_block_size, policy=policy)
        rng = np.random.RandomState(3)
        reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size,
                                                  n).tolist(),
                        max_new_tokens=6, **(samp if i == 2 else {}))
                for i, n in enumerate((5, 70, 20))]
        eng.run(reqs, on_truncate="raise")
        return eng, [r.generated for r in reqs]

    auto, auto_tokens = serve("auto")
    fixed, fixed_tokens = serve("fixed")
    plan = auto.policy
    assert plan.source == "auto" and plan.backend == "cuda"
    assert plan.policies and all(p.kernel == "cuda" for p in plan.policies)
    assert auto.prefill_chunk == (32 if arch == "qwen3-0.6b" else 16)
    assert fixed.prefill_chunk == 32
    assert auto_tokens == fixed_tokens


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "smollm-135m",
                                  "starcoder2-7b", "internvl2-2b"])
def test_full_width_arch_serves_the_same_tokens_twice_on_card(cuda, arch):
    """Full width cut to 2 layers, bf16, paged blocks of 16, the auto plan:
    flash prefills and paged decode steps serve greedy and sampled tokens
    that a second model from the same seed serves again.  The modality
    model cannot chunk (nor can the JAX one): its prompts fit the buckets
    and its prefix cache is off."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request
    cfg = get_config(arch).replace(num_layers=2)
    vlm = bool(cfg.modality_tokens)
    lengths = (5, 40, 200) if vlm else (5, 40, 300)

    def serve():
        model = build_model(cfg, device=cuda, seed=0)
        eng = build_engine(cfg, model, slots=2, max_len=512, max_bucket=256,
                           kv_block_size=16, prefix_cache=not vlm)
        before = (fa.launches.n, pa.launches.n)
        rng = np.random.RandomState(1)
        reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size,
                                                  n).tolist(),
                        max_new_tokens=6,
                        **(dict(temperature=0.8, top_k=20, seed=5)
                           if i == 1 else {}))
                for i, n in enumerate(lengths)]
        eng.run(reqs, on_truncate="raise")
        s = eng.stats.summary()
        assert s["requests_completed"] == 3 and s["nonfinite_logits"] == 0
        assert s["prefill_chunks"] == (0 if vlm else 2)
        assert fa.launches.n > before[0] and pa.launches.n > before[1]
        return [r.generated for r in reqs]

    first = serve()
    assert all(0 <= t < cfg.vocab_size for g in first for t in g)
    assert serve() == first


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd", [
    (2, 128, 128, 16, 16, 64),     # seamless-m4t-medium's encoder heads
    (4, 100, 100, 16, 16, 64),     # ragged S
    (2, 64, 64, 4, 4, 16),         # reduced seamless
    (2, 96, 96, 16, 8, 128),       # GQA
    (2, 37, 128, 16, 16, 64),      # Sq < Skv
    (2, 128, 40, 16, 8, 128),      # Sq > Skv
    (1, 1, 77, 16, 16, 64)])
def test_flash_kernel_noncausal_matches_plain_on_card(cuda, dtype, tol, b, sq,
                                                      skv, h, kvh, hd):
    """``causal=False``, as the encoder's self-attention calls it, at
    Sq == Skv and Sq != Skv (every query sees every key)."""
    gen = torch.Generator(device=cuda).manual_seed(sq + skv + hd)
    q = torch.randn(b, sq, h, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, skv, kvh, hd, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, skv, kvh, hd, generator=gen, device=cuda).to(dtype)
    before = fa.launches.n
    out = fa.flash_attention(q, k, v, causal=False)
    assert fa.launches.n == before + 1
    ref = fa.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_kernel_wrappers_refuse_autograd_on_card(cuda):
    q = torch.randn(1, 8, 2, 16, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, q.detach()[:, :, :1], q.detach()[:, :, :1])
    a = torch.rand(1, 4, 32, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        pr.pavlov_rglru(a, a.detach())
    with torch.no_grad():
        pr.pavlov_rglru(a, a)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "falcon-mamba-7b", "seamless-m4t-medium"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """Reduced configs in float32: a train step under autograd (the
    flash_attention_xla and chunked_linear_scan routes, no kernel
    launched) on the card against the CPU from the same weights: loss and
    grad norm, and, before it, a no-grad forward's logits (which go
    through the kernels on the card)."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step, optim
    cfg = reduced_config(arch).replace(compute_dtype="float32")
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
        encdec=cfg.is_encdec, d_model=cfg.d_model))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    weights = build_model(cfg, "cpu", seed=0, train=True).state_dict()
    src = batch.get("src_embeds")
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev, train=True)
        model.load_state_dict(weights)
        with torch.no_grad():
            logits = model(batch["tokens"].to(dev),
                           src_embeds=None if src is None else src.to(dev))
        params = dict(model.named_parameters())
        step = make_train_step(model, accum_steps=2,
                               schedule=optim.cosine_schedule(1e-2, 0, 10))
        counts = (fa.launches.n, pr.launches.n, ps.launches.n)
        _, st, met = step(params, optim.adamw_init(params),
                          {k: v.to(dev) for k, v in batch.items()})
        assert (fa.launches.n, pr.launches.n, ps.launches.n) == counts
        out[str(dev)] = (float(met["loss"]), float(met["grad_norm"]),
                         logits.cpu())
    cpu, card = out["cpu"], out[str(cuda)]
    assert abs(cpu[0] - card[0]) <= 1e-5 * abs(cpu[0])
    assert abs(cpu[1] - card[1]) <= 1e-4 * abs(cpu[1])
    assert (cpu[2] - card[2]).abs().max().item() <= 1e-4


# ----------------------------------------------------- disaggregated serving
DISAGG_ARCHS = [("qwen3-0.6b", 8), ("recurrentgemma-2b", None),
                ("falcon-mamba-7b", None)]


def _lively_model(arch, dtype, device):
    """Reduced ``arch`` at ``max(2, len(block_pattern))`` layers on
    ``device``, its norm scales drawn from N(0, 0.5) so greedy tokens
    vary (the init's unit scales decode one token over and over)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    cfg = reduced_config(arch)
    cfg = cfg.replace(compute_dtype=dtype,
                      num_layers=max(2, len(cfg.block_pattern)))
    model = build_model(cfg, device=device, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or "scale" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return cfg, model


def _disagg_trace(vocab):
    """The JAX package's disagg identity gate trace (70 tokens chunk; a
    pair on a 20-token prefix), one request sampled."""
    from repro_torch.serve.engine import Request
    rng = np.random.RandomState(23)
    shared = rng.randint(1, vocab, 20).tolist()
    reqs = [Request(rid=i, prompt=rng.randint(1, vocab, n).tolist(),
                    max_new_tokens=6,
                    **(dict(temperature=0.8, top_k=20, seed=5)
                       if i == 2 else {}))
            for i, n in enumerate([4, 11, 30, 70])]
    reqs += [Request(rid=10 + i, prompt=shared + rng.randint(
                 1, vocab, 3 + i).tolist(), max_new_tokens=6)
             for i in range(2)]
    return reqs


def disagg_serves_interleaved_tokens(arch, kv_block_size, dtype, device):
    """The pair (2 prefill + 4 decode slots) serves the interleaved
    4-slot engine's tokens, one handoff a request, none pending; the
    prefill role launches flash and the decode role paged decode or the
    scans at T = 1 (counted only on the card)."""
    from repro_torch.serve.disagg import DisaggEngine
    from repro_torch.serve.engine import ServeEngine
    cfg, model = _lively_model(arch, dtype, device)
    kw = dict(max_len=128, buckets=(16, 32), prefill_chunk=32,
              kv_block_size=kv_block_size, kv_blocks=None if
              kv_block_size is None else 64)
    want = [r.generated for r in ServeEngine(model, slots=4, **kw).run(
        _disagg_trace(cfg.vocab_size), on_truncate="raise")]
    dis = DisaggEngine(model, prefill_slots=2, decode_slots=4, **kw)
    dis.warmup()
    dis.reset_stats()
    before = (fa.launches.n, pa.launches.n, pr.decode_launches.n,
              ps.decode_launches.n)
    got = [r.generated for r in dis.run(_disagg_trace(cfg.vocab_size),
                                        on_truncate="raise")]
    after = (fa.launches.n, pa.launches.n, pr.decode_launches.n,
             ps.decode_launches.n)
    assert got == want
    assert len({tuple(g) for g in got}) > 1
    s = dis.summary()
    assert s["handoffs"] == 6 and s["handoffs_pending"] == 0
    assert s["roles"]["decode"]["nonfinite_logits"] == 0
    return s, [a - b for a, b in zip(after, before)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kv_block_size", DISAGG_ARCHS)
def test_disagg_pair_serves_the_interleaved_tokens_on_card(cuda, dtype, arch,
                                                           kv_block_size):
    s, moved = disagg_serves_interleaved_tokens(arch, kv_block_size, dtype,
                                                cuda)
    flash, paged, rglru, ssm = moved
    # the reduced recurrentgemma's 16-token window keeps its local layers'
    # prefill off flash (the full window takes it: chip_smoke.py phase 6)
    assert flash > 0 or arch != "qwen3-0.6b"
    assert (paged > 0) == (kv_block_size is not None)
    assert rglru > 0 or arch != "recurrentgemma-2b"
    assert ssm > 0 or arch != "falcon-mamba-7b"


def suitcase_round_trip(arch, kv_block_size, device):
    """A prefill role's slot exported and adopted by a decode role whose
    pool has another size: the decode pool's adopted blocks and the slot's
    row equal the prefill side's bit for bit, no other block changes, and
    an import through an all-sentinel row (the decode role's warmup) and a
    suitcase's clipped sentinel tail write nothing and trip no assert."""
    from repro_torch.models.attention import PagedKVCache
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, model = _lively_model(arch, "bfloat16", device)
    pool = (lambda n: n) if kv_block_size else (lambda n: None)
    pre = ServeEngine(model, role="prefill", slots=2, max_len=64,
                      buckets=(16,), prefill_chunk=16,
                      kv_block_size=kv_block_size, kv_blocks=pool(12))
    dec = ServeEngine(model, role="decode", slots=2, max_len=64,
                      kv_block_size=kv_block_size, kv_blocks=pool(20),
                      prefix_cache=False)
    pre.warmup()
    dec.warmup()
    for st in dec.states:                  # no pool row is zero by chance
        for a in (st.kv if st.kv is not None else st.rec.values()):
            if a.is_floating_point():
                a.normal_()
    rng = np.random.RandomState(4)
    req = Request(rid=0, prompt=rng.randint(1, cfg.vocab_size, 27).tolist())
    pre.submit(req)
    while not pre.ready:
        pre.step()
    slot = pre.ready.popleft()
    src_row = list(pre.kv.table[slot]) if pre.kv is not None else None
    suitcase = pre.export_slot(slot)
    pre.release_handoff(slot)
    before = [[a.clone() for a in (st.kv if st.kv is not None
                                   else st.rec.values())]
              for st in dec.states]
    sent = [dec.kv.sentinel] * dec.kv.blocks_per_slot \
        if dec.kv is not None else None
    dec._import_slot(dec._export_slot(1, sent), 1, sent)
    if device.type == "cuda":
        torch.cuda.synchronize(device)     # a device assert surfaces here
    for st, old in zip(dec.states, before):
        if isinstance(st.kv, PagedKVCache):
            assert torch.equal(st.kv.k, old[0]) \
                and torch.equal(st.kv.v, old[1])
    assert dec.adopt(req, dec.stage_in(suitcase), 27) == 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for i, (st, old, sc) in enumerate(zip(dec.states, before, suitcase)):
        if isinstance(st.kv, PagedKVCache):
            owned = dec.kv.owned[0]
            rows = dec.kv.table[0][:owned]
            for now, was, moved in ((st.kv.k, old[0], sc.kv.k),
                                    (st.kv.v, old[1], sc.kv.v)):
                assert torch.equal(now[rows], moved[:owned])
                rest = [b for b in range(now.shape[0]) if b not in rows]
                assert torch.equal(now[rest], was[rest]), i
            assert src_row[owned:] == [pre.kv.sentinel] * (len(src_row)
                                                           - owned)
            assert int(st.kv.length[0]) == 27
        else:
            parts = st.kv if st.kv is not None else list(st.rec.values())
            moved = sc.kv if sc.kv is not None else list(sc.rec.values())
            for now, was, m in zip(parts, old, moved):
                assert torch.equal(now[0], m[0]), i
                assert torch.equal(now[1], was[1]), i


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv_block_size", DISAGG_ARCHS)
def test_suitcase_round_trip_on_card(cuda, arch, kv_block_size):
    suitcase_round_trip(arch, kv_block_size, cuda)


MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
#: float32 routing, the CPU against the card: a top-k may flip only
#: between experts whose CPU probabilities lie this close
ROUTE_MARGIN = 1e-5
#: a full-width expert layer's float32 output, the card against the CPU,
#: as a share of its largest entry (sums of 4096-8192 products in other
#: orders; the output reaches ~1e4 with the banks' 1/sqrt(E) init)
MOE_SHARE = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [None, 1.25], ids=["nodrop", "cap1.25"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_moe_serves_with_its_launch_counts_on_card(cuda, arch, cap):
    """Reduced MoE, float32, paged blocks of 8, the auto plan: one flash
    launch a layer and prefill call, one paged launch a layer and decode
    step; a second engine on the same model serves the same tokens (at
    capacity 1.25 the dead slots and padding rows take expert places).
    Planned at full size (``plan_cfg``): the reduced config's 4 experts
    leave the planner's decode shape no legal strategy."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request
    kw = {} if cap is None else dict(moe_capacity=cap)
    cfg = reduced_config(arch).replace(compute_dtype="float32", **kw)
    model = build_model(cfg, device=cuda, seed=0)

    def serve():
        eng = build_engine(cfg, model, slots=3, max_len=128, max_bucket=32,
                           kv_block_size=8, plan_cfg=get_config(arch))
        rng = np.random.RandomState(2)
        reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size,
                                                  n).tolist(),
                        max_new_tokens=6,
                        **(dict(temperature=0.8, top_k=20, seed=5)
                           if i == 2 else {}))
                for i, n in enumerate((5, 70, 20, 9))]
        before = (fa.launches.n, pa.launches.n)
        eng.run(reqs, on_truncate="raise")
        s = eng.stats.summary()
        assert s["requests_completed"] == 4 and s["nonfinite_logits"] == 0
        assert fa.launches.n - before[0] \
            == cfg.num_layers * s["prefill_calls"]
        assert pa.launches.n - before[1] \
            == cfg.num_layers * s["decode_steps"]
        return [r.generated for r in reqs]

    first = serve()
    assert all(0 <= t < cfg.vocab_size for g in first for t in g)
    assert serve() == first


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_profile_serves_the_same_tokens_on_card(cuda, arch):
    """Reduced MoE, float32, planned at full size (``plan_cfg``): profiles
    whose decode phase carries ``moe_impl="ragged"`` give the engine a
    decode model over the same parameter storage, and at the reduced
    capacity (no drops) it serves the tokens of the engine without
    profiles (the einsum route at both phases), with the same launches."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.executor import ExecutionProfile, phase_profiles
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request
    cfg = reduced_config(arch).replace(compute_dtype="float32")
    model = build_model(cfg, device=cuda, seed=0)
    pre, dec = phase_profiles(get_config(arch))
    ragged = (pre, ExecutionProfile(dec.arch, dec.shape, dec.strategy,
                                    {**dec.cfg_overrides,
                                     "moe_impl": "ragged"}, dec.plan))

    def serve(**kw):
        eng = build_engine(cfg, model, slots=3, max_len=128, max_bucket=32,
                           kv_block_size=8, plan_cfg=get_config(arch), **kw)
        rng = np.random.RandomState(4)
        reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size,
                                                  n).tolist(),
                        max_new_tokens=6) for i, n in enumerate((5, 70, 20))]
        before = (fa.launches.n, pa.launches.n)
        eng.run(reqs, on_truncate="raise")
        launches = (fa.launches.n - before[0], pa.launches.n - before[1])
        return eng, [r.generated for r in reqs], launches

    plain, want, plain_launches = serve()
    eng, got, launches = serve(profiles=ragged)
    assert plain.decode_model is plain.model
    assert eng.decode_model is not eng.model
    assert eng.decode_model.cfg.moe_impl == "ragged"
    assert eng.prefill_model is eng.model and model.cfg.moe_impl == "einsum"
    assert [p.data_ptr() for p in eng.decode_model.parameters()] \
        == [p.data_ptr() for p in model.parameters()]
    assert got == want and launches == plain_launches
    assert eng.stats.summary()["nonfinite_logits"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_width_moe_layer_matches_cpu_on_card(cuda, arch):
    """One full-width expert layer (``moe_ffn``, the einsum route at the
    config's capacity 1.25, 128 tokens: drops happen), float32, the same
    weights on the CPU and the card: the routing agrees (a flip only at a
    near-tie, within ``ROUTE_MARGIN``), and where it does the output lies
    within ``MOE_SHARE`` of the CPU's scale."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    gen = torch.Generator().manual_seed(0)
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    cpu = {k: torch.randn(sh, generator=gen) / sh[0] ** 0.5
           for k, sh in shapes.items()}
    if cfg.moe_shared_expert:
        cpu["shared"] = {k: torch.randn(sh, generator=gen) / sh[0] ** 0.5
                         for k, sh in (("w_gate", (d, f)), ("w_up", (d, f)),
                                       ("w_down", (f, d)))}
    card = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(cuda))
            for k, v in cpu.items()}
    x = torch.randn((2, 64, d), generator=gen)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.moe_capacity,
              activation=cfg.activation, return_aux=True)
    want, want_aux = moe.moe_ffn(cpu, x, **kw)
    got, aux = moe.moe_ffn(card, x.to(cuda), **kw)
    flips = moe.routing_flips(
        moe.routing(cpu, x.reshape(-1, d), cfg.top_k, cfg.moe_capacity),
        moe.routing(card, x.to(cuda).reshape(-1, d), cfg.top_k,
                    cfg.moe_capacity), ROUTE_MARGIN)
    assert not flips["unexplained"], flips
    assert float(want_aux["dropped_frac"]) > 0
    if not flips["gate"] and not flips["keep"]:
        assert float(aux["dropped_frac"]) == float(want_aux["dropped_frac"])
        tol = MOE_SHARE * float(want.abs().max())
        assert (got.cpu() - want).abs().max().item() <= tol


# --------------------------------------------------- the program registry
@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv_block_size", [("qwen3-0.6b", 8),
                                                ("recurrentgemma-2b", None)])
def test_program_registry_on_card(cuda, arch, kv_block_size):
    """Reduced size, bf16, ``program_memory=True``: the allocator's
    watermarks give every prefill, chunk and decode program a temp above
    0 and arguments of at least the parameters' bytes; after a trace each
    program's invocations add up to the engine's counters, and every
    nonzero share of a program that ran lies in (0, 1.05]."""
    from repro_torch.serve.engine import ServeEngine
    _, model = _lively_model(arch, "bfloat16", cuda)
    engine = ServeEngine(model, slots=2, max_len=128, buckets=(16, 32),
                         prefill_chunk=32, kv_block_size=kv_block_size,
                         program_memory=True)
    engine.warmup()
    engine.run(_disagg_trace(model.cfg.vocab_size), on_truncate="raise")
    params = sum(p.nbytes for p in model.parameters())
    s = engine.stats.summary()
    progs = s["programs"]["programs"]
    assert s["programs"]["chip"]["name"] == "h100_sxm_bfloat16"
    for name, p in progs.items():
        mem = p["memory"]
        assert mem["argument_size_in_bytes"] >= params, name
        assert mem["peak_memory_in_bytes"] >= mem["temp_size_in_bytes"], name
        if name != "copy":
            assert mem["temp_size_in_bytes"] > 0, name
        if p["invocations"]:
            for key, base in (("utilization", "flops"),
                              ("bandwidth_utilization", "bytes_accessed")):
                if p[base]:
                    assert 0 < p[key] <= 1.05, (name, key)
    assert s["programs"]["temp_bytes_peak"] > 0
    calls = lambda k: progs.get(k, {}).get("invocations", 0)  # noqa: E731
    assert calls("decode") == s["decode_steps"] > 0
    assert sum(p["invocations"] for k, p in progs.items()
               if k.startswith("prefill[")) == s["prefill_calls"] > 0
    assert calls("chunk") == s["prefill_chunks"] > 0
    assert calls("copy") == s.get("kv", {}).get("blocks_copied", 0)


@pytest.fixture(scope="module")
def card_mesh():
    """``make_serve_mesh()`` on the card: every rank of a 1-rank NCCL group
    this module starts, and ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serve_mesh
    started = dist.is_initialized()
    mesh = make_serve_mesh()
    yield mesh
    if not started:
        dist.destroy_process_group()


def _launches() -> tuple:
    return (fa.launches.n, pa.launches.n, ps.launches.n, ps.decode_launches.n)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["tp", "auto"])
@pytest.mark.parametrize("arch,kv_block_size", [("qwen3-0.6b", 8),
                                                ("falcon-mamba-7b", None)])
def test_mesh_engine_serves_the_meshless_tokens_on_card(card_mesh, arch,
                                                         kv_block_size,
                                                         strategy):
    """Reduced qwen3 (paged blocks of 8, a prefix hit) and falcon-mamba on
    ``make_serve_mesh()``, each weight layout: the meshless engine's tokens
    with its launch counts — the kernels ran inside ``local_map`` on the
    local shards, not their plain versions."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request
    cfg = reduced_config(arch)
    model = build_model(cfg, device="cuda", seed=0)

    def serve(mesh):
        eng = build_engine(cfg, model, slots=3, max_len=128, max_bucket=32,
                           kv_block_size=kv_block_size, mesh=mesh,
                           param_strategy=strategy,
                           plan_cfg=get_config(arch))
        eng.warmup()
        rng = np.random.RandomState(4)
        shared = rng.randint(1, cfg.vocab_size, 20).tolist()
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate((shared + [5, 6], shared + [7],
                                       rng.randint(1, cfg.vocab_size,
                                                   50).tolist()))]
        before = _launches()
        eng.run(reqs, on_truncate="raise")
        assert eng.stats.summary()["nonfinite_logits"] == 0
        return ([r.generated for r in reqs],
                tuple(b - a for a, b in zip(before, _launches())))

    got, launched = serve(card_mesh)
    want, meshless = serve(None)
    assert got == want
    assert launched == meshless and sum(launched) > 0


@pytest.mark.gpu
def test_roles_cli_on_two_cards_serves_roles_off_tokens(cuda, tmp_path):
    """``--roles prefill=1,decode=1`` under ``torch.distributed.run`` on two
    cards, one process a card (reduced qwen3, paged with the prefix cache),
    warmed (the warm suitcase crosses too): ``--roles off``'s tokens, one
    handoff a request, none pending."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the role pair puts each role on a "
                    "card of its own (NCCL takes one rank a card)")
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cli = ["-m", "repro_torch.launch.serve", "--reduced", "--max-len", "64",
           "--requests", "4", "--max-new", "6", "--warmup"]
    runs = {"off": [sys.executable] + cli,
            "roles": [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc-per-node=2"] + cli
            + ["--roles", "prefill=1,decode=1", "--metrics-json",
               str(tmp_path / "m.json")]}
    got = {}
    for name, cmd in runs.items():
        path = tmp_path / f"{name}.json"
        subprocess.run(cmd + ["--tokens-json", str(path)], cwd=root, env=env,
                       check=True, timeout=600, capture_output=True)
        got[name] = json.loads(path.read_text())
    assert got["roles"] == got["off"]
    s = json.loads((tmp_path / "m.json").read_text())
    assert s["handoffs"] == 4 and s["handoffs_pending"] == 0


# ------------------------------------ encoder-decoder and context parallel
def _greedy(model, device, mesh=None, *, b=3, s=20, max_len=40, steps=4,
            frozen=(1, 2)):
    """A right-padded one-shot prefill and ``steps`` greedy decode steps
    of ``model`` on ``device`` (row ``frozen[0]`` inactive at step
    ``frozen[1]``); on ``mesh`` the model's copy with DTensor parameters
    and states laid out by ``shardings.state_specs``.  Returns (tokens,
    logits of every call, flash launches)."""
    from repro_torch.launch import shardings as sh
    cfg = model.cfg
    rng = np.random.RandomState(9)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, (b, s))
                            .astype(np.int32))
    lens = torch.from_numpy(rng.randint(s // 2, s + 1, b).astype(np.int32))
    src = torch.from_numpy(_randn(rng, b, 16, cfg.d_model)) \
        if cfg.is_encdec else None
    states = model.init_states(b, max_len)
    bax = None
    if mesh is not None:
        bax = sh.batch_axis(mesh, b)
        model = sh.distribute_models([model], mesh)[0]
        states = sh.place_states(states, sh.state_specs(model, mesh, b,
                                                        max_len), mesh)

    def put(t, spec):
        t = t.to(device)
        return t if mesh is None else sh.local_part(
            t, mesh, sh.to_placements(spec, mesh))

    def whole(t):
        return t if mesh is None else t.full_tensor()

    before = fa.launches.n
    with torch.no_grad():
        memory = None if src is None \
            else model.encode(put(src, (bax, None, None)))
        logits, states = model.prefill(put(toks, (bax, None)), states,
                                       length=put(lens, (bax,)),
                                       memory=memory)
        out = [whole(logits).cpu()]
        tok = whole(logits).argmax(-1).to(torch.int32).cpu()
        pos = lens.clone()
        got = [tok[:, 0].tolist()]
        for step in range(steps):
            active = torch.tensor([not (r == frozen[0] and step == frozen[1])
                                   for r in range(b)])
            logits, states = model.decode_step(
                put(tok, (bax, None)), states, put(pos, (bax,)),
                active=put(active, (bax,)), memory=memory)
            out.append(whole(logits).cpu())
            nxt = whole(logits).argmax(-1).to(torch.int32).cpu()
            tok = torch.where(active[:, None], nxt, tok)
            pos = pos + active.to(torch.int32)
            got.append(tok[:, 0].tolist())
    return got, out, fa.launches.n - before


@pytest.mark.gpu
def test_encdec_prefill_and_decode_on_card_match_cpu(cuda):
    """Reduced seamless-m4t-medium (2 + 2 layers) in float32: ``encode``,
    a right-padded ``prefill(memory=)`` and four ``decode_step(memory=)``
    calls on the card against the CPU's plain versions from the same
    weights — the logits within 1e-4, the tokens equal — with one
    non-causal flash launch an encoder layer and one causal launch a
    decoder layer in the prefill (the cross-attention and the decode
    steps launch none)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    cfg = reduced_config("seamless-m4t-medium").replace(
        compute_dtype="float32")
    weights = build_model(cfg, "cpu", seed=0).state_dict()
    runs = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev)
        model.load_state_dict(weights)
        runs[str(dev)] = _greedy(model, dev)
    (t_cpu, l_cpu, _), (t_card, l_card, n) = runs["cpu"], runs[str(cuda)]
    assert n == cfg.enc_layers + cfg.num_layers
    assert t_card == t_cpu
    assert max((a - b).abs().max().item()
               for a, b in zip(l_card, l_cpu)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "falcon-mamba-7b", "seamless-m4t-medium"])
def test_context_parallel_states_on_one_rank_mesh_match_meshless(card_mesh,
                                                                 arch):
    """Reduced ``arch`` in float32 on ``make_serve_mesh()`` (a 1-rank NCCL
    mesh) with states laid out by ``state_specs`` (the context-parallel
    layout; one ``model`` rank takes the meshless attention functions):
    a one-shot prefill and four decode steps give the meshless run's
    tokens, its logits within 1e-5 and its flash launches."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    cfg = reduced_config(arch)
    cfg = cfg.replace(compute_dtype="float32",
                      num_layers=max(2, len(cfg.block_pattern)))
    model = build_model(cfg, "cuda", seed=0)
    got, l_mesh, n_mesh = _greedy(model, "cuda", card_mesh)
    want, l_want, n_want = _greedy(model, "cuda")
    assert got == want
    assert n_mesh == n_want
    assert max((a - b).abs().max().item()
               for a, b in zip(l_mesh, l_want)) <= 1e-5


@pytest.mark.gpu
def test_sharded_build_equals_build_model_on_card(card_mesh):
    """Full-width phi3.5-moe cut to 2 layers built shard by shard on
    ``make_serve_mesh()`` (``launch.shardings.build_distributed_model``,
    every parameter drawn whole on the card and its part kept): each
    parameter is ``build_model``'s on the card bit for bit, in its dtype,
    and ``ServeEngine`` takes the model as it is."""
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as sh
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(num_layers=2)
    built = sh.build_distributed_model(cfg, card_mesh, seed=0)
    want = dict(build_model(cfg, device="cuda", seed=0).named_parameters())
    assert built.device.type == "cuda"
    for name, p in built.named_parameters():
        local, ref = p.to_local(), want[name].detach()
        assert local.dtype == ref.dtype and local.shape == ref.shape, name
        assert local.is_cuda and local.is_contiguous(), name
        ints = {4: torch.int32, 2: torch.int16}[ref.element_size()]
        assert torch.equal(local.view(ints), ref.view(ints)), name
    engine = ServeEngine(built, slots=2, max_len=64, kv_block_size=16,
                         mesh=card_mesh)
    assert engine.model is built


# ------------------------------------------------------------- CUDA graphs
def _state_leaves(engine) -> list:
    return [a for st in engine.states
            for a in (st.kv if st.kv is not None
                      else [st.rec[k] for k in sorted(st.rec)])]


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}
    return t.view(ints[t.element_size()]) if t.dtype != torch.bool else t


#: the archs and dtypes the graphed engine is held to the eager one in:
#: each family in float32, and the paged one in bf16 too (cuBLAS's bf16
#: GEMMs under capture; phase 6 of ``chip_smoke.py`` serves all three in
#: bf16 at full width, tokens and launches against the eager run's)
GRAPH_CASES = [(arch, kv, "float32") for arch, kv in DISAGG_ARCHS] \
    + [("qwen3-0.6b", 8, "bfloat16")]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv_block_size,dtype", GRAPH_CASES)
def test_graphs_equal_the_eager_route_bit_for_bit_on_card(cuda, dtype, arch,
                                                          kv_block_size):
    """Reduced qwen3 (paged, a prefix hit and a copied block),
    recurrentgemma and falcon-mamba (dense): one engine on CUDA graphs and
    one with ``cuda_graphs=False`` over the same model tick in lockstep
    through the disaggregated gate's trace (bucketed prefills, a chunked
    prompt, a sampled request).  After every tick the two engines' states
    and pools hold the same bits and the same tokens have come out; a slot
    with no request keeps every bit of its row through the tick; each
    tick's launches, counted by replay on the graphed engine, are the
    eager engine's; and both count the same compiled programs."""
    from repro_torch.serve.engine import ServeEngine
    cfg, model = _lively_model(arch, dtype, cuda)
    kw = dict(max_len=128, buckets=(16, 32), prefill_chunk=32,
              kv_block_size=kv_block_size,
              kv_blocks=None if kv_block_size is None else 64)
    graphed = ServeEngine(model, slots=4, **kw)
    eager = ServeEngine(model, slots=4, cuda_graphs=False, **kw)
    for eng in (graphed, eager):
        eng.warmup()
    report = graphed.graph_report()
    assert report["graphs"] == len(graphed._table) > 0
    assert report["pool_bytes"] > 0 and eager.graph_report()["graphs"] == 0
    traces = [_disagg_trace(cfg.vocab_size) for _ in range(2)]
    for eng, reqs in zip((graphed, eager), traces):
        for r in reqs[:4]:
            eng.submit(r)
    frozen, late = 0, [False, False]
    for tick in range(200):
        for k, (eng, reqs) in enumerate(zip((graphed, eager), traces)):
            # the prefix sharers one after the other: the second hits the
            # first's published tokens mid-block and clones that block
            if tick == 3:
                eng.submit(reqs[4])
            if reqs[4].done and not late[k]:
                eng.submit(reqs[5])
                late[k] = True
        moved = []
        for eng in (graphed, eager):
            idle = [i for i, r in enumerate(eng.requests) if r is None
                    and not eng._queue]
            rows = [[a[i].clone() for a in _state_leaves(eng)
                     if a.shape[0] == eng.slots] for i in idle]
            before = [c.n for c in (fa.launches, pa.launches, pr.launches,
                                    pr.decode_launches, ps.launches,
                                    ps.decode_launches)]
            eng.step()
            moved.append([c.n - b for c, b in zip(
                (fa.launches, pa.launches, pr.launches, pr.decode_launches,
                 ps.launches, ps.decode_launches), before)])
            for i, row in zip(idle, rows):
                if eng.requests[i] is None:
                    now = [a[i] for a in _state_leaves(eng)
                           if a.shape[0] == eng.slots]
                    assert all(torch.equal(_bits(x), _bits(y))
                               for x, y in zip(row, now)), (tick, i)
                    frozen += 1
        assert moved[0] == moved[1], tick
        for a, b in zip(_state_leaves(graphed), _state_leaves(eager)):
            assert torch.equal(_bits(a), _bits(b)), tick
        assert [r.generated for r in traces[0]] \
            == [r.generated for r in traces[1]], tick
        if all(r.done for t in traces for r in t):
            break
    assert all(r.done for t in traces for r in t) and frozen > 0
    assert len({tuple(r.generated) for r in traces[0]}) > 1
    s, e = graphed.stats.summary(), eager.stats.summary()
    assert s["prefill_chunks"] >= 1
    if kv_block_size is not None:
        assert s["kv"]["blocks_copied"] >= 1
    assert (s["prefill_compiles"], s["decode_compiles"]) \
        == (e["prefill_compiles"], e["decode_compiles"])
    assert graphed.graph_report()["graphs"] == report["graphs"]


@pytest.mark.gpu
def test_capture_that_meets_a_host_sync_raises_on_card(cuda):
    """A program whose body reads a value on the host cannot be one graph:
    its capture raises, and no entry falls back to the eager call."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = reduced_config("qwen3-0.6b").replace(compute_dtype="float32")
    engine = ServeEngine(build_model(cfg, device=cuda, seed=0), slots=2,
                         max_len=64)
    with pytest.raises(RuntimeError):
        engine._program("probe", lambda x: (x * 2).sum().item(),
                        np.ones((4,), np.float32))
    assert not engine._table
    torch.cuda.synchronize()
    engine.warmup()                   # the card serves on after the refusal
    assert engine.graph_report()["graphs"] == len(engine._table) > 0
    with pytest.raises(RuntimeError):          # and refuses it again
        engine._program("probe", lambda x: (x * 2).sum().item(),
                        np.ones((4,), np.float32))
