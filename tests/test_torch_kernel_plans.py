"""What the redesigned kernels' wrappers take and refuse, checked on the
CPU before they look for a card: dtypes, shapes, head dims, strides and
alignment for flash (its bf16 route copies 16 bytes at a time), rows and
layouts for the GEMV, dtypes, shapes and layouts for the Pascal matmul and
the LSTM recurrence, and dtypes, shapes, head dims, layouts and alignment
for paged decode (its blocks are bulk copies).  Each kernel's launch
geometry lives in its C entry (the shared memory of every flash and Pascal
tensor-core instantiation is checked against 227 KB when it compiles; the
LSTM's layout and paged decode's splits are planned per call from the
card's SM count); the gpu tests cover them on the card."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import jacquard_gemv as jg  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import pavlov_rglru as pr  # noqa: E402
from repro_torch.kernels import pavlov_ssm as ps  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.jacquard_gemv import kernel as gk  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pgk  # noqa: E402
from repro_torch.kernels.pascal_matmul import kernel as pk  # noqa: E402
from repro_torch.kernels.pavlov_lstm import kernel as lk  # noqa: E402
from repro_torch.kernels.pavlov_rglru import kernel as rk  # noqa: E402
from repro_torch.kernels.pavlov_ssm import kernel as sk  # noqa: E402

DTYPES = (torch.bfloat16, torch.float32)


# ------------------------------------------------- what the wrappers refuse
def _qkv(dtype=torch.bfloat16, hd=64, s=8):
    return (torch.zeros(1, s, 4, hd, dtype=dtype),
            torch.zeros(1, s, 2, hd, dtype=dtype),
            torch.zeros(1, s, 2, hd, dtype=dtype))


def test_flash_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_raw(*_qkv())


@pytest.mark.parametrize("bad,exc,match", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), TypeError, "dtypes"),
    (lambda q, k, v: (q, k.float(), v), TypeError, "dtypes"),
    (lambda q, k, v: (q[..., :32].contiguous(), k, v), ValueError,
     "GQA"),
    (lambda q, k, v: (q, k[:, :, :1], v), ValueError, "shapes"),
    (lambda q, k, v: (q[:, :, :3], k, v), ValueError, "GQA"),
    (lambda q, k, v: (q, k, v[:, :4]), ValueError, "shapes"),
    (lambda q, k, v: (q.transpose(1, 3), k, v), ValueError, "GQA"),
    (lambda q, k, v: (q[..., :48].contiguous(), k[..., :48].contiguous(),
                      v[..., :48].contiguous()), ValueError, "head_dim"),
    (lambda q, k, v: (q.transpose(1, 3).contiguous().transpose(1, 3), k,
                      v), ValueError, "contiguous"),
    (lambda q, k, v: (q[0], k[0], v[0]), ValueError, "shapes"),
])
def test_flash_refuses_shapes_and_dtypes(bad, exc, match):
    with pytest.raises(exc, match=match):
        fk.flash_attention_raw(*bad(*_qkv()))


def test_flash_refuses_unaligned_bf16_strides_and_negative_window():
    q, k, v = _qkv()
    # head_dim contiguous, but rows 65 elements apart: not 16-byte copies
    wide = torch.zeros(1, 8, 4, 65, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        fk.flash_attention_raw(wide, k, v)
    with pytest.raises(ValueError, match="window"):
        fk.flash_attention_raw(q, k, v, window=-1)
    # the SIMT route copies element by element: float32 takes such strides
    # and fails only for want of a card
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_raw(wide.float(), k.float(), v.float())


def test_gemv_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        gk.jacquard_gemv_raw(torch.zeros(1, 8), torch.zeros(8, 4))


@pytest.mark.parametrize("x,w,exc,match", [
    (torch.zeros(1, 8, dtype=torch.half),
     torch.zeros(8, 4, dtype=torch.half), TypeError, "dtypes"),
    (torch.zeros(1, 8), torch.zeros(8, 4, dtype=torch.bfloat16), TypeError,
     "dtypes"),
    (torch.zeros(1, 8), torch.zeros(9, 4), ValueError, "shapes"),
    (torch.zeros(17, 8), torch.zeros(8, 4), ValueError, "rows"),
    (torch.zeros(8), torch.zeros(8, 4), ValueError, "shapes"),
    (torch.zeros(1, 0), torch.zeros(0, 4), ValueError, "shapes"),
    (torch.zeros(2, 8)[:, ::2], torch.zeros(4, 4), ValueError, "contiguous"),
    (torch.zeros(1, 8), torch.zeros(4, 8).T, ValueError, "contiguous"),
])
def test_gemv_refuses_shapes_dtypes_and_layouts(x, w, exc, match):
    with pytest.raises(exc, match=match):
        gk.jacquard_gemv_raw(x, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [8, 32, 48, 96, 100, 512])
def test_flash_refuses_head_dims_without_an_instantiation(dtype, hd):
    q = torch.zeros(1, 8, 4, hd, dtype=dtype)
    k = torch.zeros(1, 8, 2, hd, dtype=dtype)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_raw(q, k, k.clone())


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("how", ["base", "stride"])
def test_flash_bf16_refuses_each_unaligned_operand(which, how):
    """The bf16 route's 16-byte copies need every operand aligned: q by
    cp.async, k and v by TMA."""
    qkv = list(_qkv())
    x = qkv[which]
    if how == "base":        # one element in: base 2 bytes off 16
        x = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    else:                    # head rows 68 elements apart, not a multiple of 8
        x = torch.zeros(*x.shape[:3], 68, dtype=x.dtype)[..., :64]
    qkv[which] = x
    with pytest.raises(ValueError, match="16 bytes"):
        fk.flash_attention_raw(*qkv)


def _projection_views(dtype, h, kvh, hd, b=2, s=24):
    """q, k and v as views of one fused (B, S, (H + 2 KVH) hd) projection,
    as a model can hand them over."""
    qkv = torch.zeros(b, s, (h + 2 * kvh) * hd, dtype=dtype)
    return (qkv[..., :h * hd].unflatten(-1, (h, hd)),
            qkv[..., h * hd:(h + kvh) * hd].unflatten(-1, (kvh, hd)),
            qkv[..., (h + kvh) * hd:].unflatten(-1, (kvh, hd)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", fk.HEAD_DIMS)
@pytest.mark.parametrize("layout", ["contiguous", "projection"])
def test_flash_takes_every_head_dim_and_layout_it_serves(dtype, hd, layout):
    """What the models hand over passes every check, and fails only for
    want of a card."""
    if layout == "contiguous":
        q = torch.zeros(2, 24, 4, hd, dtype=dtype)
        k = torch.zeros(2, 24, 2, hd, dtype=dtype)
        v = torch.zeros(2, 24, 2, hd, dtype=dtype)
    else:
        q, k, v = _projection_views(dtype, 4, 2, hd)
        assert not q.is_contiguous()
    fk.check_flash_args(q, k, v, window=16)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_raw(q, k, v, window=16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,kvh,hd", [
    (14, 2, 64),        # qwen2-0.5b: a fused width of 1152 with qkv bias
    (9, 3, 64),         # smollm-135m: 960
    (36, 4, 128),       # starcoder2-7b: 5632 with qkv bias
    (16, 8, 128)])      # qwen3-0.6b and internvl2-2b: 4096
def test_flash_takes_each_archs_projection_views(dtype, h, kvh, hd):
    """Views of each served arch's fused (B, S, (H + 2 KVH) hd) projection
    pass every check, and fail only for want of a card."""
    q, k, v = _projection_views(dtype, h, kvh, hd)
    assert q.stride(1) == (h + 2 * kvh) * hd and not q.is_contiguous()
    fk.check_flash_args(q, k, v, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_raw(q, k, v)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,kvh,hd,window", [(4, 2, 64, 0), (10, 1, 256, 8),
                                             (2, 2, 16, 0)])
def test_flash_on_cpu_tensors_is_the_plain_version(dtype, h, kvh, hd,
                                                   window):
    """The public wrapper runs the plain version for CPU tensors, and only
    because they lie on the CPU: the same bits as calling it directly."""
    gen = torch.Generator().manual_seed(h * hd + window)
    q = torch.randn(1, 12, h, hd, generator=gen).to(dtype)
    k = torch.randn(1, 12, kvh, hd, generator=gen).to(dtype)
    v = torch.randn(1, 12, kvh, hd, generator=gen).to(dtype)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    ref = fa.flash_attention_ref(q, k, v, causal=True, window=window)
    assert out.dtype == dtype and torch.equal(out, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 16])
def test_gemv_takes_every_row_count_it_serves(dtype, m):
    x = torch.zeros(m, 40, dtype=dtype)
    w = torch.zeros(40, 24, dtype=dtype)
    gk.check_gemv_args(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        gk.jacquard_gemv_raw(x, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead", [(1,), (4,), (2, 3)])
def test_gemv_on_cpu_tensors_is_the_plain_version(dtype, lead):
    gen = torch.Generator().manual_seed(len(lead) * 10 + lead[-1])
    x = torch.randn(*lead, 96, generator=gen).to(dtype)
    w = torch.randn(96, 37, generator=gen).to(dtype)
    out = jg.jacquard_gemv(x, w)
    ref = jg.jacquard_gemv_ref(x.reshape(-1, 96), w).reshape(*lead, 37)
    assert out.shape == (*lead, 37) and torch.equal(out, ref)


@pytest.mark.parametrize("x,w,exc,match", [
    (torch.zeros(2, 8, dtype=torch.half),
     torch.zeros(8, 4, dtype=torch.half), TypeError, "dtypes"),
    (torch.zeros(2, 8, dtype=torch.bfloat16), torch.zeros(8, 4), TypeError,
     "dtypes"),
    (torch.zeros(2, 8), torch.zeros(9, 4), ValueError, "shapes"),
    (torch.zeros(8), torch.zeros(8, 4), ValueError, "shapes"),
    (torch.zeros(0, 8), torch.zeros(8, 4), ValueError, "shapes"),
    (torch.zeros(2, 16)[:, ::2], torch.zeros(8, 4), ValueError,
     "contiguous"),
    (torch.zeros(2, 8), torch.zeros(4, 8).T, ValueError, "contiguous"),
])
def test_pascal_refuses_shapes_dtypes_and_layouts(x, w, exc, match):
    """Refused on the CPU, before the wrapper looks for a card."""
    with pytest.raises(exc, match=match):
        pk.pascal_matmul_raw(x, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(200, 2048, 8192), (1, 640, 8192),
                                   (111, 300, 1000), (1, 64, 33)])
def test_pascal_takes_both_routes_shapes(dtype, m, k, n):
    """Aligned shapes (the tensor-core route in bf16) and ragged ones (the
    SIMT route) pass every check, and fail only for want of a card."""
    x = torch.empty(m, k, dtype=dtype)
    w = torch.empty(k, n, dtype=dtype)
    pk.check_pascal_args(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        pk.pascal_matmul_raw(x, w)


def _lstm_args(dtype=torch.float32, b=2, t=3, hd=8):
    return (torch.zeros(b, t, 4 * hd, dtype=dtype),
            torch.zeros(hd, 4 * hd, dtype=dtype),
            torch.zeros(b, hd), torch.zeros(b, hd))


@pytest.mark.parametrize("bad,exc,match", [
    (lambda xg, wh, h, c: (xg.half(), wh.half(), h, c), TypeError, "dtypes"),
    (lambda xg, wh, h, c: (xg, wh.bfloat16(), h, c), TypeError, "dtypes"),
    (lambda xg, wh, h, c: (xg, wh, h.double(), c), TypeError, "float32"),
    (lambda xg, wh, h, c: (xg, wh, h, c.bfloat16()), TypeError, "float32"),
    (lambda xg, wh, h, c: (xg[..., :30], wh, h, c), ValueError, "4H"),
    (lambda xg, wh, h, c: (xg[0], wh, h, c), ValueError, "4H"),
    (lambda xg, wh, h, c: (xg[:, :0], wh, h, c), ValueError, "4H"),
    (lambda xg, wh, h, c: (xg, wh[:4], h, c), ValueError, "w_h"),
    (lambda xg, wh, h, c: (xg, wh, h[:1], c), ValueError, "h0/c0"),
    (lambda xg, wh, h, c: (xg, wh, h, c[:, :4]), ValueError, "h0/c0"),
    (lambda xg, wh, h, c: (xg.transpose(0, 1).contiguous().transpose(0, 1),
                           wh, h, c), ValueError, "contiguous"),
    (lambda xg, wh, h, c: (xg, wh.T.contiguous().T, h, c), ValueError,
     "contiguous"),
])
def test_lstm_refuses_shapes_dtypes_and_layouts(bad, exc, match):
    """Refused on the CPU, before the wrapper looks for a card."""
    with pytest.raises(exc, match=match):
        lk.pavlov_lstm_raw(*bad(*_lstm_args()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hd,state", [(1, 2048, False), (4, 2900, True),
                                        (5, 100, True), (2, 37, False)])
def test_lstm_takes_every_width_and_batch_it_serves(dtype, b, hd, state):
    """TR1's and LSTM4's widths, a batch past one group of 4, odd H: every
    check passes, and the call fails only for want of a card."""
    xg, wh, h, c = _lstm_args(dtype, b, 2, hd)
    args = (xg, wh, h, c) if state else (xg, wh)
    lk.check_lstm_args(*args)
    with pytest.raises(ValueError, match="CUDA"):
        lk.pavlov_lstm_raw(*args)


def _paged_args(dtype=torch.bfloat16, b=3, h=4, kvh=2, hd=64, n=6, bs=4,
                nb=2):
    return (torch.zeros(b, h, hd, dtype=dtype),
            torch.zeros(n, bs, kvh, hd, dtype=dtype),
            torch.zeros(n, bs, kvh, hd, dtype=dtype),
            torch.zeros(b, nb, dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32))


def test_paged_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        pgk.paged_decode_attention_raw(*_paged_args())


@pytest.mark.parametrize("bad,exc,match", [
    (lambda q, k, v, t, n: (q.half(), k.half(), v.half(), t, n), TypeError,
     "dtypes"),
    (lambda q, k, v, t, n: (q, k.float(), v, t, n), TypeError, "dtypes"),
    (lambda q, k, v, t, n: (q.float(), k, v, t, n), TypeError, "dtypes"),
    (lambda q, k, v, t, n: (q, k, v, t.long(), n), TypeError, "int32"),
    (lambda q, k, v, t, n: (q, k, v, t, n.long()), TypeError, "int32"),
    (lambda q, k, v, t, n: (q, k, v[:3], t, n), ValueError, "shapes"),
    (lambda q, k, v, t, n: (q, k[..., :32], v[..., :32], t, n), ValueError,
     "shapes"),
    (lambda q, k, v, t, n: (q[:, :3], k, v, t, n), ValueError, "shapes"),
    (lambda q, k, v, t, n: (q, k, v, t[:2], n), ValueError, "shapes"),
    (lambda q, k, v, t, n: (q, k, v, t, n[:2]), ValueError, "shapes"),
    (lambda q, k, v, t, n: (q, k, v, t[0], n), ValueError, "shapes"),
    (lambda q, k, v, t, n: (q[0], k, v, t, n), ValueError, "shapes"),
    (lambda q, k, v, t, n: (q, k, v, t[:, :0], n), ValueError, "shapes"),
    (lambda q, k, v, t, n: (q, k.transpose(0, 1).contiguous().transpose(0, 1),
                            v, t, n), ValueError, "contiguous"),
    (lambda q, k, v, t, n: (q, k, v.transpose(2, 3).contiguous().transpose(
        2, 3), t, n), ValueError, "contiguous"),
    (lambda q, k, v, t, n: (q, k, v, t.T.contiguous().T, n), ValueError,
     "contiguous"),
    (lambda q, k, v, t, n: (q.transpose(0, 1).contiguous().transpose(0, 1),
                            k, v, t, n), ValueError, "contiguous"),
])
def test_paged_refuses_shapes_dtypes_and_layouts(bad, exc, match):
    """Refused on the CPU, before the wrapper looks for a card."""
    with pytest.raises(exc, match=match):
        pgk.paged_decode_attention_raw(*bad(*_paged_args()))


def test_paged_refuses_unaligned_pools():
    """Blocks are bulk copies: a pool must start on 16 bytes."""
    q, k, v, t, n = _paged_args()
    off = torch.zeros(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        pgk.paged_decode_attention_raw(q, off, v, t, n)
    with pytest.raises(ValueError, match="16-byte"):
        pgk.paged_decode_attention_raw(q, k, off, t, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [8, 32, 48, 96, 100, 512])
def test_paged_refuses_head_dims_without_an_instantiation(dtype, hd):
    with pytest.raises(ValueError, match="head_dim"):
        pgk.paged_decode_attention_raw(*_paged_args(dtype, hd=hd))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", pgk.HEAD_DIMS)
@pytest.mark.parametrize("h,kvh,bs", [(16, 8, 16), (14, 2, 16), (8, 8, 8),
                                      (10, 1, 16), (40, 8, 48), (9, 3, 1),
                                      (36, 4, 16)])
def test_paged_takes_every_head_dim_group_and_block_size(dtype, hd, h, kvh,
                                                         bs):
    """Every head dim, the configs' GQA groups and any block size pass
    every check, and fail only for want of a card."""
    args = _paged_args(dtype, b=2, h=h, kvh=kvh, hd=hd, n=5, bs=bs, nb=3)
    pgk.check_paged_args(*args)
    with pytest.raises(ValueError, match="CUDA"):
        pgk.paged_decode_attention_raw(*args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,kvh,hd", [(4, 2, 16), (14, 2, 64), (10, 1, 256)])
def test_paged_on_cpu_tensors_is_the_plain_version(dtype, h, kvh, hd):
    """The public op runs the plain version for CPU tensors, and only
    because they lie on the CPU: the same bits as calling it directly."""
    gen = torch.Generator().manual_seed(h * hd)
    n, bs, nb, b = 12, 8, 4, 3
    q = torch.randn(b, h, hd, generator=gen).to(dtype)
    kp = torch.randn(n, bs, kvh, hd, generator=gen).to(dtype)
    vp = torch.randn(n, bs, kvh, hd, generator=gen).to(dtype)
    table = torch.randperm(n, generator=gen)[:b * nb].reshape(b, nb).int()
    lengths = torch.tensor([0, 9, 31], dtype=torch.int32)
    out = pa.paged_attention(q, kp, vp, table, lengths)
    ref = pa.paged_attention_ref(q, kp, vp, table, lengths)
    assert out.dtype == dtype and torch.equal(out, ref)


# ------------------------------------------------------ the recurrent scans
def test_rglru_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rk.pavlov_rglru_raw(torch.zeros(2, 3, 8), torch.zeros(2, 3, 8))


@pytest.mark.parametrize("bad,exc,match", [
    (lambda a, b: (a.half(), b.half()), TypeError, "dtypes"),
    (lambda a, b: (a.double(), b.double()), TypeError, "dtypes"),
    (lambda a, b: (a, b.bfloat16()), TypeError, "dtypes"),
    (lambda a, b: (a.bfloat16(), b), TypeError, "dtypes"),
    (lambda a, b: (a, b[:, :2]), ValueError, "shapes"),
    (lambda a, b: (a[..., :4], b), ValueError, "shapes"),
    (lambda a, b: (a[0], b[0]), ValueError, "shapes"),
    (lambda a, b: (a[:, :0], b[:, :0]), ValueError, "shapes"),
    (lambda a, b: (a.transpose(1, 2).contiguous().transpose(1, 2), b),
     ValueError, "contiguous"),
    (lambda a, b: (a, b.transpose(0, 1).contiguous().transpose(0, 1)),
     ValueError, "contiguous"),
    (lambda a, b: (torch.zeros(2, 3, 16)[..., ::2], b), ValueError,
     "contiguous"),
])
def test_rglru_refuses_shapes_dtypes_and_layouts(bad, exc, match):
    """Refused on the CPU, before the wrapper looks for a card."""
    with pytest.raises(exc, match=match):
        rk.pavlov_rglru_raw(*bad(torch.zeros(2, 3, 8), torch.zeros(2, 3, 8)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,e", [(4, 256, 2560), (4, 1, 2560),
                                   (1, 256, 2560), (3, 100, 2600),
                                   (2, 7, 37)])
def test_rglru_takes_every_shape_it_serves(dtype, b, t, e):
    """Prefill chunks, decode steps, an E past the ring's 32-channel strips
    and rows no TMA box can take (the element route): every check passes,
    and the call fails only for want of a card."""
    a = torch.zeros(b, t, e, dtype=dtype)
    rk.check_rglru_args(a, a.clone())
    with pytest.raises(ValueError, match="CUDA"):
        rk.pavlov_rglru_raw(a, a.clone())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,e", [(2, 1, 40), (3, 17, 33), (1, 64, 8)])
def test_rglru_on_cpu_tensors_is_the_plain_version(dtype, b, t, e):
    """The public wrapper runs the plain version for CPU tensors, and only
    because they lie on the CPU: the same bits as calling it directly."""
    gen = torch.Generator().manual_seed(b * 100 + t)
    a = torch.rand(b, t, e, generator=gen).to(dtype)
    drive = torch.randn(b, t, e, generator=gen).to(dtype)
    out = pr.pavlov_rglru(a, drive)
    ref = pr.pavlov_rglru_ref(a, drive)
    assert out.dtype == dtype and torch.equal(out, ref)


def _ssm_args(dtype=torch.float32, b=2, t=3, d=8, n=4):
    return [torch.zeros(b, t, d, dtype=dtype),
            torch.zeros(b, t, d, dtype=dtype),
            torch.zeros(b, t, n, dtype=dtype),
            torch.zeros(b, t, n, dtype=dtype),
            torch.zeros(d, n), torch.zeros(d), torch.zeros(b, d, n),
            torch.zeros(b, dtype=torch.int32)]


def test_ssm_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        sk.pavlov_ssm_raw(*_ssm_args())


def _bad_ssm(i, f):
    """_ssm_args with argument i replaced by f(it)."""
    def make(args):
        args[i] = f(args[i])
        return args
    return make


def _strided(x):
    return x.transpose(0, -1).contiguous().transpose(0, -1)


@pytest.mark.parametrize("bad,exc,match", [
    (_bad_ssm(0, lambda t: t.half()), TypeError, "dtypes"),
    (_bad_ssm(1, lambda t: t.bfloat16()), TypeError, "dtypes"),
    (_bad_ssm(2, lambda t: t.double()), TypeError, "dtypes"),
    (_bad_ssm(3, lambda t: t.bfloat16()), TypeError, "dtypes"),
    (_bad_ssm(4, lambda t: t.bfloat16()), TypeError, "float32"),
    (_bad_ssm(5, lambda t: t.double()), TypeError, "float32"),
    (_bad_ssm(6, lambda t: t.bfloat16()), TypeError, "float32"),
    (_bad_ssm(7, lambda t: t.long()), TypeError, "int32"),
    (_bad_ssm(0, lambda t: t[0]), ValueError, "delta"),
    (_bad_ssm(0, lambda t: t[:, :0]), ValueError, "delta"),
    (_bad_ssm(1, lambda t: t[..., :4]), ValueError, "x"),
    (_bad_ssm(2, lambda t: t[:, :2]), ValueError, "bc"),
    (_bad_ssm(3, lambda t: t[..., :2]), ValueError, "bc"),
    (_bad_ssm(4, lambda t: t[:4]), ValueError, "need"),
    (_bad_ssm(5, lambda t: t[:4]), ValueError, "d_skip"),
    (_bad_ssm(6, lambda t: t[:1]), ValueError, "h0"),
    (_bad_ssm(7, lambda t: t[:1]), ValueError, "length"),
    (_bad_ssm(0, _strided), ValueError, "contiguous"),
    (_bad_ssm(1, _strided), ValueError, "contiguous"),
    (_bad_ssm(2, _strided), ValueError, "contiguous"),
    (_bad_ssm(3, _strided), ValueError, "contiguous"),
    (_bad_ssm(4, _strided), ValueError, "contiguous"),
    (_bad_ssm(6, _strided), ValueError, "contiguous"),
    (_bad_ssm(5, lambda t: torch.zeros(16)[::2]), ValueError, "contiguous"),
])
def test_ssm_refuses_shapes_dtypes_and_layouts(bad, exc, match):
    """Refused on the CPU, before the wrapper looks for a card."""
    with pytest.raises(exc, match=match):
        sk.pavlov_ssm_raw(*bad(_ssm_args()))


@pytest.mark.parametrize("n", [0, 33, 64])
def test_ssm_refuses_state_sizes_outside_1_to_32(n):
    with pytest.raises(ValueError, match="N <= 32"):
        sk.pavlov_ssm_raw(*_ssm_args(n=n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3, 4, 8, 12, 16, 32])
@pytest.mark.parametrize("t,state", [(1, True), (256, True), (37, False)])
def test_ssm_takes_every_state_size_and_step_count(dtype, n, t, state):
    """Every N up to 32 (the ring's 4, 8, 16, 32 and the direct route's
    others), decode steps and prefill chunks, with and without a carried
    state: every check passes, and the call fails only for want of a
    card."""
    args = _ssm_args(dtype, b=2, t=t, d=40, n=n)
    if not state:
        args[6:] = [None, None]
    sk.check_ssm_args(*args)
    with pytest.raises(ValueError, match="CUDA"):
        sk.pavlov_ssm_raw(*args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,d,n,state", [(3, 9, 24, 16, True),
                                           (2, 1, 40, 4, True),
                                           (1, 12, 17, 5, False)])
def test_ssm_on_cpu_tensors_is_the_plain_version(dtype, b, t, d, n, state):
    """The public wrapper runs the plain version for CPU tensors, and only
    because they lie on the CPU: the same bits as calling it directly."""
    gen = torch.Generator().manual_seed(b * 1000 + t * 10 + n)
    args = [torch.rand(b, t, d, generator=gen).to(dtype) * 0.1,
            torch.randn(b, t, d, generator=gen).to(dtype),
            torch.randn(b, t, n, generator=gen).to(dtype),
            torch.randn(b, t, n, generator=gen).to(dtype),
            -torch.rand(d, n, generator=gen) * n,
            torch.randn(d, generator=gen),
            torch.randn(b, d, n, generator=gen),
            torch.tensor([t, 0, 1][:b], dtype=torch.int32)]
    if not state:
        args[6:] = [None, None]
    y, h_t = ps.pavlov_ssm(*args)
    y_ref, h_ref = ps.pavlov_ssm_ref(*args)
    assert y.dtype == dtype and torch.equal(y, y_ref)
    assert h_t.dtype == torch.float32 and torch.equal(h_t, h_ref)


# --------------------------------------------------- no kernel has a backward
def _wrapper_calls():
    """Each ops.py wrapper with small float32 inputs on the CPU, as a
    function of the tensor that may require its gradient."""
    from repro_torch.kernels.pascal_matmul import ops as pmo
    from repro_torch.kernels.pavlov_lstm import ops as plo
    x = torch.randn(2, 8, 4, 16)
    kv = torch.randn(2, 8, 2, 16)
    pool = torch.randn(4, 8, 2, 16)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lengths = torch.tensor([3, 9], dtype=torch.int32)
    a = torch.rand(2, 5, 8)
    w = torch.randn(16, 12)
    d, n = 8, 4
    return {
        "flash_attention": (x, lambda t: fa.flash_attention(t, kv, kv)),
        "paged_attention": (x[:, 0], lambda t: pa.paged_attention(
            t, pool, pool, table, lengths)),
        "paged_decode_attention": (x[:, :1], lambda t: pa.paged_decode_attention(
            t, kv[:, :1], kv[:, :1], pool.clone(), pool.clone(), table,
            lengths)),
        "pavlov_rglru": (a, lambda t: pr.pavlov_rglru(t, a)),
        "pavlov_ssm": (torch.rand(2, 5, d), lambda t: ps.pavlov_ssm(
            t, torch.randn(2, 5, d), torch.randn(2, 5, n),
            torch.randn(2, 5, n), -torch.rand(d, n), torch.ones(d))),
        "pascal_matmul": (w, lambda t: pmo.pascal_matmul(
            torch.randn(3, 16), t)),
        "jacquard_gemv": (w, lambda t: jg.jacquard_gemv(
            torch.randn(2, 16), t)),
        "lstm_recurrence": (torch.randn(4, 16), lambda t: plo.lstm_recurrence(
            torch.randn(2, 5, 16), t)),
        "pavlov_lstm": (torch.randn(16, 16), lambda t: plo.pavlov_lstm(
            torch.randn(2, 5, 16), t, torch.randn(4, 16), torch.zeros(16))),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_every_wrapper_refuses_autograd(name):
    """A wrapper would return a tensor with no ``grad_fn``: where autograd
    records an input that requires its gradient it raises instead, on
    either device (here the CPU's plain versions); without autograd, or
    with no input requiring a gradient, it runs."""
    base, call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(base.clone().requires_grad_())
    with torch.no_grad():
        call(base.clone().requires_grad_())
    call(base.clone())
