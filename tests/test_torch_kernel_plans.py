"""What the redesigned kernels' wrappers take and refuse, checked on the
CPU before they look for a card: dtypes, shapes, head dims, strides and
alignment for flash (its bf16 route copies 16 bytes at a time), rows and
layouts for the GEMV.  Each kernel's launch geometry lives in its C entry
(the shared memory of every flash instantiation is checked against 227 KB
when it compiles); the gpu tests cover its rows on the card."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import jacquard_gemv as jg  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.jacquard_gemv import kernel as gk  # noqa: E402

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
