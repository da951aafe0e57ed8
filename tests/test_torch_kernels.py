"""The port's attention kernels' plain versions against the JAX package's
Pallas kernels (interpret mode on the CPU, as tests/test_kernels.py runs
them) and their jnp oracles, and the drop-on-sentinel scatter.  The CUDA
kernels' own tests are in test_torch_gpu.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.paged_attention import paged_decode_attention as jax_paged  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import pavlov_rglru as pr  # noqa: E402

from test_torch_gpu import _paged_case, _randn  # noqa: E402

ATOL = 1e-5     # float32 on both sides: only the summation order differs


@pytest.mark.parametrize("sq,skv,h,kvh,hd,window", [
    (16, 16, 4, 2, 16, 0),      # GQA
    (32, 32, 4, 1, 16, 8),      # MQA + sliding window
    (20, 20, 4, 2, 16, 0),      # ragged S (not a multiple of any tile)
    (8, 24, 4, 2, 16, 0),       # q aligned to the end of a longer KV
])
def test_flash_plain_matches_pallas_and_oracle(sq, skv, h, kvh, hd, window):
    rng = np.random.RandomState(sq * 100 + skv + window)
    q = _randn(rng, 2, sq, h, hd)
    k = _randn(rng, 2, skv, kvh, hd)
    v = _randn(rng, 2, skv, kvh, hd)
    port = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window).numpy()
    pallas = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=window))
    oracle = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      window=window))
    np.testing.assert_allclose(port, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(port, oracle, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,h,kvh,hd,n,bs,nb", [
    (3, 4, 2, 16, 10, 8, 4),    # GQA
    (3, 8, 1, 16, 12, 4, 6),    # MQA, many small blocks
])
def test_paged_plain_matches_pallas(B, h, kvh, hd, n, bs, nb):
    c = _paged_case(np.random.RandomState(n + nb), B, h, kvh, hd, n, bs, nb)
    assert c["table"][-1, c["lengths"][-1] // bs] == n    # a dropped write
    out, kp, vp = pa.paged_decode_attention(
        *(torch.from_numpy(c[x].copy()) for x in
          ("q", "nk", "nv", "kp", "vp", "table", "lengths")))
    outj, kpj, vpj = jax_paged(*(jnp.asarray(c[x]) for x in
                                 ("q", "nk", "nv", "kp", "vp", "table",
                                  "lengths")))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kpj))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vpj))
    np.testing.assert_allclose(out.numpy(), np.asarray(outj), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("blk", [
    [2, 5, 1],          # all kept
    [2, 9, -1],         # out of range both ways: dropped
    [9, 9, 9],          # nothing kept
    [3, 7, 3],          # a dropped row beside a kept one
])
def test_scatter_paged_drops_out_of_range_rows(blk):
    n, bs = 7, 4
    rng = np.random.RandomState(len(blk) + sum(blk))
    pool = _randn(rng, n, bs, 2, 3)
    off = np.asarray([1, 3, 0])
    vals = _randn(rng, 3, 2, 3)
    want = pool.copy()
    for b, o, val in zip(blk, off, vals):
        if 0 <= b < n:
            want[b, o] = val
    got = pa.scatter_paged(torch.from_numpy(pool.copy()), torch.tensor(blk),
                           torch.from_numpy(off), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version: no build, no launch."""
    rng = np.random.RandomState(0)
    before = (fa.launches.n, pa.launches.n, pr.launches.n)
    x = torch.from_numpy(_randn(rng, 1, 8, 2, 16))
    fa.flash_attention(x, x, x)
    c = _paged_case(rng, 2, 2, 2, 16, 4, 4, 2)
    pa.paged_decode_attention(*(torch.from_numpy(c[k].copy()) for k in
                                ("q", "nk", "nv", "kp", "vp", "table",
                                 "lengths")))
    pr.pavlov_rglru(x[0], x[0])
    assert (fa.launches.n, pa.launches.n, pr.launches.n) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch functions take only CUDA tensors; they never fall back."""
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_raw(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention_raw(
            torch.zeros(1, 2, 16), torch.zeros(2, 4, 2, 16),
            torch.zeros(2, 4, 2, 16), torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        pr.pavlov_rglru_raw(x[0], x[0])
