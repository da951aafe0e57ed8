"""The port's sampling against ``repro.serve.sampling``: greedy rows are the
exact argmax; top-k / top-p keep-sets are the JAX package's for the same
logits; a seeded stream reproduces."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve.sampling import sample_tokens as jax_sample  # noqa: E402
from repro_torch.serve.sampling import keep_mask, sample_tokens  # noqa: E402

V = 64


def _logits(seed, rows=4):
    return np.random.RandomState(seed).standard_normal((rows, V)) \
        .astype(np.float32) * 3


def _jax_keep(scaled, top_k, top_p):
    """The keep-set ``repro.serve.sampling._sample_row`` forms (its
    lines 33-47), for one row of temperature-scaled logits."""
    v = scaled.shape[-1]
    sorted_desc = jnp.sort(scaled)[::-1]
    kth = sorted_desc[jnp.clip(top_k, 1, v) - 1]
    keep_k = (top_k <= 0) | (scaled >= kth)
    scaled = jnp.where(keep_k, scaled, -1e30)
    sorted_desc = jnp.sort(scaled)[::-1]
    order = jnp.argsort(-scaled)
    probs = jax.nn.softmax(sorted_desc)
    cum_before = jnp.cumsum(probs) - probs
    keep_sorted = cum_before < jnp.maximum(top_p, 1e-6)
    keep_p = jnp.zeros((v,), bool).at[order].set(keep_sorted)
    return np.asarray(keep_k & keep_p)


def test_greedy_rows_are_exact_argmax():
    lg = _logits(0, rows=6)
    lg[2, 5] = lg[2, 9] = lg[2].max() + 1        # a tie: first index wins
    n = len(lg)
    got = sample_tokens(torch.from_numpy(lg), [0.0] * n, [0] * n, [1.0] * n,
                        list(range(n)), [3] * n)
    want = np.asarray(jax_sample(jnp.asarray(lg), jnp.zeros(n),
                                 jnp.zeros(n, jnp.int32), jnp.ones(n),
                                 jnp.arange(n), jnp.full(n, 3)))
    assert got.tolist() == want.tolist() == lg.argmax(-1).tolist()


def test_all_greedy_batch_skips_the_sort(monkeypatch):
    def no_sort(*a, **k):
        raise AssertionError("an all-greedy batch must not sort")
    monkeypatch.setattr(torch, "sort", no_sort)
    lg = torch.from_numpy(_logits(1))
    assert sample_tokens(lg, [0.0] * 4, [5] * 4, [0.5] * 4, [0] * 4,
                         [0] * 4).tolist() == lg.argmax(-1).tolist()


@pytest.mark.parametrize("top_k,top_p,temp", [
    (0, 1.0, 1.0), (5, 1.0, 0.7), (0, 0.5, 1.0), (10, 0.8, 1.3),
    (1, 1.0, 1.0), (0, 1e-9, 1.0)])
def test_keep_sets_match_jax(top_k, top_p, temp):
    """Equal keep-sets, except where a token's probability mass before it
    sits within float32 rounding of ``top_p`` (then either side may keep
    it: the two cumsums round differently)."""
    for seed in range(3):
        for row in _logits(10 + seed):
            scaled = row / max(temp, 1e-6)
            got = keep_mask(torch.from_numpy(scaled), top_k, top_p).numpy()
            want = _jax_keep(jnp.asarray(scaled), top_k, top_p)
            s64 = scaled.astype(np.float64)
            if top_k > 0:
                kth = np.sort(s64)[::-1][min(top_k, V) - 1]
                s64 = np.where(s64 >= kth, s64, -np.inf)
            order = np.argsort(-s64, kind="stable")
            p = np.exp(s64[order] - s64[order][0])
            p /= p.sum()
            before = np.empty_like(p)
            before[order] = np.cumsum(p) - p
            clear = np.abs(before - top_p) > 1e-5
            np.testing.assert_array_equal(got[clear], want[clear])


def test_jax_samples_fall_in_the_port_keep_set():
    lg = _logits(20, rows=1) / 3
    scaled = lg[0] / 1.5
    keep = keep_mask(torch.from_numpy(scaled), 8, 0.9).numpy()
    assert 1 < keep.sum() <= 8
    n = 64
    toks = np.asarray(jax_sample(
        jnp.asarray(np.repeat(lg, n, 0)), jnp.full(n, 1.5),
        jnp.full(n, 8, jnp.int32), jnp.full(n, 0.9),
        jnp.arange(n), jnp.zeros(n, jnp.int32)))
    assert keep[toks].all()
    port = sample_tokens(torch.from_numpy(np.repeat(lg, n, 0)), [1.5] * n,
                         [8] * n, [0.9] * n, list(range(n)), [0] * n)
    assert keep[port.numpy()].all()
    assert len(set(port.tolist())) > 1


def test_seeded_stream_reproduces():
    lg = torch.from_numpy(_logits(30))
    args = ([0.9, 0.0, 1.2, 0.7], [0, 0, 10, 3], [1.0, 1.0, 0.9, 1.0],
            [7, 7, 8, 9])
    a = sample_tokens(lg, *args, [4, 4, 4, 4])
    b = sample_tokens(lg, *args, [4, 4, 4, 4])
    assert a.tolist() == b.tolist()
    assert a[1].item() == lg[1].argmax().item()
    draws = {tuple(sample_tokens(lg, *args, [p] * 4).tolist())
             for p in range(8)}
    assert len(draws) > 1                       # positions change the draw
