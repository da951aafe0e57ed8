"""Layer clustering — the paper's §5.1 discovery that 97% of layers fall into
five clusters in (param footprint, param FLOP/B, MACs, activation reuse) space.

Two implementations:
  * ``rule_cluster``      — the paper's published cluster boundary rules (Table in §5.1).
  * ``kmeans_cluster``    — plain k-means (k=5) on log-features, implemented from
                            scratch in numpy; used to *verify* that the rule clusters
                            are natural (high agreement ⇒ the structure is in the data,
                            not in the rules).

Clusters (paper §5.1):
  1: footprint 1–100 kB,    FLOP/B 780–20k,  MACs 30M–200M   (early std conv)
  2: footprint 100–500 kB,  FLOP/B 81–400,   MACs 20M–100M   (pointwise / mid conv)
  3: footprint 0.9–18 MB,   FLOP/B ~1,       MACs 0.1M–10M   (LSTM gates, FC)
  4: footprint 0.5–2.5 MB,  FLOP/B 25–64,    MACs 5M–25M     (late deep conv)
  5: footprint 1–100 kB,    FLOP/B 49–600,   MACs 0.5M–5M    (depthwise)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .characterize import LayerCharacteristics
from .layerspec import LayerKind

KB = 1024.0
MB = 1024.0 * 1024.0

# (footprint lo/hi bytes, flop/B lo/hi, MACs lo/hi) per cluster id
RULE_BOUNDS: dict[int, tuple[float, float, float, float, float, float]] = {
    1: (1 * KB, 100 * KB, 780.0, 20_000.0, 30e6, 200e6),
    2: (100 * KB, 500 * KB, 81.0, 400.0, 20e6, 100e6),
    3: (0.9 * MB, 18 * MB, 0.0, 8.0, 0.1e6, 10e6),
    4: (0.5 * MB, 2.5 * MB, 25.0, 64.0, 5e6, 25e6),
    5: (1 * KB, 100 * KB, 49.0, 600.0, 0.5e6, 5e6),
}

# Log-space centroids of the rule boxes, used for nearest-centroid fallback.
_CENTROIDS = {
    cid: np.array([
        (math.log10(lo_f) + math.log10(hi_f)) / 2,
        (math.log10(max(lo_r, 0.5)) + math.log10(max(hi_r, 0.5))) / 2,
        (math.log10(lo_m) + math.log10(hi_m)) / 2,
    ])
    for cid, (lo_f, hi_f, lo_r, hi_r, lo_m, hi_m) in RULE_BOUNDS.items()
}


def _features(c: LayerCharacteristics) -> np.ndarray:
    return np.array([
        math.log10(max(c.sched_param_bytes, 1.0)),
        math.log10(max(c.sched_flop_per_byte, 0.5)),
        math.log10(max(c.sched_macs, 1.0)),
    ])


@dataclass(frozen=True)
class ClusterAssignment:
    cluster: int          # 1..5
    strict: bool          # True if the layer satisfied the published rule box exactly


def _in_box(c: LayerCharacteristics, cid: int, pad: float = 1.0) -> bool:
    lo_f, hi_f, lo_r, hi_r, lo_m, hi_m = RULE_BOUNDS[cid]
    return (lo_f / pad <= c.sched_param_bytes <= hi_f * pad
            and lo_r / pad <= c.sched_flop_per_byte <= hi_r * pad
            and lo_m / pad <= c.sched_macs <= hi_m * pad)


def rule_cluster(c: LayerCharacteristics) -> ClusterAssignment:
    """Assign the paper's cluster id. Strict box match first; else structural
    priors (recurrent/FC-with-big-footprint → 3, depthwise → 5), else nearest
    rule-box centroid in log space."""
    for cid in (1, 2, 3, 4, 5):
        if _in_box(c, cid):
            return ClusterAssignment(cid, True)
    # structural priors mirror the paper's cluster descriptions
    if c.recurrent or (c.kind is LayerKind.FC and c.sched_param_bytes > 0.5 * MB) \
            or c.kind is LayerKind.EMBEDDING:
        return ClusterAssignment(3, False)
    if c.kind is LayerKind.DWCONV2D:
        return ClusterAssignment(5, False)
    f = _features(c)
    cid = min(_CENTROIDS, key=lambda k: float(np.sum((f - _CENTROIDS[k]) ** 2)))
    return ClusterAssignment(cid, False)


def cluster_all(chars: list[LayerCharacteristics]) -> list[ClusterAssignment]:
    return [rule_cluster(c) for c in chars]


def strict_fraction(chars: list[LayerCharacteristics], pad: float = 1.0) -> float:
    """Fraction of (weight-bearing) layers inside one of the 5 rule boxes — the
    paper's "97% of layers group into 5 clusters" claim.  ``pad`` loosens the
    published (rounded, descriptive) bounds multiplicatively; benchmarks report
    pad=1 (literal boxes) and pad=2.5 (boxes as cluster descriptors)."""
    weighty = [c for c in chars if c.param_bytes > 256 and c.macs > 0]
    if not weighty:
        return 0.0
    hits = sum(1 for c in weighty
               if any(_in_box(c, cid, pad) for cid in RULE_BOUNDS))
    return hits / len(weighty)


# -------------------------------------------------------------------- k-means
def kmeans_cluster(chars: list[LayerCharacteristics], k: int = 5, seed: int = 0,
                   iters: int = 100) -> tuple[np.ndarray, np.ndarray]:
    """From-scratch k-means on log features. Returns (labels, centroids)."""
    x = np.stack([_features(c) for c in chars])
    # explicit seeded generator: every draw below goes through rng, so the
    # same (chars, k, seed) always yields the same labels — the oracle's
    # reproducibility contract (and CI's)
    rng = np.random.RandomState(seed)
    # k-means++ init; degenerate inputs (all points coincident — common for a
    # transformer whose layers are identical specs) make every d2 zero, where
    # the weighted draw is undefined: fall back to a uniform seeded draw
    # instead of crashing np.random.choice with probs that don't sum to 1
    cent = [x[rng.randint(len(x))]]
    for _ in range(k - 1):
        d2 = np.min(np.stack([np.sum((x - c) ** 2, axis=1) for c in cent]), axis=0)
        total = float(d2.sum())
        if total <= 0.0:
            cent.append(x[rng.randint(len(x))])
            continue
        probs = d2 / total
        probs = probs / probs.sum()     # renormalize away fp round-off
        cent.append(x[rng.choice(len(x), p=probs)])
    cent_arr = np.stack(cent)
    labels = np.zeros(len(x), dtype=int)
    for it in range(iters):
        d = np.sum((x[:, None, :] - cent_arr[None, :, :]) ** 2, axis=2)
        new_labels = np.argmin(d, axis=1)
        if np.array_equal(new_labels, labels) and it > 0:
            break
        labels = new_labels
        for j in range(k):
            pts = x[labels == j]
            if len(pts):
                cent_arr[j] = pts.mean(axis=0)
    return labels, cent_arr


def agreement(chars: list[LayerCharacteristics]) -> float:
    """Best-permutation agreement between rule clusters and k-means clusters."""
    import itertools
    rules = np.array([rule_cluster(c).cluster - 1 for c in chars])
    km, _ = kmeans_cluster(chars)
    best = 0.0
    for perm in itertools.permutations(range(5)):
        mapped = np.array([perm[v] for v in km])
        best = max(best, float(np.mean(mapped == rules)))
    return best
