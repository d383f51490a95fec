# Copy of src/repro/traffic/patterns.py, kept so repro_torch never imports repro.
"""Synthetic traffic generators (paper §2.3.5): random-uniform, transpose,
permutation, and hotspot.

A traffic pattern is a dense [n, n] matrix T with T[s, d] = amount of traffic
from chiplet s to chiplet d (self-traffic always zero). All patterns are
normalized to a total traffic of 1.0 so throughput numbers are directly the
"fraction of offered load the ICI sustains" the paper reports.
"""
from __future__ import annotations

import numpy as np


def _normalize(t: np.ndarray) -> np.ndarray:
    np.fill_diagonal(t, 0.0)
    s = t.sum()
    if s <= 0:
        raise ValueError("traffic pattern is empty")
    return t / s


def random_uniform(n: int, seed: int = 0) -> np.ndarray:
    """Every source sends equally to every other destination (n*(n-1) pairs —
    quadratic in n, matching the paper's runtime analysis §3.2.1)."""
    t = np.ones((n, n), dtype=np.float64)
    return _normalize(t)


def transpose(n: int, seed: int = 0) -> np.ndarray:
    """Matrix-transpose traffic over the (near-)square chiplet grid:
    (r, c) -> (c, r). Linear number of communicating pairs. For non-square n
    we fall back to the bit-reversal-free index transpose d = (s*k) mod (n-1)
    style mapping used for irregular counts: d = (s * rows + s // cols) is not
    defined, so we use the rectangular generalization below."""
    rows = int(np.floor(np.sqrt(n)))
    while n % rows != 0:
        rows -= 1
    cols = n // rows
    t = np.zeros((n, n), dtype=np.float64)
    for s in range(n):
        r, c = divmod(s, cols)
        # transpose within the min(rows, cols) square; nodes outside mirror
        # back via modulo so every source has exactly one destination.
        d = (c % rows) * cols + (r % cols)
        if d != s:
            t[s, d] = 1.0
    if t.sum() == 0:    # fully symmetric tiny case: shift by one instead
        for s in range(n):
            t[s, (s + 1) % n] = 1.0
    return _normalize(t)


def permutation(n: int, seed: int = 0) -> np.ndarray:
    """A random (seeded) fixed-point-free permutation: s -> pi(s). Linear
    number of communicating pairs."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    # Resolve fixed points by cyclic swap.
    for i in np.nonzero(perm == np.arange(n))[0]:
        j = (i + 1) % n
        perm[i], perm[j] = perm[j], perm[i]
    t = np.zeros((n, n), dtype=np.float64)
    t[np.arange(n), perm] = 1.0
    return _normalize(t)


def hotspot(n: int, seed: int = 0, n_hotspots: int = 4,
            hotspot_fraction: float = 0.5) -> np.ndarray:
    """Paper footnote 1: four hotspot nodes; 50% of the traffic is directed
    towards these hotspots, the rest is uniform."""
    rng = np.random.default_rng(seed)
    n_hotspots = min(n_hotspots, n)
    hot = rng.choice(n, size=n_hotspots, replace=False)
    t = np.ones((n, n), dtype=np.float64)
    np.fill_diagonal(t, 0.0)
    t *= (1.0 - hotspot_fraction) / t.sum()
    th = np.zeros((n, n), dtype=np.float64)
    th[:, hot] = 1.0
    np.fill_diagonal(th, 0.0)
    th *= hotspot_fraction / th.sum()
    return _normalize(t + th)


def unit_injection_scale(t: np.ndarray) -> np.ndarray:
    """Scale a traffic matrix so the heaviest source injects exactly
    1 flit/cycle at injection rate 1.0.

    The cycle simulators' links carry 1 flit/cycle, so evaluating the
    throughput proxy on a matrix scaled this way (with unit link
    capacities) makes its sustainable fraction directly comparable to a
    simulator's saturation injection rate — the normalization the
    accuracy/speedup benchmarks rely on (DESIGN note in
    benchmarks/accuracy_speedup.py)."""
    mx = t.sum(axis=1).max()
    if mx <= 0:
        raise ValueError("traffic pattern has no sending source")
    return t / mx


TRAFFIC_PATTERNS = {
    "random_uniform": random_uniform,
    "transpose": transpose,
    "permutation": permutation,
    "hotspot": hotspot,
}


def make_traffic(pattern: str, n: int, seed: int = 0, **kw) -> np.ndarray:
    try:
        fn = TRAFFIC_PATTERNS[pattern]
    except KeyError:
        raise ValueError(f"unknown traffic pattern {pattern!r}; "
                         f"options: {sorted(TRAFFIC_PATTERNS)}") from None
    return fn(n, seed=seed, **kw)
