"""Latency rows for the quantile-head tests (CPU and card), made with
NumPy from a seed: a ``[C, K]`` f32 matrix, +inf past each row's count,
and the ``[C]`` int32 counts."""
from __future__ import annotations

import numpy as np

#: row kinds: gamma latencies with ragged counts (0 and 1 among them);
#: a row of one value; values sharing their top 24 bits, so every digit
#: round decides; subnormals and zeros; counts far below K; half a row
#: tied across the median
KINDS = ("ragged", "ties", "top24", "subnormal", "short", "half_ties")


def quantile_rows(C: int, K: int, seed: int = 0, kinds=KINDS) -> tuple:
    """Row ``i`` is of kind ``kinds[(i + K) % len(kinds)]``; with more
    than one row, row 0 has a count of 0 and row 1 a count of 1."""
    g = np.random.default_rng((seed, C, K))
    lat = np.full((C, K), np.inf, np.float32)
    counts = np.zeros(C, np.int32)
    for i in range(C):
        kind = kinds[(i + K) % len(kinds)]
        n = {"ragged": int(g.integers(0, K + 1)),
             "short": max(1, K // 64)}.get(kind, K)
        if kind == "ties":
            x = np.full(n, 0.25, np.float32)
        elif kind == "top24":
            low = g.integers(0, 256, n).astype(np.uint32)
            x = (np.uint32(0x3C23D700) | low).view(np.float32)
        elif kind == "subnormal":
            x = g.integers(0, 0x800000, n).astype(np.uint32).view(np.float32)
        else:
            x = g.gamma(2.0, 0.004, n).astype(np.float32)
            if kind == "half_ties":
                x[:n // 2] = 0.0125
        lat[i, :n] = x
        counts[i] = n
    if C > 1:
        lat[0] = np.inf
        counts[0] = 0
        lat[1, 1:] = np.inf
        counts[1] = 1
        if not np.isfinite(lat[1, 0]):            # a ragged count of 0
            lat[1, 0] = 0.5
    return lat, counts
