"""Synthetic graph generators (seeded numpy, then a device :class:`Graph`).

The numpy generation is the reference's (``repro.graphs.synthetic``)
verbatim, so the same seed gives the same CSR in both packages.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def cycle(n: int, device="cuda") -> Graph:
    src = np.arange(n)
    return Graph.from_edges(src, (src + 1) % n, n=n, device=device)


def star(n: int, device="cuda") -> Graph:
    """Hub 0 -> spokes and spokes -> hub (extreme degree skew)."""
    spokes = np.arange(1, n)
    src = np.concatenate([np.zeros(n - 1, np.int64), spokes])
    dst = np.concatenate([spokes, np.zeros(n - 1, np.int64)])
    return Graph.from_edges(src, dst, n=n, device=device)


def erdos_renyi(n: int, avg_deg: float, seed: int = 0, device="cuda") -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    keep = src != dst
    return Graph.from_edges(src[keep], dst[keep], n=n, device=device)


def rmat(
    n_log2: int,
    avg_deg: float = 16.0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    dedup: bool = True,
    device="cuda",
) -> Graph:
    """R-MAT / Kronecker generator (Graph500 parameters by default):
    heavy-tailed in/out degrees like the paper's web/social graphs."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    m = int(n * avg_deg)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(n_log2):
        r = rng.random(m)
        go_right = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        go_down = (r >= a) & (r < a + b) | (r >= a + b + c)
        src += go_down.astype(np.int64) << level
        dst += go_right.astype(np.int64) << level
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if dedup:
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
    return Graph.from_edges(src, dst, n=n, device=device)
