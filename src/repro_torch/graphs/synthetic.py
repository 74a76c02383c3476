"""Synthetic graph generators (seeded numpy, then a device :class:`Graph`).

The numpy generation is the reference's (``repro.graphs.synthetic``)
verbatim, so the same seed gives the same CSR in both packages.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def figure2_graph(device="cuda") -> Graph:
    """The 8-vertex graph of paper Figure 2 (v1..v8 -> 0..7): v1 -> v2,
    v3; v2 -> v4, v5; v3 -> v6, v7; v4 -> v8; v5..v8 dangling."""
    src = [0, 0, 1, 1, 2, 2, 3]
    dst = [1, 2, 3, 4, 5, 6, 7]
    return Graph.from_edges(src, dst, n=8, device=device)


def cycle(n: int, device="cuda") -> Graph:
    src = np.arange(n)
    return Graph.from_edges(src, (src + 1) % n, n=n, device=device)


def complete(n: int, device="cuda") -> Graph:
    src, dst = np.nonzero(~np.eye(n, dtype=bool))
    return Graph.from_edges(src, dst, n=n, device=device)


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


def bipartite_recsys(n_users: int, n_items: int, avg_deg: float = 8.0,
                     seed: int = 0, device="cuda") -> Graph:
    """User->item + item->user interaction graph: vertices ``[0,
    n_users)`` are users, the next ``n_items`` items, item popularity
    Zipf-distributed like click-log skew."""
    rng = np.random.default_rng(seed)
    m = int(n_users * avg_deg)
    users = rng.integers(0, n_users, size=m)
    items = (rng.zipf(1.5, size=m) - 1) % n_items + n_users
    src = np.concatenate([users, items])
    dst = np.concatenate([items, users])
    return Graph.from_edges(src, dst, n=n_users + n_items, device=device)


def batched_molecules(n_graphs: int, nodes_per_graph: int,
                      edges_per_graph: int, seed: int = 0,
                      device="cuda") -> Graph:
    """A block-diagonal union of small random molecule-like graphs: each a
    ring plus random chords, self loops dropped, symmetrized."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for g in range(n_graphs):
        off = g * nodes_per_graph
        ring = np.arange(nodes_per_graph)
        s = np.concatenate(
            [ring, rng.integers(0, nodes_per_graph, edges_per_graph)])
        d = np.concatenate(
            [(ring + 1) % nodes_per_graph,
             rng.integers(0, nodes_per_graph, edges_per_graph)])
        keep = s != d
        s, d = s[keep], d[keep]
        srcs.append(np.concatenate([s, d]) + off)
        dsts.append(np.concatenate([d, s]) + off)
    return Graph.from_edges(np.concatenate(srcs), np.concatenate(dsts),
                            n=n_graphs * nodes_per_graph, device=device)
