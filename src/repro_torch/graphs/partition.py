"""Vertex-interval partitioning (paper Section 3.1), host numpy.

The paper's master divides ``V`` into disjoint intervals and hands each to a
slave; here intervals are static shard assignments.  Balancing by *edge*
count (not vertex count) avoids stragglers on power-law graphs.  The
arithmetic is the reference's (``repro.graphs.partition``) on the graph's
``row_ptr`` read to the host, so both packages give equal intervals.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: int
    hi: int  # exclusive
    edges: int

    @property
    def size(self) -> int:
        return self.hi - self.lo


def _row_ptr(graph: Graph) -> np.ndarray:
    return graph.row_ptr.cpu().numpy().astype(np.int64)


def vertex_intervals(graph: Graph, parts: int) -> List[Interval]:
    """Contiguous intervals with ~equal vertex counts."""
    bounds = np.linspace(0, graph.n, parts + 1).astype(np.int64)
    row_ptr = _row_ptr(graph)
    return [Interval(int(lo), int(hi), int(row_ptr[hi] - row_ptr[lo]))
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def edge_balanced_intervals(graph: Graph, parts: int) -> List[Interval]:
    """Contiguous intervals with ~equal *edge* counts (straggler-aware):
    index-build scatter cost scales with an interval's edge mass."""
    row_ptr = _row_ptr(graph)
    targets = np.linspace(0, int(row_ptr[-1]), parts + 1)
    cut = np.searchsorted(row_ptr, targets, side="left")
    cut[0], cut[-1] = 0, graph.n
    cut = np.maximum.accumulate(cut)  # monotone even on degenerate graphs
    return [Interval(int(lo), int(hi), int(row_ptr[hi] - row_ptr[lo]))
            for lo, hi in zip(cut[:-1], cut[1:])]


def balance_stats(intervals: List[Interval]) -> Tuple[float, float]:
    """(vertex imbalance, edge imbalance) = max/mean ratios."""
    sizes = np.array([iv.size for iv in intervals], dtype=np.float64)
    edges = np.array([iv.edges for iv in intervals], dtype=np.float64)
    v = float(sizes.max() / max(sizes.mean(), 1e-9))
    e = float(edges.max() / max(edges.mean(), 1e-9)) if edges.sum() else 1.0
    return v, e


def assign_sources_to_shards(sources: np.ndarray,
                             n_shards: int) -> List[np.ndarray]:
    """Round-robin query/source assignment: the online analogue of the
    master handing intervals to idle slaves."""
    return [np.asarray(sources[i::n_shards]) for i in range(n_shards)]
