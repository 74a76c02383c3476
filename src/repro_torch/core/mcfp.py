"""Monte-Carlo Full-Path estimator (paper Algorithm 1).

``p_u(v) ~ x_n(v) / n`` where ``x_n`` counts *every* position on every walk
and ``n`` is the total number of positions; Theorem 2.1 gives the
exponential concentration (:mod:`repro_torch.core.theory`).  The dense
estimator runs :func:`~repro_torch.core.walks.simulate_walks`, the sparse
one the compacted sketch engine; both draw the reference's
(``repro.core.mcfp``) stream, so the same key gives the same estimate.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import frontier
from repro_torch.core.graph import Graph
from repro_torch.core.walks import (DEFAULT_C, simulate_walks,
                                    simulate_walks_sparse, walks_for_sources)


def estimate_ppr(
    graph: Graph,
    sources: torch.Tensor,
    r: int,
    key,
    *,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    words: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MCFP estimate ``f32[S, n]`` of the PPR vectors of ``sources``, on the
    graph's device; ``words`` replaces ``key`` as in
    :func:`~repro_torch.core.walks.simulate_walks`."""
    sources = torch.as_tensor(sources).to(graph.device, torch.int32)
    walk_sources, walk_rows = walks_for_sources(sources, r)
    counts = simulate_walks(graph, walk_sources, walk_rows, key,
                            n_rows=int(sources.shape[0]), c=c,
                            max_steps=max_steps, words=words)
    return counts.fp_counts / torch.clamp(counts.moves[:, None], min=1.0)


def estimate_ppr_sparse(
    graph: Graph,
    sources: torch.Tensor,
    r: int,
    key,
    *,
    l: int,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    compact_every: int = 8,
) -> frontier.SparseFrontier:
    """MCFP estimate as a top-``l`` :class:`~repro_torch.core.frontier
    .SparseFrontier`: ``O(rows * l)`` memory, no ``f32[S, n]``.  Exact
    (equal in law to :func:`estimate_ppr`) whenever ``l`` covers each row's
    visited support (``<= r/c`` vertices)."""
    sources = torch.as_tensor(sources).to(graph.device, torch.int32)
    counts = simulate_walks_sparse(
        graph, sources, r, key, l=l, ep_l=0, c=c, max_steps=max_steps,
        compact_every=compact_every,
    )
    vals = counts.fp.values / torch.clamp(counts.moves[:, None], min=1.0)
    return frontier.SparseFrontier(values=vals, indices=counts.fp.indices,
                                   k=counts.fp.k, n=graph.n)


def estimate_ppr_batched(
    graph: Graph,
    sources,
    r: int,
    key,
    *,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    source_batch: int = 256,
    stats: Optional[dict] = None,
):
    """Host-chunked MCFP for many sources (bounds the ``[S * R]`` walk
    array).  Yields ``(chunk_sources, estimates)``: numpy ids and ``f32[real,
    n]`` rows on the graph's device.  The ragged last chunk is padded with
    vertex 0 to ``source_batch`` rows (sliced off before yielding), chunk
    ``i`` (its first source's offset) walks under ``fold_in(key, i)``, and
    ``stats`` gets ``pad_rows``/``pad_fraction`` at once, before the first
    chunk is consumed."""
    sources = np.asarray(sources)
    pad_rows = (-len(sources)) % source_batch
    if stats is not None:
        stats["pad_rows"] = pad_rows
        stats["pad_fraction"] = pad_rows / max(len(sources) + pad_rows, 1)

    def chunks():
        # one upload of every (padded) source: no copy, so no sync, a chunk
        padded = torch.from_numpy(np.concatenate(
            [sources, np.zeros(pad_rows, sources.dtype)]).astype(np.int32))
        padded = padded.to(graph.device)
        for i in range(0, len(sources), source_batch):
            real = min(source_batch, len(sources) - i)
            est = estimate_ppr(graph, padded[i:i + source_batch], r,
                               rng.fold_in(key, i), c=c, max_steps=max_steps)
            yield sources[i:i + real], est[:real]

    return chunks()
