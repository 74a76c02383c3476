"""Monte-Carlo End-Point estimator (paper Algorithm 2; Fogaras et al. 2005).

The baseline PowerWalk improves on: only the terminal vertex of each walk
is counted, ``p_u(v) ~ y(v) / R``.  It shares the walk engines with
:mod:`repro_torch.core.mcfp`, so the paper's MCFP-against-MCEP comparison
(Figures 3-4) runs on the same walks; the same key gives the reference's
(``repro.core.mcep``) estimate.
"""

from __future__ import annotations

import torch

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
) -> torch.Tensor:
    """MCEP estimate ``f32[S, n]`` of the PPR vectors of ``sources``, on the
    graph's device."""
    sources = torch.as_tensor(sources).to(graph.device, torch.int32)
    walk_sources, walk_rows = walks_for_sources(sources, r)
    counts = simulate_walks(graph, walk_sources, walk_rows, key,
                            n_rows=int(sources.shape[0]), c=c,
                            max_steps=max_steps)
    return counts.ep_counts / torch.clamp(counts.walks[:, None], min=1.0)


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
    """MCEP estimate as a top-``l`` :class:`~repro_torch.core.frontier
    .SparseFrontier`.  A row from ``r`` walks has at most ``r`` nonzeros, so
    ``l >= min(r, n)`` is exact; the visit sketch is off (``l=0``)."""
    sources = torch.as_tensor(sources).to(graph.device, torch.int32)
    counts = simulate_walks_sparse(
        graph, sources, r, key, l=0, ep_l=l, c=c, max_steps=max_steps,
        compact_every=compact_every,
    )
    vals = counts.ep.values / torch.clamp(counts.walks[:, None], min=1.0)
    return frontier.SparseFrontier(values=vals, indices=counts.ep.indices,
                                   k=counts.ep.k, n=graph.n)
