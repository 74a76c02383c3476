"""Power-iteration baseline (the paper's ``PI``) and ground truth.

``p <- (1-c) * p A + c e_u`` with dangling rows of ``A`` pointing back at
each query's source, batched over queries: one shared push per iteration
(``transition_with_dangling``, i.e. the ``ell_spmm`` kernel), the same
structure as VERD.  The counterpart of ``repro.core.power_iteration``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph, transition_with_dangling
from repro_torch.core.walks import DEFAULT_C


def power_iteration(graph: Graph, sources, *, n_iter: int = 100,
                    c: float = DEFAULT_C) -> torch.Tensor:
    """Fixed-iteration batched PI, ``f32[Q, n]``.  100 iterations leave
    residual mass ``(1-c)^100 ~ 9e-8``: ground-truth grade."""
    q = sources.shape[0]
    rows = torch.arange(q, device=sources.device)
    e_u = torch.zeros((q, graph.n), dtype=torch.float32,
                      device=sources.device)
    e_u.index_put_((rows, sources.long()),
                   torch.ones((), dtype=torch.float32, device=e_u.device))
    p = e_u
    for _ in range(n_iter):
        p = transition_with_dangling(graph, p, sources)
        p.mul_(1.0 - c).add_(e_u, alpha=c)
    return p


def exact_ppr_dense(graph: Graph, c: float = DEFAULT_C) -> np.ndarray:
    """All-pairs exact PPR by direct float64 solve of ``p_u (I - (1-c)
    A_u) = c e_u`` per source (tiny graphs and oracles only)."""
    n = graph.n
    out = np.zeros((n, n), dtype=np.float64)
    for u in range(n):
        a = graph.dense_transition(source=u)
        out[u] = np.linalg.solve(np.eye(n) - (1.0 - c) * a.T,
                                 c * np.eye(n)[u])
    return out
