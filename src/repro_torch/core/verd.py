"""Vertex-Centric Decomposition (paper Algorithm 4 + Section 3.3 batching).

One VERD iteration: ``S <- S + c F``, ``F <- (1-c) F A`` with dangling rows
of ``A`` pointing back at each query's seeds; after ``t`` iterations ``p =
S + F P_hat`` against the top-L index.  Two routes, as in
``repro.core.verd``:

* dense ``[Q, n]`` state (:func:`verd_iterate`, :func:`combine_with_index`,
  :func:`verd_query`): every push runs through the ``ell_spmm`` kernel
  wrapper and the combine through the dense ``index_combine`` (on a
  rank-sharded index, over the rows gathered for ``f``'s nonzero
  columns);
* sparse ``Q x K`` state (``verd_iterate_sparse`` and below): the push runs
  through ``frontier_push`` and the final sparse combine through
  ``index_combine_sparse``; the scatter combine stays plain PyTorch, as the
  reference computes it outside any kernel.

:func:`recursive_decomp` (Algorithm 3, float64 on the host) is the oracle
of the Theorem 2.3 equivalence.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import frontier
from repro_torch.core.graph import (Graph, transition_with_dangling,
                                    transition_with_dangling_seeds)
from repro_torch.core.index import PPRIndex, RankIndex
from repro_torch.core.walks import DEFAULT_C
from repro_torch.kernels import ops as kernel_ops


def dangling_seed_candidates(dm, sources, seed_weights, *, c: float):
    """Candidates returning dangling mass ``dm f32[Q]`` to the seeds: one
    ``(1-c) * dm`` at each source, or split by the normalized seed weights
    for seed sets."""
    if seed_weights is None:
        return ((1.0 - c) * dm[:, None],
                sources.reshape(-1, 1).to(torch.int32))
    wsum = torch.clamp(seed_weights.sum(dim=1, keepdim=True), min=1e-30)
    share = dm[:, None] * (seed_weights / wsum)
    return (1.0 - c) * share, sources.to(torch.int32)


def verd_iterate(graph: Graph, sources, seed_weights=None, *, t: int,
                 c: float = DEFAULT_C, threshold: float = 0.0):
    """``t`` VERD iterations on dense state; returns ``(s, f)``, both
    ``f32[Q, n]``.  ``threshold`` drops frontier entries below epsilon
    after each push.  With ``seed_weights f32[Q, S]``, ``sources int32[Q,
    S]`` seeds each row with its weighted one-hot combination (duplicate
    seeds add) and dangling mass restarts at the seed distribution."""
    q = sources.shape[0]
    dev = sources.device
    f = torch.zeros((q, graph.n), dtype=torch.float32, device=dev)
    rows = torch.arange(q, device=dev)
    if seed_weights is None:
        f.index_put_((rows, sources.long()),
                     torch.ones((), dtype=torch.float32, device=dev))
    else:
        f.index_put_((rows[:, None].expand(sources.shape), sources.long()),
                     seed_weights.to(torch.float32), accumulate=True)
    s = torch.zeros_like(f)
    for _ in range(t):
        s.add_(f, alpha=c)
        if seed_weights is None:
            f = transition_with_dangling(graph, f, sources)
        else:
            f = transition_with_dangling_seeds(graph, f, sources,
                                               seed_weights)
        f.mul_(1.0 - c)
        if threshold > 0.0:
            f = torch.where(f >= threshold, f, 0.0)
    return s, f


def combine_with_index(s, f, index: PPRIndex):
    """Algorithm 4 line 10, ``p~ = s + sum_v f(v) * p_hat_v``, through the
    dense ``index_combine`` kernel wrapper (an index may hold more rows
    than the frontier has columns; the extra rows are never touched).
    The kernel pulls through the index's cached transposed view.

    A :class:`RankIndex` first gathers, on the leader, the rows of the
    columns of ``f`` that hold a nonzero, in ascending order, and the
    combine runs on ``f``'s columns of them.  Both the kernel and its
    plain version sum an entry as ``s``, then its terms in ascending
    ``(v, j)``, and a column of zeros adds ``+0`` to each sum, so on the
    CPU the answer is the whole index's, bit for bit; on the card the
    transposed view is built a batch over the gathered rows, and a
    column of more than ``COLUMN_SEGMENT`` entries may split elsewhere."""
    if isinstance(index, RankIndex):
        need = f.ne(0).any(dim=0).nonzero()[:, 0]
        index, f = index.gather(need), f[:, need]
    columns = index.columns(f.shape[1], s.shape[1]) if f.is_cuda else None
    return kernel_ops.index_combine(s, f, index.values, index.indices,
                                    columns=columns)


def verd_query(graph: Graph, sources, index: Optional[PPRIndex], *, t: int,
               c: float = DEFAULT_C, threshold: float = 0.0,
               seed_weights=None):
    """Full online query on dense state: iterate, then combine (``index
    None`` returns ``s``, the paper's R = 0 mode)."""
    s, f = verd_iterate(graph, sources, seed_weights, t=t, c=c,
                        threshold=threshold)
    if index is None:
        return s
    return combine_with_index(s, f, index)


def recursive_decomp(graph: Graph, u: int, t: int, base_vectors,
                     c: float = DEFAULT_C) -> np.ndarray:
    """Literal Algorithm 3 in float64 on the host (oracle only).

    ``base_vectors[v]`` plays ``p_hat_v``: exact PPR vectors check Theorem
    2.2, index rows Theorem 2.3.  A dangling vertex has an artificial edge
    to the recursion root, itself, so ``p_v = e_v``.
    """
    if t == 0:
        return np.asarray(base_vectors[u], dtype=np.float64)
    out_nbrs = graph.out_neighbors(u)
    e_u = np.zeros(graph.n, dtype=np.float64)
    e_u[u] = 1.0
    if len(out_nbrs) == 0:
        return e_u
    acc = np.zeros(graph.n, dtype=np.float64)
    for v in out_nbrs:
        acc += recursive_decomp(graph, int(v), t - 1, base_vectors, c)
    return c * e_u + (1.0 - c) / len(out_nbrs) * acc


def resolve_degree_cap(graph: Graph) -> int:
    """Max out-degree (one host sync per graph): the per-slot edge budget
    that makes the sparse push exact."""
    if graph.n == 0 or graph.m == 0:
        return 1
    return max(int(graph.out_deg.max()), 1)


def resolve_hub_splits(degree_cap: int, hub_split_degree: int) -> Tuple[int, int]:
    """``(h, s)``: each frontier slot spans ``s`` sub-slots of gather width
    ``h`` (``s * h >= degree_cap``); ``hub_split_degree <= 0`` or ``>=
    degree_cap`` disables splitting."""
    if hub_split_degree <= 0 or hub_split_degree >= degree_cap:
        return degree_cap, 1
    h = hub_split_degree
    return h, (degree_cap + h - 1) // h


def push_window_starts(start, *, degree_cap: int, hub_split_degree: int = 0,
                       m: int):
    """Clipped gather-window starts ``[Q, K, s]``: sub-slot ``j`` reads
    ``h`` edges from ``start + j*h``, clipped to ``[0, m - h]``."""
    h, s = resolve_hub_splits(degree_cap, hub_split_degree)
    st = start[..., None] + h * torch.arange(s, dtype=torch.int32,
                                             device=start.device)
    return torch.clamp(st, 0, max(m - h, 0))


def masked_push_from_windows(fv, deg, start, windows, gathered, *, c: float,
                             degree_cap: int, hub_split_degree: int = 0):
    """Mask fixed-width gather windows into push candidates of width
    ``K * s * h``: lane ``j`` of a window shifted down by ``d`` is edge
    ``s_i*h + j - d`` of its row, real iff ``j >= d`` and within ``min(deg,
    degree_cap)``; weights ``(1-c) * fv / deg``, empty slots ``(0.0, 0)``."""
    q, k = fv.shape
    h, s = resolve_hub_splits(degree_cap, hub_split_degree)
    dev = fv.device
    sub = h * torch.arange(s, dtype=torch.int32, device=dev)
    d = (start[..., None] + sub - windows)[..., None]
    j = torch.arange(h, dtype=torch.int32, device=dev)[None, None, None, :]
    eoff = sub[None, None, :, None] + (j - d)
    budget = torch.clamp(deg, max=degree_cap)[..., None, None]
    valid = (j >= d) & (eoff < budget)
    nbrs = torch.where(valid, gathered, 0)
    inv = 1.0 / torch.clamp(deg[..., None, None].to(torch.float32), min=1.0)
    push_v = torch.where(valid, (1.0 - c) * fv[..., None, None] * inv, 0.0)
    return push_v.reshape(q, k * s * h), nbrs.reshape(q, k * s * h)


def gather_push_edges(fv, fi, start, deg, col_idx, *, c: float,
                      degree_cap: int, hub_split_degree: int = 0):
    """Window gather + mask: the push candidates of ``(fv, fi)`` given the
    per-slot CSR ``start``/``deg``.  Width ``K * s * h``."""
    m = col_idx.shape[0]
    degree_cap = min(degree_cap, max(m, 1))
    h, _ = resolve_hub_splits(degree_cap, hub_split_degree)
    windows = push_window_starts(
        start, degree_cap=degree_cap, hub_split_degree=hub_split_degree, m=m)
    eidx = windows[..., None] + torch.arange(h, dtype=torch.int32,
                                             device=fv.device)
    gathered = col_idx[eidx.long()]
    return masked_push_from_windows(
        fv, deg, start, windows, gathered, c=c, degree_cap=degree_cap,
        hub_split_degree=hub_split_degree,
    )


def sparse_push_candidates(graph: Graph, fv, fi, sources, *, c=DEFAULT_C,
                           degree_cap: int, hub_split_degree: int = 0,
                           seed_weights=None):
    """One uncompacted push: edge candidates then the dangling candidates
    (width ``K * s * h + S``)."""
    if graph.m == 0:  # every vertex dangling: all mass returns to the seeds
        return dangling_seed_candidates(fv.sum(dim=1), sources, seed_weights,
                                        c=c)
    fil = fi.long()
    start = graph.row_ptr[fil]
    deg = graph.out_deg[fil]
    push_v, nbrs = gather_push_edges(
        fv, fi, start, deg, graph.col_idx, c=c, degree_cap=degree_cap,
        hub_split_degree=hub_split_degree)
    dm = torch.where(deg == 0, fv, 0.0).sum(dim=1)
    dang_v, dang_i = dangling_seed_candidates(dm, sources, seed_weights, c=c)
    return (torch.cat([push_v, dang_v], dim=1),
            torch.cat([nbrs, dang_i], dim=1))


def sparse_push_compact(
    graph: Graph, fv, fi, sources, *, c: float = DEFAULT_C, degree_cap: int,
    k_out: int, hub_split_degree: int = 0, threshold: float = 0.0,
    stream_width: int = 0, seed_weights=None,
) -> frontier.SparseFrontier:
    """One VERD push + compaction with the reference's chunk plan.

    One-shot when the candidate width ``K * s * h + S`` is at most twice
    the stream target (``max(4 * out_w, slot width, 4096)``), else streamed
    in chunks of ``target // slot_w`` slots folded into a running
    top-``out_w`` state seeded with the compacted dangling candidates.
    Every fold truncates by rank, so the plan is kept exactly.  The folds
    run in the ``frontier_push`` kernel (plain version on the CPU); the
    epsilon threshold applies once at the end.
    """
    q, k = fv.shape
    m = graph.m
    s_width = 1 if seed_weights is None else int(seed_weights.shape[1])
    if m == 0:
        cv, ci = sparse_push_candidates(graph, fv, fi, sources, c=c,
                                        degree_cap=degree_cap,
                                        seed_weights=seed_weights)
        return frontier.compact(cv, ci, min(k_out, cv.shape[1]), graph.n,
                                threshold=threshold)
    cap = min(degree_cap, max(m, 1))
    h, s = resolve_hub_splits(cap, hub_split_degree)
    slot_w = s * h
    out_w = min(k_out, k * slot_w + s_width)
    target = stream_width if stream_width > 0 else max(4 * out_w, slot_w, 4096)
    fi = fi.to(torch.int32)
    deg = graph.out_deg[fi.long()]
    dm = torch.where(deg == 0, fv, 0.0).sum(dim=1)
    dang_v, dang_i = dangling_seed_candidates(dm, sources, seed_weights, c=c)
    if k * slot_w + s_width <= 2 * target:    # narrow enough: one-shot
        slots, run_v, run_i, run_first = k, dang_v, dang_i, False
    else:
        slots = max(1, target // slot_w)
        pad = (-k) % slots
        if pad:  # pad slots carry fv == 0: their candidates compact away
            fv = torch.nn.functional.pad(fv, (0, pad))
            fi = torch.nn.functional.pad(fi, (0, pad))
        run_v, run_i = frontier.topk_compact(dang_v, dang_i, out_w)
        run_first = True
    # the kernel folds one-slot chunks over the column-sorted view; the
    # plain version does not read it
    sorted_view = (graph.col_sorted()
                   if fv.is_cuda and run_first and slots == 1 else None)
    run_v, run_i = kernel_ops.frontier_push(
        fv, fi, run_v, run_i, graph.row_ptr, graph.out_deg, graph.col_idx,
        c=c, degree_cap=cap, hub_split_degree=hub_split_degree, slots=slots,
        k_out=out_w, run_first=run_first, sorted_view=sorted_view,
    )
    if threshold > 0.0:
        run_v = frontier.threshold_values(run_v, threshold)
        run_v, run_i = frontier.topk_compact(run_v, run_i, out_w)
    return frontier.SparseFrontier(values=run_v, indices=run_i, k=out_w,
                                   n=graph.n)


def verd_iterate_sparse(
    graph: Graph, sources, seed_weights=None, *, t: int, k: int,
    c: float = DEFAULT_C, threshold: float = 0.0,
    degree_cap: Optional[int] = None, hub_split_degree: int = 0,
):
    """``t`` sparse VERD iterations; returns ``(s, f)`` as sparse frontiers
    (``s`` keeps its natural width, ``f`` width ``<= k``)."""
    if degree_cap is None:
        degree_cap = resolve_degree_cap(graph)
    q = sources.shape[0]
    if seed_weights is None:
        f = frontier.from_sources(sources, graph.n)
    else:
        f = frontier.from_seed_sets(sources, seed_weights, graph.n)
    s_vals, s_idxs = [], []
    for _ in range(t):
        s_vals.append(c * f.values)
        s_idxs.append(f.indices)
        f = sparse_push_compact(
            graph, f.values, f.indices, sources, c=c, k_out=k,
            degree_cap=degree_cap, hub_split_degree=hub_split_degree,
            threshold=threshold, seed_weights=seed_weights,
        )
    if s_vals:
        sv = torch.cat(s_vals, dim=1)
        si = torch.cat(s_idxs, dim=1)
        s = frontier.compact(sv, si, min(sv.shape[1], graph.n), graph.n)
    else:
        dev = sources.device
        s = frontier.SparseFrontier(
            values=torch.zeros((q, 1), dtype=torch.float32, device=dev),
            indices=torch.zeros((q, 1), dtype=torch.int32, device=dev),
            k=1, n=graph.n,
        )
    return s, f


def combine_candidates_from_rows(sv, si, fv, iv, ii):
    """Scale gathered index rows ``[Q, K, L]`` by the frontier mass and
    stack them after the ``s`` entries (width ``S + K * L``)."""
    q = fv.shape[0]
    contrib = fv[..., None] * iv
    return (torch.cat([sv, contrib.reshape(q, -1)], dim=1),
            torch.cat([si, ii.reshape(q, -1)], dim=1))


def gather_combine_candidates(sv, si, fv, fi, vals, idx):
    """Gather the touched index rows and form the combine candidates."""
    rows = torch.clamp(fi.long(), 0, vals.shape[0] - 1)
    return combine_candidates_from_rows(sv, si, fv, vals[rows], idx[rows])


def _gathered(f, index):
    """On a :class:`RankIndex`, the touched rows gathered from their owners
    and the frontier pointed at them (:meth:`RankIndex.gather_rows`): the
    combine over them is the same bytes.  Else ``(f, index)``."""
    if not isinstance(index, RankIndex):
        return f, index
    rows, fi = index.gather_rows(f.values, f.indices)
    return frontier.SparseFrontier(values=f.values, indices=fi, k=f.k,
                                   n=f.n), rows


def combine_with_index_sparse(s, f, index: PPRIndex, *,
                              out_k: Optional[int] = None):
    """``p = s + f @ P_hat`` against only the ``K`` touched index rows,
    compacted to ``out_k`` (default: exact) — through the
    ``index_combine_sparse`` kernel wrapper.  A :class:`RankIndex` first
    gathers those rows on the leader."""
    f, index = _gathered(f, index)
    if out_k is None:
        out_k = min(s.values.shape[1] + f.values.shape[1] * index.l, index.n)
    v, i = kernel_ops.index_combine_sparse(
        s.values, s.indices.to(torch.int32), f.values,
        f.indices.to(torch.int32), index.values, index.indices, k_out=out_k,
    )
    return frontier.SparseFrontier(values=v, indices=i, k=out_k, n=index.n)


def combine_with_index_scatter(s, f, index: PPRIndex, *, out_k: int,
                               n_cols: Optional[int] = None):
    """Final combine through a dense ``[Q, n]`` scatter-add, then a stable
    descending sort for ``lax.top_k``'s order (value desc, column asc).
    The scatter is an accumulating ``index_put_``, which sums each
    column's candidates in candidate order on the card too (no float
    atomics), so its answers are the same bytes on every run.  A
    :class:`RankIndex` first gathers the touched rows on the leader."""
    f, index = _gathered(f, index)
    cand_v, cand_i = gather_combine_candidates(
        s.values, s.indices, f.values, f.indices, index.values,
        index.indices)
    q = cand_v.shape[0]
    n = index.n if n_cols is None else n_cols
    keep = cand_i < n   # mode="drop": out-of-range columns are discarded
    dense = torch.zeros((q, n), dtype=torch.float32, device=cand_v.device)
    flat = (torch.arange(q, dtype=torch.int64, device=cand_v.device)[:, None]
            * n + torch.where(keep, cand_i, 0).long())
    dense.view(-1).index_put_((flat.reshape(-1),),
                              torch.where(keep, cand_v, 0.0).reshape(-1),
                              accumulate=True)
    vals, idx = torch.sort(dense, dim=1, descending=True, stable=True)
    kk = min(out_k, n)
    vals, idx = vals[:, :kk], idx[:, :kk]
    idx = torch.where(vals > 0, idx, 0).to(torch.int32)
    if out_k > n:
        vals = torch.nn.functional.pad(vals, (0, out_k - n))
        idx = torch.nn.functional.pad(idx, (0, out_k - n))
    return vals, idx


def verd_query_sparse(
    graph: Graph, sources, index: Optional[PPRIndex], *, t: int, k: int,
    c: float = DEFAULT_C, threshold: float = 0.0, out_k: Optional[int] = None,
    degree_cap: Optional[int] = None, hub_split_degree: int = 0,
    seed_weights=None,
) -> frontier.SparseFrontier:
    """Full online query on the sparse path; answers come back width
    ``out_k``, sorted descending — no ``[Q, n]`` state anywhere."""
    s, f = verd_iterate_sparse(
        graph, sources, seed_weights, t=t, k=k, c=c, threshold=threshold,
        degree_cap=degree_cap, hub_split_degree=hub_split_degree,
    )
    if index is None:
        if out_k is not None:
            return frontier.compact(s.values, s.indices, out_k, graph.n)
        return s
    return combine_with_index_sparse(s, f, index, out_k=out_k)
