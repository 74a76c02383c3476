"""Oracles of the kernels, the counterparts of ``repro.kernels.ref``.

The pushes and the combine are dense oracles, independent of the code under
test: densify, compute exactly, re-sparsify.  ``walk_step_ref`` is the
kernel's plain version itself: the step is one gather chain with nothing
to spell differently, and it is held bit for bit against the reference's
oracle in the tests.
"""

from __future__ import annotations

import torch

from repro_torch.core import frontier as F
from repro_torch.kernels.walk_step import walk_step_plain as walk_step_ref  # noqa: F401


def _densify(values, indices, n):
    q = values.shape[0]
    out = torch.zeros((q, n), dtype=torch.float32, device=values.device)
    return out.scatter_add_(1, indices.long(), values.to(torch.float32))


def _topk_dense(dense, k_out):
    """Top-``k_out`` of dense rows, (value desc, column asc), 0-padded."""
    n = dense.shape[1]
    vals, idx = torch.sort(dense, dim=1, descending=True, stable=True)
    vals = torch.clamp(vals[:, :min(k_out, n)], min=0.0)
    idx = torch.where(vals > 0, idx[:, :min(k_out, n)], 0).to(torch.int32)
    return F.topk_compact(vals, idx, k_out)


def frontier_push_ref(fv, fi, sources, row_ptr, out_deg, col_idx, *,
                      c: float, k_out: int, threshold: float = 0.0):
    """Densify the frontier, push ``(1-c) * f @ A`` exactly (dangling mass
    back to each source), re-sparsify to top-``k_out``."""
    n = out_deg.shape[0]
    dense = _densify(fv, fi, n)
    deg = out_deg.to(torch.float32)
    src_of_edge = torch.repeat_interleave(
        torch.arange(n, device=fv.device), (row_ptr[1:] - row_ptr[:-1]).long())
    w = 1.0 / torch.clamp(deg, min=1.0)
    edge_v = dense[:, src_of_edge] * w[src_of_edge]
    pushed = torch.zeros_like(dense).index_add_(1, col_idx.long(), edge_v)
    dm = torch.where(out_deg == 0, dense, 0.0).sum(dim=1)
    pushed[torch.arange(dense.shape[0]), sources.long()] += dm
    pushed = (1.0 - c) * pushed
    if threshold > 0.0:
        pushed = torch.where(pushed >= threshold, pushed, 0.0)
    return _topk_dense(pushed, k_out)


def index_combine_sparse_ref(sv, si, fv, fi, vals, idx, *, k_out: int):
    """Densify ``s`` and ``f``, add ``f @ P_hat`` by scatter, top-k."""
    n = vals.shape[0]
    out = _densify(sv, si, n)
    contrib = fv[:, :, None] * vals[fi.long()]            # [Q, K, L]
    out.scatter_add_(1, idx[fi.long()].reshape(fv.shape[0], -1).long(),
                     contrib.reshape(fv.shape[0], -1))
    return _topk_dense(out, k_out)


def sharded_push_ref(fv, fi, row_ptr, col_idx, *, c: float, ep: int,
                     n_shard: int, wire_k: int):
    """Dense-scatter oracle of ``sharded_frontier_push``: densify the local
    frontier slice, push every real edge of the shard's slab into a dense
    ``[Q, ep * n_shard]`` row, take each owner's top-``wire_k`` with
    owner-local indices.  Exact only where ``wire_k`` covers each owner's
    support."""
    q = fv.shape[0]
    m = col_idx.shape[0]
    f_dense = _densify(fv, fi, n_shard)
    e_ids = torch.arange(m, dtype=row_ptr.dtype, device=fv.device)
    src_row = torch.clamp(
        torch.searchsorted(row_ptr, e_ids, right=True) - 1, 0, n_shard - 1)
    deg = (row_ptr[1:] - row_ptr[:-1]).to(torch.float32)
    w = 1.0 / torch.clamp(deg[src_row], min=1.0)
    real = (e_ids < row_ptr[-1]).to(torch.float32)   # slab padding
    vals = f_dense[:, src_row] * (w * real)[None, :]
    dense = torch.zeros((q, ep * n_shard), dtype=torch.float32,
                        device=fv.device).index_add_(1, col_idx.long(), vals)
    dense = (1.0 - c) * dense
    kk = min(wire_k, n_shard)
    bv, bi = F.topk_dense(dense.reshape(q * ep, n_shard), kk)
    bv = bv.reshape(q, ep, kk)
    bi = torch.where(bv > 0, bi.reshape(q, ep, kk), 0).to(torch.int32)
    if wire_k > n_shard:
        pad = (0, wire_k - n_shard)
        bv = torch.nn.functional.pad(bv, pad)
        bi = torch.nn.functional.pad(bi, pad)
    return bv, bi


def embedding_bag_ref(ids, mask, table):
    """``out[b, :] = sum_i mask[b, i] * table[ids[b, i], :]`` in f32."""
    rows = table[ids.long()].to(torch.float32)
    return (rows * mask.to(torch.float32)[:, :, None]).sum(dim=1)
