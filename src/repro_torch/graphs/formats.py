"""Graph views for kernels (``repro.graphs.formats``): the row-chunked ELL
pull view, the destination-sorted COO edge list and edge padding.

Every vertex owns ``ceil(in_deg / k)`` rows of width ``k`` holding its
in-neighbours, so a hub costs at most ``k - 1`` padding slots and the
frontier push ``f @ A0`` becomes a gather, a weighted ``k``-sum per row and
a fold of each vertex's rows (``ell_spmm``).  The arrays equal the
reference's bit for bit; the view is built on the graph's device with
integer arithmetic and one stable sort.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class EllChunks:
    """Row-chunked ELL view of the *reversed* graph (pull by destination).

    Attributes:
      nbr:         int32[rows, k] in-neighbour ids (0 at padding).
      weight:      f32[rows, k]   ``1/out_deg[nbr]`` (0 at padding).
      row2vertex:  int32[rows]    destination vertex of each chunk row
                                  (padding rows: vertex 0, weight 0).
      vertex_rows: int32[n + 1]   first row of each vertex: vertex ``v``
                                  owns rows ``vertex_rows[v]:vertex_rows[v+1]``
                                  (the fold's segments; not in the reference).
      rows, k, n:  padded row count, row width, vertex count.
      rows_used:   rows before the padding (``vertex_rows[n]``).
    """

    nbr: torch.Tensor
    weight: torch.Tensor
    row2vertex: torch.Tensor
    vertex_rows: torch.Tensor
    rows: int
    k: int
    n: int
    rows_used: int


def to_ell_chunks(graph: Graph, k: int = 16, pad_rows_to: int = 1) -> EllChunks:
    """Build the row-chunked ELL pull view of ``graph`` on its device.

    Each chunk row holds up to ``k`` in-edges of one destination vertex, in
    CSR order of their sources; ``rows`` is padded up to a multiple of
    ``pad_rows_to``.  One host sync (the row count).
    """
    dev = graph.device
    n = graph.n
    deg = graph.out_deg
    # 1/deg in f64, then rounded once to f32: the reference's numpy spelling
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1).double(),
                          0.0).to(torch.float32)
    dst = graph.col_idx.long()
    order = torch.argsort(dst, stable=True)
    src_by_dst = graph.src.long()[order]
    dst_sorted = dst[order]
    in_deg = torch.bincount(dst, minlength=n)
    chunks_per_v = (in_deg + k - 1) // k
    vertex_rows = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(chunks_per_v, 0, out=vertex_rows[1:])
    rows = int(vertex_rows[-1]) if n else 0
    rows_padded = max(-(-rows // pad_rows_to) * pad_rows_to, pad_rows_to)

    edge_start = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(in_deg, 0, out=edge_start[1:])
    pos_in_v = torch.arange(dst_sorted.numel(), device=dev) - edge_start[
        dst_sorted]
    flat = (vertex_rows[dst_sorted] + pos_in_v // k) * k + pos_in_v % k
    nbr = torch.zeros(rows_padded * k, dtype=torch.int32, device=dev)
    weight = torch.zeros(rows_padded * k, dtype=torch.float32, device=dev)
    nbr[flat] = src_by_dst.to(torch.int32)
    weight[flat] = inv_deg[src_by_dst]
    row2vertex = torch.zeros(rows_padded, dtype=torch.int32, device=dev)
    row2vertex[:rows] = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev), chunks_per_v,
        output_size=rows)
    return EllChunks(
        nbr=nbr.reshape(rows_padded, k), weight=weight.reshape(rows_padded, k),
        row2vertex=row2vertex, vertex_rows=vertex_rows.to(torch.int32),
        rows=rows_padded, k=k, n=n, rows_used=rows,
    )


def ell_pull(ell: EllChunks, frontier: torch.Tensor) -> torch.Tensor:
    """Plain pull ``frontier @ A0`` through the ELL view: gather, weighted
    row sums, segment-sum by ``row2vertex``.  ``f32[q, n] -> f32[q, n]``;
    the unchunked oracle of ``ell_spmm`` (tests and tiny graphs)."""
    q = frontier.shape[0]
    gathered = frontier[:, ell.nbr.reshape(-1).long()].reshape(
        q, ell.rows, ell.k)
    partial = (gathered * ell.weight[None]).sum(dim=-1)
    out = torch.zeros((q, ell.n), dtype=frontier.dtype, device=frontier.device)
    return out.index_add_(1, ell.row2vertex.long(), partial)


def to_coo_sorted_by_dst(graph: Graph
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(src int32[m], dst int32[m], weight f32[m])`` sorted by destination
    (stable, so each destination keeps CSR order), ``weight = 1 /
    out_deg[src]``: the push-mode edge list, on the graph's device."""
    order = torch.argsort(graph.col_idx.long(), stable=True)
    src = graph.src.long()[order]
    w = 1.0 / graph.out_deg.to(torch.float32)[src]
    return src.to(torch.int32), graph.col_idx[order], w


def pad_edges(graph: Graph, multiple: int) -> Graph:
    """The graph with its edge arrays padded to a multiple of ``multiple``
    by ``m_pad - m`` copies of a ``0 -> 0`` edge; ``row_ptr``, ``out_deg`` and ``m`` stay
    the true ones, so CSR readers never reach the padding.  For kernels
    that need the edge count aligned."""
    m = graph.m
    m_pad = -(-m // multiple) * multiple
    if m_pad == m:
        return graph
    zeros = torch.zeros(m_pad - m, dtype=torch.int32,
                        device=graph.col_idx.device)
    return Graph(row_ptr=graph.row_ptr,
                 col_idx=torch.cat([graph.col_idx, zeros]),
                 src=torch.cat([graph.src, zeros]),
                 out_deg=graph.out_deg, n=graph.n, m=m)
